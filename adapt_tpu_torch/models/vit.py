"""ViT-B/16 as a LayerGraph cut by transformer block.

Counterpart of ``adapt_tpu/models/vit.py``: each encoder block (pre-LN MHA
+ MLP with internal residuals) is one node named ``encoder_block_{i}``,
between ``patch_embed`` and ``head``. The math is flax's: parameters are
f32 and every op casts them to the compute ``dtype`` (flax's ``dtype=``
semantics, so bf16 training keeps f32 weights and SGD loses no update);
LayerNorm is eps 1e-6 with f32 statistics; GELU is the tanh
approximation; the classifier runs in f32 on the CLS token. Inputs are
NHWC images, as in the JAX package. Attention is
``ops.attention.flash_attention``: K1 forward and K7 backward on the card.

Load the JAX package's weights with ``convert.vit_from_flax``.
"""

from __future__ import annotations

from collections.abc import Callable

import torch
import torch.nn.functional as F
from torch import nn

from adapt_tpu_torch import resolve_device
from adapt_tpu_torch.graph.ir import INPUT, LayerGraph, NodeModule
from adapt_tpu_torch.models.layers import Dense, init_weights
from adapt_tpu_torch.models.transformer_lm import LayerNorm
from adapt_tpu_torch.ops.attention import flash_attention


class MultiHeadSelfAttention(nn.Module):
    """Self-attention on the flash kernels (``ops.attention``): a fused
    ``qkv`` projection split ``(3, heads, head_dim)`` and an ``out``
    projection. ``attn_fn`` (None -> ``flash_attention`` with
    ``prefer=attn_prefer``) receives plain ``(b, h, s, hd)`` q, k, v."""

    def __init__(self, dim, heads, dtype=torch.float32,
                 attn_fn: Callable | None = None,
                 attn_prefer: str | None = None, device=None):
        super().__init__()
        if dim % heads:
            raise ValueError(f"model dim {dim} not divisible by {heads} heads")
        self.heads = heads
        self.attn_fn = attn_fn
        self.attn_prefer = attn_prefer
        self.qkv = Dense(dim, 3 * dim, dtype, device)
        self.out = Dense(dim, dim, dtype, device)

    def forward(self, x):
        b, s, d = x.shape
        q, k, v = self.qkv(x).view(b, s, 3, self.heads, d // self.heads) \
            .unbind(2)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        if self.attn_fn is None:
            o = flash_attention(q, k, v, prefer=self.attn_prefer)
        else:
            o = self.attn_fn(q, k, v)
        return self.out(o.transpose(1, 2).reshape(b, s, d))


class PatchEmbed(NodeModule):
    """Patchify conv + [CLS] token + learned position embeddings. The conv
    weight is torch's ``(dim, in_chans, patch, patch)``; a stride-``patch``
    VALID conv is one product over flattened ``(c, ph, pw)`` patches, which
    is how it runs (the same full-precision matmul as every Dense)."""

    def __init__(self, patch, dim, img_size, in_chans=3,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.patch, self.dim, self.dtype = patch, dim, dtype
        n = (img_size // patch) ** 2
        self.weight = nn.Parameter(
            torch.empty(dim, in_chans, patch, patch, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.cls = nn.Parameter(torch.zeros(1, 1, dim, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, dim, device=device))

    def forward(self, x):
        dt, p = self.dtype, self.patch
        x = x.to(dt)
        b, hh, ww, c = x.shape
        hn, wn = hh // p, ww // p
        patches = (x[:, :hn * p, :wn * p]
                   .reshape(b, hn, p, wn, p, c)
                   .permute(0, 1, 3, 5, 2, 4)
                   .reshape(b, hn * wn, c * p * p))
        x = F.linear(patches, self.weight.to(dt).reshape(self.dim, -1),
                     self.bias.to(dt))
        cls = self.cls.to(dt).expand(b, 1, self.dim)
        return torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)


class EncoderBlock(NodeModule):
    """Pre-LN transformer encoder block (residuals kept inside the node, so
    inter-block edges are clean pipeline boundaries)."""

    def __init__(self, dim, heads, mlp_dim, dtype=torch.float32,
                 attn_prefer=None, device=None):
        super().__init__()
        self.ln1 = LayerNorm(dim, dtype, device)
        self.attn = MultiHeadSelfAttention(dim, heads, dtype,
                                           attn_prefer=attn_prefer,
                                           device=device)
        self.ln2 = LayerNorm(dim, dtype, device)
        self.mlp_in = Dense(dim, mlp_dim, dtype, device)
        self.mlp_out = Dense(mlp_dim, dim, dtype, device)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        y = F.gelu(self.mlp_in(self.ln2(x)), approximate="tanh")
        return x + self.mlp_out(y)


class ViTHead(NodeModule):
    """Final LN + CLS-token classifier (the classifier in f32)."""

    def __init__(self, dim, num_classes, dtype=torch.float32, device=None):
        super().__init__()
        self.ln = LayerNorm(dim, dtype, device)
        self.fc = Dense(dim, num_classes, torch.float32, device)

    def forward(self, x):
        return self.fc(self.ln(x)[:, 0].float())


def vit(patch, dim, depth, heads, mlp_dim, num_classes=1000,
        dtype=torch.float32, name="vit", attn_prefer=None, img_size=224,
        device=None, seed=0) -> LayerGraph:
    """A ViT LayerGraph on ``device`` (the CUDA card unless ``"cpu"`` is
    asked for) with random weights from ``seed`` (``layers.init_weights``):
    nodes ``patch_embed``, ``encoder_block_{i}`` and ``head``."""
    dev = resolve_device(device)
    g = LayerGraph(name)
    prev = g.add("patch_embed",
                 PatchEmbed(patch, dim, img_size, dtype=dtype, device=dev),
                 INPUT)
    for i in range(depth):
        prev = g.add(
            f"encoder_block_{i}",
            EncoderBlock(dim, heads, mlp_dim, dtype, attn_prefer, dev),
            prev,
        )
    g.add("head", ViTHead(dim, num_classes, dtype, dev), prev)
    return init_weights(g, seed)


def vit_b16(num_classes=1000, dtype=torch.float32, attn_prefer=None,
            device=None, seed=0) -> LayerGraph:
    """ViT-B/16: patch 16, dim 768, 12 blocks of 12 heads, MLP 3072, on
    224 x 224 x 3 NHWC images (197 tokens)."""
    return vit(16, 768, 12, 12, 3072, num_classes, dtype, name="vit_b16",
               attn_prefer=attn_prefer, img_size=224, device=device,
               seed=seed)


def vit_tiny(num_classes=10, dtype=torch.float32, device=None,
             seed=0) -> LayerGraph:
    """Small ViT for tests (32x32/4 patches, 4 blocks)."""
    return vit(4, 64, 4, 4, 128, num_classes, dtype, name="vit_tiny",
               img_size=32, device=device, seed=seed)


def vit_block_cuts(depth: int, num_stages: int) -> list[str]:
    """Evenly split ``depth`` encoder blocks into ``num_stages`` stages."""
    if num_stages < 2:
        return []
    if num_stages > depth:
        raise ValueError(
            f"cannot split {depth} encoder blocks into {num_stages} stages"
        )
    bounds = []
    for k in range(1, num_stages):
        b = max(1, round(k * depth / num_stages))
        if bounds and b <= bounds[-1]:  # guard banker's-rounding collisions
            b = bounds[-1] + 1
        bounds.append(b)
    return [f"encoder_block_{b - 1}" for b in bounds]
