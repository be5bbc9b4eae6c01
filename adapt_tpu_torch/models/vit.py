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

:func:`shard_vit` runs the ViT as tensor-parallel shards of a mesh axis
driven by one process (``parallel/sharding``), with the batch over a ``dp``
axis: each encoder block cut by ``parallel.sharding.vit_tp_rules``, each
shard's attention (K1) over its heads/tp heads, the attn-out and mlp-out
partials summed in f32 by ``reduce_shards`` and their biases added once
after the sum (the LM's ``ShardedBlock`` pattern).
"""

from __future__ import annotations

from collections.abc import Callable

import torch
import torch.nn.functional as F
from torch import nn

from adapt_tpu_torch import resolve_device
from adapt_tpu_torch.convert import shard_state_dict
from adapt_tpu_torch.graph.ir import INPUT, LayerGraph, NodeModule, rebuild
from adapt_tpu_torch.models.layers import Dense, init_weights
from adapt_tpu_torch.models.transformer_lm import (
    LayerNorm,
    _load,
    _Pieces,
    _reduced,
)
from adapt_tpu_torch.ops.attention import flash_attention
from adapt_tpu_torch.parallel.sharding import shard_batch, vit_tp_rules


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
        return self.out(self.attend(x))

    def attend(self, x):
        """Attention over ``self.heads`` heads of ``qkv(x)``, before the
        out projection: ``(b, s, heads * head_dim)``."""
        b, s, _ = x.shape
        q, k, v = self.qkv(x).view(b, s, 3, self.heads, -1).unbind(2)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        if self.attn_fn is None:
            o = flash_attention(q, k, v, prefer=self.attn_prefer)
        else:
            o = self.attn_fn(q, k, v)
        return o.transpose(1, 2).reshape(b, s, -1)


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


class _PartialDense(nn.Module):
    """A shard's input-column slice of a :class:`Dense` without its bias:
    the product of the ``dtype``-cast operands with an f32 result, so that
    the sum over shards is rounded once, after the reduction. A 16-bit
    product on the card accumulates on the tensor cores as the whole
    projection does (``torch.mm(..., out_dtype=float32)``, unrounded);
    elsewhere it is an f32 product of the cast operands."""

    def __init__(self, weight, dtype):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        x, w = x.to(dt), self.weight.to(dt)
        if not x.is_cuda or dt == torch.float32:
            return F.linear(x.float(), w.float())
        flat = torch.mm(x.reshape(-1, x.shape[-1]), w.t(),
                        out_dtype=torch.float32)
        return flat.reshape(*x.shape[:-1], w.shape[0])


class ShardedEncoderBlock(nn.Module):
    """An :class:`EncoderBlock` run as ``n`` tensor-parallel shards in
    lockstep on one device: the LayerNorms once; each shard's qkv rows of
    its heads/n heads (``Blocks("tp", 3)``) and its attention; its rows of
    ``mlp_in``; the attn-out and mlp-out column slices' f32 partials summed
    in shard order and the biases added once after."""

    def __init__(self, blk: EncoderBlock, pre: str, piece, n: int):
        super().__init__()
        a = blk.attn
        if a.heads % n or blk.mlp_in.weight.shape[0] % n:
            raise ValueError(f"{pre}: heads {a.heads} / mlp hidden "
                             f"{blk.mlp_in.weight.shape[0]} not divisible "
                             f"by tp={n}")
        dt = a.qkv.dtype
        self.ln1 = _load(LayerNorm(blk.ln1.scale.shape[0], blk.ln1.dtype,
                                   "meta"), piece.sub(pre + ".ln1", 0))
        self.ln2 = _load(LayerNorm(blk.ln2.scale.shape[0], blk.ln2.dtype,
                                   "meta"), piece.sub(pre + ".ln2", 0))
        dim = a.qkv.weight.shape[1]
        self.attn_shards = nn.ModuleList()
        self.mlp_shards = nn.ModuleList()
        for s in range(n):
            sh = MultiHeadSelfAttention(dim, a.heads, dt, a.attn_fn,
                                        a.attn_prefer, "meta")
            sh.heads = a.heads // n
            sh.qkv = _load(Dense(dim, 3 * dim // n, dt, "meta"),
                           piece.sub(pre + ".attn.qkv", s))
            sh.out = _PartialDense(piece(pre + ".attn.out.weight", s), dt)
            self.attn_shards.append(sh)
            hid = piece(pre + ".mlp_in.weight", s).shape[0]
            self.mlp_shards.append(nn.ModuleDict(dict(
                mlp_in=_load(Dense(dim, hid, blk.mlp_in.dtype, "meta"),
                             piece.sub(pre + ".mlp_in", s)),
                mlp_out=_PartialDense(piece(pre + ".mlp_out.weight", s),
                                      blk.mlp_out.dtype))))
        self.out_bias = nn.Parameter(piece(pre + ".attn.out.bias", 0), False)
        self.mlp_bias = nn.Parameter(piece(pre + ".mlp_out.bias", 0), False)
        self.dtypes = (dt, blk.mlp_out.dtype)

    def forward(self, x):
        h = self.ln1(x)
        parts = [sh.out(sh.attend(h)) for sh in self.attn_shards]
        x = x + _reduced(parts, self.dtypes[0], self.out_bias.to(
            self.dtypes[0]))
        h = self.ln2(x)
        parts = [m["mlp_out"](F.gelu(m["mlp_in"](h), approximate="tanh"))
                 for m in self.mlp_shards]
        return x + _reduced(parts, self.dtypes[1], self.mlp_bias.to(
            self.dtypes[1]))


class ShardedViT(nn.Module):
    """A ViT ``LayerGraph`` run as tensor-parallel shards of ``axis`` with
    the batch over ``batch_axis`` (:func:`shard_vit`): the patch embedding
    and the head once, every encoder block a :class:`ShardedEncoderBlock`.
    One process runs every shard and every batch shard on the one device
    the mesh names."""

    def __init__(self, graph: LayerGraph, state: dict, mesh, axis: str,
                 batch_axis: str | None):
        super().__init__()
        devices = set(mesh.devices.flat)
        if len(devices) > 1:
            raise ValueError(f"the mesh names distinct devices {devices}: "
                             "tp shards run on one device")
        self.mesh, self.axis, self.batch_axis = mesh, axis, batch_axis
        self.tp = int(mesh.shape[axis])
        piece = _Pieces(state, mesh.axis_positions(axis), axis)
        self.embed = _load(rebuild(graph.node("patch_embed").module, "meta"),
                           piece.sub("layers.patch_embed", 0))
        names = [n for n in graph.topo_order() if n.startswith(
            "encoder_block_")]
        self.blocks = nn.ModuleList(
            ShardedEncoderBlock(graph.node(n).module, f"layers.{n}", piece,
                                self.tp) for n in names)
        self.head = _load(rebuild(graph.node("head").module, "meta"),
                          piece.sub("layers.head", 0))

    def forward(self, x):
        """Logits of ``x``: its rows cut over ``batch_axis`` (each cut on
        its own), concatenated in order."""
        if self.batch_axis is None:
            parts = [x]
        else:
            shards = shard_batch(x, self.mesh, self.batch_axis)
            parts = [shards[k] for k in self.mesh.axis_positions(
                self.batch_axis)]
        outs = []
        for h in parts:
            h = self.embed(h)
            for blk in self.blocks:
                h = blk(h)
            outs.append(self.head(h))
        return torch.cat(outs)


def shard_vit(graph: LayerGraph, mesh, axis: str = "tp",
              batch_axis: str | None = "dp") -> ShardedViT:
    """``graph`` (a :func:`vit`) as tp shards of ``mesh``'s ``axis``, the
    batch over ``batch_axis`` (None, or an axis the mesh lacks: whole),
    its weights cut by ``vit_tp_rules``. Replicated tensors already on the
    mesh's device are shared with ``graph``, not copied."""
    if batch_axis is not None and batch_axis not in mesh.axis_names:
        batch_axis = None
    state = shard_state_dict(graph.state_dict(), mesh,
                             lambda name, ndim: vit_tp_rules(name, ndim, axis))
    return ShardedViT(graph, state, mesh, axis, batch_axis).eval()


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
