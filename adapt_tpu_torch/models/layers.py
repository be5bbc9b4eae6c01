"""Shared building blocks of the model zoo: the CNN node modules of
``adapt_tpu/models/layers.py`` and the flax-style ``Dense``.

Every module here is a :class:`~adapt_tpu_torch.graph.ir.NodeModule`: its
constructor arguments are recorded, so a stage, a worker's binding or a
spec can build it again on another device. flax infers a layer's input
width at ``init``; torch allocates at construction, so these take theirs
(``in_features``) explicitly.

Numerics are flax's:

- Tensors are NHWC at every node boundary, as in the JAX package, so
  cut-point activations, ``eval_shapes`` and the ``concat`` merge (last
  axis) match it one for one. Inside :class:`ConvBN` the NHWC tensor is
  viewed as NCHW (``permute(0, 3, 1, 2)`` of a contiguous NHWC tensor is a
  channels_last view, which cuDNN takes without a copy) and the result is
  permuted back.
- Parameters stay f32; a layer casts its input and weights to its compute
  ``dtype`` (flax's ``dtype=``). Called without autograd, a layer keeps
  what it derives from its own tensors (weights in ``dtype``, BatchNorm's
  multiplier) from one call to the next (:class:`Folding`). BatchNorm runs
  in inference mode on its running statistics, in f32, as flax's
  ``_normalize`` does: ``(x - mean) * (rsqrt(var + 1e-5) * scale) +
  bias``, then cast to ``dtype``.
- ``"SAME"`` padding is flax's: for a window ``k`` at stride ``s`` over
  ``n`` positions, ``pad = max((ceil(n / s) - 1) s + k - n, 0)`` with
  ``pad // 2`` before and the rest after, which is asymmetric for even
  windows and for strided windows over some sizes (the ResNet stem's 7x7/2
  conv on 224 pads (2, 3), its 3x3/2 max-pool on 112 (0, 1)). An
  asymmetric pad is an explicit ``F.pad`` (``-inf`` for the max-pool)
  before a padding-0 op; a symmetric one is the op's own ``padding``.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from adapt_tpu_torch.graph.ir import NodeModule

#: flax BatchNorm's default epsilon.
BN_EPS = 1e-5

#: Activations a layer names (``act=``): the JAX package's ``jax.nn``
#: functions (its ``gelu`` is the tanh approximation).
ACTIVATIONS = {
    "relu": F.relu,
    "silu": F.silu,
    "gelu": functools.partial(F.gelu, approximate="tanh"),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
}


def _act(name):
    if name is not None and name not in ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}; have "
                         f"{sorted(ACTIVATIONS)}")
    return name


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """flax ``"SAME"`` padding of one spatial dim: (before, after)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _nchw_same(x, k, s, value=0.0):
    """``x`` (NCHW) padded for a ``k`` x ``k`` window at stride ``s``, and
    the padding left for the op: ``(x, (ph, pw))`` when the pad is
    symmetric, ``(F.pad(x), (0, 0))`` when it is not."""
    (t, b), (left, r) = same_pads(x.shape[2], k[0], s), same_pads(
        x.shape[3], k[1], s)
    if t == b and left == r:
        return x, (t, left)
    return F.pad(x, (left, r, t, b), value=value), (0, 0)


def max_pool_same(x, k: int = 3, s: int = 2):
    """flax ``nn.max_pool(window k, stride s, padding "SAME")`` on NHWC:
    the padding is ``-inf``."""
    y, pad = _nchw_same(x.permute(0, 3, 1, 2), (k, k), s, float("-inf"))
    return F.max_pool2d(y, k, s, pad).permute(0, 2, 3, 1)


class Folding(NodeModule):
    """A node module that derives tensors from its own at each call (a
    weight cast to the compute dtype, BatchNorm's multiplier). Without
    autograd they are computed once and kept while none of the module's
    own parameters and buffers is replaced, moved or changed in place
    (``load_state_dict`` copies in place); with autograd, at every call."""

    def folded(self, make):
        """``make()``, or what it returned last time if nothing changed."""
        if torch.is_grad_enabled():
            return make()
        own = (*self._parameters.values(), *self._buffers.values())
        try:
            versions = tuple(t._version for t in own)
        except RuntimeError:  # inference-mode tensors keep no version
            return make()
        kept = self.__dict__.get("_folded")
        if (kept is None or kept[1] != versions
                or any(a is not b for a, b in zip(kept[0], own))):
            kept = self._folded = (own, versions, make())
        return kept[2]

    def _apply(self, fn, *args, **kwargs):
        self.__dict__.pop("_folded", None)
        return super()._apply(fn, *args, **kwargs)


class Dense(Folding):
    """flax ``nn.Dense(dtype=...)``: f32 ``(out, in)`` weight and bias, cast
    with the input to ``dtype`` for the product."""

    def __init__(self, d_in, d_out, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = torch.nn.Parameter(torch.empty(d_out, d_in,
                                                     device=device))
        self.bias = torch.nn.Parameter(torch.zeros(d_out, device=device))

    def forward(self, x):
        dt = self.dtype
        w, b = self.folded(lambda: (self.weight.to(dt), self.bias.to(dt)))
        return F.linear(x.to(dt), w, b)


class ConvBN(Folding):
    """Conv (no bias, ``"SAME"``) + inference BatchNorm (+ activation): the
    Keras ``X_conv`` / ``X_bn`` pair. ``groups == in_features ==
    features`` is a depthwise conv, weight ``(C, 1, k, k)``."""

    def __init__(self, in_features, features, kernel=(3, 3), strides=1,
                 groups=1, act="relu", dtype=torch.float32, device=None):
        super().__init__()
        kernel = (kernel, kernel) if isinstance(kernel, int) else tuple(kernel)
        self.kernel, self.strides, self.groups = kernel, strides, groups
        self.act, self.dtype = _act(act), dtype
        self.weight = torch.nn.Parameter(torch.empty(
            features, in_features // groups, *kernel, device=device))
        self.scale = torch.nn.Parameter(torch.ones(features, device=device))
        self.bias = torch.nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x):
        dt = self.dtype
        w, mul = self.folded(lambda: (
            self.weight.to(dt), torch.rsqrt(self.var + BN_EPS) * self.scale))
        y, pad = _nchw_same(x.to(dt).permute(0, 3, 1, 2), self.kernel,
                            self.strides)
        y = F.conv2d(y, w, None, self.strides, pad, 1,
                     self.groups).permute(0, 2, 3, 1)
        y = ((y.float() - self.mean) * mul + self.bias).to(dt)
        return y if self.act is None else ACTIVATIONS[self.act](y)


class ResNetStem(NodeModule):
    """7x7/2 conv + 3x3/2 max-pool (Keras ``conv1_*`` + ``pool1_pool``)."""

    def __init__(self, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv = ConvBN(3, 64, (7, 7), 2, dtype=dtype, device=device)

    def forward(self, x):
        return max_pool_same(self.conv(x.to(self.dtype)))


class SpaceToDepthStem(NodeModule):
    """2x2 space-to-depth of the image, then a 4x4/s1 conv over 12 channels
    (the same output shape as the 7x7/s2 conv); the same max-pool after."""

    def __init__(self, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv = ConvBN(12, 64, (4, 4), 1, dtype=dtype, device=device)

    def forward(self, x):
        x = x.to(self.dtype)
        b, h, w, c = x.shape
        if h % 2 or w % 2:
            raise ValueError(
                f"space-to-depth stem needs even H/W, got {h}x{w}")
        x = (x.reshape(b, h // 2, 2, w // 2, 2, c)
             .permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c))
        return max_pool_same(self.conv(x))


class BottleneckBranch(NodeModule):
    """The residual branch of a ResNet bottleneck: 1x1 (stride) -> 3x3 ->
    1x1 (x4 filters), no activation after the last BN."""

    def __init__(self, in_features, filters, strides=1, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.conv0 = ConvBN(in_features, filters, (1, 1), strides,
                            dtype=dtype, device=device)
        self.conv1 = ConvBN(filters, filters, (3, 3), dtype=dtype,
                            device=device)
        self.conv2 = ConvBN(filters, 4 * filters, (1, 1), act=None,
                            dtype=dtype, device=device)

    def forward(self, x):
        return self.conv2(self.conv1(self.conv0(x)))


class Projection(NodeModule):
    """1x1 projection shortcut (Keras ``_0_conv`` / ``_0_bn``)."""

    def __init__(self, in_features, features, strides=1,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.conv = ConvBN(in_features, features, (1, 1), strides, act=None,
                           dtype=dtype, device=device)

    def forward(self, x):
        return self.conv(x)


class ClassifierHead(NodeModule):
    """Global average pool + Dense (Keras ``avg_pool`` + ``predictions``);
    the logits in f32."""

    def __init__(self, in_features, num_classes, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.fc = Dense(in_features, num_classes, torch.float32, device)

    def forward(self, x):
        return self.fc(x.mean(dim=(1, 2)).float())


class SqueezeExcite(Folding):
    """SE gate (EfficientNet): global pool -> 1x1 reduce (bias) -> swish ->
    1x1 expand (bias) -> sigmoid, times the input."""

    def __init__(self, channels, reduced, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        p = torch.nn.Parameter
        self.reduce_weight = p(torch.empty(reduced, channels, 1, 1,
                                           device=device))
        self.reduce_bias = p(torch.zeros(reduced, device=device))
        self.expand_weight = p(torch.empty(channels, reduced, 1, 1,
                                           device=device))
        self.expand_bias = p(torch.zeros(channels, device=device))

    def forward(self, x):
        dt = self.dtype
        rw, rb, ew, eb = self.folded(lambda: (
            self.reduce_weight.to(dt).flatten(1), self.reduce_bias.to(dt),
            self.expand_weight.to(dt).flatten(1), self.expand_bias.to(dt)))
        s = x.mean(dim=(1, 2), keepdim=True).to(dt)
        s = F.silu(F.linear(s, rw, rb))
        s = F.linear(s, ew, eb)
        return x * torch.sigmoid(s)


class MBConvBranch(NodeModule):
    """EfficientNet MBConv body: expand 1x1 (unless ``expand_ratio`` is 1)
    -> depthwise kxk -> SE -> project 1x1 (no activation after project)."""

    def __init__(self, in_filters, out_filters, kernel=3, strides=1,
                 expand_ratio=6, se_ratio=0.25, dtype=torch.float32,
                 device=None):
        super().__init__()
        expanded = in_filters * expand_ratio
        self.expand = (ConvBN(in_filters, expanded, (1, 1), act="silu",
                              dtype=dtype, device=device)
                       if expand_ratio != 1 else None)
        self.depthwise = ConvBN(expanded, expanded, (kernel, kernel),
                                strides, groups=expanded, act="silu",
                                dtype=dtype, device=device)
        self.se = (SqueezeExcite(expanded,
                                 max(1, int(in_filters * se_ratio)), dtype,
                                 device) if se_ratio > 0 else None)
        self.project = ConvBN(expanded, out_filters, (1, 1), act=None,
                              dtype=dtype, device=device)

    def forward(self, x):
        if self.expand is not None:
            x = self.expand(x)
        x = self.depthwise(x)
        if self.se is not None:
            x = self.se(x)
        return self.project(x)


class Cast(NodeModule):
    """Dtype cast node (e.g. f32 input -> bf16 compute at the stem)."""

    def __init__(self, dtype, device=None):
        super().__init__()
        self.dtype = dtype

    def forward(self, x):
        return x.to(self.dtype)


@torch.no_grad()
def init_weights(graph, seed: int = 0):
    """Random weights from ``seed``, drawn on the CPU (the same numbers on
    any device): every weight N(0, 1/fan_in) (flax's lecun_normal without
    truncation; fan_in is the product of all dims but the first: a conv's
    in_channels/groups x k x k), position embeddings N(0, 0.02^2), zero
    biases and CLS token, unit scales. BatchNorm statistics keep their
    construction values (mean 0, var 1)."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in graph.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.endswith("bias") or leaf == "cls":
            p.zero_()
        elif leaf == "scale":
            p.fill_(1.0)
        elif leaf == "pos_embed":
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
        else:
            fan_in = math.prod(p.shape[1:])
            p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(fan_in))
    return graph
