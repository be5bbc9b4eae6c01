"""EfficientNet-B0/B4 as LayerGraphs (the multi-branch DAG partition
workload).

Counterpart of ``adapt_tpu/models/efficientnet.py``: blocks with identity
residuals become branch + ``add`` node pairs (real joins); stride- or
channel-changing blocks are single chain nodes. Keras-style block names
(``block{stage}{letter}``) keep cut lists portable. The depthwise convs
are grouped convs with ``groups`` equal to the expanded width.
"""

from __future__ import annotations

import math
import string

import torch

from adapt_tpu_torch import resolve_device
from adapt_tpu_torch.graph.ir import INPUT, LayerGraph
from adapt_tpu_torch.graph.spec import registered_lambda
from adapt_tpu_torch.models.layers import (
    ClassifierHead,
    ConvBN,
    MBConvBranch,
    init_weights,
)

# B0 base architecture: (repeats, in_filters, out_filters, kernel, stride,
# expand_ratio) per stage — EfficientNet paper Table 1.
_B0_STAGES = (
    (1, 32, 16, 3, 1, 1),
    (2, 16, 24, 3, 2, 6),
    (2, 24, 40, 5, 2, 6),
    (3, 40, 80, 3, 2, 6),
    (3, 80, 112, 5, 1, 6),
    (4, 112, 192, 5, 2, 6),
    (1, 192, 320, 3, 1, 6),
)


def _round_filters(filters: int, width_mult: float, divisor: int = 8) -> int:
    filters *= width_mult
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def _round_repeats(repeats: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * repeats))


def efficientnet(width_mult: float, depth_mult: float, num_classes=1000,
                 dtype=torch.float32, name="efficientnet", device=None,
                 seed=0) -> LayerGraph:
    """An EfficientNet on ``device`` (the CUDA card unless ``"cpu"`` is
    asked for) with random weights from ``seed``."""
    dev = resolve_device(device)
    g = LayerGraph(name)
    stem_filters = _round_filters(32, width_mult)
    g.add("stem", ConvBN(3, stem_filters, (3, 3), 2, act="silu",
                         dtype=dtype, device=dev), INPUT)
    prev = "stem"
    in_f = stem_filters
    for stage_idx, (repeats, _, out_f0, kernel, stride, expand) in enumerate(
        _B0_STAGES, start=1
    ):
        out_f = _round_filters(out_f0, width_mult)
        for r in range(_round_repeats(repeats, depth_mult)):
            blk = f"block{stage_idx}{string.ascii_lowercase[r]}"
            s = stride if r == 0 else 1
            branch_mod = MBConvBranch(in_f, out_f, kernel, s, expand,
                                      dtype=dtype, device=dev)
            if s == 1 and in_f == out_f:
                # Identity residual: a real DAG join.
                b = g.add(f"{blk}_branch", branch_mod, prev)
                prev = g.add(f"{blk}_add", registered_lambda("add"),
                             (prev, b))
            else:
                prev = g.add(blk, branch_mod, prev)
            in_f = out_f
    top_filters = _round_filters(1280, width_mult)
    g.add("top_conv", ConvBN(in_f, top_filters, (1, 1), act="silu",
                             dtype=dtype, device=dev), prev)
    g.add("head", ClassifierHead(top_filters, num_classes, dtype, dev),
          "top_conv")
    return init_weights(g, seed)


def efficientnet_b0(num_classes=1000, dtype=torch.float32, device=None,
                    seed=0) -> LayerGraph:
    return efficientnet(1.0, 1.0, num_classes, dtype, "efficientnet_b0",
                        device, seed)


def efficientnet_b4(num_classes=1000, dtype=torch.float32, device=None,
                    seed=0) -> LayerGraph:
    """B4: width x1.4, depth x1.8 (canonical input 380x380)."""
    return efficientnet(1.4, 1.8, num_classes, dtype, "efficientnet_b4",
                        device, seed)
