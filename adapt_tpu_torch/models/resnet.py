"""ResNet-50/101/152 as LayerGraphs with Keras-compatible node names.

Counterpart of ``adapt_tpu/models/resnet.py``: each residual block is three
DAG nodes (branch, projection shortcut on a block's first unit, and the
``add_relu`` merge named ``conv{S}_block{B}_out`` as Keras names its
post-add activation), so the graph has real joins and the JAX package's
cut lists carry over by name. NHWC images in, f32 logits out.
"""

from __future__ import annotations

import torch

from adapt_tpu_torch import resolve_device
from adapt_tpu_torch.graph.ir import INPUT, LayerGraph
from adapt_tpu_torch.graph.spec import registered_lambda
from adapt_tpu_torch.models.layers import (
    BottleneckBranch,
    ClassifierHead,
    Projection,
    ResNetStem,
    SpaceToDepthStem,
    init_weights,
)

#: blocks per stage (conv2..conv5), Keras ResNetXX layouts.
_DEPTHS = {
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}
_FILTERS = (64, 128, 256, 512)


def resnet(depth: int, num_classes: int = 1000, dtype=torch.float32,
           stem: str = "conv7", device=None, seed: int = 0) -> LayerGraph:
    """A ResNet on ``device`` (the CUDA card unless ``"cpu"`` is asked
    for) with random weights from ``seed`` (``layers.init_weights``).
    ``stem='s2d'`` swaps the 7x7/s2 stem conv for the space-to-depth +
    4x4/s1 form; the stem is one node either way, so cut names are
    unchanged."""
    if depth not in _DEPTHS:
        raise ValueError(f"unsupported ResNet depth {depth}; have {list(_DEPTHS)}")
    stems = {"conv7": ResNetStem, "s2d": SpaceToDepthStem}
    if stem not in stems:
        raise ValueError(f"unknown stem {stem!r}; have {sorted(stems)}")
    dev = resolve_device(device)
    g = LayerGraph(f"resnet{depth}")
    g.add("stem", stems[stem](dtype=dtype, device=dev), INPUT)
    prev, width = "stem", 64
    for stage_idx, (blocks, filters) in enumerate(
        zip(_DEPTHS[depth], _FILTERS), start=2
    ):
        for b in range(1, blocks + 1):
            name = f"conv{stage_idx}_block{b}"
            strides = 2 if (b == 1 and stage_idx > 2) else 1
            branch = g.add(
                f"{name}_branch",
                BottleneckBranch(width, filters, strides, dtype, dev),
                prev,
            )
            if b == 1:
                shortcut = g.add(
                    f"{name}_short",
                    Projection(width, 4 * filters, strides, dtype, dev),
                    prev,
                )
            else:
                shortcut = prev
            prev = g.add(f"{name}_out", registered_lambda("add_relu"),
                         (shortcut, branch))
            width = 4 * filters
    g.add("head", ClassifierHead(width, num_classes, dtype, dev), prev)
    return init_weights(g, seed)


def resnet50(num_classes=1000, dtype=torch.float32, stem="conv7",
             device=None, seed=0) -> LayerGraph:
    return resnet(50, num_classes, dtype, stem, device, seed)


def resnet101(num_classes=1000, dtype=torch.float32, stem="conv7",
              device=None, seed=0) -> LayerGraph:
    return resnet(101, num_classes, dtype, stem, device, seed)


def resnet152(num_classes=1000, dtype=torch.float32, stem="conv7",
              device=None, seed=0) -> LayerGraph:
    return resnet(152, num_classes, dtype, stem, device, seed)


#: ResNet-50 in 3 stages: boundaries at the outputs of the blocks before
#: conv3_block1 and conv4_block1.
RESNET50_3STAGE_CUTS = ("conv2_block3_out", "conv3_block4_out")

#: ResNet-152 in 8 stages.
RESNET152_8STAGE_CUTS = (
    "conv2_block3_out",
    "conv3_block4_out",
    "conv3_block8_out",
    "conv4_block9_out",
    "conv4_block18_out",
    "conv4_block27_out",
    "conv4_block36_out",
)
