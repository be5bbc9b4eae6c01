"""The SPMD pipeline schedule over a stack of homogeneous blocks, on one
rank.

Counterpart of ``adapt_tpu/parallel/pipeline_spmd.py``. There, L identical
blocks are stacked (leading dim L), sharded over a ``pp`` mesh axis and run
as a GPipe-style ``scan`` whose activation hand-off is a ``ppermute``, in
a serial or an overlap (double-buffered) schedule; both give bit-identical
outputs. The port runs one rank: both schedules run each microbatch
through the whole block stack in order. A mesh with more than one rank on
an axis raises ``NotImplementedError`` until the pipeline is ported to
``torch.distributed`` (ROADMAP.md item 11).

Layout. The blocks stay ``nn.Module``s (a ``ModuleList``, in the order
they run); :func:`stack_stage_params` gives the JAX package's stacked
layout of their parameters for checkpoints and comparisons. A mesh is a
mapping of axis name to size (``{"dp": 1, "pp": 1}``), or ``None`` for one
rank.
"""

from __future__ import annotations

from collections.abc import Callable, Mapping, Sequence
from typing import Any

import torch


def stack_stage_params(
    per_block_variables: Sequence[Mapping[str, torch.Tensor]],
) -> dict[str, torch.Tensor]:
    """Stack identical-structure per-block ``state_dict``s along a new
    leading axis (the pipeline-shardable layout)."""
    first = per_block_variables[0]
    for i, sd in enumerate(per_block_variables[1:], 1):
        if sd.keys() != first.keys():
            raise ValueError(f"block {i} has other parameters than block 0")
    return {k: torch.stack([sd[k] for sd in per_block_variables])
            for k in first}


def _ranks(mesh: Mapping[str, int] | None, axis: str | None) -> int:
    if mesh is None or axis is None:
        return 1
    if axis not in mesh:
        raise ValueError(f"mesh {dict(mesh)} has no axis {axis!r}")
    n = int(mesh[axis])
    if n > 1:
        raise NotImplementedError(
            f"mesh axis {axis!r} of {n} ranks: the port's pipeline runs on "
            "one rank until torch.distributed is ported (ROADMAP.md item 11)"
        )
    return n


def spmd_pipeline(
    block_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    blocks: Sequence[Any],
    xs: torch.Tensor,
    mesh: Mapping[str, int] | None = None,
    axis: str = "pp",
    batch_axis: str | None = None,
    schedule: str = "serial",
    hop_buffers: int = 2,
) -> torch.Tensor:
    """Run ``xs`` (shape ``[M, mb, ...]``) through the L ``blocks`` in
    order: ``block_fn(blocks[i], x) -> y`` applies one block
    (``y.shape == x.shape``). On one rank the serial and overlap schedules
    both run microbatch by microbatch through the whole stack, so their
    outputs are the same."""
    if schedule not in ("serial", "overlap"):
        raise ValueError(
            f"schedule={schedule!r}: expected 'serial' or 'overlap'"
        )
    if schedule == "overlap" and hop_buffers < 2:
        raise ValueError(
            f"hop_buffers must be >= 2 for the overlap schedule, got "
            f"{hop_buffers}"
        )
    num_ranks = _ranks(mesh, axis)
    _ranks(mesh, batch_axis)
    if len(blocks) % num_ranks:
        raise ValueError(
            f"stacked block count {len(blocks)} not divisible by pipeline "
            f"ranks {num_ranks}"
        )
    ys = []
    for x in xs:
        for blk in blocks:
            x = block_fn(blk, x)
        ys.append(x)
    return torch.stack(ys)


def spmd_pipeline_from_config(
    block_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    blocks: Sequence[Any],
    x: torch.Tensor,
    mesh: Mapping[str, int] | None,
    config,
    axis: str = "pp",
    batch_axis: str | None = None,
) -> torch.Tensor:
    """``spmd_pipeline`` driven by a :class:`adapt_tpu_torch.config.
    PipelineConfig`: splits the ``[B, ...]`` batch into
    ``config.microbatches`` and runs its schedule / hop_buffers knobs."""
    xs = pipeline_microbatch(x, config.microbatches)
    y = spmd_pipeline(
        block_fn, blocks, xs, mesh, axis=axis, batch_axis=batch_axis,
        schedule=config.schedule, hop_buffers=config.hop_buffers,
    )
    return pipeline_unmicrobatch(y)


def pipeline_microbatch(x: torch.Tensor, num_micro: int) -> torch.Tensor:
    """``[B, ...] -> [M, B/M, ...]`` microbatch split (a view)."""
    if x.shape[0] % num_micro:
        raise ValueError(
            f"batch {x.shape[0]} not divisible by {num_micro} microbatches"
        )
    return x.reshape(num_micro, x.shape[0] // num_micro, *x.shape[1:])


def pipeline_unmicrobatch(y: torch.Tensor) -> torch.Tensor:
    """``[M, mb, ...] -> [B, ...]``."""
    return y.reshape(y.shape[0] * y.shape[1], *y.shape[2:])
