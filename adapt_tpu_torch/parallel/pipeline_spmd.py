"""The SPMD pipeline schedule over a stack of homogeneous blocks, over the
ranks of a mesh axis.

Counterpart of ``adapt_tpu/parallel/pipeline_spmd.py``. There, L identical
blocks are stacked (leading dim L), sharded over a ``pp`` mesh axis and run
as one ``shard_map`` program: a ``scan`` over ticks whose activation
hand-off is a ``ppermute``. Here one process drives every rank of a
:class:`~adapt_tpu_torch.core.mesh.Mesh` (``parallel/sharding``'s single
controller): rank p runs blocks ``[p L/P, (p + 1) L/P)`` on its mesh
entry's device, the ticks are a Python loop in the reference's order, and
the hop is ``parallel.ring_attention.ring_pass``, the one transport. A
(rank, tick) with no valid microbatch runs nothing, where a lockstep
program computes on garbage. Autograd flows through the loop, so the same
schedule backs the pipelined train step (``parallel/train``).

Two schedules, one body:

- ``schedule="serial"`` (GPipe): at tick t rank p runs microbatch t - p,
  and rank p + 1 consumes its output at tick t + 1. T = M + P - 1.
- ``schedule="overlap"`` (double-buffered): each rank keeps its last
  ``d = hop_buffers - 1`` outputs in a circular buffer and at tick t sends
  the one computed d ticks ago, so a hop lands d + 1 ticks after its
  compute: rank p runs microbatch t - p (d + 1), and
  T = M + (P - 1)(d + 1). On cards where a hop takes time it hides under
  the next microbatch's compute; every microbatch still runs the same
  blocks in the same order, so the outputs are bit-identical to serial.

``batch_axis`` splits each microbatch's rows over that mesh axis (dp x pp
in one call). A rank holds one copy of its blocks, so the batch shards of
one rank must name one device; pipeline ranks may name distinct ones.

Layout. The blocks stay ``nn.Module``s (a sequence, in the order they
run); :func:`stack_stage_params` gives the JAX package's stacked layout of
their parameters for checkpoints and comparisons. ``mesh=None`` is one
rank on the input's device.
"""

from __future__ import annotations

from collections.abc import Callable, Mapping, Sequence
from typing import Any

import torch

from adapt_tpu_torch.core.mesh import Mesh
from adapt_tpu_torch.parallel.ring_attention import ring_pass


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


def rank_devices(mesh: Mesh, axis: str = "pp",
                 batch_axis: str | None = None) -> list[list[torch.device]]:
    """``grid[i][p]``: the device of pipeline rank ``p`` (along ``axis``)
    in batch shard ``i`` (along ``batch_axis``; one shard without it), at
    index 0 of every other axis. Raises when an axis is missing, or when a
    rank's batch shards name distinct devices (one process holds one copy
    of a rank's blocks)."""
    names = mesh.axis_names
    for ax in (axis, batch_axis):
        if ax is not None and ax not in names:
            raise ValueError(f"mesh has no axis {ax!r} (axes: {names})")
    shards = int(mesh.shape[batch_axis]) if batch_axis is not None else 1
    grid = []
    for i in range(shards):
        row = []
        for p in range(int(mesh.shape[axis])):
            idx = [0] * len(names)
            idx[names.index(axis)] = p
            if batch_axis is not None:
                idx[names.index(batch_axis)] = i
            row.append(torch.device(mesh.devices[tuple(idx)]))
        grid.append(row)
    for p in range(len(grid[0])):
        if len({row[p] for row in grid}) > 1:
            raise ValueError(
                f"pipeline rank {p}'s {batch_axis!r} shards name distinct "
                f"devices {[row[p] for row in grid]}: a rank's blocks are "
                "one copy, on one device")
    return grid


def _local(block_fn, stack, h):
    for blk in stack:
        h = block_fn(blk, h)
    return h


def _serial(block_fn, stacks, xs, devices):
    """GPipe: rank p runs microbatch t - p at tick t."""
    ranks, num_micro = len(devices), xs.shape[0]
    outputs = [None] * num_micro
    sent = [None] * ranks
    for t in range(num_micro + ranks - 1):
        recv = ring_pass(sent, devices)
        sent = [None] * ranks
        for p in range(ranks):
            m = t - p
            if not 0 <= m < num_micro:
                continue
            h = xs[m].to(devices[0]) if p == 0 else recv[p]
            y = _local(block_fn, stacks[p], h)
            if p == ranks - 1:
                outputs[m] = y
            else:
                sent[p] = y
    return outputs


def _overlap(block_fn, stacks, xs, devices, d):
    """Double-buffered: rank p runs microbatch t - p (d + 1) at tick t; the
    hop sent at tick t carries the output of tick t - d."""
    ranks, num_micro = len(devices), xs.shape[0]
    outputs = [None] * num_micro
    bufs = [[None] * d for _ in range(ranks)]
    cur = [xs[0]] + [None] * (ranks - 1)
    for t in range(num_micro + (ranks - 1) * (d + 1)):
        recv = ring_pass([buf[t % d] for buf in bufs], devices)
        for p in range(ranks):
            m = t - p * (d + 1)
            y = None
            if 0 <= m < num_micro:
                y = _local(block_fn, stacks[p], cur[p].to(devices[p]))
                if p == ranks - 1:
                    outputs[m], y = y, None
            bufs[p][t % d] = y
        cur = [xs[t + 1] if t + 1 < num_micro else None] + recv[1:]
    return outputs


def spmd_pipeline(
    block_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    blocks: Sequence[Any],
    xs: torch.Tensor,
    mesh: Mesh | None = None,
    axis: str = "pp",
    batch_axis: str | None = None,
    schedule: str = "serial",
    hop_buffers: int = 2,
) -> torch.Tensor:
    """Run ``xs`` (shape ``[M, mb, ...]``) through the L ``blocks``
    pipelined over the ``axis`` ranks of ``mesh``: ``block_fn(blocks[i],
    x) -> y`` applies one block (``y.shape == x.shape``), and
    ``blocks[i]`` must live on the device of rank ``i // (L / P)``. With
    ``batch_axis`` each microbatch's rows split over that axis. Returns
    ``[M, mb, ...]`` on ``xs``'s device. Each tick makes one
    :func:`ring_pass` call a batch shard."""
    if schedule not in ("serial", "overlap"):
        raise ValueError(
            f"schedule={schedule!r}: expected 'serial' or 'overlap'"
        )
    if schedule == "overlap" and hop_buffers < 2:
        raise ValueError(
            f"hop_buffers must be >= 2 for the overlap schedule, got "
            f"{hop_buffers}"
        )
    grid = ([[xs.device]] if mesh is None
            else rank_devices(mesh, axis, batch_axis))
    num_ranks = len(grid[0])
    if len(blocks) % num_ranks:
        raise ValueError(
            f"stacked block count {len(blocks)} not divisible by pipeline "
            f"ranks {num_ranks}"
        )
    if xs.shape[1] % len(grid):
        raise ValueError(
            f"microbatch rows {xs.shape[1]} not divisible by the "
            f"{batch_axis!r} size {len(grid)}")
    per, w = len(blocks) // num_ranks, xs.shape[1] // len(grid)
    stacks = [blocks[p * per:(p + 1) * per] for p in range(num_ranks)]
    outs = []
    for i, devices in enumerate(grid):
        part = xs[:, i * w:(i + 1) * w]
        if schedule == "serial":
            ys = _serial(block_fn, stacks, part, devices)
        else:
            ys = _overlap(block_fn, stacks, part, devices, hop_buffers - 1)
        outs.append(torch.stack([y.to(xs.device) for y in ys]))
    return outs[0] if len(outs) == 1 else torch.cat(outs, 1)


def spmd_pipeline_from_config(
    block_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    blocks: Sequence[Any],
    x: torch.Tensor,
    mesh: Mesh | None,
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
