"""Ulysses-style sequence parallelism: the head/sequence swap — the port of
``adapt_tpu/parallel/ulysses.py``.

The second long-context strategy next to
:mod:`adapt_tpu_torch.parallel.ring_attention`. Where ring attention
rotates K/V blocks around the ``sp`` ring (P-1 neighbour hops), Ulysses
re-shards the [B, H, S/P, D] sequence shards into [B, H/P, S, D] head
shards, runs full (unsharded-sequence) attention on each rank's heads and
swaps back: two all-to-alls instead of P-1 hops. One process drives every
rank (``core/mesh``), so each all-to-all is per-rank slicing and a
concatenation in rank order, every piece moved to its destination rank's
device.

Constraint: num_heads % axis_size == 0. The local attention defaults to
:func:`adapt_tpu_torch.ops.attention.flash_attention`: K1 on CUDA tensors
at the post-swap shape [B, H/P, S, D], its plain version on CPU ones. Any
``attn_fn(q, k, v, causal=...)`` overrides.
"""

from __future__ import annotations

from typing import Callable

import torch


def ulysses_attention(q, k, v, mesh, axis: str = "sp", causal: bool = False,
                      attn_fn: Callable | None = None):
    """Sequence-parallel attention via the head/sequence all-to-all.

    q, k, v: [B, H, S, D] global tensors, S and H divisible by the axis
    size; rank r holds sequence shard r on its mesh entry's device, and the
    global output comes back on q's device.
    """
    if attn_fn is None:
        from adapt_tpu_torch.ops.attention import flash_attention

        attn_fn = flash_attention
    num_ranks = int(mesh.shape[axis])
    _, h, s, _ = q.shape
    if s % num_ranks:
        raise ValueError(
            f"sequence {s} not divisible by axis size {num_ranks}")
    if h % num_ranks:
        raise ValueError(f"heads {h} not divisible by axis size {num_ranks}")
    devices = mesh.axis_devices(axis)
    s_local, h_local = s // num_ranks, h // num_ranks

    def to_heads(x):
        # [B, H, S/P, D] on every rank -> [B, H/P, S, D]: rank r gathers
        # head block r of every rank's sequence shard, in rank order.
        seq = [x[:, :, j * s_local:(j + 1) * s_local].to(d)
               for j, d in enumerate(devices)]
        return [torch.cat([seq[j][:, r * h_local:(r + 1) * h_local].to(d)
                           for j in range(num_ranks)], dim=2)
                for r, d in enumerate(devices)]

    qh, kh, vh = to_heads(q), to_heads(k), to_heads(v)
    o = [attn_fn(qh[r], kh[r], vh[r], causal=causal)
         for r in range(num_ranks)]
    # [B, H/P, S, D] -> [B, H, S/P, D]: rank r gathers sequence block r of
    # every rank's heads, in rank order.
    back = [torch.cat([o[j][:, :, r * s_local:(r + 1) * s_local].to(d)
                       for j in range(num_ranks)], dim=1)
            for r, d in enumerate(devices)]
    return torch.cat([t.to(q.device) for t in back], dim=2)
