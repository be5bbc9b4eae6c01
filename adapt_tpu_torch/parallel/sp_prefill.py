"""Sequence-parallel long-context prefill: one prompt, many ranks — the port
of ``adapt_tpu/parallel/sp_prefill.py``.

Chunking bounds a long prompt's per-tick stall and disaggregation moves it
off the decode tier, but the prefill's O(S^2) attention still runs on one
rank. Here the prompt's token axis shards over an ``sp`` ring: every rank
computes its own chunk's projections, rope, quantization and MLP
(token-local math needs no communication), the pool-representation K/V
blocks travel the ring (:func:`ring_collect`: P-1 hops of
``ring_attention.ring_pass``), and each rank computes only its own chunk's
attention rows, as ``CausalSelfAttention.prefill_sp`` does.

The ring keeps ring attention's transport but not its online-softmax
arithmetic: each rank accumulates the rotating blocks into the full window
and computes its rows with the chunk oracle's op order (f32 scores, scale
columns, -1e30 mask, softmax). The pages are therefore what the plain
chunked prefill computes for the same rows. On the card they are not
byte-equal to the batcher's own chunked prefill, whose passes run K4, and
neither are the JAX package's at ulp level (plain f32 attention against
another schedule); the serving-level contract is the streams', held
tie-aware.

One process drives every rank (``core/mesh``): a rank's blocks are tensors
on its mesh entry's device, and on a one-card machine every entry names
that card. The model runs as it is (``tp`` 1) or as the shards of a
``ShardedLM`` (an ``(sp, tp)`` mesh, the kv-head axis of every window block
riding the tp split through the ring, each rank's out-projection partials
reduced in shard order: the tp batcher's math), and, as for tp shards, a
mesh of distinct devices is refused until a multi-card slice can test it.

The sp -> tp transition: :meth:`SPPrefiller.prefill` assembles the K/V
page-major on the host in ONE device->host copy and the caller lands them
through the same ``ContinuousBatcher.adopt_prefill_pages`` path as a
disaggregated handoff (``parallel.sharding.KVHandoffPlan`` per tp shard),
so the request then admits as a prefix-cache hit.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from adapt_tpu_torch import resolve_device
from adapt_tpu_torch.core.mesh import Mesh, MeshMember, MeshSpec, build_mesh
from adapt_tpu_torch.models.transformer_lm import (
    ShardedLM,
    shard_lm,
    validate_tp,
)
from adapt_tpu_torch.parallel.ring_attention import ring_pass
from adapt_tpu_torch.parallel.sharding import Shards, host_copy
from adapt_tpu_torch.utils.profiling import global_compile_sentinel

#: Live prefillers (weak): the ONE "sp.prefill" sentinel watch sums their
#: page-bucket variants, so a second prefiller (or a post-recovery rebuild)
#: aggregates instead of replacing the first one's watch.
_LIVE_PREFILLERS: "weakref.WeakSet[SPPrefiller]" = weakref.WeakSet()


def _family_size():
    live = list(_LIVE_PREFILLERS)
    if not live:
        return None  # no owner left: the sentinel prunes the watch
    return sum(len(pf._variants) for pf in live)


def ring_collect(blocks: list, mesh: Mesh, axis: str = "sp",
                 seq_dim: int = 2) -> list:
    """Every rank's full window of a sequence-sharded tensor: ``blocks``
    holds rank r's block (the sequence slice [r * s, (r + 1) * s) along
    ``seq_dim``) on its device, in rank order. P-1 hops of
    :func:`~adapt_tpu_torch.parallel.ring_attention.ring_pass` rotate the
    blocks around ``axis`` (after i hops rank r holds rank r - i's) while
    each rank writes the arriving block at its global offset: no gather
    primitive, no host staging. Each result is exactly the concatenation
    of the blocks in sequence order."""
    devices = mesh.axis_devices(axis)
    n = len(devices)
    if len(blocks) != n:
        raise ValueError(f"{len(blocks)} blocks for a ring of {n}")
    if n == 1:
        return list(blocks)
    s_local = blocks[0].shape[seq_dim]
    shape = list(blocks[0].shape)
    shape[seq_dim] = n * s_local
    bufs = [torch.empty(shape, dtype=blocks[0].dtype, device=d)
            for d in devices]
    cur = list(blocks)
    for i in range(n):
        for r in range(n):
            src = (r - i) % n
            bufs[r].narrow(seq_dim, src * s_local, s_local).copy_(cur[r])
        if i < n - 1:
            cur = ring_pass(cur, devices)
    return bufs


class SPPrefiller:
    """The sequence-parallel prefill: one sp-sharded whole-span pass per
    prompt over power-of-two page buckets, producing page-major host K/V in
    the decode pool's representation — the payload of a
    ``runtime.disagg.KVHandoff``.

    Owns its mesh (axes ``(sp,)`` or ``(sp, tp)``); the decode tier's pool
    layout is reached only through the handoff landing path. Both serving
    entry points drive one: ``ContinuousBatcher`` collocated admission and
    ``runtime.disagg.PrefillWorker.step``. ``health`` (a
    ``control.registry.DeviceHealthMonitor``) makes a prefill over a dead
    member raise, as a dispatch onto a lost device does."""

    def __init__(self, lm, mesh: Mesh, page_size: int,
                 kv_cache_dtype: str = "native", sp_axis: str = "sp",
                 tp_axis: str | None = None, name: str = "sp0", health=None):
        if sp_axis not in mesh.shape:
            raise ValueError(f"mesh has no {sp_axis!r} axis (axes: "
                             f"{tuple(mesh.axis_names)})")
        self.sp = int(mesh.shape[sp_axis])
        if self.sp < 2:
            raise ValueError(
                f"sp axis {sp_axis!r} has size {self.sp}; a ring needs at "
                "least 2 ranks (sp=1 is the ordinary prefill path)")
        if tp_axis is not None:
            if tp_axis not in mesh.shape:
                raise ValueError(f"mesh has no {tp_axis!r} axis (axes: "
                                 f"{tuple(mesh.axis_names)})")
            self.tp = int(mesh.shape[tp_axis])
            validate_tp(lm, self.tp)
        else:
            self.tp = 1
        if kv_cache_dtype not in ("native", "int8", "int4"):
            raise ValueError(f"kv_cache_dtype={kv_cache_dtype!r}: expected "
                             "'native', 'int8' or 'int4'")
        if any(b.moe_experts is not None for b in lm.blocks):
            raise ValueError("MoE blocks have no sequence-parallel prefill")
        devs = set(mesh.devices.flat)
        if len(devs) > 1:
            raise ValueError(
                f"the sp mesh names distinct devices {sorted(map(str, devs))}:"
                " its ranks run on one device (a mesh naming it sp x tp "
                "times)")
        self.device = next(iter(devs))
        self._model = self._place(lm, tp_axis)
        block0 = self._model.blocks[0]
        self._heads, self._head_dim = block0.cache_heads, block0.head_dim
        if kv_cache_dtype == "int4" and self._head_dim % 2:
            raise ValueError(f"kv_cache_dtype='int4' needs an even head_dim, "
                             f"got {self._head_dim}")
        self.name = name
        self.page_size = page_size
        self.kv_cache_dtype = kv_cache_dtype
        self.quantized = kv_cache_dtype != "native"
        self._mesh = mesh
        self._sp_axis = sp_axis
        self._tp_axis = tp_axis
        self._health = health
        self._member_ids = {m.id for m in mesh.members()}
        self._variants: set[int] = set()
        self.prefill_tokens = 0
        self.prefills = 0
        _LIVE_PREFILLERS.add(self)
        global_compile_sentinel().register("sp.prefill",
                                           size_fn=_family_size)

    def _place(self, lm, tp_axis):
        """The model the ranks run: ``lm`` itself at tp 1; at tp > 1 a
        ``ShardedLM`` of the ring's tp width on the ring's device (``lm``
        when it is one, else ``shard_lm`` of it)."""
        if self.tp == 1:
            if isinstance(lm, ShardedLM):
                raise ValueError("a ring without a tp axis serves an "
                                 "unsharded LM")
            if lm.device != self.device:
                raise ValueError(f"the model is on {lm.device}, the ring on "
                                 f"{self.device}")
            return lm
        if isinstance(lm, ShardedLM):
            if lm.tp != self.tp or lm.device != self.device:
                raise ValueError(
                    f"the ShardedLM runs {lm.tp} shards on {lm.device}, not "
                    f"the ring's tp={self.tp} on {self.device}")
            return lm
        return shard_lm(lm, build_mesh(MeshSpec(((tp_axis, self.tp),)),
                                       [self.device] * self.tp), tp_axis)

    @property
    def variants(self) -> set[int]:
        """Page buckets this prefiller has run: the recovery allowance
        accounting (``recover()`` re-arms the sentinel for their number)."""
        return set(self._variants)

    def covers(self, prompt_len: int) -> int:
        """Full pages an sp prefill of this prompt produces (0: nothing to
        do; the partial last page always re-prefills as the decode side's
        suffix pass, as after a disaggregated handoff)."""
        return max(0, (prompt_len - 1) // self.page_size)

    @torch.no_grad()
    def prefill(self, prompt) -> tuple[int, list]:
        """Run the sp-sharded prefill of ``prompt``'s full pages. Returns
        ``(n_pages, blocks)``: one page-major ``(K, V)`` pair per decoder
        block, each member an ``(n_pages, kv_h, page, w)`` host tensor (a
        ``(values, scales)`` tuple of them on a quantized pool) — what
        ``ContinuousBatcher.adopt_prefill_pages`` and
        ``runtime.disagg.KVHandoff`` take. The window is the page count
        padded to a power of two (trailing zero tokens, which no real row
        attends), split evenly over the ranks."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        s0, pg = prompt.shape[0], self.page_size
        m = (s0 - 1) // pg
        if m < 1:
            raise ValueError(f"prompt of {s0} tokens has no full {pg}-token "
                             "page to sp-prefill")
        if self._health is not None:
            lost = self._health.dead_ids() & self._member_ids
            if lost:
                raise RuntimeError(f"sp ring {self.name}: member(s) "
                                   f"{sorted(lost)} lost")
        nb = 1
        while nb < m:
            nb *= 2
        S = nb * pg
        if S % self.sp:
            raise ValueError(f"window of {S} tokens not divisible by "
                             f"sp={self.sp}")
        self._variants.add(nb)
        ids = np.zeros((1, S), np.int64)
        ids[0, :m * pg] = prompt[:m * pg]
        ids_t = torch.as_tensor(ids).to(self.device)
        sl = S // self.sp
        emb = self._model.embed
        hs = [emb.embed_positions(
            ids_t[:, r * sl:(r + 1) * sl],
            r * sl + torch.arange(sl, device=self.device)[None])
            for r in range(self.sp)]

        def gather(blocks):
            return ring_collect(blocks, self._mesh, self._sp_axis)

        qflag = self.kv_cache_dtype if self.quantized else False
        outs = []
        for block in self._model.blocks:
            hs, ck, cv = block.prefill_sp(hs, gather, qflag)
            outs.append((ck, cv))
        blocks = self._page_major(outs, nb, m)
        self.prefill_tokens += m * pg
        self.prefills += 1
        return m, blocks

    def _page_major(self, outs, nb: int, m: int) -> list:
        """Per block and member, the ranks' (1, kv_h, S/P, w) pieces (tp
        pieces per rank under an ``(sp, tp)`` mesh) fetched in ONE
        device->host copy, then concatenated on the host in sequence (and
        head) order and cut into ``m`` page-major ``(m, kv_h, page, w)``
        pages."""
        def planes(member):  # rank -> [plane][tp piece]
            out = []
            for x in member:
                pieces = list(x) if isinstance(x, Shards) else [x]
                n = 2 if isinstance(pieces[0], tuple) else 1
                out.append([[pc[i] if n == 2 else pc for pc in pieces]
                            for i in range(n)])
            return out

        layout = [[planes(member) for member in pair] for pair in outs]
        flat = [t for pair in layout for member in pair for rank in member
                for plane in rank for t in plane]
        it = iter(host_copy(flat))
        kvh, pg = self._heads, self.page_size

        def page_major(t):  # (1, kv_h, S, w) -> (m, kv_h, page, w)
            a = t[0].reshape(kvh, nb, pg, t.shape[-1])
            return a.transpose(0, 1)[:m].contiguous()

        blocks = []
        for pair in layout:
            got = []
            for member in pair:
                # member[rank][plane][piece], filled in the fetch's order.
                host = [[[next(it) for _ in plane] for plane in rank]
                        for rank in member]
                nplanes = len(host[0])
                whole = [page_major(torch.cat(
                    [torch.cat(rank[i], dim=1) for rank in host], dim=2))
                    for i in range(nplanes)]
                got.append(tuple(whole) if self.quantized else whole[0])
            blocks.append(tuple(got))
        return blocks

    def close(self) -> None:
        """Retire this prefiller: its variants leave the aggregate sentinel
        watch."""
        _LIVE_PREFILLERS.discard(self)
        self._variants.clear()


def build_sp_mesh(sp_width: int, tp: int = 1, sp_axis: str = "sp",
                  tp_axis: str = "tp", devices=None) -> Mesh:
    """An ``(sp,)`` or ``(sp, tp)`` mesh of ``sp_width * tp`` entries — the
    mesh the serving entry points build when handed a ``PrefillConfig``
    without one. ``devices=None`` is the CUDA card at every position (as in
    ``core.mesh.build_mesh``, raising without one). Member ids are flat
    positions, so members 0..tp-1 are those of a default tp mesh; entries
    of ``devices`` that are ``MeshMember`` s keep their ids (a recovery's
    rebuild from survivors). Raises when too few entries are given."""
    need = sp_width * tp
    if devices is None:
        pool = [MeshMember(i, resolve_device(None)) for i in range(need)]
    else:
        pool = [d if isinstance(d, MeshMember)
                else MeshMember(i, resolve_device(d))
                for i, d in enumerate(devices)]
    if len(pool) < need:
        raise ValueError(f"sp_width={sp_width} x tp={tp} needs {need} "
                         f"devices; have {len(pool)}")
    pool = pool[:need]
    shape = (sp_width, tp) if tp > 1 else (sp_width,)
    axes = (sp_axis, tp_axis) if tp > 1 else (sp_axis,)
    devs = np.empty(need, dtype=object)
    devs[:] = [m.device for m in pool]
    return Mesh(devs.reshape(shape), axes,
                np.asarray([m.id for m in pool]).reshape(shape))


__all__ = ["SPPrefiller", "build_sp_mesh", "ring_collect"]
