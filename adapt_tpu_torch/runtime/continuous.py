"""Continuous batching: requests join and leave a RUNNING decode batch —
the port of ``adapt_tpu/runtime/continuous.py``'s :class:`ContinuousBatcher`
for native caches, on both KV layouts.

- A fixed number of SLOTS decode in lockstep. With ``kv_layout="slots"``
  each slot owns a dense KV strip of ``max_len + 1`` positions per block;
  position ``max_len`` is the trash slot where idle rows park their
  garbage writes (K2 masks by each row's own index, and serves the odd
  strip length directly).
- With ``kv_layout="paged"`` the KV lives in per-block page POOLS
  ``(pool_pages, kv_h, page_size, hd)`` shared by every slot through a
  ``runtime/paged.Pager`` page table, so memory scales with resident
  tokens. Decode runs K3 over the table (re-uploaded only when it
  changed); idle and mid-prefill rows sit at the negative sentinel
  ``-(chunk + 1)`` and write to trash page 0. Admission probes the
  content-keyed PREFIX CACHE (full prompt pages shared by refcount, an
  all-or-nothing reservation of the rest, FIFO head-of-line waiting when
  the pool is short); a hit prefills only the suffix through
  ``prefill_chunk_paged`` (K4). ``prefill_chunk`` spreads a long prompt
  over one K4 pass per tick, interleaved with the decode batch.
  Sliding-window models return pages behind the window mid-request.
  ``submit_fanout`` serves n continuations of one prompt, greedy
  siblings forking the shared last prompt page copy-on-write.
- ``kv_cache_dtype`` ``"int8"`` / ``"int4"`` makes every strip or pool a
  ``(values, scales)`` pair (int8 values, or int4 packed two per byte, and
  one f32 scale per vector): quantization is a property of the cache
  layout, so admission, prefix sharing, chunked prefill, window recycling
  and CoW forks move both planes, and the kernels read the quantized
  bytes (K2q, K3q, K4q). Prefix-hit and chunked passes attend the already
  quantized window; whole-prompt admissions equal ``generate()`` with the
  same ``kv_cache_dtype``. ``stats()`` reports ``cache_bytes`` over both
  planes and ``cache_bytes_ratio`` against the native cache.
- One tick admits queued requests into free slots (a prefill per
  admission, padded to a power-of-two bucket, through K1), then runs
  ``chunk`` decode steps (K2 or K3) over every slot and syncs with the
  host ONCE, to fetch the chunk's tokens and logprobs. Requests finishing
  mid-chunk decode a garbage tail the host drops.
- Per-slot sampling state (last token, position, temperature, top-k,
  top-p, seed, key counter, active mask) lives in device tensors, written
  at admission and retirement only; every host->device copy goes through
  :meth:`_h2d`, so ``stats()["h2d_transfers"]`` shows a steady tick
  stages nothing.
- Exact per-request streams: a token is keyed by (request seed, row 0,
  token index), as ``models.transformer_lm.generate`` keys a prompt run
  alone, so a request's stream equals ``generate()`` for it alone.

Lifecycle: ``submit`` / ``tick`` / ``run`` / ``cancel`` / ``result`` /
``logprobs`` / ``stats``, and ``start`` / ``stop`` for a server thread.
Request timelines feed the SLO histograms ``continuous.queue_wait_s``,
``continuous.ttft_s``, ``continuous.itl_s`` and
``continuous.request_latency_s``; admit/finish/cancel go to the flight
recorder.

Batched speculative decoding (``draft_lm=`` + ``config.SpeculativeConfig``):
every tick becomes a fixed-shape ``draft_k + 1``-step draft scan over ALL
slots (``models/speculative.draft_chunk`` over the draft's own dense strips,
K2) plus ONE fused verify pass of the target over every slot at its own
position (``verify_chunk`` on dense strips — plain tensor operations, as in
the JAX package — or ``verify_chunk_paged`` on pools, K5), then per-slot
longest-agreeing-prefix acceptance: a slot commits 1 .. ``draft_k + 1``
tokens a tick (``draft_k + 2`` with a tree-draft leaf hit). Rejected
speculation needs no rollback: each layout carries ``draft_k +
tree_width`` slack positions, and entries past the accepted position are
masked until overwritten. Greedy requests stream exactly the target's
argmax whatever the draft proposes; ``temperature > 0`` requests go through
speculative sampling (accept a proposal with the target's own probability
of it, resample a rejection from the residual), lossless in distribution.
A steady speculative tick stages nothing to the device and fetches ONE
packed (tokens, logprobs, accepted) tensor. ``draft_weight_dtype="int8"``
keeps the draft's matrices blockwise int8 (K6), dequantized inside every
draft scan and draft prefill.

Traffic control (``config.SchedulerConfig``, ``runtime/scheduler``): the
submit queue is an :class:`~adapt_tpu_torch.runtime.scheduler.AdmissionQueue`
— a bounded FIFO without a config; with one, priority classes drained by
deficit round-robin over tenants, synchronous :class:`QueueFullError` at
the depth bound and each tenant's burst cap, and a cache-aware pick over
the pager's radix index. ``submit(slo=config.SLOSpec(...))`` attaches a
TTFT / ITL budget, a tenant and a priority: the commit path judges the
budgets (``slo.*`` counters and attainment gauges,
``continuous.good_tokens_total`` and ``continuous.goodput_tokens_s``).
When a waiting request has burned ``preempt_ttft_fraction`` of its TTFT
budget and no slot (or, paged, no page) would free otherwise, the
lowest-priority decode slot is PREEMPTED through the replay path: its pages
go to the prefix LRU, the request re-queues at the front and re-admits as a
prefix hit, and ``stream_skip`` keeps ``on_token`` exactly-once across its
lives (a regenerated token that differs from the one delivered is counted
in ``stats()["regen_mismatches"]``, never hidden). The
``DegradationController`` steps once a tick: ``draft_k`` halved, the
disaggregated busy threshold (a no-op: no ``DisaggServer`` yet), cold
prefix pages evicted, best-effort submits rejected.

The pipelined tick (``config.RuntimeConfig(pipeline_depth=2)``): ``tick()``
is a DISPATCH half (ladder step, admission, cancels, prefill passes, the
decode or speculative pass, and its one device->host fetch started into a
pinned host buffer of its own with a recorded CUDA event) and a COMMIT
half (wait for the fetch, apply per-slot commits). At depth 1 they run
back to back; at depth 2 ``tick()`` dispatches tick t and then commits
tick t-1 while t runs on the card. A slot whose binding changed since
dispatch (retired, cancelled, preempted, re-admitted) has its column
dropped at commit. Host->device staging goes through pinned buffers with
``non_blocking`` copies, so nothing in a steady dispatch half waits for
the card. ``drain()`` commits the tick in flight; ``run()``, ``stop()``
and ``close()`` are the pipeline's boundaries. ``runtime.overlap_ratio``
is 1 - (time blocked on the fetch) / (dispatch-to-commit wall).

The host KV tier (``cache_tier=config.CacheTierConfig(...)``, paged
pools): an rc=0 prefix page the pool evicts SPILLS to a
``runtime/paged.HostKVTier`` (per-tick budget, watermark pre-spill before
admission) under its content key, and admission READMITS the request's
longest run of host-resident prefix pages through ``Pager.adopt_cached``
before its prefix probe, so they share as ordinary prefix hits. The
disaggregated handoff (``runtime/disagg``) lands through the same path:
:meth:`ContinuousBatcher.adopt_prefill_pages`. ``cache_tier.*`` counters,
the ``memory.host_bytes`` / ``memory.pages_spilled`` gauges and
``continuous.prefill_stall_s`` (decode delay spent on in-tick prefill
while requests were decoding) are the books.

Tensor-parallel serving (``mesh=`` + ``config.ParallelConfig(tp)``): the
batcher runs the LM as ``tp`` shards of the mesh's ``tp`` axis, driven in
lockstep by this one process (``models/transformer_lm.shard_lm``; the
mesh names one card several times, and a mesh of distinct cards is
refused until a multi-card slice can test it). Each shard holds its heads/tp query and
KV heads, its MLP hidden slice and its own CONTIGUOUS KV cache — dense
strips or page pools ``(…, kv_heads / tp, …)``, a quantized pair's two
members alike — so every attention kernel runs at the shard's head count
on that shard's tensors, and each shard holds the logical KV bytes / tp.
The partial sums of attn-out, mlp-out and the head reduce in shard order
(``parallel/sharding.reduce_shards``). Page tables, the sampling state,
staged admission vectors and the speculative draft stay replicated on the
lead (shard 0's) device: admission, commit and the pager are
sharding-blind, and a steady tick still stages nothing. The handoff
landing and the host-tier readmit place per-shard slices
(``KVHandoffPlan``); the spill assembles a page from per-shard fetches
(``fetch_head_shards``). A tp=1 mesh runs the single-device path on the
mesh's device.

Elastic recovery (``health=`` a ``control.registry.DeviceHealthMonitor``,
``recovery=config.RecoveryConfig(...)``, ``journal=`` a
``control.journal.DispatcherJournal``): the batcher tracks its mesh's
members by member id (``core.mesh.MeshMember``; shards of one card share
a device) as leases, and a member's ``leave`` queues a loss. The next tick
(or :meth:`ContinuousBatcher.adopt_prefill_pages`) calls :meth:`recover`,
or raises :class:`DeviceLostError` when ``auto_reshard`` is off.
``recover()`` commits the tick in flight, shrinks tp to the largest
divisor of the old tp the survivors can host (not below ``min_tp``),
rebuilds the sharded model at the new tp from the old shards' slices
(``models.transformer_lm.reshard_lm``; a tp=1 remnant is a plain LM on the
survivor's device), moves every block's KV per shard by a
``parallel.sharding.KVReshardPlan`` (the lost shard's heads through the
host) and the replicated state from a surviving member, and re-uploads
the page table at the next paged tick. Decoding slots migrate and
continue; mid-chunked-prefill slots, and every slot under
``policy="replay"``, replay from the journal (payload and sampling meta,
the request's seed included) through the prefix cache, in FIFO order.
Submits are journaled before the request is reachable and done-marked at
finish, drop, queued cancel and rejection. Books: ``stats()``'s
``recoveries`` / ``recovery_*`` keys, the ``recovery.wall_s`` histogram,
``recovery.{migrated,replayed,dropped}_total`` and the ``device_lost``,
``mesh_reshard``, ``kv_migrated`` and ``replayed_from_journal`` flight
events. Recovery builds no kernel.

Sequence-parallel prefill (``prefill=config.PrefillConfig(sp_threshold,
sp_width)``, paged pools): an admission of at least ``sp_threshold``
tokens first prefills its full pages over an ``(sp,)`` or ``(sp, tp)``
ring (``parallel/sp_prefill.SPPrefiller``, on ``sp_mesh`` or a ring of
this batcher's device; its tp must be this batcher's) and lands them
through :meth:`ContinuousBatcher.adopt_prefill_pages`, so the request then
admits as a prefix hit and only its suffix runs here (K4). A failed sp
dispatch falls back to the chunked path, and three in a row retire the
ring until a recovery rebuilds it from the old ring's surviving members
(halving its width while it does not fit); each failure is counted in
``stats()["sp_failures"]`` and a ``sp_prefill`` flight event with ``ok``
False.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import threading
import time
from collections.abc import Callable

import numpy as np
import torch

from adapt_tpu_torch.config import (
    CacheTierConfig,
    CapacityConfig,
    KernelConfig,
    ObservabilityConfig,
    ParallelConfig,
    PrefillConfig,
    RecoveryConfig,
    RuntimeConfig,
    SchedulerConfig,
    SLOSpec,
    SpeculativeConfig,
)
from adapt_tpu_torch.control.registry import weak_watch
from adapt_tpu_torch.models.speculative import (
    accept_speculation,
    draft_chunk,
    speculative_sample,
    swapped_weights,
)
from adapt_tpu_torch.models.transformer_lm import (
    ShardedLM,
    TransformerLM,
    chosen_logprob,
    nucleus_filter,
    reshard_lm,
    sample_rows,
    shard_lm,
    truncate_rows,
    validate_tp,
)
from adapt_tpu_torch.ops.decode_attention import check_head_parity
from adapt_tpu_torch.ops.paged_attention import DEFAULT_PAGE_SIZE
from adapt_tpu_torch.ops.quantize import quantize_params
from adapt_tpu_torch.parallel.sharding import (
    Sharding,
    Shards,
    fetch_head_shards,
    kv_head_sharding,
    member_shards,
    plan_kv_handoff,
    plan_kv_reshard,
)
from adapt_tpu_torch.parallel.sp_prefill import SPPrefiller, build_sp_mesh
from adapt_tpu_torch.runtime.capacity import CapacityModel
from adapt_tpu_torch.runtime.paged import (
    HostKVTier,
    Pager,
    insert_prefill_pages,
)
from adapt_tpu_torch.runtime.scheduler import (
    AdmissionQueue,
    DegradationController,
    QueueFullError,
    request_priority,
    request_tenant,
)
from adapt_tpu_torch.utils.logging import get_logger
from adapt_tpu_torch.utils.metrics import global_metrics
from adapt_tpu_torch.utils.profiling import (
    apply_engine_config,
    global_compile_sentinel,
    global_engine_obs,
    program_work,
    register_memory_source,
    register_roofline_source,
    unregister_memory_source,
    unregister_roofline_source,
    watch_kernel_libraries,
)
from adapt_tpu_torch.utils.tracing import global_flight_recorder, global_tracer

log = get_logger("continuous")

__all__ = ["ContinuousBatcher", "DeviceLostError", "QueueFullError",
           "fanout_seeds"]

_M64 = (1 << 64) - 1


class DeviceLostError(RuntimeError):
    """A member of the batcher's mesh was reported dead and automatic
    resharding is off (``config.RecoveryConfig.auto_reshard=False``), or
    recovery itself is impossible (every member lost, or the survivors
    cannot support ``min_tp``). Call :meth:`ContinuousBatcher.recover`, or
    re-raise to the serving layer."""


def fanout_seeds(seed: int, n: int) -> list[int]:
    """The per-sibling seeds of a sampled :meth:`ContinuousBatcher.
    submit_fanout` group: ``n`` seeds derived deterministically from the
    request's ``seed`` (splitmix64 over ``(seed, sibling)``) — the port's
    counterpart of ``jax.random.split``. A sibling's stream equals
    ``generate()`` under its derived seed."""
    out = []
    for j in range(n):
        z = (int(seed) + (j + 1) * 0x9E3779B97F4A7C15) & _M64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
        out.append((z ^ (z >> 31)) & ((1 << 63) - 1))
    return out


def _members(cache):
    """The tensors of a cache: both planes of a quantized pair; every
    shard's, shard by shard, of a tensor-parallel ``Shards``."""
    if isinstance(cache, Shards):
        return tuple(m for c in cache for m in _members(c))
    return cache if isinstance(cache, tuple) else (cache,)


def _leaves(cache) -> list:
    """A cache's logical leaves: its tensors, or for a ``Shards`` of
    per-shard caches one ``Shards`` per member (values, then scales) over
    the head-split geometry — what ``fetch_head_shards`` reads."""
    if not isinstance(cache, Shards):
        return list(_members(cache))
    return member_shards(cache)


@dataclasses.dataclass
class _Request:
    req_id: int
    prompt: np.ndarray  # (s0,) int64
    steps: int
    temperature: float
    top_k: int  # == vocab -> no truncation
    top_p: float  # == 1.0 -> no nucleus truncation
    eos_id: int | None
    seed: int
    stop: tuple[tuple[int, ...], ...] = ()
    on_token: Callable[[int, int, int], None] | None = None
    #: Tokens already DELIVERED before a replay (preemption) re-queued the
    #: request: the re-run regenerates indices 0..skip-1, which are not
    #: delivered, timed or counted again.
    stream_skip: int = 0
    #: What the client had received when the replay re-queued it: a cancel
    #: landing before the re-run catches up resolves result() with this.
    delivered_tokens: np.ndarray | None = None
    delivered_lps: np.ndarray | None = None
    #: perf_counter of the last token the client received before the
    #: replay: the first new token's ITL gap measures from here.
    t_last_delivered: float = 0.0
    #: perf_counter of the replay's re-queue (0.0 = first life): the
    #: re-admission's queue wait and preemption headroom measure from it.
    t_requeued: float = 0.0
    t_submit: float = 0.0
    #: Optional latency budget, tenant and priority.
    slo: SLOSpec | None = None
    #: Set at the first budget violation and carried across replays.
    slo_violated: bool = False
    #: ``submit_fanout`` group id (-1 = ordinary request), consumed at
    #: admission or queued cancel (so it is never decremented twice).
    fanout_group: int = -1
    #: The capacity plane's submit-time TTFT forecast (0.0 = none); its
    #: realized TTFT closes the calibration loop at the first commit.
    ttft_forecast_s: float = 0.0


@dataclasses.dataclass
class _FanoutGroup:
    """One :meth:`ContinuousBatcher.submit_fanout` group's books.
    ``remaining`` counts siblings not yet admitted (or cancelled); the
    group dies at zero. A GREEDY group records its first admitted
    sibling's last prompt page (``page``, rc-claimed through
    ``Pager.retain`` so it outlives that sibling) and first commit: a
    later sibling whose prefix probe matched every earlier page forks
    that page copy-on-write instead of running the suffix pass. Sampled
    groups leave ``page`` unset (each sibling draws its own first
    token)."""

    remaining: int
    greedy: bool
    page: int | None = None
    first: int | None = None
    first_lp: float | None = None


@dataclasses.dataclass
class _Slot:
    idx: int = -1  # position in the slot list (page-table row)
    req: _Request | None = None
    #: chunked prefill progress: next position to prefill, or -1 when not
    #: mid-prefill (the slot decodes). A slot with pf_done >= 0 holds its
    #: request but sits out the decode batch.
    pf_done: int = -1
    s0: int = 0
    emitted: int = 0
    last_token: int = 0
    tokens: list = dataclasses.field(default_factory=list)
    lps: list = dataclasses.field(default_factory=list)
    t_first: float = 0.0
    t_last: float = 0.0
    obs_count: int = 0
    #: False from the request's first budget violation on: only tokens
    #: committed while True count toward goodput.
    slo_ok: bool = True


class _AsyncFetch:
    """One tick's device->host fetch, split into start / ``ready()`` /
    ``commit()``. ``rows`` (same-shaped tensors) are stacked as f64 and,
    on a CUDA card, copied with ``non_blocking=True`` into a pinned host
    buffer that belongs to this fetch alone, behind a recorded event:
    ``ready()`` is ``event.query()``, ``commit()`` waits on the event and
    returns the numpy array (idempotent). ``wait_s`` is how long commit
    blocked — the part of the device wall the host did not overlap. On the
    CPU the fetch is a plain synchronous copy."""

    __slots__ = ("_host", "_event", "_out", "wait_s")

    def __init__(self, rows):
        packed = torch.stack([r.double() for r in rows])
        self._event = None
        self._out = None
        self.wait_s = 0.0
        if packed.device.type == "cuda":
            self._host = torch.empty(packed.shape, dtype=packed.dtype,
                                     pin_memory=True)
            self._host.copy_(packed, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = None
            self._out = packed.numpy()

    def ready(self) -> bool:
        return self._out is not None or self._event.query()

    def commit(self) -> np.ndarray:
        if self._out is None:
            t0 = time.perf_counter()
            self._event.synchronize()
            self.wait_s = time.perf_counter() - t0
            self._out = self._host.numpy()
            self._event = None
        return self._out


@dataclasses.dataclass
class _InFlight:
    """One dispatched but uncommitted decode tick. ``reqs`` / ``lives``
    capture each slot's binding at dispatch (its request object and its
    ``tokens`` list, the life marker: a preempted request can re-admit
    into the same slot within the one-tick lag): commit applies a slot's
    column only while both still hold, and drops it otherwise (a garbage
    tail, like a mid-chunk finish's)."""

    fetch: _AsyncFetch
    reqs: list = dataclasses.field(default_factory=list)
    lives: list = dataclasses.field(default_factory=list)
    n_active: int = 0
    #: Speculative round: (draft_k_eff, tree_width, active slot indices)
    #: at dispatch — set_draft_k may change the live values mid-lag.
    spec: tuple | None = None
    #: Tracer span start of the decode / verify pass (0.0 = untraced).
    t_span: float = 0.0
    #: perf_counter at dispatch start: runtime.overlap_ratio's wall.
    t0: float = 0.0
    #: Engine-phase open of the decode / verify pass (0.0 = obs off) and
    #: the end of the dispatch half (the commit_lag phase's open).
    t_eo: float = 0.0
    t_dispatched: float = 0.0
    #: The roofline program this tick ran and its passes
    #: (``utils.profiling.program_work``'s input), counted at scrape time
    #: from the active positions at dispatch.
    program: str = ""
    passes: Callable[[], tuple] | None = None


class ContinuousBatcher:
    """Slot-based continuous batching over one LM on one device (the LM's
    device), on dense strips (``kv_layout="slots"``) or a paged pool
    (``"paged"``, with ``page_size``, ``pool_pages`` and
    ``prefill_chunk``). ``top_k`` is the default for requests that pass
    none. ``draft_lm`` (with an optional ``speculative`` config) turns on
    batched speculative decoding; ``scheduler`` traffic control;
    ``runtime`` the pipelined tick; ``observability`` the goodput
    window and the engine knobs (``obs_engine``, ``trace_enabled`` and
    ``compile_warmup``, applied as the ``Dispatcher`` applies them);
    ``capacity`` the capacity plane (``runtime/capacity``, on by default);
    ``cache_tier`` the host KV tier under a paged pool (off by default);
    ``mesh`` / ``parallel`` tensor-parallel shards, and over them
    ``recovery``, ``health`` and ``journal`` elastic recovery (see the
    module docstring and :meth:`recover`); ``prefill`` / ``sp_mesh`` the
    sequence-parallel prefill of long admissions.
    Engine telemetry (``utils/profiling``): the batcher is a memory and a
    roofline source, (re-)registers the compile sentinel's kernel-library
    watch, and times its tick phases when ``global_engine_obs()`` is
    enabled."""

    #: Max UNCLAIMED logprob streams retained (oldest evicted past it).
    _LPS_CAP = 4096

    def __init__(
        self,
        lm: TransformerLM,
        slots: int = 8,
        top_k: int | None = None,
        prompt_buckets: tuple[int, ...] | None = None,
        chunk: int = 8,
        kv_cache_dtype: str = "native",
        kv_layout: str = "slots",
        page_size: int = DEFAULT_PAGE_SIZE,
        pool_pages: int | None = None,
        prefill_chunk: int | None = None,
        kernel: KernelConfig | None = None,
        scheduler: SchedulerConfig | None = None,
        draft_lm: TransformerLM | None = None,
        speculative: SpeculativeConfig | None = None,
        runtime: RuntimeConfig | None = None,
        observability: ObservabilityConfig | None = None,
        capacity: CapacityConfig | None = None,
        cache_tier: CacheTierConfig | None = None,
        mesh=None,
        parallel: ParallelConfig | None = None,
        recovery: RecoveryConfig | None = None,
        health=None,
        journal=None,
        prefill: PrefillConfig | None = None,
        sp_mesh=None,
    ):
        lm = self._setup_parallel(lm, mesh, parallel)
        if kv_cache_dtype not in ("native", "int8", "int4"):
            raise ValueError(
                f"kv_cache_dtype={kv_cache_dtype!r}: expected 'native', "
                "'int8' or 'int4'"
            )
        if kv_layout not in ("slots", "paged"):
            raise ValueError(
                f"kv_layout={kv_layout!r}: expected 'slots' or 'paged'"
            )
        self._paged = kv_layout == "paged"
        if prefill_chunk is not None:
            if not self._paged:
                raise ValueError(
                    "prefill_chunk requires kv_layout='paged' (chunk "
                    "passes run over the page-strip machinery)"
                )
            if prefill_chunk < page_size or prefill_chunk % page_size:
                raise ValueError(
                    f"prefill_chunk must be a positive multiple of "
                    f"page_size {page_size}, got {prefill_chunk}"
                )
        self._prefill_chunk = prefill_chunk
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if top_k is not None and not (1 <= top_k <= lm.vocab):
            raise ValueError(f"top_k {top_k} outside [1, {lm.vocab}]")
        self.lm = lm
        self.device = lm.device
        self._kernel = kernel or KernelConfig()
        if self._kernel.attn_impl == "xla" and self.device.type == "cuda":
            raise ValueError(
                "KernelConfig(attn_impl='xla') selects the plain attention, "
                "which the card's path refuses"
            )
        if speculative is not None and draft_lm is None:
            raise ValueError("speculative config requires draft_lm")
        self._spec = None
        self._draft_lm = draft_lm
        #: The draft's parameters held quantized (int8 draft weights), or
        #: None: the draft module runs on its own tensors.
        self._draft_weights = None
        if draft_lm is not None:
            if draft_lm.vocab != lm.vocab:
                raise ValueError(
                    f"draft vocab {draft_lm.vocab} != target vocab {lm.vocab}"
                )
            if draft_lm.max_len < lm.max_len:
                # The draft prefills the same prompt buckets and decodes
                # the same positions as the target.
                raise ValueError(
                    f"draft max_len {draft_lm.max_len} < target max_len "
                    f"{lm.max_len}"
                )
            if draft_lm.device != lm.device:
                raise ValueError(
                    f"draft on {draft_lm.device} but the target on "
                    f"{lm.device}"
                )
            self._spec = speculative or SpeculativeConfig()
            if self._spec.draft_weight_dtype == "int8":
                # Matrix weights blockwise int8 (K6); the draft scan and
                # the draft prefill dequantize them at use.
                self._draft_weights = quantize_params(draft_lm.state_dict())
        self._spec_k = self._spec.draft_k if self._spec else 0
        #: EFFECTIVE speculation depth (:meth:`set_draft_k`). Cache slack,
        #: table width and reservations stay sized for the CONFIGURED
        #: ``draft_k``, so a shrunk depth never needs a re-layout.
        self._spec_k_eff = self._spec_k
        #: Tree-draft width: w sibling leaf rows per verify chunk.
        self._spec_w = self._spec.tree_width if self._spec else 0
        self._spec_drafted = 0
        self._spec_accepted = 0
        self.slots = [_Slot(idx=i) for i in range(slots)]
        self.top_k = top_k
        self.chunk = chunk
        if prompt_buckets is None:
            prompt_buckets, b = [], 8
            while b < lm.max_len:
                prompt_buckets.append(b)
                b *= 2
            prompt_buckets.append(lm.max_len)
        self.prompt_buckets = tuple(sorted(prompt_buckets))
        # One trash position for idle rows, plus draft_k (+ tree_width
        # leaf rows) SLACK positions in speculative mode: a verify chunk
        # writes draft_k + 1 + tree_width tokens from each slot's position.
        self._cache_len = lm.max_len + 1 + self._spec_k + self._spec_w
        self._trash = lm.max_len
        block0 = lm.blocks[0]
        #: Sliding-window models: decode masking lives in the model; the
        #: paged batcher's job is page RECYCLING behind the window.
        self._window = block0.attn.window
        heads, hd = block0.cache_heads, block0.head_dim
        if kv_cache_dtype == "int4" and hd % 2:
            raise ValueError(
                f"kv_cache_dtype='int4' packs two nibbles per int8 "
                f"lane and needs an even head_dim, got {hd}"
            )
        #: prefill's quantize_cache: False, "int8" or "int4".
        self._kv_quant = (kv_cache_dtype if kv_cache_dtype != "native"
                          else False)
        if self._paged:
            if page_size < 1:
                raise ValueError(f"page_size must be >= 1, got {page_size}")
            self._page = page_size
            # The table covers max_len plus the speculative overshoot.
            pps = -(-(lm.max_len + self._spec_k + self._spec_w) // page_size)
            if pool_pages is None:
                pool_pages = slots * pps + 1  # every slot full + trash page
            if pool_pages < 2:
                raise ValueError(
                    f"pool_pages must be >= 2, got {pool_pages}"
                )
            self._pager = Pager(pool_pages, slots, pps, page_tokens=page_size)
            self._pool_pages = pool_pages
            shape = (pool_pages, heads, page_size, hd)
        else:
            self._pager = None
            shape = (slots, heads, self._cache_len, hd)
        dev, dt = self.device, lm.dtype

        def one_cache(shape=shape, dev=dev):
            if not self._kv_quant:
                return torch.zeros(shape, dtype=dt, device=dev)
            # (values, scales): the scale plane is one f32 per cached
            # vector, addressed like the values (page-addressed by the
            # same table on pools); int4 halves the value width.
            width = hd // 2 if self._kv_quant == "int4" else hd
            return (torch.zeros(*shape[:-1], width, dtype=torch.int8,
                                device=dev),
                    torch.zeros(*shape[:-1], 1, dtype=torch.float32,
                                device=dev))

        if self._kv_sharding is not None:
            # One contiguous cache per shard, heads / tp each, on the
            # shard's device: the kernels refuse a head view of a shared
            # pool, and a shard holds only its own bytes.
            self._caches = [tuple(self._kv_sharding.map_pieces(
                one_cache, shape) for _ in range(2))
                for _ in lm.block_names]
        else:
            self._caches = [(one_cache(), one_cache())
                            for _ in lm.block_names]
        # -- host KV tier ----------------------------------------------
        if cache_tier is not None and not self._paged:
            raise ValueError(
                "cache_tier requires kv_layout='paged' (the spill tier "
                "lives under the paged prefix cache; dense strips have no "
                "page to spill)")
        self._tier_cfg = cache_tier
        self._tier = HostKVTier(cache_tier) if cache_tier else None
        #: Per-tick tier budgets, reset at tick entry (seeded here so that
        #: evictions before the first tick can spill too).
        self._spill_budget = (cache_tier.spill_pages_per_tick
                              if cache_tier else 0)
        self._readmit_budget = (cache_tier.readmit_pages_per_tick
                                if cache_tier else 0)
        if self._paged:
            # Installed with or without a tier: every cached-prefix death
            # records its radix_evict flight event.
            self._pager.evict_hook = self._on_page_evict
        #: Lifetime tier books (stats() mirrors of cache_tier.* counters).
        self._tier_spilled = 0
        self._tier_readmitted = 0
        self._tier_dropped = 0
        #: The tier's own overflow drops already bridged to the counter.
        self._tier_drop_seen = 0
        #: What the same cache geometry costs in the model's dtype: the
        #: denominator of stats()["cache_bytes_ratio"].
        self._native_cache_bytes = (
            2 * len(lm.block_names) * shape[0] * shape[1] * shape[2] * hd
            * torch.empty((), dtype=dt).element_size()
        )
        #: Idle-row cache position: the trash strip position on dense
        #: strips; on pools a negative sentinel that stays negative across
        #: a whole tick's advance (chunk steps, or a speculative tick's
        #: up to draft_k + 1 commits, + 1 with a tree bonus), routing every
        #: garbage write to the trash page.
        adv = (self._spec_k + 1 + (1 if self._spec_w else 0)
               if self._spec else chunk)
        self._idle_pos = -(adv + 1) if self._paged else self._trash
        #: Draft-model slot caches: dense per-slot strips with draft_k + 1
        #: slack (the draft is small by construction). A tree draft runs
        #: one extra scan step, so its strips carry one more position.
        self._draft_caches = None
        if self._spec:
            db = draft_lm.blocks[0]
            dshape = (slots, db.cache_heads,
                      draft_lm.max_len + self._spec_k + 1
                      + (1 if self._spec_w else 0), db.head_dim)
            self._draft_caches = [
                tuple(torch.zeros(dshape, dtype=draft_lm.dtype, device=dev)
                      for _ in range(2))
                for _ in draft_lm.block_names
            ]
        self._h2d_count = 0
        self._d2h_count = 0
        i64 = dict(dtype=torch.int64, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        #: Device-resident per-slot sampling state, written only by
        #: _stage_slot / _park_slot_row and the decode chunk itself.
        self._dstate = {
            "tok": torch.zeros(slots, **i64),
            "pos": torch.full((slots,), self._idle_pos, dtype=torch.int32,
                              device=dev),
            "seed": torch.zeros(slots, **i64),
            "kbase": torch.zeros(slots, **i64),
            "temp": torch.zeros(slots, **f32),
            "top_k": torch.full((slots,), lm.vocab, **i64),
            "top_p": torch.ones(slots, **f32),
            "active": torch.zeros(slots, dtype=torch.bool, device=dev),
        }
        #: Every request samples as row 0 of its own key stream.
        self._rows0 = torch.zeros(slots, **i64)
        #: Device copy of the pager's page table, re-uploaded only when
        #: the host table changed — a steady paged tick stages nothing.
        self._table_dev = None
        self._table_snapshot = None
        #: submit_fanout groups (id -> books), and page claims of groups
        #: that died on a client thread, released by the ticking thread.
        self._fanout_groups: dict[int, _FanoutGroup] = {}
        self._fanout_next = 0
        self._fanout_release: list[int] = []
        # -- traffic control -------------------------------------------
        self._sched = scheduler
        self._queue = AdmissionQueue(scheduler)
        if self._paged and scheduler is not None and scheduler.cache_aware:
            # Cache-aware pick: the longest (then hottest) radix-resident
            # prompt prefix first, by a read-only walk; a cold prompt
            # scores None, so a cold window stays FIFO.
            def _probe(r, _pager=self._pager):
                pages, tokens, heat = _pager.radix_probe(r.prompt)
                return (tokens, heat) if pages else None

            self._queue.prefix_probe = _probe
        self._controller = (DegradationController(scheduler)
                            if scheduler is not None and scheduler.degrade
                            else None)
        self._preempted = 0
        #: Regenerated tokens (a replay's re-run of already delivered
        #: indices) that differ from what the client received.
        self._regen_mismatches = 0
        #: Tenants holding a scheduler.queue_depth.<tenant> gauge.
        self._gauged_tenants: set[str] = set()
        self._done: dict[int, np.ndarray] = {}
        self._done_lps: dict[int, np.ndarray] = {}
        self._cancelled: set[int] = set()
        #: req_id popped by the ticking thread but not yet slot-bound.
        self._admitting: int | None = None
        self._next_id = 0
        self._admitted = 0
        self._completed = 0
        self._ticks = 0
        self._rejected = 0
        self._prefill_tokens = 0
        #: Request-timeline SLO histograms (one perf_counter stamp per
        #: committed token; ITL samples flush once per tick).
        self.obs_timeline = True
        self._itl_pending: list[float] = []
        self._ttft_pending: list[float] = []
        self._tick_tokens = 0
        #: SLO books: this tick's pending verdicts and the lifetime totals
        #: (the ladder reads the totals' windowed deltas).
        self._slo_pending = dict.fromkeys(
            ("ttft_met", "ttft_missed", "itl_met", "itl_missed"), 0)
        self._slo_totals = dict(self._slo_pending)
        self._tick_good_tokens = 0
        obs = observability or ObservabilityConfig()
        self.goodput_window_s = obs.goodput_window_s
        #: (t, good tokens) per tick over goodput_window_s.
        self._goodput_samples: collections.deque = collections.deque()
        # -- pipelined tick ----------------------------------------------
        self._depth = (runtime or RuntimeConfig()).pipeline_depth
        self._inflight: _InFlight | None = None
        self._cv = threading.Condition()
        self._server: threading.Thread | None = None
        self._stopping = False
        self._server_error: BaseException | None = None
        # -- elastic recovery --------------------------------------------
        self._recovery = recovery or RecoveryConfig()
        #: ``control.registry.DeviceHealthMonitor`` (duck-typed): the mesh's
        #: members are its leases, and a ``leave`` lands in _lost_pending.
        self._health = health
        #: ``control.journal.DispatcherJournal``: submits journaled, finishes
        #: done-marked, replays rebuilt from the journaled record.
        self._journal = journal
        if journal is not None:
            # Serving over an existing journal must not recycle a pending
            # id (its payload would be replaced and done-marked away).
            self._next_id = max(self._next_id, journal.next_request_id)
        #: Membership keys of members lost but not yet recovered from
        #: (guarded by ``_cv``; consumed by recover()).
        self._lost_pending: list[str] = []
        self._mesh_device_ids = {m.id for m in self._mesh_devices}
        self._recoveries = 0
        self._recovery_migrated = 0
        self._recovery_replayed = 0
        self._recovery_dropped = 0
        self._last_recovery_wall_s = 0.0
        #: close() sets it: a retired batcher ignores membership events.
        self._retired = False
        # -- sequence-parallel long-context prefill ------------------------
        self._sp_cfg = prefill
        self._sp: SPPrefiller | None = None
        self._sp_prefills = 0
        #: Failed sp dispatches: consecutive (three retire the ring until a
        #: recovery rebuilds it) and lifetime.
        self._sp_fail_run = 0
        self._sp_failures = 0
        #: The ring's members as first built: a recovery after the breaker
        #: retired the ring rebuilds from their survivors.
        self._sp_pool: list = []
        #: Compile-sentinel allowance granted to rebuilt rings (revoked at
        #: close()).
        self._sp_granted = 0
        if prefill is not None and prefill.enabled:
            if not self._paged:
                raise ValueError(
                    "PrefillConfig sp prefill requires kv_layout='paged' (the "
                    "sp pages land through the paged prefix cache)")
            if sp_mesh is None:
                need = prefill.sp_width * self._tp
                sp_mesh = build_sp_mesh(prefill.sp_width, self._tp,
                                        prefill.sp_axis, self._axis,
                                        devices=[self.device] * need)
            if self._tp > 1:
                if (self._axis not in sp_mesh.shape
                        or int(sp_mesh.shape[self._axis]) != self._tp):
                    raise ValueError(
                        f"sp_mesh must carry the batcher's tp axis "
                        f"{self._axis!r} at size {self._tp} — sp pages must "
                        "be what this batcher's own tp-sharded chunked "
                        "prefill would write")
            sp_tp_axis = self._axis if self._axis in sp_mesh.shape else None
            self._sp_pool = sp_mesh.members()
            self._sp = SPPrefiller(
                self.lm, sp_mesh, self._page, kv_cache_dtype=kv_cache_dtype,
                sp_axis=prefill.sp_axis, tp_axis=sp_tp_axis,
                name="batcher-sp", health=health)
            global_metrics().set_gauge("prefill.sp_width", float(self._sp.sp))
        # -- capacity plane ----------------------------------------------
        cap_cfg = capacity or CapacityConfig()
        self._capacity: CapacityModel | None = (
            CapacityModel(cap_cfg, kind="decode",
                          window_s=self.goodput_window_s)
            if cap_cfg.enabled else None)
        #: Previous _obs_flush stamp: the forecaster's tick-gap feed.
        self._cap_last_flush = 0.0
        # -- engine telemetry ----------------------------------------------
        # The config's engine knobs apply here as in the Dispatcher
        # (enable-only), so a batcher served alone can turn them on.
        apply_engine_config(obs)
        if obs.trace_enabled:
            global_tracer().enabled = True
        self._eobs = global_engine_obs()
        self._sentinel = global_compile_sentinel()
        # Registering re-arms the warmup: a fresh batcher may load its own
        # first kernel libraries (an int8 pool's, a draft's).
        watch_kernel_libraries(self._sentinel)
        #: The latest execution of each roofline program: (passes, or a
        #: zero-arg callable counting them, and the wall in seconds or
        #: None). Decode / verify walls are the engine phases';
        #: a prefill's is its own pass, ended by the first-token fetch.
        self._roofline: dict[str, tuple] = {}
        #: The pager's books as of the end of the latest tick half: only
        #: the ticking thread moves pages, so a scrape thread reading this
        #: sees a partition that adds up (a live read could fall between
        #: a page leaving the free list and its refcount being set).
        self._pager_books = self._pager.stats() if self._paged else None
        register_memory_source("continuous", self)
        register_roofline_source("continuous", self)
        if health is not None and self._mesh_devices:
            health.track(self._mesh_devices)
            # Weak: the watcher list has no unwatch and outlives batchers.
            weak_watch(health, self, "_on_device_event")
            # A member dead before construction (or killed between track()
            # and watch()) sends no future leave: seed the loss from the
            # monitor's dead roster.
            for did in sorted(health.dead_ids() & self._mesh_device_ids):
                self._on_device_event("leave", f"device:{did}")

    def _setup_parallel(self, lm, mesh, parallel):
        """The ``mesh`` / ``parallel`` refusals of the JAX batcher, then
        the model the batcher runs: ``lm`` cut into tp shards
        (``shard_lm``; a ``ShardedLM`` is taken as it is, on its own mesh
        when none is given), or on a tp=1 mesh ``lm`` on the mesh's
        device."""
        if mesh is None and isinstance(lm, ShardedLM):
            mesh = lm.mesh
            parallel = parallel or ParallelConfig(tp=lm.tp, axis=lm.axis)
        if parallel is not None and parallel.tp > 1 and mesh is None:
            raise ValueError(
                f"ParallelConfig(tp={parallel.tp}) requires a mesh")
        self._axis = (parallel or ParallelConfig()).axis
        self._mesh = None
        self._tp = 1
        self._kv_sharding = None
        #: The members serving this batcher, in tp-axis order
        #: (``core.mesh.MeshMember``): a tp=1 mesh, or the remnant of a
        #: recovery down to tp=1, keeps its one member, so losing it raises
        #: instead of dispatching onto a dead shard. Empty without a mesh.
        self._mesh_devices: list = []
        if mesh is None:
            return lm
        axis = self._axis
        if axis not in mesh.shape:
            raise ValueError(f"mesh has no {axis!r} axis (axes: "
                             f"{tuple(mesh.axis_names)})")
        tp = int(mesh.shape[axis])
        if parallel is not None and parallel.tp != tp:
            raise ValueError(f"ParallelConfig.tp={parallel.tp} != mesh "
                             f"{axis!r} size {tp}")
        validate_tp(lm, tp)
        self._mesh_devices = mesh.members(axis)
        if tp == 1:
            # A size-1 tp axis partitions nothing: the single-device
            # path on the mesh's device.
            dev0 = mesh.axis_devices(axis)[0]
            if isinstance(lm, ShardedLM):
                raise ValueError("a tp=1 mesh serves an unsharded LM")
            if lm.device != dev0:
                lm = copy.deepcopy(lm).to(dev0)
            return lm
        if isinstance(lm, ShardedLM):
            if lm.tp != tp or lm.axis != axis or lm.devices != (
                    mesh.axis_devices(axis)):
                raise ValueError(
                    f"the ShardedLM runs {lm.tp} shards of {lm.axis!r} on "
                    f"{lm.devices}, not the mesh's {axis!r} axis")
        else:
            lm = shard_lm(lm, mesh, axis)
        self._mesh = mesh
        self._tp = tp
        # The KV caches split on their head axis over the shards of the
        # tp axis, in shard order.
        self._kv_sharding = kv_head_sharding(mesh.along(axis), axis)
        return lm

    # -- device-side pieces ------------------------------------------------

    def _h2d(self, x, dtype):
        """THE host->device staging funnel: counts every transfer, so the
        0-per-steady-tick contract is asserted, not assumed. On a card the
        value goes through a pinned buffer with a ``non_blocking`` copy (a
        pageable copy would wait for the tick in flight); the caching host
        allocator keeps that buffer until the copy has run."""
        self._h2d_count += 1
        t = torch.as_tensor(np.asarray(x), dtype=dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _fetch(self, *rows) -> _AsyncFetch:
        """THE device->host fetch funnel: ``rows`` (same-shaped tensors)
        start ONE stacked f64 fetch, counted, so "one fetch per steady
        tick" is asserted, not assumed."""
        self._d2h_count += 1
        return _AsyncFetch(rows)

    def _stage_slot(self, ints, floats) -> None:
        """Write one admitted request's sampling row: ``ints`` (6,) =
        [slot, tok, pos, top_k, kbase, seed], ``floats`` (2,) = [temp,
        top_p] — two staged transfers per admission, not one per field."""
        d, i = self._dstate, ints[0:1]
        d["tok"].index_copy_(0, i, ints[1:2])
        d["pos"].index_copy_(0, i, ints[2:3].to(torch.int32))
        d["top_k"].index_copy_(0, i, ints[3:4])
        d["kbase"].index_copy_(0, i, ints[4:5])
        d["seed"].index_copy_(0, i, ints[5:6])
        d["temp"].index_copy_(0, i, floats[0:1])
        d["top_p"].index_copy_(0, i, floats[1:2])
        d["active"].index_fill_(0, i, True)

    def _park_slot_row(self, idx: int) -> None:
        """Retire one slot's device row: park it at the idle position,
        identity sampling knobs, out of the active mask. The one device
        write that every release path (finish, replay, drop) shares."""
        d = self._dstate
        d["pos"][idx] = self._idle_pos
        for key, val in (("tok", 0), ("kbase", 0), ("seed", 0), ("temp", 0.0),
                         ("top_k", self.lm.vocab), ("top_p", 1.0),
                         ("active", False)):
            d[key][idx] = val

    def _current_table(self):
        """Device copy of the pager's page table, re-uploaded only when
        the host table changed (admissions, retirements, window
        recycling, prefix shares): snapshot-compare, so no pager mutation
        site can be missed."""
        t = self._pager.table()
        if self._table_dev is None or not np.array_equal(
            t, self._table_snapshot
        ):
            self._table_snapshot = t.copy()
            self._table_dev = self._h2d(self._table_snapshot, torch.int32)
        return self._table_dev

    def _step_chunk(self, *, do_sample, truncate, nucleus):
        """``chunk`` lockstep decode steps over the device-resident slot
        state; returns ((chunk, B) tokens, (chunk, B) logprobs) without a
        host sync. Active rows advance pos/kbase/tok by the whole chunk
        (a mid-chunk finish is cleared host-side); idle rows re-park. The
        cache plumbing (strips or pools + table) is the only thing the
        layouts change."""
        d, lm, C = self._dstate, self.lm, self.chunk
        table = self._current_table() if self._paged else None
        tokens, pos = d["tok"], d["pos"]
        toks, lps = [], []
        for j in range(C):
            x = lm.embed.embed_positions(tokens[:, None], pos[:, None])
            for block, (ck, cv) in zip(lm.blocks, self._caches):
                if self._paged:
                    x, _, _ = block.decode_step_paged(
                        x, ck, cv, table, pos, None,
                        attn_impl=self._kernel.attn_impl,
                        split=self._kernel.decode_split,
                    )
                else:
                    x, _, _ = block.decode_step(
                        x, ck, cv, pos, None,
                        attn_impl=self._kernel.attn_impl,
                        split=self._kernel.decode_split,
                    )
            logits = lm.head(x)[:, 0]
            nxt = sample_rows(
                logits, d["temp"], d["top_k"], d["top_p"], d["seed"],
                self._rows0, d["kbase"] + j, do_sample=do_sample,
                truncate=truncate, nucleus=nucleus,
            )
            toks.append(nxt)
            lps.append(chosen_logprob(logits, nxt))
            tokens, pos = nxt, pos + 1
        active = d["active"]
        d["pos"] = torch.where(active, d["pos"] + C, self._idle_pos).to(
            torch.int32)
        d["tok"] = torch.where(active, toks[-1], 0)
        d["kbase"] = torch.where(active, d["kbase"] + C, 0)
        return torch.stack(toks), torch.stack(lps)

    def _count_prefill(self, n: int) -> None:
        self._prefill_tokens += n
        if self.obs_timeline:
            global_metrics().inc("continuous.prefill_tokens_total", float(n))

    def _first_pick(self, h_last, req: _Request):
        """The first-token sampling tail shared by every prefill flavour
        (whole prompt, prefix-hit suffix, final chunk): token index 0 of
        the request's key stream, with one host sync."""
        ints = self._h2d([req.top_k, req.seed], torch.int64)
        floats = self._h2d([req.temperature, req.top_p], torch.float32)
        logits = self.lm.head(h_last)[:, 0]
        first = sample_rows(
            logits, floats[0:1], ints[0:1], floats[1:2], ints[1:2],
            self._rows0[:1], self._rows0[:1],
            do_sample=req.temperature > 0.0,
            truncate=req.top_k < self.lm.vocab, nucleus=req.top_p < 1.0,
        )
        host = self._fetch(first, chosen_logprob(logits, first)).commit()
        return int(host[0, 0]), float(host[1, 0])

    def _prefill(self, slot_idx: int, req: _Request, bucket: int):
        """Prefill ``req``'s prompt padded to ``bucket`` (K1), insert its
        K/V into slot ``slot_idx``'s strips — or its owned pages — and
        pick the first token. Returns (token, logprob)."""
        lm = self.lm
        t0 = time.perf_counter() if self._eobs.enabled else 0.0
        s0 = req.prompt.shape[0]
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :s0] = req.prompt
        h = lm.embed(self._h2d(ids, torch.int64))
        pages = (self._h2d(self._pager.owned(slot_idx), torch.int64)
                 if self._paged else None)
        for block, (ck, cv) in zip(lm.blocks, self._caches):
            h, k, v = block.prefill(h, bucket, None, self._kv_quant)
            for cache, new in ((ck, k), (cv, v)):
                if self._paged:
                    insert_prefill_pages(cache, pages, new)
                else:
                    for c, n in zip(_members(cache), _members(new)):
                        c[slot_idx, :, :bucket] = n[0]
        self._count_prefill(s0)
        first = self._first_pick(h[:, s0 - 1:s0], req)
        self._note_prefill((bucket, self._attended(0, s0), s0, bucket, 1), t0)
        return first

    def _prefill_pass(self, req: _Request, pages, pos0: int, length: int,
                      sample: bool):
        """One incremental prefill pass over a paged window: prompt
        positions [pos0, pos0 + length), padded to whole pages, run the
        forward against everything cached before them IN PLACE (each
        block writes the pass's K/V into its pages and attends the window
        page by page, K4). ``pages`` covers the window padded to a
        power-of-two page count with trash entries. The prefix-hit suffix
        pass and every chunked-prefill pass share this body; only a pass
        that ``sample``s returns (token, logprob)."""
        P = self._page
        t0 = time.perf_counter() if sample and self._eobs.enabled else 0.0
        cbucket = -(-length // P) * P
        ids = np.zeros((1, cbucket), np.int64)
        ids[0, :length] = req.prompt[pos0:pos0 + length]
        ids_t = self._h2d(ids, torch.int64)
        pages_t = self._h2d(np.asarray(pages, np.int32), torch.int32)
        pos_ids = pos0 + torch.arange(cbucket, device=self.device)[None]
        h = self.lm.embed.embed_positions(ids_t, pos_ids)
        for block, (kp, vp) in zip(self.lm.blocks, self._caches):
            h, _, _ = block.prefill_chunk_paged(
                h, kp, vp, pages_t, pos0, self._kernel.attn_impl
            )
        self._count_prefill(length)
        if not sample:
            return None
        first = self._first_pick(h[:, length - 1:length], req)
        self._note_prefill((cbucket, self._attended(pos0, length),
                            pos0 + length, cbucket, 1), t0)
        return first

    def _live_keys(self, pos):
        """Live keys of query rows at positions ``pos`` (an int array):
        each attends through its own position, inside a sliding window."""
        keys = np.asarray(pos, np.int64) + 1
        if self._window is not None:
            keys = np.minimum(keys, self._window)
        return keys

    def _attended(self, pos0: int, n: int) -> int:
        """(query, live key) pairs of ``n`` rows at positions pos0 ..
        pos0 + n - 1."""
        return int(self._live_keys(np.arange(pos0, pos0 + n)).sum())

    def _decode_passes(self, active, rows_per_slot: int, steps: int):
        """A zero-arg callable counting the ``program_work`` passes of a
        decode chunk (``steps`` passes of one row a slot) or of a verify
        pass (one pass of ``rows_per_slot`` rows a slot) over the slot
        batch. Only the active slots' next positions are taken now; the
        count runs when a scrape reads the roofline."""
        pos = [s.s0 + s.emitted - 1 for s in active]
        return lambda: self._count_passes(pos, rows_per_slot, steps)

    def _count_passes(self, pos, rows_per_slot: int, steps: int) -> tuple:
        B = len(self.slots)
        pos = np.asarray(pos, np.int64)
        n = rows_per_slot * B
        if steps > 1:
            return tuple(
                (n, int(k.sum()), int(k.sum()), n, n)
                for k in (self._live_keys(pos + j) for j in range(steps)))
        offs = np.arange(rows_per_slot)
        att = int(self._live_keys(pos[:, None] + offs[None, :]).sum())
        read = int(self._live_keys(pos + rows_per_slot - 1).sum())
        return ((n, att, read, n, n),)

    def _note_prefill(self, one_pass: tuple, t0: float) -> None:
        """Record the latest prefill pass that ended in the first-token
        fetch as the ``prefill`` roofline program (its wall measured only
        with engine timing on)."""
        self._roofline["prefill"] = (
            (one_pass,), time.perf_counter() - t0 if t0 else None)

    def _window_pages(self, slot_idx: int, n_strip: int) -> list[int]:
        """The slot's first ``n_strip`` owned pages padded to a power of
        two with trash page 0 (masked past every row, skipped by K4)."""
        owned = self._pager.owned(slot_idx)
        assert n_strip <= len(owned)
        return owned[:n_strip] + [0] * ((1 << (n_strip - 1).bit_length())
                                        - n_strip)

    def _fork_page(self, src: int, dst: int) -> None:
        """Copy-on-write fork: duplicate ONE physical page, every block's
        K and V, from ``src`` into ``dst`` (a fan-out sibling's private
        copy of its group's last shared prompt page, taken at admission
        because the sibling's decode is about to write into it). A
        quantized pool copies its scale plane with the values."""
        for pair in self._caches:
            for pool in pair:
                for m in _members(pool):
                    m[dst].copy_(m[src])

    def _register_prompt_pages(self, slot_idx: int, req: _Request,
                               start: int) -> None:
        """Publish the slot's full prompt pages from ordinal ``start`` on
        for future sharing (first writer wins)."""
        P = self._page
        owned = self._pager.owned(slot_idx)
        for j in range(start, req.prompt.shape[0] // P):
            self._pager.register(
                owned[j], Pager.prefix_key(req.prompt, (j + 1) * P)
            )

    def prefix_cached(self, prompt) -> int:
        """Leading FULL pages of ``prompt`` servable from the cache
        hierarchy without recompute: the longest run of content keys
        resident in the pool or, with a host tier, spilled to it.
        Read-only: no shares taken, no readmits, no probe accounting
        moved. 0 on dense strips."""
        if not self._paged:
            return 0
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        n = 0
        for j in range((prompt.shape[0] - 1) // self._page):
            key = Pager.prefix_key(prompt, (j + 1) * self._page)
            if not (self._pager.resident(key) or (
                    self._tier is not None and self._tier.contains(key))):
                break
            n += 1
        return n

    # -- landing external pages (disaggregated handoff, host readmit) -----

    def _stage_leaves(self, leaves: list) -> list:
        """Host tensors -> the batcher's device: each group of same
        (dtype, shape) leaves is stacked into one pinned buffer and staged
        with ONE counted non-blocking copy (the disaggregated landing and
        the host-tier readmit go through here, never a steady tick)."""
        if self.device.type != "cuda":
            self._h2d_count += 1
            return [t.to(self.device) for t in leaves]
        groups: dict[tuple, list[int]] = {}
        for i, t in enumerate(leaves):
            groups.setdefault((t.dtype, tuple(t.shape)), []).append(i)
        out: list = [None] * len(leaves)
        for (dt, shape), idx in groups.items():
            buf = torch.empty((len(idx),) + shape, dtype=dt, pin_memory=True)
            for j, i in enumerate(idx):
                buf[j].copy_(leaves[i])
            self._h2d_count += 1
            dev = buf.to(self.device, non_blocking=True)
            for j, i in enumerate(idx):
                out[i] = dev[j]
        return out

    def _adopt_pages(self, pages: list[int], kvs: list) -> int:
        """Scatter page-major K/V into pool ``pages`` in place: ``kvs``
        mirrors ``self._caches``' per-block (K, V) structure with host
        leaves ``(len(pages), kvh, page, w)`` (a quantized pool's values
        and scales move together). The pool's ``KVHandoffPlan`` lands the
        leaves through :meth:`_stage_leaves` (under tp each shard receives
        only its own heads); one index_copy_ per pool member. Returns the
        logical bytes staged."""
        plan = plan_kv_handoff(self._kv_sharding)
        landed = plan.place([m for pair in kvs for c in pair
                             for m in _members(c)], self._stage_leaves)
        pools = [p for pair in self._caches for c in pair for p in _leaves(c)]
        pages_t = self._h2d(np.asarray(pages, np.int64), torch.int64)
        for pool, kv in zip(pools, landed):
            for p, k in (zip(pool, kv) if isinstance(pool, Shards)
                         else ((pool, kv),)):
                p.index_copy_(0, pages_t, k.to(p.dtype))
        return plan.staged_bytes

    def adopt_prefill_pages(self, prompt, blocks, page_size: int,
                            quantized) -> int:
        """Land a disaggregated prefill's KV pages THROUGH THE PREFIX
        CACHE: the decode-side half of the ``runtime/disagg`` handoff.
        ``blocks`` holds one ``(K, V)`` pair per decoder block, each member
        a page-major ``(n, kvh, page, hd)`` host tensor (a ``(values,
        scales)`` tuple of them on a quantized pool) with the K/V of
        ``prompt``'s first ``n`` FULL pages as this batcher's own chunked
        prefill would write them.

        The pages register under the content keys the admission probe
        computes, park rc=0 in the prefix LRU and take their bytes through
        :meth:`_adopt_pages`, so a later :meth:`submit` of the prompt
        admits as a prefix hit and prefills only the suffix: int8 pools
        and speculative mode compose as in the collocated path. Returns
        the pages adopted (resident keys dedupe; pool pressure adopts
        nothing, all-or-nothing, and the request prefills itself). Raises
        ``ValueError`` on a geometry mismatch, before any pager
        mutation. A member loss pending recovers first (or raises), so no
        slice lands on the old layout."""
        self._ensure_mesh()
        if not self._paged:
            raise ValueError(
                "adopt_prefill_pages requires kv_layout='paged' (the handoff "
                "lands through the paged prefix cache)")
        if page_size != self._page:
            raise ValueError(
                f"handoff page size {page_size} != pool page size "
                f"{self._page}")
        sender_dt = (quantized if isinstance(quantized, str)
                     else ("int8" if quantized else "native"))
        if sender_dt != (self._kv_quant or "native"):
            raise ValueError(
                f"handoff kv dtype {sender_dt!r} but pool kv_cache_dtype is "
                f"{self._kv_quant or 'native'!r}")
        blocks_m = self.lm.blocks
        if len(blocks) != len(blocks_m):
            raise ValueError(f"handoff has {len(blocks)} blocks, model has "
                             f"{len(blocks_m)}")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        k0 = blocks[0][0]
        n = int((k0[0] if isinstance(k0, tuple) else k0).shape[0])
        if n < 1 or n > (prompt.shape[0] - 1) // self._page:
            raise ValueError(
                f"handoff covers {n} pages; prompt of {prompt.shape[0]} "
                f"tokens shares at most {(prompt.shape[0] - 1) // self._page}"
                " full pages")
        quant = bool(self._kv_quant)
        for b, (block, pair) in enumerate(zip(blocks_m, blocks)):
            for mname, member in zip(("K", "V"), pair):
                if isinstance(member, tuple) != quant:
                    raise ValueError(
                        f"handoff block {b} {mname}: "
                        f"{'tuple' if isinstance(member, tuple) else 'array'}"
                        f" member in a {'quantized' if quant else 'native'} "
                        "pool")
                for li, leaf in enumerate(_members(member)):
                    width = (1 if li else block.head_dim
                             // (2 if self._kv_quant == "int4" else 1))
                    want = (n, block.cache_heads, self._page, width)
                    if tuple(leaf.shape) != want:
                        raise ValueError(
                            f"handoff block {b} {mname}[{li}] shape "
                            f"{tuple(leaf.shape)} != expected {want}")
        keys = [Pager.prefix_key(prompt, (j + 1) * self._page)
                for j in range(n)]
        adopted = self._pager.adopt_cached(keys)
        if not adopted:
            return 0
        ords = [i for i, _ in adopted]
        sel = (slice(None) if len(ords) == n
               else torch.as_tensor(ords, dtype=torch.int64))

        def pick(member):
            if isinstance(member, tuple):
                return tuple(torch.as_tensor(m)[sel] for m in member)
            return torch.as_tensor(member)[sel]

        self._adopt_pages([p for _, p in adopted],
                          [(pick(k), pick(v)) for k, v in blocks])
        return len(adopted)

    def _sp_admit(self, req: _Request) -> None:
        """Sequence-parallel prefill of one long admission: the sp ring
        computes the prompt's full pages (``parallel/sp_prefill``) and they
        land through :meth:`adopt_prefill_pages`, the disaggregated
        handoff's landing, so the admission below prefix-hits them and
        pays only the suffix pass. A failure degrades to the ordinary
        (chunked) prefill: counted, logged and recorded; three in a row
        retire the ring."""
        s0 = req.prompt.shape[0]
        m = self._sp.covers(s0)
        if m < 1 or self.prefix_cached(req.prompt) >= m:
            return  # nothing to do, or hierarchy-resident already
        eo = self._eobs
        t_ph = eo.now() if eo.enabled else 0.0
        tracer = global_tracer()
        t0 = tracer.now() if tracer.enabled else 0.0
        sp = self._sp.sp
        try:
            n, blocks = self._sp.prefill(req.prompt)
            adopted = self.adopt_prefill_pages(req.prompt, blocks, self._page,
                                               self._kv_quant)
        except Exception:  # noqa: BLE001 — degrade, never wedge
            log.exception("sp prefill failed for request %d; admission "
                          "falls back to the chunked path", req.req_id)
            self._sp_failures += 1
            self._sp_fail_run += 1
            global_metrics().inc("prefill.sp_failures_total")
            global_flight_recorder().record("sp_prefill", request=req.req_id,
                                            pages=0, sp=sp, ok=False)
            if self._sp_fail_run >= 3:
                # A deterministic failure (a dead ring-only member): stop
                # paying a doomed dispatch per long admission until a
                # recovery rebuilds the ring.
                log.warning("sp prefill disabled after %d consecutive "
                            "failures", self._sp_fail_run)
                self._sp.close()
                self._sp = None
                global_metrics().set_gauge("prefill.sp_width", 1.0)
            return
        self._sp_fail_run = 0
        with self._cv:
            self._sp_prefills += 1
        # n full pages of prompt positions: the same prefill-work books as
        # an in-tick chunk pass.
        self._count_prefill(n * self._page)
        if tracer.enabled:
            tracer.add_span("batcher.sp_prefill", start=t0, end=tracer.now(),
                            request=req.req_id, pages=n, adopted=adopted,
                            sp=sp)
        if eo.enabled:
            eo.phase("sp_prefill", t_ph, span=False)
        global_flight_recorder().record("sp_prefill", request=req.req_id,
                                        pages=n, adopted=adopted, sp=sp,
                                        ok=True)

    def _rebuild_sp(self, dead: set, new_tp: int) -> None:
        """A recovery's ring rebuild: from the old ring's surviving members
        (the first ring's, when the breaker had retired it), in their
        order and keeping their ids, at this batcher's new tp, the width
        halved while it does not fit; no ring of 2 fits: the ordinary
        prefill path. The sentinel is re-armed for the old ring's variants
        (a ring that never ran banks nothing)."""
        cfg = self._sp_cfg
        if self._sp is not None:
            variants = len(self._sp.variants)
            alive = [m for m in self._sp._mesh.members() if m.id not in dead]
            self._sp.close()
            self._sp = None
        else:
            variants = 0
            alive = [m for m in self._sp_pool if m.id not in dead]
        self._sp_fail_run = 0
        w = cfg.sp_width
        while w > 1 and w * new_tp > len(alive):
            w //= 2
        if w > 1:
            try:
                self._sp = SPPrefiller(
                    self.lm, build_sp_mesh(w, new_tp, cfg.sp_axis, self._axis,
                                           devices=alive),
                    self._page, kv_cache_dtype=self._kv_quant or "native",
                    sp_axis=cfg.sp_axis,
                    tp_axis=self._axis if new_tp > 1 else None,
                    name="batcher-sp", health=self._health)
                if variants:
                    self._sentinel.rearm("sp.prefill", expect=variants)
                    self._sp_granted += variants
            except Exception:  # noqa: BLE001 — degrade, don't wedge
                log.exception("sp prefiller rebuild failed; sp prefill "
                              "disabled until the next recovery")
        else:
            log.warning("sp prefill disabled: %d surviving ring members "
                        "support no sp >= 2 at tp=%d", len(alive), new_tp)
        global_metrics().set_gauge(
            "prefill.sp_width", float(self._sp.sp if self._sp else 1))

    # -- the host KV tier --------------------------------------------------

    def _fetch_page_host(self, page: int) -> list:
        """Host copy of one pool page's K/V across every block (the spill
        side's ONE device->host copy, ``fetch_head_shards``), as per-block
        ``(K, V)`` leaves of shape ``(kvh, page, w)``. Under tp each leaf
        is assembled on the host from its shards' heads."""
        leaves = [_leaves(c) for pair in self._caches for c in pair]
        it = iter(fetch_head_shards([x for ls in leaves for x in ls], page))
        got = iter([tuple(next(it) for _ in ls) if len(ls) > 1 else next(it)
                    for ls in leaves])
        return [(next(got), next(got)) for _ in self._caches]

    def _spill_page(self, page: int, key: bytes) -> bool:
        """Capture one rc=0 page into the host tier (the caller checked
        the budget). Idempotent for keys the tier holds."""
        raw, enc = self._tier.put(key, self._fetch_page_host(page))
        if raw == 0 and enc == 0:
            return False  # already host-resident: no new books
        self._tier_spilled += 1
        reg = global_metrics()
        reg.inc("cache_tier.spilled_total")
        reg.inc("cache_tier.codec_bytes_saved_total", float(raw - enc))
        global_flight_recorder().record(
            "kv_spill", page=int(page), bytes=int(enc), raw_bytes=int(raw))
        return True

    def _on_page_evict(self, page: int, key: bytes) -> None:
        """``Pager.evict_hook``: a registered rc=0 page is leaving the pool
        (the pager already dropped its key). Records ``radix_evict``; with
        a host tier, host-backed keys evict for free, un-backed ones spill
        inside the tick's budget or count as dropped."""
        global_flight_recorder().record(
            "radix_evict", page=int(page), prefix_tokens=len(key) // 4)
        tier = self._tier
        if tier is None or tier.contains(key):
            return
        if self._spill_budget <= 0:
            self._tier_dropped += 1
            global_metrics().inc("cache_tier.dropped_total")
            return
        self._spill_budget -= 1
        self._spill_page(page, key)

    def _tier_step(self) -> None:
        """Once a tick, before admission: reset the spill / readmit
        budgets, bridge the tier's own overflow drops to the counter, and
        when the prefix LRU holds at least ``spill_watermark`` of the
        allocatable pool, back its coldest un-backed pages down to the low
        watermark (budgeted). Only rc=0 LRU pages are scanned: a live
        slot's page never spills."""
        cfg = self._tier_cfg
        self._spill_budget = cfg.spill_pages_per_tick
        self._readmit_budget = cfg.readmit_pages_per_tick
        over = self._tier.dropped - self._tier_drop_seen
        if over:
            global_metrics().inc("cache_tier.dropped_total", float(over))
            self._tier_drop_seen = self._tier.dropped
        alloc = self._pager.num_allocatable
        cached = self._pager.cached_pages()
        if len(cached) < cfg.spill_watermark * alloc:
            return
        need = len(cached) - int(cfg.spill_low_watermark * alloc)
        if need <= 0:
            return
        for page, key in cached[:need]:
            if self._spill_budget <= 0:
                break
            if self._tier.contains(key):
                continue
            self._spill_budget -= 1
            self._spill_page(page, key)

    def _maybe_readmit(self, req: _Request) -> int:
        """Admission's host-tier consult: before the prefix probe declares
        a miss, readmit the request's longest run of host-resident prefix
        pages into the pool (decoded from the tier, landed through
        ``Pager.adopt_cached`` + :meth:`_adopt_pages`, as a handoff
        lands), so the probe then shares them as prefix hits. Budgeted per
        tick; pool pressure readmits nothing. Returns the pages
        readmitted."""
        tier = self._tier
        if tier is None or self._readmit_budget <= 0:
            return 0
        P = self._page
        keys: list[bytes] = []
        found: list[list] = []
        for j in range((req.prompt.shape[0] - 1) // P):
            key = Pager.prefix_key(req.prompt, (j + 1) * P)
            if self._pager.resident(key):
                continue  # the probe shares it without help
            if len(keys) >= self._readmit_budget:
                break
            blocks = tier.get(key)
            if blocks is None:
                break  # a true miss ends the run
            keys.append(key)
            found.append(blocks)
        if not keys:
            return 0
        adopted = self._pager.adopt_cached(keys)
        if not adopted:
            return 0  # pool pressure: admission recomputes
        ords = [i for i, _ in adopted]

        def stack(*leaves):
            return torch.stack([leaves[j] for j in ords])

        kvs = []
        for b in range(len(self._caches)):
            pair = []
            for m in range(2):
                per_page = [bl[b][m] for bl in found]
                if isinstance(per_page[0], tuple):
                    pair.append(tuple(stack(*z) for z in zip(*per_page)))
                else:
                    pair.append(stack(*per_page))
            kvs.append(tuple(pair))
        staged = self._adopt_pages([p for _, p in adopted], kvs)
        na = len(adopted)
        self._readmit_budget -= na
        self._tier_readmitted += na
        global_metrics().inc("cache_tier.readmitted_total", float(na))
        global_flight_recorder().record(
            "kv_readmit", request=req.req_id, pages=na,
            staged_bytes=int(staged))
        return na

    # -- request lifecycle -------------------------------------------------

    def validate_request(self, prompt, steps, temperature=0.0, top_k=None,
                         top_p=None, rng=None, stop=None, slo=None):
        """Raise exactly the errors :meth:`submit` would; returns the
        normalised prompt and effective ``top_k``."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        s0 = prompt.shape[0]
        if s0 < 1:
            raise ValueError("empty prompt")
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        if s0 + steps > self.lm.max_len:
            raise ValueError(
                f"prompt {s0} + steps {steps} exceeds max_len "
                f"{self.lm.max_len}"
            )
        if s0 > self.prompt_buckets[-1]:
            raise ValueError(
                f"prompt {s0} exceeds largest bucket {self.prompt_buckets[-1]}"
            )
        if self._paged:
            bucket = next(b for b in self.prompt_buckets if b >= s0)
            need = -(-max(bucket, s0 + steps + self._spec_k + self._spec_w)
                     // self._page)
            if need > self._pool_pages - 1:  # page 0 is trash
                # Would queue forever: the pool can never cover it.
                raise ValueError(
                    f"request needs {need} pages but the pool holds "
                    f"{self._pool_pages - 1} allocatable"
                )
        if temperature > 0.0 and rng is None:
            raise ValueError("temperature > 0 requires an rng seed")
        top_k_eff = top_k if top_k is not None else self.top_k
        if top_k_eff is not None and not (1 <= top_k_eff <= self.lm.vocab):
            raise ValueError(f"top_k {top_k_eff} outside [1, {self.lm.vocab}]")
        if top_p is not None and not (0.0 < top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if stop is not None and any(len(seq) == 0 for seq in stop):
            raise ValueError("stop sequences must be non-empty")
        if slo is not None and not isinstance(slo, SLOSpec):
            raise TypeError(
                f"slo must be a config.SLOSpec, got {type(slo).__name__}")
        return prompt, top_k_eff

    def submit(self, prompt, steps: int, temperature: float = 0.0,
               top_k: int | None = None, top_p: float | None = None,
               eos_id: int | None = None, rng: int | None = None,
               stop: list | None = None,
               on_token: Callable[[int, int, int], None] | None = None,
               slo: SLOSpec | None = None,
               t_submit: float | None = None, _fanout: int = -1) -> int:
        """Queue one request; returns its id. ``rng`` is the integer seed
        of a sampled request's key stream (the same as ``generate``'s for
        it alone). ``stop`` token sequences end the stream (inclusive);
        ``on_token(req_id, token, index)`` streams each commit on the
        ticking thread, exactly once per index. ``slo`` attaches a latency
        budget, a tenant and a priority (``config.SLOSpec``). Raises
        :class:`QueueFullError` synchronously when admission control
        rejects the request (depth bound, tenant burst cap, best-effort
        shed): no id waits on ``result()``."""
        prompt, top_k_eff = self.validate_request(
            prompt, steps, temperature, top_k, top_p, rng, stop, slo
        )
        do_sample = temperature > 0.0
        with self._cv:
            req_id = self._next_id
            self._next_id += 1
        req = _Request(
            req_id=req_id,
            prompt=prompt,
            steps=steps,
            temperature=float(temperature) if do_sample else 0.0,
            # Greedy requests normalise their knobs to identity values so
            # they never force the top-k/top-p sorts onto a tick.
            top_k=(top_k_eff if do_sample and top_k_eff is not None
                   else self.lm.vocab),
            top_p=top_p if do_sample and top_p is not None else 1.0,
            eos_id=eos_id,
            seed=int(rng) if rng is not None else 0,
            stop=tuple(tuple(int(t) for t in seq) for seq in (stop or ())),
            on_token=on_token,
            t_submit=t_submit if t_submit is not None else time.perf_counter(),
            slo=slo,
            fanout_group=_fanout,
        )
        if self._capacity is not None:
            # Submit-time TTFT forecast: a read-only radix walk and scalar
            # reads, safe on a client thread.
            hit = self._pager.radix_probe(prompt)[1] if self._paged else 0
            req.ttft_forecast_s = self._capacity.forecast_ttft(
                prompt.shape[0], hit)
        tenant, prio = request_tenant(req), request_priority(req)
        if self._journal is not None:
            # Shed a flood before paying journal I/O (the bounded append
            # below stays the authoritative check).
            try:
                with self._cv:
                    self._queue.check(tenant, prio)
            except QueueFullError as e:
                self._record_rejection(tenant, prio, e, request=req_id)
                raise
            # Payload and knobs BEFORE the request is reachable: a replay
            # (or a crash-recovering process) rebuilds the request from
            # this record alone; the seed keys a sampled replay's stream.
            try:
                self._journal.record_submit(
                    req_id, prompt.astype(np.int32),
                    meta={"steps": steps, "temperature": req.temperature,
                          "top_k": req.top_k, "top_p": req.top_p,
                          "eos_id": eos_id,
                          "stop": [list(q) for q in req.stop],
                          "seed": req.seed})
            except Exception as e:  # noqa: BLE001 — serve anyway, loudly
                log.warning("journal submit failed for %d: %r", req_id, e)
        try:
            with self._cv:
                self._queue.append(req)  # bounded: may raise
                self._cv.notify_all()
        except QueueFullError as e:
            self._record_rejection(tenant, prio, e, request=req_id)
            # Done-marked, so that no crash recovery resurrects a request
            # the client was told was rejected.
            self._journal_done(req_id)
            raise
        global_metrics().inc("scheduler.admitted_total")
        return req_id

    def submit_fanout(self, prompt, n: int, steps: int,
                      temperature: float = 0.0, top_k: int | None = None,
                      top_p: float | None = None, eos_id: int | None = None,
                      rng: int | None = None, stop: list | None = None,
                      on_token: Callable[[int, int, int], None] | None = None,
                      slo: SLOSpec | None = None) -> list[int]:
        """Queue ``n`` continuations of ONE prompt as a copy-on-write
        fan-out group; returns their request ids in submission order.
        Every sibling shares every common full prompt page through the
        prefix probe, and a greedy group keeps its first admitted
        sibling's last prompt page claimed so later siblings FORK it (one
        device page copy, no suffix pass). Greedy siblings are
        bit-identical to ``n`` independent :meth:`submit` calls; sampled
        siblings (``temperature > 0`` requires ``rng``) each draw under
        ``fanout_seeds(rng, n)[j]``. Dense layouts and ``n == 1`` are
        plain serial submits. On a mid-group :class:`QueueFullError` the
        already-queued siblings stay queued and the group shrinks."""
        if n < 1:
            raise ValueError(f"fan-out width must be >= 1, got {n}")
        sib_rngs: list = [rng] * n
        if temperature > 0.0:
            if rng is None:
                raise ValueError("temperature > 0 requires an rng seed")
            sib_rngs = fanout_seeds(rng, n)
        gid = -1
        if self._paged and n > 1:
            with self._cv:
                gid = self._fanout_next
                self._fanout_next += 1
                self._fanout_groups[gid] = _FanoutGroup(
                    remaining=n, greedy=temperature == 0.0
                )
        ids: list[int] = []
        try:
            for j in range(n):
                ids.append(self.submit(
                    prompt, steps, temperature=temperature, top_k=top_k,
                    top_p=top_p, eos_id=eos_id, rng=sib_rngs[j], stop=stop,
                    on_token=on_token, slo=slo, _fanout=gid,
                ))
        except Exception:
            if gid >= 0:
                with self._cv:
                    fg = self._fanout_groups.get(gid)
                    if fg is not None:
                        fg.remaining -= n - len(ids)
                        if fg.remaining <= 0:
                            self._fanout_kill_locked(gid, fg)
            raise
        return ids

    def _fanout_kill_locked(self, gid: int, fg: _FanoutGroup,
                            direct: bool = False) -> None:
        """Drop an emptied fan-out group (``_cv`` held). Its claimed page
        is released now on the ticking thread (``direct``), else parked
        for the next admission sweep: only the ticking thread moves pager
        refcounts."""
        if fg.page is not None:
            if direct:
                self._pager.release_claim(fg.page)
            else:
                self._fanout_release.append(fg.page)
            fg.page = None
        self._fanout_groups.pop(gid, None)

    def _fanout_dec_locked(self, req: _Request) -> None:
        """Consume ``req``'s fan-out membership (``_cv`` held)."""
        gid = req.fanout_group
        if gid < 0:
            return
        req.fanout_group = -1
        fg = self._fanout_groups.get(gid)
        if fg is None:
            return
        fg.remaining -= 1
        if fg.remaining <= 0:
            self._fanout_kill_locked(gid, fg)

    def cancel(self, req_id: int) -> bool:
        """Queued -> dropped with an empty result; live (in a slot, mid-
        prefill included) -> retired at the next commit boundary with its
        partial stream as the result. False for ids never issued or
        already finished."""
        with self._cv:
            if req_id in self._done or not 0 <= req_id < self._next_id:
                return False
            req = self._queue.remove_id(req_id)
            if req is None:
                live = req_id == self._admitting or any(
                    s.req is not None and s.req.req_id == req_id
                    for s in self.slots
                )
                if not live:
                    return False
                self._cancelled.add(req_id)
                global_flight_recorder().record(
                    "cancel", request=req_id, state="live"
                )
                return True
            self._cancelled.discard(req_id)
            self._fanout_dec_locked(req)
            if req.delivered_tokens is not None:
                # A replayed request waiting for re-admission already
                # streamed its first life: result() is that stream.
                self._done[req_id] = req.delivered_tokens
                self._done_lps[req_id] = req.delivered_lps
            else:
                self._done[req_id] = np.zeros((0,), np.int32)
                self._done_lps[req_id] = np.zeros((0,), np.float32)
            self._cv.notify_all()
            global_flight_recorder().record(
                "cancel", request=req_id, state="queued"
            )
        # The done mark's disk write runs outside the handoff lock.
        self._journal_done(req_id)
        return True

    # -- traffic control ----------------------------------------------------

    def _record_rejection(self, tenant: str, prio: int, err: Exception,
                          request: int | None = None) -> None:
        """The one rejection-bookkeeping body (books, counter,
        ``request_rejected`` flight event) of submit and
        :meth:`admission_check`."""
        with self._cv:
            self._rejected += 1
        global_metrics().inc("scheduler.rejected_total")
        ev = {"tenant": tenant, "priority": prio, "reason": str(err)[:200]}
        if request is not None:
            ev["request"] = request
        global_flight_recorder().record("request_rejected", **ev)

    def admission_check(self, slo: SLOSpec | None = None,
                        request: int | None = None) -> None:
        """Raise :class:`QueueFullError` iff a :meth:`submit` carrying
        ``slo`` would be rejected right now, recording the rejection as
        submit does (a front end's pre-check before it spends work on the
        request)."""
        tenant = slo.tenant if slo is not None else "default"
        prio = slo.priority if slo is not None else 0
        try:
            with self._cv:
                self._queue.check(tenant, prio)
        except QueueFullError as e:
            self._record_rejection(tenant, prio, e, request=request)
            raise

    def _maybe_preempt(self) -> None:
        """Decode-slot preemption (ticking thread, start of admission):
        when the queue's top priority class holds a request that has
        burned ``preempt_ttft_fraction`` of its TTFT budget waiting, and
        neither a slot nor (paged) the pages it needs would free
        otherwise, replay the LOWEST-priority decode slot
        (:meth:`_replay_slot`). At most one victim a tick: admission runs
        right after and serves the waiting request first."""
        sched = self._sched
        if sched is None or not sched.preempt:
            return
        with self._cv:
            if len(self._queue) == 0:
                return
            cand = self._queue.preempt_candidate()
        if cand is None:
            return
        req, prio = cand
        if any(s.req is None for s in self.slots):
            # A free slot serves the head unless it is PAGE-starved: paged
            # admission is all-or-nothing, and a head whose reservation the
            # pool cannot cover even after evicting every cold page waits
            # at the free slot while lower classes hold the pages. The
            # need is an upper bound (prefix sharing only shrinks it).
            if not self._paged:
                return
            s0 = req.prompt.shape[0]
            bucket = next(b for b in self.prompt_buckets if b >= s0)
            need = -(-max(bucket, s0 + req.steps + self._spec_k
                          + self._spec_w) // self._page)
            if self._pager.can_alloc(need):
                return
        waited = time.perf_counter() - (req.t_requeued or req.t_submit)
        if waited < sched.preempt_ttft_fraction * req.slo.ttft_budget_s:
            return
        with self._cv:
            # A cancel since the snapshot may have taken it off the queue.
            if not any(r.req_id == req.req_id for r in self._queue):
                return
        victims = [s for s in self.slots
                   if s.req is not None and s.pf_done < 0
                   and request_priority(s.req) < prio]
        if not victims:
            return  # never preempt an equal or higher class
        # Lowest class first; ties to the fewest emitted tokens (the
        # cheapest regeneration).
        victim = min(victims, key=lambda s: (request_priority(s.req),
                                             len(s.tokens)))
        vid, vprio = victim.req.req_id, request_priority(victim.req)
        delivered = len(victim.tokens)
        self._replay_slot(victim, event="preempted",
                          extra={"for_request": req.req_id})
        with self._cv:
            self._preempted += 1
        global_metrics().inc("scheduler.preempted_total")
        log.info("preempted request %d (priority %d, %d tokens delivered) "
                 "for request %d (priority %d, waited %.3fs of %.3fs TTFT)",
                 vid, vprio, delivered, req.req_id, prio, waited,
                 req.slo.ttft_budget_s)

    def _replay_slot(self, slot: _Slot, event: str = "replayed_from_journal",
                     extra: dict | None = None) -> None:
        """Replay one slot's request: free the slot (paged: its registered
        prompt pages drop into the prefix LRU, so the re-admission is a
        suffix-only prefill), discard the partial stream and re-queue the
        request at the FRONT with ``stream_skip`` set to what the client
        already received. With a journal the request is rebuilt from its
        journaled payload and meta (``source="journal"`` on the flight
        event), else from the in-memory record (``"memory"``, also the
        loud fallback when the journal read fails). Greedy replays
        regenerate the same stream, and sampled ones the same key schedule
        (keyed by the request's seed and token index). Recovery replays
        with the default event; preemption (``event="preempted"``) rides
        the same path."""
        req = slot.req
        # Per-life stamps of the interrupted life, riding its flight edge.
        life: dict = {}
        if slot.t_first:
            if req.stream_skip == 0:
                life["ttft_s"] = round(slot.t_first - req.t_submit, 6)
            if len(slot.tokens) > 1 and slot.t_last > slot.t_first:
                life["life_itl_mean_s"] = round(
                    (slot.t_last - slot.t_first) / (len(slot.tokens) - 1), 6)
        # The client's high-water mark across lives (a life that replays
        # a replay restarts slot.tokens at 0).
        delivered = max(req.stream_skip, len(slot.tokens))
        if req.delivered_tokens is None or len(slot.tokens) >= len(
                req.delivered_tokens):
            req.delivered_tokens = np.asarray(slot.tokens, np.int32)
            req.delivered_lps = np.asarray(slot.lps, np.float32)
            if len(slot.tokens) > req.stream_skip:
                # This life delivered new tokens: the next new token's ITL
                # measures from its last one.
                req.t_last_delivered = slot.t_last
        source = "memory"
        if self._journal is not None:
            try:
                payload = self._journal.read_payload(req.req_id)
                meta = self._journal.submit_meta(req.req_id)
                if meta is not None:
                    req = dataclasses.replace(
                        req,
                        prompt=np.asarray(payload, np.int64).reshape(-1),
                        steps=int(meta["steps"]),
                        temperature=float(meta["temperature"]),
                        top_k=int(meta["top_k"]),
                        top_p=float(meta["top_p"]),
                        eos_id=meta["eos_id"],
                        seed=int(meta["seed"]),
                        stop=tuple(tuple(int(t) for t in q)
                                   for q in meta.get("stop", [])))
                    source = "journal"
            except Exception as e:  # noqa: BLE001 — fallback, loudly
                log.warning("journal replay of request %d fell back to the "
                            "in-memory record: %r", req.req_id, e)
        # Host-side attachments (on_token, slo, the delivered stream and
        # its stamps) carry over from the live record.
        req.stream_skip = delivered
        req.t_requeued = time.perf_counter()
        global_flight_recorder().record(
            event, request=req.req_id, slot=slot.idx, source=source,
            tokens_discarded=len(slot.tokens), **life, **(extra or {}),
        )
        with self._cv:
            self._release_slot(slot)
            self._queue.appendleft(req)
            self._cv.notify_all()
        self._park_slot_row(slot.idx)

    def _drop_slot(self, slot: _Slot) -> None:
        """Last resort when a slot's request cannot be replayed: it
        finishes once, with an empty result (a ``result()`` waiter sees
        the loss, never a timeout), and counts as missed for its tenant."""
        req = slot.req
        global_flight_recorder().record(
            "request_dropped", request=req.req_id, slot=slot.idx)
        if self.obs_timeline:
            global_metrics().observe("continuous.request_latency_s",
                                     time.perf_counter() - req.t_submit)
            if req.slo is not None:
                global_metrics().inc(f"slo.missed_total.{req.slo.tenant}")
        global_flight_recorder().record(
            "finish", request=req.req_id, reason="dropped", tokens=0)
        with self._cv:
            self._done[req.req_id] = np.zeros((0,), np.int32)
            self._done_lps[req.req_id] = np.zeros((0,), np.float32)
            self._cancelled.discard(req.req_id)
            self._completed += 1
            self._release_slot(slot)
            self._cv.notify_all()
        self._journal_done(req.req_id)
        global_metrics().inc("continuous.completed")
        self._park_slot_row(slot.idx)

    def _journal_done(self, req_id: int) -> None:
        """Done-mark a request in the journal (no-op without one; a
        journal write failure must not poison the serving path)."""
        if self._journal is None:
            return
        try:
            self._journal.record_done(req_id)
        except Exception as e:  # noqa: BLE001 — serving outlives the WAL
            log.warning("journal done mark failed for %d: %r", req_id, e)

    def _slo_violation(self, slot: _Slot, budget: str, budget_s: float,
                       measured_s: float) -> None:
        """The first budget violation takes the request out of goodput and
        records ONE ``slo_missed`` flight event."""
        if slot.slo_ok:
            slot.slo_ok = False
            slot.req.slo_violated = True  # survives a replay
            global_flight_recorder().record(
                "slo_missed", request=slot.req.req_id,
                tenant=slot.req.slo.tenant, budget=budget, budget_s=budget_s,
                measured_s=round(measured_s, 6))

    # -- elastic recovery ---------------------------------------------------

    def _on_device_event(self, event: str, key: str) -> None:
        """Membership watch callback (on the killer's or the reaper's
        thread): a ``leave`` of a member of the CURRENT mesh is queued for
        the ticking thread, which owns the state recovery rebuilds."""
        if event != "leave" or not key.startswith("device:"):
            return
        try:
            did = int(key.split(":", 1)[1])
        except ValueError:
            return
        with self._cv:
            if did not in self._mesh_device_ids or key in self._lost_pending:
                return
            self._lost_pending.append(key)
            self._cv.notify_all()  # wake an idle server thread
        global_flight_recorder().record("device_lost", device=key,
                                        tp=self._tp)
        log.warning("mesh device lost: %s (tp=%d)", key, self._tp)

    def device_lost_pending(self) -> bool:
        """True when a member loss awaits recovery (the next tick re-shards,
        or raises under ``auto_reshard=False``)."""
        with self._cv:
            return bool(self._lost_pending)

    def _ensure_mesh(self) -> None:
        """The device-lost gate of every dispatch entry on the ticking
        thread (``tick``, :meth:`adopt_prefill_pages`): recover before
        anything runs on the broken layout, or raise when ``auto_reshard``
        is off."""
        if self._lost_pending:
            if self._recovery.auto_reshard:
                self.recover()
            else:
                with self._cv:
                    lost = list(self._lost_pending)
                raise DeviceLostError(
                    f"mesh device(s) lost: {lost} — auto_reshard is off; "
                    "call recover()")

    @torch.no_grad()
    def recover(self) -> dict:
        """Re-shard the batcher onto its surviving members after a loss:

        1. **shrink the mesh**: the new tp is the largest divisor of the
           old tp the survivors can host (``validate_tp`` and a per-block
           head-parity check run anyway, by name), on the survivors in the
           old axis order, each keeping its member id;
        2. **re-place the weights**: the sharded model is rebuilt at the
           new tp from the old shards' slices, the lost shard's through the
           host (``models.transformer_lm.reshard_lm``; a tp=1 remnant is a
           plain LM on the survivor's device);
        3. **migrate live state** by a ``parallel.sharding.KVReshardPlan``:
           every block's KV per shard (the lost shard's heads through the
           host), the sampling state and the draft's weights and caches
           from a surviving member; the page table re-uploads at the next
           paged tick;
        4. **replay** the requests whose state does not migrate
           (``policy="replay"``, or mid-chunked-prefill slots) from the
           journal, through the prefix cache, in FIFO order.

        Runs on the ticking thread (``tick`` calls it under
        ``auto_reshard``); call it yourself only between synchronous ticks.
        Builds no kernel. Returns the plan's summary with the migrated /
        replayed / dropped counts and the wall (also the ``mesh_reshard``
        flight event). Raises :class:`DeviceLostError` when no recovery
        exists (every member lost, or the survivors below ``min_tp``); the
        loss then stays pending."""
        # The tick in flight (pipeline depth 2) commits first: its results
        # came off the old layout, and its commits move slot.tokens, which
        # the migrate-or-replay choice and the replay's arithmetic read.
        fl, self._inflight = self._inflight, None
        if fl is not None:
            self._tick_commit(fl)
        t0 = time.perf_counter()
        old = self._mesh_devices
        dead = self._health.dead_ids() if self._health is not None else set()
        lost_here = sorted(m.id for m in old if m.id in dead)
        if not lost_here:
            # Never on a mesh, or nothing of ours died.
            with self._cv:
                self._lost_pending.clear()
            return {"old_tp": self._tp, "new_tp": self._tp, "lost": []}
        survivors = [m for m in old if m.id not in dead]
        if not survivors:
            raise DeviceLostError(
                f"every device of the tp={self._tp} mesh is lost")
        old_tp = new_tp = self._tp
        while new_tp > len(survivors) or old_tp % new_tp:
            new_tp -= 1
        if new_tp < self._recovery.min_tp:
            raise DeviceLostError(
                f"{len(survivors)} survivors support tp={new_tp}, below "
                f"RecoveryConfig.min_tp={self._recovery.min_tp}")
        validate_tp(self.lm, new_tp)
        axis = self._axis
        new_mesh = self._mesh.survivors(axis, dead, new_tp)
        new_devices = new_mesh.members()
        plan = plan_kv_reshard(old, new_devices, lost_here, axis)
        # The weights' bytes are booked apart: the plan's summary is the
        # live state's, as in the JAX package.
        wplan = plan_kv_reshard(old, new_devices, lost_here, axis)
        self.lm = reshard_lm(self.lm, wplan, new_mesh)
        self.device = self.lm.device
        kv_sh = kv_head_sharding(new_mesh, axis)
        self._caches = plan.migrate_tree(self._caches, kv_sh)
        for name, block, (ck, _) in zip(self.lm.block_names, self.lm.blocks,
                                        self._caches):
            # A plan bug shows as a shard holding the wrong head span.
            leaf = _members(ck[0] if isinstance(ck, Shards) else ck)[0]
            try:
                check_head_parity(block.cache_heads, leaf.shape[1] * new_tp)
            except ValueError as e:
                raise ValueError(f"{name}: {e}") from None
        repl = Sharding(new_mesh)
        self._dstate = plan.migrate_replicated(self._dstate, repl)
        self._rows0 = self._rows0.to(self.device)
        if self._spec:
            self._draft_caches = plan.migrate_replicated(self._draft_caches,
                                                         repl)
            if self._draft_weights is not None:
                self._draft_weights = plan.migrate_replicated(
                    self._draft_weights, repl)
            else:
                self._draft_lm.load_state_dict(plan.migrate_replicated(
                    self._draft_lm.state_dict(), repl), assign=True)
        self._mesh = new_mesh if new_tp > 1 else None
        self._tp = new_tp
        self._kv_sharding = kv_sh if new_tp > 1 else None
        # Placement changed even where the host table did not.
        self._table_dev = None
        self._table_snapshot = None
        with self._cv:
            # Consume only the losses THIS recovery handled: a member
            # killed on another thread since the dead_ids() snapshot stays
            # pending, so the next tick recovers again.
            consumed = {f"device:{i}" for i in lost_here}
            self._lost_pending = [k for k in self._lost_pending
                                  if k not in consumed]
            self._mesh_devices = list(new_devices)
            self._mesh_device_ids = {m.id for m in new_devices}
        if self._sp_cfg is not None and self._sp_cfg.enabled:
            # The ring may hold the lost member, and its tp must track this
            # batcher's.
            self._rebuild_sp(dead, new_tp)
        # Per request: decoding slots migrate (their state just did);
        # mid-chunked-prefill slots, and every slot under "replay", replay.
        migrated = replayed = dropped = 0
        replay_ids: list[int] = []
        replay_all = self._recovery.policy == "replay"
        for slot in self.slots:
            if slot.req is None:
                continue
            if replay_all or slot.pf_done >= 0:
                rid = slot.req.req_id
                try:
                    self._replay_slot(slot)
                except Exception:  # noqa: BLE001 — drop, don't wedge
                    if slot.req is not None:
                        log.exception("replay failed for request %d; "
                                      "dropping", rid)
                        self._drop_slot(slot)
                        dropped += 1
                        continue
                    # Released and re-queued before failing: in flight.
                    log.exception("replay of request %d raised after "
                                  "re-queue; replay proceeds", rid)
                replayed += 1
                replay_ids.append(rid)
            else:
                migrated += 1
                global_flight_recorder().record(
                    "kv_migrated", request=slot.req.req_id, slot=slot.idx,
                    tokens_kept=len(slot.tokens))
        if len(replay_ids) > 1:
            # Each replay re-queued at the front in slot order; restore
            # FIFO (ids rise in submit order) by MEMBERSHIP, since a cancel
            # may have taken a replay off the queue since.
            ids = set(replay_ids)
            with self._cv:
                head = sorted((r for r in self._queue if r.req_id in ids),
                              key=lambda r: r.req_id)
                if head:
                    rest = [r for r in self._queue if r.req_id not in ids]
                    self._queue.clear()
                    self._queue.extend(head + rest)
        wall = time.perf_counter() - t0
        with self._cv:
            self._recoveries += 1
            self._recovery_migrated += migrated
            self._recovery_replayed += replayed
            self._recovery_dropped += dropped
            self._last_recovery_wall_s = wall
        reg = global_metrics()
        reg.observe("recovery.wall_s", wall)
        for what, n in (("migrated", migrated), ("replayed", replayed),
                        ("dropped", dropped)):
            if n:
                reg.inc(f"recovery.{what}_total", float(n))
        summary = plan.summary()
        summary.update(migrated=migrated, replayed=replayed, dropped=dropped,
                       wall_s=wall, sp_width=self._sp.sp if self._sp else 1,
                       weight_host_staged_bytes=wplan.host_staged_bytes)
        global_flight_recorder().record(
            "mesh_reshard", old_tp=old_tp, new_tp=new_tp, lost=lost_here,
            migrated=migrated, replayed=replayed, dropped=dropped,
            moved_bytes=plan.moved_bytes,
            host_staged_bytes=plan.host_staged_bytes,
            weight_host_staged_bytes=wplan.host_staged_bytes,
            wall_s=round(wall, 6))
        log.warning("mesh reshard: tp %d -> %d (lost %s): %d migrated, %d "
                    "replayed, %d dropped in %.3fs", old_tp, new_tp,
                    lost_here, migrated, replayed, dropped, wall)
        return summary

    # -- retirement ---------------------------------------------------------

    def _release_slot(self, slot: _Slot) -> None:
        """Reset one slot's host-side lifecycle state and return its pages
        to the pool (caller holds ``_cv``): the one body that finish,
        replay and drop share."""
        slot.req = None
        slot.tokens = []
        slot.lps = []
        slot.pf_done = -1
        slot.slo_ok = True
        slot.t_first = 0.0
        slot.obs_count = 0
        if self._paged:
            self._pager.free_slot(slot.idx)

    def _finish(self, slot: _Slot, reason: str = "completed") -> None:
        req = slot.req
        if self.obs_timeline:
            global_metrics().observe(
                "continuous.request_latency_s",
                time.perf_counter() - req.t_submit,
            )
            if req.slo is not None:
                kind = "met" if slot.slo_ok else "missed"
                global_metrics().inc(f"slo.{kind}_total.{req.slo.tenant}")
        toks = np.asarray(slot.tokens, np.int32)
        lps = np.asarray(slot.lps, np.float32)
        if req.delivered_tokens is not None and len(toks) < len(
                req.delivered_tokens):
            # Cancelled mid-regeneration: result() never contradicts what
            # the client received in the earlier life.
            toks, lps = req.delivered_tokens, req.delivered_lps
        stamps = {}
        if slot.t_first:
            if req.stream_skip == 0:
                stamps["ttft_s"] = round(slot.t_first - req.t_submit, 6)
        if req.t_requeued:
            stamps["replayed_life"] = True
        global_flight_recorder().record(
            "finish", request=req.req_id, reason=reason, tokens=len(toks),
            **stamps,
        )
        with self._cv:
            self._done[req.req_id] = toks
            self._done_lps[req.req_id] = lps
            while len(self._done_lps) > self._LPS_CAP:
                self._done_lps.pop(next(iter(self._done_lps)))
            self._cancelled.discard(req.req_id)
            self._completed += 1
            self._release_slot(slot)
            self._cv.notify_all()
        self._journal_done(req.req_id)
        self._park_slot_row(slot.idx)
        global_metrics().inc("continuous.completed")

    def _commit(self, slot: _Slot, token: int, lp: float) -> None:
        """Append one emitted token; EOS, a stop sequence, the step budget
        or a pending cancel finishes the request."""
        req = slot.req
        with self._cv:
            cancelled = req.req_id in self._cancelled
            self._cancelled.discard(req.req_id)
        if cancelled:
            self._finish(slot, reason="cancelled")
            return
        emitted_before = len(slot.tokens)
        # A replay's regenerated prefix (indices < stream_skip) was
        # delivered, stamped and counted in an earlier life: it re-runs
        # for state only.
        regen = emitted_before < req.stream_skip
        if regen and token != int(req.delivered_tokens[emitted_before]):
            # The re-run (a prefix-hit suffix pass, tie-close to the whole
            # prompt's) picked another token than the client received.
            self._regen_mismatches += 1
            global_flight_recorder().record(
                "regen_mismatch", request=req.req_id, index=emitted_before,
                delivered=int(req.delivered_tokens[emitted_before]),
                regenerated=int(token))
        if self.obs_timeline:
            now = time.perf_counter()
            slo = req.slo
            if slot.t_first == 0.0:
                slot.t_first = now
                if emitted_before == 0 and req.stream_skip == 0:
                    ttft = now - req.t_submit
                    self._ttft_pending.append(ttft)
                    if (self._capacity is not None
                            and req.ttft_forecast_s > 0.0):
                        self._capacity.on_ttft(req.ttft_forecast_s, ttft)
                    if slo is not None and slo.ttft_budget_s is not None:
                        if ttft <= slo.ttft_budget_s:
                            self._slo_pending["ttft_met"] += 1
                        else:
                            self._slo_pending["ttft_missed"] += 1
                            self._slo_violation(slot, "ttft",
                                                slo.ttft_budget_s, ttft)
            elif slot.obs_count == emitted_before and not regen:
                if (emitted_before == req.stream_skip
                        and req.t_last_delivered):
                    # First new token after a replay: the gap the client
                    # saw spans the preemption and the regeneration.
                    gap = now - req.t_last_delivered
                else:
                    gap = now - slot.t_last
                self._itl_pending.append(gap)
                if slo is not None and slo.itl_budget_s is not None:
                    if gap <= slo.itl_budget_s:
                        self._slo_pending["itl_met"] += 1
                    else:
                        self._slo_pending["itl_missed"] += 1
                        self._slo_violation(slot, "itl", slo.itl_budget_s,
                                            gap)
            slot.t_last = now
            slot.obs_count = emitted_before + 1
            if not regen:
                self._tick_tokens += 1
                if slot.slo_ok:
                    self._tick_good_tokens += 1
        slot.tokens.append(token)
        slot.lps.append(lp)
        if req.on_token is not None and len(slot.tokens) > req.stream_skip:
            # Exactly once per index across a replay's lives.
            req.on_token(req.req_id, token, len(slot.tokens) - 1)
        if req.eos_id is not None and token == req.eos_id:
            self._finish(slot, reason="eos")
            return
        slot.emitted += 1
        slot.last_token = token
        for seq in req.stop:
            n = len(seq)
            if len(slot.tokens) >= n and tuple(slot.tokens[-n:]) == seq:
                self._finish(slot, reason="stop")
                return
        if slot.emitted >= req.steps:
            self._finish(slot)

    def _stage_decode_row(self, slot: _Slot) -> None:
        req = slot.req
        if self._spec:
            self._admit_draft(slot.idx, req)
        # The next step consumes last_token (stream index emitted - 1) at
        # cache position s0 + emitted - 1.
        ints = [slot.idx, slot.last_token, slot.s0 + slot.emitted - 1,
                req.top_k, slot.emitted, req.seed]
        self._stage_slot(
            self._h2d(ints, torch.int64),
            self._h2d([req.temperature, req.top_p], torch.float32),
        )

    def _admit_draft(self, slot_idx: int, req: _Request) -> None:
        """Prefill the DRAFT model's whole prompt into its dense slot row
        as the slot joins the decode batch. Always the full prompt: the
        draft has no prefix cache and no chunked prefill — one bucketed
        pass per admission keeps its cache in lockstep with the target's
        committed stream. int8 draft weights dequantize for the pass."""
        s0 = req.prompt.shape[0]
        bucket = next(b for b in self.prompt_buckets if b >= s0)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :s0] = req.prompt
        dlm = self._draft_lm
        with swapped_weights(dlm, self._draft_weights):
            h = dlm.embed(self._h2d(ids, torch.int64))
            for block, (ck, cv) in zip(dlm.blocks, self._draft_caches):
                h, k, v = block.prefill(h, bucket)
                ck[slot_idx, :, :bucket] = k[0]
                cv[slot_idx, :, :bucket] = v[0]

    def set_draft_k(self, k: int) -> None:
        """Shrink (or restore) the EFFECTIVE speculation depth at runtime.
        Cache slack, table width and page reservations were sized for the
        CONFIGURED ``draft_k``, so any ``k`` in ``[1, draft_k]`` keeps every
        write inside reserved space; the next tick's draft scan and verify
        chunk simply narrow to ``k``."""
        if self._spec is None:
            raise ValueError(
                "set_draft_k requires speculative mode (draft_lm=)"
            )
        if not 1 <= k <= self._spec.draft_k:
            raise ValueError(
                f"draft_k must be in [1, {self._spec.draft_k}], got {k}"
            )
        if k != self._spec_k_eff:
            self._spec_k_eff = k
            log.info("effective draft_k -> %d (configured %d)", k,
                     self._spec.draft_k)

    def _move_leaf(self, p_src, p_dst, table) -> None:
        """Move one cached vector per slot from position ``p_src`` to
        ``p_dst`` (both (B,)) in every block's K and V (and their scale
        planes): the accepted tree leaf's K/V to its canonical slot. Rows
        with nothing to move carry ``p_src == p_dst`` (an identity
        copy)."""
        B = p_src.shape[0]
        for pair in self._caches:
            for cache in pair:
                for m in _members(cache):
                    kvh, w = m.shape[1], m.shape[-1]
                    heads = torch.arange(kvh, device=m.device)
                    if table is not None:
                        P = self._page

                        def rows(p):
                            phys = torch.gather(
                                table, 1, (p // P)[:, None]).long()
                            return ((phys * kvh + heads) * P
                                    + (p % P)[:, None]).reshape(-1)
                    else:
                        L = m.shape[2]
                        slot = torch.arange(B, device=m.device)[:, None]

                        def rows(p):
                            return ((slot * kvh + heads) * L
                                    + p[:, None]).reshape(-1)

                    flat = m.view(-1, w)
                    flat.index_copy_(0, rows(p_dst), flat[rows(p_src)])

    def _spec_verify(self, dtoks, table, cands, *, sample, truncate,
                     nucleus):
        """The speculative tick's VERIFY pass. Builds every slot's chunk
        ``[last token, proposals (, leaf candidates)]`` ON DEVICE from the
        draft scan's output, runs one fused ``verify_chunk`` /
        ``verify_chunk_paged`` pass over all slots at their own positions,
        reduces each row's longest agreeing prefix and advances the device
        state by each row's commit count — no host array is staged.
        Returns ((d + 1 or d + 2, B) tokens, logprobs, (B,) accepted).

        ``sample`` turns on SPECULATIVE SAMPLING for ticks whose batch
        carries a ``temperature > 0`` row
        (``models/speculative.speculative_sample``: the token committed at
        stream offset j uses the request's counter ``kbase + j``); greedy
        rows of the same batch keep their exact argmax stream.

        TREE DRAFTS (``cands`` (B, w), the draft's top-w ids for the
        position after the chain): the chunk grows w LEAF rows verified in
        the same pass under the tree mask. When a row's whole chain
        accepts AND its correction token matches a leaf, the first matching
        leaf's K/V moves to the canonical ``pos + d + 1`` slot and the
        target's prediction AFTER that leaf commits as a BONUS token (the
        outputs then carry d + 2 rows and ``acc`` counts the bonus).
        Sampled rows take no tree bonus: the leaf's cached K/V and the
        post-leaf prediction are argmax artifacts."""
        d_state, lm = self._dstate, self.lm
        tree = cands is not None
        w = cands.shape[1] if tree else 0
        # The depth comes from the draft output, not the configured k:
        # set_draft_k narrows it at runtime.
        d = dtoks.shape[0] - (2 if tree else 1)
        kc = d + 1 + w
        tok, pos, active = d_state["tok"], d_state["pos"], d_state["active"]
        props = dtoks[:d].transpose(0, 1)  # (B, d)
        parts = [tok[:, None], props]
        if tree:
            parts.append(cands)
        chunk = torch.cat(parts, dim=1)  # (B, kc)
        # Chain rows embed at their own offsets; leaf rows share the
        # post-chain logical position d + 1.
        offs = torch.clamp(torch.arange(kc, device=self.device), max=d + 1)
        x = lm.embed.embed_positions(chunk, pos[:, None] + offs[None, :])
        for block, (ck, cv) in zip(lm.blocks, self._caches):
            if self._paged:
                x, _, _ = block.verify_chunk_paged(
                    x, ck, cv, table, pos, self._kernel.attn_impl, w,
                    self._kernel.decode_split,
                )
            else:
                x, _, _ = block.verify_chunk(x, ck, cv, pos, w)
        logits = lm.head(x)  # (B, kc, V)
        vocab = logits.shape[-1]
        preds = torch.argmax(logits, dim=-1)
        lps = chosen_logprob(
            logits.reshape(-1, vocab), preds.reshape(-1)
        ).reshape(preds.shape)
        acc = accept_speculation(props, preds[:, : d + 1])
        greedy = d_state["temp"] == 0.0
        if sample:
            nd = d + 1
            lg = logits[:, :nd] / torch.clamp(
                d_state["temp"], min=1e-6)[:, None, None]
            flat = lg.reshape(-1, vocab)
            if truncate:
                flat = truncate_rows(
                    flat, d_state["top_k"].repeat_interleave(nd))
            if nucleus:
                flat = nucleus_filter(
                    flat, d_state["top_p"].repeat_interleave(nd))
            out_s, acc_s = speculative_sample(
                flat.reshape(lg.shape), props, d_state["seed"],
                d_state["kbase"],
            )
            # Raw-logit scoring, like the lockstep chunk.
            lps_s = chosen_logprob(
                logits[:, :nd].reshape(-1, vocab), out_s.reshape(-1)
            ).reshape(out_s.shape)
            sel = greedy[:, None]
            preds = torch.cat(
                [torch.where(sel, preds[:, :nd], out_s), preds[:, nd:]], 1)
            lps = torch.cat(
                [torch.where(sel, lps[:, :nd], lps_s), lps[:, nd:]], 1)
            acc = torch.where(greedy, acc, acc_s)
        out_preds, out_lps = preds, lps
        if tree:
            corr = preds[:, d]  # the target's token for pos + d + 1
            match = cands == corr[:, None]  # (B, w)
            hit = (acc == d) & match.any(dim=1)
            if sample:
                hit = hit & greedy
            s_leaf = torch.argmax(match.to(torch.int64), dim=1)  # first
            leaf_row = (d + 1 + s_leaf)[:, None]
            out_preds = torch.cat(
                [preds[:, : d + 1], torch.gather(preds, 1, leaf_row)], 1)
            out_lps = torch.cat(
                [lps[:, : d + 1], torch.gather(lps, 1, leaf_row)], 1)
            # Canonicalize the accepted leaf's cache entry: leaf s moves
            # from pos + d + 1 + s to pos + d + 1. Rows with s == 0, no
            # hit, or inactive reduce to an identity copy at position 0.
            do = hit & (s_leaf > 0) & active
            base = torch.clamp(pos, min=0).long() + d + 1
            zero = torch.zeros_like(base)
            self._move_leaf(torch.where(do, base + s_leaf, zero),
                            torch.where(do, base, zero), table)
            acc = acc + hit.to(acc.dtype)
        ncommit = acc + 1
        last = torch.gather(out_preds, 1, acc[:, None])[:, 0]
        # Optimistic device-side advance, the lockstep chunk's discipline:
        # a surviving slot lands on pos + ncommit; retired slots are
        # cleared host-side before the next tick; idle rows re-park.
        d_state["pos"] = torch.where(
            active, pos + ncommit.to(torch.int32), self._idle_pos
        ).to(torch.int32)
        d_state["tok"] = torch.where(active, last, 0)
        d_state["kbase"] = torch.where(active, d_state["kbase"] + ncommit, 0)
        return out_preds.transpose(0, 1), out_lps.transpose(0, 1), acc

    def _spec_decode(self, active, tracer) -> _InFlight:
        """Dispatch one SPECULATIVE decode round for the whole slot batch:
        the fixed-shape draft scan over the device-resident per-slot
        state, then the fused verify-and-accept pass, and the round's ONE
        fetch (tokens and logprobs with the accepted counts as a last row)
        started. Stages zero host arrays in steady state."""
        d, w = self._spec_k_eff, self._spec_w
        vocab = self.lm.vocab
        sample = any(s.req.temperature > 0.0 for s in active)
        truncate = sample and any(s.req.top_k < vocab for s in active)
        nucleus = sample and any(s.req.top_p < 1.0 for s in active)
        passes = self._decode_passes(active, d + 1 + w, 1)
        eo = self._eobs
        eo_on = eo.enabled
        t_ph = eo.now() if eo_on else 0.0
        t0 = tracer.now() if tracer.enabled else 0.0
        kw = dict(weights=self._draft_weights,
                  attn_impl=self._kernel.attn_impl,
                  split=self._kernel.decode_split)
        st = self._dstate
        if w:
            # d chain steps + the argmax-leaf step + one leaf-coverage
            # step (the leaf token's own draft-cache write); the top-w
            # leaf candidates come from the step that predicts the
            # post-chain position (scan index d).
            dtoks, dtops = draft_chunk(
                self._draft_lm, st["tok"], st["pos"], self._draft_caches,
                n=d + 2, tail_w=w, **kw)
            cands = dtops[d]  # (B, w); cands[:, 0] == dtoks[d]
        else:
            cands = None
            dtoks = draft_chunk(
                self._draft_lm, st["tok"], st["pos"], self._draft_caches,
                n=d + 1, **kw)
        if tracer.enabled:
            tracer.add_span("decode.draft", start=t0, end=tracer.now(),
                            slots=len(active), draft_k=d)
        if eo_on:
            # span=False: decode.draft is the tracer's row.
            t_ph = eo.phase("draft", t_ph, span=False)
        t_verify = tracer.now() if tracer.enabled else 0.0
        toks, lps, acc = self._spec_verify(
            dtoks, self._current_table() if self._paged else None, cands,
            sample=sample, truncate=truncate, nucleus=nucleus,
        )
        fetch = self._fetch(torch.cat([toks, acc[None]]),
                            torch.cat([lps, acc[None].to(lps.dtype)]))
        return _InFlight(fetch=fetch, spec=(d, w, tuple(s.idx for s in active)),
                         t_span=t_verify, t_eo=t_ph, program="verify",
                         passes=passes)

    def _admit(self) -> None:
        # Traffic control: a high-priority request past its TTFT headroom
        # may free a slot here; the loop below admits it first.
        self._maybe_preempt()
        if self._paged:
            # Drain page claims parked by client-thread fan-out group
            # deaths: only this thread moves pager refcounts.
            with self._cv:
                rel, self._fanout_release = self._fanout_release, []
            for pg in rel:
                self._pager.release_claim(pg)
        for slot in self.slots:
            if slot.req is not None:
                continue
            with self._cv:
                if not self._queue:
                    return
                req = self._queue.popleft()
                self._admitting = req.req_id
                fg = self._fanout_groups.get(req.fanout_group)
            i = slot.idx
            s0 = req.prompt.shape[0]
            bucket = next(b for b in self.prompt_buckets if b >= s0)
            if self._sp is not None and s0 >= self._sp_cfg.sp_threshold:
                # Long admission: the ring computes its full pages BEFORE
                # the prefix probe, which then shares them as hits.
                self._sp_admit(req)
            m = 0
            if self._paged:
                P = self._page
                if self._tier is not None:
                    # Host-resident prefix pages readmit (budgeted) before
                    # the probe declares any miss, then share below.
                    self._maybe_readmit(req)
                # Prefix probe: acquire (rc+1) every cached FULL prompt
                # page, first miss stops; capped before the page of the
                # last prompt token, so the suffix pass is never empty.
                for j in range((s0 - 1) // P):
                    key = Pager.prefix_key(req.prompt, (j + 1) * P)
                    if self._pager.lookup_share(i, key) is None:
                        break
                    m += 1
                # All-or-nothing reservation of the rest of the window
                # (prefill writes `bucket` positions; decode reaches
                # s0 + steps - 1). FIFO head-of-line: when the pool cannot
                # cover this request, admission stops here.
                # Speculative mode reserves the overshoot slack too.
                span = max(bucket,
                           s0 + req.steps + self._spec_k + self._spec_w)
                if not self._pager.alloc(i, -(-span // P) - m):
                    self._pager.free_slot(i)  # releases the shares too
                    with self._cv:
                        self._queue.appendleft(req)
                        self._admitting = None
                    return
                self._pager.record_prefix_match(m, s0)
            # Copy-on-write fork: a greedy fan-out sibling whose probe
            # matched every page before the last prompt token, with the
            # group's source page claimed and its first commit cached.
            cow = (
                fg is not None and fg.greedy and fg.page is not None
                and fg.first is not None and req.temperature == 0.0
                and m == (s0 - 1) // self._page
            )
            chunked = (
                self._paged and not cow and self._prefill_chunk is not None
                and s0 - m * self._page > self._prefill_chunk
            )
            tracer = global_tracer()
            t0 = tracer.now() if tracer.enabled else 0.0
            # The capacity forecaster's prefill-wall feed: through the
            # first-token fetch, so it covers the device's work too.
            cap_t0 = time.perf_counter() if self._capacity is not None else 0.0
            cap_tokens = 0
            tok0 = lp0 = None
            if chunked:
                pass  # one K4 pass per tick from here (_prefill_step)
            elif cow:
                dst = self._pager.owned(i)[m]
                self._fork_page(fg.page, dst)
                self._pager.note_cow_fork()
                global_flight_recorder().record(
                    "cow_fork", request=req.req_id, src_page=int(fg.page),
                    dst_page=int(dst), prefix_pages=m,
                    saved_positions=s0 - m * self._page,
                )
                tok0, lp0 = fg.first, fg.first_lp
            elif m:
                # Suffix-only prefill against the shared prefix pages. The
                # suffix pads to whole PAGES (inside the reservation by
                # construction), the window to a power-of-two page count.
                slen = s0 - m * self._page
                n_strip = m + -(-slen // self._page)
                tok0, lp0 = self._prefill_pass(
                    req, self._window_pages(i, n_strip), m * self._page,
                    slen, sample=True,
                )
                cap_tokens = slen
            else:
                tok0, lp0 = self._prefill(i, req, bucket)
                cap_tokens = s0
            if self._capacity is not None and cap_tokens:
                self._capacity.on_prefill(cap_tokens,
                                          time.perf_counter() - cap_t0)
            if self._paged and not chunked:
                # Chunked admissions register on their final pass.
                self._register_prompt_pages(i, req, m)
            if tracer.enabled and not chunked:
                tracer.add_span("batcher.prefill", start=t0, end=tracer.now(),
                                request=req.req_id, bucket=bucket,
                                prefix_pages=m)
            slot.req, slot.s0 = req, s0
            slot.emitted, slot.tokens, slot.lps = 0, [], []
            slot.t_first, slot.obs_count = 0.0, 0
            # A replayed request that already missed its budget stays
            # missed.
            slot.slo_ok = not req.slo_violated
            slot.pf_done = m * self._page if chunked else -1
            with self._cv:
                self._admitting = None
                self._admitted += 1
                if fg is not None and req.fanout_group >= 0:
                    gid, req.fanout_group = req.fanout_group, -1
                    fg.remaining -= 1
                    if (fg.greedy and fg.page is None and fg.remaining > 0
                            and tok0 is not None):
                        # First admitted greedy sibling: claim its last
                        # prompt page (it outlives the sibling) and cache
                        # its first commit for the siblings' forks. A
                        # chunked first sibling leaves the group
                        # fork-less.
                        fg.page = self._pager.owned(i)[(s0 - 1) // self._page]
                        self._pager.retain(fg.page)
                        fg.first, fg.first_lp = tok0, lp0
                    if fg.remaining <= 0:
                        self._fanout_kill_locked(gid, fg, direct=True)
            global_metrics().inc("continuous.admitted")
            # A replay's wait measures from its re-queue.
            queue_wait = time.perf_counter() - (req.t_requeued
                                                or req.t_submit)
            if self._capacity is not None:
                self._capacity.on_queue_wait(queue_wait)
            if self.obs_timeline:
                global_metrics().observe("continuous.queue_wait_s", queue_wait)
            global_flight_recorder().record(
                "admit", request=req.req_id, slot=i, prompt_len=s0,
                prefix_pages=m, chunked=chunked, cow=cow,
                queue_wait_s=round(queue_wait, 6),
            )
            if not chunked:
                self._commit(slot, tok0, lp0)
                if slot.req is req:
                    self._stage_decode_row(slot)

    def _prefill_step(self, slot: _Slot) -> None:
        """One chunked-prefill pass for ``slot``: positions [pf_done,
        pf_done + prefill_chunk) through K4. The final pass registers the
        prompt pages, samples the first token and moves the slot into the
        decode batch."""
        req, s0, P = slot.req, slot.s0, self._page
        tracer = global_tracer()
        t0 = tracer.now() if tracer.enabled else 0.0
        pos0 = slot.pf_done  # page-aligned (chunks are page multiples)
        clen = min(self._prefill_chunk, s0 - pos0)
        final = pos0 + clen >= s0
        n_strip = (pos0 + -(-clen // P) * P) // P
        first = self._prefill_pass(
            req, self._window_pages(slot.idx, n_strip), pos0, clen,
            sample=final,
        )
        slot.pf_done = pos0 + clen
        if tracer.enabled:
            tracer.add_span("batcher.prefill_chunk", start=t0,
                            end=tracer.now(), request=req.req_id, pos0=pos0,
                            chunk_len=clen, final=final)
        if final:
            self._register_prompt_pages(slot.idx, req, 0)
            slot.pf_done = -1
            self._commit(slot, *first)
            if slot.req is req:
                self._stage_decode_row(slot)

    def _obs_flush(self) -> None:
        """Once a tick (idle ticks too, so goodput decays): the batched
        TTFT / ITL samples, the SLO counters and attainment gauges, the
        token and good-token counters and the windowed
        ``continuous.goodput_tokens_s``."""
        reg = global_metrics()
        if self._ttft_pending:
            reg.observe_many("continuous.ttft_s", self._ttft_pending)
            self._ttft_pending = []
        if self._itl_pending:
            reg.observe_many("continuous.itl_s", self._itl_pending)
            self._itl_pending = []
        pend = self._slo_pending
        if any(pend.values()):
            tot = self._slo_totals
            for key, n in pend.items():
                if n:
                    tot[key] += n
                    reg.inc(f"slo.{key}_total", float(n))
                    pend[key] = 0
            for what in ("ttft", "itl"):
                den = tot[f"{what}_met"] + tot[f"{what}_missed"]
                if den:
                    reg.set_gauge(f"slo.{what}_attainment",
                                  tot[f"{what}_met"] / den)
        if self._tick_tokens:
            reg.inc("continuous.tokens_total", float(self._tick_tokens))
        if self._tick_good_tokens:
            reg.inc("continuous.good_tokens_total",
                    float(self._tick_good_tokens))
        now = time.perf_counter()
        gs = self._goodput_samples
        gs.append((now, self._tick_good_tokens))
        self._tick_tokens = 0
        self._tick_good_tokens = 0
        cutoff = now - self.goodput_window_s
        while len(gs) > 1 and gs[0][0] < cutoff:
            gs.popleft()
        span = now - gs[0][0]
        if span > 0:
            # gs[0] anchors the window; its tokens belong to the span
            # before it.
            good = sum(g for _, g in list(gs)[1:])
            reg.set_gauge("continuous.goodput_tokens_s", good / span)
        if self._capacity is not None:
            # Capacity plane: the tick-gap feed, then the (rate-limited)
            # book rebuild, health score and capacity.* gauges.
            if self._cap_last_flush:
                self._capacity.on_tick_gap(now - self._cap_last_flush)
            self._cap_last_flush = now
            self._capacity.update(self, now)

    def tick(self) -> int:
        """Admit into free slots, run ONE prefill pass for each slot mid-
        chunked-prefill, then decode one chunk over every slot — or, in
        speculative mode, one draft-scan + fused-verify round that commits
        1 .. draft_k + 1 (+ 1) tokens per slot — with ONE fetch. At
        ``pipeline_depth=1`` the dispatch and commit halves run back to
        back; at 2 this call dispatches tick t and commits tick t-1 while
        t runs on the card. Returns the number of decoding slots whose
        tick this call committed (0 = none)."""
        fl = self._tick_dispatch()
        if self._depth <= 1:
            return self._tick_commit(fl) if fl is not None else 0
        prev, self._inflight = self._inflight, fl
        return self._tick_commit(prev) if prev is not None else 0

    def drain(self) -> int:
        """Commit the tick in flight, if any: the pipeline boundary before
        reading results outside :meth:`run` / :meth:`result`. Idempotent;
        returns the committed tick's decoding slots (0 = it was empty)."""
        fl, self._inflight = self._inflight, None
        return self._tick_commit(fl) if fl is not None else 0

    @torch.no_grad()
    def _tick_dispatch(self) -> _InFlight | None:
        """Host half of one tick: the ladder's step, admission, the cancel
        sweep, chunked-prefill passes and gauges, then ONE decode (or
        speculative) dispatch with its fetch started. None when no slot
        decodes."""
        self._ensure_mesh()
        t0 = time.perf_counter()
        if self._controller is not None:
            # Before admission: this tick's admits see the current rung.
            self._controller.step(self)
        if self._tier is not None:
            # Before admission too: fresh budgets, and the coldest LRU
            # pages pre-spilled so this tick's evictions find them backed.
            self._tier_step()
        eo = self._eobs
        # The gate is read once a tick: flipping it mid-tick must never
        # pair a 0.0 open with an enabled close.
        eo_on = eo.enabled
        t_ph = eo.now() if eo_on else 0.0
        # continuous.prefill_stall_s: with requests already decoding at
        # tick entry, the wall this tick spends on in-tick prefill work is
        # decode delay they eat (what runtime/disagg takes out of the
        # tick). Observed only when prefill actually ran.
        decode_waiting = self.obs_timeline and any(
            s.req is not None and s.pf_done < 0 for s in self.slots)
        t_stall0 = time.perf_counter() if decode_waiting else 0.0
        pf_tokens0 = self._prefill_tokens
        self._admit()
        if eo_on:
            t_ph = eo.phase("admit", t_ph)
        for slot in self.slots:
            if slot.req is None:
                continue
            with self._cv:
                cancelled = slot.req.req_id in self._cancelled
                self._cancelled.discard(slot.req.req_id)
            if cancelled:  # mid-prefill or between chunks
                self._finish(slot, reason="cancelled")
        for slot in self.slots:
            if slot.req is not None and slot.pf_done >= 0:
                self._prefill_step(slot)  # interleaves with the decode below
        if decode_waiting and self._prefill_tokens > pf_tokens0:
            global_metrics().observe("continuous.prefill_stall_s",
                                     time.perf_counter() - t_stall0)
        if eo_on:
            eo.phase("prefill", t_ph)
        active = [s for s in self.slots if s.req is not None and s.pf_done < 0]
        reg = global_metrics()
        reg.set_gauge("continuous.active_slots",
                      float(sum(1 for s in self.slots if s.req is not None)))
        reg.set_gauge("continuous.prefilling_slots", float(sum(
            1 for s in self.slots if s.req is not None and s.pf_done >= 0)))
        reg.set_gauge("continuous.queue_depth", float(len(self._queue)))
        if self._sched is not None:
            # Per-tenant depth gauges; tenants the queue forgot lose theirs.
            with self._cv:
                depths = self._queue.depths()
            for tenant in self._gauged_tenants - depths.keys():
                reg.remove_gauge(f"scheduler.queue_depth.{tenant}")
            for tenant, depth in depths.items():
                reg.set_gauge(f"scheduler.queue_depth.{tenant}", float(depth))
            self._gauged_tenants = set(depths)
        reg.set_gauge("continuous.h2d_transfers", float(self._h2d_count))
        if self._paged:
            self._pager_books = self._pager.stats()
        if not active:
            if self.obs_timeline:
                self._obs_flush()
            self._sentinel.sample(write_gauges=False)
            return None
        vocab = self.lm.vocab
        tracer = global_tracer()
        if self._spec is None:
            t_ph = eo.now() if eo_on else 0.0
            flags = (any(s.req.temperature > 0.0 for s in active),
                     any(s.req.top_k < vocab for s in active),
                     any(s.req.top_p < 1.0 for s in active))
            passes = self._decode_passes(active, 1, self.chunk)
            t_chunk = tracer.now() if tracer.enabled else 0.0
            toks, lps = self._step_chunk(do_sample=flags[0],
                                         truncate=flags[1], nucleus=flags[2])
            # The tick's one device->host fetch, started here.
            fl = _InFlight(fetch=self._fetch(toks, lps), t_span=t_chunk,
                           t_eo=t_ph, program="decode", passes=passes)
        else:
            fl = self._spec_decode(active, tracer)
        with self._cv:
            self._ticks += 1
        reg.inc("continuous.ticks")
        fl.reqs = [s.req if s.req is not None and s.pf_done < 0 else None
                   for s in self.slots]
        fl.lives = [s.tokens for s in self.slots]
        fl.n_active = len(active)
        fl.t0 = t0
        if eo_on:
            # The host cost of the whole dispatch half.
            eo.phase("dispatch", t0, span=False)
        fl.t_dispatched = time.perf_counter()
        return fl

    def _tick_commit(self, fl: _InFlight) -> int:
        """Commit half of one tick: wait for ``fl``'s fetch, apply each
        slot's tokens (dropping the columns of slots whose binding moved
        since dispatch), recycle window pages and flush the telemetry."""
        eo = self._eobs
        eo_on = eo.enabled
        if eo_on and fl.t_dispatched:
            # Dispatch end -> commit start: ~0 at depth 1, the next tick's
            # dispatch half at depth 2.
            eo.phase("commit_lag", fl.t_dispatched, span=False)
        host = fl.fetch.commit()
        reg = global_metrics()
        tracer = global_tracer()
        if fl.spec is None:
            limits = [self.chunk] * len(self.slots)
            if tracer.enabled and fl.t_span:
                tracer.add_span("batcher.decode_chunk", start=fl.t_span,
                                end=tracer.now(), slots=fl.n_active,
                                chunk=self.chunk)
            if eo_on and fl.t_eo:
                # Dispatch -> fetch landed (batcher.decode_chunk is the
                # tracer's row).
                eo.phase("decode", fl.t_eo, span=False)
        else:
            d, w, active_idx = fl.spec
            limits = [int(a) + 1 for a in host[0, -1]]
            host = host[:, :-1]
            # Acceptance books of the rows ACTIVE at dispatch (idle rows
            # verify garbage nobody commits); a tree round drafts d chain
            # proposals + w leaf candidates per slot and counts a leaf hit
            # as one more accepted. (d, w) are the dispatch's.
            acc_counts = [limits[i] - 1 for i in active_idx]
            with self._cv:
                self._spec_drafted += (d + w) * len(active_idx)
                self._spec_accepted += sum(acc_counts)
                ratio = self._spec_accepted / self._spec_drafted
            reg.set_gauge("continuous.spec_acceptance", ratio)
            if self.obs_timeline:
                reg.observe_many("continuous.spec_accepted_per_tick",
                                 [float(a) for a in acc_counts])
            if tracer.enabled and fl.t_span:
                tracer.add_span("decode.verify", start=fl.t_span,
                                end=tracer.now(), slots=len(active_idx),
                                draft_k=d)
            if eo_on and fl.t_eo:
                eo.phase("verify", fl.t_eo, span=False)
        self._roofline[fl.program] = (
            fl.passes, eo.last_s.get(fl.program) if eo_on and fl.t_eo
            else None)
        wall = time.perf_counter() - fl.t0
        if wall > 0:
            # The share of the dispatch-to-commit wall the host did NOT
            # spend blocked on the fetch.
            reg.set_gauge("runtime.overlap_ratio",
                          max(0.0, 1.0 - fl.fetch.wait_s / wall))
        t_ph = eo.now() if eo_on else 0.0
        for i, slot in enumerate(self.slots):
            req = fl.reqs[i]
            if (req is None or slot.req is not req
                    or slot.tokens is not fl.lives[i] or slot.pf_done >= 0):
                continue  # not decoding at dispatch, or a dead life
            for j in range(limits[i]):
                self._commit(slot, int(host[0, j, i]), float(host[1, j, i]))
                if slot.req is not req:
                    break
        if eo_on:
            t_ph = eo.phase("commit", t_ph)
        if self._paged and self._window is not None:
            # Rolling-window recycling: pages wholly behind every future
            # read ((o + 1) * P <= pos - window + 1, with pos = s0 +
            # emitted - 1 the next write: reads from here on mask positions
            # < index - window + 1) go back to the pool MID-REQUEST.
            for slot in self.slots:
                if slot.req is None or slot.pf_done >= 0:
                    continue
                pos = slot.s0 + slot.emitted - 1
                dead = max(0, pos - self._window + 1) // self._page \
                    - self._pager.base(slot.idx)
                if dead > 0:
                    self._pager.release_prefix(slot.idx, dead)
        if self._paged:
            self._pager_books = self._pager.stats()
        if self.obs_timeline:
            self._obs_flush()
        reg.set_gauge(
            "continuous.active_slots",
            float(sum(1 for s in self.slots if s.req is not None)),
        )
        if eo_on:
            # Post-commit bookkeeping: window recycling, the flush, gauges.
            eo.phase("update", t_ph)
        self._sentinel.sample(write_gauges=False)
        return fl.n_active

    def capacity_book(self) -> dict | None:
        """The capacity plane's last rebuilt book (JSON-safe; its
        ``wall`` stamp lets a consumer age it), or None when the plane is
        off."""
        if self._capacity is None:
            return None
        return self._capacity.book()

    def _memory_stats(self) -> dict[str, float]:
        """Pull-style memory source for ``utils.profiling``'s collector
        (scrape threads: reads only; the pager's books as of the latest
        tick half, see ``_pager_books``). Dense strips: ``memory.kv_bytes``
        (scale planes included) and ``memory.kv_bytes_per_device`` (one
        shard's: logical / tp); pools: ``memory.pool_bytes``
        (``_per_device``), the
        page partition ``memory.pages_used + pages_free + pages_cached ==
        memory.pool_pages`` (the allocatable pool, trash page excluded) and
        the pager's prefix and radix books; speculative mode:
        ``memory.draft_cache_bytes``; both layouts: ``memory.kv_bytes_ratio``
        (cache bytes over the model dtype's)."""
        cache_bytes = float(self._cache_bytes())
        shard_bytes = float(self._shard_cache_bytes())
        out: dict[str, float] = {}
        if self._paged:
            ps = self._pager_books
            out["memory.pool_bytes"] = cache_bytes
            out["memory.pool_bytes_per_device"] = shard_bytes
            out["memory.pool_pages"] = float(self._pager.num_allocatable)
            out["memory.pages_used"] = float(ps.in_use)
            out["memory.pages_cached"] = float(ps.cached)
            # PagerStats.free counts evictable cached pages as free (the
            # allocator's view); the gauges partition instead.
            out["memory.pages_free"] = float(ps.free - ps.cached)
            out["paged.prefix_hits"] = float(ps.prefix_hits)
            out["paged.prefix_misses"] = float(ps.prefix_misses)
            out["paged.prefix_capacity_skips"] = float(
                ps.prefix_capacity_skips)
            out["paged.radix_nodes"] = float(ps.radix_nodes)
            out["paged.radix_partial_hits"] = float(ps.radix_partial_hits)
            out["paged.radix_hit_tokens"] = float(ps.radix_hit_tokens)
            out["paged.cow_forks_total"] = float(ps.cow_forks)
            if self._tier is not None:
                # Pages resident in host memory (warm + cold) and their
                # encoded bytes: a copy below the pool partition above,
                # never counted in it.
                ts = self._tier.stats()
                out["memory.host_bytes"] = float(ts.host_bytes)
                out["memory.pages_spilled"] = float(ts.pages)
        else:
            out["memory.kv_bytes"] = cache_bytes
            out["memory.kv_bytes_per_device"] = shard_bytes
        out["memory.kv_bytes_ratio"] = cache_bytes / float(
            self._native_cache_bytes)
        if self._draft_caches is not None:
            out["memory.draft_cache_bytes"] = float(sum(
                c.numel() * c.element_size()
                for pair in self._draft_caches for c in pair))
        return out

    def _roofline_stats(self) -> dict[str, dict[str, float]]:
        """Pull-style roofline source: each program's latest execution
        (``decode`` chunk or ``verify`` pass, and ``prefill``) counted by
        ``utils.profiling.program_work``, with its wall (None unless
        engine timing is on)."""
        kv = self._kv_quant or "native"
        out = {}
        for prog, (passes, wall) in list(self._roofline.items()):
            st = program_work(self.lm,
                              passes() if callable(passes) else passes, kv)
            st["wall_s"] = wall
            out[prog] = st
        return out

    def stats(self) -> dict:
        """Slot occupancy, queue depth and this batcher's lifetime
        counts; a paged batcher adds the pager's books (pool partition,
        prefix cache, radix and copy-on-write counts)."""
        with self._cv:
            out = {
                "slots": len(self.slots),
                "active": sum(1 for s in self.slots if s.req is not None),
                "queued": len(self._queue),
                "finished_unclaimed": len(self._done),
                "admitted": self._admitted,
                "completed": self._completed,
                "ticks": self._ticks,
                # depth 1: synchronous; 2: one tick in flight between
                # calls (``inflight``: one is pending right now).
                "pipeline_depth": self._depth,
                "inflight": self._inflight is not None,
                "prefill_tokens": self._prefill_tokens,
                "h2d_transfers": self._h2d_count,
                "d2h_fetches": self._d2h_count,
                # Resident KV bytes of the strips or the page pools, scale
                # planes included, and their share of the same geometry in
                # the model's dtype (1.0 native; (hd + 4) / (2 hd) for int8
                # under bf16, (hd / 2 + 4) / (2 hd) for int4).
                "cache_bytes": self._cache_bytes(),
                # Under tp each shard holds its heads' bytes: logical / tp.
                "tp": self._tp,
                "cache_bytes_per_device": self._shard_cache_bytes(),
                "cache_bytes_ratio": (self._cache_bytes()
                                      / float(self._native_cache_bytes)),
                "slo_ttft_met": self._slo_totals["ttft_met"],
                "slo_ttft_missed": self._slo_totals["ttft_missed"],
                "slo_itl_met": self._slo_totals["itl_met"],
                "slo_itl_missed": self._slo_totals["itl_missed"],
                # Traffic-control books; "queued" above never exceeds the
                # scheduler's max_queue_depth.
                "rejected": self._rejected,
                "preempted": self._preempted,
                "regen_mismatches": self._regen_mismatches,
                # Elastic-recovery books (mirrors of the recovery.*
                # counters; wall_s is the latest recovery's).
                "recoveries": self._recoveries,
                "recovery_migrated": self._recovery_migrated,
                "recovery_replayed": self._recovery_replayed,
                "recovery_dropped": self._recovery_dropped,
                "last_recovery_wall_s": self._last_recovery_wall_s,
            }
            if self._controller is not None:
                out["degradation_level"] = self._controller.level
            if self._spec is not None:
                out["spec_drafted"] = self._spec_drafted
                out["spec_accepted"] = self._spec_accepted
                out["spec_acceptance"] = (
                    self._spec_accepted / self._spec_drafted
                    if self._spec_drafted else 0.0
                )
                out["draft_cache_bytes"] = sum(
                    c.numel() * c.element_size()
                    for pair in self._draft_caches for c in pair)
            if self._paged:
                ps = self._pager.stats()
                out["pool_pages"] = ps.num_pages
                out["pages_in_use"] = ps.in_use
                out["pages_free"] = ps.free
                out["pages_cached"] = ps.cached
                out["prefix_hits"] = ps.prefix_hits
                out["prefix_misses"] = ps.prefix_misses
                out["prefix_capacity_skips"] = ps.prefix_capacity_skips
                out["radix_nodes"] = ps.radix_nodes
                out["radix_partial_hits"] = ps.radix_partial_hits
                out["radix_hit_tokens"] = ps.radix_hit_tokens
                out["radix_evictions"] = self._pager.radix_evictions
                out["cow_forks"] = ps.cow_forks
                out["fanout_groups"] = len(self._fanout_groups)
            if self._sp_cfg is not None:
                # The live ring width (1: the ordinary path), admissions
                # the ring prefilled, and its failed dispatches.
                out["sp_width"] = self._sp.sp if self._sp is not None else 1
                out["sp_prefills"] = self._sp_prefills
                out["sp_failures"] = self._sp_failures
            if self._tier is not None:
                ts = self._tier.stats()
                out["host_pages"] = ts.pages
                out["host_bytes"] = ts.host_bytes
                out["tier_spilled"] = self._tier_spilled
                out["tier_readmitted"] = self._tier_readmitted
                out["tier_dropped"] = self._tier_dropped + ts.dropped
                out["tier_codec_bytes_saved"] = ts.codec_bytes_saved
            return out

    def _cache_bytes(self) -> int:
        return sum(m.numel() * m.element_size() for pair in self._caches
                   for c in pair for m in _members(c))

    def _shard_cache_bytes(self) -> int:
        """KV bytes one shard holds (the whole cache without tp)."""
        return sum(m.numel() * m.element_size() for pair in self._caches
                   for c in pair for m in _members(
                       c[0] if isinstance(c, Shards) else c))

    def logprobs(self, req_id: int) -> np.ndarray:
        """Per-token model logprobs of a FINISHED request (claims them)."""
        with self._cv:
            if req_id not in self._done_lps:
                raise KeyError(
                    f"no logprobs for request {req_id} "
                    "(not finished, or already claimed)"
                )
            return self._done_lps.pop(req_id)

    def run(self, max_ticks: int = 100_000) -> dict[int, np.ndarray]:
        """Tick until every submitted request completed; returns
        {req_id: tokens} and clears the finished set. Drains the pipeline
        on the way out (at depth 2 what is left in flight is a garbage
        tail: every slot has retired)."""
        ticks = 0
        while self._queue or any(s.req is not None for s in self.slots):
            self.tick()
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError(f"run() exceeded {max_ticks} ticks")
        self.drain()
        with self._cv:
            done, self._done = self._done, {}
        return done

    # -- threaded serving --------------------------------------------------

    def start(self) -> "ContinuousBatcher":
        """Serve on a background thread: :meth:`submit` from any thread,
        block on :meth:`result`."""
        with self._cv:
            if self._server is not None:
                raise RuntimeError("batcher already started")
            self._stopping = False

            def loop():
                while True:
                    with self._cv:
                        while (not self._stopping and not self._queue
                               and all(s.req is None for s in self.slots)):
                            self._cv.wait(timeout=0.1)
                        if self._stopping:
                            break
                    try:
                        self.tick()
                    except BaseException as e:  # noqa: BLE001 — re-raised
                        with self._cv:
                            self._server_error = e
                            self._stopping = True
                            self._cv.notify_all()
                        log.error("server tick failed: %r", e)
                        return
                    with self._cv:
                        self._cv.notify_all()
                # Stopping: the tick in flight commits on THIS thread
                # (stop() runs on the caller's and touches no device state).
                try:
                    self.drain()
                except Exception as e:  # result() waiters re-raise it
                    with self._cv:
                        self._server_error = e
                    log.error("drain on stop failed: %r", e)
                with self._cv:
                    self._cv.notify_all()

            self._server = threading.Thread(
                target=loop, name="continuous-batcher", daemon=True
            )
            self._server.start()
        return self

    def stop(self) -> None:
        with self._cv:
            server = self._server
            if server is None:
                return
            self._stopping = True
            self._cv.notify_all()
        server.join(timeout=30.0)
        if server.is_alive():
            raise RuntimeError(
                "batcher server thread did not stop within 30s; retry stop()"
            )
        with self._cv:
            self._server = None

    def __enter__(self) -> "ContinuousBatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def close(self) -> None:
        """Retire this batcher: stop its server thread, drop an undrained
        tick's device references and leave the memory and roofline
        gauges. Idempotent."""
        self.stop()
        self._inflight = None
        self._retired = True  # membership events no longer reach it
        if self._sp is not None:
            self._sp.close()
            self._sp = None
        if self._sp_granted:
            # Leftover allowance would absorb another prefiller's real
            # growth.
            self._sentinel.disarm("sp.prefill", self._sp_granted)
            self._sp_granted = 0
        unregister_memory_source("continuous", self)
        unregister_roofline_source("continuous", self)

    def result(self, req_id: int, timeout: float = 300.0) -> np.ndarray:
        """Block until ``req_id`` finishes (requires :meth:`start`);
        returns and claims its tokens."""
        with self._cv:
            if not self._cv.wait_for(
                lambda: req_id in self._done or self._stopping,
                timeout=timeout,
            ):
                raise TimeoutError(f"request {req_id} not done within {timeout}s")
            if req_id not in self._done:
                if self._server_error is not None:
                    raise RuntimeError(
                        "batcher server thread died mid-tick"
                    ) from self._server_error
                raise RuntimeError("batcher stopped before completion")
            return self._done.pop(req_id)
