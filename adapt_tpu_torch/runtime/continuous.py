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

Tensor parallelism, recovery (the journal branch of the replay) and the
host KV tier are later slices.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from collections.abc import Callable

import numpy as np
import torch

from adapt_tpu_torch.config import (
    CapacityConfig,
    KernelConfig,
    ObservabilityConfig,
    RuntimeConfig,
    SchedulerConfig,
    SLOSpec,
    SpeculativeConfig,
)
from adapt_tpu_torch.models.speculative import (
    accept_speculation,
    draft_chunk,
    speculative_sample,
    swapped_weights,
)
from adapt_tpu_torch.models.transformer_lm import (
    TransformerLM,
    chosen_logprob,
    nucleus_filter,
    sample_rows,
    truncate_rows,
)
from adapt_tpu_torch.ops.paged_attention import DEFAULT_PAGE_SIZE
from adapt_tpu_torch.ops.quantize import quantize_params
from adapt_tpu_torch.runtime.capacity import CapacityModel
from adapt_tpu_torch.runtime.paged import Pager, insert_prefill_pages
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

__all__ = ["ContinuousBatcher", "QueueFullError", "fanout_seeds"]

_M64 = (1 << 64) - 1

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
    """The tensors of a cache: both planes of a quantized pair."""
    return cache if isinstance(cache, tuple) else (cache,)


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
    ``capacity`` the capacity plane (``runtime/capacity``, on by default).
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
    ):
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

        def one_cache():
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

        self._caches = [(one_cache(), one_cache()) for _ in lm.block_names]
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
        """Leading FULL pages of ``prompt`` servable from the prefix cache
        without recompute (resident content keys, longest run). Read-only:
        no shares taken, no probe accounting moved. 0 on dense strips."""
        if not self._paged:
            return 0
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        n = 0
        for j in range((prompt.shape[0] - 1) // self._page):
            if not self._pager.resident(
                Pager.prefix_key(prompt, (j + 1) * self._page)
            ):
                break
            n += 1
        return n

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
        try:
            with self._cv:
                self._queue.append(req)  # bounded: may raise
                self._cv.notify_all()
        except QueueFullError as e:
            self._record_rejection(request_tenant(req), request_priority(req),
                                   e, request=req_id)
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
            if req is not None:
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
                return True
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

    def _replay_slot(self, slot: _Slot, event: str = "preempted",
                     extra: dict | None = None) -> None:
        """Replay one slot's request: free the slot (paged: its registered
        prompt pages drop into the prefix LRU, so the re-admission is a
        suffix-only prefill), discard the partial stream and re-queue the
        request at the FRONT with ``stream_skip`` set to what the client
        already received. Greedy replays regenerate the same stream, and
        sampled ones the same key schedule (keyed by request seed and
        token index). This is the in-memory path; the journal-backed one
        comes with recovery."""
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
        req.stream_skip = delivered
        req.t_requeued = time.perf_counter()
        global_flight_recorder().record(
            event, request=req.req_id, slot=slot.idx, source="memory",
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
        global_metrics().inc("continuous.completed")
        self._park_slot_row(slot.idx)

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
            m = 0
            if self._paged:
                P = self._page
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
        t0 = time.perf_counter()
        if self._controller is not None:
            # Before admission: this tick's admits see the current rung.
            self._controller.step(self)
        eo = self._eobs
        # The gate is read once a tick: flipping it mid-tick must never
        # pair a 0.0 open with an enabled close.
        eo_on = eo.enabled
        t_ph = eo.now() if eo_on else 0.0
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
        (scale planes included) and ``memory.kv_bytes_per_device`` (equal
        on one card); pools: ``memory.pool_bytes`` (``_per_device``), the
        page partition ``memory.pages_used + pages_free + pages_cached ==
        memory.pool_pages`` (the allocatable pool, trash page excluded) and
        the pager's prefix and radix books; speculative mode:
        ``memory.draft_cache_bytes``; both layouts: ``memory.kv_bytes_ratio``
        (cache bytes over the model dtype's)."""
        cache_bytes = float(self._cache_bytes())
        out: dict[str, float] = {}
        if self._paged:
            ps = self._pager_books
            out["memory.pool_bytes"] = cache_bytes
            out["memory.pool_bytes_per_device"] = cache_bytes
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
        else:
            out["memory.kv_bytes"] = cache_bytes
            out["memory.kv_bytes_per_device"] = cache_bytes
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
            return out

    def _cache_bytes(self) -> int:
        return sum(m.numel() * m.element_size() for pair in self._caches
                   for c in pair for m in _members(c))

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
