"""Typed configuration the ported serving core reads — copies of
``adapt_tpu/config.py``'s ``FaultConfig``, ``CodecConfig``,
``KernelConfig``, ``SpeculativeConfig``, ``SchedulerConfig`` (with
``TenantQuota``, which the latter names), ``SLOSpec``, ``RuntimeConfig``,
``PipelineConfig``, the ``ObservabilityConfig`` fields the dispatcher and
the batcher read, and ``ServeConfig`` over those, same field names and
defaults, so one config means the same thing in both packages.

``ServeConfig`` holds the subsystem configs the port has. The others
(``ParallelConfig``, ``RecoveryConfig``, ``DisaggConfig``,
``PrefillConfig``, ``CapacityConfig``, ``RouterConfig``,
``CacheTierConfig``) come with the slices that port those subsystems.

What differs is what ``KernelConfig`` selects on this card:

- ``attn_impl`` ``None`` or ``"pallas"``: the hand-written kernel on CUDA
  tensors, its plain PyTorch version on CPU tensors. ``"xla"``: the plain
  version, which a CUDA tensor refuses (``ValueError``) — no config can
  route the card's main path off the kernel.
- ``decode_split`` ``None`` means 1 until the card has measured
  otherwise; the TPU's auto rule is not carried over.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Decode-kernel knobs of the serving tier: ``attn_impl`` (see the
    module docstring) and ``decode_split``, the flash-decoding split of the
    KV length (1 = one stream per kv head; > 1 = per-split partials plus a
    rescale combine)."""

    attn_impl: str | None = None
    decode_split: int | None = None

    def __post_init__(self):
        if self.attn_impl not in (None, "xla", "pallas"):
            raise ValueError(
                f"attn_impl={self.attn_impl!r}: expected None, 'xla' "
                "or 'pallas'"
            )
        if self.decode_split is not None and self.decode_split < 1:
            raise ValueError(
                f"decode_split must be >= 1, got {self.decode_split}"
            )


@dataclasses.dataclass(frozen=True)
class SpeculativeConfig:
    """Batched speculative decoding knobs (the continuous batcher's
    speculative mode, ``ContinuousBatcher(draft_lm=...,
    speculative=SpeculativeConfig(...))``). Every tick runs a ``draft_k +
    1``-step draft scan over all slots plus ONE fused verify pass; each slot
    commits its longest agreeing prefix plus the target's correction token.
    Greedy requests get exactly the target's argmax stream; sampled requests
    go through speculative sampling (lossless in distribution)."""

    #: Proposals per round; a slot commits 1 .. ``draft_k + 1`` tokens.
    draft_k: int = 4
    #: Resident dtype of the draft's weights: ``"native"``, or ``"int8"`` —
    #: every matrix leaf blockwise int8 (``ops.quantize.quantize_params``),
    #: dequantized inside each draft scan and draft prefill. The draft's
    #: quality moves acceptance only, never the emitted stream.
    draft_weight_dtype: str = "native"
    #: Tree-draft width: 0 = chain speculation. w >= 1 appends the draft's
    #: top-w candidates for the position after the chain as leaf rows of
    #: the verify chunk; a leaf hit commits one bonus token (up to
    #: ``draft_k + 2`` per pass).
    tree_width: int = 0

    def __post_init__(self):
        if self.draft_k < 1:
            raise ValueError(f"draft_k must be >= 1, got {self.draft_k}")
        if self.draft_weight_dtype not in ("native", "int8"):
            raise ValueError(
                f"draft_weight_dtype={self.draft_weight_dtype!r}: "
                "expected 'native' or 'int8'"
            )
        if self.tree_width < 0:
            raise ValueError(
                f"tree_width must be >= 0, got {self.tree_width}"
            )


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Per-tenant traffic-control knobs: deficit-round-robin ``weight``
    and the queued ``burst`` cap."""

    weight: float = 1.0
    burst: int | None = None

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"weight must be > 0, got {self.weight}")
        if self.burst is not None and self.burst < 1:
            raise ValueError(f"burst must be >= 1, got {self.burst}")


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Multi-tenant overload control in front of the continuous batcher
    (``runtime/scheduler``): ``ContinuousBatcher(scheduler=...)`` queues
    requests by priority class (``SLOSpec.priority``) and drains each
    class's tenants by deficit round-robin, rejects synchronously at the
    global depth bound and each tenant's ``burst`` cap, preempts a
    lower-priority decode slot when a waiting request has burned
    ``preempt_ttft_fraction`` of its TTFT budget, and walks the
    degradation ladder under sustained pressure. Without a config the
    batcher's queue is a bounded strict FIFO."""

    #: Global bound on queued (not yet admitted) requests.
    max_queue_depth: int = 4096
    #: DRR credit a tenant's turn adds, times its weight; a request costs 1.
    quantum: float = 1.0
    #: Weight of a tenant without a ``quotas`` entry.
    default_weight: float = 1.0
    quotas: dict[str, TenantQuota] = dataclasses.field(default_factory=dict)
    #: Preempt the lowest-priority decode slot through the replay path.
    preempt: bool = True
    #: Share of a waiting request's TTFT budget that triggers preemption.
    preempt_ttft_fraction: float = 0.5
    #: Run the degradation ladder (``DegradationController``).
    degrade: bool = True
    #: Queue depth / ``max_queue_depth`` at or above which the ladder
    #: climbs (with slot occupancy at or above ``degrade_occupancy``) ...
    degrade_queue_high: float = 0.5
    #: ... and at or below which it steps back down.
    degrade_queue_low: float = 0.05
    degrade_occupancy: float = 1.0
    #: Windowed TTFT attainment below which a backlog counts as overload.
    degrade_attainment: float = 0.9
    #: Least time between two ladder steps (and the attainment window).
    degrade_dwell_s: float = 0.25
    #: Prefer, within one tenant's queue, the request whose prompt prefix
    #: is most resident in the paged prefix cache.
    cache_aware: bool = False
    #: How many queued requests of the tenant that scan looks at.
    cache_aware_window: int = 16

    def __post_init__(self):
        if self.max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got {self.max_queue_depth}"
            )
        if self.quantum <= 0:
            raise ValueError(f"quantum must be > 0, got {self.quantum}")
        if self.default_weight <= 0:
            raise ValueError(
                f"default_weight must be > 0, got {self.default_weight}"
            )
        if not 0.0 < self.preempt_ttft_fraction <= 1.0:
            raise ValueError(
                "preempt_ttft_fraction must be in (0, 1], got "
                f"{self.preempt_ttft_fraction}"
            )
        if not 0.0 <= self.degrade_queue_low <= self.degrade_queue_high:
            raise ValueError(
                "degrade_queue_low must be in [0, degrade_queue_high] "
                f"({self.degrade_queue_low} vs {self.degrade_queue_high})"
            )
        if not 0.0 <= self.degrade_occupancy <= 1.0:
            raise ValueError(
                "degrade_occupancy must be in [0, 1], got "
                f"{self.degrade_occupancy}"
            )
        if self.degrade_dwell_s < 0:
            raise ValueError(
                f"degrade_dwell_s must be >= 0, got {self.degrade_dwell_s}"
            )
        if self.cache_aware_window < 1:
            raise ValueError(
                "cache_aware_window must be >= 1, got "
                f"{self.cache_aware_window}"
            )


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Per-request latency budget and scheduling class:
    ``ContinuousBatcher.submit(..., slo=SLOSpec(...))``. TTFT (submit to
    first emitted token, queue wait included) is judged once at the first
    token, ITL at every later commit. A request stays inside budget until
    its first violation; tokens committed while inside count toward
    ``continuous.goodput_tokens_s``, and at finish the request lands in
    its tenant's ``slo.met_total.<tenant>`` / ``slo.missed_total.<tenant>``
    counter. Evaluation is host arithmetic on the batcher's timeline
    stamps (the ``obs_timeline`` gate)."""

    #: Submit -> first emitted token budget (None = no TTFT budget).
    ttft_budget_s: float | None = None
    #: Inter-token budget between consecutive commits (None = none).
    itl_budget_s: float | None = None
    #: Accounting label for the per-tenant counters and DRR queues.
    tenant: str = "default"
    #: Scheduling class: higher admits strictly first under backlog and
    #: may preempt a lower class's decode slot when its TTFT budget is at
    #: risk; ``< 0`` is best-effort, which the ladder's last rung rejects.
    #: Inert without a ``SchedulerConfig`` on the batcher.
    priority: int = 0

    def __post_init__(self):
        for name in ("ttft_budget_s", "itl_budget_s"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be > 0, got {v}")
        if not self.tenant:
            raise ValueError("tenant must be a non-empty label")


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Tick pipelining of the continuous batcher. ``pipeline_depth=1`` is
    the synchronous loop: each ``tick()`` dispatches the decode (or
    speculative) pass, waits for its one fetch and commits. ``2`` keeps one
    tick in flight: ``tick()`` dispatches tick t, then commits tick t-1
    while t runs on the card, so the host's scheduler pass overlaps the
    device's work; results arrive one call later (``drain()``, ``run()``,
    ``stop()`` and ``close()`` are the boundaries). Greedy streams are the
    same at both depths. Deeper pipelines buy nothing with one program a
    tick and are refused."""

    #: 1 = synchronous tick loop; 2 = one tick in flight.
    pipeline_depth: int = 1

    def __post_init__(self):
        if self.pipeline_depth not in (1, 2):
            raise ValueError(
                "pipeline_depth must be 1 (synchronous) or 2 "
                f"(one tick in flight), got {self.pipeline_depth}"
            )


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """SPMD pipeline schedule knobs (``parallel.pipeline_spmd``).

    The serial (GPipe) schedule puts every activation hop on the critical
    path; the overlap schedule issues each hop alongside the next
    microbatch's compute so hop latency hides under it. On one rank there
    is no hop: both schedules run each microbatch through the whole block
    stack in order and give the same result. Consumed by
    ``spmd_pipeline_from_config``.
    """

    # "serial" (GPipe; hop on the critical path) or "overlap"
    # (double-buffered; hop issued concurrently with compute).
    schedule: str = "overlap"
    # Microbatches per global batch.
    microbatches: int = 8
    # Circular activation-buffer depth for the overlap schedule: a hop
    # gets hop_buffers - 1 ticks to land.
    hop_buffers: int = 2

    def __post_init__(self):
        if self.schedule not in ("serial", "overlap"):
            raise ValueError(
                f"schedule={self.schedule!r}: expected 'serial' or "
                f"'overlap'"
            )
        if self.microbatches < 1:
            raise ValueError("microbatches must be >= 1")
        if self.hop_buffers < 2:
            raise ValueError("hop_buffers must be >= 2")


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Timeouts and retry policy of the adaptive dispatcher."""

    #: Worker lease TTL (the reference's etcd lease on /workers/<ip>).
    lease_ttl_s: float = 2.0
    #: Heartbeat period (must be < lease_ttl_s).
    heartbeat_s: float = 0.5
    #: Per-task deadline before the watchdog re-dispatches (host time: a
    #: worker waits for its stage's device work before it answers).
    task_deadline_s: float = 60.0
    #: Watchdog scan period.
    watchdog_period_s: float = 0.25
    #: Startup wait for the first worker, then a clean shutdown.
    startup_wait_s: float = 5.0
    #: Max re-dispatch attempts per task before failing the request.
    max_retries: int = 3
    #: Deadline misses before a still-heartbeating worker (a hang) is
    #: quarantined: the scheduler acquires it only as a last resort.
    quarantine_strikes: int = 2
    #: A worker silent (no completed task or probe) longer than this gets a
    #: canary ping task; a ping that misses the task deadline is a strike.
    #: None -> task_deadline_s. Set very large to disable probing.
    probe_silence_s: float | None = None
    #: Worker-configuration handshake timeout.
    configure_timeout_s: float = 60.0
    #: Bound on a send to a remote worker (``comm.remote``): a peer that
    #: stops draining its socket drops the link after this long.
    send_timeout_s: float = 10.0


#: The codecs of ``comm.codec``.
CODEC_NAMES = ("none", "bf16", "int8", "int8dev", "zfp", "lz")


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Activation / weights codecs at process boundaries (``comm.codec``):
    the activation codec of every remote worker a dispatcher drives, and of
    ``LocalPipeline.from_config``'s hops (``runtime.pipeline.
    codec_hop_transform``; ``"none"``: no hop transform)."""

    name: str = "none"  # none | bf16 | int8 | int8dev | zfp | lz
    #: The ``zfp`` codec's error bound.
    tolerance: float = 1e-3
    #: The codec stage weights travel in to remote workers (lossless).
    weights: str = "lz"

    def __post_init__(self):
        for what, name in (("name", self.name), ("weights", self.weights)):
            if name not in CODEC_NAMES:
                raise ValueError(f"CodecConfig.{what}={name!r}: expected one "
                                 f"of {CODEC_NAMES}")


@dataclasses.dataclass(frozen=True)
class ObservabilityConfig:
    """The tracing / flight-recorder knobs the dispatcher applies to the
    process-global tracer and recorder (``utils.tracing``): tracing is
    enable-only, and a capacity applies only when it differs from these
    defaults (a default-config dispatcher never truncates a ring another
    component sized). ``snapshot_on_recovery``: ``Dispatcher.recover``
    writes the flight recorder beside the journal. ``goodput_window_s``
    is the span of the batcher's ``continuous.goodput_tokens_s`` gauge and
    of the capacity plane's windows. ``obs_engine`` turns on the per-phase
    engine timing (``utils.profiling.EngineObs``: ``engine.phase.<name>_s``
    histograms, spans when tracing is on, and the roofline gauges' walls),
    enable-only like ``trace_enabled``; ``compile_warmup`` is the compile
    sentinel's warmup in active samples, applied only when it differs
    from this default."""

    trace_enabled: bool = False
    trace_capacity: int = 65536
    flight_capacity: int = 2048
    snapshot_on_recovery: bool = True
    obs_engine: bool = False
    compile_warmup: int = 8
    goodput_window_s: float = 2.0

    def __post_init__(self):
        if self.trace_capacity < 1:
            raise ValueError("trace_capacity must be >= 1")
        if self.flight_capacity < 1:
            raise ValueError("flight_capacity must be >= 1")
        if self.compile_warmup < 0:
            raise ValueError("compile_warmup must be >= 0")
        if self.goodput_window_s <= 0:
            raise ValueError("goodput_window_s must be > 0")


@dataclasses.dataclass(frozen=True)
class CapacityConfig:
    """The replica capacity plane (``runtime/capacity.CapacityModel``):
    every batcher keeps a capacity book — headroom (slots, pages, queue),
    a self-calibrating TTFT forecaster, a bounded prefix-affinity sketch
    and a hysteresis health score — refreshed off the critical path
    through the batcher's ``_obs_flush`` seam. ``enabled=False`` attaches
    no model: no extra work at submit, admit, commit or flush."""

    enabled: bool = True
    #: Min seconds between book rebuilds (headroom + sketch + health).
    refresh_s: float = 0.25
    #: At most this many radix nodes (hashed content keys) in the sketch.
    sketch_k: int = 32
    #: EWMA rate of the forecaster's queue-wait, prefill-wall and bias.
    ewma_alpha: float = 0.2
    #: (forecast, realized) TTFT pairs the calibration fraction spans.
    calibration_window: int = 256
    #: A health improvement must hold this long (worsening is immediate).
    health_dwell_s: float = 1.0
    #: Min seconds between lease-meta book refreshes.
    lease_refresh_s: float = 1.0

    def __post_init__(self):
        if self.refresh_s < 0:
            raise ValueError("refresh_s must be >= 0")
        if self.sketch_k < 1:
            raise ValueError("sketch_k must be >= 1")
        if not 0 < self.ewma_alpha <= 1:
            raise ValueError("ewma_alpha must be in (0, 1]")
        if self.calibration_window < 1:
            raise ValueError("calibration_window must be >= 1")
        if self.health_dwell_s < 0:
            raise ValueError("health_dwell_s must be >= 0")
        if self.lease_refresh_s < 0:
            raise ValueError("lease_refresh_s must be >= 0")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Top-level serving configuration."""

    #: Bounded request concurrency (the reference's semaphore).
    max_inflight: int = 8
    fault: FaultConfig = dataclasses.field(default_factory=FaultConfig)
    codec: CodecConfig = dataclasses.field(default_factory=CodecConfig)
    #: ``pipeline``, ``spec``, ``kernel``, ``scheduler`` and ``runtime``
    #: carry the JAX package's field names: ``Dispatcher`` and the
    #: pipelines read none of them (the LM path takes those configs as
    #: arguments of its own).
    pipeline: PipelineConfig = dataclasses.field(
        default_factory=PipelineConfig)
    obs: ObservabilityConfig = dataclasses.field(
        default_factory=ObservabilityConfig)
    spec: SpeculativeConfig = dataclasses.field(
        default_factory=SpeculativeConfig)
    kernel: KernelConfig = dataclasses.field(default_factory=KernelConfig)
    scheduler: SchedulerConfig = dataclasses.field(
        default_factory=SchedulerConfig)
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)
