"""Engine-tier observability: the compile sentinel, memory accounting,
roofline (MBU / MFU) accounting and tick-phase timing — the port of
``adapt_tpu/utils/profiling.py``, with its metric names, so one catalog
(``docs/OBSERVABILITY.md`` "Engine telemetry") covers both packages.

- :class:`CompileSentinel` — a registry of watches, each a size function
  (a 0-arg callable returning a count, or None when its owner is gone).
  Each :meth:`~CompileSentinel.sample` exports every watch as an
  ``engine.compiles.<program>`` gauge and, after a warmup of active
  samples, treats growth as an unexpected compile: the
  ``engine.compile_events`` counter, a ``recompile`` flight event, a
  WARNING and a tracer instant event. The eager port has no jit caches.
  Its one compile-time stall is a kernel library that ``ops/_build.py``
  builds or loads mid-serving (``ops.kernel_libs``, registered by
  :func:`watch_kernel_libraries`); :meth:`~CompileSentinel.rearm` grants
  planned growth to any watch registered later.
- **Memory accounting** — components register as weakly held sources
  (:func:`register_memory_source`) exposing ``_memory_stats()``;
  :func:`engine_collector` sums them into ``memory.*`` gauges at every
  snapshot / scrape and removes the gauges of retired sources. On a CUDA
  card ``memory.hbm_bytes_in_use`` (the caching allocator's allocated
  bytes, ``torch.cuda.memory_allocated``) and ``memory.hbm_bytes_limit``
  (the card's memory, ``torch.cuda.mem_get_info``) ride along; on the CPU
  both are absent, as in the JAX package.
- **Kernel dispatch** — ``engine.kernel_dispatch.<op>`` (1.0 when the
  op's latest call launched the hand-written kernel, 0.0 when it ran the
  plain version) with lifetime ``.pallas_total`` (kernel) and
  ``.xla_total`` (plain) counts, from ``ops/_build``'s books.
- **Roofline accounting** — sources (:func:`register_roofline_source`)
  expose ``_roofline_stats() -> {program: {flops, bytes, wall_s}}``. The
  JAX package reads flops / bytes from XLA's cost analysis; the port has
  no compiler to ask and counts each program's work from the model's
  shapes (:func:`program_work`), the same whichever route an op takes.
  ``engine.flops.<program>`` / ``engine.bytes_accessed.<program>`` are
  exported always; ``engine.mfu.<program>`` / ``engine.mbu.<program>``
  and the headline ``engine.mfu`` / ``engine.mbu`` (the byte-heaviest
  program's) only when the device's peaks are known
  (:func:`roofline_peaks`) and the program has a measured wall.
- :class:`EngineObs` — the one-branch gate for per-phase timing
  (``config.ObservabilityConfig.obs_engine``): ``engine.phase.<name>_s``
  histograms and ``engine.<name>`` spans. Off, a phase site costs one
  attribute check.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from collections.abc import Callable

from adapt_tpu_torch.utils.logging import get_logger, kv
from adapt_tpu_torch.utils.metrics import MetricsRegistry, global_metrics
from adapt_tpu_torch.utils.tracing import global_flight_recorder, global_tracer

log = get_logger("profiling")


# -- compile sentinel -------------------------------------------------------


class _Watch:
    __slots__ = ("size_fn", "last", "samples", "expected")

    def __init__(self, size_fn: Callable[[], int]):
        self.size_fn = size_fn
        self.last: int | None = None
        self.samples = 0
        #: Outstanding expected-growth allowance (:meth:`rearm`).
        self.expected = 0


class CompileSentinel:
    """Watches registered size functions for unexpected growth.

    ``register(name, size_fn=...)`` takes a 0-arg callable (it may return
    None to say "my owner is gone": the watch is then pruned), or an
    object with a ``_cache_size()`` method. :meth:`sample` runs once per
    serving tick and at every scrape (:func:`engine_collector`).

    Warmup counts ACTIVE samples only (size > 0): a watch registered at
    startup and scraped while the serve loop idles keeps its grace window.
    After ``warmup_samples`` active samples any growth is an event,
    except what :meth:`rearm` granted. One watch per name; re-registering
    re-arms the warmup (a fresh batcher may legitimately load its own
    first kernel libraries) and keeps an outstanding allowance. Detection is
    sentinel-global; every sampled registry's ``engine.compile_events``
    counter is synced to the cumulative event count."""

    def __init__(self, warmup_samples: int = 8):
        if warmup_samples < 0:
            raise ValueError(
                f"warmup_samples must be >= 0, got {warmup_samples}"
            )
        self._lock = threading.Lock()
        self._watches: dict[str, _Watch] = {}
        self.warmup_samples = warmup_samples
        self._events = 0
        self._synced: "weakref.WeakKeyDictionary[MetricsRegistry, int]" = (
            weakref.WeakKeyDictionary()
        )
        #: Names of pruned watches: each sample removes their stale
        #: ``engine.compiles.*`` gauges.
        self._pruned: set[str] = set()

    def register(self, name: str, fn=None, *,
                 size_fn: Callable[[], int] | None = None) -> None:
        """Watch ``name``; re-registering re-arms the warmup window."""
        if size_fn is None:
            if fn is None or not hasattr(fn, "_cache_size"):
                raise TypeError(
                    f"{name}: need an object with _cache_size() or an "
                    "explicit size_fn"
                )
            size_fn = fn._cache_size
        with self._lock:
            w = _Watch(size_fn)
            prev = self._watches.get(name)
            if prev is not None:
                w.expected = prev.expected
            self._watches[name] = w
            self._pruned.discard(name)

    def unregister(self, name: str) -> None:
        with self._lock:
            if self._watches.pop(name, None) is not None:
                self._pruned.add(name)

    def rearm(self, name: str, expect: int = 1) -> None:
        """Grant ``name`` an allowance of ``expect`` planned growth units,
        consumed whenever the growth lands (unknown names: no-op)."""
        with self._lock:
            w = self._watches.get(name)
            if w is not None:
                w.expected += expect

    def disarm(self, name: str, expect: int = 1) -> None:
        """Revoke up to ``expect`` units of ``name``'s allowance (clamped
        at zero; unknown names: no-op). A granter that retires calls this
        with its full grant."""
        with self._lock:
            w = self._watches.get(name)
            if w is not None:
                w.expected = max(0, w.expected - expect)

    def watched(self) -> list[str]:
        with self._lock:
            return list(self._watches)

    def compiles(self, name: str) -> int:
        """Current size of one watch."""
        with self._lock:
            size = self._watches[name].size_fn()
        if size is None:
            raise KeyError(f"{name}: watched program's owner is gone")
        return int(size)

    def counts(self) -> dict[str, int]:
        """Current size of every watch (sick or ownerless ones skipped)."""
        out = {}
        with self._lock:
            for name, w in self._watches.items():
                try:
                    size = w.size_fn()
                except Exception:  # noqa: BLE001 — a probe must not raise
                    continue
                if size is not None:
                    out[name] = int(size)
        return out

    @property
    def events(self) -> int:
        """Lifetime count of unexpected post-warmup growth units."""
        with self._lock:
            return self._events

    def sample(self, registry: MetricsRegistry | None = None, *,
               write_gauges: bool = True) -> int:
        """One pass over every watch; returns the number of watches that
        fired. ``write_gauges=False`` is the tick path's detection-only
        mode (every scrape refreshes the gauges anyway)."""
        reg = registry if registry is not None else global_metrics()
        fired: list[tuple[str, int, int]] = []
        sizes: list[tuple[str, int]] = []
        dead: list[str] = []
        with self._lock:
            for name, w in self._watches.items():
                try:
                    raw = w.size_fn()
                except Exception:  # noqa: BLE001 — a sick probe is skipped
                    continue
                if raw is None:
                    dead.append(name)
                    continue
                size = int(raw)
                sizes.append((name, size))
                warmed = w.samples >= self.warmup_samples
                if size > 0:
                    w.samples += 1
                if w.last is None or size == w.last:
                    w.last = size
                    continue
                delta = size - w.last
                w.last = size
                if delta > 0 and warmed and w.expected > 0:
                    absorbed = min(delta, w.expected)
                    w.expected -= absorbed
                    delta -= absorbed
                if delta > 0 and warmed:
                    fired.append((name, size, delta))
                    self._events += delta
            for name in dead:
                del self._watches[name]
            self._pruned.update(dead)
            tombstones = list(self._pruned)
            behind = self._events - self._synced.get(reg, 0)
            if behind > 0:
                self._synced[reg] = self._events
        if behind > 0:
            reg.inc("engine.compile_events", float(behind))
        if write_gauges:
            for name, size in sizes:
                reg.set_gauge(f"engine.compiles.{name}", float(size))
            for name in tombstones:
                reg.remove_gauge(f"engine.compiles.{name}")
        tracer = global_tracer()
        for name, size, delta in fired:
            global_flight_recorder().record(
                "recompile", program=name, compiles=size, new=delta
            )
            log.warning("unexpected recompile %s",
                        kv(program=name, compiles=size, new=delta))
            if tracer.enabled:
                tracer.instant("engine.recompile", program=name, new=delta)
        return len(fired)


_SENTINEL = CompileSentinel()


def global_compile_sentinel() -> CompileSentinel:
    return _SENTINEL


def watch_kernel_libraries(sentinel: CompileSentinel | None = None) -> None:
    """(Re-)register the ``ops.kernel_libs`` watch: the number of kernel
    libraries built or loaded in this process. A library that first loads
    after warmup (an nvcc build or a dlopen on the serving path) is the
    port's counterpart of a tick that stalled on the compiler."""
    from adapt_tpu_torch.ops._build import libraries_loaded

    (sentinel or _SENTINEL).register("ops.kernel_libs",
                                     size_fn=libraries_loaded)


# -- memory accounting ------------------------------------------------------


_MEMORY_SOURCES: "weakref.WeakValueDictionary[tuple[str, int], object]" = (
    weakref.WeakValueDictionary()
)
_MEMORY_LOCK = threading.Lock()
#: Per-registry names the collector wrote on its previous pass: names no
#: longer produced are removed, not served stale.
_MEMORY_WRITTEN: "weakref.WeakKeyDictionary[MetricsRegistry, set]" = (
    weakref.WeakKeyDictionary()
)


def register_memory_source(label: str, obj) -> None:
    """Register ``obj`` (anything with ``_memory_stats() -> dict``) as a
    pull-style memory source, weakly held and keyed by ``(label,
    id(obj))``; gauges SUM across live sources. A retiring component
    calls :func:`unregister_memory_source` (``ContinuousBatcher.close``
    does)."""
    if not hasattr(obj, "_memory_stats"):
        raise TypeError(f"{label}: source must expose _memory_stats()")
    with _MEMORY_LOCK:
        _MEMORY_SOURCES[(label, id(obj))] = obj


def unregister_memory_source(label: str, obj) -> None:
    with _MEMORY_LOCK:
        _MEMORY_SOURCES.pop((label, id(obj)), None)


def _device_memory_stats() -> dict[str, float]:
    """``memory.hbm_*`` from the CUDA caching allocator of the current
    card; nothing without a card (no lying zero)."""
    try:
        import torch

        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return {}
        dev = torch.cuda.current_device()
        in_use = torch.cuda.memory_allocated(dev)
        limit = torch.cuda.mem_get_info(dev)[1]
    except Exception:  # noqa: BLE001 — no stats: no gauges
        return {}
    return {"memory.hbm_bytes_in_use": float(in_use),
            "memory.hbm_bytes_limit": float(limit)}


def engine_collector(reg: MetricsRegistry) -> None:
    """The engine-tier pull hook, run at every snapshot / scrape: memory
    sources summed, the card's allocator bytes, the roofline family, the
    kernel-dispatch books, stale-gauge removal and one sentinel sample."""
    totals: dict[str, float] = {}
    with _MEMORY_LOCK:
        sources = list(_MEMORY_SOURCES.values())
    for obj in sources:
        try:
            stats = obj._memory_stats()
        except Exception:  # noqa: BLE001 — one sick source must not kill scrape
            continue
        for k, v in stats.items():
            totals[k] = totals.get(k, 0.0) + float(v)
    totals.update(_device_memory_stats())
    totals.update(_roofline_gauges())
    try:
        from adapt_tpu_torch.ops._build import kernel_dispatch_stats

        for op, d in kernel_dispatch_stats().items():
            totals[f"engine.kernel_dispatch.{op}"] = d["last"]
            totals[f"engine.kernel_dispatch.{op}.pallas_total"] = d["pallas"]
            totals[f"engine.kernel_dispatch.{op}.xla_total"] = d["xla"]
    except Exception:  # noqa: BLE001 — never break a scrape
        pass
    for k, v in totals.items():
        reg.set_gauge(k, v)
    with _MEMORY_LOCK:
        stale = _MEMORY_WRITTEN.get(reg, set()) - set(totals)
        _MEMORY_WRITTEN[reg] = set(totals)
    for k in stale:
        reg.remove_gauge(k)
    _SENTINEL.sample(reg)


global_metrics().register_collector(engine_collector)


# -- roofline accounting ----------------------------------------------------

#: Peak (dense bf16 FLOP/s, HBM bytes/s) per CUDA device name
#: (``torch.cuda.get_device_name()``, lowercased): the figures
#: ``chip_smoke.py``'s bounds use. Devices absent here (and the CPU) get
#: flops and bytes gauges but no utilization.
ROOFLINE_PEAKS: dict[str, tuple[float, float]] = {
    "nvidia h100 80gb hbm3": (989e12, 3.35e12),
}


def roofline_peaks() -> tuple[float, float] | None:
    """(peak FLOP/s, peak bytes/s) of the current card, or None. The
    ``ADAPT_TPU_PEAK_FLOPS`` / ``ADAPT_TPU_PEAK_BYTES_S`` env vars (set
    both) override the table."""
    env_f = os.environ.get("ADAPT_TPU_PEAK_FLOPS")
    env_b = os.environ.get("ADAPT_TPU_PEAK_BYTES_S")
    if env_f and env_b:
        try:
            return (float(env_f), float(env_b))
        except ValueError:
            return None
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        name = torch.cuda.get_device_name().lower()
    except Exception:  # noqa: BLE001 — no card: no claims
        return None
    return ROOFLINE_PEAKS.get(name)


_ROOFLINE_SOURCES: "weakref.WeakValueDictionary[tuple[str, int], object]" = (
    weakref.WeakValueDictionary()
)


def register_roofline_source(label: str, obj) -> None:
    """Register ``obj`` (anything with ``_roofline_stats() -> dict``) as a
    pull-style roofline source (weakly held)."""
    if not hasattr(obj, "_roofline_stats"):
        raise TypeError(f"{label}: source must expose _roofline_stats()")
    with _MEMORY_LOCK:
        _ROOFLINE_SOURCES[(label, id(obj))] = obj


def unregister_roofline_source(label: str, obj) -> None:
    with _MEMORY_LOCK:
        _ROOFLINE_SOURCES.pop((label, id(obj)), None)


def program_work(lm, passes, kv_cache_dtype: str = "native") -> dict:
    """``{"flops", "bytes"}`` of one execution of a decoder-LM program
    made of ``passes``, counted from the model's shapes. Each pass is
    ``(tokens, attended, kv_read, kv_written, logit_rows)``:

    - ``tokens`` rows multiplied through every block's weights (the
      program's rows, padding and idle slots included: the card runs
      them);
    - ``attended`` (query row, live key) pairs summed over the pass's
      rows, per layer and query head;
    - ``kv_read`` / ``kv_written`` cached key positions read / written per
      layer (K and V each);
    - ``logit_rows`` rows projected to the vocabulary.

    FLOPs = 2 x (block matrices' parameters x tokens + the head's x
    logit_rows) + 4 x head_dim x heads x attended per layer — every expert
    of a mixture-of-experts block counts (masked-dense form). Bytes = each
    pass reads every block parameter and the head once, the tokens'
    embedding rows, and K/V at their stored width (a quantized vector's
    int8 / packed int4 values plus its f32 scale), writes K/V and f32
    logits. The count is the same whichever route each op takes."""
    blocks = lm.blocks
    b0 = blocks[0]
    heads, kvh, hd = b0.heads, b0.cache_heads, b0.head_dim
    layers = len(blocks)
    # Weight matrices only: an MoE block's stacked biases (b1, b2) are 2-D
    # but add, not multiply.
    mat = sum(p.numel() for b in blocks for n, p in b.named_parameters()
              if p.dim() >= 2 and n.rsplit(".", 1)[-1] not in ("b1", "b2"))
    block_bytes = sum(p.numel() * p.element_size() for b in blocks
                      for p in b.parameters())
    head_w = lm.head.logits.weight
    head_mat = head_w.numel()
    head_bytes = sum(p.numel() * p.element_size()
                     for p in lm.head.parameters())
    tok = lm.embed.tok.weight
    emb_row = tok.shape[1] * tok.element_size()
    if getattr(lm.embed, "use_pos", False):
        emb_row += lm.embed.pos_embed.shape[1] * 4
    if kv_cache_dtype == "int8":
        vec = hd + 4
    elif kv_cache_dtype == "int4":
        vec = hd // 2 + 4
    else:
        vec = hd * tok.element_size()
    vocab = head_w.shape[0]
    flops = 0.0
    nbytes = 0.0
    for tokens, attended, kv_read, kv_written, logit_rows in passes:
        flops += 2.0 * (mat * tokens + head_mat * logit_rows)
        flops += 4.0 * hd * heads * attended * layers
        nbytes += block_bytes + head_bytes + emb_row * tokens
        nbytes += 2.0 * kvh * vec * (kv_read + kv_written) * layers
        nbytes += 4.0 * vocab * logit_rows
    return {"flops": flops, "bytes": nbytes}


def _roofline_gauges() -> dict[str, float]:
    """The roofline gauge family from the registered sources: per-program
    flops / bytes always; utilization only with known peaks and a
    measured wall (``obs_engine`` on)."""
    with _MEMORY_LOCK:
        sources = list(_ROOFLINE_SOURCES.values())
    out: dict[str, float] = {}
    peaks = roofline_peaks()
    best_bytes = -1.0
    for obj in sources:
        try:
            stats = obj._roofline_stats()
        except Exception:  # noqa: BLE001 — a sick source must not kill scrape
            continue
        for prog, st in stats.items():
            flops = float(st.get("flops", 0.0))
            nbytes = float(st.get("bytes", 0.0))
            out[f"engine.flops.{prog}"] = flops
            out[f"engine.bytes_accessed.{prog}"] = nbytes
            wall = st.get("wall_s")
            if peaks is None or not wall:
                continue
            peak_f, peak_b = peaks
            mfu = flops / wall / peak_f
            mbu = nbytes / wall / peak_b
            out[f"engine.mfu.{prog}"] = mfu
            out[f"engine.mbu.{prog}"] = mbu
            if nbytes > best_bytes:
                best_bytes = nbytes
                out["engine.mfu"] = mfu
                out["engine.mbu"] = mbu
    return out


# -- tick-phase timing ------------------------------------------------------


class EngineObs:
    """Process-global gate for per-phase engine timing. ``enabled`` is the
    one branch every phase site pays when off. On, :meth:`phase` records
    one ``engine.phase.<name>_s`` sample and, with the tracer on, an
    ``engine.<name>`` span. Enabled by ``ObservabilityConfig(
    obs_engine=True)`` when a ``Dispatcher`` is built, or directly:
    ``global_engine_obs().enabled = True``."""

    __slots__ = ("enabled", "last_s")

    def __init__(self):
        self.enabled = False
        #: Latest wall seconds per phase: the roofline's denominators.
        self.last_s: dict[str, float] = {}

    @staticmethod
    def now() -> float:
        return time.perf_counter()

    def phase(self, name: str, t0: float, *, span: bool = True,
              **attrs) -> float:
        """Close phase ``name`` opened at ``t0``; returns the close time.
        ``span=False`` where the site records its own tracer span."""
        t1 = time.perf_counter()
        self.last_s[name] = t1 - t0
        global_metrics().observe(f"engine.phase.{name}_s", t1 - t0)
        if span:
            tracer = global_tracer()
            if tracer.enabled:
                tracer.add_span(f"engine.{name}", start=t0, end=t1, **attrs)
        return t1


_ENGINE_OBS = EngineObs()


def global_engine_obs() -> EngineObs:
    return _ENGINE_OBS


def apply_engine_config(obs) -> None:
    """Apply an ``ObservabilityConfig``'s engine knobs to the process:
    ``obs_engine`` is enable-only, ``compile_warmup`` applies only when it
    differs from the default (a default config never undoes what another
    component set)."""
    if obs.obs_engine:
        _ENGINE_OBS.enabled = True
    if obs.compile_warmup != type(obs)().compile_warmup:
        _SENTINEL.warmup_samples = obs.compile_warmup
