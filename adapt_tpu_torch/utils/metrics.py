"""Counters, gauges, latency histograms (a copy of
``adapt_tpu/utils/metrics.py``, so both packages export one catalog of
metric names): cheap, lock-guarded, snapshot-able.

Percentiles come from a DETERMINISTIC DECIMATING reservoir: the sample
buffer is bounded, and when it fills, every other retained sample is
dropped and the sampling stride doubles — so the reservoir always spans
the histogram's whole history (early and late observations alike) in
bounded memory. A keep-the-first-N reservoir freezes p50/p99 at the
warm-up distribution forever; this one shifts as traffic shifts
(``tests/test_observability.py`` pins that).

``register_collector`` hooks pull-style sources (module counters like
``comm.codec.copy_stats``) into :meth:`snapshot`: collectors run at
scrape time, right before the snapshot is taken, so ``/metrics`` shows
their current values without a push on every hot-path mutation.

**Windowed snapshots** (``docs/OBSERVABILITY.md`` "Workload
telemetry"): cumulative-since-boot percentiles are useless for "what
was p99 TTFT during *this* load phase" — the warm-up phase's samples
never leave the reservoir. ``snapshot(window=True)`` opens a WINDOW: a
per-histogram decimating-reservoir FORK that receives every subsequent
observation in parallel with the cumulative reservoir.
``snapshot(since=prev)`` then closes ``prev``'s window and returns the
window's view — counter DELTAS against ``prev`` and histogram
summaries computed from the fork alone (percentile isolation: a
window's p99 contains only the window's samples). Phase-by-phase
chaining passes ``window=True`` with every read that has a next phase
(``s = reg.snapshot(window=True); ...;
s = reg.snapshot(since=s, window=True)``); the final read omits it,
so a finished sweep leaves NO open window behind. Hot-path cost:
zero when no window is open (one truthiness
check under the already-held lock); one extra reservoir append per
open window otherwise. Open windows are bounded (``_MAX_WINDOWS``,
oldest evicted) so an abandoned window can never leak observations
forever.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from collections.abc import Callable, Iterable


class _Histogram:
    #: Reservoir cap: when full, every other sample is discarded and the
    #: sampling stride doubles (memory stays O(cap), coverage stays the
    #: whole stream).
    _CAP = 4096

    __slots__ = ("count", "total", "min", "max", "_samples", "_stride",
                 "_skip")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._samples: list[float] = []  # decimating reservoir, capped
        self._stride = 1  # keep every _stride-th observation
        self._skip = 0  # observations left to skip before the next keep

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        # Deterministic decimation: unlike keep-first-N (which freezes
        # percentiles at the warm-up distribution), every epoch of the
        # stream stays represented at equal stride.
        if self._skip:
            self._skip -= 1
            return
        self._samples.append(v)
        if len(self._samples) >= self._CAP:
            del self._samples[::2]  # halve, oldest-first interleaved
            self._stride *= 2
        self._skip = self._stride - 1

    def percentile(self, p: float) -> float:
        if not self._samples:
            return 0.0
        s = sorted(self._samples)
        idx = min(len(s) - 1, int(p / 100.0 * len(s)))
        return s[idx]

    def summary(self, reservoir: bool = False) -> dict:
        if self.count == 0:
            return {"count": 0}
        # ONE sort for every percentile: summary() runs under the
        # registry lock (snapshot()), and a scrape must not stall
        # serving-path observe() calls on repeated reservoir sorts.
        s = sorted(self._samples)

        def pct(p):
            return s[min(len(s) - 1, int(p / 100.0 * len(s)))]

        out = {
            "count": self.count,
            "sum": self.total,
            "mean": self.total / self.count,
            "min": self.min,
            "max": self.max,
            "p50": pct(50),
            "p99": pct(99),
        }
        if reservoir:
            # The raw decimating reservoir (every sample stands for
            # ``stride`` observations) — what lets ANOTHER process
            # merge this histogram's percentiles with its own honestly
            # (utils.telemetry federation) instead of averaging
            # pre-computed p99s, which has no meaning.
            out["reservoir"] = {
                "samples": list(self._samples),
                "stride": self._stride,
            }
        return out


class MetricsRegistry:
    #: Max concurrently open snapshot windows; opening past it evicts
    #: the OLDEST window (its ``snapshot(since=...)`` read then falls
    #: back to cumulative summaries, flagged ``window_evicted``) so an
    #: abandoned window cannot make every observe() pay forever.
    _MAX_WINDOWS = 8

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = defaultdict(float)
        self._gauges: dict[str, float] = {}
        self._histograms: dict[str, _Histogram] = defaultdict(_Histogram)
        self._collectors: list[Callable[["MetricsRegistry"], None]] = []
        #: Open snapshot windows: id -> {histogram name -> fork}.
        #: Forks are ordinary decimating reservoirs created lazily at
        #: the first in-window observation of each histogram.
        self._windows: dict[int, dict[str, _Histogram]] = {}
        self._next_window = 0

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def remove_gauge(self, name: str) -> None:
        """Drop one gauge so snapshots stop serving its last value —
        for sources that disappear (e.g. a retired program's
        ``engine.compiles.*`` entry). No-op when absent."""
        with self._lock:
            self._gauges.pop(name, None)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            self._histograms[name].observe(value)
            if self._windows:
                for forks in self._windows.values():
                    f = forks.get(name)
                    if f is None:
                        f = forks[name] = _Histogram()
                    f.observe(value)

    def observe_many(self, name: str, values: Iterable[float]) -> None:
        """Batch observe under ONE lock acquisition — the serving paths
        (per-token inter-token latencies) flush a tick's samples in one
        call instead of contending per token."""
        values = list(values)
        if not values:
            return
        with self._lock:
            h = self._histograms[name]
            for v in values:
                h.observe(v)
            if self._windows:
                for forks in self._windows.values():
                    f = forks.get(name)
                    if f is None:
                        f = forks[name] = _Histogram()
                    for v in values:
                        f.observe(v)

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def register_collector(
        self, fn: Callable[["MetricsRegistry"], None]
    ) -> None:
        """Register a pull hook run at the top of every :meth:`snapshot`
        (outside the lock — collectors call ``set_gauge``/``inc``
        themselves). Idempotent per function object."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def snapshot(
        self,
        *,
        window: bool = False,
        since: dict | None = None,
        reservoirs: bool = False,
    ) -> dict:
        """Point-in-time view of every metric.

        Plain ``snapshot()`` (the exporter's scrape) is unchanged:
        cumulative counters, current gauges, whole-history histogram
        summaries — and costs nothing on the observe() hot path.

        ``window=True`` additionally OPENS a window: the returned dict
        carries a ``"window"`` id and every later observation also
        lands in that window's per-histogram reservoir forks.

        ``since=prev`` (``prev`` a ``window=True`` snapshot) returns
        the WINDOW view instead: ``counters`` are deltas vs ``prev``,
        ``histograms`` summarize only the samples observed since
        ``prev`` (fork reservoirs — percentile isolation between
        phases), ``gauges`` stay current values (a gauge has no
        meaningful delta), and ``window_s`` is the wall-clock span.
        The read CLOSES ``prev``'s window; pass ``window=True``
        alongside ``since=`` to open the next phase's window in the
        same call (phase chaining) — a plain ``since=`` read opens
        nothing, so one-shot callers cannot leak open windows that
        every later observe() would pay for. Reading a window that was
        evicted (``_MAX_WINDOWS`` exceeded) or never opened raises
        ``ValueError`` for the latter and degrades to cumulative
        summaries flagged ``"window_evicted": True`` for the former —
        a load sweep must notice, not silently report boot-cumulative
        percentiles as a phase's.

        ``reservoirs=True`` adds each histogram summary's raw
        decimating reservoir (``{"samples", "stride"}``) — the
        serialized form the telemetry federation layer ships so fleet
        percentiles merge from real samples, not from other
        processes' pre-computed percentiles."""
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn(self)
            except Exception:  # noqa: BLE001 — a scrape must not fail
                pass
        if since is not None and "window" not in since:
            raise ValueError(
                "snapshot(since=...) needs a snapshot taken with "
                "window=True (or a previous since= snapshot)"
            )
        with self._lock:
            out: dict = {"gauges": dict(self._gauges)}
            if since is None:
                out["counters"] = dict(self._counters)
                out["histograms"] = {
                    k: h.summary(reservoir=reservoirs)
                    for k, h in self._histograms.items()
                }
            else:
                prev_counters = since.get("counters", {})
                base = since.get("_abs_counters", prev_counters)
                out["counters"] = {
                    k: v - base.get(k, 0.0)
                    for k, v in self._counters.items()
                }
                forks = self._windows.pop(since["window"], None)
                if forks is None:
                    out["histograms"] = {
                        k: h.summary(reservoir=reservoirs)
                        for k, h in self._histograms.items()
                    }
                    out["window_evicted"] = True
                else:
                    out["histograms"] = {
                        k: f.summary(reservoir=reservoirs)
                        for k, f in forks.items()
                    }
                out["window_s"] = time.monotonic() - since["_t"]
            if window:
                wid = self._next_window
                self._next_window += 1
                self._windows[wid] = {}
                while len(self._windows) > self._MAX_WINDOWS:
                    self._windows.pop(next(iter(self._windows)))
                out["window"] = wid
                out["_t"] = time.monotonic()
                #: Absolute counter values at window open — the delta
                #: base for the NEXT since= read (out["counters"] may
                #: itself already be a delta).
                out["_abs_counters"] = dict(self._counters)
            return out

    def reset(self) -> None:
        """Clear all recorded values (collectors stay registered; open
        windows are discarded)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._windows.clear()


_GLOBAL = MetricsRegistry()


def global_metrics() -> MetricsRegistry:
    return _GLOBAL
