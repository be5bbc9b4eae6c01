"""Fleet telemetry federation and per-request forensics — the port of
``adapt_tpu/utils/telemetry.py``; its reports, frames and merged views are
the JAX package's, so either package's processes federate into the
other's store.

- :class:`TelemetryReporter` — one per process: each
  :meth:`~TelemetryReporter.collect` is a JSON report holding the
  registry's windowed snapshot delta since the previous report (counters
  as deltas, histograms as this window's decimating reservoir), the
  flight events since (each with the recorder's monotonic ``seq``, so
  loss is a visible gap), the tracer spans since, and optionally a
  ``capacity`` section (``capacity_provider``).
- **The wire** — a report rides one ``comm.framing`` frame
  (``MSG_TELEMETRY``, JSON payload): ``RemoteStageServer`` pushes one
  every ``telemetry_s`` on its dispatcher link's ping thread, and
  ``RemoteWorkerProxy`` ingests it into the process-global
  :class:`FederatedStore` under the lease's worker id. Processes with no
  comm link serve ``GET /telemetry.json`` and advertise it in their lease
  (``meta["telemetry"]``); :meth:`FederatedStore.poll_registry` pulls.
- :class:`FederatedStore` — sources keyed by ``(role, worker, pid)``:
  counters accumulate deltas, gauges keep the last value, histogram
  percentiles merge from the shipped reservoirs
  (:class:`WeightedReservoir`), flight events merge into one wall-clock
  stream; per-source staleness is the ``fleet.report_age_s.<source>``
  gauge.
- :func:`assemble_request` — the forensics bundle behind
  ``GET /debug/request/<id>``.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import urllib.request

from adapt_tpu_torch.utils.logging import get_logger
from adapt_tpu_torch.utils.metrics import MetricsRegistry, global_metrics
from adapt_tpu_torch.utils.tracing import (
    FlightRecorder,
    Tracer,
    export_spans,
    global_flight_recorder,
    global_tracer,
)

log = get_logger("telemetry")

#: Report schema version (reports from a newer peer with an unknown
#: version are rejected loudly, not half-parsed).
REPORT_V = 1


def source_key(role: str, worker: str, pid: int) -> str:
    """The store's source identity — also the ``<source>`` suffix of
    the ``fleet.report_age_s.<source>`` staleness gauge (rendered as a
    Prometheus ``source`` label)."""
    return f"{role}:{worker}:{int(pid)}"


class WeightedReservoir:
    """Deterministic weighted sample reservoir — the fleet-merge form
    of the registry's decimating reservoir.

    Each entry is ``(value, weight)`` where weight is the decimation
    stride the sample arrived with (one reservoir sample stands for
    ``stride`` real observations). When the buffer fills, every other
    entry is dropped and the survivors' weights double — the same
    deterministic decimation as ``metrics._Histogram``, so merging is
    order-deterministic and memory stays bounded however many reports
    a long-lived source ships."""

    _CAP = 4096

    __slots__ = ("samples",)

    def __init__(self):
        self.samples: list[tuple[float, float]] = []

    def add(self, values, weight: float) -> None:
        w = float(weight) if weight > 0 else 1.0
        self.samples.extend((float(v), w) for v in values)
        while len(self.samples) > self._CAP:
            self.samples = [(v, w * 2.0) for v, w in self.samples[::2]]

    @staticmethod
    def percentiles(
        reservoirs: "list[WeightedReservoir]", ps=(50, 99)
    ) -> dict[str, float]:
        """Weighted percentiles over the UNION of several sources'
        reservoirs — the honest fleet percentile (a mean of per-source
        p99s is not a p99 of anything)."""
        merged: list[tuple[float, float]] = []
        for r in reservoirs:
            merged.extend(r.samples)
        if not merged:
            return {}
        merged.sort(key=lambda vw: vw[0])
        total = sum(w for _, w in merged)
        out: dict[str, float] = {}
        for p in ps:
            target = p / 100.0 * total
            acc = 0.0
            val = merged[-1][0]
            for v, w in merged:
                acc += w
                if acc >= target:
                    val = v
                    break
            out[f"p{int(p)}"] = val
        return out


class TelemetryReporter:
    """One per process (or per registry): produces the incremental
    report dicts the federation layer ships.

    Every :meth:`collect` chains the registry's snapshot window
    (``snapshot(since=prev, window=True)``), so consecutive reports
    carry disjoint counter deltas and disjoint histogram samples — the
    store can simply accumulate. Exactly ONE consumer may drive a
    reporter (a second would split the deltas); a process that both
    pushes over the comm link and serves the HTTP pull endpoint uses
    two independent reporters, which is safe — the cursors and windows
    are per-reporter."""

    def __init__(
        self,
        role: str,
        worker: str,
        registry: MetricsRegistry | None = None,
        recorder: FlightRecorder | None = None,
        tracer: Tracer | None = None,
        max_hist_samples: int = 512,
        max_events: int = 2048,
        max_spans: int = 512,
    ):
        self.role = str(role)
        self.worker = str(worker)
        self.pid = os.getpid()
        self._reg = registry if registry is not None else global_metrics()
        self._rec = (
            recorder if recorder is not None else global_flight_recorder()
        )
        self._tracer = tracer if tracer is not None else global_tracer()
        self._max_hist = max(8, int(max_hist_samples))
        self._max_events = max(1, int(max_events))
        self._max_spans = max(1, int(max_spans))
        self._win: dict | None = None
        self._ev_seq = 0
        self._span_seq = 0
        self._seq = 0
        self._lock = threading.Lock()
        #: Optional zero-arg callable returning this process's capacity
        #: book (``runtime/capacity``): when set, every report carries
        #: a ``"capacity"`` section — an OPTIONAL key, so stores and
        #: wires that predate it ignore it instead of breaking (no
        #: REPORT_V bump needed).
        self.capacity_provider = None

    def collect(self) -> dict:
        """The next report. First call: cumulative-since-boot counters
        and reservoirs (so a parent that attaches late still sees the
        source's full totals); every later call: the delta since the
        previous collect."""
        with self._lock:
            # Reopen after close(): the previous window is gone, so a
            # plain snapshot would re-ship CUMULATIVE counters and
            # reservoirs that look like a delta — double-counting in
            # any store that accumulated the earlier reports. Ship one
            # empty, flagged round instead (the window just opened
            # makes the NEXT collect's deltas correct again).
            reopened = self._win is None and self._seq > 0
            if self._win is None:
                snap = self._reg.snapshot(window=True, reservoirs=True)
            else:
                snap = self._reg.snapshot(
                    since=self._win, window=True, reservoirs=True
                )
            self._win = snap
            first = self._seq == 0
            degraded = bool(snap.get("window_evicted")) or reopened
            hists: dict[str, dict] = {}
            if first or not degraded:
                # A window evicted under this reporter (registry reset,
                # or > _MAX_WINDOWS concurrent readers) degrades the
                # read to CUMULATIVE summaries — shipping those as a
                # delta would double-count every histogram into the
                # fleet view, so the degraded round ships none and
                # flags itself.
                for name, s in snap["histograms"].items():
                    if not s.get("count"):
                        continue
                    res = s.get("reservoir", {})
                    samples = list(res.get("samples", ()))
                    stride = max(1, int(res.get("stride", 1)))
                    while len(samples) > self._max_hist:
                        samples = samples[::2]
                        stride *= 2
                    hists[name] = {
                        "count": s["count"],
                        "sum": s["sum"],
                        "min": s["min"],
                        "max": s["max"],
                        "samples": samples,
                        "stride": stride,
                    }
            events, self._ev_seq = self._rec.events_since(self._ev_seq)
            if len(events) > self._max_events:
                events = events[-self._max_events:]
            spans, self._span_seq = self._tracer.spans_since(
                self._span_seq
            )
            self._seq += 1
            capacity = None
            if self.capacity_provider is not None:
                try:
                    capacity = self.capacity_provider()
                except Exception:  # noqa: BLE001 — a broken book must
                    # not take the whole report (counters, events) down.
                    log.exception("capacity provider failed")
            report = {
                "v": REPORT_V,
                "source": {
                    "role": self.role,
                    "worker": self.worker,
                    "pid": self.pid,
                },
                "seq": self._seq,
                "wall": time.time(),
                "counters": (
                    {}
                    if reopened
                    else {
                        k: v
                        for k, v in snap["counters"].items()
                        if v
                    }
                ),
                "gauges": dict(snap["gauges"]),
                "histograms": hists,
                "events": events,
                "spans": export_spans(spans)[-self._max_spans:],
                "degraded": degraded and not first,
            }
            if isinstance(capacity, dict):
                report["capacity"] = capacity
            return report

    def close(self) -> None:
        """Close the chained snapshot window (a retired reporter must
        not leave a fork every later ``observe()`` pays for)."""
        with self._lock:
            if self._win is not None:
                try:
                    self._reg.snapshot(since=self._win)
                except ValueError:
                    pass
                self._win = None


class _FleetHist:
    __slots__ = ("count", "total", "min", "max", "reservoir")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.reservoir = WeightedReservoir()

    def add(self, h: dict) -> None:
        self.count += int(h.get("count", 0))
        self.total += float(h.get("sum", 0.0))
        self.min = min(self.min, float(h.get("min", float("inf"))))
        self.max = max(self.max, float(h.get("max", float("-inf"))))
        self.reservoir.add(
            h.get("samples", ()), float(h.get("stride", 1))
        )

    def summary(self) -> dict:
        out = {
            "count": self.count,
            "sum": self.total,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
        }
        out.update(WeightedReservoir.percentiles([self.reservoir]))
        return out


class _Source:
    """Accumulated state for one (role, worker, pid)."""

    def __init__(self, role: str, worker: str, pid: int):
        self.role = role
        self.worker = worker
        self.pid = pid
        self.counters: dict[str, float] = collections.defaultdict(float)
        self.gauges: dict[str, float] = {}
        self.hists: dict[str, _FleetHist] = {}
        self.seq = 0
        self.reports = 0
        self.lost_events = 0
        self.lost_reports = 0
        self.duplicate_reports = 0
        self.last_event_seq = 0
        self.last_mono = time.monotonic()
        self.last_wall = 0.0
        self.degraded = 0
        #: Last capacity book this source shipped (reports carry it as
        #: an optional section) + its arrival stamp — a killed source's
        #: book reads as GROWING age, never as fresh headroom.
        self.capacity: dict | None = None
        self.capacity_mono = 0.0


class FederatedStore:
    """The parent-side aggregation point: ingests reports from any
    number of sources and serves merged, labeled views.

    Sources arrive three ways — pushed over the comm link
    (``RemoteWorkerProxy`` calls :meth:`ingest`), pulled over HTTP
    from lease-advertised endpoints (:meth:`poll_registry`), or LOCAL
    (:meth:`attach_local` registers an in-process reporter that
    :meth:`refresh` drains at read time, so the serving process's own
    metrics appear in ``/fleet/*`` with no push loop)."""

    def __init__(self, event_capacity: int = 8192, span_capacity: int = 4096):
        self._lock = threading.Lock()
        #: Serializes whole refresh passes (collect -> ingest must be
        #: atomic per local reporter: two concurrent refreshes could
        #: otherwise ingest windows n and n+1 out of order, and the
        #: duplicate-seq guard would drop window n's deltas).
        self._refresh_lock = threading.Lock()
        self._sources: dict[str, _Source] = {}
        #: Merged flight stream: each entry is the source event plus a
        #: ``"source"`` tag. Bounded; kept in arrival order, sorted by
        #: wall clock at read time (clocks across processes on one
        #: machine share time.time()).
        self._events: collections.deque[dict] = collections.deque(
            maxlen=event_capacity
        )
        #: Remote spans retained for forensics (local spans live in
        #: the local tracer ring; retaining them twice would force
        #: dedupe at assemble time).
        self._spans: collections.deque[dict] = collections.deque(
            maxlen=span_capacity
        )
        self._locals: dict[str, TelemetryReporter] = {}
        self._registries: list = []  # WorkerRegistry refs for polling
        self._poll_last: dict[str, float] = {}
        #: Lease-advertised capacity books (``meta["capacity"]`` on a
        #: WorkerRegistry lease — the disagg prefill tier's path):
        #: ``worker_id -> (book, first-seen-mono-at-this-wall)``. The
        #: mono stamp only advances when the book's ``wall`` does, and
        #: entries OUTLIVE their lease — an expired or frozen source
        #: reads as growing age, never as a fresh book — up to
        #: ``capacity_max_age_s``, where they evict for good.
        self._lease_caps: dict[str, tuple[dict, float]] = {}
        #: Staleness evict for :meth:`capacity_snapshot`: a book older
        #: than this (lease-sourced or telemetry-sourced) leaves the
        #: placement view entirely. The GROWING-age window below the
        #: bound is the operator's "it's wedged" signal; past it, a
        #: replica dead for minutes must stop being a placement
        #: candidate — the capacity plane owns staleness policy so no
        #: router has to re-implement it. None = keep forever (the
        #: pre-evict behavior).
        self.capacity_max_age_s: float | None = 60.0
        self._journal = None
        self.poll_interval_s = 1.0
        self.poll_timeout_s = 1.0

    # -- wiring ------------------------------------------------------------

    def attach_local(
        self,
        role: str,
        worker: str | None = None,
        registry: MetricsRegistry | None = None,
        recorder: FlightRecorder | None = None,
        tracer: Tracer | None = None,
        capacity_provider=None,
    ) -> str:
        """Register this process itself as a source; its reporter is
        drained lazily at every :meth:`refresh` (scrape-time pull, no
        thread). Idempotent per (role, worker): re-attaching with the
        same identity keeps the existing reporter and its cursors.
        ``capacity_provider`` (zero-arg -> book dict) makes the local
        source self-describing in ``/fleet/capacity``; passing one to
        a re-attach updates the existing reporter's provider."""
        worker = worker if worker is not None else f"pid{os.getpid()}"
        key = source_key(role, worker, os.getpid())
        stale: TelemetryReporter | None = None
        with self._lock:
            existing = self._locals.get(key)
            if existing is not None and existing._reg is (
                registry if registry is not None else global_metrics()
            ):
                if capacity_provider is not None:
                    existing.capacity_provider = capacity_provider
                return key
            stale = existing
            rep = TelemetryReporter(
                role, worker, registry=registry, recorder=recorder,
                tracer=tracer,
            )
            rep.capacity_provider = capacity_provider
            self._locals[key] = rep
        if stale is not None:
            # OUTSIDE the lock: close() snapshots the old registry,
            # which runs its collectors — and this store's own
            # staleness collector re-enters self._lock (same
            # discipline as FederatedStore.close()).
            stale.close()
        return key

    def attach_registry(self, registry) -> None:
        """Register a ``control.registry.WorkerRegistry`` whose live
        leases :meth:`refresh` scans for ``meta["telemetry"]`` pull
        URLs — the fallback for processes the dispatcher doesn't own a
        comm link to."""
        with self._lock:
            if registry not in self._registries:
                self._registries.append(registry)

    def attach_journal(self, journal) -> None:
        """Give :func:`assemble_request` (and ``/debug/request/<id>``)
        access to submit metadata / pending state."""
        self._journal = journal

    @property
    def journal(self):
        return self._journal

    # -- ingest ------------------------------------------------------------

    def ingest(self, report: dict, worker: str | None = None) -> str:
        """Fold one report in; returns the source key. ``worker``
        overrides the report's self-declared worker id (the dispatcher
        knows the worker by ITS name — a dial-out stage server only
        knows its port). Malformed reports raise ``ValueError`` (the
        comm ingest site guards and counts); a well-formed report can
        never half-apply."""
        if not isinstance(report, dict) or int(report.get("v", -1)) != (
            REPORT_V
        ):
            raise ValueError(f"unknown telemetry report: {report!r:.80}")
        src = report["source"]
        role = str(src["role"])
        wid = str(worker if worker is not None else src["worker"])
        pid = int(src["pid"])
        key = source_key(role, wid, pid)
        events = report.get("events", ())
        spans = report.get("spans", ())
        with self._lock:
            s = self._sources.get(key)
            seq = int(report.get("seq", 0))
            if s is not None and seq and seq <= s.seq:
                # Duplicate: the push path RETRANSMITS frames whose
                # send erred after TCP may already have buffered them
                # (comm.remote's telemetry backlog) — folding a
                # duplicate in would double-count every counter delta,
                # reservoir sample, and flight event. Drop it; the
                # source key carries the pid, so a restarted worker is
                # a fresh source, never mistaken for a replay.
                s.duplicate_reports += 1
                s.last_mono = time.monotonic()
                return key
            if s is None:
                s = self._sources[key] = _Source(role, wid, pid)
            s.reports += 1
            if s.seq and seq > s.seq + 1:
                # Report-seq gap: windows collected but never
                # delivered (backlog overflow during an outage). The
                # gap is the fleet-counters under-report signal —
                # counter deltas, unlike events, carry no per-item seq
                # of their own.
                s.lost_reports += seq - s.seq - 1
            s.seq = max(s.seq, seq)
            s.last_mono = time.monotonic()
            s.last_wall = float(report.get("wall", 0.0))
            if report.get("degraded"):
                s.degraded += 1
            for name, v in report.get("counters", {}).items():
                if v > 0:
                    s.counters[name] += float(v)
                # A negative delta means the source's registry was
                # reset mid-flight; dropping it keeps totals monotone
                # (the alternative — subtracting — would present a
                # counter that went backwards to every scraper).
            s.gauges.update(report.get("gauges", {}))
            cap = report.get("capacity")
            if isinstance(cap, dict):
                s.capacity = cap
                s.capacity_mono = time.monotonic()
            for name, h in report.get("histograms", {}).items():
                fh = s.hists.get(name)
                if fh is None:
                    fh = s.hists[name] = _FleetHist()
                fh.add(h)
            for ev in events:
                eseq = int(ev.get("seq", 0))
                if s.last_event_seq and eseq > s.last_event_seq + 1:
                    s.lost_events += eseq - s.last_event_seq - 1
                s.last_event_seq = max(s.last_event_seq, eseq)
                self._events.append({**ev, "source": key})
            if key not in self._locals:
                # LOCAL sources' spans already live in the local tracer
                # ring (assemble_request reads them from there);
                # retaining them here too would force dedupe. Keyed on
                # attach_local membership, NOT pid equality — two
                # containers can both be pid 1.
                self._spans.extend(spans)
        return key

    # -- refresh (read-time pulls) ----------------------------------------

    def refresh(self) -> None:
        """Drain local reporters and poll lease-advertised HTTP
        sources. Runs at read time (every ``/fleet/*`` scrape and
        forensics assemble); HTTP polls are rate-limited by
        ``poll_interval_s`` and bounded by ``poll_timeout_s``."""
        with self._refresh_lock:
            with self._lock:
                locals_ = list(self._locals.values())
                registries = list(self._registries)
            for rep in locals_:
                try:
                    self.ingest(rep.collect())
                except Exception:  # noqa: BLE001 — a scrape must not
                    log.exception("local telemetry collect failed")
            for registry in registries:
                try:
                    self.poll_registry(registry)
                except Exception:  # noqa: BLE001
                    log.exception("telemetry registry poll failed")

    def poll_registry(self, registry) -> int:
        """Pull ``/telemetry.json`` from every live lease advertising
        ``meta["telemetry"]``; returns the number of reports ingested.
        Failures count as ``fleet.poll_failed_total`` — a dead
        advertised endpoint is a staleness signal, never a scrape
        error."""
        n = 0
        now = time.monotonic()
        for wid, meta in registry.alive_meta().items():
            url = meta.get("telemetry")
            if not url:
                continue
            last = self._poll_last.get(url, 0.0)
            if now - last < self.poll_interval_s:
                continue
            self._poll_last[url] = now
            try:
                with urllib.request.urlopen(
                    url, timeout=self.poll_timeout_s
                ) as r:
                    self.ingest(
                        json.loads(r.read().decode()), worker=wid
                    )
                n += 1
            except Exception:  # noqa: BLE001 — counted, not raised
                global_metrics().inc("fleet.poll_failed_total")
        return n

    # -- read side ---------------------------------------------------------

    def sources(self) -> dict[str, dict]:
        """Per-source status (the staleness view): last report age,
        seq, loss accounting."""
        now = time.monotonic()
        with self._lock:
            return {
                key: {
                    "role": s.role,
                    "worker": s.worker,
                    "pid": s.pid,
                    "age_s": round(now - s.last_mono, 3),
                    "seq": s.seq,
                    "reports": s.reports,
                    "lost_events": s.lost_events,
                    "lost_reports": s.lost_reports,
                    "duplicate_reports": s.duplicate_reports,
                    "degraded_reports": s.degraded,
                }
                for key, s in self._sources.items()
            }

    def fleet_snapshot(self, refresh: bool = True) -> dict:
        """The merged view ``/fleet/metrics.json`` serves: per-source
        counters/gauges/histograms (histograms with per-source
        percentiles), plus ``merged`` totals whose percentiles come
        from the UNION of every source's reservoir, plus the
        staleness block."""
        if refresh:
            self.refresh()
        now = time.monotonic()
        with self._lock:
            per_source: dict[str, dict] = {}
            merged_counters: dict[str, float] = collections.defaultdict(
                float
            )
            merged_hists: dict[str, list] = collections.defaultdict(list)
            for key, s in self._sources.items():
                per_source[key] = {
                    "role": s.role,
                    "worker": s.worker,
                    "pid": s.pid,
                    "age_s": round(now - s.last_mono, 3),
                    "seq": s.seq,
                    "lost_events": s.lost_events,
                    "counters": dict(s.counters),
                    "gauges": dict(s.gauges),
                    "histograms": {
                        n: h.summary() for n, h in s.hists.items()
                    },
                }
                for n, v in s.counters.items():
                    merged_counters[n] += v
                for n, h in s.hists.items():
                    merged_hists[n].append(h)
            merged = {
                "counters": dict(merged_counters),
                "histograms": {},
            }
            for n, hs in merged_hists.items():
                total = _FleetHist()
                for h in hs:
                    total.count += h.count
                    total.total += h.total
                    total.min = min(total.min, h.min)
                    total.max = max(total.max, h.max)
                merged["histograms"][n] = {
                    "count": total.count,
                    "sum": total.total,
                    "min": total.min if total.count else 0.0,
                    "max": total.max if total.count else 0.0,
                    **WeightedReservoir.percentiles(
                        [h.reservoir for h in hs]
                    ),
                }
        out = {"sources": per_source, "merged": merged}
        out["staleness"] = {
            k: v["age_s"] for k, v in self.sources().items()
        }
        return out

    def capacity_snapshot(self, refresh: bool = True) -> dict:
        """The merged capacity plane ``GET /fleet/capacity`` serves:
        one entry per replica that has shipped a book — telemetry-wire
        sources (reports' optional ``capacity`` section) plus
        lease-meta books (``meta["capacity"]`` on live registry
        leases) — each labeled role/worker/pid with first-class
        ``age_s`` staleness. A killed source's last book stays in the
        view with GROWING age (placement must see "stale", not
        "gone"); a router treats age above its own bound as no
        capacity at all, and past ``capacity_max_age_s`` the book
        EVICTS — a replica dead for minutes is not a placement
        candidate and must not scroll a fleet view forever."""
        if refresh:
            self.refresh()
        now = time.monotonic()
        with self._lock:
            registries = list(self._registries)
        # Registry scan OUTSIDE self._lock (alive_meta takes the
        # registry's own lock; same discipline as poll_registry).
        lease_books: dict[str, dict] = {}
        for registry in registries:
            try:
                for wid, meta in registry.alive_meta().items():
                    book = meta.get("capacity")
                    if isinstance(book, dict):
                        lease_books[str(wid)] = book
            except Exception:  # noqa: BLE001 — a wedged registry must
                log.exception("capacity lease scan failed")
        replicas: dict[str, dict] = {}
        max_age = self.capacity_max_age_s
        with self._lock:
            for wid, book in lease_books.items():
                prev = self._lease_caps.get(wid)
                if prev is None or prev[0].get("wall") != book.get(
                    "wall"
                ):
                    self._lease_caps[wid] = (book, now)
            if max_age is not None:
                # The evict: books stale past the bound leave the view
                # (lease-sourced entries drop from the retention map
                # itself; telemetry-sourced ones just stop listing —
                # their _Source may still carry live counters).
                for wid in [
                    w
                    for w, (_, mono) in self._lease_caps.items()
                    if now - mono > max_age
                ]:
                    del self._lease_caps[wid]
            for key, s in self._sources.items():
                if s.capacity is None:
                    continue
                if max_age is not None and (
                    now - s.capacity_mono > max_age
                ):
                    continue
                replicas[key] = {
                    "role": s.role,
                    "worker": s.worker,
                    "pid": s.pid,
                    "via": "telemetry",
                    "age_s": round(now - s.capacity_mono, 3),
                    "book": s.capacity,
                }
            for wid, (book, mono) in self._lease_caps.items():
                replicas[f"lease:{wid}"] = {
                    "role": str(book.get("kind", "worker")),
                    "worker": wid,
                    "pid": 0,
                    "via": "lease",
                    "age_s": round(now - mono, 3),
                    "book": book,
                }
        return {"v": REPORT_V, "replicas": replicas}

    def events(
        self,
        request: int | None = None,
        kind: str | None = None,
        limit: int | None = None,
    ) -> list[dict]:
        """The merged flight stream, WALL-CLOCK ordered across sources
        (every event is ``{ts, kind, data, seq, source}``). With
        ``request``, only events naming that request (``data.request``
        or ``data.for_request``)."""
        with self._lock:
            evs = list(self._events)
        if request is not None:
            evs = [
                e
                for e in evs
                if e.get("data", {}).get("request") == request
                or e.get("data", {}).get("for_request") == request
            ]
        if kind is not None:
            evs = [e for e in evs if e.get("kind") == kind]
        evs.sort(key=lambda e: (e.get("ts", 0.0), e.get("seq", 0)))
        if limit is not None:
            evs = evs[-limit:]
        return evs

    def spans(self, request: int | None = None) -> list[dict]:
        """Remote-ingested span exports (wall-clock ``t0``/``t1``
        dicts); local spans live in the local tracer ring."""
        with self._lock:
            spans = list(self._spans)
        if request is not None:
            spans = [
                s
                for s in spans
                if s.get("attrs", {}).get("request") == request
            ]
        return spans

    def collector(self, reg: MetricsRegistry) -> None:
        """``MetricsRegistry.register_collector`` hook: surfaces the
        staleness signal on the PARENT's own ``/metrics`` —
        ``fleet.report_age_s.<source>`` per source (a wedged worker is
        visible as a growing age, not frozen gauges), plus
        ``fleet.sources`` and per-source loss counters. Registered by
        ``serve_metrics`` on whatever registry it serves."""
        infos = self.sources()
        reg.set_gauge("fleet.sources", float(len(infos)))
        for key, info in infos.items():
            reg.set_gauge(
                f"fleet.report_age_s.{key}", round(info["age_s"], 3)
            )
            if info["lost_events"]:
                reg.set_gauge(
                    f"fleet.events_lost.{key}",
                    float(info["lost_events"]),
                )
            if info["lost_reports"]:
                # Whole report windows lost (backlog overflow during
                # an outage): the fleet counters under-report by those
                # windows' deltas, and THIS gauge is the only signal —
                # counter deltas carry no per-item seq of their own.
                reg.set_gauge(
                    f"fleet.reports_lost.{key}",
                    float(info["lost_reports"]),
                )

    def close(self) -> None:
        with self._lock:
            locals_ = list(self._locals.values())
            self._locals.clear()
        for rep in locals_:
            rep.close()


def assemble_request(
    req_id: int,
    store: "FederatedStore | None" = None,
    tracer: Tracer | None = None,
    journal=None,
    refresh: bool = True,
) -> dict:
    """One JSON bundle telling request ``req_id``'s complete story
    across every federated source — the body of
    ``GET /debug/request/<id>``.

    Sections:

    - ``events`` — every flight edge naming the request (admit /
      finish / cancel / preempted / replayed_from_journal /
      kv_migrated / kv_handoff / request_rejected / slo_missed / ...),
      wall-clock ordered, each tagged with its source process;
    - ``lives`` — one entry per admission (a preempted or
      recovery-replayed request has several), with each life's queue
      wait and slot;
    - ``delivery`` — exactly-once accounting: final token count, the
      tokens each replay discarded, per-life TTFT/ITL stamps off the
      finish edge;
    - ``slo`` — violation edges and the terminal verdict;
    - ``spans`` — tracer spans tagged ``request=req_id`` from EVERY
      process (the local ring plus remote exports the store ingested);
    - ``journal`` — submit metadata and whether the request is still
      pending replay.
    """
    store = store if store is not None else global_federated_store()
    tracer = tracer if tracer is not None else global_tracer()
    if refresh:
        store.refresh()
    evs = store.events(request=req_id)
    by_kind: dict[str, list] = collections.defaultdict(list)
    for e in evs:
        by_kind[e["kind"]].append(e)
    lives = [
        {
            "slot": e["data"].get("slot"),
            "queue_wait_s": e["data"].get("queue_wait_s"),
            "ts": e.get("ts"),
            "source": e.get("source"),
        }
        for e in by_kind.get("admit", [])
    ]
    finishes = by_kind.get("finish", [])
    fin = finishes[-1]["data"] if finishes else {}
    replays = by_kind.get("replayed_from_journal", []) + by_kind.get(
        "preempted", []
    )
    # Per-life stamps: each interrupted life's TTFT/ITL ride its
    # replay/preemption edge, the last life's ride the finish edge —
    # chronological, one entry per life that emitted anything.
    life_stamps = [
        {
            k: e["data"][k]
            for k in ("ttft_s", "life_itl_mean_s", "tokens_discarded")
            if k in e["data"]
        }
        for e in sorted(replays, key=lambda e: e.get("ts", 0.0))
    ] + (
        [
            {
                k: fin[k]
                for k in ("ttft_s", "life_itl_mean_s", "tokens")
                if k in fin
            }
        ]
        if finishes
        else []
    )
    ttft = fin.get("ttft_s")
    if ttft is None:
        ttft = next(
            (s["ttft_s"] for s in life_stamps if "ttft_s" in s), None
        )
    delivery = {
        "finished": bool(finishes),
        "reason": fin.get("reason"),
        "tokens": fin.get("tokens"),
        "ttft_s": ttft,
        "life_stamps": life_stamps,
        "lives": len(lives),
        "tokens_discarded": [
            e["data"].get("tokens_discarded", 0) for e in replays
        ],
    }
    slo_evs = by_kind.get("slo_missed", [])
    slo = {
        "violated": bool(slo_evs),
        "violations": [e["data"] for e in slo_evs],
    }
    # Spans: the local ring (both locally-recorded and annex-ingested
    # remote spans live there) plus whatever remote reports shipped —
    # everything exported onto the WALL clock (export_spans), the same
    # clock report-shipped spans arrive on, so cross-source ordering
    # and the dedupe key below actually compare like with like.
    spans = export_spans(
        [
            s
            for s in tracer.spans()
            if s.attrs.get("request") == req_id
        ]
    )
    seen = {(s["pid"], s["tid"], s["name"], round(s["t0"], 6))
            for s in spans}
    for s in store.spans(request=req_id):
        key = (
            s.get("pid"), s.get("tid"), s.get("name"),
            round(float(s.get("t0", 0.0)), 6),
        )
        if key not in seen:
            seen.add(key)
            spans.append(s)
    journal = journal if journal is not None else store.journal
    jinfo = None
    if journal is not None:
        try:
            jinfo = {
                "pending": req_id in journal.pending_ids(),
                "meta": journal.submit_meta(req_id),
            }
        except Exception:  # noqa: BLE001 — forensics never raise
            jinfo = {"error": "journal read failed"}
    return {
        "request": req_id,
        "events": evs,
        "lives": lives,
        "delivery": delivery,
        "slo": slo,
        "preemptions": [e["data"] for e in by_kind.get("preempted", [])],
        "replays": [
            e["data"] for e in by_kind.get("replayed_from_journal", [])
        ],
        "kv_handoffs": [e["data"] for e in by_kind.get("kv_handoff", [])],
        "rejections": [
            e["data"] for e in by_kind.get("request_rejected", [])
        ],
        "spans": sorted(spans, key=lambda s: s["t0"]),
        "journal": jinfo,
    }


_GLOBAL = FederatedStore()


def global_federated_store() -> FederatedStore:
    """The process-global store: the comm-layer ingest site
    (``RemoteWorkerProxy``) and the exporter's ``/fleet/*`` endpoints
    default to it, so one serving process needs zero wiring to see its
    whole worker fleet."""
    return _GLOBAL
