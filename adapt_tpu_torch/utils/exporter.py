"""HTTP observability exporter: metrics, traces, flight-recorder events,
fleet federation and per-request forensics — the port of
``adapt_tpu/utils/exporter.py``, with its routes and its Prometheus text.

A stdlib ``ThreadingHTTPServer`` serving

- ``GET /metrics`` — Prometheus text (counters as ``adapt_<name>_total``,
  gauges as ``adapt_<name>``, histograms as a ``summary`` family; dots
  become underscores; per-tenant and per-source suffixes render as
  labels),
- ``GET /metrics.json`` — the raw :meth:`MetricsRegistry.snapshot`
  (non-finite floats as ``null``),
- ``GET /trace.json`` — the tracer ring as Chrome trace-event JSON,
- ``GET /debug/events`` — the flight recorder's event ring,
- ``GET /debug/request/<id>`` — one request's forensics bundle across
  every federated source (``utils.telemetry.assemble_request``),
- ``GET /fleet/metrics`` / ``/fleet/metrics.json`` — the
  :class:`~adapt_tpu_torch.utils.telemetry.FederatedStore` merged across
  reporting processes (``role`` / ``worker`` labels),
- ``GET /fleet/events`` — the merged flight stream,
- ``GET /fleet/capacity`` — the merged capacity books,
- ``GET /telemetry.json`` — this process's own report (the HTTP-pull
  federation fallback),
- ``GET /healthz`` — liveness.

Every serving component writes the shared :func:`global_metrics`
registry, so one exporter per process covers them. ``serve_metrics(port)``
starts it on a daemon thread (``port=0`` picks a free port) and returns
the server; stop it with ``.shutdown()``.
"""

from __future__ import annotations

import json
import math
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from adapt_tpu_torch.utils.logging import get_logger
from adapt_tpu_torch.utils.metrics import MetricsRegistry, global_metrics
from adapt_tpu_torch.utils.telemetry import (
    FederatedStore,
    TelemetryReporter,
    assemble_request,
    global_federated_store,
)
from adapt_tpu_torch.utils.tracing import (
    FlightRecorder,
    Tracer,
    global_flight_recorder,
    global_tracer,
)

log = get_logger("exporter")

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")

#: Dotted-name families whose LAST component is a dynamic value
#: (tenant label, federation source key), not part of the metric's
#: identity. Baking the value into the Prometheus name
#: (``adapt_scheduler_queue_depth_gold``) makes every tenant a new
#: metric no dashboard can aggregate; these render as labels instead.
_LABEL_RULES: tuple[tuple[str, str], ...] = (
    ("scheduler.queue_depth.", "tenant"),
    ("slo.met_total.", "tenant"),
    ("slo.missed_total.", "tenant"),
    ("fleet.report_age_s.", "source"),
    ("fleet.events_lost.", "source"),
    ("fleet.reports_lost.", "source"),
)


def _prom_name(name: str) -> str:
    return "adapt_" + _NAME_RE.sub("_", name)


def _counter_name(base: str) -> str:
    """Counter family name: ``_total`` appended per convention, but
    never doubled for dotted names that already end in ``.total`` /
    ``_total`` (``slo.met_total`` must render ``adapt_slo_met_total``,
    not ``..._total_total``)."""
    pname = _prom_name(base)
    return pname if pname.endswith("_total") else pname + "_total"


def _split_labels(name: str) -> tuple[str, dict[str, str]]:
    """``scheduler.queue_depth.gold`` ->
    ``("scheduler.queue_depth", {"tenant": "gold"})``; unknown names
    pass through with no labels."""
    for prefix, label in _LABEL_RULES:
        if name.startswith(prefix) and len(name) > len(prefix):
            return name[: len(prefix) - 1], {label: name[len(prefix):]}
    return name, {}


def _esc_label(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_esc_label(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


class _PromDoc:
    """Accumulates samples grouped by family so ``# HELP``/``# TYPE``
    emit exactly once per family however many label combinations
    sample it (the exposition-format contract scrapers parse by)."""

    def __init__(self):
        #: family name -> (mtype, help, [sample lines])
        self._fams: dict[str, tuple[str, str, list[str]]] = {}

    def add(
        self,
        fname: str,
        mtype: str,
        help_: str,
        value,
        labels: dict[str, str] | None = None,
        sample: str | None = None,
    ) -> None:
        """One sample under family ``fname``. ``sample`` overrides the
        sample line's metric name (summary families emit
        ``<family>_count`` / ``<family>_sum`` under the family's own
        HELP/TYPE, per the exposition format)."""
        fam = self._fams.get(fname)
        if fam is None:
            fam = self._fams[fname] = (mtype, help_, [])
        if isinstance(value, float) and not math.isfinite(value):
            value = "NaN" if math.isnan(value) else (
                "+Inf" if value > 0 else "-Inf"
            )  # the text format HAS a spelling for these; JSON doesn't
        fam[2].append(
            f"{sample or fname}{_fmt_labels(labels or {})} {value}"
        )

    def render(self) -> str:
        lines: list[str] = []
        for fname in sorted(self._fams):
            mtype, help_, samples = self._fams[fname]
            lines.append(f"# HELP {fname} {help_}")
            lines.append(f"# TYPE {fname} {mtype}")
            lines.extend(samples)
        return "\n".join(lines) + "\n"


def prometheus_text(
    snapshot: dict, const_labels: dict[str, str] | None = None
) -> str:
    """Render a :meth:`MetricsRegistry.snapshot` in the Prometheus text
    exposition format. Every sample family gets ``# HELP``/``# TYPE``
    lines exactly once; histograms render as a ``summary`` family
    (count/sum) plus percentile gauges. Known dynamic suffixes become
    labels (see ``_LABEL_RULES``); ``const_labels`` (the fleet view's
    ``role``/``worker``) attach to every sample."""
    doc = _PromDoc()
    base_labels = dict(const_labels or {})
    for name, value in sorted(snapshot.get("counters", {}).items()):
        base, labels = _split_labels(name)
        doc.add(
            _counter_name(base),
            "counter",
            f"cumulative count of {base}",
            value,
            {**base_labels, **labels},
        )
    for name, value in sorted(snapshot.get("gauges", {}).items()):
        base, labels = _split_labels(name)
        doc.add(
            _prom_name(base),
            "gauge",
            f"current value of {base}",
            value,
            {**base_labels, **labels},
        )
    for name, summ in sorted(snapshot.get("histograms", {}).items()):
        base, labels = _split_labels(name)
        pname = _prom_name(base)
        lab = {**base_labels, **labels}
        help_ = f"distribution of {base}"
        doc.add(
            pname, "summary", help_, summ.get("count", 0), lab,
            sample=pname + "_count",
        )
        if summ.get("count"):
            doc.add(
                pname, "summary", help_, summ["sum"], lab,
                sample=pname + "_sum",
            )
            for p in ("p50", "p99"):
                if p in summ:
                    doc.add(
                        f"{pname}_{p}",
                        "gauge",
                        f"{p} of {base} (reservoir)",
                        summ[p],
                        lab,
                    )
    return doc.render()


def fleet_prometheus_text(fleet: dict) -> str:
    """Render a :meth:`FederatedStore.fleet_snapshot` as ONE
    Prometheus document: every source's counters/gauges/histogram
    count+sum labeled ``role``/``worker``/``pid``, per-source
    percentile gauges labeled the same, MERGED fleet percentiles (the
    union-of-reservoirs numbers) as the unlabeled series, and the
    staleness block as ``adapt_fleet_report_age_s{source=...}``."""
    doc = _PromDoc()
    for key, src in sorted(fleet.get("sources", {}).items()):
        lab = {
            "role": src["role"],
            "worker": src["worker"],
            "pid": str(src["pid"]),
        }
        for name, value in sorted(src.get("counters", {}).items()):
            base, extra = _split_labels(name)
            doc.add(
                _counter_name(base), "counter",
                f"cumulative count of {base} (federated)",
                value, {**lab, **extra},
            )
        for name, value in sorted(src.get("gauges", {}).items()):
            base, extra = _split_labels(name)
            doc.add(
                _prom_name(base), "gauge",
                f"current value of {base} (federated)",
                value, {**lab, **extra},
            )
        for name, summ in sorted(src.get("histograms", {}).items()):
            base, extra = _split_labels(name)
            pname = _prom_name(base)
            hl = {**lab, **extra}
            help_ = f"distribution of {base} (federated)"
            doc.add(
                pname, "summary", help_, summ.get("count", 0), hl,
                sample=pname + "_count",
            )
            doc.add(
                pname, "summary", help_, summ.get("sum", 0.0), hl,
                sample=pname + "_sum",
            )
            for p in ("p50", "p99"):
                if p in summ:
                    doc.add(
                        f"{pname}_{p}", "gauge",
                        f"{p} of {base} (per-source reservoir)",
                        summ[p], hl,
                    )
    merged = fleet.get("merged", {})
    for name, summ in sorted(merged.get("histograms", {}).items()):
        base, _ = _split_labels(name)
        pname = _prom_name(base)
        for p in ("p50", "p99"):
            if p in summ:
                doc.add(
                    f"{pname}_{p}", "gauge",
                    f"{p} of {base} (fleet-merged reservoirs)",
                    summ[p], None,
                )
    for key, age in sorted(fleet.get("staleness", {}).items()):
        doc.add(
            "adapt_fleet_report_age_s", "gauge",
            "seconds since each source's last telemetry report "
            "(a growing age = a wedged or dead source)",
            age, {"source": key},
        )
    doc.add(
        "adapt_fleet_sources", "gauge",
        "telemetry sources currently known to the federated store",
        len(fleet.get("sources", {})), None,
    )
    return doc.render()


def _sanitize(obj):
    """Recursively replace non-finite floats with None: ``json.dumps``
    spells them ``NaN``/``Infinity``, which is NOT JSON — one bad
    roofline gauge on an odd backend must not make every
    ``/metrics.json`` consumer's parser throw."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    return obj


def _json_bytes(obj) -> bytes:
    # default=str: one non-JSON value (numpy scalar, exception object)
    # must degrade to its repr, not turn the scrape into a 500.
    return json.dumps(_sanitize(obj), default=str).encode()


def serve_metrics(
    port: int = 9100,
    host: str = "127.0.0.1",
    registry: MetricsRegistry | None = None,
    tracer: Tracer | None = None,
    recorder: FlightRecorder | None = None,
    store: FederatedStore | None = None,
    role: str = "server",
    worker: str | None = None,
    journal=None,
    capacity_provider=None,
    placements_provider=None,
) -> ThreadingHTTPServer:
    """Start the exporter on a daemon thread; returns the server
    (``.server_address[1]`` is the bound port). Stop with
    ``.shutdown()`` then ``.server_close()`` — shutdown alone stops the
    loop but leaks the listening socket. ``registry``/``tracer``/
    ``recorder``/``store`` default to the process-global ones.

    ``role``/``worker`` name this process in the fleet views (and
    ``/healthz``); the process registers itself as a LOCAL federation
    source, so ``/fleet/*`` always includes the serving process's own
    telemetry next to its workers'. ``journal`` (a
    ``control.journal.DispatcherJournal``) enriches
    ``/debug/request/<id>`` with submit metadata. ``capacity_provider``
    (zero-arg -> capacity book dict, e.g. a batcher's
    ``capacity_book``) makes this process a ``/fleet/capacity`` source
    and stamps the book onto ``/telemetry.json`` pulls.
    ``placements_provider`` (zero-arg -> dict, e.g. a
    ``runtime/router.FleetRouter``'s ``placements`` method) turns on
    ``GET /fleet/placements`` — the router's bounded decision ring:
    why each recent request landed on the replica it did."""
    reg = registry if registry is not None else global_metrics()
    tr = tracer if tracer is not None else global_tracer()
    rec = recorder if recorder is not None else global_flight_recorder()
    fed = store if store is not None else global_federated_store()
    # Pull-side bridges: codec registers its copy-stats collector on the
    # GLOBAL registry at import; re-register it on the registry actually
    # being served, so custom-registry exporters (tests, multi-tenant
    # processes) get codec.copy_{bytes,calls} too. register_collector is
    # idempotent per function. Function-scoped import: utils must not
    # depend on comm at module level.
    from adapt_tpu_torch.comm.codec import _copy_stats_collector

    reg.register_collector(_copy_stats_collector)
    # Engine-tier bridge (utils.profiling): memory gauges (KV strips,
    # draft caches, paged pool occupancy, the card's allocator) + a compile-
    # sentinel sample per scrape, on the registry actually served.
    from adapt_tpu_torch.utils.profiling import engine_collector

    reg.register_collector(engine_collector)
    # Federation bridges: this process is itself a fleet source, and
    # the staleness gauges (fleet.report_age_s.<source>) land on the
    # served registry so a plain /metrics scrape sees a wedged worker.
    fed.attach_local(
        role, worker, registry=reg, recorder=rec, tracer=tr,
        capacity_provider=capacity_provider,
    )
    reg.register_collector(fed.collector)
    if journal is not None:
        fed.attach_journal(journal)
    #: One pull-fallback reporter for /telemetry.json — independent of
    #: the local-source reporter above (each keeps its own window and
    #: cursors, so the two consumers don't split each other's deltas).
    pull_reporter = TelemetryReporter(
        role,
        worker if worker is not None else f"pid{os.getpid()}",
        registry=reg,
        recorder=rec,
        tracer=tr,
    )
    pull_reporter.capacity_provider = capacity_provider
    t_start = time.monotonic()

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 — http.server API
            try:
                self._serve()
            except (BrokenPipeError, ConnectionResetError):
                # A scraper hanging up mid-body is the CLIENT's
                # problem; tracebacks per disconnect would spam the
                # serving process's stderr under flaky collectors.
                pass

        def _serve(self):
            path = self.path.split("?", 1)[0]
            if path == "/metrics":
                body = prometheus_text(reg.snapshot()).encode()
                ctype = "text/plain; version=0.0.4"
            elif path == "/metrics.json":
                body = _json_bytes(reg.snapshot())
                ctype = "application/json"
            elif path == "/trace.json":
                body = _json_bytes(tr.to_chrome_trace())
                ctype = "application/json"
            elif path == "/debug/events":
                body = _json_bytes(rec.snapshot())
                ctype = "application/json"
            elif path.startswith("/debug/request/"):
                try:
                    rid = int(path.rsplit("/", 1)[1])
                except ValueError:
                    self.send_response(404)
                    self.end_headers()
                    return
                body = _json_bytes(
                    assemble_request(
                        rid, store=fed, tracer=tr, journal=journal
                    )
                )
                ctype = "application/json"
            elif path == "/fleet/metrics":
                body = fleet_prometheus_text(
                    fed.fleet_snapshot()
                ).encode()
                ctype = "text/plain; version=0.0.4"
            elif path == "/fleet/metrics.json":
                body = _json_bytes(fed.fleet_snapshot())
                ctype = "application/json"
            elif path == "/fleet/events":
                fed.refresh()
                body = _json_bytes({"events": fed.events()})
                ctype = "application/json"
            elif path == "/fleet/capacity":
                # The capacity plane: per-replica books (headroom,
                # TTFT forecast, affinity sketch, health) labeled
                # role/worker/pid with first-class age_s staleness —
                # the router/autoscaler placement view.
                body = _json_bytes(fed.capacity_snapshot())
                ctype = "application/json"
            elif path == "/fleet/placements":
                # The router's decision ring: which replica each
                # recent request landed on and WHY (affinity tokens,
                # forecast, queue, health, the losing alternatives).
                # 404 when no router runs in this process — a fleet
                # endpoint must not fabricate an empty router.
                if placements_provider is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                body = _json_bytes(placements_provider())
                ctype = "application/json"
            elif path == "/telemetry.json":
                body = _json_bytes(pull_reporter.collect())
                ctype = "application/json"
            elif path == "/healthz":
                body = _json_bytes(
                    {
                        "ok": True,
                        "pid": os.getpid(),
                        "role": role,
                        "uptime_s": round(
                            time.monotonic() - t_start, 3
                        ),
                    }
                )
                ctype = "application/json"
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # scrapes are not log events
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    # server_close() also retires the pull reporter: its chained
    # snapshot window must not outlive the endpoint that drives it
    # (an orphaned window taxes every later observe() and can evict a
    # live load-harness phase window at _MAX_WINDOWS). The store's
    # local-source reporter is shared store state — the store's own
    # close() owns that one.
    orig_close = server.server_close

    def _close():
        orig_close()
        pull_reporter.close()

    server.server_close = _close
    thread = threading.Thread(
        target=server.serve_forever, name="metrics-exporter", daemon=True
    )
    thread.start()
    log.info("metrics exporter on %s:%d", host, server.server_address[1])
    return server
