"""The port's telemetry federation and exporter (``utils/telemetry.py``,
``utils/exporter.py``) against the JAX package's, on the CPU.

The same registry / recorder / tracer operations give the same reports in
both packages, once the process id and the clock readings are taken out;
the JAX package's reports ingested by the port's store give the JAX
store's fleet snapshot (ages taken out); the Prometheus text (plain and
fleet) and the ``MSG_TELEMETRY`` frame are byte-equal to the JAX
package's; every exporter route answers; and one worker process of the
port reports to a port proxy, whose store then holds its source, its
stage executions and, after a SIGKILL, a growing report age. Waits poll
for their condition under a deadline."""

import copy
import importlib
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from adapt_tpu_torch.comm import framing as TF
from adapt_tpu_torch.comm.remote import LISTENING, RemoteWorkerProxy
from adapt_tpu_torch.config import FaultConfig, ServeConfig
from adapt_tpu_torch.control.dispatcher import Dispatcher
from adapt_tpu_torch.graph.partition import partition
from adapt_tpu_torch.models.vit import vit_tiny
from adapt_tpu_torch.runtime.capacity import stage_book
from adapt_tpu_torch.utils import exporter as TE
from adapt_tpu_torch.utils import metrics as TM
from adapt_tpu_torch.utils import telemetry as TT
from adapt_tpu_torch.utils import tracing as TR

JF = importlib.import_module("adapt_tpu.comm.framing")
JE = importlib.import_module("adapt_tpu.utils.exporter")
JM = importlib.import_module("adapt_tpu.utils.metrics")
JT = importlib.import_module("adapt_tpu.utils.telemetry")
JR = importlib.import_module("adapt_tpu.utils.tracing")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 30.0


def _poll(cond, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"{what} within {timeout} s"
        time.sleep(0.05)


def _ops(M, R):
    """The same metric / flight / span operations for either package;
    returns a reporter over private instances and a second-round op."""
    reg, rec, tr = M.MetricsRegistry(), R.FlightRecorder(64), R.Tracer()
    tr.enabled = True
    rep = (JT if M is JM else TT).TelemetryReporter(
        "stage", "w0", registry=reg, recorder=rec, tracer=tr)
    reg.inc("remote.stage_execs", 3)
    reg.set_gauge("scheduler.queue_depth.gold", 2)
    for v in np.linspace(0.001, 0.5, 300):
        reg.observe("remote.stage_exec_s", float(v))
    rec.record("admit", request=1, slot=0)
    rec.record("finish", request=1, tokens=4)
    with tr.span("remote.stage_exec", request=1, stage=1):
        pass

    def again():
        reg.inc("remote.stage_execs", 2)
        reg.observe("remote.stage_exec_s", 0.25)
        rec.record("admit", request=2)

    return rep, again


def _strip(report):
    r = copy.deepcopy(report)
    r["source"].pop("pid")
    r.pop("wall")
    for e in r["events"]:
        e.pop("ts")
    for s in r["spans"]:
        for k in ("t0", "t1", "pid", "tid"):
            s.pop(k)
    return r


def test_reports_equal_jax_minus_pid_and_times():
    (trep, tagain), (jrep, jagain) = _ops(TM, TR), _ops(JM, JR)
    for _ in range(2):
        t, j = trep.collect(), jrep.collect()
        assert _strip(t) == _strip(j)
        assert t["source"]["pid"] == os.getpid()
        tagain()
        jagain()
    trep.capacity_provider = jrep.capacity_provider = lambda: stage_book(2)
    t, j = _strip(trep.collect()), _strip(jrep.collect())
    for r in (t, j):
        r["capacity"].pop("wall")
    assert t == j and t["capacity"]["kind"] == "stage"


def _ages_out(snap):
    s = copy.deepcopy(snap)
    assert set(s.pop("staleness")) == set(s["sources"])
    for src in s["sources"].values():
        for k in ("age_s", "last_wall", "wall"):
            src.pop(k, None)
    return s


def test_jax_reports_into_the_port_store_give_jax_fleet_snapshot():
    reports = []
    for worker in ("w0", "w1"):
        rep, again = _ops(JM, JR)
        rep.worker = worker
        reports.append(rep.collect())
        again()
        reports.append(rep.collect())
    tstore, jstore = TT.FederatedStore(), JT.FederatedStore()
    for r in reports:
        tstore.ingest(json.loads(json.dumps(r)), worker=r["source"]["worker"])
        jstore.ingest(json.loads(json.dumps(r)), worker=r["source"]["worker"])
    # A duplicate report applies once in both.
    tstore.ingest(json.loads(json.dumps(reports[-1])), worker="w1")
    jstore.ingest(json.loads(json.dumps(reports[-1])), worker="w1")
    t, j = tstore.fleet_snapshot(), jstore.fleet_snapshot()
    assert _ages_out(t) == _ages_out(j)
    assert t["merged"]["counters"]["remote.stage_execs"] == 10
    assert [e["kind"] for e in tstore.events(request=1)] == [
        e["kind"] for e in jstore.events(request=1)]
    # Byte-equal, the ages' sample values aside.
    texts = [[ln for ln in txt.splitlines()
              if not ln.startswith("adapt_fleet_report_age_s{")]
             for txt in (TE.fleet_prometheus_text(t),
                         JE.fleet_prometheus_text(j))]
    assert texts[0] == texts[1]
    tstore.close()
    jstore.close()


def test_prometheus_text_and_telemetry_frame_byte_equal_jax():
    regs = (TM.MetricsRegistry(), JM.MetricsRegistry())
    for reg in regs:
        reg.set_gauge("scheduler.queue_depth.gold", 3)
        reg.set_gauge("scheduler.queue_depth.free", 7)
        reg.inc("slo.met_total.gold", 5)
        reg.set_gauge("fleet.report_age_s.stage:w0:123", 1.5)
        reg.inc("scheduler.rejected_total", 4)
        reg.set_gauge("engine.kernel_dispatch.paged_decode.pallas_total", 9)
        reg.set_gauge("engine.mbu", float("nan"))
        for v in (0.25, 0.5, 1.0):
            reg.observe("engine.phase.decode_s", v)
    text = TE.prometheus_text(regs[0].snapshot())
    assert text.encode() == JE.prometheus_text(regs[1].snapshot()).encode()
    assert 'adapt_scheduler_queue_depth{tenant="gold"} 3' in text
    rep, _ = _ops(TM, TR)
    blob = json.dumps(rep.collect(), default=str).encode()
    frames = [b"".join(bytes(p) for p in F.frame_parts(
        F.Message(F.MSG_TELEMETRY, 0, 7, 0, blob))) for F in (TF, JF)]
    assert TF.MSG_TELEMETRY == JF.MSG_TELEMETRY
    assert frames[0] == frames[1]
    msg = TF.parse_frame(frames[0][8:])  # after the length prefix
    assert (msg.msg_type, msg.request_id) == (TF.MSG_TELEMETRY, 7)
    assert json.loads(TF.payload_bytes(msg.payload)) == json.loads(blob)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.read().decode(), r.headers.get("Content-Type")


def test_exporter_serves_every_route():
    reg = TM.MetricsRegistry()
    reg.inc("dispatcher.completed", 5)
    reg.set_gauge("continuous.active_slots", 3)
    reg.observe("stage.latency_s", 0.1)
    reg.observe("stage.latency_s", 0.3)
    reg.set_gauge("engine.mbu", float("inf"))
    store = TT.FederatedStore()
    server = TE.serve_metrics(port=0, registry=reg, store=store,
                              capacity_provider=lambda: stage_book(1))
    port = server.server_address[1]
    try:
        text, ctype = _get(port, "/metrics")
        assert "text/plain" in ctype
        assert "adapt_dispatcher_completed_total 5" in text
        assert "adapt_stage_latency_s_sum 0.4" in text
        snap = json.loads(_get(port, "/metrics.json")[0])
        assert snap["counters"]["dispatcher.completed"] == 5
        assert snap["gauges"]["engine.mbu"] is None  # non-finite -> null
        health = json.loads(_get(port, "/healthz")[0])
        assert health["ok"] is True and health["pid"] == os.getpid()
        assert "traceEvents" in json.loads(_get(port, "/trace.json")[0])
        assert "events" in json.loads(_get(port, "/debug/events")[0])
        assert "adapt_dispatcher_completed_total" in _get(
            port, "/fleet/metrics")[0]
        assert "merged" in json.loads(_get(port, "/fleet/metrics.json")[0])
        assert "events" in json.loads(_get(port, "/fleet/events")[0])
        caps = json.loads(_get(port, "/fleet/capacity")[0])["replicas"]
        assert any(c["book"]["kind"] == "stage" for c in caps.values())
        assert json.loads(_get(port, "/telemetry.json")[0])["v"] == 1
        assert json.loads(_get(port, "/debug/request/1")[0])["request"] == 1
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(port, "/nope")
        assert e.value.code == 404
    finally:
        server.shutdown()
        server.server_close()
        store.close()


def test_a_worker_process_reports_to_the_proxy_and_goes_stale():
    """One worker process of the port (``--telemetry-s 0.2``) serves stage
    1 of a vit_tiny behind a port dispatcher: its reports reach the
    process-global store under the lease's worker id with its stage
    executions, ``serve_observability``-style fleet views carry them, and
    after a SIGKILL its ``fleet.report_age_s`` gauge grows past a few
    report intervals."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "adapt_tpu_torch.comm.remote", "--port", "0",
         "--device", "cpu", "--heartbeat", "0.1", "--telemetry-s", "0.2"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True)
    fault = FaultConfig(lease_ttl_s=2.0, heartbeat_s=0.2,
                        task_deadline_s=20.0, watchdog_period_s=0.2,
                        startup_wait_s=WAIT_S, configure_timeout_s=WAIT_S)
    g = vit_tiny(device="cpu")
    plan = partition(g, ["encoder_block_1"])
    disp = Dispatcher(plan, None, config=ServeConfig(fault=fault))
    disp.spawn_workers(["cpu"])
    store = TT.global_federated_store()
    reg = TM.MetricsRegistry()
    reg.register_collector(store.collector)
    try:
        line = proc.stdout.readline().split()
        assert line and line[0] == LISTENING, line
        port = int(line[1].rpartition(":")[2])
        proxy = RemoteWorkerProxy(
            "telemetry-0", ("127.0.0.1", port), disp.registry,
            disp.result_queue, model_config={
                "model": "vit_tiny", "num_classes": 10,
                "cuts": ["encoder_block_1"]},
            fault=fault, result_device="cpu")
        disp.attach_worker(proxy)
        disp.start()
        proxy.configure(1, None, plan.extract_variables()[1])
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (2, 32, 32, 3)).astype(np.float32))
        disp.serve_stream([x] * 3, timeout_per_request=WAIT_S)
        served = proxy.results_received

        def key():
            for k, s in store.sources().items():
                if s["role"] == "stage" and s["worker"] == "telemetry-0":
                    return k
            return None

        def execs():
            k = key()
            src = store.fleet_snapshot()["sources"].get(k, {}) if k else {}
            return src.get("counters", {}).get("remote.stage_execs", 0)

        _poll(lambda: execs() >= served, "the worker's reports")
        assert execs() == served
        wkey = key()
        assert store.fleet_snapshot()["sources"][wkey]["pid"] == proc.pid
        age = f"fleet.report_age_s.{wkey}"
        assert reg.snapshot()["gauges"][age] < 1.0
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=10)
        _poll(lambda: reg.snapshot()["gauges"][age] > 1.0,
              "the dead worker's report age to grow")
    finally:
        disp.shutdown()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
