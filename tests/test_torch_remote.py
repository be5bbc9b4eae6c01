"""Remote stage workers of the port (``adapt_tpu_torch.comm.remote``) in
real child processes on the CPU: ``python -m adapt_tpu_torch.comm.remote
--device cpu``, started with the environment recipe of ``tests/
conftest.py``'s ``spawn_worker_proc`` (copied here: no PYTHONPATH startup
hook, the CPU, the repo on the path) and one torch thread each.

The JAX package's ``tests/test_comm.py`` and ``tests/test_control.py``
cases, one by one, on a ``vit_tiny`` (and a 10-class ResNet-50 at 64 x
64 for the registry-less worker): outputs ``torch.equal`` to the port's
``graph.apply`` for the lossless codecs, and the port's ``graph.apply``
within ``atol = rtol = 1e-5`` of the JAX package's on the same weights
(``convert.vit_from_flax``: the ViT tests' tolerance); SIGKILL of a
worker process, probes and a hang, a registry-less worker configured by
``graph_spec``, concurrent configures, a stalled peer, gateway joins
(duplicate id, bad secret), chain forwarding and its fallback to the hub,
recovery from the journal, the counted in-flight decrement, the
``journal_dir`` warning, and no ``jax`` in a worker process.

So that the file cannot flake under parallel test workers: ports are
ephemeral (each worker binds port 0 and reports it on stdout), every wait
is a bounded poll of at most 30 s, nothing asserts a wall-clock race, and
every child is terminated in a finalizer."""

import importlib
import json
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapt_tpu_torch.comm import codec as TC
from adapt_tpu_torch.comm.framing import (
    MSG_HELLO,
    MSG_RESULT,
    Message,
    recv_msg,
    send_msg,
)
from adapt_tpu_torch.comm.remote import (
    LISTENING,
    RemoteStageServer,
    RemoteWorkerProxy,
    WorkerGateway,
)
from adapt_tpu_torch.comm.remote import main as remote_main
from adapt_tpu_torch.config import CodecConfig, FaultConfig, ServeConfig
from adapt_tpu_torch.control.dispatcher import Dispatcher
from adapt_tpu_torch.control.journal import DispatcherJournal
from adapt_tpu_torch.control.registry import WorkerRegistry
from adapt_tpu_torch.control.worker import PING_STAGE, Task, WorkerState
from adapt_tpu_torch.convert import vit_from_flax
from adapt_tpu_torch.graph.partition import partition
from adapt_tpu_torch.graph.spec import graph_to_spec
from adapt_tpu_torch.models.resnet import RESNET50_3STAGE_CUTS, resnet50
from adapt_tpu_torch.models.vit import vit_block_cuts, vit_tiny
from adapt_tpu_torch.runtime import pipeline as pipeline_mod
from adapt_tpu_torch.runtime.pipeline import ServingPipeline

JV = importlib.import_module("adapt_tpu.models.vit")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 30.0
FAULT = FaultConfig(lease_ttl_s=2.0, heartbeat_s=0.2, task_deadline_s=20.0,
                    watchdog_period_s=0.2, startup_wait_s=WAIT_S,
                    configure_timeout_s=WAIT_S)
CFG = ServeConfig(fault=FAULT)
TWO_CUTS = ["encoder_block_1"]
RECIPE = {"model": "vit_tiny", "num_classes": 10, "cuts": TWO_CUTS}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    return env


def _poll(cond, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"{what} within {timeout} s"
        time.sleep(0.05)


def read_port(proc) -> int:
    """The port a worker process printed (``listening HOST:PORT``)."""
    line = proc.stdout.readline().split()
    assert line and line[0] == LISTENING, f"worker did not start: {line}"
    return int(line[1].rpartition(":")[2])


class Spawner:
    """Worker processes, each terminated at teardown. ``start`` launches
    listening workers at once (they import torch in parallel); ``worker``
    hands out a started one, or starts one."""

    def __init__(self):
        self.procs: list[subprocess.Popen] = []
        self.ready: dict[tuple, list[subprocess.Popen]] = {}

    def start(self, n: int, *args) -> "Spawner":
        self.ready.setdefault(args, []).extend(
            self._listening(*args) for _ in range(n))
        return self

    def _listening(self, *args) -> subprocess.Popen:
        return self.python("-m", "adapt_tpu_torch.comm.remote", "--port",
                           "0", "--device", "cpu", "--heartbeat", "0.2",
                           *args)

    def python(self, *args) -> subprocess.Popen:
        proc = subprocess.Popen([sys.executable, *args], env=_env(),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL, text=True)
        self.procs.append(proc)
        return proc

    def worker(self, *args) -> tuple[subprocess.Popen, int]:
        """A listening worker on a free port; returns (process, port)."""
        started = self.ready.get(args)
        proc = started.pop() if started else self._listening(*args)
        return proc, read_port(proc)

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        for p in self.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
            if p.stdout is not None:
                p.stdout.close()


@pytest.fixture
def spawn():
    s = Spawner()
    yield s
    s.close()


@pytest.fixture(scope="module")
def pool():
    """Listening workers started together for the whole file: each test
    that kills, hangs or chains workers takes its own."""
    s = Spawner().start(8).start(1, "--no-registry")
    yield s
    s.close()


@pytest.fixture(scope="module")
def shared(pool):
    """One worker the non-destructive tests share."""
    return pool.worker()[1]


@pytest.fixture(scope="module")
def tiny():
    """vit_tiny with the JAX package's weights: (graph, x, port's
    graph.apply, JAX's graph.apply)."""
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    jg = JV.vit_tiny()
    variables = jg.init(jax.random.PRNGKey(0), jnp.asarray(x))
    g = vit_tiny(device="cpu")
    g.load_state_dict(vit_from_flax(variables))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        ref = g.apply(xt)
    return g, xt, ref, np.asarray(jg.apply(variables, jnp.asarray(x)))


def _proxy(disp, name, port, codec="none", **kw):
    return RemoteWorkerProxy(
        name, ("127.0.0.1", port), disp.registry, disp.result_queue,
        model_config=kw.pop("model_config", RECIPE), codec_name=codec,
        fault=CFG.fault, result_device="cpu", **kw)


# -- the mixed pool ------------------------------------------------------------


@pytest.mark.parametrize("codec", ["none", "lz"])
def test_mixed_pool_outputs_equal_graph_apply(shared, tiny, codec):
    g, x, ref, ref_jax = tiny
    np.testing.assert_allclose(ref.numpy(), ref_jax, atol=1e-5, rtol=1e-5)
    port = shared
    plan = partition(g, TWO_CUTS)
    disp = Dispatcher(plan, None, config=CFG)
    disp.spawn_workers(["cpu"])
    proxy = _proxy(disp, "remote-0", port, codec)
    disp.attach_worker(proxy)
    try:
        disp.start()
        proxy.configure(1, None, plan.extract_variables()[1])
        outs = disp.serve_stream([x] * 4, timeout_per_request=WAIT_S)
        assert all(torch.equal(y, ref) for y in outs)
        assert proxy.results_received >= 4  # the remote served stage 1
    finally:
        disp.shutdown()


def test_sigkill_of_a_worker_process_completes_each_request_once(pool,
                                                                 tiny):
    g, x, ref, _ = tiny
    proc, port = pool.worker()
    plan = partition(g, TWO_CUTS)
    disp = Dispatcher(plan, None, config=CFG)
    disp.spawn_workers(["cpu"])
    proxy = _proxy(disp, "remote-0", port)
    disp.attach_worker(proxy)
    try:
        disp.start()
        proxy.configure(1, None, plan.extract_variables()[1])
        futures = [disp.submit(x) for _ in range(6)]
        os.kill(proc.pid, signal.SIGKILL)
        futures += [disp.submit(x) for _ in range(4)]
        outs = [f.result(WAIT_S) for f in futures]
        assert all(torch.equal(y, ref) for y in outs)
        _poll(lambda: "remote-0" not in disp.registry.alive(),
              "the killed worker left the pool")
        assert proxy.state is WorkerState.DEAD
        assert sorted(f.request_id for f in futures) == list(range(10))
    finally:
        disp.shutdown()


def test_probe_round_trip_and_hang_swallows_it(pool):
    _, port = pool.worker()
    registry = WorkerRegistry(default_ttl_s=2.0).start()
    results: queue.Queue = queue.Queue()
    proxy = RemoteWorkerProxy("remote-probe", ("127.0.0.1", port), registry,
                              results, model_config={}, fault=FAULT)
    try:
        proxy.start()
        proxy.submit(Task(request_id=-5, stage_index=PING_STAGE, attempt=0,
                          payload=None))
        ans = results.get(timeout=WAIT_S)
        assert (ans.stage_index, ans.request_id, ans.worker_id) == (
            PING_STAGE, -5, "remote-probe")
        assert ans.error is None and proxy.queue_depth == 0
        proxy.kill("hang")
        proxy.submit(Task(request_id=-6, stage_index=PING_STAGE, attempt=0,
                          payload=None))
        with pytest.raises(queue.Empty):
            results.get(timeout=1.5)
        # A hung server keeps pinging: the lease lives, the link is up.
        time.sleep(0.5)
        assert "remote-probe" in registry.alive()
        assert proxy.state is not WorkerState.DEAD
    finally:
        proxy.stop()
        registry.stop()


def test_registry_less_worker_serves_a_graph_by_value(pool):
    g = resnet50(10, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        ref = g.apply(x)
    cuts = list(RESNET50_3STAGE_CUTS)
    plan = partition(g, cuts)
    _, port = pool.worker("--no-registry")
    disp = Dispatcher(plan, None, config=CFG)
    proxy = _proxy(disp, "by-value-0", port, "lz",
                   model_config={"graph_spec": graph_to_spec(g),
                                 "cuts": cuts})
    disp.attach_worker(proxy)
    try:
        disp.start()
        stage_vars = plan.extract_variables()
        for i in range(plan.num_stages):
            proxy.configure(i, None, stage_vars[i])
        outs = disp.serve_stream([x] * 2, timeout_per_request=WAIT_S)
        assert all(torch.equal(y, ref) for y in outs)
        assert proxy.results_received == 2 * plan.num_stages
        proxy._model_config = {"model": "resnet50", "num_classes": 10,
                               "cuts": cuts}
        with pytest.raises(RuntimeError, match="architecture-by-value"):
            proxy.configure(0, None, stage_vars[0])
    finally:
        disp.shutdown()


def test_concurrent_configures_do_not_clobber(shared, tiny):
    g = tiny[0]
    port = shared
    stage_vars = partition(g, TWO_CUTS).extract_variables()
    registry = WorkerRegistry(default_ttl_s=2.0).start()
    proxy = RemoteWorkerProxy("remote-cc", ("127.0.0.1", port), registry,
                              queue.Queue(), model_config=RECIPE, fault=FAULT)
    errors = []

    def cfg(stage):
        try:
            proxy.configure(stage, None, stage_vars[stage])
        except Exception as e:  # noqa: BLE001
            errors.append((stage, e))

    try:
        proxy.start()
        threads = [threading.Thread(target=cfg, args=(s,)) for s in (1, 1, 0)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
        assert not errors, errors
        assert proxy.is_configured(0) and proxy.is_configured(1)
    finally:
        proxy.stop()
        registry.stop()


def test_stalled_peer_send_times_out_and_drops_the_link():
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    accepted = []
    t = threading.Thread(target=lambda: accepted.append(srv.accept()[0]),
                         daemon=True)
    t.start()
    registry = WorkerRegistry(default_ttl_s=5.0).start()
    proxy = RemoteWorkerProxy(
        "remote-stall", srv.getsockname(), registry, queue.Queue(),
        model_config={}, fault=FaultConfig(startup_wait_s=5.0,
                                           send_timeout_s=1.0))
    try:
        proxy.start()
        proxy._sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
        big = torch.zeros(4 << 20, dtype=torch.uint8)
        with pytest.raises((ConnectionError, TimeoutError)):
            for i in range(8):
                proxy.submit(Task(request_id=i, stage_index=0, attempt=0,
                                  payload=big))
        assert proxy.state is WorkerState.DEAD
        assert "remote-stall" not in registry.alive()
        assert proxy.queue_depth == 0  # the failed submit is uncounted
    finally:
        proxy.stop()
        registry.stop()
        for c in accepted:
            c.close()
        srv.close()


# -- the gateway ---------------------------------------------------------------


def _raw_hello(port, worker_id, secret=None):
    """("ack", open socket) when the gateway lets the joiner in, else
    ("rejected", reason)."""
    info = {"worker_id": worker_id}
    if secret is not None:
        info["secret"] = secret
    conn = socket.create_connection(("127.0.0.1", port), timeout=5.0)
    send_msg(conn, Message(MSG_HELLO, 0, 0, 0, json.dumps(info).encode()))
    conn.settimeout(5.0)
    try:
        recv_msg(conn, retry_on_timeout=False)
    except Exception as e:  # noqa: BLE001 — a closed link is a rejection
        conn.close()
        return "rejected", str(e)
    return "ack", conn


def test_gateway_join_then_only_the_joiner_serves(spawn, tiny):
    g, x, ref, _ = tiny
    cfg = ServeConfig(fault=FAULT, codec=CodecConfig(name="lz"))
    pipe = ServingPipeline(partition(g, TWO_CUTS), None, devices=["cpu"],
                           config=cfg, gateway_model_config=RECIPE)
    try:
        pipe.start()
        assert pipe.gateway_port
        spawn.python("-m", "adapt_tpu_torch.comm.remote", "--connect",
                     f"127.0.0.1:{pipe.gateway_port}", "--worker-id",
                     "joiner-0", "--device", "cpu", "--heartbeat", "0.2")
        _poll(lambda: "joiner-0" in pipe.registry.alive(), "the join")
        pipe.kill_worker(0, "crash")
        _poll(lambda: "worker-0" not in pipe.registry.alive(),
              "the local worker's eviction")
        outs = pipe.stream([x] * 3, timeout_per_request=WAIT_S)
        assert all(torch.equal(y, ref) for y in outs)
        assert pipe.gateway.proxies[0].results_received >= 6
    finally:
        pipe.shutdown()


def test_gateway_rejects_a_live_duplicate_id_and_a_bad_secret(tiny):
    disp = Dispatcher(partition(tiny[0], TWO_CUTS), None, config=CFG)
    local = disp.spawn_workers(["cpu"])
    gateway = WorkerGateway(disp, RECIPE, secret="open-sesame",
                            result_device="cpu")
    try:
        disp.start()
        gateway.start()
        assert _raw_hello(gateway.port, "mallory")[0] == "rejected"
        assert _raw_hello(gateway.port, "mallory", "guess")[0] == "rejected"
        assert "mallory" not in disp.registry.alive()
        live = local[0].worker_id
        assert _raw_hello(gateway.port, live, "open-sesame")[0] == "rejected"
        assert live in disp.registry.alive()
        status, conn = _raw_hello(gateway.port, "joiner-x", "open-sesame")
        assert status == "ack"
        try:
            _poll(lambda: "joiner-x" in disp.registry.alive(), "the join")
        finally:
            conn.close()
    finally:
        gateway.stop()
        disp.shutdown()


# -- chain forwarding ----------------------------------------------------------


def _chain(pool, g, n=3):
    cuts = vit_block_cuts(4, n)
    plan = partition(g, cuts)
    disp = Dispatcher(plan, None, config=CFG)
    proxies = [_proxy(disp, f"chain-{i}", pool.worker()[1],
                      model_config={**RECIPE, "cuts": cuts})
               for i in range(n)]
    for p in proxies:
        disp.attach_worker(p)
    return disp, proxies


def test_chain_bypasses_the_hub_then_falls_back_exactly_once(pool, tiny):
    g, x, ref, _ = tiny
    disp, proxies = _chain(pool, g)
    disp.spawn_workers(["cpu"])  # the hub's fallback capacity
    try:
        disp.start()
        order = disp.setup_chain([p.worker_id for p in proxies])
        assert order == ["chain-0", "chain-1", "chain-2"]
        outs = disp.serve_stream([x] * 4, timeout_per_request=WAIT_S)
        assert all(torch.equal(y, ref) for y in outs)
        assert [p.results_received for p in proxies] == [0, 0, 4]
        # The tail's results were never counted on its link.
        assert [p.queue_depth for p in proxies] == [0, 0, 0]
        futures = [disp.submit(x) for _ in range(6)]
        proxies[1].kill("crash")
        outs = [f.result(WAIT_S) for f in futures]
        assert all(torch.equal(y, ref) for y in outs)
        _poll(lambda: disp._chain is None, "the chain's disable")
        assert sorted(f.request_id for f in futures) == list(range(4, 10))
    finally:
        disp.shutdown()


def test_chain_refuses_in_process_workers(tiny):
    disp = Dispatcher(partition(tiny[0], TWO_CUTS), None, config=CFG)
    workers = disp.spawn_workers(["cpu", "cpu"])
    disp.start()
    try:
        with pytest.raises(TypeError, match="cannot chain"):
            disp.setup_chain([w.worker_id for w in workers])
    finally:
        disp.shutdown()


def test_a_submit_into_a_dead_link_is_re_dispatched_not_failed(tiny):
    """A worker whose link dies as a task is sent (a SIGKILLed process the
    registry has not evicted yet): the request goes to another worker and
    completes once; it does not fail."""
    g, x, ref, _ = tiny
    disp = Dispatcher(partition(g, TWO_CUTS), None, config=CFG)
    disp.spawn_workers(["cpu"])

    class DeadLink:
        worker_id, device, queue_depth = "dead-link", None, 0
        state = WorkerState.IDLE

        def start(self):
            disp.registry.register(self.worker_id)
            return self

        def stop(self):
            pass

        def is_configured(self, stage_index):
            return True  # ranks first, as a warm worker does

        def submit(self, task):
            disp.registry.deregister(self.worker_id)  # the link drop
            raise ConnectionResetError(104, "Connection reset by peer")

    disp.attach_worker(DeadLink())
    try:
        disp.start()
        outs = disp.serve_stream([x] * 3, timeout_per_request=WAIT_S)
        assert all(torch.equal(y, ref) for y in outs)
    finally:
        disp.shutdown()


# -- the in-flight count -------------------------------------------------------


def test_only_counted_submits_decrement_the_in_flight_count():
    a, b = socket.socketpair()
    registry = WorkerRegistry(default_ttl_s=5.0).start()
    proxy = RemoteWorkerProxy("counted", ("127.0.0.1", 1), registry,
                              queue.Queue(), model_config={}, fault=FAULT,
                              sock=a, result_device="cpu")
    drain = threading.Thread(target=lambda: [recv_msg(b) for _ in range(2)],
                             daemon=True)
    try:
        proxy.start()
        drain.start()
        x = torch.ones(2, 2)
        proxy.submit(Task(request_id=1, stage_index=0, attempt=0, payload=x))
        proxy.submit(Task(request_id=2, stage_index=0, attempt=0, payload=x,
                          chained=True))
        assert proxy.queue_depth == 1
        frame = TC.pack_frames(TC.get_codec("none"), x)
        # A chain-tail result for a request this link did not count.
        send_msg(b, Message(MSG_RESULT, 2, 2, 0, frame))
        send_msg(b, Message(MSG_RESULT, 0, 1, 1, frame))  # stale attempt
        _poll(lambda: proxy.results_received == 2, "two results")
        assert proxy.queue_depth == 1
        send_msg(b, Message(MSG_RESULT, 0, 1, 0, frame))
        _poll(lambda: proxy.queue_depth == 0, "the counted decrement")
    finally:
        proxy.stop()
        registry.stop()
        b.close()


# -- the journal ---------------------------------------------------------------


def test_recover_from_the_journal_with_live_remote_workers(pool, tiny,
                                                           tmp_path):
    g, x, ref, _ = tiny
    plan = partition(g, TWO_CUTS)
    root = str(tmp_path / "journal")
    journal = DispatcherJournal(root)
    disp = Dispatcher(plan, None, config=CFG, journal=journal)
    for i in range(2):
        disp.attach_worker(_proxy(disp, f"jw-{i}", pool.worker()[1]))
    disp_b = None
    try:
        disp.start()
        disp.warmup(x)
        futures = [disp.submit(x) for _ in range(4)]
        assert torch.equal(futures[0].result(WAIT_S), ref)
        disp.hard_stop()
        all_ids = {f.request_id for f in futures}
        raced = [max(all_ids) + 1, max(all_ids) + 2]
        for rid in raced:  # accepted, never dispatched
            journal.record_submit(rid, x)
        journal.close()
        _, pending_at_crash, _ = DispatcherJournal(root).load()
        assert set(raced) <= set(pending_at_crash) <= all_ids | set(raced)
        disp_b, recovered = Dispatcher.recover(
            plan, None, DispatcherJournal(root), config=CFG,
            result_device="cpu")
        assert {"jw-0", "jw-1"} <= set(disp_b.registry.alive())
        assert set(recovered) == set(pending_at_crash)
        for fut in recovered.values():
            assert torch.equal(fut.result(WAIT_S), ref)
        fut = disp_b.submit(x)
        assert fut.request_id > max(raced)
        assert torch.equal(fut.result(WAIT_S), ref)
        # A done mark follows its future's completion (the WAL's
        # at-least-once window).
        _poll(lambda: not disp_b._journal.pending_ids(), "the done marks")
    finally:
        if disp_b is not None:
            disp_b.shutdown()
    assert DispatcherJournal(root).load()[1] == {}


def test_journal_dir_without_journaled_workers_warns(tiny, tmp_path,
                                                    monkeypatch):
    seen = []
    monkeypatch.setattr(pipeline_mod.log, "warning",
                        lambda msg, *a: seen.append(msg % a))
    with ServingPipeline(partition(tiny[0], TWO_CUTS), None, ["cpu"],
                         CFG, journal_dir=str(tmp_path / "j")) as pipe:
        assert torch.equal(pipe.infer(tiny[1]), tiny[2])
    assert any("no journaled" in m for m in seen)


# -- the worker process --------------------------------------------------------


def test_a_worker_process_imports_no_jax(spawn):
    code = ("import sys; from adapt_tpu_torch.comm.remote import "
            "RemoteStageServer; s = RemoteStageServer(device='cpu'); "
            "s._plan_for({'model': 'vit_tiny', 'num_classes': 10, "
            "'cuts': ['encoder_block_1']}); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'ml_dtypes', 'adapt_tpu')))")
    proc = spawn.python("-c", code)
    out, _ = proc.communicate(timeout=WAIT_S)
    assert proc.returncode == 0 and out.strip() == "[]"


def test_building_a_report_never_delays_a_ping(monkeypatch):
    """A report held mid-collect does not hold up the pings that keep the
    worker's lease: pings keep arriving on the dispatcher link while it is
    held, and the report follows once it is done."""
    from adapt_tpu_torch.comm.framing import (
        MSG_CONFIG,
        MSG_PING,
        MSG_TELEMETRY,
    )
    from adapt_tpu_torch.utils.telemetry import TelemetryReporter

    entered, release = threading.Event(), threading.Event()
    collect = TelemetryReporter.collect

    def held(self):
        entered.set()
        release.wait(WAIT_S)
        return collect(self)

    monkeypatch.setattr(TelemetryReporter, "collect", held)
    server = RemoteStageServer(device="cpu", heartbeat_s=0.02,
                               telemetry_s=0.02)
    port = server.listen()
    threading.Thread(target=server.serve_forever, daemon=True).start()
    conn = socket.create_connection(("127.0.0.1", port), timeout=5.0)
    conn.settimeout(None)
    frames: queue.Queue = queue.Queue()

    def read():
        try:
            while True:
                frames.put(recv_msg(conn).msg_type)
        except (ConnectionError, OSError):
            pass

    threading.Thread(target=read, daemon=True).start()
    seen: list = []

    def drained(kind, n):
        while not frames.empty():
            seen.append(frames.get())
        return seen.count(kind) >= n

    try:
        # A configure header makes this link the dispatcher link.
        send_msg(conn, Message(MSG_CONFIG, 0, 1, 0, b"{}"))
        _poll(entered.is_set, "a report being built")
        drained(MSG_PING, 0)
        seen.clear()
        _poll(lambda: drained(MSG_PING, 3), "pings while a report is held")
        assert MSG_TELEMETRY not in seen
        release.set()
        _poll(lambda: drained(MSG_TELEMETRY, 1), "the held report")
    finally:
        release.set()
        conn.close()
        server.shutdown()


def test_nonzero_telemetry_names_item_9(capsys, shared):
    """Telemetry reports are served: a server takes a non-zero cadence
    (the JAX package's default, 2 s), a negative one is refused, and a
    pool worker (started at that default) pushes reports that the proxy
    folds into the process-global store under the lease's worker id."""
    from adapt_tpu_torch.utils.telemetry import global_federated_store

    assert RemoteStageServer(device="cpu").telemetry_s == 2.0
    with pytest.raises(SystemExit) as exit_info:
        remote_main(["--port", "0", "--device", "cpu", "--telemetry-s",
                     "-1"])
    assert exit_info.value.code != 0
    assert "--telemetry-s" in capsys.readouterr().err
    plan = partition(vit_tiny(device="cpu"), TWO_CUTS)
    disp = Dispatcher(plan, None, config=CFG)
    proxy = _proxy(disp, "remote-telemetry", shared)
    disp.attach_worker(proxy)
    store = global_federated_store()

    def reported():
        return any(s["role"] == "stage" and s["worker"] == "remote-telemetry"
                   for s in store.sources().values())

    try:
        disp.start()
        proxy.configure(1, None, plan.extract_variables()[1])
        _poll(reported, "a telemetry report from the pool worker")
    finally:
        disp.shutdown()
