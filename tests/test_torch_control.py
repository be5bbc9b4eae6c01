"""The port's serving control plane on CPU workers: membership
(``control/registry.py``), stage workers (``control/worker.py``), the
late-binding dispatcher with its watchdog (``control/dispatcher.py``) and
the two pipelines (``runtime/pipeline.py``), mirroring the JAX package's
``tests/test_control.py`` (its journal, chain and codec tests are the
port's ``test_torch_comm.py`` and ``test_torch_remote.py``).

The tests assert outcomes — every request completes exactly once with the
right value, counters, worker states — not tight wall-clock times. Fault
timings are the JAX tests' or larger, recovery is held to the JAX
package's budget of 10 x (task deadline + lease TTL), and every wait is
bounded, so no test can hang the suite. The graft scenario (a 3-stage
``vit_tiny`` on 4 workers, 16 requests, a crash at request 5 and a hang at
request 9) also holds the port's ``graph.apply`` to the JAX package's on
the same weights (``convert.vit_from_flax``) at ``atol = rtol = 1e-5``,
and every served result to that ``graph.apply`` bit for bit."""

import dataclasses
import importlib
import queue
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapt_tpu_torch.config import CodecConfig, FaultConfig, ServeConfig
from adapt_tpu_torch.control.dispatcher import Dispatcher, RequestFailed
from adapt_tpu_torch.control.registry import WorkerRegistry, weak_watch
from adapt_tpu_torch.control.worker import StageWorker, WorkerState
from adapt_tpu_torch.convert import vit_from_flax
from adapt_tpu_torch.core.mesh import MeshSpec, stage_devices
from adapt_tpu_torch.core.stage import compile_stages
from adapt_tpu_torch.graph.ir import INPUT, Lambda, LayerGraph
from adapt_tpu_torch.graph.partition import partition
from adapt_tpu_torch.models.layers import Dense, init_weights
from adapt_tpu_torch.models.vit import vit_tiny
from adapt_tpu_torch.runtime import pipeline as pipeline_mod
from adapt_tpu_torch.runtime.pipeline import LocalPipeline, ServingPipeline
from adapt_tpu_torch.utils.metrics import global_metrics

JV = importlib.import_module("adapt_tpu.models.vit")

CPU = ["cpu"] * 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def chain_graph(width=8, depth=4):
    g = LayerGraph("chain")
    prev = INPUT
    for i in range(depth):
        prev = g.add(f"dense{i}", Dense(width, width, device="cpu"), prev)
    g.add("head", Lambda(lambda x: x * 2.0, "double"), prev)
    return init_weights(g, 0)


@pytest.fixture
def small_model():
    g = chain_graph()
    plan = partition(g, ["dense0", "dense2"])  # 3 stages
    return g, plan, torch.ones(2, 8)


def oracle(g, x):
    with torch.no_grad():
        return g.apply(x)


FAST_FAULT = FaultConfig(
    lease_ttl_s=0.6,
    heartbeat_s=0.1,
    task_deadline_s=1.5,
    watchdog_period_s=0.05,
    startup_wait_s=5.0,
)


# -- registry ---------------------------------------------------------------


def test_registry_lease_expiry():
    reg = WorkerRegistry(default_ttl_s=0.3, reap_period_s=0.02).start()
    events = []
    reg.watch(lambda ev, w: events.append((ev, w)))
    try:
        reg.register("w0")
        assert reg.alive() == ["w0"]
        for _ in range(5):  # heartbeats keep it past one TTL
            time.sleep(0.05)
            assert reg.heartbeat("w0")
        assert reg.alive() == ["w0"]
        deadline = time.monotonic() + 10.0  # stop heartbeating: reaped
        while ("leave", "w0") not in events and time.monotonic() < deadline:
            time.sleep(0.02)
        assert reg.alive() == [] and ("leave", "w0") in events
        assert not reg.heartbeat("w0")  # a reaped lease cannot renew
        assert ("join", "w0") in events
    finally:
        reg.stop()


def test_registry_bounded_startup_wait():
    reg = WorkerRegistry().start()
    try:
        t0 = time.monotonic()
        assert not reg.wait_for_workers(1, timeout_s=0.3)
        assert time.monotonic() - t0 >= 0.25
    finally:
        reg.stop()


def test_registry_lease_tokens_protect_replacement():
    reg = WorkerRegistry(default_ttl_s=5.0)
    old_token = reg.register("w", ttl_s=5.0)
    new_token = reg.register("w", ttl_s=5.0)  # a replacement takes the id
    assert new_token != old_token
    reg.deregister("w", token=old_token)  # the stale holder dies late
    assert "w" in reg.alive(), "stale deregister evicted the replacement"
    reg.deregister("w", token=new_token)
    assert "w" not in reg.alive()
    reg.register("w2")
    reg.deregister("w2")  # tokenless deregister stays unconditional
    assert "w2" not in reg.alive()


def test_registry_roles_and_weak_watch():
    reg = WorkerRegistry(default_ttl_s=5.0)
    reg.register("a")
    reg.register("p", meta={"role": "prefill"})
    assert sorted(reg.alive()) == ["a", "p"]
    assert reg.alive(role="prefill") == ["p"] and reg.alive_untagged() == ["a"]

    class Sub:
        _retired = False

        def __init__(self):
            self.seen = []

        def on(self, event, key):
            self.seen.append((event, key))

    sub = Sub()
    weak_watch(reg, sub, "on")
    reg.register("b")
    sub._retired = True
    reg.register("c")
    assert sub.seen == [("join", "b")]


def test_registry_meta_is_a_copy_of_the_lease_metadata():
    """``meta(worker_id)``: the lease's metadata as registered, a copy
    (mutating it leaves the registry's), ``{}`` for an unknown id; a
    re-registration replaces it. The same reads as the JAX registry's."""
    from adapt_tpu.control.registry import WorkerRegistry as JaxRegistry

    for reg in (WorkerRegistry(default_ttl_s=5.0),
                JaxRegistry(default_ttl_s=5.0)):
        reg.register("w0", meta={"role": "prefill", "addr": "h:1"})
        got = reg.meta("w0")
        assert got == {"role": "prefill", "addr": "h:1"}
        got["role"] = "decode"
        assert reg.meta("w0")["role"] == "prefill"
        assert reg.meta("nobody") == {}
        reg.register("w0", meta={"addr": "h:2"})
        assert reg.meta("w0") == {"addr": "h:2"} and reg.role("w0") is None


# -- the static pipeline ----------------------------------------------------


def test_local_pipeline_matches_model_and_keeps_order(small_model):
    g, plan, x = small_model
    pipe = LocalPipeline(plan, devices=["cpu"] * 3)
    assert torch.equal(pipe.infer(x), oracle(g, x))
    inputs = [torch.full((2, 8), float(i)) for i in range(12)]
    outputs = pipe.stream(inputs)
    assert len(outputs) == 12
    for xi, y in zip(inputs, outputs):
        assert torch.equal(y, oracle(g, xi))
    outs, dt = pipe.throughput([])
    assert outs == [] and dt >= 0


def test_local_pipeline_hop_transform(small_model):
    g, plan, x = small_model
    calls = []

    def hop(a, stage_index):
        calls.append(stage_index)
        return a.clone()  # a host round trip, as a codec would make

    pipe = LocalPipeline(plan, devices="cpu", hop_transform=hop)
    assert torch.equal(pipe.infer(x), oracle(g, x))
    assert calls == [0, 1, 2]
    calls.clear()
    outs = pipe.stream([x, x])
    assert len(outs) == 2 and sorted(calls) == [0, 0, 1, 1, 2, 2]
    assert pipe.from_config(plan, None, "cpu", ServeConfig()).hop_transform \
        is None


def test_stream_surfaces_stage_error_without_leaking_threads(small_model):
    g, plan, x = small_model
    pipe = LocalPipeline(plan, devices="cpu")
    with pytest.raises(RuntimeError, match="stage 0 failed"):
        pipe.stream([torch.ones(2, 5)])  # wrong feature dim
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="failed during stream"):
        pipe.stream([x] * 2 + [torch.ones(2, 5)] + [x] * 50)
    deadline = time.monotonic() + 5.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_stream_on_one_device_runs_in_the_callers_thread(small_model,
                                                       monkeypatch):
    g, plan, x = small_model
    pipe = LocalPipeline(plan, devices="cpu")

    def no_thread(*a, **k):
        raise AssertionError("stream on one device started a thread")

    monkeypatch.setattr(pipeline_mod.threading, "Thread", no_thread)
    outs = pipe.stream([x, 2 * x])
    assert torch.equal(outs[0], oracle(g, x))
    assert torch.equal(outs[1], oracle(g, 2 * x))


def test_threaded_stream_keeps_order_and_surfaces_errors(small_model):
    """The thread-per-stage path (across devices or with a hop transform),
    driven directly on one CPU device."""
    g, plan, x = small_model
    pipe = LocalPipeline(plan, devices=["cpu"] * 3)
    inputs = [torch.full((2, 8), float(i)) for i in range(12)]
    outputs = pipe._threaded_stream(inputs)
    assert len(outputs) == 12
    for xi, y in zip(inputs, outputs):
        assert torch.equal(y, oracle(g, xi))
    with pytest.raises(RuntimeError, match="stage 0 failed"):
        pipe._threaded_stream([torch.ones(2, 5)])
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="failed during stream"):
        pipe._threaded_stream([x] * 2 + [torch.ones(2, 5)] + [x] * 50)
    deadline = time.monotonic() + 5.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_compile_stages_and_rebind(small_model):
    g, plan, x = small_model
    stages = compile_stages(plan, None, stage_devices(3, ["cpu"]))
    y = x
    for s in stages:
        y = s(y)
    assert torch.equal(y, oracle(g, x))
    svars = plan.extract_variables()
    module = stages[1].module
    moved = stages[1].rebind("cpu", svars[1])
    assert moved.module is module  # weights moved, nothing built
    assert torch.equal(stages[2](moved(stages[0](x))), oracle(g, x))
    assert MeshSpec((("dp", 2), ("pp", 4))).num_devices == 8
    with pytest.raises(ValueError, match="no devices"):
        compile_stages(plan, None, [])


def test_entry_points_need_a_card_or_the_cpu(small_model):
    """Without ``devices``, the pipelines and the model factories run on
    the CUDA card: with none they raise, never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    g, plan, _ = small_model
    for make in (lambda: LocalPipeline(plan),
                 lambda: ServingPipeline(plan),
                 lambda: vit_tiny(),
                 lambda: stage_devices(3)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_remote_only_parts_raise_and_name_their_step(small_model):
    """The parts that once refused now serve: ``serve_observability``
    starts the process exporter (its fleet views included), and a stage
    server takes a telemetry cadence (a negative one raises). The worker
    processes' reports are held to the JAX package's in
    ``test_torch_telemetry.py``; the codecs are named and checked."""
    import json
    import urllib.request

    from adapt_tpu_torch.comm.remote import RemoteStageServer

    g, plan, x = small_model
    with ServingPipeline(plan, None, CPU, ServeConfig(fault=FAST_FAULT)) as p:
        assert torch.equal(p.infer(x), oracle(g, x))
        server = p.serve_observability()
        try:
            port = server.server_address[1]
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
                assert "adapt_dispatcher_completed_total" in r.read().decode()
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/fleet/metrics.json",
                    timeout=10) as r:
                assert "merged" in json.loads(r.read().decode())
        finally:
            server.shutdown()
            server.server_close()
    assert RemoteStageServer(device="cpu", telemetry_s=2.0).telemetry_s == 2.0
    with pytest.raises(ValueError, match="telemetry_s"):
        RemoteStageServer(device="cpu", telemetry_s=-1.0)
    assert CodecConfig(name="int8dev").name == "int8dev"
    with pytest.raises(ValueError, match="expected one of"):
        CodecConfig(name="lz4")


# -- the adaptive pipeline ----------------------------------------------------


def test_serving_pipeline_basic(small_model):
    g, plan, x = small_model
    global_metrics().reset()
    with ServingPipeline(plan, None, CPU, ServeConfig(fault=FAST_FAULT)) as p:
        assert torch.equal(p.infer(x), oracle(g, x))
        outs = p.stream([x] * 8)
        assert len(outs) == 8 and all(torch.equal(o, oracle(g, x))
                                      for o in outs)
    assert global_metrics().counter("dispatcher.completed") == 9


def test_no_workers_clean_shutdown(small_model):
    _, plan, _ = small_model
    cfg = ServeConfig(fault=FaultConfig(startup_wait_s=0.3))
    pipe = ServingPipeline(plan, None, devices=[], config=cfg)
    with pytest.raises(RequestFailed, match="no workers"):
        pipe.start()


def test_crash_recovery_no_lost_requests(small_model):
    """Crash a worker mid-stream: membership eviction re-dispatches its
    in-flight tasks at once, and every request completes correctly."""
    g, plan, _ = small_model
    cfg = ServeConfig(max_inflight=4, fault=FAST_FAULT)
    with ServingPipeline(plan, None, CPU, cfg) as pipe:
        inputs = [torch.full((2, 8), float(i)) for i in range(20)]
        futures = []
        for i, xi in enumerate(inputs):
            futures.append(pipe.dispatcher.submit(xi))
            if i == 5:
                pipe.kill_worker(0, mode="crash")
        results = [f.result(60.0) for f in futures]
        assert pipe.workers[0].state is WorkerState.DEAD
    for xi, y in zip(inputs, results):
        assert torch.equal(y, oracle(g, xi))


def test_hang_recovery_via_watchdog(small_model):
    g, plan, x = small_model
    global_metrics().reset()
    cfg = ServeConfig(max_inflight=2, fault=FAST_FAULT)
    with ServingPipeline(plan, None, ["cpu"] * 3, cfg) as pipe:
        pipe.infer(x)  # configure stages so the hung worker is a candidate
        pipe.kill_worker(1, mode="hang")
        outs = pipe.stream([x] * 6, timeout_per_request=60.0)
        assert pipe.workers[1].state is not WorkerState.DEAD
    assert len(outs) == 6 and all(torch.equal(o, oracle(g, x)) for o in outs)
    assert global_metrics().counter("dispatcher.completed") >= 7


def test_hung_worker_still_scheduled_and_recovered(small_model):
    """Only the victim is configured, so configured-first rank routes the
    first tasks to it after it hangs; probes are off, so recovery can come
    only from the real-task deadline."""
    g, plan, x = small_model
    global_metrics().reset()
    fault = dataclasses.replace(FAST_FAULT, probe_silence_s=600.0)
    cfg = ServeConfig(max_inflight=2, fault=fault)
    with ServingPipeline(plan, None, ["cpu"] * 2, cfg) as pipe:
        victim = pipe.workers[0]
        for s in range(plan.num_stages):
            pipe.dispatcher._configure_with_timeout(victim, s)
        pipe.kill_worker(0, mode="hang")
        assert victim.state is not WorkerState.DEAD
        outs = pipe.stream([x] * 4, timeout_per_request=60.0)
    assert len(outs) == 4 and all(torch.equal(o, oracle(g, x)) for o in outs)
    assert global_metrics().counter("dispatcher.redispatched") >= 1


def test_all_workers_dead_fails_requests(small_model):
    _, plan, x = small_model
    cfg = ServeConfig(fault=FaultConfig(
        lease_ttl_s=0.3, heartbeat_s=0.1, task_deadline_s=0.5,
        watchdog_period_s=0.05, startup_wait_s=2.0, max_retries=2))
    with ServingPipeline(plan, None, ["cpu"] * 2, cfg) as pipe:
        pipe.infer(x)
        for w in pipe.workers:
            w.kill("crash")
        deadline = time.monotonic() + 10.0
        while pipe.registry.alive() and time.monotonic() < deadline:
            time.sleep(0.02)
        with pytest.raises(RequestFailed):
            pipe.dispatcher.submit(x).result(20.0)


def test_exactly_once_under_redispatch(small_model):
    """A late result from a presumed-dead attempt completes nothing twice:
    completions equal submissions exactly."""
    g, plan, x = small_model
    global_metrics().reset()
    cfg = ServeConfig(max_inflight=8, fault=FAST_FAULT)
    with ServingPipeline(plan, None, CPU, cfg) as pipe:
        pipe.infer(x)
        pipe.kill_worker(2, mode="hang")
        outs = pipe.stream([x] * 10, timeout_per_request=60.0)
        pipe.workers[2].revive()  # its swallowed tasks stay dropped
        time.sleep(0.3)
    assert len(outs) == 10 and all(torch.equal(o, oracle(g, x)) for o in outs)
    counters = global_metrics().snapshot()["counters"]
    assert counters.get("dispatcher.completed", 0) == 11  # warmup + 10
    assert counters.get("dispatcher.failed", 0) == 0


def test_single_error_budget_allows_retries(small_model):
    """With max_retries=1 a request that lands on a hung worker still
    completes within its single retry."""
    g, plan, x = small_model
    cfg = ServeConfig(fault=dataclasses.replace(FAST_FAULT, max_retries=1))
    with ServingPipeline(plan, None, ["cpu"] * 2, cfg) as pipe:
        pipe.infer(x)
        pipe.kill_worker(0, mode="hang")
        outs = pipe.stream([x] * 4, timeout_per_request=60.0)
    assert len(outs) == 4


def test_shutdown_fails_pending_futures(small_model):
    _, plan, x = small_model
    pipe = ServingPipeline(plan, None, ["cpu"] * 3,
                           ServeConfig(fault=FAST_FAULT))
    pipe.start()
    pipe.infer(x)
    for w in pipe.workers:
        w.kill("hang")  # requests will never complete
    f = pipe.dispatcher.submit(x)
    pipe.shutdown()
    t0 = time.monotonic()
    with pytest.raises(RequestFailed, match="shut down|retries|no live"):
        f.result(10.0)
    assert time.monotonic() - t0 < 5.0  # prompt failure, not a timeout


def test_warmup_builds_every_stage_worker_module_once(small_model):
    """warmup builds a module for each (stage, worker) pair; a failover
    afterwards moves weights and builds none (the port's form of "a
    failover is a jit cache hit")."""
    g, plan, x = small_model
    global_metrics().reset()
    with ServingPipeline(plan, None, CPU, ServeConfig(fault=FAST_FAULT)) as p:
        p.warmup(x)
        assert p.dispatcher.stage_builds == 3 * 4
        assert global_metrics().counter("dispatcher.stage_builds") == 12
        p.kill_worker(0)
        for _ in range(6):
            assert torch.equal(p.infer(x, timeout=30.0), oracle(g, x))
        assert p.dispatcher.stage_builds == 12, "failover built a stage"


def test_concurrent_configures_of_one_pair_build_once(small_model):
    g, plan, x = small_model
    disp = Dispatcher(plan, config=ServeConfig(fault=FAST_FAULT))
    w = disp.spawn_workers(["cpu"])[0]
    errors = []

    def cfg():
        try:
            disp._configure_with_timeout(w, 1)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=cfg) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors and w.is_configured(1)
    assert disp.stage_builds == 1


def test_hung_worker_quarantined_after_strikes_then_heals(small_model):
    """A hang (heartbeats alive, tasks swallowed) is quarantined after
    ``quarantine_strikes`` missed deadlines (real tasks, then canary
    probes once rank routes traffic away); a revived worker's answered
    probe lifts the quarantine."""
    g, plan, x = small_model
    config = ServeConfig(fault=FaultConfig(
        lease_ttl_s=5.0, heartbeat_s=0.1, task_deadline_s=0.5,
        watchdog_period_s=0.05, startup_wait_s=5.0, max_retries=4,
        quarantine_strikes=2))
    with ServingPipeline(plan, None, ["cpu"] * 3, config) as pipe:
        pipe.warmup(x)
        victim = pipe.workers[0]
        victim.kill("hang")
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            y = pipe.infer(x, timeout=60.0)
            with pipe.dispatcher._health_lock:
                if victim.worker_id in pipe.dispatcher._quarantined:
                    break
        assert torch.equal(y, oracle(g, x))
        with pipe.dispatcher._health_lock:
            assert victim.worker_id in pipe.dispatcher._quarantined
        assert global_metrics().counter("dispatcher.quarantined") >= 1
        assert pipe.dispatcher._acquire(0, exclude=set()).worker_id \
            != victim.worker_id
        victim.revive()
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            with pipe.dispatcher._health_lock:
                if victim.worker_id not in pipe.dispatcher._quarantined:
                    break
            time.sleep(0.05)
        with pipe.dispatcher._health_lock:
            assert victim.worker_id not in pipe.dispatcher._quarantined


def test_timed_out_configure_cannot_install_late_binding():
    """A configure past the handshake timeout is cancelled: when its slow
    weight transfer finally completes, the abort token blocks the install."""
    g = LayerGraph("slowcfg")
    g.add("dense0", Dense(4, 4, device="cpu"), INPUT)
    init_weights(g, 0)
    plan = partition(g, [])
    config = ServeConfig(fault=FaultConfig(configure_timeout_s=0.3,
                                           startup_wait_s=5.0))
    disp = Dispatcher(plan, config=config)
    release = threading.Event()

    class SlowWorker(StageWorker):
        def configure(self, stage_index, module, host_state, spec=None,
                      abort=None):
            release.wait(5.0)  # a weight transfer far past the timeout
            return super().configure(stage_index, module, host_state,
                                     spec=spec, abort=abort)

    w = SlowWorker("slow-0", "cpu", disp.registry, disp.result_queue,
                   config.fault)
    disp.attach_worker(w)
    disp.start()
    try:
        with pytest.raises(RequestFailed, match="timed out|no worker"):
            disp.infer(torch.ones(1, 4), timeout=5.0)
        release.set()
        time.sleep(0.5)
        assert not w.is_configured(0)
    finally:
        release.set()
        disp.shutdown()


def test_unconfigure_generation_scoped(small_model):
    _, plan, _ = small_model
    w = StageWorker("w0", "cpu", WorkerRegistry(), queue.Queue())
    svars = plan.extract_variables()

    def configure():
        return w.configure(0, plan.build_stage(plan.stages[0], "meta"),
                           svars[0])

    gen1 = configure()
    gen2 = configure()  # a newer configure of the same stage
    assert gen2 > gen1
    w.unconfigure(0, gen1)  # a stale revoke is a no-op
    assert w.is_configured(0)
    w.unconfigure(0, gen2)
    assert not w.is_configured(0)
    gen3 = configure()
    assert gen3 > gen2
    w.unconfigure(0)  # unconditional
    assert not w.is_configured(0)


def test_crash_eviction_is_event_driven_hang_is_not():
    """A crashed worker deregisters at once (the lease TTL is only the
    backstop); a hung one keeps heartbeating and keeps its lease."""
    fault = FaultConfig(lease_ttl_s=60.0, heartbeat_s=0.05)
    registry = WorkerRegistry(default_ttl_s=60.0)
    rq: queue.Queue = queue.Queue()
    crash_w = StageWorker("ev-crash", "cpu", registry, rq, fault).start()
    hang_w = StageWorker("ev-hang", "cpu", registry, rq, fault).start()
    try:
        assert set(registry.alive()) >= {"ev-crash", "ev-hang"}
        t0 = time.monotonic()
        crash_w.kill("crash")
        hang_w.kill("hang")
        while "ev-crash" in registry.alive():
            assert time.monotonic() - t0 < 10.0, "no event-driven eviction"
            time.sleep(0.005)
        time.sleep(0.2)
        assert "ev-hang" in registry.alive()
        assert hang_w.state is not WorkerState.DEAD
    finally:
        hang_w.stop()
        crash_w.stop()


# -- the graft scenario --------------------------------------------------------


def test_graft_scenario_vit_tiny_on_cpu_workers():
    """A 3-stage vit_tiny on 4 CPU workers, 16 requests of batch 2, worker
    0 crashed at request 5 and worker 1 hung at request 9: every request
    completes exactly once with ``graph.apply``'s bits, none fails, the
    hung worker is not DEAD, the failover builds no stage module, and the
    last result arrives within 10 x (deadline + lease TTL) of the crash."""
    jg = JV.vit_tiny()
    x = np.random.RandomState(5).randn(2, 32, 32, 3).astype(np.float32)
    variables = jax.device_get(jax.jit(jg.init)(jax.random.PRNGKey(5),
                                                jnp.asarray(x)))
    want_jax = np.asarray(jax.jit(jg.apply)(variables, jnp.asarray(x)))
    g = vit_tiny(device="cpu")
    g.load_state_dict(vit_from_flax(variables))
    xt = torch.from_numpy(x)
    ref = oracle(g, xt)
    np.testing.assert_allclose(ref.numpy(), want_jax, atol=1e-5, rtol=1e-5)
    plan = partition(g, ["encoder_block_0", "encoder_block_2"])
    global_metrics().reset()
    cfg = ServeConfig(max_inflight=8, fault=FaultConfig(
        lease_ttl_s=0.5, heartbeat_s=0.1, task_deadline_s=2.0,
        watchdog_period_s=0.05, startup_wait_s=10.0, max_retries=4,
        quarantine_strikes=2))
    with ServingPipeline(plan, None, CPU, cfg) as pipe:
        pipe.warmup(xt)
        builds = pipe.dispatcher.stage_builds
        futures, t_kill = [], None
        for i in range(16):
            futures.append(pipe.dispatcher.submit(xt))
            if i == 5:
                pipe.kill_worker(0, mode="crash")
                t_kill = time.monotonic()
            elif i == 9:
                pipe.kill_worker(1, mode="hang")
        results = [f.result(120.0) for f in futures]
        recovery_s = time.monotonic() - t_kill
        counters = global_metrics().snapshot()["counters"]
        assert all(torch.equal(y, ref) for y in results)
        assert counters.get("dispatcher.failed", 0) == 0, counters
        assert counters.get("dispatcher.completed", 0) >= 16
        assert pipe.workers[1].state is not WorkerState.DEAD
        assert pipe.dispatcher.stage_builds == builds == 12
        budget = 10 * (cfg.fault.task_deadline_s + cfg.fault.lease_ttl_s)
        assert recovery_s < budget, f"recovery {recovery_s:.2f}s > {budget}s"
