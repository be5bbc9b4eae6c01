"""The port's pipelined tick (``config.RuntimeConfig(pipeline_depth=2)``)
on the CPU: dispatching tick t before committing tick t-1 must not show in
what the batcher emits.

- Greedy streams at depth 2 equal depth 1's, each request alone
  (``generate()``) and the JAX package's batcher at depth 2, on dense
  strips and on the paged pool; a speculative batcher with an int8 draft
  on an int8 pool at depth 2 equals depth 1 and ``generate(kv_cache_dtype=
  "int8")``.
- Paged churn with a shared prefix (pages freed at the commit of tick t-1
  while tick t, already dispatched, still writes that row's tail): depth 2
  equals depth 1, the prefix cache hits, the pool drains.
- A cancel while the victim's tick is in flight; preemption under the
  one-tick lag: streams and ``on_token`` exactly once.
- Steady depth-2 ticks stage nothing host->device and fetch once, with a
  tick in flight; ``drain()`` is idempotent; ``stop()`` drains on the
  server thread; ``runtime.overlap_ratio`` is published."""

import importlib
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapt_tpu_torch.config import (
    RuntimeConfig,
    SchedulerConfig,
    ServeConfig,
    SLOSpec,
    SpeculativeConfig,
)
from adapt_tpu_torch.convert import from_flax
from adapt_tpu_torch.models import transformer_lm as T
from adapt_tpu_torch.runtime.continuous import ContinuousBatcher
from adapt_tpu_torch.utils.metrics import global_metrics
from adapt_tpu_torch.utils.tracing import global_flight_recorder

J = importlib.import_module("adapt_tpu.models.transformer_lm")
JC = importlib.import_module("adapt_tpu.runtime.continuous")
JCfg = importlib.import_module("adapt_tpu.config")

VOCAB, MAX_LEN = 37, 64
RNG = np.random.RandomState(11)
PROMPTS = [RNG.randint(0, VOCAB, size=n) for n in (3, 9, 5, 12, 7)]
STEPS = [20, 4, 8, 3, 6]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lm_setup():
    jlm = J.lm_tiny(vocab=VOCAB, max_len=MAX_LEN)
    variables = jax.device_get(
        jlm.graph.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32)))
    tlm = T.lm_tiny(vocab=VOCAB, max_len=MAX_LEN, device="cpu")
    tlm.load_state_dict(from_flax(variables))
    return jlm, variables, tlm


def _depth(n):
    return RuntimeConfig(pipeline_depth=n)


def _solo(tlm, prompt, steps, **kw):
    return T.generate(tlm, np.asarray(prompt)[None], steps, **kw)[0].numpy()


def _staggered(bat, cancel_idx=None):
    """Two admits, two ticks, three more; optionally a cancel after one
    more tick. Returns {prompt index: tokens}."""
    ids = {bat.submit(PROMPTS[i], STEPS[i]): i for i in range(2)}
    bat.tick()
    bat.tick()
    ids.update({bat.submit(PROMPTS[i], STEPS[i]): i
                for i in range(2, len(PROMPTS))})
    if cancel_idx is not None:
        bat.tick()
        assert bat.cancel(next(r for r, i in ids.items() if i == cancel_idx))
    out = bat.run()
    return {ids[r]: out[r] for r in ids}


def test_runtime_config_validation(lm_setup):
    assert RuntimeConfig().pipeline_depth == 1
    assert ServeConfig().runtime.pipeline_depth == 1
    for bad in (0, 3, -1):
        with pytest.raises(ValueError, match="pipeline_depth"):
            RuntimeConfig(pipeline_depth=bad)
    st = ContinuousBatcher(lm_setup[2], slots=1, runtime=_depth(2)).stats()
    assert st["pipeline_depth"] == 2 and not st["inflight"]


@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_depth2_streams_equal_depth1_generate_and_jax(lm_setup, layout):
    jlm, variables, tlm = lm_setup
    kw = dict(slots=3, chunk=2)
    if layout == "paged":
        kw.update(kv_layout="paged", page_size=8)
    outs = {}
    for depth in (1, 2):
        bat = ContinuousBatcher(tlm, runtime=_depth(depth), **kw)
        outs[depth] = _staggered(bat)
        st = bat.stats()
        assert st["pipeline_depth"] == depth
        assert st["active"] == st["queued"] == 0 and not st["inflight"]
        assert st["admitted"] == st["completed"] == len(PROMPTS)
        bat.close()
    jb = JC.ContinuousBatcher(jlm, variables,
                              runtime=JCfg.RuntimeConfig(pipeline_depth=2),
                              **kw)
    jout = _staggered(jb)
    jb.close()
    for i in range(len(PROMPTS)):
        np.testing.assert_array_equal(outs[2][i], outs[1][i])
        np.testing.assert_array_equal(outs[2][i], jout[i])
        np.testing.assert_array_equal(
            outs[2][i], _solo(tlm, PROMPTS[i], STEPS[i]))


def test_depth2_speculative_int8_equals_depth1(lm_setup):
    """The tiny LM as its own draft, held in int8 weights (K6), on an int8
    paged pool: depth 2 equals depth 1 and generate(int8)."""
    _, _, tlm = lm_setup
    prompts, steps = PROMPTS[:3], [7, 9, 5]
    outs = {}
    for depth in (1, 2):
        bat = ContinuousBatcher(
            tlm, slots=2, kv_cache_dtype="int8", kv_layout="paged",
            page_size=8, draft_lm=tlm, runtime=_depth(depth),
            speculative=SpeculativeConfig(draft_k=3,
                                          draft_weight_dtype="int8"))
        ids = {bat.submit(p, s): i for i, (p, s) in
               enumerate(zip(prompts, steps))}
        out = bat.run()
        assert 0.0 < bat.stats()["spec_acceptance"] <= 1.0
        outs[depth] = {ids[r]: out[r] for r in ids}
        bat.close()
    for i in range(3):
        np.testing.assert_array_equal(outs[2][i], outs[1][i])
        np.testing.assert_array_equal(
            outs[2][i], _solo(tlm, prompts[i], steps[i],
                              kv_cache_dtype="int8"))


def test_depth2_paged_churn_with_a_shared_prefix(lm_setup):
    """Pages released at the commit of tick t-1 are still written by tick
    t's garbage tail for that row; no such write may reach a page that the
    prefix cache or a new admission reads as content. Short requests churn
    through 2 slots of a tight pool, half sharing a 2-page prefix."""
    _, _, tlm = lm_setup
    rng = np.random.RandomState(3)
    prefix = rng.randint(0, VOCAB, 16)
    prompts = [np.concatenate([prefix, rng.randint(0, VOCAB, n)])
               if j % 2 == 0 else rng.randint(0, VOCAB, n)
               for j, n in enumerate((3, 5, 2, 7, 4, 1, 6, 3, 5, 2))]
    steps = [5, 3, 9, 2, 6, 4, 3, 7, 2, 5]
    outs, hits = {}, {}
    for depth in (1, 2):
        bat = ContinuousBatcher(tlm, slots=2, chunk=3, kv_layout="paged",
                                page_size=8, pool_pages=9,
                                runtime=_depth(depth))
        ids = {}
        for j, (p, s) in enumerate(zip(prompts, steps)):
            ids[bat.submit(p, s)] = j
            if j % 3 == 2:
                bat.tick()
        out = bat.run()
        st = bat.stats()
        assert st["pages_in_use"] == 0 and not st["inflight"]
        outs[depth] = {ids[r]: out[r] for r in ids}
        hits[depth] = st["prefix_hits"]
        bat.close()
    assert hits[1] > 0 and hits[2] > 0
    for j in range(len(prompts)):
        np.testing.assert_array_equal(outs[2][j], outs[1][j])
        np.testing.assert_array_equal(outs[2][j],
                                      _solo(tlm, prompts[j], steps[j]))


def test_depth2_cancel_mid_flight(lm_setup):
    _, _, tlm = lm_setup
    got = []
    bat = ContinuousBatcher(tlm, slots=2, chunk=2, runtime=_depth(2))
    r0 = bat.submit(PROMPTS[0], STEPS[0],
                    on_token=lambda rid, tok, idx: got.append((tok, idx)))
    r1 = bat.submit(PROMPTS[1], STEPS[1])
    bat.tick()
    bat.tick()  # r0's decode results ride the one-tick lag
    assert bat.stats()["inflight"]
    assert bat.cancel(r0)
    out = bat.run()
    solo = _solo(tlm, PROMPTS[0], STEPS[0])
    assert 0 < len(out[r0]) < STEPS[0]
    np.testing.assert_array_equal(out[r0], solo[:len(out[r0])])
    np.testing.assert_array_equal(out[r1], _solo(tlm, PROMPTS[1], STEPS[1]))
    assert [i for _, i in got] == list(range(len(out[r0])))
    assert [t for t, _ in got] == out[r0].tolist()
    st = bat.stats()
    assert st["admitted"] == st["completed"] == 2
    assert st["active"] == 0 and not st["inflight"]


@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_depth2_steady_ticks_stage_nothing_and_drain(lm_setup, layout):
    _, _, tlm = lm_setup
    extra = dict(kv_layout="paged", page_size=8) if layout == "paged" else {}
    global_metrics().reset()
    bat = ContinuousBatcher(tlm, slots=2, chunk=2, runtime=_depth(2),
                            **extra)
    r1 = bat.submit(np.asarray([1, 2, 3]), 30)
    bat.tick()
    bat.tick()
    before = bat.stats()
    for _ in range(4):
        assert bat.tick() == 1  # each call commits the tick before it
        assert bat.stats()["inflight"]
        assert bat._inflight.fetch.ready()  # the CPU fetch is synchronous
    after = bat.stats()
    assert after["h2d_transfers"] == before["h2d_transfers"]
    assert after["d2h_fetches"] - before["d2h_fetches"] == 4
    ratio = global_metrics().snapshot()["gauges"]["runtime.overlap_ratio"]
    assert 0.0 <= ratio <= 1.0
    r2 = bat.submit(np.asarray([5, 6]), 3)
    out = bat.run()
    assert not bat.stats()["inflight"]
    assert bat.drain() == 0 and bat.drain() == 0
    r3 = bat.submit(np.asarray([9, 9, 9, 9]), 5)
    bat.tick()
    bat.tick()
    assert bat.stats()["inflight"]
    bat.drain()
    assert not bat.stats()["inflight"]
    out.update(bat.run())
    assert set(out) == {r1, r2, r3}
    for r, p, s in ((r1, [1, 2, 3], 30), (r2, [5, 6], 3),
                    (r3, [9, 9, 9, 9], 5)):
        np.testing.assert_array_equal(out[r], _solo(tlm, p, s))


def test_depth2_preemption_exactly_once(lm_setup):
    _, _, tlm = lm_setup
    global_flight_recorder().clear()
    p_low, p_hi = PROMPTS[1], PROMPTS[2]
    bat = ContinuousBatcher(
        tlm, slots=1, chunk=2, kv_layout="paged", page_size=8,
        runtime=_depth(2),
        scheduler=SchedulerConfig(preempt=True, preempt_ttft_fraction=0.5,
                                  degrade=False))
    delivered: dict[int, list] = {}

    def cb(rid, tok, idx):
        delivered.setdefault(rid, []).append((idx, tok))

    low = bat.submit(p_low, 20, on_token=cb,
                     slo=SLOSpec(tenant="free", priority=0))
    for _ in range(3):
        bat.tick()  # committed tokens exist AND a tick is in flight
    assert len(delivered.get(low, [])) > 0 and bat.stats()["inflight"]
    hi = bat.submit(p_hi, 10, on_token=cb,
                    slo=SLOSpec(ttft_budget_s=1e-4, tenant="gold",
                                priority=10))
    out = bat.run()
    st = bat.stats()
    assert st["preempted"] == 1 and st["regen_mismatches"] == 0
    ev = global_flight_recorder().events("preempted")
    assert [e["data"]["request"] for e in ev] == [low]
    for rid, p, n in ((low, p_low, 20), (hi, p_hi, 10)):
        solo = _solo(tlm, p, n)
        np.testing.assert_array_equal(out[rid], solo)
        assert [i for i, _ in delivered[rid]] == list(range(n))
        assert [t for _, t in delivered[rid]] == solo.tolist()
    assert st["admitted"] == st["completed"] + st["preempted"] == 3
    assert st["prefix_hits"] > 0 and not st["inflight"]


def test_depth2_server_thread_drains_on_stop(lm_setup):
    _, _, tlm = lm_setup
    bat = ContinuousBatcher(tlm, slots=2, chunk=2, runtime=_depth(2))
    with bat:
        ids = [bat.submit(PROMPTS[i], STEPS[i]) for i in range(4)]
        got = {r: bat.result(r, timeout=120) for r in ids}
    assert not bat.stats()["inflight"]
    for r, i in zip(ids, range(4)):
        np.testing.assert_array_equal(got[r], _solo(tlm, PROMPTS[i],
                                                    STEPS[i]))
    bat.close()
    bat.close()


def test_depth2_server_under_concurrent_clients(lm_setup):
    """Client threads submit (two tenants, a priority-1 class with a tight
    TTFT budget that preempts) and cancel against a depth-2 server thread,
    with a short switch interval: every accepted request resolves exactly
    once, its result equals ``generate()`` (or, cancelled, a prefix of it),
    and the books balance."""
    _, _, tlm = lm_setup
    global_flight_recorder().clear()
    bat = ContinuousBatcher(
        tlm, slots=3, chunk=2, kv_layout="paged", page_size=8,
        runtime=_depth(2), scheduler=SchedulerConfig(
            max_queue_depth=6, preempt_ttft_fraction=0.5, degrade=False))
    accepted, rejected, cancelled = {}, [0], set()
    lock = threading.Lock()

    def client(seed):
        rng = np.random.RandomState(seed)
        for j in range(6):
            p = rng.randint(0, VOCAB, rng.randint(2, 14))
            steps = int(rng.randint(2, 12))
            slo = SLOSpec(tenant=f"t{seed % 2}", priority=j % 2,
                          ttft_budget_s=1e-3 if j % 2 else None)
            try:
                rid = bat.submit(p, steps, slo=slo)
            except Exception as e:
                assert type(e).__name__ == "QueueFullError"
                with lock:
                    rejected[0] += 1
                continue
            with lock:
                accepted[rid] = (p, steps)
            if j == 3 and bat.cancel(rid):
                with lock:
                    cancelled.add(rid)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with bat:
            threads = [threading.Thread(target=client, args=(s,))
                       for s in range(6)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
            got = {r: bat.result(r, timeout=60) for r in accepted}
    finally:
        sys.setswitchinterval(old)
    st = bat.stats()
    assert len(accepted) + rejected[0] == 36 and st["rejected"] == rejected[0]
    assert st["admitted"] == st["completed"] + st["preempted"]
    queued_cancels = sum(1 for e in global_flight_recorder().events("cancel")
                         if e["data"]["state"] == "queued")
    assert st["completed"] + queued_cancels == len(accepted)
    assert not st["inflight"] and st["active"] == st["queued"] == 0
    for r, (p, steps) in accepted.items():
        solo = _solo(tlm, p, steps)
        if r in cancelled:
            np.testing.assert_array_equal(got[r], solo[:len(got[r])])
        else:
            np.testing.assert_array_equal(got[r], solo)
