"""The port's engine-tier observability (``utils/profiling.py`` and its
wiring into the batcher) against the JAX package's, on the CPU.

The compile sentinel flags post-warmup growth of a watch as a counted,
recorded event; the batcher's memory gauges equal the JAX batcher's for
the same dense and paged configuration and traffic (the page partition
exact mid-flight and after retirement); an exporter scrape races a
ticking batcher; the roofline count equals a count by hand at a tiny
shape, with no utilization on the CPU; the set of ``engine.phase.*``
names and each one's sample count equal the JAX batcher's for the same
traffic at pipeline depth 1; every op's kernel / plain route is booked."""

import importlib
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapt_tpu_torch.convert import from_flax
from adapt_tpu_torch.models import transformer_lm as T
from adapt_tpu_torch.ops import _build
from adapt_tpu_torch.runtime.continuous import ContinuousBatcher
from adapt_tpu_torch.utils import profiling
from adapt_tpu_torch.utils.exporter import serve_metrics
from adapt_tpu_torch.utils.metrics import MetricsRegistry, global_metrics
from adapt_tpu_torch.utils.profiling import (
    CompileSentinel,
    engine_collector,
    global_compile_sentinel,
    global_engine_obs,
    program_work,
    register_memory_source,
)
from adapt_tpu_torch.utils.tracing import global_flight_recorder

J = importlib.import_module("adapt_tpu.models.transformer_lm")
JC = importlib.import_module("adapt_tpu.runtime.continuous")
JP = importlib.import_module("adapt_tpu.utils.profiling")
JMET = importlib.import_module("adapt_tpu.utils.metrics")

VOCAB = 37


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    jlm = J.lm_tiny(vocab=VOCAB, max_len=64)
    v = jax.device_get(jlm.graph.init(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 4), jnp.int32)))
    tlm = T.lm_tiny(vocab=VOCAB, max_len=64, device="cpu")
    tlm.load_state_dict(from_flax(v))
    return jlm, v, tlm


@pytest.fixture
def isolated_memory_sources():
    """Batchers of earlier tests may still be alive: empty the memory and
    roofline source tables for one test."""
    tables = (profiling._MEMORY_SOURCES, profiling._ROOFLINE_SOURCES)
    saved = [dict(t) for t in tables]
    for t in tables:
        t.clear()
    try:
        yield
    finally:
        for t, kept in zip(tables, saved):
            t.clear()
            t.update(kept)


class _Size:
    """A settable size function (a watch's count)."""

    def __init__(self, n=0):
        self.n = n

    def __call__(self):
        return self.n


# -- compile sentinel -------------------------------------------------------


def test_sentinel_flags_growth_only_after_warmup():
    sent = CompileSentinel(warmup_samples=2)
    size = _Size(1)
    sent.register("toy", size_fn=size)
    assert sent.sample() == 0  # baseline
    size.n = 2  # growth inside warmup
    assert sent.sample() == 0 and sent.events == 0
    flight_before = len(global_flight_recorder().events("recompile"))
    counter_before = global_metrics().counter("engine.compile_events")
    size.n = 3
    assert sent.sample() == 1 and sent.events == 1
    assert global_metrics().counter("engine.compile_events") == (
        counter_before + 1)
    ev = global_flight_recorder().events("recompile")
    assert len(ev) == flight_before + 1
    assert ev[-1]["data"]["program"] == "toy" and ev[-1]["data"]["new"] == 1
    assert global_metrics().snapshot()["gauges"]["engine.compiles.toy"] == 3
    assert sent.compiles("toy") == 3
    assert sent.sample() == 0  # stable: no event
    reg2 = MetricsRegistry()  # a later sampler converges to the total
    sent.sample(reg2)
    assert reg2.counter("engine.compile_events") == 1.0
    assert reg2.snapshot()["gauges"]["engine.compiles.toy"] == 3.0


def test_sentinel_idle_scrapes_do_not_burn_warmup():
    sent = CompileSentinel(warmup_samples=2)
    size = _Size(0)
    sent.register("toy", size_fn=size)
    for _ in range(10):
        assert sent.sample() == 0
    size.n = 2
    assert sent.sample() == 0 and sent.events == 0


def test_sentinel_prunes_watch_when_owner_gone():
    sent = CompileSentinel()
    sent.register("gone", size_fn=lambda: 2)
    sent.register("alive", size_fn=lambda: 1)
    reg = MetricsRegistry()
    sent.sample(reg)
    assert "engine.compiles.gone" in reg.snapshot()["gauges"]
    sent.register("gone", size_fn=lambda: None)
    sent.sample(reg)
    assert sent.watched() == ["alive"]
    gauges = reg.snapshot()["gauges"]
    assert "engine.compiles.gone" not in gauges
    assert gauges["engine.compiles.alive"] == 1.0


def test_sentinel_reregister_rearms_warmup_and_disarm_revokes():
    sent = CompileSentinel(warmup_samples=1)
    size = _Size(1)
    sent.register("toy", size_fn=size)
    sent.sample()
    sent.sample()  # warmed
    sent.register("toy", size_fn=size)  # a fresh owner's constructor
    size.n = 2
    assert sent.sample() == 0 and sent.events == 0
    sent.sample()
    sent.rearm("toy", expect=2)  # planned growth that never lands
    sent.disarm("toy", expect=2)  # the granter retires
    size.n = 3
    assert sent.sample() == 1 and sent.events == 1
    sent.disarm("toy", expect=5)  # clamps at zero
    sent.disarm("missing")  # unknown names: no-op
    size.n = 4
    assert sent.sample() == 1
    sent.rearm("toy", expect=1)  # a grant absorbs exactly one unit
    size.n = 6
    assert sent.sample() == 1 and sent.events == 3
    with pytest.raises(TypeError):
        sent.register("bad")


def test_kernel_library_watch_counts_loaded_libraries():
    sent = CompileSentinel()
    profiling.watch_kernel_libraries(sent)
    assert sent.compiles("ops.kernel_libs") == len(_build._libs)


def test_batcher_late_variant_fires_sentinel_and_phase_gate(pair,
                                                             monkeypatch):
    """The eager port compiles nothing for a late sampled top-k request (a
    new decode variant in the JAX package): no event. A kernel library
    that loads after warmup is the port's compile stall: an
    ``ops.kernel_libs`` event and a flight record. The same journey pins
    the one-branch phase gate: no phase samples while it is off, one per
    phase per tick while on."""
    _, _, tlm = pair
    sent, eo = global_compile_sentinel(), global_engine_obs()
    assert eo.enabled is False
    old = sent.warmup_samples
    sent.warmup_samples = 3
    try:
        # A library loaded at start-up (warmup counts samples of a
        # non-empty watch only; the CPU loads none).
        monkeypatch.setitem(_build._libs, "warm_kernel", object())
        bat = ContinuousBatcher(tlm, slots=2, chunk=2)
        prompt = np.asarray([1, 2, 3])
        r1 = bat.submit(prompt, 40)

        def count(name):
            return (global_metrics().snapshot()["histograms"]
                    .get(f"engine.phase.{name}_s", {}).get("count", 0))

        phases = ("admit", "prefill", "dispatch", "commit_lag", "decode",
                  "commit", "update")
        before = {n: count(n) for n in phases}
        for _ in range(3):
            bat.tick()
        assert {n: count(n) for n in phases} == before
        eo.enabled = True
        try:
            for _ in range(3):
                bat.tick()
        finally:
            eo.enabled = False
        assert all(count(n) == before[n] + 3 for n in phases)
        events = sent.events
        flight = len(global_flight_recorder().events("recompile"))
        bat.submit(prompt, 4, temperature=0.7, top_k=5, rng=3)
        bat.tick()
        assert sent.events == events
        assert "ops.kernel_libs" in sent.watched()
        monkeypatch.setitem(_build._libs, "late_kernel", object())
        bat.tick()
        assert sent.events == events + 1
        new = global_flight_recorder().events("recompile")[flight:]
        assert [e["data"]["program"] for e in new] == ["ops.kernel_libs"]
        assert r1 in bat.run()
        bat.close()
    finally:
        sent.warmup_samples = old


# -- memory accounting ------------------------------------------------------

_TRAFFIC = [np.arange(1, 18), np.arange(3, 9), np.arange(1, 18)]


def _run_pair(pair, **kw):
    """Drive the JAX and the port batcher through the same traffic,
    returning both memory-stat dicts mid-flight and after the drain."""
    jlm, v, tlm = pair
    jb = JC.ContinuousBatcher(jlm, v, slots=2, chunk=2, **kw)
    tb = ContinuousBatcher(tlm, slots=2, chunk=2, **kw)
    out = []
    for b in (jb, tb):
        for p in _TRAFFIC[:2]:
            b.submit(np.asarray(p, np.int32), 6)
        b.tick()
        mid = b._memory_stats()
        b.run()
        b.submit(np.asarray(_TRAFFIC[2], np.int32), 4)
        b.run()
        out.append((mid, b._memory_stats()))
    jb.close()
    tb.close()
    return out


@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_memory_gauges_equal_jax_batcher(pair, layout,
                                         isolated_memory_sources):
    kw = (dict(kv_layout="paged", page_size=8, pool_pages=20)
          if layout == "paged" else {})
    (jmid, jend), (tmid, tend) = _run_pair(pair, **kw)
    assert tmid == jmid and tend == jend
    for g in (tmid, tend):
        if layout == "paged":
            assert (g["memory.pages_used"] + g["memory.pages_free"]
                    + g["memory.pages_cached"] == g["memory.pool_pages"])
    if layout == "paged":
        assert tend["paged.prefix_hits"] >= 2  # the repeat's full pages


def test_memory_gauges_sum_and_retire(pair, isolated_memory_sources):
    _, _, tlm = pair
    bat = ContinuousBatcher(tlm, slots=3, chunk=2)
    b0 = tlm.blocks[0]
    expected = (len(tlm.blocks) * 2 * 3 * b0.cache_heads
                * (tlm.max_len + 1) * b0.head_dim * 4)
    reg = MetricsRegistry()
    reg.register_collector(engine_collector)
    assert reg.snapshot()["gauges"]["memory.kv_bytes"] == float(expected)
    bat2 = ContinuousBatcher(tlm, slots=3, chunk=2)
    assert reg.snapshot()["gauges"]["memory.kv_bytes"] == 2.0 * expected
    bat2.close()
    assert reg.snapshot()["gauges"]["memory.kv_bytes"] == float(expected)
    bat3 = ContinuousBatcher(tlm, slots=2, chunk=2, kv_layout="paged",
                             page_size=8)
    assert "memory.pool_pages" in reg.snapshot()["gauges"]
    bat3.close()
    gauges = reg.snapshot()["gauges"]
    assert "memory.pool_pages" not in gauges
    # No CUDA allocator on the CPU: the hbm gauges are absent.
    assert "memory.hbm_bytes_in_use" not in gauges
    register_memory_source("continuous", bat)  # idempotent
    bat.close()


# -- the exporter under a ticking batcher ------------------------------------


def test_exporter_scrape_concurrent_with_ticking_batcher(pair):
    _, _, tlm = pair
    bat = ContinuousBatcher(tlm, slots=2, chunk=2, kv_layout="paged",
                            page_size=8)
    server = serve_metrics(port=0)
    port = server.server_address[1]
    rng = np.random.RandomState(5)
    errors, scrapes = [], []
    stop = threading.Event()

    def scraper():
        while not stop.is_set():
            try:
                for path in ("/metrics", "/metrics.json"):
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}{path}",
                            timeout=10) as r:
                        body = r.read().decode()
                    if path == "/metrics.json":
                        g = json.loads(body)["gauges"]
                        if "memory.pool_pages" in g:
                            scrapes.append(
                                g["memory.pages_used"]
                                + g["memory.pages_free"]
                                + g["memory.pages_cached"]
                                == g["memory.pool_pages"])
            except Exception as e:  # noqa: BLE001 — counted
                errors.append(e)
            stop.wait(0.02)

    th = threading.Thread(target=scraper, daemon=True)
    try:
        with bat:
            th.start()
            ids = [bat.submit(rng.randint(1, VOCAB, size=n), 30)
                   for n in (3, 5, 9, 4)]
            for rid in ids:
                bat.result(rid, timeout=120.0)
            deadline = 50
            while len(scrapes) < 3 and deadline:
                stop.wait(0.05)
                deadline -= 1
    finally:
        stop.set()
        th.join(timeout=10)
        server.shutdown()
        server.server_close()
        bat.close()
    assert not errors and scrapes and all(scrapes)


# -- roofline ---------------------------------------------------------------


def test_roofline_count_by_hand(pair, monkeypatch, isolated_memory_sources):
    """``program_work`` at lm_tiny's shape (vocab 37, dim 64, 4 blocks of
    4 heads, MLP 128, f32, learned positions) against a count by hand."""
    _, _, tlm = pair
    d, h, layers, mlp, vocab = 64, 4, 4, 128, VOCAB
    hd = d // h
    mats = layers * (d * 3 * d + d * d + 2 * d * mlp)
    params = layers * (3 * d * d + 3 * d + d * d + d + d * mlp + mlp
                       + mlp * d + d + 4 * d)
    head = d * vocab + vocab + 2 * d
    # One decode step of 2 rows at positions 4 and 9 (5 + 10 live keys).
    w = program_work(tlm, [(2, 15, 15, 2, 2)])
    assert w["flops"] == 2 * (mats * 2 + d * vocab * 2) + 4 * hd * h * 15 * 4
    kv = 2 * h * hd * 4 * (15 + 2) * layers
    assert w["bytes"] == (params + head) * 4 + 2 * (d * 4 + d * 4) + kv \
        + 4 * vocab * 2
    # int8 K/V: hd one-byte values + one f32 scale a vector.
    w8 = program_work(tlm, [(2, 15, 15, 2, 2)], "int8")
    assert w["bytes"] - w8["bytes"] == 2 * h * (hd * 4 - (hd + 4)) * 17 * 4
    # The batcher's decode program: chunk passes from live positions.
    bat = ContinuousBatcher(tlm, slots=2, chunk=2)
    bat.submit(np.arange(1, 5), 6)
    bat.tick()
    roof = bat._roofline_stats()
    # Prefill: an 8-token bucket of a 4-token prompt; decode: 2 steps of
    # the slot at positions 4 and 5 (5, 6 live keys), 2 rows each.
    assert roof["prefill"] == dict(program_work(
        tlm, [(8, 10, 4, 8, 1)]), wall_s=None)
    assert roof["decode"] == dict(program_work(
        tlm, [(2, 5, 5, 2, 2), (2, 6, 6, 2, 2)]), wall_s=None)
    reg = MetricsRegistry()
    reg.register_collector(engine_collector)
    g = reg.snapshot()["gauges"]
    assert g["engine.flops.decode"] == roof["decode"]["flops"]
    assert not any(k.startswith(("engine.mfu", "engine.mbu")) for k in g)
    # Known peaks (the env override) and a measured wall: utilization.
    monkeypatch.setenv("ADAPT_TPU_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("ADAPT_TPU_PEAK_BYTES_S", "1e11")
    eo = global_engine_obs()
    eo.enabled = True
    try:
        bat.tick()
    finally:
        eo.enabled = False
    g = reg.snapshot()["gauges"]
    wall = bat._roofline_stats()["decode"]["wall_s"]
    assert wall > 0
    assert g["engine.mbu.decode"] == pytest.approx(
        g["engine.bytes_accessed.decode"] / wall / 1e11)
    assert 0 < g["engine.mbu"] and 0 < g["engine.mfu"]
    bat.run()
    bat.close()


def test_kernel_dispatch_books_name_the_plain_route(pair):
    _, _, tlm = pair
    T.generate(tlm, np.arange(1, 6)[None], 3)
    reg = MetricsRegistry()
    reg.register_collector(engine_collector)
    g = reg.snapshot()["gauges"]
    for op in ("prefill", "decode"):
        assert g[f"engine.kernel_dispatch.{op}"] == 0.0  # plain: the CPU
        assert g[f"engine.kernel_dispatch.{op}.xla_total"] >= 1
        assert g[f"engine.kernel_dispatch.{op}.pallas_total"] == 0


# -- tick phases against the JAX batcher --------------------------------------


def _phase_counts(reg):
    return {k: v["count"] for k, v in reg.snapshot()["histograms"].items()
            if k.startswith("engine.phase.")}


@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_phase_names_and_counts_equal_jax(pair, layout):
    jlm, v, tlm = pair
    kw = (dict(kv_layout="paged", page_size=8, prefill_chunk=16)
          if layout == "paged" else {})
    prompts = [np.arange(1, 1 + n, dtype=np.int32) % VOCAB
               for n in (5, 30, 12, 3)]
    counts = []
    for eo, reg, mk in (
            (JP.global_engine_obs(), JMET.global_metrics(),
             lambda: JC.ContinuousBatcher(jlm, v, slots=2, chunk=2, **kw)),
            (global_engine_obs(), global_metrics(),
             lambda: ContinuousBatcher(tlm, slots=2, chunk=2, **kw))):
        b = mk()
        before = _phase_counts(reg)
        eo.enabled = True
        try:
            for p in prompts:
                b.submit(p, 5)
            b.run()
        finally:
            eo.enabled = False
        after = _phase_counts(reg)
        counts.append({k: n - before.get(k, 0) for k, n in after.items()
                       if n - before.get(k, 0)})
        b.close()
    assert counts[1] == counts[0]
    assert set(counts[1]) >= {f"engine.phase.{n}_s" for n in (
        "admit", "prefill", "dispatch", "commit_lag", "decode", "commit",
        "update")}


def test_roofline_counts_every_expert_of_a_moe_block():
    """A mixture-of-experts block multiplies each token through its gate
    and every expert's two matrices (masked-dense form); its stacked
    biases are adds."""
    d, e, mlp, layers, vocab = 32, 4, 48, 2, 53
    moe = T.transformer_lm(vocab, d, layers, 4, mlp, max_len=48,
                           moe_experts=e, moe_top_k=2, device="cpu")
    dense = T.transformer_lm(vocab, d, layers, 4, mlp, max_len=48,
                             device="cpu")
    one = [(1, 0, 0, 0, 0)]
    extra = layers * (d * e + 2 * e * d * mlp - 2 * d * mlp)
    assert (program_work(moe, one)["flops"]
            - program_work(dense, one)["flops"]) == 2 * extra
