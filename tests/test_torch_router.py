"""The port's fleet router and autoscaler (``runtime/router``) against the
JAX package's, on the CPU.

Weights come from the JAX package (flax ``init`` from a seed, carried
across by ``convert.from_flax``); prompts are seeded numpy arrays given to
both. Pinned:

- ``RouterConfig``: defaults and every refusal equal to the JAX package's;
- placement decisions equal to the JAX router's on fixed books, under the
  three policies: duck-typed engines publish books built by each package's
  own ``runtime.capacity`` from the same inputs (sketches from pagers,
  forecasts from forecasters), and the ranked order, every ``why`` record,
  the HOME flags and the decision ring (minus its wall stamps) must be
  equal: cold windows with a rendezvous HOME, placement memory, stale
  books, critical and degraded replicas, the idle-engine queue-wait clamp,
  affinity hits and an admission rejection; and the one place they differ
  on purpose, books that have learned no prefill wall (a fault of the JAX
  router's, repaired in the port);
- streams: greedy router streams over two port replicas token-equal to the
  JAX router's over two JAX replicas and to one port batcher served alone,
  with and without a prefill tier (native and int8 pools);
- membership: a deregistered lease and a replica whose ``tick`` raises are
  leave edges whose work is re-placed, streams unchanged and delivery
  exactly-once; the synchronous shed; the autoscaler up and down;
- the capacity plane's router-facing pieces: ``FederatedStore`` evicting a
  dead lease's book, ``GET /fleet/placements`` through the port's
  exporter, and ``scripts/fleet_top.py`` rendering its ROUTE column from
  the port's exporter."""

import dataclasses
import importlib
import importlib.util
import json
import pathlib
import time
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapt_tpu_torch.config import (
    CapacityConfig,
    DisaggConfig,
    RouterConfig,
    SchedulerConfig,
    ServeConfig,
)
from adapt_tpu_torch.control.registry import WorkerRegistry
from adapt_tpu_torch.convert import from_flax
from adapt_tpu_torch.models import transformer_lm as T
from adapt_tpu_torch.runtime import capacity as TCAP
from adapt_tpu_torch.runtime import paged as TPAGED
from adapt_tpu_torch.runtime import router as TR
from adapt_tpu_torch.runtime.continuous import ContinuousBatcher
from adapt_tpu_torch.runtime.disagg import DisaggServer, PrefillWorker
from adapt_tpu_torch.runtime.router import FleetAutoscaler, FleetRouter
from adapt_tpu_torch.runtime.scheduler import QueueFullError
from adapt_tpu_torch.utils.exporter import serve_metrics
from adapt_tpu_torch.utils.metrics import global_metrics
from adapt_tpu_torch.utils.telemetry import FederatedStore
from adapt_tpu_torch.utils.tracing import global_flight_recorder

J = importlib.import_module("adapt_tpu.models.transformer_lm")
JC = importlib.import_module("adapt_tpu.runtime.continuous")
JD = importlib.import_module("adapt_tpu.runtime.disagg")
JR = importlib.import_module("adapt_tpu.runtime.router")
JCAP = importlib.import_module("adapt_tpu.runtime.capacity")
JPAGED = importlib.import_module("adapt_tpu.runtime.paged")
JSCHED = importlib.import_module("adapt_tpu.runtime.scheduler")
JConfig = importlib.import_module("adapt_tpu.config")

VOCAB = 31
PAGE = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def clean_slate():
    global_metrics().reset()
    global_flight_recorder().clear()
    yield
    global_metrics().reset()
    global_flight_recorder().clear()


@pytest.fixture(scope="module")
def lm_setup():
    """The JAX router tests' model: 2 blocks, dim 32, 4 heads."""
    jlm = J.transformer_lm(VOCAB, 32, 2, 4, 64, max_len=96, name="router_lm")
    variables = jax.device_get(jlm.graph.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32)))
    tlm = T.transformer_lm(VOCAB, 32, 2, 4, 64, max_len=96, name="router_lm",
                           device="cpu")
    tlm.load_state_dict(from_flax(variables))
    return jlm, variables, tlm


def _replica(tlm, scheduler=None, kv="native"):
    return ContinuousBatcher(tlm, slots=2, chunk=PAGE, kv_layout="paged",
                             page_size=PAGE, kv_cache_dtype=kv,
                             capacity=CapacityConfig(refresh_s=0.0),
                             scheduler=scheduler)


def _jreplica(jlm, variables, kv="native"):
    return JC.ContinuousBatcher(
        jlm, variables, slots=2, chunk=PAGE, kv_layout="paged",
        page_size=PAGE, kv_cache_dtype=kv,
        capacity=JConfig.CapacityConfig(refresh_s=0.0))


def _events(kind):
    return [e["data"] for e in global_flight_recorder().events(kind)]


def _solo(tlm, prompts, steps, kv="native"):
    """Each prompt's stream from one port batcher serving them all."""
    ref = _replica(tlm, kv=kv)
    rids = [ref.submit(p, steps) for p in prompts]
    out = ref.run()
    return [out[r] for r in rids]


# -- config ------------------------------------------------------------------


BAD_ROUTER_ARGS = [
    dict(policy="round_robin"), dict(book_max_age_s=0.0),
    dict(degraded_penalty_s=-1.0), dict(queue_cost_s=-0.1),
    dict(rendezvous_bias_s=-0.1), dict(recovery_budget_s=0.0),
    dict(lease_ttl_s=0.0), dict(placements_capacity=0),
    dict(min_replicas=0), dict(min_replicas=3, max_replicas=2),
    dict(scale_up_queue_frac=0.0), dict(scale_up_queue_frac=1.5),
    dict(scale_down_idle_s=-1.0), dict(autoscale_dwell_s=-1.0),
]


def test_router_config_defaults_equal_jax():
    assert (dataclasses.asdict(RouterConfig())
            == dataclasses.asdict(JConfig.RouterConfig()))
    assert ServeConfig().router == RouterConfig()
    assert ServeConfig().router.policy == "affinity"


@pytest.mark.parametrize("kw", BAD_ROUTER_ARGS,
                         ids=[",".join(f"{k}={v}" for k, v in kw.items())
                              for kw in BAD_ROUTER_ARGS])
def test_router_config_refusals_equal_jax(kw):
    with pytest.raises(ValueError) as ours:
        RouterConfig(**kw)
    with pytest.raises(ValueError) as theirs:
        JConfig.RouterConfig(**kw)
    assert str(ours.value) == str(theirs.value)


# -- decisions on fixed books ------------------------------------------------


def _pager(paged, prompts):
    """A pager of page ``PAGE`` holding each prompt's full pages in the
    prefix cache (the radix nodes a sketch reports)."""
    p = paged.Pager(num_pages=32, slots=8, pages_per_slot=8, page_tokens=PAGE)
    for slot, toks in enumerate(prompts):
        toks = np.asarray(toks, np.int32)
        pages = (len(toks) - 1) // PAGE
        assert p.alloc(slot, pages)
        for j, page in enumerate(p.owned(slot)[:pages]):
            p.register(page, paged.Pager.prefix_key(toks, (j + 1) * PAGE))
    return p


def _forecast(cap, walls=(), queue_wait=0.0, tick_gap=0.0):
    """A forecaster fed ``walls`` ((tokens, s) prefill samples), a queue
    wait and a tick gap; its snapshot, or ``{}`` when fed nothing."""
    f = cap.TTFTForecaster(alpha=0.2, window=8)
    for n, s in walls:
        f.observe_prefill(n, s)
    if queue_wait:
        f.observe_queue_wait(queue_wait)
    if tick_gap:
        f.observe_tick_gap(tick_gap)
    return f.snapshot() if walls or queue_wait or tick_gap else {}


def _book(cap, paged, *, prefixes=(), walls=(), queue_wait=0.0,
          tick_gap=0.0, health="ok", queue=0, slots_free=1, age=0.0):
    """A decode book built by ``cap`` (one package's runtime.capacity)."""
    sketch = (cap.sketch_from_pager(_pager(paged, prefixes), 32) if prefixes
              else {"v": cap.BOOK_V, "page_tokens": PAGE, "entries": []})
    return {
        "v": cap.BOOK_V, "kind": "decode", "wall": time.time() - age,
        "health": health, "health_level": cap.HEALTH_NAMES.index(health),
        "headroom": {"queue_depth": queue, "slots_free": slots_free,
                     "slots_total": 2, "queue_bound": 4},
        "forecast": _forecast(cap, walls, queue_wait, tick_gap),
        "sketch": sketch,
    }


class _Duck:
    """A decode engine that serves a fixed book: what the router reads of
    a replica, with stats that count its submits."""

    def __init__(self, book, queue_full, dtype, reject=False):
        self._page = PAGE
        self._book = book
        self._queue_full = queue_full
        self._dtype = dtype
        self._reject = reject
        self.n = 0
        self.slots = [types.SimpleNamespace(req=None) for _ in range(2)]

    def capacity_book(self):
        return self._book

    def stats(self):
        return {"queued": self.n, "active": 0}

    def validate_request(self, prompt, steps, **kw):
        return np.asarray(prompt, self._dtype).reshape(-1), None

    def admission_check(self, slo=None, request=None):
        if self._reject:
            raise self._queue_full("queue full")

    def submit(self, prompt, t_submit=None, **kw):
        self.n += 1
        return self.n - 1


def _decision_prompts():
    rng = np.random.RandomState(11)
    hot = rng.randint(1, VOCAB, size=2 * PAGE + 1)
    first = rng.randint(1, VOCAB, size=PAGE + 4)
    return hot, [
        first,                                             # one full page
        np.concatenate([first[:PAGE], rng.randint(1, VOCAB, size=6)]),
        np.concatenate([hot[:2 * PAGE], rng.randint(1, VOCAB, size=5)]),
        rng.randint(1, VOCAB, size=5),                     # no full page
        np.concatenate([hot[:PAGE], rng.randint(1, VOCAB, size=9)]),
        rng.randint(1, VOCAB, size=3 * PAGE + 2),
    ]


def _scenario(name, cap, paged, hot):
    """name -> {replica: (book kwargs, rejects admission)}."""
    warm = [(8, 0.004), (16, 0.007), (32, 0.012)]
    return {
        # No sketch speaks and no forecast is learned: least-loaded, and
        # the rendezvous HOME breaks the tie.
        "cold": {"r0": (dict(queue=1), False), "r1": (dict(), False),
                 "r2": (dict(), False)},
        # r0's book is stale: live stats (its submits) price it.
        "stale": {"r0": (dict(age=60.0), False),
                  "r1": (dict(walls=warm, queue=1), False),
                  "r2": (dict(walls=warm, queue=2), False)},
        # The cheapest replica is critical: it sorts last.
        "critical": {"r0": (dict(health="critical"), False),
                     "r1": (dict(queue=3), False),
                     "r2": (dict(queue=2, slots_free=0), False)},
        "degraded": {"r0": (dict(health="degraded", walls=warm), False),
                     "r1": (dict(walls=warm, queue=2), False),
                     "r2": (dict(walls=warm, queue=30), False)},
        # r0 is idle but remembers a long queue wait: clamped to 0.
        "clamp": {"r0": (dict(walls=warm, queue_wait=0.5,
                              tick_gap=0.002), False),
                  "r1": (dict(walls=warm, queue_wait=0.01, queue=1), False),
                  "r2": (dict(walls=warm, queue_wait=0.5, queue=1), False)},
        # r2 holds the hot prefix: its hit shortens its forecast.
        "affinity": {"r0": (dict(walls=warm), False),
                     "r1": (dict(walls=warm, queue=1), False),
                     "r2": (dict(walls=warm, prefixes=[hot]), False)},
        # The best-ranked replica rejects admission: the next one takes it.
        "reject": {"r0": (dict(), True), "r1": (dict(queue=1), False),
                   "r2": (dict(queue=2), False)},
    }[name]


def _decide(router_mod, cfg_mod, cap, paged, queue_full, dtype, scenario,
            policy):
    hot, prompts = _decision_prompts()
    spec = _scenario(scenario, cap, paged, hot)
    engines = {name: _Duck(_book(cap, paged, **kw), queue_full, dtype, rej)
               for name, (kw, rej) in spec.items()}
    router = router_mod.FleetRouter(
        engines, config=cfg_mod.RouterConfig(policy=policy), seed=0)
    ranks = []
    for p in prompts:
        ranked = router._rank(np.asarray(p, dtype), len(p))
        ranks.append([(rep.name, why) for rep, why in ranked])
        router.submit(p, 4)
    pl = router.placements()
    decisions = [{k: v for k, v in d.items() if k != "wall"}
                 for d in pl.pop("decisions")]
    return ranks, decisions, pl, router.stats()


@pytest.mark.parametrize("scenario", ["cold", "stale", "critical",
                                      "degraded", "clamp", "affinity",
                                      "reject"])
@pytest.mark.parametrize("policy", ["affinity", "least_loaded", "random"])
def test_decisions_equal_jax_on_fixed_books(policy, scenario):
    ours = _decide(TR, importlib.import_module("adapt_tpu_torch.config"),
                   TCAP, TPAGED, QueueFullError, np.int64, scenario, policy)
    theirs = _decide(JR, JConfig, JCAP, JPAGED, JSCHED.QueueFullError,
                     np.int32, scenario, policy)
    assert ours == theirs
    ranks, decisions, _, stats = ours
    assert stats["placed"] == 6 and stats["shed"] == 0
    assert all(d["kind"] == "placed" for d in decisions)
    whys = [w for rank in ranks for _, w in rank]
    if scenario == "cold" and policy == "affinity":
        # A rendezvous HOME for the one-full-page prompt, remembered for
        # the prompt sharing its first page; none without a full page.
        homes = [[n for n, w in rank if w["home"]] for rank in ranks]
        assert len(homes[0]) == 1 and homes[1] == homes[0]
        assert homes[3] == []
        assert decisions[1]["replica"] == decisions[0]["replica"]
    if scenario == "stale":
        assert all(w["health"] == "unknown" for n, w in
                   (x for rank in ranks for x in rank) if n == "r0")
    if scenario == "critical" and policy != "random":
        assert all(rank[-1][0] == "r0" for rank in ranks)
    if scenario == "affinity" and policy == "affinity":
        assert ranks[2][0][0] == "r2" and ranks[2][0][1]["affinity_tokens"]
    if scenario == "reject":
        assert all(d["replica"] != "r0" for d in decisions)
    assert all(set(w) >= {"health", "affinity_tokens", "forecast_s",
                          "queue_depth", "home", "cost"} for w in whys)


def test_unpriced_forecasts_rank_cold_where_jax_follows_them():
    """The repaired fault: when no book has learned a prefill wall (every
    admission chunked), the JAX router still ranks on the forecasts'
    queue-wait and tick-gap memory, which a resident prefix cannot move,
    and sends the prefix's repeat to the replica without it. The port
    ranks such a fleet cold (least-loaded, affinity the tiebreak) and keeps
    the repeat where its prefix is. With walls learned, the two routers
    rank alike again. The books are phase 17 (b)'s on the card."""
    hot, prompts = _decision_prompts()
    prompt = prompts[2]  # hot's two full pages, then a tail

    def rank(router_mod, cfg_mod, cap, paged, dtype, walls):
        books = {
            "r0": _book(cap, paged, prefixes=[hot], walls=walls,
                        queue_wait=0.393221, tick_gap=0.804039),
            "r1": _book(cap, paged, walls=walls, queue_wait=0.000619,
                        tick_gap=0.686929),
        }
        router = router_mod.FleetRouter(
            {n: _Duck(b, QueueFullError, dtype) for n, b in books.items()},
            config=cfg_mod.RouterConfig())
        return [(r.name, w) for r, w in router._rank(
            np.asarray(prompt, dtype), len(prompt))]

    tcfg = importlib.import_module("adapt_tpu_torch.config")
    ours = rank(TR, tcfg, TCAP, TPAGED, np.int64, ())
    theirs = rank(JR, JConfig, JCAP, JPAGED, np.int32, ())
    assert [n for n, _ in theirs] == ["r1", "r0"]
    assert [n for n, _ in ours] == ["r0", "r1"]
    assert ours[0][1]["affinity_tokens"] == 2 * PAGE
    assert all(w["forecast_s"] == 0.0 for _, w in ours)
    warm = [(8, 0.004), (16, 0.007)]
    assert (rank(TR, tcfg, TCAP, TPAGED, np.int64, warm)
            == rank(JR, JConfig, JCAP, JPAGED, np.int32, warm))


def test_clamp_zeroes_an_idle_replicas_queue_wait():
    """The clamp itself: r0 (idle, a 0.5 s queue-wait memory) forecasts
    as if it had none, so it ranks first under the forecast policies."""
    ranks = _decide(TR, importlib.import_module("adapt_tpu_torch.config"),
                    TCAP, TPAGED, QueueFullError, np.int64, "clamp",
                    "least_loaded")[0]
    assert ranks[0][0][0] == "r0"
    fc = dict(ranks[0])
    assert fc["r0"]["forecast_s"] < fc["r2"]["forecast_s"]


# -- streams -----------------------------------------------------------------


def test_placement_streams_equal_jax_router_and_solo(clean_slate, lm_setup):
    """Two port replicas behind the router: every stream equals the JAX
    router's over two JAX replicas and one port batcher serving the
    prompts alone; each client saw indices 0..n-1 once, in order; both
    leases carry decode books; the decision ring explains each landing."""
    jlm, variables, tlm = lm_setup
    reg = WorkerRegistry()
    router = FleetRouter({"r0": _replica(tlm), "r1": _replica(tlm)},
                         registry=reg)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, VOCAB, size=12 + (i % 3) * 8).astype(np.int32)
               for i in range(6)]
    toks: dict = {}
    sids = [router.submit(p, 6, on_token=lambda s, t, i: toks.setdefault(
        s, []).append(i)) for p in prompts]
    out = router.run()
    assert set(out) == set(sids)
    for name in ("r0", "r1"):
        assert reg.alive_meta()[f"decode:{name}"]["capacity"]["kind"] == (
            "decode")
    for sid in sids:
        assert toks[sid] == list(range(len(out[sid])))
    st = router.stats()
    assert st["placed"] == 6 and st["shed"] == 0 and st["replicas_live"] == 2
    pl = router.placements()
    assert len(pl["decisions"]) == 6 and pl["v"] == TR.PLACEMENTS_V
    assert all(d["kind"] == "placed" for d in pl["decisions"])
    assert global_metrics().snapshot()["counters"]["router.placed_total"] == 6
    router.close()
    assert reg.alive() == []
    jrouter = JR.FleetRouter({"r0": _jreplica(jlm, variables),
                              "r1": _jreplica(jlm, variables)})
    jsids = [jrouter.submit(p, 6) for p in prompts]
    jout = jrouter.run()
    for sid, jsid, want in zip(sids, jsids, _solo(tlm, prompts, 6)):
        np.testing.assert_array_equal(out[sid], want)
        np.testing.assert_array_equal(out[sid], np.asarray(jout[jsid]))
    jrouter.close()


def _kill_run(tlm, kill, seed):
    """Three replicas take 9 prompts; after 2 ticks ``kill(router,
    victim)`` removes the replica holding the most requests. Returns the
    router, prompts, results, ids and each id's delivered indices."""
    reg = WorkerRegistry()
    router = FleetRouter({f"r{i}": _replica(tlm) for i in range(3)},
                         registry=reg,
                         config=RouterConfig(recovery_budget_s=2.0))
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(1, VOCAB, size=12).astype(np.int32)
               for _ in range(9)]
    toks: dict = {}
    sids = [router.submit(p, 6, on_token=lambda s, t, i: toks.setdefault(
        s, []).append(i)) for p in prompts]
    for _ in range(2):
        router.tick()
    victim = max(router._replicas.values(), key=lambda r: len(r.sids))
    assert victim.sids  # the kill must strand real work
    kill(router, reg, victim)
    out = router.run()
    return router, prompts, out, sids, toks, victim


def _check_recovered(tlm, router, prompts, out, sids, toks):
    assert set(out) == set(sids)
    for sid, want in zip(sids, _solo(tlm, prompts, 6)):
        np.testing.assert_array_equal(out[sid], want)
        assert toks[sid] == list(range(len(out[sid])))
    assert router.replaced > 0 and router.failed == 0
    leaves = _events("replica_leave")
    assert len(leaves) == 1 and leaves[0]["reason"] == "lost"
    assert leaves[0]["moved"] == router.replaced
    assert leaves[0]["wall_s"] < 2.0  # the recovery budget
    assert router.stats()["replicas_live"] == 2
    replaced = [d for d in router.placements()["decisions"]
                if d["kind"] == "replaced"]
    assert len(replaced) == router.replaced


def test_kill_one_of_three_midload(clean_slate, lm_setup):
    """A deregistered lease is a leave edge: the router re-places every
    stranded request within the recovery budget, streams equal one
    batcher's and delivery stays exactly-once."""
    tlm = lm_setup[2]
    router, prompts, out, sids, toks, victim = _kill_run(
        tlm, lambda r, reg, v: reg.deregister(v.lease_key, v.lease_token), 1)
    _check_recovered(tlm, router, prompts, out, sids, toks)
    router.close()


def test_a_raising_tick_is_a_leave_edge(clean_slate, lm_setup):
    """A replica whose ``tick`` raises a Python exception leaves the fleet
    as a lost lease does: its work is re-placed on the survivors."""
    tlm = lm_setup[2]

    def crash(router, reg, victim):
        def boom():
            raise RuntimeError("replica crashed")
        victim.engine.tick = boom

    router, prompts, out, sids, toks, victim = _kill_run(tlm, crash, 1)
    _check_recovered(tlm, router, prompts, out, sids, toks)
    assert not router._replicas[victim.name].alive
    router.close()


def test_sheds_synchronously(clean_slate, lm_setup):
    """With every live replica's queue at its bound, submit raises
    QueueFullError before any work is queued; the books and the decision
    ring count each shed."""
    tlm = lm_setup[2]
    router = FleetRouter({"r0": _replica(tlm, SchedulerConfig(
        max_queue_depth=2, preempt=False, degrade=False))})
    rng = np.random.RandomState(2)
    accepted, sheds = [], 0
    for _ in range(6):
        try:
            accepted.append(router.submit(
                rng.randint(1, VOCAB, size=8).astype(np.int32), 4))
        except QueueFullError:
            sheds += 1
    assert len(accepted) == 2 and sheds == 4 and router.shed == 4
    kinds = [d["kind"] for d in router.placements()["decisions"]]
    assert kinds.count("shed") == 4
    assert global_metrics().snapshot()["counters"]["router.shed_total"] == 4
    assert set(router.run()) == set(accepted)
    router.close()


def test_autoscaler_up_on_pressure_down_on_drain(clean_slate, lm_setup):
    """Queue pressure over the threshold spawns a replica; a drained fleet
    retires the idle one back to the floor; both edges are flight
    events, and the streams equal one batcher's."""
    tlm = lm_setup[2]
    cfg = RouterConfig(min_replicas=1, max_replicas=2,
                       scale_up_queue_frac=0.5, autoscale_dwell_s=0.0,
                       scale_down_idle_s=0.05)
    sched = SchedulerConfig(max_queue_depth=4, preempt=False, degrade=False)
    router = FleetRouter({"r0": _replica(tlm, sched)}, config=cfg)
    spawned = []

    def spawn(i):
        spawned.append(i)
        return f"auto{i}", _replica(tlm, sched)

    scaler = FleetAutoscaler(router, spawn, cfg)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, VOCAB, size=8).astype(np.int32)
               for _ in range(4)]
    sids = [router.submit(p, 4) for p in prompts]
    for _ in range(3):
        router.tick()
        if scaler.scale_ups:
            break
    assert scaler.scale_ups == 1 and spawned == [1]
    ups = _events("scale_up")
    assert ups[0]["replica"] == "auto1" and ups[0]["fleet"] == 2
    assert _events("replica_join")[0]["replica"] == "auto1"
    assert router.stats()["replicas_live"] == 2
    out = router.run()
    for sid, want in zip(sids, _solo(tlm, prompts, 4)):
        np.testing.assert_array_equal(out[sid], want)
    deadline = time.monotonic() + 5.0
    while not scaler.scale_downs and time.monotonic() < deadline:
        time.sleep(0.02)
        router.tick()
    assert scaler.scale_downs == 1
    assert _events("scale_down")[0]["fleet"] == 1
    leaves = _events("replica_leave")
    assert leaves[0]["reason"] == "drain" and leaves[0]["moved"] == 0
    assert router.stats()["replicas_live"] == 1
    router.close()


# -- the prefill tier across replicas ----------------------------------------


@pytest.mark.parametrize("kv", ["native", "int8"])
def test_prefill_tier_streams_equal_jax_router(clean_slate, lm_setup, kv):
    """A prefill tier (tp 1) feeding two replicas: every prompt of two
    full pages or more crosses the loopback wire as whole-leaf frames and
    lands as a prefix hit; streams equal the JAX router's with a JAX
    ``PrefillWorker`` and the port's replicas served collocated."""
    jlm, variables, tlm = lm_setup
    dcfg = dict(prompt_threshold=2 * PAGE, busy_prompt_threshold=2 * PAGE)
    pf = PrefillWorker(tlm, page_size=PAGE, prefill_chunk=2 * PAGE,
                       kv_cache_dtype=kv, device="cpu")
    router = FleetRouter({"d0": _replica(tlm, kv=kv),
                          "d1": _replica(tlm, kv=kv)}, prefill=pf,
                         disagg=DisaggConfig(**dcfg))
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, VOCAB, size=n).astype(np.int32)
               for n in (37, 29, 50, 12)]
    sids = [router.submit(p, 6) for p in prompts]
    out = router.run()
    assert set(out) == set(sids) and router.failed == 0
    evs = _events("kv_handoff")
    assert len(evs) == 3  # the 12-token prompt collocates
    assert all(e["tiles"] == 1 and e["adopted"] for e in evs)
    assert {e["replica"] for e in evs} <= {"d0", "d1"}
    c = global_metrics().snapshot()["counters"]
    assert c["disagg.pages_streamed"] == sum(
        (len(p) - 1) // PAGE for p in prompts[:3])
    assert router.stats()["prefill_queued"] == 0
    router.close()
    jpf = JD.PrefillWorker(jlm, variables, page_size=PAGE,
                           prefill_chunk=2 * PAGE, kv_cache_dtype=kv)
    jrouter = JR.FleetRouter(
        {"d0": _jreplica(jlm, variables, kv),
         "d1": _jreplica(jlm, variables, kv)}, prefill=jpf,
        disagg=JConfig.DisaggConfig(**dcfg))
    jsids = [jrouter.submit(p, 6) for p in prompts]
    jout = jrouter.run()
    for sid, jsid, want in zip(sids, jsids, _solo(tlm, prompts, 6, kv)):
        np.testing.assert_array_equal(out[sid], np.asarray(jout[jsid]))
        np.testing.assert_array_equal(out[sid], want)
    jrouter.close()


#: (case, replica kwargs, prefill-tier kwargs) the router refuses; "lm"
#: gives the replica a model of another vocab.
COMPAT_CASES = [
    ("page", dict(page_size=2 * PAGE), {}),
    ("dtype", {}, dict(kv_cache_dtype="int8")),
    ("dense", dict(kv_layout="slots"), {}),
    ("vocab", dict(lm=True), {}),
]


def test_check_compat_refusals_equal_jax(lm_setup):
    """A replica whose page size, KV dtype, layout or vocab differs from
    the prefill tier's is refused with the JAX router's message."""
    jlm, variables, tlm = lm_setup
    jlm2 = J.transformer_lm(VOCAB + 1, 32, 2, 4, 64, max_len=96,
                            name="router_lm2")
    jvars2 = jax.device_get(jlm2.graph.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 4), jnp.int32)))
    tlm2 = T.transformer_lm(VOCAB + 1, 32, 2, 4, 64, max_len=96,
                            name="router_lm2", device="cpu")
    for case, rkw, pkw in COMPAT_CASES:
        kw = dict(slots=2, chunk=PAGE, kv_layout="paged", page_size=PAGE)
        kw.update({k: v for k, v in rkw.items() if k != "lm"})
        if kw["kv_layout"] == "slots":
            del kw["page_size"]
        pf = PrefillWorker(tlm, page_size=PAGE, device="cpu", **pkw)
        jpf = JD.PrefillWorker(jlm, variables, page_size=PAGE, **pkw)
        rep = ContinuousBatcher(tlm2 if "lm" in rkw else tlm, **kw)
        jrep = JC.ContinuousBatcher(jlm2 if "lm" in rkw else jlm,
                                    jvars2 if "lm" in rkw else variables,
                                    **kw)
        with pytest.raises(ValueError) as ours:
            FleetRouter({"bad": rep}, prefill=pf)
        with pytest.raises(ValueError) as theirs:
            JR.FleetRouter({"bad": jrep}, prefill=jpf)
        assert str(ours.value) == str(theirs.value), case
        router = FleetRouter({"ok": _replica(tlm, kv=pf.kv_cache_dtype)},
                             prefill=pf)
        with pytest.raises(ValueError):
            router.add_replica("bad", rep)
        with pytest.raises(ValueError, match="already attached"):
            router.add_replica("ok", _replica(tlm, kv=pf.kv_cache_dtype))
        router.close()


def test_prefill_worker_sp_state_and_failed_jobs(lm_setup):
    """The one-rank port's sp state: no prompt is sp-eligible (the JAX
    predicate over ``_sp``), and a failed job the tier reports fails its
    request cleanly through the router's tick and through
    ``DisaggServer``'s."""
    tlm = lm_setup[2]
    pf = PrefillWorker(tlm, page_size=PAGE, device="cpu")
    assert pf._sp is None and pf.failed_jobs == []
    assert not any(pf.sp_eligible(n) for n in (1, PAGE + 1, 10_000))
    st = pf.stats()
    assert st["sp_prefills"] == 0 and st["sp_width"] == 1
    router = FleetRouter({"d0": _replica(tlm)}, prefill=pf,
                         disagg=DisaggConfig(prompt_threshold=2 * PAGE,
                                             busy_prompt_threshold=2 * PAGE))
    prompt = np.random.RandomState(9).randint(1, VOCAB, size=40).astype(
        np.int32)
    sid = router.submit(prompt, 4)
    assert router._tracked[sid].tier == "prefill"
    pf.cancel(sid)
    pf.failed_jobs.append((sid, "sp prefill failed"))
    out = router.run()
    assert out[sid].shape == (0,) and router.failed == 1
    assert pf.failed_jobs == []
    router.close()
    # DisaggServer's tick drains the list the same way.
    srv = DisaggServer(_replica(tlm), pf, DisaggConfig(
        prompt_threshold=2 * PAGE, busy_prompt_threshold=2 * PAGE),
        device="cpu")
    sid = srv.submit(prompt, 4)
    pf.cancel(sid)
    pf.failed_jobs.append((sid, "sp prefill failed"))
    srv.tick()
    assert srv.run()[sid].shape == (0,) and srv.failed == 1
    assert pf.failed_jobs == []


# -- the capacity plane's router-facing pieces -------------------------------


def test_federated_store_evicts_dead_lease_books():
    """A dead lease's book ages in the fleet view, and past
    ``capacity_max_age_s`` it evicts for good."""
    store = FederatedStore()
    reg = WorkerRegistry()
    store.attach_registry(reg)
    try:
        token = reg.register("cap-w0", meta={
            "capacity": TCAP.stage_book(1, backlog=0)}, ttl_s=60)
        assert "lease:cap-w0" in store.capacity_snapshot()["replicas"]
        reg.deregister("cap-w0", token)
        assert "lease:cap-w0" in store.capacity_snapshot()["replicas"]
        store.capacity_max_age_s = 0.01
        time.sleep(0.03)
        assert "lease:cap-w0" not in store.capacity_snapshot()["replicas"]
        store.capacity_max_age_s = 60.0
        assert "lease:cap-w0" not in store.capacity_snapshot()["replicas"]
    finally:
        store.close()


def _get_json(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return json.loads(r.read().decode())


def _load_fleet_top():
    path = pathlib.Path(__file__).resolve().parent.parent / "scripts" / (
        "fleet_top.py")
    spec = importlib.util.spec_from_file_location("fleet_top", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_placements_endpoint_and_fleet_top_route_column(
        clean_slate, lm_setup, capsys):
    """``GET /fleet/placements`` serves a port router's ``placements()``
    through the port's exporter (404 without a provider), and
    ``scripts/fleet_top.py`` renders each replica's ROUTE column from the
    exporter's ``/fleet/capacity`` (the replicas' lease books) and
    ``/fleet/placements``."""
    tlm = lm_setup[2]
    reg = WorkerRegistry()
    store = FederatedStore()
    store.attach_registry(reg)
    router = FleetRouter({"r0": _replica(tlm), "r1": _replica(tlm)},
                         registry=reg)
    rng = np.random.RandomState(4)
    for _ in range(4):
        router.submit(rng.randint(1, VOCAB, size=12).astype(np.int32), 3)
    router.run()
    srv = serve_metrics(port=0, store=store,
                        placements_provider=router.placements)
    bare = serve_metrics(port=0, store=FederatedStore())
    try:
        port = srv.server_address[1]
        got = _get_json(port, "/fleet/placements")
        want = json.loads(json.dumps(router.placements()))
        assert got == want and len(got["decisions"]) == 4
        with pytest.raises(urllib.error.HTTPError) as e:
            _get_json(bare.server_address[1], "/fleet/placements")
        assert e.value.code == 404
        caps = _get_json(port, "/fleet/capacity")["replicas"]
        assert {"lease:decode:r0", "lease:decode:r1"} <= set(caps)
        ft = _load_fleet_top()
        counts = {n: sum(d["replica"] == n for d in got["decisions"])
                  for n in ("r0", "r1")}
        for n in ("r0", "r1"):
            route, k = ft._route_col(f"lease:decode:{n}", got)
            assert k == counts[n]
            assert route == "-" if not k else route.startswith(f"{k}x ")
        assert ft.main(["--url", f"http://127.0.0.1:{port}", "--once"]) == 0
        lines = capsys.readouterr().out.splitlines()
        assert lines[0].split()[-1] == "ROUTE"
        rows = {ln.split()[0]: ln.rstrip() for ln in lines[1:]}
        for n in ("r0", "r1"):
            assert rows[f"lease:decode:{n}"].endswith(
                "  " + ft._route_col(f"lease:decode:{n}", got)[0])
    finally:
        for s in (srv, bare):
            s.shutdown()
            s.server_close()
        router.close()
        store.close()
