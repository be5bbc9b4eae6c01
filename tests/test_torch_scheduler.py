"""The port's traffic control (``adapt_tpu_torch/runtime/scheduler.py`` and
the batcher's share of it) against the JAX package's, on the CPU.

- ``AdmissionQueue``: the same seeded operation sequences (appends,
  pops, front re-inserts, cancels, shed toggles) through both queues give
  the same pop order, the same rejections and the same ``depths()``: no
  config (strict FIFO), priority classes, DRR 2:1, burst and depth caps,
  the best-effort shed, front re-insert and the cache-aware window under
  one probe.
- ``DegradationController``: one scripted pressure trajectory
  (``degrade_dwell_s=0``) takes both controllers through the same rungs,
  up and down; on a speculative paged batcher the ladder climbs and comes
  back as JAX's does.
- Preemption (TTFT budget 1e-4): the same victim as JAX, both streams
  token-equal to JAX's and to each request alone, ``on_token`` indices
  0..n-1 delivered exactly once, the paged victim re-admitted as a prefix
  hit; page starvation with a free slot; equal classes spared.
- SLO books: counters, per-tenant verdicts, good tokens and attainment
  equal JAX's at budgets always met (1e6) or always missed (1e-9).
- Rejections, the cache-aware admission order and a dropped slot."""

import importlib
import random
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapt_tpu_torch.config import (
    SchedulerConfig,
    SLOSpec,
    SpeculativeConfig,
    TenantQuota,
)
from adapt_tpu_torch.convert import from_flax
from adapt_tpu_torch.models import transformer_lm as T
from adapt_tpu_torch.runtime.continuous import ContinuousBatcher
from adapt_tpu_torch.runtime.scheduler import (
    AdmissionQueue,
    DegradationController,
    QueueFullError,
)
from adapt_tpu_torch.utils.metrics import global_metrics
from adapt_tpu_torch.utils.tracing import global_flight_recorder

J = importlib.import_module("adapt_tpu.models.transformer_lm")
JC = importlib.import_module("adapt_tpu.runtime.continuous")
JS = importlib.import_module("adapt_tpu.runtime.scheduler")
JCfg = importlib.import_module("adapt_tpu.config")
JM = importlib.import_module("adapt_tpu.utils.metrics")
JT = importlib.import_module("adapt_tpu.utils.tracing")

VOCAB, MAX_LEN = 29, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def clean():
    for reg in (global_metrics(), JM.global_metrics()):
        reg.reset()
    for fr in (global_flight_recorder(), JT.global_flight_recorder()):
        fr.clear()
    yield


@pytest.fixture(scope="module")
def lm_setup():
    jlm = J.lm_tiny(vocab=VOCAB, max_len=MAX_LEN)
    variables = jax.device_get(
        jlm.graph.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32)))
    tlm = T.lm_tiny(vocab=VOCAB, max_len=MAX_LEN, device="cpu")
    tlm.load_state_dict(from_flax(variables))
    return jlm, variables, tlm


def _both(lm_setup, layout="slots", draft=False, scheduler=None, **kw):
    """A JAX batcher and the port's with the same arguments; ``scheduler``
    is a dict of SchedulerConfig fields (with TenantQuota values given as
    (weight, burst))."""
    jlm, variables, tlm = lm_setup
    kw = dict(kw, chunk=4)
    if layout == "paged":
        kw.update(kv_layout="paged", page_size=8)
    jkw, tkw = dict(kw), dict(kw)
    if scheduler is not None:
        jq = {t: JCfg.TenantQuota(*q) for t, q in
              scheduler.get("quotas", {}).items()}
        tq = {t: TenantQuota(*q) for t, q in
              scheduler.get("quotas", {}).items()}
        jkw["scheduler"] = JCfg.SchedulerConfig(**{**scheduler, "quotas": jq})
        tkw["scheduler"] = SchedulerConfig(**{**scheduler, "quotas": tq})
    if draft:
        spec = kw.pop("speculative")
        jkw.update(draft_lm=jlm, draft_variables=variables,
                   speculative=JCfg.SpeculativeConfig(spec.draft_k))
        tkw.update(draft_lm=tlm, speculative=spec)
    return (JC.ContinuousBatcher(jlm, variables, **jkw),
            ContinuousBatcher(tlm, **tkw))


def _solo(tlm, prompt, steps):
    return T.generate(tlm, np.asarray(prompt)[None], steps)[0].numpy()


# -- AdmissionQueue: seeded operation sequences -----------------------------


class _Req:
    """Duck-typed request: the queue reads ``req_id``, ``slo``,
    ``t_submit`` / ``t_requeued`` and (through the probe) ``prompt``."""

    def __init__(self, req_id, slo):
        self.req_id = req_id
        self.slo = slo
        self.t_submit = float(req_id)
        self.t_requeued = 0.0


QUEUE_CASES = {
    "fifo": None,
    "priorities": dict(),
    "drr_2_1": dict(quotas={"a": (2.0,), "b": (1.0,)}),
    "burst_and_depth": dict(max_queue_depth=9,
                            quotas={"a": (1.0, 3), "b": (2.0, 4)}),
    "shed": dict(quotas={"a": (1.5,)}),
    "front_reinsert": dict(quotas={"a": (1.0,), "b": (0.5,)}),
    "cache_aware": dict(cache_aware=True, cache_aware_window=4),
}


def _queue_ops(case: str, seed: int, n: int = 160):
    """One seeded op sequence: ("append", tenant, prio) | ("pop",) |
    ("appendleft",) (re-insert the last popped request) |
    ("remove", id) | ("shed", flag)."""
    rng = random.Random(seed)
    tenants = ["a", "b", "c"]
    prios = [0] if case in ("drr_2_1", "burst_and_depth") else [-1, 0, 0, 2]
    ops = []
    for i in range(n):
        r = rng.random()
        if r < 0.5:
            ops.append(("append", rng.choice(tenants), rng.choice(prios)))
        elif r < 0.8:
            ops.append(("pop",))
        elif r < 0.88:
            ops.append(("appendleft",))
        elif r < 0.95:
            ops.append(("remove", rng.randrange(max(1, i))))
        elif case == "shed":
            ops.append(("shed", rng.random() < 0.5))
        else:
            ops.append(("pop",))
    return ops


def _run_queue(queue, spec_cls, ops, probe_scores):
    if probe_scores is not None:
        queue.prefix_probe = lambda r: probe_scores[r.req_id]
    out, last, next_id = [], None, 0
    for op in ops:
        if op[0] == "append":
            req = _Req(next_id, spec_cls(tenant=op[1], priority=op[2]))
            next_id += 1
            try:
                queue.append(req)
                out.append(("ok", req.req_id))
            except (QueueFullError, JS.QueueFullError) as e:
                out.append(("reject", type(e).__name__))
        elif op[0] == "pop":
            try:
                last = queue.popleft()
                out.append(("pop", last.req_id))
            except IndexError:
                out.append(("empty",))
        elif op[0] == "appendleft":
            if last is not None:
                queue.appendleft(last)
                out.append(("front", last.req_id))
                last = None
        elif op[0] == "remove":
            got = queue.remove_id(op[1])
            out.append(("remove", None if got is None else got.req_id))
        else:
            queue.shed_best_effort = op[1]
        out.append(("depths", tuple(sorted(queue.depths().items())),
                    len(queue)))
    out.append(("drain", [r.req_id for r in list(queue)]))
    return out


@pytest.mark.parametrize("case", sorted(QUEUE_CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_queue_ops_match_jax(case, seed):
    cfg = QUEUE_CASES[case]
    probe = None
    if case == "cache_aware":
        rng = random.Random(100 + seed)
        # Some requests score None (cold), the rest (tokens, heat).
        probe = [None if rng.random() < 0.4
                 else (rng.randrange(3) * 8, rng.randrange(5))
                 for _ in range(400)]
    ops = _queue_ops(case, seed)
    if cfg is None:
        tq, jq = AdmissionQueue(), JS.AdmissionQueue()
    else:
        quotas = cfg.get("quotas", {})
        tq = AdmissionQueue(SchedulerConfig(**{**cfg, "quotas": {
            t: TenantQuota(*q) for t, q in quotas.items()}}))
        jq = JS.AdmissionQueue(JCfg.SchedulerConfig(**{**cfg, "quotas": {
            t: JCfg.TenantQuota(*q) for t, q in quotas.items()}}))
    got = _run_queue(tq, SLOSpec, ops, probe)
    want = _run_queue(jq, JCfg.SLOSpec, ops, probe)
    rejects = [o for o in got if o[0] == "reject"]
    assert got == want
    assert all(o[1] == "QueueFullError" for o in rejects)
    if case in ("burst_and_depth", "shed"):
        assert rejects, "the sequence never met a bound"
    pops = [o for o in got if o[0] == "pop"]
    assert len(pops) > 20


def test_preempt_candidate_matches_jax():
    """The nomination: the top non-empty class's head with the largest
    burned share of its TTFT budget; FIFO mode never nominates."""
    picks = []
    for mod, spec, cfg in ((None, SLOSpec, SchedulerConfig()),
                           (JS, JCfg.SLOSpec, JCfg.SchedulerConfig())):
        q = (AdmissionQueue if mod is None else mod.AdmissionQueue)(cfg)
        fifo = (AdmissionQueue if mod is None else mod.AdmissionQueue)()
        for i, (t, p, b) in enumerate([("a", 0, 10.0), ("b", 1, None),
                                       ("c", 1, 1e3), ("d", 1, 1e4),
                                       ("e", 0, 1e-3)]):
            r = _Req(i, spec(tenant=t, priority=p, ttft_budget_s=b))
            q.append(r)
            fifo.append(r)
        got = q.preempt_candidate()
        picks.append((got[0].req_id, got[1], fifo.preempt_candidate()))
    assert picks[0] == picks[1] == (2, 1, None)


# -- the degradation ladder -------------------------------------------------


class _Queue:
    def __init__(self):
        self.n = 0
        self.shed_best_effort = False

    def __len__(self):
        return self.n


class _Bat:
    """What the controller reads and moves on a batcher."""

    def __init__(self):
        self._cv = threading.Condition()
        self._queue = _Queue()
        self.slots = [types.SimpleNamespace(req=None) for _ in range(4)]
        self._slo_totals = dict(ttft_met=0, ttft_missed=0, itl_met=0,
                                itl_missed=0)
        self._spec = types.SimpleNamespace(draft_k=4)
        self._paged = True
        self.acts = []
        self._pager = types.SimpleNamespace(
            evict_cached=lambda: self.acts.append("evict"))

    def set_draft_k(self, k):
        self.acts.append(("draft_k", k))


#: (queued, occupied slots, TTFT met delta, missed delta) per step, for a
#: queue bound of 16: calm, a backlog (4 rungs up and a hold), a half-way
#: backlog (hold), drained (4 rungs down), then overload by attainment
#: (a short queue, full slots, TTFT missed) and its recovery.
TRAJECTORY = ([(0, 2, 0, 0)] * 2 + [(10, 4, 1, 0)] * 5 + [(4, 4, 0, 0)] * 2
              + [(0, 1, 2, 0)] * 5 + [(2, 4, 0, 6)] * 3 + [(0, 0, 5, 0)] * 4)


def test_degradation_controller_matches_jax(clean):
    cfg = dict(max_queue_depth=16, degrade_dwell_s=0.0)
    levels, events, acts = [], [], []
    for ctl_cls, cfg_cls, fr in (
            (DegradationController, SchedulerConfig,
             global_flight_recorder()),
            (JS.DegradationController, JCfg.SchedulerConfig,
             JT.global_flight_recorder())):
        ctl, bat = ctl_cls(cfg_cls(**cfg)), _Bat()
        seen = []
        for queued, occ, met, missed in TRAJECTORY:
            bat._queue.n = queued
            for j, s in enumerate(bat.slots):
                s.req = object() if j < occ else None
            bat._slo_totals["ttft_met"] += met
            bat._slo_totals["ttft_missed"] += missed
            ctl.step(bat)
            seen.append(ctl.level)
        levels.append(seen)
        acts.append(bat.acts + [bat._queue.shed_best_effort])
        events.append([(e["data"]["level"], e["data"]["step"],
                        e["data"]["direction"])
                       for e in fr.events("degradation_step")])
    assert levels[0] == levels[1]
    assert events[0] == events[1]
    assert acts[0] == acts[1]
    assert max(levels[0]) == 4 and levels[0][-1] == 0
    ups = [s for _, s, d in events[0] if d == "up"]
    assert ups[:4] == list(DegradationController.LADDER)
    # The attainment leg climbed again without a deep queue.
    assert levels[0][14:17] == [1, 2, 3]


def test_ladder_on_a_speculative_batcher_matches_jax(clean, lm_setup):
    """Backlog pressure on a paged speculative batcher walks draft_k 4 ->
    2, the (no-op) busy threshold, the cold-page sweep and the best-effort
    shed, then the drained batcher steps back to draft_k 4 — the same rungs
    in the same order as the JAX batcher's, with the same streams."""
    sched = dict(max_queue_depth=8, degrade=True, degrade_dwell_s=0.0,
                 degrade_occupancy=0.0, degrade_queue_high=0.25,
                 degrade_queue_low=0.05, preempt=False)
    jb, tb = _both(lm_setup, "paged", draft=True, slots=2, scheduler=sched,
                   speculative=SpeculativeConfig(draft_k=4))
    rng = np.random.RandomState(0)
    warm = rng.randint(0, VOCAB, 9)
    flood = [rng.randint(0, VOCAB, 4) for _ in range(6)]
    seen, outs = [], []
    for bat, spec_cls, fr in ((jb, JCfg.SLOSpec, JT.global_flight_recorder()),
                              (tb, SLOSpec, global_flight_recorder())):
        bat.submit(warm, 2)
        bat.run()
        assert bat.stats()["pages_cached"] > 0
        ids = [bat.submit(p, 30) for p in flood]
        for _ in range(4):
            bat.tick()
        st = bat.stats()
        row = [st["degradation_level"], bat._spec_k_eff,
               bat._queue.shed_best_effort, st["pages_cached"]]
        with pytest.raises(Exception) as err:
            bat.submit(rng.randint(0, VOCAB, 4), 2,
                       slo=spec_cls(tenant="be", priority=-1))
        assert type(err.value).__name__ == "QueueFullError"
        out = bat.run()
        outs.append([out[i].tolist() for i in ids])
        for _ in range(6):
            bat.tick()
        row += [bat.stats()["degradation_level"], bat._spec_k_eff,
                bat._queue.shed_best_effort]
        row.append([(e["data"]["step"], e["data"]["direction"])
                    for e in fr.events("degradation_step")])
        seen.append(row)
        bat.close()
    assert seen[0] == seen[1]
    assert seen[1][:7] == [4, 2, True, 0, 0, 4, False]
    assert [s for s, d in seen[1][7] if d == "up"] == list(
        DegradationController.LADDER)
    assert outs[0] == outs[1]


# -- preemption -------------------------------------------------------------


@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_preemption_matches_jax_and_is_exactly_once(clean, lm_setup, layout):
    """A high-priority request with a 1e-4 s TTFT budget preempts the
    running low-priority one (slots=1): the victim is JAX's, both streams
    equal JAX's and each request alone, ``on_token`` delivers every index
    once, and the paged victim re-admits through the prefix cache."""
    _, _, tlm = lm_setup
    p_low = np.arange(10) % VOCAB
    p_hi = (np.arange(7) * 3) % VOCAB
    sched = dict(preempt=True, preempt_ttft_fraction=0.5, degrade=False)
    jb, tb = _both(lm_setup, layout, slots=1, scheduler=sched)
    runs = []
    for bat, spec_cls, fr in ((jb, JCfg.SLOSpec, JT.global_flight_recorder()),
                              (tb, SLOSpec, global_flight_recorder())):
        delivered: dict[int, list] = {}

        def cb(rid, tok, idx, delivered=delivered):
            delivered.setdefault(rid, []).append((idx, tok))

        low = bat.submit(p_low, 20, on_token=cb,
                         slo=spec_cls(tenant="free", priority=0))
        bat.tick()
        bat.tick()
        assert len(delivered.get(low, [])) > 0
        hi = bat.submit(p_hi, 10, on_token=cb,
                        slo=spec_cls(ttft_budget_s=1e-4, tenant="gold",
                                     priority=10))
        out = bat.run()
        ev = fr.events("preempted")
        runs.append(dict(
            victims=[(e["data"]["request"], e["data"]["for_request"])
                     for e in ev],
            out={r: out[r].tolist() for r in (low, hi)},
            delivered=delivered, stats=bat.stats(), ids=(low, hi)))
        bat.close()
    jr, tr = runs
    low, hi = tr["ids"]
    assert tr["victims"] == jr["victims"] == [(low, hi)]
    assert tr["out"] == jr["out"]
    assert tr["stats"]["preempted"] == 1
    assert global_metrics().snapshot()["counters"][
        "scheduler.preempted_total"] == 1
    for rid, p, n in ((low, p_low, 20), (hi, p_hi, 10)):
        solo = _solo(tlm, p, n)
        assert tr["out"][rid] == solo.tolist()
        assert [i for i, _ in tr["delivered"][rid]] == list(range(n))
        assert [t for _, t in tr["delivered"][rid]] == solo.tolist()
    assert tr["stats"]["regen_mismatches"] == 0
    assert tr["stats"]["admitted"] == tr["stats"]["completed"] + 1 == 3
    if layout == "paged":
        assert tr["stats"]["prefix_hits"] > 0
        assert tr["stats"]["prefix_hits"] == jr["stats"]["prefix_hits"]
        assert tr["stats"]["pages_in_use"] == 0


def test_preemption_on_page_starvation_with_a_free_slot(clean, lm_setup):
    """A free slot is not enough: the high-priority head needs pages the
    low-priority decode holds, so that decode is preempted (as in JAX)."""
    sched = dict(preempt=True, preempt_ttft_fraction=0.5, degrade=False)
    jb, tb = _both(lm_setup, "paged", slots=2, pool_pages=10,
                   scheduler=sched)
    seen = []
    for bat, spec_cls, fr in ((jb, JCfg.SLOSpec, JT.global_flight_recorder()),
                              (tb, SLOSpec, global_flight_recorder())):
        rng = np.random.RandomState(7)
        low = bat.submit(rng.randint(0, VOCAB, 8), 40,
                         slo=spec_cls(tenant="free", priority=0))
        bat.tick()
        assert sum(1 for s in bat.slots if s.req is None) == 1
        hi = bat.submit(rng.randint(0, VOCAB, 24), 16,
                        slo=spec_cls(ttft_budget_s=1e-4, tenant="gold",
                                     priority=10))
        out = bat.run()
        seen.append(([e["data"]["request"] for e in fr.events("preempted")],
                     out[low].tolist(), out[hi].tolist()))
        bat.close()
    assert seen[0] == seen[1]
    assert seen[1][0] == [0]
    assert len(seen[1][1]) == 40 and len(seen[1][2]) == 16


def test_preemption_spares_equal_classes_and_picks_the_lowest(clean,
                                                              lm_setup):
    sched = dict(preempt=True, preempt_ttft_fraction=0.5, degrade=False)
    jb, tb = _both(lm_setup, slots=2, scheduler=sched)
    seen = []
    for bat, spec_cls, fr in ((jb, JCfg.SLOSpec, JT.global_flight_recorder()),
                              (tb, SLOSpec, global_flight_recorder())):
        rng = np.random.RandomState(3)
        bat.submit(rng.randint(0, VOCAB, 6), 24,
                   slo=spec_cls(tenant="m", priority=5))
        low = bat.submit(rng.randint(0, VOCAB, 6), 24,
                         slo=spec_cls(tenant="l", priority=1))
        bat.tick()
        bat.submit(rng.randint(0, VOCAB, 4), 4,
                   slo=spec_cls(ttft_budget_s=1e-4, tenant="g", priority=9))
        out = bat.run()
        seen.append(([e["data"]["request"] for e in fr.events("preempted")],
                     {k: v.tolist() for k, v in out.items()}))
        assert seen[-1][0] == [low]
        bat.close()
    assert seen[0] == seen[1]
    # A priority-9 slot is never preempted for another priority-9 request.
    _, tb2 = _both(lm_setup, slots=1, scheduler=sched)
    a = tb2.submit(np.arange(6) % VOCAB, 12, slo=SLOSpec(priority=9))
    tb2.tick()
    b = tb2.submit(np.arange(6) % VOCAB, 4,
                   slo=SLOSpec(ttft_budget_s=1e-4, priority=9))
    out = tb2.run()
    assert tb2.stats()["preempted"] == 0
    assert len(out[a]) == 12 and len(out[b]) == 4


# -- SLO books --------------------------------------------------------------


@pytest.mark.parametrize("budget", [1e6, 1e-9], ids=["met", "missed"])
@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_slo_books_match_jax(clean, lm_setup, budget, layout):
    jb, tb = _both(lm_setup, layout, slots=2)
    rng = np.random.RandomState(5)
    traffic = [(rng.randint(0, VOCAB, n), s, t)
               for n, s, t in ((5, 9, "t0"), (11, 6, "t1"), (3, 7, "t0"),
                               (8, 5, None))]
    books = []
    for bat, spec_cls, reg in ((jb, JCfg.SLOSpec, JM.global_metrics()),
                               (tb, SLOSpec, global_metrics())):
        reg.reset()
        for p, steps, tenant in traffic:
            slo = (None if tenant is None else
                   spec_cls(ttft_budget_s=budget, itl_budget_s=budget,
                            tenant=tenant))
            bat.submit(p, steps, slo=slo)
        bat.run()
        st = bat.stats()
        snap = reg.snapshot()
        c, g = snap["counters"], snap["gauges"]
        books.append(dict(
            stats={k: st[k] for k in st if k.startswith("slo_")},
            counters={k: v for k, v in c.items()
                      if k.startswith("slo.") or k in (
                          "continuous.good_tokens_total",
                          "continuous.tokens_total")},
            gauges={k: v for k, v in g.items()
                    if k.startswith("slo.")}))
        assert "continuous.goodput_tokens_s" in g
        bat.close()
    assert books[0] == books[1]
    tokens = sum(s for _, s, _ in traffic)
    slo_reqs = [(s, t) for _, s, t in traffic if t is not None]
    c = books[1]["counters"]
    assert c["continuous.tokens_total"] == tokens
    if budget > 1:
        assert books[1]["stats"]["slo_ttft_met"] == len(slo_reqs)
        assert books[1]["gauges"]["slo.ttft_attainment"] == 1.0
        assert c["continuous.good_tokens_total"] == tokens
        assert c["slo.met_total.t0"] == 2 and c["slo.met_total.t1"] == 1
    else:
        assert books[1]["stats"]["slo_ttft_missed"] == len(slo_reqs)
        assert books[1]["stats"]["slo_itl_missed"] == sum(
            s - 1 for s, _ in slo_reqs)
        assert books[1]["gauges"]["slo.itl_attainment"] == 0.0
        # Only the request without an SLO stays good.
        assert c["continuous.good_tokens_total"] == traffic[3][1]
        assert c["slo.missed_total.t0"] == 2
        assert len(global_flight_recorder().events("slo_missed")) == 3


# -- rejections, cache-aware admission, drops -------------------------------


def test_submit_rejects_synchronously_and_books_it(clean, lm_setup):
    jb, tb = _both(lm_setup, slots=1, scheduler=dict(
        max_queue_depth=2, preempt=False, degrade=False))
    books = []
    for bat, reg, fr in ((jb, JM.global_metrics(),
                          JT.global_flight_recorder()),
                         (tb, global_metrics(), global_flight_recorder())):
        rng = np.random.RandomState(0)
        accepted, rejected = [], 0
        for _ in range(6):
            try:
                accepted.append(bat.submit(rng.randint(0, VOCAB, 4), 4))
            except Exception as e:
                assert type(e).__name__ == "QueueFullError"
                rejected += 1
        st = bat.stats()
        c = reg.snapshot()["counters"]
        books.append((rejected, st["queued"], st["rejected"],
                      fr.kind_counts().get("request_rejected"),
                      c["scheduler.rejected_total"],
                      c["scheduler.admitted_total"],
                      sorted(bat.run()) == sorted(accepted)))
        bat.close()
    assert books[0] == books[1] == (4, 2, 4, 4, 4.0, 2.0, True)
    # admission_check records a rejection exactly as submit does.
    tb2 = ContinuousBatcher(lm_setup[2], slots=1, scheduler=SchedulerConfig(
        quotas={"x": TenantQuota(burst=1)}, degrade=False))
    tb2.submit(np.arange(3), 2, slo=SLOSpec(tenant="x"))
    with pytest.raises(QueueFullError, match="burst"):
        tb2.admission_check(SLOSpec(tenant="x"))
    tb2.admission_check(SLOSpec(tenant="y"))
    assert tb2.stats()["rejected"] == 1


@pytest.mark.parametrize("aware", [True, False])
def test_cache_aware_admission_prefers_resident_prefix(clean, lm_setup,
                                                       aware):
    """With ``cache_aware`` a queued request whose prefix is resident
    admits before an earlier cold one of the same class; without it the
    order stays FIFO — on both packages."""
    jb, tb = _both(lm_setup, "paged", slots=1,
                   scheduler=dict(cache_aware=aware))
    orders = []
    for bat in (jb, tb):
        rng = np.random.RandomState(31)
        warm = rng.randint(0, VOCAB, 17)
        cold = rng.randint(0, VOCAB, 17)
        warm_again = np.concatenate([warm, rng.randint(0, VOCAB, 5)])
        bat.submit(warm, 3)
        bat.run()
        first: list[int] = []

        def cb(rid, tok, idx, first=first):
            if rid not in first:
                first.append(rid)

        b = bat.submit(cold, 3, on_token=cb)
        c = bat.submit(warm_again, 3, on_token=cb)
        bat.run()
        orders.append(first)
        assert first == ([c, b] if aware else [b, c])
        bat.close()
    assert orders[0] == orders[1]


def test_drop_slot_finishes_once_with_an_empty_result(clean, lm_setup):
    _, _, tlm = lm_setup
    bat = ContinuousBatcher(tlm, slots=2, chunk=4, kv_layout="paged",
                            page_size=8)
    a = bat.submit(np.arange(9) % VOCAB, 12, slo=SLOSpec(tenant="t"))
    b = bat.submit(np.arange(5) % VOCAB, 6)
    bat.tick()
    slot = next(s for s in bat.slots if s.req is not None
                and s.req.req_id == a)
    bat._drop_slot(slot)
    out = bat.run()
    assert out[a].shape == (0,) and len(out[b]) == 6
    st = bat.stats()
    assert st["admitted"] == st["completed"] == 2
    assert st["pages_in_use"] == 0
    assert global_metrics().snapshot()["counters"]["slo.missed_total.t"] == 1
    kinds = global_flight_recorder().kind_counts()
    assert kinds["request_dropped"] == 1 and kinds["finish"] == 2


def test_config_validation():
    with pytest.raises(ValueError, match="ttft_budget_s"):
        SLOSpec(ttft_budget_s=0.0)
    with pytest.raises(ValueError, match="tenant"):
        SLOSpec(tenant="")
    with pytest.raises(TypeError, match="SLOSpec"):
        ContinuousBatcher(
            T.lm_tiny(vocab=VOCAB, max_len=MAX_LEN, device="cpu"),
            slots=1).submit([1, 2], 2, slo={"ttft_budget_s": 1.0})
