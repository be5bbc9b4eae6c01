"""The port's capacity plane (``runtime/capacity.py``) against the JAX
package's, on the CPU.

Both packages' forecasters, health scores and affinity sketches are fed
the same synthetic inputs under an injected clock and must give equal
books: forecasts, snapshots and calibration verdicts exactly equal (the
same float arithmetic), sketches and affinity scores exactly equal (the
same blake2b digests of the same content keys). Then the book on a live
paged batcher of the port: headroom reconciled against the pager,
submit-time forecasts, calibration pairs, and a plane that is off."""

import importlib
import json

import numpy as np
import pytest
import torch

from adapt_tpu_torch.config import CapacityConfig
from adapt_tpu_torch.models import transformer_lm as T
from adapt_tpu_torch.runtime import capacity as C
from adapt_tpu_torch.runtime import paged as TPAGED
from adapt_tpu_torch.runtime.continuous import ContinuousBatcher
from adapt_tpu_torch.runtime.paged import Pager

JCAP = importlib.import_module("adapt_tpu.runtime.capacity")
JPAGED = importlib.import_module("adapt_tpu.runtime.paged")
JCFG = importlib.import_module("adapt_tpu.config")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _drive_forecaster(mod):
    """One synthetic journey: cold forecast, additive learning, bucket
    fallbacks, the snap-down, calibration verdicts and the bias."""
    f = mod.TTFTForecaster(alpha=0.2, window=8)
    out = [f.forecast(32)]
    rng = np.random.default_rng(4)
    for i in range(40):
        f.observe_queue_wait(float(rng.uniform(0.001, 0.02)))
        n = int(rng.integers(1, 300))
        f.observe_prefill(n, float(n * rng.uniform(1e-5, 5e-5)))
        f.observe_tick_gap(float(rng.uniform(0.002, 0.01)))
        if i == 10:
            f.observe_prefill(8, 2.0)  # a build-inflated wall
            f.observe_prefill(8, 0.002)  # snapped down
        fc = f.forecast(int(rng.integers(1, 600)),
                        int(rng.integers(0, 64)))
        out.append(fc)
        out.append(f.record_realized(fc, fc * float(rng.uniform(0.3, 4))))
    out.append(f._wall_for(4096))
    out.append(f.calibration())
    f.reset_calibration()
    out.append(f.calibration())
    return out, f.snapshot()


def test_forecaster_equals_jax():
    got, snap = _drive_forecaster(C)
    want, jsnap = _drive_forecaster(JCAP)
    assert got == want and snap == jsnap
    assert got[0] == 0.0 and json.loads(json.dumps(snap)) == snap
    # The router-side replay of a shipped snapshot equals the replica's.
    for n, hit in ((1, 0), (100, 32), (5000, 0)):
        assert C.forecast_from_snapshot(snap, n, hit) == (
            JCAP.forecast_from_snapshot(jsnap, n, hit))


def test_health_hysteresis_equals_jax_under_injected_clock():
    steps = [(2, 10.0), (0, 10.5), (0, 10.9), (1, 11.0), (1, 11.9),
             (1, 12.1), (2, 12.2), (0, 13.0), (2, 13.5), (0, 14.2),
             (0, 15.3), (5, 16.0), (-1, 20.0), (-1, 21.5)]
    books = []
    for mod in (C, JCAP):
        h = mod.HealthScore(dwell_s=1.0)
        books.append([(h.update(t, now=now), h.name) for t, now in steps])
    assert books[0] == books[1]
    assert books[0][:3] == [(2, "critical")] * 3
    assert books[0][5] == (1, "degraded") and books[0][10] == (0, "ok")


def _pager(mod, prompts, P=4, hits=()):
    p = mod.Pager(num_pages=32, slots=8, pages_per_slot=8, page_tokens=P)
    for slot, toks in enumerate(prompts):
        toks = np.asarray(toks, np.int32)
        pages = (len(toks) - 1) // P
        assert p.alloc(slot, pages)
        for j, page in enumerate(p.owned(slot)[:pages]):
            p.register(page, mod.Pager.prefix_key(toks, (j + 1) * P))
    for toks in hits:  # prefix-cache hits heat the radix nodes
        for j in (1, 2):
            p.lookup_share(7, mod.Pager.prefix_key(np.asarray(
                toks, np.int32), j * P))
    return p


def test_sketch_and_affinity_equal_jax():
    hot = np.arange(100, 117)
    deep = np.arange(50, 63)
    churn = [np.arange(1000 + 10 * i, 1005 + 10 * i) for i in range(3)]
    prompts = [hot, deep] + churn
    for k in (32, 2):
        sk = C.sketch_from_pager(_pager(TPAGED, prompts, hits=[hot]), k)
        jsk = JCAP.sketch_from_pager(_pager(JPAGED, prompts,
                                            hits=[hot]), k)
        assert sk == jsk and len(sk["entries"]) <= k
        assert all(set(e) == {"h", "d", "t", "heat"} for e in sk["entries"])
        for probe in (np.concatenate([hot, [1, 2, 3]]),
                      np.concatenate([deep, [7, 7, 7]]),
                      np.arange(900, 917), hot[:3]):
            a = C.affinity_score(sk, probe)
            assert a == JCAP.affinity_score(jsk, probe)
    full = C.sketch_from_pager(_pager(TPAGED, prompts), 32)
    assert C.affinity_score(full, np.concatenate([hot, [1, 2]])) >= 16.0
    assert C.affinity_score(full, np.arange(900, 917)) == 0.0
    assert C.affinity_score({"v": 99}, hot) == 0.0
    assert C.affinity_score({}, hot) == 0.0
    cold = C.sketch_from_pager(Pager(num_pages=32, slots=4, pages_per_slot=8,
                                     page_tokens=4), 32)
    assert cold == JCAP.sketch_from_pager(JPAGED.Pager(
        num_pages=32, slots=4, pages_per_slot=8, page_tokens=4), 32)


def test_stage_and_config_books_equal_jax():
    b, jb = C.stage_book(3, backlog=2), JCAP.stage_book(3, backlog=2)
    b.pop("wall"), jb.pop("wall")
    assert b == jb and b["headroom"] == {"stages": 3, "backlog": 2}
    for field in ("enabled", "refresh_s", "sketch_k", "ewma_alpha",
                  "calibration_window", "health_dwell_s",
                  "lease_refresh_s"):
        assert getattr(CapacityConfig(), field) == getattr(
            JCFG.CapacityConfig(), field)
    with pytest.raises(ValueError):
        CapacityConfig(ewma_alpha=0.0)


def test_capacity_book_on_paged_batcher_reconciles_headroom():
    lm = T.lm_tiny(vocab=31, max_len=96, device="cpu")
    bat = ContinuousBatcher(lm, slots=2, chunk=4, kv_layout="paged",
                            page_size=8,
                            capacity=CapacityConfig(refresh_s=0.0))
    cap = bat._capacity
    rng = np.random.RandomState(0)
    first = rng.randint(1, 31, size=18)
    bat.submit(first, 12)
    for _ in range(5):
        bat.tick()
    book = cap.refresh_book(bat)
    hr = book["headroom"]
    assert book["v"] == C.BOOK_V and book["kind"] == "decode"
    assert hr["slots_total"] == 2
    assert hr["slots_free"] == sum(1 for s in bat.slots if s.req is None)
    ps = bat._pager.stats()
    assert hr["pages_total"] == ps.num_pages
    assert hr["pages_in_use"] == ps.in_use and hr["pages_free"] == ps.free
    assert hr["pages_free"] + hr["pages_in_use"] == hr["pages_total"] - 1
    assert hr["pages_cached"] <= hr["pages_free"]
    assert json.loads(json.dumps(book)) == book
    rid = bat.submit(rng.randint(1, 31, size=10), 4)
    req = next(r for r in bat._queue if r.req_id == rid)
    assert req.ttft_forecast_s > 0.0
    bat.run()
    bat.tick()  # idle flush: the pending pairs drain
    assert cap.forecaster._samples >= 1
    assert 0.0 <= cap.calibration() <= 1.0
    book = bat.capacity_book()
    assert book["forecast"]["samples"] >= 1 and book["health"] == "ok"
    # The affinity of the first prompt's pages (two full pages of 8).
    probe = np.concatenate([first, [1, 2]])
    assert C.affinity_score(book["sketch"], probe) >= 16.0
    assert C.affinity_score(book["sketch"], np.arange(200, 230)) == 0.0
    bat.close()


def test_capacity_disabled_attaches_nothing():
    lm = T.lm_tiny(vocab=31, max_len=64, device="cpu")
    bat = ContinuousBatcher(lm, slots=2, chunk=4,
                            capacity=CapacityConfig(enabled=False))
    assert bat._capacity is None and bat.capacity_book() is None
    rid = bat.submit(np.arange(1, 7), 4)
    assert next(iter(bat._queue)).ttft_forecast_s == 0.0
    assert rid in bat.run()
    bat.close()
