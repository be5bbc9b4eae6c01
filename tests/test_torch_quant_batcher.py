"""The port's ContinuousBatcher over quantized KV caches, on the CPU — the
mirrors of the JAX package's own quantized-serving contracts
(``test_continuous.py::test_int8_slot_caches_match_generate_int8``,
``test_quant_serving.py``'s paged, prefix-cache, chunked-prefill, top-1 and
hot-path tests, ``test_decode_split.py::
test_int4_batcher_lossless_and_prefix_cache``) plus copy-on-write fan-out
and sliding-window recycling over quantized pools.

Greedy quantized streams must be token-equal to the JAX package's batcher
with the same ``kv_cache_dtype`` and to the port's own
``generate(kv_cache_dtype=...)`` for each request alone; int8 streams must
agree with the native ones on at least 75% of positions (the JAX bar); a
steady quantized tick stages nothing host->device; the pool drains;
``cache_bytes_ratio`` counts both planes."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapt_tpu_torch.convert import from_flax
from adapt_tpu_torch.models import transformer_lm as T
from adapt_tpu_torch.runtime.continuous import ContinuousBatcher

J = importlib.import_module("adapt_tpu.models.transformer_lm")
JC = importlib.import_module("adapt_tpu.runtime.continuous")

VOCAB = 37


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test workers at once,
    and these small shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_CACHE = {}


def _pair(key, jlm, tlm):
    if key not in _CACHE:
        variables = jax.device_get(jlm.graph.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32)))
        tlm.load_state_dict(from_flax(variables))
        _CACHE[key] = (jlm, variables, tlm)
    return _CACHE[key]


def _tiny(max_len=48):
    return _pair(max_len, J.lm_tiny(vocab=VOCAB, max_len=max_len),
                 T.lm_tiny(vocab=VOCAB, max_len=max_len, device="cpu"))


def _windowed():
    kw = dict(max_len=128, kv_heads=4, pos="rope", window=16)
    return _pair("window", J.transformer_lm(61, 64, 2, 8, 128, **kw),
                 T.transformer_lm(61, 64, 2, 8, 128, device="cpu", **kw))


def _solo(tlm, prompt, steps, **kw):
    return T.generate(tlm, np.asarray(prompt)[None], steps, **kw)[0].numpy()


def _both(setup, drive, **kw):
    """``drive(batcher)`` on the port's and on the JAX package's batcher."""
    jlm, variables, tlm = setup
    return (drive(ContinuousBatcher(tlm, **kw)),
            drive(JC.ContinuousBatcher(jlm, variables, **kw)))


def _prompts(seed, lens, vocab=VOCAB):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=n).astype(np.int32) for n in lens]


def _ratio(hd, kv_dtype):
    """Quantized / f32-native bytes: values + one f32 scale per vector."""
    width = hd // 2 if kv_dtype == "int4" else hd
    return (width + 4) / (4 * hd)


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_slot_caches_match_generate_and_jax(kv_dtype):
    setup = _tiny()
    prompts = _prompts(5, (4, 7, 3))

    def drive(bat):
        ids = [bat.submit(p, 6) for p in prompts]
        out = bat.run()
        assert bat.stats()["cache_bytes_ratio"] == pytest.approx(
            _ratio(16, kv_dtype))
        return [out[r] for r in ids]

    got, want = _both(setup, drive, slots=2, chunk=4, kv_cache_dtype=kv_dtype)
    for p, g, w in zip(prompts, got, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(
            g, _solo(setup[2], p, 6, kv_cache_dtype=kv_dtype))


def test_int8_paged_staggered_with_cancel_matches_generate_int8():
    setup = _tiny()
    tlm = setup[2]
    prompts = _prompts(3, (3, 9, 5, 12, 7))
    steps = [20, 4, 8, 3, 6]

    def drive(bat):
        ids = [bat.submit(prompts[i], steps[i]) for i in range(2)]
        bat.tick()
        ids += [bat.submit(prompts[i], steps[i]) for i in range(2, 5)]
        bat.tick()
        assert bat.cancel(ids[0])
        out = bat.run()
        st = bat.stats()
        assert st["pages_in_use"] == 0  # both planes back in the pool
        assert st["cache_bytes_ratio"] == pytest.approx(_ratio(16, "int8"))
        return [out[r] for r in ids]

    got, want = _both(setup, drive, slots=3, chunk=4, kv_layout="paged",
                      page_size=16, kv_cache_dtype="int8")
    for i in range(5):
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"req {i}")
        solo = _solo(tlm, prompts[i], steps[i], kv_cache_dtype="int8")
        if i == 0:  # cancelled live
            assert 0 < len(got[0]) < steps[0]
            np.testing.assert_array_equal(got[0], solo[:len(got[0])])
        else:
            np.testing.assert_array_equal(got[i], solo, err_msg=f"req {i}")


def test_int8_paged_prefix_cache_reuses_quantized_pages():
    """Prefix-shared quantized pages carry their scales: the second
    admission shares the first's two pages, whose scale plane holds real
    prompt scales, and both streams equal the solo int8 stream."""
    _, _, tlm = _tiny()
    prompt = _prompts(7, (37,))[0]  # 2 full pages
    bat = ContinuousBatcher(tlm, slots=2, chunk=4, kv_layout="paged",
                            page_size=16, kv_cache_dtype="int8")
    r1 = bat.submit(prompt, 5)
    out1 = bat.run()
    assert bat.stats()["pages_cached"] == 2
    k_scales = bat._caches[0][0][1]
    shared = [p for p in range(1, bat._pool_pages)
              if p in bat._pager._key_of]
    assert len(shared) == 2 and all(k_scales[p].any() for p in shared)
    r2 = bat.submit(prompt, 5)
    out2 = bat.run()
    st = bat.stats()
    assert st["prefix_hits"] == 2 and st["pages_cached"] == 2
    want = _solo(tlm, prompt, 5, kv_cache_dtype="int8")
    np.testing.assert_array_equal(out1[r1], want)
    np.testing.assert_array_equal(out2[r2], want)


def test_int8_chunked_prefill_matches_jax_and_generate_int8():
    """One page-chunk pass per tick over int8 pools, each pass attending
    the already-quantized window; for this workload the greedy streams
    equal the JAX batcher's and the solo int8 path."""
    setup = _tiny()
    short, long_p = _prompts(12, (4, 40))

    def drive(bat):
        r_short = bat.submit(short, 8)
        bat.tick()
        r_long = bat.submit(long_p, 4)
        bat.tick()  # long mid-prefill while short decodes
        assert bat.slots[1].pf_done >= 0
        out = bat.run()
        return [out[r_short], out[r_long]]

    got, want = _both(setup, drive, slots=2, chunk=2, kv_layout="paged",
                      page_size=16, prefill_chunk=16, kv_cache_dtype="int8")
    for p, g, w, n in zip((short, long_p), got, want, (8, 4)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(
            g, _solo(setup[2], p, n, kv_cache_dtype="int8"))


def test_int8_top1_agreement_vs_native_both_layouts():
    _, _, tlm = _tiny()
    prompts = _prompts(5, (4, 7, 3))
    agree = total = 0
    for kw in ({}, {"kv_layout": "paged", "page_size": 16}):
        bat = ContinuousBatcher(tlm, slots=2, kv_cache_dtype="int8", **kw)
        ids = {bat.submit(p, 8): p for p in prompts}
        out = bat.run()
        for rid, p in ids.items():
            agree += int((out[rid] == _solo(tlm, p, 8)).sum())
            total += 8
    assert total == 48
    assert agree / total >= 0.75, f"top-1 agreement {agree}/{total}"


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_quantized_paged_steady_ticks_stage_nothing(kv_dtype):
    _, _, tlm = _tiny()
    bat = ContinuousBatcher(tlm, slots=2, chunk=2, kv_layout="paged",
                            page_size=16, kv_cache_dtype=kv_dtype)
    r1 = bat.submit(np.asarray([1, 2, 3]), 30)
    bat.tick()
    h0 = bat.stats()["h2d_transfers"]
    for _ in range(4):
        assert bat.tick() == 1  # steady state over quantized pools
    assert bat.stats()["h2d_transfers"] == h0
    r2 = bat.submit(np.asarray([5, 6]), 3)
    out = bat.run()
    r3 = bat.submit(np.asarray([9, 9, 9, 9]), 5)
    out.update(bat.run())
    assert set(out) == {r1, r2, r3}
    np.testing.assert_array_equal(
        out[r3], _solo(tlm, [9, 9, 9, 9], 5, kv_cache_dtype=kv_dtype))


def test_int4_batcher_lossless_and_prefix_cache():
    """int4 streams equal solo generate(kv_cache_dtype="int4") on both
    layouts, and a re-submitted prompt enters through the prefix cache
    (its packed pages and scale planes reused)."""
    setup = _tiny(96)
    tlm = setup[2]
    p = np.arange(1, 19, dtype=np.int32)  # 2 full 8-pages
    solo = _solo(tlm, p, 6, kv_cache_dtype="int4")
    for kw in ({}, {"kv_layout": "paged", "page_size": 8}):
        bat = ContinuousBatcher(tlm, slots=2, kv_cache_dtype="int4", **kw)
        r1 = bat.submit(p, 6)
        np.testing.assert_array_equal(bat.run()[r1], solo)
        if kw:
            hits0 = bat.stats()["prefix_hits"]
            r2 = bat.submit(p, 6)
            np.testing.assert_array_equal(bat.run()[r2], solo)
            assert bat.stats()["prefix_hits"] > hits0
    jlm, variables, _ = setup
    jbat = JC.ContinuousBatcher(jlm, variables, slots=2, kv_cache_dtype="int4",
                                kv_layout="paged", page_size=8)
    r = jbat.submit(p, 6)
    np.testing.assert_array_equal(jbat.run()[r], solo)
    jbat.close()


def test_int8_greedy_fanout_forks_quantized_pages():
    """Copy-on-write fan-out over int8 pools: siblings fork the shared last
    prompt page (values and scales) and equal the JAX batcher's and the
    solo int8 stream."""
    setup = _tiny()
    prompt = _prompts(21, (19,))[0]  # 2 full pages of 8

    def drive(bat):
        rids = bat.submit_fanout(prompt, 3, 5)
        out = bat.run()
        st = bat.stats()
        assert st["cow_forks"] == 2
        assert st["fanout_groups"] == 0 and st["pages_in_use"] == 0
        return [out[r] for r in rids]

    got, want = _both(setup, drive, slots=4, chunk=4, kv_layout="paged",
                      page_size=8, kv_cache_dtype="int8")
    solo = _solo(setup[2], prompt, 5, kv_cache_dtype="int8")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, solo)


def test_int8_window_recycling_over_quantized_pools():
    setup = _windowed()
    prompts = _prompts(15, (30, 9), vocab=61)

    def drive(bat):
        ids = [bat.submit(p, 60) for p in prompts]
        bases = []
        while bat.stats()["active"] == 2 or bat.stats()["queued"]:
            bat.tick()
            bases.append(bat._pager.base(0))
        assert max(bases[:-1]) > 0  # leading pages returned mid-request
        out = bat.run()
        return [out[r] for r in ids]

    got, want = _both(setup, drive, slots=2, chunk=4, kv_layout="paged",
                      page_size=8, kv_cache_dtype="int8")
    for p, g, w in zip(prompts, got, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(
            g, _solo(setup[2], p, 60, kv_cache_dtype="int8"))


def test_int4_odd_head_dim_errors_equal_jax():
    jlm = J.transformer_lm(37, 30, 1, 2, 32, max_len=32)  # head_dim 15
    variables = jlm.graph.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 4), jnp.int32))
    tlm = T.transformer_lm(37, 30, 1, 2, 32, max_len=32, device="cpu")
    for kw in ({}, {"kv_layout": "paged", "page_size": 8}):
        with pytest.raises(ValueError) as want:
            JC.ContinuousBatcher(jlm, variables, kv_cache_dtype="int4", **kw)
        with pytest.raises(ValueError) as got:
            ContinuousBatcher(tlm, kv_cache_dtype="int4", **kw)
        assert str(got.value) == str(want.value)
    p = np.ones((1, 3), np.int32)
    with pytest.raises(ValueError) as want:
        J.generate(jlm, variables, jnp.asarray(p), 2, kv_cache_dtype="int4")
    with pytest.raises(ValueError) as got:
        T.generate(tlm, p, 2, kv_cache_dtype="int4")
    assert str(got.value) == str(want.value)
