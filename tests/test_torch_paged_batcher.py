"""The port's paged ContinuousBatcher (``kv_layout="paged"``), on the CPU.

The block-level paged steps (``decode_step_paged`` / ``prefill_chunk_paged``)
are held against the JAX package's at ``atol = rtol = 2e-5``. Greedy paged
streams — staggered submits with a live cancel, a pool small enough to make
requests wait, prefix-cache hits, chunked prefill, sliding-window page
recycling and copy-on-write fan-out — must be token-equal to the JAX
package's paged batcher and to the port's own ``generate()`` for each
request alone, with every step's top-2 logit margin above the 1e-4 logit
tolerance. Sampled streams equal the port's ``generate()`` under the same
seed. A steady paged tick stages nothing host->device."""

import importlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapt_tpu_torch.convert import from_flax
from adapt_tpu_torch.models import transformer_lm as T
from adapt_tpu_torch.runtime.continuous import ContinuousBatcher, fanout_seeds

J = importlib.import_module("adapt_tpu.models.transformer_lm")
JC = importlib.import_module("adapt_tpu.runtime.continuous")

VOCAB = 37
LOGIT_TOL = 1e-4
TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test workers at once,
    and these small shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(jlm, tlm):
    variables = jax.device_get(
        jlm.graph.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    )
    tlm.load_state_dict(from_flax(variables))
    return jlm, variables, tlm


_CACHE = {}


def _tiny(max_len):
    if max_len not in _CACHE:
        _CACHE[max_len] = _pair(
            J.lm_tiny(vocab=VOCAB, max_len=max_len),
            T.lm_tiny(vocab=VOCAB, max_len=max_len, device="cpu"),
        )
    return _CACHE[max_len]


def _windowed():
    if "window" not in _CACHE:
        kw = dict(max_len=128, kv_heads=4, pos="rope", window=16)
        _CACHE["window"] = _pair(
            J.transformer_lm(61, 64, 2, 8, 128, **kw),
            T.transformer_lm(61, 64, 2, 8, 128, device="cpu", **kw),
        )
    return _CACHE["window"]


def _solo(tlm, prompt, steps, **kw):
    return T.generate(tlm, np.asarray(prompt)[None], steps, **kw)[0].numpy()


def _check_greedy(setup, prompt, got, steps=None):
    """``got`` equals the port's solo ``generate()`` (all of it, or a
    prefix for a cancelled stream) and every pick clears the margin."""
    tlm = setup[2]
    want = _solo(tlm, prompt, steps or len(got))
    np.testing.assert_array_equal(got, want[:len(got)])
    seq = np.concatenate([prompt, want[:-1]])[None]
    lg = T.logits_full(tlm, seq)[0].numpy()  # within 1e-4 of JAX's
    top2 = np.sort(lg[len(prompt) - 1:], axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0] > LOGIT_TOL).all(), "near-tie step"


def _both(setup, drive, **kw):
    """Run ``drive(batcher)`` on the port's and the JAX package's paged
    batcher; returns both drives' results."""
    jlm, variables, tlm = setup
    got = drive(ContinuousBatcher(tlm, kv_layout="paged", **kw))
    want = drive(JC.ContinuousBatcher(jlm, variables, kv_layout="paged",
                                      **kw))
    return got, want


def _prompts(seed, lens, vocab=VOCAB):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=n).astype(np.int32) for n in lens]


# -- block-level paged steps ---------------------------------------------------


def test_block_paged_steps_match_jax_and_dead_rows_write_trash():
    jlm, variables, tlm = _windowed()
    name = "decoder_block_1"
    jblock, tblock = jlm.graph.node(name).module, getattr(tlm, name)
    rng = np.random.RandomState(3)
    kvh, page, hd, npages = 4, 8, 8, 12
    kp = rng.randn(npages, kvh, page, hd).astype(np.float32)
    vp = rng.randn(npages, kvh, page, hd).astype(np.float32)
    table = np.asarray([[5, 2, 9, 0], [7, 3, 0, 0]], np.int32)
    x = rng.randn(2, 1, 64).astype(np.float32)
    index = np.asarray([19, -3], np.int32)  # row 1 is dead
    want, jkp, _ = jax.jit(partial(jblock.apply, method="decode_step_paged"))(
        variables[name], jnp.asarray(x), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(index))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    with torch.no_grad():
        got, _, _ = tblock.decode_step_paged(
            torch.from_numpy(x), tk, tv, torch.from_numpy(table),
            torch.from_numpy(index))
    np.testing.assert_allclose(got[:1].numpy(), np.asarray(want)[:1],
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tk.numpy()[1:], np.asarray(jkp)[1:],
                               atol=TOL, rtol=TOL)
    # The dead row's write went to trash page 0, never to its own page 7.
    np.testing.assert_array_equal(tk.numpy()[7], kp[7])
    assert not np.array_equal(tk.numpy()[0], kp[0])
    # A chunk pass at pos0 = 8 over a window of 3 pages padded to 4.
    xc = rng.randn(1, 16, 64).astype(np.float32)
    pages = np.asarray([5, 2, 9, 0], np.int32)
    want, jkp, _ = jax.jit(
        partial(jblock.apply, method="prefill_chunk_paged"), static_argnums=5
    )(variables[name], jnp.asarray(xc), jnp.asarray(kp), jnp.asarray(vp),
      jnp.asarray(pages), 8)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    with torch.no_grad():
        got, _, _ = tblock.prefill_chunk_paged(
            torch.from_numpy(xc), tk, tv, torch.from_numpy(pages), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jkp), atol=TOL,
                               rtol=TOL)


# -- batcher streams -----------------------------------------------------------

LENS = (3, 9, 5, 12, 7)
STEPS = (20, 4, 8, 3, 5)


def test_staggered_greedy_with_cancel_matches_jax_and_generate():
    setup = _tiny(48)
    prompts = _prompts(1, LENS)

    def drive(bat):
        ids = [bat.submit(prompts[i], STEPS[i]) for i in range(2)]
        bat.tick()
        bat.tick()
        ids += [bat.submit(prompts[i], STEPS[i]) for i in range(2, 5)]
        assert bat.cancel(ids[0])
        out = bat.run()
        st = bat.stats()
        assert st["pages_in_use"] == 0
        assert st["pages_free"] == st["pool_pages"] - 1
        return [out[r] for r in ids]

    got, want = _both(setup, drive, slots=3, chunk=4, page_size=16)
    for i in range(5):
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"req {i}")
        _check_greedy(setup, prompts[i], got[i], STEPS[i])
    assert 0 < len(got[0]) < STEPS[0]  # cancelled live


def test_sampled_streams_match_port_generate():
    _, _, tlm = _tiny(48)
    prompts = _prompts(3, LENS)
    kw = [dict(), dict(temperature=0.9, top_k=5, rng=7), dict(),
          dict(temperature=1.3, rng=9), dict(temperature=0.7, top_p=0.8,
                                             rng=4)]
    bat = ContinuousBatcher(tlm, slots=3, chunk=4, kv_layout="paged",
                            page_size=16)
    ids = [bat.submit(prompts[i], 6, **kw[i]) for i in range(2)]
    bat.tick()
    ids += [bat.submit(prompts[i], 6, **kw[i]) for i in range(2, 5)]
    out = bat.run()
    for i, rid in enumerate(ids):
        np.testing.assert_array_equal(
            out[rid], _solo(tlm, prompts[i], 6, **kw[i]), err_msg=f"req {i}")


def test_small_pool_forces_waiting_but_completes():
    setup = _tiny(48)
    prompts = _prompts(4, (11, 12, 13, 14))

    def drive(bat):
        ids = [bat.submit(p, 6) for p in prompts]
        bat.tick()
        st = bat.stats()
        # 2 pages a request, a pool of trash + 4: page-bound, not slot-bound.
        assert st["active"] == 2 and st["pages_in_use"] == 4
        out = bat.run()
        return [out[r] for r in ids]

    got, want = _both(setup, drive, slots=3, chunk=4, page_size=16,
                      pool_pages=5)
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(got[i], want[i])
        _check_greedy(setup, p, got[i], 6)


def test_prefix_cache_hits_shared_live_pages_and_eviction():
    setup = _tiny(48)
    _, _, tlm = setup
    rng = np.random.RandomState(7)
    prompt = rng.randint(0, VOCAB, size=37).astype(np.int32)  # 2 full pages

    def drive(bat):
        r1 = bat.submit(prompt, 5)
        out1 = bat.run()
        assert bat.stats()["pages_cached"] == 2
        r2 = bat.submit(prompt, 5)
        out2 = bat.run()
        st = bat.stats()
        assert st["prefix_hits"] == 2 and st["pages_cached"] == 2
        assert bat.prefix_cached(prompt) == 2
        return [out1[r1], out2[r2]]

    got, want = _both(setup, drive, slots=2, chunk=4, page_size=16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        _check_greedy(setup, prompt, g, 5)
    # Two different requests sharing a 2-page system prompt, live at once.
    system = rng.randint(0, VOCAB, size=32).astype(np.int32)
    p1 = np.concatenate([system, rng.randint(0, VOCAB, size=4)])
    p2 = np.concatenate([system, rng.randint(0, VOCAB, size=7)])
    bat = ContinuousBatcher(tlm, slots=2, chunk=4, kv_layout="paged",
                            page_size=16)
    r1 = bat.submit(p1, 4)
    bat.tick()
    r2 = bat.submit(p2, 4, temperature=0.8, top_k=6, rng=11)
    bat.tick()
    st = bat.stats()
    assert st["prefix_hits"] == 2
    assert st["pages_in_use"] < 2 * -(-max(48, p1.shape[0] + 4) // 16)
    out = bat.run()
    _check_greedy(setup, p1, out[r1], 4)
    np.testing.assert_array_equal(
        out[r2], _solo(tlm, p2, 4, temperature=0.8, top_k=6, rng=11))
    # No spare room: cached pages evict to admit an unrelated request.
    pa, pb = _prompts(9, (33, 33))
    bat = ContinuousBatcher(tlm, slots=1, chunk=4, kv_layout="paged",
                            page_size=16, pool_pages=4)
    outs = []
    for p in (pa, pb, pa):
        rid = bat.submit(p, 5)
        outs.append(bat.run()[rid])
        assert bat.stats()["pages_cached"] == 2
    assert bat.stats()["radix_evictions"] == 4
    for p, o in zip((pa, pb, pa), outs):
        _check_greedy(setup, p, o, 5)


def test_suffix_pads_to_pages_inside_the_reservation():
    """s0=49, steps=5, P=16 with one shared page: the suffix pads to whole
    pages (3), never to a bucket past the 4-page reservation."""
    setup = _tiny(64)
    _, _, tlm = setup
    first = _prompts(11, (49,))[0]
    second = first.copy()
    second[20] = (second[20] + 1) % VOCAB  # shares ONLY the first page
    bat = ContinuousBatcher(tlm, slots=1, chunk=4, kv_layout="paged",
                            page_size=16)
    outs = []
    for p in (first, second):
        rid = bat.submit(p, 5)
        outs.append(bat.run()[rid])
    assert bat.stats()["prefix_hits"] == 1
    for p, o in zip((first, second), outs):
        _check_greedy(setup, p, o, 5)


def test_chunked_prefill_interleaves_and_composes_with_prefix_cache():
    setup = _tiny(64)
    _, _, tlm = setup
    short, long_p = _prompts(12, (4, 50))
    bat = ContinuousBatcher(tlm, slots=2, chunk=2, kv_layout="paged",
                            page_size=16, prefill_chunk=16)
    r_short = bat.submit(short, 8, temperature=0.9, top_k=5, rng=13)
    bat.tick()
    emitted = len(bat.slots[0].tokens)
    r_long = bat.submit(long_p, 4)
    bat.tick()
    assert bat.slots[1].pf_done >= 0  # mid-prefill
    assert len(bat.slots[0].tokens) > emitted  # the decode did not stall
    out = bat.run()
    np.testing.assert_array_equal(
        out[r_short], _solo(tlm, short, 8, temperature=0.9, top_k=5, rng=13))
    _check_greedy(setup, long_p, out[r_long], 4)

    rng = np.random.RandomState(13)
    system = rng.randint(0, VOCAB, size=32).astype(np.int32)
    p1 = np.concatenate([system, rng.randint(0, VOCAB, size=18)])
    p2 = np.concatenate([system, rng.randint(0, VOCAB, size=20)])

    def drive(bat):
        r1 = bat.submit(p1, 4)
        out1 = bat.run()
        hits = bat.stats()["prefix_hits"]
        r2 = bat.submit(p2, 4)
        bat.tick()
        # p2 shares the two system pages and chunk-prefills from there.
        assert bat.stats()["prefix_hits"] == hits + 2
        return [out1[r1], bat.run()[r2]]

    got, want = _both(setup, drive, slots=1, chunk=2, page_size=16,
                      prefill_chunk=16)
    for p, g, w in zip((p1, p2), got, want):
        np.testing.assert_array_equal(g, w)
        _check_greedy(setup, p, g, 4)


def test_decode_during_chunked_prefill_cannot_corrupt_prompt_pages():
    """A mid-prefill slot rides the decode batch as a dead row that OWNS
    real pages: its garbage write must go to the trash page, not to
    table[row, 0] (the prompt's first page)."""
    setup = _tiny(256)
    _, _, tlm = setup
    short, long_p = _prompts(14, (5, 124))
    bat = ContinuousBatcher(tlm, slots=2, chunk=2, kv_layout="paged",
                            page_size=16, prefill_chunk=32)
    r_short = bat.submit(short, 40)
    bat.tick()
    r_long = bat.submit(long_p, 5)
    bat.tick()
    assert bat.slots[1].pf_done >= 0
    out = bat.run()
    _check_greedy(setup, short, out[r_short], 40)
    _check_greedy(setup, long_p, out[r_long], 5)


def test_window_recycling_returns_pages_mid_request():
    setup = _windowed()
    prompts = _prompts(15, (30, 9), vocab=61)

    def drive(bat):
        ids = [bat.submit(p, 60) for p in prompts]
        in_use, bases = [], []
        while bat.stats()["active"] == 2 or bat.stats()["queued"]:
            bat.tick()
            in_use.append(bat.stats()["pages_in_use"])
            bases.append(bat._pager.base(0))
        # Slot 0 released its leading pages while both requests were live.
        assert max(bases[:-1]) > 0
        assert min(in_use[:-1]) < max(in_use)
        out = bat.run()
        return [out[r] for r in ids]

    got, want = _both(setup, drive, slots=2, chunk=4, page_size=8)
    for p, g, w in zip(prompts, got, want):
        np.testing.assert_array_equal(g, w)
        _check_greedy(setup, p, g, 60)


def test_greedy_fanout_is_bit_identical_and_books_cow_forks():
    setup = _tiny(48)
    prompt = _prompts(21, (19,))[0]  # 2 full pages of 8

    def drive(bat):
        rids = bat.submit_fanout(prompt, 3, 5)
        out = bat.run()
        st = bat.stats()
        assert st["cow_forks"] == 2
        assert st["fanout_groups"] == 0 and st["pages_in_use"] == 0
        assert st["pages_free"] == st["pool_pages"] - 1
        return [out[r] for r in rids]

    got, want = _both(setup, drive, slots=4, chunk=4, page_size=8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        _check_greedy(setup, prompt, g, 5)


def test_sampled_fanout_and_queued_sibling_cancel():
    _, _, tlm = _tiny(48)
    prompt = _prompts(22, (19,))[0]
    bat = ContinuousBatcher(tlm, slots=3, chunk=4, kv_layout="paged",
                            page_size=8)
    rids = bat.submit_fanout(prompt, 3, 5, temperature=0.9, rng=11)
    out = bat.run()
    seeds = fanout_seeds(11, 3)
    assert len(set(seeds)) == 3 and seeds == fanout_seeds(11, 3)
    for r, s in zip(rids, seeds):
        np.testing.assert_array_equal(
            out[r], _solo(tlm, prompt, 5, temperature=0.9, rng=s))
    st = bat.stats()
    assert st["cow_forks"] == 0 and st["pages_in_use"] == 0
    with pytest.raises(ValueError, match="rng"):
        bat.submit_fanout(prompt, 2, 3, temperature=0.5)
    with pytest.raises(ValueError, match="width"):
        bat.submit_fanout(prompt, 0, 3)
    # One slot: sibling 0 admits, 1 and 2 queue; cancelling 2 shrinks the
    # group without wedging it (1 still forks), and the claim is released.
    bat = ContinuousBatcher(tlm, slots=1, chunk=4, kv_layout="paged",
                            page_size=8)
    rids = bat.submit_fanout(prompt, 3, 4)
    bat.tick()
    assert bat.cancel(rids[2])
    out = bat.run()
    want = _solo(tlm, prompt, 4)
    np.testing.assert_array_equal(out[rids[0]], want)
    np.testing.assert_array_equal(out[rids[1]], want)
    assert out[rids[2]].shape == (0,)
    st = bat.stats()
    assert st["cow_forks"] == 1
    assert st["fanout_groups"] == 0 and st["pages_in_use"] == 0
    # Dense layouts and width 1 are plain serial submits.
    dense = ContinuousBatcher(tlm, slots=2, chunk=4)
    rids = dense.submit_fanout(prompt, 2, 4)
    out = dense.run()
    for r in rids:
        np.testing.assert_array_equal(out[r], want)


def test_steady_paged_ticks_stage_nothing_host_to_device():
    _, _, tlm = _tiny(48)
    bat = ContinuousBatcher(tlm, slots=2, chunk=2, kv_layout="paged",
                            page_size=8)
    bat.submit(np.asarray([1, 2, 3]), 30)
    bat.submit(np.asarray([4, 5]), 30)
    bat.tick()  # admissions stage their rows and the table
    n = bat.stats()["h2d_transfers"]
    assert n > 0
    for _ in range(5):
        assert bat.tick() == 2
    assert bat.stats()["h2d_transfers"] == n


def test_validation_errors_equal_jax():
    jlm, variables, tlm = _tiny(48)
    cases = [
        dict(prefill_chunk=16),
        dict(kv_layout="paged", page_size=16, prefill_chunk=24),
        dict(kv_layout="paged", page_size=16, prefill_chunk=8),
        dict(kv_layout="vram"),
        dict(kv_layout="paged", page_size=0),
        dict(kv_layout="paged", pool_pages=1),
        dict(kv_cache_dtype="fp8"),
    ]
    for kw in cases:
        with pytest.raises(ValueError) as want:
            JC.ContinuousBatcher(jlm, variables, **kw)
        with pytest.raises(ValueError) as got:
            ContinuousBatcher(tlm, **kw)
        assert str(got.value) == str(want.value), kw
    kw = dict(slots=2, kv_layout="paged", page_size=16, pool_pages=2)
    jbat = JC.ContinuousBatcher(jlm, variables, **kw)
    bat = ContinuousBatcher(tlm, **kw)
    for b in (jbat, bat):
        with pytest.raises(ValueError, match="pages") as e:
            b.submit(np.arange(10), steps=20)  # needs 2 of 1 allocatable
        assert "needs 2 pages" in str(e.value)
    # Quantized pools are served: (int8 values, f32 scales) page pairs.
    bat = ContinuousBatcher(tlm, kv_layout="paged", kv_cache_dtype="int8")
    vals, scales = bat._caches[0][0]
    assert vals.dtype == torch.int8 and scales.shape[-1] == 1
    assert vals.shape[:3] == scales.shape[:3]
