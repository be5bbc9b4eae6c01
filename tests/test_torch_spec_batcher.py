"""The port's speculative ``ContinuousBatcher`` (``draft_lm=...``), on the
CPU.

Greedy speculative streams must be token-equal to the port's own
``generate()`` for each request alone (with ``kv_cache_dtype`` matching the
batcher's) and to the JAX package's speculative batcher on the same traffic,
with equal acceptance books: both KV layouts, native and int8 caches; the
target as its own draft, a truncated draft (the target's first block), an
independent adversarial draft; staggered admissions with a live cancel;
EOS / stop sequences at acceptance boundaries; tree drafts
(``tree_width = 2``); ``set_draft_k``; int8 draft weights. A steady
speculative tick stages nothing host->device and fetches once; a drained
paged pool is whole again. ``temperature > 0, top_k = 1`` equals greedy, and
greedy rows of a mixed batch keep their exact stream."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapt_tpu_torch.config import SpeculativeConfig
from adapt_tpu_torch.convert import from_flax
from adapt_tpu_torch.models import transformer_lm as T
from adapt_tpu_torch.ops import quantize as TQ
from adapt_tpu_torch.runtime.continuous import ContinuousBatcher

J = importlib.import_module("adapt_tpu.models.transformer_lm")
JC = importlib.import_module("adapt_tpu.runtime.continuous")
JCFG = importlib.import_module("adapt_tpu.config")

VOCAB = 37
ARCH = dict(target=(32, 2, 2, 64), draft=(16, 1, 1, 32), trunc=(32, 1, 2, 64))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_CACHE = {}


def _model(name):
    """(jax lm, variables, torch lm): the target, an independent small
    draft, or the target truncated to its first block."""
    if name not in _CACHE:
        dim, depth, heads, mlp = ARCH[name]
        jlm = J.transformer_lm(VOCAB, dim, depth, heads, mlp, max_len=48,
                               name=name)
        if name == "trunc":
            tv = _model("target")[1]
            variables = {k: tv[k] for k in ("embed", "decoder_block_0",
                                            "head")}
        else:
            variables = jax.device_get(jlm.graph.init(
                jax.random.PRNGKey(7 if name == "draft" else 0),
                jnp.zeros((1, 4), jnp.int32)))
        tlm = T.transformer_lm(VOCAB, dim, depth, heads, mlp, max_len=48,
                               device="cpu")
        tlm.load_state_dict(from_flax(variables))
        _CACHE[name] = (jlm, variables, tlm)
    return _CACHE[name]


def _solo(prompt, steps, **kw):
    return T.generate(_model("target")[2], np.asarray(prompt)[None], steps,
                      **kw)[0].numpy()


def _traffic(seed=1):
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, VOCAB, size=n) for n in (3, 9, 5, 12, 7)]
    return prompts, [9, 14, 8, 3, 11]


def _kw(layout):
    return dict(kv_layout="paged", page_size=8) if layout == "paged" else {}


def _run_staggered(bat, prompts, steps):
    """Two requests, two ticks, then three more arrive mid-decode."""
    ids = {}
    for i in range(2):
        ids[bat.submit(prompts[i], steps[i])] = i
    bat.tick()
    bat.tick()
    for i in range(2, 5):
        ids[bat.submit(prompts[i], steps[i])] = i
    out = bat.run()
    return {i: out[rid] for rid, i in ids.items()}, ids


@pytest.mark.parametrize("layout,kv,draft,cfg", [
    ("slots", "native", "target", dict(draft_k=3)),
    ("paged", "int8", "draft", dict(draft_k=4)),
    ("paged", "native", "trunc", dict(draft_k=3, tree_width=2)),
    ("slots", "int8", "trunc", dict(draft_k=2, tree_width=2)),
])
def test_spec_streams_match_generate_and_the_jax_batcher(layout, kv, draft,
                                                         cfg):
    jlm, variables, tlm = _model("target")
    jd, dvars, td = _model(draft)
    prompts, steps = _traffic()
    bat = ContinuousBatcher(
        tlm, slots=3, kv_cache_dtype=kv, draft_lm=td,
        speculative=SpeculativeConfig(**cfg), **_kw(layout))
    got, ids = _run_staggered(bat, prompts, steps)
    for i, toks in got.items():
        np.testing.assert_array_equal(
            toks, _solo(prompts[i], steps[i], kv_cache_dtype=kv),
            err_msg=f"req {i}")
    jbat = JC.ContinuousBatcher(
        jlm, variables, slots=3, kv_cache_dtype=kv, draft_lm=jd,
        draft_variables=dvars, speculative=JCFG.SpeculativeConfig(**cfg),
        **_kw(layout))
    want, _ = _run_staggered(
        jbat, [p.astype(np.int32) for p in prompts], steps)
    for i in got:
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"req {i}")
    st, jst = bat.stats(), jbat.stats()
    for key in ("spec_drafted", "spec_accepted", "ticks", "completed"):
        assert st[key] == jst[key], key
    assert st["draft_cache_bytes"] == jst["draft_cache_bytes"]
    if draft == "target" and kv == "native":
        assert st["spec_acceptance"] == 1.0
    assert st["ticks"] < sum(steps)
    # Logprobs ride the fused verify: the scores generate() reports.
    rid0 = next(r for r, i in ids.items() if i == 0)
    _, lp = T.generate(tlm, prompts[0][None], steps[0], kv_cache_dtype=kv,
                       return_logprobs=True)
    np.testing.assert_allclose(bat.logprobs(rid0), lp[0].numpy(), rtol=2e-4,
                               atol=2e-4)
    if layout == "paged":
        assert st["pages_in_use"] == 0
        # The pool is whole again (cached pages count as free; page 0 is
        # the trash page).
        assert st["pages_free"] == st["pool_pages"] - 1
        assert st["pages_cached"] <= st["pages_free"]


@pytest.mark.parametrize("layout", ["slots", "paged"])
@pytest.mark.parametrize("draft,draft_k,tree", [
    ("draft", 1, 0), ("draft", 4, 0), ("trunc", 4, 0), ("target", 4, 2),
    ("draft", 2, 1),
])
def test_spec_is_lossless_whatever_the_draft(layout, draft, draft_k, tree):
    """The draft changes ONLY the tick count: an adversarial draft still
    advances one correction token a tick, a perfect one commits whole
    chains (and a tree leaf on top)."""
    tlm, td = _model("target")[2], _model(draft)[2]
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, VOCAB, size=n) for n in (4, 7, 2, 10)]
    bat = ContinuousBatcher(
        tlm, slots=2, draft_lm=td,
        speculative=SpeculativeConfig(draft_k=draft_k, tree_width=tree),
        **_kw(layout))
    ids = {bat.submit(p, 9): p for p in prompts}
    out = bat.run()
    for rid, p in ids.items():
        np.testing.assert_array_equal(out[rid], _solo(p, 9))
    st = bat.stats()
    assert 0.0 <= st["spec_acceptance"] <= 1.0
    if draft == "target":
        # Self draft: the chain always accepts and the argmax leaf always
        # hits, so a slot commits draft_k + 2 tokens a pass.
        assert st["spec_accepted"] * (draft_k + tree) \
            == st["spec_drafted"] * (draft_k + 1)
        assert st["ticks"] <= 2 * -(-8 // (draft_k + 2)) + 1


@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_spec_eos_stop_cancel_at_acceptance_boundaries(layout):
    tlm = _model("target")[2]
    p = np.asarray([4, 8, 15])
    full = _solo(p, 10)
    eos = int(full[3])  # finishes mid-accepted-block
    bat = ContinuousBatcher(tlm, slots=2, draft_lm=tlm,
                            speculative=SpeculativeConfig(draft_k=4),
                            **_kw(layout))
    r_eos = bat.submit(p, 10, eos_id=eos)
    stop_seq = [int(full[1]), int(full[2])]
    r_stop = bat.submit(p, 10, stop=[stop_seq])
    out = bat.run()
    n = len(out[r_eos])
    assert out[r_eos][-1] == eos and eos not in out[r_eos][:-1]
    np.testing.assert_array_equal(out[r_eos],
                                  _solo(p, 10, eos_id=eos)[:n])
    assert list(out[r_stop][-2:]) == stop_seq
    np.testing.assert_array_equal(out[r_stop], full[: len(out[r_stop])])
    # Cancel mid-flight: partial stream, slot freed, the survivor exact.
    r_long = bat.submit(np.asarray([1, 2]), 30)
    r_keep = bat.submit(np.asarray([9, 3, 3]), 12)
    bat.tick()
    assert bat.cancel(r_long)
    out = bat.run()
    partial = out[r_long]
    assert 0 < len(partial) < 30
    np.testing.assert_array_equal(partial,
                                  _solo([1, 2], 30)[: len(partial)])
    np.testing.assert_array_equal(out[r_keep], _solo([9, 3, 3], 12))
    assert not bat._cancelled
    if layout == "paged":
        assert bat.stats()["pages_in_use"] == 0


@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_spec_steady_tick_stages_nothing_and_fetches_once(layout):
    tlm, td = _model("target")[2], _model("draft")[2]
    bat = ContinuousBatcher(tlm, slots=3, draft_lm=td,
                            speculative=SpeculativeConfig(draft_k=3),
                            **_kw(layout))
    for p in ([1, 2, 3], [4, 5], [6, 7, 8, 9]):
        bat.submit(np.asarray(p), 30)
    bat.tick()  # admissions stage; from here on the batch is steady
    h2d, d2h = bat.stats()["h2d_transfers"], bat.stats()["d2h_fetches"]
    for _ in range(4):
        assert bat.tick() == 3
    st = bat.stats()
    assert st["h2d_transfers"] == h2d
    assert st["d2h_fetches"] == d2h + 4
    assert st["spec_drafted"] == 5 * 3 * 3


def test_set_draft_k_narrows_the_round_and_stays_lossless():
    tlm = _model("target")[2]
    prompts, steps = _traffic(5)
    bat = ContinuousBatcher(tlm, slots=2, draft_lm=tlm, kv_layout="paged",
                            page_size=8,
                            speculative=SpeculativeConfig(draft_k=4))
    ids = [bat.submit(p, s) for p, s in zip(prompts, steps)]
    bat.tick()
    d0 = bat.stats()["spec_drafted"]
    bat.set_draft_k(1)
    bat.tick()
    assert bat.stats()["spec_drafted"] - d0 == 2  # 2 slots x 1 proposal
    bat.set_draft_k(4)
    bat.set_draft_k(4)  # a no-op
    out = bat.run()
    for rid, p, s in zip(ids, prompts, steps):
        np.testing.assert_array_equal(out[rid], _solo(p, s))
    assert bat.stats()["spec_acceptance"] == 1.0
    for bad in (0, 5):
        with pytest.raises(ValueError, match="draft_k must be in"):
            bat.set_draft_k(bad)
    with pytest.raises(ValueError, match="speculative mode"):
        ContinuousBatcher(tlm, slots=1).set_draft_k(1)


@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_int8_draft_weights_are_lossless(layout):
    """The draft's matrices held blockwise int8 and dequantized inside
    every scan and prefill: streams stay exact, the module's own tensors
    are untouched, and a self draft still mostly agrees."""
    tlm = _model("target")[2]
    before = {k: v.clone() for k, v in tlm.state_dict().items()}
    bat = ContinuousBatcher(
        tlm, slots=2, draft_lm=tlm,
        speculative=SpeculativeConfig(draft_k=3, draft_weight_dtype="int8"),
        **_kw(layout))
    held = bat._draft_weights
    assert isinstance(held["decoder_block_0.mlp_in.weight"],
                      TQ.QuantizedTensor)
    assert isinstance(held["embed.pos_embed"], TQ.QuantizedTensor)
    assert torch.is_tensor(held["decoder_block_0.mlp_in.bias"])
    prompts, steps = _traffic(9)
    ids = [bat.submit(p, s) for p, s in zip(prompts, steps)]
    out = bat.run()
    for rid, p, s in zip(ids, prompts, steps):
        np.testing.assert_array_equal(out[rid], _solo(p, s))
    assert bat.stats()["spec_acceptance"] > 0.5
    for k, v in tlm.state_dict().items():
        assert torch.equal(v, before[k])


@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_sampled_rows_top_k_1_equal_greedy_and_mixed_batches(layout):
    tlm, td = _model("target")[2], _model("trunc")[2]
    p1, p2, p3 = np.asarray([5, 1, 9]), np.asarray([2, 2]), np.asarray([7])
    bat = ContinuousBatcher(
        tlm, slots=3, draft_lm=td,
        speculative=SpeculativeConfig(draft_k=3, tree_width=1),
        **_kw(layout))
    r1 = bat.submit(p1, 12, temperature=0.8, top_k=1, rng=11)
    r2 = bat.submit(p2, 12)  # greedy beside sampled rows
    r3 = bat.submit(p3, 12, temperature=1.3, top_p=0.9, rng=5)
    out = bat.run()
    np.testing.assert_array_equal(out[r1], _solo(p1, 12))
    np.testing.assert_array_equal(out[r2], _solo(p2, 12))
    assert out[r3].shape == (12,) and (out[r3] < VOCAB).all()
    # A sampled stream is a pure function of its seed, whatever its
    # company and the draft.
    solo = ContinuousBatcher(tlm, slots=1, draft_lm=td,
                             speculative=SpeculativeConfig(draft_k=3),
                             **_kw(layout))
    r = solo.submit(p3, 12, temperature=1.3, top_p=0.9, rng=5)
    again = solo.run()[r]
    assert again.shape == (12,)
    other = solo.submit(p3, 12, temperature=1.3, top_p=0.9, rng=6)
    assert not np.array_equal(solo.run()[other], again)


def test_spec_validation_and_geometry():
    tlm, td = _model("target")[2], _model("draft")[2]
    with pytest.raises(ValueError, match="requires draft_lm"):
        ContinuousBatcher(tlm, speculative=SpeculativeConfig())
    other = T.transformer_lm(41, 16, 1, 1, 32, max_len=48, device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        ContinuousBatcher(tlm, draft_lm=other)
    short = T.transformer_lm(VOCAB, 16, 1, 1, 32, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        ContinuousBatcher(tlm, draft_lm=short)
    for bad in (dict(draft_k=0), dict(draft_weight_dtype="int4"),
                dict(tree_width=-1)):
        with pytest.raises(ValueError):
            SpeculativeConfig(**bad)
    assert SpeculativeConfig() == SpeculativeConfig(4, "native", 0)
    # Geometry: slack positions on strips, table width and the idle
    # sentinel on pools, the draft strips' extra tree position.
    bat = ContinuousBatcher(tlm, slots=2, draft_lm=td,
                            speculative=SpeculativeConfig(3, tree_width=2))
    assert bat._caches[0][0].shape[2] == 48 + 1 + 3 + 2
    assert bat._draft_caches[0][0].shape == (2, 1, 48 + 3 + 1 + 1, 16)
    bat = ContinuousBatcher(tlm, slots=2, draft_lm=td, kv_layout="paged",
                            page_size=8,
                            speculative=SpeculativeConfig(3, tree_width=2))
    assert bat._pager.table().shape[1] == -(-(48 + 3 + 2) // 8)
    assert bat._idle_pos == -(3 + 1 + 1 + 1)
    assert ContinuousBatcher(tlm, slots=2, draft_lm=td, kv_layout="paged",
                             page_size=8)._idle_pos == -(4 + 1 + 1)
    # A request that cannot fit its speculative slack is refused.
    tight = ContinuousBatcher(tlm, slots=1, draft_lm=td, kv_layout="paged",
                              page_size=8, pool_pages=4)
    with pytest.raises(ValueError, match="pages"):
        tight.submit(np.arange(8), 14)
