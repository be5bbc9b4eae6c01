"""The port's decoder LM against the JAX package's, on the CPU.

Weights come from the JAX package (``graph.init`` from a seed) through
``convert.from_flax``; inputs are numpy arrays given to both. Tolerances:
module outputs at ``atol = rtol = 2e-5`` and logits at ``1e-4`` (the two
frameworks' f32 matmuls differ by ~1e-6, summed over depth). Greedy token
streams must be equal, and every compared step's top-2 logit margin must
exceed the logit tolerance, so a failure is a fault, not a tie."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapt_tpu_torch.convert import from_flax
from adapt_tpu_torch.models import transformer_lm as T

J = importlib.import_module("adapt_tpu.models.transformer_lm")

TOL = 2e-5
LOGIT_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test workers at once,
    and these small shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

CONFIGS = {
    "tiny": (lambda m: m.lm_tiny(),),
    "gqa_rope_window": (
        lambda m: m.transformer_lm(61, 64, 2, 8, 128, max_len=128,
                                   kv_heads=4, pos="rope", window=16),
    ),
}


def _build(name):
    jlm = CONFIGS[name][0](J)
    variables = jax.device_get(
        jlm.graph.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    )
    if name == "tiny":
        tlm = T.lm_tiny(device="cpu")
    else:
        tlm = T.transformer_lm(61, 64, 2, 8, 128, max_len=128, kv_heads=4,
                               pos="rope", window=16, device="cpu")
    tlm.load_state_dict(from_flax(variables))
    return jlm, variables, tlm


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def models(request):
    return _build(request.param)


def assert_greedy_margins(jlm, variables, prompt_row, tokens):
    """Every greedy pick in ``tokens`` (generated after ``prompt_row``)
    has a JAX top-2 logit margin above the logit tolerance."""
    seq = np.concatenate([prompt_row, tokens[:-1]])[None]
    lg = np.asarray(J.logits_full(jlm, variables, jnp.asarray(seq)))[0]
    lg = lg[len(prompt_row) - 1:]
    top2 = np.sort(lg, axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0] > LOGIT_TOL).all(), "near-tie step"
    np.testing.assert_array_equal(lg.argmax(-1), tokens)


def test_convert_covers_every_parameter(models):
    _, variables, tlm = models
    sd = from_flax(variables)
    assert set(sd) == set(tlm.state_dict())
    n_flax = sum(np.size(x) for x in jax.tree.leaves(variables))
    assert n_flax == sum(p.numel() for p in tlm.parameters())


def test_block_prefill_and_decode_step_match(models):
    jlm, variables, tlm = models
    name = "decoder_block_1"
    jblock = jlm.graph.node(name).module
    tblock = getattr(tlm, name)
    rng = np.random.RandomState(0)
    b, s, max_len = 2, 12, 20
    x = rng.randn(b, s, 64).astype(np.float32)
    vf = np.array([0, 3], np.int32)
    jy, jk, jv = jblock.apply(variables[name], jnp.asarray(x), max_len,
                              jnp.asarray(vf), False, method="prefill")
    with torch.no_grad():
        ty, tk, tv = tblock.prefill(torch.from_numpy(x), max_len,
                                    torch.from_numpy(vf))
    keep = np.arange(s)[None, :] >= vf[:, None]  # padded rows unspecified
    np.testing.assert_allclose(ty.numpy()[keep], np.asarray(jy)[keep],
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tk.numpy(), jk, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tv.numpy(), jv, atol=TOL, rtol=TOL)
    # One cached decode step per row at its own index.
    x_t = rng.randn(b, 1, 64).astype(np.float32)
    idx = np.array([s, s + 3], np.int32)
    jo, jk2, jv2 = jblock.apply(variables[name], jnp.asarray(x_t), jk, jv,
                                jnp.asarray(idx), jnp.asarray(vf), False,
                                "xla", method="decode_step")
    with torch.no_grad():
        to, tk2, tv2 = tblock.decode_step(
            torch.from_numpy(x_t), tk, tv, torch.from_numpy(idx),
            torch.from_numpy(vf),
        )
    np.testing.assert_allclose(to.numpy(), jo, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tk2.numpy(), jk2, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tv2.numpy(), jv2, atol=TOL, rtol=TOL)


def test_attention_module_forward_matches(models):
    jlm, variables, tlm = models
    name = "decoder_block_0"
    attn_vars = {"params": variables[name]["params"]["attn"]}
    jb = jlm.graph.node(name).module
    jattn = J.CausalSelfAttention(jb.dim, jb.heads, kv_heads=jb.kv_heads,
                                  window=jb.window, rope=jb.rope)
    x = np.random.RandomState(1).randn(2, 20, 64).astype(np.float32)
    want = jattn.apply(attn_vars, jnp.asarray(x))
    with torch.no_grad():
        got = getattr(tlm, name).attn(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_logits_full_match(models):
    jlm, variables, tlm = models
    ids = np.random.RandomState(2).randint(0, tlm.vocab, (2, 30))
    want = np.asarray(J.logits_full(jlm, variables, jnp.asarray(ids)))
    got = T.logits_full(tlm, ids).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_greedy_generate_token_equal(models):
    jlm, variables, tlm = models
    prompt = np.random.RandomState(3).randint(0, tlm.vocab, (3, 9))
    want = np.asarray(J.generate(jlm, variables, jnp.asarray(prompt), 12))
    got = T.generate(tlm, prompt, 12).numpy()
    np.testing.assert_array_equal(got, want)
    for i in range(3):
        assert_greedy_margins(jlm, variables, prompt[i], got[i])


def test_ragged_generate_with_eos_token_equal(models):
    jlm, variables, tlm = models
    rng = np.random.RandomState(4)
    prompt = rng.randint(0, tlm.vocab, (3, 10))
    lens = np.array([10, 4, 7], np.int32)
    plain = T.generate(tlm, prompt, 10, prompt_lengths=lens).numpy()
    for i in range(3):
        assert_greedy_margins(jlm, variables, prompt[i, :lens[i]], plain[i])
    eos = int(plain[1, 3])  # a token row 1 emits mid-stream
    want = np.asarray(J.generate(
        jlm, variables, jnp.asarray(prompt), 10,
        prompt_lengths=jnp.asarray(lens), eos_id=eos,
    ))
    got = T.generate(tlm, prompt, 10, prompt_lengths=lens, eos_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[1, 3:] == eos).all()


def test_return_logprobs_allclose(models):
    jlm, variables, tlm = models
    prompt = np.random.RandomState(5).randint(0, tlm.vocab, (2, 6))
    jt, jl = J.generate(jlm, variables, jnp.asarray(prompt), 8,
                        return_logprobs=True)
    tt, tl = T.generate(tlm, prompt, 8, return_logprobs=True)
    np.testing.assert_array_equal(tt.numpy(), jt)
    np.testing.assert_allclose(tl.numpy(), jl, atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_top_k1_sampling_equals_greedy(models):
    _, _, tlm = models
    prompt = np.random.RandomState(6).randint(0, tlm.vocab, (2, 5))
    greedy = T.generate(tlm, prompt, 9)
    sampled = T.generate(tlm, prompt, 9, temperature=0.8, top_k=1, rng=11)
    assert torch.equal(greedy, sampled)


def test_sampled_rows_are_keyed_by_seed_row_and_step(models):
    _, _, tlm = models
    prompt = np.random.RandomState(7).randint(0, tlm.vocab, (1, 5))
    two = np.repeat(prompt, 2, axis=0)
    kw = dict(temperature=1.5, rng=123)
    batch = T.generate(tlm, two, 12, **kw)
    solo = T.generate(tlm, prompt, 12, **kw)
    assert torch.equal(batch[0], solo[0])  # row 0 draws as if alone
    assert not torch.equal(batch[0], batch[1])  # rows draw their own keys
    assert torch.equal(solo, T.generate(tlm, prompt, 12, **kw))
    assert not torch.equal(solo, T.generate(tlm, prompt, 12, temperature=1.5,
                                            rng=124))


def test_gumbel_draws_follow_the_softmax():
    """Counter-keyed Gumbel-max over 20k keys reproduces softmax
    probabilities within 5 standard errors."""
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0, 0.5]])
    n = 20000
    counters = torch.arange(n)
    noise = T.gumbel_noise(torch.full((n,), 9), torch.zeros(n, dtype=torch.long),
                           counters, 5)
    picks = torch.argmax(logits + noise, -1)
    freq = torch.bincount(picks, minlength=5).double() / n
    p = torch.softmax(logits[0].double(), -1)
    se = torch.sqrt(p * (1 - p) / n)
    assert (torch.abs(freq - p) < 5 * se).all(), (freq, p)


def test_nucleus_and_truncate_match_jax():
    rng = np.random.RandomState(8)
    lg = rng.randn(4, 30).astype(np.float32) * 3
    top_p = np.array([0.3, 0.9, 1.0, 0.05], np.float32)
    want = np.asarray(J.nucleus_filter(jnp.asarray(lg), jnp.asarray(top_p)))
    got = T.nucleus_filter(torch.from_numpy(lg), torch.from_numpy(top_p))
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    ks = torch.tensor([1, 5, 30, 12])
    kept = torch.isfinite(T.truncate_rows(torch.from_numpy(lg), ks)).sum(-1)
    assert kept.tolist() == [1, 5, 30, 12]


def test_position_ids_clamp_like_jax():
    """The dense trash row sits at ``max_len``: JAX clamps the gather,
    the port clamps explicitly (an unclamped CUDA gather asserts)."""
    jlm, variables, tlm = _build("tiny")
    emb = jlm.graph.node("embed").module
    ids = np.array([[3, 4]])
    pos = np.array([[tlm.max_len, -5]])
    want = jax.jit(  # under jit JAX clamps the gather (eagerly it raises)
        lambda v, i, p: emb.apply(v, i, p, method="embed_positions")
    )(variables["embed"], jnp.asarray(ids), jnp.asarray(pos))
    got = tlm.embed.embed_positions(torch.from_numpy(ids),
                                    torch.from_numpy(pos))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=TOL, rtol=TOL)


def test_rope_matches_jax():
    x = np.random.RandomState(9).randn(2, 3, 5, 8).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [-2, -1, 0, 1, 2]])
    want = J.apply_rope(jnp.asarray(x), jnp.asarray(pos))
    got = T.apply_rope(torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_validation_errors():
    tlm = T.lm_tiny(device="cpu")
    p = np.zeros((1, 4), np.int64)
    with pytest.raises(ValueError, match="max_len"):
        T.generate(tlm, p, 100)
    with pytest.raises(ValueError, match="rng"):
        T.generate(tlm, p, 3, temperature=1.0)
    with pytest.raises(ValueError, match="prompt_lengths"):
        T.generate(tlm, p, 3, prompt_lengths=[9])
    for kv in ("int8", "int4"):  # quantized caches are served
        assert T.generate(tlm, p, 3, kv_cache_dtype=kv).shape == (1, 3)
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        T.generate(tlm, p, 3, kv_cache_dtype="fp8")
    # MoE blocks are served (tests/test_torch_moe.py holds them to JAX).
    moe = T.transformer_lm(61, 64, 2, 8, 128, moe_experts=4, device="cpu")
    assert T.generate(moe, p, 3).shape == (1, 3)
    with pytest.raises(ValueError, match="top_k"):
        T.transformer_lm(61, 64, 2, 8, 128, moe_experts=4, moe_top_k=3,
                         device="cpu")
