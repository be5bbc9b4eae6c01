"""The port's decoder LM over quantized KV caches against the JAX
package's, on the CPU.

Weights come from the JAX package through ``convert.from_flax``; inputs are
numpy arrays given to both. Block level: ``prefill(quantize_cache=...)``
returns the same ``(values, scales)`` pairs (scales at ``rtol = 1e-5``;
values equal except where the two frameworks' f32 projections, ~1e-6
apart, straddle a rounding boundary: then by one step, at most 1 in 1000),
and a cached decode step, a paged decode step and a chunk pass over the
same quantized caches match at ``atol = rtol = 2e-5`` with the same caches
written. Model level: ``generate(kv_cache_dtype="int8" | "int4")`` is
token-equal to JAX's, ragged prompts and EOS included, with logprobs at the
``1e-4`` logit tolerance."""

import importlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapt_tpu_torch.convert import from_flax
from adapt_tpu_torch.models import transformer_lm as T
from adapt_tpu_torch.ops import quantize as TQ

J = importlib.import_module("adapt_tpu.models.transformer_lm")
JQ = importlib.import_module("adapt_tpu.ops.quantize")

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
    "tiny": dict(vocab=256, dim=64, depth=4, heads=4, mlp=128, max_len=64),
    "gqa_rope_window": dict(vocab=61, dim=64, depth=2, heads=8, mlp=128,
                            max_len=128, kv_heads=4, pos="rope", window=16),
}
_CACHE = {}


def _build(name):
    if name not in _CACHE:
        c = dict(CONFIGS[name])
        args = [c.pop(k) for k in ("vocab", "dim", "depth", "heads", "mlp")]
        jlm = J.transformer_lm(*args, **c)
        variables = jax.device_get(jlm.graph.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32)))
        tlm = T.transformer_lm(*args, device="cpu", **c)
        tlm.load_state_dict(from_flax(variables))
        _CACHE[name] = (jlm, variables, tlm)
    return _CACHE[name]


def _np_pair(pair):
    return tuple(np.asarray(m) for m in pair)


def _t_jnp(pair):
    return tuple(jnp.asarray(m) for m in pair)


def _t_pair(pair):
    return tuple(torch.from_numpy(np.array(m)) for m in pair)


def _assert_quantized_close(got, want, hd):
    """Scales at rtol 1e-5; values (int4 unpacked) equal but for rare
    one-step rounding flips where the two f32 inputs straddle a .5
    boundary."""
    gv, gs = (np.array(m) for m in got)
    wv, ws = (np.array(m) for m in want)
    np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=0)
    diff = np.abs(TQ.kv_values(torch.from_numpy(gv), hd).numpy()
                  - TQ.kv_values(torch.from_numpy(wv), hd).numpy())
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_block_quantized_prefill_and_decode_step_match(name, kv_dtype):
    jlm, variables, tlm = _build(name)
    bname = "decoder_block_1"
    jblock, tblock = jlm.graph.node(bname).module, getattr(tlm, bname)
    rng = np.random.RandomState(0)
    b, s, max_len = 2, 12, 20
    x = rng.randn(b, s, 64).astype(np.float32)
    vf = np.array([0, 3], np.int32)
    jy, jk, jv = jblock.apply(variables[bname], jnp.asarray(x), max_len,
                              jnp.asarray(vf), kv_dtype, method="prefill")
    with torch.no_grad():
        ty, tk, tv = tblock.prefill(torch.from_numpy(x), max_len,
                                    torch.from_numpy(vf), kv_dtype)
    keep = np.arange(s)[None, :] >= vf[:, None]
    np.testing.assert_allclose(ty.numpy()[keep], np.asarray(jy)[keep],
                               atol=TOL, rtol=TOL)
    hd = tblock.head_dim
    assert tk[0].dtype == torch.int8
    assert tk[0].shape[-1] == (hd // 2 if kv_dtype == "int4" else hd)
    for got, want in ((tk, jk), (tv, jv)):
        _assert_quantized_close(got, want, hd)
    # One cached decode step per row at its own index, over JAX's caches.
    x_t = rng.randn(b, 1, 64).astype(np.float32)
    idx = np.array([s, s + 3], np.int32)
    jo, jk2, jv2 = jblock.apply(variables[bname], jnp.asarray(x_t), jk, jv,
                                jnp.asarray(idx), jnp.asarray(vf), True,
                                "xla", method="decode_step")
    ck, cv = _t_pair(jk), _t_pair(jv)
    with torch.no_grad():
        to, tk2, tv2 = tblock.decode_step(
            torch.from_numpy(x_t), ck, cv, torch.from_numpy(idx),
            torch.from_numpy(vf))
    np.testing.assert_allclose(to.numpy(), jo, atol=TOL, rtol=TOL)
    assert tk2[0] is ck[0] and tk2[1] is ck[1]  # written in place
    for got, want in ((tk2, jk2), (tv2, jv2)):
        _assert_quantized_close(got, want, hd)


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_block_quantized_paged_steps_match(kv_dtype):
    """decode_step_paged (a dead row included) and prefill_chunk_paged
    over quantized pool pairs, against JAX's, on the GQA + rope + window
    model."""
    jlm, variables, tlm = _build("gqa_rope_window")
    name = "decoder_block_1"
    jblock, tblock = jlm.graph.node(name).module, getattr(tlm, name)
    rng = np.random.RandomState(3)
    kvh, page, hd, npages = 4, 8, 8, 12

    def pool():
        v, s = JQ.quantize_kv_vectors(
            jnp.asarray(rng.randn(npages, kvh, page, hd).astype(np.float32)),
            kv_dtype)
        return _np_pair((v, s))

    kp, vp = pool(), pool()
    table = np.asarray([[5, 2, 9, 0], [7, 3, 0, 0]], np.int32)
    x = rng.randn(2, 1, 64).astype(np.float32)
    index = np.asarray([19, -3], np.int32)  # row 1 is dead
    want, jkp, jvp = jax.jit(partial(jblock.apply,
                                     method="decode_step_paged"))(
        variables[name], jnp.asarray(x), _t_jnp(kp), _t_jnp(vp),
        jnp.asarray(table), jnp.asarray(index))
    tk, tv = _t_pair(kp), _t_pair(vp)
    with torch.no_grad():
        got, _, _ = tblock.decode_step_paged(
            torch.from_numpy(x), tk, tv, torch.from_numpy(table),
            torch.from_numpy(index))
    np.testing.assert_allclose(got[:1].numpy(), np.asarray(want)[:1],
                               atol=TOL, rtol=TOL)
    for t_pool, j_pool in ((tk, jkp), (tv, jvp)):
        # Page 0 takes the dead row's garbage unordered; the rest match.
        _assert_quantized_close(tuple(m[1:] for m in t_pool),
                                tuple(np.asarray(m)[1:] for m in j_pool), hd)
    np.testing.assert_array_equal(tk[0].numpy()[7], kp[0][7])  # not written
    np.testing.assert_array_equal(tk[1].numpy()[7], kp[1][7])
    # A chunk pass at pos0 = 8 over a window of 3 pages padded to 4.
    xc = rng.randn(1, 16, 64).astype(np.float32)
    pages = np.asarray([5, 2, 9, 0], np.int32)
    want, jkp, jvp = jax.jit(
        partial(jblock.apply, method="prefill_chunk_paged"), static_argnums=5
    )(variables[name], jnp.asarray(xc), _t_jnp(kp), _t_jnp(vp),
      jnp.asarray(pages), 8)
    tk, tv = _t_pair(kp), _t_pair(vp)
    with torch.no_grad():
        got, _, _ = tblock.prefill_chunk_paged(
            torch.from_numpy(xc), tk, tv, torch.from_numpy(pages), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    for t_pool, j_pool in ((tk, jkp), (tv, jvp)):
        _assert_quantized_close(t_pool, j_pool, hd)


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_quantized_generate_token_equal(name, kv_dtype):
    jlm, variables, tlm = _build(name)
    prompt = np.random.RandomState(3).randint(0, tlm.vocab, (3, 9))
    jt, jl = J.generate(jlm, variables, jnp.asarray(prompt), 12,
                        kv_cache_dtype=kv_dtype, return_logprobs=True)
    tt, tl = T.generate(tlm, prompt, 12, kv_cache_dtype=kv_dtype,
                        return_logprobs=True)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_quantized_ragged_generate_with_eos_token_equal(kv_dtype):
    jlm, variables, tlm = _build("gqa_rope_window")
    rng = np.random.RandomState(4)
    prompt = rng.randint(0, tlm.vocab, (3, 10))
    lens = np.array([10, 4, 7], np.int32)
    plain = T.generate(tlm, prompt, 10, prompt_lengths=lens,
                       kv_cache_dtype=kv_dtype).numpy()
    eos = int(plain[1, 3])
    want = np.asarray(J.generate(
        jlm, variables, jnp.asarray(prompt), 10,
        prompt_lengths=jnp.asarray(lens), eos_id=eos,
        kv_cache_dtype=kv_dtype,
    ))
    got = T.generate(tlm, prompt, 10, prompt_lengths=lens, eos_id=eos,
                     kv_cache_dtype=kv_dtype).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[1, 3:] == eos).all()
