"""K7: the port's flash-attention backward against the JAX package.

On the CPU the port's autograd ``flash_attention`` runs K7's plain version
(``flash_attention_bwd_plain``). It is held against the JAX package's
streaming backward ``_flash_bwd_impl`` (both Pallas passes, interpreted, as
the JAX package's own tests run them) on the same numpy inputs and the
same saved ``(out, lse)`` from ``_flash_impl(with_lse=True)``, at
``atol = rtol = 2e-4`` (JAX's own bar for the streaming backward,
``tests/test_ops.py``), and the autograd gradients against ``jax.vjp`` of
the JAX oracle ``attention_reference``. With ``valid_from``, fully padded
query rows are unspecified: their dq is not compared and their cotangent
is zero. The CUDA kernel itself is held against the plain version in
``test_torch_kernels_gpu.py``."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapt_tpu_torch.ops import attention as TA

JA = importlib.import_module("adapt_tpu.ops.attention")

TOL = 2e-4

CASES = {
    # name: (b, h, s_q, s_k, d, kwargs)
    "noncausal_ragged_197": (1, 2, 197, 197, 16, dict(causal=False)),
    "causal": (1, 2, 128, 128, 32, dict(causal=True)),
    "window": (1, 2, 160, 160, 16, dict(causal=True, window=40)),
    "valid_from": (2, 2, 96, 96, 16, dict(causal=True, vf=[0, 37])),
    "sq_ne_sk": (2, 2, 24, 70, 16, dict(causal=False)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, b, h, s_q, s_k, d, vf=None):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, s_q, d).astype(np.float32)
    k = rng.randn(b, h, s_k, d).astype(np.float32)
    v = rng.randn(b, h, s_k, d).astype(np.float32)
    do = rng.randn(b, h, s_q, d).astype(np.float32)
    if vf is not None:  # padded rows carry no cotangent
        do = do * _valid(vf, b, s_q)[:, None, :, None]
    return q, k, v, do


def _valid(vf, b, s_q):
    if vf is None:
        return np.ones((b, s_q), bool)
    return np.arange(s_q)[None, :] >= np.asarray(vf)[:, None]


def _rows(a, vf, b, s_q):
    """(b, h, s_q, d) -> the valid query rows only."""
    return np.asarray(a).transpose(0, 2, 1, 3)[_valid(vf, b, s_q)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_interpreted_streaming_backward(name):
    b, h, s_q, s_k, d, kw = CASES[name]
    vf = kw.get("vf")
    q, k, v, do = _inputs(sorted(CASES).index(name), b, h, s_q, s_k, d, vf)
    jvf = None if vf is None else jnp.asarray(vf, jnp.int32)
    jq, jk, jv, jdo = (jnp.asarray(t) for t in (q, k, v, do))
    out, lse = JA._flash_impl(jq, jk, jv, kw["causal"], 64, 64,
                              with_lse=True, valid_from=jvf,
                              window=kw.get("window"))
    j_grads = JA._flash_bwd_impl(
        jq, jk, jv, out, lse, jdo, causal=kw["causal"], block_q=64,
        block_k=64, valid_from=jvf, window=kw.get("window"))
    t_grads = TA.flash_attention_bwd_plain(
        *(torch.from_numpy(np.array(t)) for t in (q, k, v, out, lse, do)),
        causal=kw["causal"], valid_from=None if vf is None else
        torch.tensor(vf), window=kw.get("window"))
    np.testing.assert_allclose(_rows(t_grads[0].numpy(), vf, b, s_q),
                               _rows(j_grads[0], vf, b, s_q),
                               atol=TOL, rtol=TOL)
    for t, j in zip(t_grads[1:], j_grads[1:]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL,
                                   rtol=TOL)
        assert t.dtype == torch.float32


@pytest.mark.parametrize("name", sorted(CASES))
def test_autograd_matches_jax_vjp_of_oracle(name):
    b, h, s_q, s_k, d, kw = CASES[name]
    vf = kw.get("vf")
    seed = 7 + sorted(CASES).index(name)
    q, k, v, do = _inputs(seed, b, h, s_q, s_k, d, vf)
    jvf = None if vf is None else jnp.asarray(vf, jnp.int32)
    _, vjp = jax.vjp(
        lambda q_, k_, v_: JA.attention_reference(
            q_, k_, v_, causal=kw["causal"], valid_from=jvf,
            window=kw.get("window")),
        *(jnp.asarray(t) for t in (q, k, v)))
    j_grads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    out = TA.flash_attention(
        tq, tk, tv, causal=kw["causal"], window=kw.get("window"),
        valid_from=None if vf is None else torch.tensor(vf))
    out.backward(torch.from_numpy(do))
    t_grads = (tq.grad, tk.grad, tv.grad)
    np.testing.assert_allclose(_rows(t_grads[0].numpy(), vf, b, s_q),
                               _rows(j_grads[0], vf, b, s_q),
                               atol=TOL, rtol=TOL)
    for t, j in zip(t_grads[1:], j_grads[1:]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL,
                                   rtol=TOL)


def test_bf16_gradients_come_back_in_bf16():
    q, k, v, do = (torch.from_numpy(t).to(torch.bfloat16)
                   for t in _inputs(3, 1, 2, 40, 40, 16))
    out, lse = TA._reference_with_lse(q, k, v, True)
    grads = TA.flash_attention_bwd_plain(q, k, v, out, lse, do, True)
    ref = TA.flash_attention_bwd_plain(
        *(t.float() for t in (q, k, v, out)), lse, do.float(), True)
    for g, r in zip(grads, ref):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), r, atol=2e-2, rtol=2e-2)


def test_no_grad_calls_keep_the_forward_only_path():
    q, k, v, _ = (torch.from_numpy(t) for t in _inputs(4, 2, 2, 33, 33, 16))
    ref = TA.attention_reference(q, k, v, causal=True)
    assert torch.equal(TA.flash_attention(q, k, v, causal=True), ref)
    qg = q.clone().requires_grad_()
    with torch.no_grad():
        assert torch.equal(TA.flash_attention(qg, k, v, causal=True), ref)
    out = TA.flash_attention(qg, k, v, causal=True)
    assert out.grad_fn is not None
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=1e-6)
    assert TA.flash_attn_fwd.launches == 0 and TA.flash_attn_bwd.launches == 0


def test_forward_only_entry_points_refuse_grad():
    q, k, v, _ = (torch.from_numpy(t) for t in _inputs(5, 1, 2, 16, 16, 16))
    qg = q.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="forward-only"):
        TA.flash_attention_with_lse(qg, k, v, causal=True)
    with pytest.raises(NotImplementedError, match="forward-only"):
        TA.flash_attention_with_lse(q, k, v.clone().requires_grad_(),
                                    causal=True, causal_shift=1)
    with torch.no_grad():
        out, lse = TA.flash_attention_with_lse(qg, k, v, causal=True,
                                               causal_shift=1)
    assert out.shape == q.shape and lse.shape == q.shape[:3]
