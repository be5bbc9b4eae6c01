"""K1: the port's flash attention against the JAX package.

On the CPU the port's wrappers run K1's plain version; it is held against
the JAX package's interpreted Pallas kernel (``_flash_impl``, the path its
own tests run) and its oracle, on the same numpy inputs, at
``atol = rtol = 2e-5`` (f32 on both sides; the frameworks' f32 matmuls
differ by ~1e-6). Fully padded query rows are unspecified in both
packages, so only valid rows are compared. The CUDA kernel itself is
held against the plain version in ``test_torch_kernels_gpu.py``."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapt_tpu_torch.ops import attention as TA

JA = importlib.import_module("adapt_tpu.ops.attention")

TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test workers at once,
    and these small shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = {
    # name: (b, h, s_q, s_k, d, kwargs)
    "causal": (2, 3, 48, 48, 16, dict(causal=True)),
    "causal_ragged": (1, 2, 50, 50, 16, dict(causal=True)),
    "noncausal_ragged_sk": (2, 2, 24, 37, 8, dict(causal=False)),
    "window": (1, 2, 64, 64, 16, dict(causal=True, window=16)),
    "valid_from": (3, 2, 40, 40, 16, dict(causal=True, vf=[0, 7, 33])),
    "valid_from_window": (2, 2, 48, 48, 8,
                          dict(causal=True, vf=[5, 0], window=8)),
    "shift": (1, 2, 32, 32, 16, dict(causal=True, shift=1)),
}


def _inputs(seed, b, h, s_q, s_k, d, kv_heads=None):
    rng = np.random.RandomState(seed)
    kh = kv_heads or h
    q = rng.randn(b, h, s_q, d).astype(np.float32)
    k = rng.randn(b, kh, s_k, d).astype(np.float32)
    v = rng.randn(b, kh, s_k, d).astype(np.float32)
    return q, k, v


def _valid_rows(a, vf, s_q):
    """(b, h, s_q, ...) -> valid query rows only (position >= vf)."""
    if vf is None:
        return np.asarray(a)
    keep = np.arange(s_q)[None, :] >= np.asarray(vf)[:, None]
    return np.asarray(a).transpose(0, 2, 1, *range(3, np.ndim(a)))[keep]


def _jax_kernel(q, k, v, kw):
    vf = kw.get("vf")
    shift = kw.get("shift")
    return JA._flash_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kw["causal"], 16, 16,
        with_lse=True,
        valid_from=None if vf is None else jnp.asarray(vf, jnp.int32),
        causal_shift=None if shift is None else jnp.asarray(shift, jnp.int32),
        window=kw.get("window"),
    )


def _port_plain(q, k, v, kw):
    vf = kw.get("vf")
    return TA._reference_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kw["causal"], None if vf is None else torch.tensor(vf),
        kw.get("shift"), kw.get("window"),
    )


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_interpreted_kernel(name):
    b, h, s_q, s_k, d, kw = CASES[name]
    q, k, v = _inputs(hash(name) % 1000, b, h, s_q, s_k, d)
    j_out, j_lse = _jax_kernel(q, k, v, kw)
    t_out, t_lse = _port_plain(q, k, v, kw)
    vf = kw.get("vf")
    lse_ok = np.asarray(j_lse) > -1e29  # rows with no live key: garbage
    np.testing.assert_allclose(
        _valid_rows(np.where(lse_ok[..., None], t_out.numpy(), 0), vf, s_q),
        _valid_rows(np.where(lse_ok[..., None], j_out, 0), vf, s_q),
        atol=TOL, rtol=TOL,
    )
    np.testing.assert_allclose(
        _valid_rows(np.where(lse_ok, t_lse.numpy(), 0), vf, s_q),
        _valid_rows(np.where(lse_ok, j_lse, 0), vf, s_q),
        atol=TOL, rtol=TOL,
    )


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_oracle(name):
    b, h, s_q, s_k, d, kw = CASES[name]
    q, k, v = _inputs(1 + hash(name) % 1000, b, h, s_q, s_k, d)
    vf = kw.get("vf")
    j_out, j_lse = JA._reference_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kw["causal"],
        None if vf is None else jnp.asarray(vf), kw.get("shift"),
        kw.get("window"),
    )
    t_out, t_lse = _port_plain(q, k, v, kw)
    np.testing.assert_allclose(
        _valid_rows(t_out.numpy(), vf, s_q), _valid_rows(j_out, vf, s_q),
        atol=TOL, rtol=TOL,
    )
    np.testing.assert_allclose(
        _valid_rows(t_lse.numpy(), vf, s_q), _valid_rows(j_lse, vf, s_q),
        atol=TOL, rtol=TOL,
    )


def test_gqa_repeated_kv_matches_interpreted_kernel():
    """GQA prefill: kv heads repeated adjacent-block (query head i uses kv
    head i // group) in both packages, then K1."""
    q, k, v = _inputs(5, 2, 8, 32, 32, 16, kv_heads=2)
    jk, jv = (jnp.repeat(jnp.asarray(t), 4, axis=1) for t in (k, v))
    j_out = JA.flash_attention(jnp.asarray(q), jk, jv, causal=True,
                               block_q=16, block_k=16, prefer="pallas")
    tk, tv = (torch.repeat_interleave(torch.from_numpy(t), 4, dim=1)
              for t in (k, v))
    t_out = TA.flash_attention(torch.from_numpy(q), tk, tv, causal=True)
    np.testing.assert_allclose(t_out.numpy(), j_out, atol=TOL, rtol=TOL)


def test_public_wrappers_route_cpu_tensors_to_plain():
    b, h, s_q, s_k, d, kw = CASES["valid_from"]
    q, k, v = (torch.from_numpy(t) for t in _inputs(9, b, h, s_q, s_k, d))
    vf = torch.tensor(kw["vf"])
    out = TA.flash_attention(q, k, v, causal=True, valid_from=vf)
    ref = TA.attention_reference(q, k, v, causal=True, valid_from=vf)
    assert torch.equal(out, ref)
    out, lse = TA.flash_attention_with_lse(q, k, v, causal=True,
                                           causal_shift=1)
    r_out, r_lse = TA._reference_with_lse(q, k, v, True, None, 1)
    assert torch.equal(out, r_out) and torch.equal(lse, r_lse)
    assert TA.flash_attn_fwd.launches == 0


def test_argument_errors():
    q = torch.zeros(1, 1, 8, 16)
    with pytest.raises(ValueError, match="prefer"):
        TA.flash_attention(q, q, q, prefer="triton")
    with pytest.raises(ValueError, match="window"):
        TA.flash_attention(q, q, q, causal=False, window=4)
    with pytest.raises(ValueError, match="causal_shift"):
        TA.flash_attention_with_lse(q, q, q, causal=False, causal_shift=1)
