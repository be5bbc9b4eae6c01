"""Ring attention and Ulysses of the port (``parallel/ring_attention``,
``parallel/ulysses``), held against the JAX package's on the CPU.

The JAX side runs on ``sim_mesh`` (virtual CPU devices, ``shard_map``);
the port's mesh names ``cpu`` once a rank, one process driving every rank.
Inputs come from numpy with a seed, in f32:

- ``stripe_sequence`` / ``unstripe_sequence`` equal JAX's exactly;
- ``ring_attention`` within 1e-5 of JAX's for ``block_impl`` jnp and flash
  (K1's plain version on CPU tensors), contiguous and striped, causal or
  not, sp 2 and 4; GQA-repeated heads; the odd-last-chunk recipe (pad to
  the ring, run causal, slice);
- the jnp path's gradients within 1e-5 of ``jax.grad``'s;
- ``ulysses_attention`` within 1e-5 of JAX's;
- every error case, ``"flash"`` under grad naming ``block_impl``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapt_tpu_torch.core.mesh import MeshSpec, build_mesh
from adapt_tpu_torch.parallel.ulysses import ulysses_attention

R = importlib.import_module("adapt_tpu_torch.parallel.ring_attention")
JR = importlib.import_module("adapt_tpu.parallel.ring_attention")
JU = importlib.import_module("adapt_tpu.parallel.ulysses")

TOL = dict(atol=1e-5, rtol=1e-5)


def _mesh(sp):
    return build_mesh(MeshSpec((("sp", sp),)), ["cpu"] * sp)


def _qkv(seed, b=1, h=4, s=32, d=16, kv_heads=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    kvh = kv_heads or h
    k = rng.standard_normal((b, kvh, s, d)).astype(np.float32)
    v = rng.standard_normal((b, kvh, s, d)).astype(np.float32)
    if kvh != h:  # adjacent-block repeat: the GQA convention
        k, v = np.repeat(k, h // kvh, axis=1), np.repeat(v, h // kvh, axis=1)
    return q, k, v


def _t(*xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


def _jring(sim_mesh, sp, q, k, v, **kw):
    """JAX's ring under ``jax.jit`` (an eager ``shard_map`` recompiles at
    every call)."""
    mesh = sim_mesh(sp, axis="sp")
    return np.asarray(jax.jit(lambda q, k, v: JR.ring_attention(
        q, k, v, mesh, axis="sp", **kw))(q, k, v))


@pytest.mark.parametrize("shape,ranks,axis", [
    ((1, 2, 32, 4), 4, 2), ((2, 3, 24, 8), 8, 2), ((40, 3), 5, 0)])
def test_stripe_unstripe_equal_jax(shape, ranks, axis):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = R.stripe_sequence(torch.from_numpy(x), ranks, axis)
    want = np.asarray(JR.stripe_sequence(jnp.asarray(x), ranks, axis))
    np.testing.assert_array_equal(got.numpy(), want)
    back = R.unstripe_sequence(got, ranks, axis)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(JR.unstripe_sequence(jnp.asarray(want),
                                                      ranks, axis)))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("layout", ["contiguous", "striped"])
@pytest.mark.parametrize("impl", ["jnp", "flash"])
def test_ring_attention_matches_jax(sim_mesh, impl, layout, causal, sp):
    q, k, v = _qkv(sp * 10 + causal)
    if layout == "striped":
        q, k, v = (np.asarray(JR.stripe_sequence(jnp.asarray(t), sp))
                   for t in (q, k, v))
    want = _jring(sim_mesh, sp, q, k, v, causal=causal, block_impl=impl,
                  layout=layout)
    got = R.ring_attention(*_t(q, k, v), _mesh(sp), causal=causal,
                           block_impl=impl, layout=layout)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if layout == "striped":
        got = R.unstripe_sequence(got, sp)
        ref = R.full_attention(*(R.unstripe_sequence(t, sp)
                                 for t in _t(q, k, v)), causal=causal)
    else:
        ref = R.full_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


@pytest.mark.parametrize("kv_heads", [None, 2, 1])
def test_ring_attention_gqa_heads(sim_mesh, kv_heads):
    q, k, v = _qkv(20, kv_heads=kv_heads)
    for causal in (False, True):
        want = _jring(sim_mesh, 4, q, k, v, causal=causal)
        got = R.ring_attention(*_t(q, k, v), _mesh(4), causal=causal)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_ring_attention_odd_last_chunk(sim_mesh):
    """27 tokens on a ring of 4 raise by name; padded to 28 under a causal
    mask, the real prefix matches the JAX ring and the unpadded oracle."""
    q, k, v = _qkv(2, h=2, s=27, d=8)
    with pytest.raises(ValueError, match="not divisible"):
        R.ring_attention(*_t(q, k, v), _mesh(4), causal=True)
    pq, pk, pv = (np.pad(t, ((0, 0), (0, 0), (0, 1), (0, 0)))
                  for t in (q, k, v))
    for impl in ("jnp", "flash"):
        want = _jring(sim_mesh, 4, pq, pk, pv, causal=True, block_impl=impl)
        got = R.ring_attention(*_t(pq, pk, pv), _mesh(4), causal=True,
                               block_impl=impl)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_allclose(
            got.numpy()[:, :, :27],
            R.full_attention(*_t(q, k, v), causal=True).numpy(), **TOL)


@pytest.mark.parametrize("layout", ["contiguous", "striped"])
def test_ring_attention_grads_match_jax(sim_mesh, layout):
    q, k, v = _qkv(5, h=2, s=16, d=8)
    mesh = sim_mesh(2, axis="sp")

    def loss(q, k, v):
        o = JR.ring_attention(q, k, v, mesh, axis="sp", causal=True,
                              layout=layout)
        return jnp.sum(o * jnp.cos(o))

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    o = R.ring_attention(tq, tk, tv, _mesh(2), causal=True, layout=layout)
    torch.sum(o * torch.cos(o)).backward()
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax(sim_mesh, sp, causal):
    q, k, v = _qkv(30 + sp, h=8)
    mesh = sim_mesh(sp, axis="sp")
    want = jax.jit(lambda q, k, v: JU.ulysses_attention(
        q, k, v, mesh, axis="sp", causal=causal))(q, k, v)
    got = ulysses_attention(*_t(q, k, v), _mesh(sp), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_auto_and_ring_pass():
    """On CPU tensors "auto" is the jnp path, bit for bit; the ring hop
    hands rank r's block to rank r + 1."""
    q, k, v = _t(*_qkv(6))
    a = R.ring_attention(q, k, v, _mesh(2), causal=True, block_impl="auto")
    b = R.ring_attention(q, k, v, _mesh(2), causal=True, block_impl="jnp")
    assert torch.equal(a, b)
    blocks = [torch.full((1,), float(r)) for r in range(4)]
    moved = R.ring_pass(blocks, [torch.device("cpu")] * 4)
    assert [float(t) for t in moved] == [3.0, 0.0, 1.0, 2.0]


def test_errors():
    q, k, v = _t(*_qkv(7, h=6, s=30))
    mesh = _mesh(4)
    with pytest.raises(ValueError, match="not divisible by ring size"):
        R.ring_attention(q, k, v, mesh)
    q, k, v = _t(*_qkv(7, h=6, s=32))
    with pytest.raises(ValueError, match="block_impl"):
        R.ring_attention(q, k, v, mesh, block_impl="pallas")
    with pytest.raises(ValueError, match="layout"):
        R.ring_attention(q, k, v, mesh, layout="zigzag")
    with pytest.raises(ValueError, match="not divisible"):
        R.stripe_sequence(q, 5)
    with pytest.raises(ValueError, match="not divisible"):
        R.unstripe_sequence(q, 5)
    with pytest.raises(ValueError, match="heads 6 not divisible"):
        ulysses_attention(q, k, v, mesh)
    q2, k2, v2 = _t(*_qkv(7, h=8, s=30))
    with pytest.raises(ValueError, match="sequence 30 not divisible"):
        ulysses_attention(q2, k2, v2, mesh)
    tq = q.clone().requires_grad_()
    o = R.ring_attention(tq, k, v, mesh, causal=True, block_impl="flash")
    with pytest.raises(NotImplementedError, match="block_impl"):
        o.sum().backward()
