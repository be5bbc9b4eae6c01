"""K2 / K2-split: the port's decode attention against the JAX package.

On the CPU the port runs K2's plain version (64-key tiles, dead tiles
skipped, per-split partials + the rescale combine). It is held against
the JAX package's interpreted ``_decode_kernel`` / ``_decode_split_kernel``
where that kernel runs (``L % 256 == 0``) and against
``decode_attention_reference`` at the batcher's strip length ``max_len +
1``, at ``atol = rtol = 2e-5`` (f32 on both sides). The CUDA kernels
themselves are held against the plain version in
``test_torch_kernels_gpu.py``."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapt_tpu_torch.ops import decode_attention as TD

JD = importlib.import_module("adapt_tpu.ops.decode_attention")

TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test workers at once,
    and these small shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, b, kvh, g, L, hd):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, kvh, g, hd).astype(np.float32)
    ck = rng.randn(b, kvh, L, hd).astype(np.float32)
    cv = rng.randn(b, kvh, L, hd).astype(np.float32)
    idx = rng.randint(0, L, size=(b,)).astype(np.int32)
    idx[0] = L - 1  # one row over the whole strip
    return q, ck, cv, idx


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("split", [1, 3])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("with_vf", [False, True])
def test_plain_matches_interpreted_kernel(split, g, with_vf):
    b, kvh, L, hd = 3, 2, 512, 16
    q, ck, cv, idx = _inputs(10 * g + split, b, kvh, g, L, hd)
    vf = (idx // 2).astype(np.int32) if with_vf else None
    want = JD.decode_attention(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(idx),
        None if vf is None else jnp.asarray(vf), prefer="pallas",
        block_k=256, split=split,
    )
    got = TD.decode_attention(
        *_t(q, ck, cv), torch.from_numpy(idx),
        None if vf is None else torch.from_numpy(vf), split=split,
    )
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("split", [1, 3])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("with_vf", [False, True])
def test_plain_matches_reference_on_dense_strip(split, g, with_vf):
    """L = max_len + 1 (the batcher's strip with its trash slot): the
    length the TPU kernel refused, served here."""
    b, kvh, L, hd = 4, 2, 129, 16
    q, ck, cv, idx = _inputs(7 + g + split, b, kvh, g, L, hd)
    vf = np.minimum(idx, 40).astype(np.int32) if with_vf else None
    want = JD.decode_attention_reference(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(idx),
        None if vf is None else jnp.asarray(vf),
    )
    got = TD.decode_attention(
        *_t(q, ck, cv), torch.from_numpy(idx),
        None if vf is None else torch.from_numpy(vf), split=split,
    )
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    ref = TD.decode_attention_reference(
        *_t(q, ck, cv), torch.from_numpy(idx),
        None if vf is None else torch.from_numpy(vf),
    )
    np.testing.assert_allclose(ref.numpy(), want, atol=TOL, rtol=TOL)


def test_scalar_index_and_split_one_equals_split_many():
    q, ck, cv, _ = _inputs(3, 2, 2, 2, 300, 8)
    a = TD.decode_attention(*_t(q, ck, cv), 250, split=1)
    for split in (2, 5, 8):
        np.testing.assert_allclose(
            TD.decode_attention(*_t(q, ck, cv), 250, split=split).numpy(),
            a.numpy(), atol=TOL, rtol=TOL,
        )


def test_combine_splits_matches_jax():
    rng = np.random.RandomState(4)
    rows, split, g, hd = 3, 4, 2, 8
    o = rng.randn(rows, split, g, hd).astype(np.float32)
    m = rng.randn(rows, split, g).astype(np.float32)
    m[0, 1] = -1e30  # an all-dead split
    l = rng.rand(rows, split, g).astype(np.float32)
    l[0, 1] = 0.0
    want = JD._combine_splits(
        jnp.asarray(o), jnp.broadcast_to(jnp.asarray(m)[..., None], o.shape),
        jnp.broadcast_to(jnp.asarray(l)[..., None], o.shape), jnp.float32,
    )
    got = TD._combine_splits(*_t(o, m, l), torch.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("index", [0, 5, 30, [3, 31], [-2, 40]])
def test_append_kv_matches_jax_including_clamp(index):
    """Out-of-range starts clamp exactly as ``dynamic_update_slice``."""
    rng = np.random.RandomState(1)
    cache = rng.randn(2, 3, 32, 4).astype(np.float32)
    new = rng.randn(2, 3, 2, 4).astype(np.float32)
    want = JD.append_kv(jnp.asarray(cache), jnp.asarray(new),
                        jnp.asarray(index, jnp.int32))
    idx = index if isinstance(index, int) else torch.tensor(index)
    got = TD.append_kv(torch.from_numpy(cache.copy()), torch.from_numpy(new),
                       idx)
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantized_caches_and_head_mismatch_raise():
    """Quantized (values, scales) caches are served (K2q's plain version
    on the CPU, no kernel launch); a head mismatch and a bad ``prefer``
    still raise."""
    q = torch.zeros(1, 2, 1, 8)
    c = torch.zeros(1, 2, 16, 8)
    vals = torch.ones(1, 2, 16, 8, dtype=torch.int8)
    sc = torch.full((1, 2, 16, 1), 0.5)
    out = TD.decode_attention(q, (vals, sc), (vals, sc), 0)
    np.testing.assert_allclose(out.numpy(), 0.5)  # one live key, v = 1 * 0.5
    packed = torch.zeros(1, 2, 16, 4, dtype=torch.int8)
    out = TD.decode_attention(q, (packed, sc), (packed, sc), 3)
    assert out.shape == q.shape
    with pytest.raises(ValueError, match="KV-head"):
        TD.decode_attention(q, c[:, :1], c[:, :1], 0)
    with pytest.raises(ValueError, match="prefer"):
        TD.decode_attention(q, c, c, 0, prefer="cuda")
    assert TD.decode_attn.launches == 0 and TD.decode_attn_split.launches == 0
