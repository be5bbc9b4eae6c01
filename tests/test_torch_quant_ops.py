"""Quantized KV ops of the port against the JAX package, on the CPU.

``quantize_kv_vectors`` / ``pack_int4`` / ``unpack_int4`` must be bit-equal
to JAX's on the same input (round-half-to-even ties, all-zero vectors at the
1e-8 scale clamp, bf16 inputs). The quantized attention — K2q's reference
and tile-exact plain version (split 1 and 4), K3q's and K4q's — is held
against the JAX package's ``decode_attention_reference`` /
``paged_attention_reference`` / ``paged_chunk_attention_reference`` and its
interpreted Pallas kernels (``_decode_impl`` at L = 1024, the quantized
block; ``_paged_impl`` / ``_chunk_impl`` at page 128) on the same int8 /
packed-int4 bytes and f32 scales, at ``atol = rtol = 1e-5`` (f32 on both
sides; only the summation order differs). The CUDA kernels themselves are
held against these plain versions in ``test_torch_kernels_gpu.py``."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapt_tpu_torch.ops import decode_attention as TD
from adapt_tpu_torch.ops import paged_attention as TP
from adapt_tpu_torch.ops import quantize as TQ

JD = importlib.import_module("adapt_tpu.ops.decode_attention")
JP = importlib.import_module("adapt_tpu.ops.paged_attention")
JQ = importlib.import_module("adapt_tpu.ops.quantize")

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test workers at once,
    and these small shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- quantize / pack / unpack ------------------------------------------------


def _tie_vectors(qmax):
    """Vectors whose absmax is qmax (scale exactly 1), so x / scale lands
    on exact .5 ties; and an all-zero vector (the 1e-8 clamp)."""
    ties = np.array([qmax, 2.5, -3.5, 0.5, -0.5, 1.5, -2.5, 4.5],
                    np.float32)
    return np.stack([ties, np.zeros(8, np.float32), -ties])


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
@pytest.mark.parametrize("src", ["f32", "bf16", "ties"])
def test_quantize_kv_vectors_bit_equal(kv_dtype, src):
    rng = np.random.RandomState(0)
    if src == "ties":
        x = _tie_vectors(127.0 if kv_dtype == "int8" else 7.0)
    else:
        x = (rng.randn(3, 4, 33, 16) * rng.rand(3, 4, 33, 1) * 5).astype(
            np.float32)
        x[0, 0, 0] = 0.0  # an all-zero vector
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if src == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    jv, js = JQ.quantize_kv_vectors(jx, kv_dtype)
    tv, ts = TQ.quantize_kv_vectors(tx, kv_dtype)
    assert tv.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if src == "ties":  # half to even: 2.5 -> 2, -3.5 -> -4, 0.5 -> 0
        vals = TQ.kv_values(tv, 8).numpy()
        np.testing.assert_array_equal(vals[0, 1:5], [2, -4, 0, 0])
        assert not vals[1].any() and ts[1, 0] == np.float32(1e-8)


def test_pack_unpack_int4_bit_equal_and_inverse():
    rng = np.random.RandomState(1)
    x = rng.randint(-8, 8, size=(5, 3, 40)).astype(np.int32)
    x[0, 0, :16] = np.arange(-8, 8)  # every nibble value
    jp = np.asarray(JQ.pack_int4(jnp.asarray(x)))
    tp = TQ.pack_int4(torch.from_numpy(x))
    np.testing.assert_array_equal(tp.numpy(), jp)
    tu = TQ.unpack_int4(tp)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(
        JQ.unpack_int4(jnp.asarray(jp))))
    np.testing.assert_array_equal(tu.numpy(), x)
    # Element 2i is the low nibble: [1, -1] packs to 0xF1 = -15.
    assert TQ.pack_int4(torch.tensor([1, -1])).tolist() == [-15]


def test_quantize_errors_equal_jax():
    x = np.ones((2, 7), np.float32)
    for dt, t in (("int4", x), ("fp8", x[:, :6])):
        with pytest.raises(ValueError) as want:
            JQ.quantize_kv_vectors(jnp.asarray(t), dt)
        with pytest.raises(ValueError) as got:
            TQ.quantize_kv_vectors(torch.from_numpy(t), dt)
        assert str(got.value) == str(want.value)


# -- K2q: dense strips -------------------------------------------------------


def _quant_np(x, kv_dtype):
    v, s = TQ.quantize_kv_vectors(torch.from_numpy(x), kv_dtype)
    return v.numpy(), s.numpy()


def _j(pair):
    return tuple(jnp.asarray(a) for a in pair)


def _t(pair):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in pair)


def _decode_case(seed, b, kvh, g, L, hd, kv_dtype):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, kvh, g, hd).astype(np.float32)
    ck = _quant_np(rng.randn(b, kvh, L, hd).astype(np.float32), kv_dtype)
    cv = _quant_np(rng.randn(b, kvh, L, hd).astype(np.float32), kv_dtype)
    idx = rng.randint(0, L, size=(b,)).astype(np.int32)
    idx[0] = L - 1  # one row over the whole strip
    idx[-1] = -9  # a dead row
    vf = (np.maximum(idx, 0) // 3).astype(np.int32)
    return q, ck, cv, idx, vf


DECODE_CASES = {
    # name: (g, hd, with valid_from)
    "mha": (1, 16, False),
    "gqa_vf": (4, 16, True),
    "hd128_vf": (2, 128, True),
}


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
@pytest.mark.parametrize("split", [1, 4])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_k2q_plain_matches_interpreted_kernel(kv_dtype, split, case):
    """L = 1024 (the quantized TPU block); every row, the dead one
    included (zeros on both sides), is compared."""
    g, hd, with_vf = DECODE_CASES[case]
    q, ck, cv, idx, vf = _decode_case(3 + split + g, 3, 2, g, 1024, hd,
                                      kv_dtype)
    vf = vf if with_vf else None
    want = JD.decode_attention(
        jnp.asarray(q), _j(ck), _j(cv), jnp.asarray(idx),
        None if vf is None else jnp.asarray(vf), prefer="pallas",
        block_k=1024, split=split,
    )
    got = TD.decode_attention(
        torch.from_numpy(q), _t(ck), _t(cv), torch.from_numpy(idx),
        None if vf is None else torch.from_numpy(vf), split=split,
    )
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    assert not got[-1].any()


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_k2q_reference_and_plain_match_jax_reference(kv_dtype, case):
    """L = max_len + 1 = 129 (the batcher's strip): live rows of the
    reference and of the plain version (split 1 and 4) against JAX's."""
    g, hd, with_vf = DECODE_CASES[case]
    q, ck, cv, idx, vf = _decode_case(11 + g, 4, 2, g, 129, hd, kv_dtype)
    vf = vf if with_vf else None
    jvf = None if vf is None else jnp.asarray(vf)
    tvf = None if vf is None else torch.from_numpy(vf)
    want = np.asarray(JD.decode_attention_reference(
        jnp.asarray(q), _j(ck), _j(cv), jnp.asarray(idx), jvf))
    live = idx >= 0  # the oracle spreads a dead row uniformly
    ref = TD.decode_attention_reference(
        torch.from_numpy(q), _t(ck), _t(cv), torch.from_numpy(idx), tvf)
    np.testing.assert_allclose(ref.numpy(), want, atol=TOL, rtol=TOL)
    for split in (1, 4):
        got = TD.decode_attention_plain(
            torch.from_numpy(q), _t(ck), _t(cv), torch.from_numpy(idx), tvf,
            split).numpy()
        np.testing.assert_allclose(got[live], want[live], atol=TOL, rtol=TOL)


# -- K3q / K4q: paged pools --------------------------------------------------


def _table(rng, b, pps, npages):
    """Shuffled page ids (rows sharing their first page, the last row's
    tail at the trash page)."""
    perm = rng.permutation(np.arange(1, npages))
    t = np.zeros((b, pps), np.int32)
    for i in range(b):
        t[i] = perm[i * (pps - 1): i * (pps - 1) + pps]
    t[1, 0] = t[0, 0]
    t[-1, -1] = 0
    return t


def _paged_case(seed, b, kvh, g, hd, page, pps, kv_dtype):
    rng = np.random.RandomState(seed)
    npages = b * pps + 2
    kp = _quant_np(rng.randn(npages, kvh, page, hd).astype(np.float32),
                   kv_dtype)
    vp = _quant_np(rng.randn(npages, kvh, page, hd).astype(np.float32),
                   kv_dtype)
    q = rng.randn(b, kvh, g, hd).astype(np.float32)
    table = _table(rng, b, pps, npages)
    width = pps * page
    idx = rng.randint(0, width - page, size=b).astype(np.int32)
    idx[0] = width - 1
    idx[-1] = -4  # a dead row
    vf = np.minimum(np.maximum(idx, 0) // 3, 40).astype(np.int32)
    return q, kp, vp, table, idx, vf


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
@pytest.mark.parametrize("split", [1, 3])
@pytest.mark.parametrize("g", [1, 4])
def test_k3q_plain_matches_interpreted_kernel(kv_dtype, split, g):
    q, kp, vp, table, idx, vf = _paged_case(
        20 + g + split, 3, 2, g, 16, 128, 3, kv_dtype)
    want = JP.paged_attention(
        jnp.asarray(q), _j(kp), _j(vp), jnp.asarray(table), jnp.asarray(idx),
        jnp.asarray(vf), prefer="pallas", split=split,
    )
    got = TP.paged_attention(
        torch.from_numpy(q), _t(kp), _t(vp), torch.from_numpy(table),
        torch.from_numpy(idx), torch.from_numpy(vf), split=split,
    )
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    assert not got[-1].any()


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
@pytest.mark.parametrize("split", [1, 3])
def test_k3q_plain_matches_gather_oracle_page16(kv_dtype, split):
    q, kp, vp, table, idx, vf = _paged_case(
        30 + split, 4, 2, 4, 16, 16, 5, kv_dtype)
    for valid_from in (None, vf):
        jvf = None if valid_from is None else jnp.asarray(valid_from)
        tvf = None if valid_from is None else torch.from_numpy(valid_from)
        want = np.asarray(JP.paged_attention_reference(
            jnp.asarray(q), _j(kp), _j(vp), jnp.asarray(table),
            jnp.asarray(idx), jvf))
        got = TP.paged_attention(
            torch.from_numpy(q), _t(kp), _t(vp), torch.from_numpy(table),
            torch.from_numpy(idx), tvf, split=split).numpy()
        live = idx >= 0
        np.testing.assert_allclose(got[live], want[live], atol=TOL, rtol=TOL)
        ref = TP.paged_attention_reference(
            torch.from_numpy(q), _t(kp), _t(vp), torch.from_numpy(table),
            torch.from_numpy(idx), tvf).numpy()
        np.testing.assert_allclose(ref, want, atol=TOL, rtol=TOL)


def _chunk_case(seed, kvh, g, chunk, hd, page, pos0, kv_dtype, npages=14):
    rng = np.random.RandomState(seed)
    kp = _quant_np(rng.randn(npages, kvh, page, hd).astype(np.float32),
                   kv_dtype)
    vp = _quant_np(rng.randn(npages, kvh, page, hd).astype(np.float32),
                   kv_dtype)
    q = rng.randn(1, kvh, g * chunk, hd).astype(np.float32)
    n_strip = (pos0 + chunk) // page
    n_pad = 1 << (n_strip - 1).bit_length()
    live = rng.permutation(np.arange(1, npages))[:n_strip]
    pages = np.concatenate([live, np.zeros(n_pad - n_strip, np.int64)])
    return q, kp, vp, pages.astype(np.int32)


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
@pytest.mark.parametrize("pos0_pages", [0, 3])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("window", [None, 150])
def test_k4q_plain_matches_interpreted_kernel(kv_dtype, pos0_pages, g,
                                              window):
    page = chunk = 128
    pos0 = pos0_pages * page
    q, kp, vp, pages = _chunk_case(40 + pos0_pages + g, 2, g, chunk, 16,
                                   page, pos0, kv_dtype)
    want = JP.paged_chunk_attention(
        jnp.asarray(q), _j(kp), _j(vp), jnp.asarray(pages), pos0, chunk,
        prefer="pallas", window=window,
    )
    got = TP.paged_chunk_attention(
        torch.from_numpy(q), _t(kp), _t(vp), torch.from_numpy(pages), pos0,
        chunk, window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
@pytest.mark.parametrize("window", [None, 20])
def test_k4q_plain_matches_gather_oracle_page16(kv_dtype, window):
    page, chunk = 16, 32
    for pos0 in (0, 48):
        q, kp, vp, pages = _chunk_case(50 + pos0, 2, 4, chunk, 16, page,
                                       pos0, kv_dtype)
        want = JP.paged_chunk_attention_reference(
            jnp.asarray(q), _j(kp), _j(vp), jnp.asarray(pages), pos0, chunk,
            window=window)
        got = TP.paged_chunk_attention(
            torch.from_numpy(q), _t(kp), _t(vp), torch.from_numpy(pages),
            pos0, chunk, window=window)
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_split_pools_and_pool_values_match_jax():
    vals = torch.zeros(3, 2, 8, 4, dtype=torch.int8)
    sc = torch.ones(3, 2, 8, 1)
    assert TP._split_pools((vals, sc), (vals, sc)) == (vals, vals, sc, sc)
    assert TP._split_pools(sc, sc) == (sc, sc, None, None)
    assert TP.pool_values((vals, sc)) is vals and TP.pool_values(sc) is sc
    jv = jnp.zeros((3, 2, 8, 4), jnp.int8)
    js = jnp.ones((3, 2, 8, 1))
    assert JP._split_pools((jv, js), (jv, js))[2] is js
