"""K3 / K3-split and K4: the port's paged attention against the JAX package.

On the CPU the port runs the kernels' plain versions: K3's is K2's
tile-exact plain version over the slot's table-mapped window; K4's is the
gather oracle with the per-row diagonal. They are held against the JAX
package's interpreted ``_paged_kernel`` / ``_paged_split_kernel`` /
``_chunk_kernel`` where those run (``page % 128 == 0``) and against
``paged_attention_reference`` / ``paged_chunk_attention_reference`` at pages
of 8 and 16, at ``atol = rtol = 2e-5`` (f32 on both sides). Tables are
shuffled, non-contiguous and share pages between rows, so an address of
``row * pps + j`` instead of ``table[row, j]`` fails. The CUDA kernels
themselves are held against the plain versions in
``test_torch_kernels_gpu.py``."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapt_tpu_torch.ops import paged_attention as TP
from adapt_tpu_torch.runtime.paged import insert_prefill_pages

JP = importlib.import_module("adapt_tpu.ops.paged_attention")
JPG = importlib.import_module("adapt_tpu.runtime.paged")

TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test workers at once,
    and these small shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pools(rng, npages, kvh, page, hd):
    kp = rng.randn(npages, kvh, page, hd).astype(np.float32)
    vp = rng.randn(npages, kvh, page, hd).astype(np.float32)
    return kp, vp


def _table(rng, b, pps, npages):
    """Shuffled page ids 1..npages-1 (never low-first), rows sharing their
    first page, the last row's tail at the trash page."""
    perm = rng.permutation(np.arange(1, npages))
    t = np.zeros((b, pps), np.int32)
    for i in range(b):
        t[i] = perm[i * (pps - 1): i * (pps - 1) + pps]
    t[1, 0] = t[0, 0]  # a page shared between two rows
    t[-1, -1] = 0
    return t


def _decode_case(seed, b, kvh, g, hd, page, pps):
    rng = np.random.RandomState(seed)
    npages = b * pps + 2
    kp, vp = _pools(rng, npages, kvh, page, hd)
    q = rng.randn(b, kvh, g, hd).astype(np.float32)
    table = _table(rng, b, pps, npages)
    width = pps * page
    idx = rng.randint(0, width - page, size=b).astype(np.int32)
    idx[0] = width - 1  # one row over its whole window
    idx[-1] = -(3 + 1)  # a dead row (the batcher's idle sentinel)
    vf = np.minimum(np.maximum(idx, 0) // 3, 40).astype(np.int32)
    return q, kp, vp, table, idx, vf


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("split", [1, 3])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("with_vf", [False, True])
def test_k3_plain_matches_interpreted_kernel(split, g, with_vf):
    """Page 128: the JAX kernel runs (interpreted); every row, the dead
    one included (zeros on both sides), is compared."""
    q, kp, vp, table, idx, vf = _decode_case(
        20 + 10 * g + split, b=3, kvh=2, g=g, hd=16, page=128, pps=3)
    vf = vf if with_vf else None
    want = JP.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(idx), None if vf is None else jnp.asarray(vf),
        prefer="pallas", split=split,
    )
    got = TP.paged_attention(
        *_t(q, kp, vp, table), torch.from_numpy(idx),
        None if vf is None else torch.from_numpy(vf), split=split,
    )
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    assert not got[-1].any()  # the dead row


@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("split", [1, 3])
@pytest.mark.parametrize("g", [1, 4])
def test_k3_plain_matches_reference_small_pages(page, split, g):
    """Pages of 8 and 16 (the TPU kernel's gate sends them to the oracle;
    K3 serves them): live rows against ``paged_attention_reference``."""
    q, kp, vp, table, idx, vf = _decode_case(
        7 + page + g + split, b=4, kvh=2, g=g, hd=16, page=page, pps=5)
    for valid_from in (None, vf):
        want = np.asarray(JP.paged_attention_reference(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(table), jnp.asarray(idx),
            None if valid_from is None else jnp.asarray(valid_from),
        ))
        got = TP.paged_attention(
            *_t(q, kp, vp, table), torch.from_numpy(idx),
            None if valid_from is None else torch.from_numpy(valid_from),
            split=split,
        ).numpy()
        live = idx >= 0  # the oracle spreads a dead row uniformly
        np.testing.assert_allclose(got[live], want[live], atol=TOL, rtol=TOL)
        assert not got[~live].any()
        ref = TP.paged_attention_reference(
            *_t(q, kp, vp, table), torch.from_numpy(idx),
            None if valid_from is None else torch.from_numpy(valid_from),
        ).numpy()
        np.testing.assert_allclose(ref, want, atol=TOL, rtol=TOL)


def _chunk_case(seed, kvh, g, chunk, hd, page, pos0, npages=14):
    rng = np.random.RandomState(seed)
    kp, vp = _pools(rng, npages, kvh, page, hd)
    q = rng.randn(1, kvh, g * chunk, hd).astype(np.float32)
    n_strip = (pos0 + chunk) // page
    n_pad = 1
    while n_pad < n_strip:
        n_pad *= 2
    live = rng.permutation(np.arange(1, npages))[:n_strip]
    pages = np.concatenate([live, np.zeros(n_pad - n_strip, np.int64)])
    return q, kp, vp, pages.astype(np.int32)


@pytest.mark.parametrize("pos0_pages", [0, 1, 3])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("window", [None, 150])
def test_k4_plain_matches_interpreted_kernel(pos0_pages, g, window):
    """Page 128, pos0 in {0, P, 3P}, the window padded to a power of two
    with trash pages, a sliding window band."""
    page, chunk = 128, 128
    q, kp, vp, pages = _chunk_case(
        30 + pos0_pages + g, kvh=2, g=g, chunk=chunk, hd=16, page=page,
        pos0=pos0_pages * page)
    pos0 = pos0_pages * page
    want = JP.paged_chunk_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pages),
        pos0, chunk, prefer="pallas", window=window,
    )
    got = TP.paged_chunk_attention(*_t(q, kp, vp, pages), pos0, chunk,
                                   window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("pos0_pages", [0, 1, 3])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("window", [None, 20])
def test_k4_plain_matches_reference_page16(pos0_pages, g, window):
    page, chunk = 16, 32
    pos0 = pos0_pages * page
    q, kp, vp, pages = _chunk_case(
        40 + pos0_pages + g, kvh=2, g=g, chunk=chunk, hd=16, page=page,
        pos0=pos0)
    want = JP.paged_chunk_attention_reference(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pages),
        pos0, chunk, window=window,
    )
    got = TP.paged_chunk_attention(*_t(q, kp, vp, pages), pos0, chunk,
                                   window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_insert_prefill_pages_matches_jax():
    rng = np.random.RandomState(5)
    kvh, page, hd, npages = 2, 16, 8, 10
    pool = rng.randn(npages, kvh, page, hd).astype(np.float32)
    kv = rng.randn(1, kvh, 40, hd).astype(np.float32)  # 40 -> 3 pages
    pages = np.asarray([4, 7, 2], np.int32)
    want = JPG.insert_prefill_pages(jnp.asarray(pool), jnp.asarray(pages),
                                    jnp.asarray(kv))
    got = insert_prefill_pages(torch.from_numpy(pool.copy()),
                               torch.from_numpy(pages), torch.from_numpy(kv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="pages"):
        insert_prefill_pages(got, torch.from_numpy(pages[:2]),
                             torch.from_numpy(kv))


def test_quantized_pools_head_mismatch_and_prefer_raise():
    """Quantized (values, scales) pools are served (the plain versions of
    K3q / K4q on the CPU, no kernel launch); a head mismatch, a bad
    ``prefer`` and kernel calls on CPU tensors still raise."""
    q = torch.zeros(1, 2, 1, 8)
    pool = torch.zeros(4, 2, 8, 8)
    table = torch.zeros(1, 2, dtype=torch.int32)
    vals = torch.ones(4, 2, 8, 8, dtype=torch.int8)
    sc = torch.full((4, 2, 8, 1), 0.25)
    out = TP.paged_attention(q, (vals, sc), (vals, sc), table, 0)
    np.testing.assert_allclose(out.numpy(), 0.25)  # one live key
    out = TP.paged_chunk_attention(q, (vals, sc), (vals, sc), [1], 0, 1)
    np.testing.assert_allclose(out.numpy(), 0.25)
    with pytest.raises(ValueError, match="KV-head"):
        TP.paged_attention(q, pool[:, :1], pool[:, :1], table, 0)
    with pytest.raises(ValueError, match="prefer"):
        TP.paged_attention(q, pool, pool, table, 0, prefer="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        TP.paged_attn(q, pool, pool, table, 0)
    with pytest.raises(ValueError, match="CUDA"):
        TP.paged_chunk_attn(q, pool, pool, [1], 0, 1)
    assert TP.paged_attn.launches == 0 and TP.paged_chunk_attn.launches == 0
