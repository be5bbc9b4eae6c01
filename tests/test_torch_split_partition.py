"""The partition of K2-split / K3-split (and their int8 / int4 branches),
held against the JAX package on the CPU.

On the card the split decode kernels (``csrc/decode_cluster.cuh``) cut a
(b, kv head) row's 64-key tiles into ``split`` runs of tps = ceil(ceil(L /
64) / split) tiles (``ops/decode_attention._split_partials``' boundaries,
set by L and split only) and give each (row, split) a cluster of C = 8
blocks of its own. Inside a run the unsplit partition holds: 64-key tile t
on rank t mod 8, the run's live keys [max(valid_from, 0, sp tps 64),
min(index, L - 1, (sp + 1) tps 64 - 1)] staged (the rest zero-filled), the
ranks combined in rank order into the split's (acc, m, l). Every cluster
publishes its partials and arrives on the row's counter; the last to
arrive combines the splits in split order with the reference's rescale
(m* = max m_s, a_s = exp(m_s - m*), out = sum acc_s a_s / max(sum l_s a_s,
1e-30)). This file carries a torch emulation of that arithmetic (test
code, not part of the package; the clusters' own sums are
``test_torch_decode_partition.cluster_partials``) and holds it:

- against the JAX package's interpreted ``_decode_impl(..., split=S)`` /
  ``_paged_impl(..., split=S)`` at ``atol = rtol = 1e-5`` (f32 on both
  sides; only the summation order differs), for native, int8 and packed
  int4 caches, S in {1, 2, 3, 4, 16}, with and without ``valid_from``,
  each case with a dead row (zeros on both sides);
- to its own bits (``torch.equal``): split 1 equal to the unsplit
  emulation, a pool of 1024 keys a slot at pages 16 and 128 equal to the
  same K/V as a dense strip of 1024 at split 4, and each row alone equal to
  the same row in a batch of 8 at split 4.

The card's kernels are held to the same bit-equalities, and to a second
run equal to the first, in ``test_torch_kernels_gpu.py`` and
``chip_smoke.py``."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_decode_partition import (TK, _j, _pool_case, _rows,
                                         _strip_case, _strip_of,
                                         cluster_partials, emulate,
                                         pool_fetch, strip_fetch)

JD = importlib.import_module("adapt_tpu.ops.decode_attention")
JP = importlib.import_module("adapt_tpu.ops.paged_attention")

TOL = 1e-5
SPLITS = (1, 2, 3, 4, 16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def emulate_split(q, fetch, idx, vf, L, split):
    """The split kernels' arithmetic: one cluster per split over its run
    of tiles, then the cross-split combine in split order. Arguments as
    ``emulate``; returns (b, kvh, g, hd) f32."""
    n_tiles = -(-L // TK)
    kps = -(-n_tiles // split) * TK  # keys a split
    lo = torch.clamp(vf, min=0)
    hi = torch.minimum(idx, torch.full_like(idx, L - 1))
    parts = [cluster_partials(q, fetch, torch.clamp(lo, min=sp * kps),
                              torch.clamp(hi, max=sp * kps + kps - 1))
             for sp in range(split)]
    mx = parts[0][1]
    for _, m, _ in parts[1:]:
        mx = torch.maximum(mx, m)
    a = torch.zeros_like(parts[0][0])
    den = torch.zeros_like(mx)
    for acc, m, l in parts:
        w = torch.exp(m - mx)
        a = a + acc * w[..., None]
        den = den + l * w
    return a / torch.clamp(den, min=1e-30)[..., None]


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("kv", ["native", "int8", "int4"])
def test_split_emulation_matches_interpreted_decode_kernel(kv, split):
    """Dense strips: JAX's ``_decode_impl`` at L = 512 (native, block 256)
    or 1024 (the quantized block), ``valid_from`` at odd splits."""
    L = 512 if kv == "native" else 1024
    q, ck, cv, idx, vf = _strip_case(40 + split, 3, 2, 4, L, 16, kv)
    vf = vf if split % 2 else None
    want = JD.decode_attention(
        jnp.asarray(q.numpy()), _j(ck), _j(cv), jnp.asarray(idx.numpy()),
        None if vf is None else jnp.asarray(vf.numpy()), prefer="pallas",
        block_k=256 if kv == "native" else 1024, split=split)
    got = emulate_split(q, strip_fetch(ck, cv, 16), idx,
                        torch.zeros_like(idx) if vf is None else vf, L, split)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    assert not got[-1].any()


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("kv", ["native", "int8", "int4"])
def test_split_emulation_matches_interpreted_paged_kernel(kv, split):
    """Paged pools at page 128 (JAX's ``_paged_impl``), shuffled tables
    with a shared page, ``valid_from`` at even splits."""
    q, kp, vp, table, idx, vf = _pool_case(50 + split, 3, 2, 1, 16, 128, 3,
                                           kv)
    vf = None if split % 2 else vf
    want = JP.paged_attention(
        jnp.asarray(q.numpy()), _j(kp), _j(vp), jnp.asarray(table.numpy()),
        jnp.asarray(idx.numpy()),
        None if vf is None else jnp.asarray(vf.numpy()), prefer="pallas",
        split=split)
    got = emulate_split(q, pool_fetch(kp, vp, table, 16), idx,
                        torch.zeros_like(idx) if vf is None else vf,
                        table.shape[1] * 128, split)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    assert not got[-1].any()


@pytest.mark.parametrize("kv", ["native", "int8", "int4"])
def test_split_one_equals_unsplit_bitwise(kv):
    """With one split the span, the tile -> rank map and the rank combine
    are the unsplit kernel's and a_0 = exp(0) = 1: the same bits."""
    q, ck, cv, idx, vf = _strip_case(60, 8, 2, 4, 1025, 64, kv)
    fetch = strip_fetch(ck, cv, 64)
    assert torch.equal(emulate_split(q, fetch, idx, vf, 1025, 1),
                       emulate(q, fetch, idx, vf, 1025))


@pytest.mark.parametrize("kv", ["native", "int8", "int4"])
@pytest.mark.parametrize("page", [16, 128])
def test_split_pool_equals_strip_bitwise(kv, page):
    """At split 4 a pool of 1024 keys a slot (pages 16 or 128, shuffled,
    shared) equals the same K/V as a dense strip of 1024 keys: the split
    boundaries depend on L and split only."""
    q, kp, vp, table, idx, vf = _pool_case(61, 4, 2, 1, 64, page,
                                           1024 // page, kv)
    got = emulate_split(q, pool_fetch(kp, vp, table, 64), idx, vf, 1024, 4)
    dense = emulate_split(q, strip_fetch(_strip_of(kp, table, 1024),
                                         _strip_of(vp, table, 1024), 64),
                          idx, vf, 1024, 4)
    assert torch.equal(got, dense)
    assert not got[-1].any()


@pytest.mark.parametrize("kv", ["native", "int8", "int4"])
def test_split_row_alone_equals_batch_bitwise(kv):
    """At split 4 each row alone gives the bits it gives in a batch of 8
    (live rows, a dead row, ``valid_from`` inside a split)."""
    q, ck, cv, _, _ = _strip_case(62, 8, 2, 4, 1025, 64, kv)
    idx = torch.tensor([1024, 0, 517, 64, 63, 900, 300, -1],
                       dtype=torch.int32)
    vf = torch.tensor([0, 0, 100, 64, 0, 899, 290, 0], dtype=torch.int32)
    ref = emulate_split(q, strip_fetch(ck, cv, 64), idx, vf, 1025, 4)
    for r in range(8):
        sl = slice(r, r + 1)
        alone = emulate_split(q[sl], strip_fetch(_rows(ck, sl),
                                                 _rows(cv, sl), 64),
                              idx[sl], vf[sl], 1025, 4)
        assert torch.equal(alone, ref[sl]), r
    assert not ref[-1].any()
