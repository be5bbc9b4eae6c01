"""The partition of K5 / K5q / K5-split, held against the JAX package on the
CPU.

On the card K5's f32 instantiations (``csrc/paged_verify_attn.cu``) run
the unsplit K3 body (``csrc/decode_cluster.cuh``) under its verify row
policy: one (slot, kv head) row, cut into splits and into tiles of G folded
rows (G = 4 or 16 by the g * chunk rows; 16-row tiles past 16), is a
cluster of C = 8 blocks;
64-key tile t of the slot's live span (the union of its rows' masks:
[max(idx - window + 1, 0), idx + chunk - 1], cut to the split's key run)
belongs to rank t mod 8, the rest of the span is zero-filled; each key is
scored as a butterfly over its HD / 8 lanes of 8-column partial dots and
masked per row (row t attends p <= idx + min(t, chunk - 1 - tree_tail),
banded by the window, a tree leaf also p == idx + t); an f32 online softmax
runs over the rank's own tiles (the tile max exact, the tile sum a
butterfly over 32 lanes of two keys each), P V in KS key subsets summed in
subset order; ranks whose m for a row is still -1e30 are skipped, the rest
combined in rank order. The split variant writes the combined (acc, m, l)
of each split. A quantized pool scores (q . k_int) * k_scale * sm_scale,
sums l over the unscaled p and weights V by p * v_scale.

This file carries a torch emulation of that arithmetic (test code, not part
of the package; it is K5's f32 instantiation) and holds it against JAX's
interpreted ``_verify_impl`` at ``atol = rtol = 1e-5`` (f32 on both sides;
only the summation order differs) for native, int8 and packed int4 pools,
g in {1, 4}, tree_tail 0 and 2, with and without a window, each case with a
dead slot (zeros on both sides); and checks with ``torch.equal`` that the
split-1 partials combined by the port's ``_combine_splits`` equal the
unsplit emulation, the promise ``chip_smoke.py`` and
``test_torch_kernels_gpu.py`` hold the card's kernels to.

K5's 16-bit instantiations keep the partition and run each tile's products
on the tensor cores: one block per 16 folded rows, warp w scoring and
weighting keys [16 w, 16 w + 16) of a tile with f32 sums of 16-bit
products, the four warps sharing each row's max, each keeping its own l
and P V (p times the value scale as two bf16 terms hi + lo), summed in
warp order before the ranks combine. ``emulate_tc`` carries that
arithmetic and is held against the same interpreted kernel at the card's
bf16 gate, 1e-2 + 1e-2 |ref|."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapt_tpu_torch.ops.decode_attention import _combine_splits
from test_torch_decode_partition import (C, NEG, NT, TK, _butterfly, _cols,
                                         _j, _quant, pool_fetch)

JP = importlib.import_module("adapt_tpu.ops.paged_attention")

TOL = 1e-5
PAGE = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _padded_rows(gc):
    """K5's G (f32): the folded rows of one tile, padded."""
    return 4 if gc <= 4 else 16


def _row_live(idx, rows, pos, chunk, window, tree_tail):
    """(b, rows, TK): the verify mask of folded rows ``rows`` at absolute
    positions ``pos`` (b, TK)."""
    t = rows % chunk
    edge = idx[:, None, None] + torch.clamp(
        t, max=chunk - 1 - tree_tail)[None, :, None]
    p = pos[:, None, :]
    ok = p <= edge
    if window:
        ok = ok & (p > edge - window)
    if tree_tail:
        ok = ok | (p == idx[:, None, None] + t[None, :, None])
    return ok


def emulate(q, fetch, idx, chunk, L, window=None, tree_tail=0, split=1):
    """K5's arithmetic over every split. q (b, kvh, gc, hd) f32; ``fetch``
    as ``test_torch_decode_partition.pool_fetch``; idx (b,) int. Returns the
    per-split partials (acc (b, kvh, split, gc, hd), m, l (b, kvh, split,
    gc)) and, for split 1, the normalised output (b, kvh, gc, hd)."""
    b, kvh, gc, hd = q.shape
    lpk = hd // 8
    G = _padded_rows(gc)
    rw = min(G, 4)  # rows a thread carries
    ks_n = NT // (lpk * (G // rw))
    cols = _cols(hd)
    qx = q[..., cols]  # (b, kvh, gc, lpk, 8)
    sm = torch.tensor(1.0 / np.sqrt(hd), dtype=torch.float32)
    rows = torch.arange(gc)
    kps = -(-(L // PAGE) // split) * PAGE
    lo0 = torch.clamp(idx - window + 1, min=0) if window else torch.zeros_like(
        idx)
    hi0 = torch.clamp(idx + chunk - 1, max=L - 1)
    parts = []
    for sp in range(split):
        lo = torch.clamp(lo0, min=sp * kps)
        hi = torch.clamp(hi0, max=sp * kps + kps - 1)
        alive = lo <= hi
        tf, tl = lo.clamp(min=0) // TK, hi.clamp(min=0) // TK
        ranks = []
        for rank in range(C):
            t0 = tf + ((rank - tf % C) + C) % C
            n = torch.where(alive & (t0 <= tl), (tl - t0) // C + 1, 0)
            m = torch.full((b, kvh, gc), NEG)
            l = torch.zeros(b, kvh, gc)
            acc = torch.zeros(b, kvh, gc, ks_n, hd)
            for i in range(int(n.max())):
                has = (i < n)[:, None, None]
                k0 = (t0 + i * C) * TK
                pos = k0[:, None] + torch.arange(TK)[None, :]
                live = ((pos >= lo[:, None]) & (pos <= hi[:, None])
                        & has[:, :, 0])
                k, v, ksc, vsc = fetch(pos, live)
                kx = k[..., cols]  # (b, kvh, TK, lpk, 8)
                part = torch.zeros(b, kvh, gc, TK, lpk)
                for e in range(8):
                    part = part + (qx[:, :, :, None, :, e]
                                   * kx[:, :, None, :, :, e])
                dot = _butterfly(part, lpk)  # (b, kvh, gc, TK)
                if ksc is not None:
                    dot = dot * ksc[:, :, None, :]
                ok = live[:, None, :] & _row_live(idx, rows, pos, chunk,
                                                  window, tree_tail)
                s = torch.where(ok[:, None], dot * sm, NEG)
                m_new = torch.maximum(m, s.amax(-1))
                p = torch.exp(s - m_new[..., None])
                tsum = _butterfly(p[..., :32] + p[..., 32:], 32)
                alpha = torch.exp(m - m_new)
                pv = p if vsc is None else p * vsc[:, :, None, :]
                new_acc = acc * alpha[..., None, None]
                for j in range(TK // ks_n):
                    c = torch.arange(ks_n) + j * ks_n
                    new_acc = new_acc + (pv[..., c][..., None]
                                         * v[:, :, None, c, :])
                acc = torch.where(has[..., None, None], new_acc, acc)
                l = torch.where(has, l * alpha + tsum, l)
                m = torch.where(has, m_new, m)
            o = torch.zeros(b, kvh, gc, hd)
            for k_ in range(ks_n):
                o = o + acc[:, :, :, k_]
            ranks.append((o, m, l))
        mx = torch.full((b, kvh, gc), NEG)
        for _, m, _ in ranks:
            mx = torch.maximum(mx, m)
        a = torch.zeros(b, kvh, gc, hd)
        den = torch.zeros(b, kvh, gc)
        for o, m, l in ranks:
            on = m > NEG  # a rank with nothing live for the row is skipped
            w = torch.exp(m - mx)
            den = torch.where(on, den + l * w, den)
            a = torch.where(on[..., None], a + o * w[..., None], a)
        parts.append((a, mx, den))
    acc = torch.stack([p[0] for p in parts], 2)
    m = torch.stack([p[1] for p in parts], 2)
    l = torch.stack([p[2] for p in parts], 2)
    out = None
    if split == 1:
        out = acc[:, :, 0] / torch.clamp(l[:, :, 0], min=1e-30)[..., None]
    return (acc, m, l), out


def _case(seed, b, kvh, g, kc, hd, pps, kv):
    """Pools of ``b * pps + 2`` pages with a shuffled table; base positions
    spread over the window, the last slot dead (the batcher's idle
    sentinel)."""
    rng = np.random.RandomState(seed)
    npages = b * pps + 2
    kp = _quant(torch.from_numpy(
        rng.randn(npages, kvh, PAGE, hd).astype(np.float32)), kv)
    vp = _quant(torch.from_numpy(
        rng.randn(npages, kvh, PAGE, hd).astype(np.float32)), kv)
    q = torch.from_numpy(rng.randn(b, kvh, g * kc, hd).astype(np.float32))
    perm = rng.permutation(np.arange(1, npages))
    table = perm[:b * pps].reshape(b, pps).astype(np.int32)
    width = pps * PAGE
    # slot 2 ends its chain on a tile's last key: its later rows' keys sit
    # in the next tile, on a rank where row 0 has nothing live
    idx = np.array([width - kc, rng.randint(64, width - kc), 63,
                    -(kc + 2)], np.int32)[:b]
    return q, kp, vp, torch.from_numpy(table), torch.from_numpy(idx)


def _want(q, kp, vp, table, idx, kc, window, tree_tail):
    return np.asarray(JP.paged_verify_attention(
        jnp.asarray(q.numpy()), _j(kp), _j(vp), jnp.asarray(table.numpy()),
        jnp.asarray(idx.numpy()), kc, prefer="pallas", window=window,
        tree_tail=tree_tail, split=1))


@pytest.mark.parametrize("kv", ["native", "int8", "int4"])
@pytest.mark.parametrize("tree_tail", [0, 2])
@pytest.mark.parametrize("g", [1, 4])
def test_emulation_matches_interpreted_verify_kernel(kv, tree_tail, g):
    """Native / int8 / int4 pools at page 128, g 1 and 4 (5, 7, 20 and 28
    folded rows: one and two 16-row tiles), tree_tail 0 and 2, a dead
    slot."""
    kc = 5 + tree_tail
    q, kp, vp, table, idx = _case(40 + g + tree_tail, 4, 2, g, kc, 64, 3, kv)
    _, got = emulate(q, pool_fetch(kp, vp, table, 64), idx, kc, 3 * PAGE,
                     tree_tail=tree_tail)
    want = _want(q, kp, vp, table, idx, kc, None, tree_tail)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    assert not got[-1].any()


@pytest.mark.parametrize("kv", ["native", "int8", "int4"])
def test_emulation_matches_interpreted_verify_kernel_with_window(kv):
    """A window of 100 keys (the span starts inside a tile, row 0's band
    lowest), tree leaves, g 1."""
    q, kp, vp, table, idx = _case(47, 4, 2, 1, 7, 64, 3, kv)
    _, got = emulate(q, pool_fetch(kp, vp, table, 64), idx, 7, 3 * PAGE,
                     window=100, tree_tail=2)
    want = _want(q, kp, vp, table, idx, 7, 100, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    assert not got[-1].any()


@pytest.mark.parametrize("kv", ["native", "int8", "int4"])
@pytest.mark.parametrize("window,tree_tail", [(None, 0), (100, 2)])
def test_split_one_partials_combine_to_the_unsplit_bits(kv, window,
                                                        tree_tail):
    """K5-split with one split: its (acc, m, l) combined by the port's
    ``_combine_splits`` equal the unsplit output bit for bit (the combine of
    one split divides the same acc by the same l); four splits agree with
    it within the f32 tolerance."""
    kc = 5 + tree_tail
    q, kp, vp, table, idx = _case(53, 4, 2, 4, kc, 64, 3, kv)
    fetch = pool_fetch(kp, vp, table, 64)
    (acc, m, l), out = emulate(q, fetch, idx, kc, 3 * PAGE, window,
                               tree_tail)
    b, kvh, gc, hd = q.shape
    rows = b * kvh
    one = _combine_splits(acc.reshape(rows, 1, gc, hd),
                          m.reshape(rows, 1, gc), l.reshape(rows, 1, gc),
                          torch.float32).reshape(b, kvh, gc, hd)
    assert torch.equal(one, out)
    (acc4, m4, l4), _ = emulate(q, fetch, idx, kc, 3 * PAGE, window,
                                tree_tail, split=4)
    four = _combine_splits(acc4.reshape(rows, 4, gc, hd),
                           m4.reshape(rows, 4, gc), l4.reshape(rows, 4, gc),
                           torch.float32).reshape(b, kvh, gc, hd)
    torch.testing.assert_close(four, out, atol=TOL, rtol=TOL)
    assert not four[-1].any()


def _bf16(x):
    return x.to(torch.bfloat16).float()


def emulate_tc(q, fetch, idx, chunk, L, window=None, tree_tail=0):
    """K5's 16-bit arithmetic (split 1). q (b, kvh, gc, hd) bf16-valued
    f32; ``fetch`` as in :func:`emulate`. Returns the bf16-rounded output
    (b, kvh, gc, hd) as f32."""
    b, kvh, gc, hd = q.shape
    sm = torch.tensor(1.0 / np.sqrt(hd), dtype=torch.float32)
    rows = torch.arange(gc)
    lo = torch.clamp(idx - window + 1, min=0) if window else torch.zeros_like(
        idx)
    hi = torch.clamp(idx + chunk - 1, max=L - 1)
    alive = lo <= hi
    tf, tl = lo.clamp(min=0) // TK, hi.clamp(min=0) // TK
    ranks = []
    for rank in range(C):
        t0 = tf + ((rank - tf % C) + C) % C
        n = torch.where(alive & (t0 <= tl), (tl - t0) // C + 1, 0)
        m = torch.full((b, kvh, gc), NEG)
        lw = torch.zeros(4, b, kvh, gc)
        ow = torch.zeros(4, b, kvh, gc, hd)
        for i in range(int(n.max())):
            has = (i < n)[:, None, None]
            k0 = (t0 + i * C) * TK
            pos = k0[:, None] + torch.arange(TK)[None, :]
            live = (pos >= lo[:, None]) & (pos <= hi[:, None]) & has[:, :, 0]
            k, v, ksc, vsc = fetch(pos, live)
            s = q @ k.transpose(-1, -2)  # (b, kvh, gc, TK)
            if ksc is not None:
                s = s * ksc[:, :, None, :]
            ok = live[:, None, :] & _row_live(idx, rows, pos, chunk, window,
                                              tree_tail)
            s = torch.where(ok[:, None], s * sm, NEG)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            pv = p if vsc is None else p * vsc[:, :, None, :]
            for w in range(4):
                c = slice(16 * w, 16 * w + 16)
                hi_ = _bf16(pv[..., c])
                o_new = ow[w] * alpha[..., None] + (
                    hi_ @ v[:, :, c] + _bf16(pv[..., c] - hi_) @ v[:, :, c])
                ow[w] = torch.where(has[..., None], o_new, ow[w])
                lw[w] = torch.where(has, lw[w] * alpha + p[..., c].sum(-1),
                                    lw[w])
            m = torch.where(has, m_new, m)
        acc, den = ow[0], lw[0]
        for w in range(1, 4):
            acc, den = acc + ow[w], den + lw[w]
        ranks.append((acc, m, den))
    mx = torch.full((b, kvh, gc), NEG)
    for _, m, _ in ranks:
        mx = torch.maximum(mx, m)
    a = torch.zeros(b, kvh, gc, hd)
    den = torch.zeros(b, kvh, gc)
    for o, m, l in ranks:
        on = m > NEG
        w = torch.exp(m - mx)
        den = torch.where(on, den + l * w, den)
        a = torch.where(on[..., None], a + o * w[..., None], a)
    return _bf16(a / torch.clamp(den, min=1e-30)[..., None])


@pytest.mark.parametrize("kv", ["native", "int8", "int4"])
@pytest.mark.parametrize("window,tree_tail", [(None, 0), (100, 2)])
@pytest.mark.parametrize("g", [1, 4])
def test_tensor_core_emulation_matches_interpreted_verify_kernel(
        kv, window, tree_tail, g):
    """K5's 16-bit arithmetic on bf16-valued inputs against the same
    interpreted kernel at the bf16 gate; the dead slot is zeros."""
    kc = 5 + tree_tail
    q, kp, vp, table, idx = _case(61 + g, 4, 2, g, kc, 64, 3, kv)
    q = _bf16(q)
    if kv == "native":
        kp, vp = _bf16(kp), _bf16(vp)
    got = emulate_tc(q, pool_fetch(kp, vp, table, 64), idx, kc, 3 * PAGE,
                     window, tree_tail)
    want = _want(q, kp, vp, table, idx, kc, window, tree_tail)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-2, rtol=1e-2)
    assert not got[-1].any()
