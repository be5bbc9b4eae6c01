"""The partition of the unsplit K2 / K3 (and K2q / K3q), held against the JAX
package on the CPU.

On the card the unsplit decode kernels (``csrc/decode_cluster.cuh``) spread
one (b, kv head) row over a cluster of C = 8 blocks: 64-key tile t belongs
to rank t mod 8; a rank stages only the row's live keys [max(valid_from,
0), min(index, L - 1)] (the rest zero-filled), scores each key as a
butterfly over its HD / 8 lanes of 8-column partial dots, runs an f32 online
softmax over its own tiles (the tile max exact, the tile sum a butterfly
over 32 lanes of two keys each), accumulates P V in KS key subsets (key c in
subset c mod KS) summed in subset order after its last tile, and the live
ranks combine in rank order. A quantized cache scores (q . k_int) * k_scale
* sm_scale, sums l over the unscaled p and weights V by p * v_scale. This
file carries a small torch emulation of exactly that arithmetic (test code,
not part of the package), vectorised over rows with elementwise operations
only, and holds it:

- against the JAX package's interpreted ``_decode_impl`` / ``_paged_impl``
  at ``atol = rtol = 1e-5`` (f32 on both sides; only the summation order
  differs), for native, int8 and packed int4 caches, g in {1, 4}, with and
  without ``valid_from``, with a dead row (zeros on both sides);
- to its own bits (``torch.equal``) under what the partition promises:
  the same rows on strips of 1024, 1025, 1029 and 1031 keys, a pool at
  pages 16 and 128 against its strip, and a row alone against the same row
  in a batch of 8.

The card's kernels are held to the same bit-equalities in
``test_torch_kernels_gpu.py`` and ``chip_smoke.py``."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapt_tpu_torch.ops import quantize as TQ

JD = importlib.import_module("adapt_tpu.ops.decode_attention")
JP = importlib.import_module("adapt_tpu.ops.paged_attention")

TK = 64  # keys per tile
C = 8  # blocks (ranks) per row
NT = 128  # threads per block
NEG = -1e30
TOL = 1e-5
STRIP_LENGTHS = (1024, 1025, 1029, 1031)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _padded_g(g):
    return 1 if g == 1 else 4 if g <= 4 else 16


def _butterfly(x, width):
    """Every lane's sum after xor-shuffle rounds width/2 .. 1 over the last
    axis (``width`` lanes), as ``__shfl_xor_sync`` leaves it; lane 0's."""
    lanes = torch.arange(width)
    o = width // 2
    while o:
        x = x + x[..., lanes ^ o]
        o //= 2
    return x[..., 0]


def _cols(hd):
    """col8(li, e): the 8 columns lane li of a key's hd / 8 lanes holds."""
    return torch.arange(hd).reshape(hd // 8, 8)


def emulate(q, fetch, idx, vf, L):
    """The unsplit kernels' arithmetic. q (b, kvh, g, hd) f32; ``fetch(pos,
    live)`` -> (k, v (b, kvh, TK, hd) f32 values in element order, ks, vs
    (b, kvh, TK) f32 scales or None) for absolute positions ``pos`` (b, TK),
    zero where ``live`` is false; idx / vf (b,) int. Returns (b, kvh, g, hd)
    f32."""
    lo = torch.clamp(vf, min=0)
    hi = torch.minimum(idx, torch.full_like(idx, L - 1))
    a, _, den = cluster_partials(q, fetch, lo, hi)
    return a / torch.clamp(den, min=1e-30)[..., None]


def cluster_partials(q, fetch, lo, hi):
    """One cluster's (acc, m, l) over the live keys [lo, hi] (b,) of each
    row (none where lo > hi): the ranks' walks and their combine in rank
    order, as rank 0 holds them before it normalises. Returns (b, kvh, g,
    hd), (b, kvh, g), (b, kvh, g) f32."""
    b, kvh, g, hd = q.shape
    lpk = hd // 8
    G = _padded_g(g)
    rw = min(G, 4)
    ks_n = NT // (lpk * (G // rw))
    cols = _cols(hd)
    qx = q[..., cols]  # (b, kvh, g, lpk, 8)
    sm = torch.tensor(1.0 / np.sqrt(hd), dtype=torch.float32)
    alive = lo <= hi
    tf, tl = lo // TK, hi // TK
    ranks = []
    for rank in range(C):
        t0 = tf + ((rank - tf % C) + C) % C
        n = torch.where(alive & (t0 <= tl), (tl - t0) // C + 1, 0)
        m = torch.full((b, kvh, g), NEG)
        l = torch.zeros(b, kvh, g)
        acc = torch.zeros(b, kvh, g, ks_n, hd)
        for i in range(int(n.max())):
            has = (i < n)[:, None, None]
            k0 = (t0 + i * C) * TK
            pos = k0[:, None] + torch.arange(TK)[None, :]
            live = (pos >= lo[:, None]) & (pos <= hi[:, None]) & has[:, :, 0]
            k, v, ksc, vsc = fetch(pos, live)
            kx = k[..., cols]  # (b, kvh, TK, lpk, 8)
            part = torch.zeros(b, kvh, g, TK, lpk)
            for e in range(8):
                part = part + qx[:, :, :, None, :, e] * kx[:, :, None, :, :, e]
            dot = _butterfly(part, lpk)  # (b, kvh, g, TK)
            if ksc is not None:
                dot = dot * ksc[:, :, None, :]
            s = torch.where(live[:, None, None, :], dot * sm, NEG)
            tmax = s.amax(-1)
            m_new = torch.maximum(m, tmax)
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
        o = torch.zeros(b, kvh, g, hd)
        for k_ in range(ks_n):
            o = o + acc[:, :, :, k_]
        ranks.append(((n > 0)[:, None, None], o, m, l))
    mx = torch.full((b, kvh, g), NEG)
    for on, _, m, _ in ranks:
        mx = torch.where(on, torch.maximum(mx, m), mx)
    a = torch.zeros(b, kvh, g, hd)
    den = torch.zeros(b, kvh, g)
    for on, o, m, l in ranks:
        w = torch.exp(m - mx)
        den = torch.where(on, den + l * w, den)
        a = torch.where(on[..., None], a + o * w[..., None], a)
    return a, mx, den


def strip_fetch(k, v, hd):
    """``fetch`` over dense strips (b, kvh, L, w), native f32 or quantized
    ``(values, scales)`` pairs."""

    def gather(c, pos, live):
        if isinstance(c, tuple):
            vals, sc = c
            x = gather(TQ.kv_values(vals, hd).float(), pos, live)
            s = gather(sc, pos, live)[..., 0]
            return x, s
        L = c.shape[2]
        ix = pos.clamp(0, L - 1)[:, None, :, None].expand(
            -1, c.shape[1], -1, c.shape[3])
        x = torch.gather(c, 2, ix)
        return torch.where(live[:, None, :, None], x, 0.0)

    def fetch(pos, live):
        kx, vx = gather(k, pos, live), gather(v, pos, live)
        if isinstance(k, tuple):
            return kx[0], vx[0], kx[1], vx[1]
        return kx, vx, None, None

    return fetch


def pool_fetch(kp, vp, table, hd):
    """``fetch`` over paged pools (npages, kvh, page, w) and a (b, pps)
    table."""

    def gather(c, pos, live):
        if isinstance(c, tuple):
            vals, sc = c
            x = gather(TQ.kv_values(vals, hd).float(), pos, live)
            return x, gather(sc, pos, live)[..., 0]
        page = c.shape[2]
        width = table.shape[1] * page
        p = pos.clamp(0, width - 1)
        phys = torch.gather(table.long(), 1, p // page)  # (b, TK)
        x = c[phys, :, p % page]  # (b, TK, kvh, w)
        x = x.permute(0, 2, 1, 3)
        return torch.where(live[:, None, :, None], x, 0.0)

    def fetch(pos, live):
        kx, vx = gather(kp, pos, live), gather(vp, pos, live)
        if isinstance(kp, tuple):
            return kx[0], vx[0], kx[1], vx[1]
        return kx, vx, None, None

    return fetch


def _quant(x, kv):
    if kv == "native":
        return x
    v, s = TQ.quantize_kv_vectors(x, kv)
    return v, s


def _j(c):
    if isinstance(c, tuple):
        return tuple(jnp.asarray(m.numpy()) for m in c)
    return jnp.asarray(c.numpy())


def _strip_case(seed, b, kvh, g, L, hd, kv):
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(b, kvh, g, hd).astype(np.float32))
    ck = _quant(torch.from_numpy(rng.randn(b, kvh, L, hd).astype(np.float32)),
                kv)
    cv = _quant(torch.from_numpy(rng.randn(b, kvh, L, hd).astype(np.float32)),
                kv)
    idx = torch.from_numpy(rng.randint(0, L, size=b).astype(np.int32))
    idx[0] = L - 1
    idx[-1] = -3  # a dead row
    vf = (idx.clamp(min=0) // 3).to(torch.int32)
    return q, ck, cv, idx, vf


@pytest.mark.parametrize("kv", ["native", "int8", "int4"])
@pytest.mark.parametrize("g", [1, 4])
def test_emulation_matches_interpreted_decode_kernel(kv, g):
    """Dense strips: JAX's ``_decode_impl`` at L = 512 (native, block 256)
    or 1024 (the quantized block), with ``valid_from`` at g = 4."""
    L = 512 if kv == "native" else 1024
    q, ck, cv, idx, vf = _strip_case(3 + g, 3, 2, g, L, 16, kv)
    vf = vf if g == 4 else None
    want = JD.decode_attention(
        jnp.asarray(q.numpy()), _j(ck), _j(cv), jnp.asarray(idx.numpy()),
        None if vf is None else jnp.asarray(vf.numpy()), prefer="pallas",
        block_k=256 if kv == "native" else 1024, split=1)
    got = emulate(q, strip_fetch(ck, cv, 16), idx,
                  torch.zeros_like(idx) if vf is None else vf, L)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    assert not got[-1].any()


def _pool_case(seed, b, kvh, g, hd, page, pps, kv):
    rng = np.random.RandomState(seed)
    npages = b * pps + 2
    kp = _quant(torch.from_numpy(
        rng.randn(npages, kvh, page, hd).astype(np.float32)), kv)
    vp = _quant(torch.from_numpy(
        rng.randn(npages, kvh, page, hd).astype(np.float32)), kv)
    q = torch.from_numpy(rng.randn(b, kvh, g, hd).astype(np.float32))
    perm = rng.permutation(np.arange(1, npages))
    table = perm[:b * pps].reshape(b, pps).astype(np.int32)
    table[1, 0] = table[0, 0]  # a page shared between two rows
    width = pps * page
    idx = rng.randint(0, width, size=b).astype(np.int32)
    idx[0] = width - 1
    idx[-1] = -4  # a dead row
    vf = np.minimum(np.maximum(idx, 0) // 3, 40).astype(np.int32)
    return (q, kp, vp, torch.from_numpy(table), torch.from_numpy(idx),
            torch.from_numpy(vf))


@pytest.mark.parametrize("kv", ["native", "int8", "int4"])
@pytest.mark.parametrize("g", [1, 4])
def test_emulation_matches_interpreted_paged_kernel(kv, g):
    """Paged pools at page 128 (JAX's ``_paged_impl``), shuffled tables,
    ``valid_from`` at g = 1."""
    q, kp, vp, table, idx, vf = _pool_case(20 + g, 3, 2, g, 16, 128, 3, kv)
    vf = vf if g == 1 else None
    want = JP.paged_attention(
        jnp.asarray(q.numpy()), _j(kp), _j(vp), jnp.asarray(table.numpy()),
        jnp.asarray(idx.numpy()),
        None if vf is None else jnp.asarray(vf.numpy()), prefer="pallas",
        split=1)
    got = emulate(q, pool_fetch(kp, vp, table, 16), idx,
                  torch.zeros_like(idx) if vf is None else vf,
                  table.shape[1] * 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    assert not got[-1].any()


def _first(c, n):
    if isinstance(c, tuple):
        return tuple(_first(m, n) for m in c)
    return c[:, :, :n].contiguous()


def _rows(c, sl):
    return tuple(m[sl] for m in c) if isinstance(c, tuple) else c[sl]


@pytest.mark.parametrize("kv", ["native", "int8", "int4"])
def test_strip_length_and_row_alone_do_not_change_bits(kv):
    """The same rows on strips of 1024, 1025, 1029 and 1031 keys, and each
    row alone against the batch of 8, give the same bits."""
    q, ck, cv, idx, vf = _strip_case(9, 8, 2, 4, max(STRIP_LENGTHS), 64, kv)
    idx = torch.tensor([1023, 0, 517, 64, 63, 900, 300, -1],
                       dtype=torch.int32)
    vf = torch.tensor([0, 0, 100, 64, 0, 899, 0, 0], dtype=torch.int32)
    ref = emulate(q, strip_fetch(_first(ck, 1025), _first(cv, 1025), 64),
                  idx, vf, 1025)
    for n in STRIP_LENGTHS:
        got = emulate(q, strip_fetch(_first(ck, n), _first(cv, n), 64), idx,
                      vf, n)
        assert torch.equal(got, ref), n
    for r in range(8):
        sl = slice(r, r + 1)
        alone = emulate(q[sl], strip_fetch(_rows(_first(ck, 1025), sl),
                                           _rows(_first(cv, 1025), sl), 64),
                        idx[sl], vf[sl], 1025)
        assert torch.equal(alone, ref[sl]), r
    assert not ref[-1].any()


def _strip_of(pool, table, length):
    """The pool's windows as dense (b, kvh, length, w) strips."""
    if isinstance(pool, tuple):
        return tuple(_strip_of(m, table, length) for m in pool)
    b = table.shape[0]
    win = pool[table.long()].movedim(2, 1).reshape(b, pool.shape[1], -1,
                                                   pool.shape[3])
    out = torch.zeros(b, pool.shape[1], length, pool.shape[3],
                      dtype=pool.dtype)
    out[:, :, :win.shape[2]] = win
    return out


@pytest.mark.parametrize("kv", ["native", "int8", "int4"])
@pytest.mark.parametrize("page", [16, 128])
def test_pool_equals_strip_bitwise(kv, page):
    """A pool of 1024 keys a slot (pages 16 or 128, shuffled, shared)
    against the same K/V as strips of 1024, 1025 and 1031 keys."""
    q, kp, vp, table, idx, vf = _pool_case(31, 4, 2, 1, 64, page,
                                           1024 // page, kv)
    got = emulate(q, pool_fetch(kp, vp, table, 64), idx, vf, 1024)
    for n in (1024, 1025, 1031):
        dense = emulate(q, strip_fetch(_strip_of(kp, table, n),
                                       _strip_of(vp, table, n), 64), idx, vf,
                        n)
        assert torch.equal(got, dense), n
    assert not got[-1].any()
