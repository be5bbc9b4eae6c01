"""The rounding points and tile walk of the 16-bit K4 / K4q (tensor cores),
held against the JAX package on the CPU.

On the card K4 (``csrc/paged_chunk_attn.cu``) takes a bf16 chunk of folded
query rows (row r = member * chunk + position, at pos0 + r % chunk) and a
paged pool: one block per 64 folded rows walks, in order, the 64-key tiles
holding a key some row of the block attends (other keys zero-filled), K1's
walk; scores are f32 sums of 16-bit products (int8 / int4 values are exact
in bf16), times the key scale, times sm_scale; an f32 online softmax, l
sums the f32 p, and p (times the value scale) enters P V as two bf16 terms
hi = bf16(p), lo = bf16(p - hi); the output is rounded to bf16 once. This
file carries a torch emulation of exactly that arithmetic (test code, not
part of the package) and holds it against JAX's interpreted ``_chunk_impl``
on the same numpy inputs (bf16-valued f32) at the card's bf16 gate, 1e-2 +
1e-2 |ref|: native, int8 and packed int4 pools, g 1 and 4, pos0 0 and 512,
and a window."""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapt_tpu_torch.ops import quantize as TQ

JP = importlib.import_module("adapt_tpu.ops.paged_attention")

BQ = 64  # folded query rows per block
BK = 64  # keys per tile
NEG = -1e30
PAGE = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _window_of(pool, pages, hd):
    """(kvh, n * page, hd) f32 values in element order and (kvh, n * page)
    f32 scales (None for a native pool) of the listed pages."""
    if isinstance(pool, tuple):
        vals, sc = pool
        x, _ = _window_of(TQ.kv_values(vals, hd).float(), pages, hd)
        s, _ = _window_of(sc, pages, 1)
        return x, s[..., 0]
    w = pool[pages.long()].movedim(1, 0)  # (kvh, n, page, w)
    return w.reshape(w.shape[0], -1, w.shape[-1]), None


def emulate(q, k_pool, v_pool, pages, pos0, chunk, window=None):
    """K4's 16-bit arithmetic. q (1, kvh, gc, hd) bf16-valued f32. Returns
    the bf16-rounded output as f32."""
    _, kvh, gc, hd = q.shape
    k, ksc = _window_of(k_pool, pages, hd)
    v, vsc = _window_of(v_pool, pages, hd)
    n_keys = k.shape[1]
    sm = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    out = torch.zeros(kvh, gc, hd)
    for r0 in range(0, gc, BQ):
        nrows = min(BQ, gc - r0)
        rows = torch.arange(r0, r0 + BQ)
        plo, phi = 0, chunk - 1
        if nrows < chunk:
            x, z = r0 % chunk, (r0 + nrows - 1) % chunk
            if x <= z:
                plo, phi = x, z
        plo, phi = plo + pos0, phi + pos0
        khi = min(phi, n_keys - 1)
        klo = max(plo - window + 1, 0) if window else 0
        pos = pos0 + rows % chunk
        qt = torch.zeros(kvh, BQ, hd)
        qt[:, :nrows] = q[0, :, r0:r0 + nrows]
        m = torch.full((kvh, BQ), NEG)
        lsum = torch.zeros(kvh, BQ)
        acc = torch.zeros(kvh, BQ, hd)
        for j in range(klo // BK, khi // BK + 1) if klo <= khi else ():
            cols = torch.arange(j * BK, (j + 1) * BK)
            staged = (cols >= klo) & (cols <= khi)
            cc = cols.clamp(max=n_keys - 1)
            kt = torch.where(staged[None, :, None], k[:, cc], 0.0)
            vt = torch.where(staged[None, :, None], v[:, cc], 0.0)
            s = qt @ kt.transpose(1, 2)
            if ksc is not None:
                s = s * torch.where(staged, ksc[:, cc], 0.0)[:, None, :]
            s = s * sm
            ok = (cols[None, :] <= pos[:, None]) & (cols[None, :] < n_keys)
            if window:
                ok = ok & (cols[None, :] > pos[:, None] - window)
            s = torch.where(ok[None], s, torch.tensor(NEG))
            mx = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - mx)
            p = torch.exp(s - mx[..., None])
            lsum = lsum * alpha + p.sum(-1)
            if vsc is not None:
                p = p * torch.where(staged, vsc[:, cc], 0.0)[:, None, :]
            hi = _bf16(p)
            acc = acc * alpha[..., None] + (hi @ vt + _bf16(p - hi) @ vt)
            m = mx
        o = acc / torch.clamp(lsum, min=1e-30)[..., None]
        out[:, r0:r0 + nrows] = o[:, :nrows]
    return _bf16(out)[None]


def _case(seed, kvh, g, hd, chunk, pos0, kv):
    """bf16-valued q and pools (numpy, from a seed); the window's pages
    shuffled and padded to a power of two with trash page 0."""
    rng = np.random.RandomState(seed)
    n_strip = -(-(pos0 + chunk) // PAGE)
    n_pad = 1 << (n_strip - 1).bit_length()
    npages = n_strip + 3

    def rnd(*shape):
        return _bf16(torch.from_numpy(rng.randn(*shape).astype(np.float32)))

    q = rnd(1, kvh, g * chunk, hd)
    kp, vp = rnd(npages, kvh, PAGE, hd), rnd(npages, kvh, PAGE, hd)
    if kv != "native":
        kp, vp = (TQ.quantize_kv_vectors(kp, kv),
                  TQ.quantize_kv_vectors(vp, kv))
    live = rng.permutation(np.arange(1, npages))[:n_strip]
    pages = np.concatenate([live, np.zeros(n_pad - n_strip, np.int64)])
    return q, kp, vp, torch.from_numpy(pages.astype(np.int32))


def _j(c):
    if isinstance(c, tuple):
        return tuple(jnp.asarray(m.numpy()) for m in c)
    return jnp.asarray(c.numpy())


def _check(q, kp, vp, pages, pos0, chunk, window):
    want = np.asarray(JP.paged_chunk_attention(
        jnp.asarray(q.numpy()), _j(kp), _j(vp), jnp.asarray(pages.numpy()),
        pos0, chunk, prefer="pallas", window=window))
    got = emulate(q, kp, vp, pages, pos0, chunk, window)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-2, rtol=1e-2)
    return got


@pytest.mark.parametrize("kv", ["native", "int8", "int4"])
@pytest.mark.parametrize("pos0", [0, 512])
@pytest.mark.parametrize("g", [1, 4])
def test_emulation_matches_interpreted_chunk_kernel(kv, pos0, g):
    """Chunks of 128 positions (g 4: 512 folded rows, each row tile one
    member's positions) at pos0 0 and 512, page 128."""
    q, kp, vp, pages = _case(60 + g + pos0 // 256, 2, g, 64, 128, pos0, kv)
    _check(q, kp, vp, pages, pos0, 128, None)


@pytest.mark.parametrize("kv", ["native", "int8", "int4"])
def test_emulation_matches_interpreted_chunk_kernel_with_window(kv):
    """A window of 150 keys, a chunk of 96 rows at an unaligned pos0 with
    g 2 (row tiles that wrap from one member's positions to the next's)."""
    q, kp, vp, pages = _case(71, 2, 2, 64, 96, 300, kv)
    _check(q, kp, vp, pages, 300, 96, 150)
