"""The rounding points of the 16-bit K1 / K7 (tensor cores), held against the
JAX package on the CPU.

On the card, K1 and K7 take bf16 q / k / v / do, multiply on the tensor
cores with f32 sums, and round an intermediate to bf16 only where it becomes
the operand of a second product: p before P V in the forward (whose online
softmax runs over 64-key tiles, skipping dead tiles), as two bf16 terms
hi + lo (hi = bf16(p), lo = bf16(p - hi)); p before dV += p^T dO and ds
before dQ += ds K and dK += ds^T Q in the backward, once. This file carries
a small torch emulation of exactly that arithmetic (test code, not part of
the package) and holds it against the JAX package's interpreted kernels,
``_flash_impl(with_lse=True)`` and ``_flash_bwd_impl``, on the same numpy
inputs from a seed, at the card's bf16 gates: out within 1e-2 + 1e-2 |ref|,
lse within 1e-3, and each gradient within 1e-2 of its largest reference
magnitude. The emulated backward runs on the emulated forward's bf16 out and
its lse, as K7 runs on K1's. With ``valid_from`` the padded query rows are
unspecified (not compared) and carry no cotangent."""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

JA = importlib.import_module("adapt_tpu.ops.attention")

BT = 64  # the kernels' query and key tile
NEG = -1e30

CASES = {
    # the K7_CASES of test_torch_kernels_gpu.py at small b / h and d 16-64,
    # and the LM prefill shape: (b, h, s_q, s_k, d, kwargs)
    "vit_noncausal_197": (1, 2, 197, 197, 64, dict(causal=False)),
    "causal_256": (1, 2, 256, 256, 32, dict(causal=True)),
    "causal_window_64": (1, 2, 300, 300, 16, dict(causal=True, window=64)),
    "valid_from": (3, 2, 130, 130, 16, dict(causal=True, vf=[0, 7, 100])),
    "sq70_sk197": (2, 2, 70, 197, 32, dict(causal=False)),
    "lm_causal_512": (1, 1, 512, 512, 64, dict(causal=True)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _live(rows, cols, s_q, s_k, causal, vfrom, window):
    """The masks of K1 / K7 by index on a (rows, cols) tile."""
    r, c = rows[:, None], cols[None, :]
    ok = (r < s_q) & (c < s_k) & (c >= vfrom)
    if causal:
        ok &= r >= c
        if window:
            ok &= c > r - window
    return ok


def emulate_fwd(q, k, v, causal, vf=None, window=None):
    """K1's 16-bit arithmetic: per 64-row query tile, an online softmax
    over the live 64-key tiles (the kernel's dead-tile skip), f32 scores
    and sums, p split into two bf16 terms only as the operand of P V.
    Returns the bf16-rounded out and the f32 lse."""
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    out = torch.zeros(b, h, s_q, d)
    lse = torch.zeros(b, h, s_q)
    for bi in range(b):
        vfrom = 0 if vf is None else vf[bi]
        for q0 in range(0, s_q, BT):
            rows = torch.arange(q0, q0 + BT)
            qt = torch.zeros(h, BT, d)
            n = min(BT, s_q - q0)
            qt[:, :n] = q[bi, :, q0:q0 + n]
            m = torch.full((h, BT), NEG)
            lsum = torch.zeros(h, BT)
            acc = torch.zeros(h, BT, d)
            for k0 in range(0, s_k, BT):
                live = True
                if causal:
                    live = k0 <= q0 + BT - 1
                    if window:
                        live = live and k0 + BT - 1 > q0 - window
                if vf is not None:
                    live = live and k0 + BT > vfrom
                if not live:
                    continue
                cols = torch.arange(k0, k0 + BT)
                kt = torch.zeros(h, BT, d)
                vt = torch.zeros(h, BT, d)
                nk = min(BT, s_k - k0)
                kt[:, :nk] = k[bi, :, k0:k0 + nk]
                vt[:, :nk] = v[bi, :, k0:k0 + nk]
                s = (qt @ kt.transpose(1, 2)) * scale
                ok = _live(rows, cols, 10**9, s_k, causal, vfrom, window)
                s = torch.where(ok, s, torch.tensor(NEG))
                mx = torch.maximum(m, s.amax(-1))
                alpha = torch.exp(m - mx)
                p = torch.exp(s - mx[..., None])
                lsum = lsum * alpha + p.sum(-1)
                hi = _bf16(p)
                acc = acc * alpha[..., None] + (hi + _bf16(p - hi)) @ vt
                m = mx
            lsum = lsum.clamp(min=1e-30)
            out[bi, :, q0:q0 + n] = (acc / lsum[..., None])[:, :n]
            lse[bi, :, q0:q0 + n] = (m + torch.log(lsum))[:, :n]
    return _bf16(out), lse


def emulate_bwd(q, k, v, out, lse, do, causal, vf=None, window=None):
    """K7's 16-bit arithmetic: f32 S and dP, p = exp(s - lse) (lse clamped
    at -1e20 under valid_from), ds = p (dp - delta) sm_scale, then p and ds
    rounded to bf16 as the operands of dV, dQ and dK, with f32 sums. A
    dead tile's p is exactly 0, so skipping it changes nothing."""
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    if vf is not None:
        lse = lse.clamp(min=-1e20)
    delta = (do * out).sum(-1)
    s = (q @ k.transpose(-1, -2)) * scale
    ok = torch.stack([
        _live(torch.arange(s_q), torch.arange(s_k), s_q, s_k, causal,
              0 if vf is None else vf[bi], window) for bi in range(b)])
    s = torch.where(ok[:, None], s, torch.tensor(NEG))
    p = torch.exp(s - lse[..., None])
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - delta[..., None]) * scale
    dq = _bf16(ds) @ k
    dk = _bf16(ds).transpose(-1, -2) @ q
    dv = _bf16(p).transpose(-1, -2) @ do
    return _bf16(dq), _bf16(dk), _bf16(dv)


def _inputs(seed, b, h, s_q, s_k, d, vf):
    """bf16-valued f32 inputs (numpy, from a seed); padded query rows carry
    no cotangent."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32))
                   for s in (s_q, s_k, s_k, s_q))
    if vf is not None:
        valid = torch.arange(s_q)[None, :] >= torch.tensor(vf)[:, None]
        do = do * valid[:, None, :, None]
    return tuple(_bf16(t) for t in (q, k, v, do))


def _valid_rows(vf, b, s_q):
    if vf is None:
        return torch.ones(b, s_q, dtype=torch.bool)
    return torch.arange(s_q)[None, :] >= torch.tensor(vf)[:, None]


@pytest.mark.parametrize("name", sorted(CASES))
def test_tensor_core_rounding_meets_the_bf16_gates(name):
    b, h, s_q, s_k, d, kw = CASES[name]
    causal, vf, window = kw["causal"], kw.get("vf"), kw.get("window")
    q, k, v, do = _inputs(sorted(CASES).index(name), b, h, s_q, s_k, d, vf)
    jvf = None if vf is None else jnp.asarray(vf, jnp.int32)
    jq, jk, jv, jdo = (jnp.asarray(t.numpy()) for t in (q, k, v, do))
    j_out, j_lse = JA._flash_impl(jq, jk, jv, causal, 64, 64, with_lse=True,
                                  valid_from=jvf, window=window)
    j_grads = JA._flash_bwd_impl(jq, jk, jv, j_out, j_lse, jdo,
                                 causal=causal, block_q=64, block_k=64,
                                 valid_from=jvf, window=window)
    out, lse = emulate_fwd(q, k, v, causal, vf, window)
    grads = emulate_bwd(q, k, v, out, lse, do, causal, vf, window)

    keep = _valid_rows(vf, b, s_q)  # (b, s_q): compare valid query rows
    ref = torch.from_numpy(np.array(j_out)).transpose(1, 2)[keep]
    got = out.transpose(1, 2)[keep]
    assert bool(((got - ref).abs() <= 1e-2 + 1e-2 * ref.abs()).all()), \
        float((got - ref).abs().max())
    ref_lse = torch.from_numpy(np.array(j_lse)).transpose(1, 2)[keep]
    torch.testing.assert_close(lse.transpose(1, 2)[keep], ref_lse,
                               atol=1e-3, rtol=1e-5)
    for which, g, jg in zip(("dq", "dk", "dv"), grads, j_grads):
        r = torch.from_numpy(np.array(jg))
        if which == "dq":
            g, r = g.transpose(1, 2)[keep], r.transpose(1, 2)[keep]
        err = float((g - r).abs().max())
        assert err <= 1e-2 * float(r.abs().max()), (which, err)

