"""The CUDA kernels (K1, K2, K2-split, K3, K3-split, K4, K5, K5-split, the
int8 / int4 branches K2q, K3q, K4q, K5q, K6's blockwise quantize /
dequantize, and K7, the flash backward) against their plain PyTorch
versions, on a card. Every test is marked ``gpu`` and skips without a
CUDA device (the kernels are CUDA C++ with no CPU mode). This file imports
no JAX, so it also runs on a machine that has none:

    python -m pytest tests/test_torch_kernels_gpu.py -q --noconftest

Tolerances: f32 inputs at ``atol = rtol = 2e-5`` (only the summation
order differs); bf16 / f16 at ``1e-2`` (one rounding of the output, and of
p before P V on the tensor cores); the
logsumexp at ``1e-3``. Rows with no live key (and the left padding of
``valid_from`` rows) are unspecified and not compared. K3 must equal K2
bit for bit on the same K/V laid out as dense strips of 1024, 1025, 1029
and 1031 keys, quantized or not; the unsplit K2 (a cluster of blocks per
row) must give a row the same bits alone as in a batch of 8, on every strip
length and on a second run, and add one launch per call.
Quantized caches come from ``ops.quantize.quantize_kv_vectors`` on the
card; the plain versions read the same bytes, so the tolerances stay the
native ones. K2-split / K3-split (each one CUDA kernel a call) at split 1
must equal K2 / K3 bit for bit, K3-split equal K2-split on the same key
range, and a split row give the same bits alone, in a batch of 8 and on a
second run. K5 with ``split == 1`` partials must equal the unsplit kernel
bit for bit, and K4 / K5 must give the same bits on a second run (K4 a
row's bits from its own q and the keys' positions only); K6 must be ``torch.equal`` to its plain version (values, scales
and the round trip; NaN counted equal to NaN) at every draft matrix shape
and on NaN / +-Inf blocks, raise on a base not 16-byte aligned, and
dequantize a weight tree in one launch per 32 leaves, each leaf equal to
``dequantize_blocks`` alone. K7's gradients are held at ``atol = rtol = 2e-4`` in
f32 (the JAX package's bar for its streaming backward) and within 1e-2 of
the largest reference magnitude in bf16 / f16, and two runs on the same
inputs must be ``torch.equal`` (two passes, no atomics). The 16-bit K1 and
K7 (tensor cores) must give the same bits on the models' strided q / k / v
views as on contiguous copies, and K1's rows must not depend on the batch,
on padding of s_q or on key tiles a mask removes. K2-K5 (native and int8)
are also held at the head counts of GPT-2-small's tp=2 and tp=4 shards
(kv_h 6 and 3, g 1). ``pipelined_generate`` at pp 2 on a mesh naming the
card twice streams what ``generate()`` streams for each microbatch alone,
with twice the whole batch's K1 / K2 launches."""

import pytest
import torch

from adapt_tpu_torch.ops import attention as TA
from adapt_tpu_torch.ops import decode_attention as TD
from adapt_tpu_torch.ops import paged_attention as TP
from adapt_tpu_torch.ops import quantize as TQ
from adapt_tpu_torch.ops.quantize import quantize_kv_vectors

K1_CASES = {
    # name: (b, h, s_q, s_k, kwargs)
    "causal": (2, 3, 200, 200, dict(causal=True)),
    "noncausal_ragged_sk": (2, 2, 70, 197, dict(causal=False)),
    "window": (1, 2, 300, 300, dict(causal=True, window=64)),
    "valid_from": (3, 2, 130, 130, dict(causal=True, vf=[0, 7, 100])),
    "shift": (1, 2, 96, 96, dict(causal=True, shift=1)),
    "shift0": (1, 2, 96, 96, dict(causal=True, shift=0)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no "
                    "CPU mode")
    return torch.device("cuda")


def _tol(dtype):
    return 2e-5 if dtype == torch.float32 else 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("name", sorted(K1_CASES))
def test_k1_matches_plain(cuda, name, dtype, d):
    b, h, s_q, s_k, kw = K1_CASES[name]
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(b, h, s_q, d, generator=g, device=cuda).to(dtype)
    k = torch.randn(b, h, s_k, d, generator=g, device=cuda).to(dtype)
    v = torch.randn(b, h, s_k, d, generator=g, device=cuda).to(dtype)
    vf = torch.tensor(kw["vf"], device=cuda) if "vf" in kw else None
    n0 = TA.flash_attn_fwd.launches
    out, lse = TA.flash_attn_fwd(q, k, v, kw["causal"], vf, kw.get("shift"),
                                 kw.get("window"))
    torch.cuda.synchronize()
    assert TA.flash_attn_fwd.launches == n0 + 1
    ref, ref_lse = TA._reference_with_lse(q, k, v, kw["causal"], vf,
                                          kw.get("shift"), kw.get("window"))
    ok = ref_lse > -1e29
    if vf is not None:
        ok &= (torch.arange(s_q, device=cuda)[None, :] >= vf[:, None])[:, None]
    tol = _tol(dtype)
    torch.testing.assert_close(out.float()[ok], ref.float()[ok],
                               atol=tol, rtol=tol)
    torch.testing.assert_close(lse[ok], ref_lse[ok], atol=1e-3, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1024, 2048])
@pytest.mark.parametrize("shift", [0, 1])
def test_k1_device_shift_matches_plain(cuda, shift, s):
    """The striped ring's K1 call: a device int32 ``causal_shift`` (built
    once, no host->device copy a launch), b1 h12 d64 bf16, out and lse
    against the plain version with the same shift; a row with no live key
    (shift 1's row 0) is unspecified."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(1, 12, s, 64, generator=g, device=cuda).to(
        torch.bfloat16) for _ in range(3))
    shift_t = torch.full((), shift, dtype=torch.int32, device=cuda)
    out, lse = TA.flash_attention_with_lse(q, k, v, causal=True,
                                           causal_shift=shift_t)
    torch.cuda.synchronize()
    ref, ref_lse = TA._reference_with_lse(q, k, v, True, None, shift_t)
    ok = ref_lse > -1e29
    torch.testing.assert_close(out.float()[ok], ref.float()[ok], atol=1e-2,
                               rtol=1e-2)
    torch.testing.assert_close(lse[ok], ref_lse[ok], atol=1e-3, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sp", [2, 4])
def test_ring_flash_striped_matches_jnp(cuda, sp, dtype):
    """``ring_attention(block_impl="flash")`` on the striped causal ring
    (K1 with shift 0 / 1 every step, sp * sp launches) against the plain
    online-softmax ring (``"jnp"``) on the same striped inputs."""
    import importlib

    from adapt_tpu_torch.core.mesh import MeshSpec, build_mesh

    R = importlib.import_module("adapt_tpu_torch.parallel.ring_attention")
    mesh = build_mesh(MeshSpec((("sp", sp),)), [cuda] * sp)
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (R.stripe_sequence(torch.randn(
        1, 4, 1024, 64, generator=g, device=cuda).to(dtype), sp)
        for _ in range(3))
    n0 = TA.flash_attn_fwd.launches
    got = R.ring_attention(q, k, v, mesh, causal=True, block_impl="flash",
                           layout="striped")
    torch.cuda.synchronize()
    assert TA.flash_attn_fwd.launches == n0 + sp * sp
    want = R.ring_attention(q, k, v, mesh, causal=True, block_impl="jnp",
                            layout="striped")
    tol = _tol(dtype)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


K7_CASES = {
    # name: (b, h, s_q, s_k, kwargs) -- the shapes of chip_smoke phase 11
    "vit_noncausal_197": (2, 3, 197, 197, dict(causal=False)),
    "causal_256": (1, 3, 256, 256, dict(causal=True)),
    "causal_window_64": (1, 2, 300, 300, dict(causal=True, window=64)),
    "valid_from": (3, 2, 130, 130, dict(causal=True, vf=[0, 7, 100])),
    "sq70_sk197": (2, 2, 70, 197, dict(causal=False)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("name", sorted(K7_CASES))
def test_k7_matches_plain_and_is_deterministic(cuda, name, dtype, d):
    b, h, s_q, s_k, kw = K7_CASES[name]
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(b, h, s_q, d, generator=g, device=cuda).to(dtype)
    k = torch.randn(b, h, s_k, d, generator=g, device=cuda).to(dtype)
    v = torch.randn(b, h, s_k, d, generator=g, device=cuda).to(dtype)
    do = torch.randn(b, h, s_q, d, generator=g, device=cuda).to(dtype)
    vf = torch.tensor(kw["vf"], device=cuda) if "vf" in kw else None
    args = (kw["causal"], vf, kw.get("window"))
    out, lse = TA.flash_attn_fwd(q, k, v, kw["causal"], vf, None,
                                 kw.get("window"))
    n0 = TA.flash_attn_bwd.launches
    got = TA.flash_attn_bwd(q, k, v, out, lse, do, *args)
    again = TA.flash_attn_bwd(q, k, v, out, lse, do, *args)
    torch.cuda.synchronize()
    assert TA.flash_attn_bwd.launches == n0 + 2
    ref = TA.flash_attention_bwd_plain(q, k, v, out, lse, do, *args)
    for a, a2, r in zip(got, again, ref):
        assert a.dtype == dtype and torch.equal(a, a2)
        if dtype == torch.float32:
            torch.testing.assert_close(a, r, atol=2e-4, rtol=2e-4)
        else:
            err = (a.float() - r.float()).abs().max()
            assert err <= 1e-2 * r.float().abs().max(), float(err)


def _qkv_views(cuda, dtype, b, h, s, d, seed):
    """q, k, v as the models pass them: transposed (b, h, s, d) views of
    one (b, s, 3, h, d) projection output."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    qkv = torch.randn(b, s, 3, h, d, generator=g, device=cuda).to(dtype)
    return tuple(t.transpose(1, 2) for t in qkv.unbind(2))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k1_k7_strided_views_equal_contiguous_copies(cuda, dtype, d):
    """The 16-bit kernels read q, k, v, out and do through their strides:
    the models' transposed views give the same bits as contiguous copies,
    with no copy, and the outputs come back contiguous."""
    b, h, s = 2, 3, 197
    q, k, v = _qkv_views(cuda, dtype, b, h, s, d, seed=41)
    assert not q.is_contiguous() and TA._operand(q) is q
    g = torch.Generator(device=cuda).manual_seed(42)
    do = torch.randn(b, s, h, d, generator=g, device=cuda).to(
        dtype).transpose(1, 2)
    for causal in (False, True):
        out, lse = TA.flash_attn_fwd(q, k, v, causal)
        ref_out, ref_lse = TA.flash_attn_fwd(q.contiguous(), k.contiguous(),
                                             v.contiguous(), causal)
        got = TA.flash_attn_bwd(q, k, v, out, lse, do, causal)
        want = TA.flash_attn_bwd(q.contiguous(), k.contiguous(),
                                 v.contiguous(), out, lse, do.contiguous(),
                                 causal)
        torch.cuda.synchronize()
        assert out.is_contiguous() and torch.equal(out, ref_out)
        assert torch.equal(lse, ref_lse)
        for a, w in zip(got, want):
            assert a.is_contiguous() and torch.equal(a, w)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k1_rows_are_invariant(cuda, dtype):
    """A row's out and lse depend only on its own q row and its unmasked
    keys (the batcher's token equality rests on it): the same bits at
    batch 1 and 4, with s_q padded to the next power of two, and with two
    extra key tiles that ``valid_from`` masks."""
    h, s, d = 12, 100, 64
    g = torch.Generator(device=cuda).manual_seed(43)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda).to(dtype)

    q, k, v = rnd(1, h, s, d), rnd(1, h, s, d), rnd(1, h, s, d)
    out, lse = TA.flash_attn_fwd(q, k, v, True)
    # batch 4, the row in slot 2
    q4, k4, v4 = rnd(4, h, s, d), rnd(4, h, s, d), rnd(4, h, s, d)
    q4[2], k4[2], v4[2] = q[0], k[0], v[0]
    o4, l4 = TA.flash_attn_fwd(q4, k4, v4, True)
    # s_q (and s_k) padded to 128 with other rows after the prompt
    pad = [torch.cat([t, rnd(1, h, 128 - s, d)], dim=2) for t in (q, k, v)]
    op, lp = TA.flash_attn_fwd(*pad, True)
    # two whole key tiles of left padding, masked by valid_from
    left = [torch.cat([rnd(1, h, 128, d), t], dim=2) for t in (q, k, v)]
    ol, ll = TA.flash_attn_fwd(*left, True, torch.tensor([128], device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(o4[2], out[0]) and torch.equal(l4[2], lse[0])
    assert torch.equal(op[:, :, :s], out) and torch.equal(lp[:, :, :s], lse)
    assert torch.equal(ol[:, :, 128:], out)
    assert torch.equal(ll[:, :, 128:], lse)


@pytest.mark.gpu
def test_k7_refuses_bad_operands(cuda):
    x = torch.zeros(1, 2, 8, 64, device=cuda)
    lse = torch.zeros(1, 2, 8, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        s = x[..., :32]
        TA.flash_attn_bwd(s, s, s, s, lse, s)
    with pytest.raises(ValueError, match="lse"):
        TA.flash_attn_bwd(x, x, x, x, lse[..., :4], x)
    with pytest.raises(ValueError, match="dtypes"):
        TA.flash_attn_bwd(x, x, x, x, lse, x.to(torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA"):
        TA.flash_attn_bwd(x.cpu(), x, x, x, lse, x)


@pytest.mark.gpu
@pytest.mark.parametrize("split", [1, 2, 3, 4, 16])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_k2_matches_plain(cuda, split, g, dtype):
    for hd in (64, 128):
        _k2_matches_plain(cuda, split, g, dtype, hd)


@pytest.mark.gpu
@pytest.mark.parametrize("g", [1, 3, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_k2_unsplit_matches_plain_every_g(cuda, g, dtype):
    """Every padded-row bucket of the unsplit kernel (g 1, <= 4, <= 16)."""
    _k2_matches_plain(cuda, 1, g, dtype)


def _k2_matches_plain(cuda, split, g, dtype, hd=64):
    gen = torch.Generator(device=cuda).manual_seed(1)
    b, kvh, L = 4, 3, 1025
    q = torch.randn(b, kvh, g, hd, generator=gen, device=cuda).to(dtype)
    ck = torch.randn(b, kvh, L, hd, generator=gen, device=cuda).to(dtype)
    cv = torch.randn(b, kvh, L, hd, generator=gen, device=cuda).to(dtype)
    idx = torch.tensor([1024, 0, 517, 64], device=cuda, dtype=torch.int32)
    vf = (idx // 3).to(torch.int32)
    for valid_from in (None, vf):
        got = TD.decode_attention(q, ck, cv, idx, valid_from, split=split)
        torch.cuda.synchronize()
        ref = TD.decode_attention_plain(q, ck, cv, idx, valid_from, split)
        torch.testing.assert_close(got.float(), ref.float(),
                                   atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.gpu
def test_k2_split_one_equals_split_four(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(8, 12, 1, 64, generator=gen, device=cuda)
    ck = torch.randn(8, 12, 1025, 64, generator=gen, device=cuda)
    cv = torch.randn(8, 12, 1025, 64, generator=gen, device=cuda)
    idx = torch.linspace(0, 1024, 8, device=cuda).to(torch.int32)
    a = TD.decode_attn(q, ck, cv, idx)
    b = TD.decode_attn_split(q, ck, cv, idx, None, 4)
    torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
def test_cuda_refuses_plain_and_grad(cuda):
    x = torch.zeros(1, 1, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="refuse"):
        TA.flash_attention(x, x, x, prefer="xla")
    with pytest.raises(ValueError, match="refuse"):
        TD.decode_attention(x[:, :, :1], x, x, 0, prefer="xla")
    xg = x.clone().requires_grad_()
    n_fwd, n_bwd = TA.flash_attn_fwd.launches, TA.flash_attn_bwd.launches
    TA.flash_attention(xg, x, x).sum().backward()  # grads run K1 then K7
    torch.cuda.synchronize()
    assert TA.flash_attn_fwd.launches == n_fwd + 1
    assert TA.flash_attn_bwd.launches == n_bwd + 1
    assert xg.grad.shape == x.shape
    with pytest.raises(NotImplementedError, match="forward-only"):
        TA.flash_attention_with_lse(xg, x, x)
    with pytest.raises(ValueError, match="head_dim"):
        TA.flash_attn_fwd(x[..., :32], x[..., :32], x[..., :32])


def _paged_case(cuda, dtype, b, kvh, g, hd, page, pps, seed=3):
    """Pools with a shuffled, non-contiguous page table (pages shared
    between rows, a trash tail), spread indices and one dead row."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    npages = b * pps + 1
    kp = torch.randn(npages, kvh, page, hd, generator=gen, device=cuda)
    vp = torch.randn(npages, kvh, page, hd, generator=gen, device=cuda)
    q = torch.randn(b, kvh, g, hd, generator=gen, device=cuda)
    perm = torch.randperm(npages - 1, generator=torch.Generator().manual_seed(
        seed)) + 1
    table = perm[: b * pps].reshape(b, pps).to(torch.int32)
    table[1, 0] = table[0, 0]
    table[-1, -1] = 0
    width = pps * page
    idx = torch.linspace(0, width - 1, b).round().to(torch.int32)
    idx[-1] = -9  # dead row
    return (q.to(dtype), kp.to(dtype), vp.to(dtype), table.to(cuda),
            idx.to(cuda))


def _strip(pool, table, length):
    """The same K/V as a dense (b, kv_h, length, w) strip (each member of
    a quantized pair)."""
    if isinstance(pool, tuple):
        return tuple(_strip(m, table, length) for m in pool)
    b = table.shape[0]
    win = pool[table.long()].movedim(2, 1).reshape(b, pool.shape[1], -1,
                                                   pool.shape[3])
    out = torch.zeros(b, pool.shape[1], length, pool.shape[3],
                      dtype=pool.dtype, device=pool.device)
    out[:, :, :win.shape[2]] = win
    return out


#: Strip lengths on which the unsplit K2 must give the same bits as K3 on
#: a pool of 1024 keys a slot: the pool's own, the batcher's max_len + 1 and
#: speculative strips past it.
STRIP_LENGTHS = (1024, 1025, 1029, 1031)


@pytest.mark.gpu
@pytest.mark.parametrize("page", [16, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_k3_equals_k2_bitwise(cuda, page, dtype):
    q, kp, vp, table, idx = _paged_case(cuda, dtype, 6, 3, 4, 64, page,
                                        1024 // page)
    vf = (idx.clamp(min=0) // 3).to(torch.int32)
    for valid_from in (None, vf):
        paged = TP.paged_attn(q, kp, vp, table, idx, valid_from)
        for length in STRIP_LENGTHS:
            dense = TD.decode_attn(q, _strip(kp, table, length),
                                   _strip(vp, table, length), idx,
                                   valid_from)
            torch.cuda.synchronize()
            assert torch.equal(paged, dense), length
        assert not paged[-1].any()  # the dead row


@pytest.mark.gpu
@pytest.mark.parametrize("split", [1, 2, 3, 4, 16])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("page", [16, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_k3_matches_plain(cuda, split, g, page, dtype):
    q, kp, vp, table, idx = _paged_case(cuda, dtype, 5, 2, g, 64, page,
                                        512 // page, seed=4)
    vf = (idx.clamp(min=0) // 2).to(torch.int32)
    n0 = TP.paged_attn.launches + TP.paged_attn_split.launches
    for valid_from in (None, vf):
        got = TP.paged_attention(q, kp, vp, table, idx, valid_from,
                                 split=split)
        torch.cuda.synchronize()
        ref = TP.paged_attention_plain(q, kp, vp, table, idx, valid_from,
                                       split)
        torch.testing.assert_close(got.float(), ref.float(),
                                   atol=_tol(dtype), rtol=_tol(dtype))
    assert TP.paged_attn.launches + TP.paged_attn_split.launches == n0 + 2


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 200])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_matches_plain(cuda, window, g, hd, dtype):
    gen = torch.Generator(device=cuda).manual_seed(5)
    page, chunk, npages, kvh = 16, 128, 40, 2
    kp = torch.randn(npages, kvh, page, hd, generator=gen, device=cuda)
    vp = torch.randn(npages, kvh, page, hd, generator=gen, device=cuda)
    for pos0 in (0, 256):
        q = torch.randn(1, kvh, g * chunk, hd, generator=gen, device=cuda)
        n_strip = (pos0 + chunk) // page
        n_pad = 1 << (n_strip - 1).bit_length()
        live = torch.randperm(npages - 1, generator=torch.Generator(
        ).manual_seed(pos0))[:n_strip] + 1
        pages = torch.cat([live, torch.zeros(n_pad - n_strip,
                                             dtype=live.dtype)])
        pages = pages.to(torch.int32).to(cuda)
        args = (q.to(dtype), kp.to(dtype), vp.to(dtype), pages, pos0, chunk)
        n0 = TP.paged_chunk_attn.launches
        got = TP.paged_chunk_attention(*args, window=window)
        torch.cuda.synchronize()
        assert TP.paged_chunk_attn.launches == n0 + 1
        ref = TP.paged_chunk_attention_reference(*args, window=window)
        torch.testing.assert_close(got.float(), ref.float(),
                                   atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.gpu
def test_paged_cuda_refuses_plain(cuda):
    q = torch.zeros(1, 1, 1, 64, device=cuda)
    pool = torch.zeros(2, 1, 16, 64, device=cuda)
    table = torch.ones(1, 1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="refuse"):
        TP.paged_attention(q, pool, pool, table, 0, prefer="xla")
    with pytest.raises(ValueError, match="refuse"):
        TP.paged_chunk_attention(q.expand(1, 1, 16, 64), pool, pool, table[0],
                                 0, 16, prefer="xla")
    with pytest.raises(ValueError, match="head_dim"):
        TP.paged_attn(q[..., :32], pool[..., :32], pool[..., :32], table, 0)


def _q(t, kv_dtype):
    return quantize_kv_vectors(t, kv_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
@pytest.mark.parametrize("split", [1, 2, 3, 4, 16])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_k2q_matches_plain(cuda, kv_dtype, split, g, dtype):
    gen = torch.Generator(device=cuda).manual_seed(11)
    b, kvh, L = 4, 3, 1025
    for hd in (64, 128):
        q = torch.randn(b, kvh, g, hd, generator=gen, device=cuda).to(dtype)
        ck = _q(torch.randn(b, kvh, L, hd, generator=gen, device=cuda),
                kv_dtype)
        cv = _q(torch.randn(b, kvh, L, hd, generator=gen, device=cuda),
                kv_dtype)
        idx = torch.tensor([1024, 0, 517, 64], device=cuda, dtype=torch.int32)
        vf = (idx // 3).to(torch.int32)
        n0 = TD.decode_attn.launches + TD.decode_attn_split.launches
        for valid_from in (None, vf):
            got = TD.decode_attention(q, ck, cv, idx, valid_from, split=split)
            torch.cuda.synchronize()
            ref = TD.decode_attention_plain(q, ck, cv, idx, valid_from, split)
            torch.testing.assert_close(got.float(), ref.float(),
                                       atol=_tol(dtype), rtol=_tol(dtype))
        n = TD.decode_attn.launches + TD.decode_attn_split.launches
        assert n == n0 + 2


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
@pytest.mark.parametrize("page", [16, 128])
def test_k3q_equals_k2q_bitwise(cuda, kv_dtype, page):
    q, kp, vp, table, idx = _paged_case(cuda, torch.bfloat16, 6, 3, 4, 64,
                                        page, 1024 // page, seed=12)
    kp, vp = _q(kp, kv_dtype), _q(vp, kv_dtype)
    vf = (idx.clamp(min=0) // 3).to(torch.int32)
    for valid_from in (None, vf):
        paged = TP.paged_attn(q, kp, vp, table, idx, valid_from)
        for length in STRIP_LENGTHS:
            dense = TD.decode_attn(q, _strip(kp, table, length),
                                   _strip(vp, table, length), idx,
                                   valid_from)
            torch.cuda.synchronize()
            assert torch.equal(paged, dense), length
        assert not paged[-1].any()  # the dead row


def _rows(c, sl):
    """Rows ``sl`` of a cache operand (each member of a quantized pair)."""
    return tuple(m[sl] for m in c) if isinstance(c, tuple) else c[sl]


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["native", "int8", "int4"])
@pytest.mark.parametrize("g,hd", [(1, 64), (4, 64), (2, 128), (16, 64),
                                  (16, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_k2_row_alone_equals_row_in_batch(cuda, kv_dtype, g, hd, dtype):
    """The unsplit K2 / K2q sums by key position only: each row alone
    (b = 1) gives the bits it gives in a batch of 8, on every strip length;
    a second run gives the same bits; a dead row is zeros; each call adds
    exactly one launch."""
    gen = torch.Generator(device=cuda).manual_seed(17)
    b, kvh, L = 8, 2, max(STRIP_LENGTHS)
    q = torch.randn(b, kvh, g, hd, generator=gen, device=cuda).to(dtype)
    ck = torch.randn(b, kvh, L, hd, generator=gen, device=cuda).to(dtype)
    cv = torch.randn(b, kvh, L, hd, generator=gen, device=cuda).to(dtype)
    if kv_dtype != "native":
        ck, cv = _q(ck.float(), kv_dtype), _q(cv.float(), kv_dtype)
    idx = torch.tensor([1023, 0, -1, 63, 64, 517, 900, 130], device=cuda,
                       dtype=torch.int32)
    vf = torch.tensor([0, 0, 0, 10, 64, 200, 899, 129], device=cuda,
                      dtype=torch.int32)
    first = lambda c, n: (tuple(first(m, n) for m in c)  # noqa: E731
                          if isinstance(c, tuple)
                          else c[:, :, :n].contiguous())
    for valid_from in (None, vf):
        n0 = TD.decode_attn.launches
        ref = TD.decode_attn(q, first(ck, 1025), first(cv, 1025), idx,
                             valid_from)
        again = TD.decode_attn(q, first(ck, 1025), first(cv, 1025), idx,
                               valid_from)
        torch.cuda.synchronize()
        assert TD.decode_attn.launches == n0 + 2
        assert torch.equal(ref, again)
        assert not ref[2].any()  # the dead row
        plain = TD.decode_attention_plain(q, first(ck, 1025), first(cv, 1025),
                                          idx, valid_from)
        live = idx >= 0
        torch.testing.assert_close(ref[live].float(), plain[live].float(),
                                   atol=_tol(dtype), rtol=_tol(dtype))
        for n in STRIP_LENGTHS:
            kk, vv = first(ck, n), first(cv, n)
            assert torch.equal(TD.decode_attn(q, kk, vv, idx, valid_from),
                               ref), n
            for r in range(b):
                sl = slice(r, r + 1)
                alone = TD.decode_attn(
                    q[sl], _rows(kk, sl), _rows(vv, sl), idx[sl],
                    None if valid_from is None else valid_from[sl])
                assert torch.equal(alone, ref[sl]), (n, r)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["native", "int8", "int4"])
def test_k3_counts_one_launch_and_is_deterministic(cuda, kv_dtype):
    q, kp, vp, table, idx = _paged_case(cuda, torch.bfloat16, 8, 12, 1, 64,
                                        128, 8, seed=19)
    if kv_dtype != "native":
        kp, vp = _q(kp.float(), kv_dtype), _q(vp.float(), kv_dtype)
    n0 = TP.paged_attn.launches
    a = TP.paged_attn(q, kp, vp, table, idx)
    assert TP.paged_attn.launches == n0 + 1
    b = TP.paged_attention(q, kp, vp, table, idx)
    torch.cuda.synchronize()
    assert TP.paged_attn.launches == n0 + 2
    assert torch.equal(a, b) and not a[-1].any()
    for r in (0, 3, 6):
        sl = slice(r, r + 1)
        assert torch.equal(TP.paged_attn(q[sl], kp, vp, table[sl], idx[sl]),
                           a[sl])


@pytest.mark.gpu
def test_k2_misaligned_cache_view_is_served(cuda):
    """A cache view that does not start on a 16-byte boundary (the
    kernel's cp.async copies need one) is copied by the wrapper, not
    refused, and gives the bits of an aligned copy."""
    gen = torch.Generator(device=cuda).manual_seed(23)
    flat = torch.randn(2 * 3 * 300 * 64 + 1, generator=gen,
                       device=cuda).to(torch.bfloat16)
    ck = flat[1:].view(2, 3, 300, 64)
    cv = torch.randn(2, 3, 300, 64, generator=gen,
                     device=cuda).to(torch.bfloat16)
    q = torch.randn(2, 3, 1, 64, generator=gen, device=cuda).to(torch.bfloat16)
    idx = torch.tensor([299, 100], device=cuda, dtype=torch.int32)
    assert ck.data_ptr() % 16 != 0
    got = TD.decode_attn(q, ck, cv, idx)
    want = TD.decode_attn(q, ck.clone(), cv, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
@pytest.mark.parametrize("split", [1, 2, 3, 4, 16])
@pytest.mark.parametrize("page", [16, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_k3q_matches_plain(cuda, kv_dtype, split, page, dtype):
    q, kp, vp, table, idx = _paged_case(cuda, dtype, 5, 2, 4, 64, page,
                                        512 // page, seed=13)
    kp, vp = _q(kp.float(), kv_dtype), _q(vp.float(), kv_dtype)
    vf = (idx.clamp(min=0) // 2).to(torch.int32)
    n0 = TP.paged_attn.launches + TP.paged_attn_split.launches
    for valid_from in (None, vf):
        got = TP.paged_attention(q, kp, vp, table, idx, valid_from,
                                 split=split)
        torch.cuda.synchronize()
        ref = TP.paged_attention_plain(q, kp, vp, table, idx, valid_from,
                                       split)
        torch.testing.assert_close(got.float(), ref.float(),
                                   atol=_tol(dtype), rtol=_tol(dtype))
    assert TP.paged_attn.launches + TP.paged_attn_split.launches == n0 + 2


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
@pytest.mark.parametrize("window", [None, 200])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("hd", [64, 128])
def test_k4q_matches_plain(cuda, kv_dtype, window, g, hd):
    gen = torch.Generator(device=cuda).manual_seed(14)
    page, chunk, npages, kvh = 16, 128, 40, 2
    kp = _q(torch.randn(npages, kvh, page, hd, generator=gen, device=cuda),
            kv_dtype)
    vp = _q(torch.randn(npages, kvh, page, hd, generator=gen, device=cuda),
            kv_dtype)
    for pos0 in (0, 256):
        q = torch.randn(1, kvh, g * chunk, hd, generator=gen,
                        device=cuda).to(torch.bfloat16)
        n_strip = (pos0 + chunk) // page
        n_pad = 1 << (n_strip - 1).bit_length()
        live = torch.randperm(npages - 1, generator=torch.Generator(
        ).manual_seed(pos0))[:n_strip] + 1
        pages = torch.cat([live, torch.zeros(n_pad - n_strip,
                                             dtype=live.dtype)])
        pages = pages.to(torch.int32).to(cuda)
        n0 = TP.paged_chunk_attn.launches
        got = TP.paged_chunk_attention(q, kp, vp, pages, pos0, chunk,
                                       window=window)
        torch.cuda.synchronize()
        assert TP.paged_chunk_attn.launches == n0 + 1
        ref = TP.paged_chunk_attention_reference(q, kp, vp, pages, pos0,
                                                 chunk, window=window)
        torch.testing.assert_close(got.float(), ref.float(), atol=1e-2,
                                   rtol=1e-2)


def _chunk_case(cuda, kv_dtype, dtype, kvh, g, hd, chunk, pos0, page,
                seed):
    """A chunk's folded q and pools; the window's pages shuffled and padded
    to a power of two with trash page 0."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    n_strip = -(-(pos0 + chunk) // page)
    n_pad = 1 << (n_strip - 1).bit_length()
    npages = n_strip + 3
    q = torch.randn(1, kvh, g * chunk, hd, generator=gen,
                    device=cuda).to(dtype)
    kp = torch.randn(npages, kvh, page, hd, generator=gen, device=cuda)
    vp = torch.randn(npages, kvh, page, hd, generator=gen, device=cuda)
    if kv_dtype == "native":
        kp, vp = kp.to(dtype), vp.to(dtype)
    else:
        kp, vp = _q(kp, kv_dtype), _q(vp, kv_dtype)
    live = torch.randperm(npages - 1, generator=torch.Generator(
    ).manual_seed(seed))[:n_strip] + 1
    pages = torch.cat([live, torch.zeros(n_pad - n_strip, dtype=live.dtype)])
    return q, kp, vp, pages.to(torch.int32).to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["native", "int8", "int4"])
@pytest.mark.parametrize("page", [16, 128])
@pytest.mark.parametrize("g,chunk,pos0,window", [
    (1, 100, 0, None),   # 100 folded rows: a ragged second row tile
    (3, 96, 300, None),  # 288 rows, positions wrapping inside a tile
    (2, 200, 517, 150),  # unaligned pos0, a window
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k4_ragged_rows_any_page_and_deterministic(cuda, kv_dtype, page, g,
                                                   chunk, pos0, window,
                                                   dtype):
    """The tensor-core K4 / K4q at pages 16 and 128 with folded rows that
    are not a multiple of its 64-row tile, against the plain version; a
    second run gives the same bits; each call adds one launch."""
    q, kp, vp, pages = _chunk_case(cuda, kv_dtype, dtype, 3, g, 64, chunk,
                                   pos0, page, 23)
    n0 = TP.paged_chunk_attn.launches
    got = TP.paged_chunk_attn(q, kp, vp, pages, pos0, chunk, window)
    again = TP.paged_chunk_attention(q, kp, vp, pages, pos0, chunk,
                                     window=window)
    torch.cuda.synchronize()
    assert TP.paged_chunk_attn.launches == n0 + 2
    assert torch.equal(got, again)
    ref = TP.paged_chunk_attention_reference(q, kp, vp, pages, pos0, chunk,
                                             window)
    torch.testing.assert_close(got.float(), ref.float(), atol=1e-2,
                               rtol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("page", [16, 128])
@pytest.mark.parametrize("pos0,chunk,window", [(0, 256, None),
                                               (512, 256, None),
                                               (256, 128, 200)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k4_rows_equal_k1_rows_bitwise(cuda, page, pos0, chunk, window,
                                       dtype):
    """The 16-bit K4 walks a row's key tiles in K1's order with K1's
    arithmetic: a chunk's rows equal the same rows of a causal K1 pass over
    the whole window's K/V as a dense strip, bit for bit (so a chunked or
    prefix-hit admission differs from the whole-prompt pass only by its
    matmuls' shapes)."""
    q, kp, vp, pages = _chunk_case(cuda, "native", dtype, 3, 1, 64, chunk,
                                   pos0, page, 37)
    n = pos0 + chunk
    strip = lambda pool: pool[pages.long()].movedim(1, 0).reshape(  # noqa
        1, 3, -1, 64)[:, :, :n].contiguous()
    gen = torch.Generator(device=cuda).manual_seed(41)
    q_all = torch.randn(1, 3, n, 64, generator=gen, device=cuda).to(dtype)
    q_all[:, :, pos0:] = q[:, :, :chunk]
    got = TP.paged_chunk_attn(q, kp, vp, pages, pos0, chunk, window)
    ref, _ = TA.flash_attn_fwd(q_all, strip(kp), strip(vp), True,
                               window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, ref[:, :, pos0:])


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["native", "int8", "int4"])
def test_k4_rows_depend_on_their_own_position_only(cuda, kv_dtype):
    """A row's K4 result depends on its q and the keys' positions only:
    rows 64..127 of a 256-row chunk at pos0 512 equal the same rows run as
    a chunk of 64 at pos0 576 (another row tile, another grid) bit for
    bit."""
    q, kp, vp, pages = _chunk_case(cuda, kv_dtype, torch.bfloat16, 2, 1, 64,
                                   256, 512, 128, 29)
    full = TP.paged_chunk_attn(q, kp, vp, pages, 512, 256)
    part = TP.paged_chunk_attn(q[:, :, 64:128].contiguous(), kp, vp, pages,
                               576, 64)
    torch.cuda.synchronize()
    assert torch.equal(full[:, :, 64:128], part)


@pytest.mark.gpu
def test_quantized_operands_are_checked(cuda):
    q = torch.zeros(1, 1, 1, 64, device=cuda)
    vals = torch.zeros(1, 1, 16, 64, dtype=torch.int8, device=cuda)
    sc = torch.ones(1, 1, 16, 1, device=cuda)
    with pytest.raises(ValueError, match="both"):
        TD.decode_attn(q, (vals, sc), vals.float(), 0)
    with pytest.raises(ValueError, match="width"):
        TD.decode_attn(q, (vals[..., :16], sc), (vals[..., :16], sc), 0)
    with pytest.raises(ValueError, match="scales"):
        TD.decode_attn(q, (vals, sc[..., :8, :]), (vals, sc[..., :8, :]), 0)


# -- K5 / K5q: batched paged verify ------------------------------------------


def _verify_case(cuda, dtype, kv_dtype, g, kc, hd, page, b=5, kvh=3, seed=21):
    """Pools with a shuffled table, indices spread over the window, the
    last slot dead (the batcher's idle sentinel)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    pps = 640 // page
    npages = b * pps + 1
    q = torch.randn(b, kvh, g * kc, hd, generator=gen, device=cuda).to(dtype)
    kp = torch.randn(npages, kvh, page, hd, generator=gen, device=cuda)
    vp = torch.randn(npages, kvh, page, hd, generator=gen, device=cuda)
    if kv_dtype == "native":
        kp, vp = kp.to(dtype), vp.to(dtype)
    else:
        kp = quantize_kv_vectors(kp, kv_dtype)
        vp = quantize_kv_vectors(vp, kv_dtype)
    perm = torch.randperm(npages - 1,
                          generator=torch.Generator().manual_seed(seed)) + 1
    table = perm.reshape(b, pps).to(torch.int32).to(cuda)
    idx = torch.linspace(0, 640 - kc, b).round().to(torch.int32)
    idx[-1] = -(kc + 2)
    return q, kp, vp, table, idx.to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["native", "int8", "int4"])
@pytest.mark.parametrize("window,tree_tail", [(None, 0), (150, 0), (None, 2),
                                              (70, 2)])
@pytest.mark.parametrize("g,hd,page", [(1, 64, 128), (4, 64, 16),
                                       (2, 128, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_matches_plain(cuda, dtype, g, hd, page, window, tree_tail,
                          kv_dtype):
    kc = 5 + tree_tail
    q, kp, vp, table, idx = _verify_case(cuda, dtype, kv_dtype, g, kc, hd,
                                         page)
    n0 = TP.paged_verify_attn.launches
    n1 = TP.paged_verify_attn_split.launches
    out = TP.paged_verify_attention(q, kp, vp, table, idx, kc, window=window,
                                    tree_tail=tree_tail)
    one = TP.paged_verify_attention(q, kp, vp, table, idx, kc, window=window,
                                    tree_tail=tree_tail, split=4)
    same = TP.paged_verify_attn_split(q, kp, vp, table, idx, kc, window,
                                      tree_tail, split=1)
    torch.cuda.synchronize()
    assert TP.paged_verify_attn.launches == n0 + 1
    assert TP.paged_verify_attn_split.launches == n1 + 2
    tol = _tol(dtype)
    for got, split in ((out, 1), (one, 4)):
        ref = TP.paged_verify_attention_plain(q, kp, vp, table, idx, kc,
                                              window, tree_tail, split)
        torch.testing.assert_close(got.float(), ref.float(), atol=tol,
                                   rtol=tol)
        assert not got[-1].any()  # the dead slot emits zeros
    assert torch.equal(same, out)  # split 1 == unsplit, bit for bit
    # Live rows also agree with the gather oracle.
    oracle = TP.paged_verify_attention_reference(q, kp, vp, table, idx, kc,
                                                 window, tree_tail)
    torch.testing.assert_close(out[:-1].float(), oracle[:-1].float(),
                               atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["native", "int8", "int4"])
@pytest.mark.parametrize("kc,tree_tail", [(5, 0), (7, 0), (7, 2)])
@pytest.mark.parametrize("g", [1, 4])
def test_k5_row_folds_match_plain_and_split_one(cuda, kv_dtype, kc,
                                                tree_tail, g):
    """The 16-bit K5 / K5q at 5 and 7 chunk rows with g 1 and 4 (5, 7, 20
    and 28 folded rows: one and two 16-row tiles) against the plain
    version; split 1 equals the unsplit kernel bit for bit; a second run
    gives the same bits; the dead slot is zeros."""
    q, kp, vp, table, idx = _verify_case(cuda, torch.bfloat16, kv_dtype, g,
                                         kc, 64, 128, b=8, kvh=3, seed=31)
    n0 = TP.paged_verify_attn.launches
    out = TP.paged_verify_attn(q, kp, vp, table, idx, kc, None, tree_tail)
    again = TP.paged_verify_attn(q, kp, vp, table, idx, kc, None, tree_tail)
    one = TP.paged_verify_attn_split(q, kp, vp, table, idx, kc, None,
                                     tree_tail, split=1)
    torch.cuda.synchronize()
    assert TP.paged_verify_attn.launches == n0 + 2
    assert torch.equal(out, again) and torch.equal(out, one)
    assert not out[-1].any()
    ref = TP.paged_verify_attention_plain(q, kp, vp, table, idx, kc, None,
                                          tree_tail)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                               rtol=1e-2)


@pytest.mark.gpu
def test_k5_cuda_refuses_plain_and_bad_operands(cuda):
    q, kp, vp, table, idx = _verify_case(cuda, torch.bfloat16, "native", 1,
                                         5, 64, 128)
    with pytest.raises(ValueError, match="plain version"):
        TP.paged_verify_attention(q, kp, vp, table, idx, 5, prefer="xla")
    with pytest.raises(ValueError, match="multiple"):
        TP.paged_verify_attn(q, kp, vp, table, idx, 4)
    with pytest.raises(ValueError, match="tree_tail"):
        TP.paged_verify_attn(q, kp, vp, table, idx, 5, None, 5)
    with pytest.raises(ValueError, match="page table"):
        TP.paged_verify_attn(q, kp, vp, table[:2], idx, 5)
    with pytest.raises(ValueError, match="dtypes differ"):
        TP.paged_verify_attn(q.float(), kp, vp, table, idx, 5)
    with pytest.raises(ValueError, match="contiguous"):
        TP.paged_verify_attn(q, kp.transpose(1, 2).contiguous().transpose(
            1, 2), vp, table, idx, 5)


# -- K6: blockwise int8 quantize / dequantize --------------------------------

#: The 2-layer GPT-2-small draft's quantized matrices (chip_smoke phase 10):
#: name -> (shape, dtype).
K6_DRAFT = {
    "pos_embed_f32": ((1024, 768), torch.float32),
    "tok_bf16": ((50257, 768), torch.bfloat16),
    "qkv_bf16": ((2304, 768), torch.bfloat16),
    "out_bf16": ((768, 768), torch.bfloat16),
    "mlp_in_bf16": ((3072, 768), torch.bfloat16),
    "mlp_out_bf16": ((768, 3072), torch.bfloat16),
    "head_f32": ((50257, 768), torch.float32),
}


def _k6_inputs(cuda, name):
    gen = torch.Generator(device=cuda).manual_seed(31)
    if name in K6_DRAFT:
        shape, dtype = K6_DRAFT[name]
        return (torch.randn(*shape, generator=gen, device=cuda)
                * 0.036).to(dtype)
    blocks = torch.randn(4, 8192, generator=gen, device=cuda)
    blocks[1] = 0.0
    blocks[2] = -0.37
    nan_inf = torch.randn(3, 8192, generator=gen, device=cuda)
    nan_inf[0, 17], nan_inf[1, 4000], nan_inf[2, 8191] = (
        float("nan"), float("inf"), float("-inf"))
    inf = torch.randn(2, 8192, generator=gen, device=cuda)
    inf[0, 2047], inf[1, 2048] = float("inf"), float("-inf")
    return {
        "matrix_bf16": lambda: (torch.randn(768, 3072, generator=gen,
                                            device=cuda) * 0.04).to(
                                                torch.bfloat16),
        "ragged_f32": lambda: torch.randn(1000, 37, generator=gen,
                                          device=cuda) * 3,
        "zero_const": lambda: blocks,
        "ties": lambda: torch.arange(-300, 301, device=cuda).float() / 2.0,
        "small_f16": lambda: torch.randn(17, generator=gen, device=cuda).to(
            torch.float16),
        # NaN / +Inf / -Inf blocks: NaN and Inf scales, 0 for NaN quotients.
        "nan_inf_f32": lambda: nan_inf,
        "nan_inf_f16": lambda: nan_inf.to(torch.float16),
        "inf_bf16": lambda: inf.to(torch.bfloat16),
    }[name]()


def _same_bits(a, b):
    """``torch.equal``, a NaN counting equal to a NaN (the kernel's and the
    plain version's NaN payloads may differ)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["matrix_bf16", "ragged_f32", "zero_const",
                                  "ties", "small_f16", "nan_inf_f32",
                                  "nan_inf_f16", "inf_bf16", *K6_DRAFT])
def test_k6_bit_equal_to_plain(cuda, name):
    x = _k6_inputs(cuda, name)
    n0, n1 = TQ.quantize_blocks.launches, TQ.dequantize_blocks.launches
    qt = TQ.quantize(x)
    back = TQ.dequantize(qt)
    torch.cuda.synchronize()
    assert TQ.quantize_blocks.launches == n0 + 1
    assert TQ.dequantize_blocks.launches == n1 + 1
    ref = TQ.quantize_reference(x)
    assert qt.values.shape == ref.values.shape and qt.shape == tuple(x.shape)
    assert torch.equal(qt.values, ref.values)
    assert _same_bits(qt.scales, ref.scales)
    assert back.dtype == x.dtype and back.shape == x.shape
    assert _same_bits(back, TQ.dequantize_reference(ref))
    if not bool(torch.isfinite(x).all()):
        assert not bool(torch.isfinite(qt.scales).all())


@pytest.mark.gpu
def test_k6_unaligned_base_raises(cuda):
    """16-byte vector access needs 16-byte-aligned bases: a storage-offset
    view raises, it never falls back to the plain version."""
    buf = torch.randn(8192 * 2 + 1, device=cuda).to(torch.bfloat16)
    x = buf[1:].view(2, 8192)
    with pytest.raises(ValueError, match="aligned"):
        TQ.quantize_blocks(x)
    qt = TQ.quantize_blocks(buf[:-1].view(2, 8192))
    shifted = torch.empty(qt.values.numel() + 1, dtype=torch.int8,
                          device=cuda)
    shifted[1:] = qt.values.reshape(-1)
    bad = TQ.QuantizedTensor(shifted[1:].view(-1, 128), qt.scales, qt.shape,
                             qt.dtype)
    n1 = TQ.dequantize_blocks.launches
    with pytest.raises(ValueError, match="aligned"):
        TQ.dequantize_blocks(bad)
    assert TQ.dequantize_blocks.launches == n1


@pytest.mark.gpu
def test_k6_params_round_trip_on_the_card(cuda):
    tree = {"w": torch.randn(300, 200, device=cuda).to(torch.bfloat16),
            "b": torch.randn(200, device=cuda)}
    q = TQ.quantize_params(tree)
    assert isinstance(q["w"], TQ.QuantizedTensor) and q["b"] is tree["b"]
    back = TQ.dequantize_params(q)
    assert back["w"].dtype == torch.bfloat16
    step = float(q["w"].scales.max())
    assert float((back["w"].float() - tree["w"].float()).abs().max()) \
        <= step / 2 + 0.01 * float(tree["w"].float().abs().max())


def _k6_trees(cuda):
    from adapt_tpu_torch.models.transformer_lm import transformer_lm

    draft = transformer_lm(50257, 768, 2, 12, 3072, max_len=1024,
                           dtype=torch.bfloat16, seed=1, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(37)
    shapes = [((8, 7), torch.float32), ((33, 17), torch.bfloat16),
              ((2, 4100), torch.float16), ((129, 64), torch.bfloat16)]
    forty = {f"w{i}": torch.randn(*shapes[i % 4][0], generator=gen,
                                  device=cuda).to(shapes[i % 4][1])
             for i in range(40)}
    forty["nested"] = {"empty": torch.zeros(0, 16, device=cuda),
                       "bias": torch.randn(7, device=cuda)}
    return {"draft2": (draft.state_dict(), 11, 1), "forty": (forty, 41, 2)}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["draft2", "forty"])
def test_k6_dequantize_params_grouped_launch(cuda, name):
    """``dequantize_params`` launches K6 once per 32 leaves (the 2-layer
    draft's 11 matrices: one launch; 40 leaves and an empty one: two), each
    leaf ``torch.equal`` to ``dequantize_blocks`` of that leaf alone and to
    the plain version, and a second run equal to the first."""
    tree, n_q, launches = _k6_trees(cuda)[name]
    q = TQ.quantize_params(tree)
    quant = {k: v for k, v in _k6_leaves(q)
             if isinstance(v, TQ.QuantizedTensor)}
    assert len(quant) == n_q
    n1 = TQ.dequantize_blocks.launches
    got = dict(_k6_leaves(TQ.dequantize_params(q)))
    torch.cuda.synchronize()
    assert TQ.dequantize_blocks.launches == n1 + launches
    again = dict(_k6_leaves(TQ.dequantize_params(q)))
    for key, qt in quant.items():
        assert got[key].dtype == qt.dtype and got[key].shape == qt.shape
        assert torch.equal(got[key], TQ.dequantize_blocks(qt)), key
        assert torch.equal(got[key], TQ.dequantize_reference(qt)), key
        assert torch.equal(got[key], again[key]), key
    for key, leaf in _k6_leaves(tree):
        if key not in quant:
            assert got[key] is leaf  # 1-D leaves pass through


def _k6_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _k6_leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


# K2-split / K3-split (and their int8 / int4 branches): one cluster of 8
# blocks per (row, split), the splits combined inside the launch.

def _kv(t, kv_dtype, dtype):
    """``t`` as a cache operand: native in ``dtype``, or a quantized pair."""
    return t.to(dtype) if kv_dtype == "native" else _q(t.float(), kv_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["native", "int8", "int4"])
@pytest.mark.parametrize("g", [1, 4, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_split_one_equals_unsplit_bitwise(cuda, kv_dtype, g, dtype):
    """Equality 1: with one split the span, tile -> rank map and rank
    combine are the unsplit kernel's and the rescale is exp(0) = 1, so
    K2-split / K3-split at split 1 equal K2 / K3 bit for bit."""
    q, kp, vp, table, idx = _paged_case(cuda, dtype, 6, 3, g, 64, 128, 8,
                                        seed=33)
    kp, vp = _kv(kp, kv_dtype, dtype), _kv(vp, kv_dtype, dtype)
    ck, cv = _strip(kp, table, 1025), _strip(vp, table, 1025)
    vf = (idx.clamp(min=0) // 3).to(torch.int32)
    for valid_from in (None, vf):
        dense = TD.decode_attn(q, ck, cv, idx, valid_from)
        dense1 = TD.decode_attn_split(q, ck, cv, idx, valid_from, 1)
        paged = TP.paged_attn(q, kp, vp, table, idx, valid_from)
        paged1 = TP.paged_attn_split(q, kp, vp, table, idx, valid_from, 1)
        torch.cuda.synchronize()
        assert torch.equal(dense1, dense)
        assert torch.equal(paged1, paged)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["native", "int8", "int4"])
@pytest.mark.parametrize("page", [16, 128])
@pytest.mark.parametrize("split", [3, 4])
def test_k3_split_equals_k2_split_bitwise(cuda, kv_dtype, page, split):
    """Equality 2: on the same K/V and the same key range L = 1024, a
    pool of pages 16 or 128 and a dense strip give the same bits: the
    split boundaries depend on L and split only."""
    q, kp, vp, table, idx = _paged_case(cuda, torch.bfloat16, 6, 3, 4, 64,
                                        page, 1024 // page, seed=34)
    kp, vp = (_kv(kp, kv_dtype, torch.bfloat16),
              _kv(vp, kv_dtype, torch.bfloat16))
    vf = (idx.clamp(min=0) // 3).to(torch.int32)
    for valid_from in (None, vf):
        paged = TP.paged_attn_split(q, kp, vp, table, idx, valid_from, split)
        dense = TD.decode_attn_split(q, _strip(kp, table, 1024),
                                     _strip(vp, table, 1024), idx,
                                     valid_from, split)
        torch.cuda.synchronize()
        assert torch.equal(paged, dense)
        assert not paged[-1].any()  # the dead row


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["native", "int8", "int4"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_split_row_alone_equals_batch_and_second_run(cuda, kv_dtype, layout):
    """Equalities 3 and 4 at split 4: each row alone gives the bits it
    gives in a batch of 8, and a second run (another arrival order of the
    clusters) gives the first run's bits."""
    q, kp, vp, table, idx = _paged_case(cuda, torch.bfloat16, 8, 12, 1, 64,
                                        128, 8, seed=35)
    kp, vp = (_kv(kp, kv_dtype, torch.bfloat16),
              _kv(vp, kv_dtype, torch.bfloat16))
    ck, cv = _strip(kp, table, 1025), _strip(vp, table, 1025)

    def run(sl):
        if layout == "dense":
            return TD.decode_attn_split(q[sl], _rows(ck, sl), _rows(cv, sl),
                                        idx[sl], None, 4)
        return TP.paged_attn_split(q[sl], kp, vp, table[sl], idx[sl], None,
                                   4)

    ref = run(slice(0, 8))
    for _ in range(3):
        assert torch.equal(run(slice(0, 8)), ref)
    for r in range(8):
        assert torch.equal(run(slice(r, r + 1)), ref[r:r + 1]), r
    torch.cuda.synchronize()
    assert not ref[-1].any()  # the dead row


@pytest.mark.gpu
@pytest.mark.parametrize("split", [2, 4, 8])
def test_k2_split_long_strip(cuda, split):
    """b1 kv_h12 on a strip of 16385 keys (every key live, and a row
    starting inside the strip): the splits against the plain version and
    the unsplit kernel."""
    gen = torch.Generator(device=cuda).manual_seed(36)
    L = 16385
    q = torch.randn(1, 12, 1, 64, generator=gen, device=cuda).to(
        torch.bfloat16)
    ck = torch.randn(1, 12, L, 64, generator=gen, device=cuda).to(
        torch.bfloat16)
    cv = torch.randn(1, 12, L, 64, generator=gen, device=cuda).to(
        torch.bfloat16)
    idx = torch.full((1,), L - 1, device=cuda, dtype=torch.int32)
    for valid_from in (None, torch.full((1,), 5000, device=cuda,
                                        dtype=torch.int32)):
        got = TD.decode_attn_split(q, ck, cv, idx, valid_from, split)
        whole = TD.decode_attn(q, ck, cv, idx, valid_from)
        torch.cuda.synchronize()
        ref = TD.decode_attention_plain(q, ck, cv, idx, valid_from, split)
        torch.testing.assert_close(got.float(), ref.float(), atol=1e-2,
                                   rtol=1e-2)
        torch.testing.assert_close(got.float(), whole.float(), atol=1e-2,
                                   rtol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["native", "int8", "int4"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_split_call_is_one_kernel(cuda, kv_dtype, layout):
    """A K2-split / K3-split call launches exactly one CUDA kernel, the
    cluster kernel: no torch combine runs on the card."""
    q, kp, vp, table, idx = _paged_case(cuda, torch.bfloat16, 8, 12, 1, 64,
                                        128, 8, seed=37)
    kp, vp = (_kv(kp, kv_dtype, torch.bfloat16),
              _kv(vp, kv_dtype, torch.bfloat16))
    ck, cv = _strip(kp, table, 1025), _strip(vp, table, 1025)
    def call():
        if layout == "dense":
            return TD.decode_attn_split(q, ck, cv, idx, None, 4)
        return TP.paged_attn_split(q, kp, vp, table, idx, None, 4)

    call()
    torch.cuda.synchronize()
    lead = torch.empty(1, device=cuda)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(20):  # the first events of a session may be lost
            lead.zero_()
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)  # marker: the calls' events come after it
        for _ in range(5):
            call()
        torch.cuda.synchronize()
    names = [e.name for e in sorted(
        (e for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda e: e.time_range.start)]
    after = names[max(i for i, n in enumerate(names) if "spin_kernel" in n)
                  + 1:]
    assert len(after) == 5 and all("decode_cluster_kernel" in n
                                   for n in after), after


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_split_on_two_streams(cuda, layout):
    """Split calls queued on two streams of one device at once keep to
    their own arrival counters: each stream's outputs equal the bits the
    same call gives alone."""
    q, kp, vp, table, idx = _paged_case(cuda, torch.bfloat16, 8, 12, 1, 64,
                                        128, 8, seed=38)
    ck, cv = _strip(kp, table, 1025), _strip(vp, table, 1025)

    def call(split):
        if layout == "dense":
            return TD.decode_attn_split(q, ck, cv, idx, None, split)
        return TP.paged_attn_split(q, kp, vp, table, idx, None, split)

    want = {sp: call(sp) for sp in (3, 4)}
    torch.cuda.synchronize()
    streams = {sp: torch.cuda.Stream(cuda) for sp in want}
    got = {sp: [] for sp in want}
    for _ in range(20):
        for sp, st in streams.items():
            with torch.cuda.stream(st):
                got[sp].append(call(sp))
    torch.cuda.synchronize()
    for sp, outs in got.items():
        assert all(torch.equal(o, want[sp]) for o in outs), sp


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
@pytest.mark.parametrize("kvh", [3, 6])
@pytest.mark.parametrize("kernel", ["K2", "K3", "K4", "K5"])
def test_kernels_at_shard_head_counts_match_plain(cuda, kernel, kvh,
                                                  kv_dtype):
    """GPT-2-small's 12 heads as tp=2 / tp=4 shards see them: kv_h 6 and 3,
    g 1, head_dim 64, bf16, at the serving shapes (8 rows, 1025-key strips,
    page 128, chunk 256, 5 verify rows); K3 equals K2 on the same K/V bit
    for bit."""
    dtype = torch.bfloat16
    if kernel in ("K2", "K3"):
        q, kp, vp, table, idx = _paged_case(cuda, dtype, 8, kvh, 1, 64, 128,
                                            8, seed=40 + kvh)
        if kv_dtype != "native":
            kp, vp = _q(kp, kv_dtype), _q(vp, kv_dtype)
        ck, cv = _strip(kp, table, 1025), _strip(vp, table, 1025)
        k2 = TD.decode_attn(q, ck, cv, idx)
        k3 = TP.paged_attn(q, kp, vp, table, idx)
        torch.cuda.synchronize()
        got, ref = (k2, TD.decode_attention_plain(q, ck, cv, idx)) if (
            kernel == "K2") else (k3, TP.paged_attention_plain(q, kp, vp,
                                                               table, idx))
        assert torch.equal(k3, k2)
    elif kernel == "K4":
        gen = torch.Generator(device=cuda).manual_seed(50 + kvh)
        page, chunk, pos0, npages = 128, 256, 512, 12
        kp = torch.randn(npages, kvh, page, 64, generator=gen,
                         device=cuda).to(dtype)
        vp = torch.randn(npages, kvh, page, 64, generator=gen,
                         device=cuda).to(dtype)
        if kv_dtype != "native":
            kp, vp = _q(kp, kv_dtype), _q(vp, kv_dtype)
        q = torch.randn(1, kvh, chunk, 64, generator=gen,
                        device=cuda).to(dtype)
        pages = torch.tensor([3, 7, 1, 9, 5, 0, 0, 0], dtype=torch.int32,
                             device=cuda)
        got = TP.paged_chunk_attn(q, kp, vp, pages, pos0, chunk)
        torch.cuda.synchronize()
        ref = TP.paged_chunk_attention_reference(q, kp, vp, pages, pos0,
                                                 chunk)
    else:
        q, kp, vp, table, idx = _verify_case(cuda, dtype, kv_dtype, 1, 5, 64,
                                             128, b=8, kvh=kvh, seed=60)
        got = TP.paged_verify_attn(q, kp, vp, table, idx, 5)
        torch.cuda.synchronize()
        ref = TP.paged_verify_attention_plain(q, kp, vp, table, idx, 5)
    torch.testing.assert_close(got.float(), ref.float(), atol=1e-2,
                               rtol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_pipelined_generate_pp2_matches_generate(cuda, kv_dtype):
    """``pipelined_generate`` at pp 2 on a mesh naming the card twice:
    greedy ragged streams token-equal to ``generate()`` run on each
    microbatch alone (the same prefill rows, so the same cuBLAS shapes;
    decode rows padded to 8 in both), with K1 and K2 launched twice as
    often as ``generate()`` of the whole batch."""
    from adapt_tpu_torch.core.mesh import MeshSpec, build_mesh
    from adapt_tpu_torch.models.transformer_lm import generate, transformer_lm
    from adapt_tpu_torch.parallel.pipeline_decode import pipelined_generate

    lm = transformer_lm(97, 128, 4, 2, 256, max_len=64, device=cuda, seed=3)
    gen = torch.Generator().manual_seed(4)
    prompt = torch.randint(0, 97, (8, 12), generator=gen).to(cuda)
    lens = [12, 5, 9, 3, 12, 7, 1, 10]
    mesh = build_mesh(MeshSpec((("pp", 2),)), [cuda] * 2)
    kw = dict(prompt_lengths=lens, kv_cache_dtype=kv_dtype)
    TA.flash_attn_fwd.launches = TD.decode_attn.launches = 0
    generate(lm, prompt, 9, **kw)
    whole = (TA.flash_attn_fwd.launches, TD.decode_attn.launches)
    TA.flash_attn_fwd.launches = TD.decode_attn.launches = 0
    got = pipelined_generate(lm, None, prompt, 9, mesh, **kw)
    torch.cuda.synchronize()
    assert (TA.flash_attn_fwd.launches, TD.decode_attn.launches) == (
        2 * whole[0], 2 * whole[1])
    want = torch.cat([generate(lm, prompt[m * 4:(m + 1) * 4], 9,
                               prompt_lengths=lens[m * 4:(m + 1) * 4],
                               kv_cache_dtype=kv_dtype) for m in range(2)])
    assert torch.equal(got, want)
