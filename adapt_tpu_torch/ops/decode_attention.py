"""Decode-time cached attention: kernels K2 / K2-split
(``csrc/decode_attn.cu``) and their plain PyTorch version.

Counterpart of ``adapt_tpu/ops/decode_attention.py``. Layouts stay the JAX
package's: q is the GQA-folded ``(b, kv_h, g, hd)``, caches are ``(b, kv_h,
L, hd)`` arrays or quantized ``(values, scales)`` pairs — int8 values
``(b, kv_h, L, hd)``, or packed int4 values ``(b, kv_h, L, hd // 2)``
(``ops/quantize``), with one f32 scale per cached vector ``(b, kv_h, L,
1)`` — ``index`` (scalar or ``(b,)``) is each row's newest live position
and ``valid_from`` ``(b,)`` its first. A CUDA tensor launches K2
(``split == 1``) or K2-split (``split > 1``), one launch either way; for a
quantized cache the kernel reads the int8 / int4 bytes and the scales
itself (K2q). K2 spreads a row's 64-key tiles over a cluster of 8 blocks
(tile t on rank t mod 8) and combines the ranks on the card; K2-split runs
one such cluster per (row, split) over the split's run of tiles and
combines the splits in split order in the same launch. Their sums depend
on key positions (and, split, on ``L`` and ``split``) only: the same row
gives the same bits alone or in a batch and on a paged pool (K3), and K2
on any strip length. A CPU tensor runs :func:`decode_attention_plain`,
which takes the same split boundaries (64-key tiles, dead tiles skipped,
per-split partials, :func:`_combine_splits`) but not the clusters' order of
sums: the kernels are held to it at a tolerance. Any ``L`` is served. The
scales are applied in the reference's op order: ``(q . k_int) * k_scale *
sm``, then ``softmax(...) * v_scale`` against ``v_int``.

:func:`verify_attention`, the speculative verify over dense strips, has no
kernel in either package: the JAX package runs it as an einsum schedule
outside any Pallas kernel, and so does the port, as plain tensor operations
on the card too.
"""

from __future__ import annotations

import torch

from adapt_tpu_torch.ops import _build
from adapt_tpu_torch.ops.quantize import aligned16, kv_values

_NEG_INF = -1e30

#: Keys per tile of K2 (``TK`` in ``csrc/decode_cluster.cuh``): the plain
#: version skips dead tiles and cuts splits at the same granularity.
DECODE_TILE = 64
#: Folded query rows per kv head K2 serves (padded to 1, 4 or 16).
KERNEL_MAX_G = 16
KERNEL_HEAD_DIMS = (64, 128)


def check_head_parity(q_heads: int, cache_heads: int) -> None:
    """q and cache must carry the same (per-shard) kv-head count."""
    if q_heads != cache_heads:
        raise ValueError(
            f"q carries {q_heads} KV-head rows but the cache carries "
            f"{cache_heads}: both operands must use the same (per-shard) "
            "head count"
        )


def cache_values(cache):
    """The VALUE tensor of a cache operand: the int8 member of a quantized
    ``(values, scales)`` pair, the cache itself otherwise."""
    return cache[0] if isinstance(cache, tuple) else cache


def split_kv(cache_k, cache_v):
    """Split possibly-quantized K/V operands into ``(k_vals, v_vals,
    k_scales, v_scales)``, the scales None for native caches."""
    if isinstance(cache_k, tuple):
        (kv, ks), (vv, vs) = cache_k, cache_v
        return kv, vv, ks, vs
    return cache_k, cache_v, None, None


def _operand(cache, hd):
    """A cache operand as (f32 values in element order, f32 scale row
    ``(..., 1, L)`` or None for a native cache)."""
    if isinstance(cache, tuple):
        vals, sc = cache
        return kv_values(vals, hd).float(), sc.float().transpose(-2, -1)
    return cache.float(), None


def _qk(q, k, ksc, sm):
    """Scores ``q . k`` times ``sm``; a quantized cache's key scales come
    between, in the reference's order ``(q . k_int) * k_scale * sm``."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k)
    if ksc is not None:
        s = s * ksc
    return s * sm


def _pv(p, v, vsc):
    """``p . v``; a quantized cache weights p by the value scales first
    (the denominator was summed from the unscaled p)."""
    return torch.einsum("bhqk,bhkd->bhqd", p if vsc is None else p * vsc, v)


def append_kv(cache, new, index):
    """Write K tokens per row into ``cache`` (b, h, L, hd) IN PLACE and
    return it. ``new`` is (b, h, K, hd); ``index`` a scalar (every row at
    one position) or ``(b,)`` (each row at its own). The start clamps to
    ``[0, L - K]`` exactly as the JAX ``dynamic_update_slice`` does, so a
    write past the end lands on the last K positions instead of faulting.
    Tensor indices stay on the device (no host sync). A quantized cache is
    written member by member (``models/transformer_lm._write_kv_pair``):
    ``hd`` is the member's own width."""
    b, h, L, hd = cache.shape
    K = new.shape[2]
    new = new.to(cache.dtype)
    if isinstance(index, int):
        start = min(max(index + L if index < 0 else index, 0), L - K)
        cache[:, :, start:start + K] = new
        return cache
    idx = torch.as_tensor(index, device=cache.device).to(torch.int64)
    idx = idx.reshape(-1).expand(b)
    start = torch.where(idx < 0, idx + L, idx).clamp(0, L - K)
    pos = start[:, None] + torch.arange(K, device=cache.device)[None, :]
    cache.scatter_(2, pos[:, None, :, None].expand(b, h, K, hd), new)
    return cache


def _row_index(index, b, device):
    idx = torch.as_tensor(index, device=device).to(torch.int32)
    return idx.reshape(-1).expand(b).contiguous()


def decode_attention_reference(q, cache_k, cache_v, index, valid_from=None):
    """The einsum oracle (f32 scores, position mask over the whole
    buffer, a quantized cache's scales on the score and probability
    columns): ``adapt_tpu.ops.decode_attention.
    decode_attention_reference``."""
    hd = q.shape[-1]
    sm = 1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32))
    k, ksc = _operand(cache_k, hd)
    v, vsc = _operand(cache_v, hd)
    s = _qk(q, k, ksc, sm.to(q.device))
    b, n_pos = q.shape[0], k.shape[2]
    positions = torch.arange(n_pos, device=q.device)
    live = positions[None, :] <= _row_index(index, b, q.device)[:, None]
    if valid_from is not None:
        vf = torch.as_tensor(valid_from, device=q.device)
        live = live & (positions[None, :] >= vf[:, None])
    s = torch.where(live[:, None, None, :], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return _pv(p, v, vsc).to(q.dtype)


def verify_live(index, b, rows, n_pos, chunk, window, tree_tail, device):
    """The verify mask ``(b, rows, n_pos)``: folded row ``r`` is chunk
    position ``t = r % chunk``; it attends ``col <= index + depth(t)`` with
    ``depth = min(t, chunk - 1 - tree_tail)`` (banded below by ``window``),
    and a tree leaf also its own slot ``col == index + t``."""
    cols = torch.arange(n_pos, device=device)
    t = torch.arange(rows, device=device) % chunk
    depth = torch.clamp(t, max=chunk - 1 - tree_tail) if tree_tail else t
    idx = _row_index(index, b, device)
    edge = idx[:, None, None] + depth[None, :, None]
    live = cols[None, None, :] <= edge
    if window is not None:
        live = live & (cols[None, None, :] > edge - window)
    if tree_tail:
        own = idx[:, None, None] + t[None, :, None]
        live = live | (cols[None, None, :] == own)
    return live


def verify_attention(q, cache_k, cache_v, index, chunk: int, window=None,
                     tree_tail: int = 0):
    """Multi-token VERIFY attention over dense strips: ``chunk`` rows per
    slot, each attending the cache up to its own position — the port of
    ``adapt_tpu.ops.decode_attention.verify_attention``.

    q (b, kv_h, g * chunk, hd) group-folded K-major (row = member * chunk +
    t); caches (b, kv_h, L, hd), or quantized pairs, with the chunk's K/V
    already appended; ``index`` scalar or (b,) is the cache position of
    chunk token 0. A negative row index is a dead row: everything masks and
    the output is finite garbage nothing reads. ``tree_tail`` = w marks the
    last w rows as tree leaves (see :func:`verify_live`). Quantized caches
    apply their scales in :func:`decode_attention_reference`'s op order, so
    a verify chunk's rows equal sequential quantized decode steps.

    No kernel: the JAX package runs this einsum schedule outside any Pallas
    kernel, so it stays plain tensor operations (matmul + softmax) on the
    card as well — deliberately not ``scaled_dot_product_attention``."""
    hd = q.shape[-1]
    check_head_parity(q.shape[1], cache_values(cache_k).shape[1])
    sm = 1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32))
    k, ksc = _operand(cache_k, hd)
    v, vsc = _operand(cache_v, hd)
    s = _qk(q, k, ksc, sm.to(q.device))
    live = verify_live(index, q.shape[0], q.shape[2], k.shape[2], chunk,
                       window, tree_tail, q.device)
    s = torch.where(live[:, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return _pv(p, v, vsc).to(q.dtype)


def _combine_splits(o_parts, m_parts, l_parts, out_dtype):
    """Single-pass rescale combine of split partials: ``o`` (rows, split,
    g, hd) unnormalised f32 accumulators, ``m``/``l`` (rows, split, g)
    running max / denominator. A split whose every tile was dead carries
    (m = -1e30, l = 0) and contributes nothing; an all-dead row emits 0."""
    m = m_parts[..., None]
    l = l_parts[..., None]
    m_star = torch.amax(m, dim=1, keepdim=True)
    alpha = torch.exp(m - m_star)
    denom = torch.sum(l * alpha, dim=1)
    out = torch.sum(o_parts * alpha, dim=1)
    return (out / torch.clamp(denom, min=1e-30)).to(out_dtype)


def _split_partials(q, cache_k, cache_v, index, valid_from, split):
    """Plain per-split partials (acc, m, l) of what K2-split computes:
    64-key tiles, tiles wholly past ``index`` or inside the left padding
    skipped (they add nothing, not even ``exp(0)`` garbage), the ragged
    last split masked."""
    b, kvh, g, hd = q.shape
    k, ksc = _operand(cache_k, hd)
    vv, vsc = _operand(cache_v, hd)
    L = k.shape[2]
    dev = q.device
    s = _qk(q, k, ksc, 1.0 / (hd ** 0.5))
    pos = torch.arange(L, device=dev)
    idx = _row_index(index, b, dev)[:, None]
    vf = (
        torch.zeros_like(idx) if valid_from is None
        else torch.as_tensor(valid_from, device=dev).reshape(b, 1)
    )
    live = (pos[None, :] <= idx) & (pos[None, :] >= vf)
    s = torch.where(live[:, None, None, :], s, _NEG_INF)
    t0 = (pos // DECODE_TILE) * DECODE_TILE
    tile_live = (t0[None, :] <= idx) & (t0[None, :] + DECODE_TILE > vf)
    n_tiles = -(-L // DECODE_TILE)
    tps = -(-n_tiles // split)
    owner = (pos // DECODE_TILE) // tps  # split each position belongs to
    o_p, m_p, l_p = [], [], []
    for sp in range(split):
        in_sp = (owner == sp)[None, :] & tile_live  # (b, L)
        mask = in_sp[:, None, None, :]
        m = torch.where(mask, s, float("-inf")).amax(-1)
        m = torch.clamp(m, min=_NEG_INF)  # no live tile: m stays -1e30
        p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
        o_p.append(_pv(p, vv, vsc))
        m_p.append(m)
        l_p.append(p.sum(-1))
    rows = b * kvh
    return (
        torch.stack(o_p, 2).reshape(rows, split, g, hd),
        torch.stack(m_p, 2).reshape(rows, split, g),
        torch.stack(l_p, 2).reshape(rows, split, g),
    )


def decode_attention_plain(q, cache_k, cache_v, index, valid_from=None,
                           split=1):
    """The plain version of K2 (``split == 1``) and K2-split, native or
    quantized. It takes the kernels' 64-key tiles and split boundaries; the
    kernels sum the same terms over their clusters' ranks in another
    order, so they are held to this at a tolerance (1e-2 + 1e-2 |ref| in 16
    bits, 2e-5 in f32), not bit for bit."""
    b, kvh, g, hd = q.shape
    o, m, l = _split_partials(q, cache_k, cache_v, index, valid_from, split)
    if split == 1:
        out = (o[:, 0] / torch.clamp(l[:, 0, :, None], min=1e-30))
        return out.to(q.dtype).reshape(b, kvh, g, hd)
    return _combine_splits(o, m, l, q.dtype).reshape(b, kvh, g, hd)


def kernel_kv(q, cache_k, cache_v, what):
    """Check the K/V operands a decode kernel takes against q (b, kv_h, g,
    hd) and return ``(k, v, k_scale, v_scale, kv code)``:
    native K/V in q's dtype, or quantized pairs of int8 values (``hd``
    wide, or ``hd // 2`` packed int4) and f32 scales of one per vector. The
    leading (vector) dims are the caller's to check."""
    hd = q.shape[-1]
    quant = isinstance(cache_k, tuple)
    if quant != isinstance(cache_v, tuple):
        raise ValueError(f"{what}: K and V must both be quantized or not")
    k, v, ks, vs = split_kv(cache_k, cache_v)
    if not all(t.is_cuda for t in (q, k, v, ks, vs) if t is not None):
        raise ValueError(f"{what} launches on CUDA tensors only")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"{what} serves head_dim {KERNEL_HEAD_DIMS}, got {hd}")
    if k.shape != v.shape:
        raise ValueError(f"{what}: K {tuple(k.shape)} vs V {tuple(v.shape)}")
    if not quant:
        if not q.dtype == k.dtype == v.dtype:
            raise ValueError(
                f"q/cache dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
        if k.shape[-1] != hd:
            raise ValueError(f"cache width {k.shape[-1]} vs head_dim {hd}")
        return k, v, None, None, _build.KV_NATIVE
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise ValueError(f"quantized values must be int8, got {k.dtype}")
    if k.shape[-1] not in (hd, hd // 2):
        raise ValueError(
            f"quantized width {k.shape[-1]}: expected {hd} (int8) or "
            f"{hd // 2} (packed int4)")
    want = (*k.shape[:-1], 1)
    for sc in (ks, vs):
        if sc.dtype != torch.float32 or tuple(sc.shape) != want:
            raise ValueError(
                f"scales must be f32 {want}, got {sc.dtype} "
                f"{tuple(sc.shape)}")
    code = _build.KV_INT8 if k.shape[-1] == hd else _build.KV_INT4
    return k, v, ks, vs, code


def _check_kernel_args(q, cache_k, cache_v):
    k, v, ks, vs, code = kernel_kv(q, cache_k, cache_v, "K2")
    b, kvh, g, hd = q.shape
    if k.shape[:2] != (b, kvh):
        raise ValueError(
            f"cache shape {tuple(k.shape)} vs q {tuple(q.shape)}"
        )
    if g > KERNEL_MAX_G:
        raise ValueError(f"K2 serves g <= {KERNEL_MAX_G} rows, got {g}")
    c = lambda t: None if t is None else t.contiguous()  # noqa: E731
    return aligned16(c(k)), aligned16(c(v)), c(ks), c(vs), code


_COUNTERS: dict = {}


def split_workspace(q, split):
    """The splits' scratch for one launch on q's device: ``(ws, counter)``,
    ``ws`` rows x split x g x (hd + 2) f32 partials (acc, then m, then l),
    made anew, and ``counter`` one int32 arrival word per row from the
    buffer of q's device and its current stream (the one the wrappers
    launch on), grown as needed. The kernels leave every counter at 0, so
    a buffer is never cleared again; keying it by stream keeps splits
    launched on two streams of one device off each other's counters."""
    b, kvh, g, hd = q.shape
    rows = b * kvh
    ws = torch.empty(rows * split * g * (hd + 2), dtype=torch.float32,
                     device=q.device)
    key = (q.device, torch.cuda.current_stream(q.device).cuda_stream)
    counter = _COUNTERS.get(key)
    if counter is None or counter.numel() < rows:
        counter = torch.zeros(max(rows, 1024), dtype=torch.int32,
                              device=q.device)
        _COUNTERS[key] = counter
    return ws, counter


def _launch(q, kv, index, valid_from, split, out, scratch):
    b, kvh, g, hd = q.shape
    k, v, ks, vs, code = kv
    idx = _row_index(index, b, q.device)
    vf = None
    if valid_from is not None:
        vf = torch.as_tensor(valid_from, device=q.device).to(torch.int32)
        vf = vf.reshape(b).contiguous()
    ws, counter = scratch if scratch is not None else (None, None)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    err = _build.load("decode_attn").decode_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(ks), ptr(vs),
        idx.data_ptr(), ptr(vf), out.data_ptr(), ptr(ws), ptr(counter), b,
        kvh, g, k.shape[2], hd, split, _build.dtype_code(q.dtype), code,
        1.0 / (hd ** 0.5), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "decode_attn")


def decode_attn(q, cache_k, cache_v, index, valid_from=None):
    """Launch K2 (a cluster of 8 blocks per (b, kv head)) on CUDA tensors;
    a quantized cache launches its int8 / int4 branch (K2q)."""
    kv = _check_kernel_args(q, cache_k, cache_v)
    q = q.contiguous()
    out = torch.empty_like(q)
    _launch(q, kv, index, valid_from, 1, out, None)
    decode_attn.launches += 1
    _build.record_kernel_dispatch("decode", "pallas")
    return out


def decode_attn_split(q, cache_k, cache_v, index, valid_from=None, split=2):
    """Launch K2-split (a cluster of 8 blocks per (b, kv head, split), the
    splits combined in the same launch) on CUDA tensors; a quantized cache
    launches its int8 / int4 branch. ``split == 1`` equals
    :func:`decode_attn` bit for bit."""
    kv = _check_kernel_args(q, cache_k, cache_v)
    q = q.contiguous()
    out = torch.empty_like(q)
    _launch(q, kv, index, valid_from, split, out, split_workspace(q, split))
    decode_attn_split.launches += 1
    _build.record_kernel_dispatch("decode", "pallas")
    return out


#: Launches of K2 / K2-split (kernel calls only).
decode_attn.launches = 0
decode_attn_split.launches = 0


def decode_attention(q, cache_k, cache_v, index, valid_from=None,
                     prefer=None, block_k=None, split=None):
    """Cached decode attention over the live window ``[valid_from, index]``
    of a native or quantized cache: K2 / K2-split on CUDA, the plain
    version on CPU.
    ``prefer="xla"`` selects the plain version, which a CUDA tensor
    refuses. ``split`` None means 1. ``block_k`` is accepted for signature
    parity and ignored (K2's tile is fixed)."""
    del block_k
    check_head_parity(q.shape[1], cache_values(cache_k).shape[1])
    if prefer not in (None, "pallas", "xla"):
        raise ValueError(
            f"prefer={prefer!r}: expected None, 'pallas' or 'xla'"
        )
    split = 1 if split is None else int(split)
    if split < 1:
        raise ValueError(f"split must be >= 1, got {split}")
    if not q.is_cuda:
        _build.record_kernel_dispatch("decode", "xla")
        return decode_attention_plain(
            q, cache_k, cache_v, index, valid_from, split
        )
    if prefer == "xla":
        raise ValueError(
            "prefer='xla' selects the plain version, which CUDA tensors "
            "refuse: the card's decode path runs the K2 kernel"
        )
    if split == 1:
        return decode_attn(q, cache_k, cache_v, index, valid_from)
    return decode_attn_split(q, cache_k, cache_v, index, valid_from, split)
