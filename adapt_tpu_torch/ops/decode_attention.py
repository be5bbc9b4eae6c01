"""Decode-time cached attention: kernels K2 / K2-split
(``csrc/decode_attn.cu``) and their plain PyTorch version.

Counterpart of ``adapt_tpu/ops/decode_attention.py`` for native caches.
Layouts stay the JAX package's: q is the GQA-folded ``(b, kv_h, g, hd)``,
caches are ``(b, kv_h, L, hd)``, ``index`` (scalar or ``(b,)``) is each
row's newest live position and ``valid_from`` ``(b,)`` its first. A CUDA
tensor launches K2 (``split == 1``) or K2-split plus :func:`_combine_splits`
(``split > 1``); a CPU tensor runs :func:`decode_attention_plain`, which
computes what the kernel computes tile for tile (64-key tiles, dead tiles
skipped, per-split partials, the same combine). Any ``L`` is served.
Quantized ``(values, scales)`` caches raise until their slice is ported.
"""

from __future__ import annotations

import torch

from adapt_tpu_torch.ops import _build

_NEG_INF = -1e30

#: Keys per tile of K2 (``TK`` in ``csrc/decode_attn.cu``): the plain
#: version skips dead tiles at the same granularity.
DECODE_TILE = 64
#: Folded query rows per kv head K2 serves (``MAX_G``).
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


def _reject_quantized(cache_k) -> None:
    if isinstance(cache_k, tuple):
        raise NotImplementedError(
            "quantized (values, scales) KV caches are not ported yet "
            "(K2's int8/int4 branches: ROADMAP 'quantized KV' slice)"
        )


def append_kv(cache, new, index):
    """Write K tokens per row into ``cache`` (b, h, L, hd) IN PLACE and
    return it. ``new`` is (b, h, K, hd); ``index`` a scalar (every row at
    one position) or ``(b,)`` (each row at its own). The start clamps to
    ``[0, L - K]`` exactly as the JAX ``dynamic_update_slice`` does, so a
    write past the end lands on the last K positions instead of faulting.
    Tensor indices stay on the device (no host sync)."""
    _reject_quantized(cache)
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
    buffer) — ``adapt_tpu.ops.decode_attention.decode_attention_reference``
    for native caches."""
    _reject_quantized(cache_k)
    sm = 1.0 / torch.sqrt(torch.tensor(q.shape[-1], dtype=torch.float32))
    s = torch.einsum(
        "bhqd,bhkd->bhqk", q.float(), cache_k.float()
    ) * sm.to(q.device)
    b, n_pos = q.shape[0], cache_k.shape[2]
    positions = torch.arange(n_pos, device=q.device)
    live = positions[None, :] <= _row_index(index, b, q.device)[:, None]
    if valid_from is not None:
        vf = torch.as_tensor(valid_from, device=q.device)
        live = live & (positions[None, :] >= vf[:, None])
    s = torch.where(live[:, None, None, :], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, cache_v.float())
    return o.to(q.dtype)


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
    L = cache_k.shape[2]
    dev = q.device
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), cache_k.float())
    s = s * (1.0 / (hd ** 0.5))
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
    vv = cache_v.float()
    for sp in range(split):
        in_sp = (owner == sp)[None, :] & tile_live  # (b, L)
        mask = in_sp[:, None, None, :]
        m = torch.where(mask, s, float("-inf")).amax(-1)
        m = torch.clamp(m, min=_NEG_INF)  # no live tile: m stays -1e30
        p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
        o_p.append(torch.einsum("bhqk,bhkd->bhqd", p, vv))
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
    """The plain version of K2 (``split == 1``) and K2-split."""
    b, kvh, g, hd = q.shape
    o, m, l = _split_partials(q, cache_k, cache_v, index, valid_from, split)
    if split == 1:
        out = (o[:, 0] / torch.clamp(l[:, 0, :, None], min=1e-30))
        return out.to(q.dtype).reshape(b, kvh, g, hd)
    return _combine_splits(o, m, l, q.dtype).reshape(b, kvh, g, hd)


def _check_kernel_args(q, cache_k, cache_v):
    if not (q.is_cuda and cache_k.is_cuda and cache_v.is_cuda):
        raise ValueError("decode kernels launch on CUDA tensors only")
    if not q.dtype == cache_k.dtype == cache_v.dtype:
        raise ValueError(
            f"q/cache dtypes differ: {q.dtype} {cache_k.dtype} "
            f"{cache_v.dtype}"
        )
    b, kvh, g, hd = q.shape
    if cache_k.shape != cache_v.shape or cache_k.shape[:2] != (b, kvh) \
            or cache_k.shape[3] != hd:
        raise ValueError(
            f"cache shape {tuple(cache_k.shape)} vs q {tuple(q.shape)}"
        )
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"K2 serves head_dim {KERNEL_HEAD_DIMS}, got {hd}")
    if g > KERNEL_MAX_G:
        raise ValueError(f"K2 serves g <= {KERNEL_MAX_G} rows, got {g}")


def _launch(q, cache_k, cache_v, index, valid_from, split, out, parts):
    b, kvh, g, hd = q.shape
    idx = _row_index(index, b, q.device)
    vf = None
    if valid_from is not None:
        vf = torch.as_tensor(valid_from, device=q.device).to(torch.int32)
        vf = vf.reshape(b).contiguous()
    o_p, m_p, l_p = parts if parts is not None else (None, None, None)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    err = _build.load("decode_attn").decode_attn(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), idx.data_ptr(),
        ptr(vf), ptr(out), ptr(o_p), ptr(m_p), ptr(l_p), b, kvh, g,
        cache_k.shape[2], hd, split, _build.dtype_code(q.dtype),
        1.0 / (hd ** 0.5), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "decode_attn")


def decode_attn(q, cache_k, cache_v, index, valid_from=None):
    """Launch K2 (one block per (b, kv head)) on CUDA tensors."""
    _check_kernel_args(q, cache_k, cache_v)
    q = q.contiguous()
    cache_k, cache_v = cache_k.contiguous(), cache_v.contiguous()
    out = torch.empty_like(q)
    _launch(q, cache_k, cache_v, index, valid_from, 1, out, None)
    decode_attn.launches += 1
    return out


def decode_attn_split(q, cache_k, cache_v, index, valid_from=None, split=2):
    """Launch K2-split (one block per (b, kv head, split)) on CUDA tensors
    and combine its partials."""
    _check_kernel_args(q, cache_k, cache_v)
    q = q.contiguous()
    cache_k, cache_v = cache_k.contiguous(), cache_v.contiguous()
    b, kvh, g, hd = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    parts = (
        torch.empty((b * kvh, split, g, hd), **f32),
        torch.empty((b * kvh, split, g), **f32),
        torch.empty((b * kvh, split, g), **f32),
    )
    _launch(q, cache_k, cache_v, index, valid_from, split, None, parts)
    decode_attn_split.launches += 1
    return _combine_splits(*parts, q.dtype).reshape(b, kvh, g, hd)


#: Launches of K2 / K2-split (kernel calls only).
decode_attn.launches = 0
decode_attn_split.launches = 0


def decode_attention(q, cache_k, cache_v, index, valid_from=None,
                     prefer=None, block_k=None, split=None):
    """Cached decode attention over the live window ``[valid_from, index]``
    of a native cache: K2 / K2-split on CUDA, the plain version on CPU.
    ``prefer="xla"`` selects the plain version, which a CUDA tensor
    refuses. ``split`` None means 1. ``block_k`` is accepted for signature
    parity and ignored (K2's tile is fixed)."""
    del block_k
    _reject_quantized(cache_k)
    check_head_parity(q.shape[1], cache_k.shape[1])
    if prefer not in (None, "pallas", "xla"):
        raise ValueError(
            f"prefer={prefer!r}: expected None, 'pallas' or 'xla'"
        )
    split = 1 if split is None else int(split)
    if split < 1:
        raise ValueError(f"split must be >= 1, got {split}")
    if not q.is_cuda:
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
