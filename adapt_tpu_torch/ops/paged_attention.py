"""Paged attention: kernels K3 / K3-split (``csrc/paged_attn.cu``), K4
(``csrc/paged_chunk_attn.cu``) and K5 / K5-split
(``csrc/paged_verify_attn.cu``) over a shared KV page pool, and their plain
PyTorch versions.

Counterpart of ``adapt_tpu/ops/paged_attention.py``. Layouts stay the JAX
package's:

- pool: ``(num_pages, kv_heads, page_size, head_dim)``, or a quantized
  ``(values, scales)`` pair of an int8 value pool (``head_dim`` wide, or
  ``head_dim // 2`` packed int4) and an f32 scale pool ``(num_pages,
  kv_heads, page_size, 1)`` addressed by the same table; page 0 is the
  trash page (``runtime/paged``), the target of unallocated table entries
  and of dead rows' writes, and is never read unmasked;
- page table: ``(slots, pages_per_slot)`` int32 physical page ids in
  logical order;
- q: ``(slots, kv_heads, g, head_dim)`` group-folded for decode,
  ``(1, kv_heads, g * chunk, head_dim)`` (row = member * chunk + position)
  for a chunk pass, and ``(slots, kv_heads, g * chunk, head_dim)`` for the
  batched speculative verify (K5), each slot's rows on its own diagonal.

A CUDA tensor launches the kernel, which walks each slot's page-table row
itself (no gather of pages into a strip); a CPU tensor runs the plain
version. K3 / K3-split are K2 / K2-split's body with a paged address (one
attention discipline, two layouts: a cluster of 8 blocks per row, or per
row and split with the splits combined in the same launch; tile t on rank
t mod 8), so K3 equals K2 bit for bit on the same K/V (the splits on the
same key range), and its plain version is K2's on the slot's gathered
window: 64-key tiles, dead-tile skip and split partials. K5 and K5-split
run the same
cluster body with each row's own diagonal as a mask (one cluster per slot,
kv head, split and tile of up to 16 folded rows; the 16-bit tiles'
products on the tensor cores). K4 runs K1's tensor-core body (16-bit q)
with the page walk, so a chunk's rows equal a whole-prompt K1 pass's on
the same K/V bit for bit. Any page size
is served: the TPU gates ``page % 128`` (and ``page % 1024`` for quantized
pools) are not carried over. A quantized pool launches the kernels' int8 /
int4 branches (K3q, K4q, K5q), which read the bytes and scales themselves.
"""

from __future__ import annotations

import math

import torch

from adapt_tpu_torch.ops import _build
from adapt_tpu_torch.ops.decode_attention import (
    KERNEL_MAX_G,
    _combine_splits,
    _operand,
    _pv,
    _qk,
    _row_index,
    aligned16,
    cache_values,
    check_head_parity,
    decode_attention_plain,
    decode_attention_reference,
    kernel_kv,
    split_kv,
    split_workspace,
    verify_attention,
    verify_live,
)

DEFAULT_PAGE_SIZE = 128

_NEG_INF = -1e30


#: The VALUE array of a pool operand (the int8 member of a quantized pair).
pool_values = cache_values


#: Pool operands -> ``(k_vals, v_vals, k_scales, v_scales)``.
_split_pools = split_kv


def _gather_window(pool, page_table):
    """(num_pages, kvh, P, w) pool + (b, n) table -> (b, kvh, n * P, w),
    each slot's pages in table order; a quantized pair gathers both
    members."""
    if isinstance(pool, tuple):
        return tuple(_gather_window(m, page_table) for m in pool)
    b = page_table.shape[0]
    g_ = pool[page_table.long()]  # (b, n, kvh, P, w)
    return g_.movedim(2, 1).reshape(b, pool.shape[1], -1, pool.shape[3])


def paged_attention_reference(q, k_pool, v_pool, page_table, index,
                              valid_from=None):
    """The gather oracle: each slot's pages gathered into a contiguous
    window, then the contiguous decode oracle — the semantics definition
    AND the materializing schedule K3 exists to beat."""
    return decode_attention_reference(
        q, _gather_window(k_pool, page_table),
        _gather_window(v_pool, page_table), index, valid_from,
    )


def paged_attention_plain(q, k_pool, v_pool, page_table, index,
                          valid_from=None, split=1):
    """The plain version of K3 (``split == 1``) and K3-split: K2's plain
    version over the slot's ``pps * page`` window, as K3 runs K2's body
    over it. It mirrors the split kernels' tiles, not the unsplit kernel's
    cluster partition, which is held to it at a tolerance."""
    return decode_attention_plain(
        q, _gather_window(k_pool, page_table),
        _gather_window(v_pool, page_table), index, valid_from, split,
    )


def paged_chunk_attention_reference(q, k_pool, v_pool, pages, pos0,
                                    chunk: int, window: int | None = None):
    """The gather oracle of the chunk-query kernel: gather the window,
    mask ``col <= pos0 + row % chunk`` (banded by ``window`` when set),
    softmax, weight. q is (1, kv_h, g * chunk, hd) group-folded, pages
    (n,). Quantized pools apply their scales to the score and
    probability columns in ``decode_attention_reference``'s op order. Also
    K4's plain version: K4 only skips tiles whose every position this mask
    removes."""
    hd = q.shape[-1]
    kvh = pool_values(k_pool).shape[1]

    def gather(pool):
        if isinstance(pool, tuple):
            return tuple(gather(m) for m in pool)
        return pool[torch.as_tensor(pages, device=pool.device).long()].movedim(
            1, 0).reshape(1, kvh, -1, pool.shape[3])

    k, ksc = _operand(gather(k_pool), hd)
    v, vsc = _operand(gather(v_pool), hd)
    sm = 1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32))
    s = _qk(q, k, ksc, sm.to(q.device))
    rows = torch.arange(q.shape[2], device=q.device) % chunk
    cols = torch.arange(k.shape[2], device=q.device)
    live = cols[None, :] <= pos0 + rows[:, None]
    if window is not None:
        live = live & (cols[None, :] > pos0 + rows[:, None] - window)
    s = torch.where(live[None, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return _pv(p, v, vsc).to(q.dtype)


def paged_verify_attention_reference(q, k_pool, v_pool, page_table, index,
                                     chunk: int, window: int | None = None,
                                     tree_tail: int = 0):
    """The gather oracle of the batched paged verify: each slot's pages
    gathered into a contiguous window, then the dense verify
    (:func:`decode_attention.verify_attention`). q (b, kv_h, g * chunk, hd)
    group-folded K-major; ``index`` (b,) per-slot base positions. A dead
    row (negative index) comes out as a uniform average nothing reads —
    where K5 and its plain version emit zeros."""
    return verify_attention(
        q, _gather_window(k_pool, page_table),
        _gather_window(v_pool, page_table), index, chunk, window=window,
        tree_tail=tree_tail,
    )


def _verify_partials(q, k_pool, v_pool, page_table, index, chunk, window,
                     tree_tail, split):
    """Plain per-split partials (acc, m, l) of what K5-split computes: each
    split owns ``ceil(pps / split)`` pages of the slot's table row (the
    ragged tail empty), a slot whose last chunk position is negative skips
    everything (m = -1e30, l = 0), and a split holding no live key of a row
    contributes nothing to it."""
    b, kvh, gc, hd = q.shape
    page = pool_values(k_pool).shape[2]
    pps = page_table.shape[1]
    k, ksc = _operand(_gather_window(k_pool, page_table), hd)
    v, vsc = _operand(_gather_window(v_pool, page_table), hd)
    n_pos = k.shape[2]
    dev = q.device
    s = _qk(q, k, ksc, 1.0 / (hd ** 0.5))
    idx = _row_index(index, b, dev)
    live = verify_live(idx, b, gc, n_pos, chunk, window, tree_tail, dev)
    live = live & (idx + chunk - 1 >= 0)[:, None, None]
    owner = (torch.arange(n_pos, device=dev) // page) // (-(-pps // split))
    o_p, m_p, l_p = [], [], []
    for sp in range(split):
        mask = (live & (owner == sp)[None, None, :])[:, None]
        m = torch.where(mask, s, float("-inf")).amax(-1)
        m = torch.clamp(m, min=_NEG_INF)
        p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
        o_p.append(_pv(p, v, vsc))
        m_p.append(m)
        l_p.append(p.sum(-1))
    rows = b * kvh
    return (
        torch.stack(o_p, 2).reshape(rows, split, gc, hd),
        torch.stack(m_p, 2).reshape(rows, split, gc),
        torch.stack(l_p, 2).reshape(rows, split, gc),
    )


def paged_verify_attention_plain(q, k_pool, v_pool, page_table, index,
                                 chunk: int, window: int | None = None,
                                 tree_tail: int = 0, split: int = 1):
    """The plain version of K5 (``split == 1``) and K5-split, native or
    quantized: live rows as the gather oracle, dead rows zeros."""
    b, kvh, gc, hd = q.shape
    o, m, l = _verify_partials(q, k_pool, v_pool, page_table, index, chunk,
                               window, tree_tail, split)
    if split == 1:
        out = o[:, 0] / torch.clamp(l[:, 0, :, None], min=1e-30)
        return out.to(q.dtype).reshape(b, kvh, gc, hd)
    return _combine_splits(o, m, l, q.dtype).reshape(b, kvh, gc, hd)


def _check_pools(q, k_pool, v_pool, what):
    """The kernel operands of a pool pair (``decode_attention.kernel_kv``)
    after the pool-shape checks; pools must already be contiguous (the
    kernels write nothing to them, and a copy would defeat the page
    sharing)."""
    kv = kernel_kv(q, k_pool, v_pool, what)
    if kv[0].shape[1] != q.shape[1]:
        raise ValueError(
            f"pool shape {tuple(kv[0].shape)} vs q {tuple(q.shape)}")
    if not all(t.is_contiguous() for t in kv[:4] if t is not None):
        raise ValueError(f"{what} needs contiguous pools")
    return kv


def _launch_paged(q, k_pool, v_pool, page_table, index, valid_from, split,
                  out, combine):
    k, v, ks, vs, code = _check_pools(q, k_pool, v_pool, "K3")
    k, v = aligned16(k), aligned16(v)  # K3 reads the pools, never writes
    b, kvh, g, hd = q.shape
    if g > KERNEL_MAX_G:
        raise ValueError(f"K3 serves g <= {KERNEL_MAX_G} rows, got {g}")
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(
            f"page table shape {tuple(page_table.shape)} vs {b} rows"
        )
    table = page_table.to(torch.int32).contiguous()
    idx = _row_index(index, b, q.device)
    vf = None
    if valid_from is not None:
        vf = torch.as_tensor(valid_from, device=q.device).to(torch.int32)
        vf = vf.reshape(b).contiguous()
    ws, counter = split_workspace(q, split) if combine else (None, None)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    err = _build.load("paged_attn").paged_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(ks), ptr(vs),
        table.data_ptr(), idx.data_ptr(), ptr(vf), out.data_ptr(), ptr(ws),
        ptr(counter), b, kvh, g, table.shape[1], k.shape[2], hd, split,
        _build.dtype_code(q.dtype), code, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "paged_attn")


def paged_attn(q, k_pool, v_pool, page_table, index, valid_from=None):
    """Launch K3 (a cluster of 8 blocks per (slot, kv head)) on CUDA
    tensors; a quantized pool launches its int8 / int4 branch (K3q)."""
    q = q.contiguous()
    out = torch.empty_like(q)
    _launch_paged(q, k_pool, v_pool, page_table, index, valid_from, 1, out,
                  False)
    paged_attn.launches += 1
    _build.record_kernel_dispatch("paged_decode", "pallas")
    return out


def paged_attn_split(q, k_pool, v_pool, page_table, index, valid_from=None,
                     split=2):
    """Launch K3-split (a cluster of 8 blocks per (slot, kv head, split),
    the splits combined in the same launch) on CUDA tensors; a quantized
    pool launches its int8 / int4 branch. ``split == 1`` equals
    :func:`paged_attn` bit for bit."""
    q = q.contiguous()
    out = torch.empty_like(q)
    _launch_paged(q, k_pool, v_pool, page_table, index, valid_from, split,
                  out, True)
    paged_attn_split.launches += 1
    _build.record_kernel_dispatch("paged_decode", "pallas")
    return out


def paged_chunk_attn(q, k_pool, v_pool, pages, pos0: int, chunk: int,
                     window: int | None = None):
    """Launch K4 (one block per (kv head, 64 folded query rows); tensor
    cores for bf16 / f16 q) on CUDA tensors; ``pos0`` is the chunk's first
    position (a host int). A quantized pool launches its int8 / int4
    branch (K4q)."""
    k, v, ks, vs, code = _check_pools(q, k_pool, v_pool, "K4")
    k, v = aligned16(k), aligned16(v)  # 16-byte copies; K4 never writes
    _, kvh, gc, hd = q.shape
    if q.shape[0] != 1:
        raise ValueError(f"K4 takes one chunk (batch 1), got {q.shape[0]}")
    if gc % chunk:
        raise ValueError(f"{gc} folded rows are not a multiple of {chunk}")
    pages = torch.as_tensor(pages, device=q.device).to(torch.int32)
    pages = pages.reshape(-1).contiguous()
    q = q.contiguous()
    out = torch.empty_like(q)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    err = _build.load("paged_chunk_attn").paged_chunk_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(ks), ptr(vs),
        pages.data_ptr(), out.data_ptr(), kvh, gc, chunk, pages.shape[0],
        k.shape[2], int(pos0), int(window or 0), hd,
        _build.dtype_code(q.dtype), code, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "paged_chunk_attn")
    paged_chunk_attn.launches += 1
    _build.record_kernel_dispatch("paged_chunk", "pallas")
    return out


def _launch_verify(q, k_pool, v_pool, page_table, index, chunk, window,
                   tree_tail, split, out, parts):
    k, v, ks, vs, code = _check_pools(q, k_pool, v_pool, "K5")
    k, v = aligned16(k), aligned16(v)  # 16-byte copies; K5 never writes
    b, kvh, gc, hd = q.shape
    if chunk < 1 or gc % chunk:
        raise ValueError(f"{gc} folded rows are not a multiple of {chunk}")
    if not 0 <= tree_tail < chunk:
        raise ValueError(f"tree_tail {tree_tail} outside [0, {chunk})")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(
            f"page table shape {tuple(page_table.shape)} vs {b} rows"
        )
    table = page_table.to(torch.int32).contiguous()
    idx = _row_index(index, b, q.device)
    o_p, m_p, l_p = parts if parts is not None else (None, None, None)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    err = _build.load("paged_verify_attn").paged_verify_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(ks), ptr(vs),
        table.data_ptr(), idx.data_ptr(), ptr(out), ptr(o_p), ptr(m_p),
        ptr(l_p), b, kvh, gc, chunk, int(window or 0), tree_tail,
        table.shape[1], k.shape[2], hd, split, _build.dtype_code(q.dtype),
        code, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "paged_verify_attn")


def paged_verify_attn(q, k_pool, v_pool, page_table, index, chunk: int,
                      window: int | None = None, tree_tail: int = 0):
    """Launch K5 (a cluster of 8 blocks per (slot, kv head, tile of up to
    16 folded rows)) on CUDA tensors; a quantized pool launches its int8 /
    int4 branch (K5q)."""
    q = q.contiguous()
    out = torch.empty_like(q)
    _launch_verify(q, k_pool, v_pool, page_table, index, chunk, window,
                   tree_tail, 1, out, None)
    paged_verify_attn.launches += 1
    _build.record_kernel_dispatch("paged_verify", "pallas")
    return out


def paged_verify_attn_split(q, k_pool, v_pool, page_table, index, chunk: int,
                            window: int | None = None, tree_tail: int = 0,
                            split: int = 2):
    """Launch K5-split (a cluster of 8 blocks per (slot, kv head, split,
    tile of up to 16 folded rows), rank 0 writing the split's partials) on
    CUDA tensors and combine them. With ``split == 1`` the partials are
    the unsplit kernel's sums, so the combined output equals K5's bit for
    bit."""
    q = q.contiguous()
    b, kvh, gc, hd = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    parts = (
        torch.empty((b * kvh, split, gc, hd), **f32),
        torch.empty((b * kvh, split, gc), **f32),
        torch.empty((b * kvh, split, gc), **f32),
    )
    _launch_verify(q, k_pool, v_pool, page_table, index, chunk, window,
                   tree_tail, split, None, parts)
    paged_verify_attn_split.launches += 1
    _build.record_kernel_dispatch("paged_verify", "pallas")
    return _combine_splits(*parts, q.dtype).reshape(b, kvh, gc, hd)


#: Launches of K3 / K3-split / K4 / K5 / K5-split (kernel calls only).
paged_attn.launches = 0
paged_attn_split.launches = 0
paged_chunk_attn.launches = 0
paged_verify_attn.launches = 0
paged_verify_attn_split.launches = 0


def _check_prefer(prefer, q):
    if prefer not in (None, "pallas", "xla"):
        raise ValueError(
            f"prefer={prefer!r}: expected None, 'pallas' or 'xla'"
        )
    if q.is_cuda and prefer == "xla":
        raise ValueError(
            "prefer='xla' selects the plain version, which CUDA tensors "
            "refuse: the card's paged path runs the K3/K4/K5 kernels"
        )


def paged_chunk_attention(q, k_pool, v_pool, pages, pos0, chunk: int,
                          prefer=None, window: int | None = None):
    """Chunk-prefill attention over a paged window, in place: q (1, kv_h,
    g * chunk, hd) group-folded; ``pages`` (n,) covers the whole live
    window [0, pos0 + chunk) (pow2 padding to the trash page is fine —
    those positions are past every row's mask). Pools may be quantized
    pairs. K4 on CUDA, the plain version on CPU."""
    check_head_parity(q.shape[1], pool_values(k_pool).shape[1])
    _check_prefer(prefer, q)
    if not q.is_cuda:
        _build.record_kernel_dispatch("paged_chunk", "xla")
        return paged_chunk_attention_reference(
            q, k_pool, v_pool, pages, pos0, chunk, window
        )
    return paged_chunk_attn(q, k_pool, v_pool, pages, pos0, chunk, window)


def paged_attention(q, k_pool, v_pool, page_table, index, valid_from=None,
                    prefer=None, split=None):
    """Decode attention over a paged KV cache: K3 (``split`` 1 or None)
    or K3-split (its combine inside the launch) on CUDA, the plain version
    on CPU. Pools may be quantized pairs. ``prefer="xla"`` selects the plain
    version, which a CUDA tensor refuses."""
    check_head_parity(q.shape[1], pool_values(k_pool).shape[1])
    _check_prefer(prefer, q)
    split = 1 if split is None else int(split)
    if split < 1:
        raise ValueError(f"split must be >= 1, got {split}")
    if not q.is_cuda:
        _build.record_kernel_dispatch("paged_decode", "xla")
        return paged_attention_plain(
            q, k_pool, v_pool, page_table, index, valid_from, split
        )
    if split == 1:
        return paged_attn(q, k_pool, v_pool, page_table, index, valid_from)
    return paged_attn_split(q, k_pool, v_pool, page_table, index,
                            valid_from, split)


def paged_verify_attention(q, k_pool, v_pool, page_table, index, chunk: int,
                           prefer=None, window: int | None = None,
                           tree_tail: int = 0, split=None):
    """Batched multi-token verify attention over a paged KV cache — the
    speculative counterpart of :func:`paged_attention`: ``chunk`` rows per
    slot, each masked to its own ``index[b] + t`` diagonal (the caller has
    already scattered the chunk's K/V into the pages). K5 (``split`` 1 or
    None) or K5-split plus the rescale combine on CUDA, the plain version
    on CPU. Pools may be quantized pairs; ``tree_tail`` marks the chunk's
    last w rows as tree-draft leaves. ``prefer="xla"`` selects the plain
    version, which a CUDA tensor refuses."""
    check_head_parity(q.shape[1], pool_values(k_pool).shape[1])
    _check_prefer(prefer, q)
    split = 1 if split is None else int(split)
    if split < 1:
        raise ValueError(f"split must be >= 1, got {split}")
    if not q.is_cuda:
        _build.record_kernel_dispatch("paged_verify", "xla")
        return paged_verify_attention_plain(
            q, k_pool, v_pool, page_table, index, chunk, window, tree_tail,
            split,
        )
    if split == 1:
        return paged_verify_attn(q, k_pool, v_pool, page_table, index, chunk,
                                 window, tree_tail)
    return paged_verify_attn_split(q, k_pool, v_pool, page_table, index,
                                   chunk, window, tree_tail, split)
