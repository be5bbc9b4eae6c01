"""Paged attention: kernels K3 / K3-split (``csrc/paged_attn.cu``) and K4
(``csrc/paged_chunk_attn.cu``) over a shared KV page pool, and their plain
PyTorch versions.

Counterpart of ``adapt_tpu/ops/paged_attention.py`` for native pools.
Layouts stay the JAX package's:

- pool: ``(num_pages, kv_heads, page_size, head_dim)``; page 0 is the
  trash page (``runtime/paged``), the target of unallocated table entries
  and of dead rows' writes, and is never read unmasked;
- page table: ``(slots, pages_per_slot)`` int32 physical page ids in
  logical order;
- q: ``(slots, kv_heads, g, head_dim)`` group-folded for decode, and
  ``(1, kv_heads, g * chunk, head_dim)`` (row = member * chunk + position)
  for a chunk pass.

A CUDA tensor launches the kernel, which walks each slot's page-table row
itself (no gather of pages into a strip); a CPU tensor runs the plain
version. K3 is K2's body with a paged address (one attention discipline,
two layouts), so its plain version is K2's on the slot's gathered window:
the same 64-key tiles, dead-tile skip and split partials. Any page size
is served: the TPU gate ``page % 128`` is not carried over. Quantized
``(values, scales)`` pools raise until their slice is ported;
``paged_verify_attention`` (K5) waits for the speculative slice.
"""

from __future__ import annotations

import math

import torch

from adapt_tpu_torch.ops import _build
from adapt_tpu_torch.ops.decode_attention import (
    KERNEL_HEAD_DIMS,
    KERNEL_MAX_G,
    _combine_splits,
    _row_index,
    check_head_parity,
    decode_attention_plain,
    decode_attention_reference,
)

DEFAULT_PAGE_SIZE = 128

_NEG_INF = -1e30


def pool_values(pool):
    """The VALUE array of a pool operand: the int8 member of a quantized
    ``(values, scales)`` pair, the pool itself otherwise."""
    return pool[0] if isinstance(pool, tuple) else pool


def _reject_quantized(k_pool, v_pool) -> None:
    if isinstance(k_pool, tuple) or isinstance(v_pool, tuple):
        raise NotImplementedError(
            "quantized (values, scales) KV pools are not ported yet "
            "(K3/K4's int8/int4 branches: ROADMAP 'quantized KV' slice)"
        )


def _gather_window(pool, page_table):
    """(num_pages, kvh, P, hd) pool + (b, n) table -> (b, kvh, n * P, hd),
    each slot's pages in table order."""
    b = page_table.shape[0]
    g_ = pool[page_table.long()]  # (b, n, kvh, P, hd)
    return g_.movedim(2, 1).reshape(b, pool.shape[1], -1, pool.shape[3])


def paged_attention_reference(q, k_pool, v_pool, page_table, index,
                              valid_from=None):
    """The gather oracle: each slot's pages gathered into a contiguous
    window, then the contiguous decode oracle — the semantics definition
    AND the materializing schedule K3 exists to beat."""
    _reject_quantized(k_pool, v_pool)
    return decode_attention_reference(
        q, _gather_window(k_pool, page_table),
        _gather_window(v_pool, page_table), index, valid_from,
    )


def paged_attention_plain(q, k_pool, v_pool, page_table, index,
                          valid_from=None, split=1):
    """The plain version of K3 (``split == 1``) and K3-split: K2's tile-
    exact plain version over the slot's ``pps * page`` window, as K3 runs
    K2's body over it."""
    _reject_quantized(k_pool, v_pool)
    return decode_attention_plain(
        q, _gather_window(k_pool, page_table),
        _gather_window(v_pool, page_table), index, valid_from, split,
    )


def paged_chunk_attention_reference(q, k_pool, v_pool, pages, pos0,
                                    chunk: int, window: int | None = None):
    """The gather oracle of the chunk-query kernel: gather the window,
    mask ``col <= pos0 + row % chunk`` (banded by ``window`` when set),
    softmax, weight. q is (1, kv_h, g * chunk, hd) group-folded, pages
    (n,). Also K4's plain version: K4 only skips tiles whose every
    position this mask removes."""
    _reject_quantized(k_pool, v_pool)
    kvh = k_pool.shape[1]

    def gather(pool):
        return pool[torch.as_tensor(pages, device=pool.device).long()].movedim(
            1, 0).reshape(1, kvh, -1, pool.shape[3])

    k, v = gather(k_pool), gather(v_pool)
    sm = 1.0 / torch.sqrt(torch.tensor(q.shape[-1], dtype=torch.float32))
    s = torch.einsum(
        "bhqd,bhkd->bhqk", q.float(), k.float()
    ) * sm.to(q.device)
    rows = torch.arange(q.shape[2], device=q.device) % chunk
    cols = torch.arange(k.shape[2], device=q.device)
    live = cols[None, :] <= pos0 + rows[:, None]
    if window is not None:
        live = live & (cols[None, :] > pos0 + rows[:, None] - window)
    s = torch.where(live[None, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _check_pools(q, k_pool, v_pool, what):
    if not (q.is_cuda and k_pool.is_cuda and v_pool.is_cuda):
        raise ValueError(f"{what} launches on CUDA tensors only")
    if not q.dtype == k_pool.dtype == v_pool.dtype:
        raise ValueError(
            f"q/pool dtypes differ: {q.dtype} {k_pool.dtype} {v_pool.dtype}"
        )
    hd = q.shape[-1]
    if (k_pool.shape != v_pool.shape or k_pool.shape[1] != q.shape[1]
            or k_pool.shape[3] != hd):
        raise ValueError(
            f"pool shape {tuple(k_pool.shape)} vs q {tuple(q.shape)}"
        )
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"{what} serves head_dim {KERNEL_HEAD_DIMS}, got {hd}"
        )
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError(f"{what} needs contiguous pools")


def _launch_paged(q, k_pool, v_pool, page_table, index, valid_from, split,
                  out, parts):
    _check_pools(q, k_pool, v_pool, "K3")
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
    o_p, m_p, l_p = parts if parts is not None else (None, None, None)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    err = _build.load("paged_attn").paged_attn(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
        idx.data_ptr(), ptr(vf), ptr(out), ptr(o_p), ptr(m_p), ptr(l_p), b,
        kvh, g, table.shape[1], k_pool.shape[2], hd, split,
        _build.dtype_code(q.dtype), 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "paged_attn")


def paged_attn(q, k_pool, v_pool, page_table, index, valid_from=None):
    """Launch K3 (one block per (slot, kv head)) on CUDA tensors."""
    q = q.contiguous()
    out = torch.empty_like(q)
    _launch_paged(q, k_pool, v_pool, page_table, index, valid_from, 1, out,
                  None)
    paged_attn.launches += 1
    return out


def paged_attn_split(q, k_pool, v_pool, page_table, index, valid_from=None,
                     split=2):
    """Launch K3-split (one block per (slot, kv head, split)) on CUDA
    tensors and combine its partials."""
    q = q.contiguous()
    b, kvh, g, hd = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    parts = (
        torch.empty((b * kvh, split, g, hd), **f32),
        torch.empty((b * kvh, split, g), **f32),
        torch.empty((b * kvh, split, g), **f32),
    )
    _launch_paged(q, k_pool, v_pool, page_table, index, valid_from, split,
                  None, parts)
    paged_attn_split.launches += 1
    return _combine_splits(*parts, q.dtype).reshape(b, kvh, g, hd)


def paged_chunk_attn(q, k_pool, v_pool, pages, pos0: int, chunk: int,
                     window: int | None = None):
    """Launch K4 (one block per (kv head, 64 folded query rows)) on CUDA
    tensors; ``pos0`` is the chunk's first position (a host int)."""
    _check_pools(q, k_pool, v_pool, "K4")
    _, kvh, gc, hd = q.shape
    if q.shape[0] != 1:
        raise ValueError(f"K4 takes one chunk (batch 1), got {q.shape[0]}")
    if gc % chunk:
        raise ValueError(f"{gc} folded rows are not a multiple of {chunk}")
    pages = torch.as_tensor(pages, device=q.device).to(torch.int32)
    pages = pages.reshape(-1).contiguous()
    q = q.contiguous()
    out = torch.empty_like(q)
    err = _build.load("paged_chunk_attn").paged_chunk_attn(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), pages.data_ptr(),
        out.data_ptr(), kvh, gc, chunk, pages.shape[0], k_pool.shape[2],
        int(pos0), int(window or 0), hd, _build.dtype_code(q.dtype),
        1.0 / math.sqrt(hd), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "paged_chunk_attn")
    paged_chunk_attn.launches += 1
    return out


#: Launches of K3 / K3-split / K4 (kernel calls only).
paged_attn.launches = 0
paged_attn_split.launches = 0
paged_chunk_attn.launches = 0


def _check_prefer(prefer, q):
    if prefer not in (None, "pallas", "xla"):
        raise ValueError(
            f"prefer={prefer!r}: expected None, 'pallas' or 'xla'"
        )
    if q.is_cuda and prefer == "xla":
        raise ValueError(
            "prefer='xla' selects the plain version, which CUDA tensors "
            "refuse: the card's paged path runs the K3/K4 kernels"
        )


def paged_chunk_attention(q, k_pool, v_pool, pages, pos0, chunk: int,
                          prefer=None, window: int | None = None):
    """Chunk-prefill attention over a paged window, in place: q (1, kv_h,
    g * chunk, hd) group-folded; ``pages`` (n,) covers the whole live
    window [0, pos0 + chunk) (pow2 padding to the trash page is fine —
    those positions are past every row's mask). K4 on CUDA, the plain
    version on CPU."""
    _reject_quantized(k_pool, v_pool)
    check_head_parity(q.shape[1], k_pool.shape[1])
    _check_prefer(prefer, q)
    if not q.is_cuda:
        return paged_chunk_attention_reference(
            q, k_pool, v_pool, pages, pos0, chunk, window
        )
    return paged_chunk_attn(q, k_pool, v_pool, pages, pos0, chunk, window)


def paged_attention(q, k_pool, v_pool, page_table, index, valid_from=None,
                    prefer=None, split=None):
    """Decode attention over a paged KV cache: K3 (``split`` 1 or None)
    or K3-split plus the rescale combine on CUDA, the plain version on
    CPU. ``prefer="xla"`` selects the plain version, which a CUDA tensor
    refuses."""
    _reject_quantized(k_pool, v_pool)
    check_head_parity(q.shape[1], k_pool.shape[1])
    _check_prefer(prefer, q)
    split = 1 if split is None else int(split)
    if split < 1:
        raise ValueError(f"split must be >= 1, got {split}")
    if not q.is_cuda:
        return paged_attention_plain(
            q, k_pool, v_pool, page_table, index, valid_from, split
        )
    if split == 1:
        return paged_attn(q, k_pool, v_pool, page_table, index, valid_from)
    return paged_attn_split(q, k_pool, v_pool, page_table, index,
                            valid_from, split)
