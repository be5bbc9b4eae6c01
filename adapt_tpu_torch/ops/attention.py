"""Forward flash attention: kernel K1 (``csrc/flash_attn_fwd.cu``) and its
plain PyTorch version.

Counterpart of ``adapt_tpu/ops/attention.py``. Layouts stay the JAX
package's: q, k, v are ``(batch, heads, seq, head_dim)``; the logsumexp is
``(batch, heads, s_q)`` f32. Dispatch is by device, not by a measured
budget: a CUDA tensor launches K1 (``flash_attn_fwd``), a CPU tensor runs
:func:`attention_reference` / :func:`_reference_with_lse`, the JAX
oracle's op order with the same finite ``-1e30`` sentinel. Forward only:
a CUDA call that needs a gradient raises until the streaming backward (K7)
is ported.

Fully padded query rows (position < ``valid_from``) have unspecified
contents in both versions, as in the JAX package: compare valid rows.
"""

from __future__ import annotations

import math

import torch

from adapt_tpu_torch.ops import _build

_NEG_INF = -1e30

#: Head dims K1 is instantiated for.
KERNEL_HEAD_DIMS = (64, 128)


def _causal_mask(s_q, s_k, causal_shift=None, device=None):
    """The oracle causal mask (row i attends cols <= i - shift)."""
    rows = torch.arange(s_q, device=device)[:, None]
    cols = torch.arange(s_k, device=device)[None, :]
    if causal_shift is not None:
        return rows >= cols + causal_shift
    return rows >= cols


def _masked_scores(q, k, causal, valid_from, causal_shift, window):
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    s_q, s_k = s.shape[-2:]
    dev = s.device
    if causal:
        s = torch.where(
            _causal_mask(s_q, s_k, causal_shift, dev), s, _NEG_INF
        )
    if window is not None:
        band = (
            torch.arange(s_k, device=dev)[None, :]
            > torch.arange(s_q, device=dev)[:, None] - window
        )
        s = torch.where(band[None, None], s, _NEG_INF)
    if valid_from is not None:
        cols = torch.arange(s_k, device=dev)
        vf = torch.as_tensor(valid_from, device=dev)
        live = cols[None, :] >= vf[:, None]  # (b, s_k)
        s = torch.where(live[:, None, None, :], s, _NEG_INF)
    return s


def attention_reference(
    q, k, v, causal=False, valid_from=None, causal_shift=None, window=None
):
    """Plain oracle: softmax(QK^T / sqrt(d)) V with the masks of K1
    (top-left aligned causal, optional diagonal shift, sliding ``window``
    band, per-row ``valid_from`` left padding), in f32, cast to q's
    dtype."""
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    s = _masked_scores(q, k, causal, valid_from, causal_shift, window)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _reference_with_lse(
    q, k, v, causal, valid_from=None, causal_shift=None, window=None
):
    """Oracle ``(out, lse)`` computing the score matrix once."""
    s = _masked_scores(q, k, causal, valid_from, causal_shift, window)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    return out, lse


def flash_attn_fwd(
    q, k, v, causal=False, valid_from=None, causal_shift=None, window=None
):
    """Launch K1 on CUDA tensors; returns ``(out, lse)``. Raises on any
    shape, dtype or device it does not take, and on a failed launch."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attn_fwd launches on CUDA tensors only")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q/k/v dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    b, h, s_q, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)} vs q {tuple(q.shape)}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"K1 serves head_dim {KERNEL_HEAD_DIMS}, got {d}")
    s_k = k.shape[2]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    vf = None
    if valid_from is not None:
        vf = torch.as_tensor(valid_from, device=q.device).to(torch.int32)
        vf = vf.reshape(b).contiguous()
    shift = None
    if causal_shift is not None:
        shift = torch.as_tensor(causal_shift, device=q.device)
        shift = shift.to(torch.int32).reshape(1).contiguous()
    lib = _build.load("flash_attn_fwd")
    err = lib.flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), vf.data_ptr() if vf is not None else None,
        shift.data_ptr() if shift is not None else None,
        b, h, s_q, s_k, d, _build.dtype_code(q.dtype), int(bool(causal)),
        int(window or 0), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_attn_fwd")
    flash_attn_fwd.launches += 1
    return out, lse


#: Launches of K1 (kernel calls only; the plain version never counts).
flash_attn_fwd.launches = 0


def _check_args(q, prefer, causal, window, causal_shift):
    if prefer not in (None, "pallas", "xla"):
        raise ValueError(
            f"prefer={prefer!r}: expected None, 'pallas' or 'xla'"
        )
    if window is not None and (not causal or causal_shift is not None):
        raise ValueError("window requires causal=True without causal_shift")
    if causal_shift is not None and not causal:
        raise ValueError("causal_shift requires causal=True")
    if q.is_cuda:
        if prefer == "xla":
            raise ValueError(
                "prefer='xla' selects the plain version, which CUDA tensors "
                "refuse: the card's path runs the K1 kernel"
            )
        if torch.is_grad_enabled() and q.requires_grad:
            raise NotImplementedError(
                "flash attention backward (K7, ops/attention.py:"
                "_bwd_dq_kernel/_bwd_dkv_kernel) is not ported yet"
            )


def flash_attention(
    q, k, v, causal=False, block_q=None, block_k=None, prefer=None,
    valid_from=None, window=None,
):
    """Fused attention over ``(b, h, s, d)`` tensors: K1 on CUDA, the plain
    :func:`attention_reference` on CPU. ``block_q``/``block_k`` are
    accepted for signature parity and ignored: K1 picks its own tiles."""
    del block_q, block_k
    _check_args(q, prefer, causal, window, None)
    if not q.is_cuda:
        return attention_reference(
            q, k, v, causal=causal, valid_from=valid_from, window=window
        )
    return flash_attn_fwd(q, k, v, causal, valid_from, None, window)[0]


def flash_attention_with_lse(
    q, k, v, causal=False, block_q=None, block_k=None, causal_shift=None,
):
    """``(out, lse)`` with the per-row logsumexp of the scaled scores,
    ``(b, h, s_q)`` f32 — the merge residual ring attention builds on.
    ``causal_shift`` offsets the diagonal (row i attends cols <= i -
    shift)."""
    del block_q, block_k
    _check_args(q, None, causal, None, causal_shift)
    if not q.is_cuda:
        return _reference_with_lse(q, k, v, causal, None, causal_shift)
    return flash_attn_fwd(q, k, v, causal, None, causal_shift, None)
