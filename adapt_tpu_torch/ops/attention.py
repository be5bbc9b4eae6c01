"""Flash attention: the forward kernel K1 (``csrc/flash_attn_fwd.cu``), the
streaming backward K7 (``csrc/flash_attn_bwd.cu``) and their plain
PyTorch versions.

Counterpart of ``adapt_tpu/ops/attention.py``. Layouts stay the JAX
package's: q, k, v are ``(batch, heads, seq, head_dim)``; the logsumexp is
``(batch, heads, s_q)`` f32. Dispatch is by device, not by a measured
budget: a CUDA tensor launches K1 (``flash_attn_fwd``), a CPU tensor runs
:func:`attention_reference` / :func:`_reference_with_lse`, the JAX
oracle's op order with the same finite ``-1e30`` sentinel.

Gradients: when grad is enabled and q, k or v requires it,
:func:`flash_attention` runs through an ``autograd.Function`` (the JAX
package's custom VJP): its forward saves ``(q, k, v, out, lse)`` from K1
(CUDA) or ``_reference_with_lse`` (CPU), its backward runs K7
(``flash_attn_bwd``) on CUDA or :func:`flash_attention_bwd_plain` on the
CPU. A call without grad keeps the forward-only path above.
:func:`flash_attention_with_lse` (and so ``causal_shift``) is forward-only,
as in the JAX package, and raises under grad.

Fully padded query rows (position < ``valid_from``) have unspecified
contents in both versions, as in the JAX package: compare valid rows.
"""

from __future__ import annotations

import ctypes
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
    return _mask(s, causal, valid_from, causal_shift, window)


def _mask(s, causal, valid_from, causal_shift, window):
    """The masks of K1 / K7 on a ``(b, h, s_q, s_k)`` f32 score tensor."""
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


def _operand(t):
    """``t`` as K1 / K7 read it. A 16-bit view whose last dim is contiguous
    and whose rows start on 16-byte boundaries passes as it is (the
    kernels address rows through its batch / head / row strides: the
    transposed q / k / v views of a qkv projection cost no copy); any other
    16-bit tensor, and every f32 one (the CUDA-core path), is copied
    contiguous first."""
    if t.dtype != torch.float32 and _aligned(t):
        return t
    t = t.contiguous()
    return t if _aligned(t) else t.clone()


def _aligned(t) -> bool:
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % 8 == 0 or n == 1
                    for st, n in zip(t.stride()[:-1], t.shape[:-1])))


def _strides(*ts):
    """The batch / head / row element strides of each ``(b, h, s, d)``
    operand, as the C entry points take them (host memory)."""
    vals = [st for t in ts for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def flash_attn_fwd(
    q, k, v, causal=False, valid_from=None, causal_shift=None, window=None
):
    """Launch K1 on CUDA tensors; returns ``(out, lse)``, both contiguous.
    Raises on any shape, dtype or device it does not take, and on a failed
    launch."""
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
    q, k, v = _operand(q), _operand(k), _operand(v)
    out = torch.empty((b, h, s_q, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    vf = None
    if valid_from is not None:
        vf = torch.as_tensor(valid_from, device=q.device).to(torch.int32)
        vf = vf.reshape(b).contiguous()
    shift = None
    if causal_shift is not None:
        shift = torch.as_tensor(causal_shift, device=q.device)
        shift = shift.to(torch.int32).reshape(1).contiguous()
    strides = _strides(q, k, v)
    lib = _build.load("flash_attn_fwd")
    err = lib.flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), vf.data_ptr() if vf is not None else None,
        shift.data_ptr() if shift is not None else None,
        ctypes.addressof(strides),
        b, h, s_q, s_k, d, _build.dtype_code(q.dtype), int(bool(causal)),
        int(window or 0), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_attn_fwd")
    flash_attn_fwd.launches += 1
    return out, lse


#: Launches of K1 (kernel calls only; the plain version never counts).
flash_attn_fwd.launches = 0


def flash_attention_bwd_plain(q, k, v, out, lse, do, causal=False,
                              valid_from=None, window=None):
    """Plain version of K7: ``(dq, dk, dv)`` of ``out = attention(q, k, v)``
    given the forward's ``out`` and ``lse`` and the cotangent ``do``,
    materialized in f32 in the op order of the JAX kernels
    (``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``): ``p = exp(s - lse)``,
    ``dp = do v^T``, ``ds = p (dp - delta) sm_scale``, ``dq = ds k``,
    ``dk = ds^T q``, ``dv = p^T do`` with ``delta = rowsum(do * out)``.
    Each gradient comes back in its input's dtype."""
    sm_scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    lse = lse.float()
    if valid_from is not None:
        # A fully padded row saved lse ~= -1e30, so exp(s - lse) would be
        # exp(0) = 1 on its masked scores; clamped at -1e20 they stay 0
        # (``_flash_bwd_impl`` :856-862).
        lse = torch.clamp(lse, min=-1e20)
    delta = torch.sum(dof * out.float(), dim=-1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * sm_scale
    s = _mask(s, causal, valid_from, None, window)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * sm_scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attn_bwd(q, k, v, out, lse, do, causal=False, valid_from=None,
                   window=None):
    """Launch K7 on CUDA tensors: ``(dq, dk, dv)`` in the inputs' dtype,
    contiguous. 16-bit operands are read through their strides (see
    :func:`_operand`). One call runs both passes (dQ, whose prologue
    writes ``delta``, then dK/dV) and counts one launch. Raises on any
    shape, dtype or device it does not take, and on a failed launch."""
    if not all(t.is_cuda for t in (q, k, v, out, lse, do)):
        raise ValueError("flash_attn_bwd launches on CUDA tensors only")
    if not q.dtype == k.dtype == v.dtype == out.dtype == do.dtype:
        raise ValueError(
            f"q/k/v/out/do dtypes differ: "
            f"{[str(t.dtype) for t in (q, k, v, out, do)]}")
    b, h, s_q, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)} vs q {tuple(q.shape)}")
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"out/do shapes {tuple(out.shape)} "
                         f"{tuple(do.shape)} vs q {tuple(q.shape)}")
    if lse.shape != (b, h, s_q) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({b}, {h}, {s_q}) f32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"K7 serves head_dim {KERNEL_HEAD_DIMS}, got {d}")
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    s_k = k.shape[2]
    q, k, v, out, do = (_operand(t) for t in (q, k, v, out, do))
    lse = lse.contiguous()
    dq = torch.empty((b, h, s_q, d), dtype=q.dtype, device=q.device)
    dk, dv = (torch.empty((b, h, s_k, d), dtype=q.dtype, device=q.device)
              for _ in range(2))
    delta = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    vf = None
    if valid_from is not None:
        vf = torch.as_tensor(valid_from, device=q.device).to(torch.int32)
        vf = vf.reshape(b).contiguous()
    strides = _strides(q, k, v, out, do)
    lib = _build.load("flash_attn_bwd")
    err = lib.flash_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(),
        vf.data_ptr() if vf is not None else None, ctypes.addressof(strides),
        b, h, s_q, s_k, d, _build.dtype_code(q.dtype), int(bool(causal)),
        int(window or 0), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_attn_bwd")
    flash_attn_bwd.launches += 1
    return dq, dk, dv


#: Calls of K7 (each runs both passes; the plain version never counts).
flash_attn_bwd.launches = 0


def _check_args(q, prefer, causal, window, causal_shift):
    if prefer not in (None, "pallas", "xla"):
        raise ValueError(
            f"prefer={prefer!r}: expected None, 'pallas' or 'xla'"
        )
    if window is not None and (not causal or causal_shift is not None):
        raise ValueError("window requires causal=True without causal_shift")
    if causal_shift is not None and not causal:
        raise ValueError("causal_shift requires causal=True")
    if q.is_cuda and prefer == "xla":
        raise ValueError(
            "prefer='xla' selects the plain version, which CUDA tensors "
            "refuse: the card's path runs the K1 kernel"
        )


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class _FlashAttention(torch.autograd.Function):
    """The custom VJP of ``_flash_vjp`` / ``_flash_ragged_vjp``: K1 + K7 on
    CUDA, ``_reference_with_lse`` + :func:`flash_attention_bwd_plain` on
    the CPU. ``valid_from`` is an integer operand with no cotangent."""

    @staticmethod
    def forward(ctx, q, k, v, valid_from, causal, window):
        if q.is_cuda:
            out, lse = flash_attn_fwd(q, k, v, causal, valid_from, None,
                                      window)
        else:
            out, lse = _reference_with_lse(q, k, v, causal, valid_from, None,
                                           window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.valid_from, ctx.causal, ctx.window = valid_from, causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = flash_attn_bwd if q.is_cuda else flash_attention_bwd_plain
        dq, dk, dv = bwd(q, k, v, out, lse, do.to(q.dtype), ctx.causal,
                         ctx.valid_from, ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention(
    q, k, v, causal=False, block_q=None, block_k=None, prefer=None,
    valid_from=None, window=None,
):
    """Fused attention over ``(b, h, s, d)`` tensors: K1 on CUDA, the plain
    :func:`attention_reference` on CPU; differentiable (K7 backward on
    CUDA, :func:`flash_attention_bwd_plain` on CPU) when grad is enabled
    and an input requires it. ``block_q``/``block_k`` are accepted for
    signature parity and ignored: the kernels pick their own tiles."""
    del block_q, block_k
    _check_args(q, prefer, causal, window, None)
    if _wants_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, valid_from, causal, window)
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
    shift). Forward-only, as in the JAX package: it raises under grad
    (use :func:`flash_attention` for training paths)."""
    del block_q, block_k
    _check_args(q, None, causal, None, causal_shift)
    if _wants_grad(q, k, v):
        raise NotImplementedError(
            "flash_attention_with_lse is forward-only (no VJP for the lse "
            "output or causal_shift): use flash_attention for gradients"
        )
    if not q.is_cuda:
        return _reference_with_lse(q, k, v, causal, None, causal_shift)
    return flash_attn_fwd(q, k, v, causal, None, causal_shift, None)
