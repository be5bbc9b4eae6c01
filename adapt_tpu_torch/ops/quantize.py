"""Quantization: the per-vector KV-cache scheme and the blockwise int8
tensor codec (kernels K6, ``csrc/quantize_blocks.cu`` and
``csrc/dequantize_blocks.cu``) — the port of ``adapt_tpu/ops/quantize.py``'s
``pack_int4``, ``unpack_int4``, ``quantize_kv_vectors``, ``quantize`` /
``dequantize`` (with their ``*_reference`` plain versions) and
``quantize_params`` / ``dequantize_params``.

KV caches: one f32 absmax scale per cached key/value vector.

The op order is the JAX package's (f32 absmax / qmax, clamped at 1e-8,
then ``round(t / scale)`` clipped to ``±qmax``; ``torch.round`` rounds half
to even like ``jnp.round``), so the values and scales are bit-equal to
JAX's on the same f32 input. int8 keeps one value per int8 lane; int4
quantizes to the 15-level [-7, 7] lattice and packs two nibbles per int8
lane (element ``2i`` in the low nibble of byte ``i``, ``2i + 1`` in the
high one). The attention kernels consume these bytes directly
(``csrc/common.cuh``'s cache-element policies); nothing here dequantizes a
cache for them.

Blockwise int8 (the speculative draft's resident weights): the tensor is
flattened, viewed as ``(rows, 128)`` and cut into blocks of ``64 * 128``
elements (the tail zero-padded); each block gets one f32 scale
``max(absmax, 1e-12) / 127`` and its values are ``clip(round(x / scale),
-127, 127)``. A CUDA tensor launches K6, a CPU tensor runs the plain
version; both are bit-equal to the JAX package's on the same input (a true
division, round half to even, one rounding into the target dtype on the way
back), non-finite input included (a NaN block scale, an Inf one, 0 for a
NaN quotient). ``dequantize_params`` dequantizes a whole weight tree in one
launch per 32 leaves (:func:`dequantize_plan`). The kernels read and write
16-byte vectors and their entry points (``quantize_blocks``,
``dequantize_blocks``) refuse a base that is not 16-byte aligned; the
public ``quantize`` / ``dequantize`` / ``dequantize_params`` take any view,
copying such an operand to an aligned buffer first (:func:`aligned16`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from adapt_tpu_torch.ops import _build

LANES = 128
BLOCK_ROWS = 64  # one scale per 64 * 128 = 8192 elements
BLOCK = BLOCK_ROWS * LANES

KV_DTYPES = ("int8", "int4")


def pack_int4(q):
    """Pack an even-width trailing axis of ints in [-8, 7] into int8
    bytes, two nibbles per byte; returns ``(..., w // 2)`` int8."""
    q = q.to(torch.int32)
    lo, hi = q[..., 0::2], q[..., 1::2]
    p = (lo & 15) | ((hi & 15) << 4)
    # Two's-complement wrap before the int8 cast: the byte pattern is what
    # matters, not its signed value.
    return torch.where(p >= 128, p - 256, p).to(torch.int8)


def unpack_int4(packed):
    """Inverse of :func:`pack_int4`: ``(..., w)`` int8 bytes -> ``(...,
    2w)`` int32 nibble values in [-8, 7], in element order."""
    p = packed.to(torch.int32)
    lo = ((p & 15) ^ 8) - 8  # sign-extend the low nibble
    hi = p >> 4  # the arithmetic shift sign-extends the high nibble
    return torch.stack([lo, hi], dim=-1).reshape(
        *p.shape[:-1], p.shape[-1] * 2
    )


def quantize_kv_vectors(t, dtype: str = "int8"):
    """Per-vector absmax quantization over the trailing (head_dim) axis:
    returns ``(values, scales)`` with scales ``(..., 1)`` f32. ``"int8"``
    values are int8 of the same width; ``"int4"`` values are packed,
    ``head_dim // 2`` wide (an odd head_dim raises)."""
    if dtype not in KV_DTYPES:
        raise ValueError(f"dtype={dtype!r}: expected 'int8' or 'int4'")
    qmax = 127.0 if dtype == "int8" else 7.0
    tf = t.to(torch.float32)
    scale = torch.amax(torch.abs(tf), dim=-1, keepdim=True) / qmax
    scale = torch.clamp(scale, min=1e-8)
    vals = torch.round(tf / scale).clamp(-qmax, qmax)
    if dtype == "int4":
        if t.shape[-1] % 2:
            raise ValueError(
                f"int4 KV packing needs an even head_dim, got {t.shape[-1]}"
            )
        return pack_int4(vals), scale
    return vals.to(torch.int8), scale


def kv_values(cache, head_dim: int):
    """The integer values of a quantized cache member as int32 in element
    order: packed int4 (``head_dim // 2`` wide) is unpacked, int8 widened."""
    if cache.shape[-1] * 2 == head_dim:
        return unpack_int4(cache)
    return cache.to(torch.int32)


# -- blockwise int8 (K6) -----------------------------------------------------


@dataclasses.dataclass
class QuantizedTensor:
    """int8 payload + per-block scales + logical shape / dtype."""

    values: torch.Tensor  # (rows, 128) int8, padded to whole blocks
    scales: torch.Tensor  # (num_blocks, 1) f32
    shape: tuple[int, ...]
    dtype: torch.dtype

    @property
    def nbytes_payload(self) -> int:
        return self.values.numel() + self.scales.numel() * 4


def _num_blocks(n: int) -> int:
    return -(-n // BLOCK)


def quantize_reference(x) -> QuantizedTensor:
    """The plain version of K6-quantize (``adapt_tpu.ops.quantize.
    quantize_reference``). Non-finite input follows the JAX package: a
    block holding a NaN gets a NaN scale, one holding ±Inf (and no NaN) an
    Inf scale, and an element whose quotient is NaN stores 0."""
    flat = x.to(torch.float32).reshape(-1)
    nb = _num_blocks(flat.numel())
    flat = torch.nn.functional.pad(flat, (0, nb * BLOCK - flat.numel()))
    blocks = flat.reshape(nb, BLOCK)
    amax = torch.amax(torch.abs(blocks), dim=1, keepdim=True)
    # Divide by a TENSOR 127: by a Python scalar, the CUDA division kernel
    # multiplies by the reciprocal, which is not the true division the
    # scheme defines (the results differ in the last bit).
    scales = torch.clamp(amax, min=1e-12) / torch.full_like(amax, 127.0)
    q = torch.round(blocks / scales).clamp(-127.0, 127.0)
    # A NaN -> int8 cast is undefined; XLA and PyTorch's CPU give 0, and
    # nothing promises that on CUDA, so NaN becomes 0 here.
    q = torch.nan_to_num(q, nan=0.0).to(torch.int8)
    return QuantizedTensor(q.reshape(-1, LANES), scales, tuple(x.shape),
                           x.dtype)


def dequantize_reference(qt: QuantizedTensor):
    """The plain version of K6-dequantize: ``int8 * scale`` in f32, cut to
    the logical size, cast to the logical dtype."""
    nb = qt.scales.shape[0]
    blocks = qt.values.reshape(nb, BLOCK).to(torch.float32)
    out = (blocks * qt.scales).reshape(-1)
    return out[: math.prod(qt.shape)].reshape(qt.shape).to(qt.dtype)


#: K6-dequantize's work split (``csrc/dequantize_blocks.cu`` holds the same
#: constants): a thread reads VEC int8 values with one 16-byte load, a CTA
#: of DEQ_THREADS threads dequantizes one CHUNK of one leaf (two vectors a
#: thread), and one launch takes a table of at most MAX_LEAVES leaves.
VEC = 16
DEQ_THREADS = 128
CHUNK = DEQ_THREADS * VEC * 2
MAX_LEAVES = 32


def dequantize_plan(sizes):
    """The grouped K6-dequantize launches for leaves of ``sizes`` elements,
    in order: ``[(leaf indices, chunk prefix sums)]``, one entry a launch.
    Leaf ``i`` takes ``ceil(sizes[i] / CHUNK)`` chunks (so a chunk never
    straddles two leaves) and a launch at most MAX_LEAVES leaves; CTA ``c``
    of a launch works on the leaf ``j`` with ``first[j] <= c < first[j +
    1]``. Empty leaves take no chunk and no place in a table."""
    live = [i for i, n in enumerate(sizes) if n > 0]
    plan = []
    for k in range(0, len(live), MAX_LEAVES):
        idx = live[k:k + MAX_LEAVES]
        first = [0]
        for i in idx:
            first.append(first[-1] + -(-sizes[i] // CHUNK))
        plan.append((idx, first))
    return plan


def aligned16(t):
    """``t`` itself when its storage starts on a 16-byte boundary, which
    the kernels' 16-byte vector and ``cp.async`` copies need, else an
    aligned contiguous copy."""
    if t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _aligned(t, what):
    if t.data_ptr() % 16:
        raise ValueError(f"K6 reads and writes {what} in 16-byte vectors: "
                         f"its base must be 16-byte aligned (storage offset "
                         f"{t.storage_offset()})")
    return t


def quantize_blocks(x) -> QuantizedTensor:
    """Launch K6-quantize on a CUDA tensor (f32 / bf16 / f16): a cluster of
    4 CTAs per 8192-element quantization block, the input read in its own
    dtype with 16-byte loads (its base 16-byte aligned) and the ragged
    tail zero-padded in the kernel."""
    if not x.is_cuda:
        raise ValueError("K6 launches on CUDA tensors only")
    x = _aligned(x.contiguous(), "the input")
    n = x.numel()
    nb = _num_blocks(n)
    vals = torch.empty((nb * BLOCK_ROWS, LANES), dtype=torch.int8,
                       device=x.device)
    scales = torch.empty((nb, 1), dtype=torch.float32, device=x.device)
    if nb:
        err = _build.load("quantize_blocks").quantize_blocks(
            x.data_ptr(), vals.data_ptr(), scales.data_ptr(), n, nb,
            _build.dtype_code(x.dtype),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        _build.check(err, "quantize_blocks")
        quantize_blocks.launches += 1
        _build.record_kernel_dispatch("quantize", "pallas")
    return QuantizedTensor(vals, scales, tuple(x.shape), x.dtype)


def _dequantize_launch(qts, outs, first):
    """One K6-dequantize launch over the table ``qts`` (CUDA payloads on
    one device, none empty) writing ``outs``; ``first`` is the table's
    chunk prefix sums from :func:`dequantize_plan`. The table reaches the
    kernel as a by-value parameter: nothing is copied host -> device."""
    k = len(qts)
    vals, scales = [], []
    for qt in qts:
        n = math.prod(qt.shape)
        v, s = qt.values.contiguous(), qt.scales.contiguous()
        if v.numel() < _num_blocks(n) * BLOCK or s.numel() != _num_blocks(n):
            raise ValueError(
                f"payload {tuple(v.shape)} / {tuple(s.shape)} does not "
                f"cover shape {qt.shape} in whole blocks")
        vals.append(_aligned(v, "the int8 values"))
        scales.append(s)
    ptrs = ctypes.c_void_p * k
    err = _build.load("dequantize_blocks").dequantize_blocks(
        ptrs(*[v.data_ptr() for v in vals]),
        ptrs(*[s.data_ptr() for s in scales]),
        ptrs(*[_aligned(o, "the output").data_ptr() for o in outs]),
        (ctypes.c_longlong * k)(*[o.numel() for o in outs]),
        (ctypes.c_int * k)(*[_build.dtype_code(o.dtype) for o in outs]),
        (ctypes.c_int * (k + 1))(*first), k,
        torch.cuda.current_stream(outs[0].device).cuda_stream,
    )
    _build.check(err, "dequantize_blocks")
    dequantize_blocks.launches += 1
    _build.record_kernel_dispatch("dequantize", "pallas")


def _dequantize_grouped(qts):
    """Dequantize CUDA payloads of one device: one launch per table of
    :func:`dequantize_plan`; returns the logical-dtype tensors in order."""
    outs = [torch.empty(qt.shape, dtype=qt.dtype, device=qt.values.device)
            for qt in qts]
    for idx, first in dequantize_plan([o.numel() for o in outs]):
        _dequantize_launch([qts[i] for i in idx], [outs[i] for i in idx],
                           first)
    return outs


def dequantize_blocks(qt: QuantizedTensor):
    """Launch K6-dequantize on a CUDA payload (a one-leaf table): writes
    the logical-size tensor directly in the logical dtype."""
    if not (qt.values.is_cuda and qt.scales.is_cuda):
        raise ValueError("K6 launches on CUDA tensors only")
    return _dequantize_grouped([qt])[0]


#: Launches of K6-quantize / K6-dequantize (kernel calls only).
quantize_blocks.launches = 0
dequantize_blocks.launches = 0


def _aligned_payload(qt: QuantizedTensor) -> QuantizedTensor:
    """``qt`` with its int8 values contiguous at a 16-byte-aligned base
    (copied only when they are not)."""
    v = aligned16(qt.values.contiguous())
    return qt if v is qt.values else dataclasses.replace(qt, values=v)


def quantize(x) -> QuantizedTensor:
    """Blockwise int8-quantize a tensor of any shape, any view included:
    K6 on CUDA (an input whose base is not 16-byte aligned is copied to
    one that is first), the plain version on CPU."""
    if x.is_cuda:
        return quantize_blocks(aligned16(x.contiguous()))
    _build.record_kernel_dispatch("quantize", "xla")
    return quantize_reference(x)


def dequantize(qt: QuantizedTensor):
    """Inverse of :func:`quantize`: K6 on CUDA (int8 values whose base is
    not 16-byte aligned are copied to one that is first), the plain
    version on CPU."""
    if qt.values.is_cuda:
        return dequantize_blocks(_aligned_payload(qt))
    _build.record_kernel_dispatch("dequantize", "xla")
    return dequantize_reference(qt)


def quantize_params(tree):
    """int8-quantize every float MATRIX leaf (``ndim >= 2``) of a nested
    dict of tensors (a ``state_dict``) into :class:`QuantizedTensor`; 1-D
    leaves — biases, LayerNorm scales — stay native."""
    if isinstance(tree, dict):
        return {k: quantize_params(v) for k, v in tree.items()}
    if torch.is_tensor(tree) and tree.ndim >= 2 and tree.is_floating_point():
        return quantize(tree.detach())
    return tree


def _quantized_leaves(tree, found):
    if isinstance(tree, dict):
        for v in tree.values():
            _quantized_leaves(v, found)
    elif isinstance(tree, QuantizedTensor):
        found.append(tree)
    return found


def _replace_leaves(tree, it):
    if isinstance(tree, dict):
        return {k: _replace_leaves(v, it) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return next(it)
    return tree


def dequantize_params(tree):
    """Inverse of :func:`quantize_params`: every :class:`QuantizedTensor`
    leaf dequantized, everything else passed through. Called inside each
    draft scan and draft prefill, so the float weights live only for that
    call. The CUDA leaves of a device go to K6 together, in tree order:
    one launch per MAX_LEAVES of them (a 2-layer GPT-2 draft's 11 matrices
    are one launch); CPU leaves take the plain version."""
    qts = _quantized_leaves(tree, [])
    outs = [None] * len(qts)
    by_dev = {}
    for i, qt in enumerate(qts):
        if qt.values.is_cuda:
            by_dev.setdefault(qt.values.device, []).append(i)
        else:
            _build.record_kernel_dispatch("dequantize", "xla")
            outs[i] = dequantize_reference(qt)
    for idx in by_dev.values():
        for i, out in zip(idx, _dequantize_grouped(
                [_aligned_payload(qts[i]) for i in idx])):
            outs[i] = out
    return _replace_leaves(tree, iter(outs))
