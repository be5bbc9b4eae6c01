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

Host page codecs (:func:`encode_page` / :func:`decode_page`, the host KV
tier's and the disaggregated wire's): numpy + zlib host code, no kernel,
whose payloads and meta are byte-equal to the JAX package's for every codec
and dtype. A bfloat16 page rides as its 16-bit patterns under the dtype
name ``"bfloat16"``; like ``ml_dtypes.bfloat16`` for numpy it is not a
floating dtype to the lossy codecs, which degrade to ``"lz"`` on it as on
integer arrays.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import zlib

import numpy as np
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


# -- host page codecs (the host KV tier and the disaggregated wire) ---------
#
# Codec contract: ``decode_page(encode_page(x, c))`` has x's shape and
# dtype; "raw" / "lz" are bit-exact (the warm tier's and the lossless
# wire's setting), "int8" / "int4" the per-vector absmax lattices of the
# quantized pools (one f32 scale per trailing-axis vector), "zfp" a
# zfp-style mantissa truncation (sign, exponent and the top mantissa bits
# kept, then lz over the zero-heavy tail). Lossy codecs apply to floating
# arrays only; on integer arrays (int8 value planes, prompt ids) and
# bfloat16 ones they degrade to "lz", as the JAX package's do.

PAGE_CODECS = ("raw", "lz", "int8", "int4", "zfp")
LOSSLESS_PAGE_CODECS = ("raw", "lz")
#: zfp-style truncation: f32 mantissa bits KEPT (of 23).
ZFP_KEEP_BITS = 10

#: The meta dtype name of a bfloat16 page (numpy's name for
#: ``ml_dtypes.bfloat16``); its bits ride as int16.
_BF16 = "bfloat16"


def _host_page(arr) -> tuple[np.ndarray, str]:
    """``arr`` (a numpy array or a tensor on any device) as a C-contiguous
    host numpy array and its dtype name."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu()
        if t.dtype == torch.bfloat16:
            return np.ascontiguousarray(t.view(torch.int16).numpy()), _BF16
        arr = t.numpy()
    a = np.ascontiguousarray(arr)
    return a, str(a.dtype)


def _page_tensor(a: np.ndarray, name: str) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # a view of the payload: own the bytes
        a = a.copy()
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if name == _BF16 else t


def _np_pack_int4(q):
    """numpy twin of :func:`pack_int4` (same nibble layout)."""
    q = q.astype(np.int32)
    lo, hi = q[..., 0::2] & 15, q[..., 1::2] & 15
    p = lo | (hi << 4)
    return np.where(p >= 128, p - 256, p).astype(np.int8)


def _np_unpack_int4(packed):
    """numpy twin of :func:`unpack_int4`."""
    p = packed.astype(np.int32)
    lo = ((p & 15) ^ 8) - 8
    hi = p >> 4
    return np.stack([lo, hi], axis=-1).reshape(
        p.shape[:-1] + (p.shape[-1] * 2,))


def encode_page(arr, codec: str) -> tuple[bytes, dict]:
    """Encode one host page (a numpy array or a tensor) for a tier
    boundary. Returns ``(payload, meta)``; ``meta`` holds the shape, the
    dtype name, the codec actually applied (a lossy request on a
    non-floating array records the "lz" it degraded to) and
    ``raw_nbytes``."""
    if codec not in PAGE_CODECS:
        raise ValueError(f"codec={codec!r}: expected one of {PAGE_CODECS}")
    arr, name = _host_page(arr)
    meta = {
        "shape": tuple(int(s) for s in arr.shape),
        "dtype": name,
        "codec": codec,
        "raw_nbytes": int(arr.nbytes),
    }
    if codec in ("int8", "int4", "zfp") and (
        name == _BF16 or not np.issubdtype(arr.dtype, np.floating)
        or (codec in ("int8", "int4") and arr.shape[-1] < 2)
    ):
        # Never perturb already-quantized or integer payloads; a (..., 1)
        # scale plane gains nothing from one more scale per element.
        codec = meta["codec"] = "lz"
    if codec == "raw":
        return arr.tobytes(), meta
    if codec == "lz":
        return zlib.compress(arr.tobytes(), 1), meta
    if codec == "zfp":
        u = arr.astype(np.float32).view(np.uint32)
        mask = np.uint32((0xFFFFFFFF << (23 - ZFP_KEEP_BITS)) & 0xFFFFFFFF)
        return zlib.compress((u & mask).tobytes(), 1), meta
    qmax = 127.0 if codec == "int8" else 7.0
    f = arr.astype(np.float32)
    scale = np.maximum(np.abs(f).max(axis=-1, keepdims=True) / qmax,
                       1e-8).astype(np.float32)
    q = np.clip(np.round(f / scale), -qmax, qmax)
    if codec == "int4":
        if arr.shape[-1] % 2:
            raise ValueError(
                f"int4 page codec needs an even trailing axis, got "
                f"{arr.shape[-1]}")
        vals = _np_pack_int4(q)
    else:
        vals = q.astype(np.int8)
    return scale.tobytes() + vals.tobytes(), meta


def decode_page(payload, meta: dict) -> torch.Tensor:
    """Inverse of :func:`encode_page`: a CPU tensor of the original shape
    and dtype. Bit-exact for raw / lz; the lossy codecs return the
    dequantized or truncated values cast back."""
    shape = tuple(meta["shape"])
    name = meta["dtype"]
    codec = meta["codec"]
    buf = bytes(payload)
    dtype = np.int16 if name == _BF16 else np.dtype(name)
    if codec == "raw":
        return _page_tensor(np.frombuffer(buf, dtype).reshape(shape), name)
    if codec == "lz":
        return _page_tensor(
            np.frombuffer(zlib.decompress(buf), dtype).reshape(shape), name)
    if codec == "zfp":
        u = np.frombuffer(zlib.decompress(buf), np.uint32).reshape(shape)
        return _page_tensor(u.view(np.float32).astype(dtype), name)
    n_vec = math.prod(shape[:-1])
    scale = np.frombuffer(buf[: n_vec * 4], np.float32).reshape(
        shape[:-1] + (1,))
    if codec == "int4":
        q = _np_unpack_int4(np.frombuffer(buf[n_vec * 4:], np.int8).reshape(
            shape[:-1] + (shape[-1] // 2,)))
    else:
        q = np.frombuffer(buf[n_vec * 4:], np.int8).reshape(shape)
    return _page_tensor((q.astype(np.float32) * scale).astype(dtype), name)


def page_codec_roundtrip(arr, codec: str) -> torch.Tensor:
    """``decode_page(encode_page(arr, codec))``."""
    return decode_page(*encode_page(arr, codec))
