"""KV-cache quantization: one f32 absmax scale per cached key/value vector
— the port of ``adapt_tpu/ops/quantize.py``'s ``pack_int4``,
``unpack_int4`` and ``quantize_kv_vectors``.

The op order is the JAX package's (f32 absmax / qmax, clamped at 1e-8,
then ``round(t / scale)`` clipped to ``±qmax``; ``torch.round`` rounds half
to even like ``jnp.round``), so the values and scales are bit-equal to
JAX's on the same f32 input. int8 keeps one value per int8 lane; int4
quantizes to the 15-level [-7, 7] lattice and packs two nibbles per int8
lane (element ``2i`` in the low nibble of byte ``i``, ``2i + 1`` in the
high one). The attention kernels consume these bytes directly
(``csrc/decode_tile.cuh``'s cache-element policies); nothing here
dequantizes a cache for them.
"""

from __future__ import annotations

import torch

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
