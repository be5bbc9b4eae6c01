"""Tensor codecs for the hops that cross a process boundary.

Counterpart of ``adapt_tpu/comm/codec.py``. Frames are self-describing
(``pack``: a 4-byte length, a JSON header naming the codec with the
tensor's shape and dtype, then the payload) and byte-identical to the JAX
package's for the same array, so either package unpacks the other's.

- ``none``:  the raw bytes, dtype kept.
- ``bf16``:  f32 -> bfloat16 by round to nearest even (2x smaller). The
             rounding is done here on the f32 words (:func:`to_bf16_bits`),
             bit-equal to ``ml_dtypes`` on NaN, +-Inf, subnormals and ties,
             and the ``"bfloat16"`` wire dtype maps to ``torch.bfloat16``.
- ``int8``:  per-tensor absmax int8 (4x smaller than f32).
- ``zfp``:   int16 fixed-tolerance quantization + the native LZ77 codec.
- ``lz``:    lossless native LZ77 over the raw bytes; the weights codec.
- ``int8dev``: blockwise int8 on the sender's device (K6 quantize,
             ``ops/quantize.quantize``) before the host fetch, so the
             device -> host copy is 4x smaller too; the receiver
             dequantizes on its own device (K6 dequantize). On CPU tensors
             the plain versions run.

The host codecs run on numpy: a CUDA tensor is fetched once (``.cpu()``)
and encoded there. Decoding returns a torch tensor: on the CPU for the
host codecs (``none`` and ``lz`` viewing the receive buffer where they
can), on ``device`` for ``int8dev``.

Zero-copy framing: ``encode_view(x) -> (parts, meta)`` hands out views of
the array the codec produced, ``pack_frames`` returns ``[header,
*payload views]`` for a scatter write, ``pack`` assembles one buffer (one
payload copy) and ``pack_into`` reuses a caller's. Payload copies made by
the framing layer are counted (:func:`copy_stats`).
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass
from typing import Protocol

import numpy as np
import torch

from adapt_tpu_torch.comm import native
from adapt_tpu_torch.utils.metrics import global_metrics

# -- framing-copy accounting -------------------------------------------------

_COPY_BYTES = 0
_COPY_CALLS = 0
#: pack / unpack run on several threads at once (hop threads, proxies).
_COPY_LOCK = threading.Lock()


def _count_copy(nbytes: int) -> None:
    global _COPY_BYTES, _COPY_CALLS
    with _COPY_LOCK:
        _COPY_BYTES += int(nbytes)
        _COPY_CALLS += 1


def copy_stats() -> dict:
    """Framing-layer payload copies since the last reset."""
    with _COPY_LOCK:
        return {"bytes": _COPY_BYTES, "calls": _COPY_CALLS}


def reset_copy_stats() -> None:
    global _COPY_BYTES, _COPY_CALLS
    with _COPY_LOCK:
        _COPY_BYTES = 0
        _COPY_CALLS = 0


def _copy_stats_collector(registry) -> None:
    s = copy_stats()
    registry.set_gauge("codec.copy_bytes", float(s["bytes"]))
    registry.set_gauge("codec.copy_calls", float(s["calls"]))


global_metrics().register_collector(_copy_stats_collector)


# -- host arrays and wire dtypes ---------------------------------------------

#: The wire name of bfloat16 (numpy's name for ``ml_dtypes.bfloat16``);
#: on the host its bits ride as int16.
BF16 = "bfloat16"


def host_array(x) -> tuple[np.ndarray, str]:
    """``x`` (a numpy array or a torch tensor on any device) as a
    C-contiguous numpy array and its wire dtype name. A CUDA tensor is
    fetched once; a bfloat16 tensor becomes its int16 bit pattern."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        if t.dtype == torch.bfloat16:
            return np.ascontiguousarray(t.view(torch.int16).numpy()), BF16
        x = t.numpy()
    a = np.ascontiguousarray(x)
    return a, str(a.dtype)


def _np_dtype(name: str):
    return np.int16 if name == BF16 else np.dtype(name)


def to_tensor(a: np.ndarray, name: str) -> torch.Tensor:
    """A numpy array of wire dtype ``name`` as a CPU tensor, sharing its
    memory when the array is writable (a receive buffer is)."""
    if not a.flags.writeable:
        a = a.copy()
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if name == BF16 else t


def to_bf16_bits(a: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bit patterns (uint16), rounding to nearest even
    as ``ml_dtypes`` does: NaN keeps its sign and becomes the quiet NaN
    0x7fc0 / 0xffc0; +-Inf, subnormals and ties round through the same
    integer add."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    rounded = ((u + (np.uint32(0x7FFF) + ((u >> 16) & 1))) >> 16)
    bits = rounded.astype(np.uint16)
    nan = np.isnan(a)
    if nan.any():
        bits[nan] = np.where((u[nan] >> 31) != 0, 0xFFC0, 0x7FC0)
    return bits


def from_bf16_bits(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns -> float32 (exact)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _as_float32(a: np.ndarray, name: str) -> np.ndarray:
    return from_bf16_bits(a.view(np.uint16)) if name == BF16 else a


def _cast(f: np.ndarray, name: str) -> torch.Tensor:
    """A float32 result cast to wire dtype ``name`` as a CPU tensor."""
    if name == BF16:
        return to_tensor(to_bf16_bits(f).view(np.int16), BF16)
    return to_tensor(f.astype(name), name)


# -- views ---------------------------------------------------------------------


def _byte_view(buf) -> memoryview:
    mv = buf if isinstance(buf, memoryview) else memoryview(buf)
    if mv.format != "B" or mv.ndim != 1:
        mv = mv.cast("B")
    return mv


def _array_view(a: np.ndarray) -> memoryview:
    return _byte_view(a.data)


def _parts_nbytes(parts) -> int:
    return sum(_byte_view(p).nbytes for p in parts)


def _join_parts(parts) -> bytes:
    views = [_byte_view(p) for p in parts]
    _count_copy(sum(v.nbytes for v in views))
    if len(views) == 1:
        return views[0].tobytes()
    return b"".join(views)


class Codec(Protocol):
    name: str

    def encode(self, x) -> tuple[bytes, dict]: ...

    def encode_view(self, x) -> tuple[list, dict]: ...

    def decode(self, blob, meta: dict, device=None) -> torch.Tensor: ...


def _meta(a: np.ndarray, name: str, **extra) -> dict:
    return {"shape": list(a.shape), "dtype": name, **extra}


class _ViewEncodeMixin:
    def encode(self, x) -> tuple[bytes, dict]:
        parts, meta = self.encode_view(x)
        return _join_parts(parts), meta


@dataclass(frozen=True)
class RawCodec(_ViewEncodeMixin):
    name: str = "none"

    def encode_view(self, x) -> tuple[list, dict]:
        a, name = host_array(x)
        return [_array_view(a)], _meta(a, name)

    def decode(self, blob, meta: dict, device=None) -> torch.Tensor:
        a = np.frombuffer(blob, dtype=_np_dtype(meta["dtype"]))
        return to_tensor(a.reshape(meta["shape"]), meta["dtype"])


@dataclass(frozen=True)
class Bf16Codec(_ViewEncodeMixin):
    name: str = "bf16"

    def encode_view(self, x) -> tuple[list, dict]:
        a, name = host_array(x)
        bits = (a.view(np.uint16) if name == BF16
                else to_bf16_bits(a.astype(np.float32)))
        return [_array_view(bits)], _meta(a, name)

    def decode(self, blob, meta: dict, device=None) -> torch.Tensor:
        bits = np.frombuffer(blob, dtype=np.uint16)
        if meta["dtype"] == BF16:
            return to_tensor(bits.view(np.int16).reshape(meta["shape"]), BF16)
        return _cast(from_bf16_bits(bits).reshape(meta["shape"]),
                     meta["dtype"])


@dataclass(frozen=True)
class Int8Codec(_ViewEncodeMixin):
    name: str = "int8"

    def encode_view(self, x) -> tuple[list, dict]:
        a, name = host_array(x)
        f = _as_float32(a, name)
        scale = float(np.max(np.abs(f))) / 127.0 or 1.0
        q = np.clip(np.round(f / scale), -127, 127).astype(np.int8)
        return [_array_view(q)], _meta(a, name, scale=scale)

    def decode(self, blob, meta: dict, device=None) -> torch.Tensor:
        q = np.frombuffer(blob, dtype=np.int8).reshape(meta["shape"])
        return _cast(q.astype(np.float32) * meta["scale"], meta["dtype"])


@dataclass(frozen=True)
class ZfpLikeCodec(_ViewEncodeMixin):
    """Fixed-tolerance int16 quantization + native LZ: decodes to f32."""

    tolerance: float = 1e-3
    name: str = "zfp"

    def encode_view(self, x) -> tuple[list, dict]:
        a, name = host_array(x)
        a = np.ascontiguousarray(_as_float32(a, name), dtype=np.float32)
        step = max(self.tolerance, float(np.max(np.abs(a))) / 32767.0, 1e-12)
        q = np.clip(np.round(a / step), -32767, 32767).astype(np.int16)
        comp = native.compress(_array_view(q))
        return [comp], _meta(a, str(a.dtype), step=step, raw_len=q.nbytes)

    def decode(self, blob, meta: dict, device=None) -> torch.Tensor:
        raw = native.decompress(blob, meta["raw_len"])
        q = np.frombuffer(raw, dtype=np.int16).reshape(meta["shape"])
        return _cast(q.astype(np.float32) * meta["step"], meta["dtype"])


@dataclass(frozen=True)
class LzCodec(_ViewEncodeMixin):
    """Lossless: the raw bytes through the native LZ77 codec."""

    name: str = "lz"

    def encode_view(self, x) -> tuple[list, dict]:
        a, name = host_array(x)
        return [native.compress(_array_view(a))], _meta(a, name,
                                                        raw_len=a.nbytes)

    def decode(self, blob, meta: dict, device=None) -> torch.Tensor:
        raw = bytearray(native.decompress(blob, meta["raw_len"]))
        a = np.frombuffer(raw, dtype=_np_dtype(meta["dtype"]))
        return to_tensor(a.reshape(meta["shape"]), meta["dtype"])


_TORCH_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                 BF16: torch.bfloat16, "float64": torch.float64,
                 "int32": torch.int32, "int64": torch.int64,
                 "int16": torch.int16, "int8": torch.int8,
                 "uint8": torch.uint8, "bool": torch.bool}


@dataclass(frozen=True)
class DeviceInt8Codec(_ViewEncodeMixin):
    """Blockwise int8 on the device: encode runs K6 quantize where the
    tensor lies (a numpy array is quantized on the CPU by the plain
    version) and fetches the 4x smaller values and scales as two payload
    parts; decode dequantizes on ``device`` (K6 dequantize on a card)."""

    name: str = "int8dev"

    def encode_view(self, x) -> tuple[list, dict]:
        from adapt_tpu_torch.ops.quantize import quantize

        t = (x.detach() if isinstance(x, torch.Tensor)
             else torch.from_numpy(np.array(x)))
        qt = quantize(t)
        vals = np.ascontiguousarray(qt.values.cpu().numpy())
        scales = np.ascontiguousarray(qt.scales.cpu().numpy())
        return [_array_view(vals), _array_view(scales)], {
            "shape": list(qt.shape),
            "dtype": str(qt.dtype).removeprefix("torch."),
            "rows": list(vals.shape),
            "nblocks": int(scales.shape[0]),
        }

    def decode(self, blob, meta: dict, device=None) -> torch.Tensor:
        from adapt_tpu_torch import resolve_device
        from adapt_tpu_torch.ops.quantize import QuantizedTensor, dequantize

        dev = resolve_device(device)
        blob = _byte_view(blob)
        rows = tuple(meta["rows"])
        nvals = rows[0] * rows[1]
        vals = np.frombuffer(blob[:nvals], dtype=np.int8).reshape(rows)
        scales = np.frombuffer(blob[nvals:], dtype=np.float32).copy()
        qt = QuantizedTensor(
            to_tensor(vals, "int8").to(dev),
            torch.from_numpy(scales.reshape(meta["nblocks"], 1)).to(dev),
            tuple(meta["shape"]), _TORCH_DTYPES[meta["dtype"]])
        return dequantize(qt)


CODECS: dict[str, Codec] = {
    "none": RawCodec(),
    "bf16": Bf16Codec(),
    "int8": Int8Codec(),
    "zfp": ZfpLikeCodec(),
    "lz": LzCodec(),
    "int8dev": DeviceInt8Codec(),
}


def get_codec(name: str, tolerance: float | None = None) -> Codec:
    if name == "zfp" and tolerance is not None:
        return ZfpLikeCodec(tolerance=tolerance)
    try:
        return CODECS[name]
    except KeyError:
        raise ValueError(
            f"unknown codec {name!r}; have {sorted(CODECS)}") from None


def pack_frames(codec: Codec, x) -> list:
    """The frame as scatter-write parts, ``[4-byte header length + JSON
    header, *payload views]``, with no payload copy. The views may alias
    ``x``: send (or copy) them before mutating it."""
    parts, meta = codec.encode_view(x)
    header = json.dumps({"codec": codec.name, **meta}).encode()
    return [len(header).to_bytes(4, "big") + header, *parts]


def frames_nbytes(frames) -> int:
    """Total wire size of a :func:`pack_frames` result."""
    return _parts_nbytes(frames)


def _assemble(frames, out: memoryview) -> int:
    off = 0
    for part in frames:
        v = _byte_view(part)
        out[off:off + v.nbytes] = v
        off += v.nbytes
    _count_copy(off - len(frames[0]))  # header writes are not payload
    return off


def pack_into(codec: Codec, x, buf: bytearray) -> memoryview:
    """Assemble the frame into the caller's ``buf`` (grown, never shrunk)
    and return a view of the written region: one payload copy."""
    frames = pack_frames(codec, x)
    total = _parts_nbytes(frames)
    if len(buf) < total:
        buf.extend(bytes(total - len(buf)))
    out = memoryview(buf)
    return out[:_assemble(frames, out)]


def pack(codec: Codec, x) -> bytearray:
    """Codec name + meta + payload in one buffer: one payload copy."""
    frames = pack_frames(codec, x)
    buf = bytearray(_parts_nbytes(frames))
    _assemble(frames, memoryview(buf))
    return buf


def unpack(buf, tolerance: float | None = None, device=None) -> torch.Tensor:
    """Decode a :func:`pack` frame (the JAX package's too): ``none``
    returns a tensor sharing ``buf``'s memory; ``int8dev`` dequantizes on
    ``device`` (None: the CUDA card)."""
    mv = _byte_view(buf)
    hlen = int.from_bytes(mv[:4], "big")
    meta = json.loads(bytes(mv[4:4 + hlen]).decode())
    codec = get_codec(meta.pop("codec"), tolerance)
    return codec.decode(mv[4 + hlen:], meta, device)


def unpack_many(buf, lens: list[int], tolerance: float | None = None,
                device=None) -> list[torch.Tensor]:
    """Decode concatenated :func:`pack` frames of byte lengths ``lens``;
    raises ``ValueError`` unless ``lens`` tiles ``buf`` exactly."""
    mv = _byte_view(buf)
    out, off = [], 0
    for n in lens:
        if n < 0 or off + n > mv.nbytes:
            raise ValueError(f"frame length {n} at offset {off} overruns "
                             f"the {mv.nbytes}-byte buffer")
        out.append(unpack(mv[off:off + n], tolerance, device))
        off += n
    if off != mv.nbytes:
        raise ValueError(
            f"frame lengths cover {off} of {mv.nbytes} payload bytes")
    return out
