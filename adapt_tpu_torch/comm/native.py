"""The native LZ77 byte codec (``native/qcodec.cpp``), built with ``g++``
and loaded through ``ctypes``.

Counterpart of ``adapt_tpu/comm/native.py``, with one difference: the
library is built into this package's own build directory,
``adapt_tpu_torch/_kernels_build/`` (listed in ``.gitignore``), named by a
hash of the source and the compiler flags (as ``ops/_build.py`` names the
kernels), and written there atomically. Nothing is ever written under
``native/``. Without a compiler, or when the library does not load, the
codec falls back to zlib: the fallback is counted
(``native.qcodec_fallback``) and recorded in the flight recorder.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
import zlib

from adapt_tpu_torch.utils.logging import get_logger
from adapt_tpu_torch.utils.metrics import global_metrics
from adapt_tpu_torch.utils.tracing import global_flight_recorder

log = get_logger("native")

SRC = pathlib.Path(__file__).resolve().parents[2] / "native" / "qcodec.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_kernels_build"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def lib_path() -> pathlib.Path:
    """Where the library of this source and these flags is built."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libqcodec_{h.hexdigest()[:12]}.so"


def _build(out: pathlib.Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=120)
    except (subprocess.SubprocessError, OSError) as e:
        log.warning("qcodec build failed (%s); falling back to zlib", e)
        return False
    os.replace(tmp, out)
    return True


def _fallback(**why) -> None:
    global_metrics().inc("native.qcodec_fallback")
    global_flight_recorder().record("native_codec", fallback="zlib", **why)


def load() -> ctypes.CDLL | None:
    """The loaded library (built first if needed), or None when it cannot
    be built or loaded."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = lib_path()
        if not path.exists() and not _build(path):
            _fallback(built=False)
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            log.warning("qcodec load failed: %s", e)
            _fallback(built=True, loaded=False)
            return None
        lib.qz_bound.restype = ctypes.c_size_t
        lib.qz_bound.argtypes = [ctypes.c_size_t]
        for fn in (lib.qz_compress, lib.qz_decompress):
            fn.restype = ctypes.c_size_t
            fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                           ctypes.c_char_p, ctypes.c_size_t]
        _lib = lib
        global_metrics().inc("native.qcodec_loaded")
        return _lib


def _c_src(buf):
    """A ctypes-passable view of a bytes-like object, without a copy when
    possible (bytes pass as they are, writable buffers wrap in place)."""
    if isinstance(buf, bytes):
        return buf, len(buf)
    mv = buf if isinstance(buf, memoryview) else memoryview(buf)
    if mv.format != "B" or mv.ndim != 1:
        mv = mv.cast("B")
    if mv.readonly:
        b = bytes(mv)
        return b, len(b)
    return (ctypes.c_char * mv.nbytes).from_buffer(mv), mv.nbytes


def compress(data) -> bytes:
    """LZ-compress any bytes-like object: ``b"Q" + body`` from the native
    library, ``b"Z" + zlib`` without it."""
    lib = load()
    if lib is None:
        return b"Z" + zlib.compress(data, 1)
    src, n_src = _c_src(data)
    bound = lib.qz_bound(n_src)
    dst = ctypes.create_string_buffer(bound)
    n = lib.qz_compress(src, n_src, dst, bound)
    if n == 0:
        raise RuntimeError("qz_compress failed")
    return b"Q" + dst.raw[:n]


def decompress(blob, raw_len: int) -> bytes:
    mv = blob if isinstance(blob, memoryview) else memoryview(blob)
    tag, body = bytes(mv[:1]), mv[1:]
    if tag == b"Z":
        return zlib.decompress(body)
    if tag != b"Q":
        raise ValueError(f"unknown qcodec tag {tag!r}")
    if raw_len == 0:
        return b""  # qz_decompress returns 0 for errors: disambiguate
    lib = load()
    if lib is None:
        raise RuntimeError("native qcodec unavailable for a 'Q' blob")
    src, n_src = _c_src(body)
    dst = ctypes.create_string_buffer(raw_len)
    n = lib.qz_decompress(src, n_src, dst, raw_len)
    if n == 0:
        raise ValueError("qz_decompress: malformed input")
    return dst.raw[:n]
