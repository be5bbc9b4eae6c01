"""Build and load the hand-written CUDA kernels (``adapt_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded through ``ctypes``: no
PyTorch headers, so a build takes seconds. Libraries go into
``adapt_tpu_torch/_kernels_build/`` (listed in ``.gitignore``), named by a
hash of the sources, so an edited kernel rebuilds and an unchanged one is
reused. Builds happen at first use (or all at once, in parallel, through
:func:`build_all`), never at import. A failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_kernels_build"

#: kernel library name -> its C entry point's ctypes signature.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNELS = {
    "flash_attn_fwd": [_P] * 7 + [_I] * 8 + [_F, _P],
    "decode_attn": [_P] * 9 + [_I] * 7 + [_F, _P],
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of adapt_tpu_torch build on a "
            "machine with the CUDA toolkit"
        )
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all() -> float:
    """Compile every kernel library that is not built yet, one ``nvcc``
    per source, all started together. Returns the wall seconds."""
    t0 = time.perf_counter()
    with _lock:
        jobs = {n: _start(n) for n in KERNELS}
        for name, job in jobs.items():
            if job is not None:
                _finish(name, job)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built first if needed), with
    its entry point's argument types declared."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            job = _start(name)
            if job is not None:
                _finish(name, job)
            lib = ctypes.CDLL(str(_lib_path(name)))
            fn = getattr(lib, name)
            fn.argtypes = KERNELS[name]
            fn.restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]


def dtype_code(dtype) -> int:
    """The ``adapt::DType`` code of a torch dtype (``csrc/common.cuh``)."""
    import torch

    codes = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
    if dtype not in codes:
        raise ValueError(f"kernels take f32, bf16 or f16 tensors, got {dtype}")
    return codes[dtype]


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError`` code returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
