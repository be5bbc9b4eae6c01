"""Build and load the hand-written CUDA kernels (``adapt_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded through ``ctypes``: no
PyTorch headers, so a build takes seconds. Libraries go into
``adapt_tpu_torch/_kernels_build/`` (listed in ``.gitignore``), named by a
hash of the source and every shared header (``csrc/*.cuh``), so an edited
kernel rebuilds and an unchanged one is reused. Builds happen at first use (or all at once, in parallel, through
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
_P, _I, _F, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)
KERNELS = {
    "flash_attn_fwd": [_P] * 8 + [_I] * 8 + [_F, _P],
    "flash_attn_bwd": [_P] * 12 + [_I] * 8 + [_F, _P],
    "decode_attn": [_P] * 10 + [_I] * 8 + [_F, _P],
    "paged_attn": [_P] * 11 + [_I] * 9 + [_F, _P],
    "paged_chunk_attn": [_P] * 7 + [_I] * 10 + [_F, _P],
    "paged_verify_attn": [_P] * 11 + [_I] * 12 + [_F, _P],
    "quantize_blocks": [_P] * 3 + [_L, _I, _I, _P],
    # host arrays: values, scales, outputs, sizes, dtypes, chunk prefix sums
    "dequantize_blocks": [_P] * 6 + [_I, _P],
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: kernel library name -> the compiler's output of the build this process
#: ran (``ptxas -v``: registers, shared memory and spills per kernel).
LOGS: dict[str, str] = {}


#: Route books per op with a kernel / plain route (``decode``,
#: ``paged_decode``, ``paged_chunk``, ``paged_verify``, ``prefill``,
#: ``flash_bwd``, ``quantize``, ``dequantize``): ``"pallas"`` counts the
#: hand-written kernel's launches, booked by each launch wrapper beside its
#: ``launches`` counter once the launch returned no error, and ``"xla"``
#: calls that ran the plain version (the JAX package's catalog names);
#: ``"last"`` is 1.0 when the latest call took the kernel. ``utils.profiling``'s engine collector
#: exports them as ``engine.kernel_dispatch.<op>`` gauges.
_KERNEL_DISPATCHES: dict[str, dict[str, float]] = {}


def record_kernel_dispatch(op: str, path: str) -> None:
    """Record one call of ``op`` on ``path`` (``"pallas"``: the kernel,
    ``"xla"``: the plain version)."""
    d = _KERNEL_DISPATCHES.get(op)
    if d is None:
        d = _KERNEL_DISPATCHES.setdefault(
            op, {"pallas": 0.0, "xla": 0.0, "last": 0.0})
    d[path] += 1.0
    d["last"] = 1.0 if path == "pallas" else 0.0


def kernel_dispatch_stats() -> dict[str, dict[str, float]]:
    """Copies of the per-op route books."""
    return {op: dict(d) for op, d in list(_KERNEL_DISPATCHES.items())}


def reset_kernel_dispatch() -> None:
    _KERNEL_DISPATCHES.clear()


def libraries_loaded() -> int:
    """Kernel libraries built or loaded in this process: the compile
    sentinel's watch on the port's one compile-time stall."""
    return len(_libs)


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
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
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
    LOGS[name] = log
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


#: ``adapt::KVCode`` (``csrc/common.cuh``): the cache element of a K/V
#: operand.
KV_NATIVE, KV_INT8, KV_INT4 = 0, 1, 2


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError`` code returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
