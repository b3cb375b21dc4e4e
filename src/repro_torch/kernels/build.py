"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together), the objects are linked into
one shared library with a plain C interface, and the library is loaded
with ``ctypes``. The build happens at first use, into
``build/repro_torch/<digest>/`` under the checkout, where the digest covers
the sources, the ``csrc/*.cuh`` headers they include and the flags; a later
process finds the library there.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int64
# C entry point -> argument types. Every pointer and the stream are
# c_void_p: ctypes would otherwise pass a Python int as a 32-bit int.
SIGNATURES = {
    "gather_rows_launch": [_P] * 3 + [_I] * 11 + [_P],
    "fused_gather_lstm_cell_launch": [_P] * 10 + [_I] * 11 + [_P],
    "fused_lstm_cell_launch": [_P] * 6 + [_I] * 8 + [_P],
    "flash_attention_launch": [_P] * 5 + [_I] * 17 + [_P],
    "flash_attention_bf16_launch": [_P] * 5 + [_I] * 17 + [_P],
    "flash_attention_bwd_launch": [_P] * 10 + [_I] * 24 + [_P],
    "flash_attention_bwd_bf16_launch": [_P] * 10 + [_I] * 24 + [_P],
    "gather_rows_bwd_launch": [_P] * 5 + [_I] * 12 + [_P],
    "gather_rows_bwd_bf16_launch": [_P] * 5 + [_I] * 12 + [_P],
    "ssd_scan_launch": [_P] * 9 + [_I] * 15 + [_P],
    "ssd_scan_bf16_launch": [_P] * 9 + [_I] * 15 + [_P],
    "ssd_scan_bwd_launch": [_P] * 19 + [_I] * 16 + [_P],
    "ssd_scan_bwd_bf16_launch": [_P] * 18 + [_I] * 16 + [_P],
    "empty_kernel_launch": [_P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels cannot be built")
    return str(path)


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources into the shared library (if not built yet) and
    return its path. Raises with the compiler's output on any failure."""
    sources = sorted(CSRC.glob("*.cu"))
    out_dir = BUILD_ROOT / _digest(sources)
    lib = out_dir / "librepro_torch_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in sources:
        obj = out_dir / f"{src.stem}.{os.getpid()}.o"
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *ARCH, *FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    reports = {}
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        reports[src.name] = out
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = out_dir / f"lib.{os.getpid()}.so"
    link = subprocess.run([nvcc, *ARCH, "-shared", *(str(o) for _, o, _ in procs),
                           "-o", str(tmp)], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib)   # atomic: a concurrent loader sees all or nothing
    for _, obj, _ in procs:
        obj.unlink()
    build_info.update(seconds=time.perf_counter() - t0, ptxas=reports)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(status: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {status}")
