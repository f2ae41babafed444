"""Build the port's CUDA kernels at first use and bind them with ctypes.

The sources are `vitron_tpu_torch/csrc/*.cu` (with their `*.cuh` headers)
and nothing else. They are compiled by `nvcc` for Hopper (`sm_90a`) into one
shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/vitron_tpu_torch/<hash>/libvitron_kernels.so csrc/*.cu

The output directory is keyed by a hash of the sources and flags, so an
edited kernel is rebuilt and an unchanged one is loaded as it is. Every C
entry returns `cudaGetLastError()` after its launch; `check` raises on a
non-zero code. A failed build raises with nvcc's stderr and nothing falls
back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "vitron_tpu_torch"
LIB_NAME = "libvitron_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> argtypes of every C entry point in csrc/
_SIGNATURES = {
    # x, q4, s, y, part, M, K2, N, splits, is_bf16, stream
    "vt_int4_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # q, k, v, kv_mask, out, B, S, T, N, KH, D, q_offset, scale, causal,
    # use_shift, shift, is_bf16, stream
    "vt_flash_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _F, _I, _I, _F, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # nvcc wall time of this process's build


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    """Path of the built library, building it first if needed."""
    global build_seconds
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(p) for p in sorted(CSRC.glob("*.cu"))]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stderr}")
    build_seconds = time.perf_counter() - t0
    os.replace(tmp, lib)  # atomic: a concurrent build in another process sees all or nothing
    return lib


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(library_path()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.vt_error_string.argtypes = [ctypes.c_int]
        handle.vt_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if rc != 0:
        msg = lib().vt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_handle(device) -> int:
    """Raw handle of PyTorch's current stream on `device`."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
