"""Build the port's CUDA kernels at first use and bind them with ctypes.

The sources are `vitron_tpu_torch/csrc/*.cu` (with their `*.cuh` headers)
and nothing else. Each `.cu` is compiled by its own `nvcc` for Hopper
(`sm_90a`), all started together, and the objects are linked into one
shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         -c csrc/<name>.cu -o build/vitron_tpu_torch/<hash>/<name>.o    (one per source)
    nvcc -shared -o build/vitron_tpu_torch/<hash>/libvitron_kernels.so *.o

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
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "vitron_tpu_torch"
LIB_NAME = "libvitron_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> argtypes of every C entry point in csrc/
_SIGNATURES = {
    # x, q4, s, y, part, ticket, M, K2, N, splits, is_bf16, stream
    "vt_int4_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # q, k, v, kv_mask, out, lse, B, S, T, N, KH, D, q_offset, scale, causal,
    # use_shift, shift, is_bf16, stream
    "vt_flash_attention_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _F, _I, _I, _F, _I, _P],
    # q, k, v, dout, lse, delta, kv_mask, qs (bf16 scratch), dk, dv, B, S, T, N,
    # KH, D, q_offset, scale, causal, is_bf16, stream
    "vt_flash_attention_bwd_kv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _I, _I, _I, _I, _F, _I, _I, _P],
    # q, k, v, dout, lse, delta, kv_mask, dq, B, S, T, N, KH, D, q_offset,
    # scale, causal, is_bf16, stream
    "vt_flash_attention_bwd_q": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _I, _F, _I, _I, _P],
    # x, w1, b1, w2, b2, hidden, part, out, M, C, F, splits, is_bf16, stream
    "vt_geglu_ff": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, out, part, B, R, C, splits, is_bf16, stream
    "vt_group_norm_sums": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, w, y, B, H, W, C, K, TH, TW, is_bf16, stream
    "vt_depthwise_conv2d": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, w, bias, y, B, F, N, C, Co, is_bf16, stream
    "vt_temporal_conv_k3": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # q, k, v, o, B, F, N, H, D, scale, is_bf16, stream
    "vt_frame_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
    # x, w, y, B, H, W, C, D, is_bf16, stream
    "vt_conv3x3": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # nvcc wall time of this process's build
compile_seconds: Dict[str, float] = {}  # per-source nvcc wall time of that build


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


def _run(cmds: Dict[str, List[str]]) -> Dict[str, float]:
    """Run the commands side by side; raise with the stderr of any that fails
    (after all have ended). Returns each command's wall seconds."""
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True) for name, cmd in cmds.items()}
    seconds, errors = {}, []
    for name, proc in procs.items():
        _, err = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {name} (exit {proc.returncode}): "
                          f"{' '.join(cmds[name])}\n{err}")
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def library_path() -> Path:
    """Path of the built library, building it first if needed."""
    global build_seconds, compile_seconds
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = {src.stem: out_dir / f".{src.stem}.{tag}.o" for src in sorted(CSRC.glob("*.cu"))}
    tmp = out_dir / f".{LIB_NAME}.{tag}"
    t0 = time.perf_counter()
    try:
        compile_seconds = _run({name: [nvcc, *NVCC_FLAGS, "-c", str(CSRC / f"{name}.cu"),
                                       "-o", str(obj)] for name, obj in objs.items()})
        _run({"link": [nvcc, "-shared", "-o", str(tmp), *map(str, objs.values())]})
        build_seconds = time.perf_counter() - t0
        os.replace(tmp, lib)  # atomic: a concurrent build in another process sees all or nothing
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs.values():
            obj.unlink(missing_ok=True)
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


def aligned16(t):
    """t, or a contiguous copy of it when t is not contiguous or its data does
    not start on a 16-byte boundary (the GEMM kernels load 16 bytes at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
