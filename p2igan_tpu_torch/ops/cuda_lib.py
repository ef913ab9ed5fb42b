"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` into one shared library with a plain C
interface, loaded through ``ctypes``. The library is built at first use into
``build/p2igan_tpu_torch/`` at the repository root and keyed by a hash of the
sources and flags, so a checkout builds exactly its own kernels and a source
change can never run a stale binary. Nothing here runs at import time: the CPU
tests import every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "p2igan_tpu_torch"
# -fmad=false: no FMA contraction anywhere (the kernels also spell out every
# rounding with __f*_rn intrinsics); never --use_fast_math, whose approximate
# sqrt/division would flip the IDW's k-th-neighbour ties.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas=-v")

_LOCK = threading.Lock()
_LIB = None
_BUILD_LOG = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "p2i_gauge_topk": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "p2i_combine_table_multi": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I, _F, _F, _I, _P],
    "p2i_maxpool2_duplicate": [_P, _P, _I, _I, _I, _I, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_DIR / f"libp2igan_kernels_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> str:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in _sources() if s.suffix == ".cu"]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return proc.stdout + proc.stderr


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from ``csrc/`` on first use."""
    global _LIB, _BUILD_LOG
    with _LOCK:
        if _LIB is None:
            path = library_path()
            if not path.exists():
                _BUILD_LOG = _build(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def build_log() -> str:
    """Compiler output (ptxas register/spill report) of this process's build;
    empty when the library was already built."""
    return _BUILD_LOG


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor,
                 dtypes=(torch.float32,)) -> None:
    """Device/dtype/contiguity checks shared by the kernel wrappers."""
    dev = tensors[0].device
    for i, t in enumerate(tensors):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: argument {i} on {t.device}, expected "
                             f"every argument on one CUDA device")
        want = dtypes[i] if len(dtypes) > 1 else dtypes[0]
        if t.dtype != want:
            raise TypeError(f"{name}: argument {i} is {t.dtype}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} is not contiguous")
