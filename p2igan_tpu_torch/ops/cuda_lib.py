"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` into one shared library with a plain C
interface, loaded through ``ctypes``; every ``.cu`` file compiles in its own
``nvcc`` process, all started together, and one more links them. The library is built at first use into
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
              "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas=-v")

# dynamic shared memory a block may opt in to on sm_90
MAX_SHARED_BYTES = 232448

_LOCK = threading.Lock()
_LIB = None
_BUILD_LOG = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "p2i_gauge_topk": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "p2i_combine_table": [_P] * 7 + [_I] * 7 + [_F, _F, _I, _P],
    "p2i_combine_table_bwd": [_P] * 9 + [_I] * 7 + [_F, _F, _I, _I, _P],
    "p2i_combine_dense": [_P] * 6 + [_I] * 6 + [_F, _F, _I, _P],
    "p2i_combine_table_multi": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I, _F, _F, _I, _P],
    "p2i_combine_table_multi_bwd": [_P] * 7 + [_I] * 6 + [_F, _F, _I, _I, _P],
    "p2i_maxpool2_duplicate": [_P, _P, _I, _I, _I, _I, _P],
    "p2i_maxpool2_duplicate_bf16": [_P, _P, _I, _I, _I, _I, _P],
    "p2i_decode_normalize_mask": [_P, _P, _P, _P, _L, _L, _I, _I, _I, _I, _P],
    "p2i_dk_mlp_tail": [_P] * 9 + [_I, _I, _I, _P],
    "p2i_dk_mlp_tail_bwd": [_P] * 13 + [_I, _I, _I, _I, _P],
    "p2i_enc0_conv3d_leaky": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    "p2i_dec2_conv3d_sigmoid": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "p2i_idw_cell_build": [_P] * 5 + [_I] * 5 + [_P],
    "p2i_idw_knn_chunked": [_P] * 12 + [_I] * 9 + [_F, _F, _I, _P],
    "p2i_idw_scatter": [_P] * 5 + [_I] * 4 + [_P],
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


def _run(cmds):
    """Run the commands in parallel; raise with the first failure's output.
    Returns their combined compiler output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{log}")
    return "".join(logs)


def _build(out: Path) -> str:
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs, compiles = [], []
    for src in _sources():
        if src.suffix == ".cu":
            obj = out.parent / f"{tag}.{src.stem}.o"
            objs.append(obj)
            compiles.append([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)])
    tmp = out.parent / f"{tag}.tmp.so"
    try:
        log = _run(compiles)
        log += _run([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return log


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
    """The current stream of the tensor's device, as a raw pointer."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def fixed_scratch(total: int, rows: int, device) -> torch.Tensor:
    """Scratch of one order-free sum (``csrc/fixed_sum.cuh``): ``total``
    64-bit fixed-point totals and flag words, and one max a row; the launcher
    zeroes it."""
    return torch.empty((total * 12 + rows * 4,), dtype=torch.uint8, device=device)


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
