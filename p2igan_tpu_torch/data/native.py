"""Build and bind the port's host-IO core (``p2igan_tpu_torch/native/p2io.cpp``).

The core reads uint8 3-D windows out of chunked zarr arrays (the training
read: each chunk read, decoded and copied into the window on the calling
thread) and compresses zstd chunks (the store write path). ``zarrlite``
routes both through it.

``g++`` builds it at first use into ``build/p2igan_tpu_torch/`` at the
repository root, named after a hash of the source and the flags, so a
checkout builds exactly its own core and a changed source never runs a stale
binary; the new file replaces the old one atomically. Nothing here runs at
import time. A ctypes call releases the interpreter lock, so the loader's
threads read in parallel.

Nothing falls back quietly: a failed build raises with g++'s output, and a
chunk that cannot be read or decoded raises naming its file and codec.
The zstd and blosc entry points are those of the libraries that zarrlite's
own loaders open (``_load_zstd``, ``_load_blosc``), handed to the core as
function pointers: where libblosc is absent, a blosc read raises the very
error zarrlite's pure-Python path raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "native" / "p2io.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "p2igan_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LINK_FLAGS = ("-l:libz.so.1",)

# the zarr compressor ids the core decodes, by its codec number
CODECS = {None: 0, "zlib": 1, "gzip": 1, "zstd": 2, "blosc": 3}
# the core's chunk status (p2io.cpp ``Status``), as an error says it
STATUS = {1: "cannot be read", 2: "does not decode", 3: "decodes to the wrong size",
          4: "ran out of memory"}

_LOCK = threading.Lock()
_LIB = None
_TABLES = {}

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64


def library_path(src: Optional[Path] = None) -> Path:
    """Where the core built from ``src`` (default: the port's source) with
    the current flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    h.update((src or _SRC).read_bytes())
    return _BUILD_DIR / f"libp2io_{h.hexdigest()[:16]}.so"


def build_command(src: Path, out: Path) -> list:
    return ["g++", *CXX_FLAGS, str(src), "-o", str(out), *LINK_FLAGS]


def build(src: Path, out: Path) -> None:
    """Compile ``src`` into ``out``, replacing it atomically; raise with
    g++'s output if the build fails."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so"
    cmd = build_command(src, tmp)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: the host-IO core cannot be built ({e})") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # a concurrent loader never sees half a file


def load(path: Path) -> ctypes.CDLL:
    """The core built at ``path``, its entry points typed."""
    lib = ctypes.CDLL(str(path))
    lib.p2io_read_window_u8.restype = ctypes.c_int
    lib.p2io_read_window_u8.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), _P, _I32, *[_I32] * 9, _I32, _P, _P,
        ctypes.POINTER(_I32), ctypes.POINTER(_I64)]
    lib.p2io_zstd_compress.restype = _I64
    lib.p2io_zstd_compress.argtypes = [_P, _I64, _P, _I64, _I32, _P]
    return lib


def library() -> ctypes.CDLL:
    """The loaded core, built from ``p2igan_tpu_torch/native/p2io.cpp`` at
    first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = library_path()
            if not path.exists():
                build(_SRC, path)
            _LIB = load(path)
        return _LIB


def _fn(lib: ctypes.CDLL, name: str) -> int:
    return ctypes.cast(getattr(lib, name), ctypes.c_void_p).value


def codec_table(codec: Optional[str]):
    """The core's function-pointer table (p2io.cpp ``Codecs``: zstd
    decompress, is-error, compress, blosc decompress) for ``codec``; opens
    only that codec's library, through zarrlite's loaders."""
    from .zarrlite import _load_blosc, _load_zstd

    with _LOCK:
        table = _TABLES.get(codec)
        if table is None:
            fns = [None] * 4
            if codec == "zstd":
                zstd = _load_zstd()
                fns[:3] = [_fn(zstd, "ZSTD_decompress"), _fn(zstd, "ZSTD_isError"),
                           _fn(zstd, "ZSTD_compress")]
            elif codec == "blosc":
                fns[3] = _fn(_load_blosc(), "blosc_decompress_ctx")
            table = _TABLES[codec] = (ctypes.c_void_p * 4)(*fns)
        return table


def read_window_u8(
    chunk_paths: Sequence[Tuple[Tuple[int, int, int], Optional[Path]]],
    chunk_shape: Tuple[int, int, int],
    origin: Tuple[int, int, int],
    window: Tuple[int, int, int],
    codec: Optional[str],
) -> np.ndarray:
    """The uint8 window ``origin + window`` of a chunked (T, H, W) array.

    ``chunk_paths``: ``[((it, iy, ix), path or None), ...]``, the chunks the
    window overlaps (None: a missing chunk, read as zeros). Raises if a
    chunk cannot be read or decoded, naming its file and codec.
    """
    if codec not in CODECS:
        raise ValueError(f"the host-IO core does not decode {codec!r}")
    if any(w <= 0 for w in window):
        raise ValueError(f"empty window {window}")
    lib = library()
    table = codec_table(codec)
    n = len(chunk_paths)
    paths = (ctypes.c_char_p * n)(*[None if p is None else os.fsencode(p)
                                    for _, p in chunk_paths])
    idx = np.ascontiguousarray(np.array([c for c, _ in chunk_paths], np.int32).reshape(-1))
    out = np.empty(window, np.uint8)
    failed, got = _I32(-1), _I64(-1)
    rc = lib.p2io_read_window_u8(paths, idx.ctypes.data, n, *map(int, chunk_shape),
                                 *map(int, origin), *map(int, window), CODECS[codec],
                                 table, out.ctypes.data, ctypes.byref(failed),
                                 ctypes.byref(got))
    if rc != 0:
        path = chunk_paths[failed.value][1]
        reason = STATUS.get(rc, f"failed ({rc})")
        if rc == 3:
            nbytes = int(np.prod(chunk_shape))
            reason = (f"decodes to {got.value} bytes, expected {nbytes}" if got.value >= 0
                      else f"decodes to more than its {nbytes} bytes")
        raise RuntimeError(f"zarr chunk {path} (codec {codec}) {reason}")
    return out


def zstd_compress(data, level: int) -> bytes:
    """``ZSTD_compress(data, level)`` through the core: the same bytes as
    zarrlite's ctypes path."""
    from .zarrlite import _load_zstd

    lib = library()
    table = codec_table("zstd")
    src = np.frombuffer(data, np.uint8)
    bound = _load_zstd().ZSTD_compressBound(len(src))
    dst = np.empty(bound, np.uint8)
    n = lib.p2io_zstd_compress(src.ctypes.data, len(src), dst.ctypes.data, bound,
                               int(level), table)
    if n < 0:
        raise RuntimeError(f"zstd compression of {len(src)} bytes at level {level} failed")
    return dst[:n].tobytes()
