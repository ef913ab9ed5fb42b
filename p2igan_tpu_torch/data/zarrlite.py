"""zarrlite -- a self-contained Zarr-v2-compatible chunked array store.

The reference framework stores every dataset and every inference output as
Zarr v2 directory stores (reference ``p2igan_bench/data/sti_dataset.py:245-324``,
``scripts/infer.py:168-260``, ``scripts/preprocess.py:130-233``). The ``zarr``
package is not a dependency, so this module implements the
subset of the Zarr v2 on-disk format the framework needs, bit-compatible with
stores written by the real ``zarr`` library:

  * directory stores with ``.zgroup`` / ``.zarray`` / ``.zattrs`` JSON metadata
  * C-order chunks keyed ``"i.j.k"`` (configurable ``dimension_separator``)
  * codecs: ``null`` (raw), ``zlib``, ``gzip``, ``zstd`` and ``blosc`` — the
    latter two via the system ``libzstd`` / ``libblosc`` shared libraries
  * the port's host-IO core (``data/native.py``, ``native/p2io.cpp``) reads
    every uint8 3-D window of a fill-0 array (the training read: its chunks
    decoded in C++ on the calling thread, without the interpreter lock) and
    compresses every zstd chunk; the pure-Python chunk loop
    (``Array._read_plain``) reads every other array
  * basic (integer / contiguous-slice) indexing for read and write, which is
    everything the data pipeline uses (minimal chunk-aligned window reads)

API mirrors the ``zarr`` calls used by the reference: ``open``, ``open_group``,
``Group.create_dataset / create_group / array_keys / group_keys / attrs``,
``Array.__getitem__ / __setitem__ / shape / dtype / attrs``.

The port's own copy of ``p2igan_tpu/data/zarrlite.py``, with its own host-IO
core. Unlike that package's, a core that fails to build or a chunk that fails
to decode raises: nothing falls back to the Python loop.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import json

import shutil
import zlib as _zlib
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from . import native

# ---------------------------------------------------------------------------
# Codecs
# ---------------------------------------------------------------------------

_ZSTD = None
_BLOSC = None


def _load_zstd():
    global _ZSTD
    if _ZSTD is None:
        name = ctypes.util.find_library("zstd") or "libzstd.so.1"
        lib = ctypes.CDLL(name)
        lib.ZSTD_compressBound.restype = ctypes.c_size_t
        lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
        lib.ZSTD_compress.restype = ctypes.c_size_t
        lib.ZSTD_compress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
        ]
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_decompress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
        ]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        _ZSTD = lib
    return _ZSTD


def _load_blosc():
    global _BLOSC
    if _BLOSC is None:
        name = ctypes.util.find_library("blosc") or "libblosc.so.1"
        lib = ctypes.CDLL(name)
        lib.blosc_compress_ctx.restype = ctypes.c_int
        lib.blosc_compress_ctx.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
        ]
        lib.blosc_decompress_ctx.restype = ctypes.c_int
        lib.blosc_decompress_ctx.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
        ]
        _BLOSC = lib
    return _BLOSC


def compress(data: bytes, compressor: Optional[Dict[str, Any]], itemsize: int = 1) -> bytes:
    if compressor is None:
        return data
    cid = compressor.get("id")
    if cid == "zlib":
        return _zlib.compress(data, compressor.get("level", 1))
    if cid == "gzip":
        import gzip

        return gzip.compress(data, compressor.get("level", 1))
    if cid == "zstd":
        return native.zstd_compress(data, int(compressor.get("level", 1)))
    if cid == "blosc":
        lib = _load_blosc()
        destsize = len(data) + 16 + 64  # BLOSC_MAX_OVERHEAD
        out = ctypes.create_string_buffer(destsize)
        shuffle = int(compressor.get("shuffle", 1))
        n = lib.blosc_compress_ctx(
            int(compressor.get("clevel", 5)), shuffle, itemsize, len(data),
            data, out, destsize,
            str(compressor.get("cname", "zstd")).encode(), int(compressor.get("blocksize", 0)), 1,
        )
        if n <= 0:
            raise RuntimeError("blosc compression failed")
        return out.raw[:n]
    raise ValueError(f"Unsupported compressor: {compressor}")


def _zstd_compress_plain(data: bytes, level: int) -> bytes:
    """``ZSTD_compress`` through ctypes: the plain version of the core's
    ``native.zstd_compress``, byte for byte."""
    lib = _load_zstd()
    bound = lib.ZSTD_compressBound(len(data))
    out = ctypes.create_string_buffer(bound)
    n = lib.ZSTD_compress(out, bound, data, len(data), level)
    if lib.ZSTD_isError(n):
        raise RuntimeError("zstd compression failed")
    return out.raw[:n]


def decompress(data: bytes, compressor: Optional[Dict[str, Any]], nbytes: int) -> bytes:
    if compressor is None:
        return data
    cid = compressor.get("id")
    if cid == "zlib":
        return _zlib.decompress(data)
    if cid == "gzip":
        import gzip

        return gzip.decompress(data)
    if cid == "zstd":
        lib = _load_zstd()
        out = ctypes.create_string_buffer(nbytes)
        n = lib.ZSTD_decompress(out, nbytes, data, len(data))
        if lib.ZSTD_isError(n):
            raise RuntimeError("zstd decompression failed")
        return out.raw[:n]
    if cid == "blosc":
        lib = _load_blosc()
        out = ctypes.create_string_buffer(nbytes)
        n = lib.blosc_decompress_ctx(data, out, nbytes, 1)
        if n < 0:
            raise RuntimeError("blosc decompression failed")
        return out.raw[:n]
    raise ValueError(f"Unsupported compressor: {compressor}")


DEFAULT_COMPRESSOR: Dict[str, Any] = {"id": "zstd", "level": 3}

# ---------------------------------------------------------------------------
# Attributes
# ---------------------------------------------------------------------------


class Attrs:
    """Dict-like ``.zattrs`` view persisted on every mutation."""

    def __init__(self, path: Path, read_only: bool):
        self._path = path / ".zattrs"
        self._read_only = read_only
        self._data: Dict[str, Any] = {}
        if self._path.exists():
            self._data = json.loads(self._path.read_text())

    def _flush(self) -> None:
        _atomic_write_text(
            self._path, json.dumps(self._data, indent=2, default=_json_default))

    def _check_writable(self) -> None:
        # BEFORE mutating: a rejected write must not linger in memory and
        # get silently persisted by a later successful flush
        if self._read_only:
            raise PermissionError("store is read-only")

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._check_writable()
        self._data[key] = value
        self._flush()

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def update(self, other: Dict[str, Any]) -> None:
        self._check_writable()
        self._data.update(other)
        self._flush()

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def asdict(self) -> Dict[str, Any]:
        return dict(self._data)


def _json_default(obj: Any) -> Any:
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError(f"not JSON serializable: {type(obj)}")


def _atomic_write_bytes(path: Path, data: bytes) -> None:
    """Temp file + os.replace, like zarr's DirectoryStore: a concurrent
    reader never sees a torn chunk/metadata file."""
    import os

    tmp = path.with_name(path.name + f".tmp.{os.getpid()}")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def _atomic_write_text(path: Path, text: str) -> None:
    _atomic_write_bytes(path, text.encode())


# ---------------------------------------------------------------------------
# Array
# ---------------------------------------------------------------------------


class Array:
    def __init__(self, path: Path, read_only: bool = True):
        self.path = Path(path)
        self.read_only = read_only
        meta = json.loads((self.path / ".zarray").read_text())
        if meta.get("zarr_format") != 2:
            raise ValueError(f"Unsupported zarr format: {meta.get('zarr_format')}")
        self.shape: Tuple[int, ...] = tuple(meta["shape"])
        self.chunks: Tuple[int, ...] = tuple(meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        self.compressor: Optional[Dict[str, Any]] = meta.get("compressor")
        fv = meta.get("fill_value", 0)
        if fv is None:
            fv = 0
        elif isinstance(fv, str):
            # zarr v2 spec encodes non-finite floats as JSON strings
            fv = {"NaN": np.nan, "Infinity": np.inf,
                  "-Infinity": -np.inf}.get(fv, fv)
        self.fill_value = fv
        self.order = meta.get("order", "C")
        if self.order != "C":
            raise ValueError("only C-order arrays are supported")
        if meta.get("filters"):
            raise ValueError("zarr filters are not supported")
        self.sep = meta.get("dimension_separator", ".")
        self.attrs = Attrs(self.path, read_only)

    # -- metadata ----------------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def nchunks_per_dim(self) -> Tuple[int, ...]:
        return tuple(-(-s // c) for s, c in zip(self.shape, self.chunks))

    def __len__(self) -> int:
        return self.shape[0]

    def _chunk_path(self, cidx: Tuple[int, ...]) -> Path:
        return self.path / self.sep.join(str(i) for i in cidx)

    def _chunk_nbytes(self) -> int:
        return int(np.prod(self.chunks)) * self.dtype.itemsize

    # -- read --------------------------------------------------------------
    def _read_chunk(self, cidx: Tuple[int, ...]) -> np.ndarray:
        p = self._chunk_path(cidx)
        if not p.exists():
            return np.full(self.chunks, self.fill_value, dtype=self.dtype)
        raw = decompress(p.read_bytes(), self.compressor, self._chunk_nbytes())
        return np.frombuffer(raw, dtype=self.dtype).reshape(self.chunks)

    def __getitem__(self, key: Any) -> np.ndarray:
        starts, stops, out_shape, keep = _normalize_key(key, self.shape)
        if self._native_reads(starts, stops):
            return self._read_native(starts, stops).reshape(out_shape)
        return self._read_plain(starts, stops).reshape(out_shape)

    def _native_reads(self, starts, stops) -> bool:
        """Whether the host-IO core reads this window: a uint8 3-D fill-0
        array in a codec the core decodes, and a window that is not empty."""
        comp_id = None if self.compressor is None else self.compressor.get("id")
        return (self.dtype == np.uint8 and self.ndim == 3 and self.fill_value == 0
                and comp_id in native.CODECS
                and all(stop > start for start, stop in zip(starts, stops)))

    def _read_native(self, starts, stops) -> np.ndarray:
        """The window through the host-IO core (its chunks decoded in C++,
        without the interpreter lock); raises naming a chunk that cannot be
        read or decoded."""
        chunk_list = []
        for cidx in _chunks_overlapping(starts, stops, self.chunks):
            p = self._chunk_path(cidx)
            chunk_list.append((cidx, p if p.exists() else None))
        comp_id = None if self.compressor is None else self.compressor.get("id")
        window = tuple(stop - start for start, stop in zip(starts, stops))
        return native.read_window_u8(chunk_list, self.chunks, starts, window, comp_id)

    def _read_plain(self, starts, stops) -> np.ndarray:
        """The window by the pure-Python chunk loop: every array the core
        does not read, and the plain version of the core's reads."""
        out = np.empty([stop - start for start, stop in zip(starts, stops)], dtype=self.dtype)
        for cidx in _chunks_overlapping(starts, stops, self.chunks):
            chunk = self._read_chunk(cidx)
            src_sel, dst_sel = _chunk_selections(cidx, self.chunks, starts, stops, self.shape)
            out[dst_sel] = chunk[src_sel]
        return out

    # -- write -------------------------------------------------------------
    def __setitem__(self, key: Any, value: Any) -> None:
        if self.read_only:
            raise PermissionError("array is read-only")
        starts, stops, out_shape, _ = _normalize_key(key, self.shape)
        sel_shape = tuple(stop - start for start, stop in zip(starts, stops))
        value = np.asarray(value, dtype=self.dtype)
        value = np.broadcast_to(value, sel_shape) if value.shape != sel_shape else value
        for cidx in _chunks_overlapping(starts, stops, self.chunks):
            src_sel, dst_sel = _chunk_selections(cidx, self.chunks, starts, stops, self.shape)
            full_chunk = all(
                s.start == 0 and s.stop == c
                for s, c in zip(src_sel, self.chunks)
            )
            if full_chunk:
                chunk = np.ascontiguousarray(value[dst_sel])
            else:
                chunk = self._read_chunk(cidx).copy()
                chunk[src_sel] = value[dst_sel]
            raw = chunk.tobytes()
            payload = compress(raw, self.compressor, self.dtype.itemsize)
            cp = self._chunk_path(cidx)
            if self.sep == "/":
                cp.parent.mkdir(parents=True, exist_ok=True)
            _atomic_write_bytes(cp, payload)

    def __array__(self, dtype=None) -> np.ndarray:
        arr = self[...]
        return arr.astype(dtype) if dtype is not None else arr


def _normalize_key(key: Any, shape: Tuple[int, ...]):
    """Normalize basic indexing to per-dim (start, stop); ints squeeze dims."""
    if key is Ellipsis:
        key = tuple(slice(None) for _ in shape)
    if not isinstance(key, tuple):
        key = (key,)
    key = list(key)
    if Ellipsis in key:
        i = key.index(Ellipsis)
        key[i:i + 1] = [slice(None)] * (len(shape) - len(key) + 1)
    if len(key) > len(shape):
        raise IndexError(
            f"too many indices: {len(key)} for a {len(shape)}-d array")
    while len(key) < len(shape):
        key.append(slice(None))
    starts: List[int] = []
    stops: List[int] = []
    out_shape: List[int] = []
    for k, n in zip(key, shape):
        if isinstance(k, (int, np.integer)):
            k = int(k)
            if k < 0:
                k += n
            if not 0 <= k < n:
                raise IndexError(f"index {k} out of bounds for dim of size {n}")
            starts.append(k)
            stops.append(k + 1)
        elif isinstance(k, slice):
            start, stop, step = k.indices(n)
            if step != 1:
                raise IndexError("only contiguous (step-1) slices are supported")
            stop = max(stop, start)
            starts.append(start)
            stops.append(stop)
            out_shape.append(stop - start)
        else:
            raise IndexError(f"unsupported index: {k!r}")
    return tuple(starts), tuple(stops), tuple(out_shape), len(out_shape)


def _chunks_overlapping(starts, stops, chunks) -> Iterator[Tuple[int, ...]]:
    ranges = []
    for start, stop, c in zip(starts, stops, chunks):
        if stop <= start:
            return
        ranges.append(range(start // c, (stop - 1) // c + 1))
    import itertools

    yield from itertools.product(*ranges)


def _chunk_selections(cidx, chunks, starts, stops, shape):
    src_sel = []
    dst_sel = []
    for i, (ci, c, start, stop) in enumerate(zip(cidx, chunks, starts, stops)):
        c0 = ci * c
        lo = max(start, c0)
        hi = min(stop, c0 + c)
        src_sel.append(slice(lo - c0, hi - c0))
        dst_sel.append(slice(lo - start, hi - start))
    return tuple(src_sel), tuple(dst_sel)


# ---------------------------------------------------------------------------
# Group
# ---------------------------------------------------------------------------


class Group:
    def __init__(self, path: Path, read_only: bool = True):
        self.path = Path(path)
        self.read_only = read_only
        self.attrs = Attrs(self.path, read_only)

    def _child(self, name: str) -> Path:
        return self.path / name

    def __contains__(self, name: str) -> bool:
        p = self._child(name)
        return (p / ".zarray").exists() or (p / ".zgroup").exists()

    def __getitem__(self, name: str) -> "Group | Array":
        p = self.path
        for part in str(name).split("/"):
            p = p / part
        if (p / ".zarray").exists():
            return Array(p, read_only=self.read_only)
        if (p / ".zgroup").exists():
            return Group(p, read_only=self.read_only)
        raise KeyError(name)

    def array_keys(self) -> List[str]:
        return sorted(
            d.name for d in self.path.iterdir() if d.is_dir() and (d / ".zarray").exists()
        )

    def group_keys(self) -> List[str]:
        return sorted(
            d.name for d in self.path.iterdir() if d.is_dir() and (d / ".zgroup").exists()
        )

    def keys(self) -> List[str]:
        return sorted(set(self.array_keys()) | set(self.group_keys()))

    def _mark_groups_down_to(self, p: Path) -> None:
        """Write .zgroup into every directory from self.path (exclusive) down
        to ``p`` (inclusive) — nested names like 'a/b' must leave 'a' visible
        as a group (zarr-python creates intermediates implicitly)."""
        rel = p.relative_to(self.path)
        cur = self.path
        for part in rel.parts:
            cur = cur / part
            zg = cur / ".zgroup"
            if not zg.exists() and not (cur / ".zarray").exists():
                _atomic_write_text(zg, json.dumps({"zarr_format": 2}))

    def create_group(self, name: str) -> "Group":
        if self.read_only:
            raise PermissionError("store is read-only")
        p = self._child(name)
        p.mkdir(parents=True, exist_ok=True)
        self._mark_groups_down_to(p)
        return Group(p, read_only=False)

    def require_group(self, name: str) -> "Group":
        p = self._child(name)
        if (p / ".zgroup").exists():
            return Group(p, read_only=self.read_only)
        return self.create_group(name)

    def create_dataset(
        self,
        name: str,
        shape: Sequence[int],
        chunks: Optional[Sequence[int]] = None,
        dtype: Any = "float32",
        compressor: Any = "default",
        fill_value: Any = 0,
        overwrite: bool = False,
        data: Optional[np.ndarray] = None,
        dimension_separator: str = ".",
    ) -> Array:
        if self.read_only:
            raise PermissionError("store is read-only")
        p = self._child(name)
        if p.exists():
            if overwrite:
                shutil.rmtree(p)
            elif (p / ".zarray").exists():
                raise FileExistsError(name)
            elif (p / ".zgroup").exists():
                # zarr-python raises ContainsGroupError: writing .zarray
                # into a group dir would shadow its children
                raise FileExistsError(f"a group already exists at {name!r}")
        p.mkdir(parents=True, exist_ok=True)
        if p.parent != self.path:
            self._mark_groups_down_to(p.parent)  # 'a/b' leaves 'a' a group
        shape = tuple(int(s) for s in shape)
        if chunks is None:
            chunks = shape
        chunks = tuple(min(int(c), s) if s > 0 else int(c) for c, s in zip(chunks, shape))
        comp = DEFAULT_COMPRESSOR if compressor == "default" else compressor
        dt = np.dtype(dtype)
        if isinstance(fill_value, (float, np.floating)):
            fill_value = float(fill_value)
            if np.isnan(fill_value):
                fill_value = "NaN"        # zarr v2 spec: non-finite floats
            elif np.isinf(fill_value):    # are JSON strings
                fill_value = "Infinity" if fill_value > 0 else "-Infinity"
        meta = {
            "zarr_format": 2,
            "shape": list(shape),
            "chunks": list(chunks),
            "dtype": dt.str,
            "compressor": comp,
            "fill_value": fill_value,
            "order": "C",
            "filters": None,
        }
        if dimension_separator != ".":
            # zarr-python 2.x omits the key for the default "." separator
            # (cross-validated: tests/test_zarrlite_fixture.py)
            meta["dimension_separator"] = dimension_separator
        _atomic_write_text(p / ".zarray",
                           json.dumps(meta, indent=2, default=_json_default))
        arr = Array(p, read_only=False)
        if data is not None:
            arr[...] = data
        return arr

    # zarr-python also exposes arrays via ``array(name, data)``
    def array(self, name: str, data: np.ndarray, chunks=None, **kw) -> Array:
        data = np.asarray(data)
        return self.create_dataset(
            name, shape=data.shape, chunks=chunks, dtype=data.dtype, data=data, **kw
        )


# ---------------------------------------------------------------------------
# open helpers (zarr-compatible entry points)
# ---------------------------------------------------------------------------


def open_group(path: str | Path, mode: str = "r") -> Group:
    path = Path(path)
    if mode in ("r", "r+"):
        if not (path / ".zgroup").exists():
            raise FileNotFoundError(f"no zarr group at {path}")
        return Group(path, read_only=(mode == "r"))
    if mode == "w":
        if path.exists():
            shutil.rmtree(path)
    path.mkdir(parents=True, exist_ok=True)
    if not (path / ".zgroup").exists():
        (path / ".zgroup").write_text(json.dumps({"zarr_format": 2}))
    return Group(path, read_only=False)


def open(path: str | Path, mode: str = "r") -> "Group | Array":  # noqa: A001
    path = Path(path)
    if mode == "w":
        # zarr-python semantics: 'w' clobbers any existing store
        return open_group(path, mode="w")
    if mode == "w-" and ((path / ".zarray").exists()
                         or (path / ".zgroup").exists()):
        raise FileExistsError(f"zarr store already exists at {path}")
    if (path / ".zarray").exists():
        return Array(path, read_only=(mode == "r"))
    if (path / ".zgroup").exists():
        return Group(path, read_only=(mode == "r"))
    if mode in ("a", "w-"):
        return open_group(path, mode="a")
    raise FileNotFoundError(f"no zarr store at {path}")
