"""Decoder of the JAX package's checkpoints: the bytes that
``flax.serialization.to_bytes`` writes (``p2igan_tpu/training/checkpoint.py``),
read without flax or the ``msgpack`` package.

The format (flax 0.12's ``serialization.py``): one msgpack object, the state
dict of the saved pytree (dicts with string keys; tuples and lists as dicts
keyed "0", "1", ...), whose leaves are msgpack's own scalars and flax's
extension types:

- 1, an ndarray: the msgpack array (shape, dtype name, raw C-order bytes);
- 2, a Python complex: the msgpack array (real, imag);
- 3, a numpy scalar: an ndarray of shape (), returned as its scalar.

Arrays larger than ``MAX_CHUNK_SIZE`` bytes are split into chunks, a dict
``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``,
joined again here. ndarray leaves decode to numpy arrays of their dtype, except
``bfloat16`` (numpy has none without ``ml_dtypes``, which the GPU machine may
lack): those become ``torch.bfloat16`` tensors through a uint16 view of the
same bits.

:func:`msgpack_restore` is the counterpart of
``flax.serialization.msgpack_restore``; one pure-Python code path, whether or
not the ``msgpack`` package is installed.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

CHUNKED_KEY = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3

_FIXED = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
          0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    """msgpack objects from a byte buffer; ``raw`` keeps str as bytes (flax
    decodes an ndarray's header that way)."""

    def __init__(self, data: bytes, ext_hook: Callable[[int, bytes], Any], raw: bool):
        self.buf = memoryview(data)
        self.pos = 0
        self.ext_hook = ext_hook
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        data = bytes(self.take(n))
        return data if self.raw else data.decode("utf-8")

    def array(self, n: int) -> List[Any]:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        return self.ext_hook(code, bytes(self.take(n)))

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.str_(b & 0x1f)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _FIXED:
            return self.unpack(_FIXED[b])
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        length = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xc7: ">B", 0xc8: ">H", 0xc9: ">I",
                  0xd9: ">B", 0xda: ">H", 0xdb: ">I", 0xdc: ">H", 0xdd: ">I",
                  0xde: ">H", 0xdf: ">I"}.get(b)
        if length is None:
            raise ValueError(f"invalid msgpack type byte 0x{b:02x}")
        n = self.unpack(length)
        if b <= 0xc6:
            return bytes(self.take(n))
        if b <= 0xc9:
            return self.ext(n)
        if b <= 0xdb:
            return self.str_(n)
        return self.array(n) if b <= 0xdd else self.map(n)


def unpackb(data: bytes, ext_hook: Callable[[int, bytes], Any] = None,
            raw: bool = False):
    """One msgpack object from ``data`` (which it must fill exactly)."""
    reader = _Reader(data, ext_hook or (lambda code, payload: (code, payload)), raw)
    out = reader.read()
    if reader.pos != len(data):
        raise ValueError(f"{len(data) - reader.pos} bytes after the msgpack object")
    return out


def _ndarray(payload: bytes):
    """flax's ``_ndarray_from_bytes``: (shape, dtype name, buffer)."""
    shape, dtype_name, buffer = unpackb(payload, raw=True)
    shape = tuple(shape)
    if dtype_name == b"bfloat16":
        bits = np.frombuffer(buffer, dtype=np.uint16).reshape(shape).copy()
        return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape).copy()


def _ext(code: int, payload: bytes):
    if code == EXT_NDARRAY:
        return _ndarray(payload)
    if code == EXT_COMPLEX:
        real, imag = unpackb(payload)
        return complex(real, imag)
    if code == EXT_NPSCALAR:
        arr = _ndarray(payload)
        return arr if isinstance(arr, torch.Tensor) else arr[()]
    raise ValueError(f"unknown msgpack extension type {code}")


def _dict_to_tuple(d: Dict[str, Any]) -> Tuple[Any, ...]:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(node):
    """Chunked leaves joined again, anywhere in the tree."""
    if not isinstance(node, dict):
        return node
    if CHUNKED_KEY in node:
        shape = _dict_to_tuple(node["shape"])
        chunks = _dict_to_tuple(node["chunks"])
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in node.items()}


def msgpack_restore(data: bytes):
    """The tree of dicts (and lists) ``flax.serialization.msgpack_restore``
    gives for ``data``: numpy arrays (``torch.bfloat16`` tensors for bfloat16
    leaves), numpy scalars, complex, and msgpack's str, bytes, int, float,
    bool and None."""
    return _unchunk(unpackb(bytes(data), ext_hook=_ext))


def is_flax_checkpoint(head: bytes) -> bool:
    """Whether a file that starts with ``head`` can be a flax checkpoint: a
    msgpack map (a torch checkpoint is a zip archive, PK...)."""
    return bool(head) and (0x80 <= head[0] <= 0x8f or head[0] in (0xde, 0xdf))
