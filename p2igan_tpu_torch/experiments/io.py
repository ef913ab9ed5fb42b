"""Offline-eval I/O helpers: the port's counterpart of ``experiments/io.py``.

Store loading (through the port's own ``zarrlite``) and the run-artifact
writers work on the host: the loaders return numpy arrays. The array helpers
(shape normalization, center crop, length alignment, masked selection) take
numpy arrays or tensors alike and keep the tensor's device, so the scoring
functions move the loaded arrays to their device (:func:`to_device`) and
select there.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, is_dataclass
from typing import Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch

from ..data import zarrlite

ArrayOrEvents = Union[np.ndarray, Dict[str, np.ndarray]]


def to_device(arr, device: torch.device) -> torch.Tensor:
    """A host array (or a tensor) as a tensor on ``device``, dtype kept."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def ensure_thw(arr):
    """Normalize any of the pipeline's array layouts to (T, H, W).

    Accepts (T,H,W), a leading singleton batch (1,T,C,H,W), a singleton
    channel in torch position (T,1,H,W) or channel-last position (T,H,W,1),
    squeezing in that order until three dims remain.
    """
    squeeze_order = (
        lambda a: a[0] if a.ndim == 5 and a.shape[0] == 1 else a,
        lambda a: a[:, 0] if a.ndim == 4 and a.shape[1] == 1 else a,
        lambda a: a[..., 0] if a.ndim == 4 and a.shape[-1] == 1 else a,
    )
    for fn in squeeze_order:
        arr = fn(arr)
    if arr.ndim != 3:
        raise ValueError(f"Expected [T,H,W], got shape {tuple(arr.shape)}")
    return arr


def crop_center(arr, size: int):
    """Center-crop the spatial dims of a (T, H, W)-normalizable array."""
    arr = ensure_thw(arr)
    _, h, w = arr.shape
    if size > min(h, w):
        raise ValueError(f"crop size {size} exceeds input {h}x{w}")
    y0, x0 = (h - size) // 2, (w - size) // 2
    return arr[:, y0:y0 + size, x0:x0 + size]


def center_square(plane: np.ndarray, size: int) -> np.ndarray:
    """Center-crop a 2D (H, W) plane (gauge masks) to (size, size)."""
    h, w = plane.shape
    if size > min(h, w):
        raise ValueError(
            f"crop size {size} exceeds the ({h}, {w}) mask plane")
    y0, x0 = (h - size) // 2, (w - size) // 2
    return plane[y0:y0 + size, x0:x0 + size]


def load_mask(path: str) -> np.ndarray:
    """Whitespace txt gauge mask -> (H, W) bool."""
    return np.loadtxt(path).astype(bool)


def _event_node_array(node, name: str, path: str) -> np.ndarray:
    if isinstance(node, zarrlite.Array):
        return np.asarray(node)
    # event GROUPS (events/<ts>/frames layouts) hold their frames in a child
    # array; np.asarray(Group) would give a useless 0-d object array
    inner = node.array_keys()
    if not inner:
        raise ValueError(f"event group {name!r} in {path} contains no array")
    pick = "frames" if "frames" in inner else inner[0]
    return np.asarray(node[pick])


def load_zarr_array(path: str, key: Optional[str] = None,
                    return_events: bool = False) -> ArrayOrEvents:
    """Load a zarr store on the host.

    ``return_events=True`` yields a per-event dict keyed by the store's
    groups (or arrays); otherwise the named array (or the first one) is
    returned as a single ndarray.
    """
    store = zarrlite.open(path, mode="r")
    if isinstance(store, zarrlite.Array):
        return np.asarray(store)
    if return_events:
        keys = store.group_keys() or store.array_keys()
        if keys:
            return {name: _event_node_array(store[name], name, path) for name in keys}
    if key is not None:
        return np.asarray(store[key])
    arrays = store.array_keys()
    if not arrays:
        raise ValueError(f"No arrays found in {path}")
    return np.asarray(store[arrays[0]])


def align_length(a, b) -> Tuple:
    """Truncate both sequences to the shorter one's frame count."""
    a, b = ensure_thw(a), ensure_thw(b)
    n = min(len(a), len(b))
    return a[:n], b[:n]


def _bool_mask_like(arr, mask):
    """``mask`` as a bool array where ``arr`` lives (numpy, or its device)."""
    if not isinstance(arr, torch.Tensor):
        return np.asarray(mask, dtype=bool)
    if isinstance(mask, torch.Tensor):
        return mask.to(arr.device, torch.bool)
    return torch.from_numpy(np.asarray(mask, dtype=bool)).to(arr.device)


def select_by_mask(arr, mask, invert: bool = False):
    """Per-frame pixel selection: (T, H, W) + (H, W) mask -> (T, n_selected),
    in row-major pixel order.

    ``invert=True`` selects the held-out (unobserved) pixels: the radar
    evaluation mode; ``invert=False`` selects gauge pixels.
    """
    arr = ensure_thw(arr)
    sel = _bool_mask_like(arr, mask)
    if tuple(sel.shape) != tuple(arr.shape[1:]):
        raise ValueError(f"Mask shape {tuple(sel.shape)} != data shape "
                         f"{tuple(arr.shape[1:])}")
    sel = ~sel if invert else sel
    return arr[:, sel]


def mask_for_input(arr, mask):
    """Zero out the masked pixels of every frame (returns a copy)."""
    arr = ensure_thw(arr)
    arr = arr.clone() if isinstance(arr, torch.Tensor) else arr.copy()
    sel = _bool_mask_like(arr, mask)
    if tuple(sel.shape) != tuple(arr.shape[1:]):
        raise ValueError(f"Mask shape {tuple(sel.shape)} != data shape "
                         f"{tuple(arr.shape[1:])}")
    arr[:, sel] = 0.0
    return arr


# -- run-artifact writers ---------------------------------------------------


def ensure_dir(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def save_json(path: str, payload: Dict) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, sort_keys=True)


def save_text(path: str, lines: Iterable[str]) -> None:
    body = "\n".join(line.rstrip() for line in lines)
    with open(path, "w", encoding="utf-8") as f:
        f.write(body + ("\n" if body else ""))


def save_config_snapshot(path: str, cfg) -> None:
    """Persist the experiment config (dataclass / object / dict) as JSON."""
    if is_dataclass(cfg):
        payload = asdict(cfg)
    else:
        payload = getattr(cfg, "__dict__", cfg)
    save_json(path, payload)
