"""Observation masks on the host (numpy).

The numpy half of ``p2igan_tpu/data/masks.py`` (reference
``p2igan_bench/data/sti_dataset.py:18-122``), re-implemented because that
module imports jax. Convention: mask == 1 means observed; masked = video * mask.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np


def _sti_matrix_np(rng: np.random.Generator, H: int, W: int,
                   block_size: int) -> np.ndarray:
    """(H, W) float32 with exactly one 1 in each block_size x block_size cell."""
    mat = np.zeros((H, W), dtype=np.float32)
    for h0 in range(0, H, block_size):
        h1 = min(h0 + block_size, H)
        for w0 in range(0, W, block_size):
            w1 = min(w0 + block_size, W)
            mat[rng.integers(h0, h1), rng.integers(w0, w1)] = 1.0
    return mat


@functools.lru_cache(maxsize=16)
def load_gauge_mask(mask_file: str) -> np.ndarray:
    """Load a fixed (H, W) 0/1 gauge mask from a txt file (stis type)."""
    return np.loadtxt(Path(mask_file)).astype(bool)


def create_mask_np(
    shape: Tuple[int, int, int, int],
    rng: Optional[np.random.Generator] = None,
    mask_type: str = "sti",
    mask_file: Optional[str] = None,
    block_sizes: Sequence[int] = (4,),
    keep: int = 4,
    interval: Sequence[int] = (2, 5),
) -> np.ndarray:
    """Create a (T, H, W, C) float32 observation mask (reference create_mask)."""
    T, H, W, C = shape
    rng = rng or np.random.default_rng()

    if mask_type == "sti":
        mat = _sti_matrix_np(rng, H, W, int(rng.choice(list(block_sizes))))
        return np.broadcast_to(mat[None, :, :, None], (T, H, W, C)).astype(np.float32)

    if mask_type == "fi":
        mask = np.zeros((T, H, W, C), dtype=np.float32)
        chosen = int(rng.choice(list(interval)))
        mask[0:T:chosen + 1] = 1.0
        return mask

    if mask_type == "nowcasting":
        mask = np.ones((T, H, W, C), dtype=np.float32)
        mask[keep:] = 0.0
        return mask

    if mask_type == "stin":
        # reference quirk: only the last drawn sti pattern survives, repeated
        # over all frames, then the first `keep` frames are fully observed
        if keep >= T:
            return np.ones((T, H, W, C), dtype=np.float32)
        mat = _sti_matrix_np(rng, H, W, int(rng.choice(list(block_sizes))))
        mask = np.broadcast_to(mat[None, :, :, None], (T, H, W, C)).astype(np.float32)
        mask[:keep] = 1.0
        return mask

    if mask_type == "stis":
        if mask_file is None:
            raise ValueError("mask_file is required for 'stis' masks")
        mat = load_gauge_mask(str(mask_file))
        if mat.shape != (H, W):
            raise ValueError(f"Mask matrix in {mask_file} does not match video "
                             f"spatial dimensions {H}x{W}")
        return np.broadcast_to(mat[None, :, :, None], (T, H, W, C)).astype(np.float32)

    raise ValueError(f"Invalid mask type: {mask_type!r}")
