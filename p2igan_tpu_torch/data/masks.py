"""Observation masks: on the host (numpy) and as tensors (torch).

Counterpart of ``p2igan_tpu/data/masks.py`` (reference
``p2igan_bench/data/sti_dataset.py:18-122``). Convention: mask == 1 means
observed; masked = video * mask.

The numpy half (:func:`create_mask_np`) feeds the loaders. The torch half
(:func:`create_mask` and the five generators under it) is the counterpart of
the JAX package's pure functions of a key: functions of a ``torch.Generator``,
on the generator's device, vectorized (no per-block loop). Their random
streams are PyTorch's, so a seed gives another mask than the same seed in JAX
or numpy; the invariants are the same.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def _sti_matrix_np(rng: np.random.Generator, H: int, W: int,
                   block_size: int) -> np.ndarray:
    """(H, W) float32 with exactly one 1 in each block_size x block_size cell.

    One vectorized draw: the bounds of (row, column) of every cell, row-major
    and interleaved, go to a single ``rng.integers`` call, which draws them one
    after the other exactly as the reference's per-cell loop of scalar calls
    does. The mask and the generator's state afterwards equal the loop's (the
    JAX package's ``_sti_matrix_np``), at a tenth of the host time: 169 cells a
    mask at block size 10, 1024 at 4, twelve masks a batch, in loader threads
    that share the interpreter with the thread that launches the step."""
    h0 = np.arange(0, H, block_size)
    w0 = np.arange(0, W, block_size)
    low = np.empty((len(h0), len(w0), 2), dtype=np.int64)
    high = np.empty_like(low)
    low[..., 0], low[..., 1] = h0[:, None], w0[None, :]
    high[..., 0] = np.minimum(h0 + block_size, H)[:, None]
    high[..., 1] = np.minimum(w0 + block_size, W)[None, :]
    drawn = rng.integers(low.reshape(-1), high.reshape(-1)).reshape(low.shape)
    mat = np.zeros((H, W), dtype=np.float32)
    mat[drawn[..., 0], drawn[..., 1]] = 1.0
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


# -- torch generators (functions of a torch.Generator; static sizes) ----------

def _sti_matrix(generator: torch.Generator, H: int, W: int,
                block_size: int) -> torch.Tensor:
    """(H, W) float32 sti pattern: one observed pixel in each block_size x
    block_size cell, drawn for all cells at once; edge cells are smaller."""
    dev = generator.device
    nh, nw = -(-H // block_size), -(-W // block_size)
    h0 = torch.arange(nh, device=dev) * block_size
    w0 = torch.arange(nw, device=dev) * block_size
    bh = torch.clamp(H - h0, max=block_size)
    bw = torch.clamp(W - w0, max=block_size)
    uh = torch.rand((nh, nw), generator=generator, device=dev)
    uw = torch.rand((nh, nw), generator=generator, device=dev)
    ph = h0[:, None] + torch.floor(uh * bh[:, None]).long()
    pw = w0[None, :] + torch.floor(uw * bw[None, :]).long()
    mat = torch.zeros((H * W,), dtype=torch.float32, device=dev)
    mat[(ph * W + pw).reshape(-1)] = 1.0
    return mat.reshape(H, W)


def _over_frames(frame_on: torch.Tensor, H: int, W: int, C: int) -> torch.Tensor:
    """(T,) per-frame 0/1 -> (T, H, W, C)."""
    return frame_on.to(torch.float32)[:, None, None, None].expand(-1, H, W, C)


def sti_mask(generator: torch.Generator, T: int, H: int, W: int, C: int = 1,
             block_size: int = 4) -> torch.Tensor:
    mat = _sti_matrix(generator, H, W, block_size)
    return mat[None, :, :, None].expand(T, H, W, C)


def fi_mask(generator: torch.Generator, T: int, H: int, W: int, C: int = 1,
            interval: Sequence[int] = (2, 5)) -> torch.Tensor:
    dev = generator.device
    choice = torch.randint(len(interval), (), generator=generator, device=dev)
    chosen = torch.as_tensor(list(interval), device=dev)[choice]
    return _over_frames(torch.arange(T, device=dev) % (chosen + 1) == 0, H, W, C)


def nowcasting_mask(T: int, H: int, W: int, C: int = 1, keep: int = 4,
                    device=None) -> torch.Tensor:
    return _over_frames(torch.arange(T, device=device) < keep, H, W, C)


def stin_mask(generator: torch.Generator, T: int, H: int, W: int, C: int = 1,
              block_size: int = 4, keep: int = 4) -> torch.Tensor:
    if keep >= T:
        return torch.ones((T, H, W, C), dtype=torch.float32,
                          device=generator.device)
    base = sti_mask(generator, T, H, W, C, block_size)
    frame_keep = (torch.arange(T, device=generator.device) < keep)[:, None, None, None]
    return torch.where(frame_keep, torch.ones_like(base), base)


def stis_mask(mask_matrix: torch.Tensor, T: int, C: int = 1) -> torch.Tensor:
    """Broadcast a fixed (H, W) gauge mask over frames and channels."""
    H, W = mask_matrix.shape
    return mask_matrix.to(torch.float32)[None, :, :, None].expand(T, H, W, C)


def create_mask(
    generator: torch.Generator,
    shape: Tuple[int, int, int, int],
    mask_type: str = "sti",
    mask_matrix: Optional[torch.Tensor] = None,
    block_sizes: Sequence[int] = (4,),
    keep: int = 4,
    interval: Sequence[int] = (2, 5),
) -> torch.Tensor:
    """(T, H, W, C) float32 mask of one of the five types, drawn from
    ``generator`` on its device. With several ``block_sizes`` one is drawn
    first (a host read of one integer: the block grid's shape depends on it)."""
    T, H, W, C = shape
    if mask_type in ("sti", "stin"):
        sizes = list(block_sizes)
        size = sizes[0]
        if len(sizes) > 1:
            size = sizes[int(torch.randint(len(sizes), (), generator=generator,
                                           device=generator.device))]
        if mask_type == "sti":
            return sti_mask(generator, T, H, W, C, block_size=size)
        return stin_mask(generator, T, H, W, C, block_size=size, keep=keep)
    if mask_type == "fi":
        return fi_mask(generator, T, H, W, C, interval)
    if mask_type == "nowcasting":
        return nowcasting_mask(T, H, W, C, keep, device=generator.device)
    if mask_type == "stis":
        if mask_matrix is None:
            raise ValueError("mask_matrix required for 'stis'")
        return stis_mask(mask_matrix, T, C)
    raise ValueError(f"Invalid mask type: {mask_type!r}")
