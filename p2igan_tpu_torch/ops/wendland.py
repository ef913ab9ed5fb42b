"""Wendland-C2 radial bases for the DeepKriging model family.

Reference semantics: ``p2igan_bench/models/dk.py:27-135`` (2D multi-resolution
subsampled basis, support radius 4.0 x spacing) and ``models/stdk.py:38-93``
(1D temporal basis, support radius 2.5 x spacing). The bases are deterministic
functions of (H, W) / T, so they are precomputed once on host (numpy, cached)
and handed to the model as constants (counterpart of
``p2igan_tpu/ops/wendland.py``, the same arrays bit for bit).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np


def wendland_c2(d: np.ndarray) -> np.ndarray:
    """Compactly supported Wendland C2 basis; d is a normalized distance."""
    d = np.asarray(d)
    dm = np.minimum(d, 1.0)
    val = ((1.0 - dm) ** 6) * (35.0 * dm ** 2 + 18.0 * dm + 3.0) / 3.0
    return np.where(d <= 1.0, val, 0.0)


def _subsample_uniform(knots: np.ndarray, M: int) -> np.ndarray:
    """Evenly spaced index subsampling (dk.py:59-65, round-half-to-even)."""
    K_full = knots.shape[0]
    if M >= K_full:
        return knots
    idx = np.linspace(0, K_full - 1, num=M)
    idx = np.clip(np.round(idx).astype(np.int64), 0, K_full - 1)
    return knots[idx]


def _auto_spacings(extent: int, n_levels: int) -> list[int]:
    base = max(1, int(round(extent / 4)))
    return [max(1, base // (2 ** i)) for i in range(n_levels)]


def build_space_knots(
    H: int, W: int,
    num_basis_per_level: Sequence[int] = (10, 19, 37, 73),
    spacings: Sequence[int] | None = None,
    radius_mult: float = 4.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Multi-resolution subsampled 2D knots + per-knot support radii."""
    if spacings is None:
        spacings = _auto_spacings(min(H, W), len(num_basis_per_level))
    else:
        spacings = list(spacings)
        assert len(spacings) == len(num_basis_per_level)
    knots_all, theta_all = [], []
    for M, sp in zip(num_basis_per_level, spacings):
        ys = np.arange(0, H, sp)
        xs = np.arange(0, W, sp)
        yy, xx = np.meshgrid(ys, xs, indexing="ij")
        knots_full = np.stack([yy, xx], axis=-1).reshape(-1, 2)
        knots_sub = _subsample_uniform(knots_full, M)
        knots_all.append(knots_sub)
        theta_all.append(np.full((knots_sub.shape[0],), radius_mult * float(sp)))
    return np.concatenate(knots_all, 0).astype(np.float64), np.concatenate(theta_all, 0)


@functools.lru_cache(maxsize=16)
def build_phi_space(
    H: int, W: int,
    num_basis_per_level: Tuple[int, ...] = (10, 19, 37, 73),
    spacings: Tuple[int, ...] | None = None,
) -> np.ndarray:
    """(H*W, K_s) float32 spatial Wendland features for every pixel."""
    knots, theta = build_space_knots(H, W, num_basis_per_level, spacings, radius_mult=4.0)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    grid = np.stack([ys, xs], axis=-1).reshape(-1, 2).astype(np.float64)
    d = np.sqrt(((grid[:, None, :] - knots[None, :, :]) ** 2).sum(-1))
    phi = wendland_c2(d / theta[None, :])
    return phi.astype(np.float32)


def build_time_knots(
    T: int,
    num_basis: Sequence[int] = (10, 19, 37, 73),
    spacings: Sequence[int] | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    if spacings is None:
        spacings = _auto_spacings(T, len(num_basis))
    else:
        spacings = list(spacings)
        assert len(spacings) == len(num_basis)
    knots_all, theta_all = [], []
    for M, sp in zip(num_basis, spacings):
        knots_full = np.arange(0, T, sp).reshape(-1, 1)
        knots_sub = _subsample_uniform(knots_full, M)
        knots_all.append(knots_sub)
        theta_all.append(np.full((knots_sub.shape[0],), 2.5 * float(sp)))
    return np.concatenate(knots_all, 0).astype(np.float64), np.concatenate(theta_all, 0)


@functools.lru_cache(maxsize=16)
def build_phi_time(
    T: int,
    num_basis: Tuple[int, ...] = (10, 19, 37, 73),
    spacings: Tuple[int, ...] | None = None,
) -> np.ndarray:
    """(T, K_t) float32 temporal Wendland features."""
    knots, theta = build_time_knots(T, num_basis, spacings)
    grid = np.arange(T, dtype=np.float64).reshape(-1, 1)
    d = np.abs(grid - knots.T)
    phi = wendland_c2(d / theta[None, :])
    return phi.astype(np.float32)


def time_basis_count(T: int, num_basis: Tuple[int, ...] = (10, 19, 37, 73)) -> int:
    """K_t depends on T via subsampling (stdk.py:118-121)."""
    knots, _ = build_time_knots(T, num_basis)
    return knots.shape[0]
