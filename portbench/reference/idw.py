"""Plain inverse-distance-weighted k nearest neighbours over a gauge mask
that is the same in every frame (upstream ``p2igan_bench`` InputBlock).

The observed points are every (frame, gauge) pair. Each output voxel (frame
z, pixel p) averages the values of k of them with weights
``1 / (d + tau)^2``: ``sum(w v) / (sum(w) + 1e-12)``, d the euclidean
distance in normalised coordinates (a query at ``linspace(0, 1, n)``, a
point at ``index / (n - 1)``), in float32 with each operation rounded.

Which k: the rule of the JAX package's factored IDW, which the port is
tested against. First the pixel's k nearest gauges by squared planar
distance ``dx^2 + dy^2``, the lowest pixel index first among equal ones;
then, of those gauges in every frame, the k nearest pairs by the correctly
rounded ``sqrt((dx^2 + dy^2) + dz^2)``, the lowest (frame, gauge pixel)
first among equal ones. (Two gauges whose squared distances differ by one
unit in the last place can share one rounded distance: the first step
settles those.) Found here by brute force over every gauge; the selection
depends on the mask alone and is made once, and the values are combined
every forward, differentiably.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def select(mask_hw: np.ndarray, frames: int, k: int = 4, tau: float = 0.05,
           device="cpu", block: int = 4096
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """For every voxel of a (frames, H, W) field under the (H, W) 0/1 mask:
    (idx (D*HW, k) into the D*G points, weights (D*HW, k), denominators
    (D*HW,), gauge pixels (G,))."""
    H, W = mask_hw.shape
    D = frames
    gauges = np.flatnonzero(mask_hw.reshape(-1) > 0)
    gy, gx = np.divmod(gauges, W)
    px = (gx.astype(np.float32) / np.float32(max(W - 1, 1))).astype(np.float32)
    py = (gy.astype(np.float32) / np.float32(max(H - 1, 1))).astype(np.float32)
    qx = np.tile(np.linspace(0, 1, W, dtype=np.float32), H)
    qy = np.repeat(np.linspace(0, 1, H, dtype=np.float32), W)
    qz = np.linspace(0, 1, D, dtype=np.float32)
    pz = (np.arange(D, dtype=np.float32) / np.float32(max(D - 1, 1))).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    px, py, qx, qy = t(px), t(py), t(qx), t(qy)
    dz = t(qz)[:, None] - t(pz)[None, :]
    dz2 = dz * dz                                                    # (D query, D point)
    G, HW = len(gauges), H * W
    idx = torch.empty((D, HW, k), dtype=torch.long, device=device)
    wts = torch.empty((D, HW, k), dtype=torch.float32, device=device)
    for lo in range(0, HW, block):
        dx = qx[lo:lo + block, None] - px[None, :]
        dy = qy[lo:lo + block, None] - py[None, :]
        dxy = dx * dx + dy * dy                                      # (b, G)
        near = torch.sort(torch.sort(dxy, dim=1, stable=True).indices[:, :k], dim=1).values
        gd2 = torch.gather(dxy, 1, near)                             # (b, k), pixel order
        for z in range(D):
            d = _sqrt_rn(dz2[z][None, :, None] + gd2[:, None, :])    # (b, D, k) frame-major
            d = d.reshape(d.shape[0], D * k)
            order = torch.sort(d, dim=1, stable=True).indices[:, :k]
            best = torch.gather(d, 1, order)
            inv = 1.0 / (best + tau)
            idx[z, lo:lo + block] = (order // k) * G + torch.gather(near, 1, order % k)
            wts[z, lo:lo + block] = inv * inv
    idx, wts = idx.reshape(D * HW, k), wts.reshape(D * HW, k)
    return idx, wts, wts.sum(dim=1) + 1e-12, t(gauges).long()


def apply(values: torch.Tensor, selection) -> torch.Tensor:
    """values (B, D, H, W) -> the densified (B, D, H, W) field."""
    idx, wts, denom, gauges = selection
    B, D, H, W = values.shape
    points = values.reshape(B, D, H * W)[:, :, gauges].reshape(B, -1)   # (B, D*G)
    picked = points[:, idx]                                             # (B, D*HW, k)
    return ((picked * wts).sum(dim=-1) / denom).reshape(B, D, H, W)
