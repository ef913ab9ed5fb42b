"""Factored inverse-distance-weighted k-NN (the P2IGAN "point-to-image" op).

PyTorch counterpart of ``p2igan_tpu/ops/idw.py``, limited to the factored path
that frame-constant gauge masks (stis) take: the observation set factorizes as
{G gauge pixels} x {D frames}, so every pixel's global top-k pairs one of its k
nearest gauges with some frame. The mask-derived stage
(:func:`factored_prepare_full`) runs once per mask; the value stage
(:func:`factored_apply_gauges_batch`) runs every forward. The hand-written
kernels behind both live in :mod:`.idw_factored_kernel`.

Layouts follow the JAX package: gd2/gsel are (HW, k), gauge tables (N, D, G).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def grid_points(D: int, H: int, W: int) -> np.ndarray:
    """(Q, 3) normalized grid coordinates, columns (x, y, z), x fastest."""
    z = np.linspace(0, 1, D, dtype=np.float32)
    y = np.linspace(0, 1, H, dtype=np.float32)
    x = np.linspace(0, 1, W, dtype=np.float32)
    gz, gy, gx = np.meshgrid(z, y, x, indexing="ij")
    return np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)


def round_up(n: int, m: int) -> int:
    """Smallest multiple of ``m`` >= ``n``."""
    return -(-n // m) * m


@functools.lru_cache(maxsize=8)
def frame_dz2_np(D: int) -> np.ndarray:
    """(D query z, D frames) squared z-distances, exactly as the grid/point
    normalizations produce them (grid linspace vs point idx/(D-1))."""
    zq = np.linspace(0, 1, D, dtype=np.float32)
    zp = (np.arange(D, dtype=np.float32) / max(D - 1, 1)).astype(np.float32)
    return (zq[:, None] - zp[None, :]) ** 2


def gauge_geometry(mask_xy: torch.Tensor, max_gauges: int):
    """Inputs of the gauge top-k for an (H, W) mask (>0 = observed).

    Returns (qx, qy) (HW,) pixel coords, (gx, gy, penalty) (G=max_gauges,)
    gauge-slot coords and 0/1e30 validity penalty, and gauge_pix (G,) the flat
    pixel of each slot (HW-1 for padding slots). Slots ascend in pixel order;
    observed gauges beyond ``max_gauges`` are dropped, as in the JAX package's
    static ``nonzero(size=...)`` (callers bound the budget,
    ``P2IGenerator.prepare_idw``)."""
    # Computed on the host in numpy: PyTorch's CUDA division by a scalar
    # multiplies by its reciprocal, which moves gauge coordinates by an ULP and
    # flips exact distance ties against the reference.
    H, W = mask_xy.shape
    HW = H * W
    (obs,) = np.nonzero(mask_xy.detach().cpu().numpy().reshape(-1) > 0)
    gidx = np.full((max_gauges,), HW, dtype=np.int64)
    n = min(len(obs), max_gauges)
    gidx[:n] = obs[:n]
    safe = np.minimum(gidx, HW - 1)
    gy = (safe // W).astype(np.float32) / np.float32(max(H - 1, 1))
    gx = (safe % W).astype(np.float32) / np.float32(max(W - 1, 1))
    penalty = np.where(gidx < HW, np.float32(0), np.float32(1e30)).astype(np.float32)
    # pixel coords match grid_points()' linspace bit for bit; gauge coords use
    # idx/(N-1) like the reference's point normalization
    qy = np.repeat(np.linspace(0, 1, H, dtype=np.float32), W)
    qx = np.tile(np.linspace(0, 1, W, dtype=np.float32), H)
    return tuple(torch.from_numpy(a).to(mask_xy.device)
                 for a in (qx, qy, gx, gy, penalty, safe))


def factored_prepare_full(mask_xy: torch.Tensor, max_gauges: int, k: int = 4
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mask-derived stage of the factored IDW.

    Returns gd2 (HW, k) top-k gauge distances^2 per pixel, gsel (HW, k)
    gauge-slot indices reordered ascending by slot (= gauge pixel) so the
    lowest-index tie rule is the reference's flat order, and gauge_pix (G,)."""
    from .idw_factored_kernel import gauge_topk

    qx, qy, gx, gy, penalty, gauge_pix = gauge_geometry(mask_xy, max_gauges)
    gd2_t, gsel_t = gauge_topk(qx, qy, gx, gy, penalty, k=k)
    gp_cols = list(gsel_t.unbind(0))
    gd_cols = list(gd2_t.unbind(0))

    def swap(i, j):
        lt = gp_cols[i] <= gp_cols[j]
        gp_cols[i], gp_cols[j] = (torch.where(lt, gp_cols[i], gp_cols[j]),
                                  torch.where(lt, gp_cols[j], gp_cols[i]))
        gd_cols[i], gd_cols[j] = (torch.where(lt, gd_cols[i], gd_cols[j]),
                                  torch.where(lt, gd_cols[j], gd_cols[i]))

    if k == 4:  # the JAX package's compare-swap network
        for i, j in ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)):
            swap(i, j)
    else:  # generic bubble network
        for end in range(k - 1, 0, -1):
            for i in range(end):
                swap(i, i + 1)
    return torch.stack(gd_cols, dim=1), torch.stack(gp_cols, dim=1), gauge_pix


def factored_apply_gauges_batch(gd2: torch.Tensor, gsel: torch.Tensor,
                                gauge_vals: torch.Tensor, out_hw: Tuple[int, int],
                                k: int = 4, rho: float = 2.0, tau: float = 0.05
                                ) -> torch.Tensor:
    """IDW densification of N windows sharing one mask: gd2/gsel (HW, k) from
    :func:`factored_prepare_full`, gauge_vals (N, D, G) values at the gauge
    slots. The selection runs once per pixel and serves every window.
    Returns (N, D, H, W)."""
    from .idw_factored_kernel import combine_table_multi

    H, W = out_hw
    N, D, _ = gauge_vals.shape
    out = combine_table_multi(gd2.t().contiguous(), gsel.t().contiguous(),
                              gauge_vals.contiguous(), k=k, rho=rho, tau=tau)
    return out.reshape(N, D, H, W)


def factored_apply_gauges(gd2: torch.Tensor, gsel: torch.Tensor,
                          gauge_vals: torch.Tensor, out_hw: Tuple[int, int],
                          k: int = 4, rho: float = 2.0, tau: float = 0.05
                          ) -> torch.Tensor:
    """Single-window :func:`factored_apply_gauges_batch`: gauge_vals (D, G) ->
    (D, H, W)."""
    return factored_apply_gauges_batch(gd2, gsel, gauge_vals[None], out_hw,
                                       k=k, rho=rho, tau=tau)[0]


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt. PyTorch's vectorized CPU float32 sqrt
    is not (it misrounds ~0.7% of inputs by one ULP), which flips the IDW's
    exact distance ties; the float64 sqrt rounded to float32 is exact."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _factored_combine_xla(gd2: torch.Tensor, cvals: torch.Tensor,
                          dz2: torch.Tensor, k: int, rho: float, tau: float
                          ) -> torch.Tensor:
    """Reference candidate combine over all D frames (``p2igan_tpu/ops/idw.py
    _factored_combine_xla``): gd2 (HW, k), cvals (..., HW, D*k) frame-major
    candidate values, dz2 (D, D). Returns (..., D, HW).

    The selection depends only on geometry, so it runs once per z and serves
    every leading (window) index; the arithmetic per window is the
    reference's, round by round."""
    from .idw_factored_kernel import first_min_index

    HW = gd2.shape[0]
    D = dz2.shape[0]
    bigd = _sqrt_rn(torch.tensor(1e30, dtype=torch.float32, device=gd2.device))
    col = torch.arange(D * k, device=gd2.device, dtype=torch.int32)
    col = col[None, :].expand(HW, D * k)
    lead = cvals.shape[:-2]
    rows = []
    for z in range(D):
        cd = _sqrt_rn(gd2[:, None, :] + dz2[z][None, :, None]).reshape(HW, D * k)
        cd = torch.where(cd < bigd, cd, bigd)
        w_sum = torch.zeros((HW,), dtype=torch.float32, device=gd2.device)
        wv_sum = torch.zeros(lead + (HW,), dtype=torch.float32, device=gd2.device)
        for _ in range(k):
            d_min = cd.amin(dim=-1)
            idx = first_min_index(cd, d_min[:, None], col, dim=-1)
            v = torch.gather(cvals, -1, idx.long().expand(lead + (HW,))[..., None])[..., 0]
            if abs(rho - 2.0) < 1e-6:
                invd = 1.0 / (d_min + tau)
                w = invd * invd
            else:
                w = 1.0 / torch.pow(d_min + tau, rho)
            w = torch.where(d_min < bigd, w, torch.zeros_like(w))
            w_sum = w_sum + w
            wv_sum = wv_sum + w * v
            cd = torch.where(col == idx[:, None], bigd, cd)
        rows.append(wv_sum / (w_sum + 1e-12))
    return torch.stack(rows, dim=-2)
