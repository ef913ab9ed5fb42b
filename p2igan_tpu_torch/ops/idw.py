"""Factored inverse-distance-weighted k-NN (the P2IGAN "point-to-image" op).

PyTorch counterpart of the factored half of ``p2igan_tpu/ops/idw.py``, the
path that frame-constant masks (sti, stis) take: the observation set
factorizes as {G gauge pixels} x {D frames}, so every pixel's global top-k
pairs one of its k nearest gauges with some frame. The mask-derived stage
(:func:`factored_prepare_full`, one mask or a batch of masks) is a constant of
the mask; the value stage runs every forward: :func:`factored_apply_gauges_batch`
for windows that share one mask (stis), :func:`factored_apply_gauges` for
windows that each carry their own (sti), :func:`factored_apply` /
:func:`idw_3d_factored` from a dense field. The hand-written kernels behind
all of them live in :mod:`.idw_factored_kernel`. Masks that vary per frame
(stin, fi, nowcasting) take the generic IDW: :func:`extract_points` gathers
the observed voxels into a static point budget and :func:`idw_3d_knn`
densifies them through the kernels of :mod:`.idw_kernel`.

Layouts follow the JAX package: gd2/gsel are (HW, k), gauge tables (N, D, G);
where the JAX package ``vmap``s, the port's functions take a leading batch axis.
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


@functools.lru_cache(maxsize=8)
def _pixel_tables(H: int, W: int, device: str = "cpu"):
    """(qx, qy, cx, cy) (HW,) float32 on ``device``, made on the host in numpy.

    qx/qy are the query coordinates of every pixel and match grid_points()'
    linspace bit for bit; cx/cy are the coordinates of a GAUGE at that pixel,
    idx/(N-1) like the reference's point normalization (the two differ in the
    last bit for some indices). Gauge coordinates are looked up in cx/cy: a
    division on the device would not do, since PyTorch's CUDA division by a
    scalar multiplies by its reciprocal, which moves a coordinate by an ULP and
    flips exact distance ties against the reference."""
    qy = np.repeat(np.linspace(0, 1, H, dtype=np.float32), W)
    qx = np.tile(np.linspace(0, 1, W, dtype=np.float32), H)
    pix = np.arange(H * W)
    cy = (pix // W).astype(np.float32) / np.float32(max(H - 1, 1))
    cx = (pix % W).astype(np.float32) / np.float32(max(W - 1, 1))
    return tuple(torch.from_numpy(a).to(device) for a in (qx, qy, cx, cy))


def _rank_into_slots(obs: torch.Tensor, n_slots: int) -> torch.Tensor:
    """(B, N) observed flags -> (B, n_slots) int64: the flat index of each
    slot's observation in ascending order, N for an empty slot. Observations
    beyond ``n_slots`` are dropped, as the JAX package's static
    ``nonzero(size=...)`` drops them. On the device without a host round trip:
    an observation's slot is how many observations precede it (a cumulative
    sum); the unobserved and the over-budget ones land in a spare column that
    is cut."""
    B, N = obs.shape
    rank = torch.cumsum(obs, dim=1) - 1
    dest = torch.where(obs & (rank < n_slots), rank, torch.full_like(rank, n_slots))
    flat = torch.arange(N, device=obs.device).expand(B, N)
    idx = torch.full((B, n_slots + 1), N, dtype=torch.int64, device=obs.device)
    idx.scatter_(1, dest, flat)
    return idx[:, :n_slots]


def gauge_geometry(mask_xy: torch.Tensor, max_gauges: int):
    """Inputs of the gauge top-k for an (H, W) mask (>0 = observed), or for a
    batch of masks (B, H, W): every result but qx, qy then leads with B.

    Returns (qx, qy) (HW,) pixel coords, (gx, gy, penalty) (G=max_gauges,)
    gauge-slot coords and 0/1e30 validity penalty, and gauge_pix (G,) the flat
    pixel of each slot (HW-1 for padding slots). Slots ascend in pixel order;
    observed gauges beyond ``max_gauges`` are dropped, as in the JAX package's
    static ``nonzero(size=...)`` (callers bound the budget).

    Runs on the mask's device without a host round trip (the per-sample path
    calls it every forward): a gauge's slot is its rank among the observed
    pixels (a cumulative sum), and its coordinates come from host-made
    tables."""
    lead = tuple(mask_xy.shape[:-2])
    H, W = mask_xy.shape[-2:]
    HW = H * W
    qx, qy, cx, cy = _pixel_tables(H, W, str(mask_xy.device))
    gidx = _rank_into_slots(mask_xy.reshape(-1, HW) > 0, max_gauges)
    safe = gidx.clamp(max=HW - 1)
    penalty = torch.where(gidx < HW, 0.0, 1e30).to(torch.float32)
    return (qx, qy) + tuple(t.reshape(lead + (max_gauges,)).contiguous()
                            for t in (cx[safe], cy[safe], penalty, safe))


def factored_prepare_full(mask_xy: torch.Tensor, max_gauges: int, k: int = 4
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mask-derived stage of the factored IDW for an (H, W) mask, or for a
    batch of masks (B, H, W) (the JAX package ``vmap``s it): every result then
    leads with B, and the gauge top-k of all masks is one kernel launch.

    Returns gd2 (HW, k) top-k gauge distances^2 per pixel, gsel (HW, k)
    gauge-slot indices reordered ascending by slot (= gauge pixel) so the
    lowest-index tie rule is the reference's flat order, and gauge_pix (G,)."""
    from .idw_factored_kernel import gauge_topk

    qx, qy, gx, gy, penalty, gauge_pix = gauge_geometry(mask_xy, max_gauges)
    gd2_t, gsel_t = gauge_topk(qx, qy, gx, gy, penalty, k=k)
    gp_cols = list(gsel_t.unbind(-2))
    gd_cols = list(gd2_t.unbind(-2))

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
    return torch.stack(gd_cols, dim=-1), torch.stack(gp_cols, dim=-1), gauge_pix


def factored_prepare(mask_xy: torch.Tensor, max_gauges: int, k: int = 4
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gd2 (HW, k), gpix (HW, k) flat PIXEL indices of each pixel's gauges):
    the mask-derived stage in the form :func:`factored_apply` takes."""
    gd2, gsel, gauge_pix = factored_prepare_full(mask_xy, max_gauges, k=k)
    return gd2, gauge_pix[gsel.long()]


def factored_apply_gauges_batch(gd2: torch.Tensor, gsel: torch.Tensor,
                                gauge_vals: torch.Tensor, out_hw: Tuple[int, int],
                                k: int = 4, rho: float = 2.0, tau: float = 0.05
                                ) -> torch.Tensor:
    """IDW densification of N windows sharing one mask: gd2/gsel (HW, k) from
    :func:`factored_prepare_full` (their transposes are copied unless they are
    contiguous already, as ``P2IGenerator.prepare_idw`` lays them out),
    gauge_vals (N, D, G) values at the gauge slots. The selection runs once
    per pixel and serves every window. Returns (N, D, H, W)."""
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
    """IDW densification of a window from its OWN mask's selection: gd2/gsel
    (HW, k), gauge_vals (D, G) -> (D, H, W). With a leading batch axis on all
    three ((B, HW, k), (B, HW, k), (B, D, G) -> (B, D, H, W); the JAX package
    ``vmap``s) the batch is one kernel launch, every sample selecting from its
    own gauges."""
    from .idw_factored_kernel import combine_table

    H, W = out_hw
    if gauge_vals.dim() == 2:
        return factored_apply_gauges(gd2[None], gsel[None], gauge_vals[None],
                                     out_hw, k=k, rho=rho, tau=tau)[0]
    B, D, _ = gauge_vals.shape
    out = combine_table(gd2.transpose(1, 2).contiguous(),
                        gsel.transpose(1, 2).contiguous(),
                        gauge_vals.contiguous(), k=k, rho=rho, tau=tau)
    return out.reshape(B, D, H, W)


def factored_apply(gd2: torch.Tensor, gpix: torch.Tensor,
                   values_dhw: torch.Tensor, k: int = 4, rho: float = 2.0,
                   tau: float = 0.05) -> torch.Tensor:
    """Value stage of the factored IDW gathering the candidates from the dense
    (D, H, W) field: gd2/gpix (HW, k) from :func:`factored_prepare`. Returns
    (D, H, W); differentiable in ``values_dhw``."""
    from .idw_factored_kernel import combine_dense

    D, H, W = values_dhw.shape
    HW = H * W
    # frame-major candidate rows: cvals_t[f*k + s, p] = values[f, gpix[p, s]]
    cvals_t = values_dhw.reshape(D, HW)[:, gpix.long()].permute(0, 2, 1)
    out = combine_dense(gd2.t().contiguous(),
                        cvals_t.reshape(D * k, HW).contiguous(),
                        k=k, rho=rho, tau=tau)
    return out.reshape(D, H, W)


def idw_3d_factored(mask_xy: torch.Tensor, values_dhw: torch.Tensor,
                    max_gauges: int, k: int = 4, rho: float = 2.0,
                    tau: float = 0.05) -> torch.Tensor:
    """Exact IDW k-NN of a (D, H, W) field under an (H, W) mask that is
    constant across frames (sti / stis): any point of a pixel's global top-k
    pairs one of its k nearest gauges with some frame, so Q x (G*D) distances
    become Q x (k*D) candidates. Ties break by flat (t-major) point index, as
    the reference's nonzero order."""
    gd2, gpix = factored_prepare(mask_xy, max_gauges, k=k)
    return factored_apply(gd2, gpix, values_dhw, k=k, rho=rho, tau=tau)


@functools.lru_cache(maxsize=8)
def axis_coords(n: int, device: str = "cpu") -> torch.Tensor:
    """(n,) float32 coordinates idx/(n-1) of a point at index idx of an axis,
    made on the host in numpy (a division on the device would not do: see
    :func:`_pixel_tables`)."""
    c = np.arange(n, dtype=np.float32) / np.float32(max(n - 1, 1))
    return torch.from_numpy(c).to(device)


def extract_points(mask_dhw: torch.Tensor, values_dhw: torch.Tensor,
                   max_points: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Static-shape gather of the observed voxels of (B, D, H, W) masks (>0 =
    observed) and values; a (D, H, W) pair gives unbatched results (the JAX
    package ``vmap``s it).

    Returns points (B, max_points, 3) as normalized (x, y, z), values
    (B, max_points) and valid (B, max_points) bool. Slots fill in flat t-major
    order; points beyond ``max_points`` are dropped (callers size the budget
    from the mask config), and an empty slot holds the last voxel's
    coordinates (its index clamped to n-1, as in the JAX package) with value 0
    and valid False. Differentiable in the values; no host sync."""
    if mask_dhw.dim() == 3:
        pts, vals, valid = extract_points(mask_dhw[None], values_dhw[None], max_points)
        return pts[0], vals[0], valid[0]
    B, D, H, W = mask_dhw.shape
    n = D * H * W
    dev = str(mask_dhw.device)
    idx = _rank_into_slots(mask_dhw.reshape(B, n) > 0, max_points)
    valid = idx < n
    safe = idx.clamp(max=n - 1)
    points = torch.stack([axis_coords(W, dev)[safe % W],
                          axis_coords(H, dev)[(safe // W) % H],
                          axis_coords(D, dev)[safe // (H * W)]], dim=-1)
    vals = torch.gather(values_dhw.reshape(B, n), 1, safe)
    return points, vals * valid.to(vals.dtype), valid


def idw_3d_knn(points_xyz: torch.Tensor, values: torch.Tensor,
               valid: torch.Tensor, out_shape: Tuple[int, int, int], k: int = 4,
               rho: float = 2.0, tau: float = 0.05) -> torch.Tensor:
    """IDW k-NN interpolation of P points onto the dense (D, H, W) grid
    (``grid_points`` order): points (B, P, 3), values (B, P), valid (B, P) ->
    (B, D, H, W); unbatched (P, 3), (P,), (P,) -> (D, H, W).

    Every query takes its k nearest points by the correctly rounded float32
    sqrt distance, lowest index on ties; invalid points carry a 1e30 penalty
    (so they stay selectable, with weight ~1e-30, when fewer than k are valid,
    as in the JAX package's Pallas kernels). P up to ``P_SINGLE_PASS_MAX``
    runs in one pass (kernel #8, its backward #10), a larger P streams the
    points (kernel #9, whose backward scatters the forward's own selection).
    Differentiable in ``values``; the points get no gradient."""
    from .idw_kernel import idw_knn

    if points_xyz.dim() == 2:
        return idw_3d_knn(points_xyz[None], values[None], valid[None], out_shape,
                          k=k, rho=rho, tau=tau)[0]
    return idw_knn(points_xyz, values, valid, out_shape, k=k, rho=rho, tau=tau)


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt. PyTorch's vectorized CPU float32 sqrt
    is not (it misrounds ~0.7% of inputs by one ULP), which flips the IDW's
    exact distance ties; the float64 sqrt rounded to float32 is exact."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _factored_selection(gd2: torch.Tensor, dz2: torch.Tensor, k: int,
                        rho: float, tau: float):
    """The candidate selection of the reference combine, query frame by query
    frame: gd2 (HW, k), dz2 (D, D). Yields, for z = 0..D-1, the k rounds'
    flat frame-major candidate indices and weights ((HW,) each, round order)
    and the denominator w_sum + 1e-12, formed as the kernels form them."""
    from .idw_factored_kernel import first_min_index

    HW = gd2.shape[0]
    D = dz2.shape[0]
    bigd = _sqrt_rn(torch.tensor(1e30, dtype=torch.float32, device=gd2.device))
    col = torch.arange(D * k, device=gd2.device, dtype=torch.int32)
    col = col[None, :].expand(HW, D * k)
    for z in range(D):
        cd = _sqrt_rn(gd2[:, None, :] + dz2[z][None, :, None]).reshape(HW, D * k)
        cd = torch.where(cd < bigd, cd, bigd)
        w_sum = torch.zeros((HW,), dtype=torch.float32, device=gd2.device)
        idxs, ws = [], []
        for _ in range(k):
            d_min = cd.amin(dim=-1)
            idx = first_min_index(cd, d_min[:, None], col, dim=-1)
            if abs(rho - 2.0) < 1e-6:
                invd = 1.0 / (d_min + tau)
                w = invd * invd
            else:
                w = 1.0 / torch.pow(d_min + tau, rho)
            w = torch.where(d_min < bigd, w, torch.zeros_like(w))
            w_sum = w_sum + w
            idxs.append(idx)
            ws.append(w)
            cd = torch.where(col == idx[:, None], bigd, cd)
        yield idxs, ws, w_sum + 1e-12


def _factored_combine_xla(gd2: torch.Tensor, cvals: torch.Tensor,
                          dz2: torch.Tensor, k: int, rho: float, tau: float
                          ) -> torch.Tensor:
    """Reference candidate combine over all D frames (``p2igan_tpu/ops/idw.py
    _factored_combine_xla``): gd2 (HW, k), cvals (..., HW, D*k) frame-major
    candidate values, dz2 (D, D). Returns (..., D, HW).

    The selection depends only on geometry, so it runs once per z and serves
    every leading (window) index; the arithmetic per window is the
    reference's, round by round."""
    HW = gd2.shape[0]
    lead = cvals.shape[:-2]
    rows = []
    for idxs, ws, denom in _factored_selection(gd2, dz2, k, rho, tau):
        wv_sum = torch.zeros(lead + (HW,), dtype=torch.float32, device=gd2.device)
        for idx, w in zip(idxs, ws):
            v = torch.gather(cvals, -1, idx.long().expand(lead + (HW,))[..., None])[..., 0]
            wv_sum = wv_sum + w * v
        rows.append(wv_sum / denom)
    return torch.stack(rows, dim=-2)
