"""Hand-written CUDA kernels of the generic IDW k-NN, with their plain versions.

Counterpart of ``p2igan_tpu/ops/pallas/idw_kernel.py``: the densification of
masks that vary per frame (stin, fi, nowcasting), where the observed voxels
do not factor into gauges x frames. The JAX package dispatches on the point
count: P up to :data:`P_SINGLE_PASS_MAX` takes its single-pass kernel (#8),
a larger P its chunked kernel (#9). The port keeps that split as two wrappers
over one CUDA search, and one backward kernel:

* :func:`idw_knn_single` -- #8's range, P <= 4096;
* :func:`idw_knn_chunked` -- #9's range, any P. Both run the exact search over
  cells of points (``csrc/idw_knn_cells.cu``: a cell build, then each query
  visits only the cells whose lower bound is not above its k-th distance) and
  return every query's k nearest points' weighted mean and, when asked, the
  selection (sel_idx, w_norm). Their plain versions are the brute force over
  every pair, which the search equals bit for bit;
* :func:`scatter_selection` -- #10, d_values of either forward: the normalized
  weight x cotangent of the saved selection added into the points
  (``csrc/idw_scatter.cu``), summed order-free in 64-bit fixed point, so the
  gradient repeats bit for bit. The JAX package recomputes the selection for
  P <= 4096 (``idw_3d_knn_bwd_pallas``) and scatters the saved one above; the
  port scatters the saved one on both ranges. :func:`idw_knn_bwd_reference`
  (the selection recomputed) stays as the plain statement of #10's function.

:func:`idw_knn` is the differentiable op: the forward keeps its selection
when the values need a gradient, the backward scatters it. A given P takes
the same selection in both packages.

Arithmetic (the Pallas kernels', not the XLA fallback's): points are padded
to ``round_up(max(P, 128), 128)`` slots, invalid and padding slots carry a
1e30 penalty and value 0; d2 = ((dx*dx + dy*dy) + dz*dz) + penalty; the
selection metric is the correctly rounded float32 sqrt; k first-min rounds,
lowest index on ties; w = (1/(d + tau))^2 at rho = 2; out = sum(w v) /
(sum(w) + 1e-12). Each wrapper runs its plain PyTorch version for CPU tensors
and launches its kernel for CUDA tensors (or raises); ``<wrapper>.launches``
counts kernel launches.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import cuda_lib
from .idw import _sqrt_rn, grid_points, round_up
from .idw_factored_kernel import first_min_index

# above this point count the JAX package switches to its chunked kernel
P_SINGLE_PASS_MAX = 4096
MAX_K = 8                  # csrc/idw_knn.cuh kKnnMaxK
PENALTY = 1e30             # invalid / padding slot, added to d2
# (query chunk x points) elements of one distance tensor in the plain versions:
# 512 MB in float32 (1 GB for the float64 sqrt), so that they run at full
# width on the card
_PLAIN_PAIRS = 1 << 27


def prep_points(points_xyz: torch.Tensor, values: torch.Tensor,
                valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, P, 3) points, (B, P) values and validity -> pts4 (B, Pp, 4) rows
    (x, y, z, penalty) and vals (B, Pp) float32, Pp = round_up(max(P, 128),
    128); padding rows are (0, 0, 0, 1e30) with value 0. Differentiable in the
    values."""
    B, P, _ = points_xyz.shape
    Pp = round_up(max(P, 128), 128)
    penalty = torch.where(valid, 0.0, PENALTY).to(torch.float32)
    pts4 = torch.cat([points_xyz.to(torch.float32), penalty[..., None]], dim=-1)
    pts4 = F.pad(pts4, (0, 0, 0, Pp - P))
    pts4[:, P:, 3] = PENALTY
    return pts4.contiguous(), F.pad(values.to(torch.float32), (0, Pp - P))


@functools.lru_cache(maxsize=8)
def _grid(D: int, H: int, W: int, device: str) -> torch.Tensor:
    """(Q, 3) query coordinates (``grid_points``) on ``device``."""
    return torch.from_numpy(grid_points(D, H, W)).to(device)


@functools.lru_cache(maxsize=8)
def _grid_axes(D: int, H: int, W: int, device: str):
    """(x (W,), y (H,), z (D,)) linspace coordinates: query q = (z*H + y)*W + x
    sits at (x[q % W], y[(q / W) % H], z[q / (H W)]), as in ``grid_points``."""
    g = grid_points(D, H, W)
    return tuple(torch.from_numpy(a.copy()).to(device)
                 for a in (g[:W, 0], g[:H * W:W, 1], g[::H * W, 2]))


def _weight(d: torch.Tensor, rho: float, tau: float) -> torch.Tensor:
    """IDW weight of a selected distance (``_weight_from_d`` of the TPU
    kernels): an invalid slot's 1e15 gives ~1e-30, effectively zero."""
    if abs(rho - 2.0) < 1e-6:
        invd = 1.0 / (d + tau)
        return invd * invd
    return 1.0 / torch.pow(d + tau, rho)


def _select_chunks(pts4_b: torch.Tensor, grid: torch.Tensor, k: int):
    """The k nearest points of every query, chunk by chunk of queries: yields
    (lo, hi, d (n, k), idx (n, k) int64), rounds in order (ascending d, lowest
    index first on ties)."""
    Pp = pts4_b.shape[0]
    px, py, pz, pen = (c[None, :] for c in pts4_b.unbind(-1))
    col = torch.arange(Pp, device=pts4_b.device, dtype=torch.int32)[None, :]
    step = max(1, _PLAIN_PAIRS // Pp)
    for lo in range(0, grid.shape[0], step):
        g = grid[lo:lo + step]
        dx, dy, dz = g[:, 0:1] - px, g[:, 1:2] - py, g[:, 2:3] - pz
        d = _sqrt_rn(((dx * dx + dy * dy) + dz * dz) + pen)
        del dx, dy, dz
        dmin, idx = [], []
        for _ in range(k):
            m = d.amin(dim=1, keepdim=True)
            i = first_min_index(d, m, col.expand_as(d), dim=1, keepdim=True).long()
            d.scatter_(1, i, float("inf"))
            dmin.append(m)
            idx.append(i)
        yield lo, lo + g.shape[0], torch.cat(dmin, 1), torch.cat(idx, 1)


def _forward_plain(pts4, vals, out_shape, k, rho, tau, with_sel):
    B = pts4.shape[0]
    grid = _grid(*out_shape, str(pts4.device))
    Q = grid.shape[0]
    out = torch.empty((B, Q), dtype=torch.float32, device=pts4.device)
    sel = torch.empty((B, Q, k), dtype=torch.int32, device=pts4.device) if with_sel else None
    w_norm = torch.empty((B, Q, k), dtype=torch.float32, device=pts4.device) if with_sel else None
    for b in range(B):
        for lo, hi, d, idx in _select_chunks(pts4[b], grid, k):
            w = _weight(d, rho, tau)
            v = vals[b][idx]
            w_sum = torch.zeros_like(w[:, 0])
            wv_sum = torch.zeros_like(w[:, 0])
            for r in range(k):
                w_sum = w_sum + w[:, r]
                wv_sum = wv_sum + w[:, r] * v[:, r]
            out[b, lo:hi] = wv_sum / (w_sum + 1e-12)
            if with_sel:
                sel[b, lo:hi] = idx.to(torch.int32)
                w_norm[b, lo:hi] = w / (w_sum + 1e-12)[:, None]
    return out, (None if sel is None else (sel, w_norm))


def _check(name, pts4, vals, out_shape, k, max_pp: Optional[int]):
    cuda_lib.require_cuda(name, pts4, vals)
    B, Pp = pts4.shape[0], pts4.shape[1]
    Q = out_shape[0] * out_shape[1] * out_shape[2]
    if pts4.shape != (B, Pp, 4) or pts4.data_ptr() % 16:
        raise ValueError(f"{name}: points must be (B, Pp, 4) rows aligned to 16 "
                         f"bytes, got {tuple(pts4.shape)}")
    if not 1 <= k <= MAX_K or B == 0 or Pp == 0 or Pp % 128 or Q == 0:
        raise ValueError(f"{name}: unsupported k={k}, B={B}, Pp={Pp}, Q={Q}")
    if max_pp is not None and Pp > max_pp:
        raise ValueError(f"{name}: Pp={Pp} points exceed the single pass's "
                         f"limit of {max_pp} (the JAX package's split)")
    if vals.shape != (B, Pp):
        raise ValueError(f"{name}: values {tuple(vals.shape)}, expected {(B, Pp)}")
    return B, Pp, Q


# -- #9: an exact search over cells of points ---------------------------------

# Cells: one frame deep and 8 x 8 query pixels wide (16 x 16 x 16 a sample at
# full width), coarser where that would exceed this many (csrc/idw_knn_cells.cu
# kMaxCells; its shared memory holds one lower bound a cell)
MAX_CELLS = 4096
CELL_PIXELS = 8
CELL_CHUNK = 256   # slots a build block (csrc/idw_knn_cells.cu kBuildThreads)


def cell_dims(D: int, H: int, W: int) -> Tuple[int, int, int]:
    """(CZ, CY, CX) cells over the (D, H, W) query grid's extent: CELL_PIXELS
    pixels square and one frame deep, widened (then deepened) until there are
    at most :data:`MAX_CELLS`."""
    px, frames = CELL_PIXELS, 1
    while True:
        dims = (-(-D // frames), -(-H // px), -(-W // px))
        if dims[0] * dims[1] * dims[2] <= MAX_CELLS:
            return dims
        if dims[1] * dims[2] > 256:
            px *= 2
        else:
            frames *= 2


def _cell_axis(v: torch.Tensor, n: int) -> torch.Tensor:
    """Cell index along one axis: floor(v * n) clamped to [0, n - 1], NaN to 0
    (the kernel's fminf(fmaxf(floorf(v * n), 0), n - 1))."""
    f = torch.floor(v * float(n))
    f = torch.where(f >= 0, f, 0.0)
    return torch.minimum(f, torch.tensor(float(n - 1))).long()


def cell_build_reference(pts4: torch.Tensor, dims: Tuple[int, int, int]):
    """Plain version of the cell build that #9 runs on the card before its
    search (``p2i_idw_cell_build``). Every valid point (penalty 0) falls in the
    cell of its clamped coordinates; every other slot (invalid or padding) in
    one more set, cell C - 1. Returns

    * ``count`` (B, C) int32 members a cell, ``start`` (B, C) int32 the
      exclusive per-sample scan of ``count``;
    * ``order`` (B, Pp) int32: the slots' original indices in cell order
      (ascending within a cell here; the card's order within a cell is free,
      since the search's entry test is lexicographic);
    * ``lo`` (B, C, 4), ``hi`` (B, C, 4) float32: the members' bounding box
      (x, y, z) with the least member penalty in ``lo[..., 3]`` (``hi[..., 3]``
      0); an empty cell has lo = +inf, hi = -inf.
    """
    B, Pp, _ = pts4.shape
    CZ, CY, CX = dims
    C = CZ * CY * CX + 1
    x, y, z, pen = pts4.unbind(-1)
    cell = (_cell_axis(z, CZ) * CY + _cell_axis(y, CY)) * CX + _cell_axis(x, CX)
    cell = torch.where(pen != 0, C - 1, cell)
    order = torch.argsort(cell, dim=1, stable=True)
    count = torch.zeros((B, C), dtype=torch.int64, device=pts4.device)
    count.scatter_add_(1, cell, torch.ones_like(cell))
    start = torch.cumsum(count, 1) - count
    inf = float("inf")
    lo = torch.full((B, C, 4), inf, dtype=torch.float32, device=pts4.device)
    hi = torch.full((B, C, 4), -inf, dtype=torch.float32, device=pts4.device)
    idx = cell[..., None].expand(-1, -1, 4)
    lo.scatter_reduce_(1, idx, pts4, "amin")
    hi.scatter_reduce_(1, idx, pts4, "amax")
    hi[..., 3] = 0.0
    return (count.to(torch.int32), start.to(torch.int32), order.to(torch.int32),
            lo, hi)


def _cell_scratch(B: int, Pp: int, C: int, dev):
    """The cell build's buffers (the kernels allocate nothing): ``ints`` holds
    the cell of each slot (B, Pp), the original indices in cell order (B, Pp)
    and the invalid set's offset a chunk of CELL_CHUNK slots; the points in
    cell order (B, Pp, 4); count / start / fill (3, B, C) int32; boxes
    (B, C, 2, 4) float32."""
    ints = torch.empty((B * (2 * Pp + -(-Pp // CELL_CHUNK)),), device=dev,
                       dtype=torch.int32)
    return (ints, torch.empty((B, Pp, 4), device=dev, dtype=torch.float32),
            torch.empty((3, B, C), device=dev, dtype=torch.int32),
            torch.empty((B, C, 2, 4), device=dev, dtype=torch.float32))


def idw_cell_build(pts4: torch.Tensor, dims: Tuple[int, int, int]):
    """The card's cell build alone, as :func:`cell_build_reference` returns it
    (``order`` in the card's order within a cell). #9 runs the same build
    inside every launch; this entry exists to hold the build against its plain
    version. CPU tensors take the plain version."""
    if pts4.device.type == "cpu":
        return cell_build_reference(pts4, dims)
    name = "idw_cell_build"
    cuda_lib.require_cuda(name, pts4)
    B, Pp = pts4.shape[0], pts4.shape[1]
    if pts4.shape != (B, Pp, 4) or pts4.data_ptr() % 16 or B == 0 or Pp == 0:
        raise ValueError(f"{name}: points must be (B, Pp, 4) rows aligned to 16 "
                         f"bytes, got {tuple(pts4.shape)}")
    C = dims[0] * dims[1] * dims[2] + 1
    ints, spts, cells, boxes = _cell_scratch(B, Pp, C, pts4.device)
    with torch.cuda.device(pts4.device):
        rc = cuda_lib.library().p2i_idw_cell_build(
            pts4.data_ptr(), ints.data_ptr(), spts.data_ptr(), cells.data_ptr(),
            boxes.data_ptr(), B, Pp, *dims, cuda_lib.stream_of(pts4))
    cuda_lib.check(rc, name)
    order = ints[B * Pp:2 * B * Pp].view(B, Pp)
    return cells[0], cells[1], order, boxes[:, :, 0], boxes[:, :, 1]


def idw_knn_chunked_reference(pts4, vals, out_shape, k: int = 4, rho: float = 2.0,
                              tau: float = 0.05, with_sel: bool = True):
    """Plain version of :func:`idw_knn_chunked`: (out (B, Q), (sel_idx (B, Q, k)
    int32, w_norm (B, Q, k)) or None), as ``_idw_forward_chunked`` returns
    them, by brute force over every (query, point) pair. The global
    lexicographic (d, index) top-k equals the TPU kernel's per-chunk top-k
    followed by its merge, and the card's cell search."""
    return _forward_plain(pts4, vals, out_shape, k, rho, tau, with_sel)


def _knn_cells(name, pts4, vals, out_shape, k, rho, tau, with_sel, max_pp):
    """One launch of the cell search (``p2i_idw_knn_chunked``): (out, selection
    or None)."""
    B, Pp, Q = _check(name, pts4, vals, out_shape, k, max_pp)
    lx, ly, lz = _grid_axes(*out_shape, str(pts4.device))
    dev = pts4.device
    dims = cell_dims(*out_shape)
    ints, spts, cells, boxes = _cell_scratch(B, Pp, dims[0] * dims[1] * dims[2] + 1, dev)
    out = torch.empty((B, Q), device=dev, dtype=torch.float32)
    sel = w_norm = None
    if with_sel:
        sel = torch.empty((B, Q, k), device=dev, dtype=torch.int32)
        w_norm = torch.empty((B, Q, k), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        rc = cuda_lib.library().p2i_idw_knn_chunked(
            pts4.data_ptr(), vals.data_ptr(), lx.data_ptr(), ly.data_ptr(),
            lz.data_ptr(), ints.data_ptr(), spts.data_ptr(), cells.data_ptr(),
            boxes.data_ptr(), out.data_ptr(), 0 if sel is None else sel.data_ptr(),
            0 if w_norm is None else w_norm.data_ptr(), B, Pp, *out_shape, *dims, k,
            float(rho), float(tau), int(abs(rho - 2.0) < 1e-6),
            cuda_lib.stream_of(pts4))
    cuda_lib.check(rc, name)
    return out, (None if sel is None else (sel, w_norm))


def idw_knn_chunked(pts4: torch.Tensor, vals: torch.Tensor,
                    out_shape: Tuple[int, int, int], k: int = 4, rho: float = 2.0,
                    tau: float = 0.05, with_sel: bool = False):
    """(out (B, Q), selection or None) for any number of points: the card
    sorts the points into cells (:func:`cell_dims`) and each query scans only
    the cells whose lower bound does not exceed its k-th distance, an exact
    search. ``with_sel`` also returns sel_idx (B, Q, k) int32 and w_norm
    (B, Q, k), the backward's scatter (what a training forward needs)."""
    if pts4.device.type == "cpu":
        return idw_knn_chunked_reference(pts4, vals, out_shape, k, rho, tau, with_sel)
    out = _knn_cells("idw_knn_chunked", pts4, vals, out_shape, k, rho, tau, with_sel,
                     None)
    idw_knn_chunked.launches += 1
    return out


idw_knn_chunked.launches = 0


# -- #8: the single pass's range ----------------------------------------------

def idw_knn_single_reference(pts4, vals, out_shape, k: int = 4, rho: float = 2.0,
                             tau: float = 0.05, with_sel: bool = False):
    """Plain version of :func:`idw_knn_single`: the brute force over every
    (query, point) pair, as :func:`idw_knn_chunked_reference`."""
    return _forward_plain(pts4, vals, out_shape, k, rho, tau, with_sel)


def idw_knn_single(pts4: torch.Tensor, vals: torch.Tensor,
                   out_shape: Tuple[int, int, int], k: int = 4, rho: float = 2.0,
                   tau: float = 0.05, with_sel: bool = False):
    """:func:`idw_knn_chunked` for Pp <= :data:`P_SINGLE_PASS_MAX` points, the
    range of the JAX package's single-pass kernel (#8): the same cell search,
    counted apart, so that a run shows which of the two ranges it took."""
    if pts4.device.type == "cpu":
        return idw_knn_single_reference(pts4, vals, out_shape, k, rho, tau, with_sel)
    out = _knn_cells("idw_knn_single", pts4, vals, out_shape, k, rho, tau, with_sel,
                     P_SINGLE_PASS_MAX)
    idw_knn_single.launches += 1
    return out


idw_knn_single.launches = 0


# -- #10: the backward, a scatter of the saved selection ----------------------

def scatter_selection_reference(sel_idx: torch.Tensor, w_norm: torch.Tensor,
                                g: torch.Tensor, Pp: int) -> torch.Tensor:
    """Plain version of :func:`scatter_selection`: ``index_add_`` of the
    float32 terms ``w_norm * g`` (its sum order is not fixed on the card)."""
    B, Q, k = sel_idx.shape
    flat = (sel_idx.long() + Pp * torch.arange(B, device=g.device)[:, None, None])
    dv = torch.zeros((B * Pp,), dtype=torch.float32, device=g.device)
    dv.index_add_(0, flat.reshape(-1), (w_norm * g[:, :, None]).reshape(-1))
    return dv.reshape(B, Pp)


def scatter_selection(sel_idx: torch.Tensor, w_norm: torch.Tensor,
                      g: torch.Tensor, Pp: int) -> torch.Tensor:
    """d_values (B, Pp) of either forward from its selection, sel_idx
    (B, Q, k) int32 and w_norm (B, Q, k) (normalized weights, in [0, 1]), and
    the cotangent g (B, Q): ``w_norm * g`` added into the selected points. The
    card sums in 64-bit fixed point (``csrc/idw_scatter.cu``, #10), so the
    result does not depend on the order of the adds or of the queries."""
    if g.device.type == "cpu":
        return scatter_selection_reference(sel_idx, w_norm, g, Pp)
    name = "scatter_selection"
    cuda_lib.require_cuda(name, sel_idx, w_norm, g,
                          dtypes=(torch.int32, torch.float32, torch.float32))
    B, Q, k = sel_idx.shape
    if w_norm.shape != (B, Q, k) or g.shape != (B, Q) or not 1 <= k <= MAX_K or \
            B == 0 or Q == 0 or Pp < 1:
        raise ValueError(f"{name}: sel {tuple(sel_idx.shape)}, w_norm "
                         f"{tuple(w_norm.shape)}, cotangent {tuple(g.shape)}, Pp={Pp}")
    scratch = cuda_lib.fixed_scratch(B * Pp, B, g.device)
    out = torch.empty((B, Pp), device=g.device, dtype=torch.float32)
    with torch.cuda.device(g.device):
        rc = cuda_lib.library().p2i_idw_scatter(
            sel_idx.data_ptr(), w_norm.data_ptr(), g.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), B, Q, k, Pp, cuda_lib.stream_of(g))
    cuda_lib.check(rc, name)
    scatter_selection.launches += 1
    return out


scatter_selection.launches = 0


def idw_knn_bwd_reference(pts4, g, out_shape, k: int = 4, rho: float = 2.0,
                          tau: float = 0.05):
    """d_values (B, Pp) as the TPU kernel #10 computes them
    (``idw_3d_knn_bwd_pallas``): the selection recomputed, each selected point
    gets w * (g / (sum(w) + 1e-12)), summed with ``index_add_``. The port's
    backward is :func:`scatter_selection` of the saved selection; this stays as
    the plain statement of #10's function, which the scatter equals to a
    tolerance (w_norm * g rounds otherwise)."""
    B, Pp, _ = pts4.shape
    grid = _grid(*out_shape, str(pts4.device))
    dv = torch.zeros((B, Pp), dtype=torch.float32, device=pts4.device)
    for b in range(B):
        for lo, hi, d, idx in _select_chunks(pts4[b], grid, k):
            w = _weight(d, rho, tau)
            w_sum = torch.zeros_like(w[:, 0])
            for r in range(k):
                w_sum = w_sum + w[:, r]
            scale = g[b, lo:hi] / (w_sum + 1e-12)
            dv[b].index_add_(0, idx.reshape(-1), (w * scale[:, None]).reshape(-1))
    return dv


# -- the differentiable op ----------------------------------------------------

class _IDWKnn(torch.autograd.Function):
    """Forward: #8's or #9's range of the cell search, keeping the selection
    when the values need a gradient. Backward: #10, the scatter of that
    selection. The points get no gradient, as in the JAX package's VJP."""

    @staticmethod
    def forward(ctx, pts4, vals, out_shape, k, rho, tau, single):
        ctx.Pp = vals.shape[1]
        fwd = idw_knn_single if single else idw_knn_chunked
        out, sel = fwd(pts4, vals, out_shape, k, rho, tau,
                       with_sel=ctx.needs_input_grad[1])
        if sel is not None:
            ctx.save_for_backward(*sel)
        return out

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[1]:
            return (None,) * 7
        dv = scatter_selection(*ctx.saved_tensors, g.contiguous(), ctx.Pp)
        return None, dv, None, None, None, None, None


def idw_knn(points_xyz: torch.Tensor, values: torch.Tensor, valid: torch.Tensor,
            out_shape: Tuple[int, int, int], k: int = 4, rho: float = 2.0,
            tau: float = 0.05) -> torch.Tensor:
    """(B, D, H, W) IDW of points (B, P, 3), values and validity (B, P):
    single pass for P <= :data:`P_SINGLE_PASS_MAX`, else chunked.
    Differentiable in ``values``."""
    B, P, _ = points_xyz.shape
    pts4, vals = prep_points(points_xyz.detach(), values, valid)
    out = _IDWKnn.apply(pts4, vals, tuple(out_shape), k, rho, tau,
                        P <= P_SINGLE_PASS_MAX)
    return out.reshape(B, *out_shape)
