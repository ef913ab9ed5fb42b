"""Hand-written CUDA kernels of the factored IDW, with their plain versions.

Counterpart of ``p2igan_tpu/ops/pallas/idw_factored_kernel.py`` (and of the
tie rule in ``p2igan_tpu/ops/pallas/select.py``). Six kernels:

* :func:`gauge_topk` -- per-pixel k nearest gauge slots of one mask or of a
  batch of masks in one launch (``csrc/gauge_topk.cu``): once per mask on the
  shared-mask (stis) paths, every forward on the per-sample (sti) paths;
* :func:`combine_table_multi` -- the IDW densification of N windows that share
  one mask, every generator forward (``csrc/combine_table_multi.cu``); a
  ``torch.autograd.Function`` whose backward is
* :func:`combine_table_multi_bwd` -- d_tables from the output cotangent
  (``csrc/combine_table_multi_bwd.cu``);
* :func:`combine_table` -- the densification of B windows that each carry
  their own mask (``csrc/combine_table.cu``); its backward is
* :func:`combine_table_bwd` (``csrc/combine_table_bwd.cu``);
* :func:`combine_dense` -- one window whose candidate values were gathered
  from the dense field outside (``csrc/combine_dense.cu``); its backward is
  autograd of its plain version, as the JAX package's is the XLA VJP.

Each wrapper runs its plain PyTorch version for CPU tensors and launches its
kernel for CUDA tensors (or raises); there is no fallback between the two.
``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from . import cuda_lib
from .idw import _factored_combine_xla, _factored_selection, frame_dz2_np

BIG = 1e30  # taken / invalid slot distance^2 (csrc kBig)
_BIG_I32 = int(np.iinfo(np.int32).max)
MAX_K = 8          # csrc kMaxK
MAX_CANDIDATES = 64  # csrc kMaxCand: kf * k
BWD_THREADS = 512  # csrc/combine_table_multi_bwd.cu kThreads: (pixel, z) pairs a block
# #4's budget for a block's tile of window totals (8 bytes an entry,
# csrc/fixed_sum.cuh): 3 windows at the widest tile row at D=16, G=128, k=4 (129
# slots), so two blocks share an SM; at a block's own row (a few slots) it
# holds every window of the training shape
BWD_WINDOWS_TILE_BYTES = 64 * 1024
STI_PIXELS_PER_BLOCK = 128  # csrc/combine_table.cu, combine_table_bwd.cu kThreads


def first_min_index(d: torch.Tensor, d_min: torch.Tensor, idx: torch.Tensor,
                    dim: int, keepdim: bool = False) -> torch.Tensor:
    """Lowest index along ``dim`` attaining the precomputed min ``d_min``.

    The load-bearing parity rule of every IDW selection: an integer min over
    the tied candidates' indices reproduces numpy/XLA first-index order, i.e.
    the reference's flat frame-major ``nonzero`` order."""
    big = torch.full_like(idx, _BIG_I32)
    return torch.where(d == d_min, idx, big).amin(dim=dim, keepdim=keepdim)


@functools.lru_cache(maxsize=16)
def _frame_selection(D: int, k: int, tie_eps: float = 1e-5):
    """Static per-query-z frame pruning (exact): the global top-k holds at most
    k candidates of one gauge, and per gauge the candidate order across frames
    is the frame-distance order, so only each z's nearest frames can ever be
    selected. Frames within ``tie_eps`` of the k-th nearest are kept too: the
    ULP-different dz^2 of symmetric +-z frames collapse to equal f32 distances
    after the sqrt, and the lower frame index then wins the tie. All z share
    one kf (shorter rows pad with the next-nearest frames).

    Selected frames ascend, so the lowest-index tie rule stays the
    reference's frame-major order. Returns (sel (D, kf) int32, kf)."""
    fd = frame_dz2_np(D).astype(np.float64)
    orders = [np.argsort(fd[z], kind="stable") for z in range(D)]
    keep = []
    for z in range(D):
        kth = fd[z][orders[z][min(k, D) - 1]]
        keep.append({int(f) for f in range(D) if fd[z][f] <= kth + tie_eps})
    kf = min(max(max(len(s) for s in keep), k), D)
    sel = []
    for z in range(D):
        s = keep[z]
        for f in orders[z]:
            if len(s) >= kf:
                break
            s.add(int(f))
        sel.append(np.sort(np.fromiter(s, dtype=np.int32)))
    return np.stack(sel).astype(np.int32), kf


@functools.lru_cache(maxsize=16)
def pruned_frame_table(D: int, k: int, device: str = "cpu"):
    """(sel (D, kf) int32, fd2 (D, kf*k) f32) on ``device``: the pruned frames
    of each query z and their squared z-distances in frame-major candidate
    order. Cached so a forward pays no host-to-device copy."""
    sel, kf = _frame_selection(D, k)
    fd2 = np.repeat(np.take_along_axis(frame_dz2_np(D), sel, axis=1), k, axis=1)
    return (torch.from_numpy(sel).to(device),
            torch.from_numpy(np.ascontiguousarray(fd2, np.float32)).to(device))


@functools.lru_cache(maxsize=16)
def distinct_frame_table(D: int, k: int, device: str = "cpu"):
    """(vals (nv,) f32, vmap (D, kf) int32) on ``device``: the distinct
    squared z-distances of the pruned frame table, ascending, and for each
    (query z, pruned frame) the index of its distance in that list, so that
    ``vals[vmap]`` is ``pruned_frame_table``'s fd2 without its repeat over the
    k slots. The per-sample combines compute sqrt(gd2 + vals[j]) once per
    (pixel, j, slot) and select through the map (nv = 13 at D=16, k=4)."""
    sel, _ = _frame_selection(D, k)
    fd = np.take_along_axis(frame_dz2_np(D), sel, axis=1)
    vals, vmap = np.unique(fd, return_inverse=True)
    return (torch.from_numpy(np.ascontiguousarray(vals, np.float32)).to(device),
            torch.from_numpy(vmap.reshape(fd.shape).astype(np.int32)).to(device))


# -- gauge top-k --------------------------------------------------------------

def gauge_topk_reference(qx, qy, gx, gy, penalty, k: int):
    """Plain version of :func:`gauge_topk` (``p2igan_tpu/ops/idw.py:182-195``),
    mask by mask when the gauge arrays carry a leading batch axis.

    d2 = ((dx*dx) + (dy*dy)) + penalty; a valid slot adds 0 exactly and a
    padding slot's 1e30 absorbs the distance, so this equals the reference's
    ``where(valid, dx2 + dy2, 1e30)`` bit for bit."""
    if gx.dim() == 2:
        pairs = [gauge_topk_reference(qx, qy, gx[b], gy[b], penalty[b], k)
                 for b in range(gx.shape[0])]
        return (torch.stack([p[0] for p in pairs]),
                torch.stack([p[1] for p in pairs]))
    dx = qx[:, None] - gx[None, :]
    dy = qy[:, None] - gy[None, :]
    d = (dx * dx + dy * dy) + penalty[None, :]          # (HW, G)
    col = torch.arange(d.shape[1], device=d.device, dtype=torch.int32)
    col = col[None, :].expand_as(d)
    gd2, gsel = [], []
    for _ in range(k):
        dmin = d.amin(dim=1)
        idx = first_min_index(d, dmin[:, None], col, dim=1)
        gd2.append(dmin)
        gsel.append(idx)
        d = torch.where(col == idx[:, None], torch.full_like(d, BIG), d)
    return torch.stack(gd2), torch.stack(gsel)


def gauge_topk(qx: torch.Tensor, qy: torch.Tensor, gx: torch.Tensor,
               gy: torch.Tensor, penalty: torch.Tensor, k: int = 4):
    """(HW,) pixel coords + (G,) gauge coords and validity penalties ->
    per-pixel top-k gauge distances^2 (k, HW) f32 and slot ids (k, HW) int32,
    ascending by distance, lowest slot first on ties. Gauge arrays of shape
    (B, G) give (B, k, HW) results for B masks from one launch."""
    if qx.device.type == "cpu":
        return gauge_topk_reference(qx, qy, gx, gy, penalty, k)
    name = "gauge_topk"
    cuda_lib.require_cuda(name, qx, qy, gx, gy, penalty)
    HW, G = qx.shape[0], gx.shape[-1]
    lead = tuple(gx.shape[:-1])
    if (qy.shape != (HW,) or len(lead) > 1 or gy.shape != gx.shape
            or penalty.shape != gx.shape):
        raise ValueError(f"{name}: shape mismatch {qx.shape} {qy.shape} "
                         f"{gx.shape} {gy.shape} {penalty.shape}")
    B = lead[0] if lead else 1
    # a 16-byte shared record a slot, at most 64 KB of them
    if not 1 <= k <= min(MAX_K, G) or HW == 0 or B == 0 or 16 * G > 64 * 1024:
        raise ValueError(f"{name}: unsupported k={k}, G={G}, HW={HW}, B={B}")
    gd2 = torch.empty(lead + (k, HW), device=qx.device, dtype=torch.float32)
    gsel = torch.empty(lead + (k, HW), device=qx.device, dtype=torch.int32)
    with torch.cuda.device(qx.device):
        rc = cuda_lib.library().p2i_gauge_topk(
            qx.data_ptr(), qy.data_ptr(), gx.data_ptr(), gy.data_ptr(),
            penalty.data_ptr(), gd2.data_ptr(), gsel.data_ptr(), B, HW, G, k,
            cuda_lib.stream_of(qx))
    cuda_lib.check(rc, name)
    gauge_topk.launches += 1
    return gd2, gsel


gauge_topk.launches = 0


# -- multi-window table combine -----------------------------------------------

def combine_table_multi_reference(gd2_t, gsel_t, tables, k: int,
                                  rho: float = 2.0, tau: float = 0.05):
    """Plain version of :func:`combine_table_multi`: the reference combine
    (``_factored_combine_xla``) over ALL D frames, without the kernel's frame
    pruning, so a pruning fault shows as a mismatch."""
    N, D, G = tables.shape
    HW = gd2_t.shape[1]
    gsel = gsel_t.t().long()                                   # (HW, k)
    # frame-major candidate values: cvals[n, p, f*k + s] = tables[n, f, gsel[p, s]]
    cvals = tables[:, :, gsel].permute(0, 2, 1, 3).reshape(N, HW, D * k)
    dz2 = torch.from_numpy(frame_dz2_np(D)).to(tables.device)
    return _factored_combine_xla(gd2_t.t(), cvals, dz2, k, rho, tau)


def _check_combine_args(name, gd2_t, gsel_t, k):
    HW = gd2_t.shape[1]
    if gd2_t.shape != (k, HW) or gsel_t.shape != (k, HW):
        raise ValueError(f"{name}: gd2/gsel must be (k={k}, HW), got "
                         f"{tuple(gd2_t.shape)} {tuple(gsel_t.shape)}")
    if not 1 <= k <= MAX_K or HW == 0:
        raise ValueError(f"{name}: unsupported k={k}, HW={HW}")


def _frame_table(name, D, k, device):
    sel, fd2 = pruned_frame_table(D, k, str(device))
    kf = sel.shape[1]
    if kf * k > MAX_CANDIDATES:
        raise ValueError(f"{name}: kf*k={kf * k} candidates exceed "
                         f"{MAX_CANDIDATES}")
    return sel, fd2, kf


def _combine_table_multi_cuda(gd2_t, gsel_t, tables, k, rho, tau):
    name = "combine_table_multi"
    cuda_lib.require_cuda(name, gd2_t, gsel_t, tables,
                          dtypes=(torch.float32, torch.int32, torch.float32))
    _check_combine_args(name, gd2_t, gsel_t, k)
    N, D, G = tables.shape
    HW = gd2_t.shape[1]
    if N == 0:
        raise ValueError(f"{name}: no windows")
    sel, fd2, kf = _frame_table(name, D, k, gd2_t.device)
    out = torch.empty((N, D, HW), device=gd2_t.device, dtype=torch.float32)
    with torch.cuda.device(gd2_t.device):
        rc = cuda_lib.library().p2i_combine_table_multi(
            gd2_t.data_ptr(), gsel_t.data_ptr(), tables.data_ptr(),
            sel.data_ptr(), fd2.data_ptr(), out.data_ptr(), N, D, G, HW, k, kf,
            float(rho), float(tau), int(abs(rho - 2.0) < 1e-6),
            cuda_lib.stream_of(gd2_t))
    cuda_lib.check(rc, name)
    combine_table_multi.launches += 1
    return out


class _CombineTableMulti(torch.autograd.Function):
    """The combine on both devices: forward is the kernel (CUDA) or the plain
    version (CPU); backward is :func:`combine_table_multi_bwd`, which
    dispatches the same way. gd2_t, gsel_t and the frame table get no
    gradient, as in the JAX package's custom VJP."""

    @staticmethod
    def forward(ctx, gd2_t, gsel_t, tables, k, rho, tau):
        ctx.save_for_backward(gd2_t, gsel_t)
        ctx.args = (tables.shape[2], k, rho, tau)
        if gd2_t.device.type == "cpu":
            return combine_table_multi_reference(gd2_t, gsel_t, tables, k, rho, tau)
        return _combine_table_multi_cuda(gd2_t, gsel_t, tables, k, rho, tau)

    @staticmethod
    def backward(ctx, g):
        gd2_t, gsel_t = ctx.saved_tensors
        G, k, rho, tau = ctx.args
        d_tables = None
        if ctx.needs_input_grad[2]:
            d_tables = combine_table_multi_bwd(gd2_t, gsel_t, g.contiguous(), G,
                                               k, rho, tau)
        return None, None, d_tables, None, None, None


def combine_table_multi(gd2_t: torch.Tensor, gsel_t: torch.Tensor,
                        tables: torch.Tensor, k: int, rho: float = 2.0,
                        tau: float = 0.05) -> torch.Tensor:
    """(N, D, HW) IDW combine of N windows sharing one mask: gd2_t/gsel_t
    (k, HW) from :func:`gauge_topk` (pixel-ordered), tables (N, D, G) values at
    the gauge slots. Differentiable in ``tables``."""
    return _CombineTableMulti.apply(gd2_t, gsel_t, tables, k, rho, tau)


combine_table_multi.launches = 0


# -- its backward -------------------------------------------------------------

def combine_table_multi_bwd_reference(gd2_t, gsel_t, g, G: int, k: int,
                                      rho: float = 2.0, tau: float = 0.05):
    """Plain version of :func:`combine_table_multi_bwd`: autograd of
    :func:`combine_table_multi_reference` (all D*k candidates, no frame
    pruning, so a pruning fault of the kernel shows as a mismatch). The
    combine is linear in the tables, so any table values give the same
    gradient; zeros are used."""
    N, D, _ = g.shape
    tables = torch.zeros((N, D, G), dtype=torch.float32, device=g.device,
                         requires_grad=True)
    with torch.enable_grad():
        out = combine_table_multi_reference(gd2_t, gsel_t, tables, k, rho, tau)
        (d_tables,) = torch.autograd.grad(out, tables, g)
    return d_tables


def combine_table_multi_bwd_fixed_reference(gd2_t, gsel_t, g, G: int, k: int,
                                            rho: float = 2.0, tau: float = 0.05):
    """Plain version of :func:`combine_table_multi_bwd`'s exact arithmetic:
    the plain selection's terms (one selection, the same targets for every
    window) w_norm * g (float32, rounded once), summed per window by
    :func:`fixed_point_sum_reference` at the kernel's scale (the window's
    largest finite |g|, D*HW terms a target at most). The kernel equals it
    bit for bit; :func:`combine_table_multi_bwd_reference` (float32 sums in
    autograd's order) only to a tolerance."""
    off, wnorm = combine_table_terms_reference(gd2_t[None], gsel_t[None], g.shape[1], G,
                                               k, rho, tau)
    return _fixed_point_backward(off, wnorm, g, G)


def bwd_widest_row(D: int, G: int, k: int) -> int:
    """Entries of the widest (D, pitch) tile row a block of :func:`combine_table_multi_bwd`
    may need: its pixels' k slots each (at most G), rounded up to odd, a frame."""
    return D * (min(G, k * (BWD_THREADS // D)) | 1)


def combine_table_multi_bwd(gd2_t: torch.Tensor, gsel_t: torch.Tensor,
                            g: torch.Tensor, G: int, k: int, rho: float = 2.0,
                            tau: float = 0.05, tile_bytes: Optional[int] = None
                            ) -> torch.Tensor:
    """d_tables (N, D, G) of :func:`combine_table_multi` from its output
    cotangent g (N, D, HW); the selection is recomputed, not saved. The sums
    are order-free (64-bit fixed point), so the result repeats bit for bit
    and does not depend on ``tile_bytes``, the budget of a block's tile of
    window totals (default BWD_WINDOWS_TILE_BYTES; whole windows at the widest
    row, at least one, no more than shared memory holds), which sets how many
    windows a block adds before it flushes."""
    if gd2_t.device.type == "cpu":
        return combine_table_multi_bwd_reference(gd2_t, gsel_t, g, G, k, rho, tau)
    name = "combine_table_multi_bwd"
    cuda_lib.require_cuda(name, gd2_t, gsel_t, g,
                          dtypes=(torch.float32, torch.int32, torch.float32))
    _check_combine_args(name, gd2_t, gsel_t, k)
    N, D, HW = g.shape
    if HW != gd2_t.shape[1] or N == 0 or G < 1:
        raise ValueError(f"{name}: cotangent {tuple(g.shape)} does not fit "
                         f"HW={gd2_t.shape[1]}, G={G}")
    sel, fd2, kf = _frame_table(name, D, k, gd2_t.device)
    if tile_bytes is None:
        tile_bytes = BWD_WINDOWS_TILE_BYTES
    # the launcher's layout: the tile (whole windows at the widest row, at
    # least one, at most N), then the slot map and numbering, fd2 and sel,
    # and the block's slot count (16 bytes of static shared memory)
    row = 8 * bwd_widest_row(D, G, k)
    rest = 4 * (2 * G + D * kf * (k + 1)) + 16
    windows = min(N, tile_bytes // row, (cuda_lib.MAX_SHARED_BYTES - rest) // row)
    if D > BWD_THREADS or tile_bytes < 0 or row + rest > cuda_lib.MAX_SHARED_BYTES:
        raise ValueError(f"{name}: D={D}, G={G}, k={k} need {row + rest} bytes of shared "
                         f"memory a block for one window (at most "
                         f"{cuda_lib.MAX_SHARED_BYTES}), D <= {BWD_THREADS} and a tile "
                         f"budget >= 0, got {tile_bytes}")
    scratch = cuda_lib.fixed_scratch(N * D * G, N, g.device)
    out = torch.empty((N, D, G), device=g.device, dtype=torch.float32)
    with torch.cuda.device(g.device):
        rc = cuda_lib.library().p2i_combine_table_multi_bwd(
            gd2_t.data_ptr(), gsel_t.data_ptr(), g.data_ptr(), sel.data_ptr(),
            fd2.data_ptr(), scratch.data_ptr(), out.data_ptr(), N, D, G, HW, k, kf,
            float(rho), float(tau), int(abs(rho - 2.0) < 1e-6), max(1, windows) * row,
            cuda_lib.stream_of(g))
    cuda_lib.check(rc, name)
    combine_table_multi_bwd.launches += 1
    return out


combine_table_multi_bwd.launches = 0


# -- per-sample table combine -------------------------------------------------

def combine_table_reference(gd2_t, gsel_t, tables, k: int, rho: float = 2.0,
                            tau: float = 0.05):
    """Plain version of :func:`combine_table`: the reference combine
    (``_factored_combine_xla``) sample by sample over ALL D frames, without
    the kernel's frame pruning, so a pruning fault shows as a mismatch."""
    B, D, _ = tables.shape
    HW = gd2_t.shape[2]
    dz2 = torch.from_numpy(frame_dz2_np(D)).to(tables.device)
    rows = []
    for b in range(B):
        # frame-major candidate values: cvals[p, f*k + s] = tables[b, f, gsel[s, p]]
        cvals = tables[b][:, gsel_t[b].t().long()].permute(1, 0, 2).reshape(HW, D * k)
        rows.append(_factored_combine_xla(gd2_t[b].t(), cvals, dz2, k, rho, tau))
    return torch.stack(rows)


def _check_sample_args(name, gd2_t, gsel_t, B, k):
    HW = gd2_t.shape[-1]
    if gd2_t.shape != (B, k, HW) or gsel_t.shape != (B, k, HW):
        raise ValueError(f"{name}: gd2/gsel must be (B={B}, k={k}, HW), got "
                         f"{tuple(gd2_t.shape)} {tuple(gsel_t.shape)}")
    if not 1 <= k <= MAX_K or HW == 0 or B == 0:
        raise ValueError(f"{name}: unsupported k={k}, HW={HW}, B={B}")


def sample_table(name: str, D: int, k: int, device, tile_bytes: int = 0,
                 table: bool = True):
    """The frame tables of the per-sample combines: (sel, fd2, vals, vmap,
    kf, nv) on ``device`` (``pruned_frame_table``'s frames and distances,
    ``distinct_frame_table``'s distinct distances and map). Raises when the
    kf*k candidates exceed the taken mask, or when a block's shared memory
    (``tile_bytes`` of the backward's tile, the frame tables and, with
    ``table``, its pixels' nv*k distance tables; the launchers' layout)
    exceeds what a block may hold."""
    sel, fd2, kf = _frame_table(name, D, k, device)
    vals, vmap = distinct_frame_table(D, k, str(device))
    nv = vals.shape[0]
    smem = tile_bytes + 4 * (D * kf * (2 + k) + nv)
    if table:
        smem += 4 * nv * k * STI_PIXELS_PER_BLOCK
    if smem > cuda_lib.MAX_SHARED_BYTES:
        raise ValueError(
            f"{name}: a {tile_bytes}-byte tile and nv*k={nv * k} distances a pixel "
            f"({'in' if table else 'beside'} a table at {STI_PIXELS_PER_BLOCK} pixels a "
            f"block) need {smem} bytes of shared memory, beyond the "
            f"{cuda_lib.MAX_SHARED_BYTES} a block may hold")
    return sel, fd2, vals, vmap, kf, nv


def _combine_table_cuda(gd2_t, gsel_t, tables, k, rho, tau):
    name = "combine_table"
    cuda_lib.require_cuda(name, gd2_t, gsel_t, tables,
                          dtypes=(torch.float32, torch.int32, torch.float32))
    if tables.dim() != 3:
        raise ValueError(f"{name}: tables must be (B, D, G), got "
                         f"{tuple(tables.shape)}")
    B, D, G = tables.shape
    _check_sample_args(name, gd2_t, gsel_t, B, k)
    HW = gd2_t.shape[2]
    sel, _, vals, vmap, kf, nv = sample_table(name, D, k, gd2_t.device)
    out = torch.empty((B, D, HW), device=gd2_t.device, dtype=torch.float32)
    with torch.cuda.device(gd2_t.device):
        rc = cuda_lib.library().p2i_combine_table(
            gd2_t.data_ptr(), gsel_t.data_ptr(), tables.data_ptr(),
            sel.data_ptr(), vals.data_ptr(), vmap.data_ptr(), out.data_ptr(),
            B, D, G, HW, k, kf, nv, float(rho), float(tau),
            int(abs(rho - 2.0) < 1e-6), cuda_lib.stream_of(gd2_t))
    cuda_lib.check(rc, name)
    combine_table.launches += 1
    return out


class _CombineTable(torch.autograd.Function):
    """The per-sample combine on both devices: forward is the kernel (CUDA) or
    the plain version (CPU); backward is :func:`combine_table_bwd`, which
    dispatches the same way. gd2_t and gsel_t get no gradient, as in the JAX
    package's custom VJP (``_table_bwd``)."""

    @staticmethod
    def forward(ctx, gd2_t, gsel_t, tables, k, rho, tau):
        ctx.save_for_backward(gd2_t, gsel_t)
        ctx.args = (tables.shape[2], k, rho, tau)
        if gd2_t.device.type == "cpu":
            return combine_table_reference(gd2_t, gsel_t, tables, k, rho, tau)
        return _combine_table_cuda(gd2_t, gsel_t, tables, k, rho, tau)

    @staticmethod
    def backward(ctx, g):
        gd2_t, gsel_t = ctx.saved_tensors
        G, k, rho, tau = ctx.args
        d_tables = None
        if ctx.needs_input_grad[2]:
            d_tables = combine_table_bwd(gd2_t, gsel_t, g.contiguous(), G, k,
                                         rho, tau)
        return None, None, d_tables, None, None, None


def combine_table(gd2_t: torch.Tensor, gsel_t: torch.Tensor,
                  tables: torch.Tensor, k: int, rho: float = 2.0,
                  tau: float = 0.05) -> torch.Tensor:
    """(B, D, HW) IDW combine of B windows, each with its own mask: gd2_t /
    gsel_t (B, k, HW) from the batched :func:`gauge_topk` (pixel-ordered),
    tables (B, D, G) values at each sample's gauge slots. One launch for the
    batch; the selection runs per sample. Differentiable in ``tables``."""
    return _CombineTable.apply(gd2_t, gsel_t, tables, k, rho, tau)


combine_table.launches = 0


def combine_table_bwd_reference(gd2_t, gsel_t, g, G: int, k: int,
                                rho: float = 2.0, tau: float = 0.05):
    """Plain version of :func:`combine_table_bwd`: autograd of
    :func:`combine_table_reference` (all D*k candidates, no frame pruning).
    The combine is linear in the tables, so zeros stand in for them."""
    B, D, _ = g.shape
    tables = torch.zeros((B, D, G), dtype=torch.float32, device=g.device,
                         requires_grad=True)
    with torch.enable_grad():
        out = combine_table_reference(gd2_t, gsel_t, tables, k, rho, tau)
        (d_tables,) = torch.autograd.grad(out, tables, g)
    return d_tables


def combine_table_terms_reference(gd2_t, gsel_t, D: int, G: int, k: int,
                                  rho: float = 2.0, tau: float = 0.05):
    """The plain selection of the per-sample combine as scatter terms: for
    every (sample, z, round, pixel) the target ``frame * G + slot`` in the
    sample's (D, G) table (int64) and the normalized weight w / (w_sum +
    1e-12) (float32), both (B, D, k, HW), over ALL D frames (no pruning)."""
    dz2 = torch.from_numpy(frame_dz2_np(D)).to(gd2_t.device)
    offs, wnorms = [], []
    for b in range(gd2_t.shape[0]):
        gsel = gsel_t[b].long()                                   # (k, HW)
        pix = torch.arange(gsel.shape[1], device=gsel.device)
        o_b, w_b = [], []
        for idxs, ws, denom in _factored_selection(gd2_t[b].t(), dz2, k, rho, tau):
            idx = torch.stack(idxs).long()                        # (k, HW)
            o_b.append((idx // k) * G + gsel[idx % k, pix])
            w_b.append(torch.stack(ws) / denom)
        offs.append(torch.stack(o_b))
        wnorms.append(torch.stack(w_b))
    return torch.stack(offs), torch.stack(wnorms)


def fixed_point_sum_reference(terms: torch.Tensor, idx: torch.Tensor,
                              n_out: int, row_max: torch.Tensor,
                              count: int) -> torch.Tensor:
    """The order-free sum of ``csrc/fixed_sum.cuh`` in plain PyTorch, row by
    row: terms (R, n) float32 into (R, n_out) targets ``idx`` (R, n). Each
    finite term is scaled by 2^s (s = 62 - L - e; L the bit length of
    ``count``, the most terms a target takes; row_max < 2^e, frexp), rounded
    half to even to an int64 and summed as integers; each total goes back to
    float32 with one rounding and the exact power-of-two scaling. A NaN or
    infinite term flags its target, which then takes what a float sum gives.
    Bitwise what the kernels compute."""
    R = terms.shape[0]
    dev = terms.device
    L = int(count).bit_length()
    e = torch.frexp(row_max.to(torch.float32)).exponent.tolist()
    up = torch.tensor([math.ldexp(1.0, 62 - L - x) for x in e], dtype=torch.float64,
                      device=dev)[:, None]
    down = torch.tensor([math.ldexp(1.0, x + L - 62) for x in e], dtype=torch.float64,
                        device=dev)[:, None]
    finite = torch.isfinite(terms)
    fixed = torch.round(torch.where(finite, terms, 0.0).double() * up).long()
    acc = torch.zeros((R, n_out), dtype=torch.int64, device=dev).scatter_add_(1, idx, fixed)

    def flag(hit):
        """Targets that take at least one term of ``hit``."""
        return torch.zeros((R, n_out), dtype=torch.int64, device=dev).scatter_add_(
            1, idx, hit.long()) > 0

    nan = flag(torch.isnan(terms))
    pos, neg = flag(terms == math.inf), flag(terms == -math.inf)
    out = (acc.float().double() * down).float()
    out = torch.where(pos, math.inf, torch.where(neg, -math.inf, out))
    return torch.where(nan | (pos & neg), math.nan, out)


def combine_table_bwd_fixed_reference(gd2_t, gsel_t, g, G: int, k: int,
                                      rho: float = 2.0, tau: float = 0.05):
    """Plain version of :func:`combine_table_bwd`'s exact arithmetic: the
    plain selection's terms w_norm * g (float32, rounded once) summed per
    sample by :func:`fixed_point_sum_reference` at the kernel's scale (the
    sample's largest finite |g|, D*HW terms a target at most). The kernel
    equals it bit for bit; :func:`combine_table_bwd_reference` (float32 sums
    in autograd's order) only to a tolerance."""
    off, wnorm = combine_table_terms_reference(gd2_t, gsel_t, g.shape[1], G, k, rho, tau)
    return _fixed_point_backward(off, wnorm, g, G)


def _fixed_point_backward(off, wnorm, g, G: int):
    """The backwards' terms w_norm * g (float32) summed per row of g (B, D,
    HW) by :func:`fixed_point_sum_reference`, at the kernels' scale: the row's
    largest finite |g|, D*HW terms a target at most. off and wnorm (B or 1, D,
    k, HW): the targets and weights of each row's selection, or of one
    selection that every row shares."""
    B, D, HW = g.shape
    terms = (wnorm * g[:, :, None, :]).reshape(B, -1)
    idx = off.expand(B, *off.shape[1:]).reshape(B, -1)
    absg = torch.where(torch.isfinite(g), g.abs(), 0.0)
    out = fixed_point_sum_reference(terms, idx, D * G, absg.reshape(B, -1).amax(dim=1),
                                    D * HW)
    return out.view(B, D, G)


def combine_table_bwd(gd2_t: torch.Tensor, gsel_t: torch.Tensor,
                      g: torch.Tensor, G: int, k: int, rho: float = 2.0,
                      tau: float = 0.05) -> torch.Tensor:
    """d_tables (B, D, G) of :func:`combine_table` from its output cotangent
    g (B, D, HW); the selection is recomputed per sample, not saved. The sums
    are order-free (64-bit fixed point): the result repeats bit for bit."""
    if gd2_t.device.type == "cpu":
        return combine_table_bwd_reference(gd2_t, gsel_t, g, G, k, rho, tau)
    name = "combine_table_bwd"
    cuda_lib.require_cuda(name, gd2_t, gsel_t, g,
                          dtypes=(torch.float32, torch.int32, torch.float32))
    if g.dim() != 3:
        raise ValueError(f"{name}: cotangent must be (B, D, HW), got "
                         f"{tuple(g.shape)}")
    B, D, HW = g.shape
    _check_sample_args(name, gd2_t, gsel_t, B, k)
    if HW != gd2_t.shape[2] or G < 1:
        raise ValueError(f"{name}: cotangent {tuple(g.shape)} does not fit "
                         f"HW={gd2_t.shape[2]}, G={G}")
    # the kernel takes its pixels' distance tables only where they cost no
    # block an SM; without them it must fit
    sel, fd2, vals, vmap, kf, nv = sample_table(name, D, k, gd2_t.device, 8 * D * G,
                                                table=False)
    iters = bwd_strips(D, G)
    scratch = cuda_lib.fixed_scratch(B * D * G, B, g.device)
    out = torch.empty((B, D, G), device=g.device, dtype=torch.float32)
    with torch.cuda.device(g.device):
        rc = cuda_lib.library().p2i_combine_table_bwd(
            gd2_t.data_ptr(), gsel_t.data_ptr(), g.data_ptr(), sel.data_ptr(),
            fd2.data_ptr(), vals.data_ptr(), vmap.data_ptr(), scratch.data_ptr(),
            out.data_ptr(),
            B, D, G, HW, k, kf, nv, float(rho), float(tau),
            int(abs(rho - 2.0) < 1e-6), iters, cuda_lib.stream_of(g))
    cuda_lib.check(rc, name)
    combine_table_bwd.launches += 1
    return out


combine_table_bwd.launches = 0


def bwd_strips(D: int, G: int) -> int:
    """Strips of STI_PIXELS_PER_BLOCK pixels a block of :func:`combine_table_bwd`
    walks, zeroing and flushing its (D, G) tile once: one at a 32 KB tile (D=16,
    G=256), four at 144 KB (G=1152), the fastest of 1, 2 and 4 at each of
    chip_smoke's sti shapes on the H100 (``scripts/time_sti_combine.py
    --iters``, PERF.md)."""
    return max(1, min(8, (D * G) // 4096))


# -- dense-field combine ------------------------------------------------------

def combine_dense_reference(gd2_t, cvals_t, k: int, rho: float = 2.0,
                            tau: float = 0.05):
    """Plain version of :func:`combine_dense`: the reference combine over ALL
    D frames (no pruning). gd2_t (k, HW), cvals_t (D*k, HW) -> (D, HW)."""
    D = cvals_t.shape[0] // k
    dz2 = torch.from_numpy(frame_dz2_np(D)).to(cvals_t.device)
    return _factored_combine_xla(gd2_t.t(), cvals_t.t(), dz2, k, rho, tau)


DENSE_LANES = 32      # csrc/combine_dense.cu kLanes: pixels a block, a warp's lanes
DENSE_MAX_WARPS = 16  # csrc/combine_dense.cu kMaxWarps: warps a block at most
# frames a warp of combine_dense walks (the block: ceil(D / span) warps): the
# fastest of 1, 2, 4, 8 and 16 at the full-width window on the H100
# (``scripts/time_combine_dense.py --spans``, PERF.md)
DENSE_SPAN = 2


@functools.lru_cache(maxsize=16)
def dense_plan(D: int, k: int, device, span: int = DENSE_SPAN):
    """(sel, vals, vmap, kf, nv, span) of :func:`combine_dense` on ``device``:
    the pruned frames, the distinct squared z-distances and their map
    (``distinct_frame_table``), and the frames a warp walks, ``span`` or more
    where D needs it to keep a block within ``DENSE_MAX_WARPS`` warps. Raises
    when the kf*k candidates exceed the taken mask, or when a block's 32
    distance tables and frame tables exceed what a block may hold."""
    name = "combine_dense"
    sel, _, kf = _frame_table(name, D, k, device)
    vals, vmap = distinct_frame_table(D, k, str(device))
    nv = vals.shape[0]
    smem = 4 * (nv * k * DENSE_LANES + nv + 2 * D * kf)
    if smem > cuda_lib.MAX_SHARED_BYTES:
        raise ValueError(f"{name}: nv*k={nv * k} distances a pixel need {smem} bytes of "
                         f"shared memory, beyond the {cuda_lib.MAX_SHARED_BYTES} a block "
                         f"may hold")
    return sel, vals, vmap, kf, nv, max(span, -(-D // DENSE_MAX_WARPS))


def _combine_dense_cuda(gd2_t, cvals_t, k, rho, tau, span=DENSE_SPAN):
    name = "combine_dense"
    cuda_lib.require_cuda(name, gd2_t, cvals_t)
    HW, rows = gd2_t.shape[-1], cvals_t.shape[0]
    if (not 1 <= k <= MAX_K or HW == 0 or gd2_t.shape != (k, HW) or cvals_t.dim() != 2
            or cvals_t.shape[1] != HW or rows % k or rows == 0):
        raise ValueError(f"{name}: gd2 must be (k={k}, HW) and cvals (D*k, HW) with "
                         f"1 <= k <= {MAX_K}, HW > 0, got {tuple(gd2_t.shape)} "
                         f"{tuple(cvals_t.shape)}")
    D, dev = rows // k, gd2_t.device
    sel, vals, vmap, kf, nv, span = dense_plan(D, k, dev, span)
    out = torch.empty((D, HW), device=dev, dtype=torch.float32)
    args = (gd2_t.data_ptr(), cvals_t.data_ptr(), sel.data_ptr(), vals.data_ptr(),
            vmap.data_ptr(), out.data_ptr(), D, HW, k, kf, nv, span, float(rho),
            float(tau), int(abs(rho - 2.0) < 1e-6), cuda_lib.stream_of(gd2_t))
    if dev.index == torch.cuda.current_device():
        rc = cuda_lib.library().p2i_combine_dense(*args)
    else:
        with torch.cuda.device(dev):
            rc = cuda_lib.library().p2i_combine_dense(*args)
    cuda_lib.check(rc, name)
    combine_dense.launches += 1
    return out


class _CombineDense(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU). Backward:
    autograd of the plain version on the tensors' device. The JAX package does
    the same (the XLA VJP of ``_factored_combine_xla``): this combine has no
    backward kernel in either package. Only ``cvals_t`` gets a gradient: gd2
    holds squared distances of fixed pixel and gauge geometry (its XLA
    cotangent is NaN wherever a pixel is a gauge, the sqrt at 0)."""

    @staticmethod
    def forward(ctx, gd2_t, cvals_t, k, rho, tau):
        ctx.save_for_backward(gd2_t, cvals_t)
        ctx.args = (k, rho, tau)
        if gd2_t.device.type == "cpu":
            return combine_dense_reference(gd2_t, cvals_t, k, rho, tau)
        return _combine_dense_cuda(gd2_t, cvals_t, k, rho, tau)

    @staticmethod
    def backward(ctx, g):
        d_cvals = None
        if ctx.needs_input_grad[1]:
            gd2_t, cvals_t = ctx.saved_tensors
            with torch.enable_grad():
                cvals_t = cvals_t.detach().requires_grad_(True)
                out = combine_dense_reference(gd2_t.detach(), cvals_t, *ctx.args)
                (d_cvals,) = torch.autograd.grad(out, cvals_t, g)
        return None, d_cvals, None, None, None


def combine_dense(gd2_t: torch.Tensor, cvals_t: torch.Tensor, k: int,
                  rho: float = 2.0, tau: float = 0.05) -> torch.Tensor:
    """(D, HW) IDW combine of one window from gd2_t (k, HW) and the dense
    frame-major candidate values cvals_t (D*k, HW) (row f*k + s: frame f at
    the pixel's s-th gauge). Differentiable in ``cvals_t``; where no input
    needs a gradient the call skips the autograd node (the same output)."""
    if torch.is_grad_enabled() and (gd2_t.requires_grad or cvals_t.requires_grad):
        return _CombineDense.apply(gd2_t, cvals_t, k, rho, tau)
    if gd2_t.device.type == "cpu":
        return combine_dense_reference(gd2_t, cvals_t, k, rho, tau)
    return _combine_dense_cuda(gd2_t, cvals_t, k, rho, tau)


combine_dense.launches = 0
