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

import numpy as np
import torch

from . import cuda_lib
from .idw import _factored_combine_xla, frame_dz2_np

BIG = 1e30  # taken / invalid slot distance^2 (csrc kBig)
_BIG_I32 = int(np.iinfo(np.int32).max)
MAX_K = 8          # csrc kMaxK
MAX_CANDIDATES = 64  # csrc kMaxCand: kf * k
BWD_PIXELS_PER_BLOCK = 128      # csrc/combine_table_multi_bwd.cu kThreads
BWD_TILE_BYTES = 96 * 1024      # its shared-memory accumulation tile


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
    if not 1 <= k <= min(MAX_K, G) or HW == 0 or B == 0 or 3 * 4 * G > 48 * 1024:
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


def combine_table_multi_bwd(gd2_t: torch.Tensor, gsel_t: torch.Tensor,
                            g: torch.Tensor, G: int, k: int, rho: float = 2.0,
                            tau: float = 0.05) -> torch.Tensor:
    """d_tables (N, D, G) of :func:`combine_table_multi` from its output
    cotangent g (N, D, HW); the selection is recomputed, not saved."""
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
    # windows per block: the accumulation tile (n_tile, D, G) f32 stays within
    # BWD_TILE_BYTES of shared memory
    n_tile = min(N, BWD_TILE_BYTES // (4 * D * G))
    if n_tile < 1:
        raise ValueError(f"{name}: a (D={D}, G={G}) tile exceeds "
                         f"{BWD_TILE_BYTES} bytes of shared memory")
    nblk = -(-HW // BWD_PIXELS_PER_BLOCK)
    parts = torch.empty((nblk, N, D, G), device=g.device, dtype=torch.float32)
    out = torch.empty((N, D, G), device=g.device, dtype=torch.float32)
    with torch.cuda.device(g.device):
        rc = cuda_lib.library().p2i_combine_table_multi_bwd(
            gd2_t.data_ptr(), gsel_t.data_ptr(), g.data_ptr(), sel.data_ptr(),
            fd2.data_ptr(), parts.data_ptr(), out.data_ptr(), N, D, G, HW, k, kf,
            float(rho), float(tau), int(abs(rho - 2.0) < 1e-6), n_tile, nblk,
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
    sel, fd2, kf = _frame_table(name, D, k, gd2_t.device)
    out = torch.empty((B, D, HW), device=gd2_t.device, dtype=torch.float32)
    with torch.cuda.device(gd2_t.device):
        rc = cuda_lib.library().p2i_combine_table(
            gd2_t.data_ptr(), gsel_t.data_ptr(), tables.data_ptr(),
            sel.data_ptr(), fd2.data_ptr(), out.data_ptr(), B, D, G, HW, k, kf,
            float(rho), float(tau), int(abs(rho - 2.0) < 1e-6),
            cuda_lib.stream_of(gd2_t))
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


def combine_table_bwd(gd2_t: torch.Tensor, gsel_t: torch.Tensor,
                      g: torch.Tensor, G: int, k: int, rho: float = 2.0,
                      tau: float = 0.05) -> torch.Tensor:
    """d_tables (B, D, G) of :func:`combine_table` from its output cotangent
    g (B, D, HW); the selection is recomputed per sample, not saved."""
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
    sel, fd2, kf = _frame_table(name, D, k, gd2_t.device)
    if 4 * D * G > BWD_TILE_BYTES:
        raise ValueError(f"{name}: a (D={D}, G={G}) tile exceeds "
                         f"{BWD_TILE_BYTES} bytes of shared memory")
    # strips of BWD_PIXELS_PER_BLOCK pixels a block walks: one at a (D, G) tile
    # of 16 KB (G = 256), more for a larger tile, zeroed and written once a block
    iters = max(1, min(8, (D * G) // 4096))
    nblk = -(-HW // (BWD_PIXELS_PER_BLOCK * iters))
    parts = torch.empty((nblk, B, D, G), device=g.device, dtype=torch.float32)
    out = torch.empty((B, D, G), device=g.device, dtype=torch.float32)
    with torch.cuda.device(g.device):
        rc = cuda_lib.library().p2i_combine_table_bwd(
            gd2_t.data_ptr(), gsel_t.data_ptr(), g.data_ptr(), sel.data_ptr(),
            fd2.data_ptr(), parts.data_ptr(), out.data_ptr(), B, D, G, HW, k, kf,
            float(rho), float(tau), int(abs(rho - 2.0) < 1e-6), iters, nblk,
            cuda_lib.stream_of(g))
    cuda_lib.check(rc, name)
    combine_table_bwd.launches += 1
    return out


combine_table_bwd.launches = 0


# -- dense-field combine ------------------------------------------------------

def combine_dense_reference(gd2_t, cvals_t, k: int, rho: float = 2.0,
                            tau: float = 0.05):
    """Plain version of :func:`combine_dense`: the reference combine over ALL
    D frames (no pruning). gd2_t (k, HW), cvals_t (D*k, HW) -> (D, HW)."""
    D = cvals_t.shape[0] // k
    dz2 = torch.from_numpy(frame_dz2_np(D)).to(cvals_t.device)
    return _factored_combine_xla(gd2_t.t(), cvals_t.t(), dz2, k, rho, tau)


def _combine_dense_cuda(gd2_t, cvals_t, k, rho, tau):
    name = "combine_dense"
    cuda_lib.require_cuda(name, gd2_t, cvals_t)
    HW = gd2_t.shape[-1]
    if (gd2_t.shape != (k, HW) or cvals_t.dim() != 2 or cvals_t.shape[1] != HW
            or cvals_t.shape[0] % k or cvals_t.shape[0] == 0):
        raise ValueError(f"{name}: gd2 must be (k={k}, HW) and cvals (D*k, HW), "
                         f"got {tuple(gd2_t.shape)} {tuple(cvals_t.shape)}")
    if not 1 <= k <= MAX_K or HW == 0:
        raise ValueError(f"{name}: unsupported k={k}, HW={HW}")
    D = cvals_t.shape[0] // k
    sel, fd2, kf = _frame_table(name, D, k, gd2_t.device)
    out = torch.empty((D, HW), device=gd2_t.device, dtype=torch.float32)
    with torch.cuda.device(gd2_t.device):
        rc = cuda_lib.library().p2i_combine_dense(
            gd2_t.data_ptr(), cvals_t.data_ptr(), sel.data_ptr(), fd2.data_ptr(),
            out.data_ptr(), D, HW, k, kf, float(rho), float(tau),
            int(abs(rho - 2.0) < 1e-6), cuda_lib.stream_of(gd2_t))
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
    the pixel's s-th gauge). Differentiable in ``cvals_t``."""
    return _CombineDense.apply(gd2_t, cvals_t, k, rho, tau)


combine_dense.launches = 0
