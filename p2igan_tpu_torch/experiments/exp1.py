"""exp1 -- numerical evaluation over concatenated test events, on a device.

The port's counterpart of ``experiments/exp1.py``: the same formulas, pairing
and result layout, computed on tensors of an explicit device (``run_exp1``'s
``device``, ``cuda`` unless the caller asks for the CPU). The stores are read
and paired on the host; each method's frames then move to the device, where
the transform, crop, pixel selection and every score run.

Preserved quirks of the JAX suite (each at its site): the exp1-specific HSS
denominator (it differs from ``metrics/metric.py``'s), the PSS value range
shared between prediction and truth after the ``min_value`` threshold,
numpy's histogram binning, and float32 pooling before the float64 SSIM.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..parallel.mesh import resolve_device
from .io import align_length, crop_center, ensure_thw, select_by_mask, to_device

EPS_RATIO = 1e-10
EPS_HIST = 1e-12
THRESHOLDS_MMHR: Tuple[float, ...] = (0.5, 2.0, 4.0, 8.0)
# numpy's float64 add.reduce sums a contiguous row in buffers of this many
# elements, each in pairwise order, the buffers one after another
_NP_REDUCE_BUFFER = 8192

ArrayOrEvents = Union[np.ndarray, Dict[str, np.ndarray]]


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d tensor on ``like``'s device. Dividing by it is a
    true division on CUDA too: a Python scalar divisor is turned into a
    multiplication by its reciprocal there, which can differ by an ulp."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


# --------------------------------------------------------------------------
# rain-rate transform
# --------------------------------------------------------------------------

def transform_mmhr(arr: torch.Tensor, divide_by_3: bool = True) -> torch.Tensor:
    """Normalized field -> mm/h in float64: floor at 0.001, optional /3,
    10^min(x*0.0625, 38) * 0.036, clipped to [0, 200]; NaN stays NaN.

    Trap: ``10**x`` in float64 is not correctly rounded by CUDA's ``pow`` nor
    by PyTorch's CPU kernel, so a value may sit an ulp away from numpy's;
    one within an ulp of a threshold would change a contingency count.
    Counts are compared exactly and a difference is reported, not hidden."""
    x = torch.clamp_min(arr.to(torch.float64), 0.001)
    if divide_by_3:
        x = x / _scalar(3.0, x)
    rate = 0.036 * torch.pow(10.0, torch.clamp_max(x * 0.0625, 38.0))
    return torch.clamp(rate, 0.0, 200.0)


# --------------------------------------------------------------------------
# scalar error scores
# --------------------------------------------------------------------------

def mae(pred: torch.Tensor, gt: torch.Tensor) -> float:
    return float((pred - gt).abs().mean())


def rmse(pred: torch.Tensor, gt: torch.Tensor) -> float:
    return float(torch.sqrt(((pred - gt) ** 2).mean()))


def nse(pred: torch.Tensor, gt: torch.Tensor) -> float:
    """Nash-Sutcliffe efficiency with the 1e-10 guard."""
    resid = ((pred - gt) ** 2).sum()
    spread = ((gt - gt.mean()) ** 2).sum()
    resid, spread = torch.stack([resid, spread]).tolist()
    return float(1.0 - resid / (spread + EPS_RATIO))


# --------------------------------------------------------------------------
# PSS -- per-frame histogram overlap (Perkins skill score)
# --------------------------------------------------------------------------

def _np_pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the order of numpy's float64 ``sum`` of a
    contiguous row: below 8 elements one after another, up to 128 eight
    running sums combined as a tree then the rest added, beyond that the
    halves (cut at a multiple of 8) summed so and added; rows longer than
    8192 in buffers of 8192 added one after another. Bitwise numpy's, on any
    device, since every step is one IEEE addition."""
    n = x.shape[-1]
    if n > _NP_REDUCE_BUFFER:
        total = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for i in range(0, n, _NP_REDUCE_BUFFER):
            total = total + _np_pairwise_sum(x[..., i:i + _NP_REDUCE_BUFFER])
        return total
    if n < 8:
        total = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for i in range(n):
            total = total + x[..., i]
        return total
    if n <= 128:
        m = n - n % 8
        r = x[..., 0:8]
        for i in range(8, m, 8):
            r = r + x[..., i:i + 8]
        total = ((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3])) + \
                ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7]))
        for i in range(m, n):
            total = total + x[..., i]
        return total
    half = n // 2
    half -= half % 8
    return _np_pairwise_sum(x[..., :half]) + _np_pairwise_sum(x[..., half:])


def _frames32(x: torch.Tensor) -> torch.Tensor:
    """(F, ...) -> (F, pixels) float32: one histogram a leading index."""
    x = x.to(torch.float32)
    return x.reshape(x.shape[0], -1)


def _finite_above(v: torch.Tensor, floor: Optional[float]) -> torch.Tensor:
    """Mask of the values a histogram takes. numpy compares a float32 array
    with a Python float in float32 (NEP 50), so the floor is rounded first."""
    keep = torch.isfinite(v)
    if floor is not None:
        keep &= v > float(np.float32(floor))
    return keep


def _frame_histograms(v: torch.Tensor, keep: torch.Tensor, lo: float, hi: float,
                      bins: int, edges: torch.Tensor) -> torch.Tensor:
    """(F, bins) int64 counts of each frame's kept values, binned as
    ``np.histogram(values, bins, range=(lo, hi))`` bins a float32 array.

    Trap: ``torch.histc`` places values its own way on CUDA, and
    ``torch.histogram`` has no CUDA kernel. numpy 2 (NEP 50) works in float32
    here: ``result_type(lo, hi, float32 data)`` is float32, so the edges are
    ``linspace`` cast to float32 (``edges``), the range test compares with
    float32(lo) / float32(hi), and the offset ``v - lo`` is a float32
    subtraction; it is divided by ``hi - lo`` (a float64 scalar), times
    ``bins``, truncated; ``bins`` goes to the last bin (closed); then one
    correction each way against the edges. All frames in one pass: frame x
    bin counts by ``bincount``."""
    frames = v.shape[0]
    lo32, hi32 = float(np.float32(lo)), float(np.float32(hi))
    keep = keep & (v >= lo32) & (v <= hi32)
    rows = torch.nonzero(keep)[:, 0]
    vals = v[keep]
    off = vals - _scalar(lo32, vals)
    f_idx = (off.to(torch.float64) / _scalar(hi - lo, off.to(torch.float64))) * bins
    idx = f_idx.to(torch.int64)
    idx = torch.where(idx == bins, idx - 1, idx)
    idx = idx - (vals < edges[idx]).to(torch.int64)
    idx = idx + ((vals >= edges[idx + 1]) & (idx != bins - 1)).to(torch.int64)
    counts = torch.bincount(rows * bins + idx, minlength=frames * bins)
    return counts.view(frames, bins)


def pss(pred: torch.Tensor, gt: torch.Tensor, bins: int = 50,
        min_value: Optional[float] = 0.5,
        value_range: Optional[Tuple[float, float]] = None) -> float:
    """Mean over frames of the overlap between pred/gt value histograms.

    The histogram range is shared across frames and both arrays of one call:
    the union's min and max after the ``min_value`` threshold (``+1e-6`` on
    the top when they are equal). Frames where either side has no value
    above the threshold are skipped; ``nan`` when nothing is left. Exact:
    the counts are integers and each later step is numpy's float64 order.
    """
    # the float32 cast of the JAX suite: bins are placed on float32 values
    pred, gt = _frames32(pred), _frames32(gt)
    if pred.numel() == 0 or gt.numel() == 0:
        return float("nan")
    keep_p, keep_g = _finite_above(pred, min_value), _finite_above(gt, min_value)

    if value_range is None:
        pool = torch.cat([pred[keep_p], gt[keep_g]])
        if pool.numel() == 0:
            return float("nan")
        lo, hi = torch.stack([pool.min(), pool.max()]).tolist()
        value_range = (lo, hi + 1e-6 if lo == hi else hi)
    lo, hi = float(value_range[0]), float(value_range[1])
    edges = torch.from_numpy(np.linspace(lo, hi, bins + 1, endpoint=True,
                                         dtype=np.float32)).to(pred.device)

    frames = min(pred.shape[0], gt.shape[0])  # zip over frames
    pred, gt, keep_p, keep_g = pred[:frames], gt[:frames], keep_p[:frames], keep_g[:frames]
    hp = _frame_histograms(pred, keep_p, lo, hi, bins, edges)
    hg = _frame_histograms(gt, keep_g, lo, hi, bins, edges)
    used = keep_p.any(dim=1) & keep_g.any(dim=1)
    fp = hp.to(torch.float64) / (hp.sum(dim=1, keepdim=True).to(torch.float64) + EPS_HIST)
    fg = hg.to(torch.float64) / (hg.sum(dim=1, keepdim=True).to(torch.float64) + EPS_HIST)
    overlaps = _np_pairwise_sum(torch.minimum(fp, fg))[used]
    n_used = overlaps.shape[0]
    if n_used == 0:
        return float("nan")
    return float(_np_pairwise_sum(overlaps)) / n_used


# --------------------------------------------------------------------------
# global-statistics SSIM, vectorized over the frame stack
# --------------------------------------------------------------------------

def _as_stack(x: torch.Tensor) -> torch.Tensor:
    """(T,H,W) or (B,T,H,W) -> (B,T,H,W) float32, as the JAX suite casts."""
    x = x.to(torch.float32)
    return x[None] if x.ndim == 3 else x


def _pairwise8(a: torch.Tensor) -> torch.Tensor:
    """numpy's sum of 8 contiguous values (last axis): a tree of pairs."""
    return ((a[..., 0] + a[..., 1]) + (a[..., 2] + a[..., 3])) + \
           ((a[..., 4] + a[..., 5]) + (a[..., 6] + a[..., 7]))


def _block_mean8(x: torch.Tensor) -> torch.Tensor:
    """8x8 average pooling of (B,T,H,W) in float32.

    Trap: pooling runs in float32 before the float64 SSIM, and a float32 sum
    depends on its order. numpy's ``mean(axis=(3, 5))`` adds, for each
    block, the pairwise sum of each of its 8 rows one row after another
    (with one block a row, the 64 values as one run: 8 column sums, then a
    tree), and divides by 64 (exact). The same adds here make the pooled
    frames numpy's; SSIM and DTSSIM then differ from the JAX suite's only
    in the order of their float64 means, and are held to a tolerance.
    A plain float32 ``reshape(...).mean((3, 5))`` misses that tolerance
    (rtol 1e-5 + atol 1e-7): DTSSIM at lag 2 of (2, 6, 40, 33) frames
    uniform in [0, 30) plus N(0, 3) noise (numpy seed 2) reads
    -0.0084134096 against the JAX suite's -0.0084130309, 3.8e-7 apart."""
    b, t, h, w = x.shape
    hb, wb = h // 8, w // 8
    r = x[:, :, :hb * 8, :wb * 8].reshape(b, t, hb, 8, wb, 8)
    if wb == 1:
        cols = r[:, :, :, 0, 0, :]
        for dy in range(1, 8):
            cols = cols + r[:, :, :, dy, 0, :]
        total = _pairwise8(cols)[..., None]
    else:
        total = _pairwise8(r[:, :, :, 0])
        for dy in range(1, 8):
            total = total + _pairwise8(r[:, :, :, dy])
    return total / 64


def _ssim_stack(a: torch.Tensor, b: torch.Tensor, c1: float = 0.01 ** 2,
                c2: float = 0.03 ** 2) -> torch.Tensor:
    """Global-statistics SSIM of every frame pair at once, in float64:
    (B,T,H,W) x2 -> (B,T). Whole-frame means/variances, NOT the windowed SSIM
    of the online metric suite."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    ax = (-2, -1)
    mu_a, mu_b = a.mean(ax), b.mean(ax)
    da = a - mu_a[..., None, None]
    db = b - mu_b[..., None, None]
    var_a, var_b = (da ** 2).mean(ax), (db ** 2).mean(ax)
    cov = (da * db).mean(ax)
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)
    return num / (den + EPS_RATIO)


def ssim2d(a: torch.Tensor, b: torch.Tensor, c1: float = 0.01 ** 2,
           c2: float = 0.03 ** 2) -> float:
    """Single-frame global-statistics SSIM."""
    return float(_ssim_stack(a[None, None], b[None, None], c1, c2)[0, 0])


def ssim_spatial(pred: torch.Tensor, gt: torch.Tensor, use_pool8: bool = True) -> float:
    pred, gt = _as_stack(pred), _as_stack(gt)
    if use_pool8:
        pred, gt = _block_mean8(pred), _block_mean8(gt)
    return float(_ssim_stack(pred, gt).mean())


def delta_tssim(pred: torch.Tensor, gt: torch.Tensor, lag: int = 1,
                use_pool8: bool = True) -> float:
    """Temporal-consistency delta: SSIM(frame_t, frame_{t-lag}) series of the
    prediction minus the same series of the truth, averaged."""
    pred, gt = _as_stack(pred), _as_stack(gt)
    if pred.shape[1] <= lag:
        return float("nan")
    if use_pool8:
        pred, gt = _block_mean8(pred), _block_mean8(gt)
    series = lambda x: _ssim_stack(x[:, lag:], x[:, :-lag])  # noqa: E731
    return float((series(pred) - series(gt)).mean())


# --------------------------------------------------------------------------
# categorical scores from a 2x2 contingency table
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Contingency:
    hits: float
    misses: float
    false_alarms: float
    correct_negatives: float

    @classmethod
    def at_threshold(cls, pred: torch.Tensor, gt: torch.Tensor,
                     threshold: float) -> "Contingency":
        """Counted on the device, exactly (NaN is below every threshold)."""
        p = pred >= threshold
        g = gt >= threshold
        counts = torch.stack([(p & g).sum(), (~p & g).sum(), (p & ~g).sum(),
                              (~p & ~g).sum()]).tolist()
        return cls(*(float(c) for c in counts))

    @property
    def pod(self) -> float:
        return self.hits / (self.hits + self.misses + EPS_RATIO)

    @property
    def far(self) -> float:
        return self.false_alarms / (self.hits + self.false_alarms + EPS_RATIO)

    @property
    def csi(self) -> float:
        return self.hits / (self.hits + self.misses + self.false_alarms + EPS_RATIO)

    @property
    def hss(self) -> float:
        # exp1-specific denominator, kept as the JAX suite has it
        # (experiments/exp1.py:209-217): it differs from metric.py's HSS
        h, m, f, c = (self.hits, self.misses, self.false_alarms,
                      self.correct_negatives)
        if h + m + f + c <= 0:
            return float("nan")
        den = m ** 2 + f ** 2 + 2 * h * c + (m + f) * (h + c) + EPS_RATIO
        return 2 * (h * c - m * f) / den


def categorical_metrics(pred: torch.Tensor, gt: torch.Tensor,
                        threshold: float) -> Dict[str, float]:
    tab = Contingency.at_threshold(pred, gt, threshold)
    return {"POD": tab.pod, "FAR": tab.far, "CSI": tab.csi, "HSS": tab.hss}


# --------------------------------------------------------------------------
# evaluation-pixel selection and event concatenation
# --------------------------------------------------------------------------

def apply_mask_mode(pred, gt, mask, mode: str) -> Dict[str, torch.Tensor]:
    """radar => score the *held-out* (mask==0) pixels; gauge => score the
    gauge (mask==1) pixels."""
    if mode not in ("radar", "gauge"):
        raise ValueError(f"Unknown mode: {mode}")
    invert = mode == "radar"
    return {"pred": select_by_mask(pred, mask, invert=invert),
            "gt": select_by_mask(gt, mask, invert=invert)}


def _pair_method(name: str, src: ArrayOrEvents, truth_events: Dict[str, np.ndarray],
                 keys) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(pred, truth) frame stacks with event-wise correspondence, on the host.

    Alignment happens PER EVENT: a method store missing an event (or holding
    a shorter prediction) drops/truncates that event's truth for THAT method
    only, with a warning. Served stores key events ``event_%02d`` from 1."""
    if not isinstance(src, dict):
        # pre-concatenated flat prediction array: pair against the full
        # truth concatenation
        full = np.concatenate([truth_events[k] for k in keys], axis=0)
        return align_length(ensure_thw(src), full)
    pred_chunks, truth_chunks = [], []
    for k in keys:
        pv = src.get(k)
        if pv is None:
            logging.warning("exp1: method %r has no event %r; event excluded "
                            "from its scores", name, k)
            continue
        p, t = align_length(ensure_thw(pv), truth_events[k])
        pred_chunks.append(p)
        truth_chunks.append(t)
    if not pred_chunks:
        logging.warning("exp1: method %r shares no events with the truth "
                        "store; skipped", name)
        return None
    return np.concatenate(pred_chunks, axis=0), np.concatenate(truth_chunks, axis=0)


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

_SCALAR_METRICS = (
    ("MAE", mae),
    ("RMSE", rmse),
    ("PSS", pss),
    ("NSE", nse),
)


def run_exp1(preds: Dict[str, ArrayOrEvents],
             truth: ArrayOrEvents,
             mask: np.ndarray,
             mode: str,
             crop_size: int,
             thresholds: Tuple[float, ...] = THRESHOLDS_MMHR,
             use_pool8: bool = True,
             divide_by_3: bool = True,
             device: str | torch.device = "cuda") -> Dict[str, Dict[str, float]]:
    """Score every method against the truth over all concatenated events, on
    ``device`` (``cuda`` raises when no GPU is available).

    Selected-pixel scores (MAE/RMSE/PSS/NSE/categorical) use the mask-mode
    pixels; SSIM/DTSSIM use the full cropped frames. The transform is
    elementwise and the crop spatial, so both commute with the temporal
    alignment: cropping before the transform gives the JAX suite's values.
    """
    dev = resolve_device(device)
    if isinstance(truth, dict):
        truth_events = {k: ensure_thw(v) for k, v in truth.items() if v is not None}
        keys = list(truth_events.keys())
        if not keys:
            return {}
        paired = {}
        for name, src in preds.items():
            pt = _pair_method(name, src, truth_events, keys)
            if pt is not None:
                paired[name] = pt
    else:
        t_full = ensure_thw(truth)
        paired = {name: align_length(ensure_thw(src), t_full)
                  for name, src in preds.items()}

    mask_t = to_device(np.asarray(mask, dtype=bool), dev)
    report: Dict[str, Dict[str, float]] = {}
    for name, (pred_raw, truth_raw) in paired.items():
        truth_t = transform_mmhr(crop_center(to_device(truth_raw, dev), crop_size),
                                 divide_by_3=divide_by_3)
        pred = transform_mmhr(crop_center(to_device(pred_raw, dev), crop_size),
                              divide_by_3=divide_by_3)
        sel = apply_mask_mode(pred, truth_t, mask_t, mode)

        row: Dict[str, float] = {k: fn(sel["pred"], sel["gt"])
                                 for k, fn in _SCALAR_METRICS}
        row["SSIM"] = ssim_spatial(pred, truth_t, use_pool8=use_pool8)
        row["DTSSIM_L1"] = delta_tssim(pred, truth_t, lag=1, use_pool8=use_pool8)
        row["DTSSIM_L2"] = delta_tssim(pred, truth_t, lag=2, use_pool8=use_pool8)
        for thr in thresholds:
            row[f"CAT_{thr:g}"] = categorical_metrics(sel["pred"], sel["gt"], thr)
        # the JAX suite's result order: MAE, RMSE, PSS, SSIM, DTSSIMs, NSE, CATs
        report[name] = {k: row[k] for k in
                        ("MAE", "RMSE", "PSS", "SSIM", "DTSSIM_L1",
                         "DTSSIM_L2", "NSE")} | {
                        f"CAT_{t:g}": row[f"CAT_{t:g}"] for t in thresholds}
    return report
