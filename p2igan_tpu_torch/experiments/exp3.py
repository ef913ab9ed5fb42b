"""exp3 -- NSE analysis: per-event scores, scatter/residual panels, boxplot.

The port's counterpart of ``experiments/exp3.py``. The scores (aggregate NSE
per method, per-event per-frame NSE clamped >= 0 and NaN-averaged) run on
tensors of an explicit device: :func:`exp3_metrics` returns ``metrics.json``'s
content. The four figures (scatter and residual panels with linregress R^2 +
slope, the log-frequency histogram, the per-event NSE boxplot) are drawn on
the host with matplotlib, imported inside the functions that draw; without
it, :func:`run_exp3` raises the ImportError that names it.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Tuple, Union

import numpy as np
import torch

from ..parallel.mesh import resolve_device
from .exp1 import transform_mmhr
from .io import align_length, crop_center, ensure_dir, ensure_thw, select_by_mask, to_device

SCATTER_COLORS = ['#1f77b4', '#ff7f0e', '#2ca02c', '#d62728', '#9467bd', '#8c564b']

ArrayOrEvents = Union[np.ndarray, Dict[str, np.ndarray]]


def nse(pred: torch.Tensor, gt: torch.Tensor) -> float:
    """NSE over the pairs where both values are finite (``nan`` if none)."""
    pred, gt = pred.to(torch.float64), gt.to(torch.float64)
    m = torch.isfinite(pred) & torch.isfinite(gt)
    pred, gt = pred[m], gt[m]
    if pred.numel() == 0:
        return float("nan")
    num = ((pred - gt) ** 2).sum()
    den = ((gt - gt.mean()) ** 2).sum()
    num, den = torch.stack([num, den]).tolist()
    return float(1.0 - num / (den + 1e-10))


def _mode_invert(mode: str) -> bool:
    """Mask-mode semantics shared with exp1's apply_mask_mode: radar scores
    the masked-OUT pixels, gauge the observed ones."""
    if mode not in ("radar", "gauge"):
        raise ValueError(f"Unknown mode: {mode}")
    return mode == "radar"


def _select_values(pred, gt, mask, mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    invert = _mode_invert(mode)
    return (select_by_mask(pred, mask, invert=invert).reshape(-1),
            select_by_mask(gt, mask, invert=invert).reshape(-1))


def nse_per_frame(pred: torch.Tensor, gt: torch.Tensor, mask, mode: str) -> torch.Tensor:
    """Per-frame NSE over the mode-selected pixels, vectorized over T, as a
    float64 tensor: non-finite pixels are dropped per frame; frames with no
    finite pixel give NaN."""
    t = min(pred.shape[0], gt.shape[0])
    invert = _mode_invert(mode)
    p = select_by_mask(pred[:t], mask, invert=invert).to(torch.float64)
    g = select_by_mask(gt[:t], mask, invert=invert).to(torch.float64)
    ok = torch.isfinite(p) & torch.isfinite(g)          # (T, n_sel)
    n_ok = ok.sum(dim=1)
    zero = torch.zeros((), dtype=torch.float64, device=p.device)
    resid = torch.where(ok, (p - g) ** 2, zero).sum(dim=1)
    g_mean = torch.where(ok, g, zero).sum(dim=1) / torch.clamp_min(n_ok, 1).to(torch.float64)
    spread = torch.where(ok, (g - g_mean[:, None]) ** 2, zero).sum(dim=1)
    out = 1.0 - resid / (spread + 1e-10)
    return torch.where(n_ok > 0, out, torch.full_like(out, float("nan")))


def _event_nse_score(pred_ev: torch.Tensor, truth_ev: torch.Tensor, mask,
                     mode: str) -> float:
    """One event's NSE: per-frame scores clamped >= 0, NaN-averaged."""
    frames = nse_per_frame(pred_ev, truth_ev, mask, mode)
    frames = torch.where(torch.isfinite(frames), torch.clamp_min(frames, 0.0),
                         torch.full_like(frames, float("nan")))
    if not bool(torch.isfinite(frames).any()):
        return float("nan")
    return float(torch.nanmean(frames))


def _mmhr_crop(raw, crop_size: int, dev: torch.device) -> torch.Tensor:
    """Raw frames -> cropped mm/h on ``dev`` (the transform is elementwise,
    so cropping first gives the same values with less work)."""
    return transform_mmhr(crop_center(to_device(raw, dev), crop_size))


def _per_event_pass(preds: Dict[str, ArrayOrEvents], truth: Dict[str, np.ndarray],
                    mask, mode: str, crop_size: int, dev: torch.device):
    """Walk events once: per-event NSE scores + transformed/cropped
    per-method (pred, truth) pairs for the aggregate metrics and plots.

    Pairing is PER EVENT and per method: a method store missing an event (or
    holding a shorter prediction) drops/truncates that event's truth for
    that method only."""
    scores: Dict[str, List[float]] = {name: [] for name in preds}
    chunks: Dict[str, List[torch.Tensor]] = {name: [] for name in preds}
    truth_by: Dict[str, List[torch.Tensor]] = {name: [] for name in preds}
    # flat (non-dict) stores hold all events concatenated in truth's key
    # order (the layout exp1's pairing also accepts): slice sequentially
    # (experiments/exp3.py:244-251)
    flat_offset: Dict[str, int] = {}

    for key, truth_ev in truth.items():
        if truth_ev is None:
            continue
        # normalize to (T, H, W) BEFORE any slicing, like exp1's pairing
        truth_ev = ensure_thw(truth_ev)
        t_len = int(truth_ev.shape[0])
        truth_ev = _mmhr_crop(truth_ev, crop_size, dev)
        for name, src in preds.items():
            if isinstance(src, dict):
                raw_ev = src.get(key)
            else:
                off = flat_offset.get(name, 0)
                raw_ev = ensure_thw(src)[off:off + t_len]
                flat_offset[name] = off + t_len
                if raw_ev.shape[0] == 0:
                    raw_ev = None
            if raw_ev is None:
                logging.warning("exp3: method %r has no frames for event %r; "
                                "event excluded from its aggregates", name, key)
                continue
            pred_ev, truth_al = align_length(_mmhr_crop(raw_ev, crop_size, dev), truth_ev)
            scores[name].append(_event_nse_score(pred_ev, truth_al, mask, mode))
            chunks[name].append(pred_ev)
            truth_by[name].append(truth_al)

    paired = {name: (torch.cat(chunks[name]), torch.cat(truth_by[name]))
              for name in preds if chunks[name]}
    return paired, scores


def _exp3_pass(preds: Dict[str, ArrayOrEvents], truth: ArrayOrEvents, mask, mode: str,
               crop_size: int, dev: torch.device):
    """(metrics, per-method (pred, truth) pairs, per-event NSE by method)."""
    mask_t = to_device(np.asarray(mask, dtype=bool), dev)
    if isinstance(truth, dict):
        paired, nse_by_method = _per_event_pass(preds, truth, mask_t, mode, crop_size,
                                                dev)
    else:
        nse_by_method = {}
        truth_t = _mmhr_crop(truth, crop_size, dev)
        paired = {name: align_length(_mmhr_crop(p, crop_size, dev), truth_t)
                  for name, p in preds.items()}
    metrics: Dict[str, float] = {}
    for name, (pred, truth_al) in paired.items():
        metrics[f"NSE_{name}"] = nse(*_select_values(pred, truth_al, mask_t, mode))
    return metrics, paired, nse_by_method


def exp3_metrics(preds: Dict[str, ArrayOrEvents], truth: ArrayOrEvents,
                 mask: np.ndarray, mode: str, crop_size: int,
                 device: str | torch.device = "cuda") -> Dict[str, float]:
    """``{"NSE_<method>": ...}``: exp3's ``metrics.json``, on ``device``
    (``cuda`` raises when no GPU is available). No figure is drawn."""
    return _exp3_pass(preds, truth, mask, mode, crop_size, resolve_device(device))[0]


# --------------------------------------------------------------------------
# figures (host, matplotlib)
# --------------------------------------------------------------------------

def _subsample(x, y, max_points, rng):
    if x.size > max_points:
        idx = rng.choice(x.size, size=max_points, replace=False)
        return x[idx], y[idx]
    return x, y


def _fit_and_annotate(ax, x, y, lim_x):
    from scipy import stats

    if x.size >= 2:
        slope, intercept, r, _, _ = stats.linregress(x, y)
        x_line = np.linspace(lim_x[0], lim_x[1], 200)
        ax.plot(x_line, intercept + slope * x_line, 'k--', lw=1.0)
        ax.text(0.04, 0.82, f"R²={r ** 2:.3f}\nslope={slope:.3f}",
                transform=ax.transAxes, fontsize=11)


def scatter_panels(pred_list, true, labels, save_path, lim=(0, 32),
                   max_points=2000, alpha=0.6, s=10, min_value=0.1,
                   seed=42, residual=False, lim_y=(-24, 8)) -> None:
    """Scatter (pred vs obs) or residual (pred-obs vs obs) panel row."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(seed)
    n = len(pred_list)
    # `true` is either one shared observation array or a per-method list of
    # paired truths (methods with missing events carry their own pairing)
    trues = list(true) if isinstance(true, (list, tuple)) else [true] * n
    if n == 0 or all(np.asarray(t).size == 0 for t in trues):
        return  # BEFORE subplots: plt.subplots(1, 0) raises ValueError
    fig, axes = plt.subplots(1, n, figsize=(18, 3), dpi=200)
    if n == 1:
        axes = [axes]
    for i, (pred, label) in enumerate(zip(pred_list, labels)):
        ax = axes[i]
        tf = np.asarray(trues[i], np.float64).ravel()
        pf = np.asarray(pred, np.float64).ravel()
        k = min(tf.size, pf.size)
        tf, pf = tf[:k], pf[:k]
        m = np.isfinite(pf) & np.isfinite(tf)
        x = tf[m]
        yv = pf[m] - tf[m] if residual else pf[m]
        keep = x >= min_value
        x, yv = _subsample(x[keep], yv[keep], max_points, rng)
        ax.scatter(x, yv, s=s, alpha=alpha, color=SCATTER_COLORS[i % 6],
                   edgecolors='none', zorder=1)
        x_line = np.linspace(lim[0], lim[1], 200)
        if residual:
            ax.plot(x_line, np.zeros_like(x_line), color='gray', ls=':', lw=1.0)
            ax.axhline(0, color='black', lw=1.0, ls='--')
            ax.set_ylim(*lim_y)
            if i == 0:
                ax.set_ylabel("Residual (Pred - Obs, mm/h)", fontsize=12)
        else:
            ax.plot(x_line, x_line, color='gray', ls=':', lw=1.0)
            ax.set_ylim(*lim)
            ax.set_aspect('equal', 'box')
            if i == 0:
                ax.set_ylabel("Pred (mm/h)", fontsize=12)
        _fit_and_annotate(ax, x, yv, lim)
        ax.set_title(label, fontsize=13, fontweight='bold', pad=4)
        ax.set_xlim(*lim)
        ax.set_xlabel("Obs (mm/h)", fontsize=12)
        ax.grid(False)
    plt.tight_layout(pad=1.0)
    plt.savefig(save_path, bbox_inches='tight')
    plt.close(fig)


def logfreq_plot(pred_list, true, labels, save_path, lim=(0, 32), bins=64) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(1, 1, figsize=(6, 4), dpi=200)
    bin_edges = np.linspace(lim[0], lim[1], bins + 1)
    tf = np.asarray(true, np.float64).ravel()
    tf = tf[np.isfinite(tf)]
    if tf.size == 0:
        plt.close(fig)
        return
    hist_t, _ = np.histogram(tf, bins=bin_edges)
    ax.semilogy(bin_edges[:-1], hist_t / max(hist_t.sum(), 1), color='black',
                lw=1.6, label='Obs')
    for i, (pred, label) in enumerate(zip(pred_list, labels)):
        color = SCATTER_COLORS[i % len(SCATTER_COLORS)]
        pf = np.asarray(pred, np.float64).ravel()
        pf = pf[np.isfinite(pf)]
        if pf.size == 0:
            continue
        hist_p, _ = np.histogram(pf, bins=bin_edges)
        ax.semilogy(bin_edges[:-1], hist_p / max(hist_p.sum(), 1), color=color,
                    lw=1.6, label=label)
    ax.set_xlim(*lim)
    ax.set_xlabel("Rainfall (mm/h)")
    ax.set_ylabel("Relative Frequency (log scale)")
    ax.legend(frameon=True, fontsize=9)
    plt.tight_layout()
    plt.savefig(save_path, bbox_inches="tight")
    plt.close(fig)


def nse_boxplot(nse_by_method: Dict[str, List[float]], out_path: str) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    methods = list(nse_by_method.keys())
    # non-finite per-event scores (empty / all-NaN events) would make
    # matplotlib draw NaN percentiles; the event count still reports the
    # largest method's coverage below
    data = [[v for v in nse_by_method[m] if np.isfinite(v)] for m in methods]
    fig, ax = plt.subplots(figsize=(6, 4), dpi=200)
    box = ax.boxplot(data, tick_labels=methods, patch_artist=True, showmeans=True,
                     boxprops=dict(linewidth=1.2, color='black'),
                     medianprops=dict(linewidth=2.0, color='black'),
                     meanprops=dict(marker='D', markerfacecolor='white',
                                    markeredgecolor='black', markersize=5))
    for patch, color in zip(box['boxes'], SCATTER_COLORS):
        patch.set_facecolor(color)
        patch.set_alpha(0.7)
    ax.set_ylabel('NSE', fontsize=14)
    ax.set_xlabel('Methods', fontsize=13)
    n_events = max((len(v) for v in nse_by_method.values()), default=0)
    ax.set_title(f'NSE Comparison ({n_events} Rain Events)', fontsize=14,
                 fontweight='bold')
    ax.set_ylim(-0.2, 1.0)
    plt.tight_layout()
    plt.savefig(out_path, format='pdf', bbox_inches='tight')
    plt.close(fig)


def exp3_figures(paired: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                 nse_by_method: Dict[str, List[float]], truth_flat: np.ndarray,
                 out_dir: str) -> None:
    """The four figures of one exp3 pass, from host copies of its arrays."""
    pred_list = [pred.cpu().numpy().ravel() for pred, _ in paired.values()]
    truth_list = [truth_al.cpu().numpy().ravel() for _, truth_al in paired.values()]
    labels = list(paired.keys())
    figure = lambda fname: os.path.join(out_dir, fname)  # noqa: E731
    scatter_panels(pred_list, truth_list, labels, figure("scatter_panels.pdf"),
                   residual=False)
    scatter_panels(pred_list, truth_list, labels, figure("residual_panels.pdf"),
                   residual=True)
    if nse_by_method:
        nse_boxplot(nse_by_method, figure("nse_boxplot.pdf"))
    if pred_list and truth_flat.size:
        # logfreq needs no per-event data: flat-truth runs produce it too
        logfreq_plot(pred_list, truth_flat, labels, figure("logfreq.pdf"))


def run_exp3(preds: Dict[str, ArrayOrEvents],
             truth: ArrayOrEvents,
             mask: np.ndarray,
             mode: str,
             crop_size: int,
             out_dir: str,
             device: str | torch.device = "cuda") -> Dict[str, float]:
    """Aggregate + per-event NSE analysis with the four figures; returns
    ``metrics.json``'s content (per-event boxplot data only exists for
    dict-of-events inputs)."""
    dev = resolve_device(device)
    ensure_dir(out_dir)
    metrics, paired, nse_by_method = _exp3_pass(preds, truth, mask, mode, crop_size, dev)
    if isinstance(truth, dict):
        events = [ev for ev in truth.values() if ev is not None]
        truth_flat = (torch.cat([_mmhr_crop(ev, crop_size, dev).reshape(-1)
                                 for ev in events]).cpu().numpy()
                      if events else np.empty((0,)))
    else:
        truth_flat = _mmhr_crop(truth, crop_size, dev).reshape(-1).cpu().numpy()
    exp3_figures(paired, nse_by_method, truth_flat, out_dir)
    return metrics
