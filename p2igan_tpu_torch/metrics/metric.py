"""Online evaluation metric suite (regression / categorical / FSS) in PyTorch.

Counterpart of ``p2igan_tpu/metrics/metric.py`` (reference
``p2igan_bench/metrics/metric.py``). Each metric is (init, update, compute)
over a state that is a dict of float32 tensors with the JAX leaves' names, so
a state compares leaf by leaf with the JAX suite's. ``update`` runs on the
state's device and never waits for it; ``compute`` alone reads the state to
the host. Every leaf is a sum, so a multi-device run would all-reduce the
state dict (not ported: one device here).

The rainfall transform here is ``10^(x*0.0625)*0.036`` (metric.py:16-20);
it differs from ``losses.transform`` on purpose, as in the reference.

None of this is a kernel of the JAX package: it leaves the suite to XLA
outside any Pallas kernel, and the port leaves it to PyTorch's own kernels
and cuDNN (the separable Gaussian blur, the average pools).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.convs import avg_pool2d

EPS = 1e-10

State = Dict[str, torch.Tensor]


def transform(output: torch.Tensor) -> torch.Tensor:
    """Normalized values -> rainfall intensity (reference metric.py:16-20)."""
    return torch.pow(10.0, output * 0.0625) * 0.036


def _to_nhw(x: torch.Tensor) -> torch.Tensor:
    """(B,T,H,W,C) / (B,T,H,W) / (B,H,W) ... -> (N, H, W).

    5D input is always (B,T,H,W,C); C>1 folds each channel into its own
    (H,W) plane. Any other input is (..., H, W) after a trailing C=1 goes."""
    if x.dim() >= 3 and x.shape[-1] == 1:
        x = x[..., 0]
    elif x.dim() == 5:
        x = torch.movedim(x, -1, 2)  # (B,T,C,H,W)
    return x.reshape(-1, x.shape[-2], x.shape[-1])


# ---------------------------------------------------------------------------
# SSIM (torchmetrics-compatible: gaussian 11x11 sigma 1.5, border crop,
# per-image mean), in valid mode
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=4)
def _gaussian_kernel1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _gaussian_kernel_on(size: int, sigma: float, device: torch.device) -> torch.Tensor:
    """The kernel on ``device``, copied there once (a copy from the host
    waits for the device)."""
    return torch.from_numpy(_gaussian_kernel1d(size, sigma)).to(device)


def _gaussian_blur_valid(x: torch.Tensor, size: int = 11,
                         sigma: float = 1.5) -> torch.Tensor:
    """Separable VALID-mode gaussian filter on (N, H, W) -> (N, H-2p, W-2p):
    torchmetrics' reflect pad, blur and border crop give the same values."""
    k = _gaussian_kernel_on(size, sigma, x.device)
    y = F.conv2d(x[:, None], k.reshape(1, 1, size, 1))
    y = F.conv2d(y, k.reshape(1, 1, 1, size))
    return y[:, 0]


def ssim_per_image(preds: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
                   size: int = 11, sigma: float = 1.5,
                   k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Per-image SSIM over (N, H, W); torchmetrics SSIM semantics."""
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    pad = (size - 1) // 2
    if preds.shape[1] <= 2 * pad or preds.shape[2] <= 2 * pad:
        # the border crop would empty the image, and the mean of nothing is
        # NaN, which would poison the running ssim_sum
        raise ValueError(
            f"SSIM window {size} needs images larger than {2 * pad} per "
            f"side, got {preds.shape[1]}x{preds.shape[2]}")
    n = preds.shape[0]
    stacked = torch.cat([preds, target, preds * preds, target * target, preds * target])
    mu_x, mu_y, e_xx, e_yy, e_xy = torch.chunk(_gaussian_blur_valid(stacked, size, sigma), 5)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sig_x = e_xx - mu_x2
    sig_y = e_yy - mu_y2
    sig_xy = e_xy - mu_xy
    num = (2 * mu_xy + c1) * (2 * sig_xy + c2)
    den = (mu_x2 + mu_y2 + c1) * (sig_x + sig_y + c2)
    return (num / den).reshape(n, -1).mean(dim=-1)


def _zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Regression metrics: MAE / RMSE / SSIM
# ---------------------------------------------------------------------------


def regression_metrics_init(device=None) -> State:
    return {k: _zeros((), device) for k in ("abs_sum", "squared_sum", "n_obs",
                                            "ssim_sum", "ssim_n")}


def regression_metrics_update(state: State, preds: torch.Tensor, target: torch.Tensor,
                              apply_transform: bool = True,
                              data_range: float = 1.0) -> State:
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)
    if apply_transform:
        preds = transform(preds)
        target = transform(target)
    diff = preds - target
    ssim_vals = ssim_per_image(_to_nhw(preds), _to_nhw(target), data_range=data_range)
    return {
        "abs_sum": state["abs_sum"] + torch.sum(torch.abs(diff)),
        "squared_sum": state["squared_sum"] + torch.sum(diff * diff),
        "n_obs": state["n_obs"] + diff.numel(),
        "ssim_sum": state["ssim_sum"] + torch.sum(ssim_vals),
        "ssim_n": state["ssim_n"] + ssim_vals.shape[0],
    }


def _host(state: State) -> State:
    return {k: v.detach().cpu() for k, v in state.items()}


def regression_metrics_compute(state: State) -> Dict[str, float]:
    """On the host, in the JAX suite's float32 arithmetic."""
    s = _host(state)
    n = torch.clamp(s["n_obs"], min=1.0)
    return {
        "mae": float(s["abs_sum"] / n),
        "rmse": float(torch.sqrt(s["squared_sum"] / n)),
        "ssim": float(s["ssim_sum"] / torch.clamp(s["ssim_n"], min=1.0)),
    }


# ---------------------------------------------------------------------------
# Categorical metrics: POD / FAR / CSI / HSS per threshold
# ---------------------------------------------------------------------------


def categorical_metrics_init(n_thresholds: int, device=None) -> State:
    return {k: _zeros((n_thresholds,), device) for k in ("hits", "misses", "false",
                                                         "correct")}


def categorical_metrics_update(state: State, preds: torch.Tensor, target: torch.Tensor,
                               thresholds: Tuple[float, ...]) -> State:
    preds = transform(preds.to(torch.float32)).reshape(-1)
    target = transform(target.to(torch.float32)).reshape(-1)
    # (n_thresholds, M); each threshold a scalar, so no tensor crosses from
    # the host
    tp = torch.stack([preds >= t for t in thresholds])
    tt = torch.stack([target >= t for t in thresholds])

    def count(m: torch.Tensor) -> torch.Tensor:
        return torch.sum(m, dim=1).to(torch.float32)

    return {
        "hits": state["hits"] + count(tp & tt),
        "misses": state["misses"] + count(~tp & tt),
        "false": state["false"] + count(tp & ~tt),
        "correct": state["correct"] + count(~tp & ~tt),
    }


def categorical_metrics_compute(state: State,
                                thresholds: Tuple[float, ...]) -> Dict[str, float]:
    s = _host(state)
    metrics: Dict[str, float] = {}
    for idx, thr in enumerate(thresholds):
        hits = float(s["hits"][idx])
        misses = float(s["misses"][idx])
        false = float(s["false"][idx])
        correct = float(s["correct"][idx])
        pod = hits / (hits + misses + EPS)
        far = false / (hits + false + EPS)
        csi = hits / (hits + misses + false + EPS)
        # REFERENCE QUIRK kept (metric.py:126): the first HSS denominator
        # term is (misses+false)*(false+correct) where Heidke's formula has
        # (hits+false)*(false+correct); a perfect forecast scores 2.0
        denom = (misses + false) * (false + correct) + (hits + misses) * (misses + correct)
        hss = 2 * (hits * correct - misses * false) / (denom + EPS)
        prefix = f"cat_thr{thr:.2f}"
        metrics[f"{prefix}/pod"] = pod
        metrics[f"{prefix}/far"] = far
        metrics[f"{prefix}/csi"] = csi
        metrics[f"{prefix}/hss"] = hss
    return metrics


# ---------------------------------------------------------------------------
# Fractional Skill Score across thresholds x spatial scales
# ---------------------------------------------------------------------------


def fss_init(n_thresholds: int, n_scales: int, device=None) -> State:
    return {k: _zeros((n_thresholds, n_scales), device) for k in ("score_sum", "counts")}


def _fractional_mean(x: torch.Tensor, scale: int) -> torch.Tensor:
    """avg_pool2d(kernel=scale, stride=1, padding=scale//2), padding counted,
    over the last two dims (H+1 rows and columns for an even scale)."""
    if scale == 1:
        return x
    return avg_pool2d(x, scale, 1, padding=scale // 2)


def fss_update(state: State, preds: torch.Tensor, target: torch.Tensor,
               thresholds: Tuple[float, ...], scales: Tuple[int, ...]) -> State:
    """All thresholds at once: the event masks are (N, n_thresholds, H, W)
    planes, one pool a scale."""
    preds = transform(_to_nhw(preds.to(torch.float32)))
    target = transform(_to_nhw(target.to(torch.float32)))
    pm = torch.stack([preds >= t for t in thresholds], dim=1).to(torch.float32)
    tm = torch.stack([target >= t for t in thresholds], dim=1).to(torch.float32)
    cols = []
    for scale in scales:
        fp = _fractional_mean(pm, int(scale))
        ft = _fractional_mean(tm, int(scale))
        num = torch.mean((fp - ft) ** 2, dim=(0, 2, 3))
        den = torch.mean(fp ** 2 + ft ** 2, dim=(0, 2, 3))
        # REFERENCE QUIRK kept (metric.py:166-173): a batch with no pixel
        # above the threshold in pred and target scores 1.0 (0/EPS) and is
        # counted
        cols.append(1.0 - num / (den + EPS))
    return {"score_sum": state["score_sum"] + torch.stack(cols, dim=1),
            "counts": state["counts"] + 1.0}


def fss_compute(state: State, thresholds: Tuple[float, ...],
                scales: Tuple[int, ...]) -> Dict[str, float]:
    s = _host(state)
    metrics: Dict[str, float] = {}
    for ti, thr in enumerate(thresholds):
        for si, scale in enumerate(scales):
            if float(s["counts"][ti, si]) == 0:
                continue
            metrics[f"fss_thr{thr:.2f}_s{int(scale)}"] = float(
                s["score_sum"][ti, si] / s["counts"][ti, si])
    return metrics


# ---------------------------------------------------------------------------
# Loss-averaging metrics (reference losses.py:256-310 torchmetrics wrappers:
# WeightedL1Metric / K1LossMetric / ShockDifferenceMetric) as accumulators
# ---------------------------------------------------------------------------


def loss_metric_init(device=None) -> State:
    return {"loss_sum": _zeros((), device), "n_obs": _zeros((), device)}


def loss_metric_update(state: State, loss: torch.Tensor) -> State:
    return {"loss_sum": state["loss_sum"] + loss, "n_obs": state["n_obs"] + 1.0}


def loss_metric_compute(state: State) -> float:
    s = _host(state)
    return float(s["loss_sum"] / torch.clamp(s["n_obs"], min=1.0))


def weighted_l1_metric_update(state: State, preds, target) -> State:
    from ..losses import weighted_l1_distance

    return loss_metric_update(state, weighted_l1_distance(preds, target))


def k1_loss_metric_update(state: State, preds, target, temp_alpha: float = 1.0,
                          k1_alpha: float = 0.0) -> State:
    from ..losses import k1_loss

    return loss_metric_update(state, k1_loss(preds, target, temp_alpha, k1_alpha))


def shock_difference_metric_update(state: State, preds, target, beta: float = 0.02,
                                   border_ignore: int = 2, pool: int = 1) -> State:
    from ..losses import shock_map_loss

    return loss_metric_update(
        state, shock_map_loss(preds, target, beta=beta, border_ignore=border_ignore,
                              pool=pool).mean())


# ---------------------------------------------------------------------------
# Orchestrator
# ---------------------------------------------------------------------------


@dataclass
class MetricConfig:
    thresholds: Sequence[float] = (0.5, 2.0, 4.0, 8.0)
    scales: Sequence[int] = (1, 2, 4, 8)
    apply_transform: bool = True
    data_range: float = 1.0


class RainfallMetricSuite:
    """Bundles regression/categorical/FSS metrics (reference metric.py:194-229).

    ``state`` is the tuple (regression, categorical, fss) of state dicts on
    ``device``; ``update`` adds a batch on that device without waiting for
    it, ``compute`` reads the sums to the host."""

    def __init__(self, config: MetricConfig | None = None,
                 device: str | torch.device = "cuda"):
        cfg = config or MetricConfig()
        # frozen at construction: reset() and compute() must label the
        # accumulated counts with the thresholds/scales update() used
        self.cfg = MetricConfig(
            thresholds=tuple(float(t) for t in cfg.thresholds),
            scales=tuple(int(s) for s in cfg.scales),
            apply_transform=bool(cfg.apply_transform),
            data_range=float(cfg.data_range))
        self.device = torch.empty(0, device=device).device  # with its index: cuda -> cuda:0
        _gaussian_kernel_on(11, 1.5, self.device)  # its one copy: here, not in update
        self.reset()

    def reset(self) -> None:
        n_thr, n_sc = len(self.cfg.thresholds), len(self.cfg.scales)
        self.state = (regression_metrics_init(self.device),
                      categorical_metrics_init(n_thr, self.device),
                      fss_init(n_thr, n_sc, self.device))

    @torch.no_grad()
    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        preds = preds.to(self.device)
        target = target.to(self.device)
        reg, cat, fss = self.state
        thr, sc = self.cfg.thresholds, self.cfg.scales
        self.state = (
            regression_metrics_update(reg, preds, target, self.cfg.apply_transform,
                                      self.cfg.data_range),
            categorical_metrics_update(cat, preds, target, thr),
            fss_update(fss, preds, target, thr, sc))

    def compute(self) -> Dict[str, float]:
        thr, sc = self.cfg.thresholds, self.cfg.scales
        reg, cat, fss = self.state
        out: Dict[str, float] = {}
        out.update(regression_metrics_compute(reg))
        out.update(categorical_metrics_compute(cat, thr))
        out.update(fss_compute(fss, thr, sc))
        return out


__all__ = [
    "transform",
    "MetricConfig",
    "RainfallMetricSuite",
    "ssim_per_image",
]
