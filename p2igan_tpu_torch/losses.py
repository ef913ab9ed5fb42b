"""Loss library of the port (PyTorch).

Counterpart of ``p2igan_tpu/losses.py`` (reference
``p2igan_bench/modules/losses.py``): the NowcastNet-weighted L1, the
temperature-softmax KL of temporal differences, spatial pooling,
temporal-difference matching, the Sobel + Laplacian shock maps, the k1
combination and the adversarial losses (hinge / nsgan / lsgan). The train
step uses the weighted L1, the KL and the adversarial losses; the metric
suite's loss metrics use the rest. Elementwise losses take any layout (the
training batch is (B, T, H, W, C)); the functions with spatial structure take
(B, T, H, W).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .ops.convs import max_pool2d, reflect_pad2d


def transform(x: torch.Tensor) -> torch.Tensor:
    """Normalized rainfall -> mm scale (legacy helper, losses.py:51-53); not
    the metric suite's ``metrics.transform``."""
    return 0.036 * torch.pow(10.0, (x * 255.0 / 3.0) * 0.0625)


def weighted_l1_distance(x_pred: torch.Tensor, x_true: torch.Tensor) -> torch.Tensor:
    """NowcastNet weighted L1 (losses.py:56-65): w = a*exp(b*x)+c, capped at
    x_true > 0.70."""
    a, b, c = 0.50, 5.14, 0.12
    x_max = 0.70
    w_max = a * math.exp(b * x_max) + c
    w = a * torch.exp(b * x_true) + c
    weight = torch.where(x_true > x_max, torch.full_like(w, w_max), w)
    return torch.mean(weight * torch.abs(x_pred - x_true))


def softmax_temperature(x: torch.Tensor, temperature: float) -> torch.Tensor:
    """Temperature softmax over all dims after the first two (losses.py:68-73)."""
    flat = x.reshape(x.shape[0], x.shape[1], -1)
    return torch.softmax(flat / temperature, dim=-1).reshape(x.shape)


def kl_divergence(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """torch F.kl_div(p.log(), q, reduction='batchmean') (losses.py:76-80):
    sum(q * (log q - log p)) / batch_size, with q*log(q) := 0 at q == 0."""
    p = p.reshape(p.shape[0], p.shape[1], -1)
    q = q.reshape(q.shape[0], q.shape[1], -1)
    q_safe = torch.where(q > 0, q, torch.ones_like(q))
    q_log_q = torch.where(q > 0, q * torch.log(q_safe), torch.zeros_like(q))
    return torch.sum(q_log_q - q * torch.log(p)) / p.shape[0]


def compute_forward_difference(series: torch.Tensor) -> torch.Tensor:
    """Forward temporal difference along axis 1 (losses.py:83-85)."""
    return series[:, 1:] - series[:, :-1]


def reconstruction_loss(prediction: torch.Tensor, target: torch.Tensor,
                        k1_alpha: float = 0.0
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted L1 + k1_alpha * KL of temperature-softmaxed temporal diffs
    (ReconstructionLoss, losses.py:32-48)."""
    pool_loss = weighted_l1_distance(prediction, target)
    pred_prob = softmax_temperature(compute_forward_difference(prediction), 0.1)
    true_prob = softmax_temperature(compute_forward_difference(target), 0.1)
    reg_loss = kl_divergence(pred_prob, true_prob)
    return pool_loss + k1_alpha * reg_loss, {"pool": pool_loss, "reg": reg_loss}


class ReconstructionLoss:
    """Callable wrapper with the reference class's interface; the mask
    argument is accepted and unused, as there."""

    def __init__(self, k1_alpha: float = 0.0):
        self.k1_alpha = k1_alpha

    def __call__(self, prediction, target, mask=None):
        return reconstruction_loss(prediction, target, self.k1_alpha)


def spatial_pool(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(k=5, s=4, p=2) over the trailing spatial dims of (B, T, H, W)."""
    return max_pool2d(x, 5, 4, padding=2)


def temporal_difference_matching_loss(pred_diff: torch.Tensor, true_diff: torch.Tensor,
                                      true: torch.Tensor, beta: float = 1.0,
                                      eps: float = 1e-6) -> torch.Tensor:
    """Weighted matching of pooled temporal gradients (losses.py:94-109)."""
    pred_pool = spatial_pool(pred_diff)
    true_pool = spatial_pool(true_diff)
    weight = 1.0 / (1.0 + beta * spatial_pool(true[:, :-1]) + eps)
    return torch.mean(((pred_pool - true_pool) ** 2) * weight)


def _shock_kernels(dtype, device):
    """The /8 Sobel x and y kernels and the Laplacian, OIHW (1, 1, 3, 3), in
    the orientation of cross-correlation (as the JAX HWIO kernels)."""
    kx = torch.tensor([[1, 0, -1], [2, 0, -2], [1, 0, -1]], dtype=torch.float32) / 8.0
    kl = torch.tensor([[0, 1, 0], [1, -4, 1], [0, 1, 0]], dtype=torch.float32)
    return tuple(k.reshape(1, 1, 3, 3).to(dtype=dtype, device=device)
                 for k in (kx, kx.t().contiguous(), kl))


def shock_map(x: torch.Tensor, beta: float = 30.0, eps: float = 1e-12) -> torch.Tensor:
    """Sobel-gradient x tanh(beta * Laplacian) structure map (losses.py:128-137),
    reflect-padded: (B, T, H, W) -> the same shape."""
    B, T, H, W = x.shape
    padded = reflect_pad2d(x.reshape(B * T, 1, H, W), 1)
    gx, gy, lap = (F.conv2d(padded, k) for k in _shock_kernels(x.dtype, x.device))
    grad = torch.sqrt(gx * gx + gy * gy + eps)
    return (torch.tanh(beta * lap) * grad).reshape(B, T, H, W)


def shock_map_loss(pred: torch.Tensor, true: torch.Tensor, beta: float = 30.0,
                   tau: float = 25.0, border_ignore: int = 0, pool: int = 2,
                   eps: float = 1e-12) -> torch.Tensor:
    """relu(|shock_true| - |shock_pred|) with optional max-pooling and border
    crop (losses.py:140-162). ``tau`` is a legacy no-op argument kept for the
    interface, as in the reference."""
    del tau
    if pool > 1:
        pred = max_pool2d(pred, pool, pool)
        true = max_pool2d(true, pool, pool)
    diff = F.relu(torch.abs(shock_map(true, beta, eps)) - torch.abs(shock_map(pred, beta, eps)))
    if border_ignore > 0:
        m = border_ignore
        diff = diff[..., m:-m, m:-m]
    return diff


def k1_loss(pred: torch.Tensor, true: torch.Tensor, temp_alpha: float,
            k1_alpha: float) -> torch.Tensor:
    """Weighted L1 + KL + shock-map combination (losses.py:165-189) on
    (B, T, H, W). Keeps the reference's quirk: the shock term is computed
    when ``temp_alpha == 0``, and then adds 0 * shock."""
    pool_loss = weighted_l1_distance(pred, true)
    reg_loss = torch.zeros((), dtype=pred.dtype, device=pred.device)
    shock_loss = torch.zeros((), dtype=pred.dtype, device=pred.device)
    if k1_alpha > 0:
        pred_prob = softmax_temperature(compute_forward_difference(pred), 0.1)
        true_prob = softmax_temperature(compute_forward_difference(true), 0.1)
        reg_loss = kl_divergence(pred_prob, true_prob)
    if temp_alpha == 0:
        shock_loss = shock_map_loss(pred, true, beta=0.02, border_ignore=2, pool=1).mean()
    return pool_loss + k1_alpha * reg_loss + temp_alpha * shock_loss


def _bce(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """torch BCELoss on probabilities, with its -100 log clamp."""
    log_x = torch.clamp(torch.log(x), min=-100.0)
    log_1mx = torch.clamp(torch.log(1.0 - x), min=-100.0)
    return torch.mean(-(y * log_x + (1.0 - y) * log_1mx))


def gan_loss(outputs: torch.Tensor, target_is_real: bool, *,
             loss_type: str = "nsgan", is_disc: bool = False,
             target_real_label: float = 1.0,
             target_fake_label: float = 0.0) -> torch.Tensor:
    """Multi-mode adversarial loss (AdversarialLoss, losses.py:192-253).

    hinge -- disc: mean(relu(1 -/+ out)); gen: mean(-out).
    nsgan -- BCE against the label (applied to the D outputs as they are).
    lsgan -- MSE against the label.
    """
    if loss_type == "hinge":
        if is_disc:
            if target_is_real:
                return torch.mean(F.relu(1.0 - outputs))
            return torch.mean(F.relu(1.0 + outputs))
        return torch.mean(-outputs)
    label = target_real_label if target_is_real else target_fake_label
    labels = torch.full_like(outputs, label)
    if loss_type == "nsgan":
        return _bce(outputs, labels)
    if loss_type == "lsgan":
        return torch.mean((outputs - labels) ** 2)
    raise ValueError(f"Unsupported GAN loss type: {loss_type}")
