"""Losses of the GAN training step (PyTorch).

Counterpart of the parts of ``p2igan_tpu/losses.py`` the train step uses
(reference ``p2igan_bench/modules/losses.py``): the NowcastNet-weighted L1,
the temperature-softmax KL of temporal differences, and the adversarial
losses (hinge / nsgan / lsgan). Losses are elementwise reductions and take any
layout; the training batch is (B, T, H, W, C).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F


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
