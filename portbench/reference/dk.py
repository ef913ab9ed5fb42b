"""Plain DeepKriging generator (upstream ``p2igan_bench/models/dk.py``), float32.

Every pixel p of every frame (b, t) gets the features [phi(p) | z(b, t)]:
phi the multi-resolution Wendland C2 basis of the pixel (levels of 10, 19,
37 and 73 knots subsampled from grids of spacing H/4, /8, /16, /32, support
4 x the spacing), z the values at the k visible gauges (the mask's first k
observed pixels in pixel order). A 100-100-100-1 relu MLP maps them to the
pixel's value.

One departure from the upstream code, which forms the (B*T*H*W, K+k)
feature rows: the first layer is applied to its two blocks apart,
``phi W_phi + (z W_z + b)``, which is the same sum and keeps the largest
tensor at (B*T, H*W, 100).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .common import Spec

LEVELS = (10, 19, 37, 73)
HIDDEN = 100


def sizes(cfg: Dict) -> Dict[str, int]:
    data = cfg["data"]["train"]
    return {"T": int(data.get("sample_length") or 16), "H": int(data["h"]),
            "W": int(data["w"]), "visible": 79}


def _wendland(d: np.ndarray) -> np.ndarray:
    dm = np.minimum(d, 1.0)
    return np.where(d <= 1.0, ((1.0 - dm) ** 6) * (35.0 * dm ** 2 + 18.0 * dm + 3.0) / 3.0,
                    0.0)


def basis(H: int, W: int, levels: Sequence[int] = LEVELS) -> np.ndarray:
    """(H*W, sum(levels)) float32 spatial Wendland features."""
    base = max(1, int(round(min(H, W) / 4)))
    knots, theta = [], []
    for i, m in enumerate(levels):
        sp = max(1, base // (2 ** i))
        yy, xx = np.meshgrid(np.arange(0, H, sp), np.arange(0, W, sp), indexing="ij")
        full = np.stack([yy, xx], axis=-1).reshape(-1, 2)
        if m < full.shape[0]:
            pick = np.clip(np.round(np.linspace(0, full.shape[0] - 1, num=m)).astype(np.int64),
                           0, full.shape[0] - 1)
            full = full[pick]
        knots.append(full)
        theta.append(np.full((full.shape[0],), 4.0 * sp))
    knots = np.concatenate(knots).astype(np.float64)
    theta = np.concatenate(theta)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    grid = np.stack([ys, xs], axis=-1).reshape(-1, 2).astype(np.float64)
    d = np.sqrt(((grid[:, None, :] - knots[None, :, :]) ** 2).sum(-1))
    return _wendland(d / theta[None, :]).astype(np.float32)


def generator_spec(cfg: Dict) -> Spec:
    s = sizes(cfg)
    dims = (sum(LEVELS) + s["visible"], HIDDEN, HIDDEN, HIDDEN, 1)
    spec: Spec = []
    for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
        spec += [(f"_mlp.net.{2 * i}.weight", (cout, cin), "normal", math.sqrt(2.0 / cin)),
                 (f"_mlp.net.{2 * i}.bias", (cout,), "normal", 0.01)]
    return spec


def critic_spec(cfg: Dict) -> Spec:
    return []


def prepare(mask_hw: np.ndarray, frames: int, device) -> Dict[str, torch.Tensor]:
    """The mask-derived constants: the visible gauges and the basis."""
    H, W = mask_hw.shape
    if str(device) == "meta":
        return {"gauges": torch.zeros((int((mask_hw > 0).sum()),), dtype=torch.long,
                                      device=device),
                "phi": torch.zeros((H * W, sum(LEVELS)), device=device)}
    return {"gauges": torch.from_numpy(np.flatnonzero(mask_hw.reshape(-1) > 0)).to(device),
            "phi": torch.from_numpy(basis(H, W)).to(device)}


def generator(p: Dict[str, torch.Tensor], masked: torch.Tensor, prep, cfg: Dict) -> torch.Tensor:
    B, T, H, W, _ = masked.shape
    k = sizes(cfg)["visible"]
    z = masked[..., 0].reshape(B * T, H * W)[:, prep["gauges"][:k]]      # (BT, k)
    w1 = p["_mlp.net.0.weight"]
    n_phi = prep["phi"].shape[1]
    h = F.relu((prep["phi"] @ w1[:, :n_phi].t())[None]
               + (z @ w1[:, n_phi:].t() + p["_mlp.net.0.bias"])[:, None, :])
    h = F.relu(h @ p["_mlp.net.2.weight"].t() + p["_mlp.net.2.bias"])
    h = F.relu(h @ p["_mlp.net.4.weight"].t() + p["_mlp.net.4.bias"])
    y = h @ p["_mlp.net.6.weight"].t() + p["_mlp.net.6.bias"]            # (BT, HW, 1)
    return y.reshape(B, T, H, W, 1)
