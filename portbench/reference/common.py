"""Pieces the plain references share: seeded weights, the precision switch,
the losses and the optimizer.

Plain PyTorch on any device, float32. Nothing here imports the program:
parameter names are the upstream state-dict keys (``p2igan_bench``), which
the port keeps, so the benchmark loads the same tensors into both sides by
name.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

# (name, shape, kind, scale): kind is "normal" (std = scale), "uniform"
# (U(-scale, scale)) or "unit" (a gaussian vector of norm 1)
Spec = List[Tuple[str, Tuple[int, ...], str, float]]


def make_weights(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every tensor of ``spec`` from ``seed``, drawn on ``device`` in two
    calls (one normal, one uniform) and cut into leaves."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 2654435761 + 97) % (2 ** 63))
    n_norm = sum(math.prod(s) for _, s, kind, _ in spec if kind != "uniform")
    n_uni = sum(math.prod(s) for _, s, kind, _ in spec if kind == "uniform")
    normal = torch.randn(n_norm, generator=gen, device=device)
    uni = torch.rand(n_uni, generator=gen, device=device)
    out, i, j = {}, 0, 0
    for name, shape, kind, scale in spec:
        n = math.prod(shape)
        if kind == "uniform":
            t = (uni[j:j + n] * 2.0 - 1.0) * scale
            j += n
        else:
            t = normal[i:i + n]
            i += n
            t = t / torch.linalg.vector_norm(t) if kind == "unit" else t * scale
        out[name] = t.reshape(shape).clone()
    return out


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 with TF32 off (the configuration's precision), or the
    control's TF32, for cuBLAS and cuDNN alike."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# -- losses (upstream p2igan_bench/modules/losses.py) ---------------------------

def weighted_l1(pred: torch.Tensor, true: torch.Tensor) -> torch.Tensor:
    """NowcastNet weights a*exp(b*x)+c, held at their x=0.70 value above."""
    a, b, c, x_max = 0.50, 5.14, 0.12, 0.70
    w = torch.where(true > x_max, torch.full_like(true, a * math.exp(b * x_max) + c),
                    a * torch.exp(b * true) + c)
    return torch.mean(w * torch.abs(pred - true))


def temporal_kl(pred: torch.Tensor, true: torch.Tensor, temperature: float = 0.1):
    """KL(q || p) of the temperature softmaxes of the frame differences over
    each (sample, frame), summed and divided by the batch (``batchmean``)."""
    def prob(x):
        d = (x[:, 1:] - x[:, :-1]).reshape(x.shape[0], x.shape[1] - 1, -1)
        return torch.softmax(d / temperature, dim=-1)
    p, q = prob(pred), prob(true)
    return torch.sum(torch.special.xlogy(q, q) - q * torch.log(p)) / pred.shape[0]


def reconstruction_loss(pred, true, k1: float) -> torch.Tensor:
    return weighted_l1(pred, true) + k1 * temporal_kl(pred, true)


def hinge_d(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.mean(F.relu(1.0 - real)) + torch.mean(F.relu(1.0 + fake)))


def adam(params, opt_cfg) -> torch.optim.Adam:
    """The upstream optimizer: Adam at (beta1, beta2), no weight decay."""
    return torch.optim.Adam(params, lr=opt_cfg.get("lr", 1e-4),
                            betas=(opt_cfg.get("beta1", 0.0), opt_cfg.get("beta2", 0.99)),
                            eps=opt_cfg.get("eps", 1e-8))
