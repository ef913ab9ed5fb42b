"""Plain P2I-GAN generator and critic (upstream ``p2igan_bench/models/p2igan.py``),
float32, NCHW, on a dict of tensors named by the upstream state-dict keys.

Generator, for (B, T, H, W, 1) masked frames and T = sample_length:

  frames as channels -> InputBlock (two per-pixel gates relu(h + h * (W h + b))
  over the T values, then the IDW of ``idw.py``) -> grouped 3x3 DO-Conv +
  the input repeated 4x per channel -> three 2x2 max pools, each doubling every
  channel in place -> decoding by EBlocks (4 residual pairs of 3x3 DO-Convs)
  and UPPos (bilinear x2 with aligned corners, a per-pixel gate
  x + x * (2 sigmoid(pos) - 1), a 1x1 convolution, relu), the x/4 level added
  once -> grouped 1x1 DO-Conv -> tanh.

A DO-Conv's kernel is ``einsum('ims,ois->oim', D + I, W')`` (the upstream
``DOConv2d``); a serving checkpoint holds that kernel, composed once, which
is the same product.

Critic: a 2-D branch over the frames as channels (3x3 convolutions 16-64,
64-128 /2, 128-256 /2, 256-256, 256-1) and a 3-D branch (3x3x3 1-32, 32-64,
64-128, each /2 in space, 128-128 /2 in time, 1x1x1 128-1) meaned over time
and resized bilinearly to the 2-D map, leaky relu 0.2 between layers; every
convolution spectrally normalised by one power-iteration step a training
forward (u, v held as state); the logits sigmoid(alpha2d) * 2-D + 3-D.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from . import idw
from .common import Spec

K_NEAREST, TAU = 4, 0.05
D2D = ((0, 1, 64, 1), (2, 64, 128, 2), (4, 128, 256, 2), (6, 256, 256, 1), (8, 256, 1, 1))
D3D = ((0, 1, 32, (1, 2, 2), 3), (2, 32, 64, (1, 2, 2), 3), (4, 64, 128, (1, 2, 2), 3),
       (6, 128, 128, (2, 1, 1), 3), (8, 128, 1, (1, 1, 1), 1))


def sizes(cfg: Dict) -> Dict[str, int]:
    data = cfg["data"]["train"]
    return {"T": int(data.get("sample_length") or 16), "H": int(data["h"]),
            "W": int(data["w"]), "base": int(cfg["model"].get("base_channels", 64))}


def _doconvs(T: int, base: int) -> List[Tuple[str, int, int, int, int]]:
    """(prefix, in, out, kernel, groups) of every DO-Conv."""
    out = [("Convsin.0.main.0", T, base, 3, 4)]
    for i, m in enumerate((1, 2, 4, 8)):
        c = base * m
        for j in range(4):
            for h in range(2):
                out.append((f"Decoder.{i}.layers.{j}.main.{h}.main.0", c, c, 3, 1))
    out.append(("ConvsOut.0.main.0", base, T, 1, 4))
    return out


def generator_spec(cfg: Dict) -> Spec:
    s = sizes(cfg)
    T, H, W, base = s["T"], s["H"], s["W"], s["base"]
    spec: Spec = []
    for layer in range(2):
        spec += [(f"input.layers.{layer}.conv.weight", (T, T, 1), "normal", math.sqrt(2.0 / T)),
                 (f"input.layers.{layer}.conv.bias", (T,), "normal", 0.01)]
    for prefix, cin, cout, k, g in _doconvs(T, base):
        spec.append((f"{prefix}.W", (cout, cin // g, k * k), "uniform",
                     1.0 / math.sqrt(cin // g * k * k)))
        if k > 1:
            spec.append((f"{prefix}.D", (cin, k * k, k * k), "normal", 0.05))
    for i, (cin, cout, h) in enumerate(((base * 2, base, H), (base * 4, base * 2, H // 2),
                                        (base * 8, base * 4, H // 4))):
        spec += [(f"UP.{i}.pos", (1, 1, h, W * h // H), "normal", 0.5),
                 (f"UP.{i}.proj.weight", (cout, cin, 1, 1), "normal", math.sqrt(2.0 / cin)),
                 (f"UP.{i}.proj.bias", (cout,), "normal", 0.01)]
    return spec


def critic_spec(cfg: Dict) -> Spec:
    T = sizes(cfg)["T"]
    spec: Spec = [("alpha2d", (), "normal", 0.1), ("alpha3d", (), "normal", 0.1)]
    gain = math.sqrt(2.0 / (1.0 + 0.2 ** 2))
    for branch, layers in (("d2d", D2D), ("d3d", D3D)):
        for row in layers:
            i, cin, cout = row[:3]
            cin = cin * T if (branch, i) == ("d2d", 0) else cin
            ks = (3, 3) if branch == "d2d" else (row[4],) * 3
            fan = cin * math.prod(ks)
            spec += [(f"{branch}.{i}.weight_orig", (cout, cin) + ks, "normal",
                      gain / math.sqrt(fan)),
                     (f"{branch}.{i}.bias", (cout,), "normal", 0.01),
                     (f"{branch}.{i}.weight_u", (cout,), "unit", 1.0),
                     (f"{branch}.{i}.weight_v", (fan,), "unit", 1.0)]
    return spec


def doconv_kernel(p: Dict[str, torch.Tensor], prefix: str, cin: int, cout: int, k: int,
                  groups: int) -> torch.Tensor:
    W = p[f"{prefix}.W"]
    if k == 1:
        return W.reshape(cout, cin // groups, 1, 1)
    eye = torch.eye(k * k, dtype=W.dtype, device=W.device).expand(cin, k * k, k * k)
    Wr = W.reshape(cout // groups, cin, k * k)
    return torch.einsum("ims,ois->oim", p[f"{prefix}.D"] + eye, Wr).reshape(cout, cin // groups, k, k)


def _pool_duplicate(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2).repeat_interleave(2, dim=1)


def generator(p: Dict[str, torch.Tensor], masked: torch.Tensor, selection,
              cfg: Dict) -> torch.Tensor:
    """masked (B, T, H, W, 1) -> predictions (B, T, H, W, 1); ``selection``
    from ``idw.select`` for the run's gauge mask."""
    s = sizes(cfg)
    T, base = s["T"], s["base"]
    kern = {prefix: (cin, cout, k, g) for prefix, cin, cout, k, g in _doconvs(T, base)}

    def conv(x, prefix):
        cin, cout, k, g = kern[prefix]
        return F.conv2d(x, doconv_kernel(p, prefix, cin, cout, k, g), padding=k // 2, groups=g)

    def eblock(i, x):
        for j in range(4):
            pre = f"Decoder.{i}.layers.{j}.main"
            x = conv(F.relu(conv(x, f"{pre}.0.main.0")), f"{pre}.1.main.0") + x
        return x

    def up(i, x):
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        x = x + x * (2.0 * torch.sigmoid(p[f"UP.{i}.pos"]) - 1.0)
        return F.relu(F.conv2d(x, p[f"UP.{i}.proj.weight"], p[f"UP.{i}.proj.bias"]))

    h = masked[..., 0].permute(0, 2, 3, 1)                           # (B, H, W, T)
    for layer in range(2):
        w = p[f"input.layers.{layer}.conv.weight"][:, :, 0]
        h = F.relu(h + h * (h @ w.t() + p[f"input.layers.{layer}.conv.bias"]))
    x = idw.apply(h.permute(0, 3, 1, 2), selection)                  # (B, T, H, W)
    x1 = conv(x, "Convsin.0.main.0") + x.repeat_interleave(4, dim=1)
    x2 = _pool_duplicate(x1)
    x4 = _pool_duplicate(x2)
    x8 = _pool_duplicate(x4)
    r = up(2, eblock(3, x8))
    r = up(1, eblock(2, x4 + r))
    r = up(0, eblock(1, r))
    out = torch.tanh(conv(eblock(0, r), "ConvsOut.0.main.0"))
    return out[..., None]


OUTPUT_CONV = "ConvsOut.0.main.0.W"


@torch.no_grad()
def balance_output_signs(p: Dict[str, torch.Tensor], masked: torch.Tensor, selection,
                         cfg: Dict, seed: int) -> Dict[str, torch.Tensor]:
    """``p`` with whole rows of the output DO-Conv negated, so that on
    ``masked`` (one window) half of the T output frames come out mostly at
    or below zero, the half drawn from ``seed``. The layer has no bias and
    tanh is odd, so a negated row negates its frame alone. Seeded weights
    otherwise decide how many frames serving clips to 0 (a third to five
    sixths of the values), and with it the work of the zstd write."""
    T = sizes(cfg)["T"]
    below = (generator(p, masked, selection, cfg)[..., 0] <= 0).float().mean(dim=(0, 2, 3))
    want = torch.zeros(T, dtype=torch.bool)
    want[torch.randperm(T, generator=torch.Generator().manual_seed(int(seed) % 2 ** 63))[:T // 2]] = True
    flip = ((below > 0.5).cpu() != want).to(p[OUTPUT_CONV].device)
    out = dict(p)
    out[OUTPUT_CONV] = torch.where(flip[:, None, None], -p[OUTPUT_CONV], p[OUTPUT_CONV])
    return out


def _sn(p, state, name: str, update: bool) -> torch.Tensor:
    w = p[f"{name}.weight_orig"]
    wm = w.reshape(w.shape[0], -1)
    u, v = state[f"{name}.weight_u"], state[f"{name}.weight_v"]
    if update:
        with torch.no_grad():
            v = F.normalize(wm.t() @ u, dim=0, eps=1e-12)
            u = F.normalize(wm @ v, dim=0, eps=1e-12)
        state[f"{name}.weight_u"], state[f"{name}.weight_v"] = u, v
    return w / (u @ (wm @ v))


def critic(p: Dict[str, torch.Tensor], state: Dict[str, torch.Tensor], x: torch.Tensor,
           update: bool) -> torch.Tensor:
    """x (B, T, H, W, 1) -> logits (B, N); ``state`` holds every layer's
    (u, v), advanced in place when ``update``."""
    y = x[..., 0]
    for n, (i, _, _, stride) in enumerate(D2D):
        y = F.conv2d(y, _sn(p, state, f"d2d.{i}", update), p[f"d2d.{i}.bias"],
                     stride=stride, padding=1)
        y = F.leaky_relu(y, 0.2) if n < len(D2D) - 1 else y
    z = x.permute(0, 4, 1, 2, 3)
    for n, (i, _, _, stride, k) in enumerate(D3D):
        z = F.conv3d(z, _sn(p, state, f"d3d.{i}", update), p[f"d3d.{i}.bias"],
                     stride=stride, padding=k // 2)
        z = F.leaky_relu(z, 0.2) if n < len(D3D) - 1 else z
    z = z.mean(dim=2)
    if z.shape[-2:] != y.shape[-2:]:
        z = F.interpolate(z, size=y.shape[-2:], mode="bilinear", align_corners=False)
    return (torch.sigmoid(p["alpha2d"]) * y + z).reshape(x.shape[0], -1)


def prepare(mask_hw, frames: int, device):
    """The mask-derived constant: the IDW selection (on the meta device,
    tensors of its shapes alone, for counting operations)."""
    if str(device) == "meta":
        n, G = frames * mask_hw.size, int((mask_hw > 0).sum())
        return (torch.zeros((n, K_NEAREST), dtype=torch.long, device=device),
                torch.zeros((n, K_NEAREST), device=device), torch.zeros((n,), device=device),
                torch.zeros((G,), dtype=torch.long, device=device))
    return idw.select(mask_hw, frames, K_NEAREST, TAU, device)
