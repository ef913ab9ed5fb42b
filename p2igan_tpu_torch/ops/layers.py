"""Layers of the P2I generator (NCHW, PyTorch).

Counterpart of the parts of ``p2igan_tpu/ops/layers.py`` the generator uses.
Module attribute names follow the reference's torch modules, so reference
state_dict keys (``main.0.W``, ``layers.{i}.conv``, ``pos``, ``proj``) load as
they are. Channel order is the reference's (C = t*c, grouped convs,
consecutive channel duplication).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .convs import bilinear_upsample2x_align_corners
from .doconv import DOConv2d
from .pool_dup import maxpool2_duplicate


@torch.no_grad()
def kaiming_normal_fan_in_(w: torch.Tensor,
                           generator: Optional[torch.Generator] = None) -> None:
    """torch kaiming_normal_(a=0, mode='fan_in') (reference init_weights)."""
    fan_in = w[0].numel()
    w.copy_(torch.empty(w.shape).normal_(0.0, math.sqrt(2.0 / fan_in),
                                         generator=generator))


class BasicConvDO(nn.Module):
    """DO-Conv -> (optional ReLU); reference BasicConv_do (layer.py:68-94)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, relu: bool = True, groups: int = 1,
                 factored: bool = True, device=None):
        super().__init__()
        layers = [DOConv2d(in_channels, out_channels, kernel_size, stride=stride,
                           padding=kernel_size // 2, groups=groups,
                           factored=factored, device=device)]
        if relu:
            layers.append(nn.ReLU())
        self.main = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.main(x)


class ResBlockDO(nn.Module):
    """Two 3x3 DO-convs with a residual (reference ResBlock_do)."""

    def __init__(self, channels: int, factored: bool = True, device=None):
        super().__init__()
        self.main = nn.Sequential(
            BasicConvDO(channels, channels, 3, relu=True, factored=factored,
                        device=device),
            BasicConvDO(channels, channels, 3, relu=False, factored=factored,
                        device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.main(x) + x


def downsample_duplicate_channels(x: torch.Tensor, length: int) -> torch.Tensor:
    """Maxpool-2 + consecutive channel duplication keeping the T grouping
    (reference DownsampleDuplicateChannels). x: (B, C, H, W), C % length == 0.
    Runs through the fused kernel wrapper (plain version on CPU tensors)."""
    if x.shape[1] % length != 0:
        raise ValueError(f"channels {x.shape[1]} must be divisible by {length}")
    return maxpool2_duplicate(x)


class AttentionBlock(nn.Module):
    """Per-position Conv1d(c, c, k=1) gating: relu(x + x * conv(x)), on the
    last axis of x (reference layer.py:296-304)."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.conv = nn.Conv1d(channels, channels, 1, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        kaiming_normal_fan_in_(self.conv.weight, generator)
        self.conv.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = F.linear(x, self.conv.weight[:, :, 0], self.conv.bias)
        return F.relu(x + x * gate)


class InputBlock(nn.Module):
    """Temporal attention + IDW k-NN densification (reference layer.py:307-361)
    on the factored path: masks that are constant across frames (sti, stis).

    Gauge values are gathered first, so the attention runs on (B, G, D)
    instead of every pixel. With ``shared_batch_mask`` every sample shares one
    spatial mask (stis gauge files, sliding windows of one event): the gauge
    selection is computed once per batch, or hoisted by the caller
    (``prepared``). Without it (sti: a mask per sample) every sample selects
    from its own gauges, every forward. x/mask: (B, D, H, W) with D = C*T;
    returns the densified (B, D, H, W) field."""

    def __init__(self, channels: int, depth: int = 2, k: int = 4,
                 rho: float = 2.0, tau: float = 0.05, max_points: int = 2048,
                 factored: bool = True, shared_batch_mask: bool = True,
                 frames: Optional[int] = None, device=None):
        super().__init__()
        if not factored:
            raise NotImplementedError(
                "InputBlock: the generic IDW for masks that vary per frame "
                "(stin, fi, nowcasting: extract_points + idw_3d_knn) is not "
                "ported; only the factored IDW of frame-constant masks is "
                "(sti per sample, stis shared)")
        self.k, self.rho, self.tau = k, rho, tau
        self.max_points = max_points
        self.shared_batch_mask = shared_batch_mask
        self.frames = frames
        self.layers = nn.ModuleList(AttentionBlock(channels, device=device)
                                    for _ in range(depth))

    @staticmethod
    def gauge_budget(max_points: int, depth: int) -> int:
        """Static per-pixel gauge slot budget for the factored path."""
        return max(-(-max_points // max(depth, 1) // 128) * 128, 128)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                prepared=None) -> torch.Tensor:
        from .idw import (factored_apply_gauges, factored_apply_gauges_batch,
                          factored_prepare_full)

        B, D, H, W = x.shape
        if prepared is not None and not self.shared_batch_mask:
            # only the shared-mask path can consume a hoisted gauge selection;
            # dropping it silently would hide a table built for another mask
            raise ValueError(
                "InputBlock got `prepared` but shared_batch_mask is not set: "
                "a per-sample mask computes its own gauge selection")
        max_gauges = self.gauge_budget(self.max_points, self.frames or D)
        x_pix = x.reshape(B, D, H * W)
        if self.shared_batch_mask:
            if prepared is None:
                prepared = factored_prepare_full(mask[0, 0], max_gauges, k=self.k)
            gd2, gsel, gauge_pix = prepared
            gvals = x_pix[:, :, gauge_pix]                           # (B, D, G)
        else:
            gd2, gsel, gauge_pix = factored_prepare_full(mask[:, 0], max_gauges,
                                                         k=self.k)
            gvals = torch.gather(x_pix, 2,
                                 gauge_pix[:, None, :].expand(B, D, max_gauges))
        h = gvals.transpose(1, 2)                                    # (B, G, D)
        for layer in self.layers:
            h = layer(h)
        vals_g = h.transpose(1, 2).to(torch.float32)                 # (B, D, G)
        apply = (factored_apply_gauges_batch if self.shared_batch_mask
                 else factored_apply_gauges)
        return apply(gd2, gsel, vals_g, (H, W), k=self.k, rho=self.rho,
                     tau=self.tau)


class UPPos(nn.Module):
    """Bilinear x2 upsample + learnable per-pixel gate + 1x1 proj
    (reference UPPos, layer.py:384-399): x = up(x); x += x*(2*sigmoid(pos)-1);
    relu(proj(x)). ``pos`` (1, 1, H, W) has the post-upsample size."""

    def __init__(self, in_ch: int, out_ch: int, H: int, W: int, device=None):
        super().__init__()
        self.pos = nn.Parameter(torch.zeros(1, 1, H, W, device=device))
        self.proj = nn.Conv2d(in_ch, out_ch, 1, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.pos.zero_()
        kaiming_normal_fan_in_(self.proj.weight, generator)
        self.proj.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = bilinear_upsample2x_align_corners(x)
        gate = 2.0 * torch.sigmoid(self.pos) - 1.0
        return F.relu(self.proj(x + x * gate))
