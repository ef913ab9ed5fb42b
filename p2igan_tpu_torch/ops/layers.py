"""Layers of the P2I generator and the rest of the layer library (NCHW,
PyTorch).

Counterpart of ``p2igan_tpu/ops/layers.py``: the layers the generator uses,
and those no shipped model uses, which the JAX package keeps for capability
parity (``BasicConv``, ``ResBlockDOFFT``, ``LayerNorm2d``, ``STABEDBlock``,
``FFTBenchComplexConv``). Module attribute names follow the reference's torch
modules, so reference state_dict keys (``main.0.W``, ``layers.{i}.conv``,
``pos``, ``proj``) load as they are; ``models/convert.py``
(``layer_state_dict_from_jax``) maps each layer's flax parameters. Channel
order is the reference's (C = t*c, grouped convs, consecutive channel
duplication).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .convs import bilinear_upsample2x_align_corners, conv2d, conv_transpose2d
from .doconv import DOConv2d
from .pool_dup import maxpool2_duplicate


@torch.no_grad()
def kaiming_normal_fan_in_(w: torch.Tensor,
                           generator: Optional[torch.Generator] = None) -> None:
    """torch kaiming_normal_(a=0, mode='fan_in') (reference init_weights)."""
    fan_in = w[0].numel()
    w.copy_(torch.empty(w.shape).normal_(0.0, math.sqrt(2.0 / fan_in),
                                         generator=generator))


class BasicConv(nn.Module):
    """Plain conv -> (BatchNorm) -> (ReLU), or a transposed conv (reference
    BasicConv, layer.py:43-65; JAX ``BasicConv``). ``main.0`` is the conv
    (``bias`` only without ``norm``; padding k // 2, transposed k // 2 - 1),
    ``main.1`` the BatchNorm with flax's running-statistics update
    (``models/simple.py`` ``BatchNorm``): ``forward(x, train=True)``
    normalises with the batch's statistics and advances the running ones."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, bias: bool = False, norm: bool = False,
                 relu: bool = True, transpose: bool = False, groups: int = 1,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        from ..models.simple import BatchNorm  # the models import this module

        bias = bias and not norm
        if transpose and groups != 1:
            raise NotImplementedError(
                "BasicConv(transpose=True) does not support groups != 1")
        self.stride, self.transpose, self.relu = stride, transpose, relu
        self.padding = kernel_size // 2 - 1 if transpose else kernel_size // 2
        if transpose:
            conv = nn.ConvTranspose2d(in_channels, out_channels, kernel_size, stride=stride,
                                      padding=self.padding, bias=bias, device=device)
        else:
            conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                             padding=self.padding, bias=bias, groups=groups,
                             device=device)
        layers = [conv]
        if norm:
            layers.append(BatchNorm(out_channels, momentum=0.1, eps=1e-5, device=device))
        self.main = nn.Sequential(*layers)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        conv = self.main[0]
        if self.transpose:  # fan_in of the JAX (k, k, out, in) kernel: k k out
            w = conv.weight
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            w.copy_(torch.empty(w.shape).normal_(0.0, math.sqrt(2.0 / fan_in),
                                                 generator=generator))
        else:
            kaiming_normal_fan_in_(conv.weight, generator)
        if conv.bias is not None:
            conv.bias.zero_()

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        conv = self.main[0]
        if self.transpose:
            x = conv_transpose2d(x, conv.weight, stride=self.stride, padding=self.padding,
                                 bias=conv.bias)
        else:
            x = conv2d(x, conv.weight, stride=self.stride, padding=self.padding,
                       groups=conv.groups, bias=conv.bias)
        if len(self.main) > 1:
            x = self.main[1](x, train)
        return F.relu(x) if self.relu else x


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


class ResBlockDOFFT(nn.Module):
    """Residual block with an rFFT2 spectral branch (reference
    ResBlock_do_fft_bench, layer.py:150-172; JAX ``ResBlockDOFFT``; no shipped
    model uses it): x + conv2(conv1(x)) + irfft2(fft2(fft1([Re | Im]
    rfft2(x)))), the transforms in float32 and the branch returned in x's
    dtype. ``main`` holds the two 3x3 DO-convs (``conv1``, ``conv2``),
    ``main_fft`` the two grouped 1x1 ones (``fft1``, ``fft2``)."""

    def __init__(self, channels: int, factored: bool = True, fft_groups: int = 16,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.main = nn.Sequential(
            BasicConvDO(channels, channels, 3, relu=True, factored=factored, device=device),
            BasicConvDO(channels, channels, 3, relu=False, factored=factored,
                        device=device))
        c2 = 2 * channels
        self.main_fft = nn.Sequential(
            BasicConvDO(c2, c2, 1, relu=True, groups=fft_groups, factored=factored,
                        device=device),
            BasicConvDO(c2, c2, 1, relu=False, groups=fft_groups, factored=factored,
                        device=device))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for m in self.modules():
            if isinstance(m, DOConv2d):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[-2:]
        y = torch.fft.rfft2(x.to(torch.float32), dim=(-2, -1), norm="backward")
        y_f = self.main_fft(torch.cat([y.real, y.imag], dim=1))
        y_re, y_im = torch.chunk(y_f, 2, dim=1)
        y = torch.fft.irfft2(torch.complex(y_re, y_im), s=(H, W), dim=(-2, -1),
                             norm="backward").to(x.dtype)
        return self.main(x) + x + y


def downsample_duplicate_channels(x: torch.Tensor, length: int) -> torch.Tensor:
    """Maxpool-2 + consecutive channel duplication keeping the T grouping
    (reference DownsampleDuplicateChannels). x: (B, C, H, W), C % length == 0.
    Runs through the fused kernel wrapper (plain version on CPU tensors)."""
    if x.shape[1] % length != 0:
        raise ValueError(f"channels {x.shape[1]} must be divisible by {length}")
    return maxpool2_duplicate(x)


class LayerNorm2d(nn.Module):
    """GroupNorm(1, C) over (C, H, W) per sample, affine per channel
    (reference layer.py:217-223; JAX ``LayerNorm2d``)."""

    def __init__(self, channels: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, 1, self.weight, self.bias, self.eps)


class STABEDBlock(nn.Module):
    """norm -> relu -> 3x3 conv plus norm -> 3x3 conv (reference
    layer.py:226-240; JAX ``STABEDBlock``)."""

    def __init__(self, cin: int, cout: int, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.norm1 = LayerNorm2d(cin, device=device)
        self.conv_double = nn.Conv2d(cin, cout, 3, padding=1, device=device)
        self.norm2 = LayerNorm2d(cin, device=device)
        self.conv_single = nn.Conv2d(cin, cout, 3, padding=1, device=device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for conv in (self.conv_double, self.conv_single):
            kaiming_normal_fan_in_(conv.weight, generator)
            conv.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.conv_double(F.relu(self.norm1(x)))
        return a + self.conv_single(self.norm2(x))


class FFTBenchComplexConv(nn.Module):
    """Spectral-domain MLP (reference fft_bench_complex_conv, layer.py:364-381;
    JAX ``FFTBenchComplexConv``; no shipped model uses it): irfft2 of two 1x1
    convs with a ReLU between, over [Re | Im] of rfft2(x), in float32,
    returned in x's dtype. ``dim`` is x's channel count, the hidden width
    ``int(dim * dw)``."""

    def __init__(self, dim: int, dw: float = 1.0, bias: bool = False,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        hid = int(dim * dw)
        self.conv1 = nn.Conv2d(2 * dim, 2 * hid, 1, bias=bias, device=device)
        self.conv2 = nn.Conv2d(2 * hid, 2 * dim, 1, bias=bias, device=device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for conv in (self.conv1, self.conv2):
            kaiming_normal_fan_in_(conv.weight, generator)
            if conv.bias is not None:
                conv.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[-2:]
        y = torch.fft.rfft2(x.to(torch.float32), dim=(-2, -1), norm="backward")
        y = self.conv2(F.relu(self.conv1(torch.cat([y.real, y.imag], dim=1))))
        y_re, y_im = torch.chunk(y, 2, dim=1)
        return torch.fft.irfft2(torch.complex(y_re, y_im), s=(H, W), dim=(-2, -1),
                                norm="backward").to(x.dtype)


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
        gate = F.linear(x, self.conv.weight[:, :, 0].to(x.dtype),
                        self.conv.bias.to(x.dtype))
        return F.relu(x + x * gate)


class InputBlock(nn.Module):
    """Temporal attention + IDW k-NN densification (reference layer.py:307-361).
    x/mask: (B, D, H, W) with D = C*T; returns the densified (B, D, H, W) field.

    ``factored`` (masks constant across frames: sti, stis): gauge values are
    gathered first, so the attention runs on (B, G, D) instead of every pixel.
    With ``shared_batch_mask`` every sample shares one spatial mask (stis gauge
    files, sliding windows of one event): the gauge selection is computed once
    per batch, or hoisted by the caller (``prepared``). Without it (sti: a mask
    per sample) every sample selects from its own gauges, every forward.

    Otherwise (masks that vary per frame: stin, fi, nowcasting) the attention
    runs on every pixel's D-vector, the observed voxels of the full mask are
    gathered into ``max_points`` slots and densified by the generic IDW."""

    def __init__(self, channels: int, depth: int = 2, k: int = 4,
                 rho: float = 2.0, tau: float = 0.05, max_points: int = 2048,
                 factored: bool = False, shared_batch_mask: bool = False,
                 frames: Optional[int] = None, device=None):
        super().__init__()
        self.k, self.rho, self.tau = k, rho, tau
        self.max_points = max_points
        self.factored = factored
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
        from .idw import (extract_points, factored_apply_gauges,
                          factored_apply_gauges_batch, factored_prepare_full,
                          idw_3d_knn)

        B, D, H, W = x.shape
        if prepared is not None and not (self.factored and self.shared_batch_mask):
            # only the shared-mask path can consume a hoisted gauge selection;
            # dropping it silently would hide a table built for another mask
            raise ValueError(
                "InputBlock got `prepared` but factored+shared_batch_mask is "
                f"not set (factored={self.factored}, shared_batch_mask="
                f"{self.shared_batch_mask}): a mask of its own computes its "
                "own selection")
        if not self.factored:
            h = x.permute(0, 2, 3, 1)                                # (B, H, W, D)
            for layer in self.layers:
                h = layer(h)
            vals = h.permute(0, 3, 1, 2).to(torch.float32)
            points, values, valid = extract_points(mask, vals, self.max_points)
            return idw_3d_knn(points, values, valid, (D, H, W), k=self.k,
                              rho=self.rho, tau=self.tau)
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
    relu(proj(x)). ``pos`` (1, 1, H, W) has the post-upsample size. On a
    narrower input (the generator's bf16 ``compute_dtype``) the gate and the
    projection's kernel are cast to its dtype and the bias is added after the
    projection, as the JAX ``UPPos`` does."""

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
        gate = 2.0 * torch.sigmoid(self.pos.to(x.dtype)) - 1.0
        x = x + x * gate
        if x.dtype == self.proj.weight.dtype:
            return F.relu(self.proj(x))
        y = F.conv2d(x, self.proj.weight.to(x.dtype))
        return F.relu(y + self.proj.bias.to(x.dtype)[:, None, None])
