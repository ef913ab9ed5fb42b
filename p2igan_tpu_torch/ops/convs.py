"""Convolution and resize primitives of the generators (NCHW / NCDHW).

Counterpart of the parts of ``p2igan_tpu/ops/convs.py`` the generators
use. The JAX package leaves these to XLA outside any Pallas kernel; here they
go to cuDNN / PyTorch's own kernels the same way.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
           padding: int = 0, groups: int = 1,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, Cin, H, W), weight OIHW (Cout, Cin/groups, kh, kw)."""
    return F.conv2d(x, weight, bias=bias, stride=stride, padding=padding,
                    groups=groups)


def bilinear_upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """torch ``Upsample(scale_factor=2, mode='bilinear', align_corners=True)``
    on (B, C, H, W)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


def conv3d(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
           padding: int = 0, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, Cin, T, H, W), weight OIDHW (Cout, Cin, kt, kh, kw): PyTorch's own
    layouts, as the reference state dicts store them. The JAX package's
    ``conv3d`` takes x (B, T, H, W, Cin) and a DHWIO kernel
    (kt, kh, kw, Cin, Cout) = ``weight.permute(2, 3, 4, 1, 0)``."""
    return F.conv3d(x, weight, bias=bias, stride=stride, padding=padding)


def conv_transpose3d(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
                     padding: int = 0, bias: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """torch ``ConvTranspose3d`` on x (B, Cin, T, H, W) with its weight layout
    (Cin, Cout, kt, kh, kw). The JAX package's ``conv_transpose3d`` takes the
    kernel of the forward conv whose gradient this is, (kt, kh, kw, Cout, Cin)
    = ``weight.permute(2, 3, 4, 1, 0)`` (mind: out before in)."""
    return F.conv_transpose3d(x, weight, bias=bias, stride=stride, padding=padding)
