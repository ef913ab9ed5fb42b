"""Convolution and resize primitives of the generator (NCHW).

Counterpart of the parts of ``p2igan_tpu/ops/convs.py`` the P2I generator
uses. The JAX package leaves these to XLA outside any Pallas kernel; here they
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
