"""Convolution, pooling, padding and resize primitives (NCHW / NCDHW).

Counterpart of ``p2igan_tpu/ops/convs.py``: the generators' convolutions and
resizes, and the pools and padding of the loss helpers and the metric suite.
The JAX package leaves these to XLA outside any Pallas kernel; here they go
to cuDNN / PyTorch's own kernels the same way. The JAX ops take channels-last
tensors; these take PyTorch's channels-first layouts.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
           padding: int = 0, groups: int = 1,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, Cin, H, W), weight OIHW (Cout, Cin/groups, kh, kw)."""
    return F.conv2d(x, weight, bias=bias, stride=stride, padding=padding,
                    groups=groups)


def conv1d(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
           padding: int = 0, groups: int = 1,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, Cin, L), weight (Cout, Cin/groups, k). The JAX package's
    ``conv1d`` takes x (B, L, Cin) and a (k, Cin/groups, Cout) kernel =
    ``weight.permute(2, 1, 0)``."""
    return F.conv1d(x, weight, bias=bias, stride=stride, padding=padding,
                    groups=groups)


def conv_transpose2d(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
                     padding: int = 0, bias: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """torch ``ConvTranspose2d`` on x (B, Cin, H, W) with its weight layout
    (Cin, Cout, kh, kw): output size (H - 1) * s - 2p + k. The JAX package's
    ``conv_transpose2d`` takes (kh, kw, Cout, Cin) =
    ``weight.permute(2, 3, 1, 0)``."""
    return F.conv_transpose2d(x, weight, bias=bias, stride=stride, padding=padding)


def max_pool2d(x: torch.Tensor, kernel_size, stride=None,
               padding=0) -> torch.Tensor:
    """Max over windows of the last two dims of (N, C, H, W) or (C, H, W);
    the padding never wins (it is -inf), the output size rounds down."""
    return F.max_pool2d(x, kernel_size, stride=stride if stride is not None else kernel_size,
                        padding=padding)


def avg_pool2d(x: torch.Tensor, kernel_size, stride=None, padding=0,
               count_include_pad: bool = True) -> torch.Tensor:
    """Window means over the last two dims of (N, C, H, W) or (C, H, W): with
    ``count_include_pad`` (the default) every window divides by k*k, padding
    counted as zeros; without it, by the window's cells inside the image."""
    return F.avg_pool2d(x, kernel_size, stride=stride if stride is not None else kernel_size,
                        padding=padding, count_include_pad=count_include_pad)


def reflect_pad2d(x: torch.Tensor, pad: int = 1) -> torch.Tensor:
    """Reflection padding of the last two dims of (N, C, H, W) or (C, H, W)
    (the JAX op pads H and W of a channels-last tensor)."""
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


@functools.lru_cache(maxsize=32)
def _resize_matrix(n_in: int, n_out: int, align_corners: bool,
                   device: str) -> torch.Tensor:
    """(n_out, n_in) float32: row i holds the weights of output i of a
    bilinear resize along one axis, as PyTorch computes them in float32:
    align_corners src = i * ((n_in - 1) / (n_out - 1)), else
    max(0, (n_in / n_out) * (i + 0.5) - 0.5); lambda = src - floor(src), 1 -
    lambda to the floor, lambda to the next (the floor itself at the edge)."""
    idx = torch.arange(n_out, dtype=torch.float32)
    if align_corners:
        scale = (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
        src = idx * torch.tensor(scale, dtype=torch.float32)
    else:
        src = torch.tensor(n_in / n_out, dtype=torch.float32) * (idx + 0.5) - 0.5
        src = torch.clamp(src, min=0.0)
    i0 = src.floor().long().clamp(max=n_in - 1)
    lam = src - i0.to(torch.float32)
    i1 = torch.clamp(i0 + 1, max=n_in - 1)
    a = torch.zeros((n_out, n_in), dtype=torch.float32)
    rows = torch.arange(n_out)
    a.index_put_((rows, i0), 1.0 - lam, accumulate=True)
    a.index_put_((rows, i1), lam, accumulate=True)
    return a.to(device)


class _BilinearResize(torch.autograd.Function):
    """Forward: ``F.interpolate``. Backward: the transposed resize as two
    matrix products, A_h^T g A_w, in a fixed order: PyTorch's own CUDA
    backward adds the contributions of every output with atomics in no fixed
    order (and has no deterministic version), so a gradient through it would
    not repeat bit for bit."""

    @staticmethod
    def forward(ctx, x, size, align_corners):
        ctx.args = (x.shape[-2:], tuple(size), align_corners)
        return F.interpolate(x, size=size, mode="bilinear", align_corners=align_corners)

    @staticmethod
    def backward(ctx, g):
        (H, W), (h, w), align_corners = ctx.args
        dev = str(g.device)
        a_h = _resize_matrix(H, h, align_corners, dev)
        a_w = _resize_matrix(W, w, align_corners, dev)
        return torch.matmul(torch.matmul(a_h.t(), g), a_w), None, None


def bilinear_resize(x: torch.Tensor, size, align_corners: bool) -> torch.Tensor:
    """``F.interpolate(x, size, mode='bilinear', align_corners)`` on (B, C, H,
    W); its gradient sums in a fixed order."""
    if x.requires_grad and torch.is_grad_enabled():
        return _BilinearResize.apply(x, tuple(size), align_corners)
    return F.interpolate(x, size=size, mode="bilinear", align_corners=align_corners)


def bilinear_upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """torch ``Upsample(scale_factor=2, mode='bilinear', align_corners=True)``
    on (B, C, H, W) (with align_corners the scale comes from the sizes alone,
    so this is the same resize to (2H, 2W)); its gradient sums in a fixed
    order."""
    return bilinear_resize(x, (2 * x.shape[-2], 2 * x.shape[-1]), True)


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
