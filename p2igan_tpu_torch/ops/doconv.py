"""Depthwise-over-parameterized convolution (DO-Conv).

Counterpart of ``p2igan_tpu/ops/doconv.py`` with the reference's parameter
layout (``p2igan_bench/modules/deconv_pytorch.py``): the factored (training)
variant holds ``W (out, in/g, D_mul)`` and, for kernels larger than 1x1,
``D (in, M*N, D_mul)`` plus the constant identity offset ``D_diag``; the
effective kernel is

    DoW = reshape(einsum('ims,ois->oim', D + D_diag, W'), (out, in/g, M, N))

with ``W' = reshape(W, (out/g, in, D_mul))``. The folded (serving) variant
holds the plain ``W (out, in/g, M, N)`` kernel, as the reference's
``DOConv2d_eval`` does. :class:`SimAM` is the reference module's
parameter-free attention (the JAX package's ``SimAM``).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from .convs import conv2d


def make_d_diag(in_channels: int, M: int, N: int, D_mul: int) -> np.ndarray:
    """Constant identity offset for D (deconv_pytorch.py:65-71): reps =
    D_mul // (M*N), zero-padded to width D_mul."""
    eye = np.eye(M * N, dtype=np.float32).reshape(1, M * N, M * N)
    reps = D_mul // (M * N)
    d_diag = np.tile(eye, (in_channels, 1, reps))
    if D_mul % (M * N) != 0:
        zeros = np.zeros((in_channels, M * N, D_mul % (M * N)), np.float32)
        d_diag = np.concatenate([d_diag, zeros], axis=2)
    return d_diag


def fold_doconv(W: torch.Tensor, D: torch.Tensor,
                D_diag: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Compose factored (W, D) into the plain OIHW kernel.

    W: (out, in/g, D_mul); D: (in, M*N, D_mul). Returns (out, in/g, M, N),
    M = N = sqrt(M*N) (square kernels only, as in the reference)."""
    out_ch, in_per_g, D_mul = W.shape
    in_ch, MN, _ = D.shape
    groups = in_ch // in_per_g
    M = N = int(round(MN ** 0.5))
    if D_diag is None:
        D_diag = torch.from_numpy(make_d_diag(in_ch, M, N, D_mul)).to(D)
    Wr = W.reshape(out_ch // groups, in_ch, D_mul)
    dow = torch.einsum("ims,ois->oim", D + D_diag, Wr)
    return dow.reshape(out_ch, in_per_g, M, N)


class SimAM(nn.Module):
    """Parameter-free SimAM attention (reference deconv_pytorch.py:211-223; JAX
    ``SimAM``): x * sigmoid(energy), the energy from each channel's spatial
    variance. x: (B, C, H, W)."""

    def __init__(self, e_lambda: float = 1e-4):
        super().__init__()
        self.e_lambda = e_lambda

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[-2] * x.shape[-1] - 1
        sq = (x - x.mean(dim=(-2, -1), keepdim=True)) ** 2
        y = sq / (4 * (sq.sum(dim=(-2, -1), keepdim=True) / n + self.e_lambda)) + 0.5
        return x * torch.sigmoid(y)


class DOConv2d(nn.Module):
    """DO-Conv layer, x (B, Cin, H, W) -> (B, Cout, H', W').

    ``factored=True`` holds (W, D) and composes the kernel every forward;
    ``factored=False`` is the folded serving variant (:meth:`folded`).
    ``D_diag`` is a constant and not part of the state; a state that carries
    it (reference checkpoints do) loads too, provided it equals the constant.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, groups: int = 1,
                 factored: bool = True, device=None):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.groups = groups
        self.factored = factored
        M = N = kernel_size
        in_g = in_channels // groups
        if factored:
            self.W = nn.Parameter(torch.empty(out_channels, in_g, M * N,
                                              device=device))
            if M * N > 1:
                self.D = nn.Parameter(torch.zeros(in_channels, M * N, M * N,
                                                  device=device))
                self.register_buffer(
                    "D_diag",
                    torch.from_numpy(make_d_diag(in_channels, M, N, M * N)).to(device),
                    persistent=False)
        else:
            self.W = nn.Parameter(torch.empty(out_channels, in_g, M, N,
                                              device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """torch kaiming_uniform_(a=sqrt(5)) on W: U(-1/sqrt(fan_in), ...),
        fan_in = in/g * M*N; D starts at zero (reference init)."""
        fan_in = (self.in_channels // self.groups) * self.kernel_size ** 2
        bound = 1.0 / math.sqrt(fan_in)
        w = torch.empty(self.W.shape).uniform_(-bound, bound, generator=generator)
        self.W.copy_(w)
        if hasattr(self, "D"):
            self.D.zero_()

    def kernel(self) -> torch.Tensor:
        """The effective OIHW kernel."""
        if not self.factored:
            return self.W
        if hasattr(self, "D"):
            return fold_doconv(self.W, self.D, self.D_diag)
        return self.W.reshape(self.out_channels, self.in_channels // self.groups,
                              1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The kernel (composed in float32) is cast to the input's dtype."""
        return conv2d(x, self.kernel().to(x.dtype), stride=self.stride,
                      padding=self.padding, groups=self.groups)

    @torch.no_grad()
    def folded(self) -> "DOConv2d":
        """The serving variant holding this layer's composed kernel."""
        out = DOConv2d(self.in_channels, self.out_channels, self.kernel_size,
                       stride=self.stride, padding=self.padding,
                       groups=self.groups, factored=False, device=self.W.device)
        out.W.copy_(self.kernel())
        return out

    def _load_from_state_dict(self, state_dict, prefix, local_metadata, strict,
                              missing_keys, unexpected_keys, error_msgs):
        key = prefix + "D_diag"
        if key in state_dict:
            given = state_dict.pop(key)
            want = getattr(self, "D_diag", None)
            if want is None or given.shape != want.shape or not torch.equal(
                    given.to(want), want):
                error_msgs.append(f"{key}: differs from the constant identity "
                                  f"offset this layer composes with")
        super()._load_from_state_dict(state_dict, prefix, local_metadata, strict,
                                      missing_keys, unexpected_keys, error_msgs)
