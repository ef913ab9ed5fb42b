"""Spectral-normalized convolutions with explicit power-iteration state.

Counterpart of ``p2igan_tpu/ops/spectral_norm.py``. The reference
discriminator wraps its convs in ``nn.utils.spectral_norm``; :class:`SNConv`
keeps that module's state under its state_dict keys -- ``weight_orig`` (the
parameter), ``weight_u`` and ``weight_v`` (buffers) -- but runs the power
iteration only when asked (``update_stats``), as the JAX package does:

    v = normalize(W_mat^T u);  u' = normalize(W_mat v);  sigma = u'^T W_mat v
    W_sn = W / sigma

with ``W_mat = weight_orig.reshape(out, -1)`` and eps=1e-12. The iteration
runs detached; sigma keeps its gradient through ``W``. With ``update_stats``
false (eval) the stored ``u`` and ``v`` are used as they are.

On an input of a narrower dtype (the P2I critic's bfloat16 3-D branch) the
iteration and sigma stay float32, the normalised kernel is cast to the
input's dtype and the bias is added after the convolution in the output's
dtype, as the JAX ``SNConv`` does; parameters and buffers stay float32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _l2norm(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + eps)


def _tuple(v, n: int) -> Tuple[int, ...]:
    if isinstance(v, (tuple, list)):
        if len(v) != n:
            raise ValueError(f"expected {n} values, got {tuple(v)}")
        return tuple(int(x) for x in v)
    return (int(v),) * n


class SNConv(nn.Module):
    """Spectral-norm Conv2d (``kernel_size`` of 2 ints) or Conv3d (3 ints),
    NC(T)HW layout. ``reset_parameters`` is the reference init:
    kaiming_normal_(a=0.2, leaky_relu) on the weight, zero bias, independent
    normalized gaussian ``u`` and ``v``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Sequence[int] = (3, 3),
                 stride: Sequence[int] | int = 1, padding: Sequence[int] | int = 1,
                 bias: bool = True, device=None):
        super().__init__()
        ks = tuple(int(k) for k in kernel_size)
        self.ndim = len(ks)
        if self.ndim not in (2, 3):
            raise ValueError(f"SNConv: 2-D or 3-D kernels only, got {ks}")
        self.stride = _tuple(stride, self.ndim)
        self.padding = _tuple(padding, self.ndim)
        self.weight_orig = nn.Parameter(
            torch.empty((out_channels, in_channels) + ks, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_channels, device=device))
                     if bias else None)
        k_flat = in_channels * math.prod(ks)
        self.register_buffer("weight_u", torch.empty(out_channels, device=device))
        self.register_buffer("weight_v", torch.empty(k_flat, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        w = self.weight_orig
        fan_in = w[0].numel()
        std = math.sqrt(2.0 / (1.0 + 0.2 * 0.2)) / math.sqrt(fan_in)
        w.copy_(torch.empty(w.shape).normal_(0.0, std, generator=generator))
        if self.bias is not None:
            self.bias.zero_()
        for buf in (self.weight_u, self.weight_v):
            buf.copy_(_l2norm(torch.empty(buf.shape).normal_(generator=generator)))

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        w_mat = self.weight_orig.reshape(self.weight_orig.shape[0], -1)
        if update_stats:
            with torch.no_grad():
                v = _l2norm(w_mat.t() @ self.weight_u)
                u = _l2norm(w_mat @ v)
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        else:  # copies: a later training forward updates the buffers in place
            u, v = self.weight_u.clone(), self.weight_v.clone()
        sigma = u @ (w_mat @ v)
        weight = self.weight_orig / sigma
        conv = F.conv2d if self.ndim == 2 else F.conv3d
        if x.dtype == weight.dtype:
            return conv(x, weight, self.bias, stride=self.stride, padding=self.padding)
        out = conv(x, weight.to(x.dtype), None, stride=self.stride, padding=self.padding)
        if self.bias is None:
            return out
        return out + self.bias.to(out.dtype).reshape((-1,) + (1,) * self.ndim)
