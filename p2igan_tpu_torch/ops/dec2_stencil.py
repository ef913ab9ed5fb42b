"""Fused Cout=1 3x3x3 conv + bias + sigmoid (the simple family's dec2).

Counterpart of ``p2igan_tpu/ops/pallas/dec2_stencil.py``. Serving only, like
``ops/enc0_conv.py``; training keeps ``nn.Conv3d`` (cuDNN).

Layouts follow the JAX function: ``x`` is (B, T, H, W, C), ``weight`` DHWIO
(3, 3, 3, C, 1), the result (B, T, H, W, 1). The kernel reads ``x`` in
channels-first *memory*, which is how the simple generator hands it over (a
permuted view of cuDNN's (B, C, T, H, W) output, no copy); an ``x`` in any
other memory order is copied into that order first.

:func:`conv3d_cout1_sigmoid` runs :func:`conv3d_cout1_sigmoid_reference` for
CPU tensors and launches ``csrc/dec2_stencil.cu`` for CUDA tensors (or
raises); there is no fallback between the two.
``conv3d_cout1_sigmoid.launches`` counts launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib
from .cuda_lib import MAX_SHARED_BYTES
from .enc0_conv import refuse_grad


def conv3d_cout1_sigmoid_reference(x: torch.Tensor, weight: torch.Tensor,
                                   bias: torch.Tensor) -> torch.Tensor:
    """Plain version: ``F.conv3d`` (SAME) then ``torch.sigmoid``; any float
    dtype, any device."""
    # contiguous channels-first in, so channels-first out on every backend
    y = F.conv3d(x.permute(0, 4, 1, 2, 3).contiguous(), weight.permute(4, 3, 0, 1, 2),
                 bias, padding=1)
    return torch.sigmoid(y).permute(0, 2, 3, 4, 1)


def shared_bytes(channels: int) -> int:
    """Dynamic shared memory of the kernel: a ring of four haloed 32x64 input
    slices (row pitch 72), and 28 weights a channel."""
    return 4 * (4 * 34 * 72 + channels * 28)


def conv3d_cout1_sigmoid(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """sigmoid(conv3d(x, weight, SAME) + bias), float32, no gradient.

    x: (B, T, H, W, C); weight: (3, 3, 3, C, 1); bias: (1,). Each window b is
    zero-padded at t = 0 and t = T - 1. Returns (B, T, H, W, 1)."""
    name = "conv3d_cout1_sigmoid"
    refuse_grad(name, x, weight, bias)
    if x.ndim != 5 or weight.shape != (3, 3, 3, x.shape[-1], 1) or bias.shape != (1,):
        raise ValueError(f"{name}: x {tuple(x.shape)}, weight {tuple(weight.shape)}, "
                         f"bias {tuple(bias.shape)} do not fit")
    if x.device.type == "cpu":
        return conv3d_cout1_sigmoid_reference(x, weight, bias)
    xc = x.permute(0, 4, 1, 2, 3).contiguous()   # no copy when already so
    weight, bias = weight.detach().contiguous(), bias.detach().contiguous()
    cuda_lib.require_cuda(name, xc, weight, bias)
    B, C, T, H, W = xc.shape
    if xc.numel() == 0 or shared_bytes(C) > MAX_SHARED_BYTES:
        raise ValueError(f"{name}: unsupported x {tuple(x.shape)} (C={C} needs "
                         f"{shared_bytes(C)} bytes of shared memory)")
    out = torch.empty((B, T, H, W, 1), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        rc = cuda_lib.library().p2i_dec2_conv3d_sigmoid(
            xc.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            B, T, H, W, C, cuda_lib.stream_of(xc))
    cuda_lib.check(rc, name)
    conv3d_cout1_sigmoid.launches += 1
    return out


conv3d_cout1_sigmoid.launches = 0
