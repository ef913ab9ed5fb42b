"""Fused 2x2 max pool + consecutive channel duplication (NCHW).

Counterpart of ``p2igan_tpu/ops/pallas/pool_dup.py``. The generator's three
pyramid downsamples run through :func:`maxpool2_duplicate`: its plain PyTorch
version for CPU tensors, the hand-written kernel ``csrc/pool_dup.cu`` for CUDA
tensors (or it raises). ``maxpool2_duplicate.launches`` counts kernel launches.
It is a ``torch.autograd.Function`` on both devices; its backward is the plain
version's VJP, as in the JAX package (no TPU kernel there either).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib


def maxpool2_duplicate_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version: (N, C, H, W) -> (N, 2C, H/2, W/2)."""
    return F.max_pool2d(x, 2, 2).repeat_interleave(2, dim=1)


def _maxpool2_duplicate_cuda(x: torch.Tensor) -> torch.Tensor:
    name = "maxpool2_duplicate"
    cuda_lib.require_cuda(name, x)
    if x.dim() != 4:
        raise ValueError(f"{name}: expected (N, C, H, W), got {tuple(x.shape)}")
    N, C, H, W = x.shape
    if H % 2 or W % 2 or x.numel() == 0 or x.data_ptr() % 8:
        raise ValueError(f"{name}: needs even, non-empty H and W and an "
                         f"8-byte aligned tensor, got {tuple(x.shape)}")
    out = torch.empty((N, 2 * C, H // 2, W // 2), device=x.device,
                      dtype=torch.float32)
    with torch.cuda.device(x.device):
        rc = cuda_lib.library().p2i_maxpool2_duplicate(
            x.data_ptr(), out.data_ptr(), N, C, H, W, cuda_lib.stream_of(x))
    cuda_lib.check(rc, name)
    maxpool2_duplicate.launches += 1
    return out


class _MaxPool2Duplicate(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU). Backward, on
    both devices: recompute the plain forward and take its VJP
    (``p2igan_tpu/ops/pallas/pool_dup.py`` does the same), so on ties the
    gradient goes to the element the plain max pool chose."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        if x.device.type == "cpu":
            return maxpool2_duplicate_reference(x)
        return _maxpool2_duplicate_cuda(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            (dx,) = torch.autograd.grad(maxpool2_duplicate_reference(xr), xr, g)
        return dx


def maxpool2_duplicate(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) float32 -> (N, 2C, H/2, W/2): 2x2 max pool, then every
    channel duplicated consecutively (reference DownsampleDuplicateChannels).
    Differentiable; where no gradient is wanted the autograd Function is left
    out (the same forward, less host time a call)."""
    if x.requires_grad and torch.is_grad_enabled():
        return _MaxPool2Duplicate.apply(x)
    if x.device.type == "cpu":
        return maxpool2_duplicate_reference(x)
    return _maxpool2_duplicate_cuda(x)


maxpool2_duplicate.launches = 0
