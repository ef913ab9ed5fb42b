"""Fused 2x2 max pool + consecutive channel duplication (NCHW).

Counterpart of ``p2igan_tpu/ops/pallas/pool_dup.py``. The generator's three
pyramid downsamples run through :func:`maxpool2_duplicate`: its plain PyTorch
version for CPU tensors, the hand-written kernel ``csrc/pool_dup.cu`` for CUDA
tensors (or it raises). ``maxpool2_duplicate.launches`` counts kernel launches
(``bf16_launches`` those of them on bfloat16).
It is a ``torch.autograd.Function`` on both devices; its backward is the plain
version's VJP, as in the JAX package (no TPU kernel there either).

It takes float32 and bfloat16 (the generator's bf16 compute dtype). The JAX
package sends a bf16 pyramid to XLA's max pool (``p2igan_tpu/ops/layers.py``
``downsample_duplicate_channels``); here a bf16 CUDA tensor launches the bf16
instantiation of the same kernel. Any other dtype raises on either device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib


def maxpool2_duplicate_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version: (N, C, H, W) -> (N, 2C, H/2, W/2)."""
    return F.max_pool2d(x, 2, 2).repeat_interleave(2, dim=1)


# the kernel's C entry point by dtype
_ENTRY = {torch.float32: "p2i_maxpool2_duplicate",
          torch.bfloat16: "p2i_maxpool2_duplicate_bf16"}


def _check_dtype(x: torch.Tensor) -> None:
    if x.dtype not in _ENTRY:
        raise TypeError(f"maxpool2_duplicate takes float32 or bfloat16, got {x.dtype}")


def _maxpool2_duplicate_cuda(x: torch.Tensor) -> torch.Tensor:
    name = "maxpool2_duplicate"
    cuda_lib.require_cuda(name, x, dtypes=(x.dtype,))  # the dtype: checked by the caller
    if x.dim() != 4:
        raise ValueError(f"{name}: expected (N, C, H, W), got {tuple(x.shape)}")
    N, C, H, W = x.shape
    if H % 2 or W % 2 or x.numel() == 0 or x.data_ptr() % (2 * x.element_size()):
        raise ValueError(f"{name}: needs even, non-empty H and W and a tensor "
                         f"aligned to two elements, got {tuple(x.shape)}")
    out = torch.empty((N, 2 * C, H // 2, W // 2), device=x.device, dtype=x.dtype)
    with torch.cuda.device(x.device):
        rc = getattr(cuda_lib.library(), _ENTRY[x.dtype])(
            x.data_ptr(), out.data_ptr(), N, C, H, W, cuda_lib.stream_of(x))
    cuda_lib.check(rc, name)
    maxpool2_duplicate.launches += 1
    if x.dtype == torch.bfloat16:
        maxpool2_duplicate.bf16_launches += 1
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
    """(N, C, H, W) float32 or bfloat16 -> (N, 2C, H/2, W/2) of the same
    dtype: 2x2 max pool, then every channel duplicated consecutively
    (reference DownsampleDuplicateChannels). Differentiable; where no gradient
    is wanted the autograd Function is left out (the same forward, less host
    time a call)."""
    _check_dtype(x)
    if x.requires_grad and torch.is_grad_enabled():
        return _MaxPool2Duplicate.apply(x)
    if x.device.type == "cpu":
        return maxpool2_duplicate_reference(x)
    return _maxpool2_duplicate_cuda(x)


maxpool2_duplicate.launches = 0
maxpool2_duplicate.bf16_launches = 0  # of them, the bf16 instantiation's
