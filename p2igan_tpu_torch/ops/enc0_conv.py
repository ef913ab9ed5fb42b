"""Fused small-Cin 3x3x3 conv + bias + LeakyReLU (the simple family's enc0).

Counterpart of ``p2igan_tpu/ops/pallas/enc0_conv.py``. Serving only: the simple
generator calls it after ``fold_for_inference`` has folded the block's
BatchNorm into the weights, so conv, bias and activation are the whole block.
Training keeps ``nn.Conv3d`` (cuDNN), as the JAX package keeps XLA's conv.

Layouts follow the JAX function: ``x`` is (B, T, H, W, Cin), ``weight`` DHWIO
(3, 3, 3, Cin, Cout), the result (B, T, H, W, Cout). The result's *memory* is
channels-first (a permuted view of a contiguous (B, Cout, T, H, W) tensor),
because the next layer is a cuDNN convolution that wants it so;
``result.permute(0, 4, 1, 2, 3)`` is contiguous and free.

:func:`enc0_conv3d_leaky` runs :func:`enc0_conv3d_leaky_reference` for CPU
tensors and launches ``csrc/enc0_conv.cu`` for CUDA tensors (or raises); there
is no fallback between the two. ``enc0_conv3d_leaky.launches`` counts launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib
from .cuda_lib import MAX_SHARED_BYTES

MAX_CIN = 4                # csrc/enc0_conv.cu instantiates Cin = 1..4


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """The serving-only kernels have no backward: raise rather than return a
    result that silently carries no gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is forward-only (serving): call it under torch.no_grad() "
            f"or torch.inference_mode(); training goes through nn.Conv3d "
            f"(cuDNN), which carries the gradient")


def enc0_conv3d_leaky_reference(x: torch.Tensor, weight: torch.Tensor,
                                bias: torch.Tensor, slope: float = 0.2
                                ) -> torch.Tensor:
    """Plain version: ``F.conv3d`` (SAME) then ``F.leaky_relu``; any float
    dtype, any device."""
    # contiguous channels-first in, so channels-first out on every backend
    y = F.conv3d(x.permute(0, 4, 1, 2, 3).contiguous(), weight.permute(4, 3, 0, 1, 2),
                 bias, padding=1)
    return F.leaky_relu(y, slope).permute(0, 2, 3, 4, 1)


def shared_bytes(cin: int, cout: int) -> int:
    """Dynamic shared memory of the kernel: the weights and bias padded to 32
    output channels, and a ring of four haloed 16x128 input slices, channels
    last, each row ``128 * cin + 8`` floats (a chunk of 16 bytes beyond each
    side of the tile's columns, for the halo)."""
    cout_pad = -(-cout // 32) * 32
    return 4 * ((27 * cin + 1) * cout_pad + 4 * 18 * (128 * cin + 8))


def enc0_conv3d_leaky(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      slope: float = 0.2) -> torch.Tensor:
    """leaky_relu(conv3d(x, weight, SAME) + bias, slope), float32, no gradient.

    x: (B, T, H, W, Cin) contiguous, Cin <= 4; weight: (3, 3, 3, Cin, Cout);
    bias: (Cout,). Each window b is zero-padded at t = 0 and t = T - 1."""
    name = "enc0_conv3d_leaky"
    refuse_grad(name, x, weight, bias)
    if x.ndim != 5 or weight.shape[:4] != (3, 3, 3, x.shape[-1]) \
            or bias.shape != weight.shape[4:]:
        raise ValueError(f"{name}: x {tuple(x.shape)}, weight {tuple(weight.shape)}, "
                         f"bias {tuple(bias.shape)} do not fit")
    if x.device.type == "cpu":
        return enc0_conv3d_leaky_reference(x, weight, bias, slope)
    weight, bias = weight.detach().contiguous(), bias.detach().contiguous()
    cuda_lib.require_cuda(name, x, weight, bias)
    B, T, H, W, cin = x.shape
    cout = weight.shape[4]
    if not 1 <= cin <= MAX_CIN or x.numel() == 0 or cout == 0:
        raise ValueError(f"{name}: unsupported Cin={cin} (1..{MAX_CIN}), "
                         f"x {tuple(x.shape)}, Cout={cout}")
    if H * W * cin >= 2**31:
        raise ValueError(f"{name}: a frame of {H}x{W}x{cin} floats (the kernel's "
                         f"offsets in a frame are 32-bit)")
    if shared_bytes(cin, cout) > MAX_SHARED_BYTES:
        raise ValueError(f"{name}: Cin={cin}, Cout={cout} need "
                         f"{shared_bytes(cin, cout)} bytes of shared memory")
    out = torch.empty((B, cout, T, H, W), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        rc = cuda_lib.library().p2i_enc0_conv3d_leaky(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            B, T, H, W, cin, cout, float(slope), cuda_lib.stream_of(x))
    cuda_lib.check(rc, name)
    enc0_conv3d_leaky.launches += 1
    return out.permute(0, 2, 3, 4, 1)


enc0_conv3d_leaky.launches = 0
