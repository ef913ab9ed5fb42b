"""Fused uint8 decode -> [0, 1] normalize -> mask multiply.

Counterpart of ``p2igan_tpu/ops/pallas/decode_mask.py``. The raw training
pipeline (``data.train.device_decode``) ships uint8 frames and a uint8 mask to
the device; :func:`decode_normalize_mask` turns them into the float32 video
and masked video in one pass: its plain PyTorch version for CPU tensors, the
hand-written kernel ``csrc/decode_mask.cu`` for CUDA tensors (or it raises).
``decode_normalize_mask.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import cuda_lib


def _frame_constant_mask(mask_shape, frames_shape) -> bool:
    """True for a ``(B, 1, ...)`` mask against ``(B, T, ...)`` frames (the
    sti/stis layout: one spatial observation pattern per sample)."""
    return (len(mask_shape) == len(frames_shape) and len(frames_shape) >= 3
            and mask_shape[1] == 1 and frames_shape[1] > 1
            and mask_shape[0] == frames_shape[0]
            and tuple(mask_shape[2:]) == tuple(frames_shape[2:]))


def decode_normalize_mask_reference(frames_u8: torch.Tensor, mask: torch.Tensor):
    """Plain version: ``video = u8 / 255`` and ``masked = video * mask``,
    float32, the mask broadcast to the frames. The division is by a tensor,
    which PyTorch's CUDA kernels divide with correct rounding (a Python
    scalar divisor would be turned into a reciprocal multiply there), so the
    result equals numpy's ``u8.astype(np.float32) / 255.0`` on both devices."""
    video = frames_u8.to(torch.float32) / torch.full(
        (1,), 255.0, dtype=torch.float32, device=frames_u8.device)
    return video, video * mask.to(torch.float32)


def decode_normalize_mask(frames_u8: torch.Tensor, mask: torch.Tensor):
    """(B, T, ...) uint8 frames + a full-shape or frame-constant (B, 1, ...)
    0/1 mask (uint8, bool or float) -> (video, masked) float32 in [0, 1]."""
    if frames_u8.device.type == "cpu":
        return decode_normalize_mask_reference(frames_u8, mask)
    name = "decode_normalize_mask"
    if mask.dtype == torch.bool:
        mask = mask.view(torch.uint8)
    elif mask.dtype != torch.uint8:
        mask = mask.to(torch.float32)
    cuda_lib.require_cuda(name, frames_u8, mask, dtypes=(torch.uint8, mask.dtype))
    shape = tuple(frames_u8.shape)
    frame_const = _frame_constant_mask(mask.shape, shape)
    if not frame_const and tuple(mask.shape) != shape:
        raise ValueError(f"{name}: mask {tuple(mask.shape)} is neither "
                         f"{shape} nor frame-constant (B, 1, ...)")
    n = frames_u8.numel()
    if n == 0:
        raise ValueError(f"{name}: empty frames")
    T = shape[1] if frame_const else 1
    plane = n // (shape[0] * shape[1]) if frame_const else n
    video = torch.empty(shape, device=frames_u8.device, dtype=torch.float32)
    masked = torch.empty_like(video)
    mask_align = 4 if mask.dtype == torch.uint8 else 16
    vec4 = int(n % 4 == 0 and plane % 4 == 0 and frames_u8.data_ptr() % 4 == 0
               and mask.data_ptr() % mask_align == 0)
    with torch.cuda.device(frames_u8.device):
        rc = cuda_lib.library().p2i_decode_normalize_mask(
            frames_u8.data_ptr(), mask.data_ptr(), video.data_ptr(),
            masked.data_ptr(), n, plane, T, int(mask.dtype == torch.float32),
            int(frame_const), vec4, cuda_lib.stream_of(frames_u8))
    cuda_lib.check(rc, name)
    decode_normalize_mask.launches += 1
    return video, masked


decode_normalize_mask.launches = 0
