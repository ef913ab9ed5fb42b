"""Fused DK/STDK MLP tail: the 100-100-100-1 chain after the split first layer.

Counterpart of ``p2igan_tpu/ops/pallas/dk_mlp_kernel.py``. Both families
reduce to the same tail once the first layer is decomposed:

    y[j, p] = fc4 . relu(fc3^T relu(fc2^T relu(phi[p] + off[j]) + b2) + b3) + b4

with ``j = (b, t)``, ``p`` a pixel, ``phi = phi_s @ W1_s`` (HW, h) shared by
every (b, t) and ``off`` (J, h) the per-(b, t) hidden offset. Weights keep the
JAX package's ``(in, out)`` layout at this module's functions, so the tests
compare like with like; the models pass ``weight.t()``.

* :func:`mlp_tail_fused` -- the tail for all (b, t) at once, (J, HW). For CUDA
  tensors it is a ``torch.autograd.Function`` whose forward launches
  ``csrc/dk_mlp_tail.cu`` and whose backward is
* :func:`mlp_tail_bwd` -- the eight gradients from the output cotangent
  (``csrc/dk_mlp_tail_bwd.cu``; the forward is recomputed inside, nothing of
  size (J, HW, h) reaches device memory; five of its six tile products run
  on the tensor cores at float32 accuracy, and its relu masks are bit for
  bit the forward kernel's).

Each wrapper runs its plain PyTorch version for CPU tensors and launches its
kernel for CUDA tensors (or raises); there is no fallback between the two.
``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import cuda_lib
from .cuda_lib import MAX_SHARED_BYTES

MAX_HIDDEN = 104          # csrc/dk_mlp_tail.cu kHP: 13 column owners x 8
FWD_PIXELS_PER_BLOCK = 128  # csrc/dk_mlp_tail.cu kRows: pixels a tile
BWD_PIXELS_PER_BLOCK = 64   # csrc/dk_mlp_tail_bwd.cu kRows


def _tail_chunk(phi_part, off, fc2, b2, fc3, b3, fc4, b4):
    h = torch.relu(phi_part[None, :, :] + off[:, None, :])   # (c, HW, h)
    h = torch.relu(h @ fc2 + b2)
    h = torch.relu(h @ fc3 + b3)
    return h @ fc4 + b4                                       # (c, HW)


def mlp_tail_reference(phi_part, offsets, fc2, b2, fc3, b3, fc4, b4,
                       chunk: int = 8) -> torch.Tensor:
    """Plain version of :func:`mlp_tail_fused`, any float dtype.

    phi_part: (HW, h). offsets: (J, h). fc2/fc3: (h, h) as (in, out); b2/b3:
    (h,); fc4: (h,); b4: scalar. Returns (J, HW). Walks ``chunk`` rows of
    ``offsets`` at a time so that nothing of size (J, HW, h) beyond one chunk
    is alive; under autograd each chunk is recomputed in the backward."""
    args = (phi_part, fc2, b2, fc3, b3, fc4, b4)
    recompute = torch.is_grad_enabled() and any(
        t.requires_grad for t in (offsets, *args))
    outs = []
    for lo in range(0, offsets.shape[0], chunk):
        off = offsets[lo:lo + chunk]
        if recompute:
            outs.append(checkpoint(_tail_chunk, phi_part, off, *args[1:],
                                   use_reentrant=False))
        else:
            outs.append(_tail_chunk(phi_part, off, *args[1:]))
    return torch.cat(outs, dim=0)


def mlp_tail_bwd_reference(phi_part, offsets, g, fc2, b2, fc3, b3, fc4):
    """Plain version of :func:`mlp_tail_bwd`: autograd of
    :func:`mlp_tail_reference`. Returns (dphi, doff, dfc2, db2, dfc3, db3,
    dfc4); db4 is ``g.sum()`` and is left to the caller, as in the kernel."""
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (phi_part, offsets, fc2, b2, fc3, b3, fc4)]
    b4 = torch.zeros((), dtype=phi_part.dtype, device=phi_part.device)
    with torch.enable_grad():
        out = mlp_tail_reference(*leaves, b4)
        return torch.autograd.grad(out, leaves, g)


def _check_tail_args(name, phi_part, offsets, fc2, b2, fc3, b3, fc4):
    HW, h = phi_part.shape
    J = offsets.shape[0]
    if (offsets.shape != (J, h) or fc2.shape != (h, h) or fc3.shape != (h, h)
            or b2.shape != (h,) or b3.shape != (h,) or fc4.shape != (h,)):
        raise ValueError(
            f"{name}: shapes phi {tuple(phi_part.shape)} off {tuple(offsets.shape)} "
            f"fc2 {tuple(fc2.shape)} b2 {tuple(b2.shape)} fc3 {tuple(fc3.shape)} "
            f"b3 {tuple(b3.shape)} fc4 {tuple(fc4.shape)} do not fit")
    if not 1 <= h <= MAX_HIDDEN or HW == 0 or J == 0:
        raise ValueError(f"{name}: unsupported h={h} (max {MAX_HIDDEN}), "
                         f"HW={HW}, J={J}")
    return HW, J, h


def fwd_shared_bytes(h: int) -> int:
    """Dynamic shared memory of the forward kernel (csrc/dk_mlp_tail.cu):
    every operand is padded to the hidden width MAX_HIDDEN, so it is the same
    at every h. Two weights, the phi tile and the activation tile (k-major,
    row stride rows + 4), the 13 fc4 partials of a tile, five vectors (b2,
    b3, fc4 and two rows of offsets)."""
    hp, stride = MAX_HIDDEN, FWD_PIXELS_PER_BLOCK + 4
    return 4 * (2 * hp * hp + 2 * hp * stride + 13 * stride + 5 * hp)


def bwd_shared_bytes(h: int) -> int:
    """Dynamic shared memory of the backward kernel (csrc/dk_mlp_tail_bwd.cu):
    every operand is padded to the hidden width MAX_HIDDEN, so it is the same
    at every h. Two weights, two weight-gradient accumulators, two pixel
    tiles, the column sums of 4 row tiles, five vectors (b2, b3, fc4, a row
    of offsets, fc3's column norms) and a row of the cotangent."""
    rows, hp = BWD_PIXELS_PER_BLOCK, MAX_HIDDEN
    return 4 * (4 * hp * hp + 2 * rows * hp + 4 * hp + 5 * hp + rows)


def _mlp_tail_cuda(phi_part, offsets, fc2, b2, fc3, b3, fc4, b4):
    name = "mlp_tail_fused"
    cuda_lib.require_cuda(name, phi_part, offsets, fc2, b2, fc3, b3, fc4, b4)
    HW, J, h = _check_tail_args(name, phi_part, offsets, fc2, b2, fc3, b3, fc4)
    if b4.numel() != 1:
        raise ValueError(f"{name}: b4 must hold one value, got {tuple(b4.shape)}")
    out = torch.empty((J, HW), device=phi_part.device, dtype=torch.float32)
    with torch.cuda.device(phi_part.device):
        rc = cuda_lib.library().p2i_dk_mlp_tail(
            phi_part.data_ptr(), offsets.data_ptr(), fc2.data_ptr(),
            b2.data_ptr(), fc3.data_ptr(), b3.data_ptr(), fc4.data_ptr(),
            b4.data_ptr(), out.data_ptr(), HW, J, h,
            cuda_lib.stream_of(phi_part))
    cuda_lib.check(rc, name)
    mlp_tail_fused.launches += 1
    return out


def mlp_tail_bwd(phi_part, offsets, g, fc2, b2, fc3, b3, fc4):
    """Gradients of :func:`mlp_tail_fused` from its output cotangent g (J, HW):
    (dphi (HW, h), doff (J, h), dfc2 (h, h), db2 (h,), dfc3 (h, h), db3 (h,),
    dfc4 (h,)). db4 = g.sum() is the caller's."""
    if phi_part.device.type == "cpu":
        return mlp_tail_bwd_reference(phi_part, offsets, g, fc2, b2, fc3, b3, fc4)
    name = "mlp_tail_bwd"
    cuda_lib.require_cuda(name, phi_part, offsets, g, fc2, b2, fc3, b3, fc4)
    HW, J, h = _check_tail_args(name, phi_part, offsets, fc2, b2, fc3, b3, fc4)
    if g.shape != (J, HW):
        raise ValueError(f"{name}: cotangent {tuple(g.shape)} is not ({J}, {HW})")
    dev = phi_part.device
    nblk = -(-HW // BWD_PIXELS_PER_BLOCK)
    wlen = 2 * h * h + 3 * h           # dfc2 | dfc3 | dfc4 | db2 | db3
    new = lambda *shape: torch.empty(shape, device=dev, dtype=torch.float32)  # noqa: E731
    dphi, doff, wgrad = new(HW, h), new(J, h), new(wlen)
    # per-block partials, summed in block order by a second kernel
    doff_parts, w_parts = new(nblk, J, h), new(nblk, wlen)
    with torch.cuda.device(dev):
        rc = cuda_lib.library().p2i_dk_mlp_tail_bwd(
            phi_part.data_ptr(), offsets.data_ptr(), g.data_ptr(),
            fc2.data_ptr(), b2.data_ptr(), fc3.data_ptr(), b3.data_ptr(),
            fc4.data_ptr(), dphi.data_ptr(), doff_parts.data_ptr(),
            w_parts.data_ptr(), doff.data_ptr(), wgrad.data_ptr(), HW, J, h,
            nblk, cuda_lib.stream_of(phi_part))
    cuda_lib.check(rc, name)
    mlp_tail_bwd.launches += 1
    hh = h * h
    return (dphi, doff, wgrad[:hh].view(h, h), wgrad[2 * hh + h:2 * hh + 2 * h],
            wgrad[hh:2 * hh].view(h, h), wgrad[2 * hh + 2 * h:],
            wgrad[2 * hh:2 * hh + h])


mlp_tail_bwd.launches = 0


class _MLPTail(torch.autograd.Function):
    """The fused tail on the card: forward and backward are the two kernels.
    Every input is differentiable, as in the JAX package's custom VJP."""

    @staticmethod
    def forward(ctx, phi_part, offsets, fc2, b2, fc3, b3, fc4, b4):
        args = [t.detach().to(torch.float32).contiguous()
                for t in (phi_part, offsets, fc2, b2, fc3, b3, fc4, b4)]
        ctx.save_for_backward(*args[:7])
        ctx.b4_shape = b4.shape
        return _mlp_tail_cuda(*args)

    @staticmethod
    def backward(ctx, g):
        phi_part, offsets, fc2, b2, fc3, b3, fc4 = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        dphi, doff, dfc2, db2, dfc3, db3, dfc4 = mlp_tail_bwd(
            phi_part, offsets, g, fc2, b2, fc3, b3, fc4)
        return dphi, doff, dfc2, db2, dfc3, db3, dfc4, g.sum().reshape(ctx.b4_shape)


def mlp_tail_fused(phi_part: torch.Tensor, offsets: torch.Tensor,
                   fc2: torch.Tensor, b2: torch.Tensor, fc3: torch.Tensor,
                   b3: torch.Tensor, fc4: torch.Tensor, b4: torch.Tensor
                   ) -> torch.Tensor:
    """Fused tail over all (b, t) at once: (HW, h), (J, h) -> (J, HW) float32,
    differentiable in every argument. CPU tensors take the plain version (and
    its autograd); CUDA tensors launch the kernels."""
    if phi_part.device.type == "cpu":
        return mlp_tail_reference(phi_part, offsets, fc2, b2, fc3, b3, fc4, b4)
    return _MLPTail.apply(phi_part, offsets, fc2, b2, fc3, b3, fc4, b4)


mlp_tail_fused.launches = 0
