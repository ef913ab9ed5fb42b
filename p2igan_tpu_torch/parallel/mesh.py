"""Data parallelism over processes: the port's counterpart of
``p2igan_tpu/parallel/mesh.py``.

The JAX package builds a device mesh with one ``data`` axis, shards every
batch's leading dimension over it and lets ``jit`` insert the collectives.
Here each device is a process, started by ``torchrun`` (one a GPU), and the
collectives are explicit:

* :func:`create_mesh` reads ``torchrun``'s ``RANK``, ``WORLD_SIZE`` and
  ``LOCAL_RANK``; a rank's device is ``cuda:LOCAL_RANK`` (or the CPU when the
  caller asks for it) and its process group NCCL on CUDA, gloo on the CPU,
  or the group the caller already made. Without that environment, and with no
  such group, it returns the single-process mesh, whose collectives do nothing: such a run is the one-device program,
  bit for bit.
* a batch is global: rank r takes its contiguous rows (:func:`shard_rows`,
  ``batch_sharding``'s counterpart), or the whole batch when the batch does
  not divide by the world size (the JAX trainer then replicates it);
* the gradients are averaged over the ranks by one ``all_reduce`` of one flat
  buffer (:meth:`DataMesh.reduce_gradients`); every loss is a mean over
  samples, so the average of the ranks' gradients is the global batch's;
* BatchNorm statistics in training are the global batch's, as under
  ``pjit`` (:meth:`DataMesh.batch_norm`).

Only ``all_reduce`` and ``broadcast`` carry data between ranks: gloo takes
CUDA tensors for those two collectives, so ranks that share one card can run
over gloo where NCCL refuses two ranks on a device.

Not ported: the ``model`` axis (``model_sharded_params``).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class DataMesh:
    """One rank's view of the ``data`` axis: its rank, the world size, its
    device, the process group (``None`` in a single-process run, where every
    collective below returns at once) and its backend's name."""

    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    group: Optional[Any] = None
    backend: str = ""

    def __deepcopy__(self, memo) -> "DataMesh":
        return self  # a handle on the process group, shared by copies of a module

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    # -- collectives ------------------------------------------------------
    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place."""
        if self.distributed:
            dist.all_reduce(t, group=self.group)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` of rank ``src`` on every rank, in place."""
        if self.distributed:
            dist.broadcast(t, src, group=self.group)
        return t

    def barrier(self) -> None:
        """Wait until every rank got here (an all-reduce the host waits for)."""
        if self.distributed:
            float(self.all_reduce_(torch.zeros(1, device=self.device)))

    def main_first(self, fn: Callable[[], Any]) -> Any:
        """Rank 0 calls ``fn`` while the others wait, then they call it: e.g.
        the kernel build, which rank 0 writes once and the others load."""
        if self.distributed and self.is_main:
            fn()
        self.barrier()
        return fn()

    def mean_(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over the ranks of ``t``, in place."""
        if self.distributed:
            # divided by a tensor: a Python scalar divisor is a reciprocal
            # multiply on CUDA
            self.all_reduce_(t).div_(torch.tensor(float(self.world), dtype=t.dtype,
                                                  device=t.device))
        return t

    def mean_values(self, values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """0-dim tensors by name -> their means over the ranks, in one
        all-reduce."""
        if not self.distributed or not values:
            return values
        keys = list(values)
        stacked = self.mean_(torch.stack([values[k].detach().to(torch.float32)
                                          for k in keys]))
        return dict(zip(keys, stacked.unbind(0)))

    def reduce_gradients(self, params: Iterable[torch.nn.Parameter]) -> None:
        """Average every ``.grad`` over the ranks: one flat buffer, one
        all-reduce (sum), divided by the world size, copied back. The set of
        parameters with a gradient is the same on every rank (the same step
        runs everywhere)."""
        if not self.distributed:
            return
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        flat = self.mean_(torch.cat([g.reshape(-1) for g in grads]))
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    def broadcast_module(self, module: torch.nn.Module) -> None:
        """Rank 0's parameters and buffers on every rank."""
        if not self.distributed:
            return
        for name, t in module.state_dict().items():
            if not t.is_contiguous():
                raise ValueError(f"{name} is not contiguous: it cannot be broadcast")
            self.broadcast_(t)

    def broadcast_optimizer(self, opt: torch.optim.Optimizer) -> None:
        """Rank 0's optimizer state on every rank: each tensor on this rank's
        device, parameter by parameter in the groups' order (counters on the
        host are the same on every rank: they come from the same checkpoint
        or the same number of steps)."""
        if not self.distributed:
            return
        for group in opt.param_groups:
            for p in group["params"]:
                state = opt.state.get(p, {})
                for key in sorted(state):
                    value = state[key]
                    if isinstance(value, torch.Tensor) and value.device == self.device:
                        self.broadcast_(value)

    # -- BatchNorm over the global batch ----------------------------------
    def batch_norm(self, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Training-mode BatchNorm of (B, C, ...) over the batch of every
        rank: (y, the global mean, the global biased variance)."""
        return _GlobalBatchNorm.apply(x, weight, bias, eps, self)


class _GlobalBatchNorm(torch.autograd.Function):
    """BatchNorm whose statistics are the global batch's. Forward: each rank's
    (count, mean, biased variance) a channel in its row of a (world, 3, C)
    buffer of zeros, one all-reduce (every rank then holds every row
    exactly), and the rows combined in rank order, the same arithmetic on
    every rank. Backward: one all-reduce of the two sums a channel of the
    gradient (of ``dy`` and of ``dy * xhat``); the weight and bias get this
    rank's own sums, which the gradient average then combines."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, mesh):
        dims = [0, *range(2, x.dim())]
        shape = [1, -1] + [1] * (x.dim() - 2)
        var, mean = torch.var_mean(x, dim=dims, unbiased=False)
        rows = torch.zeros((mesh.world, 3, x.shape[1]), dtype=x.dtype, device=x.device)
        rows[mesh.rank, 0] = float(x.numel() // x.shape[1])
        rows[mesh.rank, 1] = mean
        rows[mesh.rank, 2] = var
        counts, means, variances = mesh.all_reduce_(rows).unbind(1)
        n = counts.sum(0)
        g_mean = (counts * means).sum(0) / n
        g_var = (counts * (variances + (means - g_mean) ** 2)).sum(0) / n
        invstd = torch.rsqrt(g_var + eps)
        xhat = (x - g_mean.view(shape)) * invstd.view(shape)
        y = xhat * weight.view(shape) + bias.view(shape)
        ctx.save_for_backward(xhat, weight, invstd, n)
        ctx.mesh, ctx.dims, ctx.shape = mesh, dims, shape
        ctx.mark_non_differentiable(g_mean, g_var)
        return y, g_mean, g_var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xhat, weight, invstd, n = ctx.saved_tensors
        dims, shape = ctx.dims, ctx.shape
        local = torch.stack([dy.sum(dims), (dy * xhat).sum(dims)])
        total = ctx.mesh.all_reduce_(local.clone())
        dx = None
        if ctx.needs_input_grad[0]:
            dx = (dy - (total[0] / n).view(shape) - xhat * (total[1] / n).view(shape)) \
                * (weight * invstd).view(shape)
        dweight = local[1] if ctx.needs_input_grad[1] else None
        dbias = local[0] if ctx.needs_input_grad[2] else None
        return dx, dweight, dbias, None, None


# -- set-up ----------------------------------------------------------------

def resolve_device(device: str | torch.device) -> torch.device:
    """The requested device; a CUDA request without a usable GPU raises
    (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA GPU is "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def _torchrun_env() -> Optional[Tuple[int, int, int]]:
    """(RANK, WORLD_SIZE, LOCAL_RANK) when torchrun's environment is set."""
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return None
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return rank, world, int(os.environ.get("LOCAL_RANK", rank))


def create_mesh(device: str | torch.device = "cuda") -> DataMesh:
    """This rank's :class:`DataMesh`.

    * A process group already made by the caller (e.g. ``torch.multiprocessing``
      workers, or ranks that share one card over gloo) is used as it is.
    * Else, under ``torchrun``'s environment, the default group is made over
      ``env://``: NCCL when ``device`` is CUDA, gloo on the CPU. A backend that
      does not initialise raises, naming the cause; there is no fallback to
      another.
    * Else the single-process mesh on ``device``.

    A CUDA rank's device is ``cuda:LOCAL_RANK``; a CUDA request without a
    usable GPU raises (:func:`resolve_device`)."""
    dev = resolve_device(device)
    env = _torchrun_env()
    initialized = dist.is_available() and dist.is_initialized()
    if env is None and not initialized:
        return DataMesh(device=dev)
    if initialized:
        rank, world = dist.get_rank(), dist.get_world_size()
        local = env[2] if env is not None else rank
    else:
        rank, world, local = env
    if dev.type == "cuda":
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if not initialized:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        try:
            dist.init_process_group(backend, init_method="env://", rank=rank,
                                    world_size=world)
        except Exception as e:
            raise RuntimeError(f"rank {rank} of {world}: the {backend} process group "
                               f"did not initialise on {dev}: {e}") from e
    backend = dist.get_backend()
    logging.info("Data mesh: rank %d of %d on %s (%s)", rank, world, dev, backend)
    return DataMesh(rank=rank, world=world, device=dev, group=dist.group.WORLD,
                    backend=backend)


def shutdown() -> None:
    """Destroy the default process group, if there is one (the CLIs' last
    step)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0) -> Tuple[np.ndarray, int]:
    """Pad the batch axis to a multiple of the data-axis size.

    Returns (padded, n_valid). Padding repeats the last element so every shard
    sees well-formed data; callers mask out the padding in reductions.
    """
    n = x.shape[axis]
    rem = n % multiple
    if rem == 0:
        return x, n
    pad_n = multiple - rem
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(n - 1, n)
    pad = np.repeat(x[tuple(idx)], pad_n, axis=axis)
    return np.concatenate([x, pad], axis=axis), n


def shard_rows(batch, rank: int, world: int):
    """Rank ``rank``'s contiguous rows of a global batch (an array, a tensor,
    or a tuple of them with one leading size): ``batch_sharding`` of the JAX
    package. A batch that does not divide by ``world`` is taken whole by every
    rank, as the JAX trainer replicates it."""
    if isinstance(batch, tuple):
        return tuple(shard_rows(b, rank, world) for b in batch)
    n = len(batch)
    if world <= 1 or n % world:
        return batch
    rows = n // world
    return batch[rank * rows:(rank + 1) * rows]
