"""DeepKriging (DK) baseline: per-frame spatial Wendland-basis MLP (PyTorch).

Counterpart of ``p2igan_tpu/models/dk.py`` (reference
``p2igan_bench/models/dk.py``). The reference materializes per-pixel feature
vectors ``[phi_s | z_t]`` (B*HW, K_s+79) and loops frames in Python. Here the
first MLP layer is split algebraically,

    feats @ W1 = phi_s @ W1_s + z_t @ W1_z,

so the (HW, K_s) basis product is computed once per call with
``torch.matmul``, nothing of size (B*T*HW, K_s+79) is ever materialized, and
the remaining 100-100-100-1 tail runs for all (b, t) at once through
:func:`~p2igan_tpu_torch.ops.dk_mlp_kernel.mlp_tail_fused`: a hand-written
CUDA kernel pair for CUDA tensors, the plain chunked version for CPU tensors.

Parameters keep the reference state_dict names ``_mlp.net.{0,2,4,6}.{weight,
bias}`` in torch's ``(out, in)`` layout, so reference checkpoints load as
they are.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.dk_mlp_kernel import mlp_tail_fused, mlp_tail_reference
from ..ops.wendland import build_phi_space


def resolve_sample_length(config, length=None) -> int:
    """Shared dk/stdk config resolution (reference dk.py:148, stdk.py:111):
    data_loader (legacy) or data.train sample_length, default 16."""
    if length is not None:
        return int(length)
    data_cfg = config.get("data_loader") or config.get("data", {}).get("train", {})
    return int(data_cfg.get("sample_length", 16) or 16)


def _train_mask_is_stis(config) -> bool:
    """stis masks come from ONE fixed gauge file, so every (b, t) shares the
    spatial pattern and the shared_batch_mask path applies by construction.
    Other mask families draw per item."""
    data_cfg = config.get("data_loader") or config.get("data", {}).get("train", {})
    return (data_cfg.get("mask") or {}).get("type") == "stis"


@functools.lru_cache(maxsize=16)
def _basis_tensor(make, args: tuple, device: str) -> torch.Tensor:
    """A cached Wendland basis on ``device`` (a forward pays no host copy).
    Made outside inference mode: the first call may be a serving one, and a
    tensor created under ``torch.inference_mode`` cannot enter the autograd
    graph of a later training step in the same process."""
    with torch.inference_mode(False):
        return torch.from_numpy(make(*args)).to(device)


class DKMLP(nn.Module):
    """Shared 100-100-100-1 MLP (reference dk.py:10-24). The generators slice
    the first layer's weight by feature block and run layers 2..4 fused.

    Init is the reference's ``init_weights``: every Linear weight kaiming
    normal (a=0, fan_in), std sqrt(2 / fan_in), every bias zero, drawn from an
    explicit ``torch.Generator``."""

    def __init__(self, feature_dim: int, hidden_dim: int = 100, out_dim: int = 1,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.feature_dim, self.hidden_dim, self.out_dim = feature_dim, hidden_dim, out_dim
        self.net = nn.Sequential(
            nn.Linear(feature_dim, hidden_dim, device=device), nn.ReLU(),
            nn.Linear(hidden_dim, hidden_dim, device=device), nn.ReLU(),
            nn.Linear(hidden_dim, hidden_dim, device=device), nn.ReLU(),
            nn.Linear(hidden_dim, out_dim, device=device))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for m in self.net:
            if isinstance(m, nn.Linear):
                std = math.sqrt(2.0 / m.in_features)
                w = torch.randn(m.weight.shape, generator=generator) * std
                m.weight.copy_(w)
                m.bias.zero_()

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return self.net(feats)

    def tail(self, phi_part: torch.Tensor, offsets: torch.Tensor,
             fused: bool) -> torch.Tensor:
        """Layers 2..4 on ``relu(phi_part[p] + offsets[j])``: (HW, hidden),
        (J, hidden) -> (J, HW). ``fused`` takes :func:`mlp_tail_fused` (the
        kernels on CUDA tensors, the plain version on CPU tensors), else the
        plain version wherever the tensors lie."""
        if self.out_dim != 1:
            raise ValueError("the fused tail needs out_dim == 1")
        fn = mlp_tail_fused if fused else mlp_tail_reference
        l2, l3, l4 = self.net[2], self.net[4], self.net[6]
        return fn(phi_part, offsets, l2.weight.t(), l2.bias, l3.weight.t(),
                  l3.bias, l4.weight[0], l4.bias[0])


def select_visible(x_flat: torch.Tensor, m_flat: torch.Tensor, k: int,
                   shared_batch_mask: bool = False) -> torch.Tensor:
    """Gather the k visible pixel values per (b, t) from the mask's top-k.

    Reference dk.py:167-170 uses torch.topk(mask, k, sorted=False): on a 0/1
    mask with >= k ones the selected set is the k observed pixels, in an
    order torch leaves unspecified. The order here is the JAX package's
    (``jax.lax.top_k``): descending mask value, lowest pixel index first among
    equals, so the first k ones in ascending index and, where fewer than k
    exist, the lowest-index zeros after them. A stable descending sort gives
    exactly that. x_flat/m_flat: (B, T, HW) -> (B, T, k); the indices carry no
    gradient.

    ``shared_batch_mask=True`` declares the mask identical across (b, t) (the
    stis gauge workload, a fixed station set), so one selection over
    ``m_flat[0, 0]`` replaces the (B, T, HW) one."""
    if shared_batch_mask:
        idx = torch.sort(m_flat[0, 0].detach(), descending=True, stable=True).indices[:k]
        return x_flat.index_select(2, idx)
    idx = torch.sort(m_flat.detach(), dim=2, descending=True, stable=True).indices[..., :k]
    return torch.gather(x_flat, 2, idx)


def round_to(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` and back to float32: the JAX generators cast
    their inputs to ``compute_dtype`` and a product with the float32 weights
    promotes back to float32; torch does not promote mixed matmuls, so the
    port rounds where JAX casts."""
    return t if dtype == torch.float32 else t.to(dtype).to(torch.float32)


class DKGenerator(nn.Module):
    """masked/masks: (B, T, H, W, C) -> preds (B, T, H, W, C); C must be 1.

    ``fused_tail``: ``None`` or ``True`` run the tail through
    :func:`mlp_tail_fused` (kernels on the card, plain version on the CPU);
    ``False`` runs the plain version on either device (the comparison path).

    ``compute_dtype`` (JAX ``DKGenerator.compute_dtype``): the masked frames
    and the Wendland basis are rounded to it (:func:`round_to`); the weights,
    the products and the tail's operands stay float32.
    """

    def __init__(self, length: int = 16, visible_k: int = 79,
                 num_basis_space: Tuple[int, ...] = (10, 19, 37, 73),
                 fused_tail: Optional[bool] = None, shared_batch_mask: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.length = int(length)
        self.visible_k = int(visible_k)
        self.num_basis_space = tuple(num_basis_space)
        self.fused_tail = fused_tail
        self.shared_batch_mask = bool(shared_batch_mask)
        self._mlp = DKMLP(self.feature_dim(), generator=generator, device=device)

    def feature_dim(self) -> int:
        return sum(self.num_basis_space) + self.visible_k

    @classmethod
    def from_config(cls, config: Dict[str, Any], length: Optional[int] = None, **kw):
        kw.setdefault("shared_batch_mask", _train_mask_is_stis(config))
        return cls(length=resolve_sample_length(config, length), **kw)

    def fold_for_inference(self):
        """Serving hook (same protocol as P2IGenerator.fold_for_inference):
        switch the fused tail on; the weights are unchanged."""
        self.fused_tail = True
        return self

    def _inputs(self, masked_frames: torch.Tensor, masks: torch.Tensor):
        """Shape checks, then z (B, T, k): the k visible values per (b, t)."""
        b, t, h, w, c = masked_frames.shape
        if t != self.length:
            raise ValueError(f"expected T == {self.length}, got {t}")
        if c != 1:
            # the reference's view(b, t, HW) only admits C == 1; dropping
            # extra channels silently would train on a wrong objective
            raise ValueError(f"DK/STDK expect single-channel frames, got C={c}")
        x_flat = round_to(masked_frames[..., 0].reshape(b, t, h * w).to(torch.float32),
                          self.compute_dtype)
        m_flat = masks[..., 0].reshape(b, t, h * w).to(torch.float32)
        return select_visible(x_flat, m_flat, self.visible_k, self.shared_batch_mask)

    def forward(self, masked_frames: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        b, t, h, w, _ = masked_frames.shape
        z = self._inputs(masked_frames, masks)                       # (B, T, k)
        K_s = sum(self.num_basis_space)
        phi_s = round_to(_basis_tensor(build_phi_space, (h, w, self.num_basis_space),
                                       str(masked_frames.device)),
                         self.compute_dtype)                         # (HW, K_s)
        fc1 = self._mlp.net[0]
        w1_s = fc1.weight[:, :K_s].t()                               # (K_s, hidden)
        w1_z = fc1.weight[:, K_s:].t()                               # (k, hidden)
        phi_part = phi_s @ w1_s                                      # (HW, hidden)
        offs = z.reshape(b * t, self.visible_k) @ w1_z + fc1.bias    # (B*T, hidden)
        y = self._mlp.tail(phi_part, offs, self.fused_tail is not False)
        return y.reshape(b, t, h, w, 1).to(torch.float32)
