"""Spatio-Temporal DeepKriging (STDK): DK plus a 1-D temporal Wendland basis.

Counterpart of ``p2igan_tpu/models/stdk.py`` (reference
``p2igan_bench/models/stdk.py``). Per-(t, pixel) features are
``[phi_s(K_s) | phi_t(K_t) | z_seq(T*79)]`` through the shared MLP. The
reference materializes the full (B, T, HW, K_s+K_t+T*79) tensor; here the
first layer is decomposed,

    h1 = phi_s @ W_s  (pixel part, shared by all b, t)
       + phi_t @ W_t  (frame part, shared by all b, pixels)
       + z_seq @ W_z  (sample part, shared by all t, pixels)  + b1,

three small ``torch.matmul`` products plus a broadcast add, and the tail runs
through the same fused kernel pair as DK (``ops/dk_mlp_kernel.py``).
``compute_dtype`` rounds the inputs and both bases as DK does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.wendland import build_phi_space, build_phi_time, time_basis_count
from .dk import DKGenerator, _basis_tensor, round_to


class STDKGenerator(DKGenerator):
    """masked/masks: (B, T, H, W, C) -> preds (B, T, H, W, C); C must be 1."""

    def __init__(self, length: int = 16, visible_k: int = 79,
                 num_basis_space: Tuple[int, ...] = (10, 19, 37, 73),
                 num_basis_time: Tuple[int, ...] = (10, 19, 37, 73),
                 fused_tail: Optional[bool] = None, shared_batch_mask: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        self.num_basis_time = tuple(num_basis_time)
        super().__init__(length=length, visible_k=visible_k,
                         num_basis_space=num_basis_space, fused_tail=fused_tail,
                         shared_batch_mask=shared_batch_mask,
                         compute_dtype=compute_dtype, generator=generator,
                         device=device)

    def feature_dim(self) -> int:
        K_t = time_basis_count(self.length, self.num_basis_time)
        return sum(self.num_basis_space) + K_t + self.length * self.visible_k

    def forward(self, masked_frames: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        b, t, h, w, _ = masked_frames.shape
        z = self._inputs(masked_frames, masks)                       # (B, T, k)
        z_seq = z.reshape(b, t * self.visible_k)
        K_s = sum(self.num_basis_space)
        K_t = time_basis_count(self.length, self.num_basis_time)
        dev = str(masked_frames.device)
        phi_s = round_to(_basis_tensor(build_phi_space, (h, w, self.num_basis_space), dev),
                         self.compute_dtype)
        phi_t = round_to(_basis_tensor(build_phi_time, (t, self.num_basis_time), dev),
                         self.compute_dtype)
        fc1 = self._mlp.net[0]
        w_s = fc1.weight[:, :K_s].t()
        w_t = fc1.weight[:, K_s:K_s + K_t].t()
        w_z = fc1.weight[:, K_s + K_t:].t()
        phi_part = phi_s @ w_s                                       # (HW, hidden)
        offs = ((z_seq @ w_z + fc1.bias)[:, None, :]
                + (phi_t @ w_t)[None, :, :]).reshape(b * t, -1)      # (B*T, hidden)
        y = self._mlp.tail(phi_part, offs, self.fused_tail is not False)
        return y.reshape(b, t, h, w, 1).to(torch.float32)


# Reference alias (stdk.py:279)
InpaintGenerator = STDKGenerator
