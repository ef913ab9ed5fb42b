"""Simple 3-D conv encoder/decoder baseline and its critic (PyTorch).

Counterpart of ``p2igan_tpu/models/simple.py`` (reference ``models/simple.py``).
Module and attribute names give the reference state-dict keys, so a reference
``.pt`` loads with plain ``load_state_dict``:
``encoder.{0,1,2}.0.{weight,bias}`` (Conv3d),
``encoder.{i}.1.{weight,bias,running_mean,running_var}`` (BatchNorm3d; a
``num_batches_tracked`` entry is accepted and ignored, the update below does
not use it) and ``decoder.{0,2,4}.{weight,bias}``.

The modules take and return (B, T, H, W, C) and compute channels-first
(B, C, T, H, W), cuDNN's layout. Training and the unfolded forward are plain
cuDNN convolutions. ``fold_for_inference`` returns the serving module: each
encoder block's BatchNorm folded into its convolution, enc0 through
``ops/enc0_conv.py`` and dec2 through ``ops/dec2_stencil.py`` (hand-written
kernels on the card, their plain versions on the CPU). The JAX package's
``_conv3d_im2col`` and ``_dec2_smatrix`` are MXU reformulations of the same
convolutions and are not carried over: the unfused alternative here is
``F.conv3d``.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.convs import conv3d
from ..ops.dec2_stencil import conv3d_cout1_sigmoid
from ..ops.enc0_conv import MAX_CIN, enc0_conv3d_leaky

# dec2 through the fused kernel in serving unless a model says otherwise
# (``dec2_fused``); chosen by measurement on the H100, see PERF.md.
DEC2_FUSED_DEFAULT = True


@torch.no_grad()
def _init_uniform_fan_in(module: nn.Module, fan_in: int,
                         generator: Optional[torch.Generator]) -> None:
    """The JAX package's ``_torch_conv_init``: weight U(+-1/sqrt(fan_in)) from
    the explicit generator, bias zero."""
    bound = 1.0 / math.sqrt(fan_in)
    w = torch.rand(module.weight.shape, generator=generator) * (2 * bound) - bound
    module.weight.copy_(w)
    module.bias.zero_()


class BatchNorm(nn.Module):
    """BatchNorm over (B, C, ...) with flax's running-statistics update:
    ``running = 0.9 * running + 0.1 * batch`` with the **biased** batch
    variance (``nn.BatchNorm3d`` stores the unbiased one). The normalisation
    itself, and its gradient, are ``F.batch_norm``'s.

    ``mesh`` (set by the train step of a data-parallel run over several
    ranks): training-mode statistics are the global batch's, as under the
    JAX package's ``pjit``, and the running statistics advance by the global
    mean and biased variance (``DataMesh.batch_norm``)."""

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5,
                 device=None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean", torch.zeros(num_features, device=device))
        self.register_buffer("running_var", torch.ones(num_features, device=device))
        self.mesh = None

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        if self.mesh is not None:
            y, mean, var = self.mesh.batch_norm(x, self.weight, self.bias, self.eps)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            return y
        # momentum 1 leaves the batch mean and the unbiased batch variance in
        # the two scratch buffers, without another pass over x
        mean, var = torch.zeros_like(self.running_mean), torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m * (n - 1) / n)
        return y


class Conv3dBlock(nn.Sequential):
    """Conv3d -> BatchNorm3d -> LeakyReLU(0.2) (reference simple.py:7-13) on
    (B, C, T, H, W). ``train`` selects batch statistics (and advances the
    running ones); ``None`` follows the module's ``training`` flag."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(nn.Conv3d(cin, cout, 3, stride=stride, padding=1, device=device),
                         BatchNorm(cout, device=device), nn.LeakyReLU(0.2))
        _init_uniform_fan_in(self[0], 27 * cin, generator)

    def forward(self, x: torch.Tensor, train: Optional[bool] = None) -> torch.Tensor:
        train = self.training if train is None else train
        return self[2](self[1](self[0](x), train))

    @torch.no_grad()
    def folded(self) -> "FoldedConv3dBlock":
        """Serving form: ``bn(conv(x) + b) == conv(x; W * s) + ((b - mean) * s
        + beta)`` with ``s = gamma / sqrt(var + eps)`` from the running
        statistics."""
        conv, bn = self[0], self[1]
        s = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        return FoldedConv3dBlock(conv.weight * s[:, None, None, None, None],
                                 (conv.bias - bn.running_mean) * s + bn.bias,
                                 conv.stride[0])


class FoldedConv3dBlock(nn.Module):
    """Conv3d -> LeakyReLU(0.2) with the BatchNorm folded into the weights."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor, stride: int):
        super().__init__()
        self.weight = nn.Parameter(weight.detach().clone())
        self.bias = nn.Parameter(bias.detach().clone())
        self.stride = int(stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(conv3d(x, self.weight, stride=self.stride, padding=1,
                                   bias=self.bias), 0.2)


class SimpleGenerator(nn.Module):
    """masked/masks: (B, T, H, W, C) -> (B, T, H, W, C) in [0, 1].

    ``dec2_fused`` (serving only, counterpart of the JAX ``dec2_pallas``):
    ``None`` takes :data:`DEC2_FUSED_DEFAULT`, ``True`` / ``False`` route the
    last layer through the fused kernel / through ``F.conv3d`` + sigmoid."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 base_channels: int = 64, dec2_fused: Optional[bool] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        hidden = base_channels
        self.in_channels, self.out_channels, self.base_channels = (
            in_channels, out_channels, base_channels)
        self.dec2_fused = dec2_fused
        self.serving = False
        self.encoder = nn.Sequential(
            Conv3dBlock(in_channels * 2, hidden, generator=generator, device=device),
            Conv3dBlock(hidden, hidden * 2, stride=2, generator=generator, device=device),
            Conv3dBlock(hidden * 2, hidden * 4, stride=2, generator=generator, device=device))
        self.decoder = nn.Sequential(
            nn.ConvTranspose3d(hidden * 4, hidden * 2, 2, stride=2, device=device), nn.ReLU(),
            nn.ConvTranspose3d(hidden * 2, hidden, 2, stride=2, device=device), nn.ReLU(),
            nn.Conv3d(hidden, out_channels, 3, padding=1, device=device), nn.Sigmoid())
        _init_uniform_fan_in(self.decoder[0], 8 * hidden * 2, generator)
        _init_uniform_fan_in(self.decoder[2], 8 * hidden, generator)
        _init_uniform_fan_in(self.decoder[4], 27 * hidden, generator)

    @classmethod
    def from_config(cls, config: Dict[str, Any], **kw) -> "SimpleGenerator":
        model_cfg = config.get("model", {})
        in_channels = model_cfg.get("in_channels", 1)
        kw.setdefault("dec2_fused", model_cfg.get("dec2_fused"))
        return cls(in_channels=in_channels,
                   out_channels=model_cfg.get("out_channels", in_channels),
                   base_channels=model_cfg.get("base_channels", 64), **kw)

    def fold_for_inference(self) -> "SimpleGenerator":
        """The serving variant (same protocol as ``P2IGenerator``): a copy in
        eval mode whose encoder blocks carry their BatchNorm folded into the
        convolution, with enc0 and (by ``dec2_fused``) dec2 through the fused
        ops. Reassociates one multiply a tap (parity rtol 1e-5)."""
        folded = copy.deepcopy(self)
        for i, block in enumerate(folded.encoder):
            folded.encoder[i] = block.folded()
        folded.serving = True
        return folded.eval()

    def _serve(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, T, H, W, 2C) -> (B, T, H, W, C_out), folded weights."""
        enc0 = self.encoder[0]
        if enc0.stride == 1 and x.shape[-1] <= MAX_CIN:
            y = enc0_conv3d_leaky(x, enc0.weight.permute(2, 3, 4, 1, 0), enc0.bias,
                                  0.2).permute(0, 4, 1, 2, 3)
        else:
            y = enc0(x.permute(0, 4, 1, 2, 3))
        y = self.encoder[2](self.encoder[1](y))
        y = self.decoder[3](self.decoder[2](self.decoder[1](self.decoder[0](y))))
        dec2 = self.decoder[4]
        fused = DEC2_FUSED_DEFAULT if self.dec2_fused is None else self.dec2_fused
        if fused and self.out_channels == 1:
            return conv3d_cout1_sigmoid(y.permute(0, 2, 3, 4, 1),
                                        dec2.weight.permute(2, 3, 4, 1, 0), dec2.bias)
        return self.decoder[5](dec2(y)).permute(0, 2, 3, 4, 1)

    def forward(self, masked_video: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        x = torch.cat([masked_video, masks.to(masked_video.dtype)], dim=-1)
        if self.serving:
            return self._serve(x)
        y = self.encoder(x.permute(0, 4, 1, 2, 3).contiguous())
        return self.decoder(y).permute(0, 2, 3, 4, 1)


class SimpleDiscriminator(nn.Module):
    """3-D conv stack + global-average-pool linear head (reference
    simple.py:49-69): (B, T, H, W, C) -> (B, 1) logits.

    ``update_stats`` is what the train step passes to every discriminator: for
    this BatchNorm critic it selects batch statistics and advances the running
    ones (the JAX package's ``train=True`` with mutable ``batch_stats``); off,
    the running statistics normalise."""

    def __init__(self, in_channels: int = 1, base_channels: int = 64,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        hidden = base_channels
        self.features = nn.Sequential(
            Conv3dBlock(in_channels, hidden, stride=2, generator=generator, device=device),
            Conv3dBlock(hidden, hidden * 2, stride=2, generator=generator, device=device),
            Conv3dBlock(hidden * 2, hidden * 4, stride=2, generator=generator, device=device))
        self.head = nn.Linear(hidden * 4, 1, device=device)
        _init_uniform_fan_in(self.head, hidden * 4, generator)

    @classmethod
    def from_config(cls, config: Dict[str, Any], **kw) -> "SimpleDiscriminator":
        model_cfg = config.get("model", {})
        return cls(in_channels=model_cfg.get("in_channels", 1),
                   base_channels=model_cfg.get("base_channels", 64), **kw)

    def forward(self, video: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        x = video.permute(0, 4, 1, 2, 3).contiguous()
        for block in self.features:
            x = block(x, train=update_stats)
        return self.head(x.mean(dim=(2, 3, 4)))  # AdaptiveAvgPool3d(1) + flatten
