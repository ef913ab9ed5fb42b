"""P2I-GAN generator and discriminator (PyTorch, NC[T]HW inside,
(B, T, H, W, C) at the API).

Counterpart of ``p2igan_tpu/models/p2igan.py`` (reference
``p2igan_bench/models/p2igan.py:72-173``). The generator, on any mask type
(stis: one frame-constant mask for the batch; sti: one per sample; stin, fi,
nowcasting: masks that vary per frame, through the generic IDW):

  flatten T into channels -> InputBlock IDW densification -> grouped 3x3
  DO-conv + repeat-interleave(4) skip -> 3x DownsampleDuplicateChannels pyramid
  -> coarse-to-fine EBlock + UPPos decoding (only the x_4 skip is additive; the
  reference overwrites the x_2 / x_ skips) -> grouped 1x1 DO-conv to t channels
  -> tanh.

Attribute names reproduce the reference state_dict keys
(``input.layers.{i}.conv``, ``Convsin.0.main.0.{W,D}``,
``Decoder.{k}.layers.{i}.main.{j}.main.0.{W,D}``, ``UP.{k}.{pos,proj}``,
``ConvsOut.0.main.0.W``), so a reference ``.pt`` loads with
``load_state_dict``. The discriminator's keys are the reference's too
(``d2d.{0,2,4,6,8}`` and ``d3d.{...}`` with ``weight_orig``/``bias``/
``weight_u``/``weight_v``, ``alpha2d``, ``alpha3d``).
"""

from __future__ import annotations

import copy
import logging
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..ops.convs import bilinear_resize
from ..ops.doconv import DOConv2d
from ..ops.layers import (AttentionBlock, BasicConvDO, InputBlock, ResBlockDO,
                          UPPos, downsample_duplicate_channels)
from ..ops.spectral_norm import SNConv


# the reduced-precision options' dtypes by name
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _data_cfg(config: Dict[str, Any]) -> Dict[str, Any]:
    return config.get("data_loader") or config["data"]["train"]


def _mask_points_budget(mask_cfg: Dict[str, Any], H: int, W: int,
                        length: int) -> int:
    """Worst-case observed-point count per sample for one mask config
    (same bounds as the JAX package)."""
    mask_type = mask_cfg.get("type", "sti")
    bs = min(mask_cfg.get("block_sizes", [4]) or [4])
    keep = min(int(mask_cfg.get("keep", 4)), length)
    per_frame_sti = (-(-H // bs) + 1) * (-(-W // bs) + 1)
    if mask_type == "sti":
        return length * per_frame_sti
    if mask_type == "stin":
        return keep * H * W + (length - keep) * per_frame_sti
    if mask_type == "fi":
        iv = min(mask_cfg.get("interval", [2, 5]) or [2])
        return (-(-length // (iv + 1))) * H * W
    if mask_type == "nowcasting":
        return keep * H * W
    if mask_type == "stis":
        # the gauge file is counted exactly so the budget never truncates; the
        # 256 fallback applies only when the file is unreadable at config time
        n_gauges = 256
        mask_file = mask_cfg.get("file")
        if mask_file:
            try:
                from ..data.masks import load_gauge_mask

                n_gauges = int((load_gauge_mask(mask_file) > 0).sum())
            except OSError:
                logging.warning(
                    "stis gauge file %s unreadable at config time; falling "
                    "back to a %d-gauge IDW budget", mask_file, n_gauges)
        return length * max(1, n_gauges)
    return length * H * W


class EBlock(nn.Module):
    """num_res x ResBlock_do (reference p2igan.py:176-183)."""

    def __init__(self, channels: int, num_res: int = 4, factored: bool = True,
                 device=None):
        super().__init__()
        self.layers = nn.Sequential(*[ResBlockDO(channels, factored=factored,
                                                 device=device)
                                      for _ in range(num_res)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x)


class P2IGenerator(nn.Module):
    """Main generator: masked/masks (B, T, H, W, C) -> preds (B, T, H, W, C).

    ``inference=True`` builds the folded serving variant (plain DO-conv
    kernels); :meth:`fold_for_inference` derives it from a trained one. The
    IDW defaults are the JAX class's: the generic IDW (``idw_factored``
    False); :meth:`from_config` picks the factored path for sti/stis masks.
    Weights are initialized from ``generator`` (a ``torch.Generator``).

    ``compute_dtype`` (JAX ``P2IGenerator.compute_dtype``; no config key, as
    in the JAX package) runs the convolution pyramid in that dtype: the
    InputBlock's densified field (the IDW kernels, float32) is cast after the
    block, every convolution's kernel (and the positional gates) is cast to
    the activation's dtype, bilinear resizes run in float32 and return the
    caller's dtype, and ``tanh`` runs on the float32 head. Parameters stay
    float32; training and the folded serving variant take it alike."""

    def __init__(self, H: int = 128, W: int = 128, length: int = 16,
                 num_res: int = 4, base_channels: int = 64, in_channels: int = 1,
                 inference: bool = False, idw_max_points: int = 2048,
                 idw_factored: bool = False, idw_shared_batch_mask: bool = False,
                 idw_k: int = 4, compute_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.H, self.W, self.length = H, W, length
        self.compute_dtype = compute_dtype
        self.num_res = num_res
        self.base_channels = base_channels
        self.in_channels = in_channels
        self.inference = inference
        self.idw_max_points = idw_max_points
        self.idw_factored = idw_factored
        self.idw_shared_batch_mask = idw_shared_batch_mask
        self.idw_k = idw_k
        tc = length * in_channels
        base = base_channels
        factored = not inference
        self.input = InputBlock(tc, depth=2, k=idw_k, rho=2.0, tau=0.05,
                                max_points=idw_max_points, factored=idw_factored,
                                shared_batch_mask=idw_shared_batch_mask,
                                frames=length, device=device)
        self.Convsin = nn.Sequential(BasicConvDO(tc, base, 3, relu=False, groups=4,
                                                 factored=factored, device=device))
        self.Decoder = nn.ModuleList(
            EBlock(base * m, num_res, factored, device=device) for m in (1, 2, 4, 8))
        self.UP = nn.ModuleList([
            UPPos(base * 2, base, H, W, device=device),
            UPPos(base * 4, base * 2, H // 2, W // 2, device=device),
            UPPos(base * 8, base * 4, H // 4, W // 4, device=device)])
        self.ConvsOut = nn.Sequential(BasicConvDO(base, tc, 1, relu=False, groups=4,
                                                  factored=factored, device=device))
        self.reset_parameters(generator)

    @classmethod
    def from_config(cls, config: Dict[str, Any], inference: bool = False,
                    **kw) -> "P2IGenerator":
        """Build from a config, sizing the static IDW point budget from every
        split's mask config (valid/test may override the train mask)."""
        data_cfg = _data_cfg(config)
        length = data_cfg.get("sample_length", 16) or 16
        model_cfg = config.get("model", {})
        mask_cfg = data_cfg.get("mask", {})
        mask_type = mask_cfg.get("type", "sti")
        H, W = data_cfg["h"], data_cfg["w"]
        n_pts = _mask_points_budget(mask_cfg, H, W, length)
        for split, split_cfg in (config.get("data") or {}).items():
            if split == "train" or not isinstance(split_cfg, dict):
                continue
            m = dict(mask_cfg)
            if "mask" in split_cfg:
                m = {} if split_cfg["mask"] is None else {**m, **split_cfg["mask"]}
            n_pts = max(n_pts, _mask_points_budget(
                m, split_cfg.get("h", H) or H, split_cfg.get("w", W) or W,
                split_cfg.get("sample_length", length) or length))
        max_points = kw.pop("idw_max_points", -(-n_pts // 128) * 128)
        factored = kw.pop("idw_factored", mask_type in ("sti", "stis"))
        shared = kw.pop("idw_shared_batch_mask", mask_type == "stis")
        return cls(H=H, W=W, length=length,
                   base_channels=model_cfg.get("base_channels", 64),
                   in_channels=model_cfg.get("in_channels", 1),
                   inference=inference, idw_max_points=max_points,
                   idw_factored=factored, idw_shared_batch_mask=shared, **kw)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Reference init, in module order, from ``generator``."""
        for m in self.modules():
            if isinstance(m, (DOConv2d, AttentionBlock, UPPos)):
                m.reset_parameters(generator)

    @torch.no_grad()
    def fold_for_inference(self) -> "P2IGenerator":
        """The serving variant: every factored DO-conv (W, D) composed into its
        plain kernel once, instead of in every forward."""
        folded = copy.deepcopy(self)
        folded.inference = True
        for parent in folded.modules():
            for name, child in list(parent.named_children()):
                if isinstance(child, DOConv2d) and child.factored:
                    setattr(parent, name, child.folded())
        return folded

    def prepare_idw(self, mask_xy: torch.Tensor):
        """Gauge selection of the factored shared-mask IDW for an (H, W) mask,
        computed once and passed to ``forward(..., idw_prepared=...)``. gd2 and
        gsel (HW, k) are laid out as the combine kernels take them, (k, HW)
        row-major, so that no forward copies them again."""
        from ..ops.idw import factored_prepare_full

        max_gauges = InputBlock.gauge_budget(self.idw_max_points, self.length)
        n_obs = int((mask_xy > 0).sum())
        if n_obs > max_gauges:
            raise ValueError(
                f"mask has {n_obs} observed gauges but the IDW budget allows "
                f"{max_gauges} (idw_max_points={self.idw_max_points}, "
                f"length={self.length}); raise idw_max_points or fix the mask "
                f"config")
        gd2, gsel, gauge_pix = factored_prepare_full(mask_xy, max_gauges, k=self.idw_k)
        return gd2.t().contiguous().t(), gsel.t().contiguous().t(), gauge_pix

    def forward(self, masked_frames: torch.Tensor, masks: torch.Tensor,
                idw_prepared=None) -> torch.Tensor:
        b, t, h, w, c = masked_frames.shape
        # (B,T,H,W,C) -> (B,T*C,H,W), channel = t*C + c (torch c*t order)
        x_in = masked_frames.permute(0, 1, 4, 2, 3).reshape(b, t * c, h, w)
        m_in = masks.permute(0, 1, 4, 2, 3).reshape(b, t * c, h, w)

        x = self.input(x_in, m_in, prepared=idw_prepared).to(self.compute_dtype)
        x_ = self.Convsin(x) + x.repeat_interleave(4, dim=1)
        x_2 = downsample_duplicate_channels(x_, t)
        x_4 = downsample_duplicate_channels(x_2, t)
        x_8 = downsample_duplicate_channels(x_4, t)

        res1 = self.UP[2](self.Decoder[3](x_8))
        res2 = self.UP[1](self.Decoder[2](x_4 + res1))
        res3 = self.UP[0](self.Decoder[1](res2))
        z = self.ConvsOut(self.Decoder[0](res3))
        out = torch.tanh(z.to(torch.float32))
        return out.reshape(b, t, c, h, w).permute(0, 1, 3, 4, 2)


class P2IDiscriminator(nn.Module):
    """Dual-branch (2-D over the frame sequence, 3-D spatiotemporal)
    spectral-norm critic: x (B, T, H, W, C) -> logits (B, N).

    ``in_channels`` is C*T (the 2-D branch's input width), ``channels`` C.
    ``update_stats=True`` advances every layer's power iteration (training
    forwards). ``alpha3d`` exists in the reference but is unused.

    ``branch3d_dtype`` (JAX ``P2IDiscriminator.branch3d_dtype``, config key
    ``model.disc_branch3d_dtype``) runs the 3-D branch in that dtype: its
    input is cast, the spectral norm keeps sigma in float32 and casts the
    kernel (``ops/spectral_norm.py``), and the branch's output is cast back to
    float32 before the mean over frames, so the fused logits stay float32.
    Parameters, gradients and optimizer state stay float32."""

    def __init__(self, in_channels: int = 16, channels: int = 1,
                 branch3d_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.branch3d_dtype = branch3d_dtype
        lrelu = lambda: nn.LeakyReLU(0.2)  # noqa: E731
        self.d2d = nn.Sequential(
            SNConv(in_channels, 64, (3, 3), 1, 1, device=device), lrelu(),
            SNConv(64, 128, (3, 3), 2, 1, device=device), lrelu(),
            SNConv(128, 256, (3, 3), 2, 1, device=device), lrelu(),
            SNConv(256, 256, (3, 3), 1, 1, device=device), lrelu(),
            SNConv(256, 1, (3, 3), 1, 1, device=device))
        self.d3d = nn.Sequential(
            SNConv(channels, 32, (3, 3, 3), (1, 2, 2), 1, device=device), lrelu(),
            SNConv(32, 64, (3, 3, 3), (1, 2, 2), 1, device=device), lrelu(),
            SNConv(64, 128, (3, 3, 3), (1, 2, 2), 1, device=device), lrelu(),
            SNConv(128, 128, (3, 3, 3), (2, 1, 1), 1, device=device), lrelu(),
            SNConv(128, 1, (1, 1, 1), 1, 0, device=device))
        self.alpha2d = nn.Parameter(torch.zeros((), device=device))
        self.alpha3d = nn.Parameter(torch.zeros((), device=device))
        self.reset_parameters(generator)

    @classmethod
    def from_config(cls, config: Dict[str, Any], **kw) -> "P2IDiscriminator":
        """The 2-D branch takes in_channels * sample_length channels;
        ``model.disc_branch3d_dtype`` ("float32", the default, or "bfloat16")
        sets the 3-D branch's dtype, any other value raises."""
        model_cfg = config.get("model", {})
        length = _data_cfg(config).get("sample_length", 16) or 16
        c = model_cfg.get("in_channels", 1)
        d3d = str(model_cfg.get("disc_branch3d_dtype", "float32"))
        if d3d not in COMPUTE_DTYPES:
            raise ValueError(f"model.disc_branch3d_dtype={d3d!r}: expected one of "
                             f"{sorted(COMPUTE_DTYPES)}")
        return cls(in_channels=c * length, channels=c,
                   branch3d_dtype=COMPUTE_DTYPES[d3d], **kw)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Reference init (P2IDiscriminator.init_weights), in module order."""
        for m in self.modules():
            if isinstance(m, SNConv):
                m.reset_parameters(generator)
        self.alpha2d.zero_()
        self.alpha3d.zero_()

    @staticmethod
    def _branch(layers: nn.Sequential, x: torch.Tensor,
                update_stats: bool) -> torch.Tensor:
        for layer in layers:
            x = layer(x, update_stats) if isinstance(layer, SNConv) else layer(x)
        return x

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        b, t, h, w, c = x.shape
        # 2-D branch over (B, T*C, H, W), channel = t*C + c
        y = x.permute(0, 1, 4, 2, 3).reshape(b, t * c, h, w)
        out2d = self._branch(self.d2d, y, update_stats)           # (B, 1, h', w')
        # 3-D branch over (B, C, T, H, W), mean over the remaining frames
        z = self._branch(self.d3d, x.permute(0, 4, 1, 2, 3).to(self.branch3d_dtype),
                         update_stats)
        out3d = z.to(torch.float32).mean(dim=2)                   # (B, 1, h'', w'')
        if out3d.shape[-2:] != out2d.shape[-2:]:
            out3d = bilinear_resize(out3d, out2d.shape[-2:], align_corners=False)
        fused = torch.sigmoid(self.alpha2d) * out2d + out3d
        return fused.reshape(b, -1)
