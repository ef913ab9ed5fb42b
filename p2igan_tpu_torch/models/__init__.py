"""Model registry of the port, keyed like the JAX package's
(``p2igan_tpu/models/__init__.py``): ``model.name`` in {p2igan, dk, stdk,
simple}; a missing name means simple, and every family but p2igan trains
against the simple critic under ``use_gan``."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from .dk import DKGenerator, DKMLP  # noqa: F401
from .p2igan import P2IDiscriminator, P2IGenerator
from .simple import SimpleDiscriminator, SimpleGenerator
from .stdk import STDKGenerator

_DK_FAMILY = {"dk": DKGenerator, "stdk": STDKGenerator}


def _model_name(cfg: Dict[str, Any]) -> str:
    """Any name but p2igan, dk and stdk builds the simple family, as in the
    JAX registry."""
    name = str(cfg.get("model", {}).get("name", "simple")).lower()
    return name if name in ("p2igan", *_DK_FAMILY) else "simple"


def build_generator(cfg: Dict[str, Any], device=None,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
    """The training generator, keyed by ``model.name`` (reference
    models/__init__.py): p2igan with factored (unfolded) DO-convs; dk/stdk
    take ``sample_length`` from ``data_loader`` or ``data.train``; simple
    takes its channel counts (and ``dec2_fused``) from ``model``."""
    name = _model_name(cfg)
    if name in _DK_FAMILY:
        return _DK_FAMILY[name].from_config(cfg, device=device, generator=generator)
    klass = P2IGenerator if name == "p2igan" else SimpleGenerator
    return klass.from_config(cfg, device=device, generator=generator)


def build_generator_for_inference(cfg: Dict[str, Any], device=None,
                                  generator: Optional[torch.Generator] = None
                                  ) -> nn.Module:
    """The serving generator (reference scripts/infer.py:83-106): dk/stdk take
    the test ``sample_length``, falling back to train, then 16."""
    name = _model_name(cfg)
    if name not in _DK_FAMILY:
        return build_generator(cfg, device=device, generator=generator)
    data_cfg = cfg.get("data", {})
    test_cfg = data_cfg.get("test", {})
    sample_length = (test_cfg.get("sample_length")
                     or data_cfg.get("train", {}).get("sample_length") or 16)
    # shared_batch_mask follows the mask the SERVING data uses: the test
    # split's (train-inherited unless overridden; explicit null deletes)
    mask_cfg = (test_cfg["mask"] if "mask" in test_cfg
                else data_cfg.get("train", {}).get("mask"))
    return _DK_FAMILY[name].from_config(
        cfg, length=sample_length,
        shared_batch_mask=(mask_cfg or {}).get("type") == "stis",
        device=device, generator=generator)


def build_discriminator(cfg: Dict[str, Any], device=None,
                        generator: Optional[torch.Generator] = None
                        ) -> nn.Module:
    """p2igan: the P2I discriminator, whose 2-D branch takes in_channels *
    sample_length channels and whose 3-D branch runs in
    ``model.disc_branch3d_dtype`` ("float32" or "bfloat16"; any other value
    raises). Every other family (simple, dk, stdk): the simple BatchNorm
    critic."""
    klass = P2IDiscriminator if _model_name(cfg) == "p2igan" else SimpleDiscriminator
    return klass.from_config(cfg, device=device, generator=generator)


__all__ = ["P2IGenerator", "P2IDiscriminator", "DKGenerator", "STDKGenerator",
           "SimpleGenerator", "SimpleDiscriminator",
           "build_generator", "build_generator_for_inference", "build_discriminator"]
