"""Model registry of the port (the p2igan family only, so far)."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .p2igan import P2IDiscriminator, P2IGenerator


def _require_p2igan(cfg: Dict[str, Any]) -> None:
    name = str(cfg.get("model", {}).get("name", "simple")).lower()
    if name != "p2igan":
        raise NotImplementedError(
            f"model {name!r} is not ported to PyTorch yet; only p2igan is")


def build_generator(cfg: Dict[str, Any], device=None,
                    generator: Optional[torch.Generator] = None) -> P2IGenerator:
    """The training generator, keyed by ``model.name`` (reference
    models/__init__.py): the generator with factored (unfolded) DO-convs."""
    _require_p2igan(cfg)
    return P2IGenerator.from_config(cfg, device=device, generator=generator)


def build_generator_for_inference(cfg: Dict[str, Any], device=None,
                                  generator: Optional[torch.Generator] = None
                                  ) -> P2IGenerator:
    """Inference-time builder keyed by ``model.name`` like the JAX package's
    (reference scripts/infer.py:83-106); only p2igan is ported."""
    return build_generator(cfg, device=device, generator=generator)


def build_discriminator(cfg: Dict[str, Any], device=None,
                        generator: Optional[torch.Generator] = None
                        ) -> P2IDiscriminator:
    """The P2I discriminator; its 2-D branch takes in_channels * sample_length
    channels. ``model.disc_branch3d_dtype`` (a bf16 3-D branch in the JAX
    package) is not ported: anything but float32 raises."""
    _require_p2igan(cfg)
    d3d = str(cfg.get("model", {}).get("disc_branch3d_dtype", "float32"))
    if d3d != "float32":
        raise NotImplementedError(
            f"disc_branch3d_dtype={d3d!r} is not ported; the port's "
            f"discriminator runs in float32")
    return P2IDiscriminator.from_config(cfg, device=device, generator=generator)


__all__ = ["P2IGenerator", "P2IDiscriminator", "build_generator",
           "build_generator_for_inference", "build_discriminator"]
