"""Model registry of the port (the p2igan family only, so far)."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .p2igan import P2IGenerator


def build_generator_for_inference(cfg: Dict[str, Any], device=None,
                                  generator: Optional[torch.Generator] = None
                                  ) -> P2IGenerator:
    """Inference-time builder keyed by ``model.name`` like the JAX package's
    (reference scripts/infer.py:83-106); only p2igan is ported."""
    name = str(cfg.get("model", {}).get("name", "simple")).lower()
    if name != "p2igan":
        raise NotImplementedError(
            f"model {name!r} is not ported to PyTorch yet; only p2igan is")
    return P2IGenerator.from_config(cfg, device=device, generator=generator)


__all__ = ["P2IGenerator", "build_generator_for_inference"]
