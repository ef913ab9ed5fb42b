"""Checkpoint resolution and loading for the port.

``resolve_checkpoint`` follows ``p2igan_tpu/training/checkpoint.py`` (explicit
path, else ``latest.ckpt``, else the newest ``*.ckpt``/``*.msgpack``/``*.pt``
under the directory; reference scripts/infer.py:61-80). Torch ``.pt`` files
load with ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional

import torch


def resolve_checkpoint(save_dir: str | Path,
                       explicit: Optional[str | Path] = None) -> Path:
    if explicit:
        p = Path(explicit)
        if not p.exists():
            raise FileNotFoundError(p)
        return p
    base = Path(save_dir)
    if base.is_file():
        return base
    latest = base / "latest.ckpt"
    if latest.exists():
        return latest
    if base.exists():
        candidates = sorted(
            list(base.glob("*.ckpt")) + list(base.glob("*.msgpack")) + list(base.glob("*.pt")),
            key=lambda p: p.stat().st_mtime, reverse=True)
        if candidates:
            logging.warning("latest.ckpt not found, falling back to %s", candidates[0])
            return candidates[0]
    raise FileNotFoundError(f"Checkpoint not found under {base}")


def load_generator_state(path: str | Path) -> Dict[str, torch.Tensor]:
    """Generator state_dict from a torch ``.pt`` (a bare state_dict or the
    reference trainer's dict with a ``generator`` entry)."""
    path = Path(path)
    if path.suffix != ".pt":
        raise NotImplementedError(
            f"{path}: the PyTorch port loads torch .pt checkpoints only. A JAX "
            f"msgpack checkpoint can be converted on a host with flax: "
            f"restore it with p2igan_tpu.training.checkpoint.load_checkpoint_raw, "
            f"then p2igan_tpu_torch.models.convert.state_dict_from_jax, then "
            f"torch.save")
    ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "generator" in ckpt:
        ckpt = ckpt["generator"]
    return ckpt
