"""Checkpoint save, load and resolution for the port.

``save_checkpoint`` / ``load_checkpoint_raw`` follow
``p2igan_tpu/training/checkpoint.py`` with the JAX trainer's payload keys
(``epoch``, ``global_step``, ``best_val``, ``generator{params,extra}``,
``optimizer_g``, ``discriminator{params,extra}``, ``optimizer_d``) in torch's
format (``torch.save``; loaded with ``weights_only=True``). ``params`` holds
what the optimizer updates, ``extra`` the module's buffers (BatchNorm running
statistics of the simple family, spectral-norm vectors). JAX msgpack
checkpoints do not load: they raise and name the conversion.
``resolve_checkpoint`` follows the JAX package (explicit path, else
``latest.ckpt``, else the newest ``*.ckpt``/``*.msgpack``/``*.pt`` under the
directory; reference scripts/infer.py:61-80).
"""

from __future__ import annotations

import logging
import os
import zipfile
from pathlib import Path
from typing import Any, Dict, Optional

import torch

_MSGPACK_HINT = ("the PyTorch port loads torch-format checkpoints only. A JAX "
                 "msgpack checkpoint can be converted on a host with flax: "
                 "restore it with p2igan_tpu.training.checkpoint.load_checkpoint_raw, "
                 "then p2igan_tpu_torch.models.convert.state_dict_from_jax, then "
                 "torch.save")


def save_checkpoint(path: str | Path, payload: Dict[str, Any]) -> None:
    """torch.save ``payload`` to ``path`` atomically (write, then rename)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + f".{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint_raw(path: str | Path) -> Dict[str, Any]:
    """The payload of a torch-format checkpoint, on the CPU."""
    path = Path(path)
    if not zipfile.is_zipfile(path):
        raise NotImplementedError(f"{path}: {_MSGPACK_HINT}")
    return torch.load(str(path), map_location="cpu", weights_only=True)


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
    """Generator state_dict from a torch checkpoint: a bare state_dict, the
    reference trainer's dict with a ``generator`` entry, or the port's
    trainer payload (``generator.params``)."""
    path = Path(path)
    if path.suffix != ".pt" and not zipfile.is_zipfile(path):
        raise NotImplementedError(f"{path}: {_MSGPACK_HINT}")
    ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "generator" in ckpt:
        ckpt = ckpt["generator"]
        if isinstance(ckpt, dict) and set(ckpt) == {"params", "extra"}:
            ckpt = {**ckpt["params"], **ckpt["extra"]}
    return ckpt
