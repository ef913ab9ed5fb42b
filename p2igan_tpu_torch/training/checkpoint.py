"""Checkpoint save, load and resolution for the port.

``save_checkpoint`` / ``load_checkpoint_raw`` follow
``p2igan_tpu/training/checkpoint.py`` with the JAX trainer's payload keys
(``epoch``, ``global_step``, ``best_val``, ``generator{params,extra}``,
``optimizer_g``, ``discriminator{params,extra}``, ``optimizer_d``) in torch's
format (``torch.save``; loaded with ``weights_only=True``). ``params`` holds
what the optimizer updates, ``extra`` the module's buffers (BatchNorm running
statistics of the simple family, spectral-norm vectors).

JAX checkpoints load too: a file that is not a zip archive is read as the
flax msgpack the JAX trainer writes, decoded without flax or msgpack
(``utils/flax_msgpack.py``); its tree is the JAX payload, in the JAX layouts,
which ``models/convert.py`` takes to the port's (``trainer_payload_from_jax``
for resume, ``module_state_from_jax`` for serving).
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

from ..utils import flax_msgpack

_FORMAT_HINT = ("neither a torch checkpoint (a zip archive) nor a JAX trainer "
                "checkpoint (flax msgpack)")


def save_checkpoint(path: str | Path, payload: Dict[str, Any]) -> None:
    """torch.save ``payload`` to ``path`` atomically (write, then rename)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + f".{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)


def is_jax_checkpoint(path: str | Path) -> bool:
    """Whether ``path`` holds a JAX trainer checkpoint (flax msgpack) rather
    than a torch one; anything else raises."""
    path = Path(path)
    if zipfile.is_zipfile(path):
        return False
    with open(path, "rb") as f:
        if flax_msgpack.is_flax_checkpoint(f.read(1)):
            return True
    raise ValueError(f"{path}: {_FORMAT_HINT}")


def load_checkpoint_raw(path: str | Path) -> Dict[str, Any]:
    """The payload of a checkpoint, on the CPU: a torch checkpoint as saved,
    a JAX one as its decoded tree (numpy leaves, JAX layouts)."""
    path = Path(path)
    if is_jax_checkpoint(path):
        return flax_msgpack.msgpack_restore(path.read_bytes())
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


def load_generator_state(path: str | Path,
                         module: Optional[torch.nn.Module] = None
                         ) -> Dict[str, torch.Tensor]:
    """Generator state_dict from a checkpoint: a bare state_dict, the
    reference trainer's dict with a ``generator`` entry, or the port's
    trainer payload (``generator.params``); or a JAX checkpoint (the JAX
    trainer's payload or bare generator variables, as the JAX package's
    ``variables_from_checkpoint`` reads them), converted for ``module``, the
    generator it is for (required then: the layout depends on the family)."""
    path = Path(path)
    if is_jax_checkpoint(path):
        if module is None:
            raise ValueError(f"{path} is a JAX checkpoint: its conversion needs the "
                             f"generator module it is for")
        from ..models.convert import module_state_from_jax

        raw = load_checkpoint_raw(path)
        gen = raw.get("generator", raw)
        if "params" not in gen:  # bare parameters
            gen = {"params": gen}
        # a trainer payload's entry keeps its collections under "extra", bare
        # variables beside "params"
        extra = gen.get("extra", {k: v for k, v in gen.items() if k != "params"})
        return module_state_from_jax(module, {"params": gen["params"], "extra": extra})
    ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "generator" in ckpt:
        ckpt = ckpt["generator"]
        if isinstance(ckpt, dict) and set(ckpt) == {"params", "extra"}:
            ckpt = {**ckpt["params"], **ckpt["extra"]}
    return ckpt
