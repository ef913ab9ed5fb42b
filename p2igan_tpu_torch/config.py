"""Config system: JSON/YAML model+data+loss+train configs with CLI overrides.

Schema-compatible with the reference's ``p2igan_bench/config/*.json``
(reference ``scripts/train.py:67-75`` loader, ``train.py:492-504`` overrides);
defaults are layered via ``dict.get`` throughout, and dataset args inherit
train -> valid/test with explicit ``null`` deletions
(reference ``p2igan_bench/data/dataloader.py:112-139``).

The port's own copy of ``p2igan_tpu/config.py``; the shipped configs live
beside it in ``p2igan_tpu_torch/config/``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict


def load_config(path: str | Path) -> Dict[str, Any]:
    """Load a JSON or YAML config file (reference train.py:67-75 semantics)."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(path)
    with path.open("r", encoding="utf-8") as f:
        if path.suffix in {".yaml", ".yml"}:
            import yaml

            return yaml.safe_load(f)
        return json.load(f)


def save_config(path: str | Path, cfg: Dict[str, Any]) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w", encoding="utf-8") as f:
        json.dump(cfg, f, indent=2, sort_keys=True)


def flatten_dict(data: Dict[str, Any], parent_key: str = "") -> Dict[str, Any]:
    """Flatten nested config to dotted keys for param logging
    (reference train.py:85-95: lists are JSON-encoded, None dropped)."""
    items: Dict[str, Any] = {}
    for key, value in data.items():
        new_key = f"{parent_key}.{key}" if parent_key else key
        if isinstance(value, dict):
            items.update(flatten_dict(value, new_key))
        elif isinstance(value, (list, tuple)):
            items[new_key] = json.dumps(list(value))
        elif value is not None:
            items[new_key] = value
    return items


def merge_overrides(cfg: Dict[str, Any], overrides: Dict[str, Any]) -> Dict[str, Any]:
    """Apply dotted-key overrides (e.g. {"train.batch_size": 4}) in place.

    A dotted path that traverses an existing NON-dict node (e.g. a JSON
    ``"train": null``) replaces that node with a dict, matching the
    intent of the override instead of raising an opaque TypeError."""
    for dotted, value in overrides.items():
        node = cfg
        parts = dotted.split(".")
        for p in parts[:-1]:
            nxt = node.get(p)
            if not isinstance(nxt, dict):
                nxt = {}
                node[p] = nxt
            node = nxt
        node[parts[-1]] = value
    return cfg


def build_dataset_args(split_cfg: Dict[str, Any], defaults: Dict[str, Any] | None = None) -> Dict[str, Any]:
    """Per-split dataset args with train->split inheritance.

    Mirrors reference dataloader.py:112-139: ``w``/``h``/``sample_length``
    inherit from defaults, an explicit ``null`` in the split deletes the key,
    mask dicts merge (split keys win), and ``data_root`` (or legacy
    ``data_root1``) is required.
    """
    from copy import deepcopy

    defaults = defaults or {}
    args: Dict[str, Any] = {}
    for key in ("w", "h", "sample_length"):
        if key in defaults:
            args[key] = defaults[key]
        if key in split_cfg:
            value = split_cfg[key]
            if value is None and key in args:
                args.pop(key)
            elif value is not None:
                args[key] = value

    mask_cfg = deepcopy(defaults.get("mask", {}))
    if "mask" in split_cfg:
        if split_cfg["mask"] is None:  # explicit null DELETES the inherited
            mask_cfg = {}              # mask (same as w/h/sample_length)
        else:
            mask_cfg.update(split_cfg["mask"])
    if mask_cfg:
        args["mask"] = mask_cfg

    if "data_root" in split_cfg:
        args["data_root"] = split_cfg["data_root"]
    elif "data_root1" in split_cfg:
        args["data_root"] = split_cfg["data_root1"]
    else:
        raise KeyError("Dataset config requires 'data_root'.")
    if "device_decode" in split_cfg:  # raw uint8 pipeline (train zarr only)
        args["device_decode"] = bool(split_cfg["device_decode"])
    return args


def extract_shared_params(dataset_args: Dict[str, Any]) -> Dict[str, Any]:
    """Shared w/h/sample_length/mask params the valid/test splits inherit."""
    from copy import deepcopy

    shared: Dict[str, Any] = {}
    for key in ("w", "h", "sample_length"):
        if key in dataset_args:
            shared[key] = dataset_args[key]
    if "mask" in dataset_args:
        shared["mask"] = deepcopy(dataset_args["mask"])
    return shared


def drop_sample_length(params: Dict[str, Any]) -> Dict[str, Any]:
    """Test split keeps full event length (reference dataloader.py:150-153)."""
    from copy import deepcopy

    params = deepcopy(params)
    params.pop("sample_length", None)
    return params
