"""Experiment-suite configuration: the port's copy of ``experiments/config.py``.

``build_config`` defaults to the repo-local fake-data tree and can be
overridden by a JSON file (``--config path`` / ``P2I_EXPERIMENTS_CONFIG`` env
var) whose keys mirror the dataclass fields. Defaults and JSON schema are the
JAX suite's; the device is not part of the config (``--device`` of the entry
points).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


@dataclass
class ModeConfig:
    observation_path: str
    truth_path: str
    methods: Dict[str, str]
    mask_train_path: str
    mask_test_path: str


@dataclass
class ExperimentConfig:
    experiment_name: str = "test_exp_2_gauge"
    description: str = "Tests for P2I-GAN Benchmarking Experiments"
    save_dir: str = "results"
    mode: str = "gauge"  # "radar" or "gauge"
    run_exp1: bool = False
    run_exp2_gif: bool = True
    run_exp2_pdf: bool = False
    run_exp3: bool = False
    crop_size: int = 128
    visualization_vmin: float = 0.0
    visualization_vmax: float = 32.0
    gif_fps: int = 6
    exp1_pool8: bool = True
    exp2_paper_output_pdf: str = "two_events_stacked_titles.pdf"
    # crop/stitch the paper panels; works without PyMuPDF via the PIL route
    exp2_paper_crop_pdf: bool = False
    exp2_paper_crop_output: str = "cropped_stitched.pdf"
    exp2_paper_mask_path: Optional[str] = None
    exp2_paper_method_order: Tuple[str, ...] = (
        "Gauge", "Radar", "P2I-GAN", "DK", "STDK",
    )
    exp2_paper_events: Tuple[Dict[str, object], ...] = (
        {"event_id": 1, "select_idx": (0, 1, 2), "title": "Event 1"},
        {"event_id": 2, "select_idx": (0, 1, 2), "title": "Event 2"},
    )
    exp2_paper_folders: Dict[str, str] = field(default_factory=dict)
    data: Dict[str, ModeConfig] = field(default_factory=dict)


def _default_tree(root: str) -> Dict[str, ModeConfig]:
    d = lambda *p: os.path.join(root, *p)  # noqa: E731
    methods = {
        "P2IGAN": d("infer", "p2igan_nimrod.zarr"),
        "DK": d("infer", "dk_nimrod.zarr"),
        "STDK": d("infer", "stdk_nimrod.zarr"),
    }
    radar = ModeConfig(
        observation_path=d("nimrod_test.zarr"),
        truth_path=d("nimrod_test.zarr"),
        methods=dict(methods),
        mask_train_path=d("masks", "gauge_mask_128_train.txt"),
        mask_test_path=d("masks", "gauge_mask_128_test.txt"),
    )
    gauge = ModeConfig(
        observation_path=d("midas_test.zarr"),
        truth_path=d("nimrod_test.zarr"),
        methods={k: v.replace("nimrod", "gauge") for k, v in methods.items()},
        mask_train_path=radar.mask_train_path,
        mask_test_path=radar.mask_test_path,
    )
    return {"radar": radar, "gauge": gauge}


def build_config(config_path: Optional[str] = None,
                 data_root: Optional[str] = None) -> ExperimentConfig:
    cfg = ExperimentConfig()
    root = data_root or os.environ.get("P2I_DATA_ROOT", "datasets/fake")
    cfg.data = _default_tree(root)

    config_path = config_path or os.environ.get("P2I_EXPERIMENTS_CONFIG")
    if config_path:
        with open(config_path, "r", encoding="utf-8") as f:
            payload = json.load(f)
        data = payload.pop("data", None)
        for k, v in payload.items():
            if hasattr(cfg, k):
                setattr(cfg, k, tuple(v) if isinstance(getattr(cfg, k), tuple) else v)
        if data:
            cfg.data = {mode: ModeConfig(**mc) for mode, mc in data.items()}
    return cfg


def get_mode_config(cfg: ExperimentConfig) -> ModeConfig:
    mode_cfg = cfg.data.get(cfg.mode)
    if mode_cfg is None:
        raise ValueError(f"Unknown mode: {cfg.mode}")
    return mode_cfg
