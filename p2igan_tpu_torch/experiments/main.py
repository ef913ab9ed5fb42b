"""Experiment-suite entry point of the port.

    python -m p2igan_tpu_torch.experiments.main --config exp.json \
        [--data-root DIR] [--device cuda|cpu]

The counterpart of ``experiments/main.py``: the loaded inputs travel in an
``EvalContext``, each experiment is a stage function, and the ``_STAGES``
table decides what runs. Outputs (directories, file names, ``metrics.json``
keys and their order, the text reports) are the JAX suite's. Scores run on
``--device`` (``cuda`` by default; it raises when no GPU is available rather
than carry on on the CPU); the figure stages need matplotlib.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Tuple

import numpy as np
import torch

from ..parallel.mesh import resolve_device
from .config import ExperimentConfig, ModeConfig, build_config, get_mode_config
from .exp1 import run_exp1
from .exp2 import run_exp2, run_exp2_paper, run_exp2_paper_zarr
from .exp3 import run_exp3
from .io import (center_square, ensure_dir, load_mask, load_zarr_array,
                 save_config_snapshot, save_json, save_text)


@dataclass
class EvalContext:
    cfg: ExperimentConfig
    mode_cfg: ModeConfig
    results_root: str
    mask_train: np.ndarray
    mask_test: np.ndarray
    device: torch.device
    # truth/preds load LAZILY: the exp2 stages re-read stores from paths,
    # so a gif-only run must not hold every prediction array in memory
    _truth: Dict[str, np.ndarray] | None = None
    _preds: Dict[str, Dict[str, np.ndarray]] | None = None

    @property
    def truth(self) -> Dict[str, np.ndarray]:
        if self._truth is None:
            self._truth = load_zarr_array(self.mode_cfg.truth_path,
                                          return_events=True)
        return self._truth

    @property
    def preds(self) -> Dict[str, Dict[str, np.ndarray]]:
        if self._preds is None:
            self._preds = {
                name: load_zarr_array(path, return_events=True)
                for name, path in self.mode_cfg.methods.items()}
        return self._preds

    @property
    def eval_mask(self) -> np.ndarray:
        """radar mode scores held-out radar pixels (train mask); gauge mode
        scores the test gauges."""
        return self.mask_train if self.cfg.mode == "radar" else self.mask_test

    def out_dir(self, stage: str) -> str:
        path = os.path.join(self.results_root, stage)
        ensure_dir(path)
        return path


def _format_report(tree, indent: str = "") -> List[str]:
    """Nested metric dict -> indented text lines (6-decimal scalars)."""
    lines: List[str] = []
    for key, val in tree.items():
        if isinstance(val, dict):
            lines.append(f"{indent}{key}:")
            lines.extend(_format_report(val, indent + "  "))
        else:
            lines.append(f"{indent}{key}: {val:.6f}")
    return lines


def _method_sections(metrics: Dict[str, Dict]) -> List[str]:
    lines: List[str] = []
    for method, vals in metrics.items():
        lines.append(f"[{method}]")
        lines.extend(_format_report(vals))
        lines.append("")
    return lines


def stage_exp1(ctx: EvalContext) -> None:
    out = ctx.out_dir("exp1")
    report = run_exp1(ctx.preds, ctx.truth, ctx.eval_mask, ctx.cfg.mode,
                      ctx.cfg.crop_size, use_pool8=ctx.cfg.exp1_pool8,
                      divide_by_3=True, device=ctx.device)
    save_json(os.path.join(out, "metrics.json"), report)
    save_text(os.path.join(out, "metrics.txt"), _method_sections(report))


def stage_exp2_gif(ctx: EvalContext) -> None:
    run_exp2(preds=ctx.mode_cfg.methods, truth=ctx.mode_cfg.truth_path,
             observation=ctx.mode_cfg.observation_path,
             mask_train=ctx.mask_train, out_dir=ctx.out_dir("exp2_gif"),
             crop_size=ctx.cfg.crop_size, frames=None,
             vmin=ctx.cfg.visualization_vmin, vmax=ctx.cfg.visualization_vmax,
             gif_fps=ctx.cfg.gif_fps, divide_by_3=True, mode=ctx.cfg.mode,
             device=ctx.device)


def stage_exp2_pdf(ctx: EvalContext) -> None:
    cfg, mode_cfg = ctx.cfg, ctx.mode_cfg
    mask_path = cfg.exp2_paper_mask_path or mode_cfg.mask_train_path
    if cfg.exp2_paper_folders:
        # per-method PNG-folder variant, active when exp2_paper_folders is set
        run_exp2_paper(
            folders=cfg.exp2_paper_folders,
            method_order=cfg.exp2_paper_method_order,
            events=cfg.exp2_paper_events,
            mask_path=mask_path,
            crop_size=cfg.crop_size,
            out_dir=ctx.out_dir("exp2_pdf"),
            output_pdf=cfg.exp2_paper_output_pdf,
            crop_pdf=cfg.exp2_paper_crop_pdf,
            crop_output=cfg.exp2_paper_crop_output,
        )
        return
    # zarr variant: the default order is RadarMasked, Nimrod, then the
    # methods; a user override of exp2_paper_method_order takes precedence
    default_order = tuple(ExperimentConfig().exp2_paper_method_order)
    order = (("RadarMasked", "Nimrod", *mode_cfg.methods.keys())
             if tuple(cfg.exp2_paper_method_order) == default_order
             else tuple(cfg.exp2_paper_method_order))
    run_exp2_paper_zarr(
        observation_path=mode_cfg.observation_path,
        methods=mode_cfg.methods,
        events=cfg.exp2_paper_events,
        mask_path=mask_path,
        crop_size=cfg.crop_size,
        out_dir=ctx.out_dir("exp2_pdf"),
        output_pdf=cfg.exp2_paper_output_pdf,
        method_order=order,
        crop_pdf=cfg.exp2_paper_crop_pdf,
        crop_output=cfg.exp2_paper_crop_output,
        device=ctx.device,
    )


def stage_exp3(ctx: EvalContext) -> None:
    out = ctx.out_dir("exp3")
    report = run_exp3(ctx.preds, ctx.truth, ctx.eval_mask, ctx.cfg.mode,
                      ctx.cfg.crop_size, out, device=ctx.device)
    save_json(os.path.join(out, "metrics.json"), report)
    save_text(os.path.join(out, "metrics.txt"), _format_report(report))


_STAGES: Tuple[Tuple[str, Callable[[EvalContext], None]], ...] = (
    ("run_exp1", stage_exp1),
    ("run_exp2_gif", stage_exp2_gif),
    ("run_exp2_pdf", stage_exp2_pdf),
    ("run_exp3", stage_exp3),
)


def load_context(cfg: ExperimentConfig, device: str | torch.device = "cuda") -> EvalContext:
    """The stages' context: results directory and config snapshot, the two
    masks cropped to ``crop_size``, the device (``cuda`` raises without a
    GPU); stores load when a stage first reads them."""
    dev = resolve_device(device)
    mode_cfg = get_mode_config(cfg)
    results_root = os.path.join(cfg.save_dir, cfg.experiment_name)
    ensure_dir(results_root)
    save_config_snapshot(os.path.join(results_root, "config.json"), cfg)

    # the observation store is only checked: no stage reads it from memory
    if not os.path.exists(mode_cfg.observation_path):
        raise FileNotFoundError(
            f"observation store missing: {mode_cfg.observation_path}")
    return EvalContext(
        cfg=cfg,
        mode_cfg=mode_cfg,
        results_root=results_root,
        mask_train=center_square(load_mask(mode_cfg.mask_train_path),
                                 cfg.crop_size),
        mask_test=center_square(load_mask(mode_cfg.mask_test_path),
                                cfg.crop_size),
        device=dev,
    )


def run_stages(cfg: ExperimentConfig,
               stages: Iterable[Tuple[str, Callable]] = _STAGES,
               device: str | torch.device = "cuda") -> None:
    ctx = load_context(cfg, device)
    for flag, stage in stages:
        if getattr(cfg, flag, False):
            stage(ctx)


def main(config_path=None, data_root=None, device: str | torch.device = "cuda") -> None:
    run_stages(build_config(config_path=config_path, data_root=data_root),
               device=device)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="P2I-GAN benchmark experiments "
                                                 "(PyTorch / CUDA)")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--data-root", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a GPU) or cpu")
    return parser


if __name__ == "__main__":
    cli = build_parser().parse_args()
    main(config_path=cli.config, data_root=cli.data_root, device=cli.device)
