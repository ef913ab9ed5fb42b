"""Training CLI of the PyTorch port (the flags of ``scripts/train.py``).

    python scripts/train_torch.py --config p2igan_tpu_torch/config/p2igan_gan_baseline_gauge.json
    python scripts/train_torch.py --config <cfg.json> --resume weights/.../latest.ckpt

``--device`` defaults to ``cuda`` and raises when no GPU is available; pass
``--device cpu`` to run the plain PyTorch path on the CPU.

Data parallel over N GPUs of one host (one process a GPU, NCCL; the batch
size in the config is the global batch, each rank takes a N-th of it):

    torchrun --nproc_per_node N scripts/train_torch.py --config <cfg.json>
"""

from __future__ import annotations

# Allow running as `python scripts/<name>.py` without installing the package.
import sys as _sys
from pathlib import Path as _Path

_repo = str(_Path(__file__).resolve().parents[1])
if _repo not in _sys.path:
    _sys.path.insert(0, _repo)

import argparse
import logging
import os
from pathlib import Path
from typing import Optional, Sequence

import torch

from p2igan_tpu_torch.config import load_config
from p2igan_tpu_torch.parallel import shutdown
from p2igan_tpu_torch.utils.rng import seed_everything
from p2igan_tpu_torch.training.trainer import Trainer
from p2igan_tpu_torch.utils.tracking import get_tracker, setup_logging


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train P2I-GAN benchmark model (PyTorch / CUDA)")
    parser.add_argument("--config", type=Path,
                        default=Path("p2igan_tpu_torch/config/p2igan_baseline.json"),
                        help="Path to JSON/YAML config file.")
    parser.add_argument("--experiment-name", type=str, default=None)
    parser.add_argument("--run-name", type=str, default=None)
    parser.add_argument("--tracking-uri", type=str, default=None)
    parser.add_argument("--log-level", type=str, default="INFO")
    parser.add_argument("--resume", type=Path, default=None,
                        help="Checkpoint to resume from (params+optimizer+step): "
                             "the port trainer's or the JAX trainer's.")
    parser.add_argument("--run-validation", dest="run_validation", action="store_true")
    parser.add_argument("--skip-validation", dest="run_validation", action="store_false")
    parser.set_defaults(run_validation=None)
    parser.add_argument("--run-test", dest="run_test", action="store_true")
    parser.add_argument("--skip-test", dest="run_test", action="store_false")
    parser.set_defaults(run_test=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a GPU) or cpu.")
    return parser


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def main(args: Optional[argparse.Namespace] = None) -> Trainer:
    parsed = args or parse_args()
    logging.info("Loading config from %s", parsed.config)
    config = load_config(parsed.config)
    train_cfg = config.setdefault("train", {})
    if parsed.experiment_name:
        config["experiment_name"] = parsed.experiment_name
    if parsed.run_name:
        config["run_name"] = parsed.run_name
    tracker = get_tracker()
    if parsed.tracking_uri:
        tracker.set_tracking_uri(parsed.tracking_uri)
    elif "MLFLOW_TRACKING_URI" in os.environ:
        tracker.set_tracking_uri(os.environ["MLFLOW_TRACKING_URI"])
    if parsed.run_validation is not None:
        train_cfg["use_validation"] = bool(parsed.run_validation)
    if parsed.run_test is not None:
        train_cfg["use_test"] = bool(parsed.run_test)
    if parsed.resume is not None and not parsed.resume.exists():
        raise SystemExit(f"--resume checkpoint not found: {parsed.resume}")
    seed_everything(config.get("seed", 42))
    try:
        trainer = Trainer(config, device=parsed.device)
        if parsed.resume is not None:
            trainer.load(parsed.resume)
        trainer.train()
    finally:
        shutdown()
    return trainer


if __name__ == "__main__":
    _args = parse_args()
    setup_logging(_args.log_level)
    main(_args)
