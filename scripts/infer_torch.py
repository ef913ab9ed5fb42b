"""Inference CLI of the PyTorch port (the flags of ``scripts/infer.py``).

    python scripts/infer_torch.py --config p2igan_tpu_torch/config/p2igan_baseline_eval.json \
        --checkpoint weights/test/P2IGANv0.1.0.pt --output out.zarr --device cuda

``--device`` defaults to ``cuda`` and raises when no GPU is available; pass
``--device cpu`` to run the plain PyTorch path on the CPU.

Over N GPUs of one host (one process a GPU, NCCL), event batches' windows
dealt to the ranks, rank 0 writing the store:

    torchrun --nproc_per_node N scripts/infer_torch.py --config <eval.json> \
        --checkpoint <gen.pt> --output out.zarr --batch-events 2
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
from pathlib import Path
from typing import Optional, Sequence

import torch

from p2igan_tpu_torch.config import load_config
from p2igan_tpu_torch.inference.driver import run_inference
from p2igan_tpu_torch.parallel import shutdown
from p2igan_tpu_torch.utils.rng import seed_everything


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Inference for P2I-GAN benchmark models (PyTorch / CUDA)")
    parser.add_argument("--config", type=Path,
                        default=Path("p2igan_tpu_torch/config/p2igan_baseline.json"))
    parser.add_argument("--checkpoint", type=Path, default=None,
                        help="Path to a generator checkpoint: a torch .pt (reference "
                             "or port layout) or a JAX trainer .ckpt.")
    parser.add_argument("--model-dir", type=Path, default=None)
    parser.add_argument("--data-root", type=Path, default=None)
    parser.add_argument("--output", type=Path, default=None)
    parser.add_argument("--passes", type=int, default=1)
    parser.add_argument("--log-every", type=int, default=50)
    parser.add_argument("--stride", type=int, default=16)
    parser.add_argument("--overlap", type=int, default=12)
    parser.add_argument("--output-scale", type=float, default=255.0)
    parser.add_argument("--batch-events", type=int, default=1,
                        help="Events reconstructed per flattened window "
                             "stream; 1 = one event at a time.")
    parser.add_argument("--window-batch", type=int, default=8,
                        help="Windows evaluated per generator call.")
    # scripts/infer.py's lax.scan knobs; the port walks window chunks in an
    # eager loop with one accumulator, which is what their defaults select
    parser.add_argument("--scan-unroll", type=int, default=1, choices=(1,),
                        help="Accepted for scripts/infer.py compatibility; "
                             "only 1.")
    parser.add_argument("--accum-mode", type=str, default="carry",
                        choices=("carry",),
                        help="Accepted for scripts/infer.py compatibility; "
                             "only carry.")
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--log-level", type=str, default="INFO")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a GPU) or cpu.")
    return parser


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def main(args: Optional[argparse.Namespace] = None) -> Path:
    parsed = args or parse_args()
    logging.basicConfig(level=getattr(logging, parsed.log_level.upper(), logging.INFO),
                        format="%(asctime)s %(levelname)s %(message)s")
    logging.info("Loading config from %s", parsed.config)
    cfg = load_config(parsed.config)
    seed_everything(cfg.get("seed", 42))
    try:
        return run_inference(
            cfg,
            checkpoint=str(parsed.checkpoint) if parsed.checkpoint else None,
            model_dir=str(parsed.model_dir) if parsed.model_dir else None,
            data_root=str(parsed.data_root) if parsed.data_root else None,
            output=str(parsed.output) if parsed.output else None,
            passes=parsed.passes,
            stride=parsed.stride,
            overlap=parsed.overlap,
            output_scale=parsed.output_scale,
            overwrite=parsed.overwrite,
            log_every=parsed.log_every,
            window_batch=parsed.window_batch,
            batch_events=parsed.batch_events,
            config_path=str(parsed.config),
            device=parsed.device,
        )
    finally:
        shutdown()


if __name__ == "__main__":
    main()
