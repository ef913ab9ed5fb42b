"""GAN convergence smoke of the PyTorch port, with validation metrics.

    python scripts/convergence_smoke_torch.py --fresh --append        # on a GPU
    python scripts/convergence_smoke_torch.py --device cpu --size 16 --frames 4 ...

Runs the port's training path -- a fake train store -> the window loader ->
device prefetch -> the hinge-GAN step, from the shipped
``p2igan_tpu_torch/config/p2igan_gan_baseline_gauge.json`` with only size and
iteration knobs overridden, as ``scripts/convergence_smoke.py`` does for the
JAX package -- for a few hundred steps and reads the ``train/rec_loss``
trajectory back from the file tracker. It LEARNS when the mean of the last
quarter of the logged points is below ``--learn-ratio`` times the first.

Unlike the JAX script it keeps the 80/20 validation split and sets
``train.eval_metrics``, so every epoch ends with the metric suite over the
validation windows; the last epoch's ``val/*`` values are the quality numbers
of the trained model. ``--append`` prints the summary as markdown and copies
the newest train example image to ``docs/convergence_smoke_torch.png``.
The work directory (``--workdir``, default ``build/convergence_smoke_torch``
in the checkout) holds the data, weights, example images and the tracker.
"""

from __future__ import annotations

import os

# the port's tracker prefers mlflow when it can import it; the trajectory is
# read back from the file tracker, so force it before the port is imported
os.environ["P2IGAN_FORCE_FILE_TRACKER"] = "1"

# Allow running as `python scripts/<name>.py` without installing the package.
import sys as _sys
from pathlib import Path as _Path

_repo = str(_Path(__file__).resolve().parents[1])
if _repo not in _sys.path:
    _sys.path.insert(0, _repo)

import argparse
import json
import shutil
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from p2igan_tpu_torch.config import load_config
from p2igan_tpu_torch.data.fake import write_gauge_mask, write_train_zarr
from p2igan_tpu_torch.training.trainer import Trainer
from p2igan_tpu_torch.utils.tracking import get_tracker

REPO = Path(_repo)
CONFIG = REPO / "p2igan_tpu_torch" / "config" / "p2igan_gan_baseline_gauge.json"
EXAMPLE_OUT = REPO / "docs" / "convergence_smoke_torch.png"
EXPERIMENT = "convergence-smoke-torch"


def build_data(root: Path, n_events: int, event_t: int, seed: int = 0,
               H: int = 128, W: int = 128, T: int = 16) -> Tuple[Path, Path]:
    train_zarr = root / "nimrod_train.zarr"
    mask_txt = root / "masks" / "gauge_mask_128_train.txt"
    if not train_zarr.exists():
        write_train_zarr(train_zarr, n_events=n_events, T=event_t, H=H, W=W,
                         window=T, stride=1, seed=seed + 2)
    if not mask_txt.exists():
        write_gauge_mask(mask_txt, H=H, W=W, seed=seed + 3, n_gauges=min(79, H * W // 16))
    return train_zarr, mask_txt


def smoke_config(workdir: Path, train_zarr: Path, mask_txt: Path, steps: int,
                 log_step: int, H: int = 128, W: int = 128, T: int = 16,
                 batch: int = 12) -> dict:
    cfg = load_config(CONFIG)
    cfg["save_dir"] = str(workdir / "weights")
    cfg["experiment_name"] = EXPERIMENT
    cfg["run_name"] = "smoke"
    # reference constraint: base_channels == 4 * sample_length
    cfg["model"]["base_channels"] = 4 * T
    cfg["data"]["train"].update({"data_root": str(train_zarr), "w": W, "h": H,
                                 "sample_length": T})
    cfg["data"]["train"]["mask"]["file"] = str(mask_txt)
    cfg["data"].pop("test", None)
    cfg["train"].update(iterations=steps, log_step=log_step, batch_size=batch,
                        use_validation=True, use_test=False, eval_metrics=True)
    return cfg


def read_metrics(run_dir: Path) -> Dict[str, List[Tuple[int, float]]]:
    """{key: [(step, value)]} of one tracker run."""
    out: Dict[str, List[Tuple[int, float]]] = {}
    for line in (run_dir / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if rec["value"] is not None:
            out.setdefault(rec["key"], []).append((rec["step"], rec["value"]))
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--log-step", type=int, default=20)
    ap.add_argument("--events", type=int, default=48,
                    help="fake train events (sized for ~2 epochs)")
    ap.add_argument("--event-frames", type=int, default=80)
    ap.add_argument("--size", type=int, default=128, help="spatial H=W")
    ap.add_argument("--frames", type=int, default=16,
                    help="sample_length (base_channels = 4x this)")
    ap.add_argument("--batch", type=int, default=12)
    ap.add_argument("--learn-ratio", type=float, default=0.7,
                    help="LEARNS iff tail_mean < ratio * first")
    ap.add_argument("--append", action="store_true",
                    help="print the summary as markdown and copy the newest train "
                         "example image to docs/convergence_smoke_torch.png")
    ap.add_argument("--fresh", action="store_true", help="wipe the work directory first")
    ap.add_argument("--workdir", type=Path, default=REPO / "build" / "convergence_smoke_torch")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> str:
    args = build_parser().parse_args(argv)
    workdir = args.workdir.resolve()
    if args.fresh and workdir.exists():
        shutil.rmtree(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    tracker = get_tracker()
    tracker.set_tracking_uri(str(workdir / "mlruns"))

    train_zarr, mask_txt = build_data(workdir / "data", args.events, args.event_frames,
                                      H=args.size, W=args.size, T=args.frames)
    cfg = smoke_config(workdir, train_zarr, mask_txt, args.steps, args.log_step,
                       H=args.size, W=args.size, T=args.frames, batch=args.batch)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=args.device)
    print(f"device={trainer.device}  steps={args.steps}  store={train_zarr}", flush=True)
    trainer.train()
    wall = time.perf_counter() - t0

    metrics = read_metrics(tracker.run_dir)
    traj = metrics.get("train/rec_loss", [])
    if not traj:
        raise SystemExit("no train/rec_loss metrics recorded: smoke FAILED")
    first, last = traj[0][1], traj[-1][1]
    # the trajectory is noisy batch to batch: the first point against the
    # mean of the final quarter of the logged points
    tail = [v for _, v in traj[-max(1, len(traj) // 4):]]
    tail_mean = sum(tail) / len(tail)
    verdict = "LEARNS" if tail_mean < args.learn_ratio * first else "NO-IMPROVEMENT"
    print("\nrec-loss trajectory (step, value):", flush=True)
    for s, v in traj:
        print(f"  {s:5d}  {v:.4f}", flush=True)
    ends = {key: (metrics[key][0][1], metrics[key][-1][1])
            for key in ("train/dis_loss", "train/adv_loss") if key in metrics}
    val_step = max((pts[-1][0] for key, pts in metrics.items() if key.startswith("val/")),
                   default=None)
    val = {key[4:]: pts[-1][1] for key, pts in metrics.items()
           if key.startswith("val/") and pts[-1][0] == val_step}
    summary = (f"first={first:.4f}  last={last:.4f}  tail_mean={tail_mean:.4f}  "
               f"ratio={tail_mean / first:.3f}  [{verdict}]  ({wall:.0f}s wall)")
    print("\n" + summary, flush=True)
    for key, (a, b) in ends.items():
        print(f"{key}: {a:.4f} -> {b:.4f}", flush=True)
    print(f"validation at step {val_step}: " + json.dumps(val), flush=True)

    if args.append:
        pts = "  ".join(f"{s}:{v:.3f}" for s, v in traj)
        lines = [
            "", f"### GAN convergence smoke of the port ({args.steps} steps on "
            f"{trainer.device}, scripts/convergence_smoke_torch.py)", "",
            f"`train/rec_loss` every {args.log_step} steps:", "", f"    {pts}", "",
            f"first={first:.4f}, final-quarter mean={tail_mean:.4f} "
            f"({tail_mean / first:.2f}x) -> **{verdict}**; "
            + "; ".join(f"{k[6:]} {a:.3f} -> {b:.3f}" for k, (a, b) in ends.items())
            + f"; {wall:.0f} s wall.", "",
            f"Validation metrics at step {val_step}: "
            + ", ".join(f"{k} {v:.4f}" for k, v in sorted(val.items())), ""]
        imgs = sorted((Path(cfg["save_dir"]) / "artifacts").glob("train_*.png"),
                      key=lambda p: (p.stat().st_mtime, p.name))
        if imgs:
            dst = EXAMPLE_OUT
            dst.parent.mkdir(exist_ok=True)
            shutil.copy2(imgs[-1], dst)
            lines.append("![convergence example](docs/convergence_smoke_torch.png)")
            print(f"example image {imgs[-1].name} -> {dst}", flush=True)
        print("\n".join(lines), flush=True)

    if verdict != "LEARNS":
        raise SystemExit(1)
    return verdict


if __name__ == "__main__":
    main()
