"""Quality of trained models on held-out events, through the PyTorch port alone.

    python scripts/quality_torch.py --fresh --summary quality.json   # on a GPU
    python scripts/quality_torch.py --device cpu --size 16 --frames 4 --steps 2 ...

1. Trains the stis hinge GAN as ``scripts/convergence_smoke_torch.py`` does
   (the shipped ``p2igan_gan_baseline_gauge.json``, ``--steps`` at ``--batch``,
   full width by default) and ``dk_gauge.json`` for as many steps, on the same
   fake train store and 79-gauge mask.
2. Writes a held-out test store (``--test-events`` x ``--test-frames`` from
   ``data/fake.py:write_test_zarr``, seed ``TEST_SEED``; the train store's is
   2) and a second 79-gauge mask under ``MASK_SEED`` (the input gauges' is
   3): the gauge-mode scoring mask.
3. Serves three methods through ``scripts/infer_torch.py`` (stride =
   ``--frames``, overlap = 3/4 of it: 16/12 at full width; window batch
   ``WINDOW_BATCH``): the trained p2igan, the same architecture with
   untrained weights seeded by ``UNTRAINED_SEED``, and the trained dk.
4. Scores them with the offline suite on the device: exp1 through
   ``p2igan_tpu_torch.experiments.main`` and exp3's metrics, in gauge mode
   (the held-out gauges) and radar mode (every pixel that is not an input
   gauge), and prints one table a mode.

``--summary`` writes every number of the run as JSON. The work directory
(``--workdir``, default ``build/quality_torch`` in the checkout) holds the
data, weights, served stores and ``results/quality_<mode>/``.
"""

from __future__ import annotations

import os

# the trajectories are read back from the file tracker: force it before the
# port is imported
os.environ["P2IGAN_FORCE_FILE_TRACKER"] = "1"

# Allow running as `python scripts/<name>.py` without installing the package.
import sys as _sys
from pathlib import Path as _Path

_repo = str(_Path(__file__).resolve().parents[1])
if _repo not in _sys.path:
    _sys.path.insert(0, _repo)

import argparse
import importlib.util
import json
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

from p2igan_tpu_torch.config import load_config
from p2igan_tpu_torch.data.fake import write_gauge_mask, write_test_zarr, write_train_zarr
from p2igan_tpu_torch.experiments import main as exp_main
from p2igan_tpu_torch.experiments.config import build_config
from p2igan_tpu_torch.experiments.exp3 import exp3_metrics
from p2igan_tpu_torch.experiments.io import ensure_dir, save_json, save_text
from p2igan_tpu_torch.models import build_generator_for_inference
from p2igan_tpu_torch.training.trainer import Trainer
from p2igan_tpu_torch.utils.tracking import get_tracker

REPO = Path(_repo)
CONFIGS = REPO / "p2igan_tpu_torch" / "config"
METHODS = ("P2IGAN", "P2IGAN-untrained", "DK")
MODES = ("gauge", "radar")
N_GAUGES = 79
TEST_SEED, MASK_SEED, UNTRAINED_SEED = 11, 13, 2024
WINDOW_BATCH = 8


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=400, help="training steps of each model")
    ap.add_argument("--log-step", type=int, default=20)
    ap.add_argument("--batch", type=int, default=12)
    ap.add_argument("--size", type=int, default=128, help="spatial H=W")
    ap.add_argument("--frames", type=int, default=16,
                    help="sample_length (p2igan base_channels = 4x this)")
    ap.add_argument("--train-events", type=int, default=48)
    ap.add_argument("--train-event-frames", type=int, default=80)
    ap.add_argument("--test-events", type=int, default=8)
    ap.add_argument("--test-frames", type=int, default=64)
    ap.add_argument("--workdir", type=Path, default=REPO / "build" / "quality_torch")
    ap.add_argument("--fresh", action="store_true", help="wipe the work directory first")
    ap.add_argument("--summary", type=Path, default=None, help="write the numbers as JSON")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap


def _card(device: str) -> Optional[str]:
    if torch.device(device).type != "cuda":
        return None
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(0)


def _rec_loss_ends(smoke) -> Dict[str, float]:
    """First and last logged ``train/rec_loss`` of the tracker's last run."""
    traj = smoke.read_metrics(get_tracker().run_dir).get("train/rec_loss", [])
    return {"first_rec_loss": traj[0][1], "last_rec_loss": traj[-1][1]} if traj else {}


def train_p2igan(args, smoke, workdir: Path) -> Dict:
    """The convergence smoke's stis GAN run (its store and mask under
    ``workdir/data``); its LEARNS verdict is recorded, not fatal."""
    argv = ["--device", args.device, "--steps", str(args.steps), "--log-step",
            str(args.log_step), "--events", str(args.train_events), "--event-frames",
            str(args.train_event_frames), "--size", str(args.size), "--frames",
            str(args.frames), "--batch", str(args.batch), "--workdir", str(workdir)]
    t0 = time.perf_counter()
    try:
        verdict = smoke.main(argv)
    except SystemExit as exc:  # the gate failed: recorded, the run goes on
        if exc.code != 1:
            raise
        verdict = "NO-IMPROVEMENT"
    return {"verdict": verdict, "seconds": time.perf_counter() - t0, **_rec_loss_ends(smoke)}


def train_dk(args, smoke, workdir: Path, train_zarr: Path, mask: Path) -> Dict:
    """``dk_gauge.json`` for ``--steps`` rec-loss steps on the same store."""
    cfg = load_config(CONFIGS / "dk_gauge.json")
    cfg["save_dir"] = str(workdir / "weights")
    cfg["experiment_name"] = "quality-dk"
    cfg["run_name"] = "dk"
    cfg["data"]["train"].update({"data_root": str(train_zarr), "w": args.size,
                                 "h": args.size, "sample_length": args.frames})
    cfg["data"]["train"]["mask"]["file"] = str(mask)
    cfg["data"].pop("test", None)
    cfg["train"].update(iterations=args.steps, log_step=args.log_step,
                        batch_size=args.batch, use_validation=False, use_test=False)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=args.device)
    trainer.train()
    return {"seconds": time.perf_counter() - t0, **_rec_loss_ends(smoke)}


def eval_config(args, name: str, test_zarr: Path, mask: Path, save_dir: Path) -> dict:
    """The shipped eval config of ``name`` pointed at the held-out store."""
    cfg = load_config(CONFIGS / ("dk_gauge.json" if name == "dk"
                                 else "p2igan_baseline_eval.json"))
    if name != "dk":
        cfg["model"]["base_channels"] = 4 * args.frames
    cfg["save_dir"] = str(save_dir)
    cfg["data"]["train"].update({"data_root": str(test_zarr), "w": args.size,
                                 "h": args.size, "sample_length": args.frames})
    cfg["data"]["test"].update({"data_root": str(test_zarr), "w": args.size,
                                "h": args.size})
    for split in ("train", "test"):
        cfg["data"][split]["mask"]["file"] = str(mask)
    return cfg


def serve(args, cfg: dict, checkpoint: Path, out: Path, workdir: Path) -> Dict:
    infer_torch = _load_script("infer_torch")
    cfg_path = workdir / f"{out.stem}.json"
    cfg_path.write_text(json.dumps(cfg))
    stride = args.frames
    t0 = time.perf_counter()
    infer_torch.main(infer_torch.parse_args([
        "--config", str(cfg_path), "--checkpoint", str(checkpoint), "--output", str(out),
        "--stride", str(stride), "--overlap", str(3 * stride // 4), "--window-batch",
        str(WINDOW_BATCH), "--device", args.device, "--overwrite",
        "--log-level", "WARNING"]))
    return {"store": str(out), "seconds": time.perf_counter() - t0}


def score(args, mode: str, stores: Dict[str, str], test_zarr: Path, train_mask: Path,
          test_mask: Path, results: Path) -> Dict:
    """exp1 through the suite's entry point, then exp3's metrics (its figures
    need matplotlib, which a GPU machine may lack)."""
    econf = {"experiment_name": f"quality_{mode}", "save_dir": str(results), "mode": mode,
             "run_exp1": True, "run_exp2_gif": False, "run_exp2_pdf": False,
             "run_exp3": False, "crop_size": args.size,
             "data": {mode: {"observation_path": str(test_zarr),
                             "truth_path": str(test_zarr), "methods": stores,
                             "mask_train_path": str(train_mask),
                             "mask_test_path": str(test_mask)}}}
    cfg_path = results / f"quality_{mode}.json"
    cfg_path.write_text(json.dumps(econf))
    t0 = time.perf_counter()
    exp_main.main(config_path=str(cfg_path), device=args.device)
    out = results / f"quality_{mode}"
    report = json.loads((out / "exp1" / "metrics.json").read_text())
    ctx = exp_main.load_context(build_config(str(cfg_path)), args.device)
    nse = exp3_metrics(ctx.preds, ctx.truth, ctx.eval_mask, mode, args.size, args.device)
    ensure_dir(str(out / "exp3"))
    save_json(str(out / "exp3" / "metrics.json"), nse)
    save_text(str(out / "exp3" / "metrics.txt"), exp_main._format_report(nse))
    return {"exp1": report, "exp3": nse, "seconds": time.perf_counter() - t0}


def table(mode: str, scores: Dict) -> str:
    cols = ("MAE", "RMSE", "PSS", "SSIM", "NSE")
    cats = ("0.5", "4")
    head = ("| method | " + " | ".join(cols) + " | "
            + " | ".join(f"CSI {c} | HSS {c}" for c in cats) + " | exp3 NSE |")
    lines = [f"{mode} mode:", head, "|" + " --- |" * (len(cols) + 2 * len(cats) + 2)]
    for name, row in scores["exp1"].items():
        vals = [f"{row[c]:.6f}" for c in cols]
        for c in cats:
            vals += [f"{row[f'CAT_{c}']['CSI']:.6f}", f"{row[f'CAT_{c}']['HSS']:.6f}"]
        lines.append(f"| {name} | " + " | ".join(vals)
                     + f" | {scores['exp3'][f'NSE_{name}']:.6f} |")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = build_parser().parse_args(argv)
    workdir = args.workdir.resolve()
    if args.fresh and workdir.exists():
        shutil.rmtree(workdir)
    for sub in ("data", "infer", "results"):
        (workdir / sub).mkdir(parents=True, exist_ok=True)
    get_tracker().set_tracking_uri(str(workdir / "mlruns"))
    t_start = time.perf_counter()

    # the convergence smoke's train store and input gauges (its seeds 2 and 3),
    # written here so that the mask holds 79 gauges at every size (dk reads 79)
    data = workdir / "p2igan" / "data"
    train_zarr = data / "nimrod_train.zarr"
    train_mask = data / "masks" / "gauge_mask_128_train.txt"
    if not train_zarr.exists():
        write_train_zarr(train_zarr, n_events=args.train_events, T=args.train_event_frames,
                         H=args.size, W=args.size, window=args.frames, stride=1, seed=2)
    if not train_mask.exists():
        write_gauge_mask(train_mask, H=args.size, W=args.size, n_gauges=N_GAUGES, seed=3)
    test_zarr = write_test_zarr(workdir / "data" / "test_events.zarr",
                                n_events=args.test_events, T=args.test_frames,
                                H=args.size, W=args.size, seed=TEST_SEED)
    test_mask = write_gauge_mask(workdir / "data" / "masks" / "gauge_mask_128_test.txt",
                                 H=args.size, W=args.size, n_gauges=N_GAUGES,
                                 seed=MASK_SEED)

    summary: Dict = {"device": args.device, "card": _card(args.device), "steps": args.steps,
                     "batch": args.batch, "size": args.size, "frames": args.frames,
                     "test_events": args.test_events, "test_frames": args.test_frames}
    smoke = _load_script("convergence_smoke_torch")
    summary["train"] = {"p2igan": train_p2igan(args, smoke, workdir / "p2igan"),
                        "dk": train_dk(args, smoke, workdir / "dk", train_zarr, train_mask)}

    p2igan_cfg = eval_config(args, "p2igan", test_zarr, train_mask, workdir / "p2igan")
    untrained = workdir / "P2IGAN_untrained.pt"
    gen = build_generator_for_inference(
        p2igan_cfg, generator=torch.Generator().manual_seed(UNTRAINED_SEED))
    torch.save(gen.state_dict(), untrained)
    jobs = {"P2IGAN": (p2igan_cfg, workdir / "p2igan" / "weights" / "latest.ckpt"),
            "P2IGAN-untrained": (p2igan_cfg, untrained),
            "DK": (eval_config(args, "dk", test_zarr, train_mask, workdir / "dk"),
                   workdir / "dk" / "weights" / "latest.ckpt")}
    summary["serve"] = {name: serve(args, cfg, ckpt,
                                    workdir / "infer" / f"{name.lower()}.zarr", workdir)
                        for name, (cfg, ckpt) in jobs.items()}
    stores = {name: job["store"] for name, job in summary["serve"].items()}
    summary["modes"] = {mode: score(args, mode, stores, test_zarr, train_mask, test_mask,
                                    workdir / "results") for mode in MODES}
    summary["seconds"] = time.perf_counter() - t_start

    print(f"\nquality on {summary['card'] or args.device}: {args.steps} steps each at "
          f"batch {args.batch}, {args.size}x{args.size}, T={args.frames}; held-out "
          f"{args.test_events} events x {args.test_frames} frames")
    for name, run in summary["train"].items():
        print(f"{name} training: " + json.dumps(run))
    for mode in MODES:
        print(table(mode, summary["modes"][mode]))
    if args.summary is not None:
        args.summary.parent.mkdir(parents=True, exist_ok=True)
        args.summary.write_text(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
