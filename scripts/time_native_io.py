"""Time the host-IO core of several source trees on the card's host: the
window read, the host input pipeline alone, and dk / stdk training, with the
reads through each core and through the pure-Python chunk loop.

    python scripts/time_native_io.py [--tree LABEL=DIR ...] [--steps 30]
                                     [--rounds 1] [--out FILE]

Each tree is a checkout root. This checkout is the arm ``this``: its core as
the package builds and loads it (``native.library()``). Another tree's
``p2igan_tpu_torch/native/p2io.cpp`` is built with this checkout's g++ flags
and stands in for this checkout's core (``native._LIB``) while its arm runs.
The arm ``plain`` reads every window by the chunk loop
(``Array._native_reads`` returns False). So two versions of the core and the
loop they replace run on one host in one process.

The training store is ``chip_smoke.py``'s (64-frame events, 16x128x128 uint8
windows at stride 1, zstd chunks of (16, 128, 128)), with as many events as
the training runs need. Every core's windows are first checked bitwise
against the plain loop's. Then each measurement visits the arms forward and
backward (A B C C B A), ``--rounds`` times:

- ms of wall time a window read, every window of the store, on 1 and on 4
  threads;
- the host input pipeline alone (float mode, the config's 4 loader threads):
  windows/s over one epoch;
- for dk and stdk, ``scripts/train_torch.py`` on the shipped gauge config
  (batch 12): 5 warm-up steps, ``--steps`` timed ones (steps/s between the
  trainer's log points), then a torch.profiler window of 6 steps (the
  trainer's device idle share).

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

# Allow running as `python scripts/<name>.py` without installing the package.
import sys as _sys
from pathlib import Path as _Path

_repo = str(_Path(__file__).resolve().parents[1])
if _repo not in _sys.path:
    _sys.path.insert(0, _repo)

import argparse
import concurrent.futures as cf
import contextlib
import gc
import json
import statistics
import subprocess
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

import chip_smoke
from p2igan_tpu_torch.data import native, zarrlite
from p2igan_tpu_torch.data.datamodule import P2IDataModule
from p2igan_tpu_torch.ops import cuda_lib

REPO = Path(_repo)
BUILD = REPO / "build" / "time_native_io"
WARMUP, PROFILE_STEPS = 5, 6
WINDOWS_PER_EVENT = chip_smoke.EVENT_FRAMES - chip_smoke.LENGTH + 1


def build(trees: dict) -> dict:
    """label -> loaded core: this checkout's through the package, every
    other tree's source compiled into a library of its own."""
    BUILD.mkdir(parents=True, exist_ok=True)
    libs = {}
    for label, root in trees.items():
        if root == REPO:
            libs[label] = native.library()
            continue
        out = BUILD / f"libp2io.{label}.so"
        native.build(root / "p2igan_tpu_torch" / "native" / "p2io.cpp", out)
        libs[label] = native.load(out)
    return libs


@contextlib.contextmanager
def reads_through(label: str, libs: dict):
    """Every read of the block through the arm ``label``."""
    if label == "plain":
        with mock.patch.object(zarrlite.Array, "_native_reads", lambda *args: False):
            yield
        return
    saved = native._LIB
    native._LIB = libs[label]
    try:
        yield
    finally:
        native._LIB = saved


def store_windows(cfg: dict) -> list:
    """(array, starts, stops) of every window of the training store."""
    root = zarrlite.open(cfg["data"]["train"]["data_root"], mode="r")
    events = [root["events"][key]["frames"] for key in sorted(root["events"].keys())]
    H, W = chip_smoke.H, chip_smoke.W
    return [(events[e], (s, 0, 0), (s + n, H, W))
            for e, s, n in root["index"]["windows"][:].tolist()]


def read_ms(windows: list, threads: int) -> float:
    """ms of wall time a window, every window read by ``Array.__getitem__``."""
    def read(w):
        arr, starts, stops = w
        return arr[tuple(slice(a, b) for a, b in zip(starts, stops))]

    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(threads) as pool:
        for _ in pool.map(read, windows):
            pass
    return (time.perf_counter() - t0) / len(windows) * 1e3


def train_run(tmp: Path, cfg: dict, model: str, label: str, visit: int, steps: int) -> tuple:
    """One training run: (steps/s over the timed steps, device idle share of
    the profiled window)."""
    train_torch = chip_smoke.load_script("train_torch")
    tag = f"{model}_{label}_{visit}"
    cfg = json.loads(json.dumps(cfg))
    cfg["save_dir"] = str(tmp / f"weights_{tag}")
    cfg["train"].update(iterations=WARMUP + steps + PROFILE_STEPS, log_step=WARMUP,
                        profile_dir=str(tmp / f"profile_{tag}"),
                        profile_start_step=WARMUP + steps, profile_steps=PROFILE_STEPS)
    path = tmp / f"train_{tag}.json"
    path.write_text(json.dumps(cfg))
    trainer = train_torch.main(train_torch.parse_args(
        ["--config", str(path), "--device", "cuda", "--log-level", "WARNING"]))
    times = dict(trainer.log_times)
    if WARMUP not in times or WARMUP + steps not in times:
        raise SystemExit(f"{model} ({label}) logged {trainer.log_times}")
    sps = steps / (times[WARMUP + steps] - times[WARMUP])
    if trainer.global_step != WARMUP + steps + PROFILE_STEPS or \
            not np.isfinite(trainer.last_rec_loss):
        raise SystemExit(f"{model} ({label}) ended at step {trainer.global_step}, "
                         f"loss {trainer.last_rec_loss}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    summary = json.loads((tmp / f"profile_{tag}" / "summary.json").read_text())
    return sps, summary["device_idle_share"]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", action="append", default=[], metavar="LABEL=DIR",
                        help="another checkout root whose core runs beside this one's")
    parser.add_argument("--steps", type=int, default=30,
                        help=f"timed training steps a run, a multiple of {WARMUP}")
    parser.add_argument("--rounds", type=int, default=1,
                        help="A B C C B A rounds: each visits every arm twice")
    parser.add_argument("--out", type=Path, help="also write the JSON line here")
    args = parser.parse_args()
    if args.steps <= 0 or args.steps % WARMUP:
        parser.error(f"--steps must be a positive multiple of {WARMUP} (the log step)")
    if not torch.cuda.is_available():
        print("time_native_io: no CUDA GPU available", file=_sys.stderr)
        return 1
    trees = {"this": REPO}
    for item in args.tree:
        label, _, root = item.partition("=")
        if label in ("this", "plain") or not root:
            raise SystemExit(f"--tree {item}: LABEL=DIR, LABEL neither 'this' nor 'plain'")
        trees[label] = Path(root).resolve()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = card.splitlines()[0]
    print(f"card: {card}")
    chip_smoke.set_precision_policy()
    cuda_lib.library()
    libs = build(trees)
    arms = list(trees) + ["plain"]
    models = list(chip_smoke.DK_FAMILY)
    # enough full batches of the train split (80%) for every run's steps
    batches = WARMUP + args.steps + PROFILE_STEPS + 1
    chip_smoke.TRAIN_EVENTS = -(-batches * chip_smoke.TRAIN_BATCH
                                // int(0.8 * WINDOWS_PER_EVENT)) + 1
    result = {"card": card, "trees": {k: str(v) for k, v in trees.items()},
              "events": chip_smoke.TRAIN_EVENTS, "steps": args.steps, "rounds": args.rounds,
              "arms": {a: {"read_ms": {"1": [], "4": []}, "loader_windows_per_s": [],
                           "train": {m: {"steps_per_s": [], "idle_share": []}
                                     for m in models}} for a in arms}}
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        cfgs = {m: chip_smoke.write_train_tree(tmp, chip_smoke.DK_FAMILY[m][1]) for m in models}
        cfg = cfgs["dk"]
        windows = store_windows(cfg)
        print(f"store: {chip_smoke.TRAIN_EVENTS} events, {len(windows)} windows of "
              f"{chip_smoke.LENGTH}x{chip_smoke.H}x{chip_smoke.W} uint8, chunks "
              f"{windows[0][0].chunks}, codec {windows[0][0].compressor['id']}")
        for label in trees:
            with reads_through(label, libs):
                for arr, starts, stops in windows:
                    if not np.array_equal(arr._read_native(starts, stops),
                                          arr._read_plain(starts, stops)):
                        raise SystemExit(f"{label}: window {starts} differs from the plain loop")
        print(f"every core's {len(windows)} windows bitwise equal to the plain loop")
        order = (arms + arms[::-1]) * args.rounds
        for label in order:
            with reads_through(label, libs):
                for threads in (1, 4):
                    result["arms"][label]["read_ms"][str(threads)].append(
                        read_ms(windows, threads))
        for label in order:
            with reads_through(label, libs):
                result["arms"][label]["loader_windows_per_s"].append(
                    chip_smoke.loader_pass(P2IDataModule(cfg).train_dataloader())[1])
        for model in models:
            for visit, label in enumerate(order):
                with reads_through(label, libs):
                    sps, idle = train_run(tmp, cfgs[model], model, label, visit, args.steps)
                rec = result["arms"][label]["train"][model]
                rec["steps_per_s"].append(sps)
                rec["idle_share"].append(idle)
    for label, rec in result["arms"].items():
        print(f"{label}: read ms a window on 1 thread {rec['read_ms']['1']}, on 4 "
              f"{rec['read_ms']['4']}; loader alone {rec['loader_windows_per_s']} windows/s")
        for model, tr in rec["train"].items():
            tr["median_steps_per_s"] = statistics.median(tr["steps_per_s"])
            tr["median_idle_share"] = statistics.median(tr["idle_share"])
            print(f"{label} {model}: {tr['steps_per_s']} steps/s (median "
                  f"{tr['median_steps_per_s']:.3f}), idle {tr['idle_share']} (median "
                  f"{tr['median_idle_share']:.3f})")
    print(card)
    line = json.dumps(result)
    print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    _sys.exit(main())
