"""Shared fixtures of the benchmark's tests: a copy of the harness with tiny
cells beside the real ones, and the card's presence decided at run time."""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

HARNESS = CHECKOUT / "portbench"
TINY_SEED = 3000000017


def tiny_copy(dest: Path) -> Path:
    """``dest/portbench``: the harness with a tiny cell beside each real one
    (16x16 frames, T = 4, base 16, batch 4, 6 events of 12 frames) and a
    ``BENCHMARK.json`` that gives the tiny cells the real ones' metrics. Only
    new files are added."""
    root = dest / "portbench"
    shutil.copytree(HARNESS, root, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for path in sorted((root / "configs").glob("*.json")):
        cfg = json.loads(path.read_text())
        for split in ("train", "test"):
            cfg["data"][split]["h"] = cfg["data"][split]["w"] = 16
        cfg["data"]["train"]["sample_length"] = 4
        cfg["model"]["base_channels"] = 16
        cfg["train"].update(batch_size=4, num_workers=2)
        (root / "configs" / f"tiny_{path.name}").write_text(json.dumps(cfg))
    for path in sorted((root / "workloads").glob("*.json")):
        wl = json.loads(path.read_text())
        wl["config"] = "tiny_" + wl["config"]
        wl["traffic"].update(h=16, w=16, n_events=6, event_frames=12)
        if wl["entry"] == "train":
            # 6 events of 9 windows, 44 of them trained: epochs of 11 steps of
            # 4, a log point at each epoch's end, so a window of any length
            # holds whole epochs
            wl["traffic"]["window"] = 4
            wl["train"]["log_step"] = 11
            wl.update(warmup_steps=22, trace_steps=2)
        else:
            wl["serve"].update(stride=4, overlap=3, window_batch=4)
            wl.update(trace_skip=1, trace_events=2)
        (root / "workloads" / f"tiny_{path.name}").write_text(json.dumps(wl))
    spec = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    for section in ("end_to_end", "per_layer"):
        for m in spec[section]:
            if "workloads" in m:
                m["workloads"] += ["tiny_" + w for w in m["workloads"]]
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return tiny_copy(tmp_path_factory.mktemp("portbench_tiny"))


def run_tiny(root: Path, cell: str, trace: int = 0, seed: int = TINY_SEED,
             seconds: float = 1.0) -> dict:
    """One run of a tiny cell on the CPU, the look for a card skipped."""
    from portbench import run

    return run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                     "--trace", str(trace)], root=root, device="cpu",
                    t_process=time.perf_counter())


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda:0"
