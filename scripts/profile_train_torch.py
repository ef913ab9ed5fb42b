"""Profile the port's hinge-GAN train step (the counterpart of ``scripts/profile_train.py``).

    python scripts/profile_train_torch.py                         # on the card, batch 12
    python scripts/profile_train_torch.py --deterministic off     # cuDNN free to choose
    python scripts/profile_train_torch.py --device cpu --size 16 --frames 4 --base 16 --batch 2

The step of ``p2igan_tpu_torch/config/p2igan_gan_baseline_gauge.json``
(``training/steps.py`` ``build_train_step``: one generator forward, the
fused critic step, the generator step; the stis gauge selection hoisted as
the trainer hoists it) at 128x128, T=16, base 64, batch 12. It prints the
step's time (CUDA events, mean of ``--reps``), the device time of
``--trace-steps`` steps by family (``utils.profiling.device_time_by_family``),
the cuDNN kernels that take the most of it, each beside the module whose
forward launched it (or whose forward op its backward belongs to), and the
data gradient's time by module.

``--deterministic off`` sets ``cudnn.deterministic`` off for this process:
a measurement only, the port's policy (``set_precision_policy``) stays
deterministic. It never writes PROFILE.md: it prints, and ``--out`` writes
the same text to a file. ``--device`` defaults to ``cuda`` and raises
without a GPU.
"""

from __future__ import annotations

# Allow running as `python scripts/<name>.py` without installing the package.
import sys as _sys
from pathlib import Path as _Path

_repo = str(_Path(__file__).resolve().parents[1])
if _repo not in _sys.path:
    _sys.path.insert(0, _repo)

import argparse
import tempfile
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

from p2igan_tpu_torch.inference.driver import set_precision_policy
from p2igan_tpu_torch.parallel.mesh import resolve_device
from p2igan_tpu_torch.utils import profiling


# rows of the kernel and module tables
TOP = 12


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--out", type=Path, default=None, help="also write the tables here")
    ap.add_argument("--batch", type=int, default=12)
    ap.add_argument("--size", type=int, default=128, help="H = W")
    ap.add_argument("--frames", type=int, default=16, help="T, the window length")
    ap.add_argument("--base", type=int, default=64, help="base channels (4 x T)")
    ap.add_argument("--reps", type=int, default=5, help="timed steps")
    ap.add_argument("--trace-steps", type=int, default=3)
    ap.add_argument("--deterministic", choices=("on", "off"), default="on",
                    help="cudnn.deterministic for this measurement (the port's policy: on)")
    return ap


def profile_step(args, dev: torch.device) -> Dict[str, object]:
    H = W = args.size
    with tempfile.TemporaryDirectory() as tmp:
        cfg = profiling.gan_config(Path(tmp), H, W, args.frames, args.base,
                                   profiling.default_gauges(H, W))
        step = profiling.GanStep(cfg, args.batch, dev)
    sec = profiling.timeit(step, reps=args.reps, warmup=2, device=dev)
    with profiling.module_ranges(step.modules()):
        trace = profiling.capture_trace(step, reps=args.trace_steps, warmup=1, device=dev)
    fams = profiling.device_time_by_family(trace, with_modules=True)
    return {"step_s": sec, "families": fams, "step": step}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    set_precision_policy()
    if args.deterministic == "off":
        torch.backends.cudnn.deterministic = False
    res = profile_step(args, dev)
    fams, sec = res["families"], res["step_s"]
    n = args.trace_steps
    lines = [f"# The port's GAN train step on {profiling.describe_device(dev)}", "",
             f"p2igan_gan_baseline_gauge.json at {args.size}x{args.size}, T={args.frames}, "
             f"base {args.base}, batch {args.batch}, hinge; TF32 off, cuDNN deterministic "
             f"{args.deterministic}.", "",
             f"Step: {sec * 1e3:.3f} ms ({1.0 / sec:.3f} steps/s, mean of {args.reps}).", "",
             f"## Device time by family ({n} steps, torch.profiler)", ""]
    lines += profiling.family_table(fams, f"{n} steps")
    total = fams["device_total_us"]
    records = fams["records"]
    conv = [r for r in records if r["family"].startswith("cuDNN")]
    by_kernel: Dict[tuple, float] = defaultdict(float)
    for r in conv:
        by_kernel[(r["name"], r["module"] or "(not attributed)")] += r["us"]
    conv_us = sum(r["us"] for r in conv)
    attributed = sum(r["us"] for r in conv if r["module"])
    lines += ["", f"## The top cuDNN kernels and the modules that launched them ({n} steps)",
              "", "| kernel | module | ms | share of device time |", "| --- | --- | --- | --- |"]
    for (name, module), us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:TOP]:
        lines.append(f"| `{name[:90]}` | {module} | {us / 1e3:.4f} | "
                     f"{us / total if total else 0.0:.4f} |")
    lines += ["", f"cuDNN: {conv_us / 1e3:.4f} ms, of it {attributed / 1e3:.4f} ms attributed "
                  f"to a module ({attributed / conv_us if conv_us else 0.0:.4f})."]
    dgrad: Dict[str, float] = defaultdict(float)
    for r in records:
        if r["family"] == profiling.CONV_DGRAD:
            dgrad[r["module"] or "(not attributed)"] += r["us"]
    dgrad_us = sum(dgrad.values())
    lines += ["", f"## The convolutions' data gradient by module ({n} steps)", "",
              "| module | ms | share of the data gradient | share of device time |",
              "| --- | --- | --- | --- |"]
    for module, us in sorted(dgrad.items(), key=lambda kv: -kv[1])[:TOP]:
        lines.append(f"| {module} | {us / 1e3:.4f} | {us / dgrad_us:.4f} | "
                     f"{us / total if total else 0.0:.4f} |")
    roll: Dict[str, float] = defaultdict(float)
    for module, us in dgrad.items():
        roll[".".join(module.split(" ")[0].split(".")[:2])] += us
    if roll:
        lines += ["", "By block: " + "; ".join(
            f"{k} {us / 1e3:.4f} ms ({us / dgrad_us:.4f})"
            for k, us in sorted(roll.items(), key=lambda kv: -kv[1]))]
    profiling.write_out(args.out, lines)
    return {"step_s": sec, "families": fams, "lines": lines}


if __name__ == "__main__":
    main()
