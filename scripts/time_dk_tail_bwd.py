"""Time kernel #13, the DK/STDK MLP tail backward, of several source trees on one card.

    python scripts/time_dk_tail_bwd.py [--tree LABEL=DIR ...] [--reps 10] [--out FILE]

Each tree is a checkout root; this checkout is always the tree ``this``. The
tree's ``p2igan_tpu_torch/csrc/dk_mlp_tail_bwd.cu`` is compiled alone, with
this checkout's nvcc flags, into a library of its own (all trees' nvcc
processes at once), and its C entry point is called on ``chip_smoke.py``'s
training-shape inputs (J = 192, HW = 16384, h = 100). So two versions of the
kernel (say the parent commit's, unpacked with ``git archive`` into an ignored
directory, and this one) are compared on one card in one process.

For every tree: the seven gradients against the plain version on the card
(``chip_smoke.py``'s tolerances: 1e-4 x max|plain| for dphi and doff, 1e-3 for
the weight and bias gradients; a tree outside them is still timed, marked
``"ok": false``, and the script exits 1), a bitwise repeat, the median CUDA-event time of
one call over ``--reps`` calls and the device time of one call in a CUDA-graph
replay. The trees are timed in rounds that visit them forward and then
backward (A B B A), and each tree's medians are taken over all its rounds.
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
import ctypes
import json
import re
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

import chip_smoke
from p2igan_tpu_torch.ops import cuda_lib
from p2igan_tpu_torch.ops.dk_mlp_kernel import mlp_tail_bwd_reference

REPO = Path(_repo)
SOURCE = Path("p2igan_tpu_torch") / "csrc" / "dk_mlp_tail_bwd.cu"
BUILD = REPO / "build" / "time_dk_tail_bwd"
NAMES = ("dphi", "doff", "dfc2", "db2", "dfc3", "db3", "dfc4")


def build(trees: dict) -> dict:
    """label -> (loaded entry point, pixels a block), every tree compiled at once."""
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_lib._nvcc()
    jobs = {}
    for label, root in trees.items():
        src = root / SOURCE
        out = BUILD / f"{label}.so"
        cmd = [nvcc, *cuda_lib.NVCC_FLAGS, "-shared", "-o", str(out), str(src)]
        jobs[label] = (src, out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True))
    built = {}
    for label, (src, out, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {label} ({src}):\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas [{label}]: {line.strip()}")
        rows = int(re.search(r"constexpr int kRows = (\d+);", src.read_text()).group(1))
        fn = ctypes.CDLL(str(out)).p2i_dk_mlp_tail_bwd
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        built[label] = (fn, rows)
    return built


def caller(fn, rows: int, args):
    """A call of one tree's entry point with the wrapper's scratch layout."""
    phi, off, g, fc2, b2, fc3, b3, fc4 = args
    (HW, h), J = phi.shape, off.shape[0]
    nblk = -(-HW // rows)
    wlen, hh = 2 * h * h + 3 * h, h * h

    def call():
        new = lambda *shape: torch.empty(shape, device=phi.device)  # noqa: E731
        dphi, doff, wgrad = new(HW, h), new(J, h), new(wlen)
        doff_parts, w_parts = new(nblk, J, h), new(nblk, wlen)
        rc = fn(*(t.data_ptr() for t in (phi, off, g, fc2, b2, fc3, b3, fc4, dphi,
                                        doff_parts, w_parts, doff, wgrad)),
                HW, J, h, nblk, cuda_lib.stream_of(phi))
        cuda_lib.check(rc, "p2i_dk_mlp_tail_bwd")
        return (dphi, doff, wgrad[:hh].view(h, h), wgrad[2 * hh + h:2 * hh + 2 * h],
                wgrad[hh:2 * hh].view(h, h), wgrad[2 * hh + 2 * h:],
                wgrad[2 * hh:2 * hh + h])
    return call


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", action="append", default=[], metavar="LABEL=DIR",
                        help="another checkout root to time beside this one")
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--rounds", type=int, default=2,
                        help="A B B A rounds: each visits every tree twice")
    parser.add_argument("--out", type=Path, help="also write the JSON line here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_dk_tail_bwd: no CUDA GPU available", file=_sys.stderr)
        return 1
    trees = {}
    for item in args.tree:
        label, _, root = item.partition("=")
        trees[label] = Path(root).resolve()
    trees["this"] = REPO  # last: checked and timed after the trees it is held against
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = card.splitlines()[0]
    print(f"card: {card}")
    chip_smoke.set_precision_policy()
    dev = torch.device("cuda", 0)
    built = build(trees)

    inputs = chip_smoke.dk_tail_inputs(dev, chip_smoke.TRAIN_BATCH)
    phi, off, fc2, b2, fc3, b3, fc4, _ = inputs
    J, HW, h = off.shape[0], phi.shape[0], phi.shape[1]
    g = torch.from_numpy(np.random.default_rng(chip_smoke.SEED + 8).standard_normal(
        (J, HW)).astype(np.float32)).to(dev)
    tail = (phi, off, g, fc2, b2, fc3, b3, fc4)
    want = mlp_tail_bwd_reference(*tail)
    calls = {label: caller(fn, rows, tail) for label, (fn, rows) in built.items()}

    result = {"card": card, "J": J, "HW": HW, "h": h, "trees": {}}
    failed = []
    for label, call in calls.items():
        before = len(failed)
        got, again = call(), call()
        torch.cuda.synchronize()
        errs = {}
        for name, a, b in zip(NAMES, got, want):
            scale = float(b.abs().max())
            errs[name] = float((a - b).abs().max()) / scale
            tol = 1e-4 if name in ("dphi", "doff") else 1e-3
            if not errs[name] <= tol:
                failed.append(f"{label}: {name} off by {errs[name]:.3e} x max|plain| "
                              f"(> {tol})")
        if not all(chip_smoke.bitwise_equal(a, b) for a, b in zip(got, again)):
            failed.append(f"{label}: two calls differ")
        print(f"{label}: max err x max|plain| "
              + ", ".join(f"{k} {v:.1e}" for k, v in errs.items()))
        result["trees"][label] = {"pixels_a_block": built[label][1], "ok": len(failed) == before,
                                  "err_x_max_plain": errs, "ms": [], "graph_ms": []}
    order = list(result["trees"])
    for _ in range(args.rounds):
        for label in order + order[::-1]:
            rec = result["trees"][label]
            rec["ms"].append(chip_smoke.cuda_ms(calls[label], reps=args.reps))
            rec["graph_ms"].append(chip_smoke.graph_ms(lambda i: calls[label](), 1))
    flops = J * HW * (12 * h * h + 10 * h)
    for label, rec in result["trees"].items():
        rec["median_ms"] = statistics.median(rec["ms"])
        rec["median_graph_ms"] = statistics.median(rec["graph_ms"])
        rec["tflops"] = flops / rec["median_ms"] / 1e9
        print(f"{label}: {rec['median_ms']:.4f} ms a call (rounds {rec['ms']}), graph "
              f"{rec['median_graph_ms']:.4f} ms, {rec['tflops']:.1f} TFLOP/s")
    result["float32_bound_ms"] = flops / chip_smoke.PEAK_FLOPS * 1e3
    result["tf32x3_ideal_ms"] = 3 * flops / chip_smoke.PEAK_TF32_FLOPS * 1e3
    result["failed"] = failed
    print(card)
    line = json.dumps(result)
    print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    if failed:
        print("time_dk_tail_bwd FAILED: " + "; ".join(failed), file=_sys.stderr)
        return 1
    return 0

if __name__ == "__main__":
    _sys.exit(main())
