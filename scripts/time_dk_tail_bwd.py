"""Time the dk/stdk MLP tail kernels of several source trees on one card:
#13, the backward (``--kernel bwd``, the default), or #12, the forward
(``--kernel fwd``).

    python scripts/time_dk_tail_bwd.py [--kernel fwd|bwd] [--tree LABEL=DIR ...]
                                       [--reps 10] [--rounds 2] [--out FILE]

Each tree is a checkout root; this checkout is always the tree ``this``, the
last. The tree's kernel source (``p2igan_tpu_torch/csrc/dk_mlp_tail_bwd.cu``
or ``dk_mlp_tail.cu``) is compiled alone, with this checkout's nvcc flags,
into a library of its own (all trees' nvcc processes at once), and its C
entry point is called directly. So two versions of a kernel (say the parent
commit's, unpacked with ``git archive`` into an ignored directory, and this
one) are compared on one card in one process.

bwd: ``chip_smoke.py``'s training-shape inputs (J = 192, HW = 16384, h =
100). For every tree the seven gradients against the plain version on the
card (``chip_smoke.py``'s tolerances: 1e-4 x max|plain| for dphi and doff,
1e-3 for the weight and bias gradients; a tree outside them is still timed,
marked ``"ok": false``, and the script exits 1) and a bitwise repeat.

fwd: ``chip_smoke.py``'s inputs at J = 128 (serving) and J = 192 (training)
and every ``TAIL_SHAPES`` case of ``tests/test_torch_cuda.py``. For every
tree the output against the plain version (1e-5 x max|plain|), a bitwise
repeat, and whether it is bitwise equal to the first tree's output at every
shape: a tree that is not (or fails either check) is marked ``"ok": false``
and the script exits 1. Timed at the two full-width shapes.

Timing: the median CUDA-event time of one call over ``--reps`` calls and the
device time of one call in a CUDA-graph replay. The trees are timed in rounds
that visit them forward and then backward (A B B A), and each tree's medians
are taken over all its rounds. Prints the card's name and power limit, then
one JSON line.
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
from p2igan_tpu_torch.ops.dk_mlp_kernel import mlp_tail_bwd_reference, mlp_tail_reference

REPO = Path(_repo)
CSRC = Path("p2igan_tpu_torch") / "csrc"
# kernel -> (source, C entry point, its argument types)
KERNELS = {
    "bwd": ("dk_mlp_tail_bwd.cu", "p2i_dk_mlp_tail_bwd",
            [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
    "fwd": ("dk_mlp_tail.cu", "p2i_dk_mlp_tail",
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
}
BUILD = REPO / "build" / "time_dk_tail_bwd"
NAMES = ("dphi", "doff", "dfc2", "db2", "dfc3", "db3", "dfc4")


def build(trees: dict, kernel: str) -> dict:
    """label -> (loaded entry point, its source's text), every tree compiled at once."""
    BUILD.mkdir(parents=True, exist_ok=True)
    source, entry, argtypes = KERNELS[kernel]
    nvcc = cuda_lib._nvcc()
    jobs = {}
    for label, root in trees.items():
        src = root / CSRC / source
        out = BUILD / f"{kernel}.{label}.so"
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
        fn = getattr(ctypes.CDLL(str(out)), entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        built[label] = (fn, src.read_text())
    return built


def bwd_caller(fn, rows: int, args):
    """A call of one tree's #13 entry point with the wrapper's scratch layout."""
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


def fwd_caller(fn, args):
    """A call of one tree's #12 entry point: (J, HW) out."""
    phi, off = args[0], args[1]
    (HW, h), J = phi.shape, off.shape[0]

    def call():
        out = torch.empty((J, HW), device=phi.device)
        rc = fn(*(t.data_ptr() for t in args), out.data_ptr(), HW, J, h,
                cuda_lib.stream_of(phi))
        cuda_lib.check(rc, "p2i_dk_mlp_tail")
        return out
    return call


def check_bwd(built, dev, result, failed) -> dict:
    """#13 at the training shape; returns label -> call to time."""
    inputs = chip_smoke.dk_tail_inputs(dev, chip_smoke.TRAIN_BATCH)
    phi, off, fc2, b2, fc3, b3, fc4, _ = inputs
    J, HW, h = off.shape[0], phi.shape[0], phi.shape[1]
    g = torch.from_numpy(np.random.default_rng(chip_smoke.SEED + 8).standard_normal(
        (J, HW)).astype(np.float32)).to(dev)
    tail = (phi, off, g, fc2, b2, fc3, b3, fc4)
    want = mlp_tail_bwd_reference(*tail)
    calls = {}
    for label, (fn, text) in built.items():
        rows = int(re.search(r"constexpr int kRows = (\d+);", text).group(1))
        call = calls[label] = bwd_caller(fn, rows, tail)
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
        result["trees"][label] = {"pixels_a_block": rows, "ok": len(failed) == before,
                                  "err_x_max_plain": errs}
    result.update(J=J, HW=HW, h=h, shapes={f"J={J}": calls},
                  flops={f"J={J}": J * HW * (12 * h * h + 10 * h)})
    return result


def check_fwd(built, dev, result, failed) -> dict:
    """#12 at chip_smoke's two shapes and the card tests' TAIL_SHAPES."""
    _sys.path.insert(0, str(REPO / "tests"))
    from test_torch_cuda import TAIL_SHAPES, _tail_inputs

    cases = {f"J={b * chip_smoke.LENGTH}": chip_smoke.dk_tail_inputs(dev, b)
             for b in (chip_smoke.WINDOW_BATCH, chip_smoke.TRAIN_BATCH)}
    timed = list(cases)
    for HW, J, h in TAIL_SHAPES:
        cases[f"HW={HW},J={J},h={h}"] = _tail_inputs(HW, J, h, dev)
    first = {}
    shapes = {name: {} for name in timed}
    for label, (fn, _) in built.items():
        before = len(failed)
        errs, same = {}, {}
        for name, args in cases.items():
            call = fwd_caller(fn, args)
            got, again = call(), call()
            plain = mlp_tail_reference(*args)
            torch.cuda.synchronize()
            scale = float(plain.abs().max())
            errs[name] = float((got - plain).abs().max()) / scale
            if not errs[name] <= 1e-5:
                failed.append(f"{label} {name}: off by {errs[name]:.3e} x max|plain| (> 1e-5)")
            if not chip_smoke.bitwise_equal(got, again):
                failed.append(f"{label} {name}: two calls differ")
            ref = first.setdefault(name, (next(iter(built)), got))
            same[name] = chip_smoke.bitwise_equal(got, ref[1])
            if not same[name]:
                failed.append(f"{label} {name}: not bitwise equal to {ref[0]}'s output "
                              f"({int((got != ref[1]).sum())} of {got.numel()} differ)")
            if name in shapes:
                shapes[name][label] = call
        print(f"{label}: bitwise equal to {next(iter(built))} at "
              f"{sum(same.values())} of {len(same)} shapes; max err x max|plain| "
              + ", ".join(f"{k} {v:.1e}" for k, v in errs.items()))
        result["trees"][label] = {"ok": len(failed) == before, "err_x_max_plain": errs,
                                  "bitwise_equal_to_first": same}
    flops = {}
    for name in timed:
        phi, off = cases[name][0], cases[name][1]
        (HW, h), J = phi.shape, off.shape[0]
        flops[name] = J * HW * (4 * h * h + 4 * h)
    result.update(shapes=shapes, flops=flops)
    return result


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernel", choices=sorted(KERNELS), default="bwd",
                        help="bwd: #13 (dk_mlp_tail_bwd.cu); fwd: #12 (dk_mlp_tail.cu)")
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
    built = build(trees, args.kernel)

    result = {"card": card, "kernel": args.kernel, "trees": {}}
    failed = []
    check = check_fwd if args.kernel == "fwd" else check_bwd
    check(built, dev, result, failed)
    shapes = result.pop("shapes")
    order = list(result["trees"])
    times = {name: {label: {"ms": [], "graph_ms": []} for label in order}
             for name in shapes}
    # the SM clock and power under the timing rounds' load, every 200 ms
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "200"],
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    for _ in range(args.rounds):
        for label in order + order[::-1]:
            for name, calls in shapes.items():
                rec = times[name][label]
                rec["ms"].append(chip_smoke.cuda_ms(calls[label], reps=args.reps))
                rec["graph_ms"].append(chip_smoke.graph_ms(lambda i: calls[label](), 1))
    smi.terminate()
    samples = []
    for line in smi.communicate()[0].splitlines():
        try:
            clock, power = (float(v) for v in line.split(","))
        except ValueError:         # a field the card does not report
            continue
        samples.append((clock, power))
    if samples:
        result["sm_clock_mhz_median"] = statistics.median(a for a, _ in samples)
        result["power_w_median"] = statistics.median(b for _, b in samples)
        print(f"under the timing rounds: SM clock median {result['sm_clock_mhz_median']:.0f} "
              f"MHz, power median {result['power_w_median']:.1f} W ({len(samples)} samples)")
    result["float32_bound_ms"] = {}
    for name, by_label in times.items():
        flops = result["flops"][name]
        bound_ms = flops / chip_smoke.PEAK_FLOPS * 1e3
        result["float32_bound_ms"][name] = bound_ms
        for label, rec in by_label.items():
            rec["median_ms"] = statistics.median(rec["ms"])
            rec["median_graph_ms"] = statistics.median(rec["graph_ms"])
            rec["tflops"] = flops / rec["median_ms"] / 1e9
            rec["bound_share"] = bound_ms / rec["median_ms"]
            print(f"{label} {name}: {rec['median_ms']:.4f} ms a call (rounds {rec['ms']}), "
                  f"graph {rec['median_graph_ms']:.4f} ms, {rec['tflops']:.1f} TFLOP/s, "
                  f"{rec['bound_share']:.3f} of the float32 bound {bound_ms:.4f} ms")
            result["trees"][label].setdefault("times", {})[name] = rec
    if args.kernel == "bwd":
        flops = next(iter(result["flops"].values()))
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
