"""Time the per-sample (sti) combine kernels of several source trees on one
card: #5, the forward (``combine_table.cu``), and #6, its backward
(``combine_table_bwd.cu``).

    python scripts/time_sti_combine.py [--tree LABEL=DIR ...] [--iters 1,2,4,8]
                                       [--reps 10] [--rounds 2] [--out FILE]

Each tree is a checkout root (or any directory holding
``p2igan_tpu_torch/csrc``); this checkout is always the tree ``this``, the
last. Each tree's two sources are compiled alone, with the tree's own
``csrc`` as include directory and this checkout's nvcc flags, into a library
of their own (all trees' nvcc processes at once), and their C entry points are
called directly: the arguments are matched by name to the parameters the
tree's source declares, so trees whose entry points take different tables
(the pruned fd2, or the distinct values and their map) run side by side.

Shapes: ``chip_smoke.STI_SHAPES`` (training B=12 and serving B=8 at G=256,
block size 4 at G=1152; full width) and the ``STI_FWD_CASES`` /
``STI_BWD_CASES`` of ``tests/test_torch_cuda.py``. For every tree and shape
the forward is held bitwise against its plain version and both outputs
bitwise against the first tree's; the backward is also held bitwise across
two calls. A tree that differs is marked ``"ok": false`` and the script exits
1. The backward runs with the strips a block (``iters``) that this
checkout's wrapper picks; ``--iters`` also times this tree's backward at each
value given (its output must not change).

Timing, at the ``STI_SHAPES``: the median CUDA-event time of one call over
``--reps`` calls and the device time of one call in a CUDA-graph replay. The
trees are timed in rounds that visit them forward and then backward (A B B
A), and each tree's medians are taken over all its rounds. Prints the card's
name and power limit, the SM clock under load, then one JSON line.
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
from p2igan_tpu_torch.ops.idw_factored_kernel import (bwd_strips, combine_table_reference,
                                                      distinct_frame_table,
                                                      pruned_frame_table)

REPO = Path(_repo)
CSRC = Path("p2igan_tpu_torch") / "csrc"
# kernel -> (source, C entry point)
KERNELS = {"fwd": ("combine_table.cu", "p2i_combine_table"),
           "bwd": ("combine_table_bwd.cu", "p2i_combine_table_bwd")}
BUILD = REPO / "build" / "time_sti_combine"


def entry_params(text: str, entry: str) -> list:
    """(name, ctypes type) of each parameter of ``extern "C" int entry(...)``."""
    m = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", text, re.S)
    if m is None:
        raise SystemExit(f"no entry point {entry} in the source")
    params = []
    for decl in m.group(1).split(","):
        decl = decl.strip()
        name = re.findall(r"\w+", decl)[-1]
        if "*" in decl:
            params.append((name, ctypes.c_void_p))
        elif decl.startswith("long long"):
            params.append((name, ctypes.c_longlong))
        elif decl.startswith("float"):
            params.append((name, ctypes.c_float))
        else:
            params.append((name, ctypes.c_int))
    return params


def build(trees: dict, kernels: dict = KERNELS, out_dir: Path = BUILD) -> dict:
    """label -> kernel -> (entry point, its parameters), every tree compiled at
    once; ``kernels``: kernel -> (source, C entry point)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_lib._nvcc()
    jobs = {}
    for label, root in trees.items():
        csrc = root / CSRC
        for kernel, (source, _) in kernels.items():
            out = out_dir / f"{kernel}.{label}.so"
            cmd = [nvcc, *cuda_lib.NVCC_FLAGS, "-I", str(csrc), "-shared", "-o", str(out),
                   str(csrc / source)]
            jobs[label, kernel] = (csrc / source, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {label: {} for label in trees}
    for (label, kernel), (src, out, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {label} ({src}):\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Function properties" in line:
                print(f"  ptxas [{label} {kernel}]: {line.strip()}")
        entry = kernels[kernel][1]
        params = entry_params(src.read_text(), entry)
        fn = getattr(ctypes.CDLL(str(out)), entry)
        fn.argtypes = [t for _, t in params]
        fn.restype = ctypes.c_int
        built[label][kernel] = (fn, params)
    return built


def caller(fn, params, kernel: str, case: dict, iters: int = 0):
    """A call of one tree's entry point on ``case``, its arguments by name."""
    gd2, gsel = case["gd2"], case["gsel"]
    B, k, HW = gd2.shape
    D, G = case["D"], case["G"]
    sel, fd2 = pruned_frame_table(D, k, str(gd2.device))
    vals, vmap = distinct_frame_table(D, k, str(gd2.device))
    named = {"B": B, "D": D, "G": G, "HW": HW, "k": k, "kf": sel.shape[1],
             "nv": vals.shape[0], "rho": 2.0, "tau": 0.05, "rho_is_2": 1,
             "iters": iters or bwd_strips(D, G)}
    tensors = {"gd2": gd2, "gsel": gsel, "sel": sel, "fd2": fd2, "vals": vals,
               "vmap": vmap}
    if kernel == "fwd":
        tensors["tables"] = case["tables"]
        shape = (B, D, HW)
    else:
        tensors["g"] = case["g"]
        shape = (B, D, G)

    def call():
        out = torch.empty(shape, device=gd2.device)
        scratch = cuda_lib.fixed_scratch(B * D * G, B, gd2.device)
        own = {"out": out, "scratch": scratch, **tensors}
        # the stream of this call (a CUDA graph captures on its own stream)
        named["stream"] = cuda_lib.stream_of(gd2)
        args = [own[name].data_ptr() if name in own else named[name] for name, _ in params]
        cuda_lib.check(fn(*args), KERNELS[kernel][1])
        return out
    return call


def cases(dev) -> dict:
    """name -> inputs: chip_smoke's three full-width shapes (timed), then the
    card tests' cases."""
    _sys.path.insert(0, str(REPO / "tests"))
    from test_torch_cuda import STI_BWD_CASES, STI_FWD_CASES, _sti_selection

    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    out = {}
    for label, batch, block, slots in chip_smoke.STI_SHAPES:
        gd2, gsel = chip_smoke.sti_selection(dev, batch, block, slots)
        out[label] = {"gd2": gd2, "gsel": gsel, "D": chip_smoke.LENGTH, "G": slots,
                      "tables": torch.randn((batch, chip_smoke.LENGTH, slots),
                                            generator=gen).to(dev),
                      "g": torch.randn((batch, chip_smoke.LENGTH, gd2.shape[2]),
                                       generator=gen).to(dev),
                      "timed": True}
    rng = np.random.default_rng(7)
    for D, G, k in sorted(set(STI_FWD_CASES) | set(STI_BWD_CASES)):
        gd2, gsel = _sti_selection(rng, G, k, dev)
        B, HW = gd2.shape[0], gd2.shape[2]
        out[f"D={D},G={G},k={k}"] = {
            "gd2": gd2, "gsel": gsel, "D": D, "G": G,
            "tables": torch.from_numpy(rng.normal(size=(B, D, G)).astype(np.float32)).to(dev),
            "g": torch.from_numpy(rng.normal(size=(B, D, HW)).astype(np.float32)).to(dev),
            "timed": False}
    return out


def time_rounds(timed: dict, rounds: int, reps: int, result: dict) -> dict:
    """key -> label -> {"ms": [...], "graph_ms": [...]}: each call of ``timed``
    (key -> label -> call) timed in ``rounds`` rounds that visit the labels of
    a key forward and then backward (A B B A): the median CUDA-event time of
    one call over ``reps`` calls, and the device time of one call in a
    CUDA-graph replay. The SM clock and power under the rounds go into
    ``result`` and are printed."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "200"],
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    times = {key: {label: {"ms": [], "graph_ms": []} for label in calls}
             for key, calls in timed.items()}
    try:
        for _ in range(rounds):
            for key, calls in timed.items():
                order = list(calls)
                for label in order + order[::-1]:
                    rec = times[key][label]
                    rec["ms"].append(chip_smoke.cuda_ms(calls[label], reps=reps))
                    call = calls[label]
                    copies = getattr(call, "copies", 0)  # call(i) takes input copy i
                    rec["graph_ms"].append(chip_smoke.graph_ms(call, copies) if copies else
                                           chip_smoke.graph_ms(lambda i: call(), 1))
    finally:
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
    return times


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", action="append", default=[], metavar="LABEL=DIR",
                        help="another source tree to time beside this one")
    parser.add_argument("--iters", default="",
                        help="comma-separated strips a block to time this tree's "
                             "backward at, beside the wrapper's choice")
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--rounds", type=int, default=2,
                        help="A B B A rounds: each visits every tree twice")
    parser.add_argument("--out", type=Path, help="also write the JSON line here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_sti_combine: no CUDA GPU available", file=_sys.stderr)
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
    inputs = cases(dev)

    result = {"card": card, "trees": {}}
    failed = []
    first = {}
    timed = {}  # (kernel, shape) -> label -> call
    for label, kernels in built.items():
        before = len(failed)
        same = {}
        for name, case in inputs.items():
            for kernel, (fn, params) in kernels.items():
                call = caller(fn, params, kernel, case)
                got, again = call(), call()
                torch.cuda.synchronize()
                if kernel == "fwd":
                    plain = combine_table_reference(case["gd2"], case["gsel"], case["tables"],
                                                    case["gd2"].shape[1])
                    if not chip_smoke.bitwise_equal(got, plain):
                        failed.append(f"{label} fwd {name}: not bitwise its plain version")
                if not chip_smoke.bitwise_equal(got, again):
                    failed.append(f"{label} {kernel} {name}: two calls differ")
                ref = first.setdefault((kernel, name), (next(iter(built)), got))
                same[f"{kernel} {name}"] = chip_smoke.bitwise_equal(got, ref[1])
                if not same[f"{kernel} {name}"]:
                    failed.append(f"{label} {kernel} {name}: not bitwise equal to {ref[0]}'s "
                                  f"output ({int((got != ref[1]).sum())} of {got.numel()} "
                                  f"differ)")
                if case["timed"]:
                    timed.setdefault((kernel, name), {})[label] = call
        print(f"{label}: bitwise equal to {next(iter(built))} in {sum(same.values())} of "
              f"{len(same)} outputs")
        result["trees"][label] = {"ok": len(failed) == before, "bitwise_equal_to_first": same}

    # this tree's backward at other strips a block: the same bits, timed beside
    fn, params = built["this"]["bwd"]
    for it in [int(v) for v in args.iters.split(",") if v]:
        label = f"this iters={it}"
        for name, case in inputs.items():
            if not case["timed"]:
                continue
            call = caller(fn, params, "bwd", case, iters=it)
            got = call()
            torch.cuda.synchronize()
            if not chip_smoke.bitwise_equal(got, first["bwd", name][1]):
                failed.append(f"{label} bwd {name}: output differs")
            timed["bwd", name][label] = call

    times = time_rounds(timed, args.rounds, args.reps, result)
    result["times"] = {}
    for (kernel, name), by_label in times.items():
        case = inputs[name]
        bound_ms = chip_smoke.sample_combine_bound(case["gd2"].shape[0], case["G"])["bound_ms"]
        for label, rec in by_label.items():
            rec["median_ms"] = statistics.median(rec["ms"])
            rec["median_graph_ms"] = statistics.median(rec["graph_ms"])
            rec["bound_share"] = bound_ms / rec["median_graph_ms"]
            print(f"{kernel} {name} {label}: {rec['median_ms']:.4f} ms a call (rounds "
                  f"{[round(v, 4) for v in rec['ms']]}), graph {rec['median_graph_ms']:.4f} ms, "
                  f"{rec['bound_share']:.4f} of the bound {bound_ms:.5f} ms")
            result["times"].setdefault(f"{kernel} {name}", {})[label] = rec
    result["failed"] = failed
    print(card)
    line = json.dumps(result)
    print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    if failed:
        print("time_sti_combine FAILED: " + "; ".join(failed), file=_sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    _sys.exit(main())
