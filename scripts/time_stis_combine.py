"""Time the shared-mask (stis) combine kernels of several source trees on one
card: #2, the forward (``combine_table_multi.cu``), and #4, its backward
(``combine_table_multi_bwd.cu``).

    python scripts/time_stis_combine.py [--tree LABEL=DIR ...] [--diag LABEL=DIR ...]
                                        [--n-tile 1,2,6,12] [--reps 10] [--rounds 2]
                                        [--out FILE]

Each tree is a checkout root (or any directory holding
``p2igan_tpu_torch/csrc``); this checkout is always the tree ``this``, the
last. The trees are built and called as ``time_sti_combine.py`` builds and
calls them: each tree's two sources alone, with its own ``csrc`` as include
directory, and their C entry points called with the arguments matched by name
to the parameters the tree's source declares. A backward whose entry point
takes ``n_tile`` (windows a block) gets the rule of the wrapper that had it,
or each value of ``--n-tile`` (timed beside it; its output must not change);
one that takes ``tile_bytes`` gets this checkout's default budget.

Shapes: full width (D=16, HW=128x128, G=128, k=4) on the 79-gauge mask and on
the tie-heavy regular grid of ``chip_smoke.gauge_masks``: #2 at the serving
window batch N=8 and the training batch N=12, #4 at N=12 (timed); then the
cases of ``tests/test_torch_cuda.py`` (#2's and #4's, on both mask shapes).
For every tree and shape #2 is held bitwise against its plain version, #4
bitwise against its fixed-point model (``combine_table_multi_bwd_fixed_reference``)
and across two calls, and both bitwise against the first tree's outputs. A
``--tree`` that differs is marked ``"ok": false`` and the script exits 1; a
``--diag`` tree (a variant whose output is wrong on purpose, to split the
time) is timed and its differences are only reported.

Timing (``time_sti_combine.time_rounds``): the median CUDA-event time of one
call and the device time of one call in a CUDA-graph replay over input
copies that leave L2 between uses (``chip_smoke.graph_ms``), in A B B A
rounds. Prints the card's name and power limit, the SM clock under load,
each time's share of the bytes bound (``chip_smoke.combine_bound``), then one
JSON line.
"""

from __future__ import annotations

# Allow running as `python scripts/<name>.py` without installing the package.
import sys as _sys
from pathlib import Path as _Path

_repo = str(_Path(__file__).resolve().parents[1])
if _repo not in _sys.path:
    _sys.path.insert(0, _repo)
_scripts = str(_Path(__file__).resolve().parent)
if _scripts not in _sys.path:
    _sys.path.insert(0, _scripts)

import argparse
import json
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

import chip_smoke
from p2igan_tpu_torch.ops import cuda_lib
from p2igan_tpu_torch.ops.idw import factored_prepare_full
from p2igan_tpu_torch.ops.idw_factored_kernel import (BWD_WINDOWS_TILE_BYTES,
                                                      combine_table_multi_bwd_fixed_reference,
                                                      combine_table_multi_reference,
                                                      distinct_frame_table,
                                                      pruned_frame_table)
from time_sti_combine import build, time_rounds

REPO = Path(_repo)
KERNELS = {"fwd": ("combine_table_multi.cu", "p2i_combine_table_multi"),
           "bwd": ("combine_table_multi_bwd.cu", "p2i_combine_table_multi_bwd")}
BUILD = REPO / "build" / "time_stis_combine"
# (label, kernel, windows) of the timed full-width shapes, on each mask
TIMED = (("fwd N=8", "fwd", chip_smoke.WINDOW_BATCH), ("fwd N=12", "fwd", chip_smoke.TRAIN_BATCH),
         ("bwd N=12", "bwd", chip_smoke.TRAIN_BATCH))


def parent_n_tile(N: int, D: int, G: int) -> int:
    """Windows a block of the backward that took them (before the tile of a
    block's own slots): as many as fit in 32 KB of (D, G) totals."""
    return max(1, min(N, (32 * 1024) // (8 * D * G)))


def caller(fn, params, kernel: str, case: dict, n_tile: int = 0):
    """A call ``call(i=0)`` of one tree's entry point on copy i of ``case``'s
    inputs, its arguments by name. ``call.copies``: the copies a timed case
    holds, so that ``chip_smoke.graph_ms`` finds no input still in L2."""
    gd2, gsel = case["gd2"], case["gsel"]
    k, HW = gd2.shape
    D, G, N = case["D"], case["G"], case["N"]
    sel, fd2 = pruned_frame_table(D, k, str(gd2.device))
    vals, vmap = distinct_frame_table(D, k, str(gd2.device))
    named = {"N": N, "D": D, "G": G, "HW": HW, "k": k, "kf": sel.shape[1],
             "nv": vals.shape[0], "rho": 2.0, "tau": 0.05, "rho_is_2": 1,
             "n_tile": n_tile or parent_n_tile(N, D, G), "tile_bytes": BWD_WINDOWS_TILE_BYTES}
    fixed = {"sel": sel, "fd2": fd2, "vals": vals, "vmap": vmap}
    data = "tables" if kernel == "fwd" else "g"
    shape = (N, D, HW) if kernel == "fwd" else (N, D, G)
    copies = case["copies"]

    def call(i: int = 0):
        out = torch.empty(shape, device=gd2.device)
        scratch = cuda_lib.fixed_scratch(N * D * G, N, gd2.device)
        own = {"out": out, "scratch": scratch, "gd2": copies["gd2"][i],
               "gsel": copies["gsel"][i], data: copies[data][i], **fixed}
        named["stream"] = cuda_lib.stream_of(gd2)  # a CUDA graph captures on its own
        args = [own[name].data_ptr() if name in own else named[name] for name, _ in params]
        cuda_lib.check(fn(*args), KERNELS[kernel][1])
        return out
    call.copies = len(copies[data])
    return call


def with_copies(case: dict, kernel: str) -> dict:
    """``case`` with its inputs' copies: one, or for a timed case as many as
    make each copy come back after ``chip_smoke.ROTATE_BYTES`` of traffic
    (inputs read and output written)."""
    data = "tables" if kernel == "fwd" else "g"
    n = 1
    if case["timed"]:
        out = case["N"] * case["D"] * (case["gd2"].shape[1] if kernel == "fwd" else case["G"])
        per_call = 4 * (out + case[data].numel() + 2 * case["gd2"].numel())
        n = -(-chip_smoke.ROTATE_BYTES // per_call)
    case["copies"] = {name: [case[name]] + [case[name].clone() for _ in range(n - 1)]
                      for name in ("gd2", "gsel", data)}
    return case


def cases(dev) -> list:
    """(name, kernel, inputs): the timed full-width shapes, then the card
    tests' cases."""
    _sys.path.insert(0, str(REPO / "tests"))
    from test_torch_cuda import (MULTI_BWD_CASES, MULTI_BWD_SHAPE, MULTI_FWD_CASES,
                                 MULTI_FWD_SHAPE, MULTI_KINDS, MULTI_ODD_SHAPE,
                                 _multi_inputs)

    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    out = []
    hw = chip_smoke.H * chip_smoke.W
    for mask_name, mask in chip_smoke.gauge_masks(dev).items():
        gd2, gsel, _ = factored_prepare_full(mask, chip_smoke.G, k=chip_smoke.K)
        gd2_t, gsel_t = gd2.t().contiguous(), gsel.t().contiguous()
        for label, kernel, n in TIMED:
            case = {"gd2": gd2_t, "gsel": gsel_t, "D": chip_smoke.LENGTH, "G": chip_smoke.G,
                    "N": n, "timed": True}
            size = (n, chip_smoke.LENGTH, chip_smoke.G if kernel == "fwd" else hw)
            case["tables" if kernel == "fwd" else "g"] = torch.randn(size, generator=gen).to(dev)
            out.append((f"{label} {mask_name}", kernel, with_copies(case, kernel)))
    for kernel, shapes, todo in (("fwd", (MULTI_FWD_SHAPE, MULTI_ODD_SHAPE), MULTI_FWD_CASES),
                                 ("bwd", (MULTI_BWD_SHAPE, MULTI_ODD_SHAPE), MULTI_BWD_CASES)):
        for shape in shapes:
            for kind in MULTI_KINDS:
                for D, N, k in todo:
                    gd2_t, gsel_t, rng = _multi_inputs(dev, kind, shape, k, 11)
                    case = {"gd2": gd2_t, "gsel": gsel_t, "D": D, "G": 128, "N": N,
                            "timed": False}
                    size = (N, D, 128 if kernel == "fwd" else gd2_t.shape[1])
                    case["tables" if kernel == "fwd" else "g"] = torch.from_numpy(
                        rng.normal(size=size).astype(np.float32)).to(dev)
                    out.append((f"{kernel} {shape[0]}x{shape[1]} {kind} D={D},N={N},k={k}",
                                kernel, with_copies(case, kernel)))
    return out


def plain(kernel: str, case: dict) -> torch.Tensor:
    """#2's plain version, or #4's fixed-point model: what a tree must equal."""
    k = case["gd2"].shape[0]
    if kernel == "fwd":
        return combine_table_multi_reference(case["gd2"], case["gsel"], case["tables"], k)
    return combine_table_multi_bwd_fixed_reference(case["gd2"], case["gsel"], case["g"],
                                                   case["G"], k)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", action="append", default=[], metavar="LABEL=DIR",
                        help="another source tree to time beside this one")
    parser.add_argument("--diag", action="append", default=[], metavar="LABEL=DIR",
                        help="a diagnostic tree: timed, its differences only reported")
    parser.add_argument("--n-tile", default="",
                        help="comma-separated windows a block to time each tree's "
                             "backward at, where its entry point takes n_tile")
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--rounds", type=int, default=2,
                        help="A B B A rounds: each visits every tree twice")
    parser.add_argument("--out", type=Path, help="also write the JSON line here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_stis_combine: no CUDA GPU available", file=_sys.stderr)
        return 1
    trees, diag = {}, set()
    for item in args.tree + args.diag:
        label, _, root = item.partition("=")
        trees[label] = Path(root).resolve()
        if item in args.diag:
            diag.add(label)
    trees["this"] = REPO  # last: checked and timed after the trees it is held against
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = card.splitlines()[0]
    print(f"card: {card}")
    chip_smoke.set_precision_policy()
    dev = torch.device("cuda", 0)
    built = build(trees, KERNELS, BUILD)
    inputs = cases(dev)
    wants = {name: plain(kernel, case) for name, kernel, case in inputs}
    torch.cuda.synchronize()

    result = {"card": card, "trees": {}}
    failed, reported = [], []
    first = {}
    timed = {}  # shape name -> label -> call
    for label, kernels in built.items():
        out = reported if label in diag else failed
        before = len(out)
        same = {}
        for name, kernel, case in inputs:
            fn, params = kernels[kernel]
            call = caller(fn, params, kernel, case)
            got, again = call(), call()
            torch.cuda.synchronize()
            if not chip_smoke.bitwise_equal(got, wants[name]):
                what = "its plain version" if kernel == "fwd" else "its fixed-point model"
                out.append(f"{label} {name}: not bitwise {what} "
                           f"({int((got != wants[name]).sum())} of {got.numel()} differ)")
            if not chip_smoke.bitwise_equal(got, again):
                out.append(f"{label} {name}: two calls differ")
            ref = first.setdefault(name, (next(iter(built)), got))
            same[name] = chip_smoke.bitwise_equal(got, ref[1])
            if not same[name]:
                out.append(f"{label} {name}: not bitwise equal to {ref[0]}'s output")
            if case["timed"]:
                timed.setdefault(name, {})[label] = call
                if (kernel == "bwd" and label not in diag
                        and any(p == "n_tile" for p, _ in params)):
                    for n_tile in [int(v) for v in args.n_tile.split(",") if v]:
                        variant = caller(fn, params, kernel, case, n_tile=n_tile)
                        if not chip_smoke.bitwise_equal(variant(), got):
                            out.append(f"{label} n_tile={n_tile} {name}: output differs")
                        timed[name][f"{label} n_tile={n_tile}"] = variant
        print(f"{label}{' (diagnostic)' if label in diag else ''}: bitwise equal to "
              f"{next(iter(built))} in {sum(same.values())} of {len(same)} outputs")
        result["trees"][label] = {"ok": len(out) == before, "diagnostic": label in diag,
                                  "bitwise_equal_to_first": same}
    for line in reported:
        print(f"diagnostic: {line}")

    times = time_rounds(timed, args.rounds, args.reps, result)
    result["times"] = {}
    for name, by_label in times.items():
        case = next(c for n, _, c in inputs if n == name)
        bound_ms = chip_smoke.combine_bound(case["N"])["bound_ms"]
        for label, rec in by_label.items():
            rec["median_ms"] = statistics.median(rec["ms"])
            rec["median_graph_ms"] = statistics.median(rec["graph_ms"])
            rec["bound_share"] = bound_ms / rec["median_graph_ms"]
            print(f"{name} {label}: {rec['median_ms']:.4f} ms a call (rounds "
                  f"{[round(v, 4) for v in rec['ms']]}), graph {rec['median_graph_ms']:.4f} ms, "
                  f"{rec['bound_share']:.4f} of the bound {bound_ms:.5f} ms")
            result["times"].setdefault(name, {})[label] = rec
    result["failed"], result["diagnostic_differences"] = failed, reported
    print(card)
    line = json.dumps(result)
    print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    if failed:
        print("time_stis_combine FAILED: " + "; ".join(failed), file=_sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    _sys.exit(main())
