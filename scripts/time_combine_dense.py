"""Time the dense-field IDW combine (#7, ``combine_dense.cu``) of several source
trees on one card.

    python scripts/time_combine_dense.py [--tree LABEL=DIR ...] [--diag LABEL=DIR ...]
                                         [--spans 1,2,4,8,16] [--reps 10] [--rounds 2]
                                         [--host-calls 1000] [--out FILE]

Each tree is a checkout root (or any directory holding
``p2igan_tpu_torch/ops`` and ``p2igan_tpu_torch/csrc``); this checkout is
always the tree ``this``, the last. Each tree's ``combine_dense.cu`` is built
alone, with its own ``csrc`` as include directory
(``time_sti_combine.build``), and called through the tree's own wrapper
(``ops/idw_factored_kernel.py``), loaded with a ``cuda_lib`` whose library is
that tree's build: so a tree's host work is timed with its kernel.

Shapes. Timed: one full-width window (16, 128, 128), k=4, under the block-10
sti mask (G=256) and the block-4 one (G=1152), made as
``chip_smoke.check_combine_dense`` makes them. Checked only: windows of
17 x 29 and 24 x 40 pixels at (D, k) = (16, 4), (13, 4), (5, 4), (4, 4),
(1, 4), (16, 3), (5, 3) and (16, 1) under four masks (79 random gauges, a grid,
2 gauges, none), so that a warp's span of frames ends short and the pixels
fill no whole block. Every output is held bitwise against the plain version
(``combine_dense_reference``), against the first tree's output and across
two calls. A ``--tree`` that differs is marked ``"ok": false`` and the
script exits 1. A ``--diag`` tree (a variant whose output is wrong on
purpose, to split the time) runs the timed shapes only, and its differences
are only reported.

Timing (``time_sti_combine.time_rounds``): the median CUDA-event time of one
call and the device time of one call in a CUDA-graph replay over input
copies that leave L2 between uses (``chip_smoke.graph_ms``), in A B B A
rounds; this tree also at each of ``--spans`` (frames a warp walks) beside
the wrapper's choice. Then the host time a call: ``time.perf_counter`` over
``--host-calls`` calls of each tree's wrapper, with no synchronization
inside the loop, and beside them the parts of a call (the plan lookup, the
output allocation, the device check and the device context, the C entry
point alone). Prints the card's name and power limit, the SM clock under
load, each device time's share of the bound (``chip_smoke.dense_bound``),
then one JSON line.
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
import importlib
import json
import re
import statistics
import subprocess
import types
from pathlib import Path

import numpy as np
import torch

import chip_smoke
from p2igan_tpu_torch.ops import cuda_lib
from p2igan_tpu_torch.ops.idw import factored_prepare
from p2igan_tpu_torch.ops.idw_factored_kernel import combine_dense_reference
from time_enc0_decode import host_us
from time_sti_combine import build, time_rounds

REPO = Path(_repo)
KERNELS = {"dense": ("combine_dense.cu", "p2i_combine_dense")}
BUILD = REPO / "build" / "time_combine_dense"
CHECKED = [(16, 4), (13, 4), (5, 4), (4, 4), (1, 4), (16, 3), (5, 3), (16, 1)]
MASKS = ("79", "grid", "2", "empty")


def tree_module(label: str, root: Path, lib: dict):
    """The tree's ``idw_factored_kernel`` module, its package loaded as a
    package of its own whose ``cuda_lib`` hands out the tree's built entry
    point."""
    pkg = "_tree_" + re.sub(r"\W", "_", label)
    package = types.ModuleType(pkg)
    package.__path__ = [str(root / "p2igan_tpu_torch" / "ops")]
    shim = types.ModuleType(pkg + ".cuda_lib")
    shim.__dict__.update({k: v for k, v in vars(cuda_lib).items() if not k.startswith("__")})
    entries = types.SimpleNamespace(**{KERNELS[k][1]: fn for k, (fn, _) in lib.items()})
    shim.library = lambda: entries
    package.cuda_lib = shim
    _sys.modules[pkg], _sys.modules[pkg + ".cuda_lib"] = package, shim
    return importlib.import_module(pkg + ".idw_factored_kernel")


def mask_of(kind: str, H: int, W: int, rng) -> np.ndarray:
    m = np.zeros((H, W), np.float32)
    if kind == "grid":
        m[2::4, 1::4] = 1.0
    elif kind != "empty":
        m.reshape(-1)[rng.choice(H * W, int(kind), replace=False)] = 1.0
    return m


def with_copies(case: dict) -> dict:
    """``case`` with copies of (gd2_t, cvals_t): one, or for a timed case as
    many as ``chip_smoke.dense_copies`` makes."""
    pair = (case["gd2_t"], case["cvals_t"])
    case["copies"] = chip_smoke.dense_copies(*pair) if case["timed"] else [pair]
    return case


def cases(dev) -> list:
    """(name, case) of every shape: the timed windows first."""
    out = []
    gen = torch.Generator().manual_seed(chip_smoke.SEED + 2)
    for block, slots in ((chip_smoke.STI_BLOCK, chip_smoke.STI_G),
                         (chip_smoke.STI_DENSE_BLOCK, chip_smoke.STI_DENSE_G)):
        gd2_t, cvals_t = chip_smoke.dense_case(dev, block, slots, gen)
        out.append((f"window (16, 128, 128) k=4 sti block {block} G={slots}",
                    with_copies({"gd2_t": gd2_t, "cvals_t": cvals_t, "k": chip_smoke.K,
                                 "timed": True})))
    rng = np.random.default_rng(7)
    for H, W in ((17, 29), (24, 40)):
        for D, k in CHECKED:
            for kind in MASKS:
                mask = torch.from_numpy(mask_of(kind, H, W, rng)).to(dev)
                values = torch.from_numpy(rng.normal(size=(D, H * W)).astype(np.float32)).to(dev)
                gd2, gpix = factored_prepare(mask, 128, k=k)
                cvals_t = values[:, gpix.long()].permute(0, 2, 1).reshape(D * k, H * W)
                out.append((f"({D}, {H}, {W}) k={k} mask {kind}",
                            with_copies({"gd2_t": gd2.t().contiguous(),
                                         "cvals_t": cvals_t.contiguous(), "k": k,
                                         "timed": False})))
    return out


def caller(fn, case: dict):
    """``call(i=0)``: ``fn(gd2_t, cvals_t, k)`` on copy i of the case's
    inputs; ``call.copies`` as ``graph_ms`` wants."""
    def call(i: int = 0):
        with torch.no_grad():
            return fn(*case["copies"][i], case["k"])
    call.copies = len(case["copies"])
    return call


def span_fn(module, span: int):
    """The tree's wrapper with the frames a warp walks set to ``span``."""
    return lambda gd2_t, cvals_t, k: module._combine_dense_cuda(gd2_t, cvals_t, k, 2.0,
                                                                0.05, span=span)


def host_parts(modules: dict, built: dict, case: dict, calls: int) -> dict:
    """Host us a call at one timed case: each tree's wrapper, and the parts of a
    call of this tree (and the parent's plan lookup where a tree has it)."""
    gd2_t, cvals_t, k = case["gd2_t"], case["cvals_t"], case["k"]
    dev = gd2_t.device
    D, HW = cvals_t.shape[0] // k, gd2_t.shape[1]
    out = {label: host_us(lambda m=m: m.combine_dense(gd2_t, cvals_t, k), calls)
           for label, m in modules.items()}
    this = modules["this"]
    for label, m in modules.items():
        if hasattr(m, "_frame_table") and not hasattr(m, "dense_plan"):
            out[f"_frame_table ({label})"] = host_us(
                lambda m=m: m._frame_table("combine_dense", D, k, dev), calls)
    out["_combine_dense_cuda (this)"] = host_us(
        lambda: this._combine_dense_cuda(gd2_t, cvals_t, k, 2.0, 0.05), calls)
    out["_CombineDense.apply (this)"] = host_us(
        lambda: this._CombineDense.apply(gd2_t, cvals_t, k, 2.0, 0.05), calls)
    out["dense_plan (this)"] = host_us(lambda: this.dense_plan(D, k, dev), calls)
    out["require_cuda"] = host_us(lambda: cuda_lib.require_cuda("x", gd2_t, cvals_t), calls)
    out["torch.empty"] = host_us(lambda: torch.empty((D, HW), device=dev), calls)
    out["torch.cuda.current_device"] = host_us(torch.cuda.current_device, calls)

    def context():
        with torch.cuda.device(dev):
            pass
    out["with torch.cuda.device"] = host_us(context, calls)
    out["stream_of"] = host_us(lambda: cuda_lib.stream_of(gd2_t), calls)
    fn, params = built["this"]["dense"]
    sel, vals, vmap, kf, nv, span = this.dense_plan(D, k, dev)
    res = torch.empty((D, HW), device=dev)
    named = {"gd2": gd2_t, "cvals": cvals_t, "sel": sel, "vals": vals, "vmap": vmap,
             "out": res, "D": D, "HW": HW, "k": k, "kf": kf, "nv": nv, "span": span,
             "rho": 2.0, "tau": 0.05, "rho_is_2": 1, "stream": cuda_lib.stream_of(gd2_t)}
    args = [named[n].data_ptr() if isinstance(named[n], torch.Tensor) else named[n]
            for n, _ in params]
    out["entry point alone (this)"] = host_us(lambda: fn(*args), calls)
    torch.cuda.synchronize()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", action="append", default=[], metavar="LABEL=DIR",
                        help="another source tree to time beside this one")
    parser.add_argument("--diag", action="append", default=[], metavar="LABEL=DIR",
                        help="a diagnostic tree: timed, its differences only reported")
    parser.add_argument("--spans", default="",
                        help="comma-separated frames a warp walks to time this tree at, "
                             "beside the wrapper's choice")
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--rounds", type=int, default=2,
                        help="A B B A rounds: each visits every tree twice")
    parser.add_argument("--host-calls", type=int, default=1000,
                        help="calls a host-time measurement")
    parser.add_argument("--out", type=Path, help="also write the JSON line here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_combine_dense: no CUDA GPU available", file=_sys.stderr)
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
    modules = {label: tree_module(label, trees[label], lib) for label, lib in built.items()}
    inputs = cases(dev)
    torch.cuda.synchronize()

    result = {"card": card, "trees": {}}
    failed, reported = [], []
    first = {}
    timed = {}  # case name -> label -> call
    for label, module in modules.items():
        out = reported if label in diag else failed
        before = len(out)
        equal = {}
        for name, case in inputs:
            if label in diag and not case["timed"]:
                continue
            call = caller(module.combine_dense, case)
            got, again = call(), call()
            want = combine_dense_reference(case["gd2_t"], case["cvals_t"], case["k"])
            torch.cuda.synchronize()
            if not chip_smoke.bitwise_equal(got, want):
                out.append(f"{label} {name}: not bitwise the plain version (max abs err "
                           f"{float((got - want).abs().max()):.3e})")
            if not chip_smoke.bitwise_equal(got, again):
                out.append(f"{label} {name}: two calls differ")
            ref = first.setdefault(name, (next(iter(built)), got))
            equal[name] = chip_smoke.bitwise_equal(got, ref[1])
            if not equal[name]:
                out.append(f"{label} {name}: not bitwise equal to {ref[0]}'s output")
            if case["timed"]:
                timed.setdefault(name, {})[label] = call
            del got, again, want
        print(f"{label}{' (diagnostic)' if label in diag else ''}: bitwise equal to "
              f"{next(iter(built))} in {sum(equal.values())} of {len(equal)} outputs")
        result["trees"][label] = {"ok": len(out) == before, "diagnostic": label in diag,
                                  "bitwise_equal_to_first": equal}
    first.clear()
    spans = [int(v) for v in args.spans.split(",") if v]
    for span in spans:
        fn = span_fn(modules["this"], span)
        for name, case in inputs:
            call = caller(fn, case)
            got = call()
            want = combine_dense_reference(case["gd2_t"], case["cvals_t"], case["k"])
            if not chip_smoke.bitwise_equal(got, want):
                failed.append(f"this span={span} {name}: not bitwise the plain version")
            if case["timed"]:
                timed[name][f"this span={span}"] = call
    for line in reported:
        print(f"diagnostic: {line}")

    times = time_rounds(timed, args.rounds, args.reps, result)
    result["times"] = {}
    b_ = chip_smoke.dense_bound()
    for name, by_label in times.items():
        for label, rec in by_label.items():
            rec["median_ms"] = statistics.median(rec["ms"])
            rec["median_graph_ms"] = statistics.median(rec["graph_ms"])
            rec["bound_ms"], rec["bound_by"] = b_["bound_ms"], b_["bound_by"]
            rec["bound_share"] = b_["bound_ms"] / rec["median_graph_ms"]
            print(f"{name} {label}: {rec['median_ms']:.5f} ms a call (rounds "
                  f"{[round(v, 5) for v in rec['ms']]}), graph {rec['median_graph_ms']:.5f} ms "
                  f"(rounds {[round(v, 5) for v in rec['graph_ms']]}), "
                  f"{rec['bound_share']:.4f} of the bound {b_['bound_ms']:.5f} ms "
                  f"({b_['bound_by']})")
            result["times"].setdefault(name, {})[label] = rec
    name, case = inputs[0]
    host = host_parts({k: m for k, m in modules.items() if k not in diag}, built, case,
                      args.host_calls)
    result["host_us"] = host
    print(f"{name}: host us a call ({args.host_calls} calls, no sync inside): "
          + ", ".join(f"{k} {v:.2f}" for k, v in host.items()))
    result["failed"], result["diagnostic_differences"] = failed, reported
    print(card)
    line = json.dumps(result)
    print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    if failed:
        print("time_combine_dense FAILED: " + "; ".join(failed), file=_sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    _sys.exit(main())
