"""Time the gauge top-k (#1, ``gauge_topk.cu``) and simple's dec2 stencil (#15,
``dec2_stencil.cu``) of several source trees on one card.

    python scripts/time_topk_dec2.py [--tree LABEL=DIR ...] [--diag LABEL=DIR ...]
                                     [--kernel topk,dec2] [--reps 10] [--rounds 2]
                                     [--out FILE]

Each tree is a checkout root (or any directory holding
``p2igan_tpu_torch/csrc``); this checkout is always the tree ``this``, the
last. The trees are built and called as ``time_sti_combine.py`` builds and
calls them: each tree's two sources alone, with its own ``csrc`` as include
directory, and their C entry points called with the arguments matched by name
to the parameters the tree's source declares.

Shapes. #1 timed: stis (B=1, G=128, the 79-gauge mask and the 64-gauge grid of
``chip_smoke.gauge_masks``), sti train (B=12, G=256) and sti serve (B=8, G=256)
of ``chip_smoke.STI_SHAPES``; checked only: sti block 4 (B=12, G=1152), the
cases of ``tests/test_torch_cuda.py`` and a batch that mixes masks of 0-3
gauges with full ones. Every #1 output is held bitwise against the plain
version (``gauge_topk_reference``). #15 timed: the serving chunk (8, 64, 16,
128, 128), made as ``chip_smoke.check_dec2`` makes it; checked only: the
``DEC2_SHAPES`` of the card tests. Every #15 output is held to its plain
version (``F.conv3d`` then the sigmoid, rtol 1e-5, atol 5e-6). Both are held
bitwise against the first tree's output, and across two calls. A ``--tree``
that differs is marked ``"ok": false`` and the script exits 1; a ``--diag``
tree (a variant whose output is wrong on purpose, to split the time) is timed
and its differences are only reported.

Timing (``time_sti_combine.time_rounds``): the median CUDA-event time of one
call and the device time of one call in a CUDA-graph replay over input
copies that leave L2 between uses (``chip_smoke.graph_ms``), in A B B A
rounds. Prints the card's name and power limit, the SM clock under load,
each time's share of its bound (#1 the operations of one distance and one
compare a (pixel, slot), as ``chip_smoke.topk_bound`` counts them; #15 the
input's bytes), then one JSON line.
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
from p2igan_tpu_torch.ops.dec2_stencil import conv3d_cout1_sigmoid_reference
from p2igan_tpu_torch.ops.idw import gauge_geometry
from p2igan_tpu_torch.ops.idw_factored_kernel import gauge_topk_reference
from time_sti_combine import build, time_rounds

REPO = Path(_repo)
KERNELS = {"topk": ("gauge_topk.cu", "p2i_gauge_topk"),
           "dec2": ("dec2_stencil.cu", "p2i_dec2_conv3d_sigmoid")}
BUILD = REPO / "build" / "time_topk_dec2"


def topk_inputs(args) -> dict:
    """#1's case from gauge_geometry's (qx, qy, gx, gy, pen); gauge arrays of
    one mask get a batch axis of 1."""
    qx, qy, gx, gy, pen = args
    if gx.dim() == 1:
        gx, gy, pen = gx[None], gy[None], pen[None]
    return {"qx": qx, "qy": qy, "gx": gx.contiguous(), "gy": gy.contiguous(),
            "pen": pen.contiguous()}


def dec2_bound(case: dict) -> dict:
    """``chip_smoke.check_fused_conv``'s count for one output channel."""
    b, c, t, h, w = case["x"].shape
    voxels = b * t * h * w
    return chip_smoke.bound(4 * (case["x"].numel() + voxels + case["wgt"].numel() + 1),
                            voxels * (2 * 27 * c + 3))


def with_copies(case: dict, names, out_bytes: int) -> dict:
    """``case`` with copies of its inputs ``names``: one, or for a timed case as
    many as make each come back after ``chip_smoke.ROTATE_BYTES`` of traffic."""
    n = 1
    if case["timed"]:
        per_call = out_bytes + sum(4 * case[name].numel() for name in names)
        n = -(-chip_smoke.ROTATE_BYTES // per_call)
    case["copies"] = [{name: case[name] if i == 0 else case[name].clone() for name in names}
                      for i in range(n)]
    return case


def topk_cases(dev) -> list:
    _sys.path.insert(0, str(REPO / "tests"))
    from test_torch_cuda import _mask

    out = []
    for name, mask in chip_smoke.gauge_masks(dev).items():
        out.append((f"stis {name}", {**topk_inputs(gauge_geometry(mask, chip_smoke.G)[:5]),
                                     "k": chip_smoke.K, "timed": True}))
    for label, batch, block, slots in chip_smoke.STI_SHAPES:
        masks = chip_smoke.sti_masks(dev, batch, block)
        out.append((f"sti {label}", {**topk_inputs(gauge_geometry(masks, slots)[:5]),
                                     "k": chip_smoke.K, "timed": slots == chip_smoke.STI_G}))
    rng = np.random.default_rng(0)
    for kind in ("79", "grid", "2", "empty"):
        for h, w, k in ((32, 32, 4), (20, 13, 3), (16, 16, 1)):
            mask = torch.from_numpy(_mask(kind, h, w, rng)).to(dev)
            out.append((f"{kind} {h}x{w} k={k}",
                        {**topk_inputs(gauge_geometry(mask, 128)[:5]), "k": k, "timed": False}))
    mixed = mixed_masks(dev)
    for k in (4, 3):
        out.append((f"mixed 0-3 gauges k={k}",
                    {**topk_inputs(gauge_geometry(mixed, chip_smoke.STI_G)[:5]), "k": k,
                     "timed": False}))
    names = ("qx", "qy", "gx", "gy", "pen")
    return [(name, "topk", with_copies(
        case, names, 8 * case["k"] * case["gx"].shape[0] * case["qx"].shape[0]))
            for name, case in out]


def mixed_masks(dev) -> torch.Tensor:
    """Masks of 0, 1, 2 and 3 gauges beside full sti masks, one batch at full
    width: the fewer-than-k rule inside one launch."""
    rng = np.random.default_rng(chip_smoke.SEED + 1)
    full = chip_smoke.sti_masks(dev, 4, chip_smoke.STI_BLOCK).cpu().numpy()
    few = []
    for n in (0, 1, 2, 3):
        flat = np.zeros(chip_smoke.H * chip_smoke.W, np.float32)
        flat[rng.choice(flat.size, n, replace=False)] = 1.0
        few.append(flat.reshape(chip_smoke.H, chip_smoke.W))
    order = [few[0], full[0], few[1], few[2], full[1], few[3], full[2], full[3]]
    return torch.from_numpy(np.stack(order)).to(dev)


def dec2_case(dev, shape, rng, timed: bool) -> dict:
    """(b, t, h, w, c): x channels-first in memory and non-negative (it
    follows a ReLU), weights U(+-1/sqrt(27 c)), as ``chip_smoke.check_dec2``."""
    b, t, h, w, c = shape
    bound_ = 1.0 / np.sqrt(27 * c)
    x = torch.relu(torch.from_numpy(
        rng.standard_normal((b, c, t, h, w)).astype(np.float32)).to(dev))
    wgt = torch.from_numpy(rng.uniform(-bound_, bound_, (3, 3, 3, c, 1)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(1).astype(np.float32) * 0.1)
    case = {"x": x, "wgt": wgt.to(dev), "bias": bias.to(dev), "timed": timed}
    return with_copies(case, ("x",), 4 * b * t * h * w)


def dec2_cases(dev) -> list:
    _sys.path.insert(0, str(REPO / "tests"))
    from test_torch_cuda import DEC2_SHAPES

    rng = np.random.default_rng(chip_smoke.SEED + 15)
    shapes = [((chip_smoke.WINDOW_BATCH, chip_smoke.LENGTH, chip_smoke.H, chip_smoke.W,
                chip_smoke.BASE), True)] + [(s, False) for s in DEC2_SHAPES]
    return [(f"dec2 {shape}", "dec2", dec2_case(dev, shape, rng, timed))
            for shape, timed in shapes]


def caller(fn, params, kernel: str, case: dict):
    """A call ``call(i=0)`` of one tree's entry point on copy i of ``case``'s
    inputs, its arguments by name; ``call.copies`` as ``graph_ms`` wants."""
    if kernel == "topk":
        B, G = case["gx"].shape
        HW, k = case["qx"].shape[0], case["k"]
        named = {"B": B, "HW": HW, "G": G, "k": k}
        shapes = {"gd2": ((B, k, HW), torch.float32), "gsel": ((B, k, HW), torch.int32)}
        fixed = {}
    else:
        B, C, T, H, W = case["x"].shape
        named = {"B": B, "T": T, "H": H, "W": W, "C": C}
        shapes = {"out": ((B, T, H, W), torch.float32)}
        fixed = {"wgt": case["wgt"], "bias": case["bias"]}
    dev = case["copies"][0][next(iter(case["copies"][0]))].device

    def call(i: int = 0):
        outs = {name: torch.empty(shape, device=dev, dtype=dtype)
                for name, (shape, dtype) in shapes.items()}
        own = {**case["copies"][i], **fixed, **outs}
        named["stream"] = cuda_lib.stream_of(own[next(iter(own))])
        args = [own[name].data_ptr() if name in own else named[name] for name, _ in params]
        cuda_lib.check(fn(*args), KERNELS[kernel][1])
        return tuple(outs.values())
    call.copies = len(case["copies"])
    return call


def plain(kernel: str, case: dict):
    if kernel == "topk":
        return gauge_topk_reference(case["qx"], case["qy"], case["gx"], case["gy"],
                                    case["pen"], case["k"])
    with torch.no_grad():
        out = conv3d_cout1_sigmoid_reference(case["x"].permute(0, 2, 3, 4, 1), case["wgt"],
                                             case["bias"])
    return (out[..., 0],)


def held(kernel: str, got: tuple, want: tuple) -> str:
    """'' when ``got`` meets its plain version: #1 bitwise, #15 within rtol 1e-5,
    atol 5e-6; else what differs."""
    if kernel == "topk":
        bad = [n for n, g, w in zip(("gd2", "gsel"), got, want)
               if not chip_smoke.bitwise_equal(g, w)]
        return f"{', '.join(bad)} not bitwise its plain version" if bad else ""
    err, excess = chip_smoke.conv_excess(got[0], want[0], 5e-6)
    return "" if excess <= 0.0 else f"max abs err {err:.3e} over rtol 1e-5, atol 5e-6"


def same(a: tuple, b: tuple) -> bool:
    return all(chip_smoke.bitwise_equal(x, y) for x, y in zip(a, b))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", action="append", default=[], metavar="LABEL=DIR",
                        help="another source tree to time beside this one")
    parser.add_argument("--diag", action="append", default=[], metavar="LABEL=DIR",
                        help="a diagnostic tree: timed, its differences only reported")
    parser.add_argument("--kernel", default="topk,dec2",
                        help="comma-separated kernels to check and time: topk, dec2")
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--rounds", type=int, default=2,
                        help="A B B A rounds: each visits every tree twice")
    parser.add_argument("--out", type=Path, help="also write the JSON line here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_topk_dec2: no CUDA GPU available", file=_sys.stderr)
        return 1
    wanted = [k for k in args.kernel.split(",") if k]
    if not set(wanted) <= set(KERNELS):
        parser.error(f"--kernel takes {', '.join(KERNELS)}")
    kernels = {k: KERNELS[k] for k in wanted}
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
    built = build(trees, kernels, BUILD)
    inputs = (topk_cases(dev) if "topk" in kernels else []) + (
        dec2_cases(dev) if "dec2" in kernels else [])
    wants = {name: plain(kernel, case) for name, kernel, case in inputs}
    torch.cuda.synchronize()

    result = {"card": card, "trees": {}}
    failed, reported = [], []
    first = {}
    timed = {}  # case name -> label -> call
    for label, lib in built.items():
        out = reported if label in diag else failed
        before = len(out)
        equal = {}
        for name, kernel, case in inputs:
            fn, params = lib[kernel]
            call = caller(fn, params, kernel, case)
            got, again = call(), call()
            torch.cuda.synchronize()
            what = held(kernel, got, wants[name])
            if what:
                out.append(f"{label} {name}: {what}")
            if not same(got, again):
                out.append(f"{label} {name}: two calls differ")
            ref = first.setdefault(name, (next(iter(built)), got))
            equal[name] = same(got, ref[1])
            if not equal[name]:
                out.append(f"{label} {name}: not bitwise equal to {ref[0]}'s output")
            if case["timed"]:
                timed.setdefault(name, {})[label] = call
        print(f"{label}{' (diagnostic)' if label in diag else ''}: bitwise equal to "
              f"{next(iter(built))} in {sum(equal.values())} of {len(equal)} outputs")
        result["trees"][label] = {"ok": len(out) == before, "diagnostic": label in diag,
                                  "bitwise_equal_to_first": equal}
    for line in reported:
        print(f"diagnostic: {line}")

    times = time_rounds(timed, args.rounds, args.reps, result)
    result["times"] = {}
    for name, by_label in times.items():
        kernel, case = next((k, c) for n, k, c in inputs if n == name)
        # the timed #1 cases are at chip_smoke's H x W and k
        b_ = chip_smoke.topk_bound(*case["gx"].shape) if kernel == "topk" else dec2_bound(case)
        for label, rec in by_label.items():
            rec["median_ms"] = statistics.median(rec["ms"])
            rec["median_graph_ms"] = statistics.median(rec["graph_ms"])
            rec["bound_ms"], rec["bound_by"] = b_["bound_ms"], b_["bound_by"]
            rec["bound_share"] = b_["bound_ms"] / rec["median_graph_ms"]
            print(f"{name} {label}: {rec['median_ms']:.4f} ms a call (rounds "
                  f"{[round(v, 4) for v in rec['ms']]}), graph {rec['median_graph_ms']:.4f} ms "
                  f"(rounds {[round(v, 4) for v in rec['graph_ms']]}), "
                  f"{rec['bound_share']:.4f} of the bound {b_['bound_ms']:.5f} ms "
                  f"({b_['bound_by']})")
            result["times"].setdefault(name, {})[label] = rec
    result["failed"], result["diagnostic_differences"] = failed, reported
    print(card)
    line = json.dumps(result)
    print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    if failed:
        print("time_topk_dec2 FAILED: " + "; ".join(failed), file=_sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    _sys.exit(main())
