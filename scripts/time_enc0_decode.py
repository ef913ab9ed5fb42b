"""Time simple's enc0 convolution (#14, ``enc0_conv.cu``) and the uint8 decode
(#11, ``decode_mask.cu``) of several source trees on one card.

    python scripts/time_enc0_decode.py [--tree LABEL=DIR ...] [--diag LABEL=DIR ...]
                                       [--kernel enc0,decode] [--reps 10] [--rounds 2]
                                       [--host-calls 1000] [--out FILE]

Each tree is a checkout root (or any directory holding
``p2igan_tpu_torch/ops`` and ``p2igan_tpu_torch/csrc``); this checkout is
always the tree ``this``, the last. Each tree's two sources are built alone,
with its own ``csrc`` as include directory (``time_sti_combine.build``), and
called through the tree's own wrappers (``ops/enc0_conv.py``,
``ops/decode_mask.py``), loaded with a ``cuda_lib`` whose library is that
tree's build: so a tree's host work is timed with its kernel.

Shapes. #14 timed: the serving chunk (8, 16, 128, 128, 2 -> 64), made as
``chip_smoke.check_enc0`` makes it; checked only: the ``ENC0_SHAPES`` of the
card tests. Every #14 output is held to its plain version (``F.conv3d`` then
the leaky relu, rtol 1e-5, atol 5e-6). #11 timed: the training batch
(12, 16, 128, 128, 1) with the frame-constant uint8 mask (12, 1, 128, 128, 1)
and with a full-shape float32 mask; checked only: the ``DECODE_CASES`` of the
card tests. Every #11 output is held bitwise against the numpy decode. Both
are held bitwise against the first tree's output, and across two calls. A
``--tree`` that differs is marked ``"ok": false`` and the script exits 1; a
``--diag`` tree (a variant whose output is wrong on purpose, to split the
time) is timed and its differences are only reported.

Timing (``time_sti_combine.time_rounds``): the median CUDA-event time of one
call and the device time of one call in a CUDA-graph replay over input
copies that leave L2 between uses (``chip_smoke.graph_ms``), in A B B A
rounds; #11's elementwise chain (its plain version, the ``chain`` label) is
timed in the same rounds. Then #11's host time a call: ``time.perf_counter``
over ``--host-calls`` calls of each tree's wrapper and of the chain, with no
synchronization inside the loop, and beside them the parts of a call (the
two output allocations, the C entry point alone). Prints the card's name and
power limit, the SM clock under load, each device time's share of its bound
(``chip_smoke.check_enc0``'s and ``check_decode``'s counts), then one JSON
line.
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
import time
import types
from pathlib import Path

import numpy as np
import torch

import chip_smoke
from p2igan_tpu_torch.ops import cuda_lib
from p2igan_tpu_torch.ops.decode_mask import decode_normalize_mask_reference
from p2igan_tpu_torch.ops.enc0_conv import enc0_conv3d_leaky_reference
from time_sti_combine import build, time_rounds

REPO = Path(_repo)
KERNELS = {"enc0": ("enc0_conv.cu", "p2i_enc0_conv3d_leaky"),
           "decode": ("decode_mask.cu", "p2i_decode_normalize_mask")}
BUILD = REPO / "build" / "time_enc0_decode"


def tree_wrappers(label: str, root: Path, lib: dict) -> dict:
    """kernel -> the tree's wrapper function, its modules loaded as a package
    of their own whose ``cuda_lib`` hands out the tree's built entry points."""
    pkg = "_tree_" + re.sub(r"\W", "_", label)
    package = types.ModuleType(pkg)
    package.__path__ = [str(root / "p2igan_tpu_torch" / "ops")]
    shim = types.ModuleType(pkg + ".cuda_lib")
    shim.__dict__.update({k: v for k, v in vars(cuda_lib).items() if not k.startswith("__")})
    entries = types.SimpleNamespace(**{KERNELS[k][1]: fn for k, (fn, _) in lib.items()})
    shim.library = lambda: entries
    package.cuda_lib = shim
    _sys.modules[pkg], _sys.modules[pkg + ".cuda_lib"] = package, shim
    out = {}
    if "enc0" in lib:
        out["enc0"] = importlib.import_module(pkg + ".enc0_conv").enc0_conv3d_leaky
    if "decode" in lib:
        out["decode"] = importlib.import_module(pkg + ".decode_mask").decode_normalize_mask
    return out


def copies_for(case: dict, names, out_bytes: int) -> dict:
    """``case`` with copies of its inputs ``names``: one, or for a timed case as
    many as make each come back after ``chip_smoke.ROTATE_BYTES`` of traffic."""
    n = 1
    if case["timed"]:
        per_call = out_bytes + sum(case[k].numel() * case[k].element_size() for k in names)
        n = -(-chip_smoke.ROTATE_BYTES // per_call)
    case["copies"] = [{k: case[k] if i == 0 else case[k].clone() for k in names}
                      for i in range(n)]
    return case


def enc0_cases(dev) -> list:
    _sys.path.insert(0, str(REPO / "tests"))
    from test_torch_cuda import ENC0_SHAPES

    rng = np.random.default_rng(chip_smoke.SEED + 14)
    shapes = [((chip_smoke.WINDOW_BATCH, chip_smoke.LENGTH, chip_smoke.H, chip_smoke.W, 2,
                chip_smoke.BASE), True)] + [(s, False) for s in ENC0_SHAPES]
    out = []
    for shape, timed in shapes:
        b, t, h, w, cin, cout = shape
        bound_ = 1.0 / np.sqrt(27 * cin)
        case = {
            "x": torch.from_numpy(rng.standard_normal((b, t, h, w, cin)).astype(np.float32)).to(dev),
            "wgt": torch.from_numpy(rng.uniform(-bound_, bound_, (3, 3, 3, cin, cout))
                                    .astype(np.float32)).to(dev),
            "bias": torch.from_numpy(rng.standard_normal(cout).astype(np.float32) * 0.1).to(dev),
            "timed": timed}
        name = f"enc0 {shape}" + ("" if timed else " (card case)")
        out.append((name, "enc0", copies_for(case, ("x",), 4 * b * t * h * w * cout)))
    return out


def decode_cases(dev) -> list:
    _sys.path.insert(0, str(REPO / "tests"))
    from test_torch_cuda import DECODE_CASES

    rng = np.random.default_rng(chip_smoke.SEED + 11)
    full = (chip_smoke.TRAIN_BATCH, chip_smoke.LENGTH, chip_smoke.H, chip_smoke.W, 1)
    const = (chip_smoke.TRAIN_BATCH, 1, chip_smoke.H, chip_smoke.W, 1)
    specs = [(full, const, np.uint8, 0, True), (full, full, np.float32, 0, True)]
    specs += [(s, m, d, off, False) for s, m, d, off in DECODE_CASES]
    out = []
    for shape, mshape, mdtype, offset, timed in specs:
        u8 = rng.integers(0, 256, size=shape, dtype=np.uint8)
        mask = (rng.random(mshape) < 0.3).astype(mdtype)
        frames = torch.from_numpy(u8).to(dev)
        if offset:  # frames whose first byte lies ``offset`` bytes past an allocation
            frames = torch.empty(u8.size + offset, dtype=torch.uint8, device=dev)[offset:]
            frames = frames.view(shape).copy_(torch.from_numpy(u8))
        video = u8.astype(np.float32) / 255.0
        case = {"frames": frames, "mask": torch.from_numpy(mask).to(dev), "timed": timed,
                "want": (video, video * mask.astype(np.float32))}
        name = (f"decode {shape} mask {mshape} {np.dtype(mdtype).name}"
                + (f" frames +{offset} B" if offset else "") + ("" if timed else " (card case)"))
        out.append((name, "decode", copies_for(case, ("frames", "mask"), 8 * u8.size)))
    return out


def caller(wrapper, kernel: str, case: dict):
    """``call(i=0)``: the wrapper on copy i of ``case``'s inputs; ``call.copies``
    as ``graph_ms`` wants."""
    def call(i: int = 0):
        own = case["copies"][i]
        with torch.no_grad():
            if kernel == "enc0":
                return (wrapper(own["x"], case["wgt"], case["bias"]),)
            return tuple(wrapper(own["frames"], own["mask"]))
    call.copies = len(case["copies"])
    return call


def held(kernel: str, got: tuple, case: dict) -> str:
    """'' when ``got`` meets its plain version: #14 within rtol 1e-5, atol 5e-6,
    #11 bitwise the numpy decode; else what differs."""
    if kernel == "enc0":
        with torch.no_grad():
            want = enc0_conv3d_leaky_reference(case["x"], case["wgt"], case["bias"])
        err, excess = chip_smoke.conv_excess(got[0], want, 5e-6)
        return "" if excess <= 0.0 else f"max abs err {err:.3e} over rtol 1e-5, atol 5e-6"
    bad = [n for n, g, w in zip(("video", "masked"), got, case["want"])
           if not np.array_equal(g.cpu().numpy().view(np.int32), w.view(np.int32))]
    return f"{', '.join(bad)} not bitwise the numpy decode" if bad else ""


def same(a: tuple, b: tuple) -> bool:
    return all(chip_smoke.bitwise_equal(x, y) for x, y in zip(a, b))


def enc0_bound(case: dict) -> dict:
    """``chip_smoke.check_fused_conv``'s count."""
    b, t, h, w, cin = case["x"].shape
    cout = case["wgt"].shape[4]
    voxels = b * t * h * w
    return chip_smoke.bound(4 * (case["x"].numel() + voxels * cout + case["wgt"].numel() + cout),
                            voxels * cout * (2 * 27 * cin + 3))


def decode_bound(case: dict) -> dict:
    """``chip_smoke.check_decode``'s count: a frame byte and its share of the
    mask in, two floats out; 2 flops an element."""
    n = case["frames"].numel()
    mask = case["mask"]
    return chip_smoke.bound(9 * n + mask.numel() * mask.element_size(), 2 * n)


def host_us(fn, calls: int) -> float:
    """Host microseconds a call of ``fn()`` over ``calls`` calls, with no
    synchronization inside the loop (the device runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def decode_host(wrappers: dict, built: dict, case: dict, calls: int) -> dict:
    """#11's host time a call at one timed case, by label, and the parts of
    this tree's call: two output allocations, the C entry point alone."""
    frames, mask = case["frames"], case["mask"]
    out = {label: host_us(lambda w=w: w["decode"](frames, mask), calls)
           for label, w in wrappers.items()}
    out["chain"] = host_us(lambda: decode_normalize_mask_reference(frames, mask), calls)
    shape = frames.shape
    out["two torch.empty"] = host_us(lambda: (torch.empty(shape, device=frames.device),
                                              torch.empty(shape, device=frames.device)), calls)
    fn, params = built["this"]["decode"]
    video, masked = torch.empty(shape, device=frames.device), torch.empty(shape, device=frames.device)
    frame_const = int(mask.shape[1] == 1)
    n = frames.numel()
    # the arguments the wrapper passes at this case, by parameter name
    named = {"u8": frames.data_ptr(), "mask": mask.data_ptr(), "video": video.data_ptr(),
             "masked": masked.data_ptr(), "n": n,
             "plane": n // (shape[0] * shape[1]) if frame_const else n,
             "T": shape[1] if frame_const else 1, "frame_const": frame_const,
             "mask_is_f32": int(mask.dtype == torch.float32), "vec4": 1,
             "stream": cuda_lib.stream_of(frames)}
    args = [named[name] for name, _ in params]
    out["entry point alone (this)"] = host_us(lambda: fn(*args), calls)
    torch.cuda.synchronize()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", action="append", default=[], metavar="LABEL=DIR",
                        help="another source tree to time beside this one")
    parser.add_argument("--diag", action="append", default=[], metavar="LABEL=DIR",
                        help="a diagnostic tree: timed, its differences only reported")
    parser.add_argument("--kernel", default="enc0,decode",
                        help="comma-separated kernels to check and time: enc0, decode")
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--rounds", type=int, default=2,
                        help="A B B A rounds: each visits every tree twice")
    parser.add_argument("--host-calls", type=int, default=1000,
                        help="calls a host-time measurement of #11")
    parser.add_argument("--out", type=Path, help="also write the JSON line here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_enc0_decode: no CUDA GPU available", file=_sys.stderr)
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
    wrappers = {label: tree_wrappers(label, trees[label], lib) for label, lib in built.items()}
    inputs = (enc0_cases(dev) if "enc0" in kernels else []) + (
        decode_cases(dev) if "decode" in kernels else [])
    torch.cuda.synchronize()

    result = {"card": card, "trees": {}}
    failed, reported = [], []
    first = {}
    timed = {}  # case name -> label -> call
    for label in built:
        out = reported if label in diag else failed
        before = len(out)
        equal = {}
        for name, kernel, case in inputs:
            call = caller(wrappers[label][kernel], kernel, case)
            got, again = call(), call()
            torch.cuda.synchronize()
            what = held(kernel, got, case)
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
            del got, again
        print(f"{label}{' (diagnostic)' if label in diag else ''}: bitwise equal to "
              f"{next(iter(built))} in {sum(equal.values())} of {len(equal)} outputs")
        result["trees"][label] = {"ok": len(out) == before, "diagnostic": label in diag,
                                  "bitwise_equal_to_first": equal}
    first.clear()
    for line in reported:
        print(f"diagnostic: {line}")
    for name, kernel, case in inputs:
        if case["timed"] and kernel == "decode":
            timed[name]["chain"] = caller(decode_normalize_mask_reference, kernel, case)

    times = time_rounds(timed, args.rounds, args.reps, result)
    result["times"] = {}
    for name, by_label in times.items():
        kernel, case = next((k, c) for n, k, c in inputs if n == name)
        b_ = enc0_bound(case) if kernel == "enc0" else decode_bound(case)
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
    if "decode" in kernels:
        result["decode_host_us"] = {}
        for name, kernel, case in inputs:
            if case["timed"] and kernel == "decode":
                host = decode_host(wrappers, built, case, args.host_calls)
                result["decode_host_us"][name] = host
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
        print("time_enc0_decode FAILED: " + "; ".join(failed), file=_sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    _sys.exit(main())
