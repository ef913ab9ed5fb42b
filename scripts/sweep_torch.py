"""Sweeps of the port's serving and training knobs (``scripts/sweep.py``).

    python scripts/sweep_torch.py scan   [--events 16] [--reps 2] [--configs 8:1,16:2,...]
    python scripts/sweep_torch.py train  [--reps 10] [--batches 12,48]
                                         [--d3d-dtype float32|bfloat16]
    python scripts/sweep_torch.py infer  [--reps 20]
    python scripts/sweep_torch.py bf16   [--events 8] [--reps 2] [--window-batch 8]

``scan``  serving events/s over ``window_batch`` x ``batch_events``
          (``SlidingWindowReconstructor.batch``: host arrays in, host arrays
          out, the store left out) on the p2igan stis flagship.
``train`` the hinge-GAN step of ``p2igan_gan_baseline_gauge.json`` over a
          batch ladder, with the gauge selection hoisted (as the trainer does)
          and, at the first batch, inside every step; the critic's 3-D branch
          in ``--d3d-dtype``.
``infer`` the single-event ``window_batch`` ladder, and #3
          ``maxpool2_duplicate`` against its stacked plain formulation
          (``max_pool2d``, then each channel stacked beside itself).
``bf16``  the generator's ``compute_dtype`` float32 against bfloat16:
          events/s, and the RMSE and largest error on the x255 scale.

The JAX script's XLA knobs have no counterpart here and are not imitated:
``scan_unroll`` and ``accum_mode`` (the port walks window chunks in a Python
loop and adds each window in stream order) and buffer donation (PyTorch
updates in place). Times are CUDA-event means (``utils.profiling.timeit``);
``--deterministic off`` sets ``cudnn.deterministic`` off for the process, a
measurement only (the port's policy stays deterministic).
A rung that does not fit in the card's memory prints its out-of-memory
error and the sweep goes on. ``--device`` defaults to ``cuda`` and raises
without a GPU; every subcommand takes the geometry flags for a small run.
"""

from __future__ import annotations

# Allow running as `python scripts/<name>.py` without installing the package.
import sys as _sys
from pathlib import Path as _Path

_repo = str(_Path(__file__).resolve().parents[1])
if _repo not in _sys.path:
    _sys.path.insert(0, _repo)

import argparse
import gc
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from p2igan_tpu_torch.inference.driver import SlidingWindowReconstructor, set_precision_policy
from p2igan_tpu_torch.ops.pool_dup import maxpool2_duplicate
from p2igan_tpu_torch.parallel.mesh import resolve_device
from p2igan_tpu_torch.utils import profiling

DEFAULT_SCAN = "4:1,8:1,16:1,32:1,8:2,8:4,16:2,16:4"


def _geometry(args):
    H = W = args.size
    return H, W, args.frames, args.base, profiling.default_gauges(H, W)


def _serving(args, dev, compute_dtype=torch.float32):
    """The folded flagship generator and ``--events`` events under its mask."""
    H, W, T, base, n_gauges = _geometry(args)
    mask_flat = profiling.gauge_mask(H, W, n_gauges)
    gen = profiling.flagship_generator(H, W, T, base, n_gauges, dev).eval().fold_for_inference()
    gen.compute_dtype = compute_dtype
    masked, masks = profiling.build_events(mask_flat, args.events, args.event_frames, H, W)
    return gen, masked, masks


def _recon(gen, T: int, wb: int) -> SlidingWindowReconstructor:
    return SlidingWindowReconstructor(gen, stride=T, overlap=T * 3 // 4, window_batch=wb,
                                      output_scale=255.0)


def _serve_all(recon, masked, masks, batch_events: int) -> np.ndarray:
    outs = [recon.batch(masked[i:i + batch_events], masks[i:i + batch_events])
            for i in range(0, masked.shape[0], batch_events)]
    return np.concatenate(outs)


def _report_failure(tag: str, e: BaseException, dev) -> str:
    line = f"{tag}  FAILED: {type(e).__name__}: {str(e).splitlines()[0][:160]}"
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return line


def cmd_scan(args, dev) -> List[str]:
    with torch.inference_mode():
        gen, masked, masks = _serving(args, dev)
        configs = [tuple(int(v) for v in tok.split(":")) for tok in args.configs.split(",")]
        lines, best = [], (None, 0.0)
        for wb, be in configs:
            tag = f"window_batch={wb:2d} batch_events={be}"
            try:
                recon = _recon(gen, args.frames, wb)
                sec = profiling.timeit(_serve_all, recon, masked, masks, be, reps=args.reps,
                                       warmup=1, device=dev)
                rate = args.events / sec
                lines.append(f"{tag}  {rate:9.3f} events/s")
                if rate > best[1]:
                    best = (tag, rate)
            except torch.cuda.OutOfMemoryError as e:
                lines.append(_report_failure(tag, e, dev))
            print(lines[-1], flush=True)
    lines.append(f"BEST: {best[0]}  {best[1]:.3f} events/s")
    print(lines[-1], flush=True)
    return lines


def cmd_train(args, dev) -> List[str]:
    H, W, T, base, n_gauges = _geometry(args)
    batches = [int(b) for b in args.batches.split(",")]
    rungs = [(batches[0], True), (batches[0], False)] + [(b, True) for b in batches[1:]]
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        cfg = profiling.gan_config(Path(tmp), H, W, T, base, n_gauges,
                                   d3d_dtype=args.d3d_dtype)
        for batch, hoist in rungs:
            tag = (f"batch={batch:3d} d3d={args.d3d_dtype} "
                   f"idw={'hoisted' if hoist else 'inline '}")
            step = None
            try:
                step = profiling.GanStep(cfg, batch, dev, hoist_idw=hoist)
                reps = max(2, args.reps * batches[0] // batch)
                sec = profiling.timeit(step, reps=reps, warmup=2, device=dev)
                loss = float(step()["loss"])
                if not np.isfinite(loss):
                    raise FloatingPointError(f"loss {loss}")
                lines.append(f"{tag}  {1.0 / sec:8.3f} steps/s  {batch / sec:8.2f} samples/s")
            except torch.cuda.OutOfMemoryError as e:
                lines.append(_report_failure(tag, e, dev))
            del step
            print(lines[-1], flush=True)
    return lines


def cmd_infer(args, dev) -> List[str]:
    H, W, T, base, n_gauges = _geometry(args)
    args.events = 1
    lines = []
    with torch.inference_mode():
        gen, masked, masks = _serving(args, dev)
        ev_m = torch.from_numpy(masked).to(dev)
        ev_k = torch.from_numpy(masks).to(dev)
        for wb in (4, 8, 16):
            recon = _recon(gen, T, wb)
            ms = profiling.timeit(recon._reconstruct, ev_m, ev_k, reps=args.reps) * 1e3
            lines.append(f"window_batch={wb:2d}: {ms:8.3f} ms an event "
                         f"({1e3 / ms:7.2f} events/s)")
            print(lines[-1], flush=True)
        gen_ = torch.Generator().manual_seed(2)
        x = torch.rand((8, base, H, W), generator=gen_).to(dev)

        def stacked(v):
            y = F.max_pool2d(v, 2, 2)
            return torch.stack([y, y], dim=2).reshape(v.shape[0], 2 * v.shape[1],
                                                      v.shape[2] // 2, v.shape[3] // 2)

        equal = torch.equal(maxpool2_duplicate(x), stacked(x))
        k_ms = profiling.timeit(maxpool2_duplicate, x, reps=args.reps) * 1e3
        s_ms = profiling.timeit(stacked, x, reps=args.reps) * 1e3
        lines += [f"#3 maxpool2_duplicate{tuple(x.shape)} equals the stacked formulation: "
                  f"{equal}",
                  f"#3 maxpool2_duplicate: {k_ms:.4f} ms", f"stacked max_pool2d: {s_ms:.4f} ms"]
        print("\n".join(lines[-3:]), flush=True)
    return lines


def cmd_bf16(args, dev) -> List[str]:
    lines, outs = [], {}
    with torch.inference_mode():
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            gen, masked, masks = _serving(args, dev, dtype)
            recon = _recon(gen, args.frames, args.window_batch)
            sec = profiling.timeit(_serve_all, recon, masked, masks, 1, reps=args.reps,
                                   warmup=1, device=dev)
            outs[name] = (args.events / sec, _serve_all(recon, masked, masks, 1))
            lines.append(f"compute_dtype={name}  window_batch={args.window_batch}  "
                         f"{args.events / sec:9.3f} events/s")
            print(lines[-1], flush=True)
    err = outs["bfloat16"][1].astype(np.float64) - outs["float32"][1]
    lines.append(f"bf16 against float32 (x255 scale): rmse={np.sqrt((err ** 2).mean()):.4f}  "
                 f"max_abs={np.abs(err).max():.4f}  "
                 f"speedup={outs['bfloat16'][0] / outs['float32'][0]:.4f}x")
    print(lines[-1], flush=True)
    return lines


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0],
                                 formatter_class=argparse.RawDescriptionHelpFormatter,
                                 epilog=__doc__.split("\n\n", 2)[2])
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add(name, fn, help_, **defaults):
        p = sub.add_parser(name, help=help_)
        p.add_argument("--device", default="cuda",
                       help="cuda (default; raises without a GPU) or cpu")
        p.add_argument("--out", type=Path, default=None, help="also write the lines here")
        p.add_argument("--size", type=int, default=128, help="H = W")
        p.add_argument("--frames", type=int, default=16, help="T, the window length")
        p.add_argument("--base", type=int, default=64, help="base channels (4 x T)")
        p.add_argument("--event-frames", type=int, default=64)
        p.add_argument("--reps", type=int, default=defaults.pop("reps"))
        p.add_argument("--deterministic", choices=("on", "off"), default="on",
                       help="cudnn.deterministic for this measurement (the port's policy: on)")
        p.set_defaults(fn=fn)
        return p

    p = add("scan", cmd_scan, "serving events/s over window_batch x batch_events", reps=2)
    p.add_argument("--events", type=int, default=16)
    p.add_argument("--configs", type=str, default=DEFAULT_SCAN,
                   help="comma list window_batch:batch_events, e.g. 8:1,16:2 (the JAX "
                        "script's scan_unroll and accum_mode have no counterpart)")
    p = add("train", cmd_train, "GAN step over a batch ladder, gauge selection "
            "hoisted and inline, the critic's 3-D branch dtype", reps=10)
    p.add_argument("--batches", type=str, default="12,48")
    p.add_argument("--d3d-dtype", type=str, default="float32",
                   choices=("float32", "bfloat16"))
    add("infer", cmd_infer, "single-event window_batch ladder, #3 against its stacked "
        "plain formulation", reps=20)
    p = add("bf16", cmd_bf16, "the generator's compute_dtype float32 against bfloat16",
            reps=2)
    p.add_argument("--events", type=int, default=8)
    p.add_argument("--window-batch", type=int, default=8)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    set_precision_policy()
    if args.deterministic == "off":
        torch.backends.cudnn.deterministic = False
    print(f"{args.cmd} on {profiling.describe_device(dev)}, cuDNN deterministic "
          f"{args.deterministic}", flush=True)
    lines = args.fn(args, dev)
    if args.out is not None:
        Path(args.out).write_text("\n".join(lines) + "\n")
    return {"lines": lines}


if __name__ == "__main__":
    main()
