"""Roofline of the port's GAN train step by block (``scripts/roofline_train.py``).

    python scripts/roofline_train_torch.py [--batch 12] [--reps 20]
    python scripts/roofline_train_torch.py --device cpu --size 16 --frames 4 --base 16 --batch 2

Splits the step of ``p2igan_gan_baseline_gauge.json`` (``training/steps.py``
``build_train_step``) into its blocks, times each on the card
(``utils.profiling.timeit``) and counts its operations and bytes
(``utils.profiling.count_ops_bytes``):

    g_fwd    the generator forward                         (steps.py:157)
    g_bwd    forward plus backward, less the forward       (steps.py:189)
    d_step   the fused critic forward and backward and its optimizer step
                                                           (steps.py:160-175)
    g_head   the rec loss, the adversarial critic forward and its backward
             into ``preds``                                (steps.py:178-188)
    opt_g    the generator's optimizer step                (steps.py:192)

A block's bound is ``max(ops / 67e12, bytes / 3.35e12)``: the H100 SXM's
float32 rate outside the tensor cores (TF32 is off in the port's policy) and
its HBM3 rate. Its share of the bound is bound / measured time (1 at the
bound; the bytes are an upper bound of the traffic, so a share above 1 means
a wrong count). Then the whole step: measured ms, the sum of the block bounds,
and its operations over (time x 67e12), its share of the float32 peak.
It never writes PROFILE.md: it prints, and ``--out`` writes the same text to a
file. ``--device`` defaults to ``cuda`` and raises without a GPU.
"""

from __future__ import annotations

# Allow running as `python scripts/<name>.py` without installing the package.
import sys as _sys
from pathlib import Path as _Path

_repo = str(_Path(__file__).resolve().parents[1])
if _repo not in _sys.path:
    _sys.path.insert(0, _repo)

import argparse
import functools
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

from p2igan_tpu_torch.inference.driver import set_precision_policy
from p2igan_tpu_torch.losses import gan_loss, reconstruction_loss
from p2igan_tpu_torch.parallel.mesh import resolve_device
from p2igan_tpu_torch.utils import profiling

BLOCKS = ("g_fwd", "g_bwd", "d_step", "g_head", "opt_g")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--out", type=Path, default=None, help="also write the tables here")
    ap.add_argument("--batch", type=int, default=12)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--size", type=int, default=128, help="H = W")
    ap.add_argument("--frames", type=int, default=16, help="T, the window length")
    ap.add_argument("--base", type=int, default=64, help="base channels (4 x T)")
    return ap


def block_functions(s: profiling.GanStep) -> Dict[str, object]:
    """The blocks of ``s``'s step as calls without arguments, on the step's
    own models, optimizers and batch."""
    gen, disc, B = s.gen, s.disc, s.batch
    gan = functools.partial(gan_loss, loss_type=s.gan_loss_type)
    gparams = [p for p in gen.parameters() if p.requires_grad]

    def g_fwd():
        gen.train()
        return gen(s.masked, s.masks.expand_as(s.masked), idw_prepared=s.prep)

    preds0 = g_fwd().detach()
    ct = torch.ones_like(preds0)

    def g_fwdbwd():
        for p in gparams:
            p.grad = None
        g_fwd().backward(ct)

    def d_step():
        s.opt_d.zero_grad(set_to_none=True)
        logits = disc(torch.cat([preds0, s.frames], dim=0), update_stats=True)
        loss_d = (gan(logits[B:], True, is_disc=True)
                  + gan(logits[:B], False, is_disc=True)) * 0.5
        loss_d.backward()
        s.opt_d.step()

    def g_head():
        preds = preds0.clone().requires_grad_(True)
        rec, _ = reconstruction_loss(preds, s.frames, s.k1_alpha)
        disc.requires_grad_(False)
        try:
            logits = disc(preds, update_stats=True)
        finally:
            disc.requires_grad_(True)
        adv = gan(logits, True, is_disc=False) * s.adversarial_weight
        (rec + adv).backward()
        return preds.grad

    g_fwdbwd()  # the generator's gradients for opt_g

    def opt_g():
        s.opt_g.step()

    return {"g_fwd": g_fwd, "g_fwdbwd": g_fwdbwd, "d_step": d_step, "g_head": g_head,
            "opt_g": opt_g}


def roofline(args, dev: torch.device) -> Dict[str, object]:
    """Rows {block: (ms, ops, bytes, bound ms)} and the step's own."""
    H = W = args.size
    with tempfile.TemporaryDirectory() as tmp:
        cfg = profiling.gan_config(Path(tmp), H, W, args.frames, args.base,
                                   profiling.default_gauges(H, W))
        s = profiling.GanStep(cfg, args.batch, dev)
    fns = block_functions(s)
    measured = {}
    for name in ("g_fwd", "g_fwdbwd", "d_step", "g_head", "opt_g"):
        ms = profiling.timeit(fns[name], reps=args.reps, device=dev) * 1e3
        c = profiling.count_ops_bytes(fns[name])
        measured[name] = (ms, c["ops"], c["bytes"])
    fwd, fb = measured["g_fwd"], measured["g_fwdbwd"]
    measured["g_bwd"] = tuple(b - a for a, b in zip(fwd, fb))
    rows = {name: measured[name] + (profiling.bound_ms(*measured[name][1:]),)
            for name in BLOCKS}
    step_ms = profiling.timeit(s, reps=args.reps, device=dev) * 1e3
    c = profiling.count_ops_bytes(s)
    step = (step_ms, c["ops"], c["bytes"], c["bound_ms"])
    return {"rows": rows, "step": step, "fwdbwd": fb, "kernels": c["kernels"]}


def table(res: Dict[str, object], args, dev: torch.device) -> List[str]:
    rows, (step_ms, step_ops, step_bytes, step_bound) = res["rows"], res["step"]
    lines = [f"# Roofline of the port's GAN train step on {profiling.describe_device(dev)}", "",
             f"p2igan_gan_baseline_gauge.json at {args.size}x{args.size}, T={args.frames}, "
             f"base {args.base}, batch {args.batch}, hinge; TF32 off, cuDNN deterministic; "
             f"mean of {args.reps} calls a block. Bound = max(ops / 67 TFLOP/s, "
             f"bytes / 3.35 TB/s).", "",
             "| block | measured ms | GFLOP | MB (upper bound) | compute bound ms | "
             "bytes bound ms | bound ms | share of the bound |",
             "| --- | --- | --- | --- | --- | --- | --- | --- |"]
    for name in BLOCKS:
        ms, ops, nbytes, b = rows[name]
        lines.append(f"| {name} | {ms:.3f} | {ops / 1e9:.2f} | {nbytes / 1e6:.1f} | "
                     f"{ops / profiling.PEAK_FLOPS * 1e3:.3f} | "
                     f"{nbytes / profiling.PEAK_BYTES_PER_S * 1e3:.3f} | {b:.3f} | "
                     f"{b / ms if ms > 0 else float('nan'):.4f} |")
    block_ms = sum(rows[n][0] for n in BLOCKS)
    bound_sum = sum(rows[n][3] for n in BLOCKS)
    lines += ["",
              f"Whole step: **{step_ms:.3f} ms** ({1e3 / step_ms:.3f} steps/s); "
              f"{step_ops / 1e12:.4f} TFLOP (the blocks: "
              f"{sum(rows[n][1] for n in BLOCKS) / 1e12:.4f}), {step_bytes / 1e9:.3f} GB at "
              f"most; its own bound {step_bound:.3f} ms.",
              f"Blocks measured alone add up to {block_ms:.3f} ms; the sum of their bounds "
              f"is **{bound_sum:.3f} ms** = {bound_sum / step_ms:.4f} of the step.",
              f"Share of the float32 peak: {step_ops:.4e} operations / ({step_ms:.3f} ms x "
              f"67e12/s) = **{step_ops / (step_ms / 1e3 * profiling.PEAK_FLOPS):.4f}**.",
              "The port's kernels in the step (calls, GFLOP, MB by their bound formulas): "
              + "; ".join(f"{k} {v[0]}, {v[1] / 1e9:.4f}, {v[2] / 1e6:.3f}"
                          for k, v in sorted(res["kernels"].items()))]
    return lines


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    set_precision_policy()
    res = roofline(args, dev)
    lines = table(res, args, dev)
    profiling.write_out(args.out, lines)
    return {**res, "lines": lines}


if __name__ == "__main__":
    main()
