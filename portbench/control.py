"""Readings that set the upper ends of a cell's limits, at the cell's own size.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed, on the card, it makes the cell's inputs and weights as a run
does and prints one JSON line of readings:

* ``control``: the plain reference computed with TF32 (the nearest precision
  below the configuration's float32 with TF32 off) put in the program's
  place, compared with the float32 reference by the cell's own numbers;
* training cells, ``half_batch``: the reference with half of every batch
  left out (the mean taken over the rest), compared the same way. A state
  left unchanged reads 1 on ``change_gap`` by its definition and needs no
  run.

The benchmark's own runs never run this; ``tests/test_portbench_control.py``
does, and so does whoever sets a limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from portbench import core  # noqa: E402


def readings(cell: core.Cell, seed: int, device: str) -> dict:
    import numpy as np
    import torch

    from portbench.reference import common
    from portbench.reference import serve as ref_serve
    from portbench.reference import train as ref_train
    from portbench.traffic.events import synthesize_events, gauge_mask

    wl, cfg = cell.workload, cell.config
    model = core.reference_module(cell)
    t = wl["traffic"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    mask = gauge_mask(gen, t["h"], t["w"], t["n_gauges"])
    frames = synthesize_events(gen, t["n_events"], t["event_frames"], t["h"], t["w"],
                               t["n_cells"], device)
    out = {"cell": cell.name, "seed": seed}
    if cell.entry == "train":
        weights = {f"G:{n}": v for n, v in common.make_weights(
            model.generator_spec(cfg), seed, device).items()}
        if cfg["loss"].get("use_gan", 0):
            weights.update({f"D:{n}": v for n, v in common.make_weights(
                model.critic_spec(cfg), seed + 1, device).items()})
        batch = int(cfg["train"]["batch_size"])
        rows = ref_train.training_windows(t["n_events"], t["event_frames"], t["window"],
                                          seed, 3, batch)
        batches = [ref_train.batch_frames(frames, r, t["window"]) for r in rows]
        ref = ref_train.run_steps(model, cfg, weights, batches, mask, device)
        for name, kw in (("control", {"tf32": True}), ("half_batch", {"half_batch": True})):
            out[name] = ref_train.gaps(ref_train.run_steps(model, cfg, weights, batches, mask,
                                                           device, **kw), ref)
    else:
        weights = ref_serve.served_weights(model, cfg, frames, mask, seed, device)
        s = wl["serve"]
        kw = dict(stride=s["stride"], overlap=s["overlap"], output_scale=s["output_scale"],
                  window_batch=s["window_batch"])
        events = range(len(frames))
        ref = ref_serve.serve_events(model, cfg, weights, frames, mask, events, device, **kw)
        low = ref_serve.serve_events(model, cfg, weights, frames, mask, events, device,
                                     tf32=True, **kw)
        out["control"] = {"max_gap": max(float(np.max(np.abs(low[e] - ref[e]))) for e in ref)}
    out["limits"] = wl["limits"]
    return out


def fails(numbers: dict, limits: dict) -> bool:
    """Whether one of ``numbers`` is over its limit."""
    return any(v > limits[k] for k, v in numbers.items())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = core.load_cell(args.workload)
    with tempfile.TemporaryDirectory() as tmp:
        core.environment(Path(tmp), CHECKOUT)
        for seed in args.seeds:
            print(json.dumps(readings(cell, seed, "cuda:0")), flush=True)


if __name__ == "__main__":
    main()
