"""Profile the port's p2igan stis serving path (the counterpart of ``scripts/profile_infer.py``).

    python scripts/profile_infer_torch.py                 # on the card, full width
    python scripts/profile_infer_torch.py --device cpu --size 16 --frames 4 --base 16 \
        --event-frames 8 --store-events 2 --reps 2

At 128x128, T=16, base 64, window batch 8 and 64-frame events, with the
generator's DO-convs folded as ``run_inference`` folds them and the gauge
selection hoisted as the reconstructor hoists it, it prints three tables:

1. stage times (``utils.profiling.timeit``: CUDA events, mean of ``--reps``),
   each naming the port's function and the kernel it runs: the generator
   forward on 8 windows, the InputBlock, the gauge selection (#1
   ``gauge_topk``), the table combine on 8 windows (#2
   ``combine_table_multi``), the dense-field combine (#7 ``combine_dense``),
   and the 64-frame event through ``SlidingWindowReconstructor`` on device
   tensors and from host arrays;
2. the event's device time by family (``torch.profiler``, ``--trace-reps``
   events; ``utils.profiling.device_time_by_family``);
3. ``run_inference`` over ``--store-events`` events of a fake store: its
   setup (config load, test store open, model build, checkpoint read, fold;
   once a run) and, setup excluded, its host stages per event (the store
   read and mask build in the loader's threads and the main thread's wait
   for it, the copy to the device, the reconstruction, the copy back, the
   compress-and-write); the rates of plain runs, whose event loop is not
   wrapped, beside the staged run's; the device's busy share of a profiled
   run and of its event loop.

It never writes PROFILE.md: it prints, and ``--out`` writes the same text to
a file. ``--device`` defaults to ``cuda`` and raises without a GPU.
"""

from __future__ import annotations

# Allow running as `python scripts/<name>.py` without installing the package.
import sys as _sys
from pathlib import Path as _Path

_repo = str(_Path(__file__).resolve().parents[1])
if _repo not in _sys.path:
    _sys.path.insert(0, _repo)

import argparse
import contextlib
import json
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from p2igan_tpu_torch.config import load_config
from p2igan_tpu_torch.data import fake, zarrlite
from p2igan_tpu_torch.inference import driver
from p2igan_tpu_torch.ops.doconv import make_d_diag
from p2igan_tpu_torch.ops.idw import (factored_apply, factored_apply_gauges_batch,
                                      factored_prepare)
from p2igan_tpu_torch.ops.layers import InputBlock
from p2igan_tpu_torch.parallel.mesh import resolve_device
from p2igan_tpu_torch.training.trainer import device_busy_us
from p2igan_tpu_torch.utils import profiling

EVAL_CONFIG = profiling.CONFIG_DIR / "p2igan_baseline_eval.json"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--out", type=Path, default=None, help="also write the tables here")
    ap.add_argument("--size", type=int, default=128, help="H = W")
    ap.add_argument("--frames", type=int, default=16, help="T, the window length")
    ap.add_argument("--base", type=int, default=64, help="base channels (4 x T)")
    ap.add_argument("--event-frames", type=int, default=64)
    ap.add_argument("--window-batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--trace-reps", type=int, default=5)
    ap.add_argument("--store-events", type=int, default=64,
                    help="events of the fake store run_inference serves (enough that "
                         "the setup, once a run, is a few percent of it)")
    return ap


class Geometry:
    def __init__(self, args):
        self.H = self.W = args.size
        self.T, self.base, self.event_t = args.frames, args.base, args.event_frames
        self.wb = args.window_batch
        self.n_gauges = profiling.default_gauges(self.H, self.W)
        # the shipped stride 16 / overlap 12 at T=16
        self.stride, self.overlap = self.T, self.T * 3 // 4


def stage_timings(args, dev: torch.device, geo: Geometry) -> tuple:
    """[(stage, function, kernel, seconds)] and the device-resident event."""
    H, W, T, wb = geo.H, geo.W, geo.T, geo.wb
    mask_flat = profiling.gauge_mask(H, W, geo.n_gauges)
    gen = profiling.flagship_generator(
        H, W, T, geo.base, geo.n_gauges, dev).eval().fold_for_inference()
    rng = np.random.default_rng(profiling.SEED)
    mask_xy = torch.from_numpy(mask_flat.reshape(H, W)).to(dev)
    gauge = mask_xy.reshape(1, 1, H, W, 1).expand(wb, T, H, W, 1).contiguous()
    masked = torch.from_numpy(rng.random((wb, T, H, W, 1), dtype=np.float32)).to(dev) * gauge
    reps = dict(reps=args.reps, device=dev)
    rows = []
    with torch.inference_mode():
        prep = gen.prepare_idw(mask_xy)
        rows.append(("generator forward (8 windows)",
                     "P2IGenerator.forward (folded, selection hoisted)",
                     "#2, #3 x3, cuDNN",
                     profiling.timeit(lambda: gen(masked, gauge, idw_prepared=prep), **reps)))
        x_in = masked.permute(0, 1, 4, 2, 3).reshape(wb, T, H, W)
        m_in = gauge.permute(0, 1, 4, 2, 3).reshape(wb, T, H, W)
        rows.append(("InputBlock (attention + table combine)",
                     "InputBlock.forward(prepared=...)", "#2, cuBLAS",
                     profiling.timeit(lambda: gen.input(x_in, m_in, prepared=prep), **reps)))
        rows.append(("gauge selection", "P2IGenerator.prepare_idw -> factored_prepare_full",
                     "#1 gauge_topk",
                     profiling.timeit(lambda: gen.prepare_idw(mask_xy), **reps)))
        gd2, gsel, _ = prep
        G = InputBlock.gauge_budget(gen.idw_max_points, T)
        vals = torch.from_numpy(rng.random((wb, T, G), dtype=np.float32)).to(dev)
        rows.append(("table combine (8 windows)", "factored_apply_gauges_batch",
                     "#2 combine_table_multi",
                     profiling.timeit(lambda: factored_apply_gauges_batch(
                         gd2, gsel, vals, (H, W), k=4), **reps)))
        gd2_d, gpix_d = factored_prepare(mask_xy, G, k=4)
        dense = torch.from_numpy(rng.random((wb, T, H, W), dtype=np.float32)).to(dev)
        rows.append(("dense-field combine (8 windows, a call each)", "factored_apply",
                     "#7 combine_dense",
                     profiling.timeit(lambda: [factored_apply(gd2_d, gpix_d, dense[i], k=4)
                                               for i in range(wb)], **reps)))
        recon = driver.SlidingWindowReconstructor(gen, stride=geo.stride, overlap=geo.overlap,
                                                  window_batch=wb, output_scale=255.0)
        ev_mask = np.broadcast_to(mask_flat.reshape(1, H, W, 1),
                                  (geo.event_t, H, W, 1)).astype(np.float32)
        ev_masked = rng.random((geo.event_t, H, W, 1), dtype=np.float32) * ev_mask
        ev_m = torch.from_numpy(ev_masked[None]).to(dev)
        ev_k = torch.from_numpy(ev_mask[None]).to(dev)
        n_win = -(-geo.event_t // (geo.stride - geo.overlap))
        rows.append((f"event ({geo.event_t} frames, {n_win} windows, device tensors)",
                     "SlidingWindowReconstructor._reconstruct", "#1, #2, #3 x3, cuDNN",
                     profiling.timeit(lambda: recon._reconstruct(ev_m, ev_k), **reps)))
        rows.append((f"event ({geo.event_t} frames, host arrays in and out)",
                     "SlidingWindowReconstructor.__call__", "as above, + copies",
                     profiling.timeit(lambda: recon(ev_masked, ev_mask), **reps)))
    return rows, (recon, ev_m, ev_k)


# -- run_inference by host stage ---------------------------------------------------

# setup stages of run_inference, in the order the table lists them
SETUP_STAGES = (
    ("config load", "load_config", "config"),
    ("test store open and loader", "P2IDataModule, test_dataloader", "data"),
    ("model build", "build_generator_for_inference", "build"),
    ("checkpoint read", "load_generator_state", "checkpoint"),
    ("weights set and fold", "load_state_dict, fold_for_inference", "fold"),
)


class StageClock:
    """Patches ``inference.driver`` and ``zarrlite`` for one run of
    ``run_inference`` so that its stages add their seconds to ``self.seconds``.

    Every run gets the setup's stages (config load, data module, model
    build, checkpoint read, the fold) and the moment the event loop starts:
    wrappers around calls made once a run, nothing inside the loop. With
    ``per_event`` the loop's stages are timed too (the store read in the
    loader's threads, the main thread's wait for it, the copies, the
    reconstruction, the write); on the card each device stage then ends in a
    synchronize, which serving one event at a time does anyway where the
    copy back waits for the device."""

    def __init__(self, dev: torch.device, per_event: bool):
        self.cuda = dev.type == "cuda"
        self.per_event = per_event
        self.seconds: Dict[str, float] = {}
        self.lock = threading.Lock()
        self.t_start = self.t_loop = None

    def add(self, key: str, dt: float) -> None:
        with self.lock:
            self.seconds[key] = self.seconds.get(key, 0.0) + dt

    def setup_s(self) -> float:
        return self.t_loop - self.t_start

    def timed(self, key: str, fn, sync: bool = False):
        clock = self

        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if sync and clock.cuda:
                torch.cuda.synchronize()
            clock.add(key, time.perf_counter() - t0)
            return out
        return wrapper

    @contextlib.contextmanager
    def patched(self):
        clock = self
        R = driver.SlidingWindowReconstructor
        saved = [(driver, n, getattr(driver, n)) for n in
                 ("P2IDataModule", "build_generator_for_inference", "load_generator_state",
                  "load_generator")]
        if self.per_event:
            saved += [(R, n, R.__dict__[n]) for n in
                      ("_to_device", "_reconstruct", "__call__", "_check_gauge_budget")]
            saved += [(zarrlite.Group, "create_dataset", zarrlite.Group.create_dataset),
                      (zarrlite.Array, "__setitem__", zarrlite.Array.__setitem__)]
        base_dm = driver.P2IDataModule

        class TimedDataset:
            def __init__(self, ds):
                self._ds = ds

            def __len__(self):
                return len(self._ds)

            def __getitem__(self, idx, rng=None):
                t0 = time.perf_counter()
                out = self._ds.__getitem__(idx, rng=rng)
                clock.add("read", time.perf_counter() - t0)
                return out

            def __getattr__(self, item):
                return getattr(self._ds, item)

        class TimedLoader:
            def __init__(self, loader):
                if clock.per_event:
                    loader.dataset = TimedDataset(loader.dataset)
                self._loader = loader

            def __getattr__(self, item):
                return getattr(self._loader, item)

            def __setattr__(self, item, value):
                if item == "_loader":
                    object.__setattr__(self, item, value)
                else:
                    setattr(self._loader, item, value)

            def __len__(self):
                return len(self._loader)

            def __iter__(self):
                clock.t_loop = time.perf_counter()
                if not clock.per_event:
                    yield from self._loader
                    return
                it = iter(self._loader)
                while True:
                    t0 = time.perf_counter()
                    try:
                        item = next(it)
                    except StopIteration:
                        return
                    clock.add("wait", time.perf_counter() - t0)
                    yield item

        class TimedDataModule(base_dm):
            def __init__(self, *a, **kw):
                t0 = time.perf_counter()
                super().__init__(*a, **kw)
                clock.add("data", time.perf_counter() - t0)

            def test_dataloader(self):
                t0 = time.perf_counter()
                loader = super().test_dataloader()
                clock.add("data", time.perf_counter() - t0)
                return None if loader is None else TimedLoader(loader)

        driver.P2IDataModule = TimedDataModule
        driver.build_generator_for_inference = self.timed(
            "build", driver.build_generator_for_inference)
        driver.load_generator_state = self.timed("checkpoint", driver.load_generator_state)
        driver.load_generator = self.timed("load_generator", driver.load_generator, sync=True)
        if self.per_event:
            R._to_device = self.timed("to_device", R._to_device, sync=True)
            R._reconstruct = self.timed("reconstruct", R._reconstruct, sync=True)
            R.__call__ = self.timed("call", R.__call__)
            R._check_gauge_budget = self.timed("budget", R._check_gauge_budget)
            zarrlite.Group.create_dataset = self.timed("write", zarrlite.Group.create_dataset)
            zarrlite.Array.__setitem__ = self.timed("write", zarrlite.Array.__setitem__)
        try:
            yield self
        finally:
            for owner, name, value in saved:
                setattr(owner, name, value)


def write_store(tmp: Path, args, geo: Geometry) -> Path:
    """A fake test store of ``--store-events`` events, its gauge mask, a
    seeded generator checkpoint and the eval config that serves them."""
    H, W = geo.H, geo.W
    rng = np.random.default_rng(profiling.SEED)
    store = zarrlite.open_group(tmp / "test_events.zarr", mode="w")
    for i in range(args.store_events):
        frames = fake.synthesize_event(rng, geo.event_t, H, W).astype(np.float32)
        store.create_dataset(f"event_{i + 1:02d}", shape=frames.shape, chunks=frames.shape,
                             dtype="float32", data=frames)
    mask = fake.write_gauge_mask(tmp / "gauge_mask.txt", H=H, W=W, n_gauges=geo.n_gauges,
                                 seed=profiling.SEED)
    gen = profiling.flagship_generator(H, W, geo.T, geo.base, geo.n_gauges, "cpu")
    state = gen.state_dict()
    for key, val in list(state.items()):  # reference checkpoints carry D_diag
        if key.endswith(".D"):
            state[key[:-1] + "D_diag"] = torch.from_numpy(
                make_d_diag(val.shape[0], 3, 3, val.shape[2]))
    torch.save(state, tmp / "generator.pt")
    cfg = load_config(EVAL_CONFIG)
    cfg["model"]["base_channels"] = geo.base
    cfg["data"]["train"].update({"h": H, "w": W, "sample_length": geo.T,
                                 "data_root": str(tmp / "unread.zarr")})
    cfg["data"]["test"].update({"h": H, "w": W, "data_root": str(tmp / "test_events.zarr")})
    for split in ("train", "test"):
        cfg["data"][split]["mask"]["file"] = str(mask)
    cfg_path = tmp / "eval.json"
    cfg_path.write_text(json.dumps(cfg))
    return cfg_path


def serving_stages(args, dev: torch.device, geo: Geometry) -> Dict[str, object]:
    """``run_inference`` over the fake store, five runs in turn: a warm-up,
    a plain run, a run split into per-event stages, a second plain run, and
    a profiled run (device busy share). Every run times its setup (calls made
    once a run); only the staged run wraps the event loop."""
    from torch.profiler import ProfilerActivity, profile

    n = args.store_events
    runs: Dict[str, tuple] = {}
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        cfg_path = write_store(tmp, args, geo)

        def run(name: str, per_event: bool = False, prof=None) -> StageClock:
            clock = StageClock(dev, per_event)
            with clock.patched():
                clock.t_start = time.perf_counter()
                cfg = load_config(cfg_path)
                clock.add("config", time.perf_counter() - clock.t_start)
                driver.run_inference(cfg, checkpoint=str(tmp / "generator.pt"),
                                     output=str(tmp / "served.zarr"), stride=geo.stride,
                                     overlap=geo.overlap, window_batch=geo.wb,
                                     overwrite=True, log_every=10 ** 6,
                                     config_path=str(cfg_path), device=str(dev))
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                wall = time.perf_counter() - clock.t_start
            runs[name] = (wall, clock.setup_s())
            return clock

        run("warm-up")
        run("plain 1")
        clock = run("staged (loop wrapped, synchronized)", per_event=True)
        run("plain 2")
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=activities) as prof:
            run("profiled (torch.profiler)")
        busy_us = device_busy_us(prof)
    s = clock.seconds
    wall, setup = runs["staged (loop wrapped, synchronized)"]
    s["fold"] = s.get("load_generator", 0.0) - s.get("build", 0.0) - s.get("checkpoint", 0.0)
    lines = [f"## run_inference over {n} events of {geo.event_t} frames "
             f"(window batch {geo.wb}, one event at a time)", "",
             "Setup, once a run (the staged run):", "",
             "| setup stage | function | ms | share of the run |",
             "| --- | --- | --- | --- |"]
    in_setup = 0.0
    for name, fn, key in SETUP_STAGES:
        in_setup += s.get(key, 0.0)
        lines.append(f"| {name} | `{fn}` | {s.get(key, 0.0) * 1e3:.3f} | "
                     f"{s.get(key, 0.0) / wall:.4f} |")
    lines += [f"| the rest: mesh, precision policy, output store, reconstructor | "
              f"`run_inference` | {(setup - in_setup) * 1e3:.3f} | "
              f"{(setup - in_setup) / wall:.4f} |",
              f"| **setup, run start to the event loop** | | {setup * 1e3:.3f} | "
              f"{setup / wall:.4f} |", ""]
    copy_back = s.get("call", 0.0) - s.get("budget", 0.0) - s.get("to_device", 0.0) \
        - s.get("reconstruct", 0.0)
    stages = [
        ("waiting for the loader (main thread)", "Loader.__iter__", s.get("wait", 0.0)),
        ("mask budget check", "SlidingWindowReconstructor._check_gauge_budget",
         s.get("budget", 0.0)),
        ("copy to the device (masked, masks)", "SlidingWindowReconstructor._to_device",
         s.get("to_device", 0.0)),
        ("reconstruction (device, synchronized)", "SlidingWindowReconstructor._reconstruct",
         s.get("reconstruct", 0.0)),
        ("copy back", "Tensor.cpu().numpy() in SlidingWindowReconstructor.__call__",
         copy_back),
        ("compress and write", "write_event: Group.create_dataset, Array.__setitem__",
         s.get("write", 0.0)),
    ]
    loop = wall - setup
    in_stages = sum(v for _, _, v in stages)
    lines += ["Per event, setup excluded (the staged run's event loop):", "",
              "| host stage | function | ms an event | share of the event loop |",
              "| --- | --- | --- | --- |"]
    for name, fn, sec in stages:
        lines.append(f"| {name} | `{fn}` | {sec / n * 1e3:.3f} | {sec / loop:.4f} |")
    lines += [f"| the loop's rest (loop, logging, waits for the interpreter lock) | "
              f"`run_inference` | {(loop - in_stages) / n * 1e3:.3f} | "
              f"{(loop - in_stages) / loop:.4f} |", "",
              f"Store read and mask build in the loader's threads: "
              f"{s.get('read', 0.0) / n * 1e3:.3f} ms an event (overlapped with the main "
              f"thread; the wait above is what it costs it).", "",
              "| run | wall s | setup s | events/s, the run | events/s, the event loop |",
              "| --- | --- | --- | --- | --- |"]
    for name, (w, st) in runs.items():
        lines.append(f"| {name} | {w:.3f} | {st:.3f} | {n / w:.3f} | {n / (w - st):.3f} |")
    p_wall, p_setup = runs["profiled (torch.profiler)"]
    lines += ["", f"Profiled run: device busy {busy_us / 1e3:.3f} ms = {busy_us / 1e3 / n:.3f} "
                  f"ms an event; busy share {busy_us / 1e6 / p_wall:.4f} of the run, "
                  f"{busy_us / 1e6 / (p_wall - p_setup):.4f} of its event loop."]
    return {"lines": lines, "runs": runs, "seconds": dict(s), "busy_us": busy_us}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    driver.set_precision_policy()
    geo = Geometry(args)
    rows, (recon, ev_m, ev_k) = stage_timings(args, dev, geo)
    lines = [f"# The port's stis serving path on {profiling.describe_device(dev)}", "",
             f"{geo.H}x{geo.W}, T={geo.T}, base {geo.base}, window batch {geo.wb}, "
             f"{geo.event_t}-frame events, {geo.n_gauges} gauges; DO-convs folded, TF32 off, "
             f"cuDNN deterministic.", "",
             f"## Stage times (mean of {args.reps} calls)", "",
             "| stage | port function | kernel | ms |", "| --- | --- | --- | --- |"]
    for name, fn, kernel, sec in rows:
        lines.append(f"| {name} | `{fn}` | {kernel} | {sec * 1e3:.4f} |")
    ev_sec = rows[-2][3]
    lines += ["", f"Event reconstruction implies {1.0 / ev_sec:.2f} events/s on device "
                  f"tensors.", ""]
    with torch.inference_mode():
        trace = profiling.capture_trace(lambda: recon._reconstruct(ev_m, ev_k),
                                        reps=args.trace_reps, device=dev)
    fams = profiling.device_time_by_family(trace)
    lines += [f"## The event's device time by family ({args.trace_reps} events, "
              f"torch.profiler)", ""]
    lines += profiling.family_table(fams, f"{args.trace_reps} events")
    lines.append("")
    serving = serving_stages(args, dev, geo)
    lines += serving["lines"]
    profiling.write_out(args.out, lines)
    return {"stages": rows, "families": fams, "serving": serving, "lines": lines}


if __name__ == "__main__":
    main()
