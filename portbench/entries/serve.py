"""The serving entry: ``run_inference`` of the port, the path
``scripts/infer_torch.py`` runs, called again and again over a seeded
archive of events.

Set-up writes the store, the gauge file and a checkpoint of the run's
seeded generator weights (``reference/serve.py`` ``served_weights``: their
output rows' signs balanced, so that every seed clips the same share of the
served values to 0 and the write does the same work), then serves a small
store of the same events once to warm every shape. The window holds whole ``run_inference`` calls, each
with its own set-up (config, store open, model build, checkpoint read, the
fold), calls following one another until ``--seconds`` have passed at the
end of one. ``serve_events_per_s`` is the archive's events times the calls,
over the calls' seconds: it reads nothing inside a call.

Each call writes the output store with ``overwrite=True``, as a user
reprocessing an archive does: one store, which the next call replaces,
except the call drawn from the seed, which writes a store of its own. Both
that store and the last call's are read back once the window has closed and
compared, every event and frame, with the plain reference's.

Per-event host times (the per-layer ``event_p95_ms.serve`` and
``write_ms.serve``) come from wrappers around the test loader's iterator
and the store writer (the staged wrappers of ``profile_infer_torch.py``),
which read the host clock and nothing else. With ``--trace 1`` one more
call serves the archive's first ``trace_skip + trace_events`` events, under
the profiler from its ``trace_skip``-th event to its return.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import statistics
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import core, tracing
from portbench.reference import serve as ref_serve
from portbench.traffic.events import make_traffic, write_test_store

# the call whose store is kept is drawn from the first calls, which every
# window of the cell holds
KEPT_CALL_CHOICES = 4


class EventClock:
    """Per-event host times of the calls made inside :meth:`patched`."""

    def __init__(self, seg: tracing.Segment):
        self.seg = seg
        self.take: List[float] = []
        self.done: List[float] = []
        self.write_s: List[float] = []
        self._write = 0.0
        self.trace_from = None

    @contextlib.contextmanager
    def patched(self):
        from p2igan_tpu_torch.data import datamodule, zarrlite

        clock = self
        Loader, Group, Array = datamodule.Loader, zarrlite.Group, zarrlite.Array
        saved = [(Loader, "__iter__", Loader.__iter__),
                 (Group, "create_dataset", Group.create_dataset),
                 (Array, "__setitem__", Array.__setitem__)]
        base_iter, base_create, base_set = (s[2] for s in saved)

        def iterate(loader):
            for item in base_iter(loader):
                if clock.trace_from is not None and len(clock.take) == clock.trace_from:
                    clock.seg.start()
                clock.take.append(time.perf_counter())
                yield item

        def create(group, *a, **kw):
            t0 = time.perf_counter()
            out = base_create(group, *a, **kw)
            clock._write += time.perf_counter() - t0
            return out

        def setitem(array, key, value):
            t0 = time.perf_counter()
            if clock.seg.running:
                with torch.profiler.record_function("portbench::write"):
                    base_set(array, key, value)
                clock.seg.units += 1
            else:
                base_set(array, key, value)
            t1 = time.perf_counter()
            clock.write_s.append(clock._write + t1 - t0)
            clock._write = 0.0
            clock.done.append(t1)

        Loader.__iter__, Group.create_dataset, Array.__setitem__ = iterate, create, setitem
        try:
            yield self
        finally:
            for owner, name, value in saved:
                setattr(owner, name, value)


def run(ctx: core.RunContext) -> None:
    from p2igan_tpu_torch.inference.driver import run_inference

    wl = ctx.cell.workload
    model = core.reference_module(ctx.cell)
    data = make_traffic(wl["traffic"], ctx.seed, ctx.tmp, ctx.device)
    core.phase(ctx, "traffic made and written")
    cfg = copy.deepcopy(ctx.cell.config)
    cfg["seed"] = ctx.seed
    for split in cfg["data"].values():
        if isinstance(split, dict) and isinstance(split.get("mask"), dict):
            split["mask"]["file"] = str(data["mask_file"])
    cfg["data"]["train"]["data_root"] = str(ctx.tmp / "unused_train.zarr")
    weights = ref_serve.served_weights(model, cfg, data["frames"], data["mask"], ctx.seed,
                                       ctx.device)
    ckpt = ctx.tmp / "generator.pt"
    torch.save({k[2:]: v.cpu() for k, v in weights.items()}, ckpt)
    kw = dict(checkpoint=str(ckpt), overwrite=True, device=ctx.device, **wl["serve"])
    cuda = ctx.device.startswith("cuda")
    n_events = len(data["frames"])
    kept_call = int(np.random.default_rng(ctx.seed).integers(KEPT_CALL_CHOICES))

    def call(store, out):
        c = copy.deepcopy(cfg)
        c["data"]["test"]["data_root"] = str(store)
        return run_inference(c, output=str(out), **kw)

    core.phase(ctx, "checkpoint written")
    call(data["warmup_store"], ctx.tmp / "warmup_out.zarr")
    core.phase(ctx, "warm-up call done")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    seg = tracing.Segment(cuda)
    clock = EventClock(seg)
    shared, kept = ctx.tmp / "out.zarr", ctx.tmp / "out_kept.zarr"
    calls = []  # (start, end, events taken before it) of each call
    with clock.patched():
        t_start = time.perf_counter()
        while True:
            t0, before = time.perf_counter(), len(clock.take)
            call(data["store"], kept if len(calls) == kept_call else shared)
            calls.append((t0, time.perf_counter(), before))
            t_end = calls[-1][1]
            if t_end - t_start >= ctx.seconds:
                break
        n_window = len(clock.take)
        if cuda:
            ctx.memory_peak_bytes = torch.cuda.max_memory_allocated()
        if ctx.trace:
            traced = write_test_store(ctx.tmp / "trace_events.zarr",
                                      data["frames"][:wl["trace_skip"] + wl["trace_events"]])
            clock.trace_from = wl["trace_skip"] + len(clock.take)
            call(traced, ctx.tmp / "traced_out.zarr")
            seg.stop()
    take, done = clock.take[:n_window], clock.done[:n_window]
    latency = [d - t for t, d in zip(take, done)]
    window_s = t_end - t_start
    ctx.attempted = n_events * len(calls)
    ctx.produced["serve_events_per_s"] = n_events * len(calls) / window_s
    ctx.produced["setup_s"] = t_start - ctx.t_process
    ctx.layer.update({"entry": "serve", "window_s": window_s, "events": n_events * len(calls),
                      "write_s": clock.write_s[:n_window], "latency_s": latency,
                      "sizes": model.sizes(cfg)})
    ctx.window = {"calls": len(calls), "events": n_events * len(calls),
                  "kept_call": kept_call, "seconds": window_s}
    firsts = [take[b] - s if b < len(take) else float("nan") for s, _, b in calls]
    print(f"window: {len(calls)} calls, {n_events * len(calls)} events, {window_s:.6f} s; "
          "calls (seconds, of them before the first event): "
          + " ".join(f"{e - s:.3f}/{f:.3f}" for (s, e, _), f in zip(calls, firsts))
          + f"; event ms p50 {1e3 * statistics.median(latency):.2f}, write ms mean "
          f"{1e3 * statistics.fmean(clock.write_s[:n_window]):.2f}", file=sys.stderr)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if ctx.trace:
        ctx.trace_summary = seg.summary()
        tracing.print_summary(ctx.trace_summary)
        ctx.layer["flops_per_event"] = count_event_flops(model, cfg, data["mask"],
                                                         data["frames"].shape[1], wl["serve"])
    # the kept call's store, where the window reached that call, and the
    # store the last other call left
    stores = [kept] * (kept_call < len(calls)) + [shared] * (len(calls) > 1 or kept_call > 0)
    compare(ctx, model, cfg, weights, data, stores)


def compare(ctx, model, cfg, weights, data, outputs) -> None:
    """``max_gap``: the widest |served - reference| over every frame of
    every event of the kept calls' stores, x255 units, read back from disk;
    an event missing from a store reads as an infinite gap."""
    from p2igan_tpu_torch.data import zarrlite

    frames = data["frames"]
    serve = ctx.cell.workload["serve"]
    ref = ref_serve.serve_events(model, cfg, weights, frames, data["mask"], range(len(frames)),
                                 ctx.device, stride=serve["stride"], overlap=serve["overlap"],
                                 output_scale=serve["output_scale"],
                                 window_batch=serve["window_batch"])
    gap = 0.0
    for out in outputs:
        if not out.is_dir():
            gap = float("inf")
            continue
        store = zarrlite.open_group(out, mode="r")
        zeros = values = 0
        for e, want in ref.items():
            key = f"event_{e + 1:02d}"
            if key not in store:
                gap = float("inf")
                continue
            got = np.asarray(store[key][:])
            gap = max(gap, float(np.max(np.abs(got - want))) if got.shape == want.shape
                      else float("inf"))
            zeros, values = zeros + int(np.count_nonzero(got == 0)), values + got.size
        size = sum(f.stat().st_size for f in out.rglob("*") if f.is_file())
        print(f"store {out.name}: {size} bytes on disk, {zeros / max(values, 1):.4f} of the "
              "served values 0", file=sys.stderr)
    core.check(ctx, "max_gap", gap)


def count_event_flops(model, cfg: Dict, mask: np.ndarray, event_frames: int,
                      serve: Dict) -> float:
    """Operations of one event's reconstruction by the plain reference (every
    window's generator forward), on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    s = model.sizes(cfg)
    step = max(1, serve["stride"] - serve["overlap"])
    n_windows = len(range(0, event_frames, step))
    prep = model.prepare(mask, s["T"], "meta")
    g = {n: torch.zeros(shape, device="meta") for n, shape, *_ in model.generator_spec(cfg)}
    x = torch.zeros((n_windows, s["T"], s["H"], s["W"], 1), device="meta")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model.generator(g, x, prep, cfg)
    return float(counter.get_total_flops())
