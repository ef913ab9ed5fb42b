"""The training entry: ``Trainer.train()`` of the port, the path
``scripts/train_torch.py`` runs, over a seeded train store.

One trainer is built, given the run's seeded weights and trained once:

* steps 1-3 are the correctness steps: their losses, the optimizers' state
  after step 1 and the parameters after step 3 are read for the comparison
  with the plain reference (a device sync each, before the window);
* warm-up steps follow, up to the workload's ``warmup_steps``;
* the window runs from the first log point at or after the warm-up to the
  first log point at or after ``--seconds`` (``Trainer.log_times``, taken
  after a device sync): ``train_samples_per_s`` is the windows of frames
  trained between the two over their seconds. A cell either keeps the
  epoch end (the loader's restart, the examples, the checkpoint) out of
  its window by a long epoch, or logs at each epoch's last step, so that
  its window is whole epochs; in neither does the share of epoch ends in
  the window follow the speed. The result line's ``window`` counts them;
* with ``--trace 1`` the profiler then covers ``trace_steps`` more steps.

Nothing runs inside the trainer but its own code: the step it built is
wrapped to keep this clock and to read the state above, and the batch
generator is wrapped to time the step loop's wait for each batch.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from typing import Dict

import numpy as np
import torch

from portbench import core, tracing
from portbench.reference import common
from portbench.reference import train as ref_train
from portbench.traffic.events import make_traffic


def program_config(ctx, data) -> Dict:
    import copy

    cfg = copy.deepcopy(ctx.cell.config)
    wl = ctx.cell.workload
    cfg["seed"] = ctx.seed
    cfg["save_dir"] = str(ctx.tmp / "weights")
    cfg["data"]["train"]["data_root"] = str(data["store"])
    for split in cfg["data"].values():
        if isinstance(split, dict) and isinstance(split.get("mask"), dict):
            split["mask"]["file"] = str(data["mask_file"])
    empty = ctx.tmp / "no_test_events"  # the trainer serves nothing
    empty.mkdir(exist_ok=True)
    cfg["data"]["test"]["data_root"] = str(empty)
    cfg["train"].update(wl["train"])
    return cfg


def leaf_norms(module, prefix: str, of) -> Dict[str, float]:
    return {f"{prefix}:{n}": float(of(n, p)) for n, p in module.named_parameters()}


def run(ctx: core.RunContext) -> None:
    from p2igan_tpu_torch.training.trainer import Trainer
    from p2igan_tpu_torch.utils.tracking import NullTracker

    wl = ctx.cell.workload
    model = core.reference_module(ctx.cell)
    data = make_traffic(wl["traffic"], ctx.seed, ctx.tmp, ctx.device)
    core.phase(ctx, "traffic made and written")
    cfg = program_config(ctx, data)
    log_step = int(cfg["train"]["log_step"])
    warmup = int(wl["warmup_steps"])
    tail = int(wl["trace_steps"]) if ctx.trace else 0
    batch = int(cfg["train"]["batch_size"])
    b2 = float(cfg["train"]["optimizer"].get("beta2", 0.99))
    cuda = ctx.device.startswith("cuda")
    seg = tracing.Segment(cuda)
    prog: Dict = {"losses": [], "grad1": {}, "change": {}}
    clock = {"start": None, "end_step": None, "waits": {}, "rows": {}}

    weights = {f"G:{n}": t for n, t in common.make_weights(
        model.generator_spec(cfg), ctx.seed, ctx.device).items()}
    if cfg["loss"].get("use_gan", 0):
        weights.update({f"D:{n}": t for n, t in common.make_weights(
            model.critic_spec(cfg), ctx.seed + 1, ctx.device).items()})

    class BenchTrainer(Trainer):
        def _build_steps(self, idw_prepared=None):
            super()._build_steps(idw_prepared)
            self.train_step = wrap(self.train_step)

        def _device_prefetch(self, loader, lookahead=2):
            it = super()._device_prefetch(loader, lookahead)
            try:
                while True:
                    t0 = time.perf_counter()
                    if seg.running:
                        with torch.profiler.record_function("portbench::loader_wait"):
                            item = next(it, None)
                    else:
                        item = next(it, None)
                    if item is None:
                        return
                    clock["waits"][self.global_step + 1] = time.perf_counter() - t0
                    yield item
            finally:
                it.close()

    def wrap(fn):
        def step(frames, masked, masks):
            n = trainer.global_step + 1
            logs = trainer.log_times
            if clock["start"] is None and logs and logs[-1][0] >= warmup:
                clock["start"] = logs[-1]
                core.phase(ctx, f"window opens at step {logs[-1][0]}", logs[-1][1])
            elif n == 4:
                core.phase(ctx, "three correctness steps done")
            if tail and n == (clock["end_step"] or -1) + 1:
                seg.start()
            out = fn(frames, masked, masks)
            clock["rows"][n] = frames.shape[0]
            if n <= 3:
                prog["losses"].append({k: float(out[k]) for k in ("loss", "dis_loss") if k in out})
            if n == 1:
                for module, opt, p in ((trainer.generator, trainer.opt_g, "G"),
                                       (trainer.discriminator, trainer.opt_d, "D")):
                    if module is not None:
                        prog["grad1"].update(leaf_norms(module, p, lambda _, q: math.sqrt(
                            float(opt.state[q]["nu"].sum()) / (1.0 - b2))
                            if opt.state.get(q) else 0.0))
            if n == 3:
                for module, p in ((trainer.generator, "G"), (trainer.discriminator, "D")):
                    if module is not None:
                        prog["change"].update(leaf_norms(module, p, lambda name, q: torch.linalg
                                                         .vector_norm(q.detach() - weights[f"{p}:{name}"])))
            if seg.running:
                seg.units += 1
                if n == clock["end_step"] + tail:
                    seg.stop()
            elif (clock["start"] is not None and clock["end_step"] is None and n % log_step == 0
                  and n > clock["start"][0]
                  and time.perf_counter() - clock["start"][1] >= ctx.seconds):
                clock["end_step"] = n
                trainer.max_steps = n + tail
            return out
        return step

    trainer = BenchTrainer(cfg, device=ctx.device)
    trainer.tracker = NullTracker()
    core.phase(ctx, "trainer built")
    trainer.generator.load_state_dict({k[2:]: v for k, v in weights.items() if k[0] == "G"})
    if trainer.discriminator is not None:
        trainer.discriminator.load_state_dict({k[2:]: v for k, v in weights.items() if k[0] == "D"})
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    trainer.train()
    if cuda:
        torch.cuda.synchronize()
        ctx.memory_peak_bytes = torch.cuda.max_memory_allocated()
    logs = dict(trainer.log_times)
    if clock["end_step"] is None:
        raise RuntimeError("the window never closed: the trainer stopped first")
    s0, t0 = clock["start"]
    s1, t1 = clock["end_step"], logs[clock["end_step"]]
    window_s = t1 - t0
    per_epoch = trainer.train_steps_per_epoch
    # the end of the epoch whose last step is k follows k's log point: the
    # window (after s0's, to s1's) holds the ends of s0 <= k < s1
    epoch_ends = -(-s1 // per_epoch) - -(-s0 // per_epoch)
    samples = sum(clock["rows"][s] for s in range(s0 + 1, s1 + 1))
    ctx.attempted = samples
    ctx.produced["train_samples_per_s"] = samples / window_s
    ctx.produced["setup_s"] = t0 - ctx.t_process
    waits = [clock["waits"][s] for s in range(s0 + 1, s1 + 1) if s in clock["waits"]]
    ctx.layer.update({"entry": "train", "window_s": window_s, "steps": s1 - s0,
                      "loader_wait_s": waits, "sizes": model.sizes(cfg), "batch": batch})
    ctx.window = {"steps": s1 - s0, "samples": samples, "epoch_ends": epoch_ends,
                  "steps_per_epoch": per_epoch, "seconds": window_s}
    marks = [(s, t) for s, t in trainer.log_times if s0 <= s <= s1]
    print(f"window: steps {s0}-{s1}, {window_s:.6f} s, epoch ends inside: {epoch_ends} "
          f"(an epoch {per_epoch} steps); seconds between log points: "
          + " ".join(f"{b[1] - a[1]:.3f}" for a, b in zip(marks, marks[1:])), file=sys.stderr)
    del trainer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if ctx.trace:
        ctx.trace_summary = seg.summary()
        tracing.print_summary(ctx.trace_summary)
        ctx.layer["flops_per_step"] = count_step_flops(model, cfg, data["mask"], batch)

    rows = ref_train.training_windows(wl["traffic"]["n_events"], wl["traffic"]["event_frames"],
                                      wl["traffic"]["window"], ctx.seed, 3, batch)
    batches = [ref_train.batch_frames(data["frames"], r, wl["traffic"]["window"]) for r in rows]
    ref = ref_train.run_steps(model, cfg, weights, batches, data["mask"], ctx.device)
    for step, (p, r) in enumerate(zip(prog["losses"], ref["losses"]), 1):
        print(f"step {step}: " + ", ".join(f"{k} {p[k]!r} reference {r[k]!r}" for k in r),
              file=sys.stderr)
    for name, value in ref_train.gaps(prog, ref).items():
        core.check(ctx, name, value)


def count_step_flops(model, cfg: Dict, mask: np.ndarray, batch: int) -> float:
    """Operations of one training step of the plain reference at the cell's
    shapes (convolutions and matrix products, forward and backward, as
    ``torch.utils.flop_counter`` counts them), on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    s = model.sizes(cfg)
    gan = bool(cfg["loss"].get("use_gan", 0))
    dev = "meta"
    x = torch.zeros((batch, s["T"], s["H"], s["W"], 1), device=dev)
    prep = model.prepare(mask, s["T"], dev)
    g = {n: torch.zeros(shape, device=dev, requires_grad=True)
         for n, shape, *_ in model.generator_spec(cfg)}
    c_spec = model.critic_spec(cfg) if gan else []
    c = {n: torch.zeros(shape, device=dev, requires_grad=not n.endswith(("_u", "_v")))
         for n, shape, *_ in c_spec}
    state = {n: t for n, t in c.items() if n.endswith(("_u", "_v"))}
    with FlopCounterMode(display=False) as counter:
        preds = model.generator(g, x, prep, cfg)
        if gan:
            logits = model.critic(c, state, torch.cat([preds.detach(), x]), update=True)
            common.hinge_d(logits[batch:], logits[:batch]).backward()
        loss = common.reconstruction_loss(preds, x, float(cfg["loss"].get("k1_weight", 0.0)))
        if gan:
            frozen = {n: t.detach() for n, t in c.items()}
            loss = loss - torch.mean(model.critic(frozen, state, preds, update=True))
        loss.backward()
    return float(counter.get_total_flops())

