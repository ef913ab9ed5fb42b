"""Training orchestration of the port (PyTorch, one device).

Counterpart of ``p2igan_tpu/training/trainer.py`` (reference
``scripts/train.py:98-225``). Owns the data module, the generator and
discriminator, their optimizers, the tracker run and the checkpoints:

* models are seeded from explicit ``torch.Generator``s: ``seed`` for the
  generator, ``seed + 1`` for the discriminator; the data's per-item numpy RNG
  comes from (seed, epoch, index), as in the JAX package;
* the stis gauge selection of p2igan is hoisted out of the step at the first
  batch (the mask is one fixed file, so the selection is a constant of the
  run); dk, stdk and simple have no IDW to hoist;
* BatchNorm running statistics (the simple generator and critic) are module
  buffers: the steps set the mode, and checkpoints carry them under ``extra``;
* a prefetch thread copies batches from pinned host memory with
  ``non_blocking`` copies on a side stream, ``lookahead`` batches ahead; the
  raw (``data.train.device_decode``) pipeline ships uint8 frames and masks and
  decodes them on the device (``ops/decode_mask.py``);
* ``max_steps`` / ``max_epochs``, validation, ``latest.ckpt`` every epoch and
  ``best.ckpt`` on a better validation loss, ``load`` for resume, steps/s
  logging, and an optional ``torch.profiler`` window (``train.profile_dir``).

Not ported: the example images of every epoch (``_log_examples``, which needs
matplotlib), the validation metric suite (``train.eval_metrics``) and the
device mesh (one device here).
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from ..config import flatten_dict
from ..data.datamodule import P2IDataModule
from ..inference.driver import resolve_device, set_precision_policy
from ..models import build_discriminator, build_generator
from ..ops.decode_mask import decode_normalize_mask
from ..utils.tracking import get_tracker
from .checkpoint import load_checkpoint_raw, save_checkpoint
from .steps import build_eval_step, build_predict_fn, build_train_step, make_optimizer


def device_busy_us(prof) -> float:
    """Microseconds in a ``torch.profiler`` window during which the device ran
    something: the union of its device-side intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (0.0 if cur_e is None else cur_e - cur_s)


class Trainer:
    def __init__(self, cfg: Dict[str, Any], device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        set_precision_policy()
        self.seed = cfg.get("seed", 42)
        train_cfg = cfg.get("train", {})
        if train_cfg.get("eval_metrics"):
            raise NotImplementedError("train.eval_metrics: the metric suite is "
                                      "not ported yet")

        logging.info("Initializing data module...")
        self.data_module = P2IDataModule(cfg)
        self.train_loader = self.data_module.train_dataloader()
        self.val_loader = self.data_module.val_dataloader()
        self.run_validation = bool(train_cfg.get("use_validation", True))
        logging.info("Data loaders ready | train=%s, val=%s",
                     len(self.train_loader) if self.train_loader else 0,
                     len(self.val_loader) if self.val_loader else 0)
        self.train_steps_per_epoch = max(1, len(self.train_loader) if self.train_loader else 1)

        logging.info("Building models on %s...", self.device)
        self.use_gan = bool(cfg["loss"].get("use_gan", 0))
        self.generator = build_generator(
            cfg, device=self.device, generator=torch.Generator().manual_seed(self.seed))
        self.discriminator = None
        if self.use_gan:
            self.discriminator = build_discriminator(
                cfg, device=self.device,
                generator=torch.Generator().manual_seed(self.seed + 1))
        self._check_window_length()

        opt_cfg = cfg["train"]["optimizer"]
        self.opt_g = make_optimizer(opt_cfg, self.generator.parameters())
        self.opt_d = (make_optimizer(opt_cfg, self.discriminator.parameters())
                      if self.discriminator is not None else None)
        self.k1_alpha = cfg["loss"].get("k1_weight", 0.0)

        self.save_dir = Path(cfg.get("save_dir", "weights"))
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.log_every = int(train_cfg.get("log_step", 100))
        self.global_step = 0
        self.start_epoch = 0
        # `iterations: 0` means unset, as in the JAX trainer
        self.max_steps = train_cfg.get("iterations") or None
        self.max_epochs = train_cfg.get("max_epochs")
        if self.max_epochs is None:
            if self.max_steps:
                self.max_epochs = -(-int(self.max_steps) // self.train_steps_per_epoch)
            else:
                self.max_epochs = train_cfg.get("niter", 1)
        if self.max_steps is None:
            self.max_steps = self.max_epochs * self.train_steps_per_epoch
        self.best_val = float("inf")

        self._step_kwargs = dict(
            use_gan=self.use_gan, gan_loss_type=cfg["loss"].get("gan_loss", "hinge"),
            adversarial_weight=cfg["loss"].get("adversarial_weight", 0.01),
            k1_alpha=self.k1_alpha,
            gan_real_label=cfg["loss"].get("target_real_label", 1.0),
            gan_fake_label=cfg["loss"].get("target_fake_label", 0.0),
            fused_disc_forward=bool(train_cfg.get("fused_disc_forward", True)))
        self._build_steps()
        mask_cfg = cfg.get("data", {}).get("train", {}).get("mask", {}) or {}
        self._idw_hoist_pending = bool(
            mask_cfg.get("type") == "stis"
            and getattr(self.generator, "idw_factored", False)
            and getattr(self.generator, "idw_shared_batch_mask", False)
            and hasattr(self.generator, "prepare_idw"))
        self.tracker = get_tracker()
        self.profile_dir = train_cfg.get("profile_dir")
        self.profile_start = int(train_cfg.get("profile_start_step", 2))
        self.profile_steps = int(train_cfg.get("profile_steps", 3))
        self._profiler = None
        self._profile_done = False
        self._profile_stop_at = 0
        self._profile_t0 = 0.0
        # (global_step, seconds) at every log point, after a device sync
        self.log_times: list = []
        self.last_rec_loss = self.last_adv_loss = self.last_dis_loss = float("nan")

    # ------------------------------------------------------------------
    def _build_steps(self, idw_prepared=None) -> None:
        self.train_step = build_train_step(
            self.generator, self.discriminator, self.opt_g, self.opt_d,
            idw_prepared=idw_prepared, **self._step_kwargs)
        self.eval_step = build_eval_step(self.generator, k1_alpha=self.k1_alpha,
                                         idw_prepared=idw_prepared)
        self.predict_fn = build_predict_fn(self.generator, idw_prepared=idw_prepared)

    def _maybe_hoist_idw(self, masks: torch.Tensor) -> None:
        """Compute the stis gauge selection once, from the first batch's mask,
        and build the steps around it; masks that vary within the batch keep
        the in-step selection."""
        self._idw_hoist_pending = False
        if not bool((masks[:1, :1] == masks).all()):
            logging.warning("stis masks vary within the first batch; keeping "
                            "the in-step gauge selection")
            return
        prep = self.generator.prepare_idw(masks[0, 0, :, :, 0])
        self._build_steps(idw_prepared=prep)
        logging.info("Hoisted the stis gauge selection out of the train step")

    def _check_window_length(self) -> None:
        """Fail fast with a named error when the train zarr's window length
        cannot feed the fixed-length generator."""
        model_len = getattr(self.generator, "length", None)
        if not model_len or self.train_loader is None:
            return
        ds = self.train_loader.dataset
        ds = getattr(ds, "dataset", ds)  # unwrap the split Subset
        index = getattr(ds, "index_arr", None)
        if index is None:
            return
        lengths = set(int(v) for v in np.unique(index[:, 2]))
        if lengths - {int(model_len)}:
            raise ValueError(
                f"train zarr windows have length(s) {sorted(lengths)} but the "
                f"'{self.cfg.get('model', {}).get('name')}' generator expects "
                f"sample_length={model_len}; rebuild the train store with a "
                f"matching window or set data.train.sample_length to the "
                f"store's window length.")

    # ------------------------------------------------------------------
    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _put_batch(self, batch):
        """A host batch -> (frames, masked, masks) on the device. Raw pairs
        (uint8 frames, uint8 mask) are decoded there; a frame-constant mask
        stays (B, 1, H, W, C) and the steps broadcast it."""
        if len(batch) == 2:
            u8, mask_u8 = (self._to_device(a) for a in batch)
            video, masked = decode_normalize_mask(u8, mask_u8)
            return video, masked, mask_u8.to(torch.float32)
        return tuple(self._to_device(a) for a in batch)

    def _device_prefetch(self, loader, lookahead: int = 2):
        """Batches on the device, ``lookahead`` ahead: a worker thread copies
        (and decodes) them on a side stream; the training stream waits on an
        event per batch."""
        q: "queue.Queue" = queue.Queue(maxsize=max(1, lookahead))
        end = object()
        stop = threading.Event()
        side = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

        def put(item) -> bool:
            # gives up when the consumer is gone (max_steps broke the loop)
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                it = iter(loader)
                try:
                    for batch in it:
                        if side is None:
                            item = (self._put_batch(batch), None)
                        else:
                            with torch.cuda.stream(side):
                                tensors = self._put_batch(batch)
                                ready = torch.cuda.Event()
                                ready.record(side)
                            item = (tensors, ready)
                        if not put(item):
                            return
                finally:
                    close = getattr(it, "close", None)
                    if close is not None:
                        close()
                put(end)
            except BaseException as e:  # re-raised in the training thread
                put(e)

        threading.Thread(target=worker, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is end:
                    return
                if isinstance(item, BaseException):
                    raise item
                tensors, ready = item
                if ready is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(ready)
                    for t in tensors:
                        t.record_stream(current)
                yield tensors
        finally:
            stop.set()
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def train(self) -> None:
        experiment_name = self.cfg.get("experiment_name")
        if experiment_name:
            self.tracker.set_experiment(experiment_name)
        with self.tracker.start_run(run_name=self.cfg.get("run_name")):
            self.tracker.log_params(flatten_dict(self.cfg))
            val_loss = float("inf")
            if self.train_loader is not None:
                # resume continues the shuffle/mask RNG stream
                self.train_loader.epoch = self.start_epoch
            if self.start_epoch >= self.max_epochs or self.global_step >= self.max_steps:
                logging.info("Nothing to train: resumed at epoch %d / step %d with "
                             "max_epochs=%d max_steps=%d", self.start_epoch,
                             self.global_step, self.max_epochs, self.max_steps)
            for epoch in range(self.start_epoch + 1, self.max_epochs + 1):
                if self.global_step >= self.max_steps:
                    break
                logging.info("Epoch %d/%d starting...", epoch, self.max_epochs)
                train_loss = self._train_one_epoch(epoch)
                self.tracker.log_metric("train/loss", train_loss, step=self.global_step)
                logging.info("Epoch %d completed | train_loss=%.4f | global_step=%d",
                             epoch, train_loss, self.global_step)
                if self.run_validation and self.val_loader is not None:
                    val_loss = self._evaluate_rec_loss(self.val_loader)
                    self.tracker.log_metric("val/loss", val_loss, step=self.global_step)
                    logging.info("Validation done | val_loss=%.4f", val_loss)
                # fold this epoch's validation into the watermark BEFORE saving
                # latest.ckpt, so a resume cannot overwrite best.ckpt with a
                # worse epoch
                is_best = val_loss < self.best_val
                if is_best:
                    self.best_val = val_loss
                latest = self.save_dir / "latest.ckpt"
                self._save(latest, epoch)
                self.tracker.log_artifact(str(latest))
                if is_best:
                    best = self.save_dir / "best.ckpt"
                    self._save(best, epoch)
                    self.tracker.log_artifact(str(best))
                    logging.info("New best model saved at %s (val_loss=%.4f)",
                                 best, self.best_val)
                if self.global_step >= self.max_steps:
                    logging.info("Reached max steps (%d). Stopping.", self.max_steps)
                    break

    def _train_one_epoch(self, epoch: int) -> float:
        zero = lambda: torch.zeros((), device=self.device)  # noqa: E731
        running = {"loss": zero(), "rec": zero(), "adv": zero(), "dis": zero()}
        steps = 0
        t0 = time.perf_counter()  # train/steps_per_sec: steps of this epoch / time since
        for frames, masked, masks in self._device_prefetch(self.train_loader):
            if self.global_step >= self.max_steps:
                break  # before the step: a resume at the budget trains nothing
            if self._idw_hoist_pending:
                self._maybe_hoist_idw(masks)
            self._maybe_start_profile()
            metrics = self.train_step(frames, masked, masks)
            steps += 1
            self.global_step += 1
            self._maybe_stop_profile()
            if steps == 1:
                logging.info("Batch shapes | frames=%s", tuple(frames.shape))
            if self.global_step % self.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}  # syncs the device
                now = time.perf_counter()
                self.log_times.append((self.global_step, now))
                sps = steps / max(now - t0, 1e-6)
                self.tracker.log_metric("train/step_loss", m["loss"], step=self.global_step)
                for key in ("rec_loss", "adv_loss", "dis_loss", "pool", "reg"):
                    if key in m:
                        self.tracker.log_metric(f"train/{key}", m[key],
                                                step=self.global_step)
                self.tracker.log_metric("train/steps_per_sec", sps, step=self.global_step)
                logging.info("Epoch %d | step %d/%d | loss=%.4f | %.3f steps/s",
                             epoch, self.global_step, self.max_steps, m["loss"], sps)
            running["loss"] += metrics["loss"]
            running["rec"] += metrics["rec_loss"]
            running["adv"] += metrics["adv_loss"]
            if "dis_loss" in metrics:
                running["dis"] += metrics["dis_loss"]
            if self.global_step >= self.max_steps:
                break
        if self._profiler is not None:
            self._stop_profile()
        denom = max(1, steps)
        running = {k: float(v) for k, v in running.items()}
        self.last_rec_loss = running["rec"] / denom
        self.last_adv_loss = running["adv"] / denom
        self.last_dis_loss = running["dis"] / denom
        return running["loss"] / denom

    def _evaluate_rec_loss(self, loader) -> float:
        total, batches = 0.0, 0
        for batch in loader:
            frames, masked, masks = self._put_batch(batch)
            total += float(self.eval_step(frames, masked, masks))
            batches += 1
        return total / max(1, batches)

    # -- profiling -------------------------------------------------------
    def _maybe_start_profile(self) -> None:
        if (not self.profile_dir or self._profiler is not None or self._profile_done
                or self.global_step < self.profile_start):
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._sync()
        self._profiler = profile(activities=activities)
        self._profiler.start()
        self._profile_t0 = time.perf_counter()
        self._profile_stop_at = self.global_step + self.profile_steps

    def _maybe_stop_profile(self) -> None:
        if self._profiler is not None and self.global_step >= self._profile_stop_at:
            self._stop_profile()

    def _stop_profile(self) -> None:
        """End the profiled window; write the chrome trace, the per-kernel
        table and a summary (wall time, device busy time as the union of the
        device-side intervals, idle share) to ``profile_dir``."""
        self._sync()
        wall_us = (time.perf_counter() - self._profile_t0) * 1e6
        prof, self._profiler = self._profiler, None
        prof.stop()
        self._profile_done = True
        out = Path(self.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / "trace.json"))
        table = prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=40)
        (out / "key_averages.txt").write_text(table)
        busy = device_busy_us(prof)
        # device time by kernel name, so a reader can sum what a set of
        # kernels costs (the table above is cut to 40 rows)
        kernel_ms = {r.key: r.self_device_time_total / 1e3
                     for r in prof.key_averages()
                     if r.device_type == torch.autograd.DeviceType.CUDA}
        summary = {"steps": self.profile_steps, "wall_ms": wall_us / 1e3,
                   "device_busy_ms": busy / 1e3,
                   "device_idle_share": 1.0 - busy / wall_us if wall_us else None,
                   "kernel_ms": kernel_ms,
                   "device": (torch.cuda.get_device_name(self.device)
                              if self.device.type == "cuda" else "cpu")}
        (out / "summary.json").write_text(json.dumps(summary, indent=2))
        logging.info("Profiler window written to %s: %s", out,
                     {k: v for k, v in summary.items() if k != "kernel_ms"})

    # -- checkpoints -------------------------------------------------------
    @staticmethod
    def _split_state(module: torch.nn.Module) -> Dict[str, Any]:
        """``params`` (what the optimizer updates) and ``extra`` (buffers: the
        BatchNorm running statistics, the spectral-norm vectors), the JAX
        payload's two entries."""
        names = {n for n, _ in module.named_parameters()}
        state = module.state_dict()
        return {"params": {k: v for k, v in state.items() if k in names},
                "extra": {k: v for k, v in state.items() if k not in names}}

    def _save(self, path: Path, epoch: int) -> None:
        payload = {
            "epoch": epoch,
            "global_step": self.global_step,
            "best_val": self.best_val,
            "generator": self._split_state(self.generator),
            "optimizer_g": self.opt_g.state_dict(),
        }
        if self.discriminator is not None:
            payload["discriminator"] = self._split_state(self.discriminator)
            payload["optimizer_d"] = self.opt_d.state_dict()
        save_checkpoint(path, payload)

    def load(self, path: str | Path) -> None:
        """Resume the training state (weights, optimizers, counters) from a
        checkpoint this trainer wrote."""
        raw = load_checkpoint_raw(path)
        if not isinstance(raw, dict) or "optimizer_g" not in raw:
            raise ValueError(f"{path} holds no training state (optimizer_g): "
                             f"resume needs a checkpoint written by the trainer")
        gen = raw["generator"]
        self.generator.load_state_dict({**gen["params"], **gen["extra"]})
        self.opt_g.load_state_dict(raw["optimizer_g"])
        if self.discriminator is not None and "discriminator" in raw:
            disc = raw["discriminator"]
            self.discriminator.load_state_dict({**disc["params"], **disc["extra"]})
            self.opt_d.load_state_dict(raw["optimizer_d"])
        self.global_step = int(raw.get("global_step", 0))
        self.start_epoch = int(raw.get("epoch", 0))
        if "best_val" in raw:
            self.best_val = float(raw["best_val"])
        logging.info("Resumed from %s | global_step=%d epoch=%d best_val=%s",
                     path, self.global_step, self.start_epoch,
                     f"{self.best_val:.4f}" if self.best_val != float("inf") else "inf")
