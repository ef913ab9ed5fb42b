"""Training orchestration of the port (PyTorch, one device or several).

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
* ``max_steps`` / ``max_epochs``, validation (with ``train.eval_metrics``
  the metric suite accumulates on the device and logs ``val/<key>``),
  ``latest.ckpt`` every epoch and ``best.ckpt`` on a better validation loss,
  ``load`` for resume, steps/s logging, and an optional ``torch.profiler``
  window (``train.profile_dir``);
* example images every epoch (``_log_examples``: GT | prediction grids under
  ``save_dir/artifacts``, the ``viz`` config's colour scale), drawn after the
  epoch's training steps, outside the steps/s window. Unlike the JAX trainer's,
  they leave the loader's epoch counter as they found it, so a resumed run
  trains on the same batches as an uninterrupted one.

Data parallelism (``parallel/mesh.py``, one process a device under
``torchrun``; without its environment the run is the single-process one, bit
for bit): the batch is global and each rank's loaders read its rows
(``drop_last`` on the training loader, so every rank takes as many steps);
parameters, buffers and optimizer state are broadcast from rank 0 after the
build and after ``load``; the train step averages the gradients; the logged
step metrics are the global means, reduced at log points only, and
``train/steps_per_sec`` counts global steps; the validation loss sum and the
metric suite's state are reduced once a pass; rank 0 alone logs, profiles,
saves (the others wait for the save) and draws the examples. Every rank
takes the same branches, from reduced values, so none waits forever. The
stis gauge selection is hoisted on each rank from its own rows (the same
mask on every rank).
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
from ..inference.driver import set_precision_policy
from ..models import build_discriminator, build_generator
from ..ops import cuda_lib
from ..ops.decode_mask import decode_normalize_mask
from ..parallel.mesh import create_mesh
from ..utils.tracking import NullTracker, get_tracker
from ..models.convert import split_state, trainer_payload_from_jax
from .checkpoint import is_jax_checkpoint, load_checkpoint_raw, save_checkpoint
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
        self.mesh = create_mesh(device)
        self.device = self.mesh.device
        set_precision_policy()
        self.seed = cfg.get("seed", 42)
        train_cfg = cfg.get("train", {})
        self.eval_metrics = bool(train_cfg.get("eval_metrics", False))
        viz_cfg = cfg.get("viz", {})
        self.viz_scale = str(viz_cfg.get("scale", "gt_pred")).lower()
        self.viz_vmin = viz_cfg.get("vmin")
        self.viz_vmax = viz_cfg.get("vmax")

        logging.info("Initializing data module...")
        self.data_module = P2IDataModule(cfg)
        self.train_loader = self.data_module.train_dataloader()
        self.val_loader = self.data_module.val_dataloader()
        for loader in (self.train_loader, self.val_loader):
            if loader is not None:
                loader.rank, loader.world = self.mesh.rank, self.mesh.world
        if self.train_loader is not None and self.mesh.world > 1:
            self.train_loader.drop_last = True
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
        self._broadcast_state()
        if self.mesh.distributed and self.device.type == "cuda":
            self.mesh.main_first(cuda_lib.library)

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
        self.tracker = get_tracker() if self.mesh.is_main else NullTracker()
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
    def _broadcast_state(self) -> None:
        """Rank 0's models and optimizer states on every rank."""
        for module, opt in ((self.generator, self.opt_g),
                            (self.discriminator, self.opt_d)):
            if module is not None:
                self.mesh.broadcast_module(module)
                self.mesh.broadcast_optimizer(opt)

    def _build_steps(self, idw_prepared=None) -> None:
        self.train_step = build_train_step(
            self.generator, self.discriminator, self.opt_g, self.opt_d,
            idw_prepared=idw_prepared, mesh=self.mesh, **self._step_kwargs)
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
                self._log_examples(self.train_loader, prefix="train", epoch=epoch,
                                   max_batches=1)
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
                self.mesh.barrier()  # the others resume after rank 0's save
                self._log_examples(self.val_loader, prefix="val", epoch=epoch)
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
                # the global means; float() syncs the device
                m = {k: float(v) for k, v in self.mesh.mean_values(metrics).items()}
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
        running = {k: float(v) for k, v in self.mesh.mean_values(running).items()}
        self.last_rec_loss = running["rec"] / denom
        self.last_adv_loss = running["adv"] / denom
        self.last_dis_loss = running["dis"] / denom
        return running["loss"] / denom

    def _evaluate_rec_loss(self, loader) -> float:
        """Mean validation loss; with ``train.eval_metrics`` the metric suite
        also accumulates every batch's prediction on the device and each of
        its keys is logged as ``val/<key>``. Over several ranks each takes its
        rows of a batch (the batch mean is the mean of the ranks' means) and
        the loss sum and the suite's state are reduced once; a batch every
        rank holds whole (its size does not divide) enters the suite on rank
        0 only."""
        if loader is None:
            return 0.0
        suite = None
        if self.eval_metrics:
            from ..metrics import MetricConfig, RainfallMetricSuite

            suite = RainfallMetricSuite(MetricConfig(), device=self.device)
        whole = [size % self.mesh.world != 0 for size in loader.global_sizes()]
        total, batches = 0.0, 0
        for batch, replicated in zip(loader, whole):
            frames, masked, masks = self._put_batch(batch)
            total += float(self.eval_step(frames, masked, masks))
            if suite is not None and (self.mesh.is_main or not replicated):
                suite.update(self.predict_fn(masked, masks), frames)
            batches += 1
        if self.mesh.distributed:
            total = float(self.mesh.mean_(torch.tensor(total, dtype=torch.float64,
                                                       device=self.device)))
        if suite is not None:
            suite.state = suite.all_reduce_state(suite.state, self.mesh)
            for key, value in suite.compute().items():
                self.tracker.log_metric(f"val/{key}", value, step=self.global_step)
        return total / max(1, batches)

    def _log_examples(self, loader, prefix: str, epoch: int, max_batches: int = 5,
                      samples_per_batch: int = 1) -> None:
        """Colorized GT | prediction grids with their stats caption
        (reference train.py:384-466), written as
        ``save_dir/artifacts/{prefix}_epoch{epoch}_batch{b}_ex{idx}.png`` and
        logged as artifacts. The loader's epoch counter is restored, so the
        examples do not move the training data's shuffle and mask stream.
        Rank 0 alone draws them, from its rows: a batch's first sample."""
        if loader is None or not self.mesh.is_main:
            return
        from ..metrics.plots import example_image

        save_dir = self.save_dir / "artifacts"
        save_dir.mkdir(parents=True, exist_ok=True)
        epoch_before = loader.epoch
        batches = iter(loader)
        try:
            for b_idx, batch in zip(range(max_batches), batches):
                frames, masked, masks = self._put_batch(batch)
                preds = self.predict_fn(masked, masks).cpu().numpy()
                frames = frames.cpu().numpy()
                for idx in range(min(samples_per_batch, frames.shape[0])):
                    gt = frames[idx, ..., 0]  # (T, H, W)
                    pd = np.clip(preds[idx, ..., 0], 0, 1)
                    image = example_image(gt, pd, scale=self.viz_scale,
                                          vmin=self.viz_vmin, vmax=self.viz_vmax)
                    out_path = save_dir / f"{prefix}_epoch{epoch}_batch{b_idx}_ex{idx}.png"
                    image.save(out_path)
                    self.tracker.log_artifact(str(out_path))
        finally:
            batches.close()  # the loader's generator: its worker pool ends
            loader.epoch = epoch_before

    # -- profiling -------------------------------------------------------
    def _maybe_start_profile(self) -> None:
        if (not self.profile_dir or self._profiler is not None or self._profile_done
                or self.global_step < self.profile_start or not self.mesh.is_main):
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
        return split_state(module, module.state_dict())

    def _save(self, path: Path, epoch: int) -> None:
        """Rank 0 writes the checkpoint (every rank holds the same state)."""
        if not self.mesh.is_main:
            return
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
        checkpoint this trainer wrote, or one the JAX trainer wrote under the
        same config (converted by ``trainer_payload_from_jax``, then loaded
        the same way); every rank reads it, then takes rank 0's state."""
        raw = load_checkpoint_raw(path)
        if not isinstance(raw, dict) or "optimizer_g" not in raw:
            raise ValueError(f"{path} holds no training state (optimizer_g): "
                             f"resume needs a checkpoint written by the trainer")
        if is_jax_checkpoint(path):
            raw = trainer_payload_from_jax(raw, self.generator, self.opt_g,
                                           self.discriminator, self.opt_d)
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
        self._broadcast_state()
        logging.info("Resumed from %s | global_step=%d epoch=%d best_val=%s",
                     path, self.global_step, self.start_epoch,
                     f"{self.best_val:.4f}" if self.best_val != float("inf") else "inf")
