"""Sliding-window ensemble inference writing per-event Zarr stores (PyTorch).

Counterpart of ``p2igan_tpu/inference/driver.py`` (reference
``scripts/infer.py:117-275``). Every window of an event (or of a batch of
events, flattened into one stream) is gathered from the device-resident frames
by a clamped index table (= repeat-last-frame padding), the generator runs over
chunks of ``window_batch`` windows in a Python loop, and each window's
predictions are added into its frames of a device accumulator, window by
window in stream order: a fixed order, so the served stores repeat bit for
bit (``index_add_`` of a chunk, where up to four windows meet in one frame,
takes no fixed order on CUDA).

Semantics preserved: stride 16 / overlap 12 (step 4), last window padded by
repeating the final frame, overlap averaging with a 1e-5 weight floor,
x output_scale then clip >= 0, ``event_%02d`` naming, pass-k running mean
``cur + (new - cur)/(k+1)``, provenance attrs, samples/sec logging.

Several ranks (``parallel/mesh.py``, one process a device under ``torchrun``),
as the JAX package's mesh serving: with ``batch_events`` > 1 the window chunks
of an event batch are dealt to the ranks, chunk c (of ``window_batch``
windows) to rank c mod W, so every chunk is one the single process computes;
rank 0 takes each chunk's predictions by a broadcast from its owner, in
stream order, accumulates them as the single process does and writes the
store, which is therefore the single process's bit for bit. With
``batch_events`` 1 the JAX package serves on one device: rank 0 serves alone
and the others return at once, with no collective (the launch ends when rank
0 does).

Precision: float32 throughout; TF32 is switched off for cuDNN convolutions
and matmuls (PyTorch enables it for convolutions by default), as the JAX
reference computes in float32, and cuDNN takes deterministic algorithms
only, so that serving and training repeat bit for bit as the reference does.
"""

from __future__ import annotations

import logging
import shutil
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..data import zarrlite
from ..data.datamodule import P2IDataModule, pad_repeat_last
from ..data.stores import store_compressor
from ..models import build_generator_for_inference
from ..ops import cuda_lib
from ..ops.idw import round_up
from ..ops.layers import InputBlock
from ..parallel.mesh import create_mesh
from ..training.checkpoint import load_generator_state, resolve_checkpoint


def set_precision_policy() -> None:
    """float32 everywhere (no TF32 in cuDNN convolutions or cuBLAS matmuls),
    and deterministic cuDNN algorithms (no autotuning among them either)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def _overlap_average(accum: torch.Tensor, count: torch.Tensor, E: int, T: int,
                     scale: float) -> torch.Tensor:
    """Drop each event's sentinel slot T, overlap-average with the 1e-5
    floor, then the reference's x scale and clip >= 0 (infer.py:244-245)."""
    H, W, C = accum.shape[1:]
    comp = accum.reshape(E, T + 1, H, W, C)[:, :T]
    cnt = count.reshape(E, T + 1)[:, :T]
    comp = comp / torch.clamp(cnt, min=1e-5)[..., None, None, None]
    return torch.clamp(comp * scale, min=0.0)


class SlidingWindowReconstructor:
    """Sliding-window reconstruction of events on the generator's device."""

    def __init__(self, generator, stride: int = 16, overlap: int = 12,
                 window_batch: int = 4, output_scale: float = 255.0):
        self.generator = generator
        self.device = next(generator.parameters()).device
        self.stride = max(1, int(stride))
        self.overlap = max(0, int(overlap))
        self.step = max(1, self.stride - self.overlap)
        self.window_batch = max(1, int(window_batch))
        self.output_scale = float(output_scale)

    def _check_gauge_budget(self, masks: np.ndarray) -> None:
        """Fail loudly when any event/frame mask holds more gauges than the
        factored IDW's static slot budget (the selection would drop some):
        the shared-mask generator's hoisted selection and the per-sample
        generator's in-forward one alike. The generic IDW is not guarded, as
        in the JAX package: points beyond its budget are dropped."""
        gen = self.generator
        if not getattr(gen, "idw_factored", False):
            return
        budget = InputBlock.gauge_budget(gen.idw_max_points, gen.length)
        mask_xy = np.asarray(masks)[..., 0]
        n_obs = int((mask_xy > 0).reshape(-1, *mask_xy.shape[-2:])
                    .sum(axis=(1, 2)).max())
        if n_obs > budget:
            raise ValueError(
                f"mask has {n_obs} observed gauges but the factored IDW "
                f"budget allows {budget} (idw_max_points={gen.idw_max_points}, "
                f"length={gen.length}); raise idw_max_points "
                f"(P2IGenerator.from_config sizes it from the config masks)")

    def _supports_prepared_idw(self) -> bool:
        """True when the generator's IDW gauge selection is a constant of the
        event mask (the factored shared-mask path of p2igan, stis) and is
        hoisted out of the window loop. A per-sample (sti) generator and a
        generic one (masks that vary per frame: stin, fi, nowcasting) hoist
        nothing: every window computes its own selection from its own slice
        of its event's mask, so a window batch may mix events. dk, stdk and
        simple have no IDW."""
        gen = self.generator
        return bool(getattr(gen, "idw_factored", False)
                    and getattr(gen, "idw_shared_batch_mask", False))

    @staticmethod
    def _masks_shared(masks: np.ndarray) -> bool:
        masks = np.asarray(masks)
        return all(np.array_equal(masks[0, 0], masks[e, 0])
                   for e in range(1, masks.shape[0]))

    def _window_tables(self, T: int, E: int, pad_multiple: int):
        """Flat (win_idx, tgt) tables for E equal-length events, padded to a
        multiple of ``pad_multiple`` windows. Window w of event e reads frames
        ``e*T + clamp(start+dt)`` (clamped gather == repeat-last-frame
        padding) and scatters into slot ``e*(T+1) + t``; out-of-range frames
        and padding windows hit the per-event sentinel slot T, which the
        overlap average drops."""
        stride, step = self.stride, self.step
        starts = np.arange(0, T, step, dtype=np.int32)
        n_win = len(starts)
        n_all = round_up(E * n_win, pad_multiple)
        ev = np.repeat(np.arange(E, dtype=np.int32), n_win)
        st = np.tile(starts, E)
        ev = np.concatenate([ev, np.zeros(n_all - E * n_win, np.int32)])
        st = np.concatenate([st, np.full(n_all - E * n_win, T, np.int32)])
        frame = np.minimum(st[:, None] + np.arange(stride)[None, :], T - 1)
        win_idx = (ev[:, None] * T + frame).astype(np.int32)
        tgt = st[:, None] + np.arange(stride)[None, :]
        tgt = np.where((tgt < T) & (st[:, None] < T), tgt, T)
        tgt = (ev[:, None] * (T + 1) + tgt).astype(np.int32)
        return win_idx, tgt

    @torch.inference_mode()
    def _reconstruct(self, masked: torch.Tensor, masks: torch.Tensor,
                     mesh=None) -> Optional[torch.Tensor]:
        """(E, T, H, W, C) device tensors -> (E, T, H, W, C) reconstruction;
        over the ranks of ``mesh`` (chunk c on rank c mod W) the result is on
        rank 0 and the others return None."""
        E, T, H, W, C = masked.shape
        wb = self.window_batch
        win_idx, tgt = self._window_tables(T, E, wb)
        count = np.zeros((E * (T + 1),), np.float32)
        np.add.at(count, tgt.reshape(-1),
                  (tgt.reshape(-1) % (T + 1) < T).astype(np.float32))
        # a window's frames are one run of its event's slots, its first n
        # targets (none for a padding window; the rest hit the sentinel)
        runs = [(int(t[0]), int((t % (T + 1) < T).sum())) for t in tgt]
        dev = masked.device
        win_idx = torch.from_numpy(win_idx).to(dev).long()
        flat_m = masked.reshape(E * T, H, W, C)
        flat_k = masks.reshape(E * T, H, W, C)
        gen = self.generator
        # one gauge selection for the whole stream: every window shares the mask
        kw = ({"idw_prepared": gen.prepare_idw(masks[0, 0, :, :, 0])}
              if self._supports_prepared_idw() else {})
        accum = torch.zeros((E * (T + 1), H, W, C), dtype=torch.float32, device=dev)

        def add(lo, preds):
            for i, (t0, n) in enumerate(runs[lo:lo + wb]):
                if n:
                    accum[t0:t0 + n] += preds[i, :n]

        chunks = range(0, win_idx.shape[0], wb)
        if mesh is None or mesh.world == 1:
            for lo in chunks:
                idx = win_idx[lo:lo + wb]
                add(lo, gen(flat_m[idx], flat_k[idx], **kw).to(torch.float32))
        else:
            own = {lo: gen(flat_m[win_idx[lo:lo + wb]], flat_k[win_idx[lo:lo + wb]],
                           **kw).to(torch.float32)
                   for c, lo in enumerate(chunks) if c % mesh.world == mesh.rank}
            for c, lo in enumerate(chunks):
                src = c % mesh.world
                preds = own.pop(lo) if src == mesh.rank else torch.empty(
                    (wb, self.stride, H, W, C), dtype=torch.float32, device=dev)
                mesh.broadcast_(preds, src)
                if mesh.is_main:
                    add(lo, preds)
            if not mesh.is_main:
                return None
        return _overlap_average(accum, torch.from_numpy(count).to(dev), E, T,
                                self.output_scale)

    def _to_device(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32)).to(self.device)

    def batch(self, masked: np.ndarray, masks: np.ndarray,
              mesh=None) -> Optional[np.ndarray]:
        """Reconstruct equal-length events (E, T, H, W, C) as one flattened
        window stream. With the hoisted IDW the stream shares ONE gauge
        selection, so events with different masks are then reconstructed one
        by one instead; a per-sample (sti) or generic generator takes them as
        one stream whatever their masks. Over the ranks of ``mesh`` each
        stream's window chunks are dealt to the ranks; rank 0 returns the
        result, the others None."""
        self._check_gauge_budget(masks)
        if self._supports_prepared_idw() and not self._masks_shared(masks):
            outs = [self._reconstruct(self._to_device(masked[e:e + 1]),
                                      self._to_device(masks[e:e + 1]), mesh)
                    for e in range(masked.shape[0])]
            return None if outs[0] is None else torch.cat(outs).cpu().numpy()
        out = self._reconstruct(self._to_device(masked), self._to_device(masks), mesh)
        return None if out is None else out.cpu().numpy()

    def __call__(self, masked: np.ndarray, masks: np.ndarray) -> np.ndarray:
        """masked/masks: (T, H, W, C) -> reconstructed (T, H, W, C) float32."""
        self._check_gauge_budget(masks)
        out = self._reconstruct(self._to_device(masked)[None],
                                self._to_device(masks)[None])
        return out[0].cpu().numpy()


def load_generator(cfg: Dict[str, Any], checkpoint_path: str | Path,
                   device: torch.device, fold_weights: bool = True):
    """The config's generator with the checkpoint's weights (a torch
    checkpoint, or a JAX trainer's: the counterpart of the JAX package's
    ``variables_from_checkpoint``), folded for serving (p2igan: DO-conv
    kernels composed once; dk/stdk: the fused tail switched on, weights
    unchanged; simple: BatchNorm folded into the encoder convolutions, enc0
    and dec2 through the fused ops) unless ``fold_weights`` is off."""
    gen = build_generator_for_inference(cfg, device=device)
    gen.load_state_dict(load_generator_state(checkpoint_path, gen))
    gen.eval()
    return gen.fold_for_inference() if fold_weights else gen


def run_inference(cfg: Dict[str, Any], *, checkpoint: Optional[str] = None,
                  model_dir: Optional[str] = None, data_root: Optional[str] = None,
                  output: Optional[str] = None, passes: int = 1,
                  stride: int = 16, overlap: int = 12,
                  output_scale: float = 255.0, overwrite: bool = False,
                  log_every: int = 50, window_batch: int = 8,
                  batch_events: int = 1, fold_weights: bool = True,
                  config_path: str = "<inline>", device: str = "cuda") -> Path:
    """Full inference driver (reference scripts/infer.py main).

    Under ``torchrun`` every rank calls it; rank 0 writes the store (see the
    module docstring)."""
    mesh = create_mesh(device)
    dev = mesh.device
    set_precision_policy()
    if data_root is not None:
        cfg.setdefault("data", {}).setdefault("test", {})["data_root"] = str(data_root)

    checkpoint_path = resolve_checkpoint(
        model_dir or cfg.get("save_dir", "weights"), checkpoint)
    logging.info("Using checkpoint %s", checkpoint_path)

    test_loader = P2IDataModule(cfg, with_train=False).test_dataloader()
    if test_loader is None:
        raise RuntimeError("Test dataloader is not configured. Ensure data.test exists.")
    if test_loader.shuffle:
        # event_%02d keys and the pass>1 running mean are positional
        logging.warning("data.test.shuffle is ignored during inference; "
                        "events are written in dataset order")
        test_loader.shuffle = False
    dataset = test_loader.dataset
    num_samples = len(dataset)
    if num_samples == 0:
        raise RuntimeError("Test dataset is empty.")

    model_name = cfg.get("model", {}).get("name", "model")
    if output is None:
        output = Path(model_dir or cfg.get("save_dir", "weights")) / f"test{model_name}.zarr"
    output = Path(output)
    batch_events = max(1, int(batch_events))
    # the ranks the window chunks are dealt to (None: this process serves alone)
    deal = mesh if mesh.world > 1 and batch_events > 1 else None
    if deal is None and not mesh.is_main:
        # batch_events 1 serves on one device: rank 0, with no collective, as
        # a rank waiting at one for the whole run would outlast NCCL's timeout
        return output
    if output.exists() and not overwrite:
        raise FileExistsError(f"Output already exists: {output}")
    if deal is not None:
        mesh.barrier()  # every rank has looked before rank 0 replaces it
        if dev.type == "cuda":
            mesh.main_first(cuda_lib.library)
    compressor = store_compressor()
    group = None
    if mesh.is_main:
        if output.exists():
            if output.is_dir():
                shutil.rmtree(output)
            else:
                output.unlink()
        logging.info("Writing predictions to %s", output)
        group = zarrlite.open_group(output, mode="w")
        group.attrs.update({
            "config_path": str(config_path),
            "checkpoint": str(checkpoint_path),
            "model_name": model_name,
            "data_root": cfg.get("data", {}).get("test", {}).get("data_root"),
            "passes": int(passes),
            "output_scale": float(output_scale),
        })
        if hasattr(dataset, "video_files"):
            group.attrs["files"] = [str(p) for p in dataset.video_files]

    generator = load_generator(cfg, checkpoint_path, dev, fold_weights)
    recon = SlidingWindowReconstructor(generator, stride=stride, overlap=overlap,
                                       window_batch=window_batch,
                                       output_scale=output_scale)
    passes = max(1, int(passes))
    log_every = max(1, int(log_every))

    def write_event(pass_idx: int, event_idx: int, comp: np.ndarray) -> None:
        event_name = f"event_{event_idx + 1:02d}"
        if pass_idx == 0:
            ds = group.create_dataset(event_name, shape=comp.shape,
                                      chunks=comp.shape, dtype="float32",
                                      compressor=compressor, overwrite=True)
            ds[:] = comp
        else:
            cur = group[event_name][:]
            group[event_name][:] = cur + (comp - cur) / float(pass_idx + 1)

    for pass_idx in range(passes):
        logging.info("Starting pass %d/%d", pass_idx + 1, passes)
        t0 = time.time()
        done = 0
        pending: list = []

        def flush() -> None:
            # padding shorter events to the longest (repeat-last) leaves their
            # own frames' reconstruction unchanged; each is trimmed back
            nonlocal done
            if not pending:
                return
            tmax = max(m.shape[0] for _, m, _ in pending)
            ms = np.stack([pad_repeat_last(m, tmax) for _, m, _ in pending])
            ks = np.stack([pad_repeat_last(k, tmax) for _, _, k in pending])
            comps = recon.batch(ms, ks, deal)
            for (idx, m, _), comp in zip(pending, () if comps is None else comps):
                write_event(pass_idx, idx, comp[:m.shape[0]])
            done += len(pending)
            pending.clear()

        for batch_idx, (frames, masked, masks) in enumerate(test_loader):
            T = frames.shape[1]
            logging.info("Event %d | frames=%d h=%d w=%d c=%d", batch_idx, T,
                         frames.shape[2], frames.shape[3], frames.shape[4])
            if batch_events == 1:
                write_event(pass_idx, batch_idx, recon(masked[0], masks[0]))
                done += 1
            else:
                pending.append((batch_idx, masked[0], masks[0]))
                if len(pending) >= batch_events:
                    flush()
            if (batch_idx + 1) % log_every == 0:
                logging.info("Pass %d/%d | %d/%d samples | %.2f samples/sec",
                             pass_idx + 1, passes, batch_idx + 1, num_samples,
                             (batch_idx + 1) / max(time.time() - t0, 1e-6))
        flush()
        logging.info("Pass %d/%d | %d/%d samples | %.2f samples/sec",
                     pass_idx + 1, passes, done, num_samples,
                     done / max(time.time() - t0, 1e-6))

    if deal is not None:
        mesh.barrier()  # the store is whole before any rank returns
    logging.info("Inference completed. Output saved to %s", output)
    return output
