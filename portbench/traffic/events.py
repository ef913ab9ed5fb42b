"""The benchmark's traffic: storm events, the gauge mask and the stores a run
serves or trains on, all made from the run's seed.

A frozen copy of the port's fake-data generator (``data/fake.py``:
``synthesize_event``, ``write_train_zarr``, ``write_test_zarr``,
``write_gauge_mask``), changed in two ways only: every event of a store is
drawn in one batch on the run's device from a ``torch.Generator`` (the
host loop drew them cell by cell and frame by frame), and the frames stay in
memory beside the stores, so that the plain reference reads the very
numbers the stores hold without reading the program's files back.

The distribution is the original's: ``n_cells`` advecting anisotropic
gaussian rain cells an event (centre uniform over the frame, velocity
N(0, 1.5) px a frame, widths U(6, 18) px, amplitude U(80, 255), growth
U(-0.03, 0.05) a frame), N(0, 2) noise, clipped to uint8. The stores are
written in the layouts the port reads (``scripts/preprocess_torch.py``'s
sliding-window ``train.zarr``, ``scripts/tozarr_torch.py``'s flat test
store), through the port's own zarr writer, as a user's preprocessing
writes them.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch


def synthesize_events(gen: torch.Generator, n_events: int, T: int, H: int, W: int,
                      n_cells: int, device, chunk: int = 16) -> np.ndarray:
    """(n_events, T, H, W) uint8 storm events, ``chunk`` events at a time."""
    out = np.empty((n_events, T, H, W), np.uint8)
    yy = torch.arange(H, device=device, dtype=torch.float32)[None, None, :]
    xx = torch.arange(W, device=device, dtype=torch.float32)[None, None, :]
    tt = torch.arange(T, device=device, dtype=torch.float32)[None, :, None]

    def uniform(n, lo, hi):
        return lo + (hi - lo) * torch.rand((n, n_cells), generator=gen, device=device)

    for lo in range(0, n_events, chunk):
        n = min(chunk, n_events - lo)
        cy, cx = uniform(n, 0, H), uniform(n, 0, W)
        vy = 1.5 * torch.randn((n, n_cells), generator=gen, device=device)
        vx = 1.5 * torch.randn((n, n_cells), generator=gen, device=device)
        sy, sx = uniform(n, 6, 18), uniform(n, 6, 18)
        amp, growth = uniform(n, 80, 255), uniform(n, -0.03, 0.05)
        frames = 2.0 * torch.randn((n, T, H, W), generator=gen, device=device)
        for c in range(n_cells):
            col = lambda v: v[:, c, None, None]  # noqa: E731  (n, 1, 1)
            a = col(amp) * torch.exp(col(growth) * tt)                       # (n, T, 1)
            gy = torch.exp(-((yy - col(cy) - col(vy) * tt) ** 2) / (2 * col(sy) ** 2))
            gx = torch.exp(-((xx - col(cx) - col(vx) * tt) ** 2) / (2 * col(sx) ** 2))
            frames += (a * gy)[..., :, None] * gx[..., None, :]              # (n, T, H, W)
        out[lo:lo + n] = frames.clamp_(0, 255).to(torch.uint8).cpu().numpy()
    return out


def gauge_mask(gen: torch.Generator, H: int, W: int, n_gauges: int) -> np.ndarray:
    """(H, W) int64 0/1 mask with exactly ``n_gauges`` observed pixels."""
    flat = torch.randperm(H * W, generator=gen, device=gen.device)[:n_gauges].cpu().numpy()
    mask = np.zeros((H * W,), np.int64)
    mask[flat] = 1
    return mask.reshape(H, W)


def write_gauge_mask(path: Path, mask: np.ndarray) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savetxt(path, mask, fmt="%d")
    return path


def write_train_store(path: Path, frames: np.ndarray, window: int, stride: int = 1) -> Path:
    """``train.zarr``: ``events/<ts>/frames`` uint8 (T, H, W) in chunks of
    ``window`` frames, and ``index/windows`` (N, 3) = [event, start, length]."""
    from p2igan_tpu_torch.data import zarrlite

    E, T, H, W = frames.shape
    g = zarrlite.open_group(path, mode="w")
    g.attrs.update({"suggested_window": window})
    events = g.create_group("events")
    windows = []
    for i in range(E):
        ev = events.create_group(f"{202001010000 + i * 10000}")
        ev.create_dataset("frames", shape=frames[i].shape, chunks=(min(window, T), H, W),
                          dtype="uint8", data=frames[i])
        windows.extend([i, s, window] for s in range(0, T - window + 1, stride))
    g.create_group("index").create_dataset(
        "windows", shape=(len(windows), 3), dtype="int64",
        data=np.asarray(windows, np.int64))
    return path


def write_test_store(path: Path, frames: np.ndarray) -> Path:
    """Flat test store: ``event_%02d`` float32 arrays of 0-255 values, one
    chunk an event."""
    from p2igan_tpu_torch.data import zarrlite

    g = zarrlite.open_group(path, mode="w")
    for i, ev in enumerate(frames):
        data = ev.astype(np.float32)
        g.create_dataset(f"event_{i + 1:02d}", shape=data.shape, chunks=data.shape,
                         dtype="float32", data=data)
    return path


def make_traffic(traffic: Dict, seed: int, root: Path, device) -> Dict:
    """The run's inputs from its seed: ``frames`` (E, T, H, W) uint8, the
    gauge ``mask`` (H, W), and the files written under ``root``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    H, W = traffic["h"], traffic["w"]
    mask = gauge_mask(gen, H, W, traffic["n_gauges"])
    frames = synthesize_events(gen, traffic["n_events"], traffic["event_frames"], H, W,
                               traffic["n_cells"], device)
    out = {"frames": frames, "mask": mask,
           "mask_file": write_gauge_mask(root / "gauge_mask.txt", mask)}
    if traffic["store"] == "train":
        out["store"] = write_train_store(root / "train.zarr", frames, traffic["window"],
                                         traffic.get("stride", 1))
    else:
        out["store"] = write_test_store(root / "test_events.zarr", frames)
        warm = traffic.get("warmup_events", 0)
        if warm:
            out["warmup_store"] = write_test_store(root / "warmup_events.zarr", frames[:warm])
    return out
