"""Fake rainfall dataset generator (smoke tests, benchmarks, examples).

The reference's documented smoke path is "Inference with Fake Data"
(reference README.md:83-91) but the repo ships neither the generator nor the
eval config — this module closes that gap. Generates synthetic advecting
rain cells as uint8 (T, H, W) frames and writes every store layout the
framework consumes:

* per-event ``.h5`` files with a ``frames`` dataset (scripts/tozarr.py input)
* a flat test zarr with ``event_%02d`` float-ready uint8 arrays
* a ``train.zarr`` with ``events/<ts>/frames`` uint8 chunks + sliding-window
  index (scripts/preprocess.py:130-233 layout, chunks (20, 128, 128))
* a gauge-mask txt with ``n_gauges`` observation points (stis mask file)

The port's own copy of ``p2igan_tpu/data/fake.py`` (numpy only).
"""

from __future__ import annotations

from pathlib import Path
from typing import List

import numpy as np

from . import zarrlite


def synthesize_event(rng: np.random.Generator, T: int = 16, H: int = 128,
                     W: int = 128, n_cells: int = 4) -> np.ndarray:
    """Advecting anisotropic gaussian rain cells, uint8 (T, H, W)."""
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    frames = np.zeros((T, H, W), np.float32)
    for _ in range(n_cells):
        cy, cx = rng.uniform(0, H), rng.uniform(0, W)
        vy, vx = rng.normal(0, 1.5, 2)
        sy = rng.uniform(6, 18)
        sx = rng.uniform(6, 18)
        amp = rng.uniform(80, 255)
        growth = rng.uniform(-0.03, 0.05)
        for t in range(T):
            a = amp * np.exp(growth * t)
            g = a * np.exp(-(((yy - cy - vy * t) ** 2) / (2 * sy ** 2)
                            + ((xx - cx - vx * t) ** 2) / (2 * sx ** 2)))
            frames[t] += g.astype(np.float32)
    frames += rng.normal(0, 2.0, frames.shape).astype(np.float32)
    return np.clip(frames, 0, 255).astype(np.uint8)


def write_h5_events(out_dir: str | Path, n_events: int = 2, T: int = 16,
                    H: int = 128, W: int = 128, seed: int = 0) -> List[Path]:
    import h5py

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    # files named "<id>.h5" with ids 1..N, matching the reference's storm-event
    # layout so tozarr's event_%02d keys line up with inference output keys
    for i in range(n_events):
        p = out_dir / f"{i + 1}.h5"
        with h5py.File(p, "w") as f:
            f.create_dataset("frames", data=synthesize_event(rng, T, H, W))
        paths.append(p)
    return paths


def write_test_zarr(out_path: str | Path, n_events: int = 2, T: int = 16,
                    H: int = 128, W: int = 128, seed: int = 0) -> Path:
    """Flat test store: ``event_%02d`` float32 arrays (scripts/tozarr.py layout)."""
    out_path = Path(out_path)
    rng = np.random.default_rng(seed)
    g = zarrlite.open_group(out_path, mode="w")
    g.attrs.update({"description": "fake nimrod-style test events"})
    for i in range(n_events):
        frames = synthesize_event(rng, T, H, W).astype(np.float32)
        arr = g.create_dataset(f"event_{i + 1:02d}", shape=frames.shape,
                               chunks=frames.shape, dtype="float32", data=frames)
        arr.attrs.update({"start": f"2021-01-{min(i + 1, 28):02d} 00:00",
                          "duration_frames": T})
    return out_path


def write_train_zarr(out_path: str | Path, n_events: int = 3, T: int = 40,
                     H: int = 128, W: int = 128, window: int = 20,
                     stride: int = 1, seed: int = 0) -> Path:
    """Training store with per-event uint8 chunks + sliding-window index."""
    out_path = Path(out_path)
    rng = np.random.default_rng(seed)
    g = zarrlite.open_group(out_path, mode="w")
    g.attrs.update({"suggested_window": window})
    events = g.create_group("events")
    windows = []
    for i in range(n_events):
        ts = f"{202001010000 + i * 10000}"
        ev = events.create_group(ts)
        frames = synthesize_event(rng, T, H, W, n_cells=5)
        ev.create_dataset("frames", shape=frames.shape,
                          chunks=(min(window, T), H, W), dtype="uint8",
                          data=frames)
        for s in range(0, T - window + 1, stride):
            windows.append([i, s, window])
    if not windows:
        raise ValueError(
            f"write_train_zarr: window {window} > event length {T} yields "
            "ZERO training windows; pass a longer T or shorter window")
    idx = g.create_group("index")
    idx.create_dataset("windows", shape=(len(windows), 3), dtype="int64",
                       data=np.asarray(windows, np.int64))
    return out_path


def write_gauge_mask(out_path: str | Path, H: int = 128, W: int = 128,
                     n_gauges: int = 79, seed: int = 7) -> Path:
    """0/1 txt gauge mask with exactly ``n_gauges`` observed pixels."""
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    flat = rng.choice(H * W, size=n_gauges, replace=False)
    mask = np.zeros((H * W,), np.int64)
    mask[flat] = 1
    np.savetxt(out_path, mask.reshape(H, W), fmt="%d")
    return out_path


def make_fake_benchmark_tree(root: str | Path, H: int = 128, W: int = 128,
                             T: int = 16, seed: int = 0, h5_events: bool = True) -> dict:
    """Full fake data tree + paths dict for configs. ``h5_events=False``
    leaves out the per-event ``.h5`` files (they need h5py); every other
    store is the same."""
    root = Path(root)
    paths = {
        "test_zarr": write_test_zarr(root / "nimrod_test.zarr", n_events=2,
                                     T=T, H=H, W=W, seed=seed + 1),
        # window length matches the shipped configs' sample_length; events
        # are at least 2 windows long so the index is never empty
        "train_zarr": write_train_zarr(root / "nimrod_train.zarr", seed=seed + 2,
                                       H=H, W=W, window=T, T=max(40, 2 * T)),
        "gauge_mask": write_gauge_mask(root / "masks" / "gauge_mask_128_train.txt",
                                       H=H, W=W, seed=seed + 3),
        "gauge_mask_test": write_gauge_mask(root / "masks" / "gauge_mask_128_test.txt",
                                            H=H, W=W, seed=seed + 4),
    }
    if h5_events:
        paths["test_events"] = write_h5_events(root / "test_events", n_events=2, T=T,
                                               H=H, W=W, seed=seed)
    return paths
