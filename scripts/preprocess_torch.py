"""H5 -> Zarr train-set converter of the port (the flags of ``scripts/preprocess.py``).

    python scripts/preprocess_torch.py --h5-dir <dir of <ts>.h5> --output train.zarr \
        [--window 20] [--stride 1] [--spatial-chunk 128]

Packs timestamp-sorted event h5 files into ``events/<ts>/frames`` uint8
chunks (window, spatial_chunk, spatial_chunk), zstd level 3, with a
sliding-window index ``index/windows`` (N, 3) = [event_id, start_t, length]
and a ``suggested_window`` attr: the store the JAX script builds, through the
port's own ``data/zarrlite.py``. h5py is imported only where an ``.h5`` file
is opened: without it the script exits non-zero with a message that names
h5py.
"""

from __future__ import annotations

# Allow running as `python scripts/<name>.py` without installing the package.
import sys as _sys
from pathlib import Path as _Path

_repo = str(_Path(__file__).resolve().parents[1])
if _repo not in _sys.path:
    _sys.path.insert(0, _repo)

import argparse
import os
import re
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from p2igan_tpu_torch.data import zarrlite


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Build sliding-window training zarr")
    p.add_argument("--h5-dir", type=Path, required=True)
    p.add_argument("--output", type=Path, required=True)
    p.add_argument("--window", type=int, default=20)
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--spatial-chunk", type=int, default=128)
    return p


def read_h5_frames(path: Path) -> np.ndarray:
    """The ``frames`` dataset of an event file."""
    try:
        import h5py
    except ImportError as e:
        raise SystemExit(f"reading {path} needs h5py, which is not installed ({e}); "
                         "convert the .h5 events where h5py is") from e
    with h5py.File(path, "r") as f:
        return f["frames"][:]


def extract_ts(f: str) -> int:
    # search the STEM: a digit-free name must error, not pick up the '5' of
    # the '.h5' extension
    m = re.search(r"\d+", os.path.splitext(f)[0])
    if m is None:
        raise ValueError(f"cannot extract a timestamp from {f!r}: "
                         "event h5 filenames must contain digits")
    return int(m.group())


def main(argv: Optional[Sequence[str]] = None) -> Path:
    args = build_parser().parse_args(argv)
    # event ids in LEXICOGRAPHIC group-key order: the order the window reader
    # resolves event_id in (sorted(events.keys())); a numeric sort would
    # mis-pair windows whenever timestamps have different digit widths
    h5_files = sorted([f for f in os.listdir(args.h5_dir) if f.endswith(".h5")],
                      key=lambda f: str(extract_ts(f)))
    root = zarrlite.open_group(args.output, mode="w")
    events_grp = root.create_group("events")
    index_grp = root.create_group("index")
    root.attrs.update({
        "dataset_name": "train",
        "description": "Radar events, event-based storage",
        "frame_unit": "mm/h (uint8 encoded)",
        "suggested_window": args.window,
    })
    window_index = []
    for event_id, fname in enumerate(h5_files):
        ts = extract_ts(fname)
        frames = read_h5_frames(args.h5_dir / fname)
        if frames.ndim == 4 and frames.shape[-1] == 1:
            frames = frames[..., 0]
        T, H, W = frames.shape
        if frames.dtype != np.uint8:
            # clip, don't wrap: astype(uint8) would alias 300 -> 44
            frames = np.clip(frames, 0, 255)
        evt = events_grp.create_group(str(ts))
        sc = min(args.spatial_chunk, H, W)
        arr = evt.create_dataset(
            "frames", shape=frames.shape, chunks=(min(args.window, T), sc, sc),
            dtype="uint8", compressor={"id": "zstd", "level": 3},
            data=frames.astype(np.uint8),
        )
        arr.attrs.update({"event_id": event_id, "timestamp": ts,
                          "num_frames": T, "source_file": fname})
        starts = range(0, T - args.window + 1, args.stride)
        for start in starts:
            window_index.append([event_id, start, args.window])
        print(f"packed {fname}: {T} frames -> {len(starts)} windows")
    if not window_index:
        raise SystemExit(
            f"no training windows generated: every event in {args.h5_dir} "
            f"is shorter than --window {args.window}")
    idx = index_grp.create_dataset(
        "windows", shape=(len(window_index), 3), chunks=(1024, 3), dtype="int32",
        compressor={"id": "zstd", "level": 3}, data=np.asarray(window_index, np.int32),
    )
    idx.attrs.update({"columns": ["event_id", "start_t", "length"],
                      "description": "Sliding window index for training"})
    print(f"Zarr training dataset created at: {args.output}")
    print(f"Total training samples (windows): {len(window_index)}")
    return args.output


if __name__ == "__main__":
    main()
