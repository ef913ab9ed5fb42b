"""H5 -> Zarr test-set converter of the port (the flags of ``scripts/tozarr.py``).

    python scripts/tozarr_torch.py --h5-dir <dir of <id>.h5> --output test.zarr \
        [--event-table events.json] [--dataset-name Nimrod_2D_val]

Converts per-event ``<id>.h5`` storm files (dataset ``frames``) into a flat
test store of ``event_%02d`` float32 arrays, one chunk each, with the same
dataset and event attrs as the JAX script, through the port's own
``data/zarrlite.py``. h5py is imported only where an ``.h5`` file is opened:
without it the script exits non-zero with a message that names h5py.
"""

from __future__ import annotations

# Allow running as `python scripts/<name>.py` without installing the package.
import sys as _sys
from pathlib import Path as _Path

_repo = str(_Path(__file__).resolve().parents[1])
if _repo not in _sys.path:
    _sys.path.insert(0, _repo)

import argparse
import json
import os
import re
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from p2igan_tpu_torch.data import zarrlite


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Convert per-event h5 files to a test zarr")
    p.add_argument("--h5-dir", type=Path, required=True,
                   help="Directory of <id>.h5 event files (dataset 'frames').")
    p.add_argument("--output", type=Path, required=True, help="Output .zarr path")
    p.add_argument("--event-table", type=Path, default=None,
                   help="Optional JSON list of event metadata dicts (id, start, "
                        "end, duration, max_rg, max_rd, mean_rg, mean_rd).")
    p.add_argument("--dataset-name", type=str, default="Nimrod_2D_val")
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


def extract_eid(f: str) -> int:
    # search the STEM, not the '.h5' suffix; digit-free names error
    m = re.search(r"\d+", os.path.splitext(f)[0])
    if m is None:
        raise ValueError(f"cannot extract an event id from {f!r}")
    return int(m.group())


def main(argv: Optional[Sequence[str]] = None) -> Path:
    args = build_parser().parse_args(argv)
    table = None
    if args.event_table is not None:
        table = {int(e["id"]): e for e in json.loads(args.event_table.read_text())}
    files = sorted([f for f in os.listdir(args.h5_dir) if f.endswith(".h5")], key=extract_eid)
    eids = [extract_eid(f) for f in files]
    if len(set(eids)) != len(eids):
        dupes = sorted({e for e in eids if eids.count(e) > 1})
        raise SystemExit(
            f"duplicate event ids {dupes} extracted from {args.h5_dir}: "
            "each event_NN dataset would silently overwrite its twin")
    root = zarrlite.open_group(args.output, mode="w")
    root.attrs.update({
        "dataset_name": args.dataset_name,
        "description": "Rain field data for storm events",
        "num_events": len(files),
        "time_unit": "minutes",
        "time_resolution": 5,
        "value_unit": "mm/h",
        "missing_value": 0.0,
    })
    for fname in files:
        eid = extract_eid(fname)
        data = read_h5_frames(args.h5_dir / fname)
        if data.ndim == 4 and data.shape[1] == 1:
            data = data[:, 0]
        T = data.shape[0]
        arr = root.create_dataset(
            f"event_{eid:02d}", shape=data.shape, chunks=data.shape,
            dtype="float32", data=data.astype(np.float32), overwrite=True,
        )
        attrs = {"event_id": eid, "num_frames": T, "source_file": fname}
        if table and eid in table:
            e = table[eid]
            attrs.update({
                "start_time": e.get("start"), "end_time": e.get("end"),
                "duration_hours": e.get("duration"),
                "max_rainfall_rg_mm": e.get("max_rg"),
                "max_rainfall_rd_mm": e.get("max_rd"),
                "mean_rainfall_rg_mm": e.get("mean_rg"),
                "mean_rainfall_rd_mm": e.get("mean_rd"),
            })
        arr.attrs.update(attrs)
        print(f"{fname} -> event_{eid:02d} ({T} frames)")
    print(f"Zarr dataset created at: {args.output}")
    return args.output


if __name__ == "__main__":
    main()
