"""Generate the fake benchmark dataset tree with the PyTorch port's own data
modules (numpy and the port's zarrlite; no jax).

    python scripts/make_fake_data_torch.py --root datasets/fake [--size 128] [--frames 16]

Writes the flat test zarr, the sliding-window train zarr and the gauge mask
files every shipped config names, and the per-event ``.h5`` test events where
h5py is installed (it is left out, and said so, where it is not).
"""

from __future__ import annotations

# Allow running as `python scripts/<name>.py` without installing the package.
import sys as _sys
from pathlib import Path as _Path

_repo = str(_Path(__file__).resolve().parents[1])
if _repo not in _sys.path:
    _sys.path.insert(0, _repo)

import argparse
import importlib.util
from pathlib import Path

from p2igan_tpu_torch.data.fake import make_fake_benchmark_tree


def main() -> None:
    p = argparse.ArgumentParser(description="Generate fake benchmark data")
    p.add_argument("--root", type=Path, default=Path("datasets/fake"))
    p.add_argument("--size", type=int, default=128, help="Spatial H=W")
    p.add_argument("--frames", type=int, default=16, help="Frames per test event")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    h5 = importlib.util.find_spec("h5py") is not None
    paths = make_fake_benchmark_tree(args.root, H=args.size, W=args.size,
                                     T=args.frames, seed=args.seed, h5_events=h5)
    for k, v in paths.items():
        print(f"{k}: {v}")
    if not h5:
        print("test_events: not written (h5py is not installed)")


if __name__ == "__main__":
    main()
