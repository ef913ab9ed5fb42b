"""Per-event readers for serving (numpy).

``EventDataset`` of ``p2igan_tpu/data/stores.py`` (reference
``p2igan_bench/data/sti_dataset.py:124-239``), re-implemented because that
module imports jax through its masks. One item per event: ``.h5`` files
(``frames`` dataset; h5py imported only when one is read), flat zarr arrays or
video files; normalized to (T, H, W, 1) float32 / 255, RGB averaged to gray,
masked and center-cropped. Items are ``(video, masked, mask)`` float32 arrays.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from p2igan_tpu.data import zarrlite

from .masks import create_mask_np

Item = Tuple[np.ndarray, np.ndarray, np.ndarray]


def store_compressor() -> Dict[str, Any]:
    """Codec for the zarr stores the port writes: zarrlite's default (zstd)
    where the system libzstd loads, zlib (always available) otherwise."""
    try:
        zarrlite._load_zstd()
    except OSError:
        return {"id": "zlib", "level": 1}
    return dict(zarrlite.DEFAULT_COMPRESSOR)


def extract_number(filename: str) -> int:
    match = re.search(r"\d+", filename)
    return int(match.group()) if match else -1


class EventDataset:
    """Per-event reader (reference ``Dataset``)."""

    def __init__(self, args: Dict[str, Any]):
        self.args = args
        self.data_root = str(args["data_root"])
        self.is_zarr = self.data_root.endswith(".zarr")
        self.zarr_root = None
        if self.is_zarr:
            self.zarr_root = zarrlite.open(self.data_root, mode="r")
            # lexicographic event order, as the reference's
            # sorted(zarr_root.array_keys()); files sort by embedded number
            self.video_files: List[str] = list(self.zarr_root.array_keys())
        else:
            self.video_files = sorted(
                [os.path.join(self.data_root, f) for f in os.listdir(self.data_root)
                 if f.endswith((".mp4", ".avi", ".h5"))],
                key=lambda f: extract_number(os.path.basename(f)))
        mask_cfg = args.get("mask", {}) or {}
        self.mask_type = mask_cfg.get("type", "sti")
        self.mask_file = mask_cfg.get("file")
        self.block_sizes = mask_cfg.get("block_sizes", [4])
        self.mask_keep = mask_cfg.get("keep", 4)
        self.mask_interval = mask_cfg.get("interval", [2, 5])
        self.width = args["w"]
        self.height = args["h"]
        self.sample_length = args.get("sample_length")

    def __len__(self) -> int:
        return len(self.video_files)

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None) -> Item:
        if idx >= len(self.video_files):
            raise IndexError(f"Index {idx} out of range for dataset with "
                             f"{len(self.video_files)} samples.")
        rng = rng or np.random.default_rng()
        path = self.video_files[idx]
        if self.is_zarr:
            data = self._read_zarr(path)
        elif path.endswith((".mp4", ".avi")):
            data = self._read_video(path)
        elif path.endswith(".h5"):
            data = self._read_hdf5(path)
        else:
            raise ValueError(f"Unsupported file format: {path}")
        return self._post_process(data, rng)

    @staticmethod
    def _read_hdf5(path: str) -> np.ndarray:
        import h5py

        with h5py.File(path, "r") as f:
            data = f["frames"][:]
        return data[..., np.newaxis] if data.ndim == 3 else data

    def _read_zarr(self, key: str) -> np.ndarray:
        data = np.asarray(self.zarr_root[key][:])
        if data.ndim == 3:
            data = data[..., np.newaxis]
        elif data.ndim == 4 and data.shape[-1] != 1:
            data = np.mean(data, axis=-1, keepdims=True)
        return data

    @staticmethod
    def _read_video(path: str) -> np.ndarray:
        """Decode a video file to (T, H, W, 3) RGB uint8 (decord, else OpenCV)."""
        try:
            from decord import VideoReader

            vr = VideoReader(path)
            return vr.get_batch(range(len(vr))).asnumpy()
        except ImportError:
            pass
        try:
            import cv2
        except ImportError as e:
            raise ImportError("decord or opencv is required for video files") from e
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise IOError(f"cannot open video: {path}")
        frames = []
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        finally:
            cap.release()
        if not frames:
            raise IOError(f"no frames decoded from video: {path}")
        return np.stack(frames)

    def _post_process(self, video: np.ndarray, rng) -> Item:
        if self.sample_length is not None:
            video = video[: min(self.sample_length, video.shape[0])]
        video = video.astype(np.float32) / 255.0
        if video.shape[-1] == 3:
            video = np.mean(video, axis=-1, keepdims=True)
        mask = create_mask_np(video.shape, rng, mask_type=self.mask_type,
                              mask_file=self.mask_file,
                              block_sizes=self.block_sizes, keep=self.mask_keep,
                              interval=self.mask_interval)
        masked = video * mask
        return (self._crop_center(video), self._crop_center(masked),
                self._crop_center(mask))

    def _crop_center(self, data: np.ndarray) -> np.ndarray:
        if data.shape[1] == self.height and data.shape[2] == self.width:
            return data
        y0 = max((data.shape[1] - self.height) // 2, 0)
        x0 = max((data.shape[2] - self.width) // 2, 0)
        return data[:, y0:y0 + self.height, x0:x0 + self.width, :]
