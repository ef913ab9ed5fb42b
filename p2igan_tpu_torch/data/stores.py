"""Event and training-window readers (numpy).

``EventDataset`` and ``ZarrWindowDataset`` of ``p2igan_tpu/data/stores.py``
(reference ``p2igan_bench/data/sti_dataset.py:124-324``), re-implemented
because that module imports jax through its masks.

* ``EventDataset`` -- one item per event: ``.h5`` files (``frames`` dataset;
  h5py imported only when one is read), flat zarr arrays or video files;
  normalized to (T, H, W, 1) float32 / 255, RGB averaged to gray, masked and
  center-cropped.
* ``ZarrWindowDataset`` -- sliding training windows over
  ``events/<key>/frames`` (T, H, W uint8) indexed by ``index/windows``
  (N, 3) = [event_id, start_t, length]; per item a random spatial crop, /255
  and the mask.

Items are ``(video, masked, mask)`` float32 arrays, or in the raw
(``device_decode``) mode ``(video_u8, mask_u8)``, decoded on the device.
Randomness is an explicit ``numpy.random.Generator`` per item.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from . import zarrlite
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


class _MaskMixin:
    def _init_mask_cfg(self, args: Dict[str, Any]) -> None:
        mask_cfg = args.get("mask", {}) or {}
        self.mask_type = mask_cfg.get("type", "sti")
        self.mask_file = mask_cfg.get("file")
        self.block_sizes = mask_cfg.get("block_sizes", [4])
        self.mask_keep = mask_cfg.get("keep", 4)
        self.mask_interval = mask_cfg.get("interval", [2, 5])
        # sti/stis broadcast one (H, W) pattern over all frames
        self.mask_frame_constant = self.mask_type in ("sti", "stis")

    def _make_mask(self, shape, rng: np.random.Generator) -> np.ndarray:
        return create_mask_np(shape, rng, mask_type=self.mask_type,
                              mask_file=self.mask_file,
                              block_sizes=self.block_sizes, keep=self.mask_keep,
                              interval=self.mask_interval)


class EventDataset(_MaskMixin):
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
        self._init_mask_cfg(args)
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
        mask = self._make_mask(video.shape, rng)
        masked = video * mask
        return (self._crop_center(video), self._crop_center(masked),
                self._crop_center(mask))

    def _crop_center(self, data: np.ndarray) -> np.ndarray:
        if data.shape[1] == self.height and data.shape[2] == self.width:
            return data
        y0 = max((data.shape[1] - self.height) // 2, 0)
        x0 = max((data.shape[2] - self.width) // 2, 0)
        return data[:, y0:y0 + self.height, x0:x0 + self.width, :]


class ZarrWindowDataset(_MaskMixin):
    """Sliding-window training reads (reference ``Dataset_ZarrTrain``)."""

    def __init__(self, args: Dict[str, Any]):
        self.zarr_path = str(args["data_root"])
        self.root = zarrlite.open(self.zarr_path, mode="r")
        self.events_grp = self.root["events"]
        self.index_arr = np.asarray(self.root["index"]["windows"][:])
        self.event_keys = sorted(self.events_grp.keys())  # timestamp order
        self.crop_h = args["h"]
        self.crop_w = args["w"]
        # raw mode ships (uint8 video, uint8 mask) pairs; the decode, /255 and
        # mask multiply run on the device (ops/decode_mask.py)
        self.raw = bool(args.get("device_decode", False))
        self._init_mask_cfg(args)
        self._frames_cache: Dict[str, Any] = {}

    def __len__(self) -> int:
        return self.index_arr.shape[0]

    def _frames(self, key: str):
        arr = self._frames_cache.get(key)
        if arr is None:
            arr = self.events_grp[key]["frames"]
            self._frames_cache[key] = arr
        return arr

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        event_id, start_t, length = (int(v) for v in self.index_arr[idx])
        frames_z = self._frames(self.event_keys[event_id])
        T, H, W = frames_z.shape
        if H == self.crop_h and W == self.crop_w:
            y0 = x0 = 0
        else:
            if H < self.crop_h or W < self.crop_w:
                raise ValueError(
                    f"train.zarr event '{self.event_keys[event_id]}' frames are "
                    f"({H}, {W}) but data config asks for a ({self.crop_h}, "
                    f"{self.crop_w}) crop; crop must not exceed the stored "
                    f"frame size")
            y0 = int(rng.integers(0, H - self.crop_h + 1))
            x0 = int(rng.integers(0, W - self.crop_w + 1))
        video = frames_z[start_t:start_t + length,
                         y0:y0 + self.crop_h, x0:x0 + self.crop_w]
        if self.raw:
            video_u8 = np.ascontiguousarray(video)[..., np.newaxis]
            # a frame-constant mask ships as ONE (1, H, W, 1) frame; the RNG
            # draws do not depend on T, so it equals the float mode's mask
            mshape = ((1,) + video_u8.shape[1:] if self.mask_frame_constant
                      else video_u8.shape)
            return video_u8, self._make_mask(mshape, rng).astype(np.uint8)
        video = (video.astype(np.float32) / 255.0)[..., np.newaxis]
        mask = self._make_mask(video.shape, rng)
        return video, video * mask, mask
