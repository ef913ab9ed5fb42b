"""Data module: datasets and prefetching loaders per split (numpy).

Counterpart of ``p2igan_tpu/data/datamodule.py`` (reference
``p2igan_bench/data/dataloader.py``):

* routing: ``data.train.data_root`` ending in ``train.zarr`` selects the
  sliding-window dataset with a seeded 80/20 train/valid split; otherwise
  per-split ``EventDataset``s, where valid inherits train's
  w/h/sample_length/mask and test drops ``sample_length``; test batches hold
  one event, in file order unless ``data.test.shuffle``;
* loading: a thread-pool prefetch loader producing numpy batches
  (B, T, H, W, C); the per-item RNG is derived from (seed, epoch, index), so
  the same seed gives the same batches and masks as the JAX package; shorter
  sequences pad by repeating their last frame;
* data parallelism: a loader of rank r of W (``rank``, ``world``) reads only
  rank r's rows of each global batch (``parallel.shard_rows``); the global
  order and every item's mask come from the same seeds on every rank, so its
  rows hold what the single process's batch holds there.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..config import build_dataset_args, drop_sample_length, extract_shared_params
from ..parallel.mesh import shard_rows
from .stores import EventDataset, Item, ZarrWindowDataset


def pad_repeat_last(a: np.ndarray, length: int, axis: int = 0) -> np.ndarray:
    """Pad ``a`` along ``axis`` to ``length`` by repeating its last slice."""
    n = length - a.shape[axis]
    if n <= 0:
        return a
    reps = np.repeat(np.take(a, [-1], axis=axis), n, axis=axis)
    return np.concatenate([a, reps], axis=axis)


def collate_pad_last(items: Sequence[Item]) -> Tuple[np.ndarray, ...]:
    """Stack items, padding each stream to its own longest item by repeating
    the last frame (the raw pipeline's frame-constant masks stay (1, H, W, 1)
    per item)."""
    out = []
    for stream in zip(*items):
        max_len = max(arr.shape[0] for arr in stream)
        out.append(np.stack([pad_repeat_last(arr, max_len) for arr in stream]))
    return tuple(out)


class Subset:
    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None):
        return self.dataset.__getitem__(self.indices[idx], rng=rng)


class Loader:
    """Thread-pool prefetching batch loader over an indexable dataset; with
    ``world`` > 1 it yields rank ``rank``'s rows of each global batch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool, seed: int = 0,
                 num_workers: int = 4, drop_last: bool = False,
                 prefetch_batches: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch_batches = prefetch_batches
        self.epoch = 0
        self.rank, self.world = 0, 1

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def global_sizes(self) -> List[int]:
        """The global batches' sizes, in order (a rank's own batch is a
        ``world``-th of one, or all of it where the size does not divide)."""
        n = len(self.dataset)
        sizes = [min(self.batch_size, n - i) for i in range(0, n, self.batch_size)]
        return sizes[:len(self)]

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.default_rng((self.seed, self.epoch)).permutation(n)
        return np.arange(n)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        order = self._order()
        epoch = self.epoch
        self.epoch += 1
        batches: List[np.ndarray] = [order[i:i + self.batch_size]
                                     for i in range(0, len(order), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        batches = [shard_rows(b, self.rank, self.world) for b in batches]

        def fetch(idx: int) -> Item:
            rng = np.random.default_rng((self.seed, epoch, int(idx)))
            return self.dataset.__getitem__(int(idx), rng=rng)

        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending: List[List[cf.Future]] = []
            bi = 0
            while bi < len(batches) and len(pending) <= self.prefetch_batches:
                pending.append([pool.submit(fetch, i) for i in batches[bi]])
                bi += 1
            while pending:
                futs = pending.pop(0)
                if bi < len(batches):
                    pending.append([pool.submit(fetch, i) for i in batches[bi]])
                    bi += 1
                yield collate_pad_last([f.result() for f in futs])


class P2IDataModule:
    """Builds the train/valid/test datasets and loaders from a config dict."""

    def __init__(self, cfg: Dict[str, Any], with_train: bool = True):
        """``with_train=False`` builds the test split only (serving, whose
        config may name a train store that does not exist)."""
        self.cfg = cfg
        data_cfg = cfg["data"]
        self.num_workers = cfg.get("train", {}).get("num_workers", 4)
        self.seed = cfg.get("seed", 42)
        self.train_args = build_dataset_args(data_cfg["train"])
        shared = extract_shared_params(self.train_args)
        self.train_dataset = self.valid_dataset = self.test_dataset = None
        self.valid_shuffle = self.test_shuffle = False

        if with_train and str(self.train_args.get("data_root", "")).endswith("train.zarr"):
            self.train_dataset, self.valid_dataset = self._split_train_valid(
                ZarrWindowDataset(self.train_args), seed=self.seed)
        elif with_train:
            self.train_dataset = EventDataset(self.train_args)
            valid_cfg = data_cfg.get("valid")
            if valid_cfg:
                valid_args = build_dataset_args(valid_cfg, defaults=shared)
                self.valid_shuffle = bool(valid_cfg.get("shuffle", False))
                self.valid_dataset = EventDataset(valid_args)

        test_cfg = data_cfg.get("test")
        if test_cfg:
            test_args = build_dataset_args(test_cfg,
                                           defaults=drop_sample_length(shared))
            self.test_shuffle = bool(test_cfg.get("shuffle", False))
            self.test_dataset = EventDataset(test_args)

    @staticmethod
    def _split_train_valid(dataset, seed: int = 42, train_ratio: float = 0.8):
        """Seeded random 80/20 split (reference dataloader.py:94-110)."""
        total = len(dataset)
        if total <= 1:
            return dataset, None
        val_size = int(total * (1 - train_ratio))
        val_size = min(max(val_size, 1), total - 1)
        indices = np.random.default_rng(seed).permutation(total).tolist()
        return (Subset(dataset, indices[:total - val_size]),
                Subset(dataset, indices[total - val_size:]))

    def train_dataloader(self) -> Optional[Loader]:
        if self.train_dataset is None:
            return None
        return Loader(self.train_dataset, self.cfg["train"]["batch_size"],
                      shuffle=True, seed=self.seed, num_workers=self.num_workers)

    def val_dataloader(self) -> Optional[Loader]:
        if self.valid_dataset is None:
            return None
        return Loader(self.valid_dataset, self.cfg["train"]["batch_size"],
                      shuffle=self.valid_shuffle, seed=self.seed + 1,
                      num_workers=self.num_workers)

    def test_dataloader(self) -> Optional[Loader]:
        if self.test_dataset is None:
            return None
        return Loader(self.test_dataset, 1, shuffle=self.test_shuffle,
                      seed=self.seed + 2, num_workers=self.num_workers)
