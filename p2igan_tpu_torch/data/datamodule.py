"""Serving data module: the test split and its prefetching loader (numpy).

Counterpart of ``p2igan_tpu/data/datamodule.py`` (reference
``p2igan_bench/data/dataloader.py``) for inference: the test split inherits
train's w/h/mask and drops ``sample_length``; batches of one event, in file
order unless ``data.test.shuffle``; per-item RNG from (seed, epoch, index);
shorter sequences pad by repeating their last frame. The train/valid splits
wait for the training port.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from p2igan_tpu.config import build_dataset_args, drop_sample_length, extract_shared_params

from .stores import EventDataset, Item


def pad_repeat_last(a: np.ndarray, length: int, axis: int = 0) -> np.ndarray:
    """Pad ``a`` along ``axis`` to ``length`` by repeating its last slice."""
    n = length - a.shape[axis]
    if n <= 0:
        return a
    reps = np.repeat(np.take(a, [-1], axis=axis), n, axis=axis)
    return np.concatenate([a, reps], axis=axis)


def collate_pad_last(items: Sequence[Item]) -> Tuple[np.ndarray, ...]:
    """Stack items, padding each stream to its own longest item by repeating
    the last frame."""
    out = []
    for stream in zip(*items):
        max_len = max(arr.shape[0] for arr in stream)
        out.append(np.stack([pad_repeat_last(arr, max_len) for arr in stream]))
    return tuple(out)


class Loader:
    """Thread-pool prefetching batch loader over an indexable dataset."""

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

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

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
    """The test split of the JAX package's data module, from a config dict."""

    def __init__(self, cfg: Dict[str, Any]):
        self.cfg = cfg
        data_cfg = cfg["data"]
        self.num_workers = cfg.get("train", {}).get("num_workers", 4)
        self.seed = cfg.get("seed", 42)
        shared = extract_shared_params(build_dataset_args(data_cfg["train"]))
        self.test_dataset = None
        self.test_shuffle = False
        test_cfg = data_cfg.get("test")
        if test_cfg:
            test_args = build_dataset_args(test_cfg,
                                           defaults=drop_sample_length(shared))
            self.test_shuffle = bool(test_cfg.get("shuffle", False))
            self.test_dataset = EventDataset(test_args)

    def test_dataloader(self) -> Optional[Loader]:
        if self.test_dataset is None:
            return None
        return Loader(self.test_dataset, 1, shuffle=self.test_shuffle,
                      seed=self.seed + 2, num_workers=self.num_workers)
