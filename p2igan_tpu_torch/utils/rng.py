"""Seeding of the port's random number generators.

Counterpart of ``p2igan_tpu/utils/rng.py``. The JAX package seeds the host's
generators and hands out ``jax.random`` keys; the port seeds the host's and
torch's global generators and hands out ``torch.Generator`` objects, which
the models' initialisers take explicitly. The data pipeline draws its masks
from per-item numpy generators (``data/``), seeded from (seed, epoch, index),
in both packages.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def seed_everything(seed: int) -> torch.Generator:
    """Seed ``random``, numpy's and torch's global generators (the reference
    scripts' seeding, ``scripts/train.py:78-82``) and return a
    ``torch.Generator`` seeded the same, the root of a run's explicit draws."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def fold_in(seed: int, data: int) -> int:
    """A 63-bit seed derived from (seed, data), as ``jax.random.fold_in``
    derives a key: a hash of both (numpy's ``SeedSequence``), so streams of
    neighbouring counters share nothing."""
    state = np.random.SeedSequence([int(seed), int(data)]).generate_state(1, np.uint64)
    return int(state[0]) & ((1 << 63) - 1)


class KeyStream:
    """A stateful source of fresh ``torch.Generator`` objects from a root seed
    (JAX ``KeyStream``): the n-th (from 1) is seeded with ``fold_in(root, n)``.
    Use at orchestration level; code that draws takes its generator
    explicitly."""

    def __init__(self, seed: int):
        self.seed = int(seed)
        self._count = 0

    def next(self) -> torch.Generator:
        self._count += 1
        return torch.Generator().manual_seed(fold_in(self.seed, self._count))

    def __call__(self) -> torch.Generator:
        return self.next()
