"""Distributed samplers (counterpart of `vjepa2_tpu/data/samplers.py`;
reference `src/datasets/utils/weighted_sampler.py`).

``rank`` / ``num_replicas`` are the data-loading process's index and count;
the port trains on one card (rank 0 of 1), and the samplers take both as
arguments, as the reference's golden-value tests do. Host-side numpy: the
index streams are JAX's, draw for draw.
"""

from __future__ import annotations

import math
from typing import Iterator, Sequence

import numpy as np


class DistributedSampler:
    """Rank-strided epoch sampler (torch DistributedSampler semantics)."""

    def __init__(self, dataset_len: int, num_replicas: int, rank: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = False):
        self.n = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        if drop_last and self.n % num_replicas:
            self.num_samples = self.n // num_replicas
        else:
            self.num_samples = math.ceil(self.n / num_replicas)
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return self.num_samples

    def __iter__(self) -> Iterator[int]:
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            indices = rng.permutation(self.n).tolist()
        else:
            indices = list(range(self.n))
        if not self.drop_last:
            pad = self.total_size - len(indices)
            if pad > 0:
                indices += (indices * math.ceil(pad / len(indices)))[:pad]
        else:
            indices = indices[: self.total_size]
        return iter(indices[self.rank : self.total_size : self.num_replicas])


class DistributedWeightedSampler(DistributedSampler):
    """Weighted with-replacement epoch sampler (reference `:18-91`)."""

    def __init__(self, sample_weights: np.ndarray, num_replicas: int, rank: int,
                 seed: int = 0, drop_last: bool = False):
        super().__init__(len(sample_weights), num_replicas, rank, True, seed, drop_last)
        w = np.asarray(sample_weights, dtype=np.float64)
        self.p = w / w.sum()

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng(self.seed + self.epoch)
        indices = rng.choice(self.n, size=self.total_size, p=self.p, replace=True)
        return iter(indices[self.rank : self.total_size : self.num_replicas].tolist())


class MemoryEfficientDistributedWeightedSampler:
    """JIT infinite sampler, rank-strided to avoid cross-rank duplicates
    (reference `:94-196`). Samples a dataset by weight, then a rank-local
    index within it."""

    def __init__(self, dataset_sizes: Sequence[int], dataset_weights: Sequence[float],
                 num_replicas: int, rank: int, shuffle: bool = True, seed: int = 0):
        if len(dataset_sizes) != len(dataset_weights):
            raise ValueError("sizes/weights length mismatch")
        self.dataset_sizes = list(dataset_sizes)
        self.offsets = np.cumsum([0] + self.dataset_sizes[:-1])
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        if shuffle:
            self.rng = np.random.default_rng(seed + rank + self.epoch)
            total = float(sum(dataset_weights))
            self.p = np.asarray([w / total for w in dataset_weights])
        else:
            if any(not isinstance(w, (int, np.integer)) for w in dataset_weights):
                raise ValueError("dataset weights must be integers when shuffle is False")
            self.dataset_orders = []
            for i, w in enumerate(dataset_weights):
                self.dataset_orders.extend([i] * int(w))
            self.drawn = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if self.shuffle:
            self.rng = np.random.default_rng(self.seed + self.rank + epoch)

    def __iter__(self):
        return self

    def __next__(self) -> int:
        if self.shuffle:
            d = int(self.rng.choice(len(self.dataset_sizes), p=self.p))
            in_rank = int(self.rng.integers(self.dataset_sizes[d] // self.num_replicas))
            local = in_rank * self.num_replicas + self.rank
        else:
            d = self.dataset_orders[(self.rank + self.drawn) % len(self.dataset_orders)]
            local = (self.drawn * self.num_replicas + self.rank) % self.dataset_sizes[d]
            self.drawn += 1
        return int(self.offsets[d] + local)


class MemoryEfficientDistributedWeightedSamplerLessRepeat(MemoryEfficientDistributedWeightedSampler):
    """Per-dataset rank-local permutations instead of iid draws
    (reference `:278-336`): each rank cycles a shuffled permutation of its
    stride-subset, minimizing repeats within a pass."""

    def __init__(self, dataset_sizes, dataset_weights, num_replicas, rank,
                 shuffle: bool = True, seed: int = 0):
        super().__init__(dataset_sizes, dataset_weights, num_replicas, rank, shuffle, seed)
        if shuffle:
            self._perm_rng = np.random.default_rng(seed)
            self._perms = [self._new_perm(ds // num_replicas) for ds in self.dataset_sizes]

    def _new_perm(self, n: int):
        return iter(self._perm_rng.permutation(max(1, n)).tolist())

    def _next_in_rank(self, d: int) -> int:
        try:
            return next(self._perms[d])
        except StopIteration:
            self._perms[d] = self._new_perm(self.dataset_sizes[d] // self.num_replicas)
            return next(self._perms[d])

    def __next__(self) -> int:
        if not self.shuffle:
            return super().__next__()
        d = int(self.rng.choice(len(self.dataset_sizes), p=self.p))
        in_rank = self._next_in_rank(d)
        local = in_rank * self.num_replicas + self.rank
        return int(self.offsets[d] + local)
