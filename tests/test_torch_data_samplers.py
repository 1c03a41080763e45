"""The port's four samplers (`vjepa2_tpu_torch/data/samplers.py`) against the
JAX package's: identical index streams over seeds, epochs, ranks, world
sizes, shuffling, drop_last and weights, in one parametrised test."""

import itertools

import numpy as np
import pytest

from vjepa2_tpu.data import samplers as js
from vjepa2_tpu_torch.data import samplers as ts

SIZES, WEIGHTS = [7, 20, 13], [0.5, 2.0, 1.0]
INT_WEIGHTS = [1, 3, 2]


def _epoch(kind, mod, seed, rank, world, flag):
    if kind == "distributed":
        return mod.DistributedSampler(41, world, rank, shuffle=flag, seed=seed, drop_last=flag)
    if kind == "weighted":
        w = np.random.default_rng(seed).random(41) + 0.1
        return mod.DistributedWeightedSampler(w, world, rank, seed=seed, drop_last=flag)
    cls = (mod.MemoryEfficientDistributedWeightedSampler if kind == "memory_efficient"
           else mod.MemoryEfficientDistributedWeightedSamplerLessRepeat)
    return cls(SIZES, WEIGHTS if flag else INT_WEIGHTS, world, rank, shuffle=flag, seed=seed)


CASES = list(itertools.product(
    ["distributed", "weighted", "memory_efficient", "less_repeat"],
    [0, 239], [(0, 1), (0, 3), (2, 3)], [False, True]))


@pytest.mark.parametrize("kind, seed, rank_world, flag", CASES,
                         ids=["-".join(map(str, (k, s, *rw, f))) for k, s, rw, f in CASES])
def test_index_streams_match_jax(kind, seed, rank_world, flag):
    rank, world = rank_world
    got, want = (_epoch(kind, m, seed, rank, world, flag) for m in (ts, js))
    for epoch in (0, 1, 5):
        if hasattr(want, "set_epoch"):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
        a = list(itertools.islice(iter(got), 60))
        b = list(itertools.islice(iter(want), 60))
        assert a == b and len(a) > 0
        if hasattr(want, "__len__"):
            assert len(got) == len(want)
