"""Clips for tests and benchmarks (the part of `vjepa2_tpu/data/video.py`
the synthetic loader needs; the decoders come with the data pipeline from
disk)."""

from __future__ import annotations

import numpy as np


def synthetic_clip(num_frames: int, height: int, width: int, seed: int = 0) -> np.ndarray:
    """Deterministic moving-gradient clip for tests/benchmarks."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, size=(height, width, 3), dtype=np.uint8)
    frames = [np.roll(base, shift=3 * t, axis=1) for t in range(num_frames)]
    return np.stack(frames)
