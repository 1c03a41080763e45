"""Hub preprocessor (counterpart of `vjepa2_tpu/hub/preprocessor.py`;
reference `evals/hub/preprocessor.py:13`).

``vjepa2_preprocessor()`` returns the eval video transform: resize the short
side to ``crop_size``, centre crop, /255, ImageNet-normalise, emitting
channels-last float32 [T, S, S, 3] ready for the encoder. numpy only
(`data.transforms`), so a serving process needs neither cv2 nor a model.
"""

from __future__ import annotations

import numpy as np

from vjepa2_tpu_torch.data.transforms import EvalVideoTransform


class Preprocessor:
    def __init__(self, crop_size: int = 256):
        self._t = EvalVideoTransform(crop_size=crop_size, num_views_per_clip=1)

    @property
    def crop_size(self) -> int:
        return self._t.crop_size

    def __call__(self, clip: np.ndarray) -> np.ndarray:
        """clip: [T, H, W, 3] uint8 -> [T, S, S, 3] float32 normalized."""
        return self._t(np.asarray(clip))[0]


def vjepa2_preprocessor(crop_size: int = 256) -> Preprocessor:
    return Preprocessor(crop_size=crop_size)
