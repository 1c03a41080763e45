"""RandAugment and random erasing for video clips (counterpart of
`vjepa2_tpu/data/augment.py`; the reference vendors timm's
`src/datasets/utils/video/randaugment.py` and `randerase.py`).

RandAugment runs PIL's ops on uint8 frames, its parameters drawn once a clip
so that every frame gets the same ops (the reference applies one
`create_random_augment` transform to the clip's list of images). PIL is
imported at first use; without it RandAugment raises. Random erasing is
numpy. Both draw from the ``np.random.Generator`` they are given in JAX's
order, so one seed gives the same clip on both sides.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

import numpy as np

_MAX_LEVEL = 10.0
_FILL = (128, 128, 128)


def _pil():
    try:
        from PIL import Image, ImageEnhance, ImageOps
    except ImportError as e:
        raise ImportError("RandAugment (data_aug.auto_augment) needs the PIL package") from e
    return Image, ImageEnhance, ImageOps


def _sign(rng) -> int:
    return rng.choice([-1, 1])


# Each op: (pil_image, level, rng) -> pil_image
def _op_identity(img, level, rng):
    return img


def _op_autocontrast(img, level, rng):
    return _pil()[2].autocontrast(img)


def _op_equalize(img, level, rng):
    return _pil()[2].equalize(img)


def _op_invert(img, level, rng):
    return _pil()[2].invert(img)


def _op_rotate(img, level, rng):
    return img.rotate((level / _MAX_LEVEL) * 30.0, fillcolor=_FILL)


def _op_posterize(img, level, rng):
    return _pil()[2].posterize(img, max(1, 4 - int((level / _MAX_LEVEL) * 4)))


def _op_solarize(img, level, rng):
    return _pil()[2].solarize(img, int(256 - (level / _MAX_LEVEL) * 256))


def _op_solarize_add(img, level, rng):
    add = int((level / _MAX_LEVEL) * 110)
    arr = np.asarray(img).astype(np.int32)
    arr = np.where(arr < 128, np.clip(arr + add, 0, 255), arr)
    return _pil()[0].fromarray(arr.astype(np.uint8))


def _enhance(name):
    def op(img, level, rng):
        return getattr(_pil()[1], name)(img).enhance(1.0 + (level / _MAX_LEVEL) * 0.9 * _sign(rng))
    return op


def _affine(coeffs):
    def op(img, level, rng):
        Image = _pil()[0]
        return img.transform(img.size, Image.AFFINE, coeffs(img, level, rng), fillcolor=_FILL)
    return op


RAND_AUGMENT_OPS = {
    "Identity": _op_identity,
    "AutoContrast": _op_autocontrast,
    "Equalize": _op_equalize,
    "Invert": _op_invert,
    "Rotate": _op_rotate,
    "Posterize": _op_posterize,
    "Solarize": _op_solarize,
    "SolarizeAdd": _op_solarize_add,
    "Color": _enhance("Color"),
    "Contrast": _enhance("Contrast"),
    "Brightness": _enhance("Brightness"),
    "Sharpness": _enhance("Sharpness"),
    "ShearX": _affine(lambda img, lv, rng: (1, (lv / _MAX_LEVEL) * 0.3 * _sign(rng), 0, 0, 1, 0)),
    "ShearY": _affine(lambda img, lv, rng: (1, 0, 0, (lv / _MAX_LEVEL) * 0.3 * _sign(rng), 1, 0)),
    "TranslateX": _affine(lambda img, lv, rng: (
        1, 0, (lv / _MAX_LEVEL) * 0.45 * img.size[0] * _sign(rng), 0, 1, 0)),
    "TranslateY": _affine(lambda img, lv, rng: (
        1, 0, 0, 0, 1, (lv / _MAX_LEVEL) * 0.45 * img.size[1] * _sign(rng))),
}


@dataclass
class RandAugment:
    """``rand-m{magnitude}-n{num_layers}[-mstd{std}]`` parsed as timm does
    (reference `create_random_augment`, `transforms.py:590`)."""

    num_layers: int = 2
    magnitude: float = 9.0
    magnitude_std: float = 0.5

    @classmethod
    def from_config(cls, config_str: str) -> "RandAugment":
        m = re.findall(r"m(\d+)", config_str)
        n = re.findall(r"n(\d+)", config_str)
        std = re.findall(r"mstd([\d.]+)", config_str)
        return cls(num_layers=int(n[0]) if n else 2, magnitude=float(m[0]) if m else 9.0,
                   magnitude_std=float(std[0]) if std else 0.5)

    def __call__(self, clip: np.ndarray, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """clip [T, H, W, 3] uint8 -> augmented uint8, the same ops on every frame."""
        Image = _pil()[0]
        rng = rng or np.random.default_rng()
        names = list(RAND_AUGMENT_OPS)
        chosen = [names[i] for i in rng.integers(0, len(names), size=self.num_layers)]
        levels = [float(np.clip(rng.normal(self.magnitude, self.magnitude_std), 0, _MAX_LEVEL))
                  for _ in chosen]
        # the ops' own draws: one child seed an op, replayed on every frame
        seeds = rng.integers(0, 2**31, size=self.num_layers)
        out = []
        for frame in clip:
            img = Image.fromarray(frame)
            for name, level, seed in zip(chosen, levels, seeds):
                img = RAND_AUGMENT_OPS[name](img, level, np.random.default_rng(seed))
            out.append(np.asarray(img))
        return np.stack(out)


@dataclass
class RandomErasing:
    """Per-clip random erasing (reference `randerase.py:40`), one box on
    every frame ('cube' mode)."""

    probability: float = 0.25
    min_area: float = 0.02
    max_area: float = 1 / 3
    min_aspect: float = 0.3

    def __call__(self, clip: np.ndarray, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """clip [T, H, W, C] float or uint8 -> an erased copy (or the clip itself)."""
        rng = rng or np.random.default_rng()
        if rng.random() > self.probability:
            return clip
        _, H, W, C = clip.shape
        out = clip.copy()
        for _ in range(10):
            target = rng.uniform(self.min_area, self.max_area) * H * W
            ar = np.exp(rng.uniform(np.log(self.min_aspect), np.log(1 / self.min_aspect)))
            h = int(round(np.sqrt(target * ar)))
            w = int(round(np.sqrt(target / ar)))
            if h < H and w < W:
                top = rng.integers(0, H - h)
                left = rng.integers(0, W - w)
                noise = rng.normal(size=(h, w, C))
                if clip.dtype == np.uint8:
                    noise = np.clip(noise * 64 + 128, 0, 255).astype(np.uint8)
                out[:, top:top + h, left:left + w] = noise
                break
        return out
