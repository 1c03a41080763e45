"""Host-side video transforms in numpy (counterpart of
`vjepa2_tpu/data/transforms.py`; reference `app/vjepa/transforms.py`,
`src/datasets/utils/video/transforms.py`).

The pretrain path: random-resized-crop (with optional motion shift
interpolating the crop box across time), horizontal flip, colour jitter,
normalise. The eval paths: resize the short side, then a centre crop or
views slid along the long side (`EvalVideoTransform`), and the IN1K image
transform (`ImageTransform`). Output is channels-last [T, H, W, C] float32,
the layout the port's encoders take. The random transforms draw from the
``np.random.Generator`` they are given, in JAX's order, so one seed gives the
same boxes, flips and jitter on both sides.

The resize is cv2's ``INTER_LINEAR`` written in numpy (the transforms need no
cv2): half-pixel centres, edge clamp, no antialiasing when shrinking. A
uint8 frame takes cv2's fixed-point arithmetic: the horizontal pass with
11-bit weights into integer sums, the vertical pass as cv2's vector path
computes it, rounded to the nearest quarter level and then to the nearest
level. The exact products rounded once differ from cv2 by one level on about
an eighth of the pixels (measured against cv2 on uniform uint8 frames); this
formulation on about a thousandth. A float frame takes the weights in fp32.
JAX's nearest-neighbour fallback without cv2 (tests only) has no
counterpart. `VideoTransform`'s ``use_native`` takes the fused C++
crop-resize(-normalise) of `native/host_ops.cpp` (`data.native`), by default
wherever it builds, as JAX's does; ``normalize_on_device`` keeps the clip
uint8 for the train step to normalise on the card; ``auto_augment`` and
``rand_erase_prob`` add `data.augment`'s RandAugment and random erasing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

# cv2's fixed-point weight scale for uint8 (INTER_RESIZE_COEF_BITS = 11)
_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _linear_taps(src: int, dst: int):
    """For each of ``dst`` output positions along an axis of ``src`` pixels:
    the two source indices and the fp32 weight of the second, as cv2
    computes them: x = (i + 0.5) src / dst - 0.5, clamped at both edges."""
    x = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    i0 = np.floor(x).astype(np.int64)
    w = (x - i0).astype(np.float32)
    edge = (i0 < 0) | (i0 >= src - 1)
    i0 = np.clip(i0, 0, src - 1)
    w[edge] = 0.0
    return i0, np.minimum(i0 + 1, src - 1), w


def _resize_frame(frame: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """Bilinear resize of [..., H, W, C] uint8 or float frames to (h, w)."""
    h, w = size
    H, W = frame.shape[-3], frame.shape[-2]
    if H == h and W == w:
        return frame
    y0, y1, wy = _linear_taps(H, h)
    x0, x1, wx = _linear_taps(W, w)
    if frame.dtype == np.uint8:
        ax = np.round((1.0 - wx) * _COEF_SCALE).astype(np.int64)[:, None]
        ay = np.round((1.0 - wy) * _COEF_SCALE).astype(np.int64)[:, None, None]
        f = frame.astype(np.int64)
        rows = f[..., x0, :] * ax + f[..., x1, :] * (_COEF_SCALE - ax)  # level * 2^11
        # the vertical pass: (rows >> 4) * weight >> 16 per tap, in quarter levels
        s0, s1 = rows[..., y0, :, :] >> 4, rows[..., y1, :, :] >> 4
        quarters = ((s0 * ay) >> 16) + ((s1 * (_COEF_SCALE - ay)) >> 16)
        return np.clip((quarters + 2) >> 2, 0, 255).astype(np.uint8)
    dt = np.float32 if frame.dtype != np.float64 else np.float64
    f = frame.astype(dt, copy=False)
    wx, wy = wx.astype(dt)[:, None], wy.astype(dt)[:, None, None]
    rows = f[..., x0, :] * (1 - wx) + f[..., x1, :] * wx
    return rows[..., y0, :, :] * (1 - wy) + rows[..., y1, :, :] * wy


def resize_clip(clip: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """[T, H, W, C] -> [T, h, w, C], every frame as `_resize_frame`."""
    return _resize_frame(clip, size)


def _sample_crop_box(H, W, scale, ratio, rng):
    """Sample (top, left, h, w) as torchvision RandomResizedCrop does."""
    area = H * W
    for _ in range(10):
        target_area = rng.uniform(*scale) * area
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        ar = math.exp(rng.uniform(*log_ratio))
        w = int(round(math.sqrt(target_area * ar)))
        h = int(round(math.sqrt(target_area / ar)))
        if 0 < w <= W and 0 < h <= H:
            top = rng.integers(0, H - h + 1)
            left = rng.integers(0, W - w + 1)
            return int(top), int(left), h, w
    # fallback: center crop at clamped aspect
    in_ratio = W / H
    if in_ratio < ratio[0]:
        w, h = W, int(round(W / ratio[0]))
    elif in_ratio > ratio[1]:
        h, w = H, int(round(H * ratio[1]))
    else:
        w, h = W, H
    return (H - h) // 2, (W - w) // 2, h, w


def circulant_frame_padding(clip: np.ndarray, target_frames: int) -> np.ndarray:
    """Cyclically repeat a short clip to ``target_frames``
    (reference `src/datasets/utils/video/transforms.py:654`)."""
    T = clip.shape[0]
    if T >= target_frames:
        return clip[:target_frames]
    return clip[np.arange(target_frames) % T]


def color_jitter(clip: np.ndarray, rng: np.random.Generator, brightness: float = 0.4,
                 contrast: float = 0.4, saturation: float = 0.4) -> np.ndarray:
    """Clip-consistent colour jitter (one parameter draw per clip, random op
    order), on float32 [T, H, W, 3] in [0, 1] or uint8 (converted and
    returned as uint8)."""
    x = clip.astype(np.float32)
    if clip.dtype == np.uint8:
        x = x / 255.0
    ops = []
    if brightness > 0:
        b = float(rng.uniform(max(0.0, 1 - brightness), 1 + brightness))
        ops.append(lambda y: y * b)
    if contrast > 0:
        c = float(rng.uniform(max(0.0, 1 - contrast), 1 + contrast))
        ops.append(lambda y: (y - y.mean()) * c + y.mean())
    if saturation > 0:
        s = float(rng.uniform(max(0.0, 1 - saturation), 1 + saturation))

        def _sat(y, s=s):
            gray = y @ np.asarray([0.299, 0.587, 0.114], np.float32)
            return gray[..., None] + (y - gray[..., None]) * s

        ops.append(_sat)
    for i in rng.permutation(len(ops)):
        x = ops[i](x)
    x = np.clip(x, 0.0, 1.0)
    return (x * 255.0).astype(np.uint8) if clip.dtype == np.uint8 else x


def _normalized(out: np.ndarray, normalize: bool, mean, std, scale: bool = True) -> np.ndarray:
    """Pixels -> float32 / 255 (with ``scale``), then (x - mean) / std with
    ``normalize``."""
    out = out.astype(np.float32)
    if scale:
        out = out / 255.0
    if normalize:
        out = (out - mean) / std
    return np.ascontiguousarray(out)


@dataclass
class VideoTransform:
    """Pretrain-time augmentation (reference `app/vjepa/transforms.py:37-116`):
    RandAugment, the jitter, the crop box, the flip, then the motion-shift end
    box, then random erasing, each drawn from ``rng`` in JAX's order, so that
    one seed gives the same clip on both sides.

    ``use_native`` (None: wherever the library builds, as JAX's) crops,
    resizes and normalises a uint8 clip in one threaded pass of
    `native/host_ops.cpp`; True raises where it cannot be built.
    ``normalize_on_device`` emits uint8 [T, S, S, 3] (crop, resize and flip
    only) for the train step to normalise on the card
    (`train.pretrain._device_normalize`): a quarter of the host's bytes
    through collation, the workers' pipes and the copy to the card."""

    crop_size: int = 224
    random_resize_scale: tuple[float, float] = (0.3, 1.0)
    random_resize_aspect_ratio: tuple[float, float] = (0.75, 1.35)
    horizontal_flip: bool = False
    motion_shift: bool = False
    normalize: bool = True
    normalize_on_device: bool = False
    mean: np.ndarray = None
    std: np.ndarray = None
    use_native: Optional[bool] = None
    native_threads: int = 4
    auto_augment: bool = False
    aa_config: str = "rand-m7-n4-mstd0.5"
    rand_erase_prob: float = 0.0
    color_jitter_strength: float = 0.0  # clip-consistent brightness/contrast/saturation
    pad_frames: Optional[int] = None  # circulant-pad short clips to this length

    def __post_init__(self):
        self.mean = IMAGENET_MEAN if self.mean is None else np.asarray(self.mean, np.float32)
        self.std = IMAGENET_STD if self.std is None else np.asarray(self.std, np.float32)
        if self.normalize_on_device and not self.normalize:
            # the card's step normalises every uint8 clip: it cannot honour
            # normalize=False
            raise ValueError("normalize_on_device=True requires normalize=True; use the host "
                             "float path for un-normalized clips")
        from vjepa2_tpu_torch.data import native

        if self.use_native is None:
            self.use_native = self.normalize and native.available()
        elif self.use_native:
            native.load()  # raises NativeBuildError with the reason
        self._rand_augment = self._rand_erase = None
        if self.auto_augment:
            from vjepa2_tpu_torch.data.augment import RandAugment

            self._rand_augment = RandAugment.from_config(self.aa_config)
        if self.rand_erase_prob > 0:
            from vjepa2_tpu_torch.data.augment import RandomErasing

            self._rand_erase = RandomErasing(probability=self.rand_erase_prob)

    def _native_call(self, clip, boxes, hflip):
        from vjepa2_tpu_torch.data import native

        if self.normalize_on_device:
            return native.crop_resize_clip_u8(clip, *boxes, self.crop_size, hflip=hflip,
                                              num_threads=self.native_threads)
        return native.crop_resize_normalize_clip(clip, *boxes, self.crop_size, self.mean,
                                                 self.std, hflip=hflip,
                                                 num_threads=self.native_threads)

    def __call__(self, clip: np.ndarray, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """clip: [T, H, W, C] uint8 -> [T, S, S, C] float32 normalized (uint8
        with ``normalize_on_device``)."""
        rng = rng or np.random.default_rng()
        if self.pad_frames is not None:
            clip = circulant_frame_padding(clip, self.pad_frames)
        if self._rand_augment is not None and clip.dtype == np.uint8:
            clip = self._rand_augment(clip, rng=rng)
        if self.color_jitter_strength > 0:
            s = self.color_jitter_strength
            clip = color_jitter(clip, rng, brightness=s, contrast=s, saturation=s)
        T, H, W, _ = clip.shape
        scale, ratio = self.random_resize_scale, self.random_resize_aspect_ratio
        top, left, h, w = _sample_crop_box(H, W, scale, ratio, rng)
        flip = bool(self.horizontal_flip and rng.random() < 0.5)
        S = (self.crop_size, self.crop_size)
        if self.motion_shift:
            # an independent end box; the crop box interpolated across time
            # (reference `random_resized_crop_with_shift`, transforms.py:545)
            top2, left2, h2, w2 = _sample_crop_box(H, W, scale, ratio, rng)
            tops, lefts, hs, ws = (np.linspace(a, b, T).astype(int)
                                   for a, b in ((top, top2), (left, left2), (h, h2), (w, w2)))
        if self.use_native and clip.dtype == np.uint8:
            boxes = ((tops, lefts, hs, ws) if self.motion_shift else
                     tuple(np.full(T, v, np.int32) for v in (top, left, h, w)))
            out = self._native_call(clip, boxes, flip)
        else:
            if self.motion_shift:
                out = np.stack([_resize_frame(clip[t, tops[t]:tops[t] + hs[t],
                                                   lefts[t]:lefts[t] + ws[t]], S)
                                for t in range(T)])
            else:
                out = resize_clip(clip[:, top:top + h, left:left + w], S)
            if flip:
                out = out[:, :, ::-1]
            if out.dtype == np.uint8 and self.normalize_on_device:
                out = np.ascontiguousarray(out)  # stays uint8: the card normalises
            else:
                # a float clip (after colour jitter) is already in [0, 1], and
                # is normalised here even under normalize_on_device: the card
                # normalises only uint8 clips
                out = _normalized(out, self.normalize, self.mean, self.std,
                                  out.dtype == np.uint8)
        if self._rand_erase is not None:
            out = self._rand_erase(out, rng=rng)
        return out


@dataclass
class EvalVideoTransform:
    """Eval-time: resize the short side to ``crop_size``, then take
    ``num_views_per_clip`` spatial views slid along the long side (reference
    `EvalVideoTransform`)."""

    crop_size: int = 224
    num_views_per_clip: int = 1
    normalize: bool = True
    mean: np.ndarray = None
    std: np.ndarray = None

    def __post_init__(self):
        self.mean = IMAGENET_MEAN if self.mean is None else np.asarray(self.mean, np.float32)
        self.std = IMAGENET_STD if self.std is None else np.asarray(self.std, np.float32)

    def __call__(self, clip: np.ndarray) -> list[np.ndarray]:
        _, H, W, _ = clip.shape
        S = self.crop_size
        if H < W:
            nh, nw = S, max(S, int(round(W * S / H)))
        else:
            nh, nw = max(S, int(round(H * S / W))), S
        clip = resize_clip(clip, (nh, nw))
        n = self.num_views_per_clip
        if n == 1:
            tops, lefts = [(nh - S) // 2], [(nw - S) // 2]
        elif nw > nh:
            lefts, tops = np.linspace(0, nw - S, n).astype(int), [0] * n
        else:
            tops, lefts = np.linspace(0, nh - S, n).astype(int), [0] * n
        return [_normalized(clip[:, t:t + S, l:l + S], self.normalize, self.mean, self.std)
                for t, l in zip(tops, lefts)]


@dataclass
class ImageTransform:
    """IN1K-style transform: for eval, resize the short side to
    crop * 256 / 224 and centre-crop; with ``train``, a random resized crop
    and a flip."""

    crop_size: int = 224
    train: bool = False
    random_resize_scale: tuple[float, float] = (0.08, 1.0)
    random_resize_aspect_ratio: tuple[float, float] = (3 / 4, 4 / 3)
    horizontal_flip: bool = True
    normalize: bool = True
    mean: np.ndarray = None
    std: np.ndarray = None

    def __post_init__(self):
        self.mean = IMAGENET_MEAN if self.mean is None else np.asarray(self.mean, np.float32)
        self.std = IMAGENET_STD if self.std is None else np.asarray(self.std, np.float32)

    def __call__(self, img: np.ndarray, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        H, W, _ = img.shape
        S = self.crop_size
        if self.train:
            top, left, h, w = _sample_crop_box(
                H, W, self.random_resize_scale, self.random_resize_aspect_ratio, rng)
            out = _resize_frame(img[top:top + h, left:left + w], (S, S))
            if self.horizontal_flip and rng.random() < 0.5:
                out = out[:, ::-1]
        else:
            short = int(S * 256 / 224)
            if H < W:
                nh, nw = short, int(round(W * short / H))
            else:
                nh, nw = int(round(H * short / W)), short
            top, left = (nh - S) // 2, (nw - S) // 2
            out = _resize_frame(img, (nh, nw))[top:top + S, left:left + S]
        return _normalized(out, self.normalize, self.mean, self.std)
