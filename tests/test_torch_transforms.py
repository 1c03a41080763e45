"""The port's host transforms (`vjepa2_tpu_torch.data.transforms`) and hub
preprocessor (`vjepa2_tpu_torch.hub.preprocessor`) against the JAX
package's (`vjepa2_tpu/data/transforms.py`, `vjepa2_tpu/hub/preprocessor.py`),
which resize with cv2, on the CPU. The port has no cv2: its resize is cv2's
``INTER_LINEAR`` written in numpy.

Each case runs JAX's side first, on copies of the inputs, then the port's on
the same seeded uint8 frames and the same ``np.random.Generator`` seed.

Tolerances: a uint8 resize within one level of cv2's on every pixel, and off
on under 1% of them; a float resize within 1e-4 (frames in [0, 1]); a
normalised transform within one level, 1/255/min(std) = 1.75e-2, and a mean
absolute difference under 1e-3; bit-equal where no resize happens.
"""

import cv2
import numpy as np
import pytest
import torch

from vjepa2_tpu.data import transforms as jt
from vjepa2_tpu.hub import preprocessor as jpp
from vjepa2_tpu_torch.data import transforms as tt
from vjepa2_tpu_torch.hub import preprocessor as tpp

LEVEL = 1.0 / 255.0 / float(jt.IMAGENET_STD.min())  # one uint8 level after normalising
MEAN_ABS = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's torch ops: 6 pytest workers with
    torch's default 8 threads each oversubscribe an 8-core host (see
    `tests/test_torch_eval_cli.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape, np.uint8)


def _close(got, want, exact=False):
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    if exact:
        np.testing.assert_array_equal(got, want)
        return
    diff = np.abs(got - want)
    assert diff.max() <= LEVEL * 1.0001, diff.max()
    assert diff.mean() < MEAN_ABS, diff.mean()


# (H, W) -> (h, w): shrinking and growing, non-square, to 256 and 384
RESIZES = [((480, 640), (256, 341)), ((720, 1280), (256, 455)), ((100, 150), (256, 384)),
           ((300, 200), (384, 256)), ((640, 480), (384, 288)), ((64, 48), (256, 192)),
           ((512, 512), (256, 256)), ((257, 300), (256, 299))]


@pytest.mark.parametrize("src, dst", RESIZES)
def test_resize_matches_cv2_inter_linear(src, dst):
    (H, W), (h, w) = src, dst
    frame = _frames(H + W, (H, W, 3))
    want = cv2.resize(frame.copy(), (w, h), interpolation=cv2.INTER_LINEAR)
    got = tt._resize_frame(frame, (h, w))
    assert got.shape == want.shape == (h, w, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01, ((diff > 0).mean(), diff.max())
    flt = np.random.RandomState(H).rand(H, W, 3).astype(np.float32)
    want = cv2.resize(flt.copy(), (w, h), interpolation=cv2.INTER_LINEAR)
    got = tt._resize_frame(flt, (h, w))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_resize_clip_and_jax_resize_agree():
    """A clip resizes frame by frame as JAX's `resize_clip` does, and a frame
    already at the size comes back unchanged."""
    clip = _frames(1, (3, 120, 160, 3))
    want = jt.resize_clip(clip.copy(), (256, 341))
    got = tt.resize_clip(clip, (256, 341))
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    frame = clip[0]
    assert tt._resize_frame(frame, (120, 160)) is frame


@pytest.mark.parametrize("views", [1, 3])
@pytest.mark.parametrize("shape", [(4, 480, 640, 3), (4, 360, 270, 3)])
def test_eval_video_transform_matches_jax(views, shape):
    clip = _frames(views, shape)
    want = jt.EvalVideoTransform(crop_size=256, num_views_per_clip=views)(clip.copy())
    got = tt.EvalVideoTransform(crop_size=256, num_views_per_clip=views)(clip)
    assert len(got) == len(want) == views
    for g, w in zip(got, want):
        _close(g, w)


def test_eval_video_transform_without_resize_is_exact():
    clip = _frames(2, (2, 256, 320, 3))  # short side at the crop: no resize
    for views in (1, 3):
        want = jt.EvalVideoTransform(crop_size=256, num_views_per_clip=views)(clip.copy())
        got = tt.EvalVideoTransform(crop_size=256, num_views_per_clip=views)(clip)
        for g, w in zip(got, want):
            _close(g, w, exact=True)


VIDEO_CONFIGS = [
    dict(),
    dict(horizontal_flip=True),
    dict(horizontal_flip=True, motion_shift=True),
    dict(color_jitter_strength=0.4),
    dict(pad_frames=6, random_resize_scale=(0.5, 1.0)),
    dict(normalize=False),
]


@pytest.mark.parametrize("cfg", VIDEO_CONFIGS, ids=lambda c: ",".join(c) or "default")
@pytest.mark.parametrize("seed", [0, 7])
def test_video_transform_matches_jax(cfg, seed):
    clip = _frames(seed, (4, 240, 320, 3))
    want = jt.VideoTransform(crop_size=224, use_native=False, **cfg)(
        clip.copy(), np.random.default_rng(seed))
    got = tt.VideoTransform(crop_size=224, use_native=False, **cfg)(
        clip, np.random.default_rng(seed))
    _close(got, want)


def test_video_transform_float_clip_matches_jax():
    """A float clip in [0, 1] is not rescaled by 255 (JAX's jitter path)."""
    clip = np.random.RandomState(3).rand(3, 200, 260, 3).astype(np.float32)
    want = jt.VideoTransform(crop_size=128, use_native=False)(clip.copy(), np.random.default_rng(3))
    got = tt.VideoTransform(crop_size=128, use_native=False)(clip, np.random.default_rng(3))
    np.testing.assert_allclose(got, want, atol=1e-4 / float(jt.IMAGENET_STD.min()), rtol=0)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("shape", [(375, 500, 3), (500, 333, 3)])
def test_image_transform_matches_jax(train, shape):
    img = _frames(shape[0], shape)
    want = jt.ImageTransform(crop_size=224, train=train)(img.copy(), np.random.default_rng(5))
    got = tt.ImageTransform(crop_size=224, train=train)(img, np.random.default_rng(5))
    _close(got, want)


def test_image_transform_without_resize_is_exact():
    img = _frames(9, (256, 300, 3))  # short side at 224 * 256 / 224
    want = jt.ImageTransform(crop_size=224)(img.copy())
    got = tt.ImageTransform(crop_size=224)(img)
    _close(got, want, exact=True)


def test_padding_and_jitter_match_jax():
    clip = _frames(4, (3, 16, 16, 3))
    for n in (2, 3, 7):
        np.testing.assert_array_equal(tt.circulant_frame_padding(clip, n),
                                      jt.circulant_frame_padding(clip.copy(), n))
    for src in (clip, clip.astype(np.float32) / 255.0):
        want = jt.color_jitter(src.copy(), np.random.default_rng(1))
        got = tt.color_jitter(src, np.random.default_rng(1))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("crop, shape", [(256, (2, 480, 640, 3)), (384, (2, 300, 200, 3)),
                                         (256, (2, 256, 256, 3))])
def test_preprocessor_matches_jax(crop, shape):
    clip = _frames(crop, shape)
    want = jpp.vjepa2_preprocessor(crop_size=crop)(clip.copy())
    pre = tpp.vjepa2_preprocessor(crop_size=crop)
    got = pre(clip)
    assert got.shape == (shape[0], crop, crop, 3) and pre.crop_size == crop
    _close(got, want, exact=shape[1:3] == (crop, crop))
    np.testing.assert_array_equal(tt.IMAGENET_MEAN, jt.IMAGENET_MEAN)
    np.testing.assert_array_equal(tt.IMAGENET_STD, jt.IMAGENET_STD)


def test_port_transforms_import_no_cv2():
    """The port's transforms and preprocessor stand on numpy alone."""
    import subprocess
    import sys

    code = ("import sys; import vjepa2_tpu_torch.hub.preprocessor, "
            "vjepa2_tpu_torch.data.transforms; print('cv2' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "False"
