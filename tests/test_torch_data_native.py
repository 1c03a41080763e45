"""The port's native host ops (`vjepa2_tpu_torch/data/native.py`, built by its
own g++ step from `native/host_ops.cpp`) against the JAX package's
`vjepa2_tpu.data.native` and against a numpy statement of the same float32
arithmetic, on the same crops: uint8 and float outputs bit-equal, with
per-frame boxes (motion shift), a flip and boxes at the frame's edges. Also:
the build is hash-named under ``build/vjepa2_tpu_torch/`` and safe under
concurrent processes, ``use_native=True`` raises where g++ cannot build, and
`core.monitoring` samples a process without psutil."""

import importlib
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from vjepa2_tpu.data import native as jnative
from vjepa2_tpu.data import transforms as jt
from vjepa2_tpu_torch.data import native
from vjepa2_tpu_torch.data import transforms as tt

ROOT = Path(__file__).resolve().parents[1]
F32 = np.float32


def _clip(seed, shape=(5, 61, 83, 3)):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _reference(clip, boxes, S, hflip, mean=None, std=None):
    """host_ops.cpp's crop_resize_frame in numpy float32, step for step:
    half-pixel centres, truncation towards zero, the edge clamps, then the
    normalise ``(v * (1/255) - mean) * (1/std)`` or the uint8 rounding
    ``(uint8) clamp(v + 0.5)``."""
    out = []
    for t, frame in enumerate(clip):
        top, left, ch, cw = (int(b[t]) for b in boxes)

        def taps(n_in):
            s = F32(n_in) / F32(S)
            f = (np.arange(S, dtype=F32) + F32(0.5)) * s - F32(0.5)
            i0 = f.astype(np.int64)
            neg = f < 0
            f[neg], i0[neg] = F32(0), 0
            return np.minimum(i0, n_in - 1), np.minimum(i0 + 1, n_in - 1), (f - i0.astype(F32))

        y0, y1, wy = taps(ch)
        x0, x1, wx = taps(cw)
        crop = frame[top:top + ch, left:left + cw].astype(F32)
        wx, wy = wx[None, :, None], wy[:, None, None]
        r0, r1 = crop[y0], crop[y1]
        v = ((r0[:, x0] * (F32(1) - wx) + r0[:, x1] * wx) * (F32(1) - wy)
             + (r1[:, x0] * (F32(1) - wx) + r1[:, x1] * wx) * wy)
        if hflip:
            v = v[:, ::-1]
        if mean is None:
            out.append(np.clip(v + F32(0.5), 0, 255).astype(np.uint8))
        else:
            inv255, inv_std = F32(1) / F32(255), F32(1) / std.astype(F32)
            out.append((v * inv255 - mean.astype(F32)) * inv_std)
    return np.stack(out)


BOXES = {
    "fixed": lambda T: tuple(np.full(T, v, np.int32) for v in (7, 11, 40, 52)),
    "motion": lambda T: tuple(np.linspace(a, b, T).astype(np.int32)
                              for a, b in ((0, 20), (30, 5), (41, 38), (53, 70))),
    "whole": lambda T: tuple(np.full(T, v, np.int32) for v in (0, 0, 61, 83)),
    "upscale": lambda T: tuple(np.full(T, v, np.int32) for v in (50, 70, 11, 13)),
}


@pytest.mark.parametrize("boxes", sorted(BOXES))
@pytest.mark.parametrize("hflip", [False, True])
@pytest.mark.parametrize("u8", [False, True], ids=["float", "uint8"])
def test_crop_resize_matches_jax_and_numpy(boxes, hflip, u8):
    clip = _clip(len(boxes) + 3 * hflip)
    b = BOXES[boxes](clip.shape[0])
    if u8:
        got = native.crop_resize_clip_u8(clip, *b, 32, hflip=hflip, num_threads=3)
        want = jnative.crop_resize_clip_u8(clip, *b, 32, hflip=hflip, num_threads=3)
        ref = _reference(clip, b, 32, hflip)
    else:
        mean, std = jt.IMAGENET_MEAN, jt.IMAGENET_STD
        got = native.crop_resize_normalize_clip(clip, *b, 32, mean, std, hflip=hflip)
        want = jnative.crop_resize_normalize_clip(clip, *b, 32, mean, std, hflip=hflip)
        ref = _reference(clip, b, 32, hflip, mean, std)
    assert got.dtype == want.dtype == ref.dtype and got.shape == (clip.shape[0], 32, 32, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)


def test_normalize_clip_matches_jax():
    clip = _clip(9, (3, 17, 19, 3))
    got = native.normalize_clip(clip, jt.IMAGENET_MEAN, jt.IMAGENET_STD, num_threads=2)
    np.testing.assert_array_equal(got, jnative.normalize_clip(clip, jt.IMAGENET_MEAN,
                                                              jt.IMAGENET_STD))
    inv255, inv_std = F32(1) / F32(255), F32(1) / jt.IMAGENET_STD
    np.testing.assert_array_equal(got, (clip.astype(F32) * inv255 - jt.IMAGENET_MEAN) * inv_std)


def test_the_library_is_built_from_the_repository_source():
    path = native.library_path("host_ops.cpp")
    assert native.available() and native.supports_u8() and path.exists()
    assert path.parent == ROOT / "build" / "vjepa2_tpu_torch"
    assert native._LIB._name == str(path)


BUILD_PROBE = """
import sys
from pathlib import Path
from vjepa2_tpu_torch.data import native
native.BUILD_DIR = Path(sys.argv[1])
native.library_path = (lambda f: lambda *a: native.BUILD_DIR / f(*a).name)(native.library_path)
native.load()
print(native._LIB._name)
"""


def test_concurrent_processes_build_once(tmp_path):
    """Three processes reaching the first use together: one compiles under
    the lock, the others wait and load its published library."""
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_PROBE, str(tmp_path)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    names = {o.strip() for o, _ in outs}
    assert len(names) == 1 and Path(names.pop()).exists()
    assert not list(tmp_path.glob("*.tmp"))


def test_use_native_raises_where_gxx_cannot_build(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_LIB_ERROR", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "library_path", lambda *a: tmp_path / "libhost_ops_x.so")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(native.NativeBuildError, match="g\\+\\+ not found"):
        tt.VideoTransform(crop_size=32, use_native=True)
    # the auto choice takes the numpy path there, as JAX's does
    assert tt.VideoTransform(crop_size=32).use_native is False


def test_resource_monitor_without_psutil(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "psutil", None)  # importing psutil now fails
    from vjepa2_tpu_torch.core import monitoring

    monitoring = importlib.reload(monitoring)
    out = tmp_path / "mon" / "worker_0.csv"
    th = monitoring.ResourceMonitoringThread(str(out), interval=0.05)
    th.start()
    sum(i * i for i in range(2_000_000))  # some CPU time to sample
    deadline = time.monotonic() + 30
    while len(out.read_text().splitlines()) < 4 and time.monotonic() < deadline:
        time.sleep(0.05)
    th.stop()
    th.join(timeout=10)
    assert not th.is_alive()
    rows = out.read_text().splitlines()
    assert rows[0] == "ts,cpu_percent,rss_mb,read_mb,write_mb,ctx_switches" and len(rows) >= 3
    vals = [list(map(float, r.split(","))) for r in rows[1:]]
    assert all(v[2] > 1.0 and v[5] >= 1 for v in vals)  # resident MB, context switches
    snap = th.snapshot()
    assert snap.rss_mb > 1.0 and snap.cpu_percent >= 0.0


@pytest.mark.parametrize("box", [(-1, 0, 10, 10), (0, 0, 62, 10), (0, 80, 10, 4), (0, 0, 0, 5)])
def test_crop_boxes_outside_the_frame_raise(box):
    """The library reads the rows and columns it is given: a box outside the
    frame (or one box short) is refused before the call."""
    clip = _clip(1)
    boxes = tuple(np.full(clip.shape[0], v, np.int32) for v in box)
    with pytest.raises(ValueError, match="crop boxes"):
        native.crop_resize_clip_u8(clip, *boxes, 16)
    short = tuple(b[:-1] for b in BOXES["fixed"](clip.shape[0]))
    with pytest.raises(ValueError, match="crop boxes"):
        native.crop_resize_normalize_clip(clip, *short, 16, jt.IMAGENET_MEAN, jt.IMAGENET_STD)


def test_trace_writes_a_chrome_trace(tmp_path):
    """`core.monitoring.start_trace` / `stop_trace` (JAX's names) on
    `torch.profiler`: the trace of a few host ops lands in the directory."""
    import json

    import torch

    from vjepa2_tpu_torch.core import monitoring

    monitoring.start_trace(str(tmp_path / "trace"))
    torch.ones(64, 64) @ torch.ones(64, 64)
    path = monitoring.stop_trace()
    assert path.startswith(str(tmp_path / "trace"))
    with open(path) as f:
        assert json.load(f)["traceEvents"]
