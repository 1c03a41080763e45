"""The port's `VideoReader` (`vjepa2_tpu_torch/data/video.py`) against the JAX
package's on videos written with cv2: the cv2 backend's frames bit-equal to
JAX's ``VideoReader(backend="cv2")`` at sorted, unsorted, repeated and
past-the-end indices, ``len`` and ``avg_fps`` equal; the native libav
decoder (built by the port's g++ step where the libav headers exist, as
`native/build.sh` builds JAX's) bit-equal to JAX's; the automatic choice in
JAX's order; and no silent fallback: with no backend, or a named backend
that cannot load, `VideoReadError`."""

from pathlib import Path

import numpy as np
import pytest

from vjepa2_tpu.data import native as jnative
from vjepa2_tpu.data import video as jvideo
from vjepa2_tpu_torch.data import native
from vjepa2_tpu_torch.data import video

cv2 = pytest.importorskip("cv2", reason="the test videos are written with cv2")

INDICES = [[0, 1, 2, 3], [9, 2, 2, 30, 17], [0, 40, 41, 47], [46, 47, 60, 75]]


def write_video(path: Path, frames: int, h: int, w: int, seed: int, fps: float = 30.0) -> str:
    """An mp4v video of a moving noise pattern (cv2 writes BGR; the pattern
    is random, so the channel order does not matter)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for t in range(frames):
        out.write(np.roll(base, 3 * t, axis=1))
    out.release()
    return str(path)


@pytest.fixture(scope="module")
def mp4(tmp_path_factory) -> str:
    """64 px wide: an RGB row of 192 bytes, a multiple of 16 (see
    `test_native_decoder_row_spill`)."""
    return write_video(tmp_path_factory.mktemp("video") / "a.mp4", 48, 40, 64, seed=0,
                       fps=25.0)


@pytest.fixture(scope="module")
def mp4_56(tmp_path_factory) -> str:
    """56 px wide: an RGB row of 168 bytes."""
    return write_video(tmp_path_factory.mktemp("video56") / "b.mp4", 48, 40, 56, seed=1)


@pytest.mark.parametrize("idx", INDICES, ids=lambda i: "-".join(map(str, i)))
def test_cv2_backend_matches_jax(mp4, idx):
    got, want = video.VideoReader(mp4, backend="cv2"), jvideo.VideoReader(mp4, backend="cv2")
    assert got.backend == want.backend == "cv2"
    assert len(got) == len(want) == 48 and got.avg_fps == want.avg_fps == 25.0
    np.testing.assert_array_equal(got.get_batch(idx), want.get_batch(idx))


needs_libav = pytest.mark.skipif(
    native.libav_headers() is None,
    reason="no libav headers on this host: the native decoder is not built (native/build.sh "
           "skips it too)")


@needs_libav
@pytest.mark.parametrize("idx", INDICES, ids=lambda i: "-".join(map(str, i)))
def test_native_decoder_matches_jax(mp4, idx):
    assert native.decoder_available() and jnative.decoder_available()
    got = video.VideoReader(mp4, backend="native")
    want = jvideo.VideoReader(mp4, backend="native")
    assert len(got) == len(want) and got.avg_fps == want.avg_fps
    np.testing.assert_array_equal(got.get_batch(idx), want.get_batch(idx))


JAX_SPILL = """
import sys
from vjepa2_tpu.data import video
r = video.VideoReader(sys.argv[1], backend="native")
for idx in ([9, 2, 2, 30, 17], [0, 1, 2, 3], [46, 47, 60, 75]):
    r.get_batch(idx)
print("survived")
"""


@needs_libav
def test_native_decoder_row_spill(mp4_56):
    """swscale's vector code writes past the end of an RGB row that is not a
    multiple of 16 bytes. JAX's decoder hands it an exact-size buffer, and
    the spill after the last frame lands on the heap: at 56 px the process
    aborts (run apart here; ROADMAP queue C). The port asks for each frame
    once, in ascending order, into a padded buffer: every batch, in any
    order and with repeats, equals the frames decoded one at a time."""
    import subprocess
    import sys

    res = subprocess.run([sys.executable, "-c", JAX_SPILL, mp4_56], capture_output=True,
                         text=True, timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert res.returncode != 0 and "survived" not in res.stdout, res.stdout + res.stderr
    r = video.VideoReader(mp4_56, backend="native")
    one = {i: r.get_batch([i])[0] for i in range(len(r))}
    for idx in INDICES:
        got = r.get_batch(idx)
        np.testing.assert_array_equal(got, np.stack([one[min(i, len(r) - 1)] for i in idx]))
    with pytest.raises(ValueError, match="indices >= 0"):
        r._native.get_batch([3, -1])


def test_automatic_choice_in_jax_order(mp4):
    order = video.available_backends()
    assert order[0] == ("native" if native.decoder_available() else "cv2")
    assert video.VideoReader(mp4).backend == order[0] == jvideo.VideoReader(mp4).backend


def test_no_backend_raises(mp4, monkeypatch):
    monkeypatch.setattr(video, "available_backends", lambda: [])
    with pytest.raises(video.VideoReadError, match="no video decode backend"):
        video.VideoReader(mp4)


def test_a_named_backend_that_cannot_load_raises(mp4, monkeypatch):
    monkeypatch.setattr(native, "_VDLIB", None)
    monkeypatch.setattr(native, "_VD_ERROR", None)
    monkeypatch.setattr(native, "libav_headers", lambda: None)
    with pytest.raises(video.VideoReadError, match="libav headers"):
        video.VideoReader(mp4, backend="native")
    monkeypatch.setattr(video, "_cv2", lambda: None)
    with pytest.raises(video.VideoReadError, match="cv2 package"):
        video.VideoReader(mp4, backend="cv2")


def test_missing_file_raises(tmp_path):
    with pytest.raises(video.VideoReadError, match="not found"):
        video.VideoReader(str(tmp_path / "nope.mp4"))
