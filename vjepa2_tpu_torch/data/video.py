"""Video decoding on the host (counterpart of `vjepa2_tpu/data/video.py`),
and the synthetic clips of tests and benchmarks.

`VideoReader` decodes frames by index with one of three backends: the native
libav decoder (`native/video_decode.cpp`, `data.native`), OpenCV's
``VideoCapture``, or imageio. With no backend named it takes them in that
order, as JAX's does, and a file the native decoder cannot open falls back to
cv2, else imageio. cv2 and imageio are imported at first use; with none of
the three, `VideoReader` raises `VideoReadError`. Every backend returns uint8
[T, H, W, 3] RGB.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


# the farthest a wanted frame is decoded through to, rather than sought
# (`native/video_decode.cpp` kSeekGapFrames)
SEEK_GAP_FRAMES = 256


class VideoReadError(RuntimeError):
    pass


def _cv2():
    """cv2 (one thread: the loader's workers parallelise across clips), or None."""
    try:
        import cv2
    except ImportError:
        return None
    cv2.setNumThreads(0)
    return cv2


def _iio():
    try:
        import imageio.v3 as iio
    except ImportError:
        return None
    return iio


def available_backends() -> list[str]:
    """The backends this host can decode with, in `VideoReader`'s order."""
    from vjepa2_tpu_torch.data import native

    return [name for name, ok in (("native", native.decoder_available), ("cv2", _cv2),
                                  ("imageio", _iio)) if ok()]


class VideoReader:
    """Random-access frame reader. ``get_batch(indices)`` mirrors decord."""

    def __init__(self, path: str, backend: Optional[str] = None):
        if not os.path.exists(path):
            raise VideoReadError(f"video path not found: {path}")
        self.path = path
        auto = backend is None
        if auto:
            backends = available_backends()
            if not backends:
                raise VideoReadError("no video decode backend available (native/cv2/imageio): "
                                     "the native decoder needs the libav headers, the others "
                                     "the cv2 or imageio package")
            backend = backends[0]
        if backend not in ("native", "cv2", "imageio"):
            raise VideoReadError(f"unknown video backend {backend!r}")
        self.backend = backend
        self._len = self._fps = self._native = None
        if backend == "native":
            self._init_native(path, auto)
        elif backend == "cv2":
            self._init_cv2(path)
        else:
            self._init_iio(path)

    def _init_native(self, path: str, auto: bool) -> None:
        from vjepa2_tpu_torch.data import native

        try:
            nat = native.NativeVideoDecoder(path)
        except native.NativeBuildError as e:
            raise VideoReadError(str(e)) from e
        except RuntimeError as e:
            err = str(e)
        else:
            if nat.num_frames > 0:
                self._native, self._len, self._fps = nat, nat.num_frames, nat.fps or 30.0
                return
            nat.close()
            err = f"native decoder reports no frames for {path}"
        # per-file fallback under auto selection: the system's libav can lack
        # a codec that cv2's or imageio's bundled ffmpeg has
        if auto and _cv2() is not None:
            self.backend = "cv2"
            self._init_cv2(path)
        elif auto and _iio() is not None:
            self.backend = "imageio"
            self._init_iio(path)
        else:
            raise VideoReadError(err)

    def _init_cv2(self, path: str) -> None:
        cv2 = _cv2()
        if cv2 is None:
            raise VideoReadError("the cv2 backend needs the cv2 package")
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise VideoReadError(f"cv2 failed to open {path}")
        self._len = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self._fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        cap.release()
        if self._len <= 0:
            raise VideoReadError(f"cv2 reports no frames for {path}")

    def _init_iio(self, path: str) -> None:
        iio = _iio()
        if iio is None:
            raise VideoReadError("the imageio backend needs the imageio package")
        meta = iio.immeta(path, plugin="pyav")
        self._fps = float(meta.get("fps", 30.0))
        self._len = int(meta.get("nframes") or 0)
        if self._len <= 0:  # count the frames (slow: files without the metadata)
            self._len = sum(1 for _ in iio.imiter(path))

    def __len__(self) -> int:
        return self._len

    @property
    def avg_fps(self) -> float:
        return self._fps

    def get_batch(self, indices: Sequence[int]) -> np.ndarray:
        indices = np.asarray(indices, dtype=np.int64)
        if self.backend == "native":
            try:
                return self._native.get_batch(indices)
            except RuntimeError as e:
                raise VideoReadError(str(e)) from e
        if self.backend == "cv2":
            return self._get_batch_cv2(indices)
        return self._get_batch_iio(indices)

    def _get_batch_cv2(self, indices: np.ndarray) -> np.ndarray:
        """Frames in ascending order; past the last decodable frame, that
        frame repeats. A wanted frame up to `SEEK_GAP_FRAMES` ahead is reached
        by decoding through (``grab``), a farther one by a seek, as the native
        decoder does (JAX seeks at every gap, and each seek decodes from a
        keyframe: on the H100 host it halved the loader's first batch,
        `PERF.md` §6 PR 20). The frames are the same wherever cv2's seek is
        exact."""
        cv2 = _cv2()
        cap = cv2.VideoCapture(self.path)
        try:
            frames: dict[int, np.ndarray] = {}
            pos = -1
            for want in np.unique(indices):
                want = int(want)
                if want - pos - 1 > SEEK_GAP_FRAMES:
                    cap.set(cv2.CAP_PROP_POS_FRAMES, want)
                else:
                    for _ in range(want - pos - 1):
                        cap.grab()
                ok, frame = cap.read()
                if ok:
                    frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                elif frames:
                    frame = frames[max(frames)]
                else:
                    raise VideoReadError(f"decode failure at frame {want} of {self.path}")
                frames[want] = frame
                pos = want
            return np.stack([frames[int(i)] for i in indices])
        finally:
            cap.release()

    def _get_batch_iio(self, indices: np.ndarray) -> np.ndarray:
        iio = _iio()
        want = {int(i) for i in indices}
        frames = {}
        for i, frame in enumerate(iio.imiter(self.path)):
            if i in want:
                frames[i] = np.asarray(frame)[..., :3]
            if len(frames) == len(want):
                break
        if not frames:
            raise VideoReadError(f"no frames decoded from {self.path}")
        last = frames[max(frames)]
        return np.stack([frames.get(int(i), last) for i in indices])


def synthetic_clip(num_frames: int, height: int, width: int, seed: int = 0) -> np.ndarray:
    """Deterministic moving-gradient clip for tests/benchmarks."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, size=(height, width, 3), dtype=np.uint8)
    frames = [np.roll(base, shift=3 * t, axis=1) for t in range(num_frames)]
    return np.stack(frames)
