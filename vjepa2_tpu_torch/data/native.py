"""ctypes bindings for the repository's native host ops (counterpart of
`vjepa2_tpu/data/native.py`): `native/host_ops.cpp` (the fused crop, bilinear
resize and normalise of a clip's frames, threaded across frames) and
`native/video_decode.cpp` (a random-access libav decoder).

Each library is built from the repository's source with ``g++`` at first use
into ``build/vjepa2_tpu_torch/`` (beside the CUDA kernels' library), named by
a hash of its source and flags, so an edited source is rebuilt. Loader
workers are spawned processes that may all reach the first use at once: the
compile holds a file lock and publishes with ``os.replace`` from a
per-process temporary file, so no process ever loads a half-written library.
``available()`` / ``decoder_available()`` say whether a library could be
built and loaded; the calls raise `NativeBuildError` where it could not
(no ``g++``, a failed compile, or for the decoder no libav headers), with the
reason. The decoder is built only where the libav headers exist (the paths
`native/build.sh` checks).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
NATIVE_SRC = ROOT / "native"
BUILD_DIR = ROOT / "build" / "vjepa2_tpu_torch"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
LIBAV_LINK = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale")
LIBAV_HEADERS = ("/usr/include/x86_64-linux-gnu/libavcodec/avcodec.h",
                 "/usr/include/libavcodec/avcodec.h")


class NativeBuildError(RuntimeError):
    pass


def library_path(src_name: str, extra_link=()) -> Path:
    """Where the library built from ``native/<src_name>`` with these flags lives."""
    h = hashlib.sha256(" ".join((*GXX_FLAGS, *extra_link)).encode())
    h.update((NATIVE_SRC / src_name).read_bytes())
    return BUILD_DIR / f"lib{Path(src_name).stem}_{h.hexdigest()[:16]}.so"


def build_library(src_name: str, extra_link=()) -> Path:
    """Compile ``native/<src_name>`` once per source hash (see the module
    docstring); raises `NativeBuildError` with the reason."""
    src = NATIVE_SRC / src_name
    if not src.exists():
        raise NativeBuildError(f"native source {src} not found")
    out = library_path(src_name, extra_link)
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise NativeBuildError(f"g++ not found on PATH: cannot build {src_name}")
    import fcntl

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(f"{out}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # a sibling built it while this process waited
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        try:
            res = subprocess.run([gxx, *GXX_FLAGS, str(src), *extra_link, "-o", tmp],
                                 capture_output=True, text=True, timeout=300)
            if res.returncode != 0:
                raise NativeBuildError(f"g++ failed on {src_name}:\n{res.stderr[-4000:]}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return out


# -- host ops (`native/host_ops.cpp`) ---------------------------------------

_LIB: Optional[ctypes.CDLL] = None
_LIB_ERROR: Optional[str] = None


def load() -> ctypes.CDLL:
    """The host-ops library, built at first use; raises `NativeBuildError`."""
    global _LIB, _LIB_ERROR
    if _LIB is not None:
        return _LIB
    if _LIB_ERROR is not None:
        raise NativeBuildError(_LIB_ERROR)
    try:
        lib = ctypes.CDLL(str(build_library("host_ops.cpp")))
    except (NativeBuildError, OSError, subprocess.SubprocessError) as e:
        _LIB_ERROR = f"native host ops unavailable: {e}"
        raise NativeBuildError(_LIB_ERROR) from e
    u8p, f32p, i32p = (ctypes.POINTER(t) for t in (ctypes.c_uint8, ctypes.c_float, ctypes.c_int))
    box = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p, i32p, i32p, i32p]
    lib.crop_resize_normalize_clip.argtypes = [
        *box, f32p, ctypes.c_int, ctypes.c_int, f32p, f32p, ctypes.c_int, ctypes.c_int]
    lib.crop_resize_u8_clip.argtypes = [
        *box, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.normalize_clip.argtypes = [u8p, f32p, ctypes.c_int64, f32p, f32p, ctypes.c_int]
    _LIB = lib
    return lib


def available() -> bool:
    try:
        load()
    except NativeBuildError:
        return False
    return True


def supports_u8() -> bool:
    """The repository's source always has the uint8 crop (JAX's check is for
    an older prebuilt library), so this is `available()`."""
    return available()


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _boxes(clip: np.ndarray, tops, lefts, chs, cws):
    """The crop boxes as int32 arrays, one box a frame, each inside the frame
    (the library reads the rows and columns it is given)."""
    T, H, W, _ = clip.shape
    boxes = tuple(np.ascontiguousarray(a, np.int32).reshape(-1) for a in (tops, lefts, chs, cws))
    top, left, ch, cw = boxes
    if any(b.size != T for b in boxes) or (top < 0).any() or (left < 0).any() \
            or (ch < 1).any() or (cw < 1).any() or (top + ch > H).any() or (left + cw > W).any():
        raise ValueError(f"crop boxes must give one box a frame inside [{H}, {W}] for {T} frames")
    return boxes


def _clip_arg(clip: np.ndarray) -> np.ndarray:
    clip = np.ascontiguousarray(clip)
    if clip.dtype != np.uint8 or clip.ndim != 4 or clip.shape[-1] != 3:
        raise ValueError(f"want a uint8 clip [T, H, W, 3], got {clip.dtype} {clip.shape}")
    return clip


def crop_resize_normalize_clip(clip: np.ndarray, tops, lefts, chs, cws, out_size: int,
                               mean: np.ndarray, std: np.ndarray, hflip: bool = False,
                               num_threads: int = 4) -> np.ndarray:
    """clip [T, H, W, 3] uint8 and a crop box a frame -> [T, S, S, 3] float32,
    (x / 255 - mean) / std."""
    lib = load()
    clip = _clip_arg(clip)
    T, H, W, _ = clip.shape
    out = np.empty((T, out_size, out_size, 3), np.float32)
    boxes = _boxes(clip, tops, lefts, chs, cws)
    mean, std = (np.ascontiguousarray(a, np.float32) for a in (mean, std))
    lib.crop_resize_normalize_clip(
        _ptr(clip, ctypes.c_uint8), T, H, W, *(_ptr(b, ctypes.c_int) for b in boxes),
        _ptr(out, ctypes.c_float), out_size, out_size,
        _ptr(mean, ctypes.c_float), _ptr(std, ctypes.c_float), int(hflip), num_threads)
    return out


def crop_resize_clip_u8(clip: np.ndarray, tops, lefts, chs, cws, out_size: int,
                        hflip: bool = False, num_threads: int = 4) -> np.ndarray:
    """clip [T, H, W, 3] uint8 -> [T, S, S, 3] uint8 (crop and resize only:
    the train step normalises on the card, `VideoTransform(normalize_on_device)`)."""
    lib = load()
    clip = _clip_arg(clip)
    T, H, W, _ = clip.shape
    out = np.empty((T, out_size, out_size, 3), np.uint8)
    boxes = _boxes(clip, tops, lefts, chs, cws)
    lib.crop_resize_u8_clip(
        _ptr(clip, ctypes.c_uint8), T, H, W, *(_ptr(b, ctypes.c_int) for b in boxes),
        _ptr(out, ctypes.c_uint8), out_size, out_size, int(hflip), num_threads)
    return out


def normalize_clip(clip: np.ndarray, mean: np.ndarray, std: np.ndarray,
                   num_threads: int = 4) -> np.ndarray:
    """[..., 3] uint8 -> float32 (x / 255 - mean) / std."""
    lib = load()
    clip = np.ascontiguousarray(clip)
    if clip.dtype != np.uint8 or clip.shape[-1] != 3:
        raise ValueError(f"want uint8 [..., 3], got {clip.dtype} {clip.shape}")
    out = np.empty(clip.shape, np.float32)
    lib.normalize_clip(
        _ptr(clip, ctypes.c_uint8), _ptr(out, ctypes.c_float), int(np.prod(clip.shape[:-1])),
        _ptr(np.ascontiguousarray(mean, np.float32), ctypes.c_float),
        _ptr(np.ascontiguousarray(std, np.float32), ctypes.c_float), num_threads)
    return out


# -- the video decoder (`native/video_decode.cpp`, libav) ---------------------

_VDLIB: Optional[ctypes.CDLL] = None
_VD_ERROR: Optional[str] = None


def libav_headers() -> Optional[str]:
    """The first libav header `native/build.sh` looks for that exists, or None."""
    return next((p for p in LIBAV_HEADERS if os.path.exists(p)), None)


def load_decoder() -> ctypes.CDLL:
    """The decoder library, built at first use where the libav headers
    exist; raises `NativeBuildError` with the reason."""
    global _VDLIB, _VD_ERROR
    if _VDLIB is not None:
        return _VDLIB
    if _VD_ERROR is None and libav_headers() is None:
        _VD_ERROR = (f"no libav headers ({' or '.join(LIBAV_HEADERS)}): the native decoder "
                     "is not built")
    if _VD_ERROR is not None:
        raise NativeBuildError(_VD_ERROR)
    try:
        lib = ctypes.CDLL(str(build_library("video_decode.cpp", LIBAV_LINK)))
    except (NativeBuildError, OSError, subprocess.SubprocessError) as e:
        _VD_ERROR = f"native video decoder unavailable: {e}"
        raise NativeBuildError(_VD_ERROR) from e
    vp = ctypes.c_void_p
    lib.vd_open.restype, lib.vd_open.argtypes = vp, [ctypes.c_char_p, ctypes.c_int]
    lib.vd_close.argtypes = [vp]
    for name, rt in (("vd_num_frames", ctypes.c_int64), ("vd_fps", ctypes.c_double),
                     ("vd_width", ctypes.c_int), ("vd_height", ctypes.c_int)):
        getattr(lib, name).restype = rt
        getattr(lib, name).argtypes = [vp]
    lib.vd_get_batch.restype = ctypes.c_int
    lib.vd_get_batch.argtypes = [vp, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_uint8)]
    lib.vd_last_error.restype = ctypes.c_char_p
    _VDLIB = lib
    return lib


def decoder_available() -> bool:
    try:
        load_decoder()
    except NativeBuildError:
        return False
    return True


class NativeVideoDecoder:
    """Random-access libav decoder; ``get_batch`` mirrors decord's.
    ``nthreads``: libavcodec's decode threads (0: its choice); the loader's
    workers already decode clips in parallel."""

    def __init__(self, path: str, nthreads: int = 0):
        lib = load_decoder()
        self._lib = lib
        self._ctx = lib.vd_open(path.encode(), int(nthreads))
        if not self._ctx:
            raise RuntimeError(f"vd_open failed: {self._error()}")
        self.path = path
        self.width = lib.vd_width(self._ctx)
        self.height = lib.vd_height(self._ctx)
        self.fps = lib.vd_fps(self._ctx)
        self.num_frames = int(lib.vd_num_frames(self._ctx))

    def _error(self) -> str:
        return self._lib.vd_last_error().decode(errors="replace")

    def get_batch(self, indices) -> np.ndarray:
        """uint8 [len(indices), H, W, 3]. The library converts each frame
        with swscale's vector code, which can write past the end of an RGB
        row that is not a multiple of 16 bytes: frames are asked for once
        each in ascending order (the next frame then overwrites what spilled
        into it) into a buffer with a spare row and more after the last
        (ROADMAP queue C: JAX's exact-size buffer takes the spill on the
        heap)."""
        want = np.asarray(indices, np.int64).reshape(-1)
        if want.size == 0 or (want < 0).any():
            raise ValueError(f"want frame indices >= 0, got {want.tolist()}")
        uniq, inverse = np.unique(want, return_inverse=True)
        frame = self.height * self.width * 3
        buf = np.empty(uniq.size * frame + 3 * self.width + 256, np.uint8)
        ret = self._lib.vd_get_batch(self._ctx, _ptr(np.ascontiguousarray(uniq), ctypes.c_int64),
                                     int(uniq.size), _ptr(buf, ctypes.c_uint8))
        if ret != 0:
            raise RuntimeError(f"vd_get_batch failed ({ret}): {self._error()}")
        frames = buf[:uniq.size * frame].reshape(uniq.size, self.height, self.width, 3)
        return frames[inverse]

    def close(self):
        if self._ctx:
            self._lib.vd_close(self._ctx)
            self._ctx = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
