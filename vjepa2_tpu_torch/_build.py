"""Build the port's CUDA kernels with nvcc at first use and load them with ctypes.

Every ``csrc/*.cu`` file is compiled to an object by its own ``nvcc``, all
started together, and the objects are linked into one shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), for Hopper
only (``sm_90a``). The library lands in ``build/vjepa2_tpu_torch/`` under the
repository root, named by a hash of the sources (``*.cu`` and ``*.cuh``) and
flags, so an edited kernel is rebuilt and an unchanged one is reused. A
missing ``nvcc`` or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "vjepa2_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the port's CUDA "
        "kernels are built from source and need the CUDA toolkit")


def _sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvjepa2_kernels_{h.hexdigest()[:16]}.so"


def build_log() -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) for
    the current library, or '' if it was not built yet."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            _compile_and_link(so)
        _lib = ctypes.CDLL(str(so))
        _lib.vjepa2_cuda_error_string.argtypes = [ctypes.c_int]
        _lib.vjepa2_cuda_error_string.restype = ctypes.c_char_p
        return _lib


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands in parallel; return their outputs or raise on the
    first failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out[-4000:]}")
    return outs


def _compile_and_link(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    tmp = so.with_name(f"{tag}.tmp.so")
    try:
        logs = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                         for src, obj in zip(_sources(), objs)])
        logs += _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
        so.with_suffix(".log").write_text("".join(logs))
        os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.vjepa2_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


LOG2E = 1.4426950408889634  # 1 / ln 2: the kernels fold scale*log2(e) into q

_fns: dict = {}


def function(name: str, argtypes: list, restype=ctypes.c_int):
    """(library, the C function ``name`` with its argtypes and restype set)."""
    if name not in _fns:
        lib = load()
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
        _fns[name] = (lib, fn)
    return _fns[name]


def launcher_argtypes(n_ptrs: int, n_ints: int, n_floats: int) -> list:
    """Pointers, ints, the strides array, floats, then the stream."""
    return ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
            + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_float] * n_floats
            + [ctypes.c_void_p])


def ptr(t):
    """A tensor's device address for a kernel argument (None for no tensor; an
    int is an address already)."""
    return t if t is None or isinstance(t, int) else t.data_ptr()
