"""ctypes bindings of the native C++ decode sidecar (``loader.cc``).

Port of ``unflow_tpu/data/native``: the same C functions, the same Python
ones (``available``, ``png_shape``, ``decode_rgb``, ``decode_kitti_flow``,
``decode_rgb_batch``). The library is built with g++ at first use into
``unflow_tpu_torch/_build/libunflow_loader-<hash>.so`` (the hash covers the
source and the flags, so an edited source is rebuilt), without
``-march=native``, so a build directory copied to another machine stays
loadable. ``data/io.py`` decodes through it when ``UNFLOW_NATIVE=1``; a
build that fails then raises :class:`NativeCompileError` with the compiler's
output. The PIL / numpy codecs of ``data/io.py`` are its reference: the
outputs are bit-identical.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).with_name("loader.cc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
FLAGS = ("-O3", "-funroll-loops", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_lib: ctypes.CDLL | None = None


class NativeCompileError(RuntimeError):
    """g++ could not build ``loader.cc``; the message holds its output."""


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode())
    return BUILD_DIR / f"libunflow_loader-{digest.hexdigest()[:16]}.so"


def build(compiler: str = "g++") -> Path:
    """Compile the sidecar unless it is built; returns the library's path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [compiler, *FLAGS, str(SOURCE), "-lz", "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeCompileError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeCompileError(f"{' '.join(cmd)} exited {proc.returncode}:\n"
                                 f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed (raises
    :class:`NativeCompileError` if it cannot be built)."""
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        c_int_p = ctypes.POINTER(ctypes.c_int)
        c_float_p = ctypes.POINTER(ctypes.c_float)
        lib.unflow_png_shape.argtypes = [ctypes.c_char_p] + [c_int_p] * 4
        lib.unflow_decode_rgb.argtypes = [ctypes.c_char_p, c_float_p, ctypes.c_int, ctypes.c_int]
        lib.unflow_decode_kitti_flow.argtypes = [
            ctypes.c_char_p, c_float_p, c_float_p, ctypes.c_int, ctypes.c_int]
        lib.unflow_decode_rgb_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, c_float_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        for fn in (lib.unflow_png_shape, lib.unflow_decode_rgb, lib.unflow_decode_kitti_flow,
                   lib.unflow_decode_rgb_batch):
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def available() -> bool:
    """True if the sidecar builds and loads here."""
    try:
        load()
    except (NativeCompileError, OSError):
        return False
    return True


def _floats(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def png_shape(path: str | Path) -> tuple[int, int, int, int]:
    """(height, width, channels, bit depth) from the PNG's header."""
    h, w, c, b = (ctypes.c_int() for _ in range(4))
    rc = load().unflow_png_shape(str(path).encode(), h, w, c, b)
    if rc:
        raise ValueError(f"native png_shape failed ({rc}): {path}")
    return h.value, w.value, c.value, b.value


def decode_rgb(path: str | Path) -> np.ndarray:
    """Decode an 8-bit PNG to float32 RGB in [0, 1], (H, W, 3)."""
    h, w, _, depth = png_shape(path)
    if depth != 8:
        raise ValueError(f"{path}: 16-bit image; use decode_kitti_flow")
    out = np.empty((h, w, 3), np.float32)
    rc = load().unflow_decode_rgb(str(path).encode(), _floats(out), h, w)
    if rc:
        raise ValueError(f"native decode_rgb failed ({rc}): {path}")
    return out


def decode_kitti_flow(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """KITTI 16-bit flow PNG -> ((H, W, 2) flow, (H, W, 1) valid)."""
    h, w, _, depth = png_shape(path)
    if depth != 16:
        raise ValueError(f"{path}: not a 16-bit PNG")
    flow = np.empty((h, w, 2), np.float32)
    valid = np.empty((h, w, 1), np.float32)
    rc = load().unflow_decode_kitti_flow(str(path).encode(), _floats(flow), _floats(valid), h, w)
    if rc:
        raise ValueError(f"native decode_kitti_flow failed ({rc}): {path}")
    return flow, valid


def decode_rgb_batch(paths: list[str], h: int, w: int, num_threads: int = 0) -> np.ndarray:
    """Decode same-sized 8-bit PNGs on ``num_threads`` C++ threads (0: one
    per core) -> (N, H, W, 3) float32, without the GIL."""
    n = len(paths)
    out = np.empty((n, h, w, 3), np.float32)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    rc = load().unflow_decode_rgb_batch(arr, n, _floats(out), h, w, num_threads)
    if rc:
        raise ValueError(f"native batch decode failed ({rc})")
    return out
