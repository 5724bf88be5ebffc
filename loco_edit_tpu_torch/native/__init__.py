"""Native (C++) host-side image pipeline with ctypes bindings (port of
loco_edit_tpu/native/__init__.py, with its own copy of imagepipe.cpp).

Built by g++ at first use into the build directory (core/cache.py::build_dir,
by default loco_edit_tpu_torch/_build/ in a checkout; named by a hash of the
source, so an edited source is rebuilt), not beside the source.
training/data.py decodes with PIL when the library cannot build (no
toolchain or codecs). See imagepipe.cpp for what it implements.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from loco_edit_tpu_torch.core.cache import build_dir

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "imagepipe.cpp")

_lib = None
_build_error: str | None = None


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(build_dir(), f"libimagepipe-{digest}.so")


def _build(so: str) -> str | None:
    if os.path.exists(so):
        return None
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC,
           "-o", tmp, "-ljpeg", "-lpng", "-lpthread"]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return str(e)
    if r.returncode:
        return r.stderr
    os.replace(tmp, so)
    return None


def get_lib():
    """The loaded native library, or None (the reason in _build_error)."""
    global _lib, _build_error
    if _lib is not None:
        return _lib
    if _build_error is not None:
        return None
    so = _so_path()
    err = _build(so)
    if err:
        _build_error = err
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError as e:
        _build_error = str(e)
        return None
    lib.ip_decode.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.ip_decode.restype = ctypes.c_int
    lib.ip_load_batch.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    lib.ip_load_batch.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def decode_image(path: str, max_side: int = 8192) -> np.ndarray:
    """Decode a JPEG/PNG to uint8 RGB (H, W, 3)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native pipeline unavailable: {_build_error}")
    buf = np.empty((max_side * max_side * 3,), np.uint8)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.ip_decode(path.encode(), buf.ctypes.data_as(
        ctypes.POINTER(ctypes.c_uint8)), buf.size, ctypes.byref(w),
        ctypes.byref(h))
    if rc:
        raise IOError(f"decode failed (rc={rc}) for {path}")
    return buf[:h.value * w.value * 3].reshape(h.value, w.value, 3).copy()


def load_batch(paths: list[str], size: int, n_threads: int = 0) -> np.ndarray:
    """Decode, resize and normalize a batch -> (N, size, size, 3) f32 in
    [-1, 1]."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native pipeline unavailable: {_build_error}")
    out = np.empty((len(paths), size, size, 3), np.float32)
    joined = b"\0".join(p.encode() for p in paths) + b"\0"
    failed = lib.ip_load_batch(joined, len(paths), size,
                               out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                               n_threads)
    if failed:
        raise IOError(f"{failed}/{len(paths)} images failed to decode")
    return out
