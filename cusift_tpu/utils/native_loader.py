"""ctypes bindings for the native C++ frame loader (native/frameloader.cpp).

The reference's host runtime is C++ (SURVEY.md C3/C16); here the native
piece is the disk->float32 decode + prefetch pipeline that feeds the jitted
device programs.  The .so builds on demand with g++ (cached in native/build/)
and everything degrades gracefully to a NumPy/OpenCV fallback when a
compiler is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "frameloader.cpp")
_SO = os.path.join(_ROOT, "native", "build", "libframeloader.so")

_lib = None
_lib_lock = threading.Lock()


def _build() -> str | None:
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    if (os.path.exists(_SO)
            and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
        return _SO
    # build to a private name, then rename: processes that build at once
    # (test workers) never load a half-written library
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-pthread", _SRC, "-o", tmp, "-lz"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return _SO
    except (subprocess.SubprocessError, FileNotFoundError):
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        lib.fl_open.restype = ctypes.c_int
        lib.fl_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, ctypes.c_float]
        lib.fl_next.restype = ctypes.c_int
        lib.fl_next.argtypes = [ctypes.c_int,
                                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                                ctypes.POINTER(ctypes.c_int),
                                ctypes.POINTER(ctypes.c_int)]
        lib.fl_close.argtypes = [ctypes.c_int]
        lib.fl_decode.restype = ctypes.c_int
        lib.fl_decode.argtypes = [ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                                  ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_int), ctypes.c_float]
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def decode(path: str, scale: float = 0.0,
           max_pixels: int = 4096 * 4096) -> np.ndarray:
    """Decode one PGM/PPM/.npy file to float32 [H, W] via the native lib."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    buf = np.empty(max_pixels, np.float32)
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.fl_decode(path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                       max_pixels, ctypes.byref(h), ctypes.byref(w), scale)
    if rc != 0:
        raise ValueError(f"decode failed ({rc}): {path}")
    return buf[: h.value * w.value].reshape(h.value, w.value).copy()


class FrameStream:
    """Prefetching frame iterator over a list of files (native worker pool).

    scale == 0 -> normalise by the format's max value (images in [0,1]);
    otherwise multiply raw values by `scale` (e.g. 1/5000 for TUM depth).
    """

    def __init__(self, paths: list[str], threads: int = 4,
                 queue_depth: int = 8, scale: float = 0.0,
                 max_pixels: int = 4096 * 4096):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native loader unavailable")
        self._lib = lib
        self._paths = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._handle = lib.fl_open(arr, len(self._paths), threads,
                                   queue_depth, scale)
        self._buf = np.empty(max_pixels, np.float32)
        self._max_pixels = max_pixels
        self._closed = False

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        h = ctypes.c_int()
        w = ctypes.c_int()
        rc = self._lib.fl_next(
            self._handle,
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._max_pixels, ctypes.byref(h), ctypes.byref(w))
        if rc == -1:
            self.close()
            raise StopIteration
        if rc < 0:
            self.close()
            raise ValueError(f"native frame decode failed (rc={rc})")
        return self._buf[: h.value * w.value].reshape(h.value, w.value).copy()

    def close(self):
        if not self._closed:
            self._lib.fl_close(self._handle)
            self._closed = True

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
