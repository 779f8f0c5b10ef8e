"""ctypes bindings for the native async frame loader (native/frame_loader.cpp;
the port's copy of mageslam_tpu/io/native_loader.py, bound to the same
library, the repo's native/libframe_loader.so).

The native side owns disk IO, capture decode, bilinear resize, and a bounded
prefetch ring on its own thread; the host Python loop hands the frames on to
the session. This is host IO: the console reads a `.mgts` capture through it
where the library is built (`make -C native`), through `CaptureReader`
otherwise.
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator

import numpy as np

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "libframe_loader.so")

_lib = None


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(_LIB_PATH)
    lib.frame_loader_open.restype = ctypes.c_void_p
    lib.frame_loader_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int]
    lib.frame_loader_dims.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int),
                                      ctypes.POINTER(ctypes.c_int)]
    lib.frame_loader_camera.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_float)]
    lib.frame_loader_next.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_double),
                                      ctypes.POINTER(ctypes.c_int64)]
    lib.frame_loader_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    return os.path.exists(_LIB_PATH)


class NativeFrameLoader:
    """Prefetching reader over a .mgts capture; optional resize to (w, h)."""

    def __init__(self, path: str, out_width: int = 0, out_height: int = 0,
                 prefetch_depth: int = 4):
        lib = _load_lib()
        self._lib = lib
        self._h = lib.frame_loader_open(path.encode(), out_width, out_height,
                                        prefetch_depth)
        if not self._h:
            raise ValueError(f"cannot open capture {path!r}")
        w = ctypes.c_int()
        h = ctypes.c_int()
        lib.frame_loader_dims(self._h, ctypes.byref(w), ctypes.byref(h))
        self.width, self.height = w.value, h.value
        cam = (ctypes.c_float * 16)()
        lib.frame_loader_camera(self._h, cam)
        self.cam = np.array(cam, np.float32)

    def frames(self) -> Iterator[tuple[np.ndarray, float, int]]:
        n = self.width * self.height
        buf = ctypes.create_string_buffer(n)
        ts = ctypes.c_double()
        fid = ctypes.c_int64()
        while self._lib.frame_loader_next(self._h, buf, ctypes.byref(ts),
                                          ctypes.byref(fid)):
            px = np.frombuffer(buf.raw, np.uint8, n).reshape(
                self.height, self.width).copy()
            yield px, ts.value, fid.value

    def close(self):
        if self._h:
            self._lib.frame_loader_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
