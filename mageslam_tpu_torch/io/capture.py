"""Versioned binary session capture: calibration header + per-frame pixels
(the port's copy of mageslam_tpu/io/capture.py, byte for byte the same
`.mgts` format, so either package reads what the other writes).

The reference records sessions as `HeaderData` (calibration + device info)
followed by per-frame pixel buffers with timestamps, versioned for forward
compatibility (Serialization/BinarySerializer.h:19-75). Same capability here
with an explicit little-endian struct layout; frames stream append-only so a
capture can be replayed deterministically (the reference's offline-replay
test strategy, SURVEY §4).

Layout:
  magic   4s   = b"MGTS"
  version u32  = 1
  width   u32, height u32
  cam     16×f32 (geometry.camera parameter vector)
  device  64s  (utf-8, zero-padded)
  frames: repeated [timestamp f64][frame_id i64][pixels u8 × W·H]
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Iterator

import numpy as np

_MAGIC = b"MGTS"
_VERSION = 1
_HEADER = struct.Struct("<4sIII16f64s")
_FRAME = struct.Struct("<dq")


@dataclass
class CaptureHeader:
    width: int
    height: int
    cam: np.ndarray          # (16,) float32
    device: str = ""
    version: int = _VERSION


class CaptureWriter:
    def __init__(self, path: str, header: CaptureHeader):
        self._f = open(path, "wb")
        cam = np.asarray(header.cam, np.float32).reshape(16)
        self._f.write(_HEADER.pack(
            _MAGIC, header.version, header.width, header.height,
            *cam.tolist(), header.device.encode()[:64]))
        self._shape = (header.height, header.width)

    def write_frame(self, pixels: np.ndarray, timestamp: float, frame_id: int):
        px = np.ascontiguousarray(pixels, np.uint8)
        if px.shape != self._shape:
            raise ValueError(f"frame shape {px.shape} != capture {self._shape}")
        self._f.write(_FRAME.pack(timestamp, frame_id))
        self._f.write(px.tobytes())

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class CaptureReader:
    def __init__(self, path: str):
        self._f = open(path, "rb")
        raw = self._f.read(_HEADER.size)
        magic, version, w, h, *rest = _HEADER.unpack(raw)
        if magic != _MAGIC:
            raise ValueError("not a mageslam_tpu capture")
        if version > _VERSION:
            raise ValueError(f"capture version {version} > supported {_VERSION}")
        cam = np.array(rest[:16], np.float32)
        device = rest[16].rstrip(b"\0").decode()
        self.header = CaptureHeader(w, h, cam, device, version)

    def frames(self) -> Iterator[tuple[np.ndarray, float, int]]:
        n = self.header.width * self.header.height
        while True:
            meta = self._f.read(_FRAME.size)
            if len(meta) < _FRAME.size:
                return
            ts, fid = _FRAME.unpack(meta)
            px = np.frombuffer(self._f.read(n), np.uint8).reshape(
                self.header.height, self.header.width)
            yield px, ts, fid

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
