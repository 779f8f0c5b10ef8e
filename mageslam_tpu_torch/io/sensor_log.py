"""Sensor sample logs: record/replay inertial streams (the port's own copy
of mageslam_tpu/io/sensor_log.py, numpy only; the two write the same
bytes).

Replaces FuserLib's LegacySerialization (recorded sensor streams enabling
deterministic re-runs of captured sessions, SURVEY §4/§5.4). Binary layout
per record: [type u8][timestamp f64][n u8][data f32 × n].
"""

from __future__ import annotations

import struct
from typing import Iterator

import numpy as np

from ..fuser.sample_queue import SampleType, SensorSample

_MAGIC = b"MGSL"
_REC = struct.Struct("<BdB")


class SensorLogWriter:
    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._f.write(_MAGIC)

    def write(self, sample: SensorSample) -> None:
        data = np.asarray(sample.data, np.float32).reshape(-1)
        self._f.write(_REC.pack(int(sample.type), float(sample.timestamp),
                                len(data)))
        self._f.write(data.tobytes())

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SensorLogReader:
    def __init__(self, path: str):
        self._f = open(path, "rb")
        if self._f.read(4) != _MAGIC:
            raise ValueError("not a mageslam_tpu sensor log")

    def samples(self) -> Iterator[SensorSample]:
        while True:
            head = self._f.read(_REC.size)
            if len(head) < _REC.size:
                return
            t, ts, n = _REC.unpack(head)
            data = np.frombuffer(self._f.read(4 * n), np.float32).copy()
            yield SensorSample(SampleType(t), ts, data)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
