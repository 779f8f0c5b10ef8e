"""Time-sorted multi-sensor sample queue with image fences (the port's own
copy of mageslam_tpu/fuser/sample_queue.py, numpy only).

Replaces FuserLib's SensorSample / SensorSampleQueue (Include/SensorSample.h,
SensorSampleQueue.h): samples from multiple sensors arrive out of order; the
queue releases them in timestamp order, and an "image fence" marks a frame
timestamp so all inertial samples up to the fence can be consumed before the
visual update. Host-side plumbing (samples arrive from host IO anyway) with
numpy storage; the consumer feeds batches into the filter on the device.
"""

from __future__ import annotations

import enum
import heapq
from typing import NamedTuple

import numpy as np


class SampleType(enum.IntEnum):
    # SensorSample::SampleType equivalents
    ACCELEROMETER = 0
    GYROMETER = 1
    MAGNETOMETER = 2
    IMAGE_FENCE = 3


class SensorSample(NamedTuple):
    type: SampleType
    timestamp: float
    data: np.ndarray      # sensor reading, () to (3,)


class SampleQueue:
    """Min-heap on timestamp; `drain_until_fence` returns all inertial samples
    up to (and including) the next image fence, in order."""

    def __init__(self):
        self._heap: list[tuple[float, int, SensorSample]] = []
        self._seq = 0

    def add(self, sample: SensorSample) -> None:
        heapq.heappush(self._heap, (sample.timestamp, self._seq, sample))
        self._seq += 1

    def add_image_fence(self, timestamp: float) -> None:
        self.add(SensorSample(SampleType.IMAGE_FENCE, timestamp,
                              np.zeros(0, np.float32)))

    def __len__(self) -> int:
        return len(self._heap)

    def drain_until_fence(self) -> tuple[list[SensorSample], float | None]:
        """Pop samples up to the first IMAGE_FENCE. Returns (samples,
        fence_timestamp or None if no fence is queued — nothing is popped
        then, mirroring the reference's fence-gated consumption)."""
        if not any(s.type == SampleType.IMAGE_FENCE for _, _, s in self._heap):
            return [], None
        out: list[SensorSample] = []
        while self._heap:
            _, _, s = heapq.heappop(self._heap)
            if s.type == SampleType.IMAGE_FENCE:
                return out, s.timestamp
            out.append(s)
        return out, None  # unreachable given the guard
