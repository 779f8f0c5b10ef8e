"""Structured inspection: leveled event log and observer fan-out (port of
mageslam_tpu/diagnostics/introspect.py).

The reference exposes a friend-class backdoor into live internals
(Debugging/SkeletonKey.h:29-52) plus leveled structured dumps
(SkeletonLogger.h:27-144, bitmask levels SkeletonKey.h:14-25) and an
`Introspection` fan-out hub (Introspection.h:13-52). The session's state is
plain tensors, readable as it is, so this module keeps the leveled event log
and the observer fan-out those tools fed.
"""

from __future__ import annotations

import enum
import json
from typing import Any, Callable

import numpy as np

from .trace import leaf_array


class LogLevel(enum.IntFlag):
    """SkeletonKey.h:14-25 bitmask levels."""

    NONE = 0
    INITIALIZATION = 1
    TRACKING = 2
    MAPPING = 4
    IMAGE = 8
    MODEL = 16
    ALL = 31


class Introspection:
    """Leveled structured event sink and observer fan-out.

    `log(level, event, **payload)` keeps the event where its level is
    enabled; observers registered with `attach` receive every event (the
    reference's IntrospectAnalyzedImage / IntrospectEstimatedPose fan-out,
    Runtime.cpp:211,247)."""

    def __init__(self, level: LogLevel = LogLevel.NONE):
        self.level = level
        self.events: list[dict] = []
        self._observers: list[Callable[[dict], None]] = []

    def attach(self, observer: Callable[[dict], None]) -> None:
        self._observers.append(observer)

    def log(self, level: LogLevel, event: str, **payload: Any) -> None:
        record = {"level": int(level), "event": event, **payload}
        for obs in self._observers:
            obs(record)
        if self.level & level:
            self.events.append(record)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            for e in self.events:
                f.write(json.dumps(e, default=str) + "\n")

    # the SkeletonLogger sections
    def log_pose(self, stage: int, frame_id: int, pose) -> None:
        """The pose's 4×4 world→camera matrix."""
        R, t = leaf_array(pose.R), leaf_array(pose.t)
        matrix = np.eye(4, dtype=R.dtype)
        matrix[:3, :3], matrix[:3, 3] = R, t
        self.log(LogLevel.TRACKING, "pose", stage=stage, frame_id=frame_id,
                 matrix=matrix.tolist())

    def log_match_counts(self, frame_id: int, **counts: int) -> None:
        self.log(LogLevel.TRACKING, "matches", frame_id=frame_id, **counts)

    def log_map_stats(self, frame_id: int, n_keyframes: int, n_points: int) -> None:
        self.log(LogLevel.MAPPING, "map", frame_id=frame_id,
                 keyframes=n_keyframes, points=n_points)
