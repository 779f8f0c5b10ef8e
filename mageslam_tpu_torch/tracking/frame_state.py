"""Per-frame tracking state (port of mageslam_tpu/tracking/frame_state.py).

- TrackedFrame: the in-flight frame's features, pose and per-feature map
  point association (KeyframeBuilder).
- TrackingHistory: the last H tracked frames, newest at index 0
  (historical_queue<HistoricalFrame, 5>, PoseEstimator.h:53).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.se3 import Pose


class TrackedFrame(NamedTuple):
    pose: Pose                # current world→camera estimate
    cam: torch.Tensor         # (4,) fx fy cx cy (undistorted space)
    kp_xy: torch.Tensor       # (N, 2) undistorted keypoint positions
    kp_octave: torch.Tensor   # (N,) int32
    desc: torch.Tensor        # (N, 8) int32 descriptor bits
    kp_valid: torch.Tensor    # (N,) bool
    assoc: torch.Tensor       # (N,) int32 map point slot or -1
    timestamp: torch.Tensor   # () f32 seconds
    frame_id: torch.Tensor    # () int32

    def associated_count(self) -> torch.Tensor:
        return torch.sum(((self.assoc >= 0) & self.kp_valid).to(torch.int32))


class TrackingHistory(NamedTuple):
    """Ring buffer of the last H tracked frames (newest at index 0)."""

    poses: Pose               # (H,) view transforms
    timestamps: torch.Tensor  # (H,) f32
    assoc: torch.Tensor       # (H, N) int32
    kp_xy: torch.Tensor       # (H, N, 2) f32
    octave: torch.Tensor      # (H, N) int32
    desc: torch.Tensor        # (H, N, 8) int32
    valid: torch.Tensor       # (H,) bool

    @staticmethod
    def empty(length: int, n_features: int, device=None) -> "TrackingHistory":
        return TrackingHistory(
            poses=Pose.identity((length,), device=device),
            timestamps=torch.zeros((length,), dtype=torch.float32, device=device),
            assoc=torch.full((length, n_features), -1, dtype=torch.int32, device=device),
            kp_xy=torch.zeros((length, n_features, 2), dtype=torch.float32, device=device),
            octave=torch.zeros((length, n_features), dtype=torch.int32, device=device),
            desc=torch.zeros((length, n_features, 8), dtype=torch.int32, device=device),
            valid=torch.zeros((length,), dtype=torch.bool, device=device),
        )

    def advance(self, frame: TrackedFrame) -> "TrackingHistory":
        """Push the newest tracked frame (historical_queue::advance)."""
        def roll(a, v):
            return torch.cat([torch.as_tensor(v, dtype=a.dtype, device=a.device)[None],
                              a[:-1]])
        return TrackingHistory(
            poses=Pose(roll(self.poses.R, frame.pose.R), roll(self.poses.t, frame.pose.t)),
            timestamps=roll(self.timestamps, frame.timestamp),
            assoc=roll(self.assoc, frame.assoc),
            kp_xy=roll(self.kp_xy, frame.kp_xy),
            octave=roll(self.octave, frame.kp_octave),
            desc=roll(self.desc, frame.desc),
            valid=roll(self.valid, True),
        )

    def clear(self) -> "TrackingHistory":
        """Tracking lost → history reset (TrackLocalMapWorker.cpp:87-90)."""
        return self._replace(valid=torch.zeros_like(self.valid))
