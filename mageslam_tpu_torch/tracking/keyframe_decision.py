"""New-keyframe decision gates (port of
mageslam_tpu/tracking/keyframe_decision.py; NewKeyFrameDecision.cpp)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.se3 import Pose
from .frame_state import TrackedFrame


class KeyframeDecisionInput(NamedTuple):
    frames_since_keyframe: torch.Tensor  # () int32
    frames_since_reloc: torch.Tensor     # () int32
    mapping_idle: torch.Tensor           # () bool
    min_point_distance: torch.Tensor     # () f32 near bounding-plane depth


def moved_enough(frame_pose: Pose, connected_centers, connected_mask,
                 min_point_distance, min_move_ratio: float) -> torch.Tensor:
    """True when the frame center is at least minDepth·ratio away from every
    connected keyframe (NewKeyFrameDecision.cpp:41-63)."""
    min_d = min_point_distance * min_move_ratio
    d2 = torch.sum((connected_centers - frame_pose.center()[None]) ** 2, dim=-1)
    return ~torch.any(connected_mask & (d2 < min_d * min_d))


def densely_connected(frame: TrackedFrame, image_width: float, image_height: float,
                      grid_w: int = 4, grid_h: int = 3, min_points_per_cell: int = 2,
                      allowed_empty_pct: float = 0.25) -> torch.Tensor:
    """Grid coverage test (NewKeyFrameDecision.cpp:67-117)."""
    ok = (frame.assoc >= 0) & frame.kp_valid
    gx = torch.clamp(torch.floor(frame.kp_xy[:, 0] * grid_w / image_width), 0, grid_w - 1)
    gy = torch.clamp(torch.floor(frame.kp_xy[:, 1] * grid_h / image_height), 0, grid_h - 1)
    cell = (gx * grid_h + gy).to(torch.int64)
    counts = torch.zeros((grid_w * grid_h,), dtype=torch.int32, device=cell.device)
    counts = counts.index_add(0, torch.where(ok, cell, 0), ok.to(torch.int32))
    empty = torch.sum((counts < min_points_per_cell).to(torch.float32))
    return empty / (grid_w * grid_h) <= allowed_empty_pct


def is_new_keyframe(
    frame: TrackedFrame,
    decision: KeyframeDecisionInput,
    connected_centers: torch.Tensor,  # (K, 3)
    connected_mask: torch.Tensor,     # (K,) bool
    shared_counts: torch.Tensor,      # (K,) int32 points shared with this frame
    connected_sizes: torch.Tensor,    # (K,) int32 each keyframe's point count
    image_width: float,
    image_height: float,
    min_frame_count: int = 60,
    min_frame_count_reloc: int = 20,
    min_tracking_points: int = 25,
    max_tracking_matches: int = 300,
    max_overlap: float = 0.25,
    min_move_ratio: float = 0.02,
    grid_w: int = 4,
    grid_h: int = 3,
    min_points_per_cell: int = 2,
    allowed_empty_pct: float = 0.25,
) -> torch.Tensor:
    """IsNewKeyFrame (NewKeyFrameDecision.cpp:141-…). Kref is the connected
    keyframe sharing the most points."""
    n_tracked = frame.associated_count()

    gate_reloc = decision.frames_since_reloc > min_frame_count_reloc
    gate_rate = decision.mapping_idle | (decision.frames_since_keyframe > min_frame_count)
    gate_min = n_tracked > min_tracking_points
    gate_max = n_tracked < max_tracking_matches

    moved = moved_enough(frame.pose, connected_centers, connected_mask,
                         decision.min_point_distance, min_move_ratio)
    dense = densely_connected(frame, image_width, image_height, grid_w, grid_h,
                              min_points_per_cell, allowed_empty_pct)
    gate_geom = moved | ~dense

    best = torch.argmax(torch.where(connected_mask, shared_counts, -1)).reshape(1)
    n_kref = torch.where(torch.any(connected_mask), connected_sizes[best][0], 0)
    gate_overlap = n_tracked.to(torch.float32) < (
        n_kref.to(torch.float32) * max_overlap + min_tracking_points)

    return gate_reloc & gate_rate & gate_min & gate_max & gate_geom & gate_overlap
