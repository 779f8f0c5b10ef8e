"""Bounding-plane depths per tracked frame (port of
mageslam_tpu/tracking/bounding_depths.py; BoundingPlaneDepths.cpp)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..worldmap.map_state import MapState
from .frame_state import TrackedFrame


class InternalDepth(NamedTuple):
    near: torch.Tensor   # () f32
    far: torch.Tensor    # () f32
    count: torch.Tensor  # () int32 points inside the ROI


def calculate_bounding_plane_depths(frame: TrackedFrame, state: MapState,
                                    image_width: float, image_height: float,
                                    roi_min_x: float = 0.1, roi_min_y: float = 0.1,
                                    roi_max_x: float = 0.9, roi_max_y: float = 0.9,
                                    near_softness: float = 0.0,
                                    far_softness: float = 0.0) -> InternalDepth:
    """Near/far depths along the viewing direction of the associated points
    whose keypoints lie in the ROI; softness trims that quantile off each end."""
    a_ok = (frame.assoc >= 0) & frame.kp_valid
    safe = torch.where(a_ok, frame.assoc, 0).to(torch.int64)
    a_ok = a_ok & state.mp_valid[safe]

    in_roi = ((frame.kp_xy[:, 0] >= roi_min_x * image_width)
              & (frame.kp_xy[:, 0] <= roi_max_x * image_width)
              & (frame.kp_xy[:, 1] >= roi_min_y * image_height)
              & (frame.kp_xy[:, 1] <= roi_max_y * image_height))
    use = a_ok & in_roi

    f = frame.pose.forward()
    c = frame.pose.center()
    depth = torch.einsum("ni,i->n", state.mp_pos[safe] - c[None], f)
    n = torch.sum(use.to(torch.int32))

    d_sorted = torch.sort(torch.where(use, depth, float("inf"))).values
    last = depth.shape[0] - 1
    lo_idx = torch.clamp((near_softness * n.to(torch.float32)).to(torch.int64), 0, last)
    hi_idx = torch.clamp(n - 1 - (far_softness * n.to(torch.float32)).to(torch.int64),
                         0, last)
    near = d_sorted[lo_idx.reshape(1)][0]
    far = d_sorted[hi_idx.reshape(1)][0]
    ok = n > 0
    zero = torch.zeros((), dtype=torch.float32, device=depth.device)
    return InternalDepth(
        near=torch.where(ok, near, zero),
        far=torch.where(ok & torch.isfinite(far), far, zero),
        count=n.to(torch.int32),
    )
