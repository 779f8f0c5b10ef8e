"""The gated per-frame step: tracking and bookkeeping with every state update
selected on the device by the tracking outcome (port of the reference's
`_build_step_core` and `_build_frame_step_core`,
mageslam_tpu/runtime/pipeline.py:1029-1118, and of the frame conversion in
`_preprocess_image`, :301-313).

The per-frame path (`SlamSession._track`) reads the outcome and branches on
the host. The throughput entry points (runtime/streaming.py) cannot wait for
that read, so this step runs `track_step` and `post_step` unconditionally and
keeps the old state where tracking failed: the histories whole, the map's
`mp_found` / `mp_predicted` only (the one part of the map `post_step`
changes). On either outcome the state equals the branch's. The outcome comes
back as one device tensor, (ok, tracked count, keyframe & ok), with no host
read.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry.se3 import Pose
from ..ops.undistort import undistort_image
from ..tracking.frame_state import TrackedFrame, TrackingHistory
from ..worldmap.map_state import MapState
from .pose_history import PoseHistory
from .post_step import post_step
from .track_step import track_step


def prepare_image(image, device, raw_cam16: torch.Tensor | None = None) -> torch.Tensor:
    """A grayscale frame (H, W), uint8 or float32 in [0, 255], numpy or
    tensor, as float32 on `device`; warped to the undistorted pinhole where
    `raw_cam16`, the session's distorted camera, is given. A uint8 frame
    crosses to the card as uint8 and converts there."""
    image = torch.as_tensor(np.asarray(image) if not torch.is_tensor(image) else image)
    image = image.to(device).to(torch.float32)
    if raw_cam16 is not None:
        image, _ = undistort_image(image, raw_cam16)
    return image


def select(gate: torch.Tensor, new, old):
    """`new` where the () bool `gate` holds, else `old`, leaf by leaf over
    matching tuples of tensors."""
    if torch.is_tensor(new):
        return torch.where(gate, new, old)
    return type(new)(*(select(gate, a, b) for a, b in zip(new, old)))


class StepOut(NamedTuple):
    map: MapState
    history: TrackingHistory
    pose_history: PoseHistory
    frame: TrackedFrame      # the tracked frame (pose, associations)
    flags: torch.Tensor      # (3,) int32: ok, tracked count, keyframe & ok


def gated_step(settings, width: int, height: int, map_state: MapState,
               history: TrackingHistory, pose_history: PoseHistory, frame: TrackedFrame,
               frames_since_keyframe: torch.Tensor, frames_since_reloc: torch.Tensor,
               prior: Pose | None = None) -> StepOut:
    """Track `frame` and book it, the state selected by the outcome on the
    device. The counters are the ones the frame's bookkeeping sees (already
    incremented, as the per-frame path passes them); `prior`, where given,
    replaces the motion model (the fuser's). Nothing here waits on the
    device."""
    res = track_step(settings, width, height, map_state, history, frame,
                     prior_override=prior, prior_valid=prior is not None)
    m2, h2, ph2, is_kf = post_step(settings, width, height, map_state, history,
                                   pose_history, res.frame, res.found_delta,
                                   res.predicted_delta, frames_since_keyframe,
                                   frames_since_reloc)
    gate = res.succeeded
    m_out = map_state._replace(
        mp_found=torch.where(gate, m2.mp_found, map_state.mp_found),
        mp_predicted=torch.where(gate, m2.mp_predicted, map_state.mp_predicted))
    flags = torch.stack([gate.to(torch.int32), res.tracked_count.to(torch.int32),
                         (is_kf & gate).to(torch.int32)])
    return StepOut(m_out, select(gate, h2, history), select(gate, ph2, pose_history),
                   res.frame, flags)
