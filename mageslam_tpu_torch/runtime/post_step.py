"""The per-frame bookkeeping step: found/predicted scores, tracking history,
pose-history record and the new-keyframe decision (port of the reference's
`_build_post_core`, mageslam_tpu/runtime/pipeline.py:909-1027)."""

from __future__ import annotations

import torch

from ..geometry.se3 import Pose
from ..ops.indexing import scatter_drop, topk_stable
from ..tracking.bounding_depths import calculate_bounding_plane_depths
from ..tracking.frame_state import TrackedFrame, TrackingHistory
from ..tracking.keyframe_decision import KeyframeDecisionInput, is_new_keyframe
from ..worldmap.map_state import MapState
from .pose_history import PoseHistory


def _keyframe_decision(settings, width, height, map_state: MapState,
                       frame: TrackedFrame, a_ok, frames_since_keyframe,
                       frames_since_reloc) -> torch.Tensor:
    """The association-wide part of the decision: shared/size counts from the
    (K, P) membership cache as two float32 matrix products (exact: counts stay
    far below 2^24), the K1 ∪ K2 covisible neighbourhood, then
    is_new_keyframe."""
    ks = settings.KeyframeSettings
    P_cap = map_state.mp_valid.shape[0]
    K_cap = map_state.kf_valid.shape[0]
    safe = torch.where(a_ok, frame.assoc, 0).to(torch.int64)
    seen = scatter_drop(torch.zeros((P_cap,), dtype=torch.int32, device=safe.device),
                        safe, a_ok.to(torch.int32), "max") > 0
    member = (map_state.kf_member & map_state.mp_valid[None, :]).to(torch.float32)
    shared = torch.matmul(member, seen.to(torch.float32)).to(torch.int32)
    sizes = torch.sum(member, dim=1).to(torch.int32)
    # connected keyframes = K1 ∪ K2 (ThreadSafeMap.cpp:122-180): K1 shares
    # >= CovisMinThreshold of this frame's points, K2 is covisible with one
    # of the top-8 K1 seeds
    theta_c = settings.CovisibilitySettings.CovisMinThreshold
    k1 = (shared >= theta_c) & map_state.kf_valid
    _, k1_seed = topk_stable(torch.where(k1, shared, -1), min(8, K_cap))
    seed_ok = k1[k1_seed]
    covis_sub = torch.matmul(member, member[k1_seed].T)
    k2 = torch.any((covis_sub >= theta_c) & seed_ok[None, :], dim=1) & map_state.kf_valid
    depths = torch.where(a_ok, frame.pose.transform(map_state.mp_pos[safe])[:, 2],
                         float("inf"))
    min_depth = torch.min(depths)
    return is_new_keyframe(
        frame,
        KeyframeDecisionInput(
            frames_since_keyframe=frames_since_keyframe,
            frames_since_reloc=frames_since_reloc,
            mapping_idle=torch.ones((), dtype=torch.bool, device=safe.device),
            min_point_distance=torch.where(torch.isfinite(min_depth), min_depth, 0.0),
        ),
        map_state.keyframe_centers(), k1 | k2, shared, sizes, width, height,
        min_frame_count=ks.KeyframeDecisionMinFrameCount,
        min_frame_count_reloc=ks.KeyframeDecisionMinFrameCountReloc,
        min_tracking_points=ks.KeyframeDecisionMinTrackingPointCount,
        max_tracking_matches=int(ks.KeyframeDecisionMaxTrackingPointMatches),
        max_overlap=ks.KeyframeDecisionMaxTrackingPointOverlap,
        min_move_ratio=ks.MinFrameMoveToMinDepthRatio,
    )


def post_step(settings, width: int, height: int, map_state: MapState,
              history: TrackingHistory, pose_history: PoseHistory,
              frame: TrackedFrame, found_delta, predicted_delta,
              frames_since_keyframe: torch.Tensor, frames_since_reloc: torch.Tensor):
    """Bookkeeping for one tracked frame. Returns (map_state, history,
    pose_history, is_keyframe ()). Nothing here waits on the device."""
    ks = settings.KeyframeSettings
    bds = settings.BoundingDepthSettings
    map_state = map_state._replace(mp_found=map_state.mp_found + found_delta,
                                   mp_predicted=map_state.mp_predicted + predicted_delta)
    history = history.advance(frame)

    # connect to the nearest keyframes by camera center (PARITY.md)
    d2 = torch.sum((map_state.keyframe_centers() - frame.pose.center()[None]) ** 2,
                   dim=-1)
    neg, slots = topk_stable(-torch.where(map_state.kf_valid, d2, float("inf")),
                             pose_history.connections)
    bd = calculate_bounding_plane_depths(
        frame, map_state, width, height,
        roi_min_x=bds.RegionOfInterestMinX, roi_min_y=bds.RegionOfInterestMinY,
        roi_max_x=bds.RegionOfInterestMaxX, roi_max_y=bds.RegionOfInterestMaxY,
        near_softness=bds.NearDepthSoftness, far_softness=bds.FarDepthSoftness)
    pose_history = pose_history.add(
        frame.frame_id, frame.pose,
        Pose(map_state.kf_pose.R[slots], map_state.kf_pose.t[slots]),
        slots.to(torch.int32), torch.isfinite(neg), near=bd.near, far=bd.far)

    a_ok = (frame.assoc >= 0) & frame.kp_valid
    n_tracked = torch.sum(a_ok.to(torch.int32))
    cheap = ((frames_since_reloc > ks.KeyframeDecisionMinFrameCountReloc)
             & (frames_since_keyframe > 0)
             & (n_tracked > ks.KeyframeDecisionMinTrackingPointCount)
             & (n_tracked < int(ks.KeyframeDecisionMaxTrackingPointMatches)))
    # The reference evaluates the association-wide part behind lax.cond, only
    # when the cheap gates pass. Here it always runs (two small matrix
    # products at the bank sizes) and is masked on the device, so the step
    # needs no host read.
    heavy = _keyframe_decision(settings, width, height, map_state, frame, a_ok,
                               frames_since_keyframe, frames_since_reloc)
    return map_state, history, pose_history, cheap & heavy
