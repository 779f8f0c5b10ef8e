"""Track-local-map: two-stage pose-only optimization with guided
re-association (port of mageslam_tpu/tracking/track_local_map.py;
TrackLocalMap.cpp:37-330).

  stage 1: pose-only LM on the current associations, unassociate outliers
  gather : project every unassociated covisible map point, gate it by
           IsGoodCandidate (in front, inside the border, view angle, dMin/dMax
           range), predict its octave, radius-match its representative
           descriptor against the unassociated keypoints
  stage 2: pose-only LM on the merged set, unassociate outliers, fail when
           fewer than MinTrackedFeatureCount remain

Found/predicted scores of recent points come back as per-point deltas.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ba.pose_only import optimize_pose
from ..geometry.camera import project_undistorted
from ..ops.indexing import scatter_drop, topk_stable
from ..ops.matching import radius_match
from ..worldmap.map_state import MapState, predict_octave
from .frame_state import TrackedFrame


class TrackLocalMapResult(NamedTuple):
    frame: TrackedFrame            # updated pose and associations
    succeeded: torch.Tensor        # () bool
    found_delta: torch.Tensor      # (P,) int32
    predicted_delta: torch.Tensor  # (P,) int32
    tracked_count: torch.Tensor    # () int32


def _pose_only(frame: TrackedFrame, mp_pos, info_mask, num_iters, huber, max_err_sq):
    """One OptimizeCameraPose pass: LM on the associated points, then outlier
    flags by unweighted squared error and cheirality."""
    safe = torch.where(frame.assoc >= 0, frame.assoc, 0).to(torch.int64)
    info = torch.where(info_mask, 1.0, 0.0)
    pose, chi2, depth = optimize_pose(frame.pose, frame.cam, mp_pos[safe],
                                      frame.kp_xy, info, huber_width=huber,
                                      num_iters=num_iters)
    outlier = info_mask & ((chi2 > max_err_sq) | (depth <= 0.0))
    return pose, outlier


def _count_at(P: int, idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(P,) int32 histogram of `idx` over the entries where `mask` holds."""
    return scatter_drop(torch.zeros((P,), dtype=torch.int32, device=idx.device),
                        idx, mask.to(torch.int32), "add")


def track_local_map(
    frame: TrackedFrame,
    state: MapState,
    candidate_points: torch.Tensor,  # (P,) bool
    num_levels: int,
    pyramid_scale: float,
    image_width: float = 320.0,
    image_height: float = 180.0,
    image_border: float = 7.5,
    min_degrees_view_angle: float = 60.0,
    match_search_radius: float = 8.0,
    max_hamming: int = 45,
    min_hamming_diff: int = 8,
    min_refinement_count: int = 0,
    stage1_iters: int = 4,
    stage2_iters: int = 10,
    stage1_huber: float = 2.0,
    stage2_huber: float = 1.0,
    max_outlier_error_pose_estimation: float = 4.0,
    max_outlier_error: float = 2.2,
    min_tracked_features: int = 20,
    score_recent_points: bool = True,
    candidate_budget: int = 2048,
) -> TrackLocalMapResult:
    P = state.mp_valid.shape[0]
    N = frame.kp_xy.shape[0]
    device = state.mp_pos.device
    recent_window = 3
    age = (state.next_order - 1) - state.mp_created_order
    is_recent = state.mp_valid & (age >= 0) & (age <= recent_window)

    # drop stale associations to invalid points up front
    pre_ok = (frame.assoc >= 0) & frame.kp_valid
    pre_safe = torch.where(pre_ok, frame.assoc, 0).to(torch.int64)
    frame = frame._replace(
        assoc=torch.where(pre_ok & state.mp_valid[pre_safe], frame.assoc, -1))

    # initial associations count as found and predicted (TrackLocalMap.cpp:69-83)
    a_ok0 = (frame.assoc >= 0) & frame.kp_valid
    safe0 = torch.where(a_ok0, frame.assoc, 0).to(torch.int64)
    a_ok0 = a_ok0 & state.mp_valid[safe0]
    init_seen = _count_at(P, safe0, a_ok0)
    found = init_seen
    predicted = init_seen

    # ---- stage 1 ----
    pose1, outlier1 = _pose_only(frame, state.mp_pos, a_ok0, stage1_iters,
                                 stage1_huber, max_outlier_error_pose_estimation ** 2)
    out_safe = torch.where(outlier1, frame.assoc, 0).to(torch.int64)
    found = found - _count_at(P, out_safe, outlier1)
    frame = frame._replace(pose=pose1, assoc=torch.where(outlier1, -1, frame.assoc))

    # ---- candidates over the whole point bank ----
    a_ok1 = (frame.assoc >= 0) & frame.kp_valid
    safe1 = torch.where(a_ok1, frame.assoc, 0).to(torch.int64)
    already = _count_at(P, safe1, a_ok1) > 0
    cand = (candidate_points & state.mp_valid & ~already
            & (state.mp_refine_count >= min_refinement_count))

    # IsGoodCandidate gates
    proj_xy, z = project_undistorted(frame.cam, pose1.transform(state.mp_pos))
    u, v = proj_xy[:, 0], proj_xy[:, 1]
    in_border = ((u >= image_border) & (u < image_width - image_border)
                 & (v >= image_border) & (v < image_height - image_border))
    center = pose1.center()
    forward = pose1.forward()
    cos_angle = torch.einsum("pi,i->p", state.mp_mean_dir, forward)
    min_cos = torch.cos(torch.deg2rad(torch.tensor(
        min_degrees_view_angle, dtype=torch.float32, device=device)))
    angle_ok = cos_angle >= min_cos
    delta = state.mp_pos - center[None, :]
    dist_sq = torch.sum(delta * delta, dim=-1)
    range_ok = (dist_sq >= state.mp_dmin ** 2) & (dist_sq <= state.mp_dmax ** 2)
    good = cand & (z >= 0) & in_border & angle_ok & range_ok

    octv = predict_octave(torch.sqrt(torch.clamp_min(dist_sq, 1e-12)),
                          state.mp_dmin, pyramid_scale)
    is_predicted = good & (octv >= 0) & (octv <= num_levels)
    predicted = predicted + (is_predicted & is_recent).to(torch.int32)

    # ---- match candidates to unassociated keypoints ----
    # compact the predicted candidates (nearest first) to a fixed budget so
    # the Hamming matrix is (budget, N), not (P, N)
    unassociated = frame.kp_valid & (frame.assoc < 0)
    C = min(candidate_budget, P)
    prio = torch.where(is_predicted, -dist_sq, float("-inf"))
    _, cand_idx = topk_stable(prio, C)
    cand_ok = is_predicted[cand_idx]
    m_idx_c, _ = radius_match(
        state.mp_desc[cand_idx].contiguous(), proj_xy[cand_idx],
        torch.clamp(octv, 0, num_levels - 1)[cand_idx], cand_ok,
        frame.desc.contiguous(), frame.kp_xy, frame.kp_octave, unassociated,
        match_search_radius, max_hamming, min_hamming_diff)
    matched_c = m_idx_c >= 0
    # back to the full point domain (cand_idx holds distinct slots)
    m_idx = torch.full((P,), -1, dtype=torch.int32, device=device)
    m_idx[cand_idx] = m_idx_c
    matched = torch.zeros((P,), dtype=torch.bool, device=device)
    matched[cand_idx] = matched_c
    found = found + (matched & is_recent).to(torch.int32)

    # new associations: keypoint m_idx[p] ← point p (highest p wins a tie)
    t_safe = torch.where(matched, m_idx, 0).to(torch.int64)
    new_assoc = scatter_drop(
        torch.full((N,), -1, dtype=torch.int32, device=device), t_safe,
        torch.where(matched, torch.arange(P, dtype=torch.int32, device=device), -1),
        "max")
    frame = frame._replace(assoc=torch.where((frame.assoc < 0) & (new_assoc >= 0),
                                             new_assoc, frame.assoc))

    # ---- stage 2 ----
    a_ok2 = (frame.assoc >= 0) & frame.kp_valid
    safe2 = torch.where(a_ok2, frame.assoc, 0).to(torch.int64)
    a_ok2 = a_ok2 & state.mp_valid[safe2]
    pose2, outlier2 = _pose_only(frame, state.mp_pos, a_ok2, stage2_iters,
                                 stage2_huber, max_outlier_error ** 2)
    out_safe2 = torch.where(outlier2, frame.assoc, 0).to(torch.int64)
    found = found - _count_at(P, out_safe2, outlier2)
    assoc3 = torch.where(outlier2, -1, frame.assoc)
    frame = frame._replace(pose=pose2, assoc=assoc3)

    tracked = torch.sum(((assoc3 >= 0) & frame.kp_valid).to(torch.int32))
    ok = tracked >= min_tracked_features
    frame = frame._replace(assoc=torch.where(ok, assoc3, -1))

    scored = is_recent if score_recent_points else torch.zeros_like(is_recent)
    return TrackLocalMapResult(
        frame=frame,
        succeeded=ok,
        found_delta=torch.where(scored, found, 0),
        predicted_delta=torch.where(scored, predicted, 0),
        tracked_count=tracked.to(torch.int32),
    )

