"""Motion prior and guided matching against the history frames (port of
mageslam_tpu/tracking/pose_estimation.py).

- `estimate_next_pose_from_history`: constant-velocity extrapolation of the
  oldest and newest history poses (PoseEstimator.cpp:89-133).
- `estimate_pose_with_prior`: project the history frames' map points with
  the prior pose and run the 3-radius guided cascade 12→24→36 px
  (PoseEstimator.cpp:439-607); the widest stage centers on the history
  keypoints' own positions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.camera import project_undistorted
from ..geometry.se3 import Pose, interpolate_pose
from ..ops.indexing import scatter_drop, topk_stable
from ..ops.matching import BIG, radius_match_stages
from .frame_state import TrackedFrame, TrackingHistory


def estimate_next_pose_from_history(history: TrackingHistory,
                                    next_time: torch.Tensor) -> Pose:
    """Constant-velocity prior: extrapolate oldest→newest to `next_time`."""
    n_valid = torch.sum(history.valid.to(torch.int32))
    newest = Pose(history.poses.R[0], history.poses.t[0])
    # a (1,) index tensor: indexing with it never waits on the device
    oldest_idx = torch.clamp_min(n_valid - 1, 0).reshape(1)
    oldest = Pose(history.poses.R[oldest_idx][0], history.poses.t[oldest_idx][0])

    dt_hist = history.timestamps[0] - history.timestamps[oldest_idx][0]
    dt_next = next_time - history.timestamps[0]
    ratio = torch.where(dt_hist > 1e-6, dt_next / dt_hist, 0.0)

    # interpolate_pose(older, newer, 1 + ratio) extrapolates past the newer pose
    predicted = interpolate_pose(oldest, newest, 1.0 + ratio)
    single = n_valid <= 1
    return Pose(torch.where(single, newest.R, predicted.R),
                torch.where(single, newest.t, predicted.t))


class GuidedMatchResult(NamedTuple):
    assoc: torch.Tensor        # (N,) int32 map point slot per keypoint, or -1
    match_count: torch.Tensor  # () int32
    succeeded: torch.Tensor    # () bool


def estimate_pose_with_prior(
    frame: TrackedFrame,
    history: TrackingHistory,
    mp_pos: torch.Tensor,           # (P, 3)
    mp_valid: torch.Tensor,         # (P,) bool
    mp_refine_count: torch.Tensor,  # (P,) int32
    minimum_feature_matches: int = 15,
    search_radius: float = 12.0,
    wider_search_radius: float = 24.0,
    extra_wider_search_radius: float = 36.0,
    small_match_ratio: float = 0.333780871615353,
    max_hamming: int = 45,
    min_hamming_diff: int = 8,
    min_refinement_count: int = 0,
    candidate_budget: int = 1024,
) -> GuidedMatchResult:
    """The prior tracking path; `frame.pose` must already hold the prior.

    Candidates: every map point associated in any history frame (newest
    occurrence wins), refined >= min_refinement_count, in front of the
    camera. One `radius_match_stages` call serves all three stages: on the
    card one launch of the fused kernel, which computes each distance once."""
    H, N = history.assoc.shape
    P = mp_valid.shape[0]
    device = mp_pos.device

    # flatten history associations, newest frame first (dedup: first wins)
    flat_assoc = history.assoc.reshape(-1)
    flat_xy = history.kp_xy.reshape(-1, 2)
    flat_desc = history.desc.reshape(-1, 8)
    frame_valid = history.valid.repeat_interleave(N)
    a_ok = (flat_assoc >= 0) & frame_valid
    a_safe = torch.where(a_ok, flat_assoc, 0).to(torch.int64)
    a_ok = a_ok & mp_valid[a_safe] & (mp_refine_count[a_safe] >= min_refinement_count)

    order = torch.arange(H * N, dtype=torch.int32, device=device)
    first_occurrence = scatter_drop(
        torch.full((P,), BIG, dtype=torch.int32, device=device), a_safe,
        torch.where(a_ok, order, BIG), "min")
    is_first = a_ok & (first_occurrence[a_safe] == order)

    # project candidate points with the prior pose
    predicted, z = project_undistorted(frame.cam, frame.pose.transform(mp_pos[a_safe]))
    cand = is_first & (z >= 0)
    n_candidates = torch.sum(cand.to(torch.int32))
    q_oct = history.octave.reshape(-1)

    # compact the candidates to a fixed budget: validity first, ties low
    # index first (exact selection; the reference's TPU path approximated)
    n_flat = cand.shape[0]
    Cb = min(candidate_budget, n_flat)
    key = cand.to(torch.float32) * 2.0 - torch.arange(
        n_flat, dtype=torch.float32, device=device) / n_flat
    _, sel = topk_stable(key, Cb)
    cand_c = cand[sel]
    flat_xy_c = flat_xy[sel]
    predicted_c = predicted[sel]
    a_safe_c = a_safe[sel]
    q_oct_c = q_oct[sel]

    # the three stages' search boxes: the prior projection at the narrow and
    # wider radii, the history keypoints' own positions at the widest. The
    # radii are filled on the device: copying a host tensor would make the
    # host wait for the stream.
    radii = (search_radius, wider_search_radius, extra_wider_search_radius)
    radius = torch.empty((3, Cb), dtype=torch.float32, device=device)
    for s, r in enumerate(radii):
        radius[s].fill_(r)
    stage_idx, stage_dist = radius_match_stages(
        flat_desc[sel].contiguous(), torch.stack([predicted_c, predicted_c, flat_xy_c]),
        q_oct_c, cand_c, frame.desc.contiguous(), frame.kp_xy, frame.kp_octave,
        frame.kp_valid, radius, max_hamming, min_hamming_diff, octave_tol=0)

    def stage(s):   # the dedup by target ran inside the match
        idx = stage_idx[s]
        return idx, torch.sum((idx >= 0).to(torch.int32))

    denom = torch.clamp_min(n_candidates.to(torch.float32), 1.0)

    def stage_ok(n):
        return (n >= minimum_feature_matches) & (
            n.to(torch.float32) / denom >= small_match_ratio)

    # The reference runs the wider stages behind lax.cond, only when the
    # narrower one came up short. Here all three always run and the result
    # is selected on the device: a host branch would wait on the device
    # twice per frame, and the kernel matches all three stages in one pass.
    idx1, n1 = stage(0)
    idx2, n2 = stage(1)
    idx3, n3 = stage(2)
    ok1, ok2 = stage_ok(n1), stage_ok(n2)
    idx = torch.where(ok1, idx1, torch.where(ok2, idx2, idx3))
    count = torch.where(ok1, n1, torch.where(ok2, n2, n3))

    # invert: per current-frame keypoint, which map point
    has = idx >= 0
    assoc = scatter_drop(torch.full((N,), -1, dtype=torch.int32, device=device),
                         torch.where(has, idx, 0),
                         torch.where(has, a_safe_c, -1), "max")
    ok = count >= minimum_feature_matches
    assoc = torch.where(ok, assoc, -1)
    return GuidedMatchResult(assoc=assoc, match_count=count.to(torch.int32),
                             succeeded=ok)
