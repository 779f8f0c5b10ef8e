"""Monocular map initialization (port of mageslam_tpu/tracking/map_init.py;
the reference's Tracking/MapInitialization.cpp).

`try_initialize_pair` bootstraps a map from two frames: two-way descriptor
match (`ops/matching.match_two_way`, the fused kernel on the card), spread-
constrained RANSAC over 5-point samples solved by the batched 5-point
solver (in float64, where the reference solves in float32), symmetric transfer scoring of every candidate essential matrix,
disambiguation of the best one's four poses by cheirality, parallax,
epipolar and reprojection gates, DLT triangulation, and a 15-step bundle
adjustment with frame 1 fixed. `validate_third_frame` locates a middle
frame against the new points by PnP RANSAC and requires enough inliers.

The reference draws its samples from `jax.random.gumbel`; here the draws
are inputs: (B, 5, N) for the RANSAC samples and (64, N) for the PnP
hypotheses (`runtime/draws.py`). Nothing is read back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ba.pose_only import optimize_pose
from ..ba.problem import BAState, empty_problem, without_tethers
from ..ba.step import step_bundle_adjust
from ..geometry.essential import (
    MAX_ROOTS,
    decompose_essential,
    five_point_essential,
    triangulate_midpoint_pair,
)
from ..geometry.pnp import pnp_ransac
from ..geometry.se3 import Pose
from ..geometry.triangulation import triangulate_dlt
from ..ops.matching import match_two_way

PNP_HYPOTHESES = 64   # pnp_ransac's hypothesis batch in validate_third_frame


class InitSettings(NamedTuple):
    """MonoMapInitializationSettings (MageSettings.h:95-133), defaults preserved."""

    fundamental_transfer_error_threshold: float = 1.1
    min_feature_matches: int = 65
    min_scoring_inliers: int = 50
    min_inlier_percentage: float = 0.5
    min_initial_map_points: int = 40
    min_map_points: int = 60
    max_parallax_3d_distance: float = 500.0
    max_parallax_3d_median_distance: float = 20.0
    min_candidate_pose_disimilarity: float = 0.3
    max_pose_contribution_z: float = 0.66
    ransac_iterations: int = 90
    max_epipolar_error: float = 3.5
    min_pixel_spread: float = 40.0
    final_ba_huber_width: float = 0.9
    final_ba_max_outlier_error: float = 4.0
    final_ba_max_outlier_error_scale: float = 0.75
    final_ba_steps: int = 15
    max_hamming_dist: int = 30
    min_hamming_diff: int = 1


class InitResult(NamedTuple):
    succeeded: torch.Tensor     # () bool
    pose2: Pose                 # frame-2 world→camera (frame 1 = identity)
    points: torch.Tensor        # (N, 3) triangulated points (world)
    point_valid: torch.Tensor   # (N,) bool: survived every gate and BA
    feat1: torch.Tensor         # (N,) int32 feature index in frame 1
    feat2: torch.Tensor         # (N,) int32 feature index in frame 2
    match_count: torch.Tensor   # () int32


def init_settings(settings) -> InitSettings:
    """InitSettings from a session's MageSlamSettings, as the reference's
    `_try_initialize` builds them (pipeline.py:683-715)."""
    ms = settings.MonoSettings.MonoMapInitializationSettings
    return InitSettings(
        fundamental_transfer_error_threshold=ms.FundamentalTransferErrorThreshold,
        min_feature_matches=ms.MinFeatureMatches,
        min_scoring_inliers=ms.MinScoringInliers,
        min_inlier_percentage=ms.MinInlierPercentage,
        min_initial_map_points=ms.MinInitialMapPoints,
        min_map_points=ms.MinMapPoints,
        max_parallax_3d_distance=ms.MaxParallax3dDistance,
        max_parallax_3d_median_distance=ms.MaxParallax3dMedianDistance,
        min_candidate_pose_disimilarity=ms.MinCandidatePoseDisimilarity,
        max_pose_contribution_z=ms.MaxPoseContributionZ,
        ransac_iterations=ms.RansacIterationsForModels,
        max_epipolar_error=ms.MaxEpipolarError,
        min_pixel_spread=ms.MinPixelSpread,
        final_ba_huber_width=ms.BundleAdjustmentHuberWidth,
        # batched LM steps are not g2o's inner-loop steps: 15 is the floor
        final_ba_steps=max(ms.BundleAdjustmentG2OSteps, 15),
        max_hamming_dist=ms.FivePointMatchingSettings.MaxHammingDistance,
        min_hamming_diff=ms.FivePointMatchingSettings.MinHammingDifference,
    )


def _sample_spread_ok(xy1, xy2, samples, min_spread):
    """Per RANSAC sample (B, 5): every pair at least min_spread apart in
    both frames (MapInitialization.cpp:215-236)."""
    p1, p2 = xy1[samples], xy2[samples]                                # (B, 5, 2)
    d1 = torch.sum((p1[:, :, None] - p1[:, None, :]) ** 2, dim=-1)
    d2 = torch.sum((p2[:, :, None] - p2[:, None, :]) ** 2, dim=-1)
    eye = torch.eye(5, dtype=torch.bool, device=xy1.device)
    far = (d1 >= min_spread ** 2) & (d2 >= min_spread ** 2) | eye[None]
    return far.all(dim=2).all(dim=1)


def _homogeneous(xy):
    return torch.cat([xy, torch.ones_like(xy[:, :1])], dim=-1)


def _symmetric_transfer_score(F, xy1, xy2, match_ok, thr):
    """ScoreFundamentalMatrix (MapInitialization.cpp:279-323): symmetric
    epipolar distance², (thr - d²) summed over double inliers. F (C, 3, 3)
    frame 1 → frame 2. Returns (score (C,), inliers (C,))."""
    h1, h2 = _homogeneous(xy1), _homogeneous(xy2)
    l2 = torch.einsum("cij,mj->cmi", F, h1)
    l1 = torch.einsum("cji,mj->cmi", F, h2)
    d12 = torch.einsum("cmi,mi->cm", l2, h2) ** 2 / (l2[..., 0] ** 2 + l2[..., 1] ** 2
                                                     + 1e-20)
    d21 = torch.einsum("cmi,mi->cm", l1, h1) ** 2 / (l1[..., 0] ** 2 + l1[..., 1] ** 2
                                                     + 1e-20)
    inlier = (d12 < thr) & (d21 < thr) & match_ok[None, :]
    score = torch.sum(torch.where(inlier, (thr - d12) + (thr - d21), 0.0), dim=1)
    return score, torch.sum(inlier.to(torch.int32), dim=1)


def _draw_samples(draws, match_ok, mxy1, mxy2, spread_sq):
    """Greedy masked-Gumbel 5-sets (map_init.py:159-180), all hypotheses at
    once: each pick excludes candidates within min_spread of the picks
    before it; with none left it falls back to any valid match."""
    base = torch.where(match_ok, 0.0, -1e12)
    ok = match_ok.expand(draws.shape[0], -1)
    picks = []
    for t in range(5):
        pick = torch.argmax(draws[:, t] + base + torch.where(ok, 0.0, -1e9), dim=1)
        picks.append(pick)
        d1 = torch.sum((mxy1[None] - mxy1[pick][:, None]) ** 2, dim=-1)
        d2 = torch.sum((mxy2[None] - mxy2[pick][:, None]) ** 2, dim=-1)
        ok = ok & (d1 >= spread_sq) & (d2 >= spread_sq)
    return torch.stack(picks, dim=1)


def _k_inverse(cam):
    fx, fy, cx, cy = cam[0], cam[1], cam[2], cam[3]
    zero, one = torch.zeros_like(fx), torch.ones_like(fx)
    return torch.stack([torch.stack([1.0 / fx, zero, -cx / fx]),
                        torch.stack([zero, 1.0 / fy, -cy / fy]),
                        torch.stack([zero, zero, one])])


def _eval_poses(poses4: Pose, best_E, Kinv, cam, n1, n2, mxy1, mxy2, match_ok,
                n_matches, s: InitSettings):
    """Scores of the four decompositions of best_E (map_init.py:212-273).
    Returns (scores (4,), good (4, N), X (4, N, 3))."""
    fx, fy, cx, cy = cam[0], cam[1], cam[2], cam[3]
    max_epi = 2.0 * s.max_epipolar_error
    pose = Pose(poses4.R[:, None], poses4.t[:, None])                 # (4, 1)
    right_ok = poses4.R[:, 0, 0] > 0.0
    X = triangulate_midpoint_pair(pose, n1, n2)                        # (4, N, 3)
    z1 = X[..., 2]
    scale = 1.0 / torch.clamp_min(torch.sum(poses4.center() ** 2, dim=-1), 1e-12)
    Xc2 = pose.transform(X)
    front = (z1 > 0) & (Xc2[..., 2] > 0)
    parallax_ok = z1 * scale[:, None] <= s.max_parallax_3d_distance
    # symmetric epipolar error in pixels against best_E's fundamental
    Fp = Kinv.T @ best_E @ Kinv
    h1, h2 = _homogeneous(mxy1), _homogeneous(mxy2)
    l2 = h1 @ Fp.T
    l1 = h2 @ Fp
    e12 = torch.abs(torch.sum(l2 * h2, -1)) / torch.sqrt(l2[:, 0] ** 2 + l2[:, 1] ** 2
                                                         + 1e-20)
    e21 = torch.abs(torch.sum(l1 * h1, -1)) / torch.sqrt(l1[:, 0] ** 2 + l1[:, 1] ** 2
                                                         + 1e-20)
    epi = e12 + e21
    # the triangulated point must reproject into both frames
    z1s = torch.where(z1.abs() < 1e-9, 1e-9, z1)
    r1 = torch.hypot(fx * X[..., 0] / z1s + cx - mxy1[:, 0],
                     fy * X[..., 1] / z1s + cy - mxy1[:, 1])
    z2s = torch.where(Xc2[..., 2].abs() < 1e-9, 1e-9, Xc2[..., 2])
    r2 = torch.hypot(fx * Xc2[..., 0] / z2s + cx - mxy2[:, 0],
                     fy * Xc2[..., 1] / z2s + cy - mxy2[:, 1])
    reproj_ok = (r1 < max_epi) & (r2 < max_epi)
    good = match_ok & front & parallax_ok & (epi < max_epi) & reproj_ok
    p_score = torch.sum(torch.where(good, max_epi - epi, 0.0), dim=1) * right_ok
    n_good = torch.sum(good.to(torch.int32), dim=1)
    depth_sorted = torch.sort(torch.where(good, z1, torch.inf), dim=1).values
    med = torch.gather(depth_sorted, 1, (n_good // 2).to(torch.int64)[:, None])[:, 0]
    nm = torch.clamp_min(n_matches.to(torch.float32), 1.0)
    pct_ok = ((n_good >= s.min_scoring_inliers)
              & (n_good.to(torch.float32) / nm > s.min_inlier_percentage)
              & (med <= s.max_parallax_3d_median_distance))
    return torch.where(pct_ok, p_score, 0.0), good, X


def try_initialize_pair(xy1, desc1, valid1, xy2, desc2, valid2, cam, draws,
                        settings: InitSettings = InitSettings()) -> InitResult:
    """One initialization attempt on an undistorted frame pair. Features are
    (N, ...); draws (B, 5, N) Gumbel noise, B the RANSAC batch. The result's
    slots are frame 1's features."""
    N = xy1.shape[0]
    dev = xy1.device
    B = draws.shape[0]
    fx, fy, cx, cy = cam[0], cam[1], cam[2], cam[3]

    # ---- 1. match ----
    m_idx, _ = match_two_way(desc1, valid1, desc2, valid2, settings.max_hamming_dist,
                             settings.min_hamming_diff)
    match_ok = m_idx >= 0
    n_matches = torch.sum(match_ok.to(torch.int32))
    m_safe = torch.where(match_ok, m_idx, 0)
    mxy1, mxy2 = xy1, xy2[m_safe.to(torch.int64)]
    n1 = torch.stack([(mxy1[:, 0] - cx) / fx, (mxy1[:, 1] - cy) / fy], dim=-1)
    n2 = torch.stack([(mxy2[:, 0] - cx) / fx, (mxy2[:, 1] - cy) / fy], dim=-1)

    # ---- 2. RANSAC 5-point ----
    spread_sq = torch.tensor(settings.min_pixel_spread, dtype=torch.float32,
                             device=dev) ** 2
    samples = _draw_samples(draws, match_ok, mxy1, mxy2, spread_sq)     # (B, 5)
    spread_ok = _sample_spread_ok(mxy1, mxy2, samples, settings.min_pixel_spread)
    # in float64: the float32 roots move with the SVD's null-space basis,
    # which differs between the CPU and the card, enough to move the
    # winner's median depth across its gate (tools/init_gauge.py --port)
    E, e_valid = five_point_essential(n1[samples].double(), n2[samples].double())
    E_flat = E.to(torch.float32).reshape(B * MAX_ROOTS, 3, 3)
    cand_ok = (e_valid & spread_ok[:, None]).reshape(-1)
    Kinv = _k_inverse(cam)
    F = Kinv.T @ E_flat @ Kinv
    score, inliers = _symmetric_transfer_score(
        F, mxy1, mxy2, match_ok, settings.fundamental_transfer_error_threshold)
    nm = torch.clamp_min(n_matches.to(torch.float32), 1.0)
    qualified = (cand_ok & (inliers >= settings.min_scoring_inliers)
                 & (inliers.to(torch.float32) / nm > settings.min_inlier_percentage))
    score = torch.where(qualified, score, 0.0)
    best_c = torch.argmax(score)
    best_E = E_flat[best_c]
    have_candidate = score[best_c] > 0.0

    # ---- 3. pose disambiguation over the four decompositions ----
    poses4 = decompose_essential(best_E)
    scores4, good4, X4 = _eval_poses(poses4, best_E, Kinv, cam, n1, n2, mxy1, mxy2,
                                     match_ok, n_matches, settings)
    order = torch.sort(-scores4, stable=True).indices
    best_p, next_p = order[0], order[1]
    s_best, s_next = scores4[best_p], scores4[next_p]
    dissimilar = ((s_best - s_next) / torch.clamp_min(s_best, 1e-12)
                  >= settings.min_candidate_pose_disimilarity)
    pose2 = Pose(poses4.R[best_p], poses4.t[best_p])
    z_ok = pose2.center()[2].abs() <= settings.max_pose_contribution_z
    pose_ok = have_candidate & (s_best > 0) & dissimilar & z_ok
    inlier_mask = good4[best_p] & pose_ok

    # ---- refined triangulation (DLT) of the accepted correspondences ----
    X = triangulate_dlt(cam, Pose.identity(device=dev), mxy1, cam, pose2, mxy2)
    X = torch.where(torch.isfinite(X).all(dim=-1, keepdim=True), X, X4[best_p])

    # ---- 4. init BA: frame 1 fixed, frame 2 and the points free ----
    problem = empty_problem(2, N, 2 * N, device=dev)
    problem = problem._replace(
        poses=Pose(torch.stack([torch.eye(3, device=dev), pose2.R]),
                   torch.stack([torch.zeros(3, device=dev), pose2.t])),
        intrinsics=cam[None].expand(2, 4).clone(),
        cam_fixed=torch.tensor([True, False], device=dev),
        cam_valid=torch.tensor([True, True], device=dev),
        points=X,
        pt_valid=inlier_mask,
        obs_cam=torch.cat([torch.zeros(N, dtype=torch.int32, device=dev),
                           torch.ones(N, dtype=torch.int32, device=dev)]),
        obs_pt=torch.arange(N, dtype=torch.int32, device=dev).repeat(2),
        obs_uv=torch.cat([mxy1, mxy2], dim=0),
        obs_info=torch.cat([inlier_mask, inlier_mask]).to(torch.float32),
    )
    # no tether has weight here: the same optimum without the tether bank
    problem = without_tethers(problem)
    widths = settings.final_ba_huber_width * torch.tensor(0.95) ** torch.arange(
        settings.final_ba_steps, dtype=torch.float32)
    state, _, _ = step_bundle_adjust(problem, BAState.from_problem(problem),
                                     widths.tolist(),
                                     settings.final_ba_max_outlier_error ** 2)
    alive = (state.obs_info[:N] > 0) & (state.obs_info[N:] > 0) & inlier_mask
    n_points = torch.sum(alive.to(torch.int32))

    # ---- 5. validation ----
    ok = (pose_ok & (n_matches >= settings.min_feature_matches)
          & (n_points >= settings.min_map_points))
    return InitResult(
        succeeded=ok,
        pose2=Pose(state.poses.R[1], state.poses.t[1]),
        points=state.points,
        point_valid=alive & ok,
        feat1=torch.arange(N, dtype=torch.int32, device=dev),
        feat2=m_safe,
        match_count=n_matches,
    )


def validate_third_frame(result: InitResult, anchor_desc, anchor_valid, third_xy,
                         third_desc, third_valid, cam, draws, min_pct: float = 0.5,
                         max_err: float = 8.0, ba_iters: int = 5,
                         max_hamming: int = 30, min_diff: int = 1) -> torch.Tensor:
    """Locate a third (middle) frame against the pair's points and require
    enough BA inliers (MapInitialization.cpp:699, MinThirdFrameMatchPercentage).
    draws (PNP_HYPOTHESES, N) Gumbel noise for pnp_ransac. Returns () bool."""
    m_idx, _ = match_two_way(anchor_desc, anchor_valid & result.point_valid,
                             third_desc, third_valid, max_hamming, min_diff)
    has = m_idx >= 0
    n_matches = torch.sum(has.to(torch.int32))
    uv = third_xy[torch.where(has, m_idx, 0).to(torch.int64)]
    pnp = pnp_ransac(result.points, uv, has, cam, draws,
                     max_reprojection_error=max_err, min_inliers=10)
    _, chi2, depth = optimize_pose(pnp.pose, cam, result.points, uv,
                                   pnp.inliers.to(torch.float32), huber_width=4.0,
                                   num_iters=ba_iters)
    inlier = has & (chi2 <= max_err ** 2) & (depth > 0)
    pct = torch.sum(inlier.to(torch.float32)) / torch.clamp_min(
        n_matches.to(torch.float32), 1.0)
    return pnp.ok & (pct >= min_pct)
