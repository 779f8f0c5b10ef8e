"""Stereo map initialization from a pair with known extrinsics (port of
mageslam_tpu/tracking/stereo_init.py; the reference's Stereo/StereoMapInit).

The extrinsics are normalized to a unit baseline (map units are
baselines). The pair is matched two ways (`ops/matching.match_two_way`, the
fused kernel on the card), the matches are triangulated with the known
relative pose (DLT, the midpoint where DLT is not finite) and gated by
cheirality in both views, the symmetric epipolar error, the distance ratio
and the depth limit. The init BA (15 steps, camera 0 fixed) holds the rig
with a relative-transform tether at InitializationTetherStrength. Nothing
is read back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ba.problem import TETHER_TRANSFORM, BAState, empty_problem
from ..ba.step import step_bundle_adjust
from ..geometry.se3 import Pose
from ..geometry.triangulation import triangulate_dlt, triangulate_midpoint
from ..ops.matching import match_two_way
from .map_init import InitResult


class StereoInitSettings(NamedTuple):
    """StereoMapInitializationSettings (MageSettings.h:135-147)."""

    min_init_map_points: int = 15
    min_feature_matches: int = 40
    max_outlier_error: float = 2.5
    max_epipolar_error: float = 5.5
    min_accepted_distance_ratio: float = 2.0
    initialization_tether_strength: float = 50.0
    max_depth_meters: float = 2.3
    max_hamming: int = 30          # OrbMatcherSettings (MageSettings.h:36-39)
    min_hamming_diff: int = 1
    ba_steps: int = 15
    ba_huber_width: float = 1.8


def stereo_settings(settings) -> StereoInitSettings:
    """StereoInitSettings from a session's MageSlamSettings, as the
    reference's `process_stereo_features` builds them (pipeline.py:484-499)."""
    ss = settings.StereoSettings.StereoMapInitializationSettings
    return StereoInitSettings(
        min_init_map_points=ss.MinInitMapPoints,
        min_feature_matches=ss.MinFeatureMatches,
        max_outlier_error=ss.MaxOutlierError,
        max_epipolar_error=ss.MaxEpipolarError,
        min_accepted_distance_ratio=ss.MinAcceptedDistanceRatio,
        initialization_tether_strength=ss.InitializationTetherStrength,
        max_depth_meters=ss.MaxDepthMeters,
        max_hamming=ss.OrbMatcherSettings.MaxHammingDistance,
        min_hamming_diff=ss.OrbMatcherSettings.MinHammingDifference)


def _k_inverse(cam: torch.Tensor) -> torch.Tensor:
    zero, one = torch.zeros_like(cam[0]), torch.ones_like(cam[0])
    return torch.stack([
        torch.stack([1.0 / cam[0], zero, -cam[2] / cam[0]]),
        torch.stack([zero, 1.0 / cam[1], -cam[3] / cam[1]]),
        torch.stack([zero, zero, one])])


def stereo_initialize(xy0, desc0, valid0, xy1, desc1, valid1, cam,
                      frame0_to_frame1: Pose,
                      settings: StereoInitSettings = StereoInitSettings(),
                      cam2=None) -> InitResult:
    """Bootstrap a map from a stereo pair. `cam` (4,) is camera 0's
    undistorted intrinsics, `cam2` camera 1's (a mixed rig's rescaled
    secondary; None: `cam`). Camera 0 is the identity; `pose2` is camera 1
    in baseline units."""
    dev = xy0.device
    N = xy0.shape[0]
    cam2 = cam if cam2 is None else cam2

    # unit baseline (StereoMapInit.cpp:135-148)
    baseline = torch.linalg.norm(frame0_to_frame1.t)
    ok_baseline = baseline > 1e-5
    inv_b = 1.0 / torch.clamp_min(baseline, 1e-5)
    pose2 = Pose(frame0_to_frame1.R, frame0_to_frame1.t * inv_b)
    pose1 = Pose.identity(device=dev)

    m_idx, _ = match_two_way(desc0, valid0, desc1, valid1, settings.max_hamming,
                             settings.min_hamming_diff)
    match_ok = m_idx >= 0
    n_matches = torch.sum(match_ok.to(torch.int32))
    m_safe = torch.where(match_ok, m_idx, 0)
    uv1 = xy0
    uv2 = xy1[m_safe]

    # triangulate with the known relative pose
    X = triangulate_dlt(cam, pose1, uv1, cam2, pose2, uv2)
    X_mid = triangulate_midpoint(cam, pose1, uv1, cam2, pose2, uv2)
    X = torch.where(torch.isfinite(X).all(dim=-1, keepdim=True), X, X_mid)

    # gates: cheirality in both views, symmetric epipolar error, distance
    # ratio, depth
    z1 = pose1.transform(X)[:, 2]
    z2 = pose2.transform(X)[:, 2]
    t = pose2.t
    zero = torch.zeros_like(t[0])
    tx = torch.stack([torch.stack([zero, -t[2], t[1]]),
                      torch.stack([t[2], zero, -t[0]]),
                      torch.stack([-t[1], t[0], zero])])
    E = tx @ pose2.R
    F = _k_inverse(cam2).T @ E @ _k_inverse(cam)
    one = torch.ones_like(uv1[:, :1])
    h1 = torch.cat([uv1, one], dim=-1)
    h2 = torch.cat([uv2, one], dim=-1)
    l2 = torch.einsum("ij,mj->mi", F, h1)
    l1 = torch.einsum("ji,mj->mi", F, h2)
    e12 = torch.abs(torch.sum(l2 * h2, dim=-1)) / torch.sqrt(
        l2[:, 0] ** 2 + l2[:, 1] ** 2 + 1e-20)
    e21 = torch.abs(torch.sum(l1 * h1, dim=-1)) / torch.sqrt(
        l1[:, 0] ** 2 + l1[:, 1] ** 2 + 1e-20)
    epi_ok = (e12 + e21) <= 2.0 * settings.max_epipolar_error
    dist = torch.linalg.norm(X - pose1.center()[None], dim=-1)
    ratio_ok = dist >= settings.min_accepted_distance_ratio     # baseline = 1
    depth_ok = z1 <= settings.max_depth_meters * inv_b          # metric → baselines
    inlier = match_ok & (z1 > 0) & (z2 > 0) & epi_ok & ratio_ok & depth_ok

    # init BA, camera 0 fixed, the rig held by a transform tether
    problem = empty_problem(2, N, 2 * N, device=dev)

    def first(bank, value):
        out = bank.clone()
        out[0] = value
        return out

    problem = problem._replace(
        poses=Pose(torch.stack([pose1.R, pose2.R]), torch.stack([pose1.t, pose2.t])),
        intrinsics=torch.stack([cam, cam2]),
        cam_fixed=torch.tensor([True, False], device=dev),
        cam_valid=torch.tensor([True, True], device=dev),
        points=X,
        pt_valid=inlier,
        obs_cam=torch.cat([torch.zeros(N, dtype=torch.int32, device=dev),
                           torch.ones(N, dtype=torch.int32, device=dev)]),
        obs_pt=torch.arange(N, dtype=torch.int32, device=dev).repeat(2),
        obs_uv=torch.cat([uv1, uv2], dim=0),
        obs_info=torch.cat([inlier, inlier]).to(torch.float32),
        tether_kind=first(problem.tether_kind, TETHER_TRANSFORM),
        tether_cam1=first(problem.tether_cam1, 0),
        tether_cam2=first(problem.tether_cam2, 1),
        tether_pose=Pose(first(problem.tether_pose.R, pose2.R),
                         first(problem.tether_pose.t, pose2.t)),
        tether_weight=first(problem.tether_weight, settings.initialization_tether_strength),
    )
    widths = settings.ba_huber_width * torch.tensor(0.95) ** torch.arange(
        settings.ba_steps, dtype=torch.float32)
    state, _, _ = step_bundle_adjust(problem, BAState.from_problem(problem),
                                     widths.tolist(), settings.max_outlier_error ** 2)

    alive = (state.obs_info[:N] > 0) & (state.obs_info[N:] > 0) & inlier
    n_points = torch.sum(alive.to(torch.int32))
    ok = (ok_baseline & (n_matches >= settings.min_feature_matches)
          & (n_points >= settings.min_init_map_points))
    return InitResult(
        succeeded=ok,
        pose2=Pose(state.poses.R[1], state.poses.t[1]),
        points=state.points,
        point_valid=alive & ok,
        feat1=torch.arange(N, dtype=torch.int32, device=dev),
        feat2=m_safe,
        match_count=n_matches,
    )
