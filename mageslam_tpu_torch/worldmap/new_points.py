"""New map point creation for a freshly inserted keyframe (port of
mageslam_tpu/worldmap/new_points.py; Mapping/NewMapPointsCreation.cpp).

For the new keyframe Ki and its F nearest covisible keyframes Kc: match the
unassociated features two ways, gate the matches on geometry (epipolar
distance, cheirality, distance ratio, scale, parallax), cap the new points
per image grid cell, create them, then associate them into the other
covisible keyframes by a radius match at their projections.

The reference maps one function over the F neighbours. Here the neighbour
axis is a batch dimension written out: one `match_two_way` call serves all
F pairs (one launch of the fused kernel on the card), the gates run on
(F, N) tensors, and the F re-association matches go through the fused
radius-match kernel one neighbour at a time.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..geometry.epipolar import inverse_intrinsics
from ..geometry.se3 import Pose, hat
from ..geometry.triangulation import triangulate_midpoint
from ..ops.indexing import add_drop, set_drop
from ..ops.matching import match_two_way, radius_match
from .map_state import MapState, compute_dmin_dmax, predict_octave
from .member_index import fidx_add, fidx_set_rows
from .operations import create_map_points, row_of


class NewPointsResult(NamedTuple):
    state: MapState
    created: torch.Tensor       # () int32: number of points created
    slots: torch.Tensor         # (N,) int32: point slot per Ki feature or -1
    fidx: torch.Tensor | None = None   # updated feature-index membership


def _epipolar_distance(F: torch.Tensor, p_from: torch.Tensor, p_to: torch.Tensor):
    """Distance of p_to from the epipolar line F p_from, over (..., 2) points;
    F is (..., 3, 3) and broadcasts over the point axis."""
    one = torch.ones_like(p_from[..., :1])
    line = torch.einsum("...ij,...nj->...ni", F, torch.cat([p_from, one], dim=-1))
    num = torch.abs(torch.sum(line * torch.cat([p_to, one.expand(p_to.shape[:-1] + (1,))],
                                               dim=-1), dim=-1))
    return num / torch.sqrt(line[..., 0] ** 2 + line[..., 1] ** 2 + 1e-20)


def _fundamental(pose_a: Pose, cam_a, pose_b: Pose, cam_b) -> torch.Tensor:
    """F mapping pixels of camera a to epipolar lines in camera b, for
    undistorted pinhole calibrations; broadcasts over leading dimensions."""
    rel = pose_b.compose(pose_a.inverse())
    E = torch.matmul(hat(rel.t), rel.R)
    return torch.matmul(torch.matmul(inverse_intrinsics(cam_b).transpose(-1, -2), E),
                        inverse_intrinsics(cam_a))


def _project(pose: Pose, cam, X):
    """Pixels (u, v) and depth z of world points X (N, 3) in F cameras:
    pose (F,), cam (F, 4) -> (F, N) each."""
    Xc = torch.einsum("fij,nj->fni", pose.R, X) + pose.t[:, None, :]
    z = Xc[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-12, 1e-12, z)
    u = cam[:, None, 0] * Xc[..., 0] * inv_z + cam[:, None, 2]
    v = cam[:, None, 1] * Xc[..., 1] * inv_z + cam[:, None, 3]
    return u, v, z


def create_new_map_points(
    state: MapState,
    ki: torch.Tensor,                 # () index tensor: the new keyframe's slot
    covis: torch.Tensor,              # (K, K) int32 covisibility counts
    map_scale,                        # () f32 tensor or a number
    num_levels: int,
    pyramid_scale: float,
    image_width: float,
    image_height: float,
    image_border: float = 7.5,
    max_frames: int = 5,
    covis_theta: int = 15,
    max_epipolar_error: float = 4.0,
    min_distance_ratio: float = 2.0,
    min_parallax_degrees: float = 0.0238961594253207,
    min_kf_distance_sq: float = 0.0,
    grid_w: int = 4,
    grid_h: int = 3,
    max_grid_count: int = 6,
    max_hamming: int = 45,
    min_hamming_diff: int = 8,
    search_radius: float = 11.8816156,
    max_keyframe_angle_degrees: float = 60.0,
    max_new_points: int = 256,
    fidx: torch.Tensor | None = None,
) -> NewPointsResult:
    K, P, N = state.capacity
    dev = state.kf_valid.device
    F = min(max_frames, K)
    ki = ki.to(torch.int64)

    ki_pose = Pose(row_of(state.kf_pose.R, ki), row_of(state.kf_pose.t, ki))
    ki_cam = row_of(state.kf_cam, ki)
    ki_center = ki_pose.center()
    ki_xy = row_of(state.kf_kp_xy, ki)
    ki_oct = row_of(state.kf_kp_octave, ki)
    ki_desc = row_of(state.kf_desc, ki).contiguous()
    ki_assoc = row_of(state.kf_assoc, ki)
    ki_kp_valid = row_of(state.kf_kp_valid, ki)
    ki_unassoc = ki_kp_valid & (ki_assoc < 0)

    # nearest covisible keyframes by centre distance (NewMapPointsCreation
    # .cpp:216-222), without Ki itself and frames that are too close
    centers = state.keyframe_centers()
    d2 = torch.sum((centers - ki_center[None]) ** 2, dim=-1)
    connected = ((row_of(covis, ki) >= covis_theta) & state.kf_valid
                 & (torch.arange(K, device=dev) != ki))
    cand_kf = connected & (d2 >= min_kf_distance_sq * map_scale * map_scale)
    order = torch.argsort(torch.where(cand_kf, d2, torch.inf), stable=True)
    kc_slots = order[:F]                                            # (F,) distinct
    kc_ok = cand_kf[kc_slots]

    cos_min_parallax = math.cos(math.radians(min_parallax_degrees))

    # ---- the F Ki x Kc pairs as one batch ----
    kc_pose = Pose(state.kf_pose.R[kc_slots], state.kf_pose.t[kc_slots])
    kc_cam = state.kf_cam[kc_slots]                                 # (F, 4)
    kc_center = kc_pose.center()                                    # (F, 3)
    kc_xy = state.kf_kp_xy[kc_slots]                                # (F, N, 2)
    kc_oct = state.kf_kp_octave[kc_slots]
    kc_unassoc = state.kf_kp_valid[kc_slots] & (state.kf_assoc[kc_slots] < 0)

    m_idx, _ = match_two_way(
        ki_desc, (ki_unassoc[None, :] & kc_ok[:, None]).contiguous(),
        state.kf_desc[kc_slots], kc_unassoc, max_hamming, min_hamming_diff)
    has = m_idx >= 0                                                # (F, N)
    m_safe = torch.where(has, m_idx, 0).to(torch.int64)
    kc_xy_m = torch.take_along_dim(kc_xy, m_safe[..., None], dim=1)  # (F, N, 2)

    # epipolar gate, symmetric (:83-89)
    F_ki_kc = _fundamental(ki_pose, ki_cam, kc_pose, kc_cam)        # (F, 3, 3)
    F_kc_ki = _fundamental(kc_pose, kc_cam, ki_pose, ki_cam)
    ki_xy_f = ki_xy[None].expand(F, N, 2)
    e1 = _epipolar_distance(F_ki_kc, ki_xy_f, kc_xy_m)
    e2 = _epipolar_distance(F_kc_ki, kc_xy_m, ki_xy_f)
    epi_ok = (e1 + e2) <= 2.0 * max_epipolar_error

    # midpoint triangulation (TriangulatePointWorldSpace)
    X_f = triangulate_midpoint(
        ki_cam, ki_pose, ki_xy, kc_cam[:, None, :],
        Pose(kc_pose.R[:, None], kc_pose.t[:, None]), kc_xy_m)      # (F, N, 3)

    # cheirality in both frames (:95-101)
    z_ki = ki_pose.transform(X_f)[..., 2]
    z_kc = (torch.einsum("fij,fnj->fni", kc_pose.R, X_f) + kc_pose.t[:, None])[..., 2]
    front_ok = (z_ki > 0) & (z_kc > 0)

    # distance ratio (:117-126)
    d_ki_f = torch.linalg.norm(X_f - ki_center, dim=-1)
    d_kc = torch.linalg.norm(X_f - kc_center[:, None], dim=-1)
    baseline = torch.linalg.norm(ki_center[None] - kc_center, dim=-1) + 1e-12
    ratio_ok = (d_ki_f / baseline[:, None]) >= min_distance_ratio

    # scale test (:128-133): the octave predicted in Kc equals its keypoint's
    dmin_ki, _ = compute_dmin_dmax(d_ki_f, ki_oct[None], num_levels, pyramid_scale)
    pred_oct = predict_octave(d_kc, dmin_ki, pyramid_scale)
    scale_ok = torch.abs(pred_oct - torch.take_along_dim(kc_oct, m_safe, dim=1)) < 1

    # parallax (:53-64, :139-143)
    v1_f = (X_f - kc_center[:, None]) / torch.clamp_min(d_kc, 1e-12)[..., None]
    v2_f = (X_f - ki_center) / torch.clamp_min(d_ki_f, 1e-12)[..., None]
    par_ok = torch.sum(v1_f * v2_f, dim=-1) <= cos_min_parallax

    good_f = has & epi_ok & front_ok & ratio_ok & scale_ok & par_ok & kc_ok[:, None]

    # the first neighbour (nearest first) with a good match wins each feature
    first = torch.argmax(good_f.to(torch.int32), dim=0)             # (N,)
    any_good = torch.any(good_f, dim=0)
    feat_kc = torch.take_along_dim(m_safe, first[None, :], dim=0)[0].to(torch.int32)
    kc_of = kc_slots[first].to(torch.int32)
    X = torch.take_along_dim(X_f, first[None, :, None], dim=0)[0]
    v1 = torch.take_along_dim(v1_f, first[None, :, None], dim=0)[0]
    v2 = torch.take_along_dim(v2_f, first[None, :, None], dim=0)[0]
    d_ki = torch.take_along_dim(d_ki_f, first[None, :], dim=0)[0]

    # grid cap (NewPointMaxGridCount): associated keypoints prefill the
    # cells; candidates take cells in (neighbour rank, feature) order
    gx = torch.clamp((ki_xy[:, 0] * grid_w / image_width).to(torch.int32), 0, grid_w - 1)
    gy = torch.clamp((ki_xy[:, 1] * grid_h / image_height).to(torch.int32), 0, grid_h - 1)
    cell = gx + gy * grid_w
    n_cells = grid_w * grid_h
    assoc_mask = ki_kp_valid & (ki_assoc >= 0)
    existing = add_drop(torch.zeros((n_cells,), dtype=torch.int32, device=dev),
                        torch.where(assoc_mask, cell, n_cells), 1)

    feats = torch.arange(N, dtype=torch.int32, device=dev)
    cand_order = first.to(torch.int32) * N + feats
    same_cell = (cell[:, None] == cell[None, :]) & any_good[None, :] & any_good[:, None]
    earlier = cand_order[None, :] < cand_order[:, None]
    rank_in_cell = torch.sum((same_cell & earlier).to(torch.int32), dim=1)
    accept = any_good & ((existing[cell.to(torch.int64)] + rank_in_cell) < max_grid_count)

    # cap on new points per call
    order_key = torch.where(accept, cand_order, 1 << 30)
    rank_total = torch.argsort(torch.argsort(order_key, stable=True), stable=True)
    accept = accept & (rank_total < max_new_points)

    # viewing statistics at creation (Ki is the representative, :160-168)
    mean_dir = v1 + v2
    mean_dir = mean_dir / torch.clamp_min(
        torch.linalg.norm(mean_dir, dim=-1, keepdim=True), 1e-12)
    dmin, dmax = compute_dmin_dmax(d_ki, ki_oct, num_levels, pyramid_scale)

    ki_rows = ki.to(torch.int32).expand(N)
    new_state, slots = create_map_points(state, X, ki_desc, ki_rows, feats,
                                         kc_of, feat_kc, accept)
    created_mask = accept & (slots >= 0)
    slot_w = torch.where(created_mask, slots, P)
    new_state = new_state._replace(
        mp_mean_dir=set_drop(new_state.mp_mean_dir, slot_w, mean_dir),
        mp_dmin=set_drop(new_state.mp_dmin, slot_w, dmin),
        mp_dmax=set_drop(new_state.mp_dmax, slot_w, dmax),
    )

    # ---- LocallyAssociateNewAssociations (:332-425): match the new points
    # into the other covisible keyframes at their projections ----
    map_border = image_border - search_radius / 2.0
    cos_max_angle = math.cos(math.radians(max_keyframe_angle_degrees))
    u, v, z = _project(kc_pose, kc_cam, X)                          # (F, N)
    in_border = ((u >= map_border) & (u < image_width - map_border)
                 & (v >= map_border) & (v < image_height - map_border))
    angle_ok = torch.einsum("ni,fi->fn", mean_dir, kc_pose.forward()) >= cos_max_angle
    dist = torch.linalg.norm(X[None] - kc_center[:, None], dim=-1)
    range_ok = (dist >= dmin) & (dist <= dmax)
    pred = predict_octave(dist, dmin[None].expand(F, N), pyramid_scale)
    oct_ok = (pred >= 0) & (pred <= num_levels)
    not_originating = kc_of[None, :] != kc_slots[:, None]
    cand = (created_mask[None] & (z > 0) & in_border & angle_ok & range_ok & oct_ok
            & not_originating)
    q_xy = torch.stack([u, v], dim=-1)                              # (F, N, 2)
    q_oct = torch.clamp(pred, 0, num_levels - 1)

    kc_assoc = new_state.kf_assoc[kc_slots]                         # (F, N)
    kc_desc = new_state.kf_desc[kc_slots]
    kc_unassoc2 = new_state.kf_kp_valid[kc_slots] & (kc_assoc < 0)
    rows_new = []
    for f in range(F):
        r_idx, _ = radius_match(
            ki_desc, q_xy[f], q_oct[f], cand[f], kc_desc[f], kc_xy[f], kc_oct[f],
            kc_unassoc2[f], float(search_radius), max_hamming, min_hamming_diff)
        hit = (r_idx >= 0) & kc_ok[f]
        # distinct targets after the dedup: the set has one writer a slot
        rows_new.append(set_drop(kc_assoc[f], torch.where(hit, r_idx, N),
                                 torch.where(hit, slots, -1)))
    rows_new = torch.stack(rows_new)
    # kc_slots comes from a permutation: distinct rows
    new_state = new_state._replace(
        kf_assoc=new_state.kf_assoc.index_put((kc_slots,), rows_new))

    if fidx is not None:
        # Ki gains the created points at their originating features and the
        # originating Kc rows at their matched features; then the F
        # re-association rows are rebuilt from their final association rows
        pts = torch.where(created_mask, slots, 0)
        fidx = fidx_add(fidx, ki_rows, feats, pts, created_mask)
        fidx = fidx_add(fidx, kc_of, feat_kc, pts, created_mask)
        fidx = fidx_set_rows(fidx, kc_slots.to(torch.int32), rows_new,
                             new_state.kf_kp_valid[kc_slots],
                             torch.ones_like(kc_ok), kf_valid=new_state.kf_valid)

    return NewPointsResult(
        state=new_state,
        created=torch.sum(created_mask.to(torch.int32)),
        slots=torch.where(created_mask, slots, -1),
        fidx=fidx,
    )
