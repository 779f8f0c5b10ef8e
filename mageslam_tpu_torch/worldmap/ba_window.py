"""Local and global BA problem assembly from MapState, and result write-back
(port of mageslam_tpu/worldmap/ba_window.py; ThreadSafeMap.cpp:868-960,
:353, :973 and the information scaling of BundleAdjust.cpp:140-147).

The assembled problem has Kb camera slots, Pb point slots and Ob observation
slots; masked compaction (a stable sort on a priority key) selects which map
entities occupy them, lowest slot first. Nothing reads the device from the
host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ba.problem import BAProblem, empty_problem
from ..geometry.se3 import Pose
from ..ops.indexing import add_drop, any_drop, pair_index, set_drop
from .covisibility import covisibility_matrix, membership_matrix
from .map_state import MapState, refinement_confidence, refresh_point_stats_slots
from .member_index import fidx_remove_obs, fidx_remove_points
from .operations import remove_map_points, row_of

_BIG = 1 << 30


class BAWindow(NamedTuple):
    """A BAProblem and the slot maps that write its results back."""

    problem: BAProblem
    cam_slot: torch.Tensor    # (Kb,) int32 global keyframe slot per BA camera, -1 pad
    pt_slot: torch.Tensor     # (Pb,) int32 global point slot per BA point, -1 pad
    obs_kf: torch.Tensor      # (Ob,) int32 global keyframe slot per observation
    obs_feat: torch.Tensor    # (Ob,) int32 feature index per observation
    theta: torch.Tensor       # () int32 covisibility threshold actually used


def _select_theta(covis_row, is_ki, kf_valid, member, theta0: int, upper: int,
                  lower: int, theta_min: int, step: int, max_steps: int):
    """The reference's threshold walk (ThreadSafeMap.cpp:944-958): theta
    steps up while there are too many connections and down while too few,
    evaluated over a fixed ladder since the count falls as theta rises. The
    count at a theta is every observation of every point that the keyframes
    connected at that theta observe."""
    dev = covis_row.device
    offsets = torch.arange(-max_steps, max_steps + 1, dtype=torch.int32, device=dev) * step
    thetas = torch.clamp_min(theta0 + offsets, theta_min)
    ladder = torch.cat([thetas, torch.tensor([theta0], dtype=torch.int32, device=dev)])
    kc = ((covis_row[None, :] >= ladder[:, None]) | is_ki[None, :]) & kf_valid[None, :]
    member_i = member.to(torch.int32)
    n_obs = torch.sum(member_i, dim=0)                                   # (P,)
    mp = torch.any(member[None] & kc[:, :, None], dim=1)                 # (T + 1, P)
    counts_all = torch.sum(torch.where(mp, n_obs[None, :], 0), dim=1)
    counts, c0 = counts_all[:-1], counts_all[-1]

    # too many: the smallest theta >= theta0 with count <= upper, else the
    # ladder's largest
    up_ok = (thetas >= theta0) & (counts <= upper)
    up_choice = torch.where(torch.any(up_ok),
                            torch.min(torch.where(up_ok, thetas, _BIG)),
                            torch.max(thetas))
    # too few: the largest theta < theta0 with count >= lower, else theta_min
    down_ok = (thetas < theta0) & (counts >= lower)
    down_choice = torch.where(torch.any(down_ok),
                              torch.max(torch.where(down_ok, thetas, -_BIG)),
                              theta_min)
    theta = torch.where(c0 > upper, up_choice,
                        torch.where(c0 < lower, torch.clamp_min(down_choice, theta_min),
                                    theta0))
    return theta.to(torch.int32)


def _compact(priority: torch.Tensor, n: int):
    """The n <= len(priority) entries of lowest priority key, in key order:
    (index (n,) int32, -1 where the key is _BIG; ok (n,) bool)."""
    vals, order = torch.sort(priority, stable=True)
    ok = vals[:n] < _BIG
    return torch.where(ok, order[:n], -1).to(torch.int32), ok


def build_local_ba_window(state: MapState, ki, max_cams: int, max_points: int,
                          max_obs: int, theta0: int = 15,
                          upper_connections: int = 2000,
                          lower_connections: int = 1500, theta_min: int = 15,
                          theta_step: int = 15, theta_max_steps: int = 1,
                          global_window: bool = False,
                          member: torch.Tensor | None = None) -> BAWindow:
    """Assemble the covisibility-bounded local BA problem around keyframe
    `ki` (a 0-d index tensor), or the whole map when `global_window`.
    Keyframes outside the covisible set that observe its points come in as
    fixed anchors (ThreadSafeMap.cpp:936-941). Pass a current `member`
    (K, P) to skip the membership rebuild."""
    K, P, N = state.capacity
    dev = state.kf_valid.device
    if member is None:
        member = membership_matrix(state)
    covis = covisibility_matrix(state, member)
    k_ids = torch.arange(K, device=dev)

    if global_window:
        theta = torch.zeros((), dtype=torch.int32, device=dev)
        kc_mask = state.kf_valid
    else:
        covis_row = row_of(covis, ki.to(torch.int64))
        is_ki = k_ids == ki
        theta = _select_theta(covis_row, is_ki, state.kf_valid, member, theta0,
                              upper_connections, lower_connections, theta_min,
                              theta_step, theta_max_steps)
        kc_mask = ((covis_row >= theta) | is_ki) & state.kf_valid

    mp_mask = torch.any(member & kc_mask[:, None], dim=0) & state.mp_valid
    kf_mask = (torch.any(member & mp_mask[None, :], dim=1) & state.kf_valid) | kc_mask

    # keyframes into Kb slots: the covisible window first, then the anchors
    kf_priority = torch.where(kf_mask, torch.where(kc_mask, 0, 1) * K + k_ids, _BIG)
    cam_slot, cam_ok = _compact(kf_priority, max_cams)
    cam_safe = torch.where(cam_ok, cam_slot, 0).to(torch.int64)
    cam_local = set_drop(torch.full((K,), -1, dtype=torch.int32, device=dev),
                         torch.where(cam_ok, cam_slot, K),
                         torch.arange(max_cams, dtype=torch.int32, device=dev))

    # points into Pb slots: selected and observed by a selected camera
    selected_cam = any_drop(K, cam_safe, cam_ok)
    mp_used = mp_mask & torch.any(member & selected_cam[:, None], dim=0)
    pt_slot, pt_ok = _compact(torch.where(mp_used, torch.arange(P, device=dev), _BIG),
                              max_points)
    pt_safe = torch.where(pt_ok, pt_slot, 0).to(torch.int64)
    pt_local = set_drop(torch.full((P,), -1, dtype=torch.int32, device=dev),
                        torch.where(pt_ok, pt_slot, P),
                        torch.arange(max_points, dtype=torch.int32, device=dev))

    # observations: every (selected keyframe, feature) whose point is selected
    assoc = state.kf_assoc
    a_safe = torch.where(assoc >= 0, assoc, 0).to(torch.int64)
    obs_ok = ((assoc >= 0) & state.kf_kp_valid & selected_cam[:, None]
              & (pt_local[a_safe] >= 0) & (cam_local[:, None] >= 0))
    flat_priority = torch.where(obs_ok.reshape(-1), torch.arange(K * N, device=dev), _BIG)
    o_idx, o_ok = _compact(flat_priority, max_obs)
    o_idx = torch.where(o_ok, o_idx, 0).to(torch.int64)
    o_kf = o_idx // N
    o_feat = o_idx % N

    o_point = a_safe[o_kf, o_feat]
    obs_cam = torch.where(o_ok, cam_local[o_kf], 0)
    obs_pt = torch.where(o_ok, pt_local[o_point], 0)
    obs_uv = state.kf_kp_xy[o_kf, o_feat]
    info = refinement_confidence(state.mp_refine_count[o_point])
    obs_info = torch.where(o_ok, torch.clamp_min(info, 1e-3), 0.0)

    fixed = state.kf_fixed[cam_safe] | ~kc_mask[cam_safe]
    problem = empty_problem(max_cams, max_points, max_obs,
                            n_tethers=state.tether_weight.shape[0], device=dev)
    # persisted keyframe tethers with both endpoints in the window
    # (BundleAdjust.cpp:57-113; cam1 = origin, cam2 = owner)
    to_safe = torch.where(state.tether_origin >= 0, state.tether_origin, 0).to(torch.int64)
    tw_safe = torch.where(state.tether_owner >= 0, state.tether_owner, 0).to(torch.int64)
    t_cam1 = cam_local[to_safe]
    t_cam2 = cam_local[tw_safe]
    t_ok = ((state.tether_weight > 0) & (state.tether_origin >= 0)
            & (state.tether_owner >= 0) & (t_cam1 >= 0) & (t_cam2 >= 0)
            & state.kf_valid[to_safe] & state.kf_valid[tw_safe])

    problem = problem._replace(
        poses=Pose(state.kf_pose.R[cam_safe], state.kf_pose.t[cam_safe]),
        intrinsics=state.kf_cam[cam_safe],
        cam_fixed=torch.where(cam_ok, fixed, True),
        cam_valid=cam_ok,
        points=state.mp_pos[pt_safe],
        pt_valid=pt_ok,
        obs_cam=obs_cam,
        obs_pt=obs_pt,
        obs_uv=obs_uv,
        obs_info=obs_info,
        tether_kind=state.tether_kind,
        tether_cam1=torch.where(t_ok, t_cam1, 0),
        tether_cam2=torch.where(t_ok, t_cam2, 0),
        tether_pose=state.tether_pose,
        tether_distance=state.tether_distance,
        tether_weight=torch.where(t_ok, state.tether_weight, 0.0),
    )
    return BAWindow(
        problem=problem,
        cam_slot=cam_slot,
        pt_slot=pt_slot,
        obs_kf=torch.where(o_ok, o_kf, -1).to(torch.int32),
        obs_feat=torch.where(o_ok, o_feat, -1).to(torch.int32),
        theta=theta,
    )


def apply_ba_results(state: MapState, window: BAWindow, poses: Pose, points,
                     outlier_obs, num_levels: int, scale_factor: float,
                     fidx: torch.Tensor | None = None):
    """ThreadSafeMap::AdjustPosesAndMapPoints (ThreadSafeMap.cpp:973-1046):
    write the optimized poses and points back, unassociate the outlier
    observations, bump the refinement counts, refresh the window points'
    statistics and remove points left with fewer than 2 observers.

    With `fidx` the observer recount and the statistics refresh read the
    index, and (state, fidx) is returned."""
    K, P, N = state.capacity
    dev = state.kf_valid.device
    cam_ok = (window.cam_slot >= 0) & ~window.problem.cam_fixed
    cam_w = torch.where(cam_ok, window.cam_slot, K)
    pt_ok = window.pt_slot >= 0
    pt_safe = torch.where(pt_ok, window.pt_slot, 0).to(torch.int64)
    pt_w = torch.where(pt_ok, window.pt_slot, P)

    state = state._replace(
        kf_pose=Pose(set_drop(state.kf_pose.R, cam_w, poses.R),
                     set_drop(state.kf_pose.t, cam_w, poses.t)),
        mp_pos=set_drop(state.mp_pos, pt_w, points),
        mp_refine_count=add_drop(state.mp_refine_count, pt_w, 1),
    )

    # unassociate outliers (BundleAdjust outliers → Map::RemoveAssociation)
    out_ok = outlier_obs & (window.obs_kf >= 0)
    flat = torch.where(out_ok, pair_index(window.obs_kf, window.obs_feat, K, N), -1)
    assoc = set_drop(state.kf_assoc.reshape(-1), flat, -1).reshape(K, N)
    state = state._replace(kf_assoc=assoc)

    S = window.pt_slot.shape[0]
    if fidx is not None:
        # mirror the outlier unassociations; a keyframe observes a point
        # through at most one feature
        p_o = pt_safe[window.problem.obs_pt.to(torch.int64)]
        fidx = fidx_remove_obs(fidx, window.obs_kf, p_o, out_ok)
        n_obs_p = torch.sum((fidx >= 0).to(torch.int32), dim=0)
        dead = any_drop(P, window.pt_slot, pt_ok & (n_obs_p[pt_safe] < 2))
        dead = state.mp_valid & dead
        state = remove_map_points(state, dead)
        fidx = fidx_remove_points(fidx, dead)
        state = refresh_point_stats_slots(state, window.pt_slot, num_levels,
                                          scale_factor, fidx=fidx)
        return state, fidx

    # only window points can have lost observations: count observers for
    # the (S,) window slots
    s_of_p = set_drop(torch.full((P,), -1, dtype=torch.int32, device=dev), pt_w,
                      torch.arange(S, dtype=torch.int32, device=dev))
    valid_a = (assoc >= 0) & state.kf_kp_valid & state.kf_valid[:, None]
    s_tgt = torch.where(valid_a, s_of_p[torch.where(valid_a, assoc, 0).to(torch.int64)], -1)
    n_obs_s = add_drop(torch.zeros((S,), dtype=torch.int32, device=dev),
                       s_tgt.reshape(-1), 1)
    dead = any_drop(P, window.pt_slot, pt_ok & (n_obs_s < 2))
    state = remove_map_points(state, state.mp_valid & dead)
    return refresh_point_stats_slots(state, window.pt_slot, num_levels, scale_factor)
