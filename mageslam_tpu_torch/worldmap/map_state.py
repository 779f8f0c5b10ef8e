"""MapState: keyframe and map point banks as padded tensors (port of
mageslam_tpu/worldmap/map_state.py).

Derived structures (membership, per-point octave histograms, mean view
directions, representative descriptors) are recomputed by batched
reductions when needed, as in the reference. Descriptor words are int32 bit
views of the reference's uint32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.se3 import Pose
from ..ops.hamming import popcount32
from ..ops.indexing import pair_index, scatter_drop, set_drop, topk_stable


class MapState(NamedTuple):
    """All SLAM map state. K keyframe slots, P point slots, N feature slots,
    T tether slots. Field order is the reference's (snapshot leaf order)."""

    # --- keyframes ---
    kf_valid: torch.Tensor      # (K,) bool
    kf_fixed: torch.Tensor      # (K,) bool
    kf_immortal: torch.Tensor   # (K,) bool
    kf_pose: Pose               # R (K,3,3), t (K,3) world→camera
    kf_cam: torch.Tensor        # (K, 4) fx, fy, cx, cy
    kf_frame_id: torch.Tensor   # (K,) int32
    kf_order: torch.Tensor      # (K,) int32 insertion sequence number
    kf_kp_xy: torch.Tensor      # (K, N, 2) f32
    kf_kp_octave: torch.Tensor  # (K, N) int32
    kf_desc: torch.Tensor       # (K, N, 8) int32 descriptor bits
    kf_kp_valid: torch.Tensor   # (K, N) bool
    kf_assoc: torch.Tensor      # (K, N) int32 point slot or -1
    kf_member: torch.Tensor     # (K, P) bool: keyframe k observes point p

    # --- map points ---
    mp_valid: torch.Tensor          # (P,) bool
    mp_pos: torch.Tensor            # (P, 3) f32
    mp_desc: torch.Tensor           # (P, 8) int32 representative descriptor
    mp_mean_dir: torch.Tensor       # (P, 3) f32
    mp_dmin: torch.Tensor           # (P,) f32
    mp_dmax: torch.Tensor           # (P,) f32
    mp_refine_count: torch.Tensor   # (P,) int32
    mp_created_order: torch.Tensor  # (P,) int32
    mp_found: torch.Tensor          # (P,) int32
    mp_predicted: torch.Tensor      # (P,) int32

    # --- keyframe tethers ---
    tether_owner: torch.Tensor      # (T,) int32
    tether_origin: torch.Tensor     # (T,) int32
    tether_kind: torch.Tensor       # (T,) int32
    tether_pose: Pose               # (T,)
    tether_distance: torch.Tensor   # (T,) f32
    tether_weight: torch.Tensor     # (T,) f32

    # --- counters ---
    next_order: torch.Tensor        # () int32

    @property
    def capacity(self) -> tuple[int, int, int]:
        K, N = self.kf_assoc.shape
        return K, self.mp_valid.shape[0], N

    def keyframe_centers(self) -> torch.Tensor:
        """(K, 3) camera centers in world space."""
        return self.kf_pose.center()


def empty_map(max_keyframes: int, max_points: int, max_features: int,
              max_tethers: int = 16, device=None) -> MapState:
    K, P, N, T = max_keyframes, max_points, max_features, max_tethers

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    i32, f32, b = torch.int32, torch.float32, torch.bool
    return MapState(
        kf_valid=full((K,), False, b),
        kf_fixed=full((K,), False, b),
        kf_immortal=full((K,), False, b),
        kf_pose=Pose.identity((K,), device=device),
        kf_cam=torch.tensor([[1.0, 1.0, 0.0, 0.0]], dtype=f32, device=device).repeat(K, 1),
        kf_frame_id=full((K,), -1, i32),
        kf_order=full((K,), -1, i32),
        kf_kp_xy=full((K, N, 2), 0.0, f32),
        kf_kp_octave=full((K, N), 0, i32),
        kf_desc=full((K, N, 8), 0, i32),
        kf_kp_valid=full((K, N), False, b),
        kf_assoc=full((K, N), -1, i32),
        kf_member=full((K, P), False, b),
        mp_valid=full((P,), False, b),
        mp_pos=full((P, 3), 0.0, f32),
        mp_desc=full((P, 8), 0, i32),
        mp_mean_dir=full((P, 3), 0.0, f32),
        mp_dmin=full((P,), 0.0, f32),
        mp_dmax=full((P,), 0.0, f32),
        mp_refine_count=full((P,), 0, i32),
        mp_created_order=full((P,), -1, i32),
        mp_found=full((P,), 0, i32),
        mp_predicted=full((P,), 0, i32),
        tether_owner=full((T,), -1, i32),
        tether_origin=full((T,), -1, i32),
        tether_kind=full((T,), 0, i32),
        tether_pose=Pose.identity((T,), device=device),
        tether_distance=full((T,), 1.0, f32),
        tether_weight=full((T,), 0.0, f32),
        next_order=full((), 0, i32),
    )


def predict_octave(distance: torch.Tensor, dmin: torch.Tensor,
                   scale_factor: float) -> torch.Tensor:
    """ComputeOctave (MappingMath.h:13-16): expected pyramid level when
    viewing a point from `distance` given its dMin."""
    ratio = torch.clamp_min(distance / torch.clamp_min(dmin, 1e-12), 1e-12)
    log2_scale = torch.log2(torch.tensor(scale_factor, dtype=torch.float32,
                                         device=distance.device))
    return torch.round(torch.log2(ratio) / log2_scale - 0.5).to(torch.int32)


def grow_map(ms: MapState, max_keyframes: int, max_points: int) -> MapState:
    """Copy the map into larger keyframe and point banks (bucketed capacity
    growth). Slot ids are preserved: capacity only appends empty slots, which
    carry `empty_map`'s fill values."""
    K, P, N = ms.capacity
    if max_keyframes < K or max_points < P:
        raise ValueError(f"grow_map: {(K, P)} cannot shrink to "
                         f"{(max_keyframes, max_points)}")
    base = empty_map(max_keyframes, max_points, N,
                     max_tethers=ms.tether_owner.shape[0],
                     device=ms.kf_valid.device)

    def pad_into(empty_leaf, leaf):
        if isinstance(leaf, Pose):
            return Pose(pad_into(empty_leaf.R, leaf.R), pad_into(empty_leaf.t, leaf.t))
        if empty_leaf.shape == leaf.shape:
            return leaf
        out = empty_leaf.clone()
        out[tuple(slice(0, n) for n in leaf.shape)] = leaf.to(out.dtype)
        return out

    return MapState(*(pad_into(e, l) for e, l in zip(base, ms)))


def compute_dmin_dmax(distance: torch.Tensor, octave: torch.Tensor,
                      num_levels: int, scale_factor: float):
    """Scale-invariance viewing range (Map/MappingMath.h:32-41)."""
    oct_f = octave.to(torch.float32)
    scale = torch.tensor(scale_factor, dtype=torch.float32, device=distance.device)
    dmax = distance * scale ** (num_levels - (oct_f + 0.5))
    dmin = distance * scale ** (-(oct_f + 0.5))
    return dmin, dmax


def refinement_confidence(refine_count: torch.Tensor) -> torch.Tensor:
    """MapPointRefinementConfidence (MappingMath.h:43-50): observation
    information scaling, approaching 1 after about 5 refinements."""
    rc = refine_count.to(torch.float32)
    return 1.0 - 1.0 / (1.5 + rc) ** 2


def _valid_assoc(state: MapState) -> torch.Tensor:
    return (state.kf_assoc >= 0) & state.kf_kp_valid & state.kf_valid[:, None]


def point_keyframe_matrix(state: MapState) -> torch.Tensor:
    """(K, P) bool membership: keyframe k observes point p."""
    K, P, N = state.capacity
    valid = _valid_assoc(state)
    rows = torch.arange(K, device=valid.device)[:, None].expand(K, N)
    flat = torch.where(valid, pair_index(rows, state.kf_assoc, K, P), -1)
    member = scatter_drop(torch.zeros((K * P,), dtype=torch.int32, device=valid.device),
                          flat.reshape(-1), valid.reshape(-1).to(torch.int32), "max")
    return member.reshape(K, P) > 0


def refresh_membership(state: MapState) -> MapState:
    """Recompute the (K, P) membership cache from the association matrix."""
    return state._replace(kf_member=point_keyframe_matrix(state))


def point_octave_histogram(state: MapState, num_levels: int) -> torch.Tensor:
    """(P, L) int32: per map point, how many observing keyframes see it at
    each pyramid level."""
    K, P, N = state.capacity
    valid = _valid_assoc(state)
    octv = torch.clamp(state.kf_kp_octave, 0, num_levels - 1)
    flat = torch.where(valid, pair_index(state.kf_assoc, octv, P, num_levels), -1)
    hist = scatter_drop(torch.zeros((P * num_levels,), dtype=torch.int32,
                                    device=valid.device),
                        flat.reshape(-1), valid.reshape(-1).to(torch.int32), "add")
    return hist.reshape(P, num_levels)


def observation_counts(state: MapState) -> torch.Tensor:
    """(P,) int32: number of keyframes observing each point."""
    return torch.sum(point_keyframe_matrix(state).to(torch.int32), dim=0)


def _medoid_stats(state: MapState, pos, centers, top_kf, feat_idx, ok,
                  num_levels: int, scale_factor: float):
    """Representative (medoid) descriptor over the observations
    (top_kf[s, j], feat_idx[s, j]) flagged `ok`, and dMin / dMax from the
    representative keyframe's distance and octave."""
    feat_safe = torch.where(ok, feat_idx, 0)
    descs = state.kf_desc[top_kf, feat_safe]                      # (S, J, 8)
    octaves = state.kf_kp_octave[top_kf, feat_safe]               # (S, J)
    d = torch.sum(popcount32(descs[:, :, None, :] ^ descs[:, None, :, :]), dim=-1)
    pair_ok = ok[:, :, None] & ok[:, None, :]
    summed = torch.sum(torch.where(pair_ok, d, 0), dim=-1)
    summed = torch.where(ok, summed, torch.iinfo(torch.int32).max)
    rep = torch.argmin(summed, dim=-1, keepdim=True)              # first minimum
    rep_desc = torch.take_along_dim(descs, rep[:, :, None], dim=1)[:, 0]
    rep_kf = torch.take_along_dim(top_kf, rep, dim=1)[:, 0]
    rep_oct = torch.take_along_dim(octaves, rep, dim=1)[:, 0]
    dist = torch.linalg.norm(pos - centers[rep_kf], dim=-1)
    dmin, dmax = compute_dmin_dmax(dist, rep_oct, num_levels, scale_factor)
    return rep_desc, dmin, dmax


def _mean_direction(pos, centers, member) -> torch.Tensor:
    """normalize(sum over observing keyframes of normalize(pos - center))."""
    delta = pos[None, :, :] - centers[:, None, :]                 # (K, S, 3)
    unit = delta / torch.clamp_min(torch.linalg.norm(delta, dim=-1, keepdim=True), 1e-12)
    mean_dir = torch.sum(torch.where(member[..., None], unit, 0.0), dim=0)
    return mean_dir / torch.clamp_min(
        torch.linalg.norm(mean_dir, dim=-1, keepdim=True), 1e-12)


def refresh_point_stats(state: MapState, touched: torch.Tensor, num_levels: int,
                        scale_factor: float, max_obs_kf: int = 16) -> MapState:
    """Recompute mean view direction, representative descriptor and dMin /
    dMax of the points flagged in `touched` (P,) bool
    (MapPoint::UpdateRepresentativeDescriptor and
    UpdateMeanViewDirectionAndDistances, MapPoint.cpp:80-160). The medoid is
    taken over the first `max_obs_kf` observing keyframes in slot order."""
    K, P, N = state.capacity
    max_obs_kf = min(max_obs_kf, K)
    dev = state.kf_valid.device
    member = point_keyframe_matrix(state)                         # (K, P)
    n_obs = torch.sum(member.to(torch.int32), dim=0)
    centers = state.keyframe_centers()
    mean_dir = _mean_direction(state.mp_pos, centers, member)

    k_ids = torch.arange(K, dtype=torch.int32, device=dev)[:, None]
    obs_rank = torch.where(member, k_ids, K)
    top_kf = torch.argsort(obs_rank, dim=0, stable=True)[:max_obs_kf].T   # (P, J)
    top_ok = torch.take_along_dim(member.T, top_kf, dim=1)
    # the first feature of each observing keyframe that points at p
    hit = state.kf_assoc[top_kf] == torch.arange(P, dtype=torch.int32,
                                                 device=dev)[:, None, None]
    feat_idx = torch.argmax(hit.to(torch.int32), dim=-1)          # (P, J)
    ok = top_ok & torch.any(hit, dim=-1)
    rep_desc, dmin, dmax = _medoid_stats(state, state.mp_pos, centers, top_kf,
                                         feat_idx, ok, num_levels, scale_factor)

    upd = touched & state.mp_valid & (n_obs > 0)
    return state._replace(
        mp_mean_dir=torch.where(upd[:, None], mean_dir, state.mp_mean_dir),
        mp_desc=torch.where(upd[:, None], rep_desc, state.mp_desc),
        mp_dmin=torch.where(upd, dmin, state.mp_dmin),
        mp_dmax=torch.where(upd, dmax, state.mp_dmax),
    )


def refresh_point_stats_slots(state: MapState, slots: torch.Tensor,
                              num_levels: int, scale_factor: float,
                              max_obs_kf: int = 16,
                              fidx: torch.Tensor | None = None) -> MapState:
    """`refresh_point_stats` restricted to an explicit (S,) int32 slot list
    (-1 padded): the same result with (K, S) intermediates. With `fidx` (the
    (K, P) feature-index membership, worldmap/member_index.py) the (K, S)
    views are column gathers. Valid slots must be distinct."""
    K, P, N = state.capacity
    max_obs_kf = min(max_obs_kf, K)
    dev = state.kf_valid.device
    S = slots.shape[0]
    ok_s = (slots >= 0) & (slots < P)
    slot_safe = torch.where(ok_s, slots, 0)

    if fidx is not None:
        feat_s = torch.where(ok_s[None, :], fidx[:, slot_safe], -1)   # (K, S)
        member_s = feat_s >= 0
    else:
        s_of_p = set_drop(torch.full((P,), -1, dtype=torch.int32, device=dev),
                          torch.where(ok_s, slots, P),
                          torch.arange(S, dtype=torch.int32, device=dev))
        valid = _valid_assoc(state)
        s_tgt = torch.where(valid, s_of_p[torch.where(valid, state.kf_assoc, 0)], -1)
        rows = torch.arange(K, device=dev)[:, None].expand(K, N)
        flat = pair_index(rows, s_tgt, K, S).reshape(-1)
        # the first observing feature of each (keyframe, point)
        feats = torch.arange(N, dtype=torch.int32, device=dev)[None, :].expand(K, N)
        feat_s = scatter_drop(torch.full((K * S,), N, dtype=torch.int32, device=dev),
                              flat, feats.reshape(-1), "min").reshape(K, S)
        feat_s = torch.where(feat_s >= N, -1, feat_s)
        member_s = feat_s >= 0

    n_obs = torch.sum(member_s.to(torch.int32), dim=0)
    pos_s = state.mp_pos[slot_safe]
    centers = state.keyframe_centers()
    mean_dir = _mean_direction(pos_s, centers, member_s)

    # the first max_obs_kf observing keyframes, in ascending slot order
    k_ids = torch.arange(K, dtype=torch.int32, device=dev)[:, None]
    key = torch.where(member_s, K - k_ids, 0)
    vals = topk_stable(key.T, max_obs_kf)[0]                      # (S, J)
    top_ok = vals > 0
    top_kf = torch.where(top_ok, K - vals, 0)
    feat_idx = feat_s[top_kf, torch.arange(S, device=dev)[:, None]]
    ok = top_ok & (feat_idx >= 0)
    rep_desc, dmin, dmax = _medoid_stats(state, pos_s, centers, top_kf, feat_idx,
                                         ok, num_levels, scale_factor)

    upd = ok_s & state.mp_valid[slot_safe] & (n_obs > 0)
    w = torch.where(upd, slots, P)
    return state._replace(
        mp_mean_dir=set_drop(state.mp_mean_dir, w, mean_dir),
        mp_desc=set_drop(state.mp_desc, w, rep_desc),
        mp_dmin=set_drop(state.mp_dmin, w, dmin),
        mp_dmax=set_drop(state.mp_dmax, w, dmax),
    )
