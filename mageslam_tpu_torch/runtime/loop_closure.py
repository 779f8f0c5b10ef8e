"""Loop closure: detection by place recognition, closure by a similarity
correction, a map-point merge and the Sim(3) essential graph (port of
mageslam_tpu/runtime/loop_closure.py; Tasks/LoopClosureWorker.{h,cpp} and
ThreadSafeMap::FindNonCovisibleSimilarKeyframeClusters).

detect (LoopClosureWorker::DetectLoop, :108-161): score every keyframe
against the new keyframe Ki, drop Ki and its covisible set, keep the
candidates scoring at least the lowest covisible score, cluster them by
covisibility (label propagation), keep the biggest cluster, relocalize Ki
against its best C keyframes and take the scale from the depths of the
keypoints associated in both views. The reference's `lax.cond` is a host
branch here: the gate is computed on the device and read once, and the
relocalization (with its random draws) runs only where a cluster
qualifies.

close (CloseLoop, :163-208, :333-374): move Ki's covisible set by the
similarity that takes Ki to its relocalized pose, merge the duplicate
points the relocalized associations reveal, then distribute the rest of
the error over the trajectory with the Sim(3) essential graph. The
caller's global BA (runtime/global_ba.py) polishes.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..ba.pose_graph import PoseGraphProblem, Sim3, optimize_pose_graph
from ..bow.index import BowIndex, query_keyframes
from ..geometry.se3 import Pose
from ..ops.indexing import topk_stable
from ..tracking.frame_state import TrackedFrame
from ..tracking.relocalization import relocalize
from ..worldmap.covisibility import covisibility_matrix
from ..worldmap.map_state import MapState
from ..worldmap.operations import merge_map_points, row_of


class LoopDetection(NamedTuple):
    detected: torch.Tensor       # () bool
    reloc_pose: Pose             # Ki's pose in the loop region
    reloc_assoc: torch.Tensor    # (N,) int32: Ki keypoints → cluster map points
    scale: torch.Tensor          # () f32: relocDepth / currDepth
    cluster_mask: torch.Tensor   # (K,) bool
    # slot identities at detection, for a closure applied later: a slot
    # culled and reused since then still passes the validity masks, so
    # close_loop re-checks keyframes by source frame id and points by
    # creation order. None skips the guards.
    kf_frame_id: torch.Tensor | None = None   # (K,) int32
    mp_order: torch.Tensor | None = None      # (P,) int32


def _connected_components(adj: torch.Tensor, active: torch.Tensor,
                          iters: int = 16) -> torch.Tensor:
    """Label propagation: (K,) int32 label per active node (the least index
    it reaches in `iters` steps), K for inactive ones. adj (K, K) bool,
    symmetric."""
    K = adj.shape[0]
    big = torch.tensor(K, dtype=torch.int32, device=adj.device)
    labels = torch.where(active, torch.arange(K, dtype=torch.int32, device=adj.device), big)
    reach = adj & active[None, :]
    for _ in range(iters):
        neigh = torch.where(reach, labels[None, :], big)
        labels = torch.where(active, torch.minimum(labels, neigh.amin(dim=1)), big)
    return labels


def detect_loop(map_state: MapState, bow: BowIndex, frame: TrackedFrame, ki,
                draws: Callable[[], torch.Tensor], covis_loop_threshold: int = 30,
                covis_cluster_threshold: int = 15, min_cluster_size: int = 3,
                min_keyframes: int = 10, max_candidates: int = 4,
                reloc_kwargs: dict | None = None):
    """Detect a loop at keyframe slot `ki` (an int or a 0-d tensor). `frame`
    holds Ki's features, pose and associations. `draws()` gives the
    relocalization's (max_candidates, H, N) Gumbel draws; it is called only
    where a cluster qualifies. Reads the device once (the gates). Returns
    (LoopDetection, live, qualified): `live` whether the map holds
    `min_keyframes` keyframes, `qualified` whether a cluster qualifies too
    (both Python bools; where `qualified` is false, `detected` is false)."""
    K = map_state.capacity[0]
    dev = map_state.kf_valid.device
    ki = torch.as_tensor(ki, device=dev).to(torch.int64)
    k_ids = torch.arange(K, device=dev)
    covis = covisibility_matrix(map_state)
    scores, _ = query_keyframes(bow, frame.desc, frame.kp_valid)

    covisible = (row_of(covis, ki) >= covis_loop_threshold) & map_state.kf_valid
    # the lowestCovisScore gate: with no covisible keyframe nothing qualifies
    lowest = torch.amin(torch.where(covisible, scores, torch.inf))
    good = (map_state.kf_valid & bow.kf_has & ~covisible & (k_ids != ki)
            & (scores >= lowest) & torch.any(covisible))
    labels = _connected_components(covis >= covis_cluster_threshold, good)
    counts = torch.bincount(labels.to(torch.int64), minlength=K + 1)[:K]
    cluster = good & (labels == torch.argmax(counts))
    ranked = torch.sort(-torch.where(cluster, scores, -torch.inf), stable=True).indices
    cand = ranked[:max_candidates]
    live = torch.sum(map_state.kf_valid.to(torch.int32)) >= min_keyframes
    qualifies = live & (torch.sum(cluster.to(torch.int32)) >= min_cluster_size)
    ident = dict(kf_frame_id=map_state.kf_frame_id, mp_order=map_state.mp_created_order)
    is_live, qualified = torch.stack([live, qualifies]).tolist()   # the one host read
    if not qualified:
        N = frame.assoc.shape[0]
        det = LoopDetection(
            detected=torch.zeros((), dtype=torch.bool, device=dev),
            reloc_pose=Pose.identity(device=dev),
            reloc_assoc=torch.full((N,), -1, dtype=torch.int32, device=dev),
            scale=torch.ones((), dtype=torch.float32, device=dev),
            cluster_mask=cluster, **ident)
        return det, is_live, False

    r = relocalize(frame, map_state, cand.to(torch.int32), cluster[cand], draws(),
                   **(reloc_kwargs or {}))
    # scale from the keypoints associated in both views (:297-312), with
    # the reference's sanity gates: enough shared keypoints, and a ratio
    # inside the band an honest monocular session stays in
    both = (frame.assoc >= 0) & (r.assoc >= 0) & frame.kp_valid
    o_safe = torch.where(both, frame.assoc, 0).to(torch.int64)
    r_safe = torch.where(both, r.assoc, 0).to(torch.int64)
    curr_depth = torch.sum(torch.where(both, torch.linalg.norm(
        map_state.mp_pos[o_safe] - frame.pose.center()[None], dim=-1), 0.0))
    reloc_depth = torch.sum(torch.where(both, torch.linalg.norm(
        map_state.mp_pos[r_safe] - r.pose.center()[None], dim=-1), 0.0))
    n_shared = torch.sum(both.to(torch.int32))
    scale_ok = (curr_depth > 0) & (reloc_depth > 0) & (n_shared >= 8)
    scale = torch.where(scale_ok, reloc_depth / torch.clamp_min(curr_depth, 1e-12), 1.0)
    scale_ok = scale_ok & (scale > 0.25) & (scale < 4.0)
    det = LoopDetection(
        detected=qualifies & r.succeeded & scale_ok, reloc_pose=r.pose,
        reloc_assoc=r.assoc, scale=torch.where(scale_ok, scale, 1.0),
        cluster_mask=cluster, **ident)
    return det, True, True


def _sanitized(pose: Pose, valid: torch.Tensor) -> Pose:
    eye = torch.eye(3, dtype=pose.R.dtype, device=pose.R.device).expand(pose.R.shape)
    return Pose(torch.where(valid[:, None, None], pose.R, eye),
                torch.where(valid[:, None], pose.t, 0.0))


def essential_graph_refine(state: MapState, pre_pose: Pose, move: torch.Tensor,
                           cluster_mask: torch.Tensor, scale, ki,
                           pre_covis: torch.Tensor | None = None, iterations: int = 12,
                           covis_edge_threshold: int = 15, edges_per_kf: int = 4,
                           loop_edge_weight: float = 5.0) -> MapState:
    """Distribute the loop error over the whole trajectory with a Sim(3)
    pose graph (the OptimizeEssentialGraph role).

    vertices: every keyframe as Sim(3), the corrected set at scale 1/s, the
    rest at their drifted poses with s = 1. edges: the temporal chain and
    the top-C covisibility neighbours, measured from the pre-correction
    relative poses, except connections that exist only because the merge
    fused the loop's two ends (pre_covis below the threshold), measured
    from the corrected poses; plus the anchor ↔ every corrected keyframe,
    measured from the corrected poses. The loop cluster is the fixed datum.
    apply: T_j = [R_j | t_j / s_j]; a point moves with its reference
    keyframe, p' = (G_opt⁻¹ ∘ G_init)(p): a cluster observer first, then a
    corrected one, else the earliest; its viewing range scales alike.

    state: after the closed-form correction and the merge; pre_pose: the
    poses before it; pre_covis: the covisibility before the merge."""
    K = state.capacity[0]
    dev = state.kf_valid.device
    ki = torch.as_tensor(ki, device=dev).to(torch.int64)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=dev)
    valid = state.kf_valid
    post = _sanitized(state.kf_pose, valid)
    pre = _sanitized(pre_pose, valid)
    s_v = torch.where(move & valid, 1.0 / torch.clamp_min(scale, 1e-6), 1.0)
    verts = Sim3(s_v, post.R, s_v[:, None] * post.t)
    odometry = Sim3(torch.ones((K,), dtype=torch.float32, device=dev), pre.R, pre.t)

    # temporal chain: each keyframe → the latest earlier keyframe
    k_ids = torch.arange(K, dtype=torch.int32, device=dev)
    order = torch.where(valid, state.kf_order, -1)
    earlier = (order[:, None] < order[None, :]) & valid[:, None] & valid[None, :]
    prev = torch.argmax(torch.where(earlier, order[:, None], -1), dim=0).to(torch.int32)
    has_prev = torch.any(earlier, dim=0)

    # strong covisibility edges: the top-C neighbours of each keyframe
    cv = covisibility_matrix(state)
    top_v, top_i = topk_stable(torch.where(cv >= covis_edge_threshold, cv, 0), edges_per_kf)
    C = edges_per_kf

    # loop anchor: the cluster keyframe Ki now shares the most points with
    in_cluster = cluster_mask & valid
    cv_ki = row_of(cv, ki)
    anchor = torch.where(torch.any(in_cluster & (cv_ki > 0)),
                         torch.argmax(torch.where(in_cluster, cv_ki, -1)),
                         torch.argmax(in_cluster.to(torch.int32))).to(torch.int32)
    loop_w = loop_edge_weight * (move & valid & (k_ids != anchor)).to(torch.float32)
    edge_i = torch.cat([prev, top_i.reshape(-1).to(torch.int32), anchor.expand(K)])
    edge_j = torch.cat([k_ids, k_ids.repeat_interleave(C), k_ids])
    w = torch.cat([(has_prev & valid).to(torch.float32),
                   (top_v > 0).to(torch.float32).reshape(-1), loop_w])
    # dead edges pin to vertex 0 with the identity measurement
    dead = w <= 0.0
    edge_i = torch.where(dead, 0, edge_i)
    edge_j = torch.where(dead, 0, edge_j)

    if pre_covis is None:
        cov_new = torch.zeros((K, C), dtype=torch.bool, device=dev)
    else:
        cov_new = torch.gather(pre_covis, 1, top_i) < covis_edge_threshold
    from_corrected = torch.cat([torch.zeros((K,), dtype=torch.bool, device=dev),
                                cov_new.reshape(-1),
                                torch.ones((K,), dtype=torch.bool, device=dev)])

    def relative(src: Sim3) -> Sim3:
        ei, ej = edge_i.to(torch.int64), edge_j.to(torch.int64)
        return src.index(ej).compose(src.index(ei).inverse())      # i → j

    E = edge_i.shape[0]
    ident = Sim3(torch.ones((E,), device=dev),
                 torch.eye(3, device=dev).expand(E, 3, 3), torch.zeros((E, 3), device=dev))
    meas = relative(verts).where(from_corrected, relative(odometry)).where(~dead, ident)
    opt = optimize_pose_graph(PoseGraphProblem(
        vertices=verts, fixed=in_cluster, valid=valid, edge_i=edge_i, edge_j=edge_j,
        edge_meas=meas, edge_weight=w), iterations=iterations)

    new_pose = Pose(
        torch.where(valid[:, None, None], opt.R, state.kf_pose.R),
        torch.where(valid[:, None], opt.t / torch.clamp_min(opt.s, 1e-6)[:, None],
                    state.kf_pose.t))
    corr = opt.inverse().compose(verts)
    obs = state.kf_member & valid[:, None]
    prio = torch.where(in_cluster, 0, torch.where(move & valid, 1, 2)).to(torch.int32)
    key = prio * (2 ** 24) + state.kf_order
    ref = torch.argmin(torch.where(obs, key[:, None], 2 ** 30), dim=0)    # (P,)
    has_ref = torch.any(obs, dim=0) & state.mp_valid
    cr = corr.index(ref)
    p_new = cr.s[:, None] * torch.einsum("pij,pj->pi", cr.R, state.mp_pos) + cr.t
    return state._replace(
        kf_pose=new_pose,
        mp_pos=torch.where(has_ref[:, None], p_new, state.mp_pos),
        mp_dmin=torch.where(has_ref, cr.s * state.mp_dmin, state.mp_dmin),
        mp_dmax=torch.where(has_ref, cr.s * state.mp_dmax, state.mp_dmax))


def close_loop(map_state: MapState, detection: LoopDetection, frame: TrackedFrame, ki,
               covis_theta: int = 15, essential_graph_iters: int = 0) -> MapState:
    """Apply the loop as a similarity (rotation, translation, scale) and
    merge the duplicated points:

      world similarity  x' = R_r^T (s (R_k x + t_k) - t_r)
      keyframe poses    R_j' = R_j R_k^T R_r,  t_j' = R_j R_k^T (t_r - s t_k) + s t_j

    with (R_k, t_k) Ki's drifted pose, (R_r, t_r) its relocalized pose and
    s the depth-ratio scale: Ki lands on the relocalized pose. The moving
    set is Ki and its covisible keyframes; the points it observes that the
    loop cluster does not observe move with it, their viewing ranges
    scaled by s. Then, with `essential_graph_iters`, the essential graph.
    Reads nothing back to the host."""
    K, P, N = map_state.capacity
    dev = map_state.kf_valid.device
    ki = torch.as_tensor(ki, device=dev).to(torch.int64)
    cluster_mask = detection.cluster_mask
    if detection.kf_frame_id is not None:
        cluster_mask = cluster_mask & (map_state.kf_frame_id == detection.kf_frame_id)
    mp_same = (torch.ones((P,), dtype=torch.bool, device=dev) if detection.mp_order is None
               else map_state.mp_created_order == detection.mp_order)
    pre_pose = map_state.kf_pose
    covis = covisibility_matrix(map_state)
    move = ((row_of(covis, ki) >= covis_theta) | (torch.arange(K, device=dev) == ki)) \
        & map_state.kf_valid

    s = detection.scale
    R_k, t_k = row_of(map_state.kf_pose.R, ki), row_of(map_state.kf_pose.t, ki)
    R_r, t_r = detection.reloc_pose.R, detection.reloc_pose.t
    corr_R = R_k.T @ R_r
    corr_v = R_k.T @ (t_r - s * t_k)
    R_new = torch.einsum("kij,jl->kil", map_state.kf_pose.R, corr_R)
    t_new = torch.einsum("kij,j->ki", map_state.kf_pose.R, corr_v) + s * map_state.kf_pose.t
    new_pose = Pose(torch.where(move[:, None, None], R_new, map_state.kf_pose.R),
                    torch.where(move[:, None], t_new, map_state.kf_pose.t))

    member = map_state.kf_member
    seen_by_moved = torch.any(member & move[:, None], dim=0)
    seen_by_cluster = torch.any(member & cluster_mask[:, None], dim=0)
    move_pt = map_state.mp_valid & seen_by_moved & ~seen_by_cluster
    cam_k = s * (map_state.mp_pos @ R_k.T + t_k)
    pos_new = (cam_k - t_r) @ R_r
    map_state = map_state._replace(
        kf_pose=new_pose,
        mp_pos=torch.where(move_pt[:, None], pos_new, map_state.mp_pos),
        mp_dmin=torch.where(move_pt, s * map_state.mp_dmin, map_state.mp_dmin),
        mp_dmax=torch.where(move_pt, s * map_state.mp_dmax, map_state.mp_dmax))

    # merge: a Ki keypoint associated to both an old local point and a
    # cluster point marks a duplicate; both slots must still be live
    both = (frame.assoc >= 0) & (detection.reloc_assoc >= 0) & frame.kp_valid
    src = torch.where(both, frame.assoc, 0)
    dst = torch.where(both, detection.reloc_assoc, 0)
    s_i, d_i = src.to(torch.int64), dst.to(torch.int64)
    different = (both & (src != dst) & map_state.mp_valid[s_i] & map_state.mp_valid[d_i]
                 & mp_same[s_i] & mp_same[d_i])
    map_state = merge_map_points(map_state, src, dst, different)

    if essential_graph_iters > 0:
        map_state = essential_graph_refine(
            map_state, pre_pose, move, cluster_mask, detection.scale, ki,
            pre_covis=covis, iterations=essential_graph_iters,
            covis_edge_threshold=covis_theta)
    return map_state
