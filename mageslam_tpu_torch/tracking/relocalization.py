"""Relocalization: bag-of-words candidates → PnP-RANSAC → pose BA → guided
rematch (port of mageslam_tpu/tracking/relocalization.py; the lost-tracking
path of PoseEstimator::TryEstimatePoseFromCandidates,
Tracking/PoseEstimator.cpp:219-437).

Every candidate keyframe runs every stage, and the best successful one
wins, as in the reference's vmap over candidates. The two matches run once
for all C candidates: `match_two_way` as one batch of C entries
(`csrc/two_way_match.cu` on the card), and the guided rematch as one
`radius_match` over the C candidates' query rows stacked (C·N rows against
the frame's keypoints, `csrc/radius_match.cu`, with each candidate's target
dedup inside the launch: groups of N rows); each query row is independent,
so stacking changes no row's answer. PnP-RANSAC and the two
pose-only LM stages run in a loop over the C candidates. Nothing here
reads the device back to the host.

The reference draws each candidate's PnP hypotheses from a split key; here
they are an input, (C, H, M) Gumbel draws (`runtime/draws.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ba.pose_only import optimize_pose
from ..geometry.pnp import pnp_ransac
from ..geometry.se3 import Pose
from ..ops.indexing import scatter_drop
from ..ops.matching import match_two_way, radius_match
from ..worldmap.map_state import MapState
from .frame_state import TrackedFrame

_EPS = 1e-12
# PnP hypotheses a candidate: the H of the (C, H, N) draws (the reference's
# `pnp_hypotheses` default, which its callers keep)
RELOC_HYPOTHESES = 64


class RelocResult(NamedTuple):
    pose: Pose
    assoc: torch.Tensor       # (N,) int32 map point slot per current keypoint
    succeeded: torch.Tensor   # () bool
    candidate: torch.Tensor   # () int32 winning keyframe slot or -1


def relocalize(frame: TrackedFrame, state: MapState, candidate_slots: torch.Tensor,
               candidate_ok: torch.Tensor, draws: torch.Tensor,
               min_brute_force: int = 20, min_radius_matches: int = 15,
               ransac_inlier_pct: float = 0.4, ba_inlier_pct: float = 0.4,
               max_pnp_error: float = 8.0, max_ba_error: float = 8.0,
               ba_iterations: int = 10, search_radius: float = 20.0,
               max_hamming: int = 45, min_hamming_diff: int = 8) -> RelocResult:
    """candidate_slots (C,) int32 keyframe slots, candidate_ok (C,) bool,
    draws (C, H, N) Gumbel noise, H PnP hypotheses a candidate."""
    N = frame.kp_xy.shape[0]
    C = candidate_slots.shape[0]
    dev = frame.kp_xy.device
    kc = torch.where(candidate_ok, candidate_slots, 0).to(torch.int64)    # (C,)
    kc_desc = state.kf_desc[kc]                                           # (C, N, 8)
    kc_assoc = state.kf_assoc[kc]
    a_safe = torch.where(kc_assoc >= 0, kc_assoc, 0).to(torch.int64)
    kc_valid = state.kf_kp_valid[kc] & (kc_assoc >= 0) & state.mp_valid[a_safe]
    pts3d = state.mp_pos[a_safe]                                          # (C, N, 3)
    ok = candidate_ok[:, None]

    # 1. brute-force match of each candidate's associated features to the frame
    m_idx, _ = match_two_way(kc_desc, (kc_valid & ok).contiguous(),
                             frame.desc[None].expand(C, -1, -1).contiguous(),
                             frame.kp_valid[None].expand(C, -1).contiguous(),
                             max_hamming, min_hamming_diff)
    has = m_idx >= 0
    n_bf = torch.sum(has.to(torch.int32), dim=1)
    uv = frame.kp_xy[torch.where(has, m_idx, 0).to(torch.int64)]         # (C, N, 2)

    # 2. PnP-RANSAC and 3. pose-only BA on its inliers, per candidate
    pnp_ok, pnp_inl_ok, pose1 = [], [], []
    for c in range(C):
        pnp = pnp_ransac(pts3d[c], uv[c], has[c], frame.cam, draws[c],
                         max_reprojection_error=max_pnp_error,
                         min_inliers=min_brute_force)
        pnp_ok.append(pnp.ok)
        pnp_inl_ok.append(pnp.num_inliers.to(torch.float32)
                          / torch.clamp_min(n_bf[c].to(torch.float32), 1.0)
                          >= ransac_inlier_pct)
        pose1.append(optimize_pose(pnp.pose, frame.cam, pts3d[c], uv[c],
                                   pnp.inliers.to(torch.float32), huber_width=0.0,
                                   num_iters=ba_iterations)[0])
    R1 = torch.stack([p.R for p in pose1])
    t1 = torch.stack([p.t for p in pose1])

    # 4. guided radius rematch, octave-aware (± 1 level): every candidate
    #    point projected with pose1 against all current keypoints, the C
    #    candidates' rows stacked into one match
    Xc = torch.einsum("cij,cnj->cni", R1, pts3d) + t1[:, None, :]
    z = Xc[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < _EPS, _EPS, z)
    cam = frame.cam
    proj = torch.stack([cam[0] * Xc[..., 0] * inv_z + cam[2],
                        cam[1] * Xc[..., 1] * inv_z + cam[3]], dim=-1)
    query_ok = kc_valid & ok & (z > 0)
    # dedup within each candidate: each candidate's N rows a group, whose
    # target ids the dedup offsets by candidate * N
    r_idx, _ = radius_match(
        kc_desc.reshape(C * N, -1), proj.reshape(C * N, 2),
        state.kf_kp_octave[kc].reshape(C * N), query_ok.reshape(C * N),
        frame.desc, frame.kp_xy, frame.kp_octave, frame.kp_valid,
        float(search_radius), max_hamming, min_hamming_diff, octave_tol=1, group_rows=N)
    r_idx = r_idx.reshape(C, N)
    r_has = r_idx >= 0
    n_radius = torch.sum(r_has.to(torch.int32), dim=1)

    # 5. final pose-only BA on the rematched set with its outlier gate
    uv2 = frame.kp_xy[torch.where(r_has, r_idx, 0).to(torch.int64)]
    final_inlier, pose2 = [], []
    for c in range(C):
        p2, chi2, depth = optimize_pose(pose1[c], frame.cam, pts3d[c], uv2[c],
                                        r_has[c].to(torch.float32), huber_width=0.0,
                                        num_iters=ba_iterations)
        pose2.append(p2)
        final_inlier.append(r_has[c] & (chi2 <= max_ba_error ** 2) & (depth > 0))
    final_inlier = torch.stack(final_inlier)
    n_final = torch.sum(final_inlier.to(torch.int32), dim=1)
    final_pct_ok = (n_final.to(torch.float32)
                    / torch.clamp_min(n_radius.to(torch.float32), 1.0)) >= ba_inlier_pct
    success = (candidate_ok & torch.stack(pnp_ok) & torch.stack(pnp_inl_ok)
               & (n_bf >= min_brute_force) & (n_radius >= min_radius_matches)
               & final_pct_ok)

    # per-keypoint association from the final inliers (the larger point
    # slot wins where two rows claim one keypoint, as the reference's max),
    # candidate c's keypoints at rows c * N of one bank
    offset = (torch.arange(C, device=dev, dtype=torch.int32) * N)[:, None]
    tgt = torch.where(final_inlier, r_idx + offset, C * N).reshape(-1)
    assoc = scatter_drop(torch.full((C * N,), -1, dtype=torch.int32, device=dev), tgt,
                         torch.where(final_inlier, a_safe, -1).reshape(-1), "max")
    assoc = assoc.reshape(C, N)

    score = torch.where(success, n_final, -1)
    best = torch.argmax(score)                                  # first maximum
    won = success[best]
    return RelocResult(
        pose=Pose(torch.stack([p.R for p in pose2])[best],
                  torch.stack([p.t for p in pose2])[best]),
        assoc=torch.where(won, assoc[best], -1),
        succeeded=won,
        candidate=torch.where(won, candidate_slots[best].to(torch.int32), -1),
    )
