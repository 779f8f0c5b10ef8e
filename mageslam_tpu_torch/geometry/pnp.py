"""Batched DLT PnP + RANSAC (port of mageslam_tpu/geometry/pnp.py), the
cv::solvePnPRansac replacement: every hypothesis samples 6
correspondences, solves the 12-parameter projective DLT by the smallest
eigenvector of its normal matrix, orthogonalizes to SE(3) and scores the
inliers over all points; the best hypothesis is refined by LM on its
inliers.

The reference draws each hypothesis's sample from `jax.random.gumbel`;
here the (H, M) Gumbel draws are an input (`runtime/draws.py` makes them).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ba.pose_only import optimize_pose
from .se3 import Pose

_EPS = 1e-12


def dlt_pose(pts3d: torch.Tensor, xn: torch.Tensor) -> Pose:
    """Batched 6+-point DLT: world points (..., S, 3) and normalized image
    coordinates (..., S, 2) → Pose (...)."""
    S = pts3d.shape[-2]
    X = torch.cat([pts3d, torch.ones_like(pts3d[..., :1])], dim=-1)     # (..., S, 4)
    zero = torch.zeros_like(X)
    u, v = xn[..., 0:1], xn[..., 1:2]
    A = torch.cat([torch.cat([X, zero, -u * X], dim=-1),
                   torch.cat([zero, X, -v * X], dim=-1)], dim=-2)       # (..., 2S, 12)
    AtA = A.transpose(-1, -2) @ A
    p = torch.linalg.eigh(AtA)[1][..., :, 0]                            # smallest eigenvalue
    M = p.reshape(*p.shape[:-1], 3, 4)
    # cheirality: flip M so that most of the sample lies in front, before
    # orthogonalization (keeps R proper)
    w3 = torch.einsum("...sk,...k->...s", X, M[..., 2, :])
    behind = torch.sum((w3 < 0).to(torch.int32), dim=-1)
    M = M * torch.where(behind > S // 2, -1.0, 1.0)[..., None, None]
    H, h = M[..., :3], M[..., 3]
    U, s, Vt = torch.linalg.svd(H)
    d = torch.linalg.det(U @ Vt)
    U = torch.cat([U[..., :2], U[..., 2:] * torch.sign(d)[..., None, None]], dim=-1)
    R = U @ Vt
    scale = 3.0 / torch.clamp_min(s.sum(-1), _EPS)
    return Pose(R, h * scale[..., None])


class PnPResult(NamedTuple):
    pose: Pose
    inliers: torch.Tensor       # (M,) bool at the refined pose
    num_inliers: torch.Tensor   # () int32
    ok: torch.Tensor            # () bool


def _score(pose: Pose, pts3d, uv, valid, cam, max_err2):
    """Inlier masks (..., M) and counts (...) of poses (...)."""
    Xc = pose.transform(pts3d)
    z = Xc[..., 2]
    inv_z = 1.0 / torch.where(z.abs() < _EPS, _EPS, z)
    u = cam[0] * Xc[..., 0] * inv_z + cam[2]
    v = cam[1] * Xc[..., 1] * inv_z + cam[3]
    err2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
    inl = valid & (z > 0) & (err2 < max_err2)
    return inl, torch.sum(inl.to(torch.int32), dim=-1)


def pnp_ransac(pts3d: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
               cam: torch.Tensor, draws: torch.Tensor,
               max_reprojection_error: float = 8.0,
               min_inliers: int = 10) -> PnPResult:
    """pts3d (M, 3), uv (M, 2) undistorted pixels, valid (M,), cam (4,);
    draws (H, M) Gumbel noise, one row per hypothesis. Reads nothing back
    to the host."""
    fx, fy, cx, cy = cam[0], cam[1], cam[2], cam[3]
    xn = torch.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], dim=-1)
    g = draws + torch.where(valid, 0.0, -1e9)
    # argsort(-g)[:6], stable as the reference's sort
    samples = torch.sort(-g, dim=-1, stable=True).indices[:, :6]       # (H, 6)
    poses = dlt_pose(pts3d[samples], xn[samples])
    max_err2 = max_reprojection_error ** 2
    inl, counts = _score(Pose(poses.R[:, None], poses.t[:, None]), pts3d, uv, valid,
                         cam, max_err2)
    best = torch.argmax(counts)                                         # first maximum
    pose = Pose(poses.R[best], poses.t[best])
    # SOLVEPNP_ITERATIVE semantics: LM refinement on the best hypothesis's
    # inliers
    pose = optimize_pose(pose, cam, pts3d, uv, inl[best].to(torch.float32),
                         huber_width=0.0, num_iters=8)[0]
    inliers, num = _score(pose, pts3d, uv, valid, cam, max_err2)
    return PnPResult(pose=pose, inliers=inliers, num_inliers=num, ok=num >= min_inliers)
