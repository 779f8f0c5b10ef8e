"""Batched triangulation and reprojection (port of
mageslam_tpu/geometry/triangulation.py).

Midpoint triangulation as the reference's TriangulatePointWorldSpace (the
closest point between the two back-projected world rays), a DLT variant, and
the undistorted reprojection error, all batched over leading dimensions.
"""

from __future__ import annotations

import torch

from .se3 import Pose

_SMALL = 1e-5


def backproject_rays(cam: torch.Tensor, pose: Pose, px: torch.Tensor):
    """Undistorted pixels (..., 2) → (origin (..., 3), world-space ray
    direction (..., 3)); `cam` holds the pinhole intrinsics."""
    xn = torch.stack(
        [
            (px[..., 0] - cam[..., 2]) / cam[..., 0],
            (px[..., 1] - cam[..., 3]) / cam[..., 1],
            torch.ones_like(px[..., 0]),
        ],
        dim=-1,
    )
    d = torch.einsum("...ij,...j->...i", pose.R.transpose(-1, -2), xn)
    return pose.center().expand(d.shape), d


def triangulate_midpoint(cam1, pose1: Pose, px1, cam2, pose2: Pose, px2):
    """Midpoint triangulation of undistorted pixel matches
    (Triangulation.cpp:24-61): closest-approach parameters in closed form;
    near-parallel rays take sc = 0 and tc from the larger denominator."""
    o1, u = backproject_rays(cam1, pose1, px1)
    o2, v = backproject_rays(cam2, pose2, px2)
    w = o1 - o2
    a = torch.sum(u * u, dim=-1)
    b = torch.sum(u * v, dim=-1)
    c = torch.sum(v * v, dim=-1)
    d = torch.sum(u * w, dim=-1)
    e = torch.sum(v * w, dim=-1)
    D = a * c - b * b
    parallel = D < _SMALL
    D_safe = torch.where(parallel, 1.0, D)
    sc = torch.where(parallel, 0.0, (b * e - c * d) / D_safe)
    tc_par = torch.where(b > c, d / torch.where(torch.abs(b) < 1e-12, 1e-12, b),
                         e / torch.where(torch.abs(c) < 1e-12, 1e-12, c))
    tc = torch.where(parallel, tc_par, (a * e - b * d) / D_safe)
    p1 = o1 + sc[..., None] * u
    p2 = o2 + tc[..., None] * v
    return 0.5 * (p1 + p2)


def triangulate_dlt(cam1, pose1: Pose, px1, cam2, pose2: Pose, px2):
    """Two-view DLT triangulation in normalized camera coordinates, solved
    through the 3x3 normal equations (cv::triangulatePoints analog)."""
    rows = []
    for pose, cam, px in ((pose1, cam1, px1), (pose2, cam2, px2)):
        P = torch.cat([pose.R, pose.t[..., :, None]], dim=-1)       # (..., 3, 4)
        xn = torch.stack(
            [
                (px[..., 0] - cam[..., 2]) / cam[..., 0],
                (px[..., 1] - cam[..., 3]) / cam[..., 1],
            ],
            dim=-1,
        )
        P = P.expand(px.shape[:-1] + (3, 4))
        rows.append(xn[..., 0:1] * P[..., 2, :] - P[..., 0, :])
        rows.append(xn[..., 1:2] * P[..., 2, :] - P[..., 1, :])
    A = torch.stack(rows, dim=-2)                                   # (..., 4, 4)
    # homogeneous solve with x = [X, 1]: A3 X = -a4
    A3 = A[..., :3]
    a4 = A[..., 3]
    AtA = torch.einsum("...ki,...kj->...ij", A3, A3)
    Atb = -torch.einsum("...ki,...k->...i", A3, a4)
    eye = torch.eye(3, dtype=A.dtype, device=A.device) * 1e-9
    # solve_ex: a singular system gives non-finite values, as the
    # reference's solve does, where `solve` would raise (and read the host)
    return torch.linalg.solve_ex(AtA + eye, Atb[..., None])[0][..., 0]


def reprojection_error(cam, pose: Pose, pts_world, px):
    """Undistorted reprojection error (pixels) and depth, batched
    (Tracking/Reprojection.cpp ProjectUndistorted)."""
    pc = pose.transform(pts_world)
    z = pc[..., 2]
    div = torch.where(z == 0, 1.0, z)
    u = pc[..., 0] / div * cam[..., 0] + cam[..., 2]
    v = pc[..., 1] / div * cam[..., 1] + cam[..., 3]
    err = torch.sqrt((u - px[..., 0]) ** 2 + (v - px[..., 1]) ** 2)
    return err, z
