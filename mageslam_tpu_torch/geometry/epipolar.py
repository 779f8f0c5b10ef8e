"""Epipolar geometry: essential and fundamental matrices, point-to-epiline
distances (port of mageslam_tpu/geometry/epipolar.py; Utils/Epipolar.cpp).

F = K_to^-T E K_from^-1 with E = [t]_x R of the relative view transform.
All functions broadcast over leading dimensions.
"""

from __future__ import annotations

import torch

from .se3 import Pose, hat


def relative_pose(from_pose: Pose, to_pose: Pose) -> Pose:
    """View transform from from-frame to to-frame camera coordinates:
    T_rel = T_to ∘ T_from^-1."""
    return to_pose.compose(from_pose.inverse())


def essential_matrix(from_pose: Pose, to_pose: Pose) -> torch.Tensor:
    """E = [t]_x R of the relative transform (Epipolar.cpp:29-49)."""
    rel = relative_pose(from_pose, to_pose)
    return torch.einsum("...ij,...jk->...ik", hat(rel.t), rel.R)


def inverse_intrinsics(cam: torch.Tensor) -> torch.Tensor:
    fx, fy, cx, cy = cam[..., 0], cam[..., 1], cam[..., 2], cam[..., 3]
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    return torch.stack(
        [
            torch.stack([1.0 / fx, z, -cx / fx], dim=-1),
            torch.stack([z, 1.0 / fy, -cy / fy], dim=-1),
            torch.stack([z, z, o], dim=-1),
        ],
        dim=-2,
    )


def fundamental_matrix(from_pose: Pose, from_cam, to_pose: Pose, to_cam):
    """F = K_to^-T E K_from^-1 (Epipolar.cpp:14-25)."""
    E = essential_matrix(from_pose, to_pose)
    return torch.einsum("...ij,...jk,...kl->...il",
                        inverse_intrinsics(to_cam).transpose(-1, -2), E, inverse_intrinsics(from_cam))


def epiline(F: torch.Tensor, px1: torch.Tensor) -> torch.Tensor:
    """Epipolar line (a, b, c) in image 2 of points px1 (..., 2) in image 1."""
    p1h = torch.stack([px1[..., 0], px1[..., 1], torch.ones_like(px1[..., 0])],
                      dim=-1)
    return torch.einsum("...ij,...j->...i", F, p1h)


def distance_from_epipolar_line(F, px1, px2) -> torch.Tensor:
    """|a x2 + b y2 + c| / sqrt(a² + b²), 1 in place of a zero norm."""
    line = epiline(F, px1)
    a, b, c = line[..., 0], line[..., 1], line[..., 2]
    nu = a * a + b * b
    inv_nu = torch.where(nu > 0, 1.0 / torch.sqrt(torch.where(nu > 0, nu, 1.0)), 1.0)
    return torch.abs(px2[..., 0] * a + px2[..., 1] * b + c) * inv_nu


def symmetric_transfer_error(F, px1, px2) -> torch.Tensor:
    """Sum of the squared point-to-epiline distances in both images."""
    d2 = distance_from_epipolar_line(F, px1, px2)
    d1 = distance_from_epipolar_line(F.transpose(-1, -2), px2, px1)
    return d1 * d1 + d2 * d2
