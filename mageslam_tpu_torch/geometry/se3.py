"""SE(3) / SO(3) operations on tensors (port of mageslam_tpu/geometry/se3.py).

A `Pose` is a world→camera view transform: rotation `R` (..., 3, 3) and
translation `t` (..., 3),

    x_cam = R @ x_world + t        camera center C = -R^T t

Every function broadcasts over leading batch dimensions. LM updates use the
g2o convention: T_new = exp(delta) * T with twist order [rho(3), phi(3)].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_EPS = 1e-8


class Pose(NamedTuple):
    """World→camera rigid transform. R: (..., 3, 3), t: (..., 3)."""

    R: torch.Tensor
    t: torch.Tensor

    @staticmethod
    def identity(batch_shape: tuple[int, ...] = (), device=None,
                 dtype=torch.float32) -> "Pose":
        R = torch.eye(3, dtype=dtype, device=device).expand(
            batch_shape + (3, 3)).clone()
        t = torch.zeros(batch_shape + (3,), dtype=dtype, device=device)
        return Pose(R, t)

    def compose(self, other: "Pose") -> "Pose":
        """self ∘ other: apply `other` first, then `self`."""
        return Pose(
            torch.einsum("...ij,...jk->...ik", self.R, other.R),
            torch.einsum("...ij,...j->...i", self.R, other.t) + self.t,
        )

    def transform(self, pts: torch.Tensor) -> torch.Tensor:
        """Apply to world points (..., 3) → camera-frame points."""
        return torch.einsum("...ij,...j->...i", self.R, pts) + self.t

    def center(self) -> torch.Tensor:
        """Camera center in world coordinates."""
        return -torch.einsum("...ji,...j->...i", self.R, self.t)

    def forward(self) -> torch.Tensor:
        """World-space viewing direction (+Z row of R)."""
        return self.R[..., 2, :]


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [v]_x of (..., 3) vectors."""
    zero = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], zero, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], zero], dim=-1),
        ],
        dim=-2,
    )


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def exp_so3(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) rotation vector → (..., 3, 3) rotation matrix."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta < 1e-4
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    K = hat(phi)
    KK = torch.einsum("...ij,...jk->...ik", K, K)
    return _eye_like(K) + a[..., None, None] * K + b[..., None, None] * KK


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix → rotation vector (principal branch, |phi| <= pi)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    near_zero = cos_theta > 1.0 - 1e-7
    safe_cos = torch.where(near_zero, torch.zeros_like(cos_theta), cos_theta)
    theta = torch.where(near_zero, torch.zeros_like(cos_theta),
                        torch.arccos(safe_cos))
    w = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin_theta = torch.sin(theta)
    small = theta < 1e-4
    safe_sin = torch.where(small, torch.ones_like(sin_theta), sin_theta)
    scale = torch.where(small, 0.5 + theta * theta / 12.0,
                        theta / (2.0 * safe_sin))
    phi = w * scale[..., None]
    # near theta = pi, w → 0: recover the axis from the diagonal of R
    near_pi = theta > 3.0
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_sq = torch.clamp_min(
        (diag - cos_theta[..., None]) / (1.0 - cos_theta[..., None] + _EPS), 0.0)
    axis = torch.sqrt(torch.where(near_pi[..., None], axis_sq,
                                  torch.ones_like(axis_sq)))
    sign = torch.where(w >= 0, 1.0, -1.0)
    phi_pi = axis * sign * theta[..., None]
    return torch.where(near_pi[..., None], phi_pi, phi)


def _so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J_l of SO(3) (the SE(3) exp translation part)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta < 1e-4
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta + _EPS))
    K = hat(phi)
    KK = torch.einsum("...ij,...jk->...ik", K, K)
    return _eye_like(K) + b[..., None, None] * K + c[..., None, None] * KK


def exp_se3(twist: torch.Tensor) -> Pose:
    """SE(3) exponential of twist = [rho(3), phi(3)]."""
    rho, phi = twist[..., :3], twist[..., 3:]
    R = exp_so3(phi)
    t = torch.einsum("...ij,...j->...i", _so3_left_jacobian(phi), rho)
    return Pose(R, t)


def retract(pose: Pose, twist: torch.Tensor) -> Pose:
    """LM update: T_new = exp(twist) ∘ T (g2o VertexSE3Expmap::oplusImpl)."""
    return exp_se3(twist).compose(pose)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) → rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = w * w + x * x + y * y + z * z
    s = 2.0 / (n + _EPS)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return torch.stack(
        [
            torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1),
            torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1),
            torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix → unit quaternion (w, x, y, z), branchless Shepperd."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    qw2 = torch.clamp_min(1.0 + m00 + m11 + m22, 0.0)
    qx2 = torch.clamp_min(1.0 + m00 - m11 - m22, 0.0)
    qy2 = torch.clamp_min(1.0 - m00 + m11 - m22, 0.0)
    qz2 = torch.clamp_min(1.0 - m00 - m11 + m22, 0.0)
    qw = torch.sqrt(qw2) * 0.5
    qx = torch.sqrt(qx2) * 0.5
    qy = torch.sqrt(qy2) * 0.5
    qz = torch.sqrt(qz2) * 0.5
    cands = torch.stack(
        [
            torch.stack([qw, (m21 - m12) / (4 * qw + _EPS),
                         (m02 - m20) / (4 * qw + _EPS),
                         (m10 - m01) / (4 * qw + _EPS)], dim=-1),
            torch.stack([(m21 - m12) / (4 * qx + _EPS), qx,
                         (m01 + m10) / (4 * qx + _EPS),
                         (m02 + m20) / (4 * qx + _EPS)], dim=-1),
            torch.stack([(m02 - m20) / (4 * qy + _EPS),
                         (m01 + m10) / (4 * qy + _EPS), qy,
                         (m12 + m21) / (4 * qy + _EPS)], dim=-1),
            torch.stack([(m10 - m01) / (4 * qz + _EPS),
                         (m02 + m20) / (4 * qz + _EPS),
                         (m12 + m21) / (4 * qz + _EPS), qz], dim=-1),
        ],
        dim=-2,
    )  # (..., 4 candidates, 4)
    idx = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)
    q = torch.take_along_dim(
        cands, idx[..., None, None].expand(idx.shape + (1, 4)), dim=-2)[..., 0, :]
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + _EPS)
    # canonical sign: w >= 0
    return q * torch.where(q[..., :1] >= 0, 1.0, -1.0)


def quat_mul(q0: torch.Tensor, q1: torch.Tensor) -> torch.Tensor:
    """Hamilton product of quaternions (w, x, y, z), broadcasting."""
    w0, x0, y0, z0 = q0[..., 0], q0[..., 1], q0[..., 2], q0[..., 3]
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    return torch.stack(
        [
            w0 * w1 - x0 * x1 - y0 * y1 - z0 * z1,
            w0 * x1 + x0 * w1 + y0 * z1 - z0 * y1,
            w0 * y1 - x0 * z1 + y0 * w1 + z0 * x1,
            w0 * z1 + x0 * y1 - y0 * x1 + z0 * w1,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (= inverse for unit quaternions) of (w, x, y, z)."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def slerp(q0: torch.Tensor, q1: torch.Tensor, alpha) -> torch.Tensor:
    """Spherical linear interpolation between unit quaternions (w, x, y, z)."""
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.abs(dot)
    theta = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-5
    w0 = torch.where(small, 1.0 - alpha,
                     torch.sin((1.0 - alpha) * theta) / (sin_theta + _EPS))
    w1 = torch.where(small, alpha + torch.zeros_like(theta),
                     torch.sin(alpha * theta) / (sin_theta + _EPS))
    q = w0 * q0 + w1 * q1
    return q / (torch.linalg.norm(q, dim=-1, keepdim=True) + _EPS)


def interpolate_pose(p0: Pose, p1: Pose, alpha) -> Pose:
    """Interpolate view transforms: slerp rotation, lerp camera center."""
    q = slerp(rot_to_quat(p0.R), rot_to_quat(p1.R), alpha)
    R = quat_to_rot(q)
    c = (1.0 - alpha) * p0.center() + alpha * p1.center()
    t = -torch.einsum("...ij,...j->...i", R, c)
    return Pose(R, t)
