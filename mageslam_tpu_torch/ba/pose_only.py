"""Motion-only Levenberg-Marquardt (port of mageslam_tpu/ba/pose_only.py).

One camera, fixed points, Huber-robustified reprojection edges; the normal
equations are one 6x6 system from a batched reduction. LM policy of g2o's
OptimizationAlgorithmLevenberg: λ₀ = 1e-5·max(diag H); accept when the gain
ratio ρ > 0 (λ ← λ·max(⅓, 1-(2ρ-1)³), ν = 2), else λ ← λ·ν, ν ← 2ν.

The loop is branch-free, as in the reference: every iteration computes the
trial and selects with `torch.where`, so nothing waits on the device.
"""

from __future__ import annotations

import torch

from ..geometry.se3 import Pose, hat, retract

_EPS = 1e-12


def _pose_residuals(pose: Pose, intrinsics, points, uv, info, huber_width):
    """r (N,2), J (N,2,6), w (N,), chi2 (N,), depth (N,) for one camera."""
    Xc = torch.einsum("ij,nj->ni", pose.R, points) + pose.t
    z = Xc[:, 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < _EPS, torch.full_like(z, _EPS), z)
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    u = fx * Xc[:, 0] * inv_z + cx
    v = fy * Xc[:, 1] * inv_z + cy
    r = uv - torch.stack([u, v], dim=-1)

    inv_z2 = inv_z * inv_z
    zeros = torch.zeros_like(z)
    dproj = torch.stack(
        [
            torch.stack([fx * inv_z, zeros, -fx * Xc[:, 0] * inv_z2], dim=-1),
            torch.stack([zeros, fy * inv_z, -fy * Xc[:, 1] * inv_z2], dim=-1),
        ],
        dim=-2,
    )  # (N, 2, 3)
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(Xc.shape[:-1] + (3, 3))
    dXc_dxi = torch.cat([eye, -hat(Xc)], dim=-1)  # (N, 3, 6)
    J = -torch.einsum("nij,njk->nik", dproj, dXc_dxi)

    chi2 = info * torch.sum(r * r, dim=-1)
    sqrt_chi2 = torch.sqrt(chi2 + _EPS)
    use_huber = huber_width > 0.0
    rho_p = torch.where(use_huber & (chi2 > huber_width * huber_width),
                        huber_width / sqrt_chi2, 1.0)
    w = torch.where(info > 0, info * rho_p, 0.0)
    return r, J, w, chi2, z


def _robust_cost(chi2, info, huber_width) -> torch.Tensor:
    delta2 = huber_width * huber_width
    rho = torch.where((huber_width > 0.0) & (chi2 > delta2),
                      2.0 * huber_width * torch.sqrt(chi2 + _EPS) - delta2, chi2)
    return torch.sum(torch.where(info > 0, rho, 0.0))


def optimize_pose(pose: Pose, intrinsics: torch.Tensor, points: torch.Tensor,
                  uv: torch.Tensor, info: torch.Tensor, huber_width=1.8,
                  num_iters: int = 10):
    """LM on one camera pose. intrinsics (4,), points (N, 3) fixed world
    points, uv (N, 2) measured undistorted pixels, info (N,) with 0 = masked.
    Returns (pose, chi2 (N,), depth (N,)) at the final pose."""
    huber_width = torch.as_tensor(huber_width, dtype=torch.float32,
                                  device=points.device)
    eye6 = torch.eye(6, dtype=torch.float32, device=points.device)

    def build(p: Pose):
        """One residual evaluation → (H, b, cost); a rejected trial reuses
        the carried system."""
        r, J, w, chi2, _ = _pose_residuals(p, intrinsics, points, uv, info,
                                           huber_width)
        Jw = J * w[:, None, None]
        H = torch.einsum("nij,nik->jk", Jw, J)
        b = -torch.einsum("nij,ni->j", Jw, r)
        return H, b, _robust_cost(chi2, info, huber_width)

    H, b, cost = build(pose)
    lam = 1e-5 * torch.max(torch.diagonal(H))
    ni = torch.tensor(2.0, dtype=torch.float32, device=points.device)
    p = pose
    for _ in range(num_iters):
        # solve_ex: no error check, so no device→host sync per iteration
        dx = torch.linalg.solve_ex(H + lam * eye6, b)[0]
        p_new = retract(p, dx)
        H_new, b_new, cost_new = build(p_new)
        scale = torch.dot(dx, lam * dx + b) + _EPS
        rho = (cost - cost_new) / scale
        ok = torch.isfinite(cost_new) & (rho > 0)
        lam_acc = lam * torch.clamp_min(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0)
        p = Pose(torch.where(ok, p_new.R, p.R), torch.where(ok, p_new.t, p.t))
        lam, ni = torch.where(ok, lam_acc, lam * ni), torch.where(ok, 2.0, ni * 2.0)
        cost = torch.where(ok, cost_new, cost)
        H = torch.where(ok, H_new, H)
        b = torch.where(ok, b_new, b)
    _, _, _, chi2_f, depth_f = _pose_residuals(p, intrinsics, points, uv, info,
                                               huber_width)
    return p, chi2_f, depth_f
