"""Visual pose covariance from reprojection Jacobians (port of
mageslam_tpu/fuser/covariance.py).

Replaces Fuser::EstimatePoseCovariance + CalculateJacobian/CalculateResiduals
(Core/MAGESLAM/Source/Fuser/Fuser.cpp:300-400, Fuser.h:51-75): each tracked
association contributes the gradient of its squared reprojection error with
respect to the 6-dof pose twist; the Gauss-Newton Hessian H = ΣJᵢᵀJᵢ inverts
to the pose covariance fed to the sensor filter's visual update.

Batched over the frame's full association table — one (N, 6) Jacobian block
and a single 6×6 solve. Nothing here reads the device: the gate's smallest
eigenvalue is tested by a Cholesky factorization, whose flag stays on the
device (`eigvalsh` stops the host on the card to check its own).
"""

from __future__ import annotations

import torch

from ..geometry.se3 import Pose, hat

EIG_GATE = 1e-10      # the smallest eigenvalue of H must exceed it
FAILED_VARIANCE = 1e6


def estimate_pose_covariance(
    pose: Pose,
    cam: torch.Tensor,          # (4,) fx fy cx cy (undistorted space)
    kp_xy: torch.Tensor,        # (N, 2) observed undistorted keypoints
    kp_valid: torch.Tensor,     # (N,) bool
    assoc: torch.Tensor,        # (N,) int32 → map point slot or -1
    mp_pos: torch.Tensor,       # (P, 3)
    mp_valid: torch.Tensor,     # (P,) bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ((6, 6) covariance in [rho, phi] twist order, ok).

    ok is False when the Hessian is not invertible (e.g. <6 usable
    observations), matching the reference's failure return; the covariance
    is then 1e6·I. The reference's gate `eigvalsh(H)[0] > 1e-10` is the
    factorization of H − 1e-10·I succeeding: that matrix is positive
    definite exactly when every eigenvalue of H exceeds 1e-10."""
    ok_a = (assoc >= 0) & kp_valid
    safe = torch.where(ok_a, assoc, 0).long()
    ok_a = ok_a & mp_valid[safe]
    Xc = pose.transform(mp_pos[safe])                    # (N, 3) camera frame
    z = Xc[:, 2]
    ok_a = ok_a & (z > 1e-6)
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, 1e-9, z)

    fx, fy, cx, cy = cam[0], cam[1], cam[2], cam[3]
    du = fx * Xc[:, 0] * inv_z + cx - kp_xy[:, 0]
    dv = fy * Xc[:, 1] * inv_z + cy - kp_xy[:, 1]

    # d(uv)/d(Xc): (N, 2, 3)
    zero = torch.zeros_like(z)
    J_proj = torch.stack([
        torch.stack([fx * inv_z, zero, -fx * Xc[:, 0] * inv_z * inv_z], -1),
        torch.stack([zero, fy * inv_z, -fy * Xc[:, 1] * inv_z * inv_z], -1),
    ], dim=1)
    # d(Xc)/d(twist [rho, phi]) for the left-perturbation T ← exp(δ)∘T:
    # dXc/drho = I, dXc/dphi = -[Xc]× ;   (N, 3, 6)
    eye = torch.eye(3, dtype=z.dtype, device=z.device).expand(z.shape[0], 3, 3)
    J_pose = torch.cat([eye, -hat(Xc)], dim=-1)
    J_uv = torch.einsum("nij,njk->nik", J_proj, J_pose)  # (N, 2, 6)
    # gradient of the SQUARED pixel error (CalculateJacobian's jNorm·J row)
    J = 2.0 * (du[:, None] * J_uv[:, 0, :] + dv[:, None] * J_uv[:, 1, :])
    J = torch.where(ok_a[:, None], J, 0.0)

    H = J.T @ J                                          # (6, 6)
    n_obs = torch.sum(ok_a.to(torch.int32))
    eye6 = torch.eye(6, dtype=H.dtype, device=H.device)
    _, not_pd = torch.linalg.cholesky_ex(H - EIG_GATE * eye6)
    ok = (n_obs >= 6) & (not_pd == 0) & torch.isfinite(H).all()
    H_safe = torch.where(ok, H, eye6)
    cov = torch.linalg.inv_ex(H_safe).inverse
    cov = 0.5 * (cov + cov.T)      # f32 inverse is only symmetric to ~1e-9
    return torch.where(ok, cov, eye6 * FAILED_VARIANCE), ok
