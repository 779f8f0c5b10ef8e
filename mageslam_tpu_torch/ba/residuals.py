"""Reprojection and tether residuals with Jacobians, batched over all
observations at once (port of mageslam_tpu/ba/residuals.py).

Semantics as g2o driven by BundlerLib:
  - observation error  e = obs_uv - project(K, T X)   (EdgeProjectXYZ2UV)
  - information        Omega = info I_2               (BundlerLib.cpp:316-318)
  - Huber weight rho'(chi2) = 1 if chi2 <= delta^2 else delta / sqrt(chi2),
    chi2 = e^T Omega e
  - distance tether    e = (d_meas - |t2 - t1|) w     (BundlerLib.cpp:30-55)
  - rotation tether    e = angle(R1 R2^T delta) w
  - transform tether   e = log(T2^-1 dT T1), Omega = w I_6

Pose updates are left-multiplicative, T <- exp([rho, phi]) T, so
dX_cam / dxi = [I_3 | -[X_cam]_x]. The observation Jacobians are analytic;
the tether Jacobians come from forward-mode differentiation, as the
reference takes them (`torch.func.jvp`; not under `vmap`, which turns the
tangents of float32 tensors scaled by Python numbers into float64).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.se3 import Pose, exp_se3, hat, log_se3
from .problem import BAProblem, TETHER_DISTANCE, TETHER_ROTATION, TETHER_TRANSFORM

_EPS = 1e-12


class ObsResiduals(NamedTuple):
    r: torch.Tensor        # (O, 2) residuals e = obs - proj
    Jc: torch.Tensor       # (O, 2, 6) d e / d camera twist [rho, phi]
    Jp: torch.Tensor       # (O, 2, 3) d e / d point
    w: torch.Tensor        # (O,) info * Huber rho' (0 for invalid)
    chi2: torch.Tensor     # (O,) e^T Omega e, before the robustifier
    depth: torch.Tensor    # (O,) z in the camera frame


def project_obs(poses: Pose, intrinsics, points, obs_cam, obs_pt):
    """Project each observation's point into its camera. Returns (uv, Xc)."""
    obs_cam = obs_cam.to(torch.int64)
    Xc = torch.einsum("oij,oj->oi", poses.R[obs_cam],
                      points[obs_pt.to(torch.int64)]) + poses.t[obs_cam]
    K = intrinsics[obs_cam]
    z = Xc[:, 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < _EPS, _EPS, z)
    u = K[:, 0] * Xc[:, 0] * inv_z + K[:, 2]
    v = K[:, 1] * Xc[:, 1] * inv_z + K[:, 3]
    return torch.stack([u, v], dim=-1), Xc


def observation_residuals(problem: BAProblem, poses: Pose, points, obs_info,
                          huber_width) -> ObsResiduals:
    """All observation residuals and Jacobians in one batched evaluation."""
    obs_cam = problem.obs_cam.to(torch.int64)
    obs_pt = problem.obs_pt.to(torch.int64)
    uv, Xc = project_obs(poses, problem.intrinsics, points, obs_cam, obs_pt)
    r = problem.obs_uv - uv

    K = problem.intrinsics[obs_cam]
    fx, fy = K[:, 0], K[:, 1]
    x, y, z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < _EPS, _EPS, z)
    inv_z2 = inv_z * inv_z

    zeros = torch.zeros_like(fx)
    dproj = torch.stack(
        [
            torch.stack([fx * inv_z, zeros, -fx * x * inv_z2], dim=-1),
            torch.stack([zeros, fy * inv_z, -fy * y * inv_z2], dim=-1),
        ],
        dim=-2,
    )                                                          # (O, 2, 3)
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(Xc.shape[:-1] + (3, 3))
    dXc_dxi = torch.cat([eye, -hat(Xc)], dim=-1)               # (O, 3, 6)
    Jc = -torch.einsum("oij,ojk->oik", dproj, dXc_dxi)
    Jp = -torch.einsum("oij,ojk->oik", dproj, poses.R[obs_cam])

    chi2 = obs_info * torch.sum(r * r, dim=-1)
    # Huber rho': 1 inside the width, delta / sqrt(chi2) outside; a width
    # of 0 is plain least squares
    hw = torch.as_tensor(huber_width, dtype=torch.float32, device=r.device)
    rho_p = torch.where((hw > 0.0) & (chi2 > hw * hw),
                        hw / torch.sqrt(chi2 + _EPS), 1.0)
    valid = (obs_info > 0) & problem.cam_valid[obs_cam] & problem.pt_valid[obs_pt]
    w = torch.where(valid, obs_info * rho_p, 0.0)
    return ObsResiduals(r=r, Jc=Jc, Jp=Jp, w=w, chi2=chi2, depth=z)


def behind_camera(res: ObsResiduals) -> torch.Tensor:
    """Cheirality outlier test (BundlerLib.cpp:400-417): camera-frame z <= 0."""
    return res.depth <= 0.0


class TetherResiduals(NamedTuple):
    r: torch.Tensor        # (T, 6) residual, zero-padded for 1-dim kinds
    Jc1: torch.Tensor      # (T, 6, 6) d r / d twist of cam1
    Jc2: torch.Tensor      # (T, 6, 6) d r / d twist of cam2
    w: torch.Tensor        # (T,) information scalar
    chi2: torch.Tensor     # (T,)


def _tether_residual(xi, p1R, p1t, p2R, p2t, kind, meas_R, meas_t, meas_d, w):
    """(..., T, 6) tether residuals at the twist perturbations xi =
    [xi1, xi2] (..., T, 12); every kind is evaluated and each tether's own
    selected."""
    T1 = exp_se3(xi[..., :6]).compose(Pose(p1R, p1t))
    T2 = exp_se3(xi[..., 6:]).compose(Pose(p2R, p2t))
    dt = T2.t - T1.t
    r_dist = (meas_d - torch.sqrt(torch.sum(dt * dt, dim=-1) + _EPS)) * w
    R_rel = torch.matmul(T1.R.transpose(-1, -2), T2.R)
    dR = torch.matmul(R_rel, meas_R.transpose(-1, -2))
    cos_a = torch.clamp((dR[..., 0, 0] + dR[..., 1, 1] + dR[..., 2, 2] - 1.0) * 0.5,
                        -1.0 + 1e-7, 1.0 - 1e-7)
    r_rot = torch.acos(cos_a) * w
    r_xform = log_se3(T2.inverse().compose(Pose(meas_R, meas_t)).compose(T1))
    pad = torch.zeros_like(r_xform[..., :5])
    kind = kind[..., None]
    return torch.where(
        kind == TETHER_DISTANCE, torch.cat([r_dist[..., None], pad], dim=-1),
        torch.where(kind == TETHER_ROTATION, torch.cat([r_rot[..., None], pad], dim=-1),
                    r_xform))


def tether_residuals(problem: BAProblem, poses: Pose,
                     jacobians: bool = True) -> TetherResiduals:
    """All tether kinds evaluated and masked by kind. Tethers are few, so
    forward-mode differentiation is cheap beside the observation blocks: one
    `torch.func.jvp` over a (12, T) batch, copy k of the tethers perturbed
    along twist coordinate k, gives every column of both Jacobians. With
    `jacobians` false, Jc1 and Jc2 are zeros (the cost needs none)."""
    T = problem.tether_cam1.shape[0]
    dev = poses.t.device
    if T == 0:
        z = torch.zeros
        return TetherResiduals(z((0, 6), device=dev), z((0, 6, 6), device=dev),
                               z((0, 6, 6), device=dev), z((0,), device=dev),
                               z((0,), device=dev))
    c1 = problem.tether_cam1.to(torch.int64)
    c2 = problem.tether_cam2.to(torch.int64)
    args = (poses.R[c1], poses.t[c1], poses.R[c2], poses.t[c2], problem.tether_kind,
            problem.tether_pose.R, problem.tether_pose.t, problem.tether_distance,
            problem.tether_weight)
    if jacobians:
        zero = torch.zeros((12, T, 12), dtype=torch.float32, device=dev)
        basis = torch.eye(12, dtype=torch.float32, device=dev)[:, None, :].expand(12, T, 12)
        r, dr = torch.func.jvp(lambda xi: _tether_residual(xi, *args), (zero,), (basis,))
        r = r[0]
        J = dr.permute(1, 2, 0)                              # (T, 6, 12)
        Jc1, Jc2 = J[..., :6], J[..., 6:]
    else:
        r = _tether_residual(torch.zeros((T, 12), dtype=torch.float32, device=dev), *args)
        Jc1 = Jc2 = torch.zeros((T, 6, 6), dtype=torch.float32, device=dev)

    # the TRANSFORM kind has Omega = w I; the 1-dim kinds carry w inside
    # the residual, so their information is 1 where valid
    valid = problem.tether_weight > 0
    w_info = torch.where(problem.tether_kind == TETHER_TRANSFORM, problem.tether_weight, 1.0)
    w_info = torch.where(valid, w_info, 0.0)
    chi2 = w_info * torch.sum(r * r, dim=-1)
    return TetherResiduals(r=r, Jc1=Jc1, Jc2=Jc2, w=w_info, chi2=chi2)


def robust_cost(chi2, huber_width, valid_w) -> torch.Tensor:
    """Exact Huber cost: sum of rho(chi2) over the valid observations."""
    hw = torch.as_tensor(huber_width, dtype=torch.float32, device=chi2.device)
    delta2 = hw * hw
    rho = torch.where((hw > 0.0) & (chi2 > delta2),
                      2.0 * hw * torch.sqrt(chi2 + _EPS) - delta2, chi2)
    return torch.sum(torch.where(valid_w > 0, rho, 0.0))
