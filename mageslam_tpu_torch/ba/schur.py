"""Full bundle adjustment: the Schur-complement reduced camera system,
batched (port of mageslam_tpu/ba/schur.py; g2o's BlockSolver_6_3 with a dense
linear solver as BundlerLib::StepBundleAdjustment drives it).

One LM iteration:
  1. batched residuals and Jacobians of every observation and tether,
  2. normal-equation blocks by scatter-add: U (K, 6, 6) on the diagonal of
     H_cc, V (P, 3, 3), Wc (K, P, 6, 3), g_c (K, 6), g_p (P, 3), and the
     tether blocks into H_cc,
  3. point elimination: V^ = V + lambda I by a closed-form 3x3 inverse,
     S = H_cc + lambda I - Wc V^-1 Wc^T,
  4. dense Cholesky on the (6K, 6K) reduced system,
  5. back-substitution dx_p = V^-1 (g_p - Wc^T dx_c),
  6. g2o's gain-ratio accept / reject with the lambda / nu update.

Fixed cameras get zero Jacobians and an identity diagonal block, so their
update is exactly zero; invalid slots carry zero weights throughout.

The scatter-adds are `ops/indexing.add_at_`: in index order on the CPU,
`index_put_(accumulate=True)` on CUDA, whose float32 sums of duplicates
take another order, so the normal equations, and with them the step, agree
with the reference to float32 rounding of the sums (relative 1e-6 a
block), not bit for bit. Nothing here reads the device
from the host: a failed Cholesky is detected and replaced by the LU solve
on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.se3 import Pose, retract
from ..ops.indexing import add_at_
from .problem import BAProblem, BAState
from .residuals import (ObsResiduals, TetherResiduals, observation_residuals,
                        robust_cost, tether_residuals)

_EPS = 1e-12


def _inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate over determinant)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(torch.abs(det) < _EPS, _EPS, det)
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
            torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
            torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


class NormalEquations(NamedTuple):
    H_cc: torch.Tensor   # (K, K, 6, 6) camera-camera blocks
    V: torch.Tensor      # (P, 3, 3) point diagonal blocks
    Wc: torch.Tensor     # (K, P, 6, 3) camera-point cross blocks
    g_c: torch.Tensor    # (K, 6)
    g_p: torch.Tensor    # (P, 3)


def _added(shape, index, values, device) -> torch.Tensor:
    """zeros(shape).at[index].add(values): duplicates are summed."""
    return add_at_(torch.zeros(shape, dtype=torch.float32, device=device), index, values)


def build_normal_equations(problem: BAProblem, obs: ObsResiduals,
                           teth: TetherResiduals) -> NormalEquations:
    K = problem.num_cameras
    P = problem.num_points
    dev = obs.r.device
    oc = problem.obs_cam.to(torch.int64)
    op = problem.obs_pt.to(torch.int64)

    # zero camera Jacobians of fixed cameras, and point Jacobians when the
    # points are fixed: then V = W = g_p = 0 and dx_p = 0
    Jc = obs.Jc * (~problem.cam_fixed)[oc][:, None, None]
    Jp = obs.Jp * (0.0 if problem.points_fixed else 1.0)

    Jc_w = Jc * obs.w[:, None, None]
    Jp_w = Jp * obs.w[:, None, None]
    U_obs = torch.einsum("oij,oik->ojk", Jc_w, Jc)
    V_obs = torch.einsum("oij,oik->ojk", Jp_w, Jp)
    W_obs = torch.einsum("oij,oik->ojk", Jc_w, Jp)             # (O, 6, 3)
    gc_obs = torch.einsum("oij,oi->oj", Jc_w, -obs.r)          # b = -J^T Omega e
    gp_obs = torch.einsum("oij,oi->oj", Jp_w, -obs.r)

    H_cc = _added((K, K, 6, 6), (oc, oc), U_obs, dev)
    V = _added((P, 3, 3), (op,), V_obs, dev)
    Wc = _added((K, P, 6, 3), (oc, op), W_obs, dev)
    g_c = _added((K, 6), (oc,), gc_obs, dev)
    g_p = _added((P, 3), (op,), gp_obs, dev)

    if problem.tether_cam1.shape[0] > 0:
        c1 = problem.tether_cam1.to(torch.int64)
        c2 = problem.tether_cam2.to(torch.int64)
        J1 = teth.Jc1 * (~problem.cam_fixed)[c1][:, None, None]
        J2 = teth.Jc2 * (~problem.cam_fixed)[c2][:, None, None]
        w = teth.w[:, None, None]
        add_at_(H_cc, (c1, c1), torch.einsum("tij,tik->tjk", J1 * w, J1))
        add_at_(H_cc, (c2, c2), torch.einsum("tij,tik->tjk", J2 * w, J2))
        add_at_(H_cc, (c1, c2), torch.einsum("tij,tik->tjk", J1 * w, J2))
        add_at_(H_cc, (c2, c1), torch.einsum("tij,tik->tjk", J2 * w, J1))
        add_at_(g_c, (c1,), torch.einsum("tij,ti->tj", J1 * w, -teth.r))
        add_at_(g_c, (c2,), torch.einsum("tij,ti->tj", J2 * w, -teth.r))

    return NormalEquations(H_cc=H_cc, V=V, Wc=Wc, g_c=g_c, g_p=g_p)


def solve_camera_system(S, b, cam_fixed, cam_valid, lam) -> torch.Tensor:
    """dx_c (K, 6) of the reduced camera system S (K, K, 6, 6), b (K, 6):
    lambda on the camera diagonal; fixed and invalid cameras get an
    identity row and column, so their dx is exactly 0. The sharded solver
    (parallel/sharded_ba.py) solves its summed system here too."""
    K = S.shape[0]
    dev = S.device
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    freeze = cam_fixed | ~cam_valid
    keep = (~freeze).to(torch.float32)
    diag = torch.diag_embed(torch.ones((K,), dtype=torch.float32, device=dev))
    S = S + diag[:, :, None, None] * (lam * eye6)
    S = S * keep[:, None, None, None] * keep[None, :, None, None]
    S = S + (diag * freeze.to(torch.float32)[:, None])[:, :, None, None] * eye6
    b = b * keep[:, None]

    S_mat = S.permute(0, 2, 1, 3).reshape(K * 6, K * 6)
    rhs = b.reshape(K * 6, 1)
    # cholesky_ex reports failure in `info` instead of raising; where S is
    # not positive definite (or the solve gave NaN, as the reference's
    # Cholesky does) the LU solve takes its place, selected on the device
    L, info = torch.linalg.cholesky_ex(S_mat, check_errors=False)
    dx_chol = torch.cholesky_solve(rhs, L)
    dx_lu = torch.linalg.solve_ex(S_mat, rhs, check_errors=False)[0]
    bad = (info != 0) | torch.any(torch.isnan(dx_chol))
    return torch.where(bad, dx_lu, dx_chol).reshape(K, 6) * keep[:, None]


def solve_lm_system(problem: BAProblem, eq: NormalEquations, lam):
    """Solve the damped system through the Schur complement. Returns
    (dx_c (K, 6), dx_p (P, 3))."""
    eye3 = torch.eye(3, dtype=torch.float32, device=eq.V.device)
    V_inv = _inv3x3(eq.V + lam * eye3[None])                       # (P, 3, 3)
    Y = torch.einsum("kpij,pjl->kpil", eq.Wc, V_inv)               # (K, P, 6, 3)
    S = eq.H_cc - torch.einsum("kpij,qplj->kqil", Y, eq.Wc)        # (K, K, 6, 6)
    b = eq.g_c - torch.einsum("kpij,pj->ki", Y, eq.g_p)            # (K, 6)
    dx_c = solve_camera_system(S, b, problem.cam_fixed, problem.cam_valid, lam)

    rhs_p = eq.g_p - torch.einsum("kpij,ki->pj", eq.Wc, dx_c)      # (P, 3)
    dx_p = torch.einsum("pij,pj->pi", V_inv, rhs_p)
    dx_p = dx_p * problem.pt_valid.to(torch.float32)[:, None]
    return dx_c, dx_p


class LMStepResult(NamedTuple):
    state: BAState
    cost: torch.Tensor       # robust cost after the step (the accepted value)
    accepted: torch.Tensor   # () bool


def _cost(problem: BAProblem, poses: Pose, points, obs_info, huber_width):
    obs = observation_residuals(problem, poses, points, obs_info, huber_width)
    teth = tether_residuals(problem, poses, jacobians=False)
    return robust_cost(obs.chi2, huber_width, obs.w) + torch.sum(teth.chi2)


def lm_iteration(problem: BAProblem, state: BAState, huber_width) -> LMStepResult:
    """One g2o-style LM iteration (about one `Optimizer->Step()`)."""
    obs = observation_residuals(problem, state.poses, state.points, state.obs_info,
                                huber_width)
    teth = tether_residuals(problem, state.poses)
    eq = build_normal_equations(problem, obs, teth)

    # lambda: the user's value if set, else g2o's 1e-5 * max diag of H
    k = torch.arange(problem.num_cameras, device=obs.r.device)
    max_diag = torch.maximum(
        torch.max(torch.abs(torch.diagonal(eq.H_cc[k, k], dim1=-2, dim2=-1))),
        torch.max(torch.abs(torch.diagonal(eq.V, dim1=-2, dim2=-1))))
    lam = torch.where(state.lam > 0, state.lam, 1e-5 * torch.clamp_min(max_diag, _EPS))

    cost0 = robust_cost(obs.chi2, huber_width, obs.w) + torch.sum(teth.chi2)

    dx_c, dx_p = solve_lm_system(problem, eq, lam)
    poses_new = retract(state.poses, dx_c)
    points_new = state.points + dx_p
    cost_new = _cost(problem, poses_new, points_new, state.obs_info, huber_width)

    scale = (torch.sum(dx_c * (lam * dx_c + eq.g_c))
             + torch.sum(dx_p * (lam * dx_p + eq.g_p)) + _EPS)
    rho = (cost0 - cost_new) / scale
    ok = torch.isfinite(cost_new) & (rho > 0)

    lam_acc = lam * torch.clamp_min(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0)
    new_state = BAState(
        poses=Pose(torch.where(ok, poses_new.R, state.poses.R),
                   torch.where(ok, poses_new.t, state.poses.t)),
        points=torch.where(ok, points_new, state.points),
        lam=torch.where(ok, lam_acc, lam * state.ni),
        ni=torch.where(ok, 2.0, state.ni * 2.0),
        obs_info=state.obs_info,
    )
    return LMStepResult(state=new_state, cost=torch.where(ok, cost_new, cost0),
                        accepted=ok)
