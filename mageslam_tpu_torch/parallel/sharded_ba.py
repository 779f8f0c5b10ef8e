"""The global BA's Schur system split over the point axis (port of
mageslam_tpu/parallel/sharded_ba.py).

The giants of the global BA are the (K, P, 6, 3) camera-point cross blocks
and their (K, K, 6, 6) Schur contraction (ba/schur.py; ~151 MB at the
budgets K = 256, P = 8192). Here the point axis is split over a mesh:

  - every shard masks the observations to its point range, sending the
    others to a dropped row, and builds only its (K, P/d, 6, 3) cross
    block, its V and g_p slices and its partial H_cc and g_c: each
    observation lands on one shard, so one `psum` rebuilds the camera
    blocks; the tether blocks are added on shard 0 alone;
  - the Schur contraction S = H_cc - sum_p Y W^T splits d ways over the
    points and meets in the same `psum`;
  - the (6K, 6K) system is solved once, on the mesh's first device, with
    the dense solver's Cholesky and LU fallback
    (ba/schur.solve_camera_system);
  - back-substitution is local to each shard, and dx_p returns by
    `all_gather`.

The iteration's residuals, cost and gain ratio run on the problem's
device. Equal to ba/schur.lm_iteration up to float32 sums taken in
another order (tests/test_torch_parallel.py).
"""

from __future__ import annotations

import functools

import torch

from ..ba.problem import BAProblem, BAState
from ..ba.residuals import observation_residuals, robust_cost, tether_residuals
from ..ba.schur import LMStepResult, _EPS, _inv3x3, solve_camera_system
from ..ba.step import step_bundle_adjust
from ..geometry.se3 import Pose, retract
from ..ops.indexing import add_at_
from . import Mesh, all_gather, on, psum


def _added(shape, index, values) -> torch.Tensor:
    return add_at_(torch.zeros(shape, dtype=torch.float32, device=values.device), index,
                   values)


def make_sharded_lm_solver(mesh: Mesh, axis: str = "model"):
    """Returns solve(problem, obs, teth, lam) -> (dx_c (K, 6), dx_p (P, 3)),
    ba.schur.solve_lm_system with the point axis of the normal equations
    split over the mesh; P must divide by its size."""
    d = mesh.size

    def shard_blocks(s, dev, P_local, obs_cam, obs_pt, Jc, Jp, r, w, teth_args, cam_fixed,
                     lam):
        """Shard s's partial S and b, and what its back-substitution needs."""
        K = cam_fixed.shape[0]
        p_lo = s * P_local
        free_cam = (~cam_fixed)[obs_cam]
        Jc = Jc * free_cam[:, None, None]
        Jc_w = Jc * w[:, None, None]
        Jp_w = Jp * w[:, None, None]
        # every observation belongs to one shard's point range
        local = (obs_pt >= p_lo) & (obs_pt < p_lo + P_local)
        lw = local.to(torch.float32)
        lp = torch.where(local, obs_pt - p_lo, P_local)          # the dropped row

        U_obs = torch.einsum("oij,oik->ojk", Jc_w, Jc) * lw[:, None, None]
        V_obs = torch.einsum("oij,oik->ojk", Jp_w, Jp) * lw[:, None, None]
        W_obs = torch.einsum("oij,oik->ojk", Jc_w, Jp) * lw[:, None, None]
        gc_obs = torch.einsum("oij,oi->oj", Jc_w, -r) * lw[:, None]
        gp_obs = torch.einsum("oij,oi->oj", Jp_w, -r) * lw[:, None]

        H_cc = _added((K, K, 6, 6), (obs_cam, obs_cam), U_obs)
        V = _added((P_local + 1, 3, 3), (lp,), V_obs)[:P_local]
        Wc = _added((K, P_local + 1, 6, 3), (obs_cam, lp), W_obs)[:, :P_local]
        g_c = _added((K, 6), (obs_cam,), gc_obs)
        g_p = _added((P_local + 1, 3), (lp,), gp_obs)[:P_local]

        if s == 0 and teth_args is not None:     # the tether blocks count once
            c1, c2, tJ1, tJ2, t_r, t_w = teth_args
            J1 = tJ1 * (~cam_fixed)[c1][:, None, None]
            J2 = tJ2 * (~cam_fixed)[c2][:, None, None]
            tw = t_w[:, None, None]
            add_at_(H_cc, (c1, c1), torch.einsum("tij,tik->tjk", J1 * tw, J1))
            add_at_(H_cc, (c2, c2), torch.einsum("tij,tik->tjk", J2 * tw, J2))
            add_at_(H_cc, (c1, c2), torch.einsum("tij,tik->tjk", J1 * tw, J2))
            add_at_(H_cc, (c2, c1), torch.einsum("tij,tik->tjk", J2 * tw, J1))
            add_at_(g_c, (c1,), torch.einsum("tij,ti->tj", J1 * tw, -t_r))
            add_at_(g_c, (c2,), torch.einsum("tij,ti->tj", J2 * tw, -t_r))

        eye3 = torch.eye(3, dtype=torch.float32, device=dev)
        V_inv = _inv3x3(V + lam * eye3[None])                       # (P/d, 3, 3)
        Y = torch.einsum("kpij,pjl->kpil", Wc, V_inv)               # (K, P/d, 6, 3)
        S_part = H_cc - torch.einsum("kpij,qplj->kqil", Y, Wc)
        b_part = g_c - torch.einsum("kpij,pj->ki", Y, g_p)
        return S_part, b_part, (Wc, V_inv, g_p)

    def solve(problem: BAProblem, obs, teth, lam):
        P_total = problem.num_points
        if P_total % d:
            raise ValueError(f"sharded BA: {P_total} points do not split over {d} shards")
        P_local = P_total // d
        Jp = obs.Jp * (0.0 if problem.points_fixed else 1.0)
        lam = torch.as_tensor(lam, dtype=torch.float32, device=obs.r.device)
        S_parts, b_parts, backs = [], [], []
        for s, dev in enumerate(mesh.devices):
            with on(dev):
                teth_args = None
                if problem.tether_cam1.shape[0] > 0:
                    teth_args = tuple(x.to(dev) for x in (
                        problem.tether_cam1.to(torch.int64),
                        problem.tether_cam2.to(torch.int64), teth.Jc1, teth.Jc2, teth.r,
                        teth.w))
                S_part, b_part, back = shard_blocks(
                    s, dev, P_local, problem.obs_cam.to(dev, torch.int64),
                    problem.obs_pt.to(dev, torch.int64), obs.Jc.to(dev), Jp.to(dev),
                    obs.r.to(dev), obs.w.to(dev), teth_args, problem.cam_fixed.to(dev),
                    lam.to(dev))
            S_parts.append(S_part)
            b_parts.append(b_part)
            backs.append(back)
        S = psum(S_parts, mesh)                                     # (K, K, 6, 6)
        b = psum(b_parts, mesh)                                     # (K, 6)
        dev0 = mesh.devices[0]
        dx_c = solve_camera_system(S, b, problem.cam_fixed.to(dev0),
                                   problem.cam_valid.to(dev0), lam.to(dev0))
        pt_ok = problem.pt_valid.to(torch.float32)
        dx_parts = []
        for s, (dev, (Wc, V_inv, g_p)) in enumerate(zip(mesh.devices, backs)):
            with on(dev):
                rhs_p = g_p - torch.einsum("kpij,ki->pj", Wc, dx_c.to(dev))   # (P/d, 3)
                dx_p_loc = torch.einsum("pij,pj->pi", V_inv, rhs_p)
                ok = pt_ok[s * P_local:(s + 1) * P_local].to(dev)
                dx_parts.append(dx_p_loc * ok[:, None])
        return dx_c.to(obs.r.device), all_gather(dx_parts, mesh).to(obs.r.device)

    return solve


def make_sharded_lm_iteration(mesh: Mesh, axis: str = "model"):
    """The g2o-style LM iteration (ba.schur.lm_iteration's semantics) with
    the linear solve split over the mesh: iteration(problem, state,
    huber_width) -> LMStepResult. The lambda initialisation takes the
    diagonal of the observation blocks, as the reference's sharded
    iteration does (mageslam_tpu/parallel/sharded_ba.py:160-175)."""
    solve = make_sharded_lm_solver(mesh, axis)

    def iteration(problem: BAProblem, state: BAState, huber_width) -> LMStepResult:
        obs = observation_residuals(problem, state.poses, state.points, state.obs_info,
                                    huber_width)
        teth = tether_residuals(problem, state.poses)
        oc = problem.obs_cam.to(torch.int64)
        op = problem.obs_pt.to(torch.int64)

        # lambda: the user's value, else 1e-5 * the largest |diagonal| of the
        # blocks assembled per entity
        free_cam = (~problem.cam_fixed)[oc]
        Jc_f = obs.Jc * free_cam[:, None, None]
        Jp_f = obs.Jp * (0.0 if problem.points_fixed else 1.0)
        w3 = obs.w[:, None]
        diag_c = _added((problem.num_cameras, 6), (oc,),
                        w3 * torch.einsum("oij,oij->oj", Jc_f, Jc_f))
        diag_p = _added((problem.num_points, 3), (op,),
                        w3 * torch.einsum("oij,oij->oj", Jp_f, Jp_f))
        max_diag = torch.maximum(torch.max(torch.abs(diag_c)), torch.max(torch.abs(diag_p)))
        lam = torch.where(state.lam > 0, state.lam, 1e-5 * torch.clamp_min(max_diag, _EPS))

        cost0 = robust_cost(obs.chi2, huber_width, obs.w) + torch.sum(teth.chi2)
        dx_c, dx_p = solve(problem, obs, teth, lam)
        poses_new = retract(state.poses, dx_c)
        points_new = state.points + dx_p
        obs_new = observation_residuals(problem, poses_new, points_new, state.obs_info,
                                        huber_width)
        teth_new = tether_residuals(problem, poses_new, jacobians=False)
        cost_new = robust_cost(obs_new.chi2, huber_width, obs_new.w) + torch.sum(teth_new.chi2)

        # the gain ratio's scale: the full gradient the dense path assembles
        # (g_c with the tether terms, g_p)
        g_c = torch.einsum("oij,oi->oj", Jc_f * obs.w[:, None, None], -obs.r)
        gc_full = _added(tuple(dx_c.shape), (oc,), g_c)
        if problem.tether_cam1.shape[0] > 0:
            c1 = problem.tether_cam1.to(torch.int64)
            c2 = problem.tether_cam2.to(torch.int64)
            tw = teth.w[:, None, None]
            J1 = teth.Jc1 * (~problem.cam_fixed)[c1][:, None, None] * tw
            J2 = teth.Jc2 * (~problem.cam_fixed)[c2][:, None, None] * tw
            add_at_(gc_full, (c1,), torch.einsum("tij,ti->tj", J1, -teth.r))
            add_at_(gc_full, (c2,), torch.einsum("tij,ti->tj", J2, -teth.r))
        g_p = torch.einsum("oij,oi->oj", Jp_f * obs.w[:, None, None], -obs.r)
        gp_full = _added(tuple(dx_p.shape), (op,), g_p)
        scale = (torch.sum(dx_c * (lam * dx_c + gc_full))
                 + torch.sum(dx_p * (lam * dx_p + gp_full)) + _EPS)
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

    return iteration


def make_sharded_step_bundle_adjust(mesh: Mesh, axis: str = "model"):
    """ba/step.step_bundle_adjust with the sharded LM iteration: a drop-in
    `step_fn` for iterate_bundle_adjust, so the session's global BA (the
    loop closure's and fossilize's) runs split over the mesh
    (SlamSession.enable_sharded_global_ba). One LM iteration per Huber
    width, then the outlier extraction, as the dense step."""
    return functools.partial(step_bundle_adjust,
                             iteration=make_sharded_lm_iteration(mesh, axis))
