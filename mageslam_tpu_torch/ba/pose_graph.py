"""Sim(3) pose-graph optimization (port of mageslam_tpu/ba/pose_graph.py;
BundlerLib's PoseGraphOptimizer, Include/PoseGraphOptimizer.h:18-65).

Batched LM over every keyframe's Sim(3) at once: a vertex is (s, R, t)
with a 7-dim tangent [rho(3), phi(3), sigma]; an edge's residual is the
7-dim log of its relative-transform error. The reference differentiates
each edge with `jax.jacfwd` under `vmap`; here one `torch.func.jvp` over a
(7, E) batch (copy k of the edges perturbed along tangent coordinate k)
gives every column of an edge's two 7 x 7 blocks, in float32. The normal
equations scatter into a dense (7K, 7K) system solved by
`torch.linalg.solve`, as the reference solves it with `jnp.linalg.solve`.
The loop is branch-free: each iteration computes its trial and selects
with `torch.where`, so nothing waits on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.se3 import _so3_left_jacobian, exp_so3, log_so3
from ..ops.indexing import add_at_

_EPS = 1e-12


class Sim3(NamedTuple):
    """s · R x + t (world → keyframe), batched."""

    s: torch.Tensor   # (...,)
    R: torch.Tensor   # (..., 3, 3)
    t: torch.Tensor   # (..., 3)

    def compose(self, other: "Sim3") -> "Sim3":
        return Sim3(self.s * other.s, torch.matmul(self.R, other.R),
                    self.s[..., None] * torch.einsum("...ij,...j->...i", self.R, other.t)
                    + self.t)

    def inverse(self) -> "Sim3":
        Rt = self.R.transpose(-1, -2)
        inv_s = 1.0 / torch.clamp_min(self.s, _EPS)
        return Sim3(inv_s, Rt, -inv_s[..., None] * torch.einsum("...ij,...j->...i", Rt, self.t))

    def index(self, idx: torch.Tensor) -> "Sim3":
        return Sim3(self.s[idx], self.R[idx], self.t[idx])

    def where(self, cond: torch.Tensor, other: "Sim3") -> "Sim3":
        """Per entry of cond (...,): self where true, else other."""
        return Sim3(torch.where(cond, self.s, other.s),
                    torch.where(cond[..., None, None], self.R, other.R),
                    torch.where(cond[..., None], self.t, other.t))


def sim3_exp(xi: torch.Tensor) -> Sim3:
    """Tangent [rho(3), phi(3), sigma] → Sim3 (first-order-coupled form:
    exact in R and s, V from the SE(3) left Jacobian)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    t = torch.einsum("...ij,...j->...i", _so3_left_jacobian(phi), rho)
    return Sim3(torch.exp(sigma), exp_so3(phi), t)


def sim3_log(g: Sim3) -> torch.Tensor:
    phi = log_so3(g.R)
    rho = torch.linalg.solve(_so3_left_jacobian(phi), g.t[..., None])[..., 0]
    sigma = torch.log(torch.clamp_min(g.s, _EPS))
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def _edge_residual(xi_i, xi_j, gi: Sim3, gj: Sim3, meas: Sim3) -> torch.Tensor:
    """r = log(meas⁻¹ · (exp(xi_j)·gj) · (exp(xi_i)·gi)⁻¹): the measurement
    is the relative transform i → j (g2o EdgeSim3 convention)."""
    Gi = sim3_exp(xi_i).compose(gi)
    Gj = sim3_exp(xi_j).compose(gj)
    return sim3_log(meas.inverse().compose(Gj.compose(Gi.inverse())))


class PoseGraphProblem(NamedTuple):
    vertices: Sim3             # (K,)
    fixed: torch.Tensor        # (K,) bool
    valid: torch.Tensor        # (K,) bool
    edge_i: torch.Tensor       # (E,) int32
    edge_j: torch.Tensor       # (E,) int32
    edge_meas: Sim3            # (E,) relative i → j measurements
    edge_weight: torch.Tensor  # (E,) f32 (0 = invalid)


def _expand(g: Sim3, n: int) -> Sim3:
    return Sim3(g.s.expand((n,) + g.s.shape), g.R.expand((n,) + g.R.shape),
                g.t.expand((n,) + g.t.shape))


def edge_jacobians(gi: Sim3, gj: Sim3, meas: Sim3):
    """(r (E, 7), Ji (E, 7, 7), Jj (E, 7, 7)) at zero perturbation: one
    forward-mode pass over 14 tangent directions, 7 for each end."""
    E = gi.s.shape[0]
    dev = gi.s.device
    zero = torch.zeros((14, E, 14), dtype=torch.float32, device=dev)
    basis = torch.eye(14, dtype=torch.float32, device=dev)[:, None, :].expand(14, E, 14)
    args = (_expand(gi, 14), _expand(gj, 14), _expand(meas, 14))
    r, dr = torch.func.jvp(
        lambda xi: _edge_residual(xi[..., :7], xi[..., 7:], *args), (zero,), (basis,))
    J = dr.permute(1, 2, 0)                                   # (E, 7, 14)
    return r[0], J[..., :7], J[..., 7:]


def optimize_pose_graph(problem: PoseGraphProblem, iterations: int = 10) -> Sim3:
    """Batched LM over the whole graph (g2o's Levenberg policy). Returns the
    optimized vertices."""
    K = problem.fixed.shape[0]
    dev = problem.fixed.device
    ei = problem.edge_i.to(torch.int64)
    ej = problem.edge_j.to(torch.int64)
    w = problem.edge_weight
    freeze = problem.fixed | ~problem.valid
    keep = (~freeze).to(torch.float32)
    eye7 = torch.eye(7, dtype=torch.float32, device=dev)
    k_ids = torch.arange(K, device=dev)

    def cost_of(verts: Sim3) -> torch.Tensor:
        r = _edge_residual(torch.zeros((ei.shape[0], 7), device=dev),
                           torch.zeros((ei.shape[0], 7), device=dev),
                           verts.index(ei), verts.index(ej), problem.edge_meas)
        return torch.sum(w * torch.sum(r * r, dim=-1))

    def build(verts: Sim3):
        r, Ji, Jj = edge_jacobians(verts.index(ei), verts.index(ej), problem.edge_meas)
        Ji = Ji * keep[ei][:, None, None]
        Jj = Jj * keep[ej][:, None, None]
        Jwi, Jwj = Ji * w[:, None, None], Jj * w[:, None, None]
        H = torch.zeros((K, K, 7, 7), dtype=torch.float32, device=dev)
        add_at_(H, (ei, ei), torch.einsum("eij,eik->ejk", Jwi, Ji))
        add_at_(H, (ej, ej), torch.einsum("eij,eik->ejk", Jwj, Jj))
        add_at_(H, (ei, ej), torch.einsum("eij,eik->ejk", Jwi, Jj))
        add_at_(H, (ej, ei), torch.einsum("eij,eik->ejk", Jwj, Ji))
        b = torch.zeros((K, 7), dtype=torch.float32, device=dev)
        add_at_(b, (ei,), torch.einsum("eij,ei->ej", Jwi, -r))
        add_at_(b, (ej,), torch.einsum("eij,ei->ej", Jwj, -r))
        return H, b

    def solve(H, b, lam):
        H = H.index_put((k_ids, k_ids), H[k_ids, k_ids] + lam * eye7)
        H = H * keep[:, None, None, None] * keep[None, :, None, None]
        H = H.index_put((k_ids, k_ids), H[k_ids, k_ids]
                        + freeze.to(torch.float32)[:, None, None] * eye7)
        b = b * keep[:, None]
        dx = torch.linalg.solve_ex(H.permute(0, 2, 1, 3).reshape(K * 7, K * 7),
                                   b.reshape(K * 7))[0].reshape(K, 7)
        return dx * keep[:, None]

    verts = problem.vertices
    H0, _ = build(verts)
    lam = 1e-5 * torch.clamp_min(torch.max(torch.abs(
        torch.diagonal(H0[k_ids, k_ids], dim1=-2, dim2=-1))), _EPS)
    ni = torch.tensor(2.0, dtype=torch.float32, device=dev)
    cost = cost_of(verts)
    for _ in range(iterations):
        H, b = build(verts)
        dx = solve(H, b, lam)
        new = sim3_exp(dx).compose(verts)
        cost_new = cost_of(new)
        scale = torch.sum(dx * (lam * dx + b)) + _EPS
        rho = (cost - cost_new) / scale
        ok = torch.isfinite(cost_new) & (rho > 0)
        verts = new.where(ok.expand(K), verts)
        lam = torch.where(ok, lam * torch.clamp_min(1 - (2 * rho - 1) ** 3, 1 / 3), lam * ni)
        ni = torch.where(ok, 2.0, ni * 2.0)
        cost = torch.where(ok, cost_new, cost)
    return verts
