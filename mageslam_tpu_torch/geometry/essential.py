"""Batched 5-point essential matrix estimation (port of
mageslam_tpu/geometry/essential.py).

Per 5-point sample: the epipolar constraints give a 5×9 system whose
4-dim null space (batched SVD) spans E = x·E1 + y·E2 + z·E3 + E4. The 10
cubic constraints (det E = 0, 2·E·Eᵀ·E − tr(E·Eᵀ)·E = 0) are evaluated at
20 fixed points and turned into monomial coefficients by a precomputed
inverse Vandermonde. Grouping by the 10 (x, y) monomials gives a 10×10
matrix M(z) with cubic entries; the real roots of det M(z) are found by
sign changes on a tan-warped grid and a fixed bisection, and the null
vector of M(z*) gives (x, y) and hence E. Everything is fixed-shape and
batched over RANSAC hypotheses, as in the reference, and computed in the
inputs' dtype (mono init passes float64).

The SVD's null-space basis is not unique: another basis gives another
z-parametrisation and other roots for the same set of essential
matrices. `five_point_essential` takes an optional basis so that its
stages can be held against the reference's on the reference's basis.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .se3 import Pose

MAX_ROOTS = 10
GRID_SIZE = 256
BISECT_ITERS = 40

# total-degree-3 monomials in (x, y, z), and the (x, y) monomials of degree ≤ 3
_MONOMIALS = [(i, j, k) for i in range(4) for j in range(4) for k in range(4)
              if i + j + k <= 3]
_XY_MONOMIALS = [(i, j) for i in range(4) for j in range(4) if i + j <= 3]
_XY_INDEX = {m: n for n, m in enumerate(_XY_MONOMIALS)}
_MONO_TO_XY = np.array([_XY_INDEX[(i, j)] for (i, j, _) in _MONOMIALS], np.int64)
_MONO_ZPOW = np.array([k for (_, _, k) in _MONOMIALS], np.float32)
# (20, 10) 0/1: monomial m belongs to (x, y) group g. M(z) is a matmul with
# it, a fixed summation order (a scatter-add on the card sums in atomic order)
_GROUP = np.eye(10, dtype=np.float32)[_MONO_TO_XY]


def _make_vandermonde_inverse() -> tuple[np.ndarray, np.ndarray]:
    """20 fixed evaluation points (x, y, z) and the inverse of the 20×20
    monomial Vandermonde (the reference's draw: RandomState(7), cond < 1e6)."""
    rng = np.random.RandomState(7)
    while True:
        pts = rng.uniform(-1.0, 1.0, (20, 3))
        V = np.stack([np.prod(pts ** np.array(m, float), axis=1) for m in _MONOMIALS],
                     axis=1)
        if np.linalg.cond(V) < 1e6:
            return pts, np.linalg.inv(V)


_EVAL_POINTS, _V_INV = _make_vandermonde_inverse()


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A constant in `like`'s dtype, on its device."""
    return torch.as_tensor(np.asarray(a, np.float64), dtype=like.dtype, device=like.device)


def _essential_constraints(E: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) → (..., 10): [det E, vec(2 E Eᵀ E − tr(E Eᵀ) E)]."""
    det = torch.linalg.det(E)
    EEt = E @ E.transpose(-1, -2)
    tr = EEt[..., 0, 0] + EEt[..., 1, 1] + EEt[..., 2, 2]
    C = 2.0 * (EEt @ E) - tr[..., None, None] * E
    return torch.cat([det[..., None], C.reshape(*C.shape[:-2], 9)], dim=-1)


def null_space_4(pts1: torch.Tensor, pts2: torch.Tensor) -> torch.Tensor:
    """(B, 5, 2) normalized point pairs → (B, 4, 3, 3) null-space basis of
    p2ᵀ E p1 = 0 (the 4 right singular vectors of the smallest values)."""
    x1, y1 = pts1[..., 0], pts1[..., 1]
    x2, y2 = pts2[..., 0], pts2[..., 1]
    one = torch.ones_like(x1)
    Q = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], dim=-1)
    Vh = torch.linalg.svd(Q, full_matrices=True)[2]
    return Vh[..., 5:, :].reshape(*Q.shape[:-2], 4, 3, 3)


def constraint_coefficients(basis: torch.Tensor) -> torch.Tensor:
    """(B, 4, 3, 3) basis → (B, 10 constraints, 20 monomial coefficients)."""
    pts = _const(_EVAL_POINTS, basis)
    w = torch.cat([pts, torch.ones_like(pts[:, :1])], dim=1)             # (20, 4)
    E_samples = torch.einsum("sk,bkij->bsij", w, basis)                   # (B, 20, 3, 3)
    vals = _essential_constraints(E_samples)                              # (B, 20, 10)
    return torch.einsum("ms,bsc->bcm", _const(_V_INV, basis), vals)


def _zpow(z: torch.Tensor) -> torch.Tensor:
    """(...) → (..., 20) powers of z per monomial."""
    return z[..., None] ** _const(_MONO_ZPOW, z)


def _m_of_z(coeffs: torch.Tensor, zp: torch.Tensor) -> torch.Tensor:
    """coeffs (B, 10, 20), zp (B, Z, 20) → M (B, Z, 10, 10)."""
    weighted = coeffs[:, None, :, :] * zp[:, :, None, :]                  # (B, Z, 10, 20)
    return weighted @ _const(_GROUP, coeffs)


def _scaled_m(coeffs: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """M(z) with each row divided by its largest magnitude."""
    M = _m_of_z(coeffs, _zpow(z))
    return M / (M.abs().amax(dim=-1, keepdim=True) + 1e-20)


def _det_m(coeffs: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """det M(z) at per-batch points z (B, R), rows normalized."""
    return torch.linalg.det(_scaled_m(coeffs, z))


def grid() -> np.ndarray:
    """(GRID_SIZE,) float32 tan-warped search grid over the real line. Its
    points may differ from the reference's by a few ulps (another float32
    linspace and tan); a root is bisected to the same place unless it
    lies within those ulps of a grid point."""
    u = np.linspace(-math.pi / 2 + 1e-3, math.pi / 2 - 1e-3, GRID_SIZE)
    return np.tan(u.astype(np.float32))


def find_real_roots(coeffs: torch.Tensor, bisect_iters: int = BISECT_ITERS):
    """Real roots of det M(z): the first MAX_ROOTS sign changes on the grid,
    each refined by bisection. Returns (roots (B, MAX_ROOTS), valid)."""
    B = coeffs.shape[0]
    g = _const(grid(), coeffs)
    vals = _det_m(coeffs, g.expand(B, GRID_SIZE))
    sign = torch.sign(vals)
    flip = (sign[:, :-1] * sign[:, 1:]) < 0                               # (B, Z-1)
    pos = torch.arange(GRID_SIZE - 1, device=coeffs.device)
    take = torch.sort(torch.where(flip, pos, GRID_SIZE), dim=1,
                      stable=True).indices[:, :MAX_ROOTS]
    valid = torch.gather(flip, 1, take)
    lo, hi = g[take], g[take + 1]
    f_lo = _det_m(coeffs, lo)
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        f_mid = _det_m(coeffs, mid)
        left = (torch.sign(f_lo) * torch.sign(f_mid)) <= 0
        lo, hi, f_lo = (torch.where(left, lo, mid), torch.where(left, mid, hi),
                        torch.where(left, f_lo, f_mid))
    return 0.5 * (lo + hi), valid


def five_point_essential(pts1n: torch.Tensor, pts2n: torch.Tensor,
                         basis: torch.Tensor | None = None):
    """Batched 5-point solver on normalized coordinates (B, 5, 2). Returns
    (E (B, MAX_ROOTS, 3, 3) with ‖E‖_F = 1, valid (B, MAX_ROOTS)); p2ᵀ E p1
    = 0. `basis` (B, 4, 3, 3) replaces the SVD's null-space basis."""
    B = pts1n.shape[0]
    if basis is None:
        basis = null_space_4(pts1n, pts2n)
    coeffs = constraint_coefficients(basis)
    roots, valid = find_real_roots(coeffs)
    null = torch.linalg.svd(_scaled_m(coeffs, roots))[2][..., -1, :]     # (B, R, 10)
    w0 = null[..., _XY_INDEX[(0, 0)]]
    w0 = torch.where(w0.abs() < 1e-12, 1e-12, w0)
    x = null[..., _XY_INDEX[(1, 0)]] / w0
    y = null[..., _XY_INDEX[(0, 1)]] / w0
    wvec = torch.stack([x, y, roots, torch.ones_like(roots)], dim=-1)      # (B, R, 4)
    E = torch.einsum("brk,bkij->brij", wvec, basis)
    E = E / (torch.linalg.norm(E.reshape(B, MAX_ROOTS, 9), dim=-1)[..., None, None]
             + 1e-20)
    return E, valid


def decompose_essential(E: torch.Tensor) -> Pose:
    """E (..., 3, 3) → the 4 candidate world→camera2 poses (..., 4) with
    camera 1 at identity (Nistér §3.1)."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vt = Vt * torch.sign(torch.linalg.det(Vt))[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    Ra = U @ W @ Vt
    Rb = U @ W.T @ Vt
    t = U[..., :, 2]
    return Pose(torch.stack([Ra, Ra, Rb, Rb], dim=-3),
                torch.stack([t, -t, t, -t], dim=-2))


def triangulate_midpoint_pair(pose2: Pose, p1n: torch.Tensor, p2n: torch.Tensor):
    """Midpoint triangulation of normalized rays (..., 2), camera 1 at
    identity, pose2 world→camera2. Returns (..., 3) world points."""
    d1 = torch.cat([p1n, torch.ones_like(p1n[..., :1])], dim=-1)
    d2c = torch.cat([p2n, torch.ones_like(p2n[..., :1])], dim=-1)
    R2t = pose2.R.transpose(-1, -2)
    d2 = torch.einsum("...ij,...j->...i", R2t, d2c)
    c2 = -torch.einsum("...ij,...j->...i", R2t, pose2.t)
    d11 = (d1 * d1).sum(-1)
    d12 = (d1 * d2).sum(-1)
    d22 = (d2 * d2).sum(-1)
    r1 = (c2 * d1).sum(-1)
    r2 = (c2 * d2).sum(-1)
    det = d11 * d22 - d12 * d12
    det = torch.where(det.abs() < 1e-12, 1e-12, det)
    a = (d22 * r1 - d12 * r2) / det
    b = (d12 * r1 - d11 * r2) / det
    return 0.5 * (a[..., None] * d1 + c2 + b[..., None] * d2)
