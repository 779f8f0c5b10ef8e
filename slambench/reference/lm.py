"""Plain Levenberg-Marquardt for the two optimizations the timed path runs:
the track step's motion-only refinement of one camera, and the mapping
step's local bundle adjustment. Written from the algorithm, not from the
program: g2o's SE3 vertex (T <- exp([rho, phi]) T), the pinhole edge
e = uv - project(K, T X) with information `info` and a Huber kernel of
width `huber` on chi2 = info |e|^2, and g2o's LevenbergMarquardt policy:
lambda_0 = 1e-5 max diag H; a step is accepted where the gain ratio is
positive (lambda *= max(1/3, 1 - (2 rho - 1)^3), nu = 2), else lambda *= nu,
nu *= 2. The bundle adjustment eliminates the points through the Schur
complement, holds fixed cameras still and solves the reduced camera system
densely.

`prec="f64"` computes in float64; `prec="tf32"` is the control: float32,
where every matrix product (the point transforms, the Jacobians' chain
rule, the normal equations, the Schur complement, the exponential map)
takes operands rounded to TF32, as a tensor core computes them.
"""

from __future__ import annotations

import torch

from .frontend import tf32

EPS = 1e-12


def _dtype(prec: str) -> torch.dtype:
    return torch.float64 if prec == "f64" else torch.float32


def _round(x: torch.Tensor, prec: str) -> torch.Tensor:
    return tf32(x) if prec == "tf32" else x


def mm(a, b, prec: str):
    """a @ b, with TF32 operands under the control precision."""
    return _round(a, prec) @ _round(b, prec)


def es(eq: str, a, b, prec: str):
    """einsum of two operands, with TF32 operands under the control."""
    return torch.einsum(eq, _round(a, prec), _round(b, prec))


def hat(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def exp_se3(twist: torch.Tensor, prec: str = "f64") -> tuple[torch.Tensor, torch.Tensor]:
    """(R, t) of exp([rho, phi]): Rodrigues and the left Jacobian."""
    rho, phi = twist[..., :3], twist[..., 3:]
    th2 = torch.sum(phi * phi, -1)
    th = torch.sqrt(th2)
    small = th < 1e-5
    safe = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(safe) / safe)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(safe)) / (safe * safe))
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (safe - torch.sin(safe)) / safe**3)
    K = hat(phi)
    KK = mm(K, K, prec)
    eye = torch.eye(3, dtype=twist.dtype, device=twist.device).expand(K.shape)
    R = eye + a[..., None, None] * K + b[..., None, None] * KK
    V = eye + b[..., None, None] * K + c[..., None, None] * KK
    return R, mm(V, rho[..., None], prec)[..., 0]


def retract(R, t, twist, prec: str = "f64"):
    dR, dt = exp_se3(twist, prec)
    return mm(dR, R, prec), mm(dR, t[..., None], prec)[..., 0] + dt


def _edges(R, t, cam, X, uv, info, huber, prec: str):
    """Residuals r (N, 2), camera Jacobian Jc (N, 2, 6), point Jacobian
    Jp (N, 2, 3), Huber-weighted information w (N,), chi2 (N,), depth (N,).
    R, t, cam are per edge."""
    Xc = mm(R, X[..., None], prec)[..., 0] + t
    z = Xc[:, 2]
    iz = 1.0 / torch.where(z.abs() < EPS, torch.full_like(z, EPS), z)
    fx, fy, cx, cy = cam.unbind(-1)
    r = uv - torch.stack([fx * Xc[:, 0] * iz + cx, fy * Xc[:, 1] * iz + cy], -1)
    zero = torch.zeros_like(z)
    dproj = torch.stack([torch.stack([fx * iz, zero, -fx * Xc[:, 0] * iz * iz], -1),
                         torch.stack([zero, fy * iz, -fy * Xc[:, 1] * iz * iz], -1)], -2)
    eye = torch.eye(3, dtype=X.dtype, device=X.device).expand(Xc.shape[:-1] + (3, 3))
    Jc = -mm(dproj, torch.cat([eye, -hat(Xc)], -1), prec)
    Jp = -mm(dproj, R, prec)
    chi2 = info * torch.sum(r * r, -1)
    over = (huber > 0) & (chi2 > huber * huber)
    rho_p = torch.where(over, huber / torch.sqrt(chi2 + EPS), torch.ones_like(chi2))
    w = torch.where(info > 0, info * rho_p, torch.zeros_like(chi2))
    return r, Jc, Jp, w, chi2, z


def huber_cost(chi2, huber, w) -> torch.Tensor:
    over = (huber > 0) & (chi2 > huber * huber)
    rho = torch.where(over, 2.0 * huber * torch.sqrt(chi2 + EPS) - huber * huber, chi2)
    return torch.sum(torch.where(w > 0, rho, torch.zeros_like(rho)))


def _gain(cost, cost_new, dx_dot):
    rho = (cost - cost_new) / (dx_dot + EPS)
    return bool(torch.isfinite(cost_new)) and bool(rho > 0), rho


def _lam_update(lam, ni, ok, rho):
    if ok:
        return lam * max(1.0 / 3.0, 1.0 - (2.0 * float(rho) - 1.0) ** 3), 2.0
    return lam * ni, ni * 2.0


def optimize_pose(R, t, cam, points, uv, info, huber: float, iters: int, prec: str = "f64"):
    """Motion-only LM of one camera over fixed points, `iters` iterations
    from (R, t). info (N,) weights each edge, 0 masks it. Returns (R, t)."""
    dt = _dtype(prec)
    R, t, cam, X, uv, info = (torch.as_tensor(a).to(dt) for a in (R, t, cam, points, uv, info))
    n = X.shape[0]
    hw = torch.tensor(float(huber), dtype=dt, device=X.device)

    def build(R, t):
        r, Jc, _, w, chi2, _ = _edges(R.expand(n, 3, 3), t.expand(n, 3), cam.expand(n, 4), X,
                                      uv, info, hw, prec)
        Jw = Jc * w[:, None, None]
        H = es("nij,nik->jk", Jw, Jc, prec)
        b = -es("nij,ni->j", Jw, r, prec)
        return H, b, huber_cost(chi2, hw, w)

    H, b, cost = build(R, t)
    lam = 1e-5 * float(torch.max(torch.diagonal(H)))
    ni = 2.0
    eye = torch.eye(6, dtype=dt, device=X.device)
    for _ in range(iters):
        dx = torch.linalg.solve(H + lam * eye, b)
        R2, t2 = retract(R, t, dx, prec)
        H2, b2, cost2 = build(R2, t2)
        ok, rho = _gain(cost, cost2, torch.dot(dx, lam * dx + b))
        lam, ni = _lam_update(lam, ni, ok, rho)
        if ok:
            R, t, H, b, cost = R2, t2, H2, b2, cost2
    return R, t


def bundle_adjust(problem: dict, widths, max_error_sq: float, prec: str = "f64"):
    """One LM iteration per Huber width over the problem's cameras and
    points (a dict of the padded arrays: poses_R (K, 3, 3), poses_t (K, 3),
    intrinsics (K, 4), cam_fixed, cam_valid (K,), points (P, 3), pt_valid
    (P,), obs_cam, obs_pt (O,), obs_uv (O, 2), obs_info (O,)), then the
    outliers: active edges whose unweighted squared error exceeds
    `max_error_sq` or whose point lies behind the camera. Returns
    (poses_R, poses_t, points, outlier (O,) bool)."""
    dt = _dtype(prec)
    p = {k: torch.as_tensor(v) for k, v in problem.items()}
    R, t, X = p["poses_R"].to(dt), p["poses_t"].to(dt), p["points"].to(dt)
    cams, info, uv = p["intrinsics"].to(dt), p["obs_info"].to(dt), p["obs_uv"].to(dt)
    oc, op = p["obs_cam"].long(), p["obs_pt"].long()
    fixed, cvalid, pvalid = p["cam_fixed"].bool(), p["cam_valid"].bool(), p["pt_valid"].bool()
    K, P, dev = R.shape[0], X.shape[0], X.device
    valid_edge = (info > 0) & cvalid[oc] & pvalid[op]
    info_v = torch.where(valid_edge, info, torch.zeros_like(info))
    free = (~fixed).to(dt)
    keep = (~fixed & cvalid).to(dt)

    def edges(R, t, X, hw):
        return _edges(R[oc], t[oc], cams[oc], X[op], uv, info_v, hw, prec)

    def cost_of(R, t, X, hw):
        _, _, _, w, chi2, _ = edges(R, t, X, hw)
        return huber_cost(chi2, hw, w)

    lam, ni = None, 2.0
    for width in widths:
        hw = torch.tensor(float(width), dtype=dt, device=dev)
        r, Jc, Jp, w, chi2, _ = edges(R, t, X, hw)
        Jc = Jc * free[oc][:, None, None]
        Jcw, Jpw = Jc * w[:, None, None], Jp * w[:, None, None]
        U = torch.zeros((K, 6, 6), dtype=dt, device=dev).index_add_(
            0, oc, es("oij,oik->ojk", Jcw, Jc, prec))
        V = torch.zeros((P, 3, 3), dtype=dt, device=dev).index_add_(
            0, op, es("oij,oik->ojk", Jpw, Jp, prec))
        W = torch.zeros((K * P, 6, 3), dtype=dt, device=dev).index_add_(
            0, oc * P + op, es("oij,oik->ojk", Jcw, Jp, prec)).reshape(K, P, 6, 3)
        gc = torch.zeros((K, 6), dtype=dt, device=dev).index_add_(
            0, oc, -es("oij,oi->oj", Jcw, r, prec))
        gp = torch.zeros((P, 3), dtype=dt, device=dev).index_add_(
            0, op, -es("oij,oi->oj", Jpw, r, prec))
        if lam is None:
            lam = 1e-5 * max(float(torch.diagonal(U, dim1=-2, dim2=-1).abs().max()),
                             float(torch.diagonal(V, dim1=-2, dim2=-1).abs().max()), EPS)
        cost = huber_cost(chi2, hw, w)

        eye3 = torch.eye(3, dtype=dt, device=dev)
        Vinv = torch.linalg.inv(V + lam * eye3)
        Y = es("kpij,pjl->kpil", W, Vinv, prec)
        S = -es("kpij,qplj->kqil", Y, W, prec)
        S[torch.arange(K), torch.arange(K)] += U + lam * torch.eye(6, dtype=dt, device=dev)
        bc = gc - es("kpij,pj->ki", Y, gp, prec)
        m = keep[:, None, None, None] * keep[None, :, None, None]
        S = S * m
        S[torch.arange(K), torch.arange(K)] += (1.0 - keep)[:, None, None] * torch.eye(
            6, dtype=dt, device=dev)
        A = S.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
        dxc = torch.linalg.solve(A, (bc * keep[:, None]).reshape(-1)).reshape(K, 6)
        dxc = dxc * keep[:, None]
        rhs = gp - es("kpij,ki->pj", W, dxc, prec)
        dxp = es("pij,pj->pi", Vinv, rhs, prec) * pvalid.to(dt)[:, None]

        R2, t2 = retract(R, t, dxc, prec)
        X2 = X + dxp
        cost2 = cost_of(R2, t2, X2, hw)
        dot = torch.sum(dxc * (lam * dxc + gc)) + torch.sum(dxp * (lam * dxp + gp))
        ok, rho = _gain(cost, cost2, dot)
        lam, ni = _lam_update(lam, ni, ok, rho)
        if ok:
            R, t, X = R2, t2, X2
    r, _, _, _, _, z = edges(R, t, X, torch.tensor(0.0, dtype=dt, device=dev))
    outlier = (info_v > 0) & ((z <= 0) | (torch.sum(r * r, -1) > max_error_sq))
    return R, t, X, outlier
