"""Trajectory evaluation: ATE RMSE against ground truth (the port's own
numpy copy of mageslam_tpu/apps/evaluate.py's metric). TUM protocol:
associate estimate and ground truth by timestamp, align with a similarity
transform (Umeyama: a monocular trajectory needs the scale), report the
RMSE of the aligned position residuals."""

from __future__ import annotations

import numpy as np


def associate(ts_a: np.ndarray, ts_b: np.ndarray, max_dt: float = 0.02):
    """Nearest-timestamp association (TUM associate.py semantics)."""
    ia, ib = [], []
    for i, t in enumerate(ts_a):
        j = int(np.argmin(np.abs(ts_b - t)))
        if abs(ts_b[j] - t) <= max_dt:
            ia.append(i)
            ib.append(j)
    return np.array(ia, int), np.array(ib, int)


def umeyama_align(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Similarity transform (s, R, t) minimizing ||s R src + t - dst||^2."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    U, D, Vt = np.linalg.svd(xd.T @ xs / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / max((xs ** 2).sum() / len(src), 1e-12)) \
        if with_scale else 1.0
    return s, R, mu_d - s * R @ mu_s


def ate_rmse(est_ts, est_centers, gt_ts, gt_centers, max_dt: float = 0.02):
    """(RMSE in ground-truth units, number of associated poses)."""
    ia, ib = associate(est_ts, gt_ts, max_dt)
    if len(ia) < 3:
        return float("nan"), 0
    e, g = est_centers[ia], gt_centers[ib]
    s, R, t = umeyama_align(e, g, with_scale=True)
    err = np.linalg.norm((s * (R @ e.T)).T + t - g, axis=1)
    return float(np.sqrt((err ** 2).mean())), len(ia)
