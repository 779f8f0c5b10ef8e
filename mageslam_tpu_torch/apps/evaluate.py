"""Trajectory evaluation: ATE RMSE against ground truth (the port's own
numpy copy of mageslam_tpu/apps/evaluate.py). TUM protocol: associate
estimate and ground truth by timestamp, align with a similarity transform
(Umeyama: a monocular trajectory needs the scale), report the RMSE of the
aligned position residuals.

Usage: python -m mageslam_tpu_torch.apps.evaluate trajectory.csv groundtruth.txt
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def load_trajectory_csv(path: str):
    """The console's CSV (apps/console.py): frame id, timestamp, 16
    world-matrix values a row. Returns (ids, timestamps, centers)."""
    ids, ts, centers = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 18:
                continue
            ids.append(int(parts[0]))
            ts.append(float(parts[1]))
            centers.append(np.array([float(x) for x in parts[2:18]]).reshape(4, 4)[:3, 3])
    return np.array(ids), np.array(ts), np.array(centers)


def load_tum_groundtruth(path: str):
    """TUM groundtruth.txt: (timestamps, centers)."""
    ts, centers = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = line.split()
            ts.append(float(v[0]))
            centers.append([float(v[1]), float(v[2]), float(v[3])])
    return np.array(ts), np.array(centers)


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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trajectory", help="console output CSV")
    p.add_argument("groundtruth", help="TUM groundtruth.txt")
    p.add_argument("--max-dt", type=float, default=0.02)
    args = p.parse_args(argv)
    _, est_ts, est_c = load_trajectory_csv(args.trajectory)
    gt_ts, gt_c = load_tum_groundtruth(args.groundtruth)
    rmse, n = ate_rmse(est_ts, est_c, gt_ts, gt_c, args.max_dt)
    print(f"ate_rmse={rmse:.4f} m over {n} associated poses")
    return 0


if __name__ == "__main__":
    sys.exit(main())
