"""Visual-inertial end-to-end evaluation: the UseFuser=true path on rendered
pixels with a synthesized IMU stream (port of mageslam_tpu/apps/vi_eval.py).

Sensor samples go through `SlamSession.add_sensor_sample` (MAGESlam::
AddSensorSample) before each frame's `process_frame`, through the fuser's
mode machine (Tasks/FuserWorker.cpp:37-80 — WaitForGravityConverge →
ScaleInit → Tracking), metric-scale estimation, and IMU pose priors feeding
tracking (IMUPosePriorProvider); the run ends in `fossilize`.

IMU synthesis (exact differentiation of the analytic ground-truth
trajectory by central differences at sub-frame step):
  gyro  = body angular rate:  vee(R_wbᵀ · dR_wb/dt)            + bias + noise
  accel = specific force:     R_wbᵀ · (d²c/dt² − g_world)      + bias + noise
Gravity convention: the error-state EKF's world is z-up (fuser/filters.py
GRAVITY, g_world = (0, 0, −G)); the synthetic IMU therefore defines
"down" as +z in the render world. The sweep/orbit trajectories start at
R = I, so the monocular map frame (first camera = gauge origin) coincides
with the render world orientation and the visual updates are consistent
with the gravity updates without a map↔IMU alignment stage.

Usage: python -m mageslam_tpu_torch.apps.vi_eval [--frames 80] [--imu-rate 120]
       [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from ..fuser.filters import GRAVITY
from ..fuser.sample_queue import SampleType, SensorSample

FPS = 30.0


def _vee(A: np.ndarray) -> np.ndarray:
    return 0.5 * np.array([A[2, 1] - A[1, 2], A[0, 2] - A[2, 0],
                           A[1, 0] - A[0, 1]], np.float64)


def synthesize_imu(traj_fn, n_frames: int, period: int,
                   imu_rate: float = 120.0, seed: int = 3,
                   gyro_noise: float = 0.002, accel_noise: float = 0.02,
                   gyro_bias: float = 0.003, accel_bias: float = 0.03):
    """Gyro/accel SensorSamples along the analytic trajectory, with constant
    biases and white noise (device/presets.py IMU characterization scale).
    traj_fn(i, period) -> (R_cw, c) accepts float frame indices."""
    rng = np.random.default_rng(seed)
    bg = rng.normal(0.0, gyro_bias, 3)
    ba = rng.normal(0.0, accel_bias, 3)
    g_world = np.array([0.0, 0.0, -GRAVITY])
    h = 0.05                                  # frames; central-difference step
    samples = []
    n_samples = int(n_frames * imu_rate / FPS)
    for k in range(n_samples):
        ts = k / imu_rate
        i = ts * FPS
        R0, c0 = traj_fn(i, period)
        Rp, cp = traj_fn(i + h, period)
        Rm, cm = traj_fn(i - h, period)
        R_wb = R0.astype(np.float64).T        # body→world (camera ≡ body)
        dR_wb = (Rp.T - Rm.T).astype(np.float64) / (2 * h) * FPS
        omega = _vee(R_wb.T @ dR_wb)
        a_world = (cp - 2.0 * c0 + cm).astype(np.float64) / (h * h) * FPS * FPS
        f_body = R_wb.T @ (a_world - g_world)
        samples.append(SensorSample(
            SampleType.GYROMETER, ts,
            (omega + bg + rng.normal(0, gyro_noise, 3)).astype(np.float32)))
        samples.append(SensorSample(
            SampleType.ACCELEROMETER, ts,
            (f_body + ba + rng.normal(0, accel_noise, 3)).astype(np.float32)))
    return samples


def vi_settings(filter_type=None, settings=None):
    """`settings` (golden by default) with UseFuser on and `filter_type`
    (SIMPLE6DOF by default)."""
    from ..config import FilterType, golden_path_settings

    ft = FilterType.SIMPLE6DOF if filter_type is None else filter_type
    s = settings if settings is not None else golden_path_settings()
    return dataclasses.replace(s, FuserSettings=dataclasses.replace(
        s.FuserSettings, UseFuser=True, FilterType=ft))


def replay_fuser(filter_type, samples, calls: dict, adopt_frame: int, n_frames: int,
                 fps: float = FPS, device="cuda") -> dict:
    """A fresh `Fuser` run on a recorded session's inputs: each frame i's
    samples (timestamps up to i / fps), the map's existence from
    `adopt_frame`, and `calls[i]` = (R, t, covariance) or (None, None, None)
    where the session handed frame i to the fuser (a tracked or a failed
    frame). Returns per frame the prior given before the frame (`prior_valid`,
    `prior_R`, `prior_t`), the mode and metric scale after it (`mode`,
    `metric_scale`; NaN while unknown) and the filter's state (`ekf_q`,
    `ekf_p`, `ekf_v`, `ekf_bg`, `ekf_ba`, `ekf_P`), as numpy, and the
    fuser itself (`fuser`)."""
    from ..fuser.fuser import Fuser
    from ..geometry.se3 import Pose

    f = Fuser(filter_type=filter_type, device=device)
    out = {"mode": np.full(n_frames, -1, np.int32),
           "metric_scale": np.full(n_frames, np.nan),
           "prior_valid": np.zeros(n_frames, bool),
           "prior_R": np.full((n_frames, 3, 3), np.nan, np.float32),
           "prior_t": np.full((n_frames, 3), np.nan, np.float32)}
    states = []
    it = 0
    for i in range(n_frames):
        ts = i / fps
        while it < len(samples) and samples[it].timestamp <= ts:
            f.add_sample(samples[it])
            it += 1
        if i == adopt_frame:
            f.on_mage_initialized()
        if i in calls:
            prior = f.pose_prior()
            if prior is not None:
                out["prior_valid"][i] = True
                out["prior_R"][i], out["prior_t"][i] = prior.R.cpu().numpy(), prior.t.cpu().numpy()
            R, t, cov = calls[i]
            f.process_frame(None if R is None else Pose(R, t), ts, pose_covariance=cov)
        out["mode"][i] = f.mode.value
        out["metric_scale"][i] = np.nan if f.metric_scale is None else f.metric_scale
        states.append(torch.cat([x.reshape(-1) for x in f.state]))
    packed = torch.stack(states).cpu().numpy()
    at = 0
    for name, x in zip(f.state._fields, f.state):
        out[f"ekf_{name}"] = packed[:, at:at + x.numel()].reshape((n_frames,) + tuple(x.shape))
        at += x.numel()
    out["fuser"] = f
    return out


def run_vi_eval(n_frames: int = 80, width: int = 320, height: int = 180,
                trajectory: str = "sweep", period: int | None = None,
                imu_rate: float = 120.0, filter_type=None,
                verbose: bool = True, settings=None, device="cuda", draws=None,
                frames=None):
    """Render `trajectory`, interleave the synthesized IMU stream with the
    frames through the public session API, and return mode-transition
    frames, the metric-scale estimate + its ground truth, tracking health,
    ATE RMSE and the session itself (`session`, for its post-run queries).
    `draws` replaces the session's own random draws (runtime/draws.py);
    `frames`, the first `n_frames` images of the rendered sequence, skips
    rendering them again (the ground truth is the trajectory's)."""
    from ..runtime import SlamSession, TrackingState
    from .evaluate import ate_rmse
    from .render_scene import (CX, CY, FX, FY, render_sequence, trajectory_pose,
                               trajectory_pose_circuit, trajectory_pose_fig8,
                               trajectory_pose_orbit)

    period = period or n_frames
    s = vi_settings(filter_type, settings)
    sx, sy = width / 640.0, height / 480.0
    cam = np.array([FX * sx, FY * sy, CX * sx, CY * sy], np.float32)
    sess = SlamSession(s, cam=cam, image_width=width, image_height=height, device=device,
                       draws=draws)

    traj_fn = {"sweep": trajectory_pose, "orbit": trajectory_pose_orbit,
               "circuit": trajectory_pose_circuit,
               "fig8": trajectory_pose_fig8}[trajectory]
    imu = synthesize_imu(traj_fn, n_frames, period, imu_rate=imu_rate)
    imu_iter = iter(imu)
    next_s = next(imu_iter, None)
    if frames is None:
        seq = render_sequence(n_frames, width, height, trajectory=trajectory, period=period)
    else:
        seq = ((frames[i], i / FPS, i, *traj_fn(i, period)) for i in range(n_frames))

    t0 = time.time()
    gt_ts, gt_c, ts_by_id = [], [], {}
    transitions = {}
    prev_mode = sess.fuser.mode
    for img, ts, fid, _R, c in seq:
        # deliver every sensor sample timestamped before this frame — the
        # image-fence ordering AddSensorSample relies on (sample_queue.py)
        while next_s is not None and next_s.timestamp <= ts:
            sess.add_sensor_sample(next_s)
            next_s = next(imu_iter, None)
        sess.process_frame(np.asarray(img, np.float32), ts, fid)
        gt_ts.append(ts)
        gt_c.append(c)
        ts_by_id[fid] = ts
        if sess.fuser.mode != prev_mode:
            transitions[sess.fuser.mode.name] = fid
            prev_mode = sess.fuser.mode
            if verbose:
                print(f"f{fid:3d} fuser → {prev_mode.name}"
                      f" ({time.time() - t0:.0f}s)", file=sys.stderr)

    ids, mats = sess.fossilize(global_ba_steps=None)
    states = [r.state for r in sorted(sess.results, key=lambda r: r.frame_id)]
    est_ts = np.array([ts_by_id[int(i)] for i in ids])
    est_c = np.array([-m[:3, :3].T @ m[:3, 3] for m in mats])
    rmse, n = ate_rmse(est_ts, est_c, np.array(gt_ts), np.array(gt_c))

    # ground-truth metric scale = metric path length / visual path length
    # over the frames the session actually estimated (the mono gauge is the
    # init baseline; the fuser's SCALE_INIT estimates exactly this ratio)
    id_to_gt = {fid: c for fid, c in zip(ts_by_id, gt_c)}
    gt_seq = np.array([id_to_gt[int(i)] for i in ids])
    gt_path = float(np.linalg.norm(np.diff(gt_seq, axis=0), axis=1).sum())
    est_path = float(np.linalg.norm(np.diff(est_c, axis=0), axis=1).sum())
    scale_true = gt_path / max(est_path, 1e-12)

    return {
        "n_frames": n_frames,
        "tracked": sum(st == TrackingState.TRACKING for st in states),
        "transitions": transitions,
        "final_mode": sess.fuser.mode.name,
        "metric_scale": sess.fuser.metric_scale,
        "scale_true": scale_true,
        "ate_rmse": float(rmse),
        "n_poses": int(n),
        "keyframes": int(sess.map.kf_valid.sum()),
        "elapsed_s": time.time() - t0,
        "session": sess,
    }


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frames", type=int, default=80)
    p.add_argument("--trajectory", default="sweep",
                   choices=["sweep", "orbit", "circuit", "fig8"])
    p.add_argument("--period", type=int, default=None)
    p.add_argument("--imu-rate", type=float, default=120.0)
    p.add_argument("--filter", default="simple6dof",
                   choices=["3dof", "6dof", "simple6dof"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    from ..config import FilterType

    ft = {"3dof": FilterType.FUSER3DOF, "6dof": FilterType.FUSER6DOF,
          "simple6dof": FilterType.SIMPLE6DOF}[args.filter]
    r = run_vi_eval(args.frames, trajectory=args.trajectory,
                    period=args.period, imu_rate=args.imu_rate,
                    filter_type=ft, device=args.device)
    print(f"tracked {r['tracked']}/{r['n_frames']}  "
          f"transitions {r['transitions']}  final {r['final_mode']}  "
          f"scale {r['metric_scale']} (true {r['scale_true']:.3f})  "
          f"ATE {r['ate_rmse']:.4f} m / {r['n_poses']} poses  "
          f"({r['elapsed_s']:.0f}s)")


if __name__ == "__main__":
    main()
