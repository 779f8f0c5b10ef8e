"""The Fuser: VI mode state machine, gravity convergence, metric scale (port
of mageslam_tpu/fuser/fuser.py).

Replaces Fuser/Fuser.{h,cpp} (870 LoC, excluded from the reference build —
FuserStubs.cpp throws on every call) and Tasks/FuserWorker.cpp:37-80's mode
machine:

  WAIT_FOR_MAGE_INIT      — visual map not yet initialized
  WAIT_FOR_GRAVITY        — run 3DoF gravity updates until attitude converges
  SCALE_INIT              — accumulate (visual Δp, inertially-integrated Δp)
                            pairs; metric scale = ratio of path lengths
  TRACKING                — full 6DoF EKF: IMU propagation between frames,
                            visual pose updates at frames; provides pose
                            priors (IMUPosePriorProvider equivalent)

The filter state lives on the fuser's device; the mode machine and the
scale solve (float64 least squares over the window) run on the host. A
frame's inertial samples go to the device in one copy, a visual update's
pose (and covariance) in another. The host reads the device once on each
WAIT_FOR_GRAVITY frame (the attitude block of P, for the convergence test)
and once on each SCALE_INIT frame with a visual pose (the integrated
position); `host_reads` counts them. TRACKING frames read nothing: the
session hands the visual pose and its covariance over as host arrays.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from ..config import FilterType
from ..geometry.se3 import Pose
from ..interop import resolve_device
from .filters import (ekf_init, ekf_predict, ekf_update_gravity, ekf_update_pose,
                      ekf_update_rotation, pose_from_state)
from .sample_queue import SampleQueue, SampleType, SensorSample


class FuserMode(enum.Enum):
    WAIT_FOR_MAGE_INIT = 0
    WAIT_FOR_GRAVITY = 1
    SCALE_INIT = 2
    TRACKING = 3


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Fuser:
    def __init__(self, gravity_converge_var: float = 1e-3, scale_window: int = 10,
                 filter_type=None, device="cuda"):
        """filter_type selects the sensor filter (config.FilterType ↔
        SensorFilter3Dof/6Dof/Simple6Dof, SensorFilter.h:99-157):
          FUSER3DOF  — attitude-only: gravity + visual ROTATION updates, no
                       scale estimation, rotation-only priors
          FUSER6DOF  — the full error-state EKF (default)
          SIMPLE6DOF — 6DoF propagation with the IMU bias states frozen
                       (the internal SimpleIMUFilter's reduced model)
        """
        self.device = resolve_device(device)
        self.queue = SampleQueue()
        self.state = ekf_init(device=self.device)
        self.mode = FuserMode.WAIT_FOR_MAGE_INIT
        self.gravity_converge_var = gravity_converge_var
        self.scale_window = scale_window
        self.filter_type = FilterType.FUSER6DOF if filter_type is None else filter_type
        self._scale_pairs: list = []        # (Δc_visual (3,), Δp_imu (3,), dt)
        self.metric_scale: float | None = None
        self._last_time: float | None = None
        self._last_visual_center: np.ndarray | None = None
        self._last_center_dev: torch.Tensor | None = None
        self._last_scale_time: float | None = None
        self.host_reads = 0

    # -- events (the mediator messages of FuserWorker) -------------------- #
    def on_mage_initialized(self) -> None:
        if self.mode == FuserMode.WAIT_FOR_MAGE_INIT:
            self.mode = FuserMode.WAIT_FOR_GRAVITY

    def add_sample(self, sample: SensorSample) -> None:
        self.queue.add(sample)

    # -- per-frame processing -------------------------------------------- #
    def _imu_rows(self, samples: list[SensorSample]) -> np.ndarray:
        """(n, 7) float32 rows [gyro, accel, dt] of the accelerometer samples
        that move the filter in the current mode, advancing the integration
        clock over every accelerometer sample. Gyro samples do NOT advance
        the clock: each holds the latest angular rate for the next accel
        step (a gyro+accel pair sharing one hardware timestamp must still
        integrate over the full sample period; keying dt off "previous
        sample of any type" made paired streams integrate over dt=0 and
        froze the filter position — caught by the end-to-end VI run)."""
        gyro = np.zeros(3, np.float32)
        rows = []
        for s in samples:
            if s.type == SampleType.GYROMETER:
                gyro = np.asarray(s.data, np.float32)
            elif s.type == SampleType.ACCELEROMETER:
                dt = 0.0 if self._last_time is None else max(s.timestamp - self._last_time, 0.0)
                self._last_time = s.timestamp
                moves = (self.mode == FuserMode.WAIT_FOR_GRAVITY or
                         (dt > 0 and self.mode in (FuserMode.SCALE_INIT, FuserMode.TRACKING)))
                if moves:
                    rows.append(np.concatenate([gyro, np.asarray(s.data, np.float32),
                                                np.float32([dt])]))
        return np.asarray(rows, np.float32).reshape(-1, 7)

    def _to_device(self, *parts: np.ndarray) -> list[torch.Tensor]:
        """Host arrays to the device in one copy, as float32 views."""
        flat = [np.asarray(p, np.float32) for p in parts]
        packed = torch.from_numpy(np.concatenate([f.reshape(-1) for f in flat])).to(self.device)
        out, at = [], 0
        for f in flat:
            out.append(packed[at:at + f.size].view(f.shape))
            at += f.size
        return out

    def _zero_biases(self) -> None:
        zeros = torch.zeros(3, dtype=torch.float32, device=self.device)
        self.state = self.state._replace(bg=zeros, ba=zeros)

    def process_frame(self, visual_pose: Pose | None, timestamp: float,
                      pose_covariance=None) -> None:
        """Consume inertial samples up to this frame's fence, then apply the
        visual update according to the current mode. `visual_pose` is the
        frame's world→camera pose (host arrays or tensors) or None;
        `pose_covariance` the optional (6, 6) reprojection-derived
        covariance in [rho, phi] order (fuser.covariance ↔
        Fuser::EstimatePoseCovariance) weighting the visual update."""
        self.queue.add_image_fence(timestamp)
        samples, _ = self.queue.drain_until_fence()
        rows = self._imu_rows(samples)
        if len(rows):
            (imu,) = self._to_device(rows)
            for row in imu:
                if self.mode == FuserMode.WAIT_FOR_GRAVITY:
                    self.state = ekf_update_gravity(self.state, row[3:6])
                    continue
                self.state = ekf_predict(self.state, row[0:3], row[3:6], row[6])
                if self.filter_type == FilterType.SIMPLE6DOF:
                    # SimpleIMUFilter: no online bias estimation
                    self._zero_biases()

        if self.mode == FuserMode.WAIT_FOR_GRAVITY:
            # yaw is unobservable from gravity — converge on the two
            # observable attitude axes (smallest covariance eigenvalues)
            self.host_reads += 1
            eig = np.sort(np.linalg.eigvalsh(self.state.P[0:3, 0:3].cpu().numpy()))
            if float(eig[0] + eig[1]) < self.gravity_converge_var:
                # 3DoF mode never estimates metric scale — it provides
                # rotation-only fusion (SensorFilter3Dof)
                if self.filter_type == FilterType.FUSER3DOF:
                    self.mode = FuserMode.TRACKING
                else:
                    self.mode = FuserMode.SCALE_INIT
            return

        if visual_pose is None or self.mode == FuserMode.WAIT_FOR_MAGE_INIT:
            return
        if isinstance(visual_pose.R, torch.Tensor) and visual_pose.R.is_cuda:
            self.host_reads += 1
        R, t = _host(visual_pose.R).astype(np.float32), _host(visual_pose.t).astype(np.float32)
        center = -R.T @ t
        cov = None if pose_covariance is None else _host(pose_covariance).astype(np.float32)

        if self.filter_type == FilterType.FUSER3DOF:
            if self.mode == FuserMode.TRACKING:
                parts = [R, t, center] + ([] if cov is None else [cov[3:, 3:]])
                R_d, t_d, c_d, *rot_cov = self._to_device(*parts)
                self.state = ekf_update_rotation(self.state, Pose(R_d, t_d),
                                                 rot_cov=rot_cov[0] if rot_cov else None)
                self._last_visual_center, self._last_center_dev = center, c_d
            return

        if self.mode == FuserMode.SCALE_INIT:
            # visual ROTATION update during scale init: attitude from vision
            # is scale-free, and an uncorrected attitude error from gravity
            # convergence (~1-2°) leaks g·sinθ ≈ 0.2-0.3 m/s² into the
            # velocity integral — the dominant scale-estimate error. Position
            # stays vision-free: it IS the measurement being ratioed.
            R_d, t_d = self._to_device(R, t)
            self.state = ekf_update_rotation(self.state, Pose(R_d, t_d))
            if self._last_visual_center is not None:
                dc = center - self._last_visual_center      # map units
                self.host_reads += 1
                dp = self.state.p.cpu().numpy().astype(np.float64)  # metres, v carried
                dt = (timestamp - self._last_scale_time
                      if self._last_scale_time is not None else 0.0)
                if np.linalg.norm(dc) > 1e-6 and dt > 0:
                    self._scale_pairs.append((dc, dp, dt))
            self._last_visual_center = center
            self._last_scale_time = timestamp
            self.state = self.state._replace(p=torch.zeros(3, device=self.device))  # re-anchor
            if len(self._scale_pairs) >= self.scale_window:
                # the filter's velocity integrates from v=0 at window start
                # while the camera is already moving, so each per-frame IMU
                # displacement is missing a v₀·dt term. Solve jointly for
                # scale s and the unknown initial velocity v₀:
                # s·Δc_k − v₀·dt_k = Δp_k (VINS-style linear alignment).
                A = np.concatenate([np.concatenate([dc[:, None], -dt * np.eye(3)], axis=1)
                                    for dc, _, dt in self._scale_pairs])       # (3n, 4)
                b = np.concatenate([dp for _, dp, _ in self._scale_pairs])
                x, *_ = np.linalg.lstsq(A, b, rcond=None)
                self.metric_scale = float(max(x[0], 1e-12))
                self.mode = FuserMode.TRACKING
            return

        if self.mode == FuserMode.TRACKING:
            # scale the visual pose into metric units before the EKF update
            s = self.metric_scale or 1.0
            parts = [R, t * s]
            if cov is not None:
                metric_cov = cov.copy()
                metric_cov[:3, :] *= s
                metric_cov[:, :3] *= s
                parts.append(metric_cov)
            R_d, t_d, *metric_cov = self._to_device(*parts)
            self.state = ekf_update_pose(self.state, Pose(R_d, t_d),
                                         pose_cov=metric_cov[0] if metric_cov else None)
            if self.filter_type == FilterType.SIMPLE6DOF:
                # SimpleIMUFilter: biases frozen against UPDATE injection
                # too, not just predict (the Kalman gain's bias rows are
                # nonzero once propagation has built cross-covariances)
                self._zero_biases()

    # -- outputs ---------------------------------------------------------- #
    def pose_prior(self) -> Pose | None:
        """IMU-predicted pose prior in VISUAL map units (IMUPosePriorProvider),
        on the device; no host read. In 3DoF mode the prior is
        rotation-only (position held at the last visual center — the
        caller's motion model supplies translation)."""
        if self.mode != FuserMode.TRACKING:
            return None
        metric = pose_from_state(self.state)
        if self.filter_type == FilterType.FUSER3DOF:
            c = (self._last_center_dev if self._last_center_dev is not None else
                 torch.zeros(3, device=self.device))
            return Pose(metric.R, -metric.R @ c)
        if self.metric_scale is None or self.metric_scale < 1e-6:
            # degenerate scale estimate (e.g. a stationary SCALE_INIT
            # window) — a prior divided by it would be garbage; fall back
            # to the caller's motion model
            return None
        return Pose(metric.R, metric.t * (1.0 / self.metric_scale))
