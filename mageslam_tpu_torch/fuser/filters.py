"""Error-state EKF for visual-inertial fusion, as plain functions on tensors
(port of mageslam_tpu/fuser/filters.py).

The reference wraps internal `ST::` Kalman filters behind SensorFilter3Dof /
SensorFilter6Dof / SensorFilterSimple6Dof (FuserLib SensorFilter.h:99-157);
those internals were never open-sourced. This is a standard error-state EKF
in float32 on the state's device: fixed-shape state, dense 15×15 algebra, no
branches and no host read.

State (16): q (w,x,y,z) body→world, p world, v world, bg gyro bias, ba accel
bias. Error state (15): [δθ, δp, δv, δbg, δba].

  predict: strapdown IMU integration + first-order covariance propagation
  update_pose: visual pose observation (world→camera R, t → body pose with
               identity camera-to-body by default)
  update_gravity (3DoF mode): accelerometer direction observation — what the
               reference's WaitForGravityConverge mode runs

Every product is a float32 matmul, which the package keeps out of TF32 on
the card (mageslam_tpu_torch/__init__.py). The Kalman gain inverts S with
`torch.linalg.inv_ex`, whose error flag stays on the device: `inv` would
stop the host to check it. Constant vectors and measurement matrices are
made on the device once (`_vec`, `_selector`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.se3 import Pose, hat, quat_mul, quat_to_rot
from ..interop import resolve_device

GRAVITY = 9.80665


class EkfState(NamedTuple):
    q: torch.Tensor      # (4,) unit quaternion body→world
    p: torch.Tensor      # (3,)
    v: torch.Tensor      # (3,)
    bg: torch.Tensor     # (3,)
    ba: torch.Tensor     # (3,)
    P: torch.Tensor      # (15, 15) error covariance


_CONSTANTS: dict[tuple, torch.Tensor] = {}


def _vec(values, like: torch.Tensor) -> torch.Tensor:
    """A constant float32 vector on `like`'s device, made once: a copy from
    the host waits for the card's queue to drain."""
    key = (tuple(values), like.device)
    if key not in _CONSTANTS:
        _CONSTANTS[key] = torch.tensor(values, dtype=torch.float32, device=like.device)
    return _CONSTANTS[key]


def _selector(rows: int, cols: tuple[int, ...], like: torch.Tensor) -> torch.Tensor:
    """(rows, 15) measurement matrix with an identity block at each of
    `cols`, made once a device."""
    key = (rows, cols, like.device)
    if key not in _CONSTANTS:
        H = torch.zeros((rows, 15), dtype=torch.float32, device=like.device)
        for k, c in enumerate(cols):
            H[3 * k:3 * k + 3, c:c + 3] = torch.eye(3, dtype=torch.float32,
                                                    device=like.device)
        _CONSTANTS[key] = H
    return _CONSTANTS[key]


def ekf_init(q: torch.Tensor | None = None, p: torch.Tensor | None = None,
             att_var: float = 1e-2, pos_var: float = 1e-2, vel_var: float = 1e-1,
             bg_var: float = 1e-4, ba_var: float = 1e-2, device="cuda") -> EkfState:
    """The filter at rest on `device` (q, p: a start attitude and position)."""
    device = resolve_device(device)
    diag = torch.tensor([att_var] * 3 + [pos_var] * 3 + [vel_var] * 3 + [bg_var] * 3
                        + [ba_var] * 3, dtype=torch.float32, device=device)
    zeros = torch.zeros(3, dtype=torch.float32, device=device)
    return EkfState(
        q=q if q is not None else torch.tensor([1.0, 0.0, 0.0, 0.0], device=device),
        p=p if p is not None else zeros,
        v=zeros, bg=zeros, ba=zeros, P=torch.diag(diag),
    )


def _small_quat(dtheta: torch.Tensor) -> torch.Tensor:
    half = 0.5 * dtheta
    w = torch.sqrt(torch.clamp_min(1.0 - torch.sum(half * half), 1e-12))
    return torch.cat([w[None], half])


def _normalized(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp_min(torch.linalg.vector_norm(q), 1e-12)


def ekf_predict(state: EkfState, gyro: torch.Tensor, accel: torch.Tensor,
                dt: torch.Tensor, gyro_noise: float = 1e-3, accel_noise: float = 1e-2,
                gyro_bias_walk: float = 1e-6, accel_bias_walk: float = 1e-5) -> EkfState:
    """Strapdown propagation with one IMU sample over dt (a float32 scalar
    tensor)."""
    w = gyro - state.bg
    a = accel - state.ba
    R = quat_to_rot(state.q)
    g = _vec([0.0, 0.0, -GRAVITY], R)

    q_new = _normalized(quat_mul(state.q, _small_quat(w * dt)))
    a_world = R @ a + g
    v_new = state.v + a_world * dt
    p_new = state.p + state.v * dt + 0.5 * a_world * dt * dt

    # error-state transition F (15×15)
    eye = torch.eye(3, dtype=torch.float32, device=R.device)
    F = torch.eye(15, dtype=torch.float32, device=R.device)
    F[0:3, 0:3] = eye - hat(w) * dt
    F[0:3, 9:12] = -eye * dt
    F[3:6, 6:9] = eye * dt
    F[6:9, 0:3] = -R @ hat(a) * dt
    F[6:9, 12:15] = -R * dt

    rates = _vec([gyro_noise**2] * 3 + [0.0] * 3 + [accel_noise**2] * 3
                 + [gyro_bias_walk**2] * 3 + [accel_bias_walk**2] * 3, R)
    P_new = F @ state.P @ F.T + torch.diag(rates * dt)
    return EkfState(q=q_new, p=p_new, v=v_new, bg=state.bg, ba=state.ba, P=P_new)


def _inject(state: EkfState, dx: torch.Tensor) -> EkfState:
    q = _normalized(quat_mul(state.q, _small_quat(dx[0:3])))
    return state._replace(
        q=q, p=state.p + dx[3:6], v=state.v + dx[6:9],
        bg=state.bg + dx[9:12], ba=state.ba + dx[12:15],
    )


def _kalman(state: EkfState, H: torch.Tensor, r: torch.Tensor, Rm: torch.Tensor) -> EkfState:
    """The update with measurement matrix H, residual r and noise Rm, the
    covariance in Joseph form."""
    S = H @ state.P @ H.T + Rm
    K = state.P @ H.T @ torch.linalg.inv_ex(S).inverse
    dx = K @ r
    IKH = torch.eye(15, dtype=torch.float32, device=S.device) - K @ H
    P = IKH @ state.P @ IKH.T + K @ Rm @ K.T
    return _inject(state, dx)._replace(P=P)


def _vee_residual(dR: torch.Tensor) -> torch.Tensor:
    # log(dR) ≈ vee(dR - I) for a small rotation
    return 0.5 * torch.stack([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                              dR[1, 0] - dR[0, 1]])


def ekf_update_pose(state: EkfState, visual_pose: Pose, pos_noise: float = 1e-2,
                    rot_noise: float = 1e-2,
                    pose_cov: torch.Tensor | None = None) -> EkfState:
    """Visual pose update: world→camera pose observation (camera ≡ body).
    Measurement: body position p_m = camera center, attitude R_m = R_wcᵀ.

    pose_cov, when given, is the (6, 6) reprojection-derived covariance in
    [rho(3), phi(3)] twist order (fuser.covariance.estimate_pose_covariance
    ↔ Fuser::EstimatePoseCovariance, Fuser.h:51-75); its blocks are permuted
    into the filter's [attitude, position] measurement order and floored by
    the scalar noise defaults."""
    p_m = visual_pose.center()
    R_m = visual_pose.R.transpose(-1, -2)        # body→world
    R = quat_to_rot(state.q)
    r = torch.cat([_vee_residual(R.T @ R_m), p_m - state.p])
    H = _selector(6, (0, 3), R)
    floor = torch.diag(_vec([rot_noise**2] * 3 + [pos_noise**2] * 3, R))
    if pose_cov is None:
        Rm = floor
    else:
        # [rho, phi] → [att, pos]: both axes' halves swapped
        Rm = torch.roll(pose_cov, (3, 3), (0, 1)) + floor
    return _kalman(state, H, r, Rm)


def ekf_update_rotation(state: EkfState, visual_pose: Pose, rot_noise: float = 1e-2,
                        rot_cov: torch.Tensor | None = None) -> EkfState:
    """3DoF visual update: attitude only (SensorFilter3Dof::
    AddVisualRotationUpdate, SensorFilter.h:99-112) — position states are
    untouched, for the VISUAL_INERTIAL_FUSION_WITH_3DOF filter mode."""
    R_m = visual_pose.R.transpose(-1, -2)
    R = quat_to_rot(state.q)
    r = _vee_residual(R.T @ R_m)
    H = _selector(3, (0,), R)
    Rm = torch.eye(3, dtype=torch.float32, device=R.device) * rot_noise**2
    if rot_cov is not None:
        Rm = rot_cov + Rm
    return _kalman(state, H, r, Rm)


def ekf_update_gravity(state: EkfState, accel: torch.Tensor, noise: float = 0.5) -> EkfState:
    """3DoF gravity-direction update (WaitForGravityConverge mode): the
    accelerometer, at low dynamics, measures -g in the body frame."""
    R = quat_to_rot(state.q)
    pred = R.T @ _vec([0.0, 0.0, GRAVITY], R)   # expected accel (static)
    a_dir = accel / torch.clamp_min(torch.linalg.vector_norm(accel), 1e-9) * GRAVITY
    r = a_dir - pred
    H = torch.zeros((3, 15), dtype=torch.float32, device=R.device)
    H[0:3, 0:3] = hat(pred)
    Rm = torch.eye(3, dtype=torch.float32, device=R.device) * noise**2
    return _kalman(state, H, r, Rm)


def pose_from_state(state: EkfState) -> Pose:
    """World→camera pose prior from the filter (IMUPosePriorProvider)."""
    R_cw = quat_to_rot(state.q).T
    return Pose(R_cw, -R_cw @ state.p)


def gravity_in_body(state: EkfState) -> torch.Tensor:
    R = quat_to_rot(state.q)
    return R.T @ _vec([0.0, 0.0, -GRAVITY], R)
