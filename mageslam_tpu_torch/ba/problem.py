"""Fixed-shape bundle-adjustment problem container (port of
mageslam_tpu/ba/problem.py).

Cameras, map points, observations with a per-observation information scalar,
and distance / relative-rotation / relative-transform tether constraints
(BundlerLib.h:27-49) as padded tensors with validity masks. Index tensors
point into the padded camera and point banks; invalid slots carry index 0
and weight 0, so gathers stay in bounds and their sums add nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.se3 import Pose

# tether kinds (Data/Tether.h:12-68)
TETHER_DISTANCE = 0
TETHER_ROTATION = 1
TETHER_TRANSFORM = 2


class BAProblem(NamedTuple):
    """Padded BA problem: K cameras, P points, O observations, T tethers."""

    # cameras
    poses: Pose                   # R (K, 3, 3), t (K, 3) world→camera
    intrinsics: torch.Tensor      # (K, 4) fx, fy, cx, cy, undistorted space
    cam_fixed: torch.Tensor       # (K,) bool
    cam_valid: torch.Tensor       # (K,) bool

    # points
    points: torch.Tensor          # (P, 3)
    pt_valid: torch.Tensor        # (P,) bool

    # observations (EdgeProjectXYZ2UV with a Huber kernel)
    obs_cam: torch.Tensor         # (O,) int32 → camera slot
    obs_pt: torch.Tensor          # (O,) int32 → point slot
    obs_uv: torch.Tensor          # (O, 2) f32 measured undistorted pixels
    obs_info: torch.Tensor        # (O,) f32 information scalar, 0 = invalid

    # tethers, all three kinds in one bank
    tether_kind: torch.Tensor     # (T,) int32 TETHER_*
    tether_cam1: torch.Tensor     # (T,) int32
    tether_cam2: torch.Tensor     # (T,) int32
    tether_pose: Pose             # (T,) measured delta cam1→cam2
    tether_distance: torch.Tensor  # (T,) f32 measured distance
    tether_weight: torch.Tensor   # (T,) f32, 0 = invalid

    points_fixed: bool = False    # BundlerParameters::ArePointsFixed

    @property
    def num_cameras(self) -> int:
        return self.poses.t.shape[0]

    @property
    def num_points(self) -> int:
        return self.points.shape[0]

    @property
    def num_observations(self) -> int:
        return self.obs_cam.shape[0]


def empty_problem(n_cams: int, n_points: int, n_obs: int, n_tethers: int = 8,
                  points_fixed: bool = False, device=None) -> BAProblem:
    """All-invalid problem of the given capacities."""
    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    intrinsics = torch.tensor([[1.0, 1.0, 0.0, 0.0]], dtype=torch.float32,
                              device=device).repeat(n_cams, 1)
    return BAProblem(
        poses=Pose.identity((n_cams,), device=device),
        intrinsics=intrinsics,
        cam_fixed=full((n_cams,), False, torch.bool),
        cam_valid=full((n_cams,), False, torch.bool),
        points=full((n_points, 3), 0.0, torch.float32),
        pt_valid=full((n_points,), False, torch.bool),
        obs_cam=full((n_obs,), 0, torch.int32),
        obs_pt=full((n_obs,), 0, torch.int32),
        obs_uv=full((n_obs, 2), 0.0, torch.float32),
        obs_info=full((n_obs,), 0.0, torch.float32),
        tether_kind=full((n_tethers,), 0, torch.int32),
        tether_cam1=full((n_tethers,), 0, torch.int32),
        tether_cam2=full((n_tethers,), 0, torch.int32),
        tether_pose=Pose.identity((n_tethers,), device=device),
        tether_distance=full((n_tethers,), 1.0, torch.float32),
        tether_weight=full((n_tethers,), 0.0, torch.float32),
        points_fixed=points_fixed,
    )


def without_tethers(problem: BAProblem) -> BAProblem:
    """The problem with an empty tether bank: the same optimum where no
    tether has weight, without the tether residuals' work."""
    return problem._replace(
        tether_kind=problem.tether_kind[:0], tether_cam1=problem.tether_cam1[:0],
        tether_cam2=problem.tether_cam2[:0],
        tether_pose=Pose(problem.tether_pose.R[:0], problem.tether_pose.t[:0]),
        tether_distance=problem.tether_distance[:0],
        tether_weight=problem.tether_weight[:0])


class BAState(NamedTuple):
    """Optimizer state carried across steps: the variables and the LM lambda
    (BundlerLib::Set/GetCurrentLambda, BundlerLib.cpp:354-362)."""

    poses: Pose
    points: torch.Tensor
    lam: torch.Tensor        # () f32 current lambda; <= 0 means "initialize from H"
    ni: torch.Tensor         # () f32 lambda growth factor (g2o `_ni`)
    obs_info: torch.Tensor   # (O,) f32; outlier removal zeroes entries

    @staticmethod
    def from_problem(p: BAProblem, user_lambda=-1.0) -> "BAState":
        dev = p.points.device
        return BAState(
            poses=p.poses,
            points=p.points,
            lam=torch.as_tensor(user_lambda, dtype=torch.float32, device=dev),
            ni=torch.tensor(2.0, dtype=torch.float32, device=dev),
            obs_info=p.obs_info,
        )
