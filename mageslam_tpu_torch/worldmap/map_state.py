"""MapState: keyframe and map point banks as padded tensors (port of
mageslam_tpu/worldmap/map_state.py).

Only what tracking reads is ported: the state itself, `empty_map`,
`predict_octave` and `keyframe_centers`. The mapping functions of the
reference module (`grow_map`, `refresh_membership`, `refresh_point_stats*`,
...) come with keyframe mapping.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.se3 import Pose


class MapState(NamedTuple):
    """All SLAM map state. K keyframe slots, P point slots, N feature slots,
    T tether slots. Field order is the reference's (snapshot leaf order)."""

    # --- keyframes ---
    kf_valid: torch.Tensor      # (K,) bool
    kf_fixed: torch.Tensor      # (K,) bool
    kf_immortal: torch.Tensor   # (K,) bool
    kf_pose: Pose               # R (K,3,3), t (K,3) world→camera
    kf_cam: torch.Tensor        # (K, 4) fx, fy, cx, cy
    kf_frame_id: torch.Tensor   # (K,) int32
    kf_order: torch.Tensor      # (K,) int32 insertion sequence number
    kf_kp_xy: torch.Tensor      # (K, N, 2) f32
    kf_kp_octave: torch.Tensor  # (K, N) int32
    kf_desc: torch.Tensor       # (K, N, 8) int32 descriptor bits
    kf_kp_valid: torch.Tensor   # (K, N) bool
    kf_assoc: torch.Tensor      # (K, N) int32 point slot or -1
    kf_member: torch.Tensor     # (K, P) bool: keyframe k observes point p

    # --- map points ---
    mp_valid: torch.Tensor          # (P,) bool
    mp_pos: torch.Tensor            # (P, 3) f32
    mp_desc: torch.Tensor           # (P, 8) int32 representative descriptor
    mp_mean_dir: torch.Tensor       # (P, 3) f32
    mp_dmin: torch.Tensor           # (P,) f32
    mp_dmax: torch.Tensor           # (P,) f32
    mp_refine_count: torch.Tensor   # (P,) int32
    mp_created_order: torch.Tensor  # (P,) int32
    mp_found: torch.Tensor          # (P,) int32
    mp_predicted: torch.Tensor      # (P,) int32

    # --- keyframe tethers ---
    tether_owner: torch.Tensor      # (T,) int32
    tether_origin: torch.Tensor     # (T,) int32
    tether_kind: torch.Tensor       # (T,) int32
    tether_pose: Pose               # (T,)
    tether_distance: torch.Tensor   # (T,) f32
    tether_weight: torch.Tensor     # (T,) f32

    # --- counters ---
    next_order: torch.Tensor        # () int32

    @property
    def capacity(self) -> tuple[int, int, int]:
        K, N = self.kf_assoc.shape
        return K, self.mp_valid.shape[0], N

    def keyframe_centers(self) -> torch.Tensor:
        """(K, 3) camera centers in world space."""
        return self.kf_pose.center()


def empty_map(max_keyframes: int, max_points: int, max_features: int,
              max_tethers: int = 16, device=None) -> MapState:
    K, P, N, T = max_keyframes, max_points, max_features, max_tethers

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    i32, f32, b = torch.int32, torch.float32, torch.bool
    return MapState(
        kf_valid=full((K,), False, b),
        kf_fixed=full((K,), False, b),
        kf_immortal=full((K,), False, b),
        kf_pose=Pose.identity((K,), device=device),
        kf_cam=torch.tensor([[1.0, 1.0, 0.0, 0.0]], dtype=f32, device=device).repeat(K, 1),
        kf_frame_id=full((K,), -1, i32),
        kf_order=full((K,), -1, i32),
        kf_kp_xy=full((K, N, 2), 0.0, f32),
        kf_kp_octave=full((K, N), 0, i32),
        kf_desc=full((K, N, 8), 0, i32),
        kf_kp_valid=full((K, N), False, b),
        kf_assoc=full((K, N), -1, i32),
        kf_member=full((K, P), False, b),
        mp_valid=full((P,), False, b),
        mp_pos=full((P, 3), 0.0, f32),
        mp_desc=full((P, 8), 0, i32),
        mp_mean_dir=full((P, 3), 0.0, f32),
        mp_dmin=full((P,), 0.0, f32),
        mp_dmax=full((P,), 0.0, f32),
        mp_refine_count=full((P,), 0, i32),
        mp_created_order=full((P,), -1, i32),
        mp_found=full((P,), 0, i32),
        mp_predicted=full((P,), 0, i32),
        tether_owner=full((T,), -1, i32),
        tether_origin=full((T,), -1, i32),
        tether_kind=full((T,), 0, i32),
        tether_pose=Pose.identity((T,), device=device),
        tether_distance=full((T,), 1.0, f32),
        tether_weight=full((T,), 0.0, f32),
        next_order=full((), 0, i32),
    )


def predict_octave(distance: torch.Tensor, dmin: torch.Tensor,
                   scale_factor: float) -> torch.Tensor:
    """ComputeOctave (MappingMath.h:13-16): expected pyramid level when
    viewing a point from `distance` given its dMin."""
    ratio = torch.clamp_min(distance / torch.clamp_min(dmin, 1e-12), 1e-12)
    log2_scale = torch.log2(torch.tensor(scale_factor, dtype=torch.float32,
                                         device=distance.device))
    return torch.round(torch.log2(ratio) / log2_scale - 0.5).to(torch.int32)
