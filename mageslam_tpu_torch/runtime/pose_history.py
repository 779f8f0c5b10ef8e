"""Pose history: every tracked frame's pose stored relative to keyframes
(port of mageslam_tpu/runtime/pose_history.py; PoseHistory.cpp,
HistoricalPose.cpp).

Each record keeps K connection slots with the reference's offset
parameterization in world space:

  off_q = q_kf^-1 * q_frame                 (rotation offset)
  off_p = R_kf_world^-1 (c_frame - c_kf)    (position offset, kf frame)

Only recording is ported (`empty`, `add`, `add_single`); re-deriving and
rebasing poses come with keyframe mapping.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.se3 import Pose, quat_conj, quat_mul, rot_to_quat


def _world_parts(pose: Pose):
    """View pose → (world quaternion (w, x, y, z), camera center)."""
    return rot_to_quat(pose.R.transpose(-1, -2)), pose.center()


class PoseHistory(NamedTuple):
    frame_id: torch.Tensor  # (H,) int32, -1 = empty
    conn_kf: torch.Tensor   # (H, K) int32 keyframe slot per connection
    conn_ok: torch.Tensor   # (H, K) bool
    off_q: torch.Tensor     # (H, K, 4) f32
    off_p: torch.Tensor     # (H, K, 3) f32
    near: torch.Tensor      # (H,) f32
    far: torch.Tensor       # (H,) f32
    count: torch.Tensor     # () int32 next write index (ring buffer)

    @staticmethod
    def empty(capacity: int, connections: int = 4, device=None) -> "PoseHistory":
        off_q = torch.zeros((capacity, connections, 4), dtype=torch.float32,
                            device=device)
        off_q[..., 0] = 1.0
        return PoseHistory(
            frame_id=torch.full((capacity,), -1, dtype=torch.int32, device=device),
            conn_kf=torch.zeros((capacity, connections), dtype=torch.int32, device=device),
            conn_ok=torch.zeros((capacity, connections), dtype=torch.bool, device=device),
            off_q=off_q,
            off_p=torch.zeros((capacity, connections, 3), dtype=torch.float32,
                              device=device),
            near=torch.zeros((capacity,), dtype=torch.float32, device=device),
            far=torch.zeros((capacity,), dtype=torch.float32, device=device),
            count=torch.zeros((), dtype=torch.int32, device=device),
        )

    @property
    def connections(self) -> int:
        return self.conn_kf.shape[1]

    def add(self, frame_id, pose: Pose, conn_poses: Pose, kf_slots, conn_ok,
            near=0.0, far=0.0) -> "PoseHistory":
        """AddHistoricalPose (PoseHistory.cpp:25-56): connect the frame to up
        to K keyframes (their view poses pre-gathered in `conn_poses`) and
        record its bounding-plane depths. Writes at `count % H` on the
        device, with no host read of `count`."""
        K = self.connections
        dev = self.frame_id.device
        kf_slots = torch.as_tensor(kf_slots, dtype=torch.int32, device=dev)[:K]
        conn_ok = torch.as_tensor(conn_ok, device=dev)[:K]
        q_kf, c_kf = _world_parts(conn_poses)
        q_f, c_f = _world_parts(pose)
        off_q = quat_mul(quat_conj(q_kf), q_f[None, :])
        # R_kf_world^-1 is the view-pose rotation itself
        off_p = torch.einsum("kij,kj->ki", conn_poses.R, c_f[None, :] - c_kf)
        i = torch.remainder(self.count, self.frame_id.shape[0]).to(torch.int64).reshape(1)

        def put(bank, value):
            value = torch.as_tensor(value, dtype=bank.dtype, device=dev)
            return bank.index_put((i,), value.expand(bank.shape[1:])[None])

        return self._replace(
            frame_id=put(self.frame_id, frame_id),
            conn_kf=put(self.conn_kf, kf_slots),
            conn_ok=put(self.conn_ok, conn_ok),
            off_q=put(self.off_q, off_q),
            off_p=put(self.off_p, off_p),
            near=put(self.near, near),
            far=put(self.far, far),
            count=self.count + 1,
        )

    def add_single(self, frame_id, pose: Pose, kf_pose: Pose, kf_slot,
                   near=0.0, far=0.0) -> "PoseHistory":
        """One-connection add (init keyframes: the frame is the keyframe)."""
        K = self.connections
        bank = Pose(kf_pose.R[None].expand(K, 3, 3), kf_pose.t[None].expand(K, 3))
        dev = self.frame_id.device
        slots = torch.full((K,), int(kf_slot), dtype=torch.int32, device=dev) \
            if not torch.is_tensor(kf_slot) else kf_slot.to(torch.int32).expand(K)
        ok = torch.arange(K, device=dev) == 0
        return self.add(frame_id, pose, bank, slots, ok, near, far)
