"""FossilizedMap: the frozen post-mortem queryable map (port of
mageslam_tpu/runtime/fossilized.py).

Replaces MAGESlam::FossilizedMap (MageSlam.h:109-128, MageSlam.cpp:411-438):
after Fossilize, the caller can query tracking results for arbitrary frames,
export the point cloud (optionally denoised), and compute the volume of
interest from the recorded pose history + bounding depths. Answers are
numpy arrays on the host; the work runs on the map's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..analysis.clouds import reposition_points
from ..analysis.voi import VoiSettings, calculate_volume_of_interest, make_voi_keyframes
from ..geometry.se3 import Pose


def view_matrices(poses: Pose) -> torch.Tensor:
    """(..., 4, 4) homogeneous world→camera matrices of `poses`."""
    mats = torch.zeros(poses.R.shape[:-2] + (4, 4), dtype=poses.R.dtype,
                       device=poses.R.device)
    mats[..., :3, :3] = poses.R
    mats[..., :3, 3] = poses.t
    mats[..., 3, 3] = 1.0
    return mats


def volume_of_interest(poses: Pose, ok: torch.Tensor, near: torch.Tensor, far: torch.Tensor,
                       settings: VoiSettings, min_poses: int = 0):
    """(min_corner, max_corner) as numpy of the poses marked `ok`, or None
    when fewer than `min_poses` (or none) are marked or the LOD loop keeps
    nothing. Two host reads: the marked rows, then the box. Only the marked
    poses are scored (an unmarked one adds nothing): a pose history holds
    thousands of rows, few of them live."""
    rows = torch.nonzero(ok).squeeze(1)
    if rows.numel() == 0 or rows.numel() < min_poses:
        return None
    kf = make_voi_keyframes(Pose(poses.R[rows], poses.t[rows]), near[rows], far[rows],
                            torch.ones_like(rows, dtype=torch.bool), settings)
    lo, hi, got = calculate_volume_of_interest(kf, settings)
    out = torch.cat([lo, hi, got[None].to(lo.dtype)]).cpu().numpy()
    return (out[0:3], out[3:6]) if out[6] > 0 else None


class FossilizedMap:
    def __init__(self, map_state, pose_history, fes):
        self._map = map_state
        self._history = pose_history
        self._fes = fes
        self._poses, valid = pose_history.derive_poses(map_state.kf_pose)
        self._valid_dev = valid
        self._valid = valid.cpu().numpy()
        self._ids = pose_history.frame_id.cpu().numpy()

    # -- GetTrackingResultsForFrames ------------------------------------- #
    def get_tracking_results(self, frame_ids) -> list[np.ndarray | None]:
        """Per requested frame id: the 4×4 world→camera view matrix, or None
        if that frame was never tracked."""
        mats = view_matrices(self._poses).cpu().numpy()
        lut = {int(fid): i for i, fid in enumerate(self._ids) if self._valid[i]}
        out = []
        for fid in frame_ids:
            i = lut.get(int(fid))
            out.append(mats[i] if i is not None else None)
        return out

    def trajectory(self):
        """(frame_ids, (M,4,4) view matrices) sorted by frame id."""
        mats = view_matrices(self._poses).cpu().numpy()
        ok = self._valid
        order = np.argsort(self._ids[ok], kind="stable")
        return self._ids[ok][order], mats[ok][order]

    # -- point cloud ------------------------------------------------------ #
    def map_points(self, denoised: bool = False) -> np.ndarray:
        """(M, 3) world positions of the fossilized cloud; `denoised` runs
        the Clouds/DeNoising repositioning pass first."""
        valid = self._map.mp_valid
        pos = self._map.mp_pos
        if denoised:
            pos = reposition_points(pos, valid)
        return pos.cpu().numpy()[valid.cpu().numpy()]

    # -- TryGetVolumeOfInterest ------------------------------------------- #
    def try_get_volume_of_interest(self, settings: VoiSettings = VoiSettings()):
        """Returns (min_corner, max_corner) or None (MageSlam.cpp:427-438 —
        computed from the historical poses + their bounding depths)."""
        h = self._history
        return volume_of_interest(self._poses, self._valid_dev & (h.far > 0), h.near, h.far,
                                  settings)
