"""`SlamSession`: the host state machine around the per-frame steps (port of
the tracking path of mageslam_tpu/runtime/pipeline.py `SlamSession`).

Per frame: `detect_and_compute` → `track_step` → `post_step`. The host reads
the device twice per frame, as the reference's `_track` does: the tracking
outcome (success and tracked count together) and the keyframe flag.

What is not ported yet fails loudly:
- keyframe mapping: a frame the decision marks returns is_keyframe=True and
  the map is left as it is;
- mono init: `process_frame` on an uninitialized session raises;
- relocalization: `process_frame` in the RELOCALIZING state raises;
- the visual-inertial fuser (FuserSettings.UseFuser) raises at construction.
The reference's relay-only machinery (chunk/stream cores, grouped fetches,
pipeline-depth overrides) has no counterpart here.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import numpy as np
import torch

from .._config import golden_path_settings
from ..geometry.camera import make_pinhole
from ..geometry.se3 import Pose
from ..interop import load_jax_snapshot
from ..ops.frontend import FrameFeatures, detect_and_compute
from ..tracking.frame_state import TrackedFrame, TrackingHistory
from ..worldmap.map_state import empty_map
from .pose_history import PoseHistory
from .post_step import post_step
from .track_step import track_step


class TrackingState(enum.Enum):
    INITIALIZING = 0
    TRACKING = 1
    RELOCALIZING = 2
    SKIPPED = 3


class FrameResult(NamedTuple):
    frame_id: int
    state: TrackingState
    pose: Pose | None          # world→camera when tracked
    tracked_count: int
    is_keyframe: bool


class SlamSession:
    """Monocular tracking session (MageSlam.h:25-187), tracking path only."""

    def __init__(self, settings=None, cam=None, image_width: int = 320,
                 image_height: int = 180, device="cpu"):
        self.settings = settings or golden_path_settings()
        if self.settings.FuserSettings.UseFuser:
            raise NotImplementedError(
                "the visual-inertial fuser (mageslam_tpu/fuser) is not ported yet")
        b = self.settings.Budgets
        self.fes = self.settings.MonoSettings.MonoCamera.FeatureExtractorSettings
        self.device = torch.device(device)
        self.width = image_width
        self.height = image_height
        # undistorted pinhole intrinsics (4,): the matching and BA space
        if cam is None:
            cam = [image_width * 0.82, image_width * 0.82,
                   image_width / 2.0, image_height / 2.0]
        self.cam = torch.as_tensor(np.asarray(cam, np.float32), device=self.device)
        fx, fy, cx, cy = (float(v) for v in self.cam.cpu())
        self.cam16 = make_pinhole(fx, fy, cx, cy, image_width, image_height,
                                  device=self.device)
        self.N = b.MaxFeatures
        self.map = empty_map(min(48, b.MaxKeyframes), min(2048, b.MaxMapPoints),
                             self.N, max_tethers=b.MaxTethers, device=self.device)
        self.history = TrackingHistory.empty(b.TrackingHistoryLength, self.N,
                                             device=self.device)
        self.pose_history = PoseHistory.empty(
            4096, self.settings.PoseHistorySettings.InitalInterpolationConnections,
            device=self.device)
        self.initialized = False
        self.lost_count = 0
        self.frames_since_keyframe = 0
        self.frames_since_reloc = 10_000
        self.results: list[FrameResult] = []

    @classmethod
    def from_jax_snapshot(cls, path: str, settings=None, cam=None,
                          image_width: int = 320, image_height: int = 180,
                          device="cpu") -> "SlamSession":
        """A session holding the state that the JAX package's
        `save_session_snapshot` wrote (same settings and image size)."""
        sess = cls(settings, cam, image_width, image_height, device)
        sess.map, sess.history, sess.pose_history, meta = load_jax_snapshot(
            path, sess.device)
        if (meta["width"], meta["height"]) != (image_width, image_height):
            raise ValueError(f"snapshot image size {meta['width']}x{meta['height']}"
                             f" != {image_width}x{image_height}")
        if sess.map.capacity[2] != sess.N:
            raise ValueError(f"snapshot has {sess.map.capacity[2]} feature slots, "
                             f"settings say {sess.N}")
        sess.initialized = bool(meta["initialized"])
        sess.lost_count = int(meta["lost_count"])
        sess.frames_since_keyframe = int(meta["frames_since_keyframe"])
        sess.frames_since_reloc = int(meta["frames_since_reloc"])
        return sess

    # ------------------------------------------------------------------ #
    def process_frame(self, image, timestamp: float, frame_id: int) -> FrameResult:
        """Analyze and track one grayscale frame (H, W), uint8 or float32
        [0, 255], numpy or tensor."""
        image = torch.as_tensor(image).to(self.device)
        feats = detect_and_compute(image, self.cam16, self.fes, self.N)
        return self.process_features(feats, timestamp, frame_id)

    def process_features(self, feats: FrameFeatures, timestamp: float,
                         frame_id: int) -> FrameResult:
        if not self.initialized:
            raise NotImplementedError(
                "mono initialization (mageslam_tpu/tracking/map_init.py, "
                "pipeline.py:642-847) is not ported yet: start the session "
                "from a JAX snapshot (SlamSession.from_jax_snapshot)")
        if self.lost_count >= \
                self.settings.TrackLocalMapSettings.TrackingLostCountUntilReloc:
            raise NotImplementedError(
                "relocalization (mageslam_tpu/tracking/relocalization.py, "
                "pipeline.py:1887) is not ported yet")
        result = self._track(feats, timestamp, frame_id)
        self.results.append(result)
        return result

    def _scalar(self, value, dtype) -> torch.Tensor:
        return torch.tensor(value, dtype=dtype, device=self.device)

    def _frame(self, feats: FrameFeatures, timestamp, frame_id) -> TrackedFrame:
        return TrackedFrame(
            pose=Pose.identity(device=self.device), cam=self.cam,
            kp_xy=feats.und_xy, kp_octave=feats.octave, desc=feats.desc,
            kp_valid=feats.valid,
            assoc=torch.full((self.N,), -1, dtype=torch.int32, device=self.device),
            timestamp=self._scalar(np.float32(timestamp), torch.float32),
            frame_id=self._scalar(frame_id, torch.int32),
        )

    def _track(self, feats: FrameFeatures, timestamp, frame_id) -> FrameResult:
        """mageslam_tpu/runtime/pipeline.py:1705-1779 `_track`."""
        res = track_step(self.settings, self.width, self.height, self.map,
                         self.history, self._frame(feats, timestamp, frame_id))
        succeeded, tracked = torch.stack(
            [res.succeeded.to(torch.int32), res.tracked_count]).tolist()
        if not succeeded:
            return self._tracking_failed(frame_id)
        frame = res.frame
        self.lost_count = 0
        self.frames_since_keyframe += 1
        self.frames_since_reloc += 1
        self.map, self.history, self.pose_history, is_kf_dev = post_step(
            self.settings, self.width, self.height, self.map, self.history,
            self.pose_history, frame, res.found_delta, res.predicted_delta,
            self._scalar(self.frames_since_keyframe, torch.int32),
            self._scalar(min(self.frames_since_reloc, 10_000), torch.int32))
        # On a keyframe the reference maps it here, _insert_keyframe_and_map
        # (mageslam_tpu/runtime/pipeline.py:1761-1762, 2237). Keyframe mapping
        # is not ported yet (ROADMAP queue 1, item 6): the keyframe is
        # reported and the map is left as it is.
        is_kf = bool(is_kf_dev)
        return FrameResult(frame_id, TrackingState.TRACKING, frame.pose, tracked,
                           is_kf)

    def _tracking_failed(self, frame_id) -> FrameResult:
        """mageslam_tpu/runtime/pipeline.py:1822-1833 `_tracking_failed`."""
        self.lost_count += 1
        lost_limit = self.settings.TrackLocalMapSettings.TrackingLostCountUntilReloc
        if self.lost_count >= lost_limit:
            if self.lost_count == lost_limit:
                self.history = self.history.clear()
            return FrameResult(frame_id, TrackingState.RELOCALIZING, None, 0, False)
        return FrameResult(frame_id, TrackingState.SKIPPED, None, 0, False)
