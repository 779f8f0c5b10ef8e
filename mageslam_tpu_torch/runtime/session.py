"""`SlamSession`: the host state machine around the per-frame steps (port
of mageslam_tpu/runtime/pipeline.py `SlamSession`).

`SlamSession(...)` then `process_frame` from the first frame: every frame
is analyzed (`detect_and_compute`) and its descriptors pooled for the
vocabulary retrain; before the map exists the frame goes to mono init
(runtime/init_step.py: anchor, accumulate, attempt, third-frame check,
adoption), after it to `track_step` → `post_step`, and on a frame the
keyframe decision marks, `mapping` (runtime/mapping_step.py) and the
keyframe's bag-of-words add. The host reads the device twice per tracked
frame, as the reference's `_track` does: the tracking outcome (success and
tracked count together) and the keyframe flag; a keyframe adds the mapping
step's one read, whose keyframe and point counts also arm bank growth.
Init's reads are listed in runtime/init_step.py.

After the keyframe's bag-of-words add, loop detection runs on every mapped
keyframe when LoopClosureSettings.EnableLoopClosure is set, synchronously
(the reference's `_post_keyframe` with defer=False): it reads its gate once
(runtime/loop_closure.py) and, on a detection, the session closes the loop
(similarity correction, merge, essential graph), runs global BA
(runtime/global_ba.py) and refreshes the membership cache. Detection is
live only once the map holds MinKeyframe keyframes after mapping, which
detection's own read tells (`loop_det_stats` counts it); the mapping
step's keyframe count bounds that count from above, so below MinKeyframe
the session skips detection without a read. After
TrackingLostCountUntilReloc failed frames a frame relocalizes
(runtime/reloc_step.py) instead of tracking, with one read of its outcome.
`fossilize` runs the final global BA and returns the trajectory;
`snapshot_state` / `restore_state` rewind the session in memory.

With several devices the global BA splits its Schur system over the point
axis (parallel/sharded_ba.py; `enable_sharded_global_ba`, pipeline.py:
2264-2295). `enable_mapping_offload(device)` moves each keyframe's mapping
to a worker thread that issues it on a second CUDA stream of `device` (on
the CPU, the thread alone) while tracking goes on against the map as it
was; the result is adopted at the next keyframe, relocalization, safe
point or `fossilize`, as the reference's offload to a second device
(pipeline.py:2176-2235).

Mono init, the vocabulary and relocalization draw random numbers; the
session takes them from `draws` (runtime/draws.py), by default a generator
seeded by `seed`.

A session takes a pinhole `cam` (4,) or a full `camera` (16,) model
(geometry/camera.py: Poly3K, Rational6K). With a distorted camera and
MonoCamera.UndistortImagePixels, every frame is warped to the undistorted
pinhole before analysis (ops/undistort.py); otherwise the frontend
undistorts the keypoints only and matching keeps the original intrinsics.
Before init, frames are analyzed with SpatialFeatureSelection off, as the
reference does. `process_stereo_frames` / `process_stereo_features` run a
stereo rig: the first pair that passes `stereo_initialize`
(tracking/stereo_init.py) is adopted as the map with a persistent rig
tether between its two keyframes, and later pairs track the configured
primary camera (StereoSettings.PrimaryTrackingCamera) under its own
intrinsics, which its keyframes carry.

With FuserSettings.UseFuser the session owns a `Fuser` (fuser/fuser.py, its
filter on the session's device): `add_sensor_sample` queues inertial
samples, adoption starts its mode machine, and every tracked frame hands
it the visual pose (a failed frame: none). In its TRACKING mode the fuser's
pose prior replaces the motion model, and the frame's pose covariance
(fuser/covariance.py) weights the filter's update; the covariance, its
flag and the pose come back in the tracking outcome's one read, as the
pose alone does in SCALE_INIT. The fuser's own reads are listed in
fuser/fuser.py. After the run, `fossilize_map` returns the queryable
`FossilizedMap` (runtime/fossilized.py: trajectory, denoised cloud, volume
of interest); `get_tracking_results_for_frames` and
`try_get_volume_of_interest` answer the same on the live session.

The throughput and realtime entry points (`process_features_pipelined`,
`process_frame_pipelined`, `flush`, `process_frame_realtime`,
`process_frames_chunked`, `process_frame_stream`, `flush_chunks`) and the
deferred loop detection of the chunk path live in runtime/streaming.py
(`StreamEntryPoints`, a mixin of this class); they run the gated step of
runtime/frame_step.py. io/snapshot.py writes and reads the session on disk
in the reference's format.

Diagnostics (mageslam_tpu_torch/diagnostics): a session takes `metrics`
(MetricChannels), `introspection` (Introspection), `determinator`
(Determinator) and `xray` (XRay, or `attach_xray`). The Determinator hashes
the reference's named checkpoints (Init.*, TrackLocalMap.*, Post.*,
Mapping.*, Reloc.Result, LoopClosure.*, Stream.Chunk, Fossilize.Trajectory)
at the same points of a frame with the same trees; on the chunk path the
summary's last column then carries each frame's state digest
(ops/digest.py). The xray captures the global BA ("GlobalBA") and loop
detection ("LoopClosure.Detect"). With none attached the hooks read nothing
from the device and launch nothing.
"""

from __future__ import annotations

import dataclasses
import enum
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from .. import parallel
from ..bow.index import add_keyframe as bow_add_keyframe
from ..bow.index import empty_index, grow_index
from ..ba.problem import TETHER_TRANSFORM
from ..analysis.voi import VoiSettings
from ..config import CameraIdentity, golden_path_settings
from ..fuser.covariance import estimate_pose_covariance
from ..fuser.fuser import Fuser, FuserMode
from ..geometry.camera import make_pinhole
from ..geometry.se3 import Pose
from ..interop import load_jax_snapshot, resolve_device
from ..ops.frontend import FrameFeatures, detect_and_compute
from ..ops.undistort import (remap_bilinear, rescale_map, scale_for_camera_configuration,
                             undistorted_calibration)
from ..tracking.frame_state import TrackedFrame, TrackingHistory
from ..tracking.relocalization import RELOC_HYPOTHESES
from ..tracking.stereo_init import stereo_initialize, stereo_settings
from ..worldmap.map_state import empty_map, grow_map, refresh_membership
from ..worldmap.operations import add_keyframe_tether
from .draws import GeneratorDraws
from .fossilized import FossilizedMap, volume_of_interest
from .frame_step import prepare_image
from .global_ba import global_ba
from .init_step import BowTraining, InitWindow, adopt, try_initialize
from .loop_closure import close_loop
from .mapping_step import mapping, mapping_body
from .pose_history import PoseHistory
from .post_step import post_step
from .reloc_step import reloc_step
from .streaming import DEFERRED_STATS, StreamEntryPoints
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


class SlamSession(StreamEntryPoints):
    """Monocular or stereo session (MageSlam.h:25-187): mono init or the
    stereo bootstrap, tracking, relocalization, keyframe mapping, the
    bag-of-words index, loop closure and fossilize.

    Runs on the card (`device="cuda"`) unless the caller passes
    `device="cpu"`; where torch sees no card, the default raises. `draws`
    gives init's and the vocabulary's random draws (runtime/draws.py); by
    default a `GeneratorDraws` seeded by `seed`. `camera` (16,) replaces
    the pinhole `cam` with a full camera model."""

    def __init__(self, settings=None, cam=None, image_width: int = 320,
                 image_height: int = 180, device="cuda", seed: int = 0, draws=None,
                 camera=None, metrics=None, introspection=None, determinator=None,
                 xray=None):
        # optional diagnostics (pipeline.py:101-110); None keeps the frame
        # loop free of host reads, as the reference's release macros
        self.metrics = metrics
        self.introspection = introspection
        self.determinator = determinator
        self.xray = xray
        self.settings = settings or golden_path_settings()
        b = self.settings.Budgets
        self.fes = self.settings.MonoSettings.MonoCamera.FeatureExtractorSettings
        # before init, the reference selection (pipeline.py:264-273)
        self._fes_boot = (dataclasses.replace(self.fes, SpatialFeatureSelection=False)
                          if self.fes.SpatialFeatureSelection else self.fes)
        self.device = resolve_device(device)
        self.width = image_width
        self.height = image_height
        self._raw_cam16 = None      # the distorted camera where frames are warped
        self._stereo_prep = None    # (camera1 bytes, overlap ok, rescale map, cam1_16)
        self._frame_cam = None      # a call's (4,) intrinsics override
        # cam: the undistorted pinhole intrinsics (4,), the matching and BA
        # space; cam16: the frontend's camera model (pipeline.py:116-158)
        if camera is not None:
            camera = torch.as_tensor(np.asarray(camera, np.float32), device=self.device)
            if float(camera[14]) != 0.0 and \
                    self.settings.MonoSettings.MonoCamera.UndistortImagePixels:
                self._raw_cam16 = camera
                self.cam16 = undistorted_calibration(camera)
            else:
                self.cam16 = camera
            if cam is None:
                # the warped image's centered pinhole, or the keypoint-only
                # path's original intrinsics (it undistorts with P = K)
                cam = self.cam16[:4].cpu().numpy()
        elif cam is None:
            cam = [image_width * 0.82, image_width * 0.82,
                   image_width / 2.0, image_height / 2.0]
        self.cam = torch.as_tensor(np.asarray(cam, np.float32), device=self.device)
        if camera is None:
            fx, fy, cx, cy = (float(v) for v in self.cam.cpu())
            self.cam16 = make_pinhole(fx, fy, cx, cy, image_width, image_height,
                                      device=self.device)
        self.N = b.MaxFeatures
        self.map = empty_map(min(48, b.MaxKeyframes), min(2048, b.MaxMapPoints),
                             self.N, max_tethers=b.MaxTethers, device=self.device)
        self.bow = empty_index(self.map.capacity[0], num_words=64, device=self.device)
        self.draws = draws if draws is not None else GeneratorDraws(seed, self.device)
        self.init_window = InitWindow()
        self.bow_training = BowTraining()
        self.history = TrackingHistory.empty(b.TrackingHistoryLength, self.N,
                                             device=self.device)
        self.pose_history = PoseHistory.empty(
            4096, self.settings.PoseHistorySettings.InitalInterpolationConnections,
            device=self.device)
        self.initialized = False
        self.lost_count = 0
        self.frames_since_keyframe = 0
        self.frames_since_reloc = 10_000
        self.map_scale = 1.0
        self.last_kf_slot = -1
        self.n_loops_closed = 0
        # detections run (live), those whose cluster qualified (a
        # relocalization ran) and loops closed; the chunk path's deferred
        # detections add runtime/streaming.py's DEFERRED_STATS
        self.loop_det_stats = dict.fromkeys(("live", "qualified", "closed",
                                             *DEFERRED_STATS), 0)
        self._grow_pending = False
        # the mapping offload (enable_mapping_offload): None = mapping in the
        # frame; a pending pass is (future, frame, tracking counters then)
        self._mapping_device = None
        self._offload_stream = None
        self._offload_pool = None
        self._offload_pending = None
        # the sharded global BA: None = auto (shard where the session is on
        # CUDA and parallel.mesh_devices gives several devices), True/False
        # force; the step is cached on (flag, devices)
        self.enable_sharded_global_ba: bool | None = None
        self._sharded_ba_step = None
        self.results: list[FrameResult] = []
        # the visual-inertial path (pipeline.py:192-200), its filter chosen
        # by FilterType (SensorFilter.h:99-157: 3Dof / 6Dof / Simple6Dof)
        self.fuser = (Fuser(filter_type=self.settings.FuserSettings.FilterType,
                            device=self.device)
                      if self.settings.FuserSettings.UseFuser else None)
        self._init_streaming()

    @classmethod
    def from_jax_snapshot(cls, path: str, settings=None, cam=None,
                          image_width: int = 320, image_height: int = 180,
                          device="cuda", seed: int = 0, draws=None,
                          **diagnostics) -> "SlamSession":
        """A session holding the state that the JAX package's
        `save_session_snapshot` wrote (same settings and image size),
        bag-of-words index included. The file holds no vocabulary training
        pool: an initialized session counts as retrained (the reference
        retrains once, TrainingFrames frames into the session).
        `diagnostics`: the constructor's metrics, introspection,
        determinator and xray."""
        sess = cls(settings, cam, image_width, image_height, device, seed, draws,
                   **diagnostics)
        sess.map, sess.history, sess.pose_history, meta, bow = load_jax_snapshot(
            path, sess.device)
        if bow is not None:
            sess.bow = bow
        if (meta["width"], meta["height"]) != (image_width, image_height):
            raise ValueError(f"snapshot image size {meta['width']}x{meta['height']}"
                             f" != {image_width}x{image_height}")
        if sess.map.capacity[2] != sess.N:
            raise ValueError(f"snapshot has {sess.map.capacity[2]} feature slots, "
                             f"settings say {sess.N}")
        sess.initialized = bool(meta["initialized"])
        sess.bow_training = BowTraining(retrained=sess.initialized)
        sess.lost_count = int(meta["lost_count"])
        sess.frames_since_keyframe = int(meta["frames_since_keyframe"])
        sess.frames_since_reloc = int(meta["frames_since_reloc"])
        sess.map_scale = float(meta.get("map_scale", 1.0))
        sess.last_kf_slot = int(meta.get("last_kf_slot", -1))
        return sess

    # ------------------------------------------------------------------ #
    def add_sensor_sample(self, sample) -> None:
        """MAGESlam::AddSensorSample (MageSlam.cpp:250; pipeline.py:295-299):
        queue an inertial `fuser.SensorSample` for the fuser (no-op when
        UseFuser is off)."""
        if self.fuser is not None:
            self.fuser.add_sample(sample)

    def process_frame(self, image, timestamp: float, frame_id: int) -> FrameResult:
        """Analyze and track one grayscale frame (H, W), uint8 or float32
        [0, 255], numpy or tensor (pipeline.py:310-329)."""
        image = prepare_image(image, self.device, self._raw_cam16)
        feats = detect_and_compute(image, self.cam16,
                                   self.fes if self.initialized else self._fes_boot, self.N)
        return self.process_features(feats, timestamp, frame_id)

    def process_features(self, feats: FrameFeatures, timestamp: float,
                         frame_id: int, cam=None) -> FrameResult:
        """pipeline.py:584-601 `process_features`. `cam` (4,) overrides the
        frame's pinhole intrinsics for this call (a stereo rig's secondary
        camera); None: the session's."""
        self._frame_cam = (None if cam is None else
                           torch.as_tensor(cam, dtype=torch.float32, device=self.device))
        try:
            if self._grow_pending:
                self._service_bank_growth()
            self.bow_training.add(self, feats.desc, feats.valid)
            if not self.initialized:
                result = self._try_initialize(feats, timestamp, frame_id)
            elif self.lost_count >= \
                    self.settings.TrackLocalMapSettings.TrackingLostCountUntilReloc:
                result = self._relocalize(feats, timestamp, frame_id)
            else:
                result = self._track(feats, timestamp, frame_id)
        finally:
            self._frame_cam = None
        self.results.append(result)
        return result

    def process_stereo_frames(self, image0, image1, frame0_to_frame1: Pose,
                              timestamp: float, frame_id: int,
                              camera1=None) -> FrameResult:
        """Analyze both frames of a stereo pair and run the stereo path
        (pipeline.py:393-467). Where `camera1`, the secondary's (16,) model,
        differs from the primary, frame 1 is resized to the primary's
        angular resolution and its intrinsics scaled to match (the stereo
        rescale, computed once per `camera1`). Where the two cameras do not
        overlap, an initialized session tracks frame 0 alone, an
        uninitialized one waits. Both frames are analyzed with the
        session's feature settings and are not undistorted densely."""
        img0, img1 = prepare_image(image0, self.device), prepare_image(image1, self.device)
        rig = self._pose(frame0_to_frame1)
        cam1_16 = self.cam16
        if camera1 is not None:
            c1 = torch.as_tensor(np.asarray(camera1, np.float32), device=self.device)
            key = c1.cpu().numpy().tobytes()
            if self._stereo_prep is None or self._stereo_prep[0] != key:
                self._stereo_prep = (key, *self._stereo_rescale(c1, rig))
            _, ok, remap, cam1_16 = self._stereo_prep
            if not ok:
                if self.initialized:
                    return self.process_frame(image0, timestamp, frame_id)
                result = FrameResult(frame_id, TrackingState.INITIALIZING, None, 0, False)
                self.results.append(result)
                return result
            if remap is not None:
                img1 = remap_bilinear(img1, remap)
        f0 = detect_and_compute(img0, self.cam16, self.fes, self.N)
        f1 = detect_and_compute(img1, cam1_16, self.fes, self.N)
        return self.process_stereo_features(f0, f1, rig, timestamp, frame_id,
                                            cam1=cam1_16[:4])

    def _stereo_rescale(self, c1: torch.Tensor, rig: Pose):
        """(overlap ok, rescale map or None, the secondary's (16,) camera
        after the rescale) of a rig (pipeline.py:418-437)."""
        max_depth = self.settings.StereoSettings.StereoMapInitializationSettings.MaxDepthMeters
        scale, overlap_ok = scale_for_camera_configuration(c1, self.cam16, rig, max_depth)
        sc, ok = float(scale), bool(overlap_ok)
        if not (ok and abs(sc - 1.0) > 1e-3):
            return ok, None, c1
        c1 = c1.clone()
        c1[:4] = c1[:4] * sc
        c1[12], c1[13] = self.width, self.height
        return ok, rescale_map(sc, self.height, self.width, self.device), c1

    def process_stereo_features(self, feats0: FrameFeatures, feats1: FrameFeatures,
                                frame0_to_frame1: Pose, timestamp: float, frame_id: int,
                                cam1=None) -> FrameResult:
        """The stereo path on analyzed frames (pipeline.py:469-541). Before
        init: the stereo bootstrap, adopted through the mono adoption with
        frame 0 as the anchor, then the rig tether between the two
        keyframes (unit baseline) and keyframe 1's intrinsics set to `cam1`,
        the secondary's. After init: the configured primary is tracked, by
        default STEREO_2, frame 1 under `cam1`. The bootstrap frame feeds
        no vocabulary training."""
        rig = self._pose(frame0_to_frame1)
        if self.initialized:
            if self.settings.StereoSettings.PrimaryTrackingCamera == CameraIdentity.STEREO_2:
                return self.process_features(feats1, timestamp, frame_id, cam=cam1)
            return self.process_features(feats0, timestamp, frame_id)
        ss = stereo_settings(self.settings)
        cam2 = (None if cam1 is None else
                torch.as_tensor(cam1, dtype=torch.float32, device=self.device))
        res = stereo_initialize(feats0.und_xy, feats0.desc, feats0.valid, feats1.und_xy,
                                feats1.desc, feats1.valid, self.cam, rig, ss, cam2=cam2)
        if not bool(res.succeeded):
            result = FrameResult(frame_id, TrackingState.INITIALIZING, None, 0, False)
            self.results.append(result)
            return result
        win = self.init_window
        win.anchor, win.anchor_meta = feats0, (frame_id, timestamp)
        pose, tracked = adopt(self, res, feats1, timestamp, frame_id)
        # the rig's extrinsic tether, kept for every later BA window holding
        # both keyframes (Data/Tether.h:12-68)
        baseline = float(torch.linalg.norm(rig.t))
        self.map = add_keyframe_tether(
            self.map, 1, 0, TETHER_TRANSFORM, Pose(rig.R, rig.t / max(baseline, 1e-5)),
            weight=ss.initialization_tether_strength)
        if cam2 is not None:
            kf_cam = self.map.kf_cam.clone()
            kf_cam[1] = cam2
            self.map = self.map._replace(kf_cam=kf_cam)
        result = FrameResult(frame_id, TrackingState.TRACKING, pose, tracked, True)
        self.results.append(result)
        return result

    def _det_check(self, name: str, *trees) -> None:
        """DETERMINISTIC_CHECK site (arcana/analysis/determinator.h:16-61;
        pipeline.py:604-613): hashes `trees` into the attached Determinator.
        Without one, nothing is read from the device."""
        if self.determinator is not None:
            self.determinator.check(name, *trees)

    def attach_xray(self, xray) -> None:
        """Attach a diagnostics.XRay stage I/O recorder (pipeline.py:615-619);
        the wired sites capture from the next call on."""
        self.xray = xray

    def _xray_capture(self, stage: str, inputs, outputs) -> None:
        """XRAY_BEGINTRACE/UPDATETRACE site (arcana/analysis/xray.h:28-43;
        pipeline.py:621-627). Without an XRay, nothing is read."""
        if self.xray is not None and self.xray.wants(stage):
            self.xray.capture(stage, inputs, outputs)

    def _pose(self, pose: Pose) -> Pose:
        return Pose(torch.as_tensor(pose.R, dtype=torch.float32, device=self.device),
                    torch.as_tensor(pose.t, dtype=torch.float32, device=self.device))

    def _try_initialize(self, feats: FrameFeatures, timestamp, frame_id) -> FrameResult:
        adopted = try_initialize(self, feats, timestamp, frame_id)
        if adopted is None:
            return FrameResult(frame_id, TrackingState.INITIALIZING, None, 0, False)
        pose, tracked = adopted
        return FrameResult(frame_id, TrackingState.TRACKING, pose, tracked, True)

    def _scalar(self, value, dtype) -> torch.Tensor:
        return torch.tensor(value, dtype=dtype, device=self.device)

    def _frame(self, feats: FrameFeatures, timestamp, frame_id) -> TrackedFrame:
        return TrackedFrame(
            pose=Pose.identity(device=self.device),
            cam=self.cam if self._frame_cam is None else self._frame_cam,
            kp_xy=feats.und_xy, kp_octave=feats.octave, desc=feats.desc,
            kp_valid=feats.valid,
            assoc=torch.full((self.N,), -1, dtype=torch.int32, device=self.device),
            timestamp=self._scalar(np.float32(timestamp), torch.float32),
            frame_id=self._scalar(frame_id, torch.int32),
        )

    def _imu_prior(self) -> Pose | None:
        """The fuser's pose prior (pipeline.py:1071-1077): a device pose in
        the fuser's TRACKING mode, else None (the motion model's turn)."""
        return None if self.fuser is None else self.fuser.pose_prior()

    def _outcome(self, res, fuser_mode) -> tuple[bool, int, Pose | None, np.ndarray | None]:
        """The tracking outcome in one host read: (succeeded, tracked count,
        the pose as host arrays, the covariance or None). The pose is read
        where the fuser's SCALE_INIT or TRACKING update takes it, the
        covariance and its flag in TRACKING (pipeline.py:1800-1820, the
        reference's (50,) fetch); the covariance is None where its gate
        failed."""
        if fuser_mode not in (FuserMode.SCALE_INIT, FuserMode.TRACKING):
            succeeded, tracked = torch.stack(
                [res.succeeded.to(torch.int32), res.tracked_count]).tolist()
            return bool(succeeded), tracked, None, None
        frame = res.frame
        parts = [res.succeeded.to(torch.float32)[None], res.tracked_count.to(torch.float32)[None],
                 frame.pose.R.reshape(-1), frame.pose.t]
        if fuser_mode == FuserMode.TRACKING:
            cov, ok = estimate_pose_covariance(frame.pose, frame.cam, frame.kp_xy,
                                               frame.kp_valid, frame.assoc, self.map.mp_pos,
                                               self.map.mp_valid)
            parts += [cov.reshape(-1), ok.to(torch.float32)[None]]
        out = torch.cat(parts).cpu().numpy()
        pose = Pose(out[2:11].reshape(3, 3), out[11:14])
        cov = out[14:50].reshape(6, 6) if len(out) > 14 and out[50] > 0 else None
        return bool(out[0] > 0), int(out[1]), pose, cov

    def _track(self, feats: FrameFeatures, timestamp, frame_id) -> FrameResult:
        """mageslam_tpu/runtime/pipeline.py:1705-1779 `_track`."""
        prior = self._imu_prior()
        res = track_step(self.settings, self.width, self.height, self.map,
                         self.history, self._frame(feats, timestamp, frame_id),
                         prior_override=prior, prior_valid=prior is not None)
        succeeded, tracked, pose, cov = self._outcome(
            res, None if self.fuser is None else self.fuser.mode)
        if not succeeded:
            if self.fuser is not None:
                self.fuser.process_frame(None, timestamp)
            return self._tracking_failed(frame_id)
        if self.fuser is not None:
            self.fuser.process_frame(res.frame.pose if pose is None else pose, timestamp,
                                     pose_covariance=cov)
        frame = res.frame
        self.lost_count = 0
        self.frames_since_keyframe += 1
        self.frames_since_reloc += 1
        # the diagnostics sites of pipeline.py:1741-1776
        if self.metrics is not None:
            self.metrics.fire("TrackLocalMap.NumMatchedKeypoints", frame_id, tracked)
        self._det_check("TrackLocalMap.Pose", frame.pose)
        self._det_check("TrackLocalMap.Associations", frame.assoc, res.tracked_count)
        self._det_check("TrackLocalMap.Scoring", res.found_delta, res.predicted_delta)
        if self.introspection is not None:
            self.introspection.log_pose(3, frame_id, frame.pose)
        self.map, self.history, self.pose_history, is_kf_dev = post_step(
            self.settings, self.width, self.height, self.map, self.history,
            self.pose_history, frame, res.found_delta, res.predicted_delta,
            self._scalar(self.frames_since_keyframe, torch.int32),
            self._scalar(min(self.frames_since_reloc, 10_000), torch.int32))
        is_kf = bool(is_kf_dev)
        self._det_check("Post.History", self.history.poses, self.history.valid)
        self._det_check("Post.KeyframeDecision", is_kf_dev)
        if is_kf:
            self._insert_keyframe_and_map(frame)
            self._det_check("Mapping.Map", self.map.kf_valid, self.map.mp_valid,
                            self.map.kf_assoc)
            self._det_check("Mapping.Poses", self.map.kf_pose, self.map.mp_pos)
            self._det_check("Mapping.PoseHistory", self.pose_history.conn_kf,
                            self.pose_history.conn_ok)
            if self.metrics is not None:
                self.metrics.fire("Mappoints.Total", frame_id,
                                  int(torch.sum(self.map.mp_valid)))
            if self.introspection is not None:
                self.introspection.log_map_stats(
                    frame_id, int(torch.sum(self.map.kf_valid)),
                    int(torch.sum(self.map.mp_valid)))
        return FrameResult(frame_id, TrackingState.TRACKING, frame.pose, tracked,
                           is_kf)

    def _relocalize(self, feats: FrameFeatures, timestamp, frame_id) -> FrameResult:
        """mageslam_tpu/runtime/pipeline.py:1887-1906 `_relocalize`: one
        read of the outcome; a relocalized frame is never a keyframe."""
        self._adopt_offloaded_mapping()
        C = self.settings.MappingSettings.MaxRelocQueryResults
        draws = self.draws.gumbel("reloc", (C, RELOC_HYPOTHESES, self.N))
        res = reloc_step(self.settings, self.width, self.height, self.map, self.bow,
                         self._frame(feats, timestamp, frame_id), draws)
        self._det_check("Reloc.Result", res.succeeded, res.frame.pose)
        succeeded, tracked = torch.stack(
            [res.succeeded.to(torch.int32), res.tracked_count]).tolist()
        if not succeeded:
            return FrameResult(frame_id, TrackingState.RELOCALIZING, None, 0, False)
        frame = res.frame
        self.lost_count = 0
        self.frames_since_reloc = 0
        self.frames_since_keyframe += 1
        self.map, self.history, self.pose_history, _ = post_step(
            self.settings, self.width, self.height, self.map, self.history,
            self.pose_history, frame, res.found_delta, res.predicted_delta,
            self._scalar(self.frames_since_keyframe, torch.int32),
            self._scalar(0, torch.int32))
        return FrameResult(frame_id, TrackingState.TRACKING, frame.pose, tracked, False)

    def _insert_keyframe_and_map(self, frame: TrackedFrame) -> None:
        """mageslam_tpu/runtime/pipeline.py:2237-2261, then `_post_keyframe`:
        the bag-of-words add and loop detection. With the offload on, the
        pass is handed to the worker instead."""
        if self._mapping_device is not None:
            self._offload_mapping(frame)
            return
        self.map, self.pose_history, ki, (n_kf, n_mp) = mapping(
            self.settings, self.width, self.height, self.map, self.pose_history,
            frame, self.map_scale)
        if ki < 0:
            return
        self.frames_since_keyframe = 0
        self.last_kf_slot = ki
        self._kf_bound = n_kf
        self._post_keyframe(frame, ki, n_kf)
        # the counts are the mapping step's own read, taken before local BA
        # and the culls: where those remove something, growth is armed a
        # little earlier than the reference's post-mapping counts would
        self._maybe_grow_banks(n_kf, n_mp)

    # ------------------------------------------------------------------ #
    # the mapping offload (pipeline.py:2176-2235)

    def enable_mapping_offload(self, device) -> None:
        """Map each keyframe on `device` while tracking goes on: a worker
        thread (the reference's MappingWorker thread) issues the mapping
        schedule on a second CUDA stream of `device`, or on the CPU runs it
        beside the main thread. The pass works on a copy of the map;
        tracking uses the map as it was until the result is adopted at the
        next keyframe, relocalization, safe point or `fossilize`, and the
        tracking counters earned meanwhile are merged into it."""
        self._adopt_offloaded_mapping()
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self._mapping_device = device
        self._offload_stream = (torch.cuda.Stream(device) if device.type == "cuda"
                                else None)
        if self._offload_pool is None:
            # the worker's own OpenMP threads: as many as the main thread's
            self._offload_pool = ThreadPoolExecutor(
                1, "mapping", initializer=torch.set_num_threads,
                initargs=(torch.get_num_threads(),))

    def _offload_mapping(self, frame: TrackedFrame) -> None:
        """pipeline.py:2191-2199: adopt the pass before (one pass at a time),
        copy the map and the frame on the main stream, and hand them to
        the worker, whose stream waits for the copy."""
        self._adopt_offloaded_mapping()
        dev = self._mapping_device
        counters = (self.map.mp_found, self.map.mp_predicted)
        m, f = parallel.tree_map(lambda x: x.to(dev, copy=True), (self.map, frame))
        copied = None
        if self._offload_stream is not None:
            copied = torch.cuda.Event()
            copied.record(torch.cuda.current_stream(dev))
        job = self._offload_pool.submit(self._offload_worker, m, f, self.map_scale, copied)
        self._offload_pending = (job, frame, counters)

    def _offload_worker(self, m, f, map_scale: float, copied):
        """The worker thread: the mapping schedule without the pose-history
        rebase (`mapping_body`); its one host read blocks this thread
        only. Returns (its outputs, the event after its last launch)."""
        stream = self._offload_stream
        if stream is None:
            return mapping_body(self.settings, self.width, self.height, m, f, map_scale), None
        with torch.cuda.device(stream.device), torch.cuda.stream(stream):
            stream.wait_event(copied)
            # the copies were made on the main stream: not reused before
            # this stream is done with them
            parallel.tree_map(lambda x: x.record_stream(stream), (m, f))
            out = mapping_body(self.settings, self.width, self.height, m, f, map_scale)
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    def _adopt_offloaded_mapping(self) -> None:
        """pipeline.py:2201-2235: the pass's map on the session's device,
        the tracking counters earned since the copy merged where the point
        is valid, the pose history rebased, then the keyframe's
        bag-of-words add and loop detection. Like the reference it reads no
        counts and arms no bank growth."""
        if self._offload_pending is None:
            return
        job, frame, (found0, predicted0) = self._offload_pending
        self._offload_pending = None
        (m2, ki, culled, old_poses, live), done = job.result()
        out = (m2, culled, old_poses)
        if done is not None:
            for dev in {self._mapping_device, self.device} - {torch.device("cpu")}:
                torch.cuda.current_stream(dev).wait_event(done)
            main = torch.cuda.current_stream(self._mapping_device)
            parallel.tree_map(lambda x: x.record_stream(main), out)
        m2, culled, old_poses = parallel.tree_map(lambda x: x.to(self.device), out)
        m = self.map
        m2 = m2._replace(
            mp_found=torch.where(m2.mp_valid, m2.mp_found + (m.mp_found - found0),
                                 m2.mp_found),
            mp_predicted=torch.where(m2.mp_valid,
                                     m2.mp_predicted + (m.mp_predicted - predicted0),
                                     m2.mp_predicted))
        if ki >= 0:
            self.pose_history = self.pose_history.rebase(
                old_poses, culled, self._scalar(ki, torch.int64), m2.kf_pose)
        self.map = m2
        if ki >= 0:
            self.frames_since_keyframe = 0
            self.last_kf_slot = ki
            self._kf_bound = live[0]
            self._post_keyframe(frame, ki, live[0])

    def _drop_offloaded_mapping(self) -> None:
        """Forget a pending pass (`restore_state`), once its worker is done."""
        if self._offload_pending is not None:
            self._offload_pending[0].result()
            self._offload_pending = None

    def _global_ba_step_fn(self):
        """pipeline.py:2264-2295: the dense step, or the point-sharded one
        over `parallel.mesh_devices(self.device)`, their count cut until it
        divides Budgets.MaxMapPoints; cached on (flag, devices)."""
        devs = parallel.mesh_devices(self.device)
        key = (self.enable_sharded_global_ba, len(devs))
        if self._sharded_ba_step is not None and self._sharded_ba_step[0] == key:
            return self._sharded_ba_step[1]
        use = self.enable_sharded_global_ba
        if use is None:
            use = self.device.type == "cuda" and len(devs) > 1
        n = len(devs)
        while n > 1 and self.settings.Budgets.MaxMapPoints % n:
            n -= 1
        step = (parallel.make_sharded_step_bundle_adjust(
            parallel.make_session_mesh(devs[:n], "model")) if use and n > 1 else None)
        self._sharded_ba_step = (key, step)
        return step

    def _post_keyframe(self, frame: TrackedFrame, ki: int, n_kf_bound: int | None,
                       defer: bool = False) -> bool:
        """pipeline.py:2379-2426 and 2448-2473: the keyframe's bag-of-words
        add, then loop detection. `n_kf_bound` bounds the map's keyframe
        count from above (None: unknown). defer=False reads the detection
        and, on a hit, closes the loop now; defer=True queues it for the
        chunk path's resolution (runtime/streaming.py). Returns whether a
        loop closed."""
        lc = self.settings.LoopClosureSettings
        # the slot guard: the keyframe still occupies the slot mapping gave it
        slot_ok = self.map.kf_frame_id[ki] == frame.frame_id
        bow = bow_add_keyframe(self.bow, torch.where(slot_ok, ki, -1), frame.desc,
                               frame.kp_valid)
        self.bow = bow._replace(kf_has=bow.kf_has & self.map.kf_valid)
        if not lc.EnableLoopClosure:
            return False
        # below MinKeyframe keyframes nothing can be detected: the detection
        # is a constant, made only where it is queued or diagnosed
        below = n_kf_bound is not None and n_kf_bound < lc.MinKeyframe
        if below and not defer and self.determinator is None and self.xray is None:
            return False
        det, qualified = (self._no_detection(), False) if below else \
            self._detect(frame, ki, slot_ok)
        if self.xray is not None and self.xray.wants("LoopClosure.Detect"):
            # the reference's descriptor words are uint32
            self.xray.capture("LoopClosure.Detect", {
                "frame": frame._replace(desc=frame.desc.cpu().numpy().view(np.uint32)),
                "ki": ki, "frame_id": int(frame.frame_id)}, det)
        if defer:
            self._pending_loop_dets.append((det, frame, ki, int(frame.frame_id)))
            self.loop_det_stats["deferred"] += 1
            return False
        self._det_check("LoopClosure.Detect", det.detected, det.scale, det.cluster_mask)
        if not qualified or not bool(det.detected):
            return False
        self._apply_loop_closure(det, frame, ki)
        self.loop_det_stats["closed"] += 1
        return True

    def _apply_loop_closure(self, det, frame: TrackedFrame, ki: int) -> bool:
        """pipeline.py:2475-2504: similarity correction, merge and essential
        graph, then global BA with the loop-closure settings and the
        membership refresh (global BA unassociates outliers)."""
        lc = self.settings.LoopClosureSettings
        bas = lc.BundleAdjustSettings
        self.map = close_loop(self.map, det, frame, ki,
                              covis_theta=self.settings.CovisibilitySettings.CovisMinThreshold,
                              essential_graph_iters=lc.EssentialGraphIterations)
        self.map, _ = global_ba(self.settings, self.map, self.last_kf_slot,
                                steps=max(bas.NumSteps, 5), huber=bas.HuberWidth,
                                max_outlier_error=bas.MaxOutlierError, bas=bas,
                                capture=self._global_ba_capture(),
                                step_fn=self._global_ba_step_fn())
        self.map = refresh_membership(self.map)
        self._det_check("LoopClosure.Close", self.map.kf_pose, self.map.mp_pos)
        self.n_loops_closed += 1
        return True

    def estimate_pose_covariance(self, frame: TrackedFrame) -> tuple[np.ndarray, bool]:
        """A tracked frame's 6×6 pose covariance from reprojection Jacobians
        against the current map (Fuser::EstimatePoseCovariance, Fuser.h:51-75;
        pipeline.py:1781-1798). Returns (covariance (6, 6) in [rho, phi]
        twist order, ok) as numpy, in one host read."""
        cov, ok = estimate_pose_covariance(frame.pose, frame.cam, frame.kp_xy, frame.kp_valid,
                                           frame.assoc, self.map.mp_pos, self.map.mp_valid)
        out = torch.cat([cov.reshape(-1), ok.to(torch.float32)[None]]).cpu().numpy()
        return out[:36].reshape(6, 6), bool(out[36] > 0)

    def get_tracking_results_for_frames(self, frame_ids) -> list[np.ndarray | None]:
        """Live-session trajectory query (MAGESlam::GetTrackingResultsForFrames,
        MageSlam.h:161; pipeline.py:2572-2583): per requested frame id, the
        current world→camera 4×4 view matrix re-derived from the pose
        history against today's keyframe poses, or None if the frame was
        never tracked or its connections died."""
        return FossilizedMap(self.map, self.pose_history, self.fes).get_tracking_results(
            frame_ids)

    def try_get_volume_of_interest(self, settings: VoiSettings | None = None):
        """Live-session VOI query (MAGESlam::TryGetVolumeOfInterest,
        MageSlam.h:178; pipeline.py:2585-2605): (min corner, max corner) of
        interesting space from the pose history's view frusta, or None while
        uninitialized, with fewer than two poses or when nothing passes."""
        if not self.initialized:
            return None
        poses, valid = self.pose_history.derive_poses(self.map.kf_pose)
        h = self.pose_history
        return volume_of_interest(poses, valid & (h.far > 0), h.near, h.far,
                                  settings or VoiSettings(), min_poses=2)

    def fossilize_map(self, global_ba_steps: int | None = None) -> FossilizedMap:
        """Fossilize and return the queryable FossilizedMap
        (MAGESlam::Fossilize -> FossilizedMap, MageSlam.h:109-128;
        pipeline.py:2631-2637)."""
        self.fossilize(global_ba_steps)
        return FossilizedMap(self.map, self.pose_history, self.fes)

    def fossilize(self, global_ba_steps: int | None = None):
        """MAGESlam::Fossilize (MageSlam.cpp:322-383; pipeline.py:2607-2628):
        the final global BA (GraphOptimizationSettings.NumSteps steps unless
        `global_ba_steps` says otherwise; none before the map exists), then
        every stored pose re-derived from the keyframes. Returns (frame ids
        (M,), world→camera matrices (M, 4, 4)) as numpy, sorted by frame id."""
        steps = global_ba_steps if global_ba_steps is not None else \
            self.settings.GraphOptimizationSettings.NumSteps
        self._adopt_offloaded_mapping()
        if self.initialized and steps > 0:
            self.map, _ = global_ba(self.settings, self.map, self.last_kf_slot, steps,
                                    capture=self._global_ba_capture(),
                                    step_fn=self._global_ba_step_fn())
        ids, mats = FossilizedMap(self.map, self.pose_history, self.fes).trajectory()
        self._det_check("Fossilize.Trajectory", ids, mats)
        return ids, mats

    def _global_ba_capture(self):
        """The "GlobalBA" xray site (pipeline.py:2351-2356) as `global_ba`'s
        capture callback, or None."""
        if self.xray is None or not self.xray.wants("GlobalBA"):
            return None
        return lambda inputs, outputs: self.xray.capture("GlobalBA", inputs, outputs)

    # the state the frame loop changes; settings, calibration and the
    # session's draw source itself are not part of a snapshot
    _SNAP_ATTRS = ("map", "history", "pose_history", "bow", "initialized", "lost_count",
                   "frames_since_keyframe", "frames_since_reloc", "map_scale",
                   "last_kf_slot", "n_loops_closed", "_grow_pending")

    def snapshot_state(self) -> dict:
        """An in-memory snapshot of the live session (pipeline.py:1485-1513):
        the map, histories, index, counters, the vocabulary's training pool
        and retrained flag, the init window and the draw source's position.
        As in the reference, the fuser's state (the visual-inertial path)
        is not part of it.
        Every state update makes new tensors, so the snapshot holds
        references, not copies. `restore_state` rewinds to it. The queues of
        the throughput entry points are drained first, and a pending
        offloaded mapping pass is adopted."""
        self._drain()
        self._adopt_offloaded_mapping()
        snap = {a: getattr(self, a) for a in self._SNAP_ATTRS}
        snap["loop_det_stats"] = dict(self.loop_det_stats)
        bt, win = self.bow_training, self.init_window
        snap["bow_training"] = (list(bt.pool), bt.frames, bt.retrained)
        snap["init_window"] = (win.anchor, win.anchor_meta, win.counters, win.n_frames,
                               list(win.middles), win.attempts)
        snap["draws"] = self.draws.position()
        snap["n_results"] = len(self.results)
        return snap

    def restore_state(self, snap: dict) -> None:
        """Rewind to a `snapshot_state` point of this session; the results
        recorded since are dropped, and the queues cleared. Frames run again
        give the same results."""
        self._clear_queues()
        self._drop_offloaded_mapping()
        for a in self._SNAP_ATTRS:
            setattr(self, a, snap[a])
        self.loop_det_stats = dict(snap["loop_det_stats"])
        pool, frames, retrained = snap["bow_training"]
        self.bow_training.pool, self.bow_training.frames = list(pool), frames
        self.bow_training.retrained = retrained
        win = self.init_window
        (win.anchor, win.anchor_meta, win.counters, win.n_frames, middles,
         win.attempts) = snap["init_window"]
        win.middles = list(middles)
        self.draws.rewind(snap["draws"])
        del self.results[snap["n_results"]:]

    def _maybe_grow_banks(self, n_kf: int, n_mp: int) -> None:
        """Arm bank growth when the live counts approach the current bucket
        (pipeline.py:1442-1454). Overflow before the growth is served drops
        new points and keyframes as at full capacity."""
        b = self.settings.Budgets
        K, P, _ = self.map.capacity
        if K >= b.MaxKeyframes and P >= b.MaxMapPoints:
            return
        if n_kf > int(0.75 * K) or n_mp > int(0.85 * P):
            self._grow_pending = True

    def _service_bank_growth(self) -> list[FrameResult]:
        """Serve an armed growth at a safe point (pipeline.py:1456-1480):
        drain the queues, then grow the map banks and the index's keyframe
        rows. Returns the chunk results the drain resolved."""
        drained = self._drain()
        self._adopt_offloaded_mapping()
        b = self.settings.Budgets
        self.map = grow_map(self.map, b.MaxKeyframes, b.MaxMapPoints)
        self.bow = grow_index(self.bow, b.MaxKeyframes)
        self._dev_counters = None
        self._grow_pending = False
        return drained

    def _tracking_failed(self, frame_id) -> FrameResult:
        """mageslam_tpu/runtime/pipeline.py:1822-1833 `_tracking_failed`."""
        self.lost_count += 1
        lost_limit = self.settings.TrackLocalMapSettings.TrackingLostCountUntilReloc
        if self.lost_count >= lost_limit:
            if self.lost_count == lost_limit:
                self.history = self.history.clear()
            return FrameResult(frame_id, TrackingState.RELOCALIZING, None, 0, False)
        return FrameResult(frame_id, TrackingState.SKIPPED, None, 0, False)
