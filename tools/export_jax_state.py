"""Export a JAX session's tracking state and its reference outputs for the
PyTorch port (`mageslam_tpu_torch`).

Runs the JAX `SlamSession` through `process_frame` over bench.py's world
(`build_world(RandomState(7))`, 640x480, cam [520, 520, 320, 240], golden
settings) on the local CPU. After frame `SNAP_FRAME` it saves the session with
`mageslam_tpu.io.snapshot.save_session_snapshot`; over frames
`SNAP_FRAME+1 .. LAST_FRAME` it records what the JAX session computes per
frame (pose R/t, tracked count, keyframe flag, tracking state, and the frame's
keypoint -> map point associations). Both go into one `.npz`: the snapshot's
own keys plus `ref_*` keys.

The window is chosen so that no keyframe fires inside it except at its last
frame: mapping runs after a frame's pose and keyframe decision are made, so a
tracking-only session reproduces every output of the window.

A second file holds the reference for keyframe mapping: the same session run
on from frame `SNAP_FRAME+1` until `MAP_EVENTS` keyframes have been mapped
and `MAP_TAIL` more frames tracked. It records the per-frame outputs (`ref_*`)
and, for mapping event j, the map and pose history after it
(`ev{j}_post_map{i}`, `ev{j}_post_ph{i}`, leaves in flatten order), the
keyframe's slot and frame id; for the first event also the inputs of the
mapping step (`ev0_pre_map{i}`, `ev0_pre_ph{i}`, `ev0_frame{i}`,
`ev0_map_scale`). The JAX session runs at golden settings, loop closure
as golden has it. The export fails if the map banks grow inside the window.

A third file, from the same run as the second, holds the JAX session's
bag-of-words index after each of those mapping events (`ev{j}_post_bow{i}`).

A fourth file holds the reference for mono init and the bag-of-words
vocabulary: the same session over frames 0..SNAP_FRAME from a bare
`SlamSession` (`init_*` keys): per frame its state, pose R/t, tracked count
and keyframe flag; the anchor and adoption frames; each init attempt's
inputs and `InitResult`; each third-frame check's inputs and verdict; the
index (anchors, idf, keyframe vectors) after adoption and after the
vocabulary retrain. Every key the session split for `try_initialize_pair`,
`validate_third_frame` (its `pnp_ransac`), `train_vocabulary` and the
retrain is stored with the Gumbel draws made from it (float32), in the
order the session used them: the port takes the draws as inputs, since
torch cannot reproduce `jax.random`.

Three more files hold the references of relocalization, loop closure and
the photoreal run (`RelocRecorder` records, for every relocalization a
session runs, the key and the (C, H, M) Gumbel draws of its candidates'
PnP hypotheses under `reloc{j}_*`, and per mapped keyframe whether loop
detection was live and whether a cluster qualified; the reference splits
a key whenever detection is live but draws only when a cluster
qualifies, and only those draws are recorded):

- `photoreal`: tests/test_photoreal_ate.py's 80 rendered frames (uint8,
  `frames`), the JAX session's per-frame outputs over them (`ref_*`), its
  init, vocabulary and relocalization draws, each frame's associations
  (`ref_assoc`, the newest tracking-history row), the ground truth, the
  trajectory of `fossilize(global_ba_steps=None)` (`fossil_*`) and then of
  `fossilize(global_ba_steps=3)` (`fossil3_*`), the map's masks after each
  mapping event (`ev{j}_kf_valid` etc., the event's frame in
  `ev_frame_id`), the map before fossilize (`final_map{i}`) and the JAX
  run's ATE (~100 s);
- `reloc`: tests/test_bow_reloc.py's lost-and-relocalize session
  (`rng` = RandomState(0)): every frame's features (`feat{i}_*`), the
  session's per-frame outputs, its draws, its snapshot after frame
  RELOC_SNAP_FRAME (the snapshot file's own keys), and for the first successful
  relocalization its inputs (`relocin_map*`, `relocin_bow*`,
  `relocin_frame*`, `relocin_draws`), the query's scores and candidates
  and `relocalize`'s result (`relocin_out_*`) (~90 s);
- `loop`: tests/test_loop_closure.py's `build_drifted_map` scenes
  (`a`: drift only, `b`: drift and scale 1.3 with 30 keypoints visible):
  map, index and keyframe Ki (`{s}_map*`, `{s}_bow*`, `{s}_frame*`),
  `detect_loop`'s result with its draws, `close_loop` without and with
  the essential graph, the session's global BA and membership refresh
  after it; and the 12-keyframe circuit of
  `test_essential_graph_distributes_drift` with `essential_graph_refine`'s
  inputs and output (`eg_*`) (~60 s).

Two more hold the references of the stereo rig and the camera models
(`SessionRecorder`: a session's draws, results and the map's masks after
each mapping event, under a prefix):

- `stereo`: tests/test_stereo.py's scenes. `pair_*`: the synthetic pair
  (300 points, 512 slots, baseline 0.12) and `stereo_initialize`'s result,
  also with no displacement (`pair_zero_*`). `rig_*`: the rig-tether
  session, the bootstrap pair then 39 frames of synthetic features (every
  frame's features stored), with its tether bank and keyframe poses at the
  end. `mix_*`: the mixed-FOV rig through `process_stereo_frames`, 24
  pairs at 320x180 rendered by `mixed_rig_render` (numpy), stored as each
  frame's SHA-256, with the rescaled secondary camera; the session's
  snapshot right after its stereo bootstrap is the file's own keys
  (~60 s);
- `cameras`: tests/test_undistort.py's Poly3K photoreal scene (the frames
  distorted and rounded to uint8, `dist_frames`) run with
  UndistortImagePixels on (`und_*`) and, in a second file, off (`kp_*`);
  the oriented frontend at 3 levels on two photoreal frames (`orb{j}_*`);
  the first frame's features of a session with SpatialFeatureSelection=True
  (`sfs_feat0_*`, extracted with it off before init); and in a third file a
  photoreal session with UseOrientation=True over its first 30 frames
  (`orient_*`) (~300 s). These sessions' init-attempt draws are stored as
  0 where the attempt's mutual match fails (no sample can pick them).

One more holds the reference of the visual-inertial path:

- `vi`: apps/vi_eval.py's default run (SIMPLE6DOF, 120 Hz IMU from
  `synthesize_imu`, the "sweep" trajectory) on the photoreal fixture's
  frames (checked first to equal `render_sequence(80, 320, 180)`'s), with
  the photoreal run's init and vocabulary draws (checked equal; only the
  relocalizations' draws are stored). Per frame: the session's results
  (`ref_*`), the fuser's mode, metric scale and EKF state after the frame
  (`mode`, `metric_scale`, `ekf_*`), the pose prior given before it
  (`prior_*`), the covariance and its flag where the fuser tracked
  (`cov`, `cov_ok`), the arguments the session gave `Fuser.process_frame`
  (`call_*`); the map's masks after each mapping event, the adoption
  frame, the IMU stream's SHA-256, the live `get_tracking_results_for_frames`
  / `try_get_volume_of_interest` answers at the end (`live_*`),
  `fossilize(None)`'s trajectory and ATE, and `fossilize_map`'s denoised
  and raw clouds and volume of interest (`fm_*`). Then the 3DoF and 6DoF
  filters replayed on the recorded samples and visual poses
  (`rp_{FUSER3DOF,FUSER6DOF}_*`), and the photoreal session's end state
  (its pose history `pr_ph*` beside the photoreal fixture's `final_map*`,
  its live and fossilized answers `pr_*`) (~300 s).

One more holds the reference of the session's throughput entry points:

- `stream`: a JAX session at bench.py's settings (golden, MinKeyframe 3)
  over frames 0-30 per frame (as `run_to_snapshot`), its snapshot as the
  file's own keys, and which of its leaves differ from
  `torch_port_bench640_f30.npz`'s (`f30_differs`). From that state, in the
  same session, rewound with `snapshot_state` / `restore_state` between
  them: `process_frame_stream` over 31-95 (`s95_*`) and over 31-71
  (`s71_*`), chunk 8 at `_chunk_pipeline_depth` 4, and
  `process_frame_pipelined` over 31-58 (`p58_*`). Each call's per-frame
  results (`ref_*`), the map's masks right after each mapping step
  (`ev{j}_*`), its `loop_det_stats` (`det_stats`, in `DET_STATS` order),
  the index at the end (`bow{i}`) and each detection's relocalization
  draws (`reloc{j}_draws`, re-detections included). And
  tests/test_stream_loop_closure.py's deferred-resolution scene
  (`dr_*`): the drifted map, keyframes 4 and 5 with their detections'
  draws, the re-detection's gate and what the JAX session counted (~6 min).

One more holds the references of the diagnostics and the bag-of-words
scale evaluation:

- `diag`: a JAX session at bench.py's settings (as `stream`) with a
  `Determinator` attached from its construction, over frames 0-30 per
  frame; its state is checked to equal `torch_port_stream.npz`'s snapshot.
  From that state, `process_frame_stream` over 31-95 (chunk 8, depth 4):
  its checkpoint stream (`st_names`, `st_hashes`), the stream's 20-column
  chunk summaries (`st_summary`), the hash of the
  `Mapping.Map` tree after each of the stream's mapping steps
  (`st_map_hash`, `st_map_frame`), and the digest's inputs and value at
  `DIGEST_FRAMES` (`dg{j}_*`, one of them a keyframe). Then the photoreal
  session of `photoreal` with a Determinator over frames 0-`PH_LAST` (init,
  adoption at 5, keyframes 6 and 7): its checkpoint stream (`ph_names`,
  `ph_hashes`). Then the xray
  captures of one loop closure on tests/test_loop_closure.py's scene `a`
  (`torch_port_loop.npz`'s `a_*`) in a session with MinKeyframe 5 and
  MinClusterSize 2: `LoopClosure.Detect` and `GlobalBA` (`xr_*_json`),
  with the detection's relocalization draws (`xr_draws`). Then
  apps/bow_eval.py's evaluation at a small cut (`BOW_CUT`; descriptors,
  queries, draws, metrics and each query's top-4 list under `bc_*`) and at
  full size (the metrics, the top-4 lists and the draws under `bf_*`)
  (~12 min).

One more holds the JAX references of tests/test_torch_ba.py:

- `ba`: the small scene of tests/test_torch_worldmap.py with keyframe 4
  and every point knocked off the truth (`win_map*`) and its local BA
  window (`win_*`), a synthetic problem with all three tether kinds
  (`teth_p*`), and what the JAX package computes on them: the observation
  and tether residuals with `project_obs`, the normal equations, the
  damped solves, two LM iterations, `step_bundle_adjust` on the noiseless
  scene (`nl_*`), `iterate_bundle_adjust`, the window at each of the
  test's argument sets (`kw{j}_*`), `build_fidx` and `apply_ba_results`
  (`apply{0,1}_*`). A window is its problem's leaves (`{w}_p{i}`) and its
  slot maps by name (~80 s).

One more holds the JAX references of the port's parallel package and the
session's mapping offload (tests/test_torch_parallel.py,
tests/test_torch_offload.py, chip_smoke.py phase 15), on 8 virtual CPU
devices (`XLA_FLAGS=--xla_force_host_platform_device_count=8`):

- `parallel`: the sharded matcher's answers over 8 devices at
  tests/test_parallel.py's (512, 128) and the budgets' (8192, 512)
  (`mt_*`; the inputs are rebuilt from `matcher_case`'s seed); its
  `_problem` (RandomState(0)) with one sharded LM iteration, four chained
  and the dense one (`lm_*`); tests/test_global_ba_capacity.py's window
  (`build_capacity_map(RandomState(0))`) with the dense and the sharded
  step (`cap_*`); the per-frame session's maps, histories and frames
  before frames 31-38 (session 0's map whole, the others' differing
  leaves) and `batched_track_step` over the 8 (`bt*`); the session from
  frame 0 with a Determinator and, from frame 31, the mapping offloaded to
  `jax.devices()[1]` over frames 31-95, then `fossilize(0)`: per-frame
  outputs, the map's masks after each adoption, the trajectory and the
  checkpoints from frame 31 (`off_*`) (~5 min).

Two more hold the references of three pyramid levels and of the
visual-inertial session under its other two filters:

- `levels`: golden settings with NumLevels 3 and ScaleFactor 1.5
  (`SessionRecorder`, plus each frame's associations `ref_assoc` and the
  octave histogram of its associated keypoints `ref_octave_hist`):
  bench.py's frames at 640x480 from frame 0 until `LEVELS_EVENTS`
  keyframes have been mapped and `MAP_TAIL` more frames tracked, and
  `detect_and_compute` at three levels on bench frame 31, its 160x120 crop
  and photoreal frame 10 (`fe_*`), the pyramids of those images, the
  octave arithmetic on its rounding boundaries and the per-level budgets,
  with the jax / jaxlib versions and the CPU's features that produced them
  (`levels_reference_arrays`). When that session relocalizes no lost
  frame, a second file holds tests/test_bow_reloc.py's lost-and-relocalize
  scene (as `reloc`: its snapshot after frame 29 as the file's own keys,
  the features of frames 30-37) with each point given an octave in 0..2 as
  tests/test_pipeline.py's three-level test gives them (~4 min);
- `vi_filters`: apps/vi_eval.py's run as `vi` records it (per-frame
  results, fuser mode, metric scale, EKF state, priors, covariances, the
  arguments given to `Fuser.process_frame`, the map's masks after each
  mapping event, its relocalizations' draws) with FilterType FUSER3DOF
  (`f3_*`) and FUSER6DOF (`f6_*`) (~4 min).

One more holds the JAX side of two mono-init checks:

- `init_checks`: tests/test_torch_map_init.py's synthetic pairs (two
  views, a pure rotation, unrelated descriptors: the draws of PRNGKey(0)
  and `try_initialize_pair`'s result) and tests/test_torch_reloc.py's
  attempt at frame 7 of the `reloc` scene in float64 (~40 s).

    python tools/export_jax_state.py [track|map|both|bow|init|photoreal|reloc|loop|stereo|cameras|vi|stream|diag|ba|parallel|levels|vi_filters|init_checks|all]

`both` is track and map, `all` every file. Outputs:
tests/data/torch_port_bench640_f30.npz (track),
tests/data/torch_port_bench640_map.npz (map),
tests/data/torch_port_bench640_bow.npz (bow),
tests/data/torch_port_bench640_init.npz (init),
tests/data/torch_port_photoreal.npz (photoreal),
tests/data/torch_port_reloc.npz (reloc),
tests/data/torch_port_loop.npz (loop),
tests/data/torch_port_stereo.npz (stereo) and
tests/data/torch_port_cameras.npz, torch_port_cameras_kp.npz and
torch_port_orient.npz (cameras), tests/data/torch_port_vi.npz (vi),
tests/data/torch_port_stream.npz (stream), tests/data/torch_port_diag.npz
(diag), tests/data/torch_port_ba.npz (ba), tests/data/torch_port_parallel.npz
(parallel), tests/data/torch_port_levels.npz and
torch_port_levels_reloc.npz (levels),
tests/data/torch_port_vi_filters.npz (vi_filters),
tests/data/torch_port_init_checks.npz (init_checks).
"""

from __future__ import annotations

import os
import re
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(REPO, "tests", "data", "torch_port_bench640_f30.npz")

MAP_OUT = os.path.join(REPO, "tests", "data", "torch_port_bench640_map.npz")
INIT_OUT = os.path.join(REPO, "tests", "data", "torch_port_bench640_init.npz")
BOW_OUT = os.path.join(REPO, "tests", "data", "torch_port_bench640_bow.npz")
PHOTOREAL_OUT = os.path.join(REPO, "tests", "data", "torch_port_photoreal.npz")
RELOC_OUT = os.path.join(REPO, "tests", "data", "torch_port_reloc.npz")
LOOP_OUT = os.path.join(REPO, "tests", "data", "torch_port_loop.npz")

SNAP_FRAME = 30
LAST_FRAME = 54
MAP_EVENTS = 3        # mapped keyframes in the second file's window
MAP_TAIL = 2          # frames tracked after the last of them
MAP_MAX_FRAME = 140   # give up beyond this frame
CAM = (520.0, 520.0, 320.0, 240.0)
DT = 0.033


def bench_frames(stop: int) -> list[np.ndarray]:
    """bench.py's rendered frames 0..stop-1, clipped and cast to uint8."""
    sys.path.insert(0, REPO)
    import bench

    pts, patches = bench.build_world(np.random.RandomState(7))
    return [np.clip(bench.render(pts, patches, i * DT), 0, 255).astype(np.uint8)
            for i in range(stop)]


def make_jax_session():
    import jax.numpy as jnp

    from mageslam_tpu.config import golden_path_settings
    from mageslam_tpu.runtime import SlamSession

    return SlamSession(golden_path_settings(), cam=jnp.asarray(CAM, jnp.float32),
                       image_width=640, image_height=480)


class InitRecorder:
    """Records what a JAX session's mono init and vocabulary training see
    and draw: installed on the pipeline module's functions and on the
    session's own methods while frames 0..SNAP_FRAME run."""

    def __init__(self, sess, mask_draws: bool = False):
        import jax

        from mageslam_tpu.bow import index as bow_index
        from mageslam_tpu.runtime import pipeline

        self.sess, self.frame, self.mask_draws = sess, -1, mask_draws
        self.arrays: dict = {}
        self.counts = {"attempt": 0, "third": 0, "vocab": 0}
        self.adopt_frame = self.retrain_frame = -1
        self.anchors: list[int] = []
        self._jit_gumbel = jax.jit(
            lambda keys, shape: jax.vmap(lambda k: jax.random.gumbel(k, shape))(keys),
            static_argnums=1)
        self._restore = [(pipeline, "try_initialize_pair"),
                         (pipeline, "validate_third_frame"),
                         (pipeline, "train_vocabulary"),
                         (bow_index, "retrain_index_jit")]
        self._real = {n: getattr(m, n) for m, n in self._restore}
        pipeline.try_initialize_pair = self._attempt
        pipeline.validate_third_frame = self._third
        pipeline.train_vocabulary = self._vocab
        bow_index.retrain_index_jit = self._retrain
        self._process, self._adopt = sess.process_features, sess._adopt_initialization
        sess.process_features = self._process_features
        sess._adopt_initialization = self._adopt_initialization

    def close(self) -> None:
        for m, n in self._restore:
            setattr(m, n, self._real[n])
        del self.sess.process_features, self.sess._adopt_initialization

    def _put(self, name: str, value) -> None:
        self.arrays[name] = np.asarray(value)

    def _draws(self, key, rows: int, shape: tuple) -> np.ndarray:
        """The Gumbel draws of `rows` keys split from `key`, each of
        `shape`, as the reference's vmapped draw makes them."""
        import jax

        return np.asarray(self._jit_gumbel(jax.random.split(key, rows), shape),
                          np.float32)

    def _process_features(self, feats, timestamp, frame_id, *a, **k):
        self.frame = int(frame_id)
        out = self._process(feats, timestamp, frame_id, *a, **k)
        meta = self.sess.prev_meta
        if not self.sess.initialized and meta is not None and meta[0] == self.frame:
            self.anchors.append(self.frame)
        return out

    def _attempt(self, xy1, desc1, valid1, xy2, desc2, valid2, cam, key, settings,
                 ransac_batch):
        j = self.counts["attempt"]
        self.counts["attempt"] += 1
        res = self._real["try_initialize_pair"](xy1, desc1, valid1, xy2, desc2, valid2,
                                                cam, key, settings,
                                                ransac_batch=ransac_batch)
        n = xy1.shape[0]
        p = f"init_att{j}_"
        self._put(p + "frame", np.int32(self.frame))
        self._put(p + "key", key)
        draws = self._draws(key, ransac_batch, (5, n))
        if self.mask_draws:
            # a draw where the pair's mutual match fails never reaches a
            # sample: the greedy argmax adds -1e12 there, which absorbs it
            # (map_init.py:164-176); stored as 0, the file compresses
            from mageslam_tpu.ops.matching import match_two_way

            m_idx, _ = match_two_way(desc1, valid1, desc2, valid2,
                                     settings.max_hamming_dist, settings.min_hamming_diff)
            draws = np.where(np.asarray(m_idx >= 0)[None, None], draws, np.float32(0))
        self._put(p + "draws", draws)
        for name, v in (("xy1", xy1), ("desc1", desc1), ("valid1", valid1),
                        ("xy2", xy2), ("desc2", desc2), ("valid2", valid2)):
            self._put(p + name, v)
        self._put(p + "succeeded", res.succeeded)
        self._put(p + "pose2_R", res.pose2.R)
        self._put(p + "pose2_t", res.pose2.t)
        self._put(p + "points", res.points)
        self._put(p + "point_valid", res.point_valid)
        self._put(p + "feat2", res.feat2)
        self._put(p + "match_count", res.match_count)
        return res

    def _third(self, res, anchor_desc, anchor_valid, xy, desc, valid, cam, key,
               **kw):
        j = self.counts["third"]
        self.counts["third"] += 1
        ok = self._real["validate_third_frame"](res, anchor_desc, anchor_valid, xy,
                                                desc, valid, cam, key, **kw)
        p = f"init_third{j}_"
        self._put(p + "frame", np.int32(self.frame))
        self._put(p + "key", key)
        # pnp_ransac's 64 hypotheses, each a Gumbel draw over the M points
        self._put(p + "draws", self._draws(key, 64, (res.points.shape[0],)))
        for name, v in (("xy", xy), ("desc", desc), ("valid", valid),
                        ("anchor_valid", anchor_valid)):
            self._put(p + name, v)
        self._put(p + "ok", ok)
        return ok

    def _vocab_draw(self, key, n: int, where: str) -> None:
        import jax

        j = self.counts["vocab"]
        self.counts["vocab"] += 1
        self._put(f"init_vocab{j}_frame", np.int32(self.frame))
        self._put(f"init_vocab{j}_where", np.bytes_(where))
        self._put(f"init_vocab{j}_key", key)
        self._put(f"init_vocab{j}_draws",
                  np.asarray(jax.jit(jax.random.gumbel, static_argnums=1)(key, (n,)),
                             np.float32))

    def _vocab(self, desc, valid, key, **kw):
        self._vocab_draw(key, desc.shape[0], "adopt")
        return self._real["train_vocabulary"](desc, valid, key, **kw)

    def _retrain(self, index, pool_desc, pool_valid, kf_desc, kf_kp_valid, kf_has, key,
                 **kw):
        self._vocab_draw(key, pool_desc.shape[0], "retrain")
        out = self._real["retrain_index_jit"](index, pool_desc, pool_valid, kf_desc,
                                              kf_kp_valid, kf_has, key, **kw)
        self.retrain_frame = self.frame
        self._put("init_pool_rows", np.int32(pool_desc.shape[0]))
        for name, v in zip(("anchors", "idf", "kf_vectors", "kf_has"), out[:4]):
            self._put(f"init_bow_retrain_{name}", v)
        return out

    def _adopt_initialization(self, res, feats, timestamp, frame_id):
        self._adopt(res, feats, timestamp, frame_id)
        self.adopt_frame = int(frame_id)
        bow = self.sess.bow
        for name, v in zip(("anchors", "idf", "kf_vectors", "kf_has"), bow[:4]):
            self._put(f"init_bow_adopt_{name}", v)

    def result(self) -> dict:
        """The recorded arrays with the counts, the anchor, adoption and
        retrain frames and the session's per-frame outputs."""
        out = dict(self.arrays)
        for k, v in self.counts.items():
            out[f"init_n_{k}"] = np.int32(v)
        out["init_anchor_frames"] = np.asarray(self.anchors, np.int32)
        out["init_adopt_frame"] = np.int32(self.adopt_frame)
        out["init_retrain_frame"] = np.int32(self.retrain_frame)
        rs = self.sess.results
        nan_R, nan_t = np.full((3, 3), np.nan, np.float32), np.full(3, np.nan, np.float32)
        out["init_ref_frame_id"] = np.asarray([r.frame_id for r in rs], np.int32)
        out["init_ref_state"] = np.asarray([r.state.value for r in rs], np.int32)
        out["init_ref_R"] = np.asarray([nan_R if r.pose is None else np.asarray(r.pose.R)
                                        for r in rs], np.float32)
        out["init_ref_t"] = np.asarray([nan_t if r.pose is None else np.asarray(r.pose.t)
                                        for r in rs], np.float32)
        out["init_ref_tracked"] = np.asarray([r.tracked_count for r in rs], np.int32)
        out["init_ref_is_kf"] = np.asarray([r.is_keyframe for r in rs], bool)
        return out


def run_to_snapshot(frames, snap_path: str):
    """Drive a JAX session over frames 0..SNAP_FRAME and save its snapshot.
    The session's `init_record` holds what `InitRecorder` recorded."""
    from mageslam_tpu.io.snapshot import save_session_snapshot

    sess = make_jax_session()
    rec = InitRecorder(sess)
    try:
        for i in range(SNAP_FRAME + 1):
            sess.process_frame(frames[i], i * DT, i)
    finally:
        rec.close()
    sess.init_record = rec.result()
    save_session_snapshot(snap_path, sess)
    return sess


def record_window(sess, frames, start: int, stop: int) -> dict:
    """Per-frame JAX outputs over frames start..stop-1 as `ref_*` arrays."""
    out = {k: [] for k in ("frame_id", "R", "t", "tracked", "is_kf", "state",
                           "assoc")}
    for i in range(start, stop):
        r = sess.process_frame(frames[i], i * DT, i)
        out["frame_id"].append(i)
        out["R"].append(np.asarray(r.pose.R) if r.pose is not None
                        else np.full((3, 3), np.nan, np.float32))
        out["t"].append(np.asarray(r.pose.t) if r.pose is not None
                        else np.full((3,), np.nan, np.float32))
        out["tracked"].append(r.tracked_count)
        out["is_kf"].append(r.is_keyframe)
        out["state"].append(r.state.value)
        # a tracked frame's associations are the newest tracking-history row
        # (mapping, when the frame is a keyframe, leaves the history alone)
        out["assoc"].append(np.asarray(sess.history.assoc[0]))
    return {
        "ref_frame_id": np.asarray(out["frame_id"], np.int32),
        "ref_R": np.asarray(out["R"], np.float32),
        "ref_t": np.asarray(out["t"], np.float32),
        "ref_tracked": np.asarray(out["tracked"], np.int32),
        "ref_is_kf": np.asarray(out["is_kf"], bool),
        "ref_state": np.asarray(out["state"], np.int32),
        "ref_assoc": np.asarray(out["assoc"], np.int32),
    }


def _flatten(prefix: str, tree) -> dict:
    import jax

    return {f"{prefix}{i}": np.asarray(leaf)
            for i, leaf in enumerate(jax.tree.flatten(tree)[0])}


def record_mapping_window(sess, render_frame) -> dict:
    """Run `sess` on from frame SNAP_FRAME+1 until MAP_EVENTS keyframes have
    been mapped and MAP_TAIL more frames tracked; `render_frame(i)` gives
    frame i. Returns the second file's arrays."""
    events = []
    mapper = sess._insert_keyframe_and_map

    def recording_mapper(frame, frame_id):
        pre = (sess.map, sess.pose_history, frame, np.float32(sess.map_scale))
        capacity = sess.map.capacity
        mapper(frame, frame_id)
        if sess.map.capacity != capacity or sess._grow_pending:
            raise RuntimeError(f"the map banks grow at frame {frame_id}: "
                               f"shorten the window")
        events.append((frame_id, pre, sess.map, sess.pose_history,
                       sess.last_kf_slot, sess.bow))

    sess._insert_keyframe_and_map = recording_mapper
    per_frame = []
    i, stop = SNAP_FRAME + 1, MAP_MAX_FRAME
    while i < stop:
        per_frame.append(record_window(sess, {i: render_frame(i)}, i, i + 1))
        if len(events) == MAP_EVENTS and stop == MAP_MAX_FRAME:
            stop = i + 1 + MAP_TAIL
        i += 1
    if len(events) < MAP_EVENTS:
        raise RuntimeError(f"only {len(events)} keyframes mapped by frame "
                           f"{MAP_MAX_FRAME}")
    out = {k: np.concatenate([f[k] for f in per_frame]) for k in per_frame[0]}
    out["ev_frame_id"] = np.asarray([e[0] for e in events], np.int32)
    out["ev_ki"] = np.asarray([e[4] for e in events], np.int32)
    for j, (_, pre, post_map, post_ph, _, post_bow) in enumerate(events):
        out.update(_flatten(f"ev{j}_post_map", post_map))
        out.update(_flatten(f"ev{j}_post_ph", post_ph))
        out.update(_flatten(f"ev{j}_post_bow", post_bow))
        if j == 0:
            out.update(_flatten("ev0_pre_map", pre[0]))
            out.update(_flatten("ev0_pre_ph", pre[1]))
            out.update(_flatten("ev0_frame", pre[2]))
            out["ev0_map_scale"] = pre[3]
    return out


def main_map(out_path: str = MAP_OUT, bow_path: str | None = None) -> None:
    """Write the map file; with `bow_path`, write only the bag-of-words
    index after each event (`ev{j}_post_bow{i}`) there instead."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    import bench

    pts, patches = bench.build_world(np.random.RandomState(7))

    def render_frame(i):
        return np.clip(bench.render(pts, patches, i * DT), 0, 255).astype(np.uint8)

    frames = [render_frame(i) for i in range(SNAP_FRAME + 1)]
    with tempfile.TemporaryDirectory() as tmp:
        sess = run_to_snapshot(frames, os.path.join(tmp, "snap.npz"))
    arrays = record_mapping_window(sess, render_frame)
    if (arrays["ref_state"] != 1).any():
        raise RuntimeError(f"not every frame tracked: {arrays['ref_state'].tolist()}")
    is_bow = {k: "_post_bow" in k for k in arrays}
    if bow_path is None:
        arrays = {k: v for k, v in arrays.items() if not is_bow[k]}
    else:
        out_path = bow_path
        arrays = {k: v for k, v in arrays.items() if is_bow[k] or k.startswith("ev_")}
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez_compressed(out_path, **arrays)
    print(f"wrote {out_path}: {os.path.getsize(out_path)} bytes, mapped keyframes at "
          f"{arrays['ev_frame_id'].tolist()} in slots {arrays['ev_ki'].tolist()}")


def main(out_path: str = DEFAULT_OUT) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    frames = bench_frames(LAST_FRAME + 1)
    with tempfile.TemporaryDirectory() as tmp:
        snap = os.path.join(tmp, "snap.npz")
        sess = run_to_snapshot(frames, snap)
        with np.load(snap) as z:
            arrays = {k: z[k] for k in z.files}
    ref = record_window(sess, frames, SNAP_FRAME + 1, LAST_FRAME + 1)
    kf = ref["ref_is_kf"]
    if kf[:-1].any() or not kf[-1] or (ref["ref_state"] != 1).any():
        raise RuntimeError(
            f"window {SNAP_FRAME + 1}..{LAST_FRAME} is not an all-tracked "
            f"keyframe-free window ending in a keyframe: keyframes at "
            f"{ref['ref_frame_id'][kf].tolist()}, states "
            f"{ref['ref_state'].tolist()}")
    arrays.update(ref)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez_compressed(out_path, **arrays)
    print(f"wrote {out_path}: {os.path.getsize(out_path)} bytes, tracked "
          f"{ref['ref_tracked'].tolist()}")


def main_init(out_path: str = INIT_OUT) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    frames = bench_frames(SNAP_FRAME + 1)
    with tempfile.TemporaryDirectory() as tmp:
        sess = run_to_snapshot(frames, os.path.join(tmp, "snap.npz"))
    arrays = sess.init_record
    if arrays["init_adopt_frame"] < 0 or arrays["init_retrain_frame"] < 0:
        raise RuntimeError(f"no adoption or no retrain by frame {SNAP_FRAME}")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez_compressed(out_path, **arrays)
    print(f"wrote {out_path}: {os.path.getsize(out_path)} bytes, anchors at "
          f"{arrays['init_anchor_frames'].tolist()}, attempts at "
          f"{[int(arrays[f'init_att{j}_frame']) for j in range(arrays['init_n_attempt'])]}, "
          f"adopted at {int(arrays['init_adopt_frame'])}, retrained at "
          f"{int(arrays['init_retrain_frame'])} ({int(arrays['init_pool_rows'])} pool rows), "
          f"states {arrays['init_ref_state'].tolist()}")


PHOTOREAL_FRAMES = 80
PHOTOREAL_SIZE = (320, 180)
# the map's masks recorded after each mapping event of the photoreal run
EVENT_MASKS = ("kf_valid", "mp_valid", "kf_assoc", "kf_member")
RELOC_HYPOTHESES = 64   # pnp_ransac's hypotheses, as relocalize calls it


def reloc_draws(key, candidates: int, rows: int) -> np.ndarray:
    """(C, H, M) Gumbel draws of `relocalize(key)`: the key splits into C
    candidates, each candidate's `pnp_ransac` key into H hypotheses of
    (M,) draws."""
    import jax

    def per_candidate(k):
        return jax.vmap(lambda kk: jax.random.gumbel(kk, (rows,)))(
            jax.random.split(k, RELOC_HYPOTHESES))

    return np.asarray(jax.jit(jax.vmap(per_candidate))(
        jax.random.split(key, candidates)), np.float32)


def detection_gate(settings, map_state, bow, frame, ki):
    """(live, qualifies, cluster size) of detect_loop on this keyframe, as
    mageslam_tpu/runtime/loop_closure.py:91-132 computes them."""
    import jax.numpy as jnp

    from mageslam_tpu.bow.index import query_keyframes
    from mageslam_tpu.runtime.loop_closure import _connected_components
    from mageslam_tpu.worldmap.covisibility import covisibility_matrix

    cs, lc = settings.CovisibilitySettings, settings.LoopClosureSettings
    K = map_state.capacity[0]
    covis = covisibility_matrix(map_state)
    scores, _ = query_keyframes(bow, frame.desc, frame.kp_valid)
    covisible = (covis[ki] >= cs.CovisLoopThreshold) & map_state.kf_valid
    lowest = jnp.min(jnp.where(covisible, scores, jnp.inf))
    good = (map_state.kf_valid & bow.kf_has & ~covisible & (jnp.arange(K) != ki)
            & (scores >= lowest) & jnp.any(covisible))
    labels = _connected_components(covis >= cs.CovisMinThreshold, good)
    counts = jnp.zeros((K + 1,), jnp.int32).at[labels].add(1).at[K].set(0)
    size = int(jnp.sum(good & (labels == jnp.argmax(counts))))
    n_kf = int(jnp.sum(map_state.kf_valid))
    live = n_kf >= lc.MinKeyframe
    return live, live and size >= lc.MinClusterSize, size


class RelocRecorder:
    """Records every relocalization a JAX session runs: the lost-frame
    path's (`_reloc_core`) and loop detection's (inside the keyframe
    resolve core), with its key and draws, in the order they ran. With
    `full_inputs` the first successful lost-frame relocalization's inputs
    and results are stored too (`relocin_*`)."""

    def __init__(self, sess, full_inputs: bool = False):
        self.sess, self.full_inputs = sess, full_inputs
        self.arrays: dict = {}
        self.n = 0
        self.detections: list[tuple] = []
        self._real_reloc, self._real_get = sess._reloc_core, sess._get_kf_resolve_core
        sess._reloc_core = self._reloc
        sess._get_kf_resolve_core = self._get_core

    def close(self) -> None:
        self.sess._reloc_core = self._real_reloc
        del self.sess._get_kf_resolve_core

    def _record(self, key, frame, where: str) -> int:
        j = self.n
        self.n += 1
        C = self.sess.settings.MappingSettings.MaxRelocQueryResults
        self.arrays[f"reloc{j}_frame"] = np.int32(frame.frame_id)
        self.arrays[f"reloc{j}_where"] = np.bytes_(where)
        self.arrays[f"reloc{j}_key"] = np.asarray(key)
        self.arrays[f"reloc{j}_draws"] = reloc_draws(key, C, frame.desc.shape[0])
        return j

    def _reloc(self, map_state, bow, frame, key):
        res = self._real_reloc(map_state, bow, frame, key)
        j = self._record(key, frame, "lost")
        self.arrays[f"reloc{j}_succeeded"] = np.asarray(res.succeeded)
        if self.full_inputs and bool(res.succeeded) and "relocin_cand" not in self.arrays:
            self._inputs(map_state, bow, frame, key)
        return res

    def _inputs(self, map_state, bow, frame, key) -> None:
        """A relocalization's inputs, the query and `relocalize`'s result,
        as `_build_reloc_core` computes them."""
        import jax.numpy as jnp

        from mageslam_tpu.bow.index import query_keyframes
        from mageslam_tpu.tracking.relocalization import relocalize

        s = self.sess.settings
        rs = s.RelocalizationSettings
        C = s.MappingSettings.MaxRelocQueryResults
        self.arrays.update(_flatten("relocin_map", map_state))
        self.arrays.update(_flatten("relocin_bow", bow))
        self.arrays.update(_flatten("relocin_frame", frame))
        self.arrays["relocin_draws"] = self.arrays[f"reloc{self.n - 1}_draws"]
        scores, qualified = query_keyframes(
            bow, frame.desc, frame.kp_valid,
            qualifying_score=s.BagOfWordsSettings.QualifyingCandidateScore)
        cand = jnp.argsort(-jnp.where(qualified, scores, -1.0))[:C].astype(jnp.int32)
        cand_ok = qualified[cand] & map_state.kf_valid[cand]
        r = relocalize(
            frame, map_state, cand, cand_ok, key,
            min_brute_force=rs.MinBruteForceCorrespondences,
            min_radius_matches=rs.MinRadiusMatchCorrespondences,
            ransac_inlier_pct=rs.RansacInliersPctRequired,
            ba_inlier_pct=rs.BundleAdjustInliersPctRequired,
            max_pnp_error=rs.MaxBundlePnPReprojectionError,
            max_ba_error=rs.MaxBundleAdjustReprojectionError,
            ba_iterations=rs.BundleAdjustIterations,
            search_radius=rs.SearchRadius,
            max_hamming=rs.OrbMatcherSettings.MaxHammingDistance,
            min_hamming_diff=rs.OrbMatcherSettings.MinHammingDifference)
        for name, v in (("scores", scores), ("qualified", qualified), ("cand", cand),
                        ("cand_ok", cand_ok), ("out_R", r.pose.R), ("out_t", r.pose.t),
                        ("out_assoc", r.assoc), ("out_succeeded", r.succeeded),
                        ("out_candidate", r.candidate)):
            self.arrays[f"relocin_{name}"] = np.asarray(v)

    def _get_core(self):
        import jax

        core = self._real_get()

        def wrapped(map_state, bow, frame, ki, fid, key):
            out = core(map_state, bow, frame, ki, fid, key)
            if out[1] is None:
                return out
            live, qualifies, size = detection_gate(self.sess.settings, map_state,
                                                   out[0], frame, int(ki))
            self.detections.append((int(fid), int(ki), live, qualifies, size,
                                    bool(out[1].detected)))
            if qualifies:
                self._record(jax.random.split(key)[1], frame, "detect")
            return out

        return wrapped

    def result(self) -> dict:
        out = dict(self.arrays)
        out["reloc_n"] = np.int32(self.n)
        d = np.asarray(self.detections, np.int32).reshape(-1, 6)
        for i, name in enumerate(("frame", "ki", "live", "qualifies", "cluster_size",
                                  "detected")):
            out[f"det_{name}"] = d[:, i]
        return out


def session_refs(sess) -> dict:
    """Every result of a JAX session as `ref_*` arrays (NaN poses where a
    frame was not tracked)."""
    rs = sess.results
    nan_R, nan_t = np.full((3, 3), np.nan, np.float32), np.full(3, np.nan, np.float32)
    return {
        "ref_frame_id": np.asarray([r.frame_id for r in rs], np.int32),
        "ref_state": np.asarray([r.state.value for r in rs], np.int32),
        "ref_R": np.asarray([nan_R if r.pose is None else np.asarray(r.pose.R)
                             for r in rs], np.float32),
        "ref_t": np.asarray([nan_t if r.pose is None else np.asarray(r.pose.t)
                             for r in rs], np.float32),
        "ref_tracked": np.asarray([r.tracked_count for r in rs], np.int32),
        "ref_is_kf": np.asarray([r.is_keyframe for r in rs], bool),
    }


def _save(out_path: str, arrays: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez_compressed(out_path, **arrays)


def main_photoreal(out_path: str = PHOTOREAL_OUT) -> None:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    from mageslam_tpu.apps.evaluate import ate_rmse
    from mageslam_tpu.apps.render_scene import CX, CY, FX, FY, render_sequence
    from mageslam_tpu.config import golden_path_settings
    from mageslam_tpu.runtime import SlamSession

    W, H = PHOTOREAL_SIZE
    seq = list(render_sequence(PHOTOREAL_FRAMES, W, H))
    sx, sy = W / 640.0, H / 480.0
    cam = np.asarray([FX * sx, FY * sy, CX * sx, CY * sy], np.float32)
    sess = SlamSession(golden_path_settings(), cam=jnp.asarray(cam),
                       image_width=W, image_height=H)
    rec, rrec = InitRecorder(sess), RelocRecorder(sess)
    events = []
    mapper = sess._insert_keyframe_and_map

    def recording_mapper(frame, frame_id):
        mapper(frame, frame_id)
        events.append((frame_id, {n: np.asarray(getattr(sess.map, n)) for n in EVENT_MASKS}))

    sess._insert_keyframe_and_map = recording_mapper
    assoc = []
    try:
        for img, ts, fid, _, _ in seq:
            sess.process_frame(img.astype(np.float32), ts, fid)
            # a tracked frame's associations: the newest tracking-history row
            assoc.append(np.asarray(sess.history.assoc[0]))
    finally:
        rec.close()
        rrec.close()
        del sess._insert_keyframe_and_map
    arrays = {k: v for k, v in rec.result().items() if not k.startswith("init_ref_")}
    arrays["ref_assoc"] = np.asarray(assoc, np.int32)
    arrays["ev_frame_id"] = np.asarray([e[0] for e in events], np.int32)
    for j, (_, masks) in enumerate(events):
        arrays.update({f"ev{j}_{n}": v for n, v in masks.items()})
    arrays.update(rrec.result())
    arrays.update(session_refs(sess))
    arrays.update(_flatten("final_map", sess.map))
    arrays["frames"] = np.stack([s[0] for s in seq]).astype(np.uint8)
    arrays["timestamps"] = np.asarray([s[1] for s in seq], np.float64)
    arrays["gt_R"] = np.asarray([s[3] for s in seq], np.float64)
    arrays["gt_c"] = np.asarray([s[4] for s in seq], np.float64)
    arrays["cam"] = cam
    arrays["map_scale"] = np.float32(sess.map_scale)
    arrays["n_loops_closed"] = np.int32(sess.n_loops_closed)
    ids, mats = sess.fossilize(global_ba_steps=None)
    arrays["fossil_ids"], arrays["fossil_mats"] = np.asarray(ids, np.int32), mats
    ts_by_id = dict(zip(arrays["ref_frame_id"].tolist(), arrays["timestamps"]))
    centers = np.asarray([-m[:3, :3].T @ m[:3, 3] for m in mats])
    rmse, n = ate_rmse(np.asarray([ts_by_id[int(i)] for i in ids]), centers,
                       arrays["timestamps"], arrays["gt_c"])
    arrays["jax_ate"], arrays["jax_ate_n"] = np.float64(rmse), np.int32(n)
    ids3, mats3 = sess.fossilize(global_ba_steps=3)
    arrays["fossil3_ids"], arrays["fossil3_mats"] = np.asarray(ids3, np.int32), mats3
    _save(out_path, arrays)
    print(f"wrote {out_path}: {os.path.getsize(out_path)} bytes; states "
          f"{arrays['ref_state'].tolist()}; keyframes at "
          f"{arrays['ref_frame_id'][arrays['ref_is_kf']].tolist()}; "
          f"{int(arrays['reloc_n'])} relocalizations; detections (frame, ki, live, "
          f"qualifies, cluster, detected) {rrec.detections}; {len(ids)} fossilized poses, "
          f"ATE {rmse:.4f} m over {n}")


def _feature_arrays(prefix: str, feats) -> dict:
    return {f"{prefix}{name}": np.asarray(getattr(feats, name))
            for name in ("xy", "und_xy", "response", "octave", "angle", "desc", "valid")}


RELOC_SNAP_FRAME = 29   # the last tracked frame before the garbage frames


def _snapshot_arrays(sess) -> dict:
    """`save_session_snapshot`'s arrays of `sess`, as the fixture's own
    keys, so that the port's `SlamSession.from_jax_snapshot` reads the
    fixture itself."""
    from mageslam_tpu.io.snapshot import save_session_snapshot

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "snap.npz")
        save_session_snapshot(path, sess)
        with np.load(path) as z:
            return {k: z[k] for k in z.files}


def main_reloc(out_path: str = RELOC_OUT) -> None:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    from test_bow_reloc import rand_desc
    from test_pipeline import CAM, H, W, frame_features, make_world, pose_at

    from mageslam_tpu.ops.frontend import FrameFeatures
    from mageslam_tpu.runtime import SlamSession

    rng = np.random.RandomState(0)      # the tests' `rng` fixture
    pts, descs = make_world(rng)
    sess = SlamSession(cam=CAM, image_width=int(W), image_height=int(H))
    rec, rrec = InitRecorder(sess), RelocRecorder(sess, full_inputs=True)
    arrays: dict = {}

    def garbage():
        n = sess.N
        xy = jnp.array(rng.uniform(20, 300, (n, 2)), jnp.float32)
        return FrameFeatures(xy=xy, und_xy=xy, response=jnp.full((n,), 10.0),
                             octave=jnp.zeros((n,), jnp.int32),
                             angle=jnp.zeros((n,), jnp.float32),
                             desc=rand_desc(rng, n), valid=jnp.ones((n,), bool))

    try:
        for i in range(38):
            t = i * 0.033
            if i < 30:
                feats = frame_features(pts, descs, pose_at(t), sess.N, rng)
            elif i < 35:
                feats = garbage()
            else:
                feats = frame_features(pts, descs, pose_at(29 * 0.033), sess.N, rng)
            arrays.update(_feature_arrays(f"feat{i}_", feats))
            sess.process_features(feats, t, i)
            if i == RELOC_SNAP_FRAME:
                arrays.update(_snapshot_arrays(sess))
    finally:
        rec.close()
        rrec.close()
    arrays.update({k: v for k, v in rec.result().items() if not k.startswith("init_ref_")})
    arrays.update(rrec.result())
    arrays.update(session_refs(sess))
    arrays["cam"] = np.asarray(CAM, np.float32)
    arrays["size"] = np.asarray([W, H], np.int32)
    arrays["n_frames"] = np.int32(38)
    arrays["map_scale"] = np.float32(sess.map_scale)
    _save(out_path, arrays)
    print(f"wrote {out_path}: {os.path.getsize(out_path)} bytes; states "
          f"{arrays['ref_state'].tolist()}; {int(arrays['reloc_n'])} relocalizations "
          f"{[int(arrays[f'reloc{j}_frame']) for j in range(int(arrays['reloc_n']))]}; "
          f"detections {rrec.detections}")


def main_loop(out_path: str = LOOP_OUT) -> None:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    from test_loop_closure import CAM as LCAM
    from test_loop_closure import K_CAP, N_CAP, P_CAP, build_drifted_map

    from mageslam_tpu.bow.index import query_keyframes
    from mageslam_tpu.config import golden_path_settings
    from mageslam_tpu.geometry.se3 import Pose
    from mageslam_tpu.runtime import SlamSession
    from mageslam_tpu.runtime.loop_closure import (close_loop, detect_loop,
                                                   essential_graph_refine)
    from mageslam_tpu.tracking.frame_state import TrackedFrame
    from mageslam_tpu.worldmap import empty_map
    from mageslam_tpu.worldmap.covisibility import covisibility_matrix
    from mageslam_tpu.worldmap.map_state import refresh_membership

    settings = golden_path_settings()
    lc = settings.LoopClosureSettings
    arrays: dict = {"cam": np.asarray(LCAM, np.float32),
                    "capacity": np.asarray([K_CAP, P_CAP, N_CAP], np.int32)}
    scenes = {"a": (np.array([0.4, 0.1, 0.0], np.float32), 1.0, N_CAP),
              "b": (np.array([0.5, 0.15, 0.0], np.float32), 1.3, 30)}
    for s, (drift, scale, n_vis) in scenes.items():
        m, bow, frames, pts, _, n_pts = build_drifted_map(np.random.RandomState(0), drift,
                                                          scale=scale)
        xy, d, valid, assoc, pose = frames[5]
        valid = valid & (jnp.arange(N_CAP) < n_vis)
        assoc = jnp.where(valid, assoc, -1)
        frame = TrackedFrame(pose=pose, cam=LCAM, kp_xy=xy,
                             kp_octave=jnp.zeros((N_CAP,), jnp.int32), desc=d,
                             kp_valid=valid, assoc=assoc, timestamp=np.float32(0.5),
                             frame_id=np.int32(12))
        key = jax.random.PRNGKey(3)
        det = detect_loop(m, bow, frame, jnp.int32(5), key, min_keyframes=5,
                          min_cluster_size=2)
        scores, qualified = query_keyframes(bow, frame.desc, frame.kp_valid)
        arrays.update(_flatten(f"{s}_map", m))
        arrays.update(_flatten(f"{s}_bow", bow))
        arrays.update(_flatten(f"{s}_frame", frame))
        arrays[f"{s}_pts"], arrays[f"{s}_n_pts"] = pts, np.int32(n_pts)
        arrays[f"{s}_true_t"] = np.asarray(frames[2][4].t)
        arrays[f"{s}_draws"] = reloc_draws(key, 4, N_CAP)
        arrays[f"{s}_scores"], arrays[f"{s}_qualified"] = np.asarray(scores), np.asarray(qualified)
        arrays[f"{s}_covis"] = np.asarray(covisibility_matrix(m))
        for name in ("detected", "reloc_assoc", "scale", "cluster_mask"):
            arrays[f"{s}_det_{name}"] = np.asarray(getattr(det, name))
        arrays[f"{s}_det_R"] = np.asarray(det.reloc_pose.R)
        arrays[f"{s}_det_t"] = np.asarray(det.reloc_pose.t)
        arrays.update(_flatten(f"{s}_closed", close_loop(m, det, frame, jnp.int32(5))))
        closed_eg = close_loop(
            m, det, frame, jnp.int32(5),
            covis_theta=settings.CovisibilitySettings.CovisMinThreshold,
            essential_graph_iters=lc.EssentialGraphIterations)
        arrays.update(_flatten(f"{s}_closed_eg", closed_eg))
        # the session's closure: global BA with the loop-closure settings,
        # then the membership refresh (pipeline.py:2484-2501)
        sess = SlamSession(settings, cam=LCAM, image_width=320, image_height=180)
        sess.map, sess.last_kf_slot = closed_eg, 5
        mse = sess._global_ba(steps=max(lc.BundleAdjustSettings.NumSteps, 5),
                              huber=lc.BundleAdjustSettings.HuberWidth,
                              max_outlier_error=lc.BundleAdjustSettings.MaxOutlierError,
                              bas=lc.BundleAdjustSettings)
        arrays.update(_flatten(f"{s}_gba", refresh_membership(sess.map)))
        arrays[f"{s}_gba_mse"] = np.float32(mse)
        print(f"scene {s}: detected {bool(det.detected)}, scale {float(det.scale):.5f}, "
              f"cluster {np.flatnonzero(np.asarray(det.cluster_mask)).tolist()}, "
              f"global BA mse {mse:.4g}")

    # the 12-keyframe circuit of test_essential_graph_distributes_drift
    rng = np.random.RandomState(0)
    NK, G, s_tot = 12, 16, 1.3
    th = 2 * np.pi * np.arange(NK) / NK
    c_true = np.stack([2 * np.sin(th), np.zeros(NK), 2 * np.cos(th)], 1).astype(np.float32)
    s_k = s_tot ** (np.maximum(np.arange(NK) - 2, 0) / 9.0)
    c_drift = c_true.copy()
    for k in range(3, NK):
        c_drift[k] = c_drift[k - 1] + s_k[k] * (c_true[k] - c_true[k - 1])
    base = np.stack([3.5 * np.sin(th), np.zeros(NK), 3.5 * np.cos(th)], 1)
    pts_true = (base[:, None, :] + rng.uniform(-0.5, 0.5, (NK, G, 3))).astype(np.float32)
    own = np.maximum(np.arange(NK) - 1, 0)
    pts_drift = (c_drift[own][:, None, :] + s_k[own][:, None, None]
                 * (pts_true - c_true[own][:, None, :])).astype(np.float32)
    move = np.zeros(NK, bool)
    move[[10, 11]] = True
    cluster = np.zeros(NK, bool)
    cluster[:3] = True
    kf_c = np.where(move[:, None] | cluster[:, None], c_true, c_drift)
    pt_now = pts_drift.copy()
    pt_now[[0, 10, 11]] = pts_true[[0, 10, 11]]
    m = empty_map(K_CAP, P_CAP, N_CAP)
    P2 = NK * G
    m = m._replace(
        mp_valid=m.mp_valid.at[:P2].set(True),
        mp_pos=m.mp_pos.at[:P2].set(jnp.asarray(pt_now.reshape(-1, 3))),
        mp_dmin=m.mp_dmin.at[:P2].set(0.1), mp_dmax=m.mp_dmax.at[:P2].set(50.0),
        mp_mean_dir=m.mp_mean_dir.at[:P2, 2].set(1.0))
    assoc_rows = np.full((K_CAP, N_CAP), -1, np.int32)
    for k in range(NK):
        g2 = 0 if k == NK - 1 else k + 1
        assoc_rows[k, :G] = np.arange(k * G, (k + 1) * G)
        assoc_rows[k, G:2 * G] = np.arange(g2 * G, (g2 + 1) * G)
    m = m._replace(
        kf_valid=m.kf_valid.at[:NK].set(True), kf_order=m.kf_order.at[:NK].set(jnp.arange(NK)),
        kf_frame_id=m.kf_frame_id.at[:NK].set(jnp.arange(NK)),
        kf_pose=Pose(m.kf_pose.R, m.kf_pose.t.at[:NK].set(jnp.asarray(-kf_c))),
        kf_cam=m.kf_cam.at[:NK].set(LCAM),
        kf_kp_valid=m.kf_kp_valid.at[:NK, :2 * G].set(True),
        kf_assoc=jnp.asarray(assoc_rows))
    m = refresh_membership(m)
    pre_t = np.asarray(m.kf_pose.t).copy()
    pre_t[:NK] = -c_drift
    pre_cv = covisibility_matrix(m).at[11, 0].set(0).at[0, 11].set(0)
    move_k, cluster_k = np.pad(move, (0, K_CAP - NK)), np.pad(cluster, (0, K_CAP - NK))
    out = essential_graph_refine(m, Pose(m.kf_pose.R, jnp.asarray(pre_t)),
                                 jnp.asarray(move_k), jnp.asarray(cluster_k),
                                 jnp.float32(1.0 / s_tot), jnp.int32(11),
                                 pre_covis=pre_cv, iterations=25)
    arrays.update(_flatten("eg_map", m))
    arrays.update(_flatten("eg_out", out))
    arrays["eg_pre_t"], arrays["eg_pre_cv"] = pre_t.astype(np.float32), np.asarray(pre_cv)
    arrays["eg_move"], arrays["eg_cluster"] = move_k, cluster_k
    arrays["eg_scale"], arrays["eg_iterations"] = np.float32(1.0 / s_tot), np.int32(25)
    arrays["eg_c_true"], arrays["eg_pts_true"] = c_true, pts_true
    _save(out_path, arrays)
    print(f"wrote {out_path}: {os.path.getsize(out_path)} bytes")


STEREO_OUT = os.path.join(REPO, "tests", "data", "torch_port_stereo.npz")
CAMERAS_OUT = os.path.join(REPO, "tests", "data", "torch_port_cameras.npz")
CAMERAS_KP_OUT = os.path.join(REPO, "tests", "data", "torch_port_cameras_kp.npz")
ORIENT_OUT = os.path.join(REPO, "tests", "data", "torch_port_orient.npz")
RIG_FRAMES = 40          # the rig-tether session: the bootstrap pair + 39 frames
MIXED_FRAMES = 24        # the mixed-FOV rig through process_stereo_frames
MIXED_SIZE = (320, 180)
MIXED_CAMS = ((260.0, 260.0), (325.0, 325.0))   # primary, narrower secondary fx, fy
MIXED_PP = (160.0, 90.0)
DISTORTED_FRAMES = 40    # the Poly3K photoreal scene, in both undistortion modes
DISTORTION = (-0.15, 0.03, 0.0, 0.0, 0.0)        # k1, k2, k3, p1, p2
ORIENT_FRAMES = 30       # a photoreal session with UseOrientation=True
ORB_FRAMES = (0, 40)     # photoreal frames for the oriented, 3-level frontend
ORB_LEVELS = 3


def _prefixed(prefix: str, arrays: dict) -> dict:
    return {prefix + k: v for k, v in arrays.items()}


def _stereo_settings(s, **keyframe):
    """`s` with MaxDepthMeters = 12 (the synthetic scenes are 3-10 m deep at
    a 0.12 m baseline) and, where given, KeyframeSettings replaced."""
    import dataclasses

    st = s.StereoSettings
    s = dataclasses.replace(s, StereoSettings=dataclasses.replace(
        st, StereoMapInitializationSettings=dataclasses.replace(
            st.StereoMapInitializationSettings, MaxDepthMeters=12.0)))
    if keyframe:
        s = dataclasses.replace(s, KeyframeSettings=dataclasses.replace(
            s.KeyframeSettings, **keyframe))
    return s


def _with_fes(s, undistort_pixels: bool | None = None, **fes):
    """`s` with the mono camera's FeatureExtractorSettings (and
    UndistortImagePixels, where given) replaced."""
    import dataclasses

    cam = s.MonoSettings.MonoCamera
    cam = dataclasses.replace(cam, FeatureExtractorSettings=dataclasses.replace(
        cam.FeatureExtractorSettings, **fes))
    if undistort_pixels is not None:
        cam = dataclasses.replace(cam, UndistortImagePixels=undistort_pixels)
    return dataclasses.replace(s, MonoSettings=dataclasses.replace(s.MonoSettings,
                                                                   MonoCamera=cam))


ATTEMPT_INPUT = re.compile(r"init_(att\d+_(xy|desc|valid)[12]|third\d+_(xy|desc|valid|"
                           r"anchor_valid))$")


class SessionRecorder:
    """A JAX session's draws (`InitRecorder`, `RelocRecorder`), the map's
    masks after each mapping event and each result (`session_refs`)."""

    def __init__(self, sess):
        self.sess = sess
        self.rec, self.rrec = InitRecorder(sess, mask_draws=True), RelocRecorder(sess)
        self.events = []
        mapper = sess._insert_keyframe_and_map

        def recording_mapper(frame, frame_id):
            mapper(frame, frame_id)
            self.events.append((frame_id, {n: np.asarray(getattr(sess.map, n))
                                           for n in EVENT_MASKS}))

        sess._insert_keyframe_and_map = recording_mapper

    def close(self) -> dict:
        self.rec.close()
        self.rrec.close()
        del self.sess._insert_keyframe_and_map
        # the port replays the draws; the attempts' inputs stay out of the file
        arrays = {k: v for k, v in self.rec.result().items()
                  if not k.startswith("init_ref_") and not ATTEMPT_INPUT.match(k)}
        arrays.update(self.rrec.result())
        arrays.update(session_refs(self.sess))
        arrays["ev_frame_id"] = np.asarray([e[0] for e in self.events], np.int32)
        for j, (_, masks) in enumerate(self.events):
            arrays.update({f"ev{j}_{n}": v for n, v in masks.items()})
        arrays["map_scale"] = np.float32(self.sess.map_scale)
        return arrays


def mixed_rig_world():
    """tests/test_stereo.py::test_tracks_on_stereo2_with_rescale_active's
    world: 300 points and their 13×13 patches, the patches resampled for
    the narrower secondary camera."""
    rng = np.random.RandomState(17)
    n_pts = 300
    pts = np.stack([rng.uniform(-3.0, 7.0, n_pts), rng.uniform(-2.0, 2.0, n_pts),
                    rng.uniform(3.0, 7.0, n_pts)], 1).astype(np.float32)
    patches = rng.uniform(30, 220, (n_pts, 13, 13)).astype(np.float32)

    def resize_patch(p, n):
        xs = np.linspace(0, p.shape[1] - 1, n)
        rows = np.stack([np.interp(xs, np.arange(p.shape[1]), p[r])
                         for r in range(p.shape[0])])
        ys = np.linspace(0, p.shape[0] - 1, n)
        return np.stack([np.interp(ys, np.arange(p.shape[0]), rows[:, c])
                         for c in range(n)], axis=1).astype(np.float32)

    n1 = int(round(13 * MIXED_CAMS[1][0] / MIXED_CAMS[0][0])) | 1
    return pts, patches, np.stack([resize_patch(p, n1) for p in patches])


def mixed_rig_render(pts, R, t, fx, fy, bank):
    """The test's renderer with numpy in place of `Pose.transform`: each
    visible point's patch pasted at its rounded projection."""
    W2, H2 = MIXED_SIZE
    half = bank.shape[1] // 2
    Xc = pts @ np.asarray(R, np.float32).T + np.asarray(t, np.float32)
    z = Xc[:, 2]
    u = fx * Xc[:, 0] / z + MIXED_PP[0]
    v = fy * Xc[:, 1] / z + MIXED_PP[1]
    img = np.zeros((H2, W2), np.float32)
    m = half + 3
    vis = (z > 1.0) & (u > m) & (u < W2 - m) & (v > m) & (v < H2 - m)
    for i in np.where(vis)[0]:
        x, y = int(round(u[i])), int(round(v[i]))
        img[y - half:y + half + 1, x - half:x + half + 1] = bank[i]
    return img


def mixed_rig_frames():
    """The 24 pairs: (img0, img1, timestamp) per frame; the rig's camera 0 →
    camera 1 transform is (I, (-0.12, 0, 0))."""
    pts, patches, patches1 = mixed_rig_world()
    eye = np.eye(3, dtype=np.float32)
    out = []
    for i in range(MIXED_FRAMES):
        ts = i * DT
        c = np.array([1.8 * ts, 0.05 * np.sin(2 * ts), 0.0], np.float32)
        t0 = -c
        t1 = t0 + np.array([-0.12, 0.0, 0.0], np.float32)
        out.append((mixed_rig_render(pts, eye, t0, *MIXED_CAMS[0], patches),
                    mixed_rig_render(pts, eye, t1, *MIXED_CAMS[1], patches1), ts))
    return out


def frame_hash(img: np.ndarray) -> np.bytes_:
    import hashlib

    return np.bytes_(hashlib.sha256(np.ascontiguousarray(img, np.float32).tobytes())
                     .hexdigest())


def main_stereo(out_path: str = STEREO_OUT) -> None:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    from test_pipeline import CAM, H, W, frame_features, make_world, pose_at
    from test_stereo import stereo_pair

    from mageslam_tpu.config import golden_path_settings
    from mageslam_tpu.geometry.se3 import Pose
    from mageslam_tpu.runtime import SlamSession
    from mageslam_tpu.tracking.stereo_init import StereoInitSettings, stereo_initialize

    arrays: dict = {"cam": np.asarray(CAM, np.float32), "size": np.asarray([W, H], np.int32)}

    # the bootstrap alone: TestStereoInit's pair (300 points, 512 slots,
    # baseline 0.12), then the same pair with no displacement
    rng = np.random.RandomState(0)
    pts, descs = make_world(rng, n=300)
    f0, f1, rel, _, _ = stereo_pair(rng, pts, descs, 512)
    arrays.update(_feature_arrays("pair_f0_", f0))
    arrays.update(_feature_arrays("pair_f1_", f1))
    arrays["pair_rel_R"], arrays["pair_rel_t"] = np.asarray(rel.R), np.asarray(rel.t)
    settings = StereoInitSettings(max_depth_meters=12.0)
    for name, pose in (("pair_", rel), ("pair_zero_", Pose.identity())):
        res = stereo_initialize(f0.und_xy, f0.desc, f0.valid, f1.und_xy, f1.desc,
                                f1.valid, CAM, pose, settings)
        for field in ("succeeded", "points", "point_valid", "feat1", "feat2",
                      "match_count"):
            arrays[f"{name}{field}"] = np.asarray(getattr(res, field))
        arrays[f"{name}pose2_R"] = np.asarray(res.pose2.R)
        arrays[f"{name}pose2_t"] = np.asarray(res.pose2.t)
    print(f"pair: succeeded {bool(arrays['pair_succeeded'])}, "
          f"{int(arrays['pair_match_count'])} matches, "
          f"{int(arrays['pair_point_valid'].sum())} points; zero baseline "
          f"{bool(arrays['pair_zero_succeeded'])}")

    # the rig-tether session (test_rig_tether_persists_through_mapping_bas)
    rng = np.random.RandomState(0)
    pts, descs = make_world(rng, n=500)
    s = _stereo_settings(golden_path_settings(),
                         KeyframeDecisionMaxTrackingPointMatches=100000,
                         KeyframeDecisionMaxTrackingPointOverlap=0.98)
    sess = SlamSession(s, cam=CAM, image_width=int(W), image_height=int(H))
    rec = SessionRecorder(sess)
    f0, f1, rel, _, _ = stereo_pair(rng, pts, descs, sess.N)
    rig = _feature_arrays("rig_feat0_", f0)
    rig.update(_feature_arrays("rig_feat0b_", f1))
    rig["rig_rel_R"], rig["rig_rel_t"] = np.asarray(rel.R), np.asarray(rel.t)
    try:
        sess.process_stereo_features(f0, f1, rel, 0.0, 0)
        for i in range(1, RIG_FRAMES):
            t = i * 0.033
            feats = frame_features(pts, descs, pose_at(2.2 * t), sess.N, rng, noise=0.4)
            rig.update(_feature_arrays(f"rig_feat{i}_", feats))
            sess.process_features(feats, t, i)
    finally:
        arrays.update(_prefixed("rig_", rec.close()))
    arrays.update(rig)
    arrays["rig_timestamps"] = np.asarray([i * 0.033 for i in range(RIG_FRAMES)])
    m = sess.map
    for name in ("tether_owner", "tether_origin", "tether_kind", "tether_distance",
                 "tether_weight", "kf_valid", "kf_cam", "kf_frame_id"):
        arrays[f"rig_final_{name}"] = np.asarray(getattr(m, name))
    arrays["rig_final_tether_R"] = np.asarray(m.tether_pose.R)
    arrays["rig_final_tether_t"] = np.asarray(m.tether_pose.t)
    arrays["rig_final_kf_R"] = np.asarray(m.kf_pose.R)
    arrays["rig_final_kf_t"] = np.asarray(m.kf_pose.t)
    print(f"rig: states {arrays['rig_ref_state'].tolist()}; keyframes at "
          f"{arrays['rig_ref_frame_id'][arrays['rig_ref_is_kf']].tolist()}; "
          f"{len(arrays['rig_ev_frame_id'])} mapping events; "
          f"{int(arrays['rig_reloc_n'])} relocalizations")

    # the mixed-FOV rig through process_stereo_frames
    (fx0, fy0), (fx1, fy1) = MIXED_CAMS
    w2, h2 = MIXED_SIZE
    camera1 = np.zeros(16, np.float32)
    camera1[:4] = [fx1, fy1, *MIXED_PP]
    camera1[12], camera1[13] = w2, h2
    s = _stereo_settings(golden_path_settings())
    sess = SlamSession(s, cam=jnp.array([fx0, fy0, *MIXED_PP]), image_width=w2,
                       image_height=h2)
    rec = SessionRecorder(sess)
    rel = Pose(jnp.eye(3), jnp.array([-0.12, 0.0, 0.0]))
    hashes = []
    try:
        for i, (img0, img1, ts) in enumerate(mixed_rig_frames()):
            hashes.append((frame_hash(img0), frame_hash(img1)))
            was = sess.initialized
            sess.process_stereo_frames(img0, img1, rel, ts, i, camera1=jnp.asarray(camera1))
            if sess.initialized and not was:
                arrays.update(_snapshot_arrays(sess))     # the file's own keys
                arrays["mix_snapshot_frame"] = np.int32(i)
    finally:
        arrays.update(_prefixed("mix_", rec.close()))
    _, ok, remap, cam1_16 = sess._stereo_prep
    arrays["mix_hash0"] = np.asarray([h[0] for h in hashes])
    arrays["mix_hash1"] = np.asarray([h[1] for h in hashes])
    arrays["mix_camera1"] = camera1
    arrays["mix_cam"] = np.asarray([fx0, fy0, *MIXED_PP], np.float32)
    arrays["mix_cam1_16"] = np.asarray(cam1_16)
    arrays["mix_rescale_ok"] = np.bool_(ok)
    arrays["mix_rescale_active"] = np.bool_(remap is not None)
    arrays["mix_timestamps"] = np.asarray([i * DT for i in range(MIXED_FRAMES)])
    arrays["mix_final_kf_cam"] = np.asarray(sess.map.kf_cam)
    arrays["mix_final_kf_valid"] = np.asarray(sess.map.kf_valid)
    arrays["mix_final_kf_frame_id"] = np.asarray(sess.map.kf_frame_id)
    _save(out_path, arrays)
    print(f"mixed: states {arrays['mix_ref_state'].tolist()}; keyframes at "
          f"{arrays['mix_ref_frame_id'][arrays['mix_ref_is_kf']].tolist()}; cam1_16[:4] "
          f"{arrays['mix_cam1_16'][:4].tolist()}")
    print(f"wrote {out_path}: {os.path.getsize(out_path)} bytes")


def distortion_maps(cam16):
    """The forward map that renders a distorted frame from an ideal pinhole
    one (tests/test_undistort.py::test_tracks_with_poly3k_undistort_pixels):
    each distorted pixel samples the ideal image at its undistorted place."""
    import jax.numpy as jnp

    from mageslam_tpu.geometry.camera import pixel_to_normalized, undistort_normalized

    w, h = int(cam16[12]), int(cam16[13])
    u, v = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    xn = undistort_normalized(cam16, pixel_to_normalized(cam16, jnp.asarray(
        np.stack([u, v], -1))))
    return jnp.stack([cam16[0] * xn[..., 0] + cam16[2], cam16[1] * xn[..., 1] + cam16[3]],
                     axis=-1)


def main_cameras(out_path: str = CAMERAS_OUT) -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    from mageslam_tpu.apps.render_scene import FX, FY, render_sequence
    from mageslam_tpu.config import golden_path_settings
    from mageslam_tpu.geometry.camera import make_pinhole, make_poly3k
    from mageslam_tpu.ops.frontend import detect_and_compute
    from mageslam_tpu.ops.undistort import remap_bilinear
    from mageslam_tpu.runtime import SlamSession
    from mageslam_tpu.runtime import pipeline as pipeline_mod

    W, H = PHOTOREAL_SIZE
    with np.load(PHOTOREAL_OUT) as z:
        photo, photo_ts, photo_cam = z["frames"], z["timestamps"], z["cam"]
    arrays: dict = {}

    # the Poly3K scene: rendered, distorted, rounded to uint8
    sx, sy = W / 640.0, H / 480.0
    cam16 = make_poly3k(FX * sx, FY * sy, W / 2, H / 2, *DISTORTION, W, H)
    dist_map = distortion_maps(cam16)
    seq = list(render_sequence(DISTORTED_FRAMES, W, H))
    frames = np.stack([np.clip(np.round(np.asarray(remap_bilinear(
        jnp.asarray(img, jnp.float32), dist_map))), 0, 255).astype(np.uint8)
        for img, *_ in seq])
    arrays["dist_frames"] = frames
    arrays["dist_timestamps"] = np.asarray([s[1] for s in seq], np.float64)
    arrays["dist_camera"] = np.asarray(cam16)
    kp_arrays: dict = {}
    for prefix, undistort, out in (("und_", True, arrays), ("kp_", False, kp_arrays)):
        sess = SlamSession(_with_fes(golden_path_settings(), undistort_pixels=undistort),
                           camera=cam16, image_width=W, image_height=H)
        rec = SessionRecorder(sess)
        try:
            for i, img in enumerate(frames):
                sess.process_frame(img, float(arrays["dist_timestamps"][i]), i)
        finally:
            out.update(_prefixed(prefix, rec.close()))
        out[prefix + "cam"] = np.asarray(sess.cam)
        out[prefix + "cam16"] = np.asarray(sess.cam16)
        print(f"distorted, UndistortImagePixels={undistort}: states "
              f"{out[prefix + 'ref_state'].tolist()}; keyframes at "
              f"{out[prefix + 'ref_frame_id'][out[prefix + 'ref_is_kf']].tolist()}")
    _save(CAMERAS_KP_OUT, kp_arrays)
    print(f"wrote {CAMERAS_KP_OUT}: {os.path.getsize(CAMERAS_KP_OUT)} bytes")

    # a photoreal session with UseOrientation=True
    sess = SlamSession(_with_fes(golden_path_settings(), UseOrientation=True),
                       cam=jnp.asarray(photo_cam), image_width=W, image_height=H)
    rec = SessionRecorder(sess)
    try:
        for i in range(ORIENT_FRAMES):
            sess.process_frame(photo[i], float(photo_ts[i]), i)
    finally:
        orient = _prefixed("orient_", rec.close())
    _save(ORIENT_OUT, orient)
    print(f"oriented: states {orient['orient_ref_state'].tolist()}; keyframes at "
          f"{orient['orient_ref_frame_id'][orient['orient_ref_is_kf']].tolist()}; wrote "
          f"{ORIENT_OUT}: {os.path.getsize(ORIENT_OUT)} bytes")

    # the oriented frontend at 3 levels on two photoreal frames
    fes = dataclasses.replace(golden_path_settings().MonoSettings.MonoCamera
                              .FeatureExtractorSettings, UseOrientation=True,
                              NumLevels=ORB_LEVELS)
    pin16 = make_pinhole(*photo_cam, W, H)
    for j, i in enumerate(ORB_FRAMES):
        feats = detect_and_compute(jnp.asarray(photo[i], jnp.float32), pin16, fes, 512)
        arrays.update(_feature_arrays(f"orb{j}_", feats))
    arrays["orb_frames"] = np.asarray(ORB_FRAMES, np.int32)

    # SpatialFeatureSelection: the session's first (init) frame's features
    s = _with_fes(golden_path_settings(), SpatialFeatureSelection=True)
    sess = SlamSession(s, cam=jnp.asarray(photo_cam), image_width=W, image_height=H)
    seen = []
    real = pipeline_mod.detect_and_compute

    def recording(image, cam, fes, max_features):
        out = real(image, cam, fes, max_features)
        seen.append((fes.SpatialFeatureSelection, out))
        return out

    pipeline_mod.detect_and_compute = recording
    try:
        sess.process_frame(photo[0], float(photo_ts[0]), 0)
    finally:
        pipeline_mod.detect_and_compute = real
    if seen[0][0]:
        raise RuntimeError("the JAX session extracted its first frame with the spatial "
                           "selection on")
    arrays.update(_feature_arrays("sfs_feat0_", seen[0][1]))
    _save(out_path, arrays)
    print(f"wrote {out_path}: {os.path.getsize(out_path)} bytes")


VI_OUT = os.path.join(REPO, "tests", "data", "torch_port_vi.npz")
VI_FRAMES = 80
VI_REPLAYS = ("FUSER3DOF", "FUSER6DOF")   # replayed on the recorded visual poses
EKF_FIELDS = ("q", "p", "v", "bg", "ba", "P")


def imu_digest(samples) -> np.bytes_:
    """SHA-256 of a sample stream: type, timestamp and data of each."""
    import hashlib

    h = hashlib.sha256()
    for s in samples:
        h.update(np.int32(int(s.type)).tobytes() + np.float64(s.timestamp).tobytes()
                 + np.asarray(s.data, np.float32).tobytes())
    return np.bytes_(h.hexdigest())


def _nan(shape) -> np.ndarray:
    return np.full(shape, np.nan, np.float32)


class FuserTrace:
    """Per frame of a fuser's run: its mode, metric scale and filter state
    after the frame, and the pose prior it gave before it (valid, R, t)."""

    def __init__(self, n: int):
        self.n = n
        self.arrays = {"mode": np.full(n, -1, np.int32), "metric_scale": _nan(n),
                       "prior_valid": np.zeros(n, bool), "prior_R": _nan((n, 3, 3)),
                       "prior_t": _nan((n, 3))}
        for f in EKF_FIELDS:
            self.arrays[f"ekf_{f}"] = None

    def prior(self, i: int, pose) -> None:
        if pose is not None:
            self.arrays["prior_valid"][i] = True
            self.arrays["prior_R"][i] = np.asarray(pose.R)
            self.arrays["prior_t"][i] = np.asarray(pose.t)

    def after(self, i: int, fuser) -> None:
        a = self.arrays
        a["mode"][i] = fuser.mode.value
        a["metric_scale"][i] = np.nan if fuser.metric_scale is None else fuser.metric_scale
        for f in EKF_FIELDS:
            v = np.asarray(getattr(fuser.state, f), np.float32)
            if a[f"ekf_{f}"] is None:
                a[f"ekf_{f}"] = np.full((self.n,) + v.shape, np.nan, np.float32)
            a[f"ekf_{f}"][i] = v


def vi_imu():
    from mageslam_tpu.apps.render_scene import trajectory_pose
    from mageslam_tpu.apps.vi_eval import synthesize_imu

    return synthesize_imu(trajectory_pose, VI_FRAMES, VI_FRAMES)


def replay_fuser(filter_type, imu, calls: dict, adopt_frame: int) -> dict:
    """A fresh JAX `Fuser` fed the VI session's samples frame by frame and
    its recorded `process_frame` arguments (`calls`: frame → (pose R, t or
    None, covariance or None)), told of the map at `adopt_frame`."""
    import jax.numpy as jnp

    from mageslam_tpu.fuser.fuser import Fuser
    from mageslam_tpu.geometry.se3 import Pose

    f = Fuser(filter_type=filter_type)
    trace = FuserTrace(VI_FRAMES)
    it = 0
    for i in range(VI_FRAMES):
        ts = i / 30.0
        while it < len(imu) and imu[it].timestamp <= ts:
            f.add_sample(imu[it])
            it += 1
        if i == adopt_frame:
            f.on_mage_initialized()
        if i in calls:
            R, t, cov = calls[i]
            trace.prior(i, f.pose_prior())
            f.process_frame(None if R is None else Pose(jnp.asarray(R), jnp.asarray(t)), ts,
                            pose_covariance=cov)
        trace.after(i, f)
    return trace.arrays


def live_queries(sess, prefix: str) -> dict:
    """The live session's GetTrackingResultsForFrames over every frame
    (NaN where None) and TryGetVolumeOfInterest."""
    got = sess.get_tracking_results_for_frames(range(VI_FRAMES))
    voi = sess.try_get_volume_of_interest()
    return {f"{prefix}live_has": np.asarray([m is not None for m in got]),
            f"{prefix}live_mats": np.stack([_nan((4, 4)) if m is None else np.asarray(m, np.float32)
                                            for m in got]),
            f"{prefix}live_voi_ok": np.bool_(voi is not None),
            f"{prefix}live_voi": np.stack(voi) if voi is not None else _nan((2, 3))}


def fossilized_answers(fm, prefix: str) -> dict:
    voi = fm.try_get_volume_of_interest()
    return {f"{prefix}fm_points": np.asarray(fm.map_points(denoised=True), np.float32),
            f"{prefix}fm_points_raw": np.asarray(fm.map_points(), np.float32),
            f"{prefix}fm_voi_ok": np.bool_(voi is not None),
            f"{prefix}fm_voi": np.stack(voi) if voi is not None else _nan((2, 3))}


def photoreal_end_state() -> dict:
    """tests/test_photoreal_ate.py's session (the photoreal fixture's run)
    after its 80 frames: its pose history, its live queries and its
    fossilized map's answers (`pr_*`); its map must equal the fixture's
    `final_map*`."""
    import jax.numpy as jnp

    from mageslam_tpu.config import golden_path_settings
    from mageslam_tpu.runtime import SlamSession
    from mageslam_tpu.runtime.fossilized import FossilizedMap

    with np.load(PHOTOREAL_OUT) as z:
        ref = {k: z[k] for k in z.files if k.startswith("final_map") or k in
               ("frames", "timestamps", "cam")}
    W, H = PHOTOREAL_SIZE
    sess = SlamSession(golden_path_settings(), cam=jnp.asarray(ref["cam"]),
                       image_width=W, image_height=H)
    for i, (img, ts) in enumerate(zip(ref["frames"], ref["timestamps"])):
        sess.process_frame(img.astype(np.float32), float(ts), i)
    for k, v in _flatten("final_map", sess.map).items():
        if not np.array_equal(v, ref[k]):
            raise SystemExit(f"the photoreal session's end map differs from the fixture at {k}")
    arrays = _flatten("pr_ph", sess.pose_history)
    arrays.update(live_queries(sess, "pr_"))
    arrays.update(fossilized_answers(FossilizedMap(sess.map, sess.pose_history, sess.fes),
                                     "pr_"))
    return arrays


def vi_session(filter_name: str, photo: dict, imu):
    """apps/vi_eval.py's run with `filter_name` on the photoreal fixture's
    frames: the session, its recorders' arrays (draws checked equal to
    the photoreal run's; the relocalizations' kept), its per-frame results,
    the fuser's trace, covariances and calls, and the map's masks after
    each mapping event."""
    import dataclasses

    import jax.numpy as jnp

    from mageslam_tpu.apps.render_scene import CX, CY, FX, FY
    from mageslam_tpu.config import FilterType, golden_path_settings
    from mageslam_tpu.runtime import SlamSession

    W, H = PHOTOREAL_SIZE
    s = golden_path_settings()
    s = dataclasses.replace(s, FuserSettings=dataclasses.replace(
        s.FuserSettings, UseFuser=True, FilterType=getattr(FilterType, filter_name)))
    sx, sy = W / 640.0, H / 480.0
    cam = np.asarray([FX * sx, FY * sy, CX * sx, CY * sy], np.float32)
    sess = SlamSession(s, cam=jnp.asarray(cam), image_width=W, image_height=H)
    rec, rrec = InitRecorder(sess), RelocRecorder(sess)
    events = []
    mapper = sess._insert_keyframe_and_map

    def recording_mapper(frame, frame_id):
        mapper(frame, frame_id)
        events.append((frame_id, {n: np.asarray(getattr(sess.map, n)) for n in EVENT_MASKS}))

    sess._insert_keyframe_and_map = recording_mapper
    trace = FuserTrace(VI_FRAMES)
    frame = [0]
    calls, covs = {}, {}
    real_prior, real_packed = sess._imu_prior, sess._estimate_cov_packed
    real_process, real_adopt = sess.fuser.process_frame, sess.fuser.on_mage_initialized
    adopted = []

    def imu_prior():
        pose, valid = real_prior()
        trace.prior(frame[0], pose if bool(valid) else None)
        return pose, valid

    def packed(res):
        out = real_packed(res)
        covs[frame[0]] = (out[:36].reshape(6, 6).copy(), bool(out[36] > 0))
        return out

    def process(visual_pose, timestamp, pose_covariance=None):
        calls[frame[0]] = (None, None, None) if visual_pose is None else (
            np.asarray(visual_pose.R, np.float32), np.asarray(visual_pose.t, np.float32),
            None if pose_covariance is None else np.asarray(pose_covariance, np.float32))
        return real_process(visual_pose, timestamp, pose_covariance=pose_covariance)

    def on_init():
        adopted.append(frame[0])
        return real_adopt()

    sess._imu_prior, sess._estimate_cov_packed = imu_prior, packed
    sess.fuser.process_frame, sess.fuser.on_mage_initialized = process, on_init
    it = 0
    try:
        for i in range(VI_FRAMES):
            frame[0] = i
            ts = float(photo["timestamps"][i])
            while it < len(imu) and imu[it].timestamp <= ts:
                sess.add_sensor_sample(imu[it])
                it += 1
            sess.process_frame(photo["frames"][i].astype(np.float32), ts, i)
            trace.after(i, sess.fuser)
    finally:
        rec.close()
        rrec.close()
        del sess._insert_keyframe_and_map, sess._imu_prior, sess._estimate_cov_packed
    arrays = {}
    # draws: the init, third-frame and vocabulary draws must be the
    # photoreal run's (the fuser does nothing before adoption); only the
    # relocalizations' are stored
    for k, v in rec.result().items():
        if k.endswith("_draws") and not np.array_equal(v, photo.get(k)):
            raise SystemExit(f"the {filter_name} session's {k} differ from the photoreal run's")
    arrays.update(rrec.result())
    arrays.update(session_refs(sess))
    arrays.update(trace.arrays)
    arrays["ev_frame_id"] = np.asarray([e[0] for e in events], np.int32)
    for j, (_, masks) in enumerate(events):
        arrays.update({f"ev{j}_{n}": v for n, v in masks.items()})
    arrays["adopt_frame"] = np.int32(adopted[0] if adopted else -1)
    arrays["map_scale"] = np.float32(sess.map_scale)
    arrays["cam"] = cam
    n = VI_FRAMES
    arrays["cov"], arrays["cov_ok"] = _nan((n, 6, 6)), np.full(n, -1, np.int32)
    for i, (c, ok) in covs.items():
        arrays["cov"][i], arrays["cov_ok"][i] = c, int(ok)
    arrays["call_has"] = np.zeros(n, bool)
    arrays["call_pose"] = np.zeros(n, bool)
    arrays["call_R"], arrays["call_t"], arrays["call_cov"] = (_nan((n, 3, 3)), _nan((n, 3)),
                                                              _nan((n, 6, 6)))
    for i, (R, t, c) in calls.items():
        arrays["call_has"][i] = True
        if R is not None:
            arrays["call_pose"][i], arrays["call_R"][i], arrays["call_t"][i] = True, R, t
        if c is not None:
            arrays["call_cov"][i] = c
    return sess, arrays, calls, adopted, rrec.detections


def vi_photo() -> dict:
    """The photoreal fixture, its frames checked to be apps/vi_eval.py's
    default sequence."""
    from mageslam_tpu.apps.render_scene import render_sequence

    W, H = PHOTOREAL_SIZE
    with np.load(PHOTOREAL_OUT) as z:
        photo = {k: z[k] for k in z.files}
    for i, (img, *_) in enumerate(render_sequence(VI_FRAMES, W, H)):
        if not np.array_equal(img, photo["frames"][i]):
            raise SystemExit(f"frame {i} of render_sequence({VI_FRAMES}, {W}, {H}) differs "
                             f"from the photoreal fixture's")
    return photo


def main_vi(out_path: str = VI_OUT) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    from mageslam_tpu.apps.evaluate import ate_rmse
    from mageslam_tpu.config import FilterType

    photo = vi_photo()
    imu = vi_imu()
    sess, arrays, calls, adopted, detections = vi_session("SIMPLE6DOF", photo, imu)
    arrays["imu_sha256"] = imu_digest(imu)
    arrays["imu_n"] = np.int32(len(imu))
    arrays.update(live_queries(sess, ""))
    ids, mats = sess.fossilize(global_ba_steps=None)
    arrays["fossil_ids"], arrays["fossil_mats"] = np.asarray(ids, np.int32), mats
    centers = np.asarray([-m[:3, :3].T @ m[:3, 3] for m in mats])
    ts_ids = photo["timestamps"][ids]
    rmse, n_ate = ate_rmse(ts_ids, centers, photo["timestamps"], photo["gt_c"])
    gt_seq = photo["gt_c"][ids]
    gt_path = float(np.linalg.norm(np.diff(gt_seq, axis=0), axis=1).sum())
    est_path = float(np.linalg.norm(np.diff(centers, axis=0), axis=1).sum())
    arrays["jax_ate"], arrays["jax_ate_n"] = np.float64(rmse), np.int32(n_ate)
    arrays["scale_true"] = np.float64(gt_path / max(est_path, 1e-12))
    arrays["final_metric_scale"] = np.float64(sess.fuser.metric_scale)
    arrays.update(fossilized_answers(sess.fossilize_map(None), ""))
    for name in VI_REPLAYS:
        arrays.update(_prefixed(f"rp_{name}_", replay_fuser(getattr(FilterType, name), imu,
                                                             calls, adopted[0])))
    arrays.update(photoreal_end_state())
    _save(out_path, arrays)
    modes = arrays["mode"]
    print(f"wrote {out_path}: {os.path.getsize(out_path)} bytes; adopted at {adopted[0]}; "
          f"modes {modes.tolist()}; metric scale {sess.fuser.metric_scale} (true "
          f"{float(arrays['scale_true']):.5f}); states {arrays['ref_state'].tolist()}; "
          f"keyframes {arrays['ref_frame_id'][arrays['ref_is_kf']].tolist()}; "
          f"{int(arrays['reloc_n'])} relocalizations; detections {detections}; "
          f"{len(ids)} fossilized poses, ATE {rmse:.6f} m over {n_ate}; priors on frames "
          f"{np.flatnonzero(arrays['prior_valid']).tolist()}; cov ok "
          f"{arrays['cov_ok'].tolist()}; replays "
          + "; ".join(f"{nm}: modes {arrays[f'rp_{nm}_mode'].tolist()} scale "
                      f"{arrays[f'rp_{nm}_metric_scale'][-1]}" for nm in VI_REPLAYS))


VI_FILTERS_OUT = os.path.join(REPO, "tests", "data", "torch_port_vi_filters.npz")
VI_FILTERS = (("f3_", "FUSER3DOF"), ("f6_", "FUSER6DOF"))


def main_vi_filters(out_path: str = VI_FILTERS_OUT) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    photo = vi_photo()
    imu = vi_imu()
    arrays = {"imu_sha256": imu_digest(imu), "imu_n": np.int32(len(imu))}
    lines = []
    for prefix, name in VI_FILTERS:
        sess, a, _, adopted, detections = vi_session(name, photo, imu)
        a["final_metric_scale"] = np.float64(np.nan if sess.fuser.metric_scale is None
                                             else sess.fuser.metric_scale)
        arrays.update(_prefixed(prefix, a))
        lines.append(f"{name}: adopted at {adopted}; modes {a['mode'].tolist()}; metric "
                     f"scale {sess.fuser.metric_scale}; states {a['ref_state'].tolist()}; "
                     f"keyframes {a['ref_frame_id'][a['ref_is_kf']].tolist()}; "
                     f"{int(a['reloc_n'])} relocalizations; detections {detections}; priors "
                     f"on frames {np.flatnonzero(a['prior_valid']).tolist()}; cov ok "
                     f"{a['cov_ok'].tolist()}")
    _save(out_path, arrays)
    print(f"wrote {out_path}: {os.path.getsize(out_path)} bytes")
    print("\n".join(lines))


INIT_CHECKS_OUT = os.path.join(REPO, "tests", "data", "torch_port_init_checks.npz")
SYNTHETIC_PAIRS = ("two_view", "pure_rotation", "unrelated")
SYNTHETIC_BATCH = 64


def main_init_checks(out_path: str = INIT_CHECKS_OUT) -> None:
    """The JAX side of two mono-init checks of the port's tests:
    tests/test_torch_map_init.py's synthetic pairs (`sp_draws`: the draws
    of PRNGKey(0) at 64 hypotheses; `sp_{case}_*`: `try_initialize_pair`'s
    result) and tests/test_torch_reloc.py's float-width check (`fw_*`: the
    reloc scene's attempt at frame 7 solved in float64 with its recorded
    draws widened, as that test did live)."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    from test_torch_map_init import synthetic_pair

    from mageslam_tpu.ba import problem as jax_problem
    from mageslam_tpu.tracking import map_init as jm

    arrays = {}
    key = jax.random.PRNGKey(0)
    for case in SYNTHETIC_PAIRS:
        xy1, desc1, xy2, desc2, K = synthetic_pair(case)
        n = xy1.shape[0]
        valid = np.ones(n, bool)
        # one key and one size: the three cases draw the same (64, 5, n)
        keys = jax.random.split(key, SYNTHETIC_BATCH)
        arrays["sp_draws"] = np.asarray(
            jax.vmap(lambda k: jax.random.gumbel(k, (5, n)))(keys), np.float32)
        r = jm.try_initialize_pair(jnp.asarray(xy1), jnp.asarray(desc1), jnp.asarray(valid),
                                   jnp.asarray(xy2), jnp.asarray(desc2), jnp.asarray(valid),
                                   jnp.asarray(K), key, jm.InitSettings(),
                                   ransac_batch=SYNTHETIC_BATCH)
        for name in ("succeeded", "match_count", "feat2", "point_valid"):
            arrays[f"sp_{case}_{name}"] = np.asarray(getattr(r, name))
        arrays[f"sp_{case}_R"], arrays[f"sp_{case}_t"] = (np.asarray(r.pose2.R),
                                                          np.asarray(r.pose2.t))

    with np.load(RELOC_OUT) as z:
        ref = {k: z[k] for k in z.files}
    att = {int(ref[f"init_att{j}_frame"]): f"init_att{j}_"
           for j in range(int(ref["init_n_attempt"]))}
    p = att[7]
    names = ("xy1", "desc1", "valid1", "xy2", "desc2", "valid2")
    gumbel, from_problem = jax.random.gumbel, jax_problem.BAState.from_problem

    def state64(problem, user_lambda=-1.0):   # the reference pins lambda to float32
        f = problem.points.dtype
        return jax_problem.BAState(poses=problem.poses, points=problem.points,
                                   lam=jnp.asarray(user_lambda, f), ni=jnp.asarray(2.0, f),
                                   obs_info=problem.obs_info)

    from mageslam_tpu_torch import golden_path_settings as port_settings
    from mageslam_tpu_torch.tracking.map_init import init_settings

    settings = jm.InitSettings(*init_settings(port_settings()))   # as the test built them
    with jax.enable_x64(True):
        # the recorded float32 draws, widened: the same samples
        jax.random.gumbel = lambda key, shape, dtype=None: gumbel(
            key, shape, jnp.float32).astype(jnp.float64)
        jax_problem.BAState.from_problem = staticmethod(state64)
        try:
            args = [jnp.asarray(ref[p + n].astype(np.float64) if ref[p + n].dtype == np.float32
                                else ref[p + n]) for n in names]
            out = jm.try_initialize_pair(
                *args, jnp.asarray(ref["cam"].astype(np.float64)), jnp.asarray(ref[p + "key"]),
                settings, ransac_batch=ref[p + "draws"].shape[0])
            arrays["fw_dtype"] = np.bytes_(str(out.points.dtype))
            arrays["fw_succeeded"] = np.asarray(out.succeeded)
            arrays["fw_points"] = np.int32(np.asarray(out.point_valid).sum())
        finally:
            jax.random.gumbel = gumbel
            jax_problem.BAState.from_problem = staticmethod(from_problem)
    _save(out_path, arrays)
    print(f"wrote {out_path}: {os.path.getsize(out_path)} bytes; synthetic pairs succeeded "
          f"{[bool(arrays[f'sp_{c}_succeeded']) for c in SYNTHETIC_PAIRS]}; float64 attempt "
          f"at frame 7: {bool(arrays['fw_succeeded'])}, {int(arrays['fw_points'])} points")


LEVELS_OUT = os.path.join(REPO, "tests", "data", "torch_port_levels.npz")
LEVELS_RELOC_OUT = os.path.join(REPO, "tests", "data", "torch_port_levels_reloc.npz")
LEVELS_EVENTS = 3     # keyframes mapped in the session's window
LEVELS = 3
# the frontend's references: (name, image source, crop)
LEVELS_FRONTENDS = (("bench640", "bench", None), ("bench160", "bench", (180, 300, 240, 400)),
                    ("photo320", "photo", None))


def levels_settings():
    from mageslam_tpu.config import golden_path_settings

    return _with_fes(golden_path_settings(), NumLevels=LEVELS, ScaleFactor=1.5)


def octave_hist(feats, assoc) -> np.ndarray:
    """(LEVELS,) counts of the frame's valid keypoints with a map point,
    by octave."""
    use = np.asarray(feats.valid) & (np.asarray(assoc) >= 0)
    return np.bincount(np.asarray(feats.octave)[use], minlength=LEVELS).astype(np.int32)


def levels_session(sess, feed, stop=lambda rec: False, after=lambda i: None) -> dict:
    """Run `feed` (an iterator of (features, timestamp, frame id)) through
    `sess` under a `SessionRecorder` until `stop(recorder)`, calling
    `after(frame id)` after each frame: the recorder's arrays plus each
    frame's associations (-1 where it was not tracked) and octave
    histogram."""
    rec = SessionRecorder(sess)
    assoc, hist = [], []
    try:
        for feats, ts, fid in feed:
            sess.process_features(feats, ts, fid)
            r = sess.results[-1]
            row = np.asarray(sess.history.assoc[0])
            tracked = r.pose is not None and r.tracked_count > 0
            assoc.append(row if tracked else np.full_like(row, -1))
            hist.append(octave_hist(feats, assoc[-1]))
            after(fid)
            if stop(rec):
                break
    finally:
        arrays = rec.close()
    arrays["ref_assoc"] = np.asarray(assoc, np.int32)
    arrays["ref_octave_hist"] = np.asarray(hist, np.int32)
    return arrays


def levels_frames(sess, frames):
    """(features, timestamp, frame id) of each bench frame, as
    `process_frame` extracts them."""
    import jax.numpy as jnp

    from mageslam_tpu.ops.frontend import detect_and_compute

    for i, img in enumerate(frames):
        fes = sess.fes if sess.initialized else sess._fes_boot
        yield (detect_and_compute(jnp.asarray(img, jnp.float32), sess.cam16, fes, sess.N),
               i * DT, i)


def levels_images(bench_frame: np.ndarray) -> dict:
    """Bench frame 31, its 160x120 crop and photoreal frame 10, float32, by
    name (`LEVELS_FRONTENDS`)."""
    with np.load(PHOTOREAL_OUT) as z:
        photo = z["frames"][10]
    out = {}
    for name, source, crop in LEVELS_FRONTENDS:
        img = (bench_frame if source == "bench" else photo).astype(np.float32)
        if crop is not None:
            img = img[crop[0]:crop[1], crop[2]:crop[3]]
        out[name] = np.ascontiguousarray(img)
    return out


def levels_frontend_arrays(images: dict) -> dict:
    """`detect_and_compute` at three levels (cam 0.82 w, centred) on each of
    `levels_images` (`fe_{name}_*`)."""
    import jax.numpy as jnp

    from mageslam_tpu.geometry.camera import make_pinhole
    from mageslam_tpu.ops.frontend import detect_and_compute

    fes = levels_settings().MonoSettings.MonoCamera.FeatureExtractorSettings
    arrays = {}
    for name, img in images.items():
        h, w = img.shape
        cam = np.asarray([0.82 * w, 0.82 * w, w / 2.0, h / 2.0], np.float32)
        feats = detect_and_compute(jnp.asarray(img), make_pinhole(*cam.tolist(), w, h), fes, 512)
        arrays.update(_feature_arrays(f"fe_{name}_", feats))
        arrays[f"fe_{name}_cam"] = cam
    return arrays


# features_per_level's cases: (features, levels, scale)
LEVELS_BUDGETS = ((440, 3, 1.5), (512, 3, 1.5), (1000, 8, 1.2), (440, 1, 1.5))


def octave_boundary_cases(scale: float = 1.5) -> tuple[np.ndarray, np.ndarray]:
    """(distance, dmin) pairs whose ratio lies on a rounding boundary of
    `predict_octave` (scale^(k+1)) or midway between two (scale^(k+1/2)),
    each with the 40 float32 neighbours on either side."""
    dist, dmin = [], []
    for k in range(-4, 6):
        for base in (scale ** (k + 1), scale ** (k + 0.5)):
            for d0 in (0.3, 1.0, 2.7, 13.0):
                c = np.float32(d0 * base)
                for direction in (np.float32(np.inf), np.float32(0)):
                    v = c
                    for _ in range(41):
                        dist.append(v)
                        dmin.append(np.float32(d0))
                        v = np.nextafter(v, direction)
    return np.asarray(dist, np.float32), np.asarray(dmin, np.float32)


def levels_reference_arrays(images: dict) -> dict:
    """The JAX package's answers at three levels, scale 1.5, for the
    port's exact checks, with what produced them: the pyramid's levels 1.. of
    each of `images` (`pyr_{name}_{level}`); `predict_octave` jitted on
    `octave_boundary_cases` (`oct_*`); `compute_dmin_dmax` jitted on those
    distances with octaves 0, 1, 2 in turn (`dmm_*`); `features_per_level`
    on `LEVELS_BUDGETS` (`fpl{j}`); the jax and jaxlib versions, the
    machine and numpy's list of the CPU's features (`jax_version`,
    `jaxlib_version`, `machine`, `cpu_features`): XLA:CPU's code, and with
    it the last bits of the pyramid, follows the build and the ISA."""
    import platform

    import jax
    import jax.numpy as jnp
    import jaxlib
    from numpy._core._multiarray_umath import __cpu_features__

    from mageslam_tpu.ops import image
    from mageslam_tpu.worldmap import map_state

    arrays = {}
    for name, img in images.items():
        for lv, level in enumerate(image.build_pyramid(jnp.asarray(img), LEVELS, 1.5)[1:], 1):
            arrays[f"pyr_{name}_{lv}"] = np.asarray(level)
    dist, dmin = octave_boundary_cases()
    arrays.update(oct_dist=dist, oct_dmin=dmin, oct_want=np.asarray(
        jax.jit(map_state.predict_octave, static_argnums=2)(jnp.asarray(dist),
                                                            jnp.asarray(dmin), 1.5)))
    octave = np.arange(len(dist), dtype=np.int32) % LEVELS
    lo, hi = jax.jit(map_state.compute_dmin_dmax, static_argnums=(2, 3))(
        jnp.asarray(dist), jnp.asarray(octave), LEVELS, 1.5)
    arrays.update(dmm_octave=octave, dmm_dmin=np.asarray(lo), dmm_dmax=np.asarray(hi))
    for j, case in enumerate(LEVELS_BUDGETS):
        arrays[f"fpl{j}_args"] = np.asarray(case, np.float64)
        arrays[f"fpl{j}"] = np.asarray(image.features_per_level(*case), np.int32)
    arrays.update(jax_version=np.bytes_(jax.__version__),
                  jaxlib_version=np.bytes_(jaxlib.__version__),
                  machine=np.bytes_(platform.machine()),
                  cpu_features=np.bytes_(" ".join(sorted(k for k, v in __cpu_features__.items()
                                                         if v))))
    return arrays


def main_levels(out_path: str = LEVELS_OUT, reloc_path: str = LEVELS_RELOC_OUT) -> None:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    from test_bow_reloc import rand_desc
    from test_pipeline import CAM as RCAM, H as RH, W as RW
    from test_pipeline import frame_features, make_world, pose_at

    from mageslam_tpu.ops.frontend import FrameFeatures
    from mageslam_tpu.runtime import SlamSession

    sess = SlamSession(levels_settings(), cam=jnp.asarray(CAM, jnp.float32),
                       image_width=640, image_height=480)
    frames = bench_frames(MAP_MAX_FRAME)
    tail = []

    def stop(rec):
        if len(rec.events) >= LEVELS_EVENTS:
            tail.append(1)
        return len(tail) > MAP_TAIL

    arrays = levels_session(sess, levels_frames(sess, frames), stop)
    if len(arrays["ev_frame_id"]) < LEVELS_EVENTS:
        raise SystemExit(f"only {len(arrays['ev_frame_id'])} mapping events by frame "
                         f"{MAP_MAX_FRAME}")
    images = levels_images(frames[31])
    arrays.update(levels_frontend_arrays(images))
    arrays.update(levels_reference_arrays(images))
    _save(out_path, arrays)
    lost = [j for j in range(int(arrays["reloc_n"])) if arrays[f"reloc{j}_where"] == b"lost"]
    outputs = [(out_path, arrays)]
    if not lost:
        # tests/test_bow_reloc.py's lost-and-relocalize scene (as `main_reloc`
        # drives it), each point at an octave of its own as
        # tests/test_pipeline.py's three-level test gives them, with the
        # session's snapshot after RELOC_SNAP_FRAME as the file's own keys
        rng = np.random.RandomState(0)
        pts, descs = make_world(rng)
        pt_oct = np.random.RandomState(99).randint(0, LEVELS, len(pts))
        rsess = SlamSession(levels_settings(), cam=RCAM, image_width=int(RW),
                            image_height=int(RH))
        n = rsess.N
        stored: dict = {}

        def with_octaves(feats, pose):
            # frame_features packs the visible points in order
            Xc = np.array(pose.transform(jnp.array(pts)))
            uv = np.stack([float(RCAM[0]) * Xc[:, 0] / Xc[:, 2] + float(RCAM[2]),
                           float(RCAM[1]) * Xc[:, 1] / Xc[:, 2] + float(RCAM[3])], 1)
            vis = (Xc[:, 2] > 0.5) & (uv[:, 0] > 10) & (uv[:, 0] < RW - 10) \
                & (uv[:, 1] > 10) & (uv[:, 1] < RH - 10)
            idx = np.where(vis)[0][:n]
            octv = np.zeros(n, np.int32)
            octv[:len(idx)] = pt_oct[idx]
            return feats._replace(octave=jnp.asarray(octv))

        def feed():
            for i in range(38):
                if 30 <= i < 35:
                    xy = jnp.array(rng.uniform(20, 300, (n, 2)), jnp.float32)
                    feats = FrameFeatures(
                        xy=xy, und_xy=xy, response=jnp.full((n,), 10.0),
                        octave=jnp.asarray(rng.randint(0, LEVELS, n), jnp.int32),
                        angle=jnp.zeros((n,), jnp.float32), desc=rand_desc(rng, n),
                        valid=jnp.ones((n,), bool))
                else:
                    pose = pose_at(min(i, 29) * 0.033)
                    feats = with_octaves(frame_features(pts, descs, pose, n, rng), pose)
                if i > RELOC_SNAP_FRAME:
                    stored.update(_feature_arrays(f"feat{i}_", feats))
                yield feats, i * 0.033, i

        def snapshot(fid):
            if fid == RELOC_SNAP_FRAME:
                stored.update(_snapshot_arrays(rsess))

        rl = levels_session(rsess, feed(), after=snapshot)
        rl = {k: v for k, v in rl.items() if k.startswith(("ref_", "reloc", "det_", "ev"))
              or k == "map_scale"}
        rl.update(stored)
        rl["cam"] = np.asarray(RCAM, np.float32)
        rl["size"] = np.asarray([RW, RH], np.int32)
        rl["n_frames"] = np.int32(38)
        _save(reloc_path, rl)
        outputs.append((reloc_path, rl))
    for path, a in outputs:
        print(f"wrote {path}: {os.path.getsize(path)} bytes; states {a['ref_state'].tolist()}; "
              f"keyframes {a['ref_frame_id'][a['ref_is_kf']].tolist()}; events "
              f"{a['ev_frame_id'].tolist()}; tracked {a['ref_tracked'].tolist()}; "
              f"relocalizations "
              f"{[(int(a[f'reloc{j}_frame']), a[f'reloc{j}_where'].decode()) for j in range(int(a['reloc_n']))]}; "
              f"octaves {a['ref_octave_hist'].sum(0).tolist()}; map scale {float(a['map_scale'])}")


STREAM_OUT = os.path.join(REPO, "tests", "data", "torch_port_stream.npz")
STREAM_CALLS = (("s95", "stream", 95), ("s71", "stream", 71), ("p58", "pipelined", 58))
STREAM_CHUNK, STREAM_DEPTH = 8, 4
DET_STATS = ("deferred", "resolved", "stale_slot", "closed", "requeued", "same_loop_dropped")


def bench_settings():
    """bench.py's settings: golden with LoopClosureSettings.MinKeyframe 3."""
    import dataclasses

    from mageslam_tpu.config import golden_path_settings

    s = golden_path_settings()
    return dataclasses.replace(s, LoopClosureSettings=dataclasses.replace(
        s.LoopClosureSettings, MinKeyframe=3))


class StreamRelocRecorder(RelocRecorder):
    """`RelocRecorder` that also records the re-detections the deferred
    resolution runs (`_get_kf_redetect_core`)."""

    def __init__(self, sess):
        super().__init__(sess)
        self._real_redetect = sess._get_kf_redetect_core
        sess._get_kf_redetect_core = self._get_redetect

    def close(self) -> None:
        super().close()
        del self.sess._get_kf_redetect_core

    def _get_redetect(self):
        import jax

        core = self._real_redetect()

        def wrapped(map_state, bow, frame, ki, fid, key):
            out = core(map_state, bow, frame, ki, fid, key)
            live, qualifies, size = detection_gate(self.sess.settings, map_state, bow,
                                                   frame, int(ki))
            self.detections.append((int(fid), int(ki), live, qualifies, size,
                                    bool(out[0].detected)))
            if qualifies:
                self._record(jax.random.split(key)[1], frame, "redetect")
            return out

        return wrapped


def record_mapping_events(sess) -> list:
    """Records the map's masks right after every mapping step of `sess`, the
    host one (`_mapping_core`) and the one the stream cores embed
    (`_mapping_fn`, through a debug callback: a stream core built once keeps
    it), into a new list it returns: (frame id, slot, masks) tuples."""
    import jax

    sess._event_sink = events = []
    if getattr(sess, "_events_recorded", False):
        return events
    sess._events_recorded = True
    real_core, real_fn = sess._mapping_core, sess._mapping_fn

    def host_core(map_state, pose_history, frame, map_scale):
        out = real_core(map_state, pose_history, frame, map_scale)
        sess._event_sink.append((int(frame.frame_id), int(out[2]), {
            n: np.asarray(getattr(out[0], n)) for n in EVENT_MASKS}))
        return out

    def keep(fid, ki, *masks):
        sess._event_sink.append((int(fid), int(ki),
                                 dict(zip(EVENT_MASKS, map(np.asarray, masks)))))

    def scan_fn(map_state, pose_history, frame, map_scale):
        out = real_fn(map_state, pose_history, frame, map_scale)
        jax.debug.callback(keep, frame.frame_id, out[2],
                           *[getattr(out[0], n) for n in EVENT_MASKS])
        return out

    sess._mapping_core, sess._mapping_fn = host_core, scan_fn
    return events


def stream_call(sess, bank, kind: str, last: int) -> dict:
    """One call of the stream or pipelined entry point over frames
    SNAP_FRAME+1..last and what it recorded."""
    import jax

    n0 = len(sess.results)
    events = record_mapping_events(sess)
    rrec = StreamRelocRecorder(sess)
    try:
        T = bank.shape[0]
        ts, ids = [i * DT for i in range(T)], list(range(T))
        if kind == "stream":
            sess.process_frame_stream(bank, ts, ids, start=SNAP_FRAME + 1, stop=last + 1,
                                      chunk=STREAM_CHUNK)
            sess.flush_chunks()
        else:
            for i in range(SNAP_FRAME + 1, last + 1):
                sess.process_frame_pipelined(bank[i], i * DT, i)
            sess.flush()
        jax.effects_barrier()
    finally:
        rrec.close()
    arrays = {k: v[n0:] for k, v in session_refs(sess).items()}
    if arrays["ref_frame_id"].tolist() != list(range(SNAP_FRAME + 1, last + 1)):
        raise RuntimeError(f"{kind} results out of order: {arrays['ref_frame_id'].tolist()}")
    events.sort(key=lambda e: e[0])
    arrays["ev_frame_id"] = np.asarray([e[0] for e in events], np.int32)
    arrays["ev_ki"] = np.asarray([e[1] for e in events], np.int32)
    for j, (_, _, masks) in enumerate(events):
        arrays.update({f"ev{j}_{n}": v for n, v in masks.items()})
    arrays["det_stats"] = np.asarray([sess.loop_det_stats[k] for k in DET_STATS], np.int32)
    arrays["n_loops_closed"] = np.int32(sess.n_loops_closed)
    arrays.update(_flatten("bow", sess.bow))
    arrays.update(rrec.result())
    return arrays


def deferred_resolution_arrays() -> dict:
    """tests/test_stream_loop_closure.py::test_deferred_resolution_guards_and_requeue
    as the port's twin needs it: the scene, both keyframes with the draws of
    their detections, and what the JAX session's resolution did."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    sys.path[:0] = [os.path.join(REPO, "tests")]
    from test_loop_closure import CAM as LCAM
    from test_loop_closure import K_CAP, N_CAP, P_CAP, build_drifted_map

    from mageslam_tpu.config import Budgets, MageSlamSettings
    from mageslam_tpu.runtime import SlamSession
    from mageslam_tpu.runtime.loop_closure import detect_loop
    from mageslam_tpu.tracking.frame_state import TrackedFrame

    m, bow, frames, _, _, n_pts = build_drifted_map(np.random.RandomState(0))
    s = MageSlamSettings()
    s = dataclasses.replace(
        s, LoopClosureSettings=dataclasses.replace(
            s.LoopClosureSettings, EnableLoopClosure=True, MinKeyframe=5, MinClusterSize=2),
        Budgets=Budgets(MaxFeatures=N_CAP, MaxKeyframes=K_CAP, MaxMapPoints=P_CAP))
    sess = SlamSession(s, cam=LCAM, image_width=320, image_height=180)
    sess.map, sess.bow, sess.initialized = m, bow, True
    sess._global_ba = lambda *a, **k: 0.0

    def tracked(i, fid):
        xy, d, valid, assoc, pose = frames[i]
        return TrackedFrame(pose=pose, cam=LCAM, kp_xy=xy,
                            kp_octave=jnp.zeros((N_CAP,), jnp.int32), desc=d,
                            kp_valid=valid, assoc=assoc, timestamp=np.float32(0.1 * i),
                            frame_id=np.int32(fid))

    kw = dict(min_keyframes=5, min_cluster_size=2)
    frame5, frame4 = tracked(5, 12), tracked(4, 11)
    det5 = detect_loop(m, bow, frame5, jnp.int32(5), jax.random.PRNGKey(3), **kw)
    det4 = detect_loop(m, bow, frame4, jnp.int32(4), jax.random.PRNGKey(4), **kw)
    det4_distinct = det4._replace(
        cluster_mask=jnp.zeros_like(det4.cluster_mask).at[9].set(True))
    rrec = StreamRelocRecorder(sess)
    try:
        sess._pending_loop_dets = [(det5, frame5, 5, 999), (det5, frame5, 5, 12),
                                   (det4, frame4, 4, 11), (det4_distinct, frame4, 4, 11)]
        sess._resolve_loop_dets()
        requeued = [(int(k), int(f), bool(d.detected)) for d, _, k, f in sess._pending_loop_dets]
        sess._resolve_loop_dets()
    finally:
        rrec.close()
    arrays = {**_flatten("dr_map", m), **_flatten("dr_bow", bow),
              **_flatten("dr_frame5", frame5), **_flatten("dr_frame4", frame4)}
    arrays["dr_det5_draws"] = reloc_draws(jax.random.PRNGKey(3), 4, N_CAP)
    arrays["dr_det4_draws"] = reloc_draws(jax.random.PRNGKey(4), 4, N_CAP)
    for name, det in (("det5", det5), ("det4", det4)):
        arrays[f"dr_{name}_detected"] = np.asarray(det.detected)
        arrays[f"dr_{name}_cluster_mask"] = np.asarray(det.cluster_mask)
    arrays["dr_requeued"] = np.asarray(requeued, np.int32).reshape(-1, 3)
    arrays["dr_det_stats"] = np.asarray([sess.loop_det_stats[k] for k in DET_STATS], np.int32)
    arrays["dr_n_loops_closed"] = np.int32(sess.n_loops_closed)
    arrays["dr_post_kf_assoc"] = np.asarray(sess.map.kf_assoc)
    arrays["dr_n_pts"] = np.int32(n_pts)
    arrays.update({f"dr_{k}": v for k, v in rrec.result().items()})
    return arrays


def main_stream(out_path: str = STREAM_OUT) -> None:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    from mageslam_tpu.runtime import SlamSession

    last = max(c[2] for c in STREAM_CALLS)
    frames = bench_frames(last + 1)
    sess = SlamSession(bench_settings(), cam=jnp.asarray(CAM, jnp.float32),
                       image_width=640, image_height=480)
    for i in range(SNAP_FRAME + 1):
        sess.process_frame(frames[i], i * DT, i)
    arrays = _snapshot_arrays(sess)
    with np.load(DEFAULT_OUT) as z:
        differs = [k for k in arrays if k != "meta_json" and (
            k not in z.files or z[k].shape != arrays[k].shape
            or not np.array_equal(z[k], arrays[k]))]
        meta_same = bytes(z["meta_json"]) == bytes(arrays["meta_json"])
    arrays["f30_differs"] = np.bytes_(" ".join(differs + ([] if meta_same else ["meta_json"])))
    arrays["ref_frames_until"] = np.int32(SNAP_FRAME)
    sess._chunk_pipeline_depth = STREAM_DEPTH
    bank = jnp.asarray(np.stack(frames))
    snap = sess.snapshot_state()
    summary = []
    for prefix, kind, stop in STREAM_CALLS:
        sess.restore_state(snap)
        sess.loop_det_stats = dict.fromkeys(DET_STATS, 0)
        sess.n_loops_closed = 0
        call = stream_call(sess, bank, kind, stop)
        arrays.update(_prefixed(prefix + "_", call))
        summary.append(f"{prefix}: keyframes {call['ref_frame_id'][call['ref_is_kf']].tolist()}, "
                       f"states {sorted(set(call['ref_state'].tolist()))}, events "
                       f"{call['ev_frame_id'].tolist()} in slots {call['ev_ki'].tolist()}, "
                       f"det_stats {call['det_stats'].tolist()}, "
                       f"{int(call['reloc_n'])} relocalizations")
    arrays.update(deferred_resolution_arrays())
    _save(out_path, arrays)
    print(f"wrote {out_path}: {os.path.getsize(out_path)} bytes; frame-30 leaves that "
          f"differ from {os.path.basename(DEFAULT_OUT)}: {differs or 'none'}"
          f"{'' if meta_same else ' and meta_json'}; " + "; ".join(summary)
          + f"; deferred scene det_stats {arrays['dr_det_stats'].tolist()}")


DIAG_OUT = os.path.join(REPO, "tests", "data", "torch_port_diag.npz")
PH_LAST = 7                  # the photoreal window 0..7: init, adoption, two keyframes
DIGEST_FRAMES = (54, 60, 94)   # 54 and 94 are keyframes of the stream call
# the small bag-of-words cut: views per room, query stride, tolerance
BOW_CUT = dict(views_per_room=8, query_stride=4, tol=2)


def _checkpoints(det, start: int) -> tuple[np.ndarray, np.ndarray]:
    names = [n for n, _ in det._stream[start:]]
    return (np.asarray(names, dtype=np.bytes_),
            np.asarray([h for _, h in det._stream[start:]], np.uint32))


def diag_stream_arrays() -> dict:
    """The Determinator streams, summaries and digest inputs (see `diag`)."""
    import jax
    import jax.numpy as jnp

    from mageslam_tpu.diagnostics import Determinator
    from mageslam_tpu.runtime import SlamSession

    frames = bench_frames(96)
    det = Determinator()
    sess = SlamSession(bench_settings(), cam=jnp.asarray(CAM, jnp.float32),
                       image_width=640, image_height=480, determinator=det)
    for i in range(SNAP_FRAME + 1):
        sess.process_frame(frames[i], i * DT, i)
    arrays = _snapshot_arrays(sess)
    with np.load(STREAM_OUT) as z:
        differs = [k for k in arrays if k != "meta_json" and not np.array_equal(z[k], arrays[k])]
    if differs:
        raise RuntimeError(f"the session after frame {SNAP_FRAME} differs from "
                           f"{os.path.basename(STREAM_OUT)}'s snapshot: {differs}")
    sess._chunk_pipeline_depth = STREAM_DEPTH
    out: dict = {}

    feeds: dict = {}
    real_body = sess._scan_frame_body

    def keep(fid, mp_pos, kf_t, mp_valid, kf_valid, fsk, digest):
        if int(fid) in DIGEST_FRAMES:
            feeds[int(fid)] = [np.asarray(a) for a in
                               (mp_pos, kf_t, mp_valid, kf_valid, fsk, digest)]

    def body(carry, image, timestamp, frame_id, map_scale):
        carry2, outs = real_body(carry, image, timestamp, frame_id, map_scale)
        m, fsk = carry2[0], carry2[3]
        jax.debug.callback(keep, frame_id, m.mp_pos, m.kf_pose.t, m.mp_valid, m.kf_valid,
                           fsk, outs[-1])
        return carry2, outs

    sess._scan_frame_body = body
    events = record_mapping_events(sess)
    summaries = []
    real_check = det.check

    def check(name, *trees):
        if name == "Stream.Chunk":
            summaries.append(np.asarray(trees[0]))
        real_check(name, *trees)

    det.check = check
    n0 = len(det._stream)
    bank = jnp.asarray(np.stack(frames))
    sess.process_frame_stream(bank, [i * DT for i in range(96)], list(range(96)),
                              start=SNAP_FRAME + 1, stop=96, chunk=STREAM_CHUNK)
    sess.flush_chunks()
    jax.effects_barrier()
    det.check = real_check
    out["st_names"], out["st_hashes"] = _checkpoints(det, n0)
    out["st_summary"] = np.stack(summaries).astype(np.float32)
    out["st_is_kf"] = np.asarray([r.is_keyframe for r in sess.results[-(95 - SNAP_FRAME):]])
    events.sort(key=lambda e: e[0])
    out["st_map_frame"] = np.asarray([e[0] for e in events], np.int32)
    hashes = []
    for _, _, masks in events:
        d = Determinator()
        d.check("Mapping.Map", masks["kf_valid"], masks["mp_valid"], masks["kf_assoc"])
        hashes.append(d._stream[0][1])
    out["st_map_hash"] = np.asarray(hashes, np.uint32)
    if sorted(feeds) != sorted(DIGEST_FRAMES):
        raise RuntimeError(f"digest inputs kept at {sorted(feeds)}, not {DIGEST_FRAMES}")
    for j, fid in enumerate(DIGEST_FRAMES):
        for name, a in zip(("mp_pos", "kf_t", "mp_valid", "kf_valid", "fsk", "digest"),
                           feeds[fid]):
            out[f"dg{j}_{name}"] = a
        out[f"dg{j}_frame"] = np.int32(fid)
    out["dg_frames"] = np.asarray(DIGEST_FRAMES, np.int32)
    print(f"diag stream: {len(out['st_names'])} checkpoints "
          f"({sorted(set(out['st_names'].tolist()))}), mapping "
          f"events at {out['st_map_frame'].tolist()}, digests "
          f"{[float(feeds[f][5]) for f in DIGEST_FRAMES]}")
    return out


def diag_photoreal_arrays() -> dict:
    """The photoreal session over frames 0..PH_LAST with a Determinator."""
    import jax.numpy as jnp

    from mageslam_tpu.config import golden_path_settings
    from mageslam_tpu.diagnostics import Determinator
    from mageslam_tpu.runtime import SlamSession

    with np.load(PHOTOREAL_OUT) as z:
        frames, ts, cam = z["frames"], z["timestamps"], z["cam"]
    det = Determinator()
    sess = SlamSession(golden_path_settings(), cam=jnp.asarray(cam),
                       image_width=PHOTOREAL_SIZE[0], image_height=PHOTOREAL_SIZE[1],
                       determinator=det)
    for i in range(PH_LAST + 1):
        sess.process_frame(frames[i].astype(np.float32), float(ts[i]), i)
    out = {}
    out["ph_names"], out["ph_hashes"] = _checkpoints(det, 0)
    out["ph_is_kf"] = np.asarray([r.is_keyframe for r in sess.results])
    print(f"diag photoreal: frames 0-{PH_LAST}, {len(out['ph_names'])} checkpoints, keyframes "
          f"{np.flatnonzero(out['ph_is_kf']).tolist()}")
    return out


def loop_session_settings():
    """The loop scene's session settings: golden with loop closure on,
    MinKeyframe 5, MinClusterSize 2 and the scene's bank sizes."""
    import dataclasses

    sys.path[:0] = [os.path.join(REPO, "tests")]
    from test_loop_closure import K_CAP, N_CAP, P_CAP

    from mageslam_tpu.config import Budgets, golden_path_settings

    s = golden_path_settings()
    return dataclasses.replace(
        s, LoopClosureSettings=dataclasses.replace(
            s.LoopClosureSettings, EnableLoopClosure=True, MinKeyframe=5, MinClusterSize=2),
        Budgets=Budgets(MaxFeatures=N_CAP, MaxKeyframes=K_CAP, MaxMapPoints=P_CAP))


def diag_xray_arrays() -> dict:
    """One closure on scene `a` with an XRay attached (see `diag`)."""
    import jax
    import jax.numpy as jnp

    sys.path[:0] = [os.path.join(REPO, "tests")]
    from test_loop_closure import CAM as LCAM
    from test_loop_closure import N_CAP

    from mageslam_tpu.bow.index import BowIndex
    from mageslam_tpu.diagnostics import XRay
    from mageslam_tpu.geometry.se3 import Pose
    from mageslam_tpu.runtime import SlamSession
    from mageslam_tpu.tracking.frame_state import TrackedFrame
    from mageslam_tpu.worldmap.map_state import MapState

    with np.load(LOOP_OUT) as z:
        ref = {k: z[k] for k in z.files}

    def unflat(template, prefix):
        leaves, treedef = jax.tree.flatten(template)
        return jax.tree.unflatten(treedef, [jnp.asarray(ref[f"{prefix}{i}"])
                                            for i in range(len(leaves))])

    from mageslam_tpu.bow.index import empty_index
    from mageslam_tpu.worldmap import empty_map
    K, P, N = (int(v) for v in ref["capacity"])
    m = unflat(empty_map(K, P, N), "a_map")
    bow = unflat(empty_index(K), "a_bow")
    f = unflat(TrackedFrame(pose=Pose(0, 0), cam=0, kp_xy=0, kp_octave=0, desc=0, kp_valid=0,
                            assoc=0, timestamp=0, frame_id=0), "a_frame")
    assert isinstance(m, MapState) and isinstance(bow, BowIndex)
    with tempfile.TemporaryDirectory() as tmp:
        sess = SlamSession(loop_session_settings(), cam=LCAM, image_width=320,
                           image_height=180, xray=XRay(tmp))
        sess.map, sess.bow, sess.initialized, sess.last_kf_slot = m, bow, True, 5
        sess.key = jax.random.PRNGKey(3)
        _, sub = jax.random.split(sess.key)
        closed = sess._post_keyframe(f, 5, int(f.frame_id))
        files = sorted(os.listdir(tmp))
        if not closed or [x.split("_", 1)[1] for x in files] != [
                "LoopClosure.Detect.json", "GlobalBA.json"]:
            raise RuntimeError(f"scene a closed {closed}, captures {files}")
        out = {}
        for name, key in zip(files, ("xr_detect_json", "xr_gba_json")):
            with open(os.path.join(tmp, name), "rb") as fh:
                out[key] = np.bytes_(fh.read())
    out["xr_draws"] = reloc_draws(sub, 4, N_CAP)
    print(f"diag xray: captures {files}, {[len(out[k]) for k in ('xr_detect_json', 'xr_gba_json')]}"
          f" bytes")
    return out


def bow_eval_arrays(prefix: str, views_per_room: int = 70, query_stride: int = 6,
                    tol: int = 5, keep_desc: bool = False, seeds=(7, 21, 42)) -> dict:
    """apps/bow_eval.py's `run_bow_scale_eval` at 320x180 and 64 words, with
    what it does not return: each vocabulary's draws and each query's top-4
    keyframes (and, with `keep_desc`, every descriptor)."""
    import time

    import jax
    import jax.numpy as jnp

    from mageslam_tpu.apps.render_scene import (CX, CY, FX, FY, build_scene, render_frame,
                                                trajectory_pose_orbit)
    from mageslam_tpu.bow.index import add_keyframe, compute_idf, empty_index, query_keyframes
    from mageslam_tpu.bow.vocab import train_vocabulary
    from mageslam_tpu.config import golden_path_settings
    from mageslam_tpu.ops.frontend import detect_and_compute

    t0 = time.time()
    width, height, num_words = 320, 180, 64
    fes = golden_path_settings().MonoSettings.MonoCamera.FeatureExtractorSettings
    sx, sy = width / 640.0, height / 480.0
    cam = jnp.array([FX * sx, FY * sy, CX * sx, CY * sy], jnp.float32)
    fe = jax.jit(lambda img: detect_and_compute(img.astype(jnp.float32), cam, fes,
                                                max_features=512))
    K = len(seeds) * views_per_room

    def view(surfaces, phase):
        R, c = trajectory_pose_orbit(phase, views_per_room)
        img = render_frame(surfaces, R, c, width, height, frame_index=int(phase * 7) % 97,
                           supersample=2)
        f = fe(jnp.asarray(img))
        return np.asarray(f.desc), np.asarray(f.valid)

    kf_desc = np.zeros((K, 512, 8), np.uint32)
    kf_valid = np.zeros((K, 512), bool)
    queries = []
    for room, seed in enumerate(seeds):
        surfaces = build_scene(seed, variant="loop")
        for i in range(views_per_room):
            kf_desc[room * views_per_room + i], kf_valid[room * views_per_room + i] = \
                view(surfaces, i)
        for i in range(0, views_per_room, query_stride):
            queries.append((room, i + 0.5, *view(surfaces, i + 0.5)))
    out = {}
    pools = {"all_rooms_vocab": (kf_desc[::7].reshape(-1, 8), kf_valid[::7].reshape(-1)),
             "room0_vocab": (kf_desc[:views_per_room:2].reshape(-1, 8),
                             kf_valid[:views_per_room:2].reshape(-1))}
    for name, (pd, pv) in pools.items():
        idx = empty_index(K, num_words=num_words)
        anchors = train_vocabulary(jnp.asarray(pd), jnp.asarray(pv), jax.random.PRNGKey(0),
                                   num_words=num_words)
        out[f"{prefix}{name}_draws"] = np.asarray(
            jax.random.gumbel(jax.random.PRNGKey(0), (pd.shape[0],)), np.float32)
        idx = idx._replace(anchors=anchors, trained=jnp.asarray(True))
        idx = compute_idf(idx, jnp.asarray(pd), jnp.asarray(pv))
        add = jax.jit(add_keyframe)
        for k in range(K):
            idx = add(idx, jnp.int32(k), jnp.asarray(kf_desc[k]), jnp.asarray(kf_valid[k]))
        q_jit = jax.jit(lambda d, v, idx=idx: query_keyframes(idx, d, v))

        def correct(k, room, phase):
            r, i = divmod(int(k), views_per_room)
            dphase = abs(i - phase)
            dphase = min(dphase, views_per_room - dphase)
            return r == room and dphase <= tol

        top1 = p4 = qual_rec = cross = 0
        top4 = []
        for room, phase, d, v in queries:
            scores, qualified = q_jit(jnp.asarray(d), jnp.asarray(v))
            order = np.argsort(-np.asarray(scores))
            top1 += correct(order[0], room, phase)
            cross += (order[0] // views_per_room) != room
            p4 += np.mean([correct(k, room, phase) for k in order[:4]])
            qual_rec += any(correct(k, room, phase)
                            for k in np.where(np.asarray(qualified))[0])
            top4.append(order[:4])
        nq = len(queries)
        out[f"{prefix}{name}_metrics"] = np.asarray(
            [top1 / nq, p4 / nq, qual_rec / nq, cross / nq], np.float64)
        out[f"{prefix}{name}_top4"] = np.asarray(top4, np.int32)
        print(f"bow eval {prefix}{name}: top1 {top1 / nq:.4f} p@4 {p4 / nq:.4f} "
              f"qual_recall {qual_rec / nq:.4f} cross_room {cross / nq:.4f} "
              f"({time.time() - t0:.0f}s)", flush=True)
    out[f"{prefix}config"] = np.asarray([views_per_room, query_stride, tol], np.int32)
    if keep_desc:
        out[f"{prefix}kf_desc"], out[f"{prefix}kf_valid"] = kf_desc, kf_valid
        out[f"{prefix}q_room"] = np.asarray([q[0] for q in queries], np.int32)
        out[f"{prefix}q_phase"] = np.asarray([q[1] for q in queries], np.float64)
        out[f"{prefix}q_desc"] = np.stack([q[2] for q in queries])
        out[f"{prefix}q_valid"] = np.stack([q[3] for q in queries])
    return out


def main_diag(out_path: str = DIAG_OUT) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    arrays = {}
    arrays.update(diag_stream_arrays())
    arrays.update(diag_photoreal_arrays())
    arrays.update(diag_xray_arrays())
    arrays.update(bow_eval_arrays("bc_", keep_desc=True, **BOW_CUT))
    arrays.update(bow_eval_arrays("bf_"))
    _save(out_path, arrays)
    print(f"wrote {out_path}: {os.path.getsize(out_path)} bytes")


BA_OUT = os.path.join(REPO, "tests", "data", "torch_port_ba.npz")
# tests/test_torch_ba.py's window arguments and its argument sets
BA_WINDOW_KW = dict(max_cams=8, max_points=128, max_obs=256, theta0=5, theta_min=5,
                    upper_connections=2000, lower_connections=50)
BA_WINDOW_CASES = (
    {},                                                  # the whole covisible set fits
    {"max_cams": 3, "max_points": 50, "max_obs": 90},    # every bank overflows
    {"upper_connections": 120, "theta_step": 10, "theta_max_steps": 2},   # theta walks up
    {"theta0": 40, "lower_connections": 150, "theta_step": 10, "theta_max_steps": 2},  # down
    {"global_window": True},
)
BA_HUBERS = (0.0, 1.5)
BA_LAMBDAS = (1.0, 10.0)


def _fields(prefix: str, tree) -> dict:
    """A NamedTuple's fields as `{prefix}_{field}` arrays (a Pose field as
    `.R` and `.t`), skipping Python scalars."""
    out = {}
    for name, value in tree._asdict().items():
        if hasattr(value, "R"):
            out[f"{prefix}_{name}.R"], out[f"{prefix}_{name}.t"] = (np.asarray(value.R),
                                                                    np.asarray(value.t))
        elif not isinstance(value, (bool, int, float)):
            out[f"{prefix}_{name}"] = np.asarray(value)
    return out


def _window(prefix: str, w) -> dict:
    """A BA window: its problem's array leaves in flatten order
    (`{prefix}_p{i}`), `points_fixed` and the slot maps by name."""
    out = _flatten(f"{prefix}_p", w.problem[:-1])
    out[f"{prefix}_points_fixed"] = np.asarray(w.problem.points_fixed)
    for name in ("cam_slot", "pt_slot", "obs_kf", "obs_feat", "theta"):
        out[f"{prefix}_{name}"] = np.asarray(getattr(w, name))
    return out


def ba_perturbed_scene(seed=0, noise=0.0):
    """tests/test_torch_worldmap.py's small scene with keyframe 4's pose and
    every point knocked off the truth and `noise` pixels on the
    observations; keyframes 0 and 1 fixed (which pins the scale)."""
    import jax.numpy as jnp

    from mageslam_tpu.geometry.se3 import Pose as JPose
    from mageslam_tpu.geometry.se3 import retract
    from test_torch_worldmap import build_scene

    m, _, _ = build_scene(seed)
    m = m._replace(kf_fixed=m.kf_fixed.at[1].set(True))
    rng = np.random.RandomState(seed + 100)
    bad = retract(JPose(m.kf_pose.R[4], m.kf_pose.t[4]),
                  jnp.asarray([0.02, -0.01, 0.015, 0.008, -0.006, 0.004], jnp.float32))
    return m._replace(
        kf_pose=JPose(m.kf_pose.R.at[4].set(bad.R), m.kf_pose.t.at[4].set(bad.t)),
        mp_pos=m.mp_pos + jnp.asarray(rng.randn(*m.mp_pos.shape).astype(np.float32) * 0.01),
        kf_kp_xy=m.kf_kp_xy + jnp.asarray(
            rng.randn(*m.kf_kp_xy.shape).astype(np.float32) * noise))


def ba_tether_problem(seed=0, K=6, Pn=40, O=160, Tn=5):
    """A synthetic problem with all three tether kinds (and one invalid)."""
    import jax.numpy as jnp

    from mageslam_tpu.ba import problem as jproblem
    from mageslam_tpu.geometry.se3 import Pose as JPose
    from mageslam_tpu.geometry.se3 import exp_so3

    rng = np.random.RandomState(seed)
    p = jproblem.empty_problem(K, Pn, O, n_tethers=Tn)
    R = np.asarray(exp_so3(jnp.asarray(rng.randn(K, 3).astype(np.float32) * 0.05)))
    t = np.concatenate([rng.randn(K, 2) * 0.4, np.zeros((K, 1))], 1).astype(np.float32)
    pts = np.stack([rng.uniform(-1, 1, Pn), rng.uniform(-1, 1, Pn), rng.uniform(4, 7, Pn)],
                   1).astype(np.float32)
    oc, op = rng.randint(0, K, O).astype(np.int32), rng.randint(0, Pn, O).astype(np.int32)
    Xc = np.einsum("oij,oj->oi", R[oc], pts[op]) + t[oc]
    uv = (300 * Xc[:, :2] / Xc[:, 2:3] + [160, 120] + rng.randn(O, 2)).astype(np.float32)
    info = np.where(rng.rand(O) < 0.9, rng.uniform(0.5, 1, O), 0).astype(np.float32)
    c1, c2 = rng.randint(0, K, Tn).astype(np.int32), rng.randint(0, K, Tn).astype(np.int32)
    c2 = np.where(c1 == c2, (c2 + 1) % K, c2).astype(np.int32)
    dR = np.asarray(exp_so3(jnp.asarray(rng.randn(Tn, 3).astype(np.float32) * 0.1)))
    return p._replace(
        poses=JPose(jnp.asarray(R), jnp.asarray(t)),
        intrinsics=jnp.tile(jnp.asarray([[300.0, 300.0, 160.0, 120.0]]), (K, 1)),
        cam_fixed=jnp.arange(K) < 2, cam_valid=jnp.arange(K) < K - 1,
        points=jnp.asarray(pts), pt_valid=jnp.arange(Pn) < Pn - 2,
        obs_cam=jnp.asarray(oc), obs_pt=jnp.asarray(op), obs_uv=jnp.asarray(uv),
        obs_info=jnp.asarray(info),
        tether_kind=jnp.asarray(np.arange(Tn) % 3, jnp.int32),
        tether_cam1=jnp.asarray(c1), tether_cam2=jnp.asarray(c2),
        tether_pose=JPose(jnp.asarray(dR), jnp.asarray(rng.randn(Tn, 3).astype(np.float32) * 0.3)),
        tether_distance=jnp.asarray(rng.uniform(0.2, 1, Tn).astype(np.float32)),
        tether_weight=jnp.asarray(np.where(np.arange(Tn) == Tn - 1, 0, 2.0).astype(np.float32)))


def main_ba(out_path: str = BA_OUT) -> None:
    """The JAX references of tests/test_torch_ba.py (see `ba`), computed as
    that file computed them live: the residuals, `project_obs` and the LM
    iteration jitted as the JAX pipeline runs them, the normal equations
    eager apart from the jitted tether residuals, the rest eager."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    from mageslam_tpu.ba import problem as jproblem
    from mageslam_tpu.ba import residuals as jres
    from mageslam_tpu.ba import schur as jschur
    from mageslam_tpu.ba import step as jstep
    from mageslam_tpu.worldmap import ba_window as jwin
    from mageslam_tpu.worldmap import member_index as jmi
    from test_torch_worldmap import LEVELS, SCALE, build_scene

    j_obs = jax.jit(jres.observation_residuals)
    j_tether = jax.jit(jres.tether_residuals)
    j_project = jax.jit(jres.project_obs)
    j_lm = jax.jit(jschur.lm_iteration)
    m = ba_perturbed_scene(noise=0.3)
    w = jwin.build_local_ba_window(m, jnp.int32(4), **BA_WINDOW_KW)
    problems = {"window": w.problem, "tethered": ba_tether_problem()}
    arrays = {**_flatten("win_map", m), **_window("win", w),
              **_flatten("teth_p", problems["tethered"][:-1])}
    for which, jp in problems.items():
        for huber in BA_HUBERS:
            pre = f"obs_{which}_{huber}"
            want = j_obs(jp, jp.poses, jp.points, jp.obs_info, jnp.float32(huber))
            arrays.update(_fields(pre, want))
            arrays[f"{pre}_behind"] = np.asarray(jres.behind_camera(want))
            arrays[f"{pre}_cost"] = np.asarray(jres.robust_cost(want.chi2, jnp.float32(huber),
                                                                want.w))
        uv, Xc = j_project(jp.poses, jp.intrinsics, jp.points, jp.obs_cam, jp.obs_pt)
        arrays[f"proj_{which}_uv"], arrays[f"proj_{which}_Xc"] = np.asarray(uv), np.asarray(Xc)
        # the normal equations at huber 1.5, the solves' input
        jobs = jres.observation_residuals(jp, jp.poses, jp.points, jp.obs_info,
                                          jnp.float32(1.5))
        jeq = jschur.build_normal_equations(jp, jobs, j_tether(jp, jp.poses))
        arrays.update(_fields(f"eq_{which}", jeq))
        for lam in BA_LAMBDAS + ((-50.0,) if which == "window" else ()):
            dx_c, dx_p = jschur.solve_lm_system(jp, jeq, jnp.float32(lam))
            arrays[f"solve_{which}_{lam}_dx_c"] = np.asarray(dx_c)
            arrays[f"solve_{which}_{lam}_dx_p"] = np.asarray(dx_p)
        st = jproblem.BAState.from_problem(jp, -1.0)
        for j, huber in enumerate((1.5, 0.0)):     # the second starts from lambda > 0
            r = j_lm(jp, st, jnp.float32(huber))
            pre = f"lm_{which}_{j}"
            arrays[f"{pre}_accepted"] = np.asarray(r.accepted)
            arrays[f"{pre}_cost"] = np.asarray(r.cost)
            arrays.update(_fields(f"{pre}_state", r.state))
            st = r.state
    arrays.update(_fields("teth", j_tether(problems["tethered"], problems["tethered"].poses)))

    # step_bundle_adjust on the noiseless scene, one gross outlier observation
    truth, _, _ = build_scene()
    nm = ba_perturbed_scene(noise=0.0)
    nm = nm._replace(kf_kp_xy=nm.kf_kp_xy.at[3, 0].add(25.0))
    nw = jwin.build_local_ba_window(nm, jnp.int32(4), **BA_WINDOW_KW)
    widths = np.float32(1.5) * np.float32(0.9) ** np.arange(4, dtype=np.float32)
    st, mse, out = jstep.step_bundle_adjust(nw.problem, jproblem.BAState.from_problem(
        nw.problem, -1.0), jnp.asarray(widths), jnp.float32(4.0))
    arrays.update(_window("nl", nw))
    arrays.update(_fields("nl_state", st))
    arrays.update({"nl_mse": np.asarray(mse), "nl_out": np.asarray(out),
                   "nl_cam_slot": np.asarray(nw.cam_slot), "nl_widths": widths,
                   "nl_before_t4": np.asarray(nm.kf_pose.t[4]),
                   "nl_truth_t4": np.asarray(truth.kf_pose.t[4])})

    kw = dict(huber_width=1.5, max_outlier_error=3.0, huber_width_scale=0.9,
              max_outlier_error_scale=0.9, min_mean_square_error=1e-9, num_steps=4,
              steps_per_run=2, min_steps=2)
    st, mse, steps, out = jstep.iterate_bundle_adjust(
        w.problem, jproblem.BAState.from_problem(w.problem, -1.0), **kw)
    arrays.update(_fields("it_state", st))
    arrays.update({"it_mse": np.float64(mse), "it_steps": np.int32(steps),
                   "it_out": np.asarray(out)})

    for j, case in enumerate(BA_WINDOW_CASES):
        arrays.update(_window(f"kw{j}", jwin.build_local_ba_window(
            m, jnp.int32(4), **{**BA_WINDOW_KW, **case})))
    fidx = jmi.build_fidx(m)
    arrays["fidx"] = np.asarray(fidx)

    st, _, out = jstep.step_bundle_adjust(w.problem, jproblem.BAState.from_problem(w.problem),
                                          jnp.asarray([1.5, 1.2]), jnp.float32(1.0))
    # enough outliers that some points fall under two observers
    out = np.asarray(out) | (np.random.RandomState(0).rand(len(out)) < 0.45)
    arrays.update(_fields("apply_state", st))
    arrays["apply_out"] = out
    for with_fidx in (False, True):
        want = jwin.apply_ba_results(m, w, st.poses, st.points, jnp.asarray(out), LEVELS,
                                     SCALE, fidx=fidx if with_fidx else None)
        if with_fidx:
            arrays["apply1_fidx"] = np.asarray(want[1])
            want = want[0]
        arrays.update(_flatten(f"apply{int(with_fidx)}_map", want))
    _save(out_path, arrays)
    print(f"wrote {out_path}: {os.path.getsize(out_path)} bytes, {len(arrays)} arrays")


PARALLEL_OUT = os.path.join(REPO, "tests", "data", "torch_port_parallel.npz")
PARALLEL_LAST = 95            # the offloaded session's last frame
BATCH = 8                     # the batched track step's sessions
MATCH_CASES = (("small", 512, 128), ("full", 8192, 512))   # Budgets' P, N for full
MATCH_GATES = (12.0, 45, 8)   # radius, max_hamming, min_diff (tests/test_parallel.py)
OFFLOAD_MASKS = ("kf_valid", "mp_valid", "kf_assoc", "kf_member")


def matcher_case(P: int, N: int, seed: int = 0) -> tuple:
    """tests/test_parallel.py:44-51's matcher case at (P, N): queries and
    targets with near-copies so real matches exist (numpy)."""
    rng = np.random.RandomState(seed)
    q_desc = rng.randint(0, 2**31, (P, 8)).astype(np.uint32)
    t_desc = rng.randint(0, 2**31, (N, 8)).astype(np.uint32)
    t_desc[:64] = q_desc[100:164]
    q_xy = rng.uniform(0, 300, (P, 2)).astype(np.float32)
    t_xy = q_xy[100:100 + N].copy()
    q_valid = rng.rand(P) > 0.1
    t_valid = np.ones((N,), bool)
    return q_desc, q_xy, q_valid, t_desc, t_xy, t_valid


def parallel_matcher_arrays(mesh) -> dict:
    import jax.numpy as jnp

    from mageslam_tpu.parallel.sharded_matching import make_sharded_guided_matcher

    match = make_sharded_guided_matcher(mesh, axis="model")
    out = {}
    for name, P, N in MATCH_CASES:
        args = [jnp.asarray(a) for a in matcher_case(P, N)]
        got = np.asarray(match(*args, *MATCH_GATES))
        out[f"mt_{name}_d8"] = got
        print(f"matcher {name} ({P}, {N}): {int((got >= 0).sum())} matches")
    return out


def parallel_lm_arrays(mesh) -> dict:
    """tests/test_parallel.py's `_problem` (RandomState(0)): one sharded LM
    iteration, four chained, and the dense iteration."""
    import jax.numpy as jnp

    from mageslam_tpu.ba.schur import lm_iteration
    from mageslam_tpu.parallel.sharded_ba import make_sharded_lm_iteration

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_parallel import TestShardedGlobalBA

    p, st = TestShardedGlobalBA()._problem(np.random.RandomState(0))
    hw = jnp.float32(1.5)
    it = make_sharded_lm_iteration(mesh, axis="model")
    out = _flatten("lm_p", p[:-1])
    out.update(_flatten("lm_st", st))
    one = it(p, st, hw)
    out.update(_flatten("lm1_st", one.state))
    out["lm1_cost"], out["lm1_accepted"] = np.asarray(one.cost), np.asarray(one.accepted)
    dense = lm_iteration(p, st, hw)
    out.update(_flatten("lmd_st", dense.state))
    out["lmd_cost"], out["lmd_accepted"] = np.asarray(dense.cost), np.asarray(dense.accepted)
    costs = []
    for _ in range(4):
        r = it(p, st, hw)
        st = r.state
        costs.append(float(r.cost))
    out.update(_flatten("lm4_st", st))
    out["lm4_costs"] = np.asarray(costs, np.float32)
    print(f"sharded LM: one iteration cost {float(one.cost):.6g} (dense "
          f"{float(dense.cost):.6g}), four {costs}")
    return out


def parallel_capacity_arrays(mesh) -> dict:
    """tests/test_global_ba_capacity.py's full-budget window
    (`build_capacity_map(RandomState(0))`): the window problem, the dense
    and the sharded step's outputs at widths (2.0, 1.6)."""
    import jax.numpy as jnp

    from mageslam_tpu.ba import BAState
    from mageslam_tpu.ba.step import step_bundle_adjust
    from mageslam_tpu.config import Budgets
    from mageslam_tpu.parallel.sharded_ba import make_sharded_step_bundle_adjust
    from mageslam_tpu.worldmap.ba_window import build_local_ba_window

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_global_ba_capacity import build_capacity_map

    b = Budgets()
    m = build_capacity_map(np.random.RandomState(0))[0]
    window = build_local_ba_window(m, jnp.int32(0), max_cams=b.MaxKeyframes,
                                   max_points=b.MaxMapPoints,
                                   max_obs=b.MaxGlobalBaObservations, global_window=True)
    p = window.problem
    st = BAState.from_problem(p)
    widths = jnp.asarray([2.0, 1.6], jnp.float32)
    out = _flatten("cap_p", p[:-1])
    out["cap_widths"], out["cap_max_error_sq"] = np.asarray(widths), np.float32(16.0)
    for name, step in (("dense", step_bundle_adjust),
                       ("sharded", make_sharded_step_bundle_adjust(mesh))):
        st2, mse, outliers = step(p, st, widths, jnp.float32(16.0))
        out.update(_flatten(f"cap_{name}_st", st2))
        out[f"cap_{name}_mse"], out[f"cap_{name}_out"] = np.asarray(mse), np.asarray(outliers)
        print(f"capacity step {name}: mse {float(mse):.6g}, "
              f"{int(np.asarray(outliers).sum())} outliers")
    return out


def parallel_batch_arrays(mesh, frames) -> dict:
    """The JAX per-frame session from frame 30: session b holds its map and
    history before frame 31 + b (after frame 30 + b) and the frame the
    session built for it; batched_track_step over the 8 sessions."""
    import jax
    import jax.numpy as jnp

    from mageslam_tpu.config import golden_path_settings
    from mageslam_tpu.parallel import batched_track_step

    with tempfile.TemporaryDirectory() as tmp:
        sess = run_to_snapshot(frames, os.path.join(tmp, "snap.npz"))
    seen = []
    core = sess._track_core

    def recording_core(map_state, history, frame, *a):
        seen.append((map_state, history, frame))
        return core(map_state, history, frame, *a)

    sess._track_core = recording_core
    for i in range(SNAP_FRAME + 1, SNAP_FRAME + 1 + BATCH):
        sess.process_frame(frames[i], i * DT, i)
    sess._track_core = core
    out = {}
    for b, (m, h, f) in enumerate(seen):
        for i, leaf in enumerate(jax.tree.flatten(m)[0]):
            leaf = np.asarray(leaf)
            if b == 0 or not np.array_equal(leaf, out[f"bt0_map{i}"]):
                out[f"bt{b}_map{i}"] = leaf
        out.update(_flatten(f"bt{b}_hist", h))
        out.update(_flatten(f"bt{b}_frame", f))
    stack = lambda trees: jax.tree.map(lambda *xs: jnp.stack(xs), *trees)  # noqa: E731
    step, shard = batched_track_step(mesh, golden_path_settings(), 640.0, 480.0)
    res = step(*(shard(stack([s[k] for s in seen])) for k in range(3)))
    out["bt_R"], out["bt_t"] = np.asarray(res.frame.pose.R), np.asarray(res.frame.pose.t)
    out["bt_succeeded"] = np.asarray(res.succeeded)
    out["bt_tracked"] = np.asarray(res.tracked_count)
    print(f"batched step: succeeded {out['bt_succeeded'].tolist()}, tracked "
          f"{out['bt_tracked'].tolist()}")
    return out


def parallel_offload_arrays(frames) -> dict:
    """The JAX session from frame 0 with a Determinator; from the frame-30
    state `enable_mapping_offload(jax.devices()[1])` over frames
    31..PARALLEL_LAST, then `fossilize(global_ba_steps=0)`."""
    import jax
    import jax.numpy as jnp

    from mageslam_tpu.config import golden_path_settings
    from mageslam_tpu.diagnostics import Determinator
    from mageslam_tpu.runtime import SlamSession

    det = Determinator()
    sess = SlamSession(golden_path_settings(), cam=jnp.asarray(CAM, jnp.float32),
                       image_width=640, image_height=480, determinator=det)
    for i in range(SNAP_FRAME + 1):
        sess.process_frame(frames[i], i * DT, i)
    snap = _snapshot_arrays(sess)
    with np.load(DEFAULT_OUT) as z:
        differs = [k for k in snap if k != "meta_json" and not np.array_equal(z[k], snap[k])]
    if differs:
        raise RuntimeError(f"the session after frame {SNAP_FRAME} differs from "
                           f"{os.path.basename(DEFAULT_OUT)}'s snapshot: {differs}")
    n0 = len(det._stream)
    sess.enable_mapping_offload(jax.devices()[1])
    adoptions = []
    adopt = sess._adopt_offloaded_mapping

    def recording_adopt():
        pending = sess._offload_pending
        adopt()
        if pending is not None:
            adoptions.append((pending[2], {k: np.asarray(getattr(sess.map, k))
                                           for k in OFFLOAD_MASKS}))

    sess._adopt_offloaded_mapping = recording_adopt
    out = record_window(sess, frames, SNAP_FRAME + 1, PARALLEL_LAST + 1)
    out = {f"off_{k[4:]}": v for k, v in out.items()}
    ids, mats = sess.fossilize(global_ba_steps=0)
    out["off_fossil_ids"], out["off_fossil_mats"] = np.asarray(ids), np.asarray(mats)
    out["off_names"], out["off_hashes"] = _checkpoints(det, n0)
    out["off_adopt_frame"] = np.asarray([a[0] for a in adoptions], np.int32)
    for j, (_, masks) in enumerate(adoptions):
        for k, v in masks.items():
            out[f"off_ad{j}_{k}"] = v
    print(f"offload: keyframes at {out['off_frame_id'][out['off_is_kf']].tolist()}, "
          f"adopted {out['off_adopt_frame'].tolist()}, {len(out['off_names'])} checkpoints")
    return out


def main_parallel(out_path: str = PARALLEL_OUT) -> None:
    """The references of the port's parallel package and the session's
    mapping offload (see `parallel` in the module docstring)."""
    import jax
    from jax.sharding import Mesh

    jax.config.update("jax_platforms", "cpu")
    if len(jax.devices()) < 8:
        raise RuntimeError("needs 8 CPU devices: XLA_FLAGS="
                           "--xla_force_host_platform_device_count=8")
    mesh = Mesh(np.array(jax.devices()[:8]), ("model",))
    frames = bench_frames(PARALLEL_LAST + 1)
    arrays = parallel_matcher_arrays(mesh)
    arrays.update(parallel_lm_arrays(mesh))
    arrays.update(parallel_capacity_arrays(mesh))
    arrays.update(parallel_batch_arrays(Mesh(np.array(jax.devices()[:8]), ("sessions",)),
                                        frames))
    arrays.update(parallel_offload_arrays(frames))
    _save(out_path, arrays)
    print(f"wrote {out_path}: {os.path.getsize(out_path)} bytes, {len(arrays)} arrays")


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which not in ("track", "map", "both", "init", "bow", "photoreal", "reloc", "loop",
                     "stereo", "cameras", "vi", "stream", "diag", "ba", "parallel", "levels",
                     "vi_filters", "init_checks", "all"):
        sys.exit(__doc__)
    if which in ("track", "both", "all"):
        main()
    if which in ("map", "both", "all"):
        main_map()
    if which in ("init", "all"):
        main_init()
    if which in ("bow", "all"):
        main_map(bow_path=BOW_OUT)
    if which in ("photoreal", "all"):
        main_photoreal()
    if which in ("reloc", "all"):
        main_reloc()
    if which in ("loop", "all"):
        main_loop()
    if which in ("stereo", "all"):
        main_stereo()
    if which in ("cameras", "all"):
        main_cameras()
    if which in ("vi", "all"):
        main_vi()
    if which in ("stream", "all"):
        main_stream()
    if which in ("diag", "all"):
        main_diag()
    if which in ("ba", "all"):
        main_ba()
    if which in ("parallel", "all"):
        main_parallel()
    if which in ("levels", "all"):
        main_levels()
    if which in ("vi_filters", "all"):
        main_vi_filters()
    if which in ("init_checks", "all"):
        main_init_checks()
