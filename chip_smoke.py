"""Smoke run of the PyTorch/CUDA port (`mageslam_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each reported on its own line; any failure ends the run non-zero:

1. Device: a CUDA device is required (there is no CPU path); prints its name
   and `nvidia-smi --query-gpu=name,power.limit` for the card.
2. Build: compiles the port's CUDA sources with nvcc (ops/_build.py) and
   prints what ptxas reports for each kernel.
3. Kernel check, each kernel against its plain PyTorch version on the card,
   exact:
   - the standalone Hamming kernel (`csrc/hamming.cu`, on the tensor cores
     through `csrc/hamming_tile.cuh`) on full-range 32-bit words at
     KERNEL_SHAPES, the full point bank (8192, 512) and BoW's word
     assignment (440, 64), (1024, 64) and (8192, 64), and on low-entropy
     words; timed at those shapes beside `torch._int_mm` of the ±1 int8 bits
     (256 - 2 * Hamming), the library yardstick, whose device time a call
     is read from the profiler too;
   - the fused radius-match kernel (`csrc/radius_match.cu`) at S in {1, 3}
     stages and (Q, T) up to (2048, 512) and (700, 3000), the mapping
     step's (512, 512) among them, on low-entropy descriptors (ties at best
     and second), rows without candidates and points exactly on the radius,
     with its dedup by target over the whole call and in groups of rows,
     and on DEDUP_CASES (tied best claims, claims past the dedup's Q + 2
     table, relocalization's groups); held exactly against the plain
     version and timed on the inputs the tracking path gives it on frame 31
     (2 calls) and on those the first keyframe event gives it (6 calls: the
     loop-closure match and the five re-association matches), beside the
     composite of the TPU path's structure (the standalone Hamming kernel's
     (Q, T) matrix, then the eager masked match and the eager dedup; no
     single PyTorch call computes it);
   - the bag-of-words kernels (`csrc/bow_words.cu`): word assignment at
     the path's row counts and the tile's edges, and 12 chained k-medoid
     iterations at the pools' sizes, with ties, an empty word and no valid
     row, exact; timed on the path's own calls in phases 7-9 beside the
     composites they replace (hamming.cu or `torch._int_mm` + argmin; the
     hamming.cu matrix + the eager k-medoid epilogue), and a one-element
     `add_` timed as the least launch there is;
   - the fused two-way match kernel (`csrc/two_way_match.cu`, its scan on
     the same tensor-core tile) at B in {1, 5} and (N, M) up to (512, 512)
     and (440, 700), and mono init's (440, 440) at B = 1, on low-entropy
     descriptors (ties in both directions), rows and columns without
     candidates and min_diff in {1, 8}; timed on the inputs the first
     keyframe event gives it and at mono init's shape, beside the two
     composites it replaces (per batch entry the standalone Hamming kernel,
     or `torch._int_mm` of the ±1 bits, and the eager epilogue; no single
     PyTorch call computes it).
   Each call is timed with CUDA events in turns (kernel, plain, plain,
   kernel; 5 samples of 200 calls, of 20 for a plain version, which takes
   milliseconds a call), and each launch's device time is read from
   torch.profiler.
4. Slice: starts a session on the card from the committed JAX state
   (tests/data/torch_port_bench640_f30.npz: the benchmark world after frame
   30), tracks frames 31-54 through `SlamSession.process_frame`, and holds
   every frame against the stored JAX outputs: state TRACKING, keyframe
   flag, pose R and t within 1e-3, tracked count within 3. In that run the
   fused kernel must launch exactly twice a frame (cascade, track-local-map),
   plus the mapping step's launches on the window's one keyframe (its last
   frame), and the word-assignment kernel once a mapped keyframe (its
   bag-of-words add); the standalone Hamming kernel never. The index after
   frame 54 must equal the JAX session's
   (tests/data/torch_port_bench640_bow.npz). Then torch.profiler
   traces 8 frames for the device events and device time per frame.
5. Mapping event: the first keyframe's mapping step (runtime/mapping_step.py)
   on the card from the committed JAX state just before it
   (tests/data/torch_port_bench640_map.npz), held against the JAX map after
   it: `kf_valid`, `mp_valid`, `kf_assoc`, `kf_member` exact, `kf_pose`
   within 1e-4 and `mp_pos` within 2e-3 (float32 LM with sums in another
   order). Timed over repeats and traced once for its device events. The
   event is mapped once more with one live tether put into the map, so that
   local BA's tether residuals run on the card (a map without a live tether
   skips them): the tethered keyframes must end nearer the tether's distance.
6. Mapping window: a session from the frame-30 state runs frames 31-95
   through `process_frame`, mapping the keyframes at 54, 68 and 93. Every
   frame is held against the JAX session as in phase 4; the map after the
   first event must equal the JAX map's masks exactly, and a later event's
   differing mask entries are reported, not hidden. Per frame the launch
   counts must be 2 fused radius-match launches without a keyframe, and on
   a keyframe 8 radius-match (2 tracking, 1 loop-closure match, 5
   re-association), 1 two-way match and 1 word assignment (the keyframe's
   bag-of-words add). The index after each event must equal the
   JAX session's.
7. From frame 0: `SlamSession(golden_path_settings(), cam, 640, 480)` on the
   card with no snapshot runs frames 0-54 through `process_frame`: mono init
   (anchor, accumulate, attempts, third-frame check, adoption), the
   vocabulary retrain, tracking and mapping. Its random draws replay the
   JAX session's (tests/data/torch_port_bench640_init.npz). Held against
   the JAX session: the same anchor, attempt and adoption frames; the
   adopted pose's R within 1e-3 and its t within 1e-3 once scaled by the
   ratio of the two map scales (the init BA leaves the scale where float
   noise puts it: PERF.md), that ratio within 5 %; point_valid with at most
   POINT_VALID_BOUND entries differing; the index's anchors exact and idf
   within 1e-6 after adoption and after the retrain; every frame's state,
   keyframe flag, R and scaled t within 1e-3, tracked count within 3 (the
   init fixture has frames 0-30, the f30 fixture's ref_* 31-54). Launches
   are asserted for each frame class (anchor, accumulate, attempt,
   adoption, retrain, tracked, keyframe). Every two-way call of init and
   every bag-of-words call of the index is held exactly against its plain
   version, and each bag-of-words kernel at each row count of the path and
   the init pair match are timed. An attempt, the adoption and the retrain are timed (wall) and
   traced (device events, device ms). Then a session with its own
   generator (no replay) must initialise within the init window and track
   every frame to 54; its adoption frame and pose are reported, not
   compared.
   Phases 4-7 never hold MinKeyframe (10) valid keyframes (phase 6: 3 + 3,
   phase 7: 2 + 3), so loop detection's gate stays shut there: phases 6
   and 7 assert that it never ran, and their launch counts are unchanged.
8. Photoreal: tests/test_photoreal_ate.py's 80 rendered frames at 320x180
   from tests/data/torch_port_photoreal.npz (rendered by the JAX package's
   apps/render_scene.py when the fixture was written), a bare session,
   the JAX session's draws replayed (init, vocabulary, and loop
   detection's one relocalization), then `fossilize(None)` and
   `fossilize(3)`. Held against the JAX run: every frame's state and
   keyframe flag, R and scaled t within 1e-3, tracked count within 3,
   associations on at least 99 % of the keypoints; the map's masks after
   each of the 13 mapping events exactly; the detections that ran and
   qualified; both fossilized trajectories within 1e-3. Frame 71, logged
   in ROADMAP queue 3 (a borderline inlier set), is held to 2e-3 instead.
   Asserted: at least 80 % tracked and ATE < 0.06 m (the port's numpy
   copy of the Umeyama ATE, mageslam_tpu_torch/apps/evaluate.py).
   Launches by frame class as in phase 7, a live detection adding
   LAUNCHES_DETECTION and a qualifying one LAUNCHES_DETECTION_RELOC.
   Reported: every frame's wall time, each detection's wall time, host
   reads and launches, and its device events and device ms: each
   detection's frame runs again, traced, from the session's
   `snapshot_state` taken just before it (`restore_state`), and whether
   that second run is bit for bit the first is reported. Every kernel call
   inside detection is held exactly against its plain version; the
   query's 512-row word assignment, the B = 4 two-way match and the
   stacked (2048, 512) rematch are timed and bounded.
9. Relocalization: tests/test_bow_reloc.py's scene from the JAX state
   after frame 29 (tests/data/torch_port_reloc.npz): five garbage frames,
   then the view of frame 29 again; states, poses and tracked counts held
   against JAX, LAUNCHES_RELOC asserted on each relocalizing frame, the
   relocalization's kernel calls held exactly and timed, the step's wall
   time, host reads and device events and device ms reported (each
   relocalizing frame run again, traced, from the snapshot before it).
10. Loop closure: tests/test_loop_closure.py's drifted maps
   (tests/data/torch_port_loop.npz, scenes a and b): `detect_loop`
   (detected, cluster and associations exact, scale within 1e-5, pose
   within 1e-4), then the session's closure (close_loop with the
   essential graph, global BA, membership refresh): masks exact, points
   and keyframe centers within CLOSURE_ATOL after one similarity (global
   BA leaves the gauge free); wall time over repeats, device events and
   device ms. Then the closure's cost on phase 6's final map with an
   identity detection (the exploring world never closes a loop).
11. Stereo rig and cameras, from tests/data/torch_port_stereo.npz,
   torch_port_cameras.npz, torch_port_cameras_kp.npz and
   torch_port_orient.npz (the JAX runs, `tools/export_jax_state.py
   stereo|cameras`), JAX's draws replayed, with the CPU tests' tolerances:
   - `stereo_initialize` on tests/test_stereo.py's synthetic pair
     (succeeded, match count, feat2 and point_valid exact, points within
     1e-3 relative, pose2 within 1e-4) and with no displacement (rejected);
     its two-way call held exactly against the plain version and timed
     beside the composites it replaces, with its bound;
   - the rig-tether session (40 frames: the bootstrap pair, then features),
     every mapping event's local BA holding the live rig tether: states,
     keyframe flags, unscaled poses (1e-3), tracked counts (3) and masks
     after each event as JAX's, the tether bank exact, the rig transform
     within 1e-3; launches asserted by frame class (the bootstrap: the pair
     match and the adoption's 3 + 12 bag-of-words launches); each frame's and event's
     wall time, each event's device events and device ms (its frame run
     again from the snapshot before it, traced);
   - the mixed-FOV rig through `process_stereo_frames` (24 pairs rendered by
     `stereo_world`, held to the JAX run's frames by SHA-256): the rescale
     active, the secondary camera within 1e-4, frames and masks as above,
     the post-init keyframes' intrinsics as JAX's; the pair frame's and
     the rescale's time;
   - tests/test_undistort.py's distorted Poly3K photoreal scene, 40 frames,
     with UndistortImagePixels on and off, and 30 photoreal frames with
     UseOrientation=True, each from a bare session: frames and masks as
     JAX's (t scaled by the map-scale ratio), launches by frame class;
     `undistort_image`'s time a frame.
   Frames and events beyond the tolerance on the card are logged in ROADMAP
   queue 3 and held to LOGGED's ceilings.
12. Visual-inertial run and the fossilized map, from
   tests/data/torch_port_vi.npz (the JAX package's apps/vi_eval.py run on
   the photoreal frames, `tools/export_jax_state.py vi`), JAX's draws
   replayed, the IMU stream (`synthesize_imu`) held to JAX's by SHA-256:
   - `run_vi_eval(80)` with every radius-match, two-way and bag-of-words call
     captured and the host reads of each frame counted by fuser mode: its
     transitions JAX's, tests/test_vi_e2e.py's gates (TRACKING reached
     after SCALE_INIT, metric scale within 35 % of the trajectory's truth,
     at least 64 frames tracked and 60 poses, ATE < 0.06 m);
   - the same 80 frames through `add_sensor_sample` / `process_frame`,
     launches counted from 0: the fuser's mode after every frame, states,
     keyframe flags, poses (1e-3, t scaled by the map-scale ratio), tracked
     counts and the masks after every event as JAX's, the metric scale
     within 1e-3 relative in JAX's map units, the IMU priors (1e-3) and the
     covariances (flag exact, 5e-3 of the largest entry) on every
     VI-tracking frame, launches by frame class; frame 71's borderline
     inliers and what the filter carries of them are held to their logged
     ceilings (ROADMAP queue 3);
   - the same frames vision-only, for a tracked frame's wall time beside
     the VI frame's;
   - the live queries, then `fossilize_map`: the trajectory (ATE within
     1e-3 m of JAX's), the raw and denoised clouds (the latter within 2e-3
     of the cloud's extent: the eigensolver's signs, queue 3) and the
     volume of interest (within one voxel); `ekf_predict`, the pose update,
     the covariance and `reposition_points` timed and traced;
   - the three filters replayed on the JAX run's recorded samples and
     visual poses, against JAX's replays;
   - every captured kernel call held exactly against its plain version.
13. The throughput and realtime entry points, from
   tests/data/torch_port_stream.npz (the JAX session at bench.py's
   settings, MinKeyframe 3, after frames 0-30, and its stream and pipelined
   calls from there; `tools/export_jax_state.py stream`):
   - `process_frame_stream` over bench frames 31-95 from a uint8 bank on the
     card (chunk 8, `_chunk_pipeline_depth` 4), every kernel call captured:
     states and keyframe flags exact, R and t within 1e-3, tracked counts
     within 3, the masks after each mapping step exact and
     `loop_det_stats` equal to JAX's; run again with the launches counted
     from 0 (the kernel line's `stream_frames_31_95`) and the host reads;
   - the same window through `process_frames_chunked` (chunk 4), held
     against the stream run frame by frame; `process_frame_pipelined` over
     31-58 against JAX's pipelined call (mapping lags to the resolution);
     the stream saved to disk after frame 62 (io/snapshot.py), loaded into
     a fresh card session and continued, against the uninterrupted run;
   - `process_frame`, `process_frame_stream`, `process_frame_pipelined` and
     `process_frame_realtime` on frames 31-62, each on a fresh session, in
     three interleaved rounds (the order reversed every other round): wall
     ms and host reads a frame each round, and how many frames the realtime
     gate drops back to back (reported, not asserted); the gate with
     max_inflight=0 drops every frame as SKIPPED without counting a
     failure, and paced frames all track; one chunk traced for its device
     events;
   - tests/test_stream_loop_ci.py's orbit through `run_orbit_eval(324,
     288, 240, 135, mode="stream")` with the session's own generator, its
     gates held (a loop closed, 100 frames tracked, ATE < 0.15 m, deferred
     detections resolved, one closed from the deferred path);
   - the console (`python -m mageslam_tpu_torch.apps.console`) as a
     subprocess on the photoreal frames written to a `.mgts` capture, with
     the fixture's intrinsics and the JAX run's draws: exit 0, its CSV at
     ATE < 0.06 m with 80 % tracked.

The next-to-last line is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_bench640_f30.npz")
MAP_FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_bench640_map.npz")
BOW_FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_bench640_bow.npz")
INIT_FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_bench640_init.npz")
PHOTOREAL_FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_photoreal.npz")
RELOC_FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_reloc.npz")
LOOP_FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_loop.npz")
STEREO_FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_stereo.npz")
CAMERAS_FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_cameras.npz")
CAMERAS_KP_FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_cameras_kp.npz")
ORIENT_FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_orient.npz")
ORIENT_FRAMES = 30                 # the oriented photoreal session's frames
WARM_FRAMES = 6                    # a stereo session's warm pass: bootstrap, one event
TRACED_EVENTS = 3                  # rig-tether mapping events traced: first, middle, last
STEREO_POINT_RTOL = 1e-3           # stereo_initialize's points against JAX's
STEREO_PAIR_POSE_ATOL = 1e-4       # its pose2
STEREO_CAM1_ATOL = 1e-4            # the mixed rig's rescaled secondary camera
# ROADMAP queue 3, by run: ({frame: pose ceiling}, {mapping event's frame:
# differing kf_assoc and kf_member entries allowed}). The rig sessions move
# with float summation order (the port's own CPU runs at 1-8 threads spread
# to 3.9e-2 and 556 mask entries on the rig-tether scene); two mapping
# events of the UndistortImagePixels run hold one association on the other
# keypoint of a pair whose responses are 4e-4 apart
LOGGED = {"rig_": ({f: 1e-2 for f in range(18, 40)}, {17: 2, 21: 2}),
          "mix_": ({f: 4e-3 for f in range(16, 24)}, {}),
          "und_": ({}, {13: 2, 16: 2}),
          "": ({71: 2e-3}, {})}         # the VI run (its fixture's keys have no prefix)
PHOTOREAL_SIZE = (320, 180)
ATE_LIMIT = 0.06                   # m, tests/test_photoreal_ate.py's gate
TRACKED_SHARE = 0.8
RELOC_SNAP_FRAME = 29              # the reloc fixture's snapshot frame
CLOSURE_ATOL = 5e-4                # closure poses and points after the essential graph
CLOSURE_REPEATS = 3
CAM = (520.0, 520.0, 320.0, 240.0)
WIDTH, HEIGHT = 640, 480
DT = 0.033
KERNEL_SHAPES = ((1, 1), (129, 257), (1000, 440), (1024, 512), (2048, 512))
PATH_SHAPES = ((1024, 512), (2048, 512))   # guided cascade, track-local-map
BANK_SHAPE = (8192, 512)   # the full point bank against a frame's feature slots
BOW_SHAPE = (440, 64)      # a frame's features against a vocabulary level's words
BOW_SHAPES = ((1024, 64), (8192, 64))   # the adoption's pool; a bank-size pool
# bow_words.cu's rows: a keyframe's slots, the adoption's pool, the
# retrain's pool (15 x 512), every keyframe's slots at the retrain (48 x 512)
BOW_ASSIGN_ROWS = (512, 1024, 7680, 24576)
# the bag-of-words kinds of a recorded call: (kernel wrapper, plain version)
BOW_KERNELS = {"bow_assign": ("assign", "assign_plain"),
               "bow_vocab_step": ("vocab_step", "vocab_step_plain")}
HAMMING_TIMED = PATH_SHAPES + (BANK_SHAPE,) + BOW_SHAPES
RADIUS_SHAPES = ((1, 1), (129, 257), (512, 512), (1024, 512), (2048, 512), (700, 3000))
# (stages, Q, T) of the radius matches of a tracked frame and of a keyframe event
RADIUS_CALLS_TRACKED = ((3, 1024, 512), (1, 2048, 512))
RADIUS_CALLS_KEYFRAME = ((1, 2048, 512),) + 5 * ((1, 512, 512),)
RADIUS_STAGES = (1, 3)
# (Q, T, group_rows) of the dedup's edge cases: tied best claims, claims
# past the Q + 2 table, relocalization's groups, a stacked rematch's shape
DEDUP_CASES = ((40, 30, None), (20, 300, None), (64, 512, 16), (2048, 512, 512))
TWO_WAY_SHAPES = ((1, 1), (129, 257), (512, 512), (440, 700))
TWO_WAY_BATCHES = (1, 5)
TWO_WAY_MIN_DIFFS = (1, 8)
INIT_SHAPE = (440, 440)    # mono init's match of two frames' features, B = 1
INIT_GATES = (30, 1)       # its max_hamming and min_diff (InitSettings)
POSE_ATOL = 1e-3
# photoreal frames logged in ROADMAP queue 3 (a borderline inlier set moved
# by float32 summation order) and their ceiling, for pose and fossil
PHOTOREAL_LOGGED_FRAMES = (71,)
PHOTOREAL_LOGGED_ATOL = 2e-3       # measured 1.37e-3
ASSOC_SHARE = 0.99                 # keypoints with JAX's association, a frame
MAP_POSE_ATOL = 1e-4      # kf_pose after a mapping event, against the JAX map
MAP_POINT_ATOL = 2e-3     # mp_pos after a mapping event
MAP_MASKS = ("kf_valid", "mp_valid", "kf_assoc", "kf_member")
MAP_REPEATS = 5
# the kernels whose launches are counted, in the order of every launch tuple
KERNELS = ("radius_match", "two_way_match", "hamming_matrix", "bow_assign", "bow_vocab_step")
# kernel launches of one frame, by KERNELS; the standalone Hamming kernel
# has no call on the path (bag-of-words goes through bow_words.cu)
LAUNCHES_TRACKED = (2, 0, 0, 0, 0)
LAUNCHES_KEYFRAME = (8, 1, 0, 1, 0)      # + the mapping step's and the index add's
LAUNCHES_MAPPING_STEP = (6, 1, 0, 0, 0)  # the mapping step alone (phase 5)
# from frame 0, by frame class; parts that add up where a frame is several
LAUNCHES_ANCHOR = (0, 0, 0, 0, 0)
LAUNCHES_ACCUMULATE = (0, 1, 0, 0, 0)    # the anchor's covisibility counter
LAUNCHES_PAIR = (0, 1, 0, 0, 0)          # try_initialize_pair's match (an attempt)
LAUNCHES_THIRD = (0, 1, 0, 0, 0)         # validate_third_frame's match
LAUNCHES_ADOPTION = (0, 0, 0, 3, 12)     # 12 k-medoid iterations; idf, 2 keyframe adds
LAUNCHES_RETRAIN = (0, 0, 0, 2, 12)      # 12 iterations; idf, all keyframes' histograms
# loop detection on a mapped keyframe once the map holds MinKeyframe
# keyframes: the query's word assignment; where a cluster qualifies, also
# relocalize's B = 4 two-way match and its stacked rematch
LAUNCHES_DETECTION = (0, 0, 0, 1, 0)
LAUNCHES_DETECTION_RELOC = (1, 1, 0, 0, 0)
# a lost frame's relocalization: the stacked rematch and track-local-map's
# match, the B = 4 two-way match, the query's word assignment
LAUNCHES_RELOC = (2, 1, 0, 1, 0)
LAUNCHES_STEREO_PAIR = (0, 1, 0, 0, 0)   # stereo_initialize's pair match (B = 1)
INIT_LAST = 54                     # frames 0..INIT_LAST from frame 0
INIT_PROFILE_LAST = 14             # the traced pass runs to the retrain
SCALE_TOL = 0.05                   # |s_jax / s_port - 1| at adoption
POINT_VALID_BOUND = 6              # of ~290 adopted points: 2 %
IDF_ATOL = 1e-6
MAX_INIT_MS = 330                  # golden MaxInitializationIntervalMilliseconds
TRACKED_TOL = 3
PROFILE_FRAMES = 8
# NVIDIA H100 SXM data sheet (dense): HBM rate, int8 tensor-core rate (the
# ±1 bit product's densest form), float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
F32_OPS_PER_S = 67e12
# radius_match_stages' tensor arguments, in order, then all its arguments
TENSOR_ARGS = ("query_desc", "query_xy", "query_octave", "query_valid", "target_desc",
               "target_xy", "target_octave", "target_valid", "radius")
RADIUS_ARGS = TENSOR_ARGS + ("max_hamming", "min_diff", "octave_tol", "group_rows")
# few distinct words with close popcounts: distances tie often
LOW_ENTROPY_WORDS = np.array([0, 1, 3, 0x80000000, 0x80000003, 0xFFFF0000], np.uint32)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def random_words(rng: np.random.RandomState, rows: int) -> np.ndarray:
    """(rows, 8) full-range uint32 words (bit 31 set about half the time)."""
    return rng.randint(0, 2**32, size=(rows, 8), dtype=np.uint64).astype(np.uint32)


def radius_case(rng: np.random.RandomState, n_stages: int, n_query: int,
                n_target: int) -> dict:
    """numpy inputs of `radius_match_stages` that reach its edge cases:
    low-entropy descriptors (ties at best and at second), a third of the
    queries copying a target near it (exact matches), integer positions and
    radii (targets exactly on a box edge), invalid queries and targets, and
    queries parked far from every target (rows with no candidate)."""
    side = int(2 * np.sqrt(n_target)) + 4
    t_desc = LOW_ENTROPY_WORDS[rng.randint(0, 6, (n_target, 8))]
    t_xy = rng.randint(0, side, (n_target, 2)).astype(np.float32)
    t_xy[rng.rand(n_target) < 0.3] += 0.5
    q_desc = LOW_ENTROPY_WORDS[rng.randint(0, 6, (n_query, 8))]
    q_xy = np.repeat(rng.randint(0, side, (1, n_query, 2)), n_stages, 0).astype(np.float32)
    if n_target:
        copy = np.flatnonzero(rng.rand(n_query) < 0.3)
        src = rng.randint(0, n_target, copy.size)
        q_desc[copy] = t_desc[src]
        q_xy[:, copy] = t_xy[src] + rng.randint(-2, 3, (copy.size, 2))
    moved = rng.rand(n_stages, n_query) < 0.5
    moved[0] = False
    q_xy[moved] = rng.randint(0, side, (int(moved.sum()), 2))
    q_xy[:, rng.rand(n_query) < 0.1] = 1e4
    return {
        "query_desc": q_desc.view(np.int32),
        "query_xy": q_xy,
        "query_octave": rng.randint(0, 2, n_query).astype(np.int32),
        "query_valid": rng.rand(n_query) < 0.85,
        "target_desc": t_desc.view(np.int32),
        "target_xy": t_xy,
        "target_octave": rng.randint(0, 2, n_target).astype(np.int32),
        "target_valid": rng.rand(n_target) < 0.85,
        "radius": rng.choice(np.float32([0, 1, 2, 4, 8]), (n_stages, n_query)),
    }


def dedup_case(rng: np.random.RandomState, n_stages: int, n_query: int,
               n_target: int) -> dict:
    """numpy inputs of `radius_match_stages` that pile the claims onto few
    targets: every query valid and an exact copy of one of the first or the
    last seven targets, every pair a candidate. Under gates (256, -1) every
    row claims, claims on one target tie at the best distance, and a bank
    wider than Q + 2 puts claims past the dedup reference's table."""
    case = radius_case(rng, n_stages, n_query, n_target)
    src = rng.randint(0, 7, n_query) + np.where(rng.rand(n_query) < 0.5, n_target - 7, 0)
    case.update(query_desc=case["target_desc"][np.clip(src, 0, n_target - 1)],
                query_valid=np.ones(n_query, bool), target_valid=np.ones(n_target, bool),
                query_octave=np.zeros(n_query, np.int32),
                target_octave=np.zeros(n_target, np.int32),
                query_xy=np.zeros_like(case["query_xy"]),
                target_xy=np.zeros_like(case["target_xy"]),
                radius=np.ones_like(case["radius"]))
    return case


def candidates(a: dict, octave_tol: int) -> torch.Tensor:
    """(S, Q, T) bool: the pairs each stage may match, from a dict of
    `radius_match_stages`' tensor arguments."""
    from mageslam_tpu_torch.ops.matching import candidate_mask

    return candidate_mask(*(a[k] for k in ("query_xy", "query_octave", "query_valid",
                                            "target_xy", "target_octave", "target_valid",
                                            "radius")), octave_tol)


def case_stats(a: dict, octave_tol: int) -> dict:
    """How many rows and pairs of a case reach each edge: rows with no
    candidate, rows whose best distance ties, candidates exactly on the
    box edge."""
    from mageslam_tpu_torch.ops.hamming import hamming_matrix_plain

    cand = candidates(a, octave_tol)
    d = torch.where(cand, hamming_matrix_plain(a["query_desc"], a["target_desc"])[None],
                    1 << 20)
    two = d.topk(2, dim=-1, largest=False).values if d.shape[-1] > 1 else None
    edge = (a["query_xy"][:, :, None, :] - a["target_xy"][None, None, :, :]).abs()
    return {
        "rows_without_candidate": int((~cand.any(-1)).sum()),
        "rows_tied_at_best": 0 if two is None else int(
            ((two[..., 0] == two[..., 1]) & (two[..., 0] < 1 << 20)).sum()),
        "candidates_on_the_edge": int((cand & (edge.amax(-1) == a["radius"][:, :, None])).sum()),
    }


def cuda_ms(fn, iters: int = 200, warmup: int = 20, reps: int = 5) -> float:
    """Median over `reps` of the mean time of `iters` back-to-back calls,
    from CUDA events, after warmup."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / iters)
    return statistics.median(times)


PLAIN_ITERS = 10   # the plain versions take milliseconds a call


def in_turns(kernel, plain) -> tuple[float, float, str]:
    """(kernel ms, plain ms, report): each timed twice, kernel, plain, plain,
    kernel; the better of each pair."""
    k1 = cuda_ms(kernel)
    p1, p2 = (cuda_ms(plain, iters=PLAIN_ITERS, warmup=2) for _ in range(2))
    k2 = cuda_ms(kernel)
    return min(k1, k2), min(p1, p2), (f"kernel {k1:.5f} / {k2:.5f} ms, plain {p1:.5f} / "
                                      f"{p2:.5f} ms (kernel, plain, plain, kernel; "
                                      f"median of 5 x 200 calls, plain 5 x {PLAIN_ITERS})")


def _device_us(e) -> float:
    """A device event's time in microseconds (the attribute was renamed from
    cuda_time_total to device_time_total across PyTorch versions)."""
    for n in ("device_time_total", "cuda_time_total"):
        if hasattr(e, n):
            return float(getattr(e, n))
    return 0.0


def profile(fn) -> list:
    """The device events of one traced call of `fn`."""
    from torch.profiler import ProfilerActivity, profile as trace

    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type.name == "CUDA"]


def launch_us(fn, kernel_name: str, launches: int = 20) -> float | None:
    """Mean device time of one launch of `kernel_name`, over `launches`
    calls of `fn` under the profiler; None where the trace holds no device
    time for it (reported as not measured)."""
    times = [_device_us(e) for e in profile(lambda: [fn() for _ in range(launches)])
             if kernel_name in e.name]
    if times and sum(times) > 0:
        return sum(times) / len(times)
    return None


def traced_pair(kernel, composite, kernel_name: str, calls: int = 20) -> dict:
    """One profiler session over `calls` calls of `kernel`, a marker kernel
    (`torch.cuda._sleep`'s spin kernel), then `calls` calls of the
    `composite` it replaces: the mean device time of the kernel's launches
    (`kernel_name`) and of the launches of that name inside the composite,
    the launches traced in each part, and the composite's device events
    and device time a call. None where the trace holds no device time
    (reported as not measured)."""
    events = profile(lambda: ([kernel() for _ in range(calls)], torch.cuda._sleep(1000),
                              [composite() for _ in range(calls)]))
    events.sort(key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
    named = [i for i, e in enumerate(events) if kernel_name in e.name]
    split = marks[0] if marks else (named[calls - 1] + 1 if len(named) >= calls else 0)
    first, rest = events[:split], events[split + bool(marks):]

    def mean(xs):
        return sum(xs) / len(xs) if xs and sum(xs) > 0 else None

    mine = [_device_us(e) for e in first if kernel_name in e.name]
    inner = [_device_us(e) for e in rest if kernel_name in e.name]
    composite_us = sum(_device_us(e) for e in rest)
    return {"us": mean(mine), "us_in_composite": mean(inner), "launches_traced": len(mine),
            "composite_events": len(rest) / calls if rest else None,
            "composite_us": composite_us / calls if composite_us > 0 else None}


def us_text(us: float | None) -> str:
    return "not measured" if us is None else f"{us:.2f} us"


def bound(n_bytes: float, f32_ops: float = 0.0, int8_ops: float = 0.0) -> tuple[float, str]:
    """(least ms the card could take, what sets it): the larger of the bytes
    over the HBM rate and each operation count over its peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(f32_ops / F32_OPS_PER_S, int8_ops / INT8_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def call_device_us(fn, calls: int = 20) -> tuple[float | None, list[str]]:
    """(mean device time of one call of `fn` over all the kernels it
    launches, their names), over `calls` traced calls; None where the trace
    holds no device time. For a library call whose kernels are not ours."""
    events = [e for e in profile(lambda: [fn() for _ in range(calls)])
              if _device_us(e) > 0 and "memcpy" not in e.name.lower()
              and "memset" not in e.name.lower()]
    total = sum(_device_us(e) for e in events)
    return (total / calls if total > 0 else None), sorted({e.name for e in events})


def check_hamming(device) -> dict:
    """The standalone Hamming kernel against its plain version, exact, on
    full-range words at every listed shape and on low-entropy words; then
    timed at HAMMING_TIMED beside `torch._int_mm` of the ±1 bits."""
    from mageslam_tpu_torch.ops import hamming

    rng = np.random.RandomState(0)
    max_err = 0
    cases = [(n, m, False) for n, m in KERNEL_SHAPES + (BANK_SHAPE, BOW_SHAPE) + BOW_SHAPES]
    cases += [(1000, 440, True), (BANK_SHAPE[0], BANK_SHAPE[1], True)]
    for n, m, low in cases:
        if low:   # few distinct words: equal rows and columns, distances 0 and repeats
            a, b = (torch.from_numpy(LOW_ENTROPY_WORDS[rng.randint(0, 6, (r, 8))].view(np.int32))
                    .to(device) for r in (n, m))
        else:
            a = torch.from_numpy(random_words(rng, n).view(np.int32)).to(device)
            b = torch.from_numpy(random_words(rng, m).view(np.int32)).to(device)
        got = hamming.hamming_matrix(a, b)
        want = hamming.hamming_matrix_plain(a, b)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        if got.shape != (n, m) or got.dtype != torch.int32 or err != 0:
            raise AssertionError(f"hamming kernel != plain at ({n}, {m}): max err {err}")
        if not bool(((got >= 0) & (got <= 256)).all()):
            raise AssertionError(f"hamming kernel out of range at ({n}, {m})")
        max_err = max(max_err, err)
        phase("kernel", f"hamming ({n}, {m}){' low-entropy words' if low else ''}: equal to "
                        f"plain (max abs err {err})")
    rows = {}
    for n, m in HAMMING_TIMED:
        a = torch.from_numpy(random_words(rng, n).view(np.int32)).to(device)
        b = torch.from_numpy(random_words(rng, m).view(np.int32)).to(device)
        rows[(n, m)] = time_hamming(a, b, f"({n}, {m})")
    return {"max_abs_err": max_err, "rows": rows}


def time_hamming(a: torch.Tensor, b: torch.Tensor, where: str) -> dict:
    """The standalone Hamming kernel on (a, b): kernel and plain in turns,
    `torch._int_mm` of the ±1 bits beside it, device time a launch of each,
    and the bound."""
    from mageslam_tpu_torch.ops import hamming

    n, m = a.shape[0], b.shape[0]
    with KeptLaunches():
        t_kernel, t_plain, report = in_turns(lambda: hamming.hamming_matrix(a, b),
                                             lambda: hamming.hamming_matrix_plain(a, b))
        # library yardstick: ±1 int8 bits, (N, 256) x (256, M) -> 256 - 2 * Hamming
        a_pm = hamming.pm_bits(a)
        b_pm_t = hamming.pm_bits(b).t()   # column-major (256, M), as cuBLASLt takes it
        if not torch.equal(torch._int_mm(a_pm, b_pm_t),
                           256 - 2 * hamming.hamming_matrix(a, b)):
            raise AssertionError(f"_int_mm yardstick != 256 - 2 * hamming at {where}")
        t_library = cuda_ms(lambda: torch._int_mm(a_pm, b_pm_t))
        us = launch_us(lambda: hamming.hamming_matrix(a, b), "hamming_kernel")
        lib_us, lib_kernels = call_device_us(lambda: torch._int_mm(a_pm, b_pm_t))
    bound_ms, bound_by = bound((n + m) * 32 + n * m * 4, int8_ops=2 * 256 * n * m)
    share = "not measured" if us is None else f"{bound_ms * 1e3 / us:.3f} of the bound"
    phase("kernel", f"hamming {where}: {report}; torch._int_mm {t_library:.5f} ms; "
                    f"device {us_text(us)} a launch, {share}; torch._int_mm device "
                    f"{us_text(lib_us)} a call ({', '.join(lib_kernels)}) (profiler); "
                    f"bound {bound_ms * 1e3:.3f} us ({bound_by})")
    return {"shape": [n, m], "ms": t_kernel, "plain_ms": t_plain, "library_ms": t_library,
            "device_us": us, "library_device_us": lib_us, "library_kernels": lib_kernels,
            "bound_ms": bound_ms, "bound_by": bound_by}


class KeptLaunches:
    """Leaves the launch counts as they were before the with-block: launches
    made to compare or time a kernel are not a path's."""

    def __enter__(self):
        self.saved = launch_counts()
        return self

    def __exit__(self, *exc):
        from mageslam_tpu_torch.ops import bow_words, hamming, matching

        (matching.LAUNCHES, matching.TWO_WAY_LAUNCHES, hamming.LAUNCHES,
         bow_words.ASSIGN_LAUNCHES, bow_words.STEP_LAUNCHES) = self.saved


def minimal_launch(device) -> dict:
    """The device time of the least launch there is, a one-element add_:
    what a latency-bound kernel can reach, beside the bounds."""
    x = torch.zeros(1, device=device)
    us, names = call_device_us(lambda: x.add_(1))
    ms = cuda_ms(lambda: x.add_(1))
    phase("kernel", f"minimal launch (one-element add_): {ms:.5f} ms a call (CUDA events), "
                    f"device {us_text(us)} a launch ({', '.join(names)}) (profiler)")
    return {"ms": ms, "device_us": us}


def bow_case(rng: np.random.RandomState, rows: int, words: int = 64,
             low: bool = False) -> tuple:
    """(desc, valid, anchors) numpy inputs of the bag-of-words kernels:
    full-range or low-entropy words (ties at the best anchor), 85 % valid,
    the anchors drawn from the rows as the k-medoid's init draws them."""
    desc = (LOW_ENTROPY_WORDS[rng.randint(0, 6, (max(rows, words), 8))] if low
            else random_words(rng, max(rows, words)))
    anchors = desc[rng.permutation(desc.shape[0])[:words]]
    return (desc[:rows].view(np.int32), rng.rand(rows) < 0.85, anchors.view(np.int32))


def bow_tensors(case: tuple, device) -> tuple:
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in case)


def vocab_step_composite(desc, valid, anchors, bits, hamming_fn):
    """The k-medoid iteration as the path ran it before bow_words.cu: the
    (N, V) matrix from `hamming_fn`, then the eager epilogue."""
    from mageslam_tpu_torch.ops import bow_words

    d = torch.where(valid[:, None], hamming_fn(desc, anchors), bow_words.BIG)
    member = torch.nn.functional.one_hot(torch.argmin(d, dim=1), anchors.shape[0]) \
        .to(torch.bool) & valid[:, None]
    new = bow_words.majority_descriptors(bits, member)
    return torch.where(member.any(0)[:, None], new, anchors).contiguous()


def check_bow_words(device) -> dict:
    """Both bag-of-words kernels against their plain versions, exact: word
    assignment at the path's row counts and edges (R = 0, 1, 17, ties,
    every row invalid, 5 anchors), the k-medoid iteration at the pools'
    sizes, 12 iterations chained, an empty word, an all-invalid pool and
    N = 0. Returns the max abs errors (0)."""
    from mageslam_tpu_torch.ops import bow_words

    rng = np.random.RandomState(11)
    with KeptLaunches():
        cases = [(r, 64, False, 0.85) for r in BOW_ASSIGN_ROWS]
        cases += [(0, 64, False, 0.85), (1, 64, False, 0.85), (17, 64, False, 0.85),
                  (1000, 64, True, 0.85), (512, 64, False, 0.0), (300, 5, True, 0.85)]
        for rows, words, low, share in cases:
            desc, valid, anchors = bow_tensors(bow_case(rng, rows, words, low), device)
            valid = valid & (torch.rand(rows, device=device) < share)
            got = bow_words.assign(desc, valid, anchors)
            want = bow_words.assign_plain(desc, valid, anchors)
            torch.cuda.synchronize()
            if got.shape != (rows,) or got.dtype != torch.int32 or not torch.equal(got, want):
                raise AssertionError(f"bow assign kernel != plain at R={rows}, V={words}")
            phase("kernel", f"bow assign R={rows} V={words}{' low-entropy' if low else ''} "
                            f"valid share {share}: equal to plain")
        for rows, low, note in ((1024, False, ""), (7680, False, ""), (7680, True, " low-entropy"),
                                (0, False, " no row"), (700, False, " every row invalid"),
                                (700, True, " an empty word")):
            desc, valid, anchors = bow_tensors(bow_case(rng, rows, 64, low), device)
            if "invalid" in note:
                valid = torch.zeros_like(valid)
            if "empty" in note:   # a repeated anchor: the first copy wins every tie
                anchors[7] = anchors[3]
            got, want = anchors, anchors
            for it in range(12):
                got = bow_words.vocab_step(desc, valid, got)
                want = bow_words.vocab_step_plain(desc, valid, want)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"bow vocab_step kernel != plain at N={rows}{note}, "
                                         f"iteration {it}")
            phase("kernel", f"bow vocab_step N={rows}{note}: 12 iterations chained, equal to "
                            f"plain after each")
    return {"max_abs_err": 0}


def time_bow_assign(desc, valid, anchors, where: str) -> dict:
    """The word-assignment kernel on one call's inputs: kernel and plain in
    turns, the composites it replaces (hamming.cu or `torch._int_mm`, then
    argmin and where), device time a launch, the bound."""
    from mageslam_tpu_torch.ops import bow_words, hamming

    rows, words = desc.shape[0], anchors.shape[0]
    with KeptLaunches():
        t_kernel, t_plain, report = in_turns(
            lambda: bow_words.assign(desc, valid, anchors),
            lambda: bow_words.assign_plain(desc, valid, anchors))
        a_pm, b_pm_t = hamming.pm_bits(desc), hamming.pm_bits(anchors).t()

        def with_hamming():
            return torch.where(valid, torch.argmin(hamming.hamming_matrix(desc, anchors), dim=1)
                               .to(torch.int32), -1)

        def with_int_mm():   # the largest ±1 product is the least distance
            return torch.where(valid, torch.argmax(torch._int_mm(a_pm, b_pm_t), dim=1)
                               .to(torch.int32), -1)

        want = bow_words.assign(desc, valid, anchors)
        if not (torch.equal(with_hamming(), want) and torch.equal(with_int_mm(), want)):
            raise AssertionError(f"bow assign composites != kernel on {where}")
        t_ham = cuda_ms(with_hamming, iters=50)
        t_int = cuda_ms(with_int_mm, iters=50)
        tr = traced_pair(lambda: bow_words.assign(desc, valid, anchors), with_hamming,
                         "bow_assign_kernel")
        us, comp_us = tr["us"], tr["composite_us"]
    bound_ms, bound_by = bound(rows * (32 + 1 + 4) + words * 32,
                               int8_ops=2 * 256 * rows * words)
    phase("kernel", f"bow assign on {where} (R={rows}, V={words}): {report}; composites "
                    f"hamming.cu + argmin + where {t_ham:.5f} ms, torch._int_mm + argmax + "
                    f"where {t_int:.5f} ms; device {us_text(us)} a launch "
                    f"({tr['launches_traced']} launches traced; the hamming.cu composite "
                    f"{us_text(comp_us)} a call) (profiler); bound "
                    f"{bound_ms * 1e3:.3f} us ({bound_by})")
    return {"shape": [rows, words], "ms": t_kernel, "plain_ms": t_plain,
            "composite_hamming_kernel_ms": t_ham, "composite_int_mm_ms": t_int,
            "device_us": us, "composite_device_us": comp_us, "bound_ms": bound_ms,
            "bound_by": bound_by}


def time_vocab_step(desc, valid, anchors, where: str) -> dict:
    """The k-medoid kernel on one iteration's inputs: kernel and plain in
    turns, the composite it replaces (hamming.cu and the eager epilogue),
    device time a launch and device events a call of each, the bound."""
    from mageslam_tpu_torch.ops import bow_words, hamming

    rows, words = desc.shape[0], anchors.shape[0]
    bits = bow_words.descriptor_bits(desc)
    with KeptLaunches():
        t_kernel, t_plain, report = in_turns(
            lambda: bow_words.vocab_step(desc, valid, anchors),
            lambda: bow_words.vocab_step_plain(desc, valid, anchors))

        def composite():
            return vocab_step_composite(desc, valid, anchors, bits, hamming.hamming_matrix)

        if not torch.equal(composite(), bow_words.vocab_step(desc, valid, anchors)):
            raise AssertionError(f"bow vocab_step composite != kernel on {where}")
        t_comp = cuda_ms(composite, iters=50)
        tr = traced_pair(lambda: bow_words.vocab_step(desc, valid, anchors), composite,
                         "bow_vocab_step_kernel")
        us = tr["us"]
    # each row read once, the anchors read and written; the ±1 product and
    # one add a (valid row, bit) vote
    bound_ms, bound_by = bound(rows * 33 + 2 * words * 32,
                               f32_ops=256 * int(valid.sum()),
                               int8_ops=2 * 256 * rows * words)
    phase("kernel", f"bow vocab_step on {where} (N={rows}, V={words}): {report}; composite "
                    f"hamming.cu + eager epilogue {t_comp:.5f} ms, {tr['composite_events']} "
                    f"device events and {us_text(tr['composite_us'])} a call; device "
                    f"{us_text(us)} a launch ({tr['launches_traced']} launches traced) "
                    f"(profiler); bound {bound_ms * 1e3:.3f} us "
                    f"({bound_by})")
    return {"shape": [rows, words], "ms": t_kernel, "plain_ms": t_plain,
            "composite_hamming_kernel_ms": t_comp,
            "composite_device_events": tr["composite_events"],
            "composite_device_us": tr["composite_us"], "device_us": us,
            "bound_ms": bound_ms, "bound_by": bound_by}


def _to_device(case: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(case[k])).to(device) for k in TENSOR_ARGS}


def dedup_stats(idx: torch.Tensor, kept: torch.Tensor, group_rows) -> dict:
    """How a case reaches the dedup's edges: claims, claims dropped, claims
    on a key past the reference's Q + 2 table."""
    n_query = idx.shape[1]
    g = n_query if group_rows is None else group_rows
    key = idx + (torch.arange(n_query, device=idx.device) // g * g)[None]
    return {"claims": int((idx >= 0).sum()), "dropped": int(((idx >= 0) & (kept < 0)).sum()),
            "claims_past_the_table": int(((idx >= 0) & (key >= n_query + 2)).sum())}


def match_alone(args: list, max_hamming: int, min_diff: int, octave_tol: int):
    """The plain match of `radius_match_stages`' tensor arguments before
    its dedup: (S, Q) idx and dist."""
    from mageslam_tpu_torch.ops import hamming, matching

    d = hamming.hamming_matrix_plain(args[0], args[4])
    return matching.radius_from_distances(d, *args[1:4], *args[5:9], max_hamming, min_diff,
                                          octave_tol)


def check_radius_match(device) -> int:
    """The fused kernel against its plain version, exact, at every listed
    shape and stage count: with the dedup by target over the whole call and
    in groups of a quarter of the rows (relocalization's stacked
    candidates). Returns the max abs error (0)."""
    from mageslam_tpu_torch.ops import matching

    rng = np.random.RandomState(1)
    reached = {"dropped": 0, "claims_past_the_table": 0}
    with KeptLaunches():
        for n_stages in RADIUS_STAGES:
            for n_query, n_target in RADIUS_SHAPES:
                octave_tol = n_query % 2            # both 0 and 1 occur
                a = _to_device(radius_case(rng, n_stages, n_query, n_target), device)
                gates = (6, 1)
                args = [a[k] for k in TENSOR_ARGS]
                stats = {}
                plain_idx = match_alone(args, *gates, octave_tol)[0]
                for group in (None, max(n_query // 4, 1)):
                    opts = (*gates, octave_tol, group)
                    got = matching.radius_match_stages(*args, *opts)
                    want = matching.radius_match_stages_plain(*args, *opts)
                    torch.cuda.synchronize()
                    for g, w in zip(got, want):
                        if (g.shape != (n_stages, n_query) or g.dtype != torch.int32
                                or not torch.equal(g, w)):
                            raise AssertionError(f"radius_match kernel != plain at S={n_stages}, "
                                                 f"({n_query}, {n_target}), "
                                                 f"group_rows {group}")
                    stats[f"group_rows={group}"] = d = dedup_stats(plain_idx, got[0], group)
                    for k in reached:
                        reached[k] += d[k]
                stats["match"] = case_stats(a, octave_tol)
                phase("kernel", f"radius_match S={n_stages} ({n_query}, {n_target}) "
                                f"octave_tol={octave_tol}: equal to plain, deduplicated "
                                f"whole and in groups; {stats}")
        for n_stages in RADIUS_STAGES:
            for n_query, n_target, group in DEDUP_CASES:
                a = _to_device(dedup_case(rng, n_stages, n_query, n_target), device)
                args = [a[k] for k in TENSOR_ARGS]
                opts = (256, -1, 0, group)
                got = matching.radius_match_stages(*args, *opts)
                want = matching.radius_match_stages_plain(*args, *opts)
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"radius_match kernel != plain on the dedup case "
                                         f"S={n_stages}, ({n_query}, {n_target}), group_rows "
                                         f"{group}")
                alone = match_alone(args, 256, -1, 0)[0]
                d = dedup_stats(alone, got[0], group)
                for k in reached:
                    reached[k] += d[k]
                phase("kernel", f"radius_match dedup case S={n_stages} ({n_query}, {n_target}) "
                                f"group_rows {group}: equal to plain; {d}")
    if not all(reached.values()):
        raise AssertionError(f"the radius-match cases never reached a dedup edge: {reached}")
    return 0


def capture_radius_calls(run) -> list[dict]:
    """The arguments of every `radius_match_stages` call that `run()`
    makes, tensors cloned."""
    from mageslam_tpu_torch.ops import matching
    from mageslam_tpu_torch.tracking import pose_estimation

    calls, real = [], matching.radius_match_stages

    def recording(*args, **kwargs):
        call = dict(zip(RADIUS_ARGS, args), **kwargs)
        calls.append({k: v.clone() if isinstance(v, torch.Tensor) else v
                      for k, v in call.items()})
        return real(*args, **kwargs)

    matching.radius_match_stages = pose_estimation.radius_match_stages = recording
    try:
        run()
    finally:
        matching.radius_match_stages = pose_estimation.radius_match_stages = real
    return calls


def time_radius_calls(calls: list[dict], where: str, expected) -> dict:
    """Holds the fused kernel exactly against its plain version on each
    captured call and times it there: kernel and plain in turns, device
    time a launch, and the bound from the call's own inputs, beside the
    composite of the TPU path's structure. `expected` is the (stages, Q, T)
    of each call, in order."""
    from mageslam_tpu_torch.ops import hamming, matching

    per_call = []
    for c in calls:
        tensors = [c[k] for k in TENSOR_ARGS]
        scalars = (c["max_hamming"], c["min_diff"], c.get("octave_tol", 0))
        group = c.get("group_rows")
        opts = (*scalars, group)
        with KeptLaunches():
            got = matching.radius_match_stages(*tensors, *opts)
            want = matching.radius_match_stages_plain(*tensors, *opts)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"radius_match kernel != plain on the inputs of {where}")
        n_stages, n_query = c["radius"].shape
        n_target = c["target_desc"].shape[0]
        cand = candidates(c, scalars[2])
        # an unbounded box leaves the validity and octave gate
        gated = candidates({**c, "radius": torch.full_like(c["radius"], float("inf"))},
                           scalars[2])[0]
        n_bytes = (n_query * (32 + 4 + 1) + n_stages * n_query * (8 + 4)
                   + n_target * (32 + 8 + 4 + 1) + 2 * n_stages * n_query * 4)
        # per (gated pair, stage): 2 subtractions, 2 comparisons; per pair that
        # is a candidate in some stage: 256 multiply-adds of the ±1 bit product
        bound_ms, bound_by = bound(n_bytes, f32_ops=4 * n_stages * int(gated.sum()),
                                   int8_ops=2 * 256 * int(cand.any(0).sum()))

        def composite():   # the standalone Hamming kernel's matrix, the eager rest
            d = hamming.hamming_matrix(tensors[0], tensors[4])
            return matching.dedup_stages_plain(*matching.radius_from_distances(
                d, *tensors[1:4], *tensors[5:9], *scalars), group)

        with KeptLaunches():
            t_kernel, t_plain, report = in_turns(
                lambda: matching.radius_match_stages(*tensors, *opts),
                lambda: matching.radius_match_stages_plain(*tensors, *opts))
            if not all(torch.equal(g, w) for g, w in zip(composite(), got)):
                raise AssertionError(f"radius_match composite != kernel on {where}")
            t_comp = cuda_ms(composite, iters=50)
            tr = traced_pair(lambda: matching.radius_match_stages(*tensors, *opts), composite,
                             f"radius_match_kernel<{n_stages}>")
            us = tr["us"]
        row = {"stages": n_stages, "shape": [n_query, n_target], "group_rows": group, "ms": t_kernel, "plain_ms": t_plain,
               "composite_ms": t_comp, "composite_device_events": tr["composite_events"],
               "composite_device_us": tr["composite_us"],
               "device_us": us, "bound_ms": bound_ms,
               "bound_by": bound_by, "candidate_pairs": int(cand.any(0).sum()),
               "matched": int((got[0] >= 0).sum())}
        per_call.append(row)
        phase("kernel", f"radius_match on {where}, call S={n_stages} "
                        f"({n_query}, {n_target}) group_rows {group}: equal to "
                        f"plain, {row['matched']} kept; {report}; composite (hamming.cu's "
                        f"matrix + eager match + {n_stages} x eager dedup) {t_comp:.5f} ms, "
                        f"{tr['composite_events']} device events and "
                        f"{us_text(tr['composite_us'])} a call; device {us_text(us)} a "
                        f"launch (profiler); bound "
                        f"{bound_ms * 1e3:.3f} us ({bound_by}; {row['candidate_pairs']} "
                        f"candidate pairs)")
    shapes = tuple((r["stages"], *r["shape"]) for r in per_call)
    if shapes != tuple(expected):
        raise AssertionError(f"{where}: radius_match calls (stages, Q, T) {shapes}, "
                             f"expected {tuple(expected)}")
    return {"calls": per_call,
            **{k: sum(r[k] for r in per_call)
               for k in ("ms", "plain_ms", "composite_ms", "bound_ms")},
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in per_call)
            else "operations"}


def time_radius_path(device, frame: np.ndarray, frame_id: int) -> dict:
    """The fused kernel on the two calls that tracking one frame makes (a
    fresh session from the fixture)."""
    from mageslam_tpu_torch import SlamSession, golden_path_settings

    sess = SlamSession.from_jax_snapshot(FIXTURE, golden_path_settings(), CAM, WIDTH,
                                         HEIGHT, device)
    calls = capture_radius_calls(lambda: sess.process_frame(frame, frame_id * DT, frame_id))
    return time_radius_calls(calls, f"frame {frame_id}", RADIUS_CALLS_TRACKED)


def time_radius_mapping(device) -> dict:
    """The fused kernel on the six calls of the first keyframe event: the
    loop-closure match and the five re-association matches."""
    pre = load_event(device)
    calls = capture_radius_calls(lambda: map_event(pre))
    return time_radius_calls(calls, "the first keyframe event", RADIUS_CALLS_KEYFRAME)


def two_way_case(rng: np.random.RandomState, n_batch: int, n_a: int, n_b: int,
                 shared_a: bool) -> dict:
    """numpy inputs of `match_two_way` that reach its edge cases: low-entropy
    descriptors (ties at best and second in both directions), invalid rows
    and columns, and one batch entry with no valid row at all."""
    a_shape = (n_a, 8) if shared_a else (n_batch, n_a, 8)
    valid_a = rng.rand(n_batch, n_a) < 0.8
    valid_a[-1] = n_batch == 1      # the last entry of a real batch is empty
    return {
        "desc_a": LOW_ENTROPY_WORDS[rng.randint(0, 6, a_shape)].view(np.int32),
        "valid_a": valid_a,
        "desc_b": LOW_ENTROPY_WORDS[rng.randint(0, 6, (n_batch, n_b, 8))].view(np.int32),
        "valid_b": rng.rand(n_batch, n_b) < 0.8,
    }


TWO_WAY_ARGS = ("desc_a", "valid_a", "desc_b", "valid_b")


def check_two_way(device) -> int:
    """The fused two-way kernel against its plain version, exact, at every
    listed batch, shape and min_diff. Returns the max abs error (0)."""
    from mageslam_tpu_torch.ops import matching

    rng = np.random.RandomState(2)
    for n_batch in TWO_WAY_BATCHES:
        for n_a, n_b in TWO_WAY_SHAPES + ((INIT_SHAPE,) if n_batch == 1 else ()):
            for min_diff in TWO_WAY_MIN_DIFFS:
                shared = n_batch > 1 and min_diff == 8   # both layouts of desc_a
                case = two_way_case(rng, n_batch, n_a, n_b, shared)
                args = [torch.from_numpy(np.ascontiguousarray(case[k])).to(device)
                        for k in TWO_WAY_ARGS]
                got = matching.match_two_way(*args, 6, min_diff)
                want = matching.match_two_way_plain(*args, 6, min_diff)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    if (g.shape != (n_batch, n_a) or g.dtype != torch.int32
                            or not torch.equal(g, w)):
                        raise AssertionError(f"two_way_match kernel != plain at B={n_batch}, "
                                             f"({n_a}, {n_b}), min_diff={min_diff}")
                d = torch.stack([matching.hamming_matrix_plain(
                    args[0] if shared else args[0][b], args[2][b]) for b in range(n_batch)])
                d = torch.where(args[1][:, :, None] & args[3][:, None, :] & (d <= 6), d, 1 << 20)
                best_r, best_c = d.amin(2, keepdim=True), d.amin(1, keepdim=True)
                phase("kernel", f"two_way_match B={n_batch} ({n_a}, {n_b}) min_diff={min_diff}"
                                f"{' shared desc_a' if shared else ''}: equal to plain; "
                                f"{int((got[0] >= 0).sum())} matched, rows tied at best "
                                f"{int((((d == best_r) & (d < 1 << 20)).sum(2) > 1).sum())}, "
                                f"columns tied at best "
                                f"{int((((d == best_c) & (d < 1 << 20)).sum(1) > 1).sum())}, "
                                f"rows without candidate {int((best_r >= 1 << 20).sum())}")
    return 0


def load_post_map(device, j: int):
    """The JAX map after the map fixture's event j, as the port's MapState."""
    from mageslam_tpu_torch import interop
    from mageslam_tpu_torch.worldmap.map_state import MapState

    with np.load(MAP_FIXTURE) as z:
        data = {k: z[k] for k in z.files if k.startswith(f"ev{j}_post_map")}
    return interop.unflatten(MapState, f"ev{j}_post_map", data, device)


def load_event(device):
    """(pre_map, pre_pose_history, frame, map_scale, post_map) of the map
    fixture's first event as the port's states on `device`."""
    from mageslam_tpu_torch import interop
    from mageslam_tpu_torch.runtime.pose_history import PoseHistory
    from mageslam_tpu_torch.tracking.frame_state import TrackedFrame
    from mageslam_tpu_torch.worldmap.map_state import MapState

    with np.load(MAP_FIXTURE) as z:
        data = {k: z[k] for k in z.files if k.startswith("ev0_")}
    return (interop.unflatten(MapState, "ev0_pre_map", data, device),
            interop.unflatten(PoseHistory, "ev0_pre_ph", data, device),
            interop.unflatten(TrackedFrame, "ev0_frame", data, device),
            float(data["ev0_map_scale"]), load_post_map(device, 0))


def with_live_tether(pre, distance: float = 3.0, weight: float = 50.0):
    """`pre` with one heavy distance tether between the keyframes in slots 1
    and 2 (no ported path adds a tether yet, so the fixture's map has none)."""
    pre_map = pre[0]
    w = torch.zeros_like(pre_map.tether_weight)
    w[0] = weight
    return (pre_map._replace(
        tether_origin=torch.full_like(pre_map.tether_origin, 1),
        tether_owner=torch.full_like(pre_map.tether_owner, 2),
        tether_kind=torch.zeros_like(pre_map.tether_kind),
        tether_distance=torch.full_like(pre_map.tether_distance, distance),
        tether_weight=w),) + tuple(pre[1:])


def map_event(pre):
    """Map the fixture's first keyframe from `pre` (what `load_event` gives
    for it). Returns (map, pose_history, slot)."""
    from mageslam_tpu_torch import golden_path_settings
    from mageslam_tpu_torch.runtime.mapping_step import mapping

    pre_map, pre_ph, frame, map_scale, _ = pre
    return mapping(golden_path_settings(), WIDTH, HEIGHT, pre_map, pre_ph, frame,
                   map_scale)[:3]


def mask_diffs(got, want) -> dict:
    """{mask: differing entries} over MAP_MASKS of two maps."""
    return {f: int((getattr(got, f) != getattr(want, f)).sum()) for f in MAP_MASKS}


def check_map_event(device, card: str) -> None:
    """Phase 5: the first mapping event against the JAX map after it."""
    pre = load_event(device)
    post = pre[4]
    reset_launch_counts()
    new_map, _, ki = map_event(pre)
    torch.cuda.synchronize()
    launches = launch_counts()
    with np.load(MAP_FIXTURE) as z:
        want_ki = int(z["ev_ki"][0])
    diffs = mask_diffs(new_map, post)
    pose_err = max(float((new_map.kf_pose.R - post.kf_pose.R).abs().max()),
                   float((new_map.kf_pose.t - post.kf_pose.t).abs().max()))
    live = new_map.mp_valid
    point_err = float((new_map.mp_pos - post.mp_pos)[live].abs().max())
    if ki != want_ki or any(diffs.values()):
        raise AssertionError(f"mapping event: slot {ki} (JAX {want_ki}), differing mask "
                             f"entries {diffs}")
    if not (pose_err <= MAP_POSE_ATOL and point_err <= MAP_POINT_ATOL):
        raise AssertionError(f"mapping event: kf_pose err {pose_err:.3g} (limit "
                             f"{MAP_POSE_ATOL}), mp_pos err {point_err:.3g} (limit "
                             f"{MAP_POINT_ATOL})")
    expected = LAUNCHES_MAPPING_STEP
    if launches != expected:
        raise AssertionError(f"mapping event launched {KERNELS} {launches}, expected "
                             f"{expected}")
    phase("mapping", f"first keyframe event from the JAX state: slot {ki}, "
                     f"{int(new_map.kf_valid.sum())} keyframes, {int(live.sum())} points; "
                     f"{', '.join(MAP_MASKS)} equal to the JAX map; kf_pose err "
                     f"{pose_err:.3g} (limit {MAP_POSE_ATOL}), mp_pos err {point_err:.3g} "
                     f"(limit {MAP_POINT_ATOL}); launches {dict(zip(KERNELS, launches))}")
    ms = []
    for _ in range(MAP_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        map_event(pre)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    phase("mapping", f"event wall time (mapping + synchronize): median "
                     f"{statistics.median(ms):.3f} ms, min {min(ms):.3f}, max {max(ms):.3f} "
                     f"over {MAP_REPEATS} repeats; {card}")
    check_tethered_event(pre, new_map, card)
    events = profile(lambda: map_event(pre))
    device_ms = sum(_device_us(e) for e in events) / 1e3
    if not events or device_ms == 0:
        phase("profile", "mapping event: the profiler recorded no device time: not measured")
        return
    ours = {n: [e for e in events if n in e.name]
            for n in ("radius_match_kernel", "two_way_scan_kernel", "two_way_gate_kernel")}
    phase("profile", f"mapping event: {len(events)} device events, {device_ms:.3f} ms of "
                     f"device time; " + ", ".join(
                         f"{n} {len(es)} launches, "
                         f"{sum(_device_us(e) for e in es) / max(len(es), 1):.2f} us each"
                         for n, es in ours.items()) + f"; {card}")


def check_tethered_event(pre, free_map, card: str) -> None:
    """The same event with one live tether in the map, so that local BA
    runs its tether residuals on the card: the tethered keyframes must end
    nearer the tether's distance than without it, with finite poses and the
    same keyframes."""
    def gap(m):
        c = m.kf_pose.center()
        return float(torch.linalg.norm(c[1] - c[2]))

    distance = gap(free_map) - 0.1
    tethered = with_live_tether(pre, distance)
    map_event(tethered)                                   # warm pass
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    held, _, ki = map_event(tethered)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if not (bool(torch.isfinite(held.kf_pose.t).all()) and torch.equal(held.kf_valid, free_map.kf_valid)
            and abs(gap(held) - distance) < 0.75 * abs(gap(free_map) - distance)):
        raise AssertionError(f"tethered mapping event: slot {ki}, keyframes 1-2 are "
                             f"{gap(held):.4f} apart, {gap(free_map):.4f} without the tether, "
                             f"tether distance {distance:.4f}")
    phase("mapping", f"event with one live distance tether (local BA with the tether "
                     f"residuals): keyframes 1-2 end {gap(held):.4f} apart for a tether of "
                     f"{distance:.4f}, {gap(free_map):.4f} without it; wall {ms:.3f} ms (one "
                     f"run after a warm pass); {card}")


def capture_two_way_call(device) -> dict:
    """The arguments of the `match_two_way` call of the first keyframe
    event."""
    from mageslam_tpu_torch.worldmap import new_points

    calls, real = [], new_points.match_two_way

    def recording(*args):
        calls.append([a.clone() if isinstance(a, torch.Tensor) else a for a in args])
        return real(*args)

    new_points.match_two_way = recording
    try:
        map_event(load_event(device))
    finally:
        new_points.match_two_way = real
    if len(calls) != 1:
        raise AssertionError(f"expected one match_two_way call a keyframe, got {len(calls)}")
    return calls[0]


def init_case(rng: np.random.RandomState, n: int, m: int) -> dict:
    """numpy inputs of mono init's `match_two_way` (B = 1): two frames'
    features, 60 % of the second frame's a few bits away from one of the
    first's, in another order, 5 % of either side invalid."""
    a = random_words(rng, n)
    b = random_words(rng, m)
    k = int(0.6 * min(n, m))
    src, dst = rng.permutation(n)[:k], rng.permutation(m)[:k]
    flips = rng.rand(k, 8, 32) < 0.02
    b[dst] = a[src] ^ np.packbits(flips, axis=-1, bitorder="little").view(np.uint32)[..., 0]
    return {"desc_a": a.view(np.int32), "valid_a": rng.rand(1, n) < 0.95,
            "desc_b": b[None].view(np.int32), "valid_b": rng.rand(1, m) < 0.95}


def time_two_way(args: tuple, where: str) -> dict:
    """Holds the fused two-way kernel exactly against its plain version on
    `args` (match_two_way's arguments) and times it there: kernel and plain
    in turns, the two composites it replaces, device time a launch of each
    of its two kernels and the bound."""
    from mageslam_tpu_torch.ops import hamming, matching

    desc_a, valid_a, desc_b, valid_b, max_hamming, min_diff = args
    n_batch, n_b = desc_b.shape[:2]
    n_a = desc_a.shape[-2]
    got = matching.match_two_way(*args)
    want = matching.match_two_way_plain(*args)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"two_way_match kernel != plain on {where}")

    def composite(distances):
        return [matching.two_way_from_distances(distances(b), valid_a[b], valid_b[b],
                                                max_hamming, min_diff)
                for b in range(n_batch)]

    a_of = (lambda b: desc_a) if desc_a.dim() == 2 else (lambda b: desc_a[b])
    a_pm = [hamming.pm_bits(a_of(b)) for b in range(n_batch)]
    b_pm_t = [hamming.pm_bits(desc_b[b]).t() for b in range(n_batch)]

    def with_hamming_kernel():
        return composite(lambda b: hamming.hamming_matrix(a_of(b), desc_b[b]))

    def with_int_mm():
        return composite(lambda b: (256 - torch._int_mm(a_pm[b], b_pm_t[b])) // 2)

    for name, fn in (("hamming.cu", with_hamming_kernel), ("torch._int_mm", with_int_mm)):
        out = fn()
        if not all(torch.equal(torch.stack([o[i] for o in out]), got[i]) for i in (0, 1)):
            raise AssertionError(f"the {name} composite != two_way_match kernel on {where}")
    with KeptLaunches():
        t_kernel, t_plain, report = in_turns(lambda: matching.match_two_way(*args),
                                             lambda: matching.match_two_way_plain(*args))
        t_ham, t_mm = cuda_ms(with_hamming_kernel, iters=50), cuda_ms(with_int_mm, iters=50)
    us_scan = launch_us(lambda: matching.match_two_way(*args), "two_way_scan_kernel")
    us_gate = launch_us(lambda: matching.match_two_way(*args), "two_way_gate_kernel")
    n_bytes = (desc_a.numel() * 4 + n_batch * n_b * 32 + n_batch * (n_a + n_b)
               + 2 * n_batch * n_a * 4)
    # the ±1 bit product, 256 multiply-adds, once for every pair of a valid
    # row and a valid column (the others read BIG whatever their bits)
    pairs = int((valid_a.sum(1) * valid_b.sum(1)).sum())
    bound_ms, bound_by = bound(n_bytes, int8_ops=2 * 256 * pairs)
    share = ("not measured" if us_scan is None or us_gate is None
             else f"{bound_ms * 1e3 / (us_scan + us_gate):.4f} of the bound")
    phase("kernel", f"two_way_match on {where} B={n_batch} ({n_a}, {n_b}), "
                    f"{int(valid_a.sum())} valid rows, {int(valid_b.sum())} valid columns, "
                    f"{int((got[0] >= 0).sum())} matched: {report}; composite "
                    f"of {n_batch} x (hamming.cu + eager epilogue) {t_ham:.5f} ms, of "
                    f"{n_batch} x (torch._int_mm + eager epilogue) {t_mm:.5f} ms (median of "
                    f"5 x 50 calls); device {us_text(us_scan)} (scan) + {us_text(us_gate)} (gate) "
                    f"a call (profiler), {share}; bound {bound_ms * 1e3:.3f} us ({bound_by}; "
                    f"{pairs} valid pairs)")
    return {"shape": [n_batch, n_a, n_b], "valid_pairs": pairs, "ms": t_kernel,
            "plain_ms": t_plain, "composite_hamming_kernel_ms": t_ham,
            "composite_int_mm_ms": t_mm, "device_us_scan": us_scan, "device_us_gate": us_gate,
            "bound_ms": bound_ms, "bound_by": bound_by}


def time_two_way_path(device) -> dict:
    """The fused two-way kernel on the first keyframe event's own inputs."""
    return time_two_way(tuple(capture_two_way_call(device)), "the first keyframe event's call")


def time_two_way_init(device) -> dict:
    """The fused two-way kernel at mono init's shape (440, 440), B = 1."""
    case = init_case(np.random.RandomState(3), *INIT_SHAPE)
    args = tuple(torch.from_numpy(np.ascontiguousarray(case[k])).to(device)
                 for k in TWO_WAY_ARGS)
    return time_two_way(args + INIT_GATES, f"mono init's shape {INIT_SHAPE}")


def run_map_window(device, frames, first_id: int):
    """A session from the frame-30 state over `frames`, keyframes mapped.
    Returns (results, per-frame ms, per-frame launch counts by KERNELS,
    the mapping events' ms, the map after each event)."""
    from mageslam_tpu_torch import SlamSession, golden_path_settings

    sess = SlamSession.from_jax_snapshot(FIXTURE, golden_path_settings(), CAM,
                                         WIDTH, HEIGHT, device)
    map_ms, maps, bows = [], [], []
    inner = sess._insert_keyframe_and_map

    def timed(frame):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inner(frame)
        torch.cuda.synchronize()
        map_ms.append((time.perf_counter() - t0) * 1e3)
        maps.append(sess.map)
        bows.append(sess.bow)

    sess._insert_keyframe_and_map = timed
    results, ms, launches = [], [], []
    for j, img in enumerate(frames):
        i = first_id + j
        before = launch_counts()
        t0 = time.perf_counter()
        results.append(sess.process_frame(img, i * DT, i))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        after = launch_counts()
        launches.append(tuple(a - b for a, b in zip(after, before)))
    return results, ms, launches, map_ms, maps, bows, sess


def check_map_window(device, card: str):
    """Phase 6. Returns the launch counts of the run, by kernel, and the
    session at its end."""
    with np.load(MAP_FIXTURE) as z:
        ref = {k: z[k] for k in z.files if k.startswith(("ref_", "ev_"))}
    first = int(ref["ref_frame_id"][0])
    frames = render_window(first, first + len(ref["ref_frame_id"]))
    run_map_window(device, frames, first)      # warm pass
    reset_launch_counts()
    results, ms, launches, map_ms, maps, bows, sess = run_map_window(device, frames, first)
    totals = counted_launches()
    pose_err, count_err = check_window(results, ref)
    if sess.loop_det_stats["live"]:
        raise AssertionError(f"loop detection ran {sess.loop_det_stats}: the map never holds "
                             f"MinKeyframe keyframes in this window")
    kf = [r.frame_id for r in results if r.is_keyframe]
    if kf != ref["ev_frame_id"].tolist() or len(kf) < 3:
        raise AssertionError(f"keyframes mapped at {kf}, the JAX session's at "
                             f"{ref['ev_frame_id'].tolist()}")
    for r, got in zip(results, launches):
        want = LAUNCHES_KEYFRAME if r.is_keyframe else LAUNCHES_TRACKED
        if got != want:
            raise AssertionError(f"frame {r.frame_id} (keyframe: {r.is_keyframe}) launched "
                                 f"{KERNELS} {got}, expected "
                                 f"{want}")
    for j, got in enumerate(maps):
        diffs = mask_diffs(got, load_post_map(device, j))
        if j == 0 and any(diffs.values()):
            raise AssertionError(f"the map after the first event (frame {kf[0]}) differs "
                                 f"from the JAX map: {diffs}")
        phase("window", f"map after event {j} (frame {kf[j]}): differing mask entries "
                        f"against the JAX map {diffs}; bag-of-words index "
                        f"{check_bow_event(bows[j], j)}")
    tracked_ms = [t for t, r in zip(ms, results) if not r.is_keyframe]
    phase("window", f"frames {first}-{first + len(frames) - 1}: all TRACKING, keyframes "
                    f"mapped at {kf} as in the JAX session, max pose err {pose_err:.3g} "
                    f"(limit {POSE_ATOL}), max tracked diff {count_err} (limit {TRACKED_TOL})")
    phase("window", f"kernel launches: {LAUNCHES_TRACKED} a tracked frame and "
                    f"{LAUNCHES_KEYFRAME} a keyframe frame (radius_match, two_way_match, "
                    f"hamming), asserted on every frame; totals {totals}")
    phase("window", f"tracked frame (process_frame + synchronize): median "
                    f"{statistics.median(tracked_ms):.3f} ms, min {min(tracked_ms):.3f}, max "
                    f"{max(tracked_ms):.3f} over {len(tracked_ms)} frames; mapping event "
                    f"(inside its keyframe's process_frame): median "
                    f"{statistics.median(map_ms):.3f} ms, min {min(map_ms):.3f}, max "
                    f"{max(map_ms):.3f} over {len(map_ms)} events; after one warm pass; {card}")
    phase("window", f"loop detection: gate never live ({sess.loop_det_stats}; at most "
                    f"{int(sess.map.kf_valid.sum())} keyframes, MinKeyframe "
                    f"{sess.settings.LoopClosureSettings.MinKeyframe})")
    return totals, sess


def bow_errors(got, want: dict) -> tuple[int, int, float, float]:
    """(differing anchor words, differing kf_has, idf err, kf_vectors err) of
    the port's index against the JAX index's leaves {field: array}."""
    from mageslam_tpu_torch import interop

    g = interop.to_numpy(got)
    return (int((g["anchors"] != want["anchors"]).sum()),
            int((g["kf_has"] != want["kf_has"]).sum()),
            float(np.abs(g["idf"] - want["idf"]).max()),
            float(np.abs(g["kf_vectors"] - want["kf_vectors"]).max()))


def check_bow_event(got, j: int) -> str:
    """The port's index after the window's event j against the JAX
    session's: anchors and kf_has exact, idf and kf_vectors within 1e-6."""
    from mageslam_tpu_torch import interop
    from mageslam_tpu_torch.bow.index import BowIndex

    with np.load(BOW_FIXTURE) as z:
        want = interop.to_numpy(interop.unflatten(BowIndex, f"ev{j}_post_bow",
                                                  {k: z[k] for k in z.files}, "cpu"))
    anchors, has, idf, vec = bow_errors(got, want)
    if anchors or has or idf > IDF_ATOL or vec > IDF_ATOL:
        raise AssertionError(f"bag-of-words index after event {j}: {anchors} anchor words "
                             f"and {has} kf_has entries differ, idf err {idf:.3g}, "
                             f"kf_vectors err {vec:.3g} (limit {IDF_ATOL})")
    return (f"equal to the JAX index ({int(want['kf_has'].sum())} keyframes; idf err "
            f"{idf:.3g}, kf_vectors err {vec:.3g}, limit {IDF_ATOL})")


def render_window(start: int, stop: int) -> list[np.ndarray]:
    """The benchmark world's frames start..stop-1, clipped and cast to
    uint8 (the port's own copy of the scene, mageslam_tpu_torch/bench_world.py)."""
    from mageslam_tpu_torch import bench_world

    return bench_world.frames(start, stop)


def run_window(device, frames, first_id: int):
    """A session from the fixture, tracked over `frames`. Returns the
    results and each frame's wall time (ms, synchronized)."""
    from mageslam_tpu_torch import SlamSession, golden_path_settings

    sess = SlamSession.from_jax_snapshot(FIXTURE, golden_path_settings(), CAM,
                                         WIDTH, HEIGHT, device)
    results, ms = [], []
    for j, img in enumerate(frames):
        i = first_id + j
        t0 = time.perf_counter()
        results.append(sess.process_frame(img, i * DT, i))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return results, ms, sess.bow


def check_window(results, ref) -> tuple[float, int]:
    """Hold each frame against the stored JAX outputs. Returns (max pose
    error, max tracked-count difference)."""
    pose_err, count_err = 0.0, 0
    for j, r in enumerate(results):
        fid = int(ref["ref_frame_id"][j])
        if r.frame_id != fid or r.state.name != "TRACKING" or r.pose is None:
            raise AssertionError(f"frame {fid}: {r.state.name}, expected TRACKING")
        if r.is_keyframe != bool(ref["ref_is_kf"][j]):
            raise AssertionError(f"frame {fid}: is_keyframe {r.is_keyframe}, JAX "
                                 f"{bool(ref['ref_is_kf'][j])}")
        R = r.pose.R.cpu().numpy()
        t = r.pose.t.cpu().numpy()
        if R.shape != (3, 3) or t.shape != (3,) or not (np.isfinite(R).all()
                                                        and np.isfinite(t).all()):
            raise AssertionError(f"frame {fid}: pose not finite or misshapen")
        err = max(float(np.abs(R - ref["ref_R"][j]).max()),
                  float(np.abs(t - ref["ref_t"][j]).max()))
        d_count = abs(r.tracked_count - int(ref["ref_tracked"][j]))
        if err > POSE_ATOL or d_count > TRACKED_TOL:
            raise AssertionError(f"frame {fid}: pose err {err:.3g} (limit {POSE_ATOL}),"
                                 f" tracked {r.tracked_count} vs JAX "
                                 f"{int(ref['ref_tracked'][j])}")
        pose_err, count_err = max(pose_err, err), max(count_err, d_count)
    return pose_err, count_err


def profile_window(device, frames, first_id: int, card: str) -> None:
    """Device events and device time per frame over PROFILE_FRAMES frames."""
    from mageslam_tpu_torch import SlamSession, golden_path_settings

    sess = SlamSession.from_jax_snapshot(FIXTURE, golden_path_settings(), CAM,
                                         WIDTH, HEIGHT, device)
    events = profile(lambda: [sess.process_frame(frames[j], (first_id + j) * DT, first_id + j)
                              for j in range(PROFILE_FRAMES)])
    device_ms = sum(_device_us(e) for e in events) / 1e3
    if not events or device_ms == 0:
        phase("profile", "the profiler recorded no device time: not measured")
        return
    fused = [e for e in events if "radius_match_kernel" in e.name]
    phase("profile", f"{PROFILE_FRAMES} frames: {len(events) / PROFILE_FRAMES:.1f} device "
                     f"events a frame, {device_ms / PROFILE_FRAMES:.3f} ms of device time a "
                     f"frame; radius_match_kernel {len(fused)} launches, "
                     f"{sum(_device_us(e) for e in fused) / max(len(fused), 1):.2f} us "
                     f"each; {card}")


class CountingDraws:
    """A session's draw source that counts the draws of each kind."""

    def __init__(self, inner):
        self.inner = inner
        self.counts = {"init": 0, "pnp": 0, "vocab": 0, "reloc": 0}

    def gumbel(self, kind: str, shape):
        self.counts[kind] += 1
        return self.inner.gumbel(kind, shape)

    def position(self):
        return dict(self.counts), self.inner.position()

    def rewind(self, position) -> None:
        counts, inner = position
        self.counts = dict(counts)
        self.inner.rewind(inner)


def launch_counts() -> tuple[int, ...]:
    """The launch counts so far, by KERNELS."""
    from mageslam_tpu_torch.ops import bow_words, hamming, matching

    return (matching.LAUNCHES, matching.TWO_WAY_LAUNCHES, hamming.LAUNCHES,
            bow_words.ASSIGN_LAUNCHES, bow_words.STEP_LAUNCHES)


def reset_launch_counts() -> None:
    from mageslam_tpu_torch.ops import bow_words, hamming, matching

    hamming.LAUNCHES = matching.LAUNCHES = matching.TWO_WAY_LAUNCHES = 0
    bow_words.ASSIGN_LAUNCHES = bow_words.STEP_LAUNCHES = 0


def counted_launches() -> dict:
    """{kernel: launches so far}, by KERNELS."""
    return dict(zip(KERNELS, launch_counts()))


def expected_launches(obs: dict) -> tuple[str, tuple[int, int, int]]:
    """A frame's class and the launches it must make, from what the session
    did on it: the parts of each class it belongs to, added up."""
    parts, name = [], ""
    if not obs["was_init"]:
        name = "keyframe" if obs["keyframe"] else "tracked"
        parts.append(LAUNCHES_KEYFRAME if obs["keyframe"] else LAUNCHES_TRACKED)
    elif obs["anchor"]:
        name = "anchor"
        parts.append(LAUNCHES_ANCHOR)
    else:
        name = "accumulate"
        parts.append(LAUNCHES_ACCUMULATE)
        if obs["draws"]["init"]:
            name = "attempt"
            parts.append(LAUNCHES_PAIR)
        if obs["draws"]["pnp"]:
            name += " with third-frame check"
            parts.append(LAUNCHES_THIRD)
        if obs["adopted"]:
            name = "adoption"
            parts.append(LAUNCHES_ADOPTION)
    if obs["retrained"]:
        name += " + retrain"
        parts.append(LAUNCHES_RETRAIN)
    if obs.get("detections"):
        name += " + detection"
        parts.append(LAUNCHES_DETECTION)
    if obs.get("qualified"):
        name += " (qualified)"
        parts.append(LAUNCHES_DETECTION_RELOC)
    return name, tuple(sum(p[k] for p in parts) for k in range(len(KERNELS)))


class Patched:
    """Replace `module.name` by `wrap(current)` for a with-block, target
    after target (a later wrap of the same name wraps the earlier one)."""

    def __init__(self, *targets):
        self.targets = targets     # (module, name, wrap)
        self.saved = []

    def __enter__(self):
        for m, n, wrap in self.targets:
            self.saved.append((m, n, getattr(m, n)))
            setattr(m, n, wrap(getattr(m, n)))
        return self

    def __exit__(self, *exc):
        for m, n, real in reversed(self.saved):
            setattr(m, n, real)


def call_recorder(calls: list, kind: str, where: str):
    """A wrap for a kernel wrapper that records each call as (kind, where,
    its arguments bound to positions with the defaults applied, tensors
    cloned)."""
    import functools
    import inspect

    def wrap(real):
        sig = inspect.signature(real)

        @functools.wraps(real)
        def call(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            calls.append((kind, where, [a.clone() if isinstance(a, torch.Tensor) else a
                                        for a in bound.arguments.values()]))
            return real(*args, **kwargs)
        return call
    return wrap


def bow_recorders(calls: list, where: str | None = None):
    """Patch targets recording every call of the two bag-of-words kernels'
    wrappers (word assignment, the k-medoid iteration)."""
    from mageslam_tpu_torch.bow import vocab
    from mageslam_tpu_torch.ops import bow_words

    return [(bow_words, "assign", call_recorder(calls, "bow_assign", where or "word assignment")),
            (vocab, "vocab_step", call_recorder(calls, "bow_vocab_step",
                                                where or "vocabulary training"))]


def init_call_recorders(calls: list):
    """Patch targets recording every two-way call of mono init and every
    bag-of-words kernel call, tensors cloned, with where."""
    from mageslam_tpu_torch.runtime import init_step
    from mageslam_tpu_torch.tracking import map_init

    return [(init_step, "match_two_way",
             call_recorder(calls, "two_way", "covisibility counter")),
            (map_init, "match_two_way", call_recorder(calls, "two_way", "pair or third frame")),
            *bow_recorders(calls)]


def wall_timers(times: dict):
    """Patch targets timing (synchronized wall ms) each attempt, adoption and
    retrain, by frame."""
    from mageslam_tpu_torch.runtime import init_step

    def timer(name):
        def wrap(real):
            def call(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = real(*args, **kwargs)
                torch.cuda.synchronize()
                times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
                return out
            return call
        return wrap

    return [(init_step, "_attempt", timer("attempt")), (init_step, "adopt", timer("adoption")),
            (init_step, "retrain_index", timer("retrain"))]


def top_kernels(events, n: int = 4) -> list[tuple[str, int, float]]:
    """The n device kernels with the most device time: (name, launches, ms)."""
    by_name = {}
    for e in events:
        count, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (count + 1, us + _device_us(e))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:n]
    return [(name[:60], count, round(us / 1e3, 3)) for name, (count, us) in top]


def device_tracers(traces: dict, names):
    """Patch targets tracing each call of init_step's `names` under
    torch.profiler: (device events, device ms, top kernels) a call."""
    from mageslam_tpu_torch.runtime import init_step

    def tracer(name):
        def wrap(real):
            def call(*args, **kwargs):
                out = []
                events = profile(lambda: out.append(real(*args, **kwargs)))
                traces.setdefault(name, []).append(
                    (len(events), sum(_device_us(e) for e in events) / 1e3,
                     top_kernels(events)))
                return out[0]
            return call
        return wrap

    return [(init_step, n, tracer(label)) for n, label in names]


def detection_counter(count: list):
    """A patch target counting the session's loop detections in count[0]:
    each launches the query's word assignment, live or not."""
    from mageslam_tpu_torch.runtime import streaming

    def wrap(real):
        def call(*args, **kwargs):
            count[0] += 1
            return real(*args, **kwargs)
        return call
    return (streaming, "detect_loop", wrap)


def run_from_frame0(device, frames, draws, patches=(), cam=CAM, size=(WIDTH, HEIGHT),
                    timestamps=None, settings=None, camera=None, feed=None) -> dict:
    """A bare session (no snapshot) over `frames` from frame 0 with `draws`:
    results, per-frame launches, wall ms and what the session did on each
    frame, and the states it passed through. Frame i's timestamp is
    timestamps[i], by default i * DT. `settings` (golden by default) and
    `camera` (a (16,) model) go to the session; `feed(sess, i, timestamp)`,
    where given, runs before frame i (a visual-inertial run's samples)."""
    from mageslam_tpu_torch import SlamSession, golden_path_settings
    from mageslam_tpu_torch.runtime import init_step

    counting = CountingDraws(draws)
    sess = SlamSession(settings or golden_path_settings(), cam, *size, device, draws=counting,
                       camera=camera)
    out = {"results": [], "launches": [], "obs": [], "ms": [], "sess": sess}

    def keep_result(real):
        def adopt(s, res, *args):
            out["adopt_result"] = res
            return real(s, res, *args)
        return adopt

    detections = [0]
    with Patched((init_step, "adopt", keep_result), detection_counter(detections), *patches):
        for i, img in enumerate(frames):
            was_init, retrained = not sess.initialized, sess.bow_training.retrained
            drawn = dict(counting.counts)
            stats, ran = dict(sess.loop_det_stats), detections[0]
            ts = i * DT if timestamps is None else float(timestamps[i])
            if feed is not None:
                feed(sess, i, ts)
            before = launch_counts()
            t0 = time.perf_counter()
            r = sess.process_frame(img, ts, i)
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["launches"].append(tuple(a - b for a, b in zip(launch_counts(), before)))
            out["results"].append(r)
            meta = sess.init_window.anchor_meta
            obs = {"was_init": was_init, "keyframe": r.is_keyframe,
                   "anchor": was_init and not sess.initialized and meta[0] == i,
                   "adopted": was_init and sess.initialized,
                   "retrained": sess.bow_training.retrained and not retrained,
                   "draws": {k: counting.counts[k] - drawn[k] for k in drawn},
                   "detections": detections[0] - ran,
                   **{k: sess.loop_det_stats[k] - stats[k] for k in ("live", "qualified")}}
            out["obs"].append(obs)
            if obs["adopted"]:
                out.update(adopt_frame=i, adopt_bow=sess.bow, adopt_scale=sess.map_scale,
                           anchor_ts=meta[1])
            if obs["retrained"]:
                out.update(retrain_frame=i, retrain_bow=sess.bow)
    return out


def check_launch_classes(run: dict, where: str) -> dict:
    """Each frame's launches against its class's. Returns {class: launches}."""
    seen = {}
    for r, obs, got in zip(run["results"], run["obs"], run["launches"]):
        name, want = expected_launches(obs)
        if got != want:
            raise AssertionError(f"{where}, frame {r.frame_id} ({name}): launched "
                                 f"{KERNELS} {got}, expected "
                                 f"{want}")
        seen.setdefault(name, want)
    return seen


def hold_frame(r, want: dict, j: int, k: float) -> tuple[float, int]:
    """A frame against the JAX outputs at row j, t scaled by k. Returns
    (pose error, tracked-count difference)."""
    err, d_count = frame_error(r, want, j, k)
    if err > POSE_ATOL or d_count > TRACKED_TOL:
        raise AssertionError(f"frame {r.frame_id}: pose err {err:.3g} (t scaled by {k:.6f}; "
                             f"limit {POSE_ATOL}), tracked {r.tracked_count} vs JAX "
                             f"{int(want['tracked'][j])}")
    return err, d_count


def frame_error(r, want: dict, j: int, k: float) -> tuple[float, int]:
    """A frame's (pose error, tracked-count difference) against the JAX
    outputs at row j, t scaled by k; a differing state or keyframe flag, or
    a pose that is not finite, raises."""
    fid = r.frame_id
    if r.state.value != int(want["state"][j]) or r.is_keyframe != bool(want["is_kf"][j]):
        raise AssertionError(f"frame {fid}: {r.state.name}, keyframe {r.is_keyframe}; JAX "
                             f"state {int(want['state'][j])}, keyframe {bool(want['is_kf'][j])}")
    d_count = abs(r.tracked_count - int(want["tracked"][j]))
    if r.pose is None:
        return 0.0, d_count
    R, t = r.pose.R.cpu().numpy(), r.pose.t.cpu().numpy()
    if not (np.isfinite(R).all() and np.isfinite(t).all()):
        raise AssertionError(f"frame {fid}: pose not finite")
    err = max(float(np.abs(R - want["R"][j]).max()), float(np.abs(k * t - want["t"][j]).max()))
    return err, d_count


def check_bow_state(got, init: dict, when: str) -> str:
    """The index after adoption or after the retrain against the JAX
    session's: anchors and kf_has exact, idf and kf_vectors within 1e-6."""
    want = {n: init[f"init_bow_{when}_{n}"] for n in ("anchors", "idf", "kf_vectors", "kf_has")}
    anchors, has, idf, vec = bow_errors(got, want)
    if anchors or has or idf > IDF_ATOL or vec > IDF_ATOL:
        raise AssertionError(f"index after {when}: {anchors} anchor words and {has} kf_has "
                             f"entries differ, idf err {idf:.3g}, kf_vectors err {vec:.3g}")
    return f"anchors equal, idf err {idf:.3g}, kf_vectors err {vec:.3g}"


def check_init_calls(calls: list) -> dict:
    """Every captured two-way and bag-of-words call of the path held exactly
    against the plain version; the pair match and each bag-of-words kernel
    at each of its row counts timed. Returns {"two_way": timing of the pair
    match, "bow_assign" / "bow_vocab_step": {rows: row}, "calls": counts}."""
    from mageslam_tpu_torch.ops import bow_words, matching

    counts, shapes = {}, {}
    matches = [args for kind, where, args in calls if where == "pair or third frame"]
    # the adoption's attempt made the last two: its pair match, its third-frame check
    pair = matches[-2] if len(matches) >= 2 else matches[-1]
    with KeptLaunches():
        for kind, where, args in calls:
            if kind == "two_way":
                got = matching.match_two_way(*args)
                want = matching.match_two_way_plain(*args)
                equal = all(torch.equal(g, w) for g, w in zip(got, want))
            else:
                kernel, plain = BOW_KERNELS[kind]
                equal = torch.equal(getattr(bow_words, kernel)(*args),
                                    getattr(bow_words, plain)(*args))
                shapes.setdefault((kind, args[0].shape[0]), (args, where))
            if not equal:
                raise AssertionError(f"{kind} kernel != plain on init's {where} call")
            counts[f"{kind}: {where}"] = counts.get(f"{kind}: {where}", 0) + 1
    phase("init", f"kernel calls of the path held exactly against the plain version: "
                  f"{counts}")
    rows = {"bow_assign": {}, "bow_vocab_step": {}}
    for (kind, n), (args, where) in sorted(shapes.items()):
        timer = time_bow_assign if kind == "bow_assign" else time_vocab_step
        rows[kind][n] = timer(*args[:3], f"the path's {where} call")
    d_a, v_a, d_b, v_b, max_hamming, min_diff = pair      # unbatched: as B = 1
    two_way = time_two_way((d_a, v_a[None], d_b[None], v_b[None], max_hamming, min_diff),
                           "mono init's pair match (the adoption's)")
    return {"two_way": two_way, **rows, "calls": counts}


def check_from_frame0(device, card: str) -> dict:
    """Phase 7. Returns the launch totals of the replayed run and of the run
    on the session's own generator, the path's kernel rows and timings."""
    from mageslam_tpu_torch.runtime.draws import GeneratorDraws, ReplayDraws

    with np.load(INIT_FIXTURE) as z:
        init = {k: z[k] for k in z.files}
    with np.load(FIXTURE) as z:
        f30 = {k[4:]: z[k] for k in z.files if k.startswith("ref_")}
    ref0 = {k[9:]: v for k, v in init.items() if k.startswith("init_ref_")}
    frames = render_window(0, INIT_LAST + 1)

    run_from_frame0(device, frames, ReplayDraws.from_npz(INIT_FIXTURE, device))  # warm pass
    calls, times = [], {}
    reset_launch_counts()
    replay = ReplayDraws.from_npz(INIT_FIXTURE, device)
    run = run_from_frame0(device, frames, replay,
                          init_call_recorders(calls) + wall_timers(times))
    totals = counted_launches()

    obs = run["obs"]
    anchors = [i for i, o in enumerate(obs) if o["anchor"]]
    attempts = [i for i, o in enumerate(obs) if o["draws"]["init"]]
    want_attempts = [int(init[f"init_att{j}_frame"]) for j in range(int(init["init_n_attempt"]))]
    if (anchors != init["init_anchor_frames"].tolist() or attempts != want_attempts
            or run.get("adopt_frame") != int(init["init_adopt_frame"])
            or run.get("retrain_frame") != int(init["init_retrain_frame"])):
        raise AssertionError(f"from frame 0: anchors {anchors}, attempts {attempts}, adoption "
                             f"{run.get('adopt_frame')}, retrain {run.get('retrain_frame')}; "
                             f"JAX {init['init_anchor_frames'].tolist()}, {want_attempts}, "
                             f"{int(init['init_adopt_frame'])}, "
                             f"{int(init['init_retrain_frame'])}")
    if any(replay.remaining().values()):
        raise AssertionError(f"recorded draws left unused: {replay.remaining()}")

    # the adopted pair: R direct, t in the JAX session's scale
    a = int(init["init_n_attempt"]) - 1
    R_j, t_j = init[f"init_att{a}_pose2_R"], init[f"init_att{a}_pose2_t"]
    k = float(np.linalg.norm(R_j.T @ t_j)) / run["adopt_scale"]
    res = run["adopt_result"]
    pose2_err = max(float(np.abs(res.pose2.R.cpu().numpy() - R_j).max()),
                    float(np.abs(k * res.pose2.t.cpu().numpy() - t_j).max()))
    raw_t_err = float(np.abs(res.pose2.t.cpu().numpy() - t_j).max())
    pv_diff = int((res.point_valid.cpu().numpy() != init[f"init_att{a}_point_valid"]).sum())
    if abs(k - 1.0) > SCALE_TOL or pose2_err > POSE_ATOL or pv_diff > POINT_VALID_BOUND:
        raise AssertionError(f"adoption: scale ratio {k:.6f} (limit 1 +- {SCALE_TOL}), pose2 "
                             f"err {pose2_err:.3g} (limit {POSE_ATOL}), point_valid differs in "
                             f"{pv_diff} (limit {POINT_VALID_BOUND})")
    bow_adopt = check_bow_state(run["adopt_bow"], init, "adopt")
    bow_retrain = check_bow_state(run["retrain_bow"], init, "retrain")

    pose_err, count_err = 0.0, 0
    for r in run["results"]:
        want, j = (ref0, r.frame_id) if r.frame_id <= 30 else (f30, r.frame_id - 31)
        e, c = hold_frame(r, want, j, k)
        pose_err, count_err = max(pose_err, e), max(count_err, c)
    classes = check_launch_classes(run, "from frame 0")
    if run["sess"].loop_det_stats["live"]:
        raise AssertionError(f"from frame 0: loop detection ran {run['sess'].loop_det_stats}")
    kf = [r.frame_id for r in run["results"] if r.is_keyframe]
    phase("init", f"frames 0-{INIT_LAST} from a bare session, JAX draws replayed: anchor "
                  f"{anchors}, attempts {attempts}, adopted at {run['adopt_frame']}, "
                  f"vocabulary retrained at {run['retrain_frame']}, keyframes {kf}; as the "
                  f"JAX session")
    phase("init", f"adopted pose2: R and scaled t err {pose2_err:.3g} (limit {POSE_ATOL}); "
                  f"map scale {run['adopt_scale']:.6f}, JAX {run['adopt_scale'] * k:.6f}, "
                  f"ratio {k:.6f} (limit 1 +- {SCALE_TOL}); raw t err {raw_t_err:.3g}; "
                  f"point_valid: {int(res.point_valid.sum())} points, {pv_diff} differ "
                  f"(limit {POINT_VALID_BOUND})")
    phase("init", f"bag-of-words index after adoption: {bow_adopt}; after the retrain: "
                  f"{bow_retrain}")
    phase("init", f"every frame: state and keyframe flag as JAX, max pose err {pose_err:.3g} "
                  f"(t scaled by the ratio; limit {POSE_ATOL}), max tracked diff {count_err} "
                  f"(limit {TRACKED_TOL})")
    phase("init", f"launches {KERNELS} by frame class, asserted "
                  f"on every frame: {classes}; totals {totals}")
    init_ms = [t for t, o in zip(run["ms"], obs) if o["was_init"]]
    tracked_ms = [t for t, o in zip(run["ms"], obs)
                  if not o["was_init"] and not o["keyframe"] and not o["retrained"]]
    phase("init", f"wall ms (synchronized): attempts {[round(t, 3) for t in times['attempt']]} "
                  f"(frames {attempts}; the last includes the third-frame check and the "
                  f"adoption), adoption {[round(t, 3) for t in times['adoption']]}, retrain "
                  f"{[round(t, 3) for t in times['retrain']]}; init frames "
                  f"{[round(t, 3) for t in init_ms]}; tracked frame median "
                  f"{statistics.median(tracked_ms):.3f} over {len(tracked_ms)}; after one "
                  f"warm pass; {card}")

    traces = {}
    profile_frames = frames[:INIT_PROFILE_LAST + 1]
    run_from_frame0(device, profile_frames, ReplayDraws.from_npz(INIT_FIXTURE, device),
                    device_tracers(traces, (("_attempt", "attempt"),
                                            ("retrain_index", "retrain"))))
    run_from_frame0(device, profile_frames[:int(init["init_adopt_frame"]) + 1],
                    ReplayDraws.from_npz(INIT_FIXTURE, device),
                    device_tracers(traces, (("adopt", "adoption"),)))
    phase("profile", "from frame 0, (device events, device ms) a call: " + "; ".join(
        f"{n} {[(e, round(ms, 3)) for e, ms, _ in v]}" for n, v in traces.items())
        + f" (attempts at frames {attempts}, the last with its adoption); {card}")
    for n, v in traces.items():
        phase("profile", f"{n}, first call: kernels with the most device time (name, "
                         f"launches, ms): {v[0][2]}")

    kernels = check_init_calls(calls)

    reset_launch_counts()
    own = run_from_frame0(device, frames, GeneratorDraws(0, device))
    own_totals = counted_launches()
    adopt = own.get("adopt_frame")
    ms_init = MAX_INIT_MS
    if adopt is None or (adopt * DT - own["anchor_ts"]) * 1000.0 > ms_init:
        raise AssertionError(f"own draws: adopted at {adopt}, anchor at "
                             f"{own.get('anchor_ts')} s (limit {ms_init} ms after it)")
    after = own["results"][adopt:]
    if not all(r.state.name == "TRACKING" and r.pose is not None for r in after):
        raise AssertionError(f"own draws: not every frame from {adopt} to {INIT_LAST} tracked: "
                             f"{[r.state.name for r in after]}")
    own_classes = check_launch_classes(own, "own draws")
    r = own["results"][adopt]
    phase("init", f"own generator (seed 0, no replay): adopted at frame {adopt}, "
                  f"{(adopt * DT - own['anchor_ts']) * 1000:.1f} ms after its anchor (limit "
                  f"{ms_init}), {r.tracked_count} points, pose2 R "
                  f"{np.round(r.pose.R.cpu().numpy(), 5).tolist()} t "
                  f"{np.round(r.pose.t.cpu().numpy(), 5).tolist()}, map scale "
                  f"{own['adopt_scale']:.6f}; every frame to {INIT_LAST} TRACKING, keyframes "
                  f"{[x.frame_id for x in own['results'] if x.is_keyframe]}; launches by class "
                  f"{own_classes}; totals {own_totals}")
    return {"totals": totals, "own_totals": own_totals, **kernels}


class HostReads:
    """Counts the device-to-host reads (bool, int, float, item, tolist and
    cpu of a CUDA tensor) made inside a with-block."""

    METHODS = ("__bool__", "__int__", "__float__", "item", "tolist", "cpu")

    def __enter__(self):
        self.count, self.saved = 0, []
        for n in self.METHODS:
            self.saved.append((n, torch.Tensor.__dict__.get(n)))
            real = getattr(torch.Tensor, n)

            def counted(t, *args, _real=real, **kwargs):
                if t.is_cuda:
                    self.count += 1
                return _real(t, *args, **kwargs)
            setattr(torch.Tensor, n, counted)
        return self

    def __exit__(self, *exc):
        for n, own in reversed(self.saved):
            if own is None:
                delattr(torch.Tensor, n)
            else:
                setattr(torch.Tensor, n, own)


def kernel_call_recorders(calls: list, where: str):
    """Patch targets recording the arguments (tensors cloned) of every
    bag-of-words, two-way and radius-match call, as (kind, where, args)."""
    from mageslam_tpu_torch.ops import matching
    from mageslam_tpu_torch.tracking import relocalization

    return [*bow_recorders(calls, where),
            (relocalization, "match_two_way", call_recorder(calls, "two_way", where)),
            (matching, "radius_match_stages", call_recorder(calls, "radius", where))]


def inside(module, name: str, targets_of):
    """A patch target that applies `targets_of()`'s patches only while
    `module.name` runs."""
    def wrap(real):
        def call(*args, **kwargs):
            with Patched(*targets_of()):
                return real(*args, **kwargs)
        return call
    return (module, name, wrap)


def step_timers(rows: list, module, name: str):
    """A patch target timing each call of `module.name`: synchronized wall
    ms, kernel launches and host reads made inside it."""
    def wrap(real):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            before = launch_counts()
            t0 = time.perf_counter()
            with HostReads() as reads:
                out = real(*args, **kwargs)
            torch.cuda.synchronize()
            rows.append({"ms": (time.perf_counter() - t0) * 1e3, "host_reads": reads.count,
                         "launches": tuple(a - b for a, b in zip(launch_counts(), before))})
            return out
        return call
    return (module, name, wrap)


def step_tracers(rows: list, module, name: str):
    """A patch target tracing each call of `module.name` under
    torch.profiler: (device events, device ms, top kernels)."""
    def wrap(real):
        def call(*args, **kwargs):
            out = []
            events = profile(lambda: out.append(real(*args, **kwargs)))
            rows.append((len(events), sum(_device_us(e) for e in events) / 1e3,
                         top_kernels(events)))
            return out[0]
        return call
    return (module, name, wrap)


def snapshotter(snaps: dict, frame_ids):
    """A patch target keeping the session's `snapshot_state` just before
    each frame of `frame_ids`, by frame id."""
    from mageslam_tpu_torch.runtime import session as session_mod

    def wrap(real):
        def call(self, feats, timestamp, frame_id, **kwargs):
            if frame_id in frame_ids:
                snaps[frame_id] = self.snapshot_state()
            return real(self, feats, timestamp, frame_id, **kwargs)
        return call
    return (session_mod.SlamSession, "process_features", wrap)


def same_result(a, b) -> bool:
    if (a.state, a.is_keyframe, a.tracked_count) != (b.state, b.is_keyframe, b.tracked_count):
        return False
    if a.pose is None or b.pose is None:
        return a.pose is None and b.pose is None
    return torch.equal(a.pose.R, b.pose.R) and torch.equal(a.pose.t, b.pose.t)


def retrace(sess, snaps: dict, results: dict, rerun, tracer) -> list[int]:
    """Restore each snapshot, the latest first (a replayed draw source only
    rewinds), and run its frame again (`rerun(frame_id)`) under the patch
    target `tracer`. Returns the frames whose second run differs from the
    first (`results` by frame id) in state, keyframe flag, tracked count or
    pose, bit for bit."""
    differing = []
    for f in sorted(snaps, reverse=True):
        sess.restore_state(snaps[f])
        with Patched(tracer):
            r = rerun(f)
        if not same_result(r, results[f]):
            differing.append(f)
    return differing


def hold_path_calls(calls: list, where: str) -> tuple[dict, dict]:
    """Every captured call held exactly against its plain version. Returns
    (the first call's arguments of each kind, the calls counted by kind)."""
    from mageslam_tpu_torch.ops import bow_words, matching

    firsts, counts = {}, {}
    with KeptLaunches():
        for kind, _, args in calls:
            if kind in BOW_KERNELS:
                kernel, plain = BOW_KERNELS[kind]
                equal = torch.equal(getattr(bow_words, kernel)(*args),
                                    getattr(bow_words, plain)(*args))
            elif kind == "two_way":
                equal = all(torch.equal(g, w) for g, w in zip(
                    matching.match_two_way(*args), matching.match_two_way_plain(*args)))
            else:
                equal = all(torch.equal(g, w) for g, w in zip(
                    matching.radius_match_stages(*args),
                    matching.radius_match_stages_plain(*args)))
            if not equal:
                raise AssertionError(f"{kind} kernel != plain on a call of {where}")
            firsts.setdefault(kind, args)
            counts[kind] = counts.get(kind, 0) + 1
    phase("kernel", f"{where}: every kernel call held exactly against the plain version: "
                    f"{counts}")
    return firsts, counts


def check_path_calls(calls: list, where: str, radius_expected) -> dict:
    """`hold_path_calls`, then the first call of each kind timed at its
    shape. Returns {kind: timing row}, with the calls counted by kind."""
    firsts, counts = hold_path_calls(calls, where)
    rows = {"calls": counts}
    if "bow_assign" in firsts:
        rows["bow_assign"] = time_bow_assign(*firsts["bow_assign"][:3], f"{where}'s query words")
    if "two_way" in firsts:
        rows["two_way"] = time_two_way(tuple(firsts["two_way"]), f"{where}'s relocalization")
    if "radius" in firsts:
        rows["radius"] = time_radius_calls([dict(zip(RADIUS_ARGS, firsts["radius"]))],
                                           f"{where}'s stacked rematch", radius_expected)
    return rows


def fossil_errors(ids, mats, ref: dict, which: str, k: float) -> np.ndarray:
    """Each fossilized pose's largest R and scaled t error against the JAX
    trajectory's; other frame ids or a pose that is not finite raise."""
    if ids.tolist() != ref[f"{which}_ids"].tolist() or not np.isfinite(mats).all():
        raise AssertionError(f"{which}: frame ids {ids.tolist()} != JAX "
                             f"{ref[f'{which}_ids'].tolist()}, or poses not finite")
    want = ref[f"{which}_mats"]
    return np.maximum(np.abs(mats[:, :3, :3] - want[:, :3, :3]).max(axis=(1, 2)),
                      np.abs(mats[:, :3, 3] * k - want[:, :3, 3]).max(axis=1))


def map_recorder(maps: list):
    """A patch target keeping the session's map after each mapping event
    (references: a state update makes new tensors)."""
    from mageslam_tpu_torch.runtime import session as session_mod

    def wrap(real):
        def call(self, frame):
            real(self, frame)
            maps.append(self.map)
        return call
    return (session_mod.SlamSession, "_insert_keyframe_and_map", wrap)


def assoc_recorder(rows: list):
    """A patch target keeping each frame's newest tracking-history row of
    associations (references)."""
    from mageslam_tpu_torch.runtime import session as session_mod

    def wrap(real):
        def call(self, *args, **kwargs):
            out = real(self, *args, **kwargs)
            rows.append(self.history.assoc[0])
            return out
        return call
    return (session_mod.SlamSession, "process_features", wrap)


def event_diffs(maps: list, ref: dict, device) -> list[tuple[int, dict]]:
    """(event frame, {mask: differing entries}) of each mapping event's map
    against the JAX map after it (`ev{j}_*` of the fixture)."""
    from types import SimpleNamespace

    if len(maps) != len(ref["ev_frame_id"]):
        raise AssertionError(f"{len(maps)} mapping events, JAX {len(ref['ev_frame_id'])}")
    return [(int(f), mask_diffs(m, SimpleNamespace(**{
        n: torch.from_numpy(ref[f"ev{j}_{n}"]).to(device) for n in MAP_MASKS})))
        for j, (f, m) in enumerate(zip(ref["ev_frame_id"], maps))]


def check_photoreal(device, card: str) -> dict:
    """Phase 8. Returns the run's launch totals and the detection's kernel rows."""
    from mageslam_tpu_torch.apps.evaluate import ate_rmse
    from mageslam_tpu_torch.runtime import streaming as streaming_mod
    from mageslam_tpu_torch.runtime.draws import ReplayDraws

    with np.load(PHOTOREAL_FIXTURE) as z:
        ref = {k: z[k] for k in z.files}
    frames = list(ref["frames"])
    kw = dict(cam=ref["cam"], size=PHOTOREAL_SIZE, timestamps=ref["timestamps"])
    calls = []
    run_from_frame0(device, frames, ReplayDraws.from_npz(PHOTOREAL_FIXTURE, device),
                    [inside(streaming_mod, "detect_loop",
                            lambda: kernel_call_recorders(calls, "loop detection"))], **kw)
    det_rows, maps, assoc, snaps = [], [], [], {}
    det_frames = [int(f) for f in ref["det_frame"][ref["det_live"] > 0]]
    replay = ReplayDraws.from_npz(PHOTOREAL_FIXTURE, device)
    reset_launch_counts()
    run = run_from_frame0(device, frames, replay,
                          [step_timers(det_rows, streaming_mod, "detect_loop"),
                           map_recorder(maps), assoc_recorder(assoc),
                           snapshotter(snaps, det_frames)], **kw)
    totals = counted_launches()
    sess = run["sess"]
    k = float(ref["map_scale"]) / sess.map_scale
    if abs(k - 1.0) > SCALE_TOL:
        raise AssertionError(f"photoreal: map scale ratio {k:.6f} (limit 1 +- {SCALE_TOL})")
    want = {n: ref[f"ref_{n}"] for n in ("state", "is_kf", "tracked", "R", "t")}
    errs = [frame_error(r, want, j, k) for j, r in enumerate(run["results"])]
    # every mapping event's map as JAX's; every tracked frame with JAX's
    # associations on ASSOC_SHARE of its keypoints; every pose within
    # POSE_ATOL but the logged frames', which are held to their ceiling
    diffs = event_diffs(maps, ref, device)
    if any(any(d.values()) for _, d in diffs):
        raise AssertionError(f"photoreal: the map after a mapping event differs from JAX's "
                             f"(event frame, differing mask entries) {diffs}")
    n_assoc = [int((a.cpu().numpy() != ref["ref_assoc"][j]).sum()) if r.pose is not None
               else 0 for j, (r, a) in enumerate(zip(run["results"], assoc))]
    n_kp = ref["ref_assoc"].shape[1]
    if max(n_assoc) > (1 - ASSOC_SHARE) * n_kp:
        raise AssertionError(f"photoreal: associations differ from JAX's on "
                             f"{max(n_assoc)} of {n_kp} keypoints of a frame (limit "
                             f"{1 - ASSOC_SHARE:.0%})")
    over = [(r.frame_id, round(e, 6), c, n_assoc[j])
            for j, (r, (e, c)) in enumerate(zip(run["results"], errs))
            if e > POSE_ATOL or c > TRACKED_TOL]
    failing = [o for o in over if o[2] > TRACKED_TOL or o[0] not in PHOTOREAL_LOGGED_FRAMES
               or o[1] > PHOTOREAL_LOGGED_ATOL]
    if failing:
        raise AssertionError(f"photoreal: frames beyond the tolerance (frame, pose err, "
                             f"tracked diff, associations differing) {failing}; only frames "
                             f"{PHOTOREAL_LOGGED_FRAMES} may reach {PHOTOREAL_LOGGED_ATOL}")
    same = [e for (e, _), n in zip(errs, n_assoc) if n == 0]
    classes = check_launch_classes(run, "photoreal")
    tracked = sum(r.state.name == "TRACKING" for r in run["results"])
    stats = sess.loop_det_stats
    if (stats["live"] != int(ref["det_live"].sum()) or stats["qualified"]
            != int(ref["det_qualifies"].sum()) or sess.n_loops_closed != int(ref["n_loops_closed"])
            or any(replay.remaining().values()) or tracked < TRACKED_SHARE * len(frames)):
        raise AssertionError(f"photoreal: detections {stats}, JAX live "
                             f"{int(ref['det_live'].sum())} qualified "
                             f"{int(ref['det_qualifies'].sum())}; draws left "
                             f"{replay.remaining()}; {tracked} of {len(frames)} tracked")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, mats = sess.fossilize(global_ba_steps=None)
    fossil_ms = (time.perf_counter() - t0) * 1e3
    fossil_err = fossil_errors(ids, mats, ref, "fossil", k)
    est_ts = ref["timestamps"][ids]
    centers = np.asarray([-m[:3, :3].T @ m[:3, 3] for m in mats])
    ate, n_ate = ate_rmse(est_ts, centers, ref["timestamps"], ref["gt_c"])
    if not ate < ATE_LIMIT or n_ate < 0.75 * len(frames):
        raise AssertionError(f"photoreal: ATE {ate:.4f} m over {n_ate} poses (limit "
                             f"{ATE_LIMIT} m)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids3, mats3 = sess.fossilize(global_ba_steps=3)
    torch.cuda.synchronize()
    fossil3_ms = (time.perf_counter() - t0) * 1e3
    fossil3_err = fossil_errors(ids3, mats3, ref, "fossil3", k)
    fossil_over = sorted((int(f), round(float(max(e, e3)), 6))
                         for f, e, e3 in zip(ids, fossil_err, fossil3_err)
                         if max(e, e3) > POSE_ATOL)
    if any(f not in PHOTOREAL_LOGGED_FRAMES or e > PHOTOREAL_LOGGED_ATOL
           for f, e in fossil_over):
        raise AssertionError(f"photoreal: fossilized poses beyond {POSE_ATOL} (frame, err) "
                             f"{fossil_over}; only frames {PHOTOREAL_LOGGED_FRAMES} may "
                             f"reach {PHOTOREAL_LOGGED_ATOL}")
    fossil_err, fossil3_err = float(fossil_err.max()), float(fossil3_err.max())
    kf = [r.frame_id for r in run["results"] if r.is_keyframe]
    phase("photoreal", f"80 frames at {PHOTOREAL_SIZE[0]}x{PHOTOREAL_SIZE[1]} from a bare "
                       f"session, JAX draws replayed: {tracked} TRACKING (limit "
                       f"{TRACKED_SHARE:.0%}), keyframes {kf}; every frame's state and "
                       f"keyframe flag as JAX, max pose err "
                       f"{max(e for e, _ in errs):.3g} (t scaled by {k:.6f}; limit "
                       f"{POSE_ATOL}), max tracked diff {max(c for _, c in errs)} (limit "
                       f"{TRACKED_TOL}); frames beyond the limits (frame, pose err, tracked "
                       f"diff, associations differing from JAX's): {over or 'none'}; "
                       f"{len(same)} frames with JAX's associations, max pose err among them "
                       f"{max(same):.3g}; frames with other associations "
                       f"{[(r.frame_id, n) for r, n in zip(run['results'], n_assoc) if n]}")
    phase("photoreal", f"the map after each of the {len(diffs)} mapping events (frames "
                       f"{[f for f, _ in diffs]}): kf_valid, mp_valid, kf_assoc, kf_member "
                       f"equal to JAX's; associations as JAX's on at least "
                       f"{ASSOC_SHARE:.0%} of every tracked frame's keypoints (at most "
                       f"{max(n_assoc)} of {n_kp} differ); logged frames "
                       f"{PHOTOREAL_LOGGED_FRAMES} held to {PHOTOREAL_LOGGED_ATOL}")
    phase("photoreal", f"fossilize(None): {len(ids)} poses, err {fossil_err:.3g} against "
                       f"JAX, {fossil_ms:.3f} ms; ATE {ate:.5f} m over {n_ate} poses (limit "
                       f"{ATE_LIMIT}; the JAX run's {float(ref['jax_ate']):.5f}); "
                       f"fossilize(3) (global BA) {fossil3_ms:.3f} ms, err {fossil3_err:.3g} "
                       f"against JAX; fossilized poses beyond {POSE_ATOL} (frame, err) "
                       f"{fossil_over or 'none'}; {card}")
    phase("photoreal", f"loop detection {stats} as the JAX session's; a detection (wall ms, "
                       f"host reads, launches {KERNELS}): "
                       f"{[(round(r['ms'], 3), r['host_reads'], r['launches']) for r in det_rows]}")
    phase("photoreal", f"launches by frame class, asserted on every frame: {classes}; "
                       f"totals {totals}")
    tracked_ms = [t for t, o in zip(run["ms"], run["obs"])
                  if not o["was_init"] and not o["keyframe"] and not o["retrained"]]
    kf_ms = [t for t, o in zip(run["ms"], run["obs"]) if o["keyframe"] and not o["was_init"]]
    phase("photoreal", f"wall ms a frame (process_frame + synchronize): tracked median "
                       f"{statistics.median(tracked_ms):.3f} (min {min(tracked_ms):.3f}, max "
                       f"{max(tracked_ms):.3f}, {len(tracked_ms)} frames); keyframe median "
                       f"{statistics.median(kf_ms):.3f} (max {max(kf_ms):.3f}); every frame "
                       f"{[round(t, 1) for t in run['ms']]}; after one warm pass; {card}")
    # each detection's frame again from the snapshot before it, traced
    traces = []
    differing = retrace(sess, snaps, {r.frame_id: r for r in run["results"]},
                        lambda f: sess.process_frame(frames[f], float(ref["timestamps"][f]), f),
                        step_tracers(traces, streaming_mod, "detect_loop"))
    traces.reverse()
    phase("profile", f"loop detection at frames {det_frames}, each frame run again from "
                     f"the session's snapshot before it (restore_state), traced: (device "
                     f"events, device ms) a call: {[(e, round(ms, 3)) for e, ms, _ in traces]}; "
                     f"the qualifying one's kernels with the most device time: "
                     f"{max(traces, key=lambda t: t[0])[2]}; frames whose second run differs "
                     f"from the first bit for bit: {differing or 'none'}; {card}")
    rows = check_path_calls(calls, "photoreal loop detection", ((1, 2048, 512),))
    return {"totals": totals, "rows": rows, "detections": det_rows, "ate": ate}


def reloc_features(ref: dict, i: int, device):
    return fixture_features(ref, f"feat{i}_", device)


def run_reloc(device, ref: dict, patches=()) -> dict:
    """The reloc scenario's session from the JAX state after frame 29 over
    frames 30-37: results, wall ms and launches a frame, and the session's
    snapshot before each relocalizing frame."""
    from mageslam_tpu_torch import SlamSession, golden_path_settings
    from mageslam_tpu_torch.runtime.draws import ReplayDraws

    draws = ReplayDraws.from_npz(RELOC_FIXTURE, device, kinds=("reloc",))
    sess = SlamSession.from_jax_snapshot(RELOC_FIXTURE, golden_path_settings(), ref["cam"],
                                         *(int(v) for v in ref["size"]), device, draws=draws)
    feats = {i: reloc_features(ref, i, device)
             for i in range(RELOC_SNAP_FRAME + 1, int(ref["n_frames"]))}
    out = {"results": [], "ms": [], "launches": [], "sess": sess, "draws": draws,
           "snaps": {}}
    with Patched(*patches):
        for i, f in feats.items():
            before = launch_counts()
            lost = sess.lost_count >= \
                sess.settings.TrackLocalMapSettings.TrackingLostCountUntilReloc
            if lost:
                out["snaps"][i] = sess.snapshot_state()
            t0 = time.perf_counter()
            out["results"].append(sess.process_features(f, i * DT, i))
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["launches"].append((lost, tuple(a - b for a, b in zip(launch_counts(), before))))
    return out


def check_reloc(device, card: str) -> dict:
    """Phase 9."""
    from mageslam_tpu_torch.runtime import session as session_mod

    with np.load(RELOC_FIXTURE) as z:
        ref = {k: z[k] for k in z.files}
    calls = []
    run_reloc(device, ref, [inside(session_mod, "reloc_step",
                                   lambda: kernel_call_recorders(calls, "relocalization"))])
    reloc_rows = []
    reset_launch_counts()
    run = run_reloc(device, ref, [step_timers(reloc_rows, session_mod, "reloc_step")])
    totals = counted_launches()
    first = RELOC_SNAP_FRAME + 1
    want = {n: ref[f"ref_{n}"][first:] for n in ("state", "is_kf", "tracked", "R", "t")}
    errs = [hold_frame(r, want, j, 1.0) for j, r in enumerate(run["results"])]
    states = [r.state.name for r in run["results"]]
    if "RELOCALIZING" not in states or states[-3] != "TRACKING" or any(
            run["draws"].remaining().values()):
        raise AssertionError(f"reloc: states {states}, draws left {run['draws'].remaining()}")
    for r, (lost, got) in zip(run["results"], run["launches"]):
        want_l = LAUNCHES_RELOC if lost else LAUNCHES_TRACKED
        if got != want_l:
            raise AssertionError(f"reloc frame {r.frame_id} (relocalizing: {lost}): launched "
                                 f"{got}, expected {want_l}")
    # each relocalizing frame again from the snapshot before it, traced
    traces = []
    sess = run["sess"]
    differing = retrace(sess, run["snaps"], {r.frame_id: r for r in run["results"]},
                        lambda f: sess.process_features(reloc_features(ref, f, device),
                                                        f * DT, f),
                        step_tracers(traces, session_mod, "reloc_step"))
    traces.reverse()
    r = run["results"][-3]
    phase("reloc", f"frames {first}-{first + len(states) - 1} from the JAX state after frame "
                   f"{RELOC_SNAP_FRAME}, JAX draws replayed: {states} as JAX; relocalized at "
                   f"frame {r.frame_id} with {r.tracked_count} tracked; max pose err "
                   f"{max(e for e, _ in errs):.3g} (limit {POSE_ATOL}), max tracked diff "
                   f"{max(c for _, c in errs)}")
    phase("reloc", f"launches a relocalizing frame {LAUNCHES_RELOC}, a tracked one "
                   f"{LAUNCHES_TRACKED}, asserted on every frame; totals {totals}; a "
                   f"relocalization (wall ms, host reads in the step, launches): "
                   f"{[(round(x['ms'], 3), x['host_reads'], x['launches']) for x in reloc_rows]}; "
                   f"frame wall ms {[round(t, 3) for t in run['ms']]}; {card}")
    phase("profile", f"relocalization at frames {sorted(run['snaps'])}, each frame run "
                     f"again from the session's snapshot before it (restore_state), traced: "
                     f"(device events, device ms) a call: "
                     f"{[(e, round(ms, 3)) for e, ms, _ in traces]}; kernels with the most "
                     f"device time: {traces[-1][2]}; frames whose second run differs from the "
                     f"first bit for bit: {differing or 'none'}; {card}")
    rows = check_path_calls(calls, "the relocalization", ((1, 2048, 512),))
    return {"totals": totals, "rows": rows, "reloc": reloc_rows}


def loop_scene(ref: dict, s: str, device):
    from mageslam_tpu_torch.bow.index import BowIndex
    from mageslam_tpu_torch.interop import unflatten
    from mageslam_tpu_torch.tracking.frame_state import TrackedFrame
    from mageslam_tpu_torch.worldmap.map_state import MapState

    return (unflatten(MapState, f"{s}_map", ref, device),
            unflatten(BowIndex, f"{s}_bow", ref, device),
            unflatten(TrackedFrame, f"{s}_frame", ref, device))


def aligned_error(got, want) -> float:
    """Largest residual of keyframe centers and points after one
    similarity aligns the port's map to the JAX map (global BA leaves the
    similarity gauge free)."""
    from mageslam_tpu_torch.apps.evaluate import umeyama_align

    kv, pv = want.kf_valid.cpu().numpy(), want.mp_valid.cpu().numpy()
    src = np.concatenate([got.kf_pose.center().cpu().numpy()[kv], got.mp_pos.cpu().numpy()[pv]])
    dst = np.concatenate([want.kf_pose.center().cpu().numpy()[kv],
                          want.mp_pos.cpu().numpy()[pv]])
    s, R, t = umeyama_align(src.astype(np.float64), dst.astype(np.float64))
    return float(np.abs((s * (R @ src.T)).T + t - dst).max())


def closure_session(device, m, ki: int):
    from mageslam_tpu_torch import SlamSession, golden_path_settings

    sess = SlamSession(golden_path_settings(), CAM, WIDTH, HEIGHT, device)
    sess.map, sess.last_kf_slot = m, ki
    return sess


def timed_closure(device, m, det, frame, ki: int) -> tuple[object, list, tuple]:
    """The session's closure (`_apply_loop_closure`) on map m: the map it
    gives, wall ms over CLOSURE_REPEATS calls after a warm one, and one
    traced call's (device events, device ms, top kernels)."""
    closure_session(device, m, ki)._apply_loop_closure(det, frame, ki)     # warm
    ms = []
    for _ in range(CLOSURE_REPEATS):
        sess = closure_session(device, m, ki)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess._apply_loop_closure(det, frame, ki)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    sess2 = closure_session(device, m, ki)
    events = profile(lambda: sess2._apply_loop_closure(det, frame, ki))
    return sess.map, ms, (len(events), sum(_device_us(e) for e in events) / 1e3,
                          top_kernels(events))


def check_loop_closure(device, card: str, window_sess) -> dict:
    """Phase 10."""
    from mageslam_tpu_torch.geometry.se3 import Pose
    from mageslam_tpu_torch.interop import unflatten
    from mageslam_tpu_torch.runtime.loop_closure import LoopDetection, detect_loop
    from mageslam_tpu_torch.tracking.frame_state import TrackedFrame
    from mageslam_tpu_torch.worldmap.map_state import MapState

    with np.load(LOOP_FIXTURE) as z:
        ref = {k: z[k] for k in z.files}
    reset_launch_counts()
    out, dets, calls = {}, {}, {}
    for s in "ab":
        m, bow, frame = loop_scene(ref, s, device)
        calls[s] = []
        with Patched(*kernel_call_recorders(calls[s], "loop scene")):
            det, _, _ = detect_loop(m, bow, frame, 5,
                                    lambda: torch.from_numpy(ref[f"{s}_draws"]).to(device),
                                    min_keyframes=5, min_cluster_size=2)
        scale_err = abs(float(det.scale) - float(ref[f"{s}_det_scale"]))
        pose_err = max(float(np.abs(det.reloc_pose.R.cpu().numpy() - ref[f"{s}_det_R"]).max()),
                       float(np.abs(det.reloc_pose.t.cpu().numpy() - ref[f"{s}_det_t"]).max()))
        if (not bool(det.detected) or not np.array_equal(det.cluster_mask.cpu().numpy(),
                                                         ref[f"{s}_det_cluster_mask"])
                or not np.array_equal(det.reloc_assoc.cpu().numpy(),
                                      ref[f"{s}_det_reloc_assoc"])
                or scale_err > 1e-5 or pose_err > 1e-4):
            raise AssertionError(f"loop scene {s}: detected {bool(det.detected)}, scale err "
                                 f"{scale_err:.3g}, pose err {pose_err:.3g}, or cluster or "
                                 f"associations differ from JAX")
        dets[s] = (m, frame, det, scale_err, pose_err)
    totals = counted_launches()
    for s, (m, frame, det, scale_err, pose_err) in dets.items():
        hold_path_calls(calls[s], f"loop scene {s}'s detection")
        got, ms, trace = timed_closure(device, m, det, frame, 5)
        want = unflatten(MapState, f"{s}_gba", ref, device)
        diffs = mask_diffs(got, want)
        err = aligned_error(got, want)
        if any(diffs.values()) or err > CLOSURE_ATOL:
            raise AssertionError(f"loop scene {s}: the closure's masks differ {diffs} or its "
                                 f"aligned error {err:.3g} exceeds {CLOSURE_ATOL}")
        phase("loop", f"scene {s}: detected as JAX (cluster "
                      f"{np.flatnonzero(ref[f'{s}_det_cluster_mask']).tolist()}, scale "
                      f"{float(det.scale):.6f}, err {scale_err:.3g}; reloc pose err "
                      f"{pose_err:.3g}); closure (close_loop + essential graph + global BA + "
                      f"membership refresh): masks equal to JAX's, aligned err {err:.3g} "
                      f"(limit {CLOSURE_ATOL}); wall ms {[round(t, 3) for t in ms]}; "
                      f"{trace[0]} device events, {trace[1]:.3f} device ms; {card}")
        phase("profile", f"loop scene {s} closure: kernels with the most device time: "
                         f"{trace[2]}")
        out[s] = {"ms": ms, "device_events": trace[0], "device_ms": trace[1]}

    # the closure's cost on a real map: phase 6's, an identity detection
    m = window_sess.map
    ki = int(window_sess.last_kf_slot)
    kv = m.kf_valid.cpu().numpy()
    cluster = torch.zeros_like(m.kf_valid)
    cluster[torch.from_numpy(np.flatnonzero(kv)[:3]).to(device)] = True
    kf_pose = Pose(m.kf_pose.R[ki], m.kf_pose.t[ki])
    frame = TrackedFrame(pose=kf_pose, cam=m.kf_cam[ki], kp_xy=m.kf_kp_xy[ki],
                         kp_octave=m.kf_kp_octave[ki], desc=m.kf_desc[ki],
                         kp_valid=m.kf_kp_valid[ki], assoc=m.kf_assoc[ki],
                         timestamp=torch.zeros((), device=device), frame_id=m.kf_frame_id[ki])
    det = LoopDetection(detected=torch.ones((), dtype=torch.bool, device=device),
                        reloc_pose=kf_pose, reloc_assoc=m.kf_assoc[ki],
                        scale=torch.ones((), device=device), cluster_mask=cluster,
                        kf_frame_id=m.kf_frame_id, mp_order=m.mp_created_order)
    got, ms, trace = timed_closure(device, m, det, frame, ki)
    if not (torch.isfinite(got.kf_pose.t).all() and torch.isfinite(got.mp_pos).all()):
        raise AssertionError("identity closure on the phase-6 map: not finite")
    phase("loop", f"identity closure on the phase-6 map ({int(kv.sum())} keyframes, "
                  f"{int(m.mp_valid.sum())} points, capacity {m.capacity}): wall ms "
                  f"{[round(t, 3) for t in ms]}; {trace[0]} device events, {trace[1]:.3f} "
                  f"device ms; kernels with the most device time {trace[2]}; {card}")
    out["window_identity"] = {"ms": ms, "device_events": trace[0], "device_ms": trace[1]}
    return {"totals": totals, **out}


def stereo_settings(**keyframe):
    """Golden settings with MaxDepthMeters = 12 (the synthetic rigs' scenes
    are 3-10 m deep at a 0.12 m baseline) and, where given, KeyframeSettings
    replaced (tests/test_stereo.py)."""
    import dataclasses

    from mageslam_tpu_torch import golden_path_settings

    s = golden_path_settings()
    st = s.StereoSettings
    s = dataclasses.replace(s, StereoSettings=dataclasses.replace(
        st, StereoMapInitializationSettings=dataclasses.replace(
            st.StereoMapInitializationSettings, MaxDepthMeters=12.0)))
    if keyframe:
        s = dataclasses.replace(s, KeyframeSettings=dataclasses.replace(
            s.KeyframeSettings, **keyframe))
    return s


def camera_settings(undistort_pixels=None, **fes):
    """Golden settings with the mono camera's feature settings (and
    UndistortImagePixels, where given) replaced."""
    import dataclasses

    from mageslam_tpu_torch import golden_path_settings

    s = golden_path_settings()
    cam = s.MonoSettings.MonoCamera
    cam = dataclasses.replace(cam, FeatureExtractorSettings=dataclasses.replace(
        cam.FeatureExtractorSettings, **fes))
    if undistort_pixels is not None:
        cam = dataclasses.replace(cam, UndistortImagePixels=undistort_pixels)
    return dataclasses.replace(s, MonoSettings=dataclasses.replace(s.MonoSettings,
                                                                   MonoCamera=cam))


def load_npz(*paths) -> dict:
    out = {}
    for p in paths:
        with np.load(p) as z:
            out.update({k: z[k] for k in z.files})
    return out


def fixture_features(ref: dict, prefix: str, device):
    from mageslam_tpu_torch.ops.frontend import FrameFeatures

    def t(a):
        return torch.from_numpy((a.view(np.int32) if a.dtype == np.uint32 else a).copy())
    return FrameFeatures(*(t(ref[prefix + n]).to(device) for n in FrameFeatures._fields))


def hold_run(results, maps, ref: dict, prefix: str, k: float,
             where: str) -> tuple[float, int, dict]:
    """Every frame's state and keyframe flag, pose (t scaled by k) and
    tracked count against the JAX run under `prefix`, and the map's masks
    after each mapping event, but where LOGGED logs the run's frames and
    events. Returns (max pose err, max tracked diff, mask differences by
    event frame)."""
    from types import SimpleNamespace

    n = len(results)
    want = {name: ref[f"{prefix}ref_{name}"][:n] for name in ("state", "is_kf", "tracked",
                                                               "R", "t")}
    errs = [frame_error(r, want, j, k) for j, r in enumerate(results)]
    logged_frames, logged_events = LOGGED.get(prefix, ({}, {}))
    over = [(r.frame_id, round(e, 6), c) for r, (e, c) in zip(results, errs)
            if c > TRACKED_TOL or e > logged_frames.get(r.frame_id, POSE_ATOL)]
    ev = ref[f"{prefix}ev_frame_id"]
    ev = ev[ev < n]
    if over or len(maps) != len(ev):
        raise AssertionError(f"{where}: frames beyond the tolerance (frame, pose err, tracked "
                             f"diff) {over}; {len(maps)} mapping events, JAX {len(ev)}")
    diffs = {}
    for j, m in enumerate(maps):
        d = mask_diffs(m, SimpleNamespace(**{
            name: torch.from_numpy(ref[f"{prefix}ev{j}_{name}"]).to(m.kf_valid.device)
            for name in MAP_MASKS}))
        bad = {name: c for name, c in d.items() if c and not (
            name in ("kf_assoc", "kf_member") and c <= logged_events.get(int(ev[j]), 0))}
        if bad:
            raise AssertionError(f"{where}: the map after mapping event {j} (frame {ev[j]}) "
                                 f"differs from JAX's: {d}")
        diffs[int(ev[j])] = d
    return max(e for e, _ in errs), max(c for _, c in errs), diffs


def run_stereo(device, sess, steps, patches=()) -> dict:
    """Drive `sess` by `steps` (frame i → its call), keeping each frame's
    result, wall ms (synchronized), launches and what the session did."""
    out = {"results": [], "ms": [], "launches": [], "obs": []}
    detections = [0]
    with Patched(detection_counter(detections), *patches):
        for i, step in enumerate(steps):
            was_init, retrained = not sess.initialized, sess.bow_training.retrained
            stats, ran = dict(sess.loop_det_stats), detections[0]
            before = launch_counts()
            t0 = time.perf_counter()
            r = step()
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["launches"].append(tuple(a - b for a, b in zip(launch_counts(), before)))
            out["results"].append(r)
            out["obs"].append({
                "was_init": was_init, "keyframe": r.is_keyframe,
                "stereo_bootstrap": was_init and sess.initialized,
                "retrained": sess.bow_training.retrained and not retrained,
                "detections": detections[0] - ran,
                **{k: sess.loop_det_stats[k] - stats[k] for k in ("live", "qualified")}})
    return out


def check_stereo_launches(run: dict, where: str) -> dict:
    """Each frame's launches: the stereo bootstrap's pair match and
    adoption, else as `expected_launches` classes a tracked frame."""
    seen = {}
    for r, obs, got in zip(run["results"], run["obs"], run["launches"]):
        if obs["stereo_bootstrap"]:
            name, want = "stereo bootstrap", tuple(
                a + b for a, b in zip(LAUNCHES_STEREO_PAIR, LAUNCHES_ADOPTION))
        elif obs["was_init"]:
            name, want = "stereo pair not adopted", LAUNCHES_STEREO_PAIR
        else:
            name, want = expected_launches(obs)
        if got != want:
            raise AssertionError(f"{where}, frame {r.frame_id} ({name}): launched "
                                 f"{KERNELS} {got}, expected "
                                 f"{want}")
        seen.setdefault(name, want)
    return seen


def check_stereo_pair(device, ref: dict) -> dict:
    """Phase 11, part 1: `stereo_initialize` on the synthetic pair and the
    zero-baseline pair against JAX; its two-way calls held exactly against
    the plain version; the pair match timed beside the composites it
    replaces, with its bound."""
    from mageslam_tpu_torch.geometry.se3 import Pose
    from mageslam_tpu_torch.tracking import stereo_init

    f0 = fixture_features(ref, "pair_f0_", device)
    f1 = fixture_features(ref, "pair_f1_", device)
    cam = torch.from_numpy(ref["cam"]).to(device)
    calls = []
    patches = [(stereo_init, "match_two_way", lambda real: recording_call(calls, real))]
    for which, rel in (("pair_", Pose(torch.from_numpy(ref["pair_rel_R"]).to(device),
                                      torch.from_numpy(ref["pair_rel_t"]).to(device))),
                       ("pair_zero_", Pose.identity(device=device))):
        with Patched(*patches):
            res = stereo_init.stereo_initialize(
                f0.und_xy, f0.desc, f0.valid, f1.und_xy, f1.desc, f1.valid, cam, rel,
                stereo_init.StereoInitSettings(max_depth_meters=12.0))
        for name in ("succeeded", "match_count", "feat2", "point_valid"):
            if not np.array_equal(getattr(res, name).cpu().numpy(), ref[which + name]):
                raise AssertionError(f"stereo_initialize ({which}): {name} differs from JAX's")
        if which == "pair_":
            ok = ref["pair_point_valid"]
            want = ref["pair_points"][ok]
            pt_err = float((np.linalg.norm(res.points.cpu().numpy()[ok] - want, axis=1)
                            / np.linalg.norm(want, axis=1)).max())
            pose_err = max(float(np.abs(res.pose2.R.cpu().numpy() - ref["pair_pose2_R"]).max()),
                           float(np.abs(res.pose2.t.cpu().numpy() - ref["pair_pose2_t"]).max()))
            if pt_err > STEREO_POINT_RTOL or pose_err > STEREO_PAIR_POSE_ATOL:
                raise AssertionError(f"stereo_initialize: points {pt_err:.3g} relative (limit "
                                     f"{STEREO_POINT_RTOL}), pose2 {pose_err:.3g} (limit "
                                     f"{STEREO_PAIR_POSE_ATOL})")
    hold_path_calls([("two_way", "stereo_initialize", c) for c in calls], "stereo_initialize")
    phase("stereo", f"stereo_initialize on the synthetic pair: succeeded, "
                    f"{int(ref['pair_match_count'])} matches, "
                    f"{int(ref['pair_point_valid'].sum())} points, feat2 and point_valid as JAX; "
                    f"points within {pt_err:.3g} relative (limit {STEREO_POINT_RTOL}), pose2 "
                    f"within {pose_err:.3g} (limit {STEREO_PAIR_POSE_ATOL}); the zero-baseline "
                    f"pair rejected as JAX")
    desc_a, valid_a, desc_b, valid_b, max_hamming, min_diff = calls[0]     # B = 1
    return time_two_way((desc_a, valid_a[None], desc_b[None], valid_b[None], max_hamming,
                         min_diff), "the stereo pair (StereoMapInitialization gates)")


def recording_call(calls: list, real):
    def call(*args):
        calls.append([a.clone() if isinstance(a, torch.Tensor) else a for a in args])
        return real(*args)
    return call


def check_rig_session(device, ref: dict, card: str) -> dict:
    """Phase 11, part 2: the rig-tether session, 40 frames of synthetic
    features; every mapping event's local BA assembles the live rig tether."""
    from mageslam_tpu_torch import SlamSession
    from mageslam_tpu_torch.geometry.se3 import Pose
    from mageslam_tpu_torch.runtime import session as session_mod
    from mageslam_tpu_torch.runtime.draws import ReplayDraws

    n = len(ref["rig_timestamps"])
    feats = [fixture_features(ref, "rig_feat0_", device)] + [
        fixture_features(ref, f"rig_feat{i}_", device) for i in range(1, n)]
    feat0b = fixture_features(ref, "rig_feat0b_", device)
    rel = Pose(torch.from_numpy(ref["rig_rel_R"]).to(device),
               torch.from_numpy(ref["rig_rel_t"]).to(device))
    settings = stereo_settings(KeyframeDecisionMaxTrackingPointMatches=100000,
                               KeyframeDecisionMaxTrackingPointOverlap=0.98)

    def session():
        draws = ReplayDraws.from_npz(STEREO_FIXTURE, device, prefix="rig_")
        sess = SlamSession(settings, ref["cam"], *ref["size"].tolist(), device, draws=draws)
        ts = ref["rig_timestamps"]
        steps = [lambda: sess.process_stereo_features(feats[0], feat0b, rel, 0.0, 0)] + [
            (lambda i=i: sess.process_features(feats[i], float(ts[i]), i)) for i in range(1, n)]
        return sess, draws, steps

    sess, _, steps = session()
    run_stereo(device, sess, steps[:WARM_FRAMES])           # warm pass
    sess, draws, steps = session()
    maps, events, snaps = [], [], {}
    ev_frames = [int(f) for f in ref["rig_ev_frame_id"]]
    kf_frames = [ev_frames[j] for j in
                 np.linspace(0, len(ev_frames) - 1, TRACED_EVENTS).round().astype(int)]
    reset_launch_counts()
    run = run_stereo(device, sess, steps,
                     [map_recorder(maps), step_timers(events, session_mod, "mapping"),
                      snapshotter(snaps, kf_frames)])
    totals = counted_launches()
    classes = check_stereo_launches(run, "rig-tether session")
    pose_err, count_err, diffs = hold_run(run["results"], maps, ref, "rig_", 1.0,
                                          "rig-tether session")
    m = sess.map
    for name in ("tether_owner", "tether_origin", "tether_kind", "tether_distance",
                 "tether_weight"):
        if not np.array_equal(getattr(m, name).cpu().numpy(), ref[f"rig_final_{name}"]):
            raise AssertionError(f"rig-tether session: {name} differs from JAX's")
    kR, kt = m.kf_pose.R.cpu().numpy(), m.kf_pose.t.cpu().numpy()
    rig_R, jR = kR[1] @ kR[0].T, ref["rig_final_kf_R"][1] @ ref["rig_final_kf_R"][0].T
    rig_err = max(float(np.abs(rig_R - jR).max()), float(np.abs(
        (kt[1] - rig_R @ kt[0]) - (ref["rig_final_kf_t"][1] - jR @ ref["rig_final_kf_t"][0])
    ).max()))
    if rig_err > POSE_ATOL or any(draws.remaining().values()):
        raise AssertionError(f"rig-tether session: kf0 -> kf1 rig transform {rig_err:.3g} "
                             f"from JAX's (limit {POSE_ATOL}); draws left {draws.remaining()}")
    # the tether holds the rig: kf1 sits one baseline from kf0 along -x
    if np.abs(kt[1] - rig_R @ kt[0] - np.array([-1.0, 0.0, 0.0])).max() > 5e-2:
        raise AssertionError("rig-tether session: the rig transform left the tether")
    # each mapping event's frame again from the snapshot before it, traced
    traces = []
    differing = retrace(sess, snaps, {r.frame_id: r for r in run["results"]},
                        lambda f: sess.process_features(feats[f], float(ref["rig_timestamps"][f]),
                                                        f),
                        step_tracers(traces, session_mod, "mapping"))
    traces.reverse()
    tracked_ms = [t for t, o in zip(run["ms"], run["obs"])
                  if not o["was_init"] and not o["keyframe"]]
    phase("stereo", f"rig-tether session, {n} frames (the bootstrap pair, then features), JAX "
                    f"draws replayed: every state and keyframe flag as JAX (keyframes "
                    f"{[r.frame_id for r in run['results'] if r.is_keyframe]}), max pose err "
                    f"{pose_err:.3g} unscaled (limit {POSE_ATOL}, frames 18-39 logged to "
                    f"{max(LOGGED['rig_'][0].values())}), max tracked diff {count_err}; mask "
                    f"entries differing from JAX's after the {len(maps)} mapping events "
                    f"{({f: d for f, d in diffs.items() if any(d.values())}) or 'none'}; tether "
                    f"bank as JAX's, kf0 -> kf1 rig transform within {rig_err:.3g}")
    phase("stereo", f"rig-tether launches by frame class, asserted on every frame: {classes}; "
                    f"totals {totals}")
    phase("stereo", f"rig-tether wall ms (synchronized, after a warm pass over frames "
                    f"0-{WARM_FRAMES - 1}): tracked frame "
                    f"median {statistics.median(tracked_ms):.3f} (n = {len(tracked_ms)}); "
                    f"bootstrap frame {run['ms'][0]:.3f}; every frame "
                    f"{[round(t, 1) for t in run['ms']]}; mapping events with the live rig "
                    f"tether (wall ms, host reads, launches): "
                    f"{[(round(e['ms'], 3), e['host_reads'], e['launches']) for e in events]}; "
                    f"{card}")
    phase("profile", f"rig-tether mapping events at frames {sorted(snaps)}, each frame run "
                     f"again from the snapshot before it, traced: (device events, device ms) "
                     f"an event: "
                     f"{[(e, round(ms, 3)) for e, ms, _ in traces]}; kernels with the most "
                     f"device time in the last: {traces[-1][2]}; frames whose second run "
                     f"differs bit for bit: {differing or 'none'}; {card}")
    return {"totals": totals, "events": events, "traces": traces}


def check_mixed_rig(device, ref: dict, card: str) -> dict:
    """Phase 11, part 3: the mixed-FOV rig through `process_stereo_frames`."""
    from mageslam_tpu_torch import SlamSession, stereo_world
    from mageslam_tpu_torch.geometry.se3 import Pose
    from mageslam_tpu_torch.ops.undistort import remap_bilinear
    from mageslam_tpu_torch.runtime.draws import ReplayDraws

    pairs = stereo_world.frames()
    hashes = ([stereo_world.frame_hash(p[0]) for p in pairs],
              [stereo_world.frame_hash(p[1]) for p in pairs])
    if hashes != tuple([h.decode() for h in ref[f"mix_hash{c}"].tolist()] for c in (0, 1)):
        raise AssertionError("mixed rig: the port's renderer does not give the JAX run's frames")
    R, t = stereo_world.rig()
    rel = Pose(torch.from_numpy(R).to(device), torch.from_numpy(t).to(device))
    camera1 = stereo_world.secondary_camera()
    imgs = [(torch.from_numpy(a).to(device), torch.from_numpy(b).to(device), ts)
            for a, b, ts in pairs]

    def session():
        draws = ReplayDraws.from_npz(STEREO_FIXTURE, device, prefix="mix_")
        sess = SlamSession(stereo_settings(), ref["mix_cam"], stereo_world.W, stereo_world.H,
                           device, draws=draws)
        steps = [(lambda i=i: sess.process_stereo_frames(imgs[i][0], imgs[i][1], rel,
                                                         imgs[i][2], i, camera1=camera1))
                 for i in range(len(imgs))]
        return sess, steps

    sess, steps = session()
    run_stereo(device, sess, steps[:WARM_FRAMES])           # warm pass
    sess, steps = session()
    maps = []
    reset_launch_counts()
    run = run_stereo(device, sess, steps, [map_recorder(maps)])
    totals = counted_launches()
    classes = check_stereo_launches(run, "mixed rig")
    pose_err, count_err, _ = hold_run(run["results"], maps, ref, "mix_", 1.0, "mixed rig")
    _, ok, remap, cam1_16 = sess._stereo_prep
    cam_err = float(np.abs(cam1_16.cpu().numpy() - ref["mix_cam1_16"]).max())
    kv = sess.map.kf_valid.cpu().numpy()
    post = [k for k in np.flatnonzero(kv) if k >= 1]
    if (not ok or remap is None or cam_err > STEREO_CAM1_ATOL
            or not np.array_equal(kv, ref["mix_final_kf_valid"])
            or not np.array_equal(sess.map.kf_cam.cpu().numpy()[post],
                                  ref["mix_final_kf_cam"][post])):
        raise AssertionError(f"mixed rig: rescale active {ok and remap is not None}, cam1_16 "
                             f"err {cam_err:.3g} (limit {STEREO_CAM1_ATOL}), or the post-init "
                             f"keyframes' intrinsics differ from JAX's")
    rescale_ms = cuda_ms(lambda: remap_bilinear(imgs[0][1], remap), iters=50)
    pair_ms = [t for t, o in zip(run["ms"], run["obs"]) if not o["was_init"]
               and not o["keyframe"]]
    phase("stereo", f"mixed-FOV rig, {len(pairs)} pairs at {stereo_world.W}x{stereo_world.H} "
                    f"through process_stereo_frames (frames equal to the JAX run's by "
                    f"SHA-256): rescale active, cam1_16 within {cam_err:.3g} of JAX's (limit "
                    f"{STEREO_CAM1_ATOL}); every state and keyframe flag as JAX, max pose err "
                    f"{pose_err:.3g} unscaled (limit {POSE_ATOL}, logged frames to "
                    f"{max(LOGGED['mix_'][0].values())}), max tracked diff {count_err}; masks "
                    f"after all "
                    f"{len(maps)} mapping events and the post-init keyframes' intrinsics as "
                    f"JAX's; launches {classes}, totals {totals}")
    phase("stereo", f"mixed-FOV rig wall ms (synchronized, after a warm pass over frames "
                    f"0-{WARM_FRAMES - 1}): pair frame "
                    f"(two frontends + tracking) median {statistics.median(pair_ms):.3f} (min "
                    f"{min(pair_ms):.3f}, max {max(pair_ms):.3f}, n = {len(pair_ms)}); the "
                    f"bootstrap pair {run['ms'][0]:.3f}; the secondary's rescale (one bilinear "
                    f"remap, CUDA events) {rescale_ms:.5f} ms a frame; {card}")
    return {"totals": totals, "pair_ms": pair_ms, "rescale_ms": rescale_ms}


def check_camera_runs(device, card: str) -> dict:
    """Phase 11, parts 4 and 5: the distorted photoreal scene in both
    undistortion modes, and a photoreal session with UseOrientation=True."""
    from mageslam_tpu_torch.ops.undistort import undistort_image
    from mageslam_tpu_torch.runtime.draws import ReplayDraws

    ref = load_npz(CAMERAS_FIXTURE, CAMERAS_KP_FIXTURE, ORIENT_FIXTURE)
    photo = load_npz(PHOTOREAL_FIXTURE)
    frames = list(ref["dist_frames"])
    out = {}
    runs = (("und_", CAMERAS_FIXTURE, dict(settings=camera_settings(undistort_pixels=True),
                                           cam=None, camera=ref["dist_camera"]), frames,
             ref["dist_timestamps"]),
            ("kp_", CAMERAS_KP_FIXTURE, dict(settings=camera_settings(undistort_pixels=False),
                                             cam=None, camera=ref["dist_camera"]), frames,
             ref["dist_timestamps"]),
            ("orient_", ORIENT_FIXTURE, dict(settings=camera_settings(UseOrientation=True),
                                             cam=photo["cam"]),
             list(photo["frames"][:ORIENT_FRAMES]), photo["timestamps"]))
    for prefix, path, kw, imgs, ts in runs:
        maps = []
        draws = ReplayDraws.from_npz(path, device, prefix=prefix)
        reset_launch_counts()
        run = run_from_frame0(device, imgs, draws, [map_recorder(maps)], size=(320, 180),
                              timestamps=ts, **kw)
        totals = counted_launches()
        sess = run["sess"]
        k = float(ref[prefix + "map_scale"]) / sess.map_scale
        if abs(k - 1.0) > SCALE_TOL or any(draws.remaining().values()):
            raise AssertionError(f"{prefix}: map scale ratio {k:.6f}, draws left "
                                 f"{draws.remaining()}")
        pose_err, count_err, diffs = hold_run(run["results"], maps, ref, prefix, k, prefix)
        classes = check_launch_classes(run, prefix)
        kf = [r.frame_id for r in run["results"] if r.is_keyframe]
        tracked_ms = [t for t, o in zip(run["ms"], run["obs"])
                      if not o["was_init"] and not o["keyframe"] and not o["retrained"]]
        what = {"und_": "distorted Poly3K scene, UndistortImagePixels on",
                "kp_": "distorted Poly3K scene, UndistortImagePixels off (keypoints only)",
                "orient_": "photoreal, UseOrientation=True"}[prefix]
        phase("cameras", f"{what}: {len(imgs)} frames from a bare session, JAX draws "
                         f"replayed: every state and keyframe flag as JAX (adopted at "
                         f"{run.get('adopt_frame')}, keyframes {kf}), max pose err "
                         f"{pose_err:.3g} (t scaled by {k:.6f}; limit {POSE_ATOL}), max "
                         f"tracked diff {count_err}; mask entries differing from JAX's after "
                         f"each mapping event {({f: d for f, d in diffs.items() if any(d.values())}) or 'none'}; "
                         f"launches {classes}, totals {totals}; tracked frame wall ms median "
                         f"{statistics.median(tracked_ms):.3f} (n = {len(tracked_ms)}); {card}")
        out[prefix] = {"totals": totals, "tracked_ms": tracked_ms}
    img = torch.from_numpy(frames[0]).to(device).to(torch.float32)
    cam16 = torch.from_numpy(ref["dist_camera"]).to(device)
    undistort_image(img, cam16)                                  # the cached map
    und_ms = cuda_ms(lambda: undistort_image(img, cam16), iters=50)
    phase("cameras", f"undistort_image (UndistortImagePixels: one bilinear remap on the "
                     f"cached rectify map) {und_ms:.5f} ms a 320x180 frame (CUDA events); "
                     f"{card}")
    out["undistort_ms"] = und_ms
    return out


def check_stereo_and_cameras(device, card: str) -> dict:
    """Phase 11."""
    ref = load_npz(STEREO_FIXTURE)
    out, t0 = {}, time.perf_counter()
    for name, check in (("pair", lambda: check_stereo_pair(device, ref)),
                        ("rig", lambda: check_rig_session(device, ref, card)),
                        ("mixed", lambda: check_mixed_rig(device, ref, card)),
                        ("cameras", lambda: check_camera_runs(device, card))):
        out[name] = check()
        phase("time", f"phase 11, {name}: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
    return {**out, **out.pop("cameras")}


VI_FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_vi.npz")
VI_FRAMES = 80
VI_DRAW_KINDS = ("init", "pnp", "vocab")   # the photoreal run's; relocalization's the VI run's
VI_TRACKED_MIN = 64        # tests/test_vi_e2e.py: 0.8 of 80 frames tracked
VI_POSES_MIN = 60          # 0.75 of 80 fossilized poses
VI_TRUTH_RTOL = 0.35       # metric scale against the trajectory's true ratio
VI_SCALE_RTOL = 1e-3       # metric scale against the JAX run's (in its map units)
VI_ATE_ATOL = 1e-3         # m, ATE against the JAX run's
VI_COV_ATOL = 5e-3         # a covariance against JAX's, of its largest entry
VI_REPLAY_ATOL = 1e-4      # a replayed filter's priors and states
VI_REPLAY_SCALE_RTOL = 1e-5
VI_CLOUD_ATOL = 2e-3       # the denoised cloud, of its extent (the normals' signs: queue 3)
VI_LOGGED = LOGGED[""][0]  # frame → pose ceiling, ROADMAP queue 3 (photoreal's frame 71)
# frame 71's borderline inliers reach the filter: the IMU priors of the next
# frames carry them (the CPU at 1-4 threads: 4.1e-3 at 72, fading by 79)
VI_PRIOR_LOGGED = {f: 6e-3 for f in range(72, 80)}
# a frame whose tracked count differs from JAX's (a borderline inlier kept
# or dropped) has another Hessian: its covariance is held to this ceiling
# (the CPU: 0.26-0.38 of the largest entry on frames 71 and 77)
VI_COV_LOGGED_ATOL = 0.5
EKF_FIELDS = ("q", "p", "v", "bg", "ba", "P")


def vi_draws(device):
    from mageslam_tpu_torch.runtime.draws import ReplayDraws

    return ReplayDraws.from_npzs(((PHOTOREAL_FIXTURE, VI_DRAW_KINDS),
                                  (VI_FIXTURE, ("reloc",))), device)


def vi_samples(ref: dict) -> list:
    """apps/vi_eval.py's IMU stream, held to the JAX run's by SHA-256."""
    import hashlib

    from mageslam_tpu_torch.apps.render_scene import trajectory_pose
    from mageslam_tpu_torch.apps.vi_eval import synthesize_imu

    samples = synthesize_imu(trajectory_pose, VI_FRAMES, VI_FRAMES)
    h = hashlib.sha256()
    for s in samples:
        h.update(np.int32(int(s.type)).tobytes() + np.float64(s.timestamp).tobytes()
                 + np.asarray(s.data, np.float32).tobytes())
    if h.hexdigest().encode() != ref["imu_sha256"].item():
        raise AssertionError("the IMU stream differs from the JAX run's")
    return samples


def vi_feed(samples: list):
    """A run_from_frame0 feed: every sample up to the frame's timestamp."""
    at = [0]

    def feed(sess, i, ts):
        while at[0] < len(samples) and samples[at[0]].timestamp <= ts:
            sess.add_sensor_sample(samples[at[0]])
            at[0] += 1
    return feed


def all_kernel_call_recorders(calls: list, where: str):
    """Patch targets recording every call of the kernel wrappers on the
    monocular path, arguments bound to positions (tensors cloned)."""
    from mageslam_tpu_torch.ops import matching
    from mageslam_tpu_torch.runtime import init_step
    from mageslam_tpu_torch.tracking import map_init, pose_estimation, relocalization
    from mageslam_tpu_torch.worldmap import new_points

    return ([(m, "match_two_way", call_recorder(calls, "two_way", where))
             for m in (init_step, map_init, new_points, relocalization)]
            + bow_recorders(calls, where)
            + [(m, "radius_match_stages", call_recorder(calls, "radius", where))
               for m in (matching, pose_estimation)])


def vi_recorders(rec: dict):
    """Patch targets keeping, without reading the device, each frame's
    fuser mode after it, the IMU prior given to tracking and the pose
    covariance (with its inputs, the last frame's kept)."""
    from mageslam_tpu_torch.runtime import session as session_mod

    frame = [0]

    def process(real):
        def call(self, image, timestamp, frame_id):
            frame[0] = frame_id
            out = real(self, image, timestamp, frame_id)
            rec.setdefault("modes", []).append(self.fuser.mode.value)
            return out
        return call

    def prior(real):
        def call(self):
            p = real(self)
            if p is not None:
                rec.setdefault("priors", {})[frame[0]] = p
            return p
        return call

    def cov(real):
        def call(*args):
            out = real(*args)
            rec.setdefault("covs", {})[frame[0]] = out
            rec["cov_args"] = args
            return out
        return call

    return [(session_mod.SlamSession, "process_frame", process),
            (session_mod.SlamSession, "_imu_prior", prior),
            (session_mod, "estimate_pose_covariance", cov)]


def read_counter(reads: list):
    """A patch target counting each frame's host reads, with the fuser's
    mode before the frame and the frame's state."""
    from mageslam_tpu_torch.runtime import session as session_mod

    def wrap(real):
        def call(self, *args, **kwargs):
            mode = self.fuser.mode.name
            with HostReads() as hr:
                out = real(self, *args, **kwargs)
            reads.append((mode, out.state.name, out.is_keyframe, hr.count))
            return out
        return call
    return (session_mod.SlamSession, "process_frame", wrap)


def recorded_calls(ref: dict) -> dict:
    """frame → (R, t, covariance) the JAX session gave Fuser.process_frame."""
    calls = {}
    for i in np.flatnonzero(ref["call_has"]):
        cov = ref["call_cov"][i]
        calls[int(i)] = ((None, None, None) if not ref["call_pose"][i] else
                         (ref["call_R"][i], ref["call_t"][i],
                          None if np.isnan(cov).any() else cov))
    return calls


def check_replays(device, ref: dict, samples: list) -> dict:
    """The three filters replayed on the card on the JAX run's recorded
    samples and visual poses, against JAX's replays (SIMPLE6DOF: its
    session's own fuser)."""
    from mageslam_tpu_torch.apps.vi_eval import replay_fuser
    from mageslam_tpu_torch.config import FilterType
    from mageslam_tpu_torch.fuser.fuser import FuserMode

    calls, out = recorded_calls(ref), {}
    for name in ("SIMPLE6DOF", "FUSER6DOF", "FUSER3DOF"):
        pre = "" if name == "SIMPLE6DOF" else f"rp_{name}_"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = replay_fuser(getattr(FilterType, name), samples, calls, int(ref["adopt_frame"]),
                           VI_FRAMES, device=device)
        ms = (time.perf_counter() - t0) * 1e3
        want = ref[pre + "metric_scale"]
        known = ~np.isnan(want)
        scale_err = (float(np.max(np.abs(got["metric_scale"][known] / want[known] - 1)))
                     if known.any() else 0.0)
        errs = {k: float(np.nanmax(np.abs(got[k] - ref[pre + k])))
                for k in ("prior_R", "prior_t", "ekf_q", "ekf_p", "ekf_v", "ekf_bg", "ekf_ba")
                if got["prior_valid"].any() or not k.startswith("prior")}
        errs["ekf_P"] = float(np.abs(got["ekf_P"] - ref[pre + "ekf_P"]).max()
                              / np.abs(ref[pre + "ekf_P"]).max())
        if (not np.array_equal(got["mode"], ref[pre + "mode"])
                or not np.array_equal(np.isnan(got["metric_scale"]), ~known)
                or scale_err > VI_REPLAY_SCALE_RTOL
                or not np.array_equal(got["prior_valid"], ref[pre + "prior_valid"])
                or max(errs.values()) > VI_REPLAY_ATOL):
            raise AssertionError(f"{name} replay: modes {got['mode'].tolist()}, JAX "
                                 f"{ref[pre + 'mode'].tolist()}; scale err {scale_err:.3g}; "
                                 f"errors {errs}")
        modes = got["mode"].tolist()
        out[name] = {"scale": None if not known.any() else float(got["metric_scale"][-1]),
                     "ms": ms, "errs": errs,
                     "transitions": {m.name: modes.index(m.value) for m in FuserMode
                                     if m.value in modes}}
        phase("vi", f"{name} replayed on the JAX run's samples and visual poses: modes as "
                    f"JAX's (transitions {out[name]['transitions']}), metric scale "
                    f"{out[name]['scale']} (err {scale_err:.3g}, limit "
                    f"{VI_REPLAY_SCALE_RTOL}), max errors {({k: round(v, 8) for k, v in errs.items()})} "
                    f"(limit {VI_REPLAY_ATOL}; P relative); {ms:.1f} ms for 80 frames")
    return out


def check_vi_run(run: dict, rec: dict, maps: list, ref: dict, faults: list) -> dict:
    """The measured VI run against the JAX run: frames, masks, modes, the
    metric scale, priors and covariances. Faults are collected."""
    sess = run["sess"]
    k = float(ref["map_scale"]) / sess.map_scale
    out = {"k": k}
    try:
        out["pose_err"], out["count_err"], _ = hold_run(run["results"], maps, ref, "", k, "vi")
    except AssertionError as e:
        faults.append(str(e))
    errs = [frame_error(r, {n: ref[f"ref_{n}"] for n in ("state", "is_kf", "tracked", "R",
                                                            "t")}, j, k)
            for j, r in enumerate(run["results"])]
    out["over"] = [(r.frame_id, round(e, 6)) for r, (e, _) in zip(run["results"], errs)
                   if e > POSE_ATOL]
    if rec["modes"] != ref["mode"].tolist():
        faults.append(f"vi: fuser modes {rec['modes']}, JAX {ref['mode'].tolist()}")
    scale = sess.fuser.metric_scale
    want = float(ref["final_metric_scale"])
    out["scale_err"] = abs(scale / k / want - 1.0)
    if out["scale_err"] > VI_SCALE_RTOL:
        faults.append(f"vi: metric scale {scale} (in JAX's map units {scale / k}), JAX "
                      f"{want}: {out['scale_err']:.3g} relative (limit {VI_SCALE_RTOL})")
    priors = {i: (p.R.cpu().numpy(), p.t.cpu().numpy()) for i, p in rec["priors"].items()}
    if sorted(priors) != np.flatnonzero(ref["prior_valid"]).tolist():
        faults.append(f"vi: priors on frames {sorted(priors)}, JAX "
                      f"{np.flatnonzero(ref['prior_valid']).tolist()}")
    out["prior_err"] = {i: float(max(np.abs(R - ref["prior_R"][i]).max(),
                                     np.abs(t * k - ref["prior_t"][i]).max()))
                        for i, (R, t) in priors.items() if ref["prior_valid"][i]}
    D = np.diag([k, k, k, 1.0, 1.0, 1.0])
    covs = {i: (c.cpu().numpy(), bool(ok)) for i, (c, ok) in rec["covs"].items()}
    if sorted(covs) != np.flatnonzero(ref["cov_ok"] >= 0).tolist():
        faults.append(f"vi: covariances on frames {sorted(covs)}, JAX "
                      f"{np.flatnonzero(ref['cov_ok'] >= 0).tolist()}")
    out["cov_ok_differs"] = [i for i, (_, ok) in covs.items() if ok != bool(ref["cov_ok"][i])]
    out["cov_err"] = {i: float(np.abs(D @ c @ D - ref["cov"][i]).max()
                               / np.abs(ref["cov"][i]).max())
                      for i, (c, ok) in covs.items() if ok and ref["cov_ok"][i] > 0}
    other_inliers = {r.frame_id for r in run["results"]
                     if r.tracked_count != int(ref["ref_tracked"][r.frame_id])}
    out["cov_logged"] = {i: round(e, 4) for i, e in out["cov_err"].items()
                         if i in other_inliers}
    over_cov = {i: e for i, e in out["cov_err"].items()
                if e > (VI_COV_LOGGED_ATOL if i in other_inliers else VI_COV_ATOL)}
    out["prior_logged"] = {i: round(e, 6) for i, e in out["prior_err"].items()
                           if e > POSE_ATOL}
    over_prior = {i: e for i, e in out["prior_err"].items()
                  if e > VI_PRIOR_LOGGED.get(i, POSE_ATOL)}
    if out["cov_ok_differs"] or over_cov or over_prior:
        faults.append(f"vi: covariance flags differ on {out['cov_ok_differs']}, covariances "
                      f"beyond the tolerance {over_cov} (limit {VI_COV_ATOL}, "
                      f"{VI_COV_LOGGED_ATOL} where the tracked count differs), priors beyond "
                      f"the tolerance {over_prior}")
    return out


def check_vi_queries(sess, ref: dict, k: float, card: str, faults: list) -> dict:
    """The live queries, then fossilize_map: trajectory and ATE, the raw and
    denoised clouds and the volume of interest, against the JAX run's."""
    from mageslam_tpu_torch.analysis.clouds import reposition_points
    from mageslam_tpu_torch.apps.evaluate import ate_rmse

    out = {}
    live = sess.get_tracking_results_for_frames(range(VI_FRAMES))
    has = np.asarray([m is not None for m in live])
    if not np.array_equal(has, ref["live_has"]):
        faults.append(f"vi: live tracking results on {has.sum()} frames, JAX "
                      f"{int(ref['live_has'].sum())}")
    else:
        out["live_err"] = max_mat_err(np.stack([m for m in live if m is not None]),
                                      ref["live_mats"][has], k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    voi = sess.try_get_volume_of_interest()
    out["live_voi_ms"] = (time.perf_counter() - t0) * 1e3
    out["live_voi_err"] = voi_error(voi, ref, "live_voi", k, faults)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fm = sess.fossilize_map()
    out["fossilize_map_ms"] = (time.perf_counter() - t0) * 1e3
    ids, mats = fm.trajectory()
    if ids.tolist() != ref["fossil_ids"].tolist():
        faults.append(f"vi: fossilized frames {ids.tolist()}, JAX "
                      f"{ref['fossil_ids'].tolist()}")
    else:
        errs = np.maximum(np.abs(mats[:, :3, :3] - ref["fossil_mats"][:, :3, :3]).max((1, 2)),
                          np.abs(mats[:, :3, 3] * k - ref["fossil_mats"][:, :3, 3]).max(1))
        out["fossil_over"] = [(int(f), round(float(e), 6)) for f, e in zip(ids, errs)
                              if e > VI_LOGGED.get(int(f), POSE_ATOL)]
        if out["fossil_over"]:
            faults.append(f"vi: fossilized poses beyond the tolerance {out['fossil_over']}")
    with np.load(PHOTOREAL_FIXTURE) as z:
        ts_all, gt_c = z["timestamps"], z["gt_c"]
    centers = np.asarray([-m[:3, :3].T @ m[:3, 3] for m in mats])
    out["ate"], out["n_poses"] = ate_rmse(ts_all[ids], centers, ts_all, gt_c)
    gt_seq = gt_c[ids]
    out["scale_true"] = (float(np.linalg.norm(np.diff(gt_seq, axis=0), axis=1).sum())
                         / float(np.linalg.norm(np.diff(centers, axis=0), axis=1).sum()))
    if not (out["ate"] < ATE_LIMIT and abs(out["ate"] - float(ref["jax_ate"])) <= VI_ATE_ATOL
            and out["n_poses"] >= VI_POSES_MIN):
        faults.append(f"vi: ATE {out['ate']:.6f} m over {out['n_poses']} poses (limit "
                      f"{ATE_LIMIT}, JAX {float(ref['jax_ate']):.6f} +- {VI_ATE_ATOL})")

    raw = fm.map_points()
    want_raw = ref["fm_points_raw"]
    if raw.shape != want_raw.shape:
        faults.append(f"vi: {len(raw)} fossilized map points, JAX {len(want_raw)}")
        return out
    extent = float(np.ptp(want_raw, axis=0).max())
    out["raw_err"] = float(np.abs(raw * k - want_raw).max()) / extent
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dn = fm.map_points(denoised=True)
    out["denoised_ms"] = (time.perf_counter() - t0) * 1e3
    out["denoised_err"] = float(np.abs(dn * k - ref["fm_points"]).max()) / extent
    if out["denoised_err"] > VI_CLOUD_ATOL:
        faults.append(f"vi: denoised cloud {out['denoised_err']:.3g} of its extent from "
                      f"JAX's (limit {VI_CLOUD_ATOL}; raw {out['raw_err']:.3g})")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    voi = fm.try_get_volume_of_interest()
    out["voi_ms"] = (time.perf_counter() - t0) * 1e3
    out["voi_err"] = voi_error(voi, ref, "fm_voi", k, faults)
    m = sess.map
    out["reposition_ms"] = cuda_ms(lambda: reposition_points(m.mp_pos, m.mp_valid), iters=5,
                                   warmup=1, reps=3)
    events = profile(lambda: reposition_points(m.mp_pos, m.mp_valid))
    out["reposition_events"] = len(events)
    out["reposition_device_ms"] = sum(_device_us(e) for e in events) / 1e3
    out["reposition_top"] = top_kernels(events)
    out["n_points"] = int(m.mp_valid.sum())
    return out


def max_mat_err(got: np.ndarray, want: np.ndarray, k: float) -> float:
    return float(max(np.abs(got[:, :3, :3] - want[:, :3, :3]).max(),
                     np.abs(got[:, :3, 3] * k - want[:, :3, 3]).max()))


def voi_error(voi, ref: dict, key: str, k: float, faults: list) -> float | None:
    """A volume of interest (scaled into JAX's map units) against JAX's, in
    voxels of its last level of detail; more than one is a fault."""
    if (voi is not None) != bool(ref[key + "_ok"]):
        faults.append(f"vi: {key} {'found' if voi is not None else 'none'}, JAX's "
                      f"{'found' if ref[key + '_ok'] else 'none'}")
        return None
    if voi is None:
        return 0.0
    want = ref[key]
    voxel = float(np.max(want[1] - want[0])) / 23.0
    err = float(np.abs(np.stack(voi) * k - want).max()) / voxel
    if err > 1.0:
        faults.append(f"vi: {key} {np.stack(voi).tolist()} (x {k:.6f}) against JAX's "
                      f"{want.tolist()}: {err:.3g} voxels")
    return err


def time_fuser_steps(device, sess, cov_args, card: str) -> dict:
    """ekf_predict on the run's final filter state, and the pose covariance
    on the last VI-tracked frame's inputs: ms a call (CUDA events) and device
    events and ms (profiler)."""
    from mageslam_tpu_torch.fuser.covariance import estimate_pose_covariance
    from mageslam_tpu_torch.fuser.filters import ekf_predict, ekf_update_pose
    from mageslam_tpu_torch.geometry.se3 import Pose

    state = sess.fuser.state
    gyro = torch.tensor([0.01, -0.02, 0.005], device=device)
    accel = torch.tensor([0.1, 0.2, 9.8], device=device)
    dt = torch.tensor(1 / 120.0, device=device)
    pose = Pose(torch.eye(3, device=device), torch.zeros(3, device=device))
    out = {}
    for name, fn in (("ekf_predict", lambda: ekf_predict(state, gyro, accel, dt)),
                     ("ekf_update_pose", lambda: ekf_update_pose(state, pose)),
                     ("estimate_pose_covariance", lambda: estimate_pose_covariance(*cov_args))):
        ms = cuda_ms(fn, iters=50, warmup=5, reps=3)
        events = profile(fn)
        out[name] = {"ms": ms, "events": len(events),
                     "device_ms": sum(_device_us(e) for e in events) / 1e3,
                     "top": top_kernels(events, 3)}
        phase("vi", f"{name}: {ms:.5f} ms a call (CUDA events, 3 x 50 calls), {len(events)} "
                    f"device events, {out[name]['device_ms']:.4f} ms of device time a call; "
                    f"top kernels {out[name]['top']}; {card}")
    return out


def check_vi(device, card: str) -> dict:
    """Phase 12. Returns the measured run's launch totals."""
    from mageslam_tpu_torch import golden_path_settings
    from mageslam_tpu_torch.apps.vi_eval import run_vi_eval, vi_settings
    from mageslam_tpu_torch.runtime.draws import ReplayDraws

    ref = load_npz(VI_FIXTURE)
    photo = load_npz(PHOTOREAL_FIXTURE)
    frames, ts = list(photo["frames"]), photo["timestamps"]
    samples = vi_samples(ref)
    faults, calls, reads = [], [], []
    clock = time.perf_counter()

    # run 1, the app's entry point: warm, every kernel call captured, the
    # host reads counted; tests/test_vi_e2e.py's gates on its summary
    with Patched(*all_kernel_call_recorders(calls, "VI run"), read_counter(reads)):
        e2e = run_vi_eval(VI_FRAMES, device=device, draws=vi_draws(device),
                          frames=photo["frames"], verbose=False)
    tr = e2e["transitions"]
    want_tr = {m: int(np.argmax(ref["mode"] == v)) for m, v in
               (("WAIT_FOR_GRAVITY", 1), ("SCALE_INIT", 2), ("TRACKING", 3))}
    e2e_ok = (e2e["final_mode"] == "TRACKING" and tr.get("SCALE_INIT", 99) < tr.get("TRACKING", -1)
              and e2e["metric_scale"] is not None
              and abs(e2e["metric_scale"] - e2e["scale_true"]) / e2e["scale_true"] < VI_TRUTH_RTOL
              and e2e["tracked"] >= VI_TRACKED_MIN and e2e["n_poses"] >= VI_POSES_MIN
              and e2e["ate_rmse"] < ATE_LIMIT)
    phase("vi", f"run_vi_eval(80) on the card, JAX draws replayed: transitions {tr} (JAX "
                f"{want_tr}), final {e2e['final_mode']}, metric scale {e2e['metric_scale']} "
                f"(true {e2e['scale_true']:.5f}, limit {VI_TRUTH_RTOL:.0%}), tracked "
                f"{e2e['tracked']}/80 (limit {VI_TRACKED_MIN}), ATE {e2e['ate_rmse']:.6f} m over "
                f"{e2e['n_poses']} poses (limit {ATE_LIMIT}; JAX {float(ref['jax_ate']):.6f}), "
                f"{e2e['keyframes']} keyframes, {e2e['elapsed_s']:.1f} s with every kernel call "
                f"captured and host reads counted")
    if tr != want_tr or not e2e_ok:
        faults.append(f"vi: run_vi_eval's summary misses tests/test_vi_e2e.py's gates or "
                      f"JAX's transitions: {dict((k, v) for k, v in e2e.items() if k != 'session')}")
    by_mode = {}
    for mode, state, kf, n in reads:
        key = f"{mode}/{state}{'/keyframe' if kf else ''}"
        by_mode.setdefault(key, set()).add(n)
    phase("vi", "host reads a frame by (fuser mode before it / frame state): "
                + str({k: sorted(v) for k, v in sorted(by_mode.items())}))
    phase("time", f"phase 12, run_vi_eval: {time.perf_counter() - clock:.1f} s")

    # run 2, measured: the session's entry points, JAX draws, held against
    # the JAX run frame by frame
    rec, maps = {}, []
    settings = vi_settings()
    reset_launch_counts()
    run = run_from_frame0(device, frames, vi_draws(device), [map_recorder(maps),
                                                               *vi_recorders(rec)],
                          cam=ref["cam"], size=PHOTOREAL_SIZE, timestamps=ts,
                          settings=settings, feed=vi_feed(samples))
    totals = counted_launches()
    sess = run["sess"]
    held = check_vi_run(run, rec, maps, ref, faults)
    try:
        classes = check_launch_classes(run, "vi")
    except AssertionError as e:
        faults.append(str(e))
        classes = None
    phase("vi", f"80 frames through SlamSession.add_sensor_sample / process_frame, JAX "
                f"draws replayed: fuser modes {'as' if rec['modes'] == ref['mode'].tolist() else 'NOT as'} "
                f"JAX's; max pose err {held.get('pose_err', float('nan')):.3g} (t scaled by "
                f"{held['k']:.6f}; limit {POSE_ATOL}), frames beyond {held['over'] or 'none'}; "
                f"metric scale {sess.fuser.metric_scale} ({held['scale_err']:.3g} from JAX's in "
                f"its map units, limit {VI_SCALE_RTOL}); priors on {len(held['prior_err'])} "
                f"frames, beyond {POSE_ATOL} (logged after frame 71): "
                f"{held['prior_logged'] or 'none'}; covariances on {len(held['cov_err'])} "
                f"frames, flags differing {held['cov_ok_differs'] or 'none'}, max err where the "
                f"tracked count is JAX's "
                f"{max(e for i, e in held['cov_err'].items() if i not in held['cov_logged']):.3g} "
                f"of the largest entry (limit {VI_COV_ATOL}), where it differs "
                f"{held['cov_logged'] or 'none'} (limit {VI_COV_LOGGED_ATOL}); launches by class "
                f"{classes}, totals {totals}")

    # run 3: the same frames vision-only, for the wall-time comparison
    vision = run_from_frame0(device, frames, ReplayDraws.from_npz(PHOTOREAL_FIXTURE, device),
                             cam=photo["cam"], size=PHOTOREAL_SIZE, timestamps=ts)
    first_vi = int(np.argmax(ref["prior_valid"]))

    def tracked_ms(r, lo):
        return [t for j, (t, o) in enumerate(zip(r["ms"], r["obs"])) if j >= lo
                and not o["was_init"] and not o["keyframe"] and not o["retrained"]
                and not o.get("detections")]
    vi_ms, vo_ms = tracked_ms(run, first_vi), tracked_ms(vision, first_vi)
    phase("vi", f"wall ms a tracked frame (process_frame + synchronize, frames {first_vi}-79, "
                f"no keyframe): VI (IMU prior, covariance, EKF update) median "
                f"{statistics.median(vi_ms):.3f} (min {min(vi_ms):.3f}, max {max(vi_ms):.3f}, "
                f"n = {len(vi_ms)}); vision-only, the same frames, median "
                f"{statistics.median(vo_ms):.3f} (min {min(vo_ms):.3f}, max {max(vo_ms):.3f}, "
                f"n = {len(vo_ms)}); {card}")
    phase("time", f"phase 12, measured and vision-only runs: {time.perf_counter() - clock:.1f} s")

    queries = check_vi_queries(sess, ref, held["k"], card, faults)
    phase("vi", f"live queries before fossilize: tracking results max err "
                f"{queries.get('live_err', float('nan')):.3g}, volume of interest "
                f"{queries['live_voi_err']} voxels from JAX's ({queries['live_voi_ms']:.3f} ms); "
                f"fossilize_map {queries['fossilize_map_ms']:.3f} ms: ATE "
                f"{queries['ate']:.6f} m over {queries['n_poses']} poses (JAX "
                f"{float(ref['jax_ate']):.6f}, limit +- {VI_ATE_ATOL}), fossilized poses beyond "
                f"{POSE_ATOL}: {queries.get('fossil_over') or 'none'}; scale true "
                f"{queries['scale_true']:.5f}; {queries.get('n_points')} map points, raw cloud "
                f"{queries.get('raw_err', float('nan')):.3g} of the extent from JAX's, denoised "
                f"{queries.get('denoised_err', float('nan')):.3g} (limit {VI_CLOUD_ATOL}) in "
                f"{queries.get('denoised_ms', float('nan')):.3f} ms; volume of interest "
                f"{queries.get('voi_err')} voxels from JAX's in "
                f"{queries.get('voi_ms', float('nan')):.3f} ms; {card}")
    if "reposition_ms" in queries:
        phase("vi", f"reposition_points on the 2048-slot bank ({queries['n_points']} valid): "
                    f"{queries['reposition_ms']:.4f} ms a call (CUDA events), "
                    f"{queries['reposition_events']} device events, "
                    f"{queries['reposition_device_ms']:.4f} ms of device time; top "
                    f"{queries['reposition_top']}; {card}")
    steps = time_fuser_steps(device, sess, rec["cov_args"], card)
    replays = check_replays(device, ref, samples)
    phase("time", f"phase 12, queries and replays: {time.perf_counter() - clock:.1f} s")
    hold_path_calls(calls, "the VI run")
    if faults:
        raise AssertionError("phase 12 (VI): " + " | ".join(faults))
    return {"totals": totals, "steps": steps, "replays": replays, "queries": queries,
            "vi_ms": vi_ms, "vision_ms": vo_ms}


# --------------------------------------------------------------- phase 13 ----

STREAM_FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_stream.npz")
STREAM_FIRST, STREAM_LAST = 31, 95        # the stream window, bench frames
STREAM_CHUNK, STREAM_DEPTH = 8, 4         # bench.py's depth
CHUNKED_CHUNK = 4
STREAM_KERNELS = ("radius_match", "two_way_match", "bow_assign")   # launched in the window
PIPELINED_LAST = 58
SNAPSHOT_LAST = 62                        # the stream saved after 4 chunks, then continued
TIMED_LAST = 62                           # the entry points timed on 31-62 (4 chunks)
TIMED_ROUNDS = 3                          # each entry point timed 3 times, interleaved
REALTIME_PACED, REALTIME_DROPPED = range(31, 39), range(39, 43)
ORBIT = (324, 288, 240, 135)              # tests/test_stream_loop_ci.py's run
ORBIT_TRACKED_MIN = 100
ORBIT_ATE_LIMIT = 0.15
CONSOLE_TIMEOUT = 600
DET_STATS = ("deferred", "resolved", "stale_slot", "closed", "requeued", "same_loop_dropped")


def stream_settings():
    """bench.py's settings: golden with LoopClosureSettings.MinKeyframe 3."""
    import dataclasses

    from mageslam_tpu_torch import golden_path_settings

    s = golden_path_settings()
    return dataclasses.replace(s, LoopClosureSettings=dataclasses.replace(
        s.LoopClosureSettings, MinKeyframe=3))


def stream_session(device, prefix: str | None):
    """A card session from the stream fixture's frame-30 state, its
    relocalization draws replayed from the call `prefix` (None: its own
    generator), at bench.py's resolution depth."""
    from mageslam_tpu_torch import SlamSession
    from mageslam_tpu_torch.runtime.draws import ReplayDraws

    draws = (None if prefix is None else
             ReplayDraws.from_npz(STREAM_FIXTURE, device, kinds=("reloc",), prefix=prefix))
    sess = SlamSession.from_jax_snapshot(STREAM_FIXTURE, stream_settings(), CAM, WIDTH, HEIGHT,
                                         device, draws=draws)
    sess._chunk_pipeline_depth = STREAM_DEPTH
    return sess


def stream_event_recorder(events: list):
    """Patch targets keeping the map's masks right after every mapping step,
    on the chunk path and the per-frame path."""
    from mageslam_tpu_torch.runtime import session as session_mod
    from mageslam_tpu_torch.runtime import streaming

    def wrap(real):
        def call(*args, **kwargs):
            out = real(*args, **kwargs)
            events.append((args[5].frame_id, out[2], {n: getattr(out[0], n).clone()
                                                      for n in MAP_MASKS}))
            return out
        return call
    return [(streaming, "mapping", wrap), (session_mod, "mapping", wrap)]


def hold_stream(results, ref: dict, prefix: str, ids, faults: list, events=None) -> dict:
    """Each result against the JAX call's: states and keyframe flags exact,
    R and t within POSE_ATOL, tracked counts within TRACKED_TOL; the masks
    after each mapping step exact."""
    n = len(results)
    got_ids = [r.frame_id for r in results]
    states = [r.state.value for r in results]
    kfs = [r.is_keyframe for r in results]
    out = {"pose_err": float("nan"), "count_err": None}
    if got_ids != list(ids) or states != ref[prefix + "ref_state"][:n].tolist() \
            or kfs != ref[prefix + "ref_is_kf"][:n].tolist():
        faults.append(f"{prefix}: ids/states/keyframes differ from JAX's: keyframes at "
                      f"{[i for i, k in zip(got_ids, kfs) if k]} (JAX "
                      f"{np.asarray(list(ids))[ref[prefix + 'ref_is_kf'][:n]].tolist()})")
        return out
    R = np.stack([np.asarray(torch.as_tensor(r.pose.R).cpu()) for r in results])
    t = np.stack([np.asarray(torch.as_tensor(r.pose.t).cpu()) for r in results])
    out["pose_err"] = float(max(np.abs(R - ref[prefix + "ref_R"][:n]).max(),
                                np.abs(t - ref[prefix + "ref_t"][:n]).max()))
    out["count_err"] = int(np.abs(np.array([r.tracked_count for r in results])
                                  - ref[prefix + "ref_tracked"][:n]).max())
    if not out["pose_err"] <= POSE_ATOL or out["count_err"] > TRACKED_TOL:
        faults.append(f"{prefix}: pose err {out['pose_err']:.3g} (limit {POSE_ATOL}) or "
                      f"tracked diff {out['count_err']} (limit {TRACKED_TOL})")
    if events is not None:
        ev_ids = [int(e[0]) for e in events]
        diffs = {}
        for j, (_, _, masks) in enumerate(events):
            d = {m: int((masks[m].cpu().numpy() != ref[f"{prefix}ev{j}_{m}"]).sum())
                 for m in MAP_MASKS if f"{prefix}ev{j}_{m}" in ref}
            if any(d.values()):
                diffs[ev_ids[j]] = d
        out["events"], out["mask_diffs"] = ev_ids, diffs
        if ev_ids != ref[prefix + "ev_frame_id"].tolist() or diffs:
            faults.append(f"{prefix}: mapping steps at {ev_ids} (JAX "
                          f"{ref[prefix + 'ev_frame_id'].tolist()}), masks differing {diffs}")
    return out


def same_results(got, want, what: str, faults: list) -> float:
    """Two runs' results frame by frame: ids, states, keyframe flags exact,
    poses within POSE_ATOL and tracked counts within TRACKED_TOL. Returns
    the largest pose difference."""
    key = lambda rs: [(r.frame_id, r.state, r.is_keyframe) for r in rs]
    if key(got) != key(want):
        faults.append(f"{what}: frames, states or keyframes differ")
        return float("nan")
    err, cnt = 0.0, 0
    for a, b in zip(got, want):
        if a.pose is not None:
            err = max(err, float((torch.as_tensor(a.pose.R).cpu() -
                                  torch.as_tensor(b.pose.R).cpu()).abs().max()),
                      float((torch.as_tensor(a.pose.t).cpu() -
                             torch.as_tensor(b.pose.t).cpu()).abs().max()))
        cnt = max(cnt, abs(a.tracked_count - b.tracked_count))
    if not err <= POSE_ATOL or cnt > TRACKED_TOL:
        faults.append(f"{what}: pose difference {err:.3g} or tracked difference {cnt}")
    return err


def timed_entry(device, run, n_frames: int) -> dict:
    """Wall ms a frame (the whole call, synchronized, over its frames) and
    host reads a frame of `run(sess)` on a fresh session with its own
    generator; returns those with run's own return value."""
    sess = stream_session(device, None)
    torch.cuda.synchronize()
    with HostReads() as hr:
        t0 = time.perf_counter()
        out = run(sess)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return {"ms_a_frame": wall / n_frames, "reads_a_frame": hr.count / n_frames,
            "sess": sess, "out": out}


_ORBIT_SCENE: dict = {}


def _orbit_worker() -> None:
    from mageslam_tpu_torch.apps.render_scene import build_scene

    _ORBIT_SCENE["surfaces"] = build_scene(7, variant="loop")


def _render_orbit_frame(i: int):
    """Frame i of `render_sequence(*ORBIT's size, trajectory="orbit")`, the
    same bit for bit (seed 7, 30 fps, supersampled 2x below 640 wide)."""
    from mageslam_tpu_torch.apps.render_scene import render_frame, trajectory_pose_orbit

    _, period, w, h = ORBIT
    R, c = trajectory_pose_orbit(i, period)
    img = render_frame(_ORBIT_SCENE["surfaces"], R, c, w, h, frame_index=i, supersample=2)
    return img, i / 30.0, i, R, c


def start_orbit_render():
    """The orbit's frames, rendered in the background by one spawned process
    fewer than the machine has cores while the held stream runs use the
    card (sequentially they take as long as the orbit's run). Returns
    (pool, pending); the frames are `pending.get()`."""
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(max(1, (os.cpu_count() or 2) - 1),
                                                     _orbit_worker)
    return pool, pool.map_async(_render_orbit_frame, range(ORBIT[0]))


def check_orbit(device, render, faults: list) -> dict:
    """tests/test_stream_loop_ci.py's stream-path orbit on the card with the
    session's own generator, on the frames `start_orbit_render` made."""
    from mageslam_tpu_torch.apps.loop_eval import run_orbit_eval

    n, period, w, h = ORBIT
    pool, pending = render
    t0 = time.perf_counter()
    frames = pending.get()
    pool.close()
    pool.join()
    wait_s = time.perf_counter() - t0
    r = run_orbit_eval(n, period, w, h, verbose=False, mode="stream", device=device,
                       frames=frames)
    st = r["loop_det_stats"]
    ok = (r["loops_closed"] >= 1 and r["tracked"] >= ORBIT_TRACKED_MIN
          and r["ate_rmse"] < ORBIT_ATE_LIMIT and st["deferred"] > 0
          and st["resolved"] >= st["deferred"] and st["closed"] >= 1)
    phase("stream", f"orbit {n} frames at {w}x{h} (period {period}) through "
                    f"process_frames_chunked, own generator: {r['loops_closed']} loops closed, "
                    f"tracked {r['tracked']} (limit {ORBIT_TRACKED_MIN}), {r['keyframes']} "
                    f"keyframes, ATE {r['ate_rmse']:.6f} m over {r['n_poses']} poses (limit "
                    f"{ORBIT_ATE_LIMIT}), loop_det_stats {st}; frames waited for {wait_s:.1f} s "
                    f"after the held runs, run {r['elapsed_s']:.1f} s")
    if not ok:
        faults.append(f"orbit misses tests/test_stream_loop_ci.py's gates: "
                      f"{ {k: v for k, v in r.items() if k != 'states'} }")
    return r


def check_console(device, faults: list) -> dict:
    """The console on the photoreal frames written to a `.mgts` capture, as a
    subprocess on the card with the fixture's intrinsics (and the JAX run's
    draws replayed), its CSV held to tests/test_photoreal_ate.py's gate."""
    import tempfile

    from mageslam_tpu_torch.apps.evaluate import ate_rmse, load_trajectory_csv
    from mageslam_tpu_torch.io.capture import CaptureHeader, CaptureWriter

    ref = load_npz(PHOTOREAL_FIXTURE)
    w, h = PHOTOREAL_SIZE
    with tempfile.TemporaryDirectory() as tmp:
        cap, csv = os.path.join(tmp, "photoreal.mgts"), os.path.join(tmp, "trajectory.csv")
        cam16 = np.zeros(16, np.float32)
        cam16[:4] = ref["cam"]
        with CaptureWriter(cap, CaptureHeader(w, h, cam16, "render_scene")) as wr:
            for i, (px, ts) in enumerate(zip(ref["frames"], ref["timestamps"])):
                wr.write_frame(px, float(ts), i)
        fx, fy, cx, cy = (repr(float(v)) for v in ref["cam"])
        cmd = [sys.executable, "-m", "mageslam_tpu_torch.apps.console", cap, "-o", csv,
               "--width", str(w), "--height", str(h), "--fx", fx, "--fy", fy, "--cx", cx,
               "--cy", cy, "--draws", PHOTOREAL_FIXTURE, "--device", device.type]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=CONSOLE_TIMEOUT)
        wall = time.perf_counter() - t0
        summary = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
        if proc.returncode != 0:
            faults.append(f"console exited {proc.returncode}: {summary} {proc.stderr[-2000:]}")
            return {"rc": proc.returncode}
        ids, ts, centers = load_trajectory_csv(csv)
    fields = dict(kv.split("=", 1) for kv in summary.split() if "=" in kv)
    n, tracked = int(fields["frames"]), int(fields["tracked"])
    rmse, n_ate = ate_rmse(ts, centers, ref["timestamps"], ref["gt_c"])
    phase("stream", f"console subprocess on an 80-frame .mgts capture: rc 0 in {wall:.1f} s "
                    f"({summary}); {len(ids)} CSV poses, ATE {rmse:.6f} m over {n_ate} (limit "
                    f"{ATE_LIMIT}), tracked {tracked}/{n} (limit {TRACKED_SHARE:.0%})")
    if not (rmse < ATE_LIMIT and tracked >= TRACKED_SHARE * n):
        faults.append(f"console: ATE {rmse} or tracked {tracked}/{n} misses the gate")
    return {"rc": 0, "ate": rmse, "tracked": tracked, "wall_s": wall}


def check_stream(device, card: str) -> dict:
    """Phase 13. Returns the measured stream run's launch totals."""
    import tempfile

    from mageslam_tpu_torch import SlamSession, TrackingState
    from mageslam_tpu_torch.io.snapshot import load_session_snapshot, save_session_snapshot
    from mageslam_tpu_torch.runtime.draws import ReplayDraws

    ref = load_npz(STREAM_FIXTURE)
    faults, calls = [], []
    clock = time.perf_counter()
    frames = render_window(0, STREAM_LAST + 1)
    bank = torch.from_numpy(np.stack(frames)).to(device)
    ts = [i * DT for i in range(STREAM_LAST + 1)]
    ids = list(range(STREAM_LAST + 1))
    window = range(STREAM_FIRST, STREAM_LAST + 1)

    def stream(sess, first=STREAM_FIRST, last=STREAM_LAST):
        return sess.process_frame_stream(bank, ts, ids, start=first, stop=last + 1,
                                         chunk=STREAM_CHUNK)

    # the four entry points on the same frames: wall ms and host reads a frame
    timed = range(STREAM_FIRST, TIMED_LAST + 1)
    n_timed = len(timed)

    def per_frame(sess):
        out = []
        for i in timed:
            t0 = time.perf_counter()
            sess.process_frame(bank[i], ts[i], i)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    def pipelined(sess):
        for i in timed:
            sess.process_frame_pipelined(bank[i], ts[i], i)
        sess.flush()

    def realtime(sess):
        n0 = len(sess.results)
        for i in timed:
            sess.process_frame_realtime(bank[i], ts[i], i)
        sess.flush()
        return sum(r.state == TrackingState.SKIPPED for r in sess.results[n0:])

    runs = {"process_frame": per_frame,
            "process_frame_stream": lambda s: stream(s, STREAM_FIRST, TIMED_LAST),
            "process_frame_pipelined": pipelined, "process_frame_realtime": realtime}
    entry = {k: [] for k in runs}
    for rnd in range(TIMED_ROUNDS):     # interleaved, the order reversed every other round
        for k in (list(runs) if rnd % 2 == 0 else list(runs)[::-1]):
            entry[k].append(timed_entry(device, runs[k], n_timed))
    dropped = [e["out"] for e in entry["process_frame_realtime"]]
    per_frame_ms = [ms for e in entry["process_frame"] for ms in e["out"]]
    numbers = {k: {"ms_a_frame": [round(e["ms_a_frame"], 3) for e in v],
                   "median_ms_a_frame": round(statistics.median(e["ms_a_frame"] for e in v), 3),
                   "reads_a_frame": [round(e["reads_a_frame"], 3) for e in v]}
               for k, v in entry.items()}
    numbers["process_frame"]["median_frame_ms"] = round(statistics.median(per_frame_ms), 3)
    phase("stream", f"frames {STREAM_FIRST}-{TIMED_LAST}, each entry point on a fresh session "
                    f"(own generator), {TIMED_ROUNDS} interleaved rounds in the orders "
                    f"{list(runs)} and back: wall ms and host reads a frame (whole call, "
                    f"synchronized, over {n_timed} frames) a round {numbers}; "
                    f"process_frame_realtime back to back at the default depth "
                    f"(MaxPendingKeyframes) dropped {dropped} of {n_timed} frames; {card}")

    # realtime: the drop gate and paced frames
    rsess = stream_session(device, None)
    for i in REALTIME_PACED:
        rsess.process_frame_realtime(bank[i], ts[i], i)
        rsess.flush()
    paced_ok = all(r.state == TrackingState.TRACKING for r in rsess.results)
    lost = rsess.lost_count
    drops = [rsess.process_frame_realtime(bank[i], ts[i], i, max_inflight=0)
             for i in REALTIME_DROPPED]
    drop_ok = all(r is not None and r.state == TrackingState.SKIPPED for r in drops) \
        and rsess.lost_count == lost
    phase("stream", f"process_frame_realtime: paced frames {REALTIME_PACED.start}-"
                    f"{REALTIME_PACED.stop - 1} (flush after each) "
                    f"{'all' if paced_ok else 'NOT all'} TRACKING; max_inflight=0 drops "
                    f"{sum(r.state == TrackingState.SKIPPED for r in drops)}/{len(drops)} as "
                    f"SKIPPED, lost count {'unchanged' if rsess.lost_count == lost else 'CHANGED'}")
    if not (paced_ok and drop_ok):
        faults.append("realtime: paced frames did not all track, or the drop gate failed")

    # device events a frame: one chunk of the stream, traced
    tsess = stream_session(device, None)
    stream(tsess, STREAM_FIRST, STREAM_FIRST + STREAM_CHUNK - 1)
    tsess = stream_session(device, None)
    ev = profile(lambda: stream(tsess, STREAM_FIRST, STREAM_FIRST + STREAM_CHUNK - 1))
    dev_ms = sum(_device_us(e) for e in ev) / 1e3
    phase("profile", f"process_frame_stream, one chunk of {STREAM_CHUNK} frames "
                     f"({STREAM_FIRST}-{STREAM_FIRST + STREAM_CHUNK - 1}, resolved): "
                     f"{len(ev) / STREAM_CHUNK:.1f} device events and "
                     f"{dev_ms / STREAM_CHUNK:.3f} ms of device time a frame; {card}")
    phase("time", f"phase 13, entry points timed: {time.perf_counter() - clock:.1f} s")
    render = start_orbit_render()
    try:
        # run 1: every kernel call captured, held against the JAX stream call
        sess = stream_session(device, "s95_")
        snap = sess.snapshot_state()
        events = []
        with Patched(*all_kernel_call_recorders(calls, "stream"), *stream_event_recorder(events)):
            held_run = stream(sess)
        held = hold_stream(held_run, ref, "s95_", window, faults, events)
        stats = [sess.loop_det_stats[k] for k in DET_STATS]
        if stats != ref["s95_det_stats"].tolist():
            faults.append(f"stream loop_det_stats {dict(zip(DET_STATS, stats))} != JAX "
                          f"{dict(zip(DET_STATS, ref['s95_det_stats'].tolist()))}")
        phase("stream", f"process_frame_stream over {STREAM_FIRST}-{STREAM_LAST} (chunk "
                        f"{STREAM_CHUNK}, depth {STREAM_DEPTH}, uint8 bank on the card) against "
                        f"JAX's: keyframes at {held.get('events')}, max pose err "
                        f"{held['pose_err']:.3g} (limit {POSE_ATOL}), max tracked diff "
                        f"{held['count_err']} (limit {TRACKED_TOL}), masks differing "
                        f"{held.get('mask_diffs') or 'none'}, loop_det_stats "
                        f"{dict(zip(DET_STATS, stats))} (JAX's: "
                        f"{'equal' if stats == ref['s95_det_stats'].tolist() else 'DIFFERENT'})")

        # run 2, the measured main path: launches counted from 0, host reads
        sess.restore_state(snap)
        reset_launch_counts()
        torch.cuda.synchronize()
        with HostReads() as hr:
            measured = stream(sess)
        totals = counted_launches()
        stream_reads = hr.count
        same_results(measured, held_run, "stream run 2 against run 1", faults)
        # the window maps keyframes and runs detection but never retrains, and
        # the standalone Hamming kernel has no path call
        if not all(totals[k] for k in STREAM_KERNELS) or totals["hamming_matrix"]:
            faults.append(f"stream window: a kernel of the path never launched, or the "
                          f"standalone Hamming kernel did: {totals}")
        phase("stream", f"measured stream run: launches {totals}; {stream_reads / len(window):.2f} "
                        f"host reads a frame (whole call / {len(window)} frames)")

        # chunked, chunk 4, the same window (the tail frame per frame)
        sess.restore_state(snap)
        chunked = []
        for base in range(STREAM_FIRST, STREAM_LAST, CHUNKED_CHUNK):
            sl = slice(base, base + CHUNKED_CHUNK)
            chunked += sess.process_frames_chunked(list(bank[sl]), ts[sl], ids[sl])
        chunked += sess.flush_chunks()
        chunked.append(sess.process_frame(bank[STREAM_LAST], ts[STREAM_LAST], STREAM_LAST))
        chunked_err = same_results(chunked, held_run, "chunked against stream", faults)
        phase("stream", f"process_frames_chunked (chunk {CHUNKED_CHUNK}) over the window against "
                        f"the stream run: max pose difference {chunked_err:.3g}")

        # pipelined, held against JAX's pipelined call
        psess = stream_session(device, "p58_")
        pevents = []
        with Patched(*stream_event_recorder(pevents)):
            n0 = len(psess.results)
            for i in range(STREAM_FIRST, PIPELINED_LAST + 1):
                psess.process_frame_pipelined(bank[i], ts[i], i)
            psess.flush()
        pheld = hold_stream(psess.results[n0:], ref, "p58_",
                            range(STREAM_FIRST, PIPELINED_LAST + 1), faults, pevents)
        phase("stream", f"process_frame_pipelined over {STREAM_FIRST}-{PIPELINED_LAST} "
                        f"against JAX's: mapping at resolution, steps at {pheld.get('events')}, "
                        f"max pose err {pheld['pose_err']:.3g}, tracked diff {pheld['count_err']}, masks "
                        f"differing {pheld.get('mask_diffs') or 'none'}")

        # snapshot on disk mid-window, a fresh card session continues
        sess.restore_state(snap)
        first_part = stream(sess, STREAM_FIRST, SNAPSHOT_LAST)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "snap.npz")
            save_session_snapshot(path, sess)
            fresh = SlamSession(stream_settings(), CAM, WIDTH, HEIGHT, device,
                                draws=ReplayDraws.from_npz(STREAM_FIXTURE, device, kinds=("reloc",),
                                                           prefix="s95_"))
            load_session_snapshot(path, fresh)
        fresh._chunk_pipeline_depth = STREAM_DEPTH
        resumed = first_part + stream(fresh, SNAPSHOT_LAST + 1, STREAM_LAST)
        snap_err = same_results(resumed, held_run, "saved, loaded and continued", faults)
        phase("stream", f"saved to disk after frame {SNAPSHOT_LAST}, loaded into a fresh card "
                        f"session and continued to {STREAM_LAST}: the uninterrupted run's results, "
                        f"max pose difference {snap_err:.3g}")
        phase("time", f"phase 13, stream runs held (the orbit's frames rendering meanwhile): "
                      f"{time.perf_counter() - clock:.1f} s")

        orbit = check_orbit(device, render, faults)
    finally:
        render[0].terminate()
    phase("time", f"phase 13, orbit: {time.perf_counter() - clock:.1f} s")
    console = check_console(device, faults)
    phase("time", f"phase 13, console: {time.perf_counter() - clock:.1f} s")
    hold_path_calls(calls, "the stream window")
    if faults:
        raise AssertionError("phase 13 (stream): " + " | ".join(faults))
    return {"totals": totals, "entry": numbers, "dropped": dropped, "orbit": orbit,
            "console": console, "events_a_frame": len(ev) / STREAM_CHUNK,
            "device_ms_a_frame": dev_ms / STREAM_CHUNK}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    clock = [time.perf_counter()]

    def lap(what: str) -> None:
        now = time.perf_counter()
        phase("time", f"{what}: {now - clock[-1]:.1f} s (since start {now - clock[0]:.1f} s)")
        clock.append(now)
    phase("device", f"{name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(card, flush=True)   # name, power limit: as nvidia-smi prints them

    from mageslam_tpu_torch.ops import _build

    path, build_s, log = _build.build()
    _build.library()
    phase("build", f"{os.path.relpath(path, REPO)} built in {build_s:.1f} s")
    for line in log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            phase("build", line.strip())
    lap("phases 1-2 (device, build)")

    ham = check_hamming(device)
    fused_err = check_radius_match(device)
    two_way_err = check_two_way(device)
    bow_err = check_bow_words(device)
    least = minimal_launch(device)
    lap("phase 3 (kernel checks)")

    with np.load(FIXTURE) as z:
        ref = {k: z[k] for k in z.files if k.startswith("ref_")}
    first = int(ref["ref_frame_id"][0])
    frames = render_window(first, first + len(ref["ref_frame_id"]))
    fused = time_radius_path(device, frames[0], first)

    fused_map = time_radius_mapping(device)
    two_way = time_two_way_path(device)
    two_way_init = time_two_way_init(device)
    lap("phase 3 (kernel timings on path inputs)")

    run_window(device, frames, first)          # warm pass: allocator, caches
    reset_launch_counts()
    results, ms, bow = run_window(device, frames, first)
    first_path = counted_launches()
    pose_err, count_err = check_window(results, ref)
    kf = [r.frame_id for r in results if r.is_keyframe]
    want = tuple(len(frames) * t + len(kf) * (k - t)
                 for t, k in zip(LAUNCHES_TRACKED, LAUNCHES_KEYFRAME))
    if launch_counts() != want:
        raise AssertionError(f"over {len(frames)} frames with {len(kf)} keyframes mapped: "
                             f"launched {first_path}, expected {dict(zip(KERNELS, want))} "
                             f"({LAUNCHES_TRACKED} a frame and {LAUNCHES_KEYFRAME} a keyframe "
                             f"by {KERNELS})")
    phase("slice", f"bag-of-words index after frame {results[-1].frame_id}: "
                   f"{check_bow_event(bow, 0)}")
    phase("slice", f"frames {first}-{first + len(frames) - 1}: all TRACKING, "
                   f"keyframes at {kf}, max pose err {pose_err:.3g} (limit "
                   f"{POSE_ATOL}), max tracked diff {count_err} (limit {TRACKED_TOL})")
    phase("slice", f"kernel launches in the run: {first_path} ({LAUNCHES_TRACKED} a frame "
                   f"and {LAUNCHES_KEYFRAME} a keyframe frame by {KERNELS}; {len(kf)} "
                   f"mapped keyframes)")
    phase("slice", f"per-frame wall time (process_frame + synchronize): median "
                   f"{statistics.median(ms):.3f} ms, min {min(ms):.3f}, max "
                   f"{max(ms):.3f} over {len(ms)} frames after one warm pass; {card}")
    profile_window(device, frames, first, card)
    lap("phase 4 (slice)")

    check_map_event(device, card)
    lap("phase 5 (mapping event)")
    map_launches, window_sess = check_map_window(device, card)
    lap("phase 6 (mapping window)")
    init = check_from_frame0(device, card)
    lap("phase 7 (from frame 0)")
    photoreal = check_photoreal(device, card)
    lap("phase 8 (photoreal)")
    reloc = check_reloc(device, card)
    lap("phase 9 (relocalization)")
    loop = check_loop_closure(device, card, window_sess)
    lap("phase 10 (loop closure)")
    stereo = check_stereo_and_cameras(device, card)
    lap("phase 11 (stereo rig and cameras)")
    vi = check_vi(device, card)
    lap("phase 12 (visual-inertial run and the fossilized map)")
    stream = check_stream(device, card)
    lap("phase 13 (stream, chunked, pipelined and realtime entry points, orbit, console)")

    # the standalone kernel's top-level row: the synthetic (1024, 64), the
    # shape of the adoption's vocabulary call before bow_words.cu took it
    ham_row = ham["rows"][BOW_SHAPES[0]]
    # the bag-of-words kernels' top-level rows: the adoption's calls (its
    # IDF's word assignment, its first k-medoid iteration)
    assign_row = init["bow_assign"][1024]
    step_row = init["bow_vocab_step"][1024]

    def launches(kernel: str) -> dict:
        by_path = {"frames_31_54": first_path[kernel],
                   "frames_31_95_mapped": map_launches[kernel],
                   "frames_0_54_from_frame_0": init["totals"][kernel],
                   "frames_0_54_own_draws": init["own_totals"][kernel],
                   "photoreal_frames_0_79": photoreal["totals"][kernel],
                   "reloc_frames_30_37": reloc["totals"][kernel],
                   "loop_scenes_detection": loop["totals"][kernel],
                   "stereo_rig_frames_0_39": stereo["rig"]["totals"][kernel],
                   "stereo_mixed_rig_frames_0_23": stereo["mixed"]["totals"][kernel],
                   "distorted_undistort_pixels_frames_0_39": stereo["und_"]["totals"][kernel],
                   "distorted_keypoints_frames_0_39": stereo["kp_"]["totals"][kernel],
                   "oriented_photoreal_frames_0_29": stereo["orient_"]["totals"][kernel],
                   "vi_frames_0_79": vi["totals"][kernel],
                   "stream_frames_31_95": stream["totals"][kernel]}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    def new_shapes(kind: str) -> dict:
        return {"photoreal_loop_detection": photoreal["rows"].get(kind),
                "relocalization": reloc["rows"].get(kind)}

    def bow_row(kind: str, row: dict, err: int, note: str) -> dict:
        return {"name": kind, "route": "cuda", "source": "mageslam_tpu_torch/csrc/bow_words.cu",
                "replaces": "mageslam_tpu/ops/pallas_kernels.py:57", **launches(kind),
                "max_abs_err": err, "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None,
                "shape": row["shape"], "device_us": row["device_us"],
                "composite_hamming_kernel_ms": row["composite_hamming_kernel_ms"],
                "minimal_launch": least, "note": note,
                "path_rows": {n: r for n, r in init[kind].items()}}

    print(json.dumps({"kernels": [
        {"name": "radius_match", "route": "cuda",
         "source": "mageslam_tpu_torch/csrc/radius_match.cu",
         "replaces": "mageslam_tpu/ops/pallas_kernels.py:57",
         **launches("radius_match"), "max_abs_err": fused_err,
         "ms": fused["ms"], "plain_ms": fused["plain_ms"], "bound_ms": fused["bound_ms"],
         "bound_by": fused["bound_by"], "library_ms": None,
         "note": "ms, plain_ms, bound_ms: sum of a tracked frame's two calls (calls); "
                 "keyframe: the same sums and calls of a keyframe event's six more",
         "calls": fused["calls"], "keyframe": fused_map,
         "composite_ms": fused["composite_ms"], "minimal_launch": least,
         "stacked_reloc_rematch": new_shapes("radius")},
        {"name": "hamming_matrix", "route": "cuda",
         "source": "mageslam_tpu_torch/csrc/hamming.cu",
         "replaces": "mageslam_tpu/ops/pallas_kernels.py:57",
         **launches("hamming_matrix"), "max_abs_err": ham["max_abs_err"],
         "ms": ham_row["ms"], "plain_ms": ham_row["plain_ms"],
         "bound_ms": ham_row["bound_ms"], "bound_by": ham_row["bound_by"],
         "library_ms": ham_row["library_ms"], "shape": ham_row["shape"],
         "device_us": ham_row["device_us"], "library_device_us": ham_row["library_device_us"],
         "note": "the standalone port; no path call since bow_words.cu took the "
                 "bag-of-words calls; top level: synthetic (1024, 64); rows: synthetic words",
         "rows": {f"{n}x{m}": r for (n, m), r in ham["rows"].items()}},
        {**bow_row("bow_assign", assign_row, bow_err["max_abs_err"],
                   "no single PyTorch call computes it; top level: the adoption's IDF call "
                   "(1024 rows); path_rows: one call of each row count; query_words: loop "
                   "detection's and relocalization's"),
         "query_words": new_shapes("bow_assign")},
        bow_row("bow_vocab_step", step_row, bow_err["max_abs_err"],
                "no single PyTorch call computes it; top level: the adoption's first "
                "k-medoid iteration (1024 rows); path_rows: the adoption's and the retrain's"),
        {"name": "two_way_match", "route": "cuda",
         "source": "mageslam_tpu_torch/csrc/two_way_match.cu",
         "replaces": "mageslam_tpu/ops/pallas_kernels.py:57",
         **launches("two_way_match"), "max_abs_err": two_way_err,
         "ms": two_way["ms"], "plain_ms": two_way["plain_ms"],
         "bound_ms": two_way["bound_ms"], "bound_by": two_way["bound_by"],
         "library_ms": None,
         "note": "no single PyTorch call computes it; the composites it replaces are timed; "
                 "top level: the keyframe event's call; init: mono init's pair match on "
                 "the path (B = 1, 512x512); init_synthetic: (440, 440), B = 1",
         **{k: two_way[k] for k in ("shape", "composite_hamming_kernel_ms",
                                    "composite_int_mm_ms", "valid_pairs", "device_us_scan",
                                    "device_us_gate")},
         "init": init["two_way"], "init_synthetic": two_way_init,
         "reloc_b4": new_shapes("two_way"), "stereo_pair": stereo["pair"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
