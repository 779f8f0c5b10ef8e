"""The port's session on tests/test_photoreal_ate.py's 80 rendered frames,
held against the JAX session and the ground truth.

The frames, the JAX session's outputs over them, its random draws (mono
init, the vocabulary and loop detection's one relocalization) and its
`fossilize` trajectories come from tests/data/torch_port_photoreal.npz
(`python tools/export_jax_state.py photoreal`); the port replays the draws.
Tolerances: every frame's state and keyframe flag identical, the map's
masks after each mapping event identical, tracked count within 3,
associations equal on 99 % of the keypoints, R and t within 1e-3 once t is
scaled by the ratio of the two map scales (mono init leaves the scale to
float noise: tools/init_gauge.py), that ratio within 5 %. One frame is
logged in ROADMAP queue 3: frame 71 keeps two keypoints within 0.05 px of
track-local-map's 2.2 px outlier gate with one CPU thread and on the card
(pose 1.37e-3 off), drops them with two threads and in JAX (float32
summation order). That frame alone, tracked and fossilized, is held to
LOGGED_ATOL instead of 1e-3, and to the same tracked count tolerance. The
ATE gate is the JAX test's: at least 80 % of the frames tracked, at least
75 % of them associated, ATE < 0.06 m.
"""

import os

import numpy as np
import pytest
import torch

from mageslam_tpu.apps.evaluate import ate_rmse as jax_ate_rmse
from mageslam_tpu_torch import SlamSession, TrackingState, golden_path_settings
from mageslam_tpu_torch.apps.evaluate import ate_rmse
from mageslam_tpu_torch.runtime.draws import ReplayDraws

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_photoreal.npz")
W, H = 320, 180
POSE_ATOL = 1e-3
LOGGED_FRAMES = (71,)     # ROADMAP queue 3: a borderline inlier set
LOGGED_ATOL = 2e-3        # their ceiling (measured 1.37e-3 on the card)
TRACKED_TOL = 3
SCALE_TOL = 0.05


@pytest.fixture(scope="module")
def ref():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def port_run(ref):
    draws = ReplayDraws.from_npz(FIXTURE, "cpu")
    sess = SlamSession(golden_path_settings(), ref["cam"], W, H, device="cpu", draws=draws)
    maps, mapper = [], sess._insert_keyframe_and_map

    def recording_mapper(frame):
        mapper(frame)
        maps.append(sess.map)

    sess._insert_keyframe_and_map = recording_mapper
    results, assoc = [], []
    for i, (img, ts) in enumerate(zip(ref["frames"], ref["timestamps"])):
        results.append(sess.process_frame(img, float(ts), i))
        assoc.append(sess.history.assoc[0].numpy())
    fossil = sess.fossilize(global_ba_steps=None)
    fossil3 = sess.fossilize(global_ba_steps=3)
    return sess, results, fossil, fossil3, draws.remaining(), maps, assoc


def scale_ratio(sess, ref) -> float:
    return float(ref["map_scale"]) / sess.map_scale


def centers(mats: np.ndarray) -> np.ndarray:
    return np.asarray([-m[:3, :3].T @ m[:3, 3] for m in mats])


def test_tracks_most_frames(port_run):
    _, results, *_ = port_run
    tracked = sum(r.state == TrackingState.TRACKING for r in results)
    assert tracked >= 0.8 * len(results), [r.state.name for r in results]


def test_ate_under_threshold(port_run, ref):
    _, _, (ids, mats), *_ = port_run
    ts = ref["timestamps"][ids]
    rmse, n = ate_rmse(ts, centers(mats), ref["timestamps"], ref["gt_c"])
    assert n >= 0.75 * len(ref["frames"])
    assert rmse < 0.06, f"ATE RMSE {rmse:.4f} m over {n} poses"
    # the port's copy of the metric is the reference's
    assert rmse == jax_ate_rmse(ts, centers(mats), ref["timestamps"], ref["gt_c"])[0]


def pose_limit(frame_id: int) -> float:
    return LOGGED_ATOL if frame_id in LOGGED_FRAMES else POSE_ATOL


def test_every_frame_matches_jax(port_run, ref):
    sess, results, *_ = port_run
    k = scale_ratio(sess, ref)
    assert abs(k - 1.0) < SCALE_TOL, k
    assert [r.state.value for r in results] == ref["ref_state"].tolist()
    assert [r.is_keyframe for r in results] == ref["ref_is_kf"].tolist()
    for r, i in zip(results, range(len(results))):
        assert abs(r.tracked_count - int(ref["ref_tracked"][i])) <= TRACKED_TOL, i
        if r.pose is None:
            continue
        err = max(np.abs(r.pose.R.numpy() - ref["ref_R"][i]).max(),
                  np.abs(r.pose.t.numpy() * k - ref["ref_t"][i]).max())
        assert err <= pose_limit(i), (i, err)


def test_associations_match_jax(port_run, ref):
    """Every tracked frame's keypoint → map point associations equal the
    JAX frame's on at least 99 % of the keypoints."""
    _, results, *_, assoc = port_run
    for r, a, want in zip(results, assoc, ref["ref_assoc"]):
        if r.pose is not None:
            assert (a == want).mean() >= 0.99, (r.frame_id, int((a != want).sum()))


def test_loop_detection_as_jax(port_run, ref):
    """Detection runs on every keyframe once the map holds MinKeyframe
    keyframes, and relocalizes where a cluster qualifies: the JAX run's
    live and qualifying detections, every recorded draw used, no loop."""
    sess, _, _, _, left, *_ = port_run
    assert sess.loop_det_stats["live"] == int(ref["det_live"].sum()) > 0
    assert sess.loop_det_stats["qualified"] == int(ref["det_qualifies"].sum()) > 0
    assert sess.n_loops_closed == int(ref["n_loops_closed"]) == 0
    assert left == {"init": 0, "pnp": 0, "vocab": 0, "reloc": 0}


def test_maps_after_each_event_match_jax(port_run, ref):
    """The map's masks after each of the 13 mapping events equal the JAX
    map's."""
    _, _, _, _, _, maps, _ = port_run
    assert len(maps) == len(ref["ev_frame_id"]) == 13
    for j, m in enumerate(maps):
        for name in ("kf_valid", "mp_valid", "kf_assoc", "kf_member"):
            np.testing.assert_array_equal(getattr(m, name).numpy(), ref[f"ev{j}_{name}"],
                                          err_msg=f"event {j} (frame {ref['ev_frame_id'][j]})")


@pytest.mark.parametrize("which", ["fossil", "fossil3"])
def test_fossilize_matches_jax(port_run, ref, which):
    """`fossilize(None)` (no global BA at golden settings) and then
    `fossilize(3)` (three global BA steps) against the JAX trajectories."""
    sess, _, fossil, fossil3, *_ = port_run
    ids, mats = fossil if which == "fossil" else fossil3
    np.testing.assert_array_equal(ids, ref[f"{which}_ids"])
    want = ref[f"{which}_mats"]
    err = np.maximum(np.abs(mats[:, :3, :3] - want[:, :3, :3]).max(axis=(1, 2)),
                     np.abs(mats[:, :3, 3] * scale_ratio(sess, ref) - want[:, :3, 3]).max(1))
    assert all(e <= pose_limit(int(f)) for f, e in zip(ids, err)), (
        [(int(f), float(e)) for f, e in zip(ids, err) if e > POSE_ATOL])
