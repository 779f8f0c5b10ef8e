"""The port's stereo rig against the JAX package: the stereo bootstrap, the
rig-tether session and the mixed-FOV rig through `process_stereo_frames`,
from tests/data/torch_port_stereo.npz (`python tools/export_jax_state.py
stereo`: tests/test_stereo.py's scenes run by the JAX session, its draws
recorded and replayed here).

Tolerances: the bootstrap's `succeeded`, `match_count`, `feat2` and
`point_valid` exact, points within 1e-3 relative, pose2 within 1e-4. The
sessions: every frame's state and keyframe flag identical; R and t within
1e-3 unscaled (the unit baseline fixes the gauge); tracked count within 3;
the map's masks after each mapping event identical; the tether bank
exact and the kf0 → kf1 rig transform within 1e-3 of JAX's after the last
event; the mixed rig's rescaled secondary camera within 1e-4 and every
post-init keyframe's intrinsics equal to JAX's. One frame is logged in
ROADMAP queue 3: the mixed rig's last frame (23), where t has drifted
1.2e-3 from JAX's at |t| = 6.8 baselines (R within 2e-5, every mask and
decision equal); it is held to its `LOGGED` ceiling instead. These scenes
move with float summation order (`python tools/float_spread.py
rig|mixed`): torch runs on 2 threads here, as in the other port files. A JAX snapshot taken right
after the mixed rig's bootstrap crosses over with its tether bank and
per-keyframe intrinsics exact.
"""

import torch_threads  # noqa: F401  (first: torch's OpenMP threads wait passively)

import dataclasses
import os

import numpy as np
import pytest
import torch

from mageslam_tpu_torch import SlamSession, TrackingState, golden_path_settings
from mageslam_tpu_torch import stereo_world
from mageslam_tpu_torch.geometry.se3 import Pose
from mageslam_tpu_torch.interop import MapState, load_jax_snapshot, to_numpy
from mageslam_tpu_torch.ops.frontend import FrameFeatures
from mageslam_tpu_torch.runtime.draws import ReplayDraws
from mageslam_tpu_torch.tracking.stereo_init import StereoInitSettings, stereo_initialize

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_stereo.npz")
POSE_ATOL = 1e-3
LOGGED = {"mix_": {23: 2e-3}}   # ROADMAP queue 3: frame → its ceiling
PAIR_POSE_ATOL = 1e-4
POINT_RTOL = 1e-3
TRACKED_TOL = 3
CAM1_ATOL = 1e-4
MASKS = ("kf_valid", "mp_valid", "kf_assoc", "kf_member")
TETHER = ("tether_owner", "tether_origin", "tether_kind", "tether_distance", "tether_weight")


@pytest.fixture(scope="module")
def ref():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


def T(a):
    a = np.asarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a.copy())


def features(ref, prefix: str) -> FrameFeatures:
    return FrameFeatures(*(T(ref[prefix + f]) for f in FrameFeatures._fields))


def stereo_settings(**keyframe):
    s = golden_path_settings()
    st = s.StereoSettings
    s = dataclasses.replace(s, StereoSettings=dataclasses.replace(
        st, StereoMapInitializationSettings=dataclasses.replace(
            st.StereoMapInitializationSettings, MaxDepthMeters=12.0)))
    if keyframe:
        s = dataclasses.replace(s, KeyframeSettings=dataclasses.replace(
            s.KeyframeSettings, **keyframe))
    return s


@pytest.mark.parametrize("which", ["pair_", "pair_zero_"])
def test_stereo_initialize_matches_jax(ref, which):
    f0, f1 = features(ref, "pair_f0_"), features(ref, "pair_f1_")
    rel = (Pose(T(ref["pair_rel_R"]), T(ref["pair_rel_t"])) if which == "pair_"
           else Pose.identity())
    res = stereo_initialize(f0.und_xy, f0.desc, f0.valid, f1.und_xy, f1.desc, f1.valid,
                            T(ref["cam"]), rel, StereoInitSettings(max_depth_meters=12.0))
    assert bool(res.succeeded) == bool(ref[which + "succeeded"]) == (which == "pair_")
    assert int(res.match_count) == int(ref[which + "match_count"])
    np.testing.assert_array_equal(res.feat2.numpy(), ref[which + "feat2"])
    np.testing.assert_array_equal(res.point_valid.numpy(), ref[which + "point_valid"])
    if which == "pair_":
        ok = ref["pair_point_valid"]
        assert ok.sum() >= 15
        np.testing.assert_allclose(res.points.numpy()[ok], ref["pair_points"][ok],
                                   rtol=POINT_RTOL, atol=1e-6)
        np.testing.assert_allclose(res.pose2.R.numpy(), ref["pair_pose2_R"], atol=PAIR_POSE_ATOL)
        np.testing.assert_allclose(res.pose2.t.numpy(), ref["pair_pose2_t"], atol=PAIR_POSE_ATOL)


def recording(sess):
    """The session's map after each mapping event (references)."""
    maps, mapper = [], sess._insert_keyframe_and_map

    def recording_mapper(frame):
        mapper(frame)
        maps.append(sess.map)

    sess._insert_keyframe_and_map = recording_mapper
    return maps


def hold_session(results, maps, ref, prefix: str) -> None:
    """States, keyframe flags, unscaled poses, tracked counts and the masks
    after each mapping event against the JAX run."""
    assert [r.state.value for r in results] == ref[prefix + "ref_state"].tolist()
    assert [r.is_keyframe for r in results] == ref[prefix + "ref_is_kf"].tolist()
    for i, r in enumerate(results):
        assert abs(r.tracked_count - int(ref[prefix + "ref_tracked"][i])) <= TRACKED_TOL, i
        if r.pose is not None:
            err = max(np.abs(r.pose.R.numpy() - ref[prefix + "ref_R"][i]).max(),
                      np.abs(r.pose.t.numpy() - ref[prefix + "ref_t"][i]).max())
            assert err <= LOGGED.get(prefix, {}).get(i, POSE_ATOL), (i, err)
    assert len(maps) == len(ref[prefix + "ev_frame_id"])
    for j, m in enumerate(maps):
        for name in MASKS:
            np.testing.assert_array_equal(getattr(m, name).numpy(), ref[f"{prefix}ev{j}_{name}"],
                                          err_msg=f"event {j}")


@pytest.fixture(scope="module")
def rig_run(ref):
    draws = ReplayDraws.from_npz(FIXTURE, "cpu", prefix="rig_")
    sess = SlamSession(stereo_settings(KeyframeDecisionMaxTrackingPointMatches=100000,
                                       KeyframeDecisionMaxTrackingPointOverlap=0.98),
                       T(ref["cam"]), *ref["size"].tolist(), device="cpu", draws=draws)
    maps = recording(sess)
    rel = Pose(T(ref["rig_rel_R"]), T(ref["rig_rel_t"]))
    ts = ref["rig_timestamps"]
    results = [sess.process_stereo_features(features(ref, "rig_feat0_"),
                                            features(ref, "rig_feat0b_"), rel, 0.0, 0)]
    results += [sess.process_features(features(ref, f"rig_feat{i}_"), float(ts[i]), i)
                for i in range(1, len(ts))]
    return sess, results, maps, draws.remaining()


def test_rig_tether_session_matches_jax(rig_run, ref):
    """tests/test_stereo.py:198-240's scene: the bootstrap adopts on the
    first pair, the rig tether persists through every mapping event's
    local BA, and frames, maps and the tether bank follow the JAX session."""
    sess, results, maps, left = rig_run
    assert results[0].state == TrackingState.TRACKING and results[0].is_keyframe
    assert sum(r.is_keyframe for r in results[1:]) >= 5
    hold_session(results, maps, ref, "rig_")
    assert all(v == 0 for v in left.values()), left
    m = sess.map
    for name in TETHER:
        np.testing.assert_array_equal(getattr(m, name).numpy(), ref[f"rig_final_{name}"],
                                      err_msg=name)
    np.testing.assert_array_equal(m.tether_pose.R.numpy(), ref["rig_final_tether_R"])
    np.testing.assert_array_equal(m.tether_pose.t.numpy(), ref["rig_final_tether_t"])
    assert (m.tether_weight > 0).sum() == 1
    # the rig transform between keyframe slots 0 and 1
    kf = Pose(m.kf_pose.R, m.kf_pose.t)
    rig = Pose(kf.R[1], kf.t[1]).compose(Pose(kf.R[0], kf.t[0]).inverse())
    jR, jt = ref["rig_final_kf_R"], ref["rig_final_kf_t"]
    jrig_R = jR[1] @ jR[0].T
    jrig_t = jt[1] - jrig_R @ jt[0]
    np.testing.assert_allclose(rig.R.numpy(), jrig_R, atol=POSE_ATOL)
    np.testing.assert_allclose(rig.t.numpy(), jrig_t, atol=POSE_ATOL)
    np.testing.assert_allclose(rig.t.numpy(), [-1.0, 0.0, 0.0], atol=5e-2)


@pytest.fixture(scope="module")
def mixed_run(ref):
    pairs = stereo_world.frames()
    draws = ReplayDraws.from_npz(FIXTURE, "cpu", prefix="mix_")
    sess = SlamSession(stereo_settings(), T(ref["mix_cam"]), stereo_world.W, stereo_world.H,
                       device="cpu", draws=draws)
    maps = recording(sess)
    R, t = stereo_world.rig()
    rel = Pose(T(R), T(t))
    results, snap_map = [], None
    for i, (img0, img1, ts) in enumerate(pairs):
        results.append(sess.process_stereo_frames(img0, img1, rel, ts, i,
                                                  camera1=stereo_world.secondary_camera()))
        if i == int(ref["mix_snapshot_frame"]):
            snap_map = sess.map
    return sess, pairs, results, maps, snap_map


def test_mixed_rig_matches_jax(mixed_run, ref):
    """tests/test_stereo.py:103-196: the port's numpy renderer gives the
    JAX run's frames, the rescale is active with JAX's secondary camera, and
    the session tracks the secondary (STEREO_2) as JAX does, its keyframes
    carrying the secondary's intrinsics."""
    sess, pairs, results, maps, _ = mixed_run
    assert [stereo_world.frame_hash(p[0]) for p in pairs] == \
        [h.decode() for h in ref["mix_hash0"].tolist()]
    assert [stereo_world.frame_hash(p[1]) for p in pairs] == \
        [h.decode() for h in ref["mix_hash1"].tolist()]
    _, ok, remap, cam1_16 = sess._stereo_prep
    assert ok and remap is not None and bool(ref["mix_rescale_active"])
    np.testing.assert_allclose(cam1_16.numpy(), ref["mix_cam1_16"], atol=CAM1_ATOL)
    assert sum(r.state == TrackingState.TRACKING for r in results) >= 18
    hold_session(results, maps, ref, "mix_")
    kv = sess.map.kf_valid.numpy()
    np.testing.assert_array_equal(kv, ref["mix_final_kf_valid"])
    post = [k for k in np.flatnonzero(kv) if k >= 1]
    assert any(k >= 2 for k in post)
    np.testing.assert_array_equal(sess.map.kf_cam.numpy()[post], ref["mix_final_kf_cam"][post])
    np.testing.assert_allclose(sess.map.kf_cam.numpy()[post],
                               np.broadcast_to(ref["mix_cam1_16"][:4], (len(post), 4)),
                               atol=CAM1_ATOL)


def test_stereo_snapshot_crosses_over(mixed_run, ref):
    """`load_jax_snapshot` of the JAX session right after its stereo
    bootstrap: the tether bank and the per-keyframe intrinsics (keyframe 1
    the secondary's) come over exactly, and equal the port's own map
    after its bootstrap."""
    _, _, _, _, snap_map = mixed_run
    m, _, _, meta, _ = load_jax_snapshot(FIXTURE, "cpu")
    assert meta["initialized"]
    leaves = to_numpy(m)
    names = [n for n in leaves if n.startswith("tether_")] + ["kf_cam", "kf_valid"]
    for i, name in enumerate(leaves):
        if name in names:
            np.testing.assert_array_equal(leaves[name], ref[f"map{i}"], err_msg=name)
    assert not np.array_equal(leaves["kf_cam"][0], leaves["kf_cam"][1])
    assert (leaves["tether_weight"] > 0).sum() == 1
    mine = to_numpy(snap_map)
    for name in names:
        np.testing.assert_array_equal(mine[name], leaves[name], err_msg=name)
    assert isinstance(m, MapState)
