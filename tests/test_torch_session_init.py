"""The port's session from frame 0 on the CPU: `SlamSession(...)` then
`process_frame` over the benchmark world's frames 0-36, with no JAX
snapshot, mono init and the vocabulary drawing what the JAX session drew
(the draws recorded in tests/data/torch_port_bench640_init.npz, replayed by
`runtime.draws.ReplayDraws`), held against that session:

- the anchor, attempt and adoption frames, and every recorded draw used;
- frames 0-30 against the JAX session's outputs (the init fixture) and
  frames 31-36 against those of tests/data/torch_port_bench640_f30.npz:
  states and keyframe flags equal, tracked counts within 3, R within 1e-3
  and t within 1e-3 once scaled by s_jax / s_port, the ratio of the two
  sessions' map scales (the baseline each fixed at adoption). The init BA
  leaves the map's scale where float noise puts it (frame 1 is its only
  fixed camera), so the port's raw t differs from JAX's by that ratio:
  1.1 % here, and JAX's own jitted and eager runs of the same attempt
  differ by 1.9 % (tools/init_gauge.py). The ratio is asserted within 5 %.
- the bag-of-words index after adoption and after the retrain: anchors
  exact, idf and keyframe vectors within 1e-6, kf_has exact;
- the state after frame 30 against the JAX session's snapshot (the f30
  fixture): kf_valid, mp_valid, kf_assoc, kf_member equal; keyframe poses
  within 1e-3 after scaling; the index's leaves as above.

Frames 37-54 from frame 0 run on the card only (chip_smoke.py): about 0.7 s
a frame here. A session with its own generator (no replay) must initialise
within the init window and track on, checked for structure only.
"""

import torch_threads  # noqa: F401  (first: torch's OpenMP threads wait passively)

import numpy as np
import pytest
import torch

from mageslam_tpu_torch import SlamSession, TrackingState, bench_world, golden_path_settings
from mageslam_tpu_torch import interop
from mageslam_tpu_torch.runtime.draws import GeneratorDraws, ReplayDraws

torch.set_num_threads(2)

INIT = "tests/data/torch_port_bench640_init.npz"
F30 = "tests/data/torch_port_bench640_f30.npz"
CAM = (520.0, 520.0, 320.0, 240.0)
DT = 0.033
LAST = 36
POSE_ATOL = 1e-3
TRACKED_TOL = 3
SCALE_TOL = 0.05
MASKS = ("kf_valid", "mp_valid", "kf_assoc", "kf_member")


@pytest.fixture(scope="module")
def ref():
    with np.load(INIT) as z:
        init = {k: z[k] for k in z.files}
    with np.load(F30) as z:
        f30 = {k: z[k] for k in z.files if k.startswith("ref_")}
    return init, f30


def jax_scale(init) -> float:
    """The JAX session's map scale: its adopted second keyframe's baseline."""
    a = int(init["init_n_attempt"]) - 1
    R, t = init[f"init_att{a}_pose2_R"], init[f"init_att{a}_pose2_t"]
    return float(np.linalg.norm(R.T @ t))


@pytest.fixture(scope="module")
def run(ref):
    init, _ = ref
    draws = ReplayDraws.from_npz(INIT, "cpu")
    sess = SlamSession(golden_path_settings(), CAM, 640, 480, device="cpu", draws=draws)
    out = {"results": [], "anchors": []}
    for i, img in enumerate(bench_world.frames(0, LAST + 1)):
        had = sess.init_window.anchor_meta
        r = sess.process_frame(img, i * DT, i)
        out["results"].append(r)
        if not sess.initialized and sess.init_window.anchor_meta != had:
            out["anchors"].append(i)
        if r.is_keyframe and i == int(init["init_adopt_frame"]):
            out["adopt_bow"], out["adopt_scale"] = sess.bow, sess.map_scale
        if i == int(init["init_retrain_frame"]):
            out["retrain_bow"] = sess.bow
        if i == 30:
            out["map30"], out["bow30"] = sess.map, sess.bow
    out["sess"], out["draws"] = sess, draws
    return out


def test_anchor_attempt_and_adoption_frames(ref, run):
    init, _ = ref
    assert run["anchors"] == init["init_anchor_frames"].tolist() == [0]
    adopted = [r.frame_id for r in run["results"] if r.state == TrackingState.TRACKING]
    assert adopted[0] == int(init["init_adopt_frame"])
    assert run["sess"].init_window.attempts == int(init["init_n_attempt"])
    assert run["draws"].remaining() == {"init": 0, "pnp": 0, "vocab": 0, "reloc": 0}
    assert run["sess"].bow_training.retrained


def test_scale_ratio(ref, run):
    ratio = jax_scale(ref[0]) / run["adopt_scale"]
    assert abs(ratio - 1.0) <= SCALE_TOL, ratio


def hold(results, want: dict, prefix: str, first: int, k: float):
    """Each result against the JAX outputs `{prefix}state` ... from frame
    `first` on, t scaled by k."""
    for r in results:
        j = r.frame_id - first
        assert r.state.value == int(want[prefix + "state"][j]), r.frame_id
        assert r.is_keyframe == bool(want[prefix + "is_kf"][j]), r.frame_id
        assert abs(r.tracked_count - int(want[prefix + "tracked"][j])) <= TRACKED_TOL
        if r.pose is None:
            assert np.isnan(want[prefix + "t"][j]).all()
            continue
        np.testing.assert_allclose(r.pose.R.numpy(), want[prefix + "R"][j], atol=POSE_ATOL,
                                   err_msg=f"frame {r.frame_id}")
        np.testing.assert_allclose(k * r.pose.t.numpy(), want[prefix + "t"][j],
                                   atol=POSE_ATOL, err_msg=f"frame {r.frame_id}")


def test_frames_0_30_track_like_jax(ref, run):
    init, _ = ref
    k = jax_scale(init) / run["adopt_scale"]
    hold(run["results"][:31], init, "init_ref_", 0, k)
    assert [r.frame_id for r in run["results"][:31] if r.is_keyframe] == \
        init["init_ref_frame_id"][init["init_ref_is_kf"]].tolist()


def test_frames_31_36_track_like_jax(ref, run):
    init, f30 = ref
    k = jax_scale(init) / run["adopt_scale"]
    hold(run["results"][31:], f30, "ref_", 31, k)


def assert_bow(got, anchors, idf, kf_vectors, kf_has):
    np.testing.assert_array_equal(got.anchors.numpy().view(np.uint32), anchors)
    np.testing.assert_allclose(got.idf.numpy(), idf, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.kf_vectors.numpy(), kf_vectors, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.kf_has.numpy(), kf_has)
    assert bool(got.trained)


@pytest.mark.parametrize("when", ["adopt", "retrain"])
def test_bow_index_like_jax(ref, run, when):
    init, _ = ref
    assert_bow(run[f"{when}_bow"], *(init[f"init_bow_{when}_{n}"]
                                     for n in ("anchors", "idf", "kf_vectors", "kf_has")))


def test_state_after_frame_30(ref, run):
    mp, _, _, meta, bow = interop.load_jax_snapshot(F30, "cpu")
    got = run["map30"]
    for name in MASKS:
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(mp, name).numpy(),
                                      err_msg=name)
    k = jax_scale(ref[0]) / run["adopt_scale"]
    live = mp.kf_valid.numpy()
    np.testing.assert_allclose(got.kf_pose.R.numpy()[live], mp.kf_pose.R.numpy()[live],
                               atol=POSE_ATOL)
    np.testing.assert_allclose(k * got.kf_pose.t.numpy()[live], mp.kf_pose.t.numpy()[live],
                               atol=POSE_ATOL)
    assert_bow(run["bow30"], *(interop.to_numpy(bow)[n]
                               for n in ("anchors", "idf", "kf_vectors", "kf_has")))
    sess = run["sess"]
    assert (sess.last_kf_slot, sess.frames_since_keyframe) == \
        (meta["last_kf_slot"], meta["frames_since_keyframe"] + 6)


def test_default_generator_initialises_and_tracks():
    sess = SlamSession(golden_path_settings(), CAM, 640, 480, device="cpu", seed=0)
    assert isinstance(sess.draws, GeneratorDraws)
    ms = sess.settings.MonoSettings.MonoMapInitializationSettings
    frames = bench_world.frames(0, 14)
    results = [sess.process_frame(img, i * DT, i) for i, img in enumerate(frames)]
    states = [r.state for r in results]
    adopt = states.index(TrackingState.TRACKING)
    anchor_id, anchor_ts = sess.init_window.anchor_meta
    assert (adopt * DT - anchor_ts) * 1000 <= ms.MaxInitializationIntervalMilliseconds
    assert all(s == TrackingState.INITIALIZING for s in states[:adopt])
    assert all(s == TrackingState.TRACKING for s in states[adopt:])
    assert results[adopt].is_keyframe and results[adopt].tracked_count >= ms.MinMapPoints
    assert sess.map.kf_valid.sum() >= 2 and bool(sess.bow.trained)
    assert bool(sess.bow.kf_has[:2].all())
    for r in results[adopt:]:
        assert torch.isfinite(r.pose.R).all() and torch.isfinite(r.pose.t).all()
        assert r.tracked_count > 0
