"""The port at three pyramid levels (NumLevels 3, ScaleFactor 1.5) against
the JAX package: the pyramid, the frontend, the octave arithmetic of the
map, a session from frame 0 and a relocalization; and the port's blur and
FAST against OpenCV, as tests/test_frontend.py holds the JAX package's.

The JAX session runs are tests/data/torch_port_levels.npz (bench.py's
frames at 640x480 from frame 0, golden settings at three levels, frames
0-51: adoption at 7, keyframes mapped at 21, 40 and 49; with JAX's draws,
each frame's associations and the octave histogram of its associated
keypoints; and `detect_and_compute` on three images) and
tests/data/torch_port_levels_reloc.npz (tests/test_bow_reloc.py's
lost-and-relocalize scene with each point at an octave in 0..2, the JAX
state after frame 29, relocalized at 35), both from `python
tools/export_jax_state.py levels`. The bench session runs here over frames
0-22 (adoption, the vocabulary retrain at 14, the first mapping event);
its whole window runs on the card (chip_smoke.py phase 16,
tests/test_torch_cuda.py). The pyramid, `predict_octave`,
`compute_dmin_dmax` and `features_per_level` are held against the JAX
package's answers in the same file (`pyr_*`, `oct_*`, `dmm_*`, `fpl*`), which
records the jax / jaxlib versions and the CPU's features that computed
them: the pyramid's last bits follow XLA:CPU's code, so it is held against
that recorded build and no JAX runs here.

Tolerances:
- the pyramid at 640x480, 320x180 and 160x120: bit for bit;
- the frontend: valid masks, keypoints, responses, octaves, angles and
  descriptors exact, undistorted positions within 1e-4 px;
- `predict_octave`: exact where the quotient log(ratio)/log(scale) - 0.5
  lies more than 1e-6 from a rounding boundary. Within that band float32
  rounding decides, and the reference disagrees with itself there (eager
  against jitted: 40 of the 6,560 boundary cases below), so each answer
  must be one of the two octaves beside the boundary. `compute_dmin_dmax`:
  within 2 ulp of the jitted reference (which fuses the power into the
  product; the map's bounds are float state, its masks are held exact);
- the sessions: every state and keyframe flag exact, the map's masks after
  each mapping event exact, tracked counts and the octave histograms of
  the associated keypoints within 3, R and t within 1e-3 once t is scaled
  by the ratio of the map scales (mono init leaves the scale to float
  noise), that ratio within 5 %. Measured on the CPU: counts, histograms
  and associations equal on every frame, poses within 5.2e-4 over 0-51.
"""

import torch_threads  # noqa: F401  (first: torch's OpenMP threads wait passively)

import dataclasses
import os

import cv2
import numpy as np
import pytest
import torch

from mageslam_tpu_torch import SlamSession, TrackingState, bench_world, golden_path_settings
from mageslam_tpu_torch.geometry.camera import make_pinhole
from mageslam_tpu_torch.ops import fast, image
from mageslam_tpu_torch.ops.frontend import FrameFeatures, detect_and_compute
from mageslam_tpu_torch.runtime.draws import ReplayDraws
from mageslam_tpu_torch.worldmap import map_state

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_levels.npz")
RELOC = os.path.join(REPO, "tests", "data", "torch_port_levels_reloc.npz")
PHOTOREAL = os.path.join(REPO, "tests", "data", "torch_port_photoreal.npz")
LEVELS, SCALE = 3, 1.5
CAM = (520.0, 520.0, 320.0, 240.0)
DT = 0.033
WINDOW = 23               # frames 0-22 of the bench session
RELOC_SNAP = 29           # the reloc fixture's state is after this frame
POSE_ATOL = 1e-3
TRACKED_TOL = 3
SCALE_TOL = 0.05
UND_ATOL = 1e-4
BOUNDARY_BAND = 1e-6
EVENT_MASKS = ("kf_valid", "mp_valid", "kf_assoc", "kf_member")


def levels_settings():
    """Golden settings at three pyramid levels."""
    s = golden_path_settings()
    cam = s.MonoSettings.MonoCamera
    fes = dataclasses.replace(cam.FeatureExtractorSettings, NumLevels=LEVELS,
                              ScaleFactor=SCALE)
    return dataclasses.replace(s, MonoSettings=dataclasses.replace(
        s.MonoSettings, MonoCamera=dataclasses.replace(cam, FeatureExtractorSettings=fes)))


@pytest.fixture(scope="module")
def ref():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def images():
    """Bench frame 31 at 640x480, its 160x120 crop and photoreal frame 10
    at 320x180: the fixture's frontend inputs."""
    full = bench_world.frames(31, 32)[0].astype(np.float32)
    with np.load(PHOTOREAL) as z:
        photo = z["frames"][10].astype(np.float32)
    return {"bench640": full, "bench160": np.ascontiguousarray(full[180:300, 240:400]),
            "photo320": photo}


def built_by(ref) -> str:
    """What computed the fixture's references."""
    return (f"JAX references from jax {ref['jax_version'].item().decode()} / jaxlib "
            f"{ref['jaxlib_version'].item().decode()} on {ref['machine'].item().decode()} "
            f"({ref['cpu_features'].item().decode()})")


@pytest.mark.parametrize("name", ["bench640", "photo320", "bench160"])
def test_pyramid_equals_jax_bit_for_bit(ref, images, name):
    img = images[name]
    got = image.build_pyramid(torch.from_numpy(img), LEVELS, SCALE)
    want = [img] + [ref[f"pyr_{name}_{lv}"] for lv in range(1, LEVELS)]
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for lv, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"level {lv}; {built_by(ref)}")


def test_features_per_level_equals_jax(ref):
    for j in range(4):
        n, levels, scale = ref[f"fpl{j}_args"].tolist()
        assert image.features_per_level(int(n), int(levels), scale) == ref[f"fpl{j}"].tolist()


@pytest.mark.parametrize("name", ["bench640", "photo320", "bench160"])
def test_frontend_three_levels_equals_jax(ref, images, name):
    img = images[name]
    h, w = img.shape
    fes = levels_settings().MonoSettings.MonoCamera.FeatureExtractorSettings
    cam = ref[f"fe_{name}_cam"].tolist()
    got = detect_and_compute(torch.from_numpy(img), make_pinhole(*cam, w, h), fes, 512)
    valid = ref[f"fe_{name}_valid"]
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    for field in ("xy", "response", "octave", "angle"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), ref[f"fe_{name}_{field}"],
                                      err_msg=field)
    np.testing.assert_array_equal(got.desc.numpy().view(np.uint32), ref[f"fe_{name}_desc"])
    np.testing.assert_allclose(got.und_xy.numpy(), ref[f"fe_{name}_und_xy"], atol=UND_ATOL)
    # every level holds keypoints
    assert (np.bincount(got.octave.numpy()[valid], minlength=LEVELS) > 0).all()


def test_predict_octave_on_its_boundaries(ref):
    """On the fixture's boundary cases: ratios on a rounding boundary
    (1.5^(k+1)) or midway between two (1.5^(k+1/2)), each with the 40
    float32 neighbours on either side."""
    dist, dmin = ref["oct_dist"], ref["oct_dmin"]
    got = map_state.predict_octave(torch.from_numpy(dist), torch.from_numpy(dmin),
                                   SCALE).numpy()
    want = ref["oct_want"]
    q = np.log2(dist.astype(np.float64) / dmin) / np.log2(SCALE) - 0.5
    off = np.abs(q - np.floor(q) - 0.5)
    near = off <= BOUNDARY_BAND
    assert near.sum() > 100 and (~near).sum() > 1000
    np.testing.assert_array_equal(got[~near], want[~near], err_msg=built_by(ref))
    for answer in (got, want):
        assert np.isin(answer[near] - np.floor(q[near]), (0, 1)).all()


def test_compute_dmin_dmax_on_its_boundaries(ref):
    got = map_state.compute_dmin_dmax(torch.from_numpy(ref["oct_dist"]),
                                      torch.from_numpy(ref["dmm_octave"]), LEVELS, SCALE)
    for g, w in zip(got, (ref["dmm_dmin"], ref["dmm_dmax"])):
        np.testing.assert_array_max_ulp(g.numpy(), w, maxulp=2)


def scale_ratio(sess, want_scale) -> float:
    """t_jax ≈ k · t_port."""
    return float(want_scale) / sess.map_scale


def octave_hist(feats, assoc) -> np.ndarray:
    use = feats.valid.numpy() & (assoc >= 0)
    return np.bincount(feats.octave.numpy()[use], minlength=LEVELS)


def run_session(sess, feed):
    """Each (features, timestamp, frame id) of `feed` through `sess`: its
    results, associations, octave histograms and the map after each
    mapping event."""
    maps, mapper = [], sess._insert_keyframe_and_map

    def recording_mapper(frame):
        mapper(frame)
        maps.append(sess.map)

    sess._insert_keyframe_and_map = recording_mapper
    results, hists = [], []
    for feats, ts, fid in feed:
        results.append(sess.process_features(feats, ts, fid))
        tracked = results[-1].pose is not None and results[-1].tracked_count > 0
        assoc = sess.history.assoc[0].numpy() if tracked else np.full(sess.N, -1)
        hists.append(octave_hist(feats, assoc))
    return results, hists, maps


def bench_feed(sess, frames):
    """The bench frames' features as `process_frame` extracts them."""
    for i, img in enumerate(frames):
        yield (detect_and_compute(torch.from_numpy(img).to(torch.float32), sess.cam16,
                                  sess.fes if sess.initialized else sess._fes_boot, sess.N),
               i * DT, i)


@pytest.fixture(scope="module")
def session_run(ref):
    draws = ReplayDraws.from_npz(FIXTURE, "cpu")
    sess = SlamSession(levels_settings(), CAM, 640, 480, device="cpu", draws=draws)
    out = run_session(sess, bench_feed(sess, bench_world.frames(0, WINDOW)))
    return (sess, *out, draws)


def check_frames(results, hists, ref, k, first=0):
    assert abs(k - 1.0) < SCALE_TOL, k
    n = len(results)
    assert [r.state.value for r in results] == ref["ref_state"][first:first + n].tolist()
    assert [r.is_keyframe for r in results] == ref["ref_is_kf"][first:first + n].tolist()
    for r, hist, i in zip(results, hists, range(first, first + n)):
        assert abs(r.tracked_count - int(ref["ref_tracked"][i])) <= TRACKED_TOL, i
        assert np.abs(hist - ref["ref_octave_hist"][i]).max() <= TRACKED_TOL, (i, hist)
        if r.pose is None:
            continue
        err = max(np.abs(r.pose.R.numpy() - ref["ref_R"][i]).max(),
                  np.abs(r.pose.t.numpy() * k - ref["ref_t"][i]).max())
        assert err <= POSE_ATOL, (i, err)


def test_session_from_frame_zero_matches_jax(session_run, ref):
    sess, results, hists, _, _ = session_run
    check_frames(results, hists, ref, scale_ratio(sess, ref["map_scale"]))
    assert results[7].state == TrackingState.TRACKING and results[7].is_keyframe
    assert sess.bow_training.retrained
    # the window tracks keypoints at every level
    assert (np.sum(hists, axis=0) > 0).all()


def test_session_maps_after_each_event_match_jax(session_run, ref):
    _, _, _, maps, draws = session_run
    assert len(maps) == int(np.sum(ref["ev_frame_id"] < WINDOW)) == 1     # frame 21
    for j, m in enumerate(maps):
        for name in EVENT_MASKS:
            np.testing.assert_array_equal(getattr(m, name).numpy(), ref[f"ev{j}_{name}"],
                                          err_msg=f"event {j}")
    assert draws.remaining() == {"init": 0, "pnp": 0, "vocab": 0, "reloc": 0}


def _features(rl, i) -> FrameFeatures:
    return FrameFeatures(*(torch.from_numpy(
        (rl[f"feat{i}_{n}"].view(np.int32) if n == "desc" else rl[f"feat{i}_{n}"]).copy())
        for n in FrameFeatures._fields))


def test_relocalization_three_levels_matches_jax():
    """From the JAX state after frame 29: lost on 30-34, relocalized at
    35 with the JAX draws, as the JAX session."""
    with np.load(RELOC) as z:
        rl = {k: z[k] for k in z.files}
    W, H = (int(v) for v in rl["size"])
    draws = ReplayDraws.from_npz(RELOC, "cpu", kinds=("reloc",))
    sess = SlamSession.from_jax_snapshot(RELOC, levels_settings(), rl["cam"], W, H,
                                         device="cpu", draws=draws)
    first = RELOC_SNAP + 1
    feed = ((_features(rl, i), i * DT, i) for i in range(first, int(rl["n_frames"])))
    results, hists, maps = run_session(sess, feed)
    check_frames(results, hists, rl, 1.0, first)
    states = [r.state for r in results]
    assert TrackingState.RELOCALIZING in states and states[5] == TrackingState.TRACKING
    assert draws.remaining()["reloc"] == 0 and not maps
    # the relocalized frames track points of every octave
    assert (np.sum(hists[5:], axis=0) > 0).all()


# The port's blur and FAST against OpenCV: tests/test_frontend.py's oracles
# and tolerances.

def checker_image(rng, h=120, w=160):
    """Random blobby test image with corners."""
    img = (rng.rand(h // 8, w // 8) * 255).astype(np.float32)
    img = cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)
    img = cv2.GaussianBlur(img, (3, 3), 0.8)
    return np.clip(img, 0, 255).astype(np.uint8)


def test_gaussian_blur_matches_cv2(rng):
    img = checker_image(rng).astype(np.float32)
    ours = image.gaussian_blur(torch.from_numpy(img), 7, 2.0).numpy()
    want = cv2.GaussianBlur(img, (7, 7), 2, borderType=cv2.BORDER_REFLECT_101)
    np.testing.assert_allclose(ours, want, atol=1e-2)


def test_fast_matches_cv2(rng):
    img = checker_image(rng)
    thr = 20
    score = fast.nms3x3(fast.fast_score_map(torch.from_numpy(img).to(torch.float32),
                                            thr)).numpy()
    det = cv2.FastFeatureDetector_create(thr, True, cv2.FAST_FEATURE_DETECTOR_TYPE_9_16)
    want = {(int(k.pt[0]), int(k.pt[1])): k.response for k in det.detect(img)}
    ours = {(x, y): score[y, x] for y, x in zip(*np.nonzero(score > 0))}
    # cv2 FAST detects in the interior only; compare on common support
    common = set(want) & set(ours)
    assert len(common) >= 0.9 * max(len(want), 1), (len(common), len(want), len(ours))
    for pt in common:
        assert abs(want[pt] - ours[pt]) <= 1.0, (pt, want[pt], ours[pt])
    # no spurious detections far beyond cv2's set
    assert len(ours) <= len(want) + 0.1 * len(want) + 5
