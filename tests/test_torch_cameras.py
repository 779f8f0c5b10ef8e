"""The port's camera models, device presets, dense undistortion and stereo
rescale against the JAX package (and OpenCV where tests/test_camera_geometry.py
and tests/test_undistort.py use it), and the port's session on a distorted
camera against the JAX session.

Tolerances: `k_matrix` and the presets' vectors exact; the camera models
within 1e-5 relative; the rectify map and the bilinear remap within 1e-3
px and 1e-3 gray levels; the overlap crop within 1e-3 px; the stereo
rescale's scale within 1e-5, `ok` exact. The distorted sessions
(tests/test_undistort.py's Poly3K photoreal scene, frames 0-19 of
tests/data/torch_port_cameras.npz, the JAX run with UndistortImagePixels
off in torch_port_cameras_kp.npz, both written by `python
tools/export_jax_state.py cameras`, with JAX's draws replayed), with
UndistortImagePixels on and off: every frame's state and keyframe flag
identical, R and t within 1e-3 once t is scaled by the ratio of the map
scales (mono init leaves the scale to float noise), that ratio within 5 %,
tracked count within 3, the map's masks after each mapping event identical.
Two events are logged in ROADMAP queue 3: with UndistortImagePixels the
JAX session warps each frame in one jitted function whose fused
arithmetic rounds its bilinear weights apart from the eager ops (the
port's warp equals JAX's eager `undistort_image` bit for bit; the jitted
one differs by 1.4e-3 gray levels on frame 13: `python
tools/float_spread.py warp`), and on frame 13 two keypoints
whose responses lie 4e-4 apart swap slots; the keyframe inserted there
(slot 5) then holds point 11 on the other slot of the pair at events 4-5.
Those events' `kf_assoc` may differ in LOGGED_ASSOC entries, all else
exact.
"""

import torch_threads  # noqa: F401  (first: torch's OpenMP threads wait passively)

import dataclasses
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mageslam_tpu.device import presets as jpresets
from mageslam_tpu.geometry import camera as jcam
from mageslam_tpu.geometry.se3 import Pose as JPose
from mageslam_tpu.ops import undistort as jund
from mageslam_tpu_torch import SlamSession, golden_path_settings
from mageslam_tpu_torch.device import presets
from mageslam_tpu_torch.geometry import camera
from mageslam_tpu_torch.geometry.se3 import Pose
from mageslam_tpu_torch.ops import undistort
from mageslam_tpu_torch.runtime.draws import ReplayDraws

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_cameras.npz")
KP_FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_cameras_kp.npz")
PHOTOREAL = os.path.join(REPO, "tests", "data", "torch_port_photoreal.npz")
W, H = 320, 240                       # tests/test_undistort.py's image
K1, K2, K3, P1, P2 = -0.28, 0.07, 0.0, 1e-3, -5e-4
RATIONAL = (-0.28, 0.07, 0.01, 0.02, -0.003, 0.001, 1e-3, -5e-4)   # k1..k6, p1, p2
SESSION_FRAMES = 20
POSE_ATOL = 1e-3
TRACKED_TOL = 3
SCALE_TOL = 0.05
MASKS = ("kf_valid", "mp_valid", "kf_assoc", "kf_member")
LOGGED_EVENTS = {"und_": (4, 5)}   # ROADMAP queue 3: a response near-tie swaps two slots
LOGGED_ASSOC = 2


def T(a):
    return torch.from_numpy(np.array(a))


def make_image(rng):
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    img = cv2.GaussianBlur(img, (0, 0), 3.0)
    return (255 * (img - img.min()) / max(float(np.ptp(img)), 1e-6)).astype(np.float32)


def cameras():
    """(port, JAX) pairs: Poly3K, Rational6K, pinhole."""
    args = (260.0, 262.0, 150.0, 125.0)
    return [
        (camera.make_poly3k(*args, K1, K2, K3, P1, P2, W, H),
         jcam.make_poly3k(*args, K1, K2, K3, P1, P2, W, H)),
        (camera.make_rational6k(*args, *RATIONAL, W, H),
         jcam.make_rational6k(*args, *RATIONAL, W, H)),
        (camera.make_pinhole(*args, W, H), jcam.make_pinhole(*args, W, H)),
    ]


def test_k_matrix_and_accessors_exact(rng):
    cams = rng.uniform(50, 500, (5, 16)).astype(np.float32)
    np.testing.assert_array_equal(camera.k_matrix(T(cams)).numpy(),
                                  np.asarray(jcam.k_matrix(jnp.asarray(cams))))
    for i, f in enumerate(("fx", "fy", "cx", "cy")):
        np.testing.assert_array_equal(getattr(camera, f)(T(cams)).numpy(), cams[:, i])
    w, h = camera.image_size(T(cams))
    np.testing.assert_array_equal(np.stack([w.numpy(), h.numpy()]), cams[:, 12:14].T)


def test_camera_vectors_equal_jax():
    for got, want in cameras():
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("which", [0, 1])
def test_distortion_matches_jax_and_opencv(rng, which):
    """distort / undistort / project of Poly3K (0) and Rational6K (1)
    within 1e-5 relative of JAX, and projection and undistortion against
    OpenCV as tests/test_camera_geometry.py holds the JAX package."""
    got_cam, want_cam = cameras()[which]
    xn = ((rng.rand(200, 2) - 0.5) * 0.8).astype(np.float32)
    xd = camera.distort_normalized(got_cam, T(xn)).numpy()
    np.testing.assert_allclose(xd, np.asarray(jcam.distort_normalized(want_cam, jnp.asarray(xn))),
                               rtol=1e-5, atol=1e-7)
    back = camera.undistort_normalized(got_cam, T(xd), iters=15).numpy()
    np.testing.assert_allclose(back, np.asarray(jcam.undistort_normalized(
        want_cam, jnp.asarray(xd), iters=15)), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(back, xn, atol=1e-4)

    pts3 = rng.randn(200, 3).astype(np.float32)
    pts3[:, 2] = np.abs(pts3[:, 2]) + 2.0
    px, z = camera.project_camera_points(got_cam, T(pts3))
    jpx, _ = jcam.project_camera_points(want_cam, jnp.asarray(pts3))
    np.testing.assert_allclose(px.numpy(), np.asarray(jpx), rtol=1e-5)
    K = np.array([[260.0, 0, 150.0], [0, 262.0, 125.0], [0, 0, 1]])
    dist = (np.array([K1, K2, P1, P2, K3]) if which == 0 else
            np.array([*RATIONAL[:2], *RATIONAL[6:], *RATIONAL[2:6]]))   # OpenCV order
    ref, _ = cv2.projectPoints(pts3.reshape(-1, 1, 3).astype(np.float64), np.zeros(3),
                               np.zeros(3), K, dist)
    np.testing.assert_allclose(px.numpy(), ref.reshape(-1, 2), atol=0.01)
    uv = rng.uniform([50, 50], [270, 190], size=(100, 2)).astype(np.float32)
    und = camera.undistort_pixels(got_cam, T(uv), iters=20).numpy()
    np.testing.assert_allclose(und, np.asarray(jcam.undistort_pixels(
        want_cam, jnp.asarray(uv), iters=20)), rtol=1e-5)
    ref = cv2.undistortPoints(uv.reshape(-1, 1, 2).astype(np.float64), K, dist,
                              P=K).reshape(-1, 2)
    np.testing.assert_allclose(und, ref, atol=0.6)


def test_presets_equal_jax():
    """Every preset's model and camera vector at several focus values and
    resolutions (the Lumia 950's focus is clamped to its bounds)."""
    assert sorted(presets.SUPPORTED_DEVICES) == sorted(jpresets.SUPPORTED_DEVICES)
    for name in presets.SUPPORTED_DEVICES:
        dev, jdev = presets.get_camera_device(name), jpresets.get_camera_device(name)
        assert tuple(dev.model) == tuple(jdev.model) and dev.default_focus == jdev.default_focus
        for focus in (0.0, 500.0, 650.0, 800.0):
            for w, h in ((1920, 1080), (320, 180)):
                np.testing.assert_array_equal(dev.model.camera_at(focus, w, h).numpy(),
                                              np.asarray(jdev.model.camera_at(focus, w, h)))
        imu, jimu = presets.get_imu_characterization(name), jpresets.get_imu_characterization(name)
        assert imu.accel_noise_sigma == jimu.accel_noise_sigma
        np.testing.assert_array_equal(imu.body_camera_to_body_imu, jimu.body_camera_to_body_imu)
    rational = camera.LinearFocalLengthModel(0.0, 0.8, 0.0, 1.4, 0.5, 0.5, 1920, 1080,
                                             distortion=RATIONAL)
    jrational = jcam.LinearFocalLengthModel(0.0, 0.8, 0.0, 1.4, 0.5, 0.5, 1920, 1080,
                                            distortion=RATIONAL)
    np.testing.assert_allclose(rational.camera_at(0.0, 640, 360).numpy(),
                               np.asarray(jrational.camera_at(0.0, 640, 360)), rtol=1e-6)


@pytest.mark.parametrize("which", [0, 1, 2])
def test_undistort_image_matches_jax(rng, which):
    """The rectify map within 1e-3 px, the remapped image within 1e-3 gray
    levels, the undistorted calibration exact; Poly3K, Rational6K, and the
    pinhole (whose remap is the identity)."""
    got_cam, want_cam = cameras()[which]
    img = make_image(rng)
    und = undistort.undistorted_calibration(got_cam)
    np.testing.assert_array_equal(und.numpy(), np.asarray(jund.undistorted_calibration(want_cam)))
    m = undistort.rectify_map(got_cam, H, W)
    jm = jund.undistort_rectify_map(want_cam, jund.undistorted_calibration(want_cam), H, W)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=1e-3)
    out, _ = undistort.undistort_image(T(img), got_cam)
    jout, _ = jund.undistort_image(jnp.asarray(img), want_cam)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-3)
    if which == 2:
        # the pinhole's map moves the principal point to the center only
        assert undistort.rectify_map(got_cam, H, W) is m       # cached
    # the remap alone, on a map with samples outside the image
    grid = rng.uniform(-5, W + 5, (H // 4, W // 4, 2)).astype(np.float32)
    np.testing.assert_allclose(undistort.remap_bilinear(T(img), T(grid)).numpy(),
                               np.asarray(jund.remap_bilinear(jnp.asarray(img),
                                                              jnp.asarray(grid))),
                               atol=1e-3)


def rescale_cases():
    """tests/test_undistort.py:68-90: equal cameras (a 0.1 baseline), a
    double-focal target, opposite cameras; plus the distorted camera against
    a pinhole, rotated a little."""
    pin = (260.0, 260.0, W / 2, H / 2, W, H)
    c = np.cos(0.1)
    rot = np.array([[c, 0, np.sin(0.1)], [0, 1, 0], [-np.sin(0.1), 0, c]], np.float32)
    return [
        (pin, pin, np.eye(3, dtype=np.float32), [-0.1, 0.0, 0.0]),
        (pin, (520.0, 520.0, W / 2, H / 2, W, H), np.eye(3, dtype=np.float32), [0.0, 0.0, 0.0]),
        (pin, pin, np.diag([-1.0, 1.0, -1.0]).astype(np.float32), [0.0, 0.0, 0.0]),
        ("poly", pin, rot, [-0.12, 0.01, 0.0]),
    ]


@pytest.mark.parametrize("case", range(4))
def test_stereo_rescale_matches_jax(case):
    src, tgt, R, t = rescale_cases()[case]

    def make(mod, spec):
        if spec == "poly":
            return mod.make_poly3k(260.0, 262.0, 150.0, 125.0, K1, K2, K3, P1, P2, W, H)
        return mod.make_pinhole(*spec)

    rel = Pose(T(R), T(np.asarray(t, np.float32)))
    jrel = JPose(jnp.asarray(R), jnp.asarray(np.asarray(t, np.float32)))
    crop = undistort.overlap_crop_source_in_target(make(camera, src), make(camera, tgt), rel, 5.0)
    jcrop = jund.overlap_crop_source_in_target(make(jcam, src), make(jcam, tgt), jrel, 5.0)
    np.testing.assert_allclose(crop.numpy(), np.asarray(jcrop), atol=1e-3)
    scale, ok = undistort.scale_for_camera_configuration(make(camera, src), make(camera, tgt),
                                                         rel, 5.0)
    jscale, jok = jund.scale_for_camera_configuration(make(jcam, src), make(jcam, tgt), jrel, 5.0)
    assert bool(ok) == bool(jok) == (case != 2)
    np.testing.assert_allclose(float(scale), float(jscale), rtol=1e-5)
    if case < 2:
        assert abs(float(scale) - (1.0, 2.0)[case]) < 0.05


def test_rescale_image_matches_jax(rng):
    img = make_image(rng)
    for s in (0.5, 0.8, 1.25):
        np.testing.assert_allclose(undistort.rescale_image(T(img), s, H, W).numpy(),
                                   np.asarray(jund.rescale_image(jnp.asarray(img), s, H, W)),
                                   atol=1e-3)


def settings_with(undistort_pixels=None, **fes):
    s = golden_path_settings()
    cam = s.MonoSettings.MonoCamera
    cam = dataclasses.replace(cam, FeatureExtractorSettings=dataclasses.replace(
        cam.FeatureExtractorSettings, **fes))
    if undistort_pixels is not None:
        cam = dataclasses.replace(cam, UndistortImagePixels=undistort_pixels)
    return dataclasses.replace(s, MonoSettings=dataclasses.replace(s.MonoSettings,
                                                                   MonoCamera=cam))


def test_keypoint_path_keeps_original_principal_point():
    """tests/test_undistort.py:153-165: without UndistortImagePixels the
    frontend undistorts keypoints with P = K, so matching keeps the original
    fx/fy/cx/cy; with it, frames are warped to the centered pinhole."""
    cam16 = camera.make_poly3k(260.0, 262.0, 150.0, 125.0, K1, K2, K3, P1, P2, W, H)
    sess = SlamSession(camera=cam16, image_width=W, image_height=H, device="cpu")
    assert sess._raw_cam16 is None
    np.testing.assert_array_equal(sess.cam.numpy(), [260.0, 262.0, 150.0, 125.0])
    np.testing.assert_array_equal(sess.cam16.numpy(), cam16.numpy())
    sess = SlamSession(settings_with(undistort_pixels=True), camera=cam16, image_width=W,
                       image_height=H, device="cpu")
    assert sess._raw_cam16 is not None
    np.testing.assert_array_equal(sess.cam.numpy(), [260.0, 262.0, W / 2, H / 2])
    assert float(sess.cam16[14]) == camera.MODEL_PINHOLE


@pytest.fixture(scope="module")
def ref():
    out = {}
    for path in (FIXTURE, KP_FIXTURE):
        with np.load(path) as z:
            out.update({k: z[k] for k in z.files})
    return out


def run_distorted(ref, prefix: str, undistort_pixels: bool, n: int):
    """The port's session over the first n distorted frames, JAX's draws
    replayed; returns (session, results, maps after each mapping event)."""
    draws = ReplayDraws.from_npz(KP_FIXTURE if prefix == "kp_" else FIXTURE, "cpu",
                                 prefix=prefix)
    sess = SlamSession(settings_with(undistort_pixels=undistort_pixels),
                       camera=ref["dist_camera"], image_width=320, image_height=180,
                       device="cpu", draws=draws)
    maps, mapper = [], sess._insert_keyframe_and_map

    def recording_mapper(frame):
        mapper(frame)
        maps.append(sess.map)

    sess._insert_keyframe_and_map = recording_mapper
    results = [sess.process_frame(ref["dist_frames"][i], float(ref["dist_timestamps"][i]), i)
               for i in range(n)]
    return sess, results, maps


def hold_session(sess, results, maps, ref, prefix: str) -> float:
    """States, keyframe flags, scaled poses, tracked counts and the masks
    after each mapping event against the JAX run; returns the worst pose
    error."""
    n = len(results)
    assert [r.state.value for r in results] == ref[prefix + "ref_state"][:n].tolist()
    assert [r.is_keyframe for r in results] == ref[prefix + "ref_is_kf"][:n].tolist()
    k = float(ref[prefix + "map_scale"]) / sess.map_scale
    assert abs(k - 1.0) < SCALE_TOL, k
    worst = 0.0
    for i, r in enumerate(results):
        assert abs(r.tracked_count - int(ref[prefix + "ref_tracked"][i])) <= TRACKED_TOL, i
        if r.pose is not None:
            err = max(np.abs(r.pose.R.numpy() - ref[prefix + "ref_R"][i]).max(),
                      np.abs(r.pose.t.numpy() * k - ref[prefix + "ref_t"][i]).max())
            assert err <= POSE_ATOL, (i, err)
            worst = max(worst, err)
    ev = ref[prefix + "ev_frame_id"]
    assert len(maps) == int((ev < n).sum())
    for j, m in enumerate(maps):
        for name in MASKS:
            got, want = getattr(m, name).numpy(), ref[f"{prefix}ev{j}_{name}"]
            if name == "kf_assoc" and j in LOGGED_EVENTS.get(prefix, ()):
                assert (got != want).sum() <= LOGGED_ASSOC, (j, np.argwhere(got != want))
                continue
            np.testing.assert_array_equal(got, want, err_msg=f"event {j} (frame {ev[j]})")
    return worst


@pytest.mark.parametrize("prefix,undistort_pixels", [("und_", True), ("kp_", False)])
def test_distorted_session_matches_jax(ref, prefix, undistort_pixels):
    sess, results, maps = run_distorted(ref, prefix, undistort_pixels, SESSION_FRAMES)
    np.testing.assert_array_equal(sess.cam.numpy(), ref[prefix + "cam"])
    np.testing.assert_array_equal(sess.cam16.numpy(), ref[prefix + "cam16"])
    hold_session(sess, results, maps, ref, prefix)


def test_spatial_selection_off_before_init(ref):
    """With SpatialFeatureSelection, init frames are analyzed with it off
    and tracking frames with it on (pipeline.py:264-273, 326-328); the
    first init frame's features equal the JAX session's. The photoreal
    frames with JAX's draws: init frames extract as at golden settings, so
    the session adopts at JAX's frame 5 and tracks 6 with the selection."""
    from mageslam_tpu_torch.runtime import session as session_mod

    with np.load(PHOTOREAL) as z:
        frames, ts, cam = z["frames"][:7], z["timestamps"][:7], z["cam"]
    sess = SlamSession(settings_with(SpatialFeatureSelection=True), cam, 320, 180,
                       device="cpu", draws=ReplayDraws.from_npz(PHOTOREAL, "cpu"))
    seen, real = [], session_mod.detect_and_compute

    def recording(image, cam16, fes, max_features):
        out = real(image, cam16, fes, max_features)
        seen.append((fes.SpatialFeatureSelection, out))
        return out

    session_mod.detect_and_compute = recording
    try:
        results = [sess.process_frame(f, float(t), i) for i, (f, t) in enumerate(zip(frames, ts))]
    finally:
        session_mod.detect_and_compute = real
    adopt = next(i for i, r in enumerate(results) if r.pose is not None)
    assert adopt == 5 and results[6].pose is not None
    assert [s for s, _ in seen] == [False] * (adopt + 1) + [True] * (6 - adopt)
    feats = seen[0][1]
    for name in ("xy", "response", "octave", "valid"):
        np.testing.assert_array_equal(getattr(feats, name).numpy(), ref[f"sfs_feat0_{name}"])
    np.testing.assert_allclose(feats.und_xy.numpy(), ref["sfs_feat0_und_xy"], atol=1e-4)
    np.testing.assert_array_equal(feats.desc.numpy().view(np.uint32), ref["sfs_feat0_desc"])
