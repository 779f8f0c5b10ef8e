"""The port's geometry, pose-only LM and per-frame bookkeeping pieces against
the JAX package, on seeded numpy inputs. Float tolerances are float32
reassociation bounds (a few ulp of the values involved)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mageslam_tpu.ba.pose_only import optimize_pose as joptimize_pose
from mageslam_tpu.geometry import camera as jcam
from mageslam_tpu.geometry import se3 as jse3
from mageslam_tpu.runtime.pose_history import PoseHistory as JPoseHistory
from mageslam_tpu.tracking import frame_state as jfs
from mageslam_tpu.tracking.pose_estimation import \
    estimate_next_pose_from_history as jestimate_next
from mageslam_tpu_torch.ba.pose_only import optimize_pose
from mageslam_tpu_torch.geometry import camera, se3
from mageslam_tpu_torch.runtime.pose_history import PoseHistory
from mageslam_tpu_torch.tracking import frame_state as fs
from mageslam_tpu_torch.tracking.pose_estimation import estimate_next_pose_from_history
from mageslam_tpu_torch.worldmap.map_state import predict_octave

torch.set_num_threads(2)


def T(a):
    return torch.from_numpy(np.array(a))


def random_rotvecs(rng, n, scale=1.0):
    return (rng.randn(n, 3) * scale).astype(np.float32)


@pytest.mark.parametrize("scale", [1e-6, 0.3, 2.5])
def test_so3_maps_match(rng, scale):
    phi = random_rotvecs(rng, 64, scale)
    R = se3.exp_so3(T(phi)).numpy()
    np.testing.assert_allclose(R, np.asarray(jse3.exp_so3(jnp.asarray(phi))), atol=2e-6)
    np.testing.assert_allclose(se3.log_so3(T(R)).numpy(),
                               np.asarray(jse3.log_so3(jnp.asarray(R))), atol=2e-5)
    q = se3.rot_to_quat(T(R)).numpy()
    np.testing.assert_allclose(q, np.asarray(jse3.rot_to_quat(jnp.asarray(R))), atol=2e-6)
    np.testing.assert_allclose(se3.quat_to_rot(T(q)).numpy(),
                               np.asarray(jse3.quat_to_rot(jnp.asarray(q))), atol=2e-6)


def test_retract_and_interpolate_match(rng):
    R = np.asarray(jse3.exp_so3(jnp.asarray(random_rotvecs(rng, 16))))
    t = rng.randn(16, 3).astype(np.float32)
    tw = (rng.randn(16, 6) * 0.1).astype(np.float32)
    got = se3.retract(se3.Pose(T(R), T(t)), T(tw))
    want = jse3.retract(jse3.Pose(jnp.asarray(R), jnp.asarray(t)), jnp.asarray(tw))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=2e-6)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=5e-6)
    R2, t2 = R[::-1].copy(), t[::-1].copy()
    for alpha in (0.25, 1.6):
        got = se3.interpolate_pose(se3.Pose(T(R), T(t)), se3.Pose(T(R2), T(t2)), alpha)
        want = jse3.interpolate_pose(jse3.Pose(jnp.asarray(R), jnp.asarray(t)),
                                     jse3.Pose(jnp.asarray(R2), jnp.asarray(t2)), alpha)
        np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-5)
        np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-4)


def test_camera_projection_and_undistortion_match(rng):
    args = (500.0, 505.0, 320.0, 240.0, -0.12, 0.03, 0.001, 0.0005, -0.0004, 640, 480)
    cam_t, cam_j = camera.make_poly3k(*args), jcam.make_poly3k(*args)
    np.testing.assert_array_equal(cam_t.numpy(), np.asarray(cam_j))
    px = rng.uniform([0, 0], [640, 480], (200, 2)).astype(np.float32)
    np.testing.assert_allclose(camera.undistort_pixels(cam_t, T(px)).numpy(),
                               np.asarray(jcam.undistort_pixels(cam_j, jnp.asarray(px))),
                               atol=1e-3)
    pts = np.concatenate([rng.uniform(-2, 2, (200, 2)), rng.uniform(1, 8, (200, 1))],
                         axis=1).astype(np.float32)
    for fn, jfn in ((camera.project_camera_points, jcam.project_camera_points),
                    (camera.project_undistorted, jcam.project_undistorted)):
        (uv, z), (juv, jz) = fn(cam_t, T(pts)), jfn(cam_j, jnp.asarray(pts))
        np.testing.assert_allclose(uv.numpy(), np.asarray(juv), atol=1e-3)
        np.testing.assert_array_equal(z.numpy(), np.asarray(jz))


@pytest.mark.parametrize("iters", [3, 10])
def test_optimize_pose_matches(rng, iters):
    """Pose-only LM from a perturbed start, with outliers and masked rows."""
    n = 200
    R = np.asarray(jse3.exp_so3(jnp.asarray(random_rotvecs(rng, 1, 0.2)[0])))
    t = np.array([0.1, -0.2, 0.3], np.float32)
    pts = np.concatenate([rng.uniform(-3, 3, (n, 2)), rng.uniform(3, 9, (n, 1))],
                         axis=1).astype(np.float32)
    cam = np.array([520.0, 520.0, 320.0, 240.0], np.float32)
    Xc = pts @ R.T + t
    uv = (cam[:2] * Xc[:, :2] / Xc[:, 2:] + cam[2:]).astype(np.float32)
    uv += rng.randn(n, 2).astype(np.float32) * 0.5
    uv[:10] += 40.0                                    # gross outliers
    info = (rng.rand(n) > 0.1).astype(np.float32)
    R0 = np.asarray(jse3.exp_so3(jnp.asarray(random_rotvecs(rng, 1, 0.02)[0]))) @ R
    t0 = t + np.float32(0.05)
    got = optimize_pose(se3.Pose(T(R0), T(t0)), T(cam), T(pts), T(uv), T(info), 2.0, iters)
    want = joptimize_pose(jse3.Pose(jnp.asarray(R0), jnp.asarray(t0)), jnp.asarray(cam),
                          jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(info), 2.0,
                          num_iters=iters)
    np.testing.assert_allclose(got[0].R.numpy(), np.asarray(want[0].R), atol=2e-5)
    np.testing.assert_allclose(got[0].t.numpy(), np.asarray(want[0].t), atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-4)


def _histories(rng, h=5, n=32):
    R = np.asarray(jse3.exp_so3(jnp.asarray(random_rotvecs(rng, h, 0.05))))
    t = rng.randn(h, 3).astype(np.float32)
    ts = (np.arange(h)[::-1] * 0.033 + 1.0).astype(np.float32)
    assoc = rng.randint(-1, 100, (h, n)).astype(np.int32)
    xy = rng.uniform(0, 640, (h, n, 2)).astype(np.float32)
    octv = rng.randint(0, 2, (h, n)).astype(np.int32)
    desc = rng.randint(0, 2**32, (h, n, 8), dtype=np.uint64).astype(np.uint32)
    valid = np.array([True, True, True, False, False])
    jh = jfs.TrackingHistory(jse3.Pose(jnp.asarray(R), jnp.asarray(t)), jnp.asarray(ts),
                             jnp.asarray(assoc), jnp.asarray(xy), jnp.asarray(octv),
                             jnp.asarray(desc), jnp.asarray(valid))
    th = fs.TrackingHistory(se3.Pose(T(R), T(t)), T(ts), T(assoc), T(xy), T(octv),
                            T(desc.view(np.int32)), T(valid))
    return jh, th


def test_motion_prior_and_history_advance_match(rng):
    jh, th = _histories(rng)
    got = estimate_next_pose_from_history(th, torch.tensor(1.2, dtype=torch.float32))
    want = jestimate_next(jh, jnp.float32(1.2))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-5)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-4)
    n = th.assoc.shape[1]
    frame = fs.TrackedFrame(se3.Pose.identity(), torch.zeros(4),
                            torch.ones((n, 2)), torch.zeros(n, dtype=torch.int32),
                            torch.full((n, 8), -1, dtype=torch.int32),
                            torch.ones(n, dtype=torch.bool),
                            torch.arange(n, dtype=torch.int32),
                            torch.tensor(1.2), torch.tensor(9, dtype=torch.int32))
    adv = th.advance(frame)
    assert adv.valid.tolist() == [True, True, True, True, False]
    assert adv.assoc[0].tolist() == list(range(n)) and adv.assoc[1].tolist() == th.assoc[0].tolist()
    assert (adv.desc[0] == -1).all() and not th.clear().valid.any()


def test_pose_history_add_matches(rng):
    K = 4
    Rk = np.asarray(jse3.exp_so3(jnp.asarray(random_rotvecs(rng, K, 0.3))))
    tk = rng.randn(K, 3).astype(np.float32)
    Rf = np.asarray(jse3.exp_so3(jnp.asarray(random_rotvecs(rng, 1, 0.3)[0])))
    tf = rng.randn(3).astype(np.float32)
    slots = np.array([3, 0, 7, 1], np.int32)
    ok = np.array([True, True, False, True])
    got = PoseHistory.empty(6, K)
    want = JPoseHistory.empty(6, K)
    for fid in range(8):                       # wraps the ring buffer
        got = got.add(fid, se3.Pose(T(Rf), T(tf)), se3.Pose(T(Rk), T(tk)), T(slots), T(ok),
                      near=torch.tensor(0.5 + fid), far=torch.tensor(9.0))
        want = want.add(fid, jse3.Pose(jnp.asarray(Rf), jnp.asarray(tf)),
                        jse3.Pose(jnp.asarray(Rk), jnp.asarray(tk)), jnp.asarray(slots),
                        jnp.asarray(ok), near=jnp.float32(0.5 + fid), far=jnp.float32(9.0))
    got = got.add_single(8, se3.Pose(T(Rf), T(tf)), se3.Pose(T(Rk[0]), T(tk[0])), 2)
    want = want.add_single(8, jse3.Pose(jnp.asarray(Rf), jnp.asarray(tf)),
                           jse3.Pose(jnp.asarray(Rk[0]), jnp.asarray(tk[0])), 2)
    for f in JPoseHistory._fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=2e-5, err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)


def test_predict_octave_matches(rng):
    from mageslam_tpu.worldmap.map_state import predict_octave as jpredict

    d = rng.uniform(0.1, 20, 500).astype(np.float32)
    dmin = rng.uniform(0.05, 5, 500).astype(np.float32)
    np.testing.assert_array_equal(predict_octave(T(d), T(dmin), 1.5).numpy(),
                                  np.asarray(jpredict(jnp.asarray(d), jnp.asarray(dmin), 1.5)))
