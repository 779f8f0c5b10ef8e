"""The port's visual-inertial fuser (mageslam_tpu_torch/fuser, io/sensor_log)
held against the JAX package's on the CPU.

- The sample queue and the sensor log are numpy copies: the same order, the
  same bytes from both writers.
- Each filter function on seeded inputs against JAX's, float32: within
  1e-5 absolute of values of order one (P within 1e-5 of its largest entry).
- The pose covariance against JAX's on a synthetic frame, relative to its
  largest entry (1e-4; H's entries are fx² times squared residuals), the
  flag exact; the shrink case, the underdetermined case and the
  covariance-weighted update as tests/test_analysis_fuser.py has them; the
  port's Cholesky gate against `eigvalsh`'s on matrices on both sides of it.
- A `Fuser` replay of `synthesize_imu`'s samples (bit for bit JAX's) and the
  JAX VI session's recorded visual poses and covariances
  (tests/data/torch_port_vi.npz, `python tools/export_jax_state.py vi`), for
  all three FilterTypes: the same mode on every frame, the metric scale
  within 1e-6 relative, priors and filter states within 1e-4.
"""

import torch_threads  # noqa: F401  (first: torch's OpenMP threads wait passively)

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mageslam_tpu.apps import vi_eval as jax_vi
from mageslam_tpu.apps.render_scene import trajectory_pose as jax_trajectory_pose
from mageslam_tpu.fuser import covariance as jax_cov
from mageslam_tpu.fuser import filters as jf
from mageslam_tpu.fuser import sample_queue as jax_queue
from mageslam_tpu.geometry.se3 import Pose as JPose
from mageslam_tpu.io import sensor_log as jax_log
from mageslam_tpu_torch.apps import vi_eval
from mageslam_tpu_torch.apps.render_scene import trajectory_pose
from mageslam_tpu_torch.config import FilterType
from mageslam_tpu_torch.fuser import covariance as port_cov
from mageslam_tpu_torch.fuser import filters as pf
from mageslam_tpu_torch.fuser import sample_queue as port_queue
from mageslam_tpu_torch.fuser.fuser import Fuser, FuserMode
from mageslam_tpu_torch.geometry.se3 import Pose
from mageslam_tpu_torch.io import sensor_log as port_log

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VI_FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_vi.npz")
STATE_ATOL = 1e-5
COV_RTOL = 1e-4
REPLAY_ATOL = 1e-4
SCALE_RTOL = 1e-6


@pytest.fixture(scope="module")
def vi():
    with np.load(VI_FIXTURE) as z:
        return {k: z[k] for k in z.files}


def random_samples(rng, n: int, queue_mod):
    """Shuffled gyro/accel samples with repeated timestamps and fences."""
    out = []
    for k in range(n):
        ts = float(rng.integers(0, 40)) / 16.0
        kind = queue_mod.SampleType(int(rng.integers(0, 3)))
        out.append(queue_mod.SensorSample(kind, ts, rng.normal(size=3).astype(np.float32)))
    return out


def test_sample_queue_matches_the_original():
    rng = np.random.default_rng(0)
    port, ref = port_queue.SampleQueue(), jax_queue.SampleQueue()
    drained = [], []
    for s in random_samples(rng, 200, port_queue):
        port.add(s)
        ref.add(jax_queue.SensorSample(jax_queue.SampleType(int(s.type)), s.timestamp, s.data))
        if rng.random() < 0.1:
            ts = float(rng.integers(0, 40)) / 16.0
            port.add_image_fence(ts)
            ref.add_image_fence(ts)
        if rng.random() < 0.1:
            for q, out in zip((port, ref), drained):
                got, fence = q.drain_until_fence()
                out.append((fence, [(int(s.type), s.timestamp, s.data.tobytes()) for s in got]))
    assert drained[0] == drained[1] and len(port) == len(ref)
    assert any(fence is not None for fence, _ in drained[0])


def test_sensor_log_writes_the_same_bytes(tmp_path):
    rng = np.random.default_rng(1)
    samples = random_samples(rng, 50, port_queue)
    with port_log.SensorLogWriter(str(tmp_path / "port.log")) as w:
        for s in samples:
            w.write(s)
    with jax_log.SensorLogWriter(str(tmp_path / "ref.log")) as w:
        for s in samples:
            w.write(jax_queue.SensorSample(jax_queue.SampleType(int(s.type)), s.timestamp,
                                           s.data))
    assert (tmp_path / "port.log").read_bytes() == (tmp_path / "ref.log").read_bytes()
    with port_log.SensorLogReader(str(tmp_path / "ref.log")) as r:
        back = list(r.samples())
    assert [(s.type, s.timestamp) for s in back] == [(s.type, s.timestamp) for s in samples]
    assert all(np.array_equal(a.data, b.data) for a, b in zip(back, samples))
    assert all(isinstance(s.type, port_queue.SampleType) for s in back)


def test_synthesized_imu_is_jax_bit_for_bit(vi):
    port = vi_eval.synthesize_imu(trajectory_pose, 80, 80)
    ref = jax_vi.synthesize_imu(jax_trajectory_pose, 80, 80)
    assert len(port) == len(ref) == int(vi["imu_n"])
    for a, b in zip(port, ref):
        assert int(a.type) == int(b.type) and a.timestamp == b.timestamp
        assert a.data.dtype == b.data.dtype and a.data.tobytes() == b.data.tobytes()


# --------------------------------------------------------------------------- #
# the filter functions

def random_state(seed: int):
    """(numpy leaves, port EkfState, JAX EkfState): a unit attitude, moving,
    with biases and a symmetric positive definite P."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    A = rng.normal(scale=0.1, size=(15, 15))
    leaves = [q, rng.normal(size=3), rng.normal(size=3), rng.normal(scale=1e-2, size=3),
              rng.normal(scale=1e-1, size=3), A @ A.T + 1e-2 * np.eye(15)]
    leaves = [np.asarray(x, np.float32) for x in leaves]
    return (leaves, pf.EkfState(*[torch.from_numpy(x) for x in leaves]),
            jf.EkfState(*[jnp.asarray(x) for x in leaves]))


def random_pose(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    R = np.array(jf.quat_to_rot(jnp.asarray(q, jnp.float32)))
    return R, rng.normal(size=3).astype(np.float32)


def assert_state_close(port: pf.EkfState, ref, what: str) -> None:
    for name, a, b in zip(port._fields, port, ref):
        b = np.asarray(b)
        scale = max(1.0, float(np.abs(b).max())) if name == "P" else 1.0
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=STATE_ATOL * scale,
                                   err_msg=f"{what}: {name}")


def spd6(rng, scale: float) -> np.ndarray:
    A = rng.normal(size=(6, 6))
    return np.asarray(scale * (A @ A.T + np.eye(6)), np.float32)


CASES = ["init", "predict", "inject", "kalman", "pose", "pose_cov", "rotation",
         "rotation_cov", "gravity", "pose_from_state", "gravity_in_body"]


@pytest.mark.parametrize("case", CASES)
def test_filter_function_matches_jax(case):
    rng = np.random.default_rng(CASES.index(case) + 10)
    leaves, port, ref = random_state(CASES.index(case))
    R, t = random_pose(rng)
    vp, vj = Pose(torch.from_numpy(R), torch.from_numpy(t)), JPose(jnp.asarray(R), jnp.asarray(t))
    if case == "init":
        got, want = pf.ekf_init(device="cpu"), jf.ekf_init()
    elif case == "predict":
        gyro, accel = rng.normal(size=3).astype(np.float32), rng.normal(size=3).astype(np.float32)
        got = port
        want = ref
        for dt in (np.float32(1 / 120), np.float32(0.004)):
            got = pf.ekf_predict(got, torch.from_numpy(gyro), torch.from_numpy(accel),
                                 torch.tensor(dt))
            want = jf.ekf_predict(want, jnp.asarray(gyro), jnp.asarray(accel), jnp.float32(dt))
    elif case == "inject":
        dx = rng.normal(scale=0.1, size=15).astype(np.float32)
        got, want = pf._inject(port, torch.from_numpy(dx)), jf._inject(ref, jnp.asarray(dx))
    elif case == "kalman":
        H = rng.normal(size=(6, 15)).astype(np.float32)
        r = rng.normal(size=6).astype(np.float32)
        Rm = spd6(rng, 0.1)
        got = pf._kalman(port, torch.from_numpy(H), torch.from_numpy(r), torch.from_numpy(Rm))
        want = jf._kalman(ref, jnp.asarray(H), jnp.asarray(r), jnp.asarray(Rm))
    elif case in ("pose", "pose_cov"):
        cov = spd6(rng, 1e-3) if case == "pose_cov" else None
        got = pf.ekf_update_pose(port, vp, pose_cov=None if cov is None else torch.from_numpy(cov))
        want = jf.ekf_update_pose(ref, vj, pose_cov=None if cov is None else jnp.asarray(cov))
    elif case in ("rotation", "rotation_cov"):
        cov = spd6(rng, 1e-3)[:3, :3] if case == "rotation_cov" else None
        got = pf.ekf_update_rotation(port, vp,
                                     rot_cov=None if cov is None else torch.from_numpy(cov))
        want = jf.ekf_update_rotation(ref, vj, rot_cov=None if cov is None else jnp.asarray(cov))
    elif case == "gravity":
        accel = (np.float32([0.3, -0.2, 9.7]) + rng.normal(scale=0.1, size=3)).astype(np.float32)
        got = pf.ekf_update_gravity(port, torch.from_numpy(accel))
        want = jf.ekf_update_gravity(ref, jnp.asarray(accel))
    elif case == "pose_from_state":
        p, j = pf.pose_from_state(port), jf.pose_from_state(ref)
        np.testing.assert_allclose(p.R.numpy(), np.asarray(j.R), atol=STATE_ATOL)
        np.testing.assert_allclose(p.t.numpy(), np.asarray(j.t), atol=STATE_ATOL)
        return
    else:
        np.testing.assert_allclose(pf.gravity_in_body(port).numpy(),
                                   np.asarray(jf.gravity_in_body(ref)), atol=STATE_ATOL * 10)
        return
    assert all(x.dtype == torch.float32 for x in got)
    assert_state_close(got, want, case)


def kalman_case(seed: int = 3):
    """A Kalman update's float32 inputs (state, H, r, Rm) and its covariance
    by the Joseph form in float64."""
    rng = np.random.default_rng(seed)
    leaves, state, _ = random_state(seed)
    H = rng.normal(size=(6, 15)).astype(np.float32)
    r = rng.normal(size=6).astype(np.float32)
    Rm = spd6(rng, 0.1)
    P, H64, Rm64 = leaves[5].astype(np.float64), H.astype(np.float64), Rm.astype(np.float64)
    K = P @ H64.T @ np.linalg.inv(H64 @ P @ H64.T + Rm64)
    IKH = np.eye(15) - K @ H64
    return state, H, r, Rm, IKH @ P @ IKH.T + K @ Rm64 @ K.T


def test_fuser_products_run_in_full_float32():
    """The package turns TF32 off on the card for every float32 product,
    the filter's included (its 15×15 products would keep ~3 digits); the
    update's covariance agrees with a float64 evaluation to float32
    rounding (tests/test_torch_cuda.py holds the same on the card)."""
    import mageslam_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    state, H, r, Rm, want = kalman_case()
    got = pf._kalman(state, *[torch.from_numpy(x) for x in (H, r, Rm)])
    assert float(np.abs(got.P.numpy() - want).max() / np.abs(want).max()) < 1e-5


# --------------------------------------------------------------------------- #
# the pose covariance

def covariance_case(rng, n: int = 60, noise: float = 0.5):
    """tests/test_analysis_fuser.py::TestPoseCovariance's frame: n points
    3-8 m ahead, their projections with pixel noise, 64 slots."""
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(3, 8, n)], 1).astype(np.float32)
    uv = np.stack([260 * pts[:, 0] / pts[:, 2] + 160,
                   260 * pts[:, 1] / pts[:, 2] + 90], 1).astype(np.float32)
    uv += rng.normal(0, noise, uv.shape).astype(np.float32)
    N = 64
    kp = np.zeros((N, 2), np.float32)
    kp[:n] = uv[:N]
    valid = np.arange(N) < n
    assoc = np.where(valid, np.arange(N), -1).astype(np.int32)
    cam = np.float32([260.0, 260.0, 160.0, 90.0])
    return cam, kp, valid, assoc, pts, np.ones((n,), bool)


def both_covariances(cam, kp, valid, assoc, pts, mp_valid, R=None, t=None):
    R = np.eye(3, dtype=np.float32) if R is None else R
    t = np.zeros(3, np.float32) if t is None else t
    port = port_cov.estimate_pose_covariance(
        Pose(torch.from_numpy(R), torch.from_numpy(t)), *[torch.from_numpy(np.asarray(x))
                                                         for x in (cam, kp, valid, assoc, pts,
                                                                   mp_valid)])
    ref = jax_cov.estimate_pose_covariance(JPose(jnp.asarray(R), jnp.asarray(t)),
                                           *[jnp.asarray(x) for x in (cam, kp, valid, assoc, pts,
                                                                      mp_valid)])
    return (port[0].numpy(), bool(port[1])), (np.asarray(ref[0]), bool(ref[1]))


@pytest.mark.parametrize("n", [60, 10, 2])
def test_covariance_matches_jax(n):
    """60 and 10 points: ok, the same covariance; 2: underdetermined, both
    fail to 1e6·I."""
    cam, kp, valid, assoc, pts, mpv = covariance_case(np.random.default_rng(n))
    if n < 60:
        valid = valid & (np.arange(valid.shape[0]) < n)
        assoc = np.where(valid, assoc, -1).astype(np.int32)
    (c, ok), (c_ref, ok_ref) = both_covariances(cam, kp, valid, assoc, pts, mpv)
    assert ok == ok_ref == (n >= 6)
    np.testing.assert_allclose(c, c_ref, rtol=0, atol=COV_RTOL * np.abs(c_ref).max())
    if not ok:
        np.testing.assert_array_equal(c, np.eye(6, dtype=np.float32) * 1e6)


def test_covariance_shrinks_with_more_points():
    cam, kp, valid, assoc, pts, mpv = covariance_case(np.random.default_rng(0))
    (many, ok), _ = both_covariances(cam, kp, valid, assoc, pts, mpv)
    few = valid & (np.arange(valid.shape[0]) < 10)
    (few_cov, ok2), _ = both_covariances(cam, kp, few, np.where(few, assoc, -1).astype(np.int32),
                                         pts, mpv)
    assert ok and ok2 and np.trace(many) < np.trace(few_cov)
    np.testing.assert_allclose(many, many.T, rtol=1e-6)
    assert (np.linalg.eigvalsh(many) > 0).all()


@pytest.mark.parametrize("smallest", [1e-12, 1e-9, 1e-6, 1.0, 1e3])
def test_cholesky_gate_is_the_eigenvalue_gate(smallest):
    """The port tests eigvalsh(H)[0] > 1e-10 by factoring H − 1e-10·I (no
    host stop on the card): the same verdict on Hessians whose smallest
    eigenvalue sits on either side of the gate, and on ones with
    reprojection-sized entries."""
    rng = np.random.default_rng(int(-np.log10(smallest)) + 20)
    Q, _ = np.linalg.qr(rng.normal(size=(6, 6)))
    eigs = np.array([smallest, 1e-3, 1.0, 10.0, 100.0, 1e3])
    H = torch.from_numpy(Q @ np.diag(eigs) @ Q.T)
    _, info = torch.linalg.cholesky_ex(H - port_cov.EIG_GATE * torch.eye(6, dtype=H.dtype))
    assert (int(info) == 0) == bool(np.linalg.eigvalsh(H.numpy())[0] > port_cov.EIG_GATE)


def test_covariance_weighted_update():
    """A huge measurement covariance must damp the visual update."""
    target = Pose(torch.eye(3), torch.tensor([-1.0, 0.0, 0.0]))
    st_default = pf.ekf_update_pose(pf.ekf_init(device="cpu"), target)
    st_weak = pf.ekf_update_pose(pf.ekf_init(device="cpu"), target,
                                 pose_cov=torch.eye(6) * 1e4)
    assert float(st_weak.p[0]) < float(st_default.p[0]) * 0.1
    ref = jf.ekf_update_pose(jf.ekf_init(), JPose(jnp.eye(3), jnp.array([-1.0, 0.0, 0.0])),
                             pose_cov=jnp.eye(6) * 1e4)
    assert_state_close(st_weak, ref, "weighted update")


# --------------------------------------------------------------------------- #
# the Fuser on the recorded VI run

def recorded_calls(vi: dict) -> dict:
    """frame → (R, t, covariance) the JAX session gave Fuser.process_frame."""
    calls = {}
    for i in np.flatnonzero(vi["call_has"]):
        if not vi["call_pose"][i]:
            calls[int(i)] = (None, None, None)
            continue
        cov = vi["call_cov"][i]
        calls[int(i)] = (vi["call_R"][i], vi["call_t"][i], None if np.isnan(cov).any() else cov)
    return calls


@pytest.mark.parametrize("filter_name", ["SIMPLE6DOF", "FUSER6DOF", "FUSER3DOF"])
def test_fuser_replay_matches_jax(vi, filter_name):
    """A fresh Fuser on the VI run's samples and recorded visual poses: the
    JAX fuser's mode on every frame, its metric scale, priors and states.
    SIMPLE6DOF is the session's own fuser; the other two are JAX's replay
    of the same inputs."""
    calls = recorded_calls(vi)
    got = vi_eval.replay_fuser(getattr(FilterType, filter_name),
                               vi_eval.synthesize_imu(trajectory_pose, 80, 80), calls,
                               int(vi["adopt_frame"]), 80, device="cpu")
    pre = "" if filter_name == "SIMPLE6DOF" else f"rp_{filter_name}_"
    np.testing.assert_array_equal(got["mode"], vi[pre + "mode"])
    want_scale = vi[pre + "metric_scale"]
    np.testing.assert_array_equal(np.isnan(got["metric_scale"]), np.isnan(want_scale))
    known = ~np.isnan(want_scale)
    np.testing.assert_allclose(got["metric_scale"][known], want_scale[known], rtol=SCALE_RTOL)
    np.testing.assert_array_equal(got["prior_valid"], vi[pre + "prior_valid"])
    assert got["prior_valid"].any()
    for key in ("prior_R", "prior_t", "ekf_q", "ekf_p", "ekf_v", "ekf_bg", "ekf_ba"):
        np.testing.assert_allclose(got[key], vi[pre + key], rtol=0, atol=REPLAY_ATOL,
                                   equal_nan=True, err_msg=key)
    P, P_ref = got["ekf_P"], vi[pre + "ekf_P"]
    assert np.abs(P - P_ref).max() <= REPLAY_ATOL * np.abs(P_ref).max()
    f = got["fuser"]
    if filter_name == "FUSER3DOF":
        assert FuserMode.SCALE_INIT.value not in got["mode"] and f.metric_scale is None
    if filter_name == "SIMPLE6DOF":
        assert not f.state.bg.any() and not f.state.ba.any()
    # the host reads: one a WAIT_FOR_GRAVITY frame, one a SCALE_INIT frame
    # with a visual pose after the first
    modes_before = np.concatenate([[FuserMode.WAIT_FOR_MAGE_INIT.value], got["mode"][:-1]])
    called = np.asarray([i in calls for i in range(80)])
    gravity = int(np.sum(called & (modes_before == FuserMode.WAIT_FOR_GRAVITY.value)))
    scale_init = int(np.sum(called & (modes_before == FuserMode.SCALE_INIT.value)
                            & vi["call_pose"]))
    assert f.host_reads == gravity + max(scale_init - 1, 0)


def test_fuser_mode_machine_from_scratch():
    """tests/test_analysis_fuser.py's mode machine on the port: static
    accelerometer samples converge gravity, then a physically consistent
    +1 m/s² run gives a metric scale of about 1 (the visual poses are
    metric)."""
    f = Fuser(scale_window=3, device="cpu")
    f.on_mage_initialized()
    t = 0.0
    g = np.array([0, 0, pf.GRAVITY], np.float32)
    for i in range(60):
        t += 0.01
        f.add_sample(port_queue.SensorSample(port_queue.SampleType.ACCELEROMETER, t, g))
        if i % 10 == 9:
            f.process_frame(None, t)
        if f.mode != FuserMode.WAIT_FOR_GRAVITY:
            break
    assert f.mode == FuserMode.SCALE_INIT
    for k in range(6):
        t += 0.1
        f.add_sample(port_queue.SensorSample(port_queue.SampleType.GYROMETER, t - 0.05,
                                             np.zeros(3, np.float32)))
        f.add_sample(port_queue.SensorSample(port_queue.SampleType.ACCELEROMETER, t - 0.05,
                                             np.array([1.0, 0, pf.GRAVITY], np.float32)))
        tau = 0.1 * (k + 1)
        f.process_frame(Pose(torch.eye(3), torch.tensor([-0.5 * tau * tau, 0.0, 0.0])), t)
    assert f.mode == FuserMode.TRACKING and 0.2 < f.metric_scale < 5.0
    assert f.pose_prior() is not None
