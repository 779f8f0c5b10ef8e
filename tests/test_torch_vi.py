"""The port's visual-inertial session (FuserSettings.UseFuser, SIMPLE6DOF)
over the first 26 of apps/vi_eval.py's 80 frames, held against the JAX
session's run on the CPU.

The JAX run is tests/data/torch_port_vi.npz (`python tools/export_jax_state.py
vi`): apps/vi_eval.py's default run on the photoreal fixture's frames, with
the photoreal run's init and vocabulary draws, which the port replays. The
window 0-25 covers every mode of the fuser: adoption at 5 (WAIT_FOR_GRAVITY),
SCALE_INIT at 6, TRACKING at 17, then eight frames (18-25) tracked from the
IMU prior with the covariance-weighted update. Tolerances:

- the fuser's mode after every frame, every state and keyframe flag, and
  the map's masks after each mapping event: exact;
- poses within 1e-3 once t is scaled by the ratio of the two map scales (mono
  init leaves the scale to float noise), that ratio within 5 %; tracked
  counts within 3;
- the metric scale within 1e-3 relative, in JAX's map units;
- the IMU priors (frames 18-25) within 1e-3 (t in JAX's map units); the
  covariance's flag on every VI-tracking frame exact, the covariance (in
  JAX's map units) within 5e-3 of its largest entry; the filter's position,
  velocity and biases (metric) within 1e-3 and its attitude within 1e-4.

Measured on the CPU (2 threads): poses within 3.0e-4, metric scale 2.3e-4
relative, priors 3.2e-4, covariances 9.2e-4 of their largest entry.

The port's `render_scene` copy renders two of the fixture's frames bit for
bit.
"""

import os

import numpy as np
import pytest
import torch

from mageslam_tpu_torch import SlamSession, TrackingState
from mageslam_tpu_torch.apps import render_scene, vi_eval
from mageslam_tpu_torch.fuser.fuser import Fuser, FuserMode
from mageslam_tpu_torch.fuser.sample_queue import SampleType, SensorSample
from mageslam_tpu_torch.runtime import session as session_mod
from mageslam_tpu_torch.runtime.draws import ReplayDraws

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHOTOREAL = os.path.join(REPO, "tests", "data", "torch_port_photoreal.npz")
VI_FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_vi.npz")
DRAW_SOURCES = ((PHOTOREAL, ("init", "pnp", "vocab")), (VI_FIXTURE, ("reloc",)))
WINDOW = 26
PERIOD = 80                 # the fixture's trajectory: vi_eval's 80-frame run
POSE_ATOL = 1e-3
TRACKED_TOL = 3
SCALE_TOL = 0.05
METRIC_SCALE_RTOL = 1e-3
COV_ATOL = 5e-3             # of the covariance's largest entry
EKF_ATOL = 1e-3
EKF_Q_ATOL = 1e-4


@pytest.fixture(scope="module")
def ref():
    with np.load(VI_FIXTURE) as z:
        out = {k: z[k] for k in z.files}
    with np.load(PHOTOREAL) as z:
        out["frames"] = z["frames"][:WINDOW]
    return out


@pytest.fixture(scope="module")
def port_run(ref):
    """run_vi_eval over the window on the CPU, recording per frame the
    fuser's mode and state, the prior given to tracking, the covariance and
    the map after each mapping event."""
    rec = {"maps": [], "priors": {}, "covs": {}, "modes": [], "states": []}
    frame = [0]
    real_prior = session_mod.SlamSession._imu_prior
    real_cov = session_mod.estimate_pose_covariance
    real_map = session_mod.SlamSession._insert_keyframe_and_map
    real_process = session_mod.SlamSession.process_frame
    real_track = session_mod.track_step

    def prior(self):
        p = real_prior(self)
        if p is not None:
            rec["priors"][frame[0]] = (p.R.numpy(), p.t.numpy())
        return p

    def cov(*args):
        c, ok = real_cov(*args)
        rec["covs"][frame[0]] = (c.numpy(), bool(ok))
        return c, ok

    def mapper(self, f):
        real_map(self, f)
        rec["maps"].append(self.map)

    def track(*args, **kwargs):
        res = real_track(*args, **kwargs)
        rec["last_frame"] = res.frame
        return res

    def process(self, image, timestamp, frame_id):
        frame[0] = frame_id
        out = real_process(self, image, timestamp, frame_id)
        rec["modes"].append(self.fuser.mode.value)
        rec["states"].append([x.clone() for x in self.fuser.state])
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(session_mod.SlamSession, "_imu_prior", prior)
        mp.setattr(session_mod, "estimate_pose_covariance", cov)
        mp.setattr(session_mod.SlamSession, "_insert_keyframe_and_map", mapper)
        mp.setattr(session_mod.SlamSession, "process_frame", process)
        mp.setattr(session_mod, "track_step", track)
        out = vi_eval.run_vi_eval(WINDOW, period=PERIOD, verbose=False, device="cpu",
                                  draws=ReplayDraws.from_npzs(DRAW_SOURCES, "cpu"),
                                  frames=ref["frames"])
    return out, rec


def scale_ratio(sess, ref) -> float:
    """t_jax ≈ k · t_port."""
    return float(ref["map_scale"]) / sess.map_scale


def test_mode_transitions_match_jax(port_run, ref):
    out, rec = port_run
    np.testing.assert_array_equal(rec["modes"], ref["mode"][:WINDOW])
    assert out["transitions"] == {"WAIT_FOR_GRAVITY": 5, "SCALE_INIT": 6, "TRACKING": 17}
    assert out["final_mode"] == "TRACKING" and out["tracked"] == WINDOW - 5


def test_frames_match_jax(port_run, ref):
    out, _ = port_run
    sess = out["session"]
    k = scale_ratio(sess, ref)
    assert abs(k - 1.0) < SCALE_TOL, k
    results = sess.results
    assert [r.state.value for r in results] == ref["ref_state"][:WINDOW].tolist()
    assert [r.is_keyframe for r in results] == ref["ref_is_kf"][:WINDOW].tolist()
    for i, r in enumerate(results):
        assert abs(r.tracked_count - int(ref["ref_tracked"][i])) <= TRACKED_TOL, i
        if r.pose is None:
            continue
        err = max(np.abs(r.pose.R.numpy() - ref["ref_R"][i]).max(),
                  np.abs(r.pose.t.numpy() * k - ref["ref_t"][i]).max())
        assert err <= POSE_ATOL, (i, err)


def test_maps_after_each_event_match_jax(port_run, ref):
    _, rec = port_run
    events = ref["ev_frame_id"]
    n = int(np.sum(events < WINDOW))
    assert len(rec["maps"]) == n == 5          # frames 6, 7, 11, 16, 23
    for j, m in enumerate(rec["maps"]):
        for name in ("kf_valid", "mp_valid", "kf_assoc", "kf_member"):
            np.testing.assert_array_equal(getattr(m, name).numpy(), ref[f"ev{j}_{name}"],
                                          err_msg=f"event {j} (frame {events[j]})")


def test_metric_scale_matches_jax(port_run, ref):
    out, _ = port_run
    sess = out["session"]
    k = scale_ratio(sess, ref)
    want = float(ref["metric_scale"][17])
    # metres per map unit: the port's map unit is 1/k of JAX's
    assert abs(out["metric_scale"] / k - want) <= METRIC_SCALE_RTOL * want, \
        (out["metric_scale"], k, want)


def test_priors_and_covariances_match_jax(port_run, ref):
    out, rec = port_run
    k = scale_ratio(out["session"], ref)
    assert sorted(rec["priors"]) == np.flatnonzero(ref["prior_valid"][:WINDOW]).tolist() \
        == list(range(18, WINDOW))
    for i, (R, t) in rec["priors"].items():
        err = max(np.abs(R - ref["prior_R"][i]).max(), np.abs(t * k - ref["prior_t"][i]).max())
        assert err <= POSE_ATOL, (i, err)
    vi_frames = np.flatnonzero(ref["cov_ok"][:WINDOW] >= 0).tolist()
    assert sorted(rec["covs"]) == vi_frames == list(range(18, WINDOW))
    D = np.diag([k, k, k, 1.0, 1.0, 1.0])        # [rho, phi] in JAX's map units
    for i, (c, ok) in rec["covs"].items():
        assert ok == bool(ref["cov_ok"][i]), i
        want = ref["cov"][i]
        err = np.abs(D @ c @ D - want).max() / np.abs(want).max()
        assert err <= COV_ATOL, (i, err)


def test_public_pose_covariance_is_the_tracking_one(port_run):
    """`SlamSession.estimate_pose_covariance` on the window's last tracked
    frame gives the covariance the fuser took in that frame (the map is
    the same: frame 25 is no keyframe)."""
    out, rec = port_run
    cov, ok = out["session"].estimate_pose_covariance(rec["last_frame"])
    want, want_ok = rec["covs"][WINDOW - 1]
    assert ok and want_ok and cov.shape == (6, 6)
    np.testing.assert_array_equal(cov, want)


def test_filter_state_matches_jax(port_run, ref):
    _, rec = port_run
    for i, (q, p, v, bg, ba, P) in enumerate(rec["states"]):
        assert np.abs(q.numpy() - ref["ekf_q"][i]).max() <= EKF_Q_ATOL, i
        for name, x in (("p", p), ("v", v), ("bg", bg), ("ba", ba)):
            assert np.abs(x.numpy() - ref[f"ekf_{name}"][i]).max() <= EKF_ATOL, (i, name)
        if i > 0 and ref["mode"][i - 1] == FuserMode.TRACKING.value:
            # SIMPLE6DOF: the biases stay zero once a frame starts in TRACKING
            assert not bg.any() and not ba.any()


def test_render_scene_copy_renders_the_fixture_frames(ref):
    surfaces = render_scene.build_scene(7)
    for i in (0, 17):
        R, c = render_scene.trajectory_pose(i, PERIOD)
        img = render_scene.render_frame(surfaces, R, c, 320, 180, frame_index=i, supersample=2)
        assert img.dtype == np.uint8
        np.testing.assert_array_equal(img, ref["frames"][i])


def test_session_builds_its_fuser():
    """UseFuser: the session's Fuser runs on its device with the configured
    filter, samples reach its queue, and a snapshot leaves it out."""
    s = vi_eval.vi_settings()
    sess = SlamSession(s, (216.6, 216.6, 160.0, 90.0), 320, 180, device="cpu")
    assert isinstance(sess.fuser, Fuser) and sess.fuser.device.type == "cpu"
    assert sess.fuser.filter_type == s.FuserSettings.FilterType
    assert sess.fuser.state.P.device.type == "cpu"
    assert sess.fuser.mode == FuserMode.WAIT_FOR_MAGE_INIT
    sess.add_sensor_sample(SensorSample(SampleType.GYROMETER, 0.0, np.zeros(3, np.float32)))
    assert len(sess.fuser.queue) == 1
    assert "fuser" not in sess.snapshot_state()
    r = sess.process_frame(np.zeros((180, 320), np.uint8), 0.0, 0)
    assert r.state == TrackingState.INITIALIZING
