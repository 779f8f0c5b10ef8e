"""The port's visual-inertial session under FilterType FUSER3DOF and
FUSER6DOF, whole sessions over the first 26 of apps/vi_eval.py's 80 frames
(tests/test_torch_vi.py's window), held against the JAX sessions on the
CPU.

The JAX runs are tests/data/torch_port_vi_filters.npz (`python
tools/export_jax_state.py vi_filters`: apps/vi_eval.py's run as
tests/data/torch_port_vi.npz records SIMPLE6DOF's, under `f3_` and `f6_`),
on the photoreal fixture's frames with the photoreal run's init and
vocabulary draws, which the port replays. The filter's prior feeds back into
tracking (`SlamSession._imu_prior`), so these are closed loops, not replays.
In the window FUSER3DOF goes from WAIT_FOR_GRAVITY (adoption at 5) straight
to TRACKING at 6, with no metric scale, and gives priors from frame 7;
FUSER6DOF runs SCALE_INIT from 6 and TRACKING from 17, with priors from 18.
Tolerances are tests/test_torch_vi.py's:

- the fuser's mode after every frame, every state and keyframe flag, and
  the map's masks after each mapping event: exact;
- poses within 1e-3 once t is scaled by the ratio of the two map scales (mono
  init leaves the scale to float noise), that ratio within 5 %; tracked
  counts within 3;
- the metric scale within 1e-3 relative, in JAX's map units (FUSER6DOF;
  FUSER3DOF has none in either package);
- the IMU priors within 1e-3 (t in JAX's map units); the covariance's flag
  on every VI-tracking frame exact, the covariance (in JAX's map units)
  within 5e-3 of its largest entry; the filter's position, velocity and
  biases within 1e-3 and its attitude within 1e-4.
"""

import torch_threads  # noqa: F401  (first: torch's OpenMP threads wait passively)

import os

import numpy as np
import pytest
import torch

from mageslam_tpu_torch.apps import vi_eval
from mageslam_tpu_torch.config import FilterType
from mageslam_tpu_torch.runtime import session as session_mod
from mageslam_tpu_torch.runtime.draws import ReplayDraws

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHOTOREAL = os.path.join(REPO, "tests", "data", "torch_port_photoreal.npz")
FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_vi_filters.npz")
FILTERS = {"f3": FilterType.FUSER3DOF, "f6": FilterType.FUSER6DOF}
WINDOW = 26
PERIOD = 80                 # the fixture's trajectory: vi_eval's 80-frame run
POSE_ATOL = 1e-3
TRACKED_TOL = 3
SCALE_TOL = 0.05
METRIC_SCALE_RTOL = 1e-3
COV_ATOL = 5e-3             # of the covariance's largest entry
EKF_ATOL = 1e-3
EKF_Q_ATOL = 1e-4
# (first frame with a prior, frame of TRACKING) in the window, per filter
EXPECTED = {"f3": (7, 6), "f6": (18, 17)}


@pytest.fixture(scope="module")
def fixture():
    with np.load(FIXTURE) as z:
        out = {k: z[k] for k in z.files}
    with np.load(PHOTOREAL) as z:
        out["frames"] = z["frames"][:WINDOW]
    return out


def run(frames, filter_type):
    """run_vi_eval over the window on the CPU, recording per frame the
    fuser's mode and state, the prior given to tracking, the covariance and
    the map after each mapping event."""
    rec = {"maps": [], "priors": {}, "covs": {}, "modes": [], "states": []}
    frame = [0]
    real_prior = session_mod.SlamSession._imu_prior
    real_cov = session_mod.estimate_pose_covariance
    real_map = session_mod.SlamSession._insert_keyframe_and_map
    real_process = session_mod.SlamSession.process_frame

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

    def process(self, image, timestamp, frame_id):
        frame[0] = frame_id
        out = real_process(self, image, timestamp, frame_id)
        rec["modes"].append(self.fuser.mode.value)
        rec["states"].append([x.clone() for x in self.fuser.state])
        return out

    draws = ReplayDraws.from_npz(PHOTOREAL, "cpu", kinds=("init", "pnp", "vocab"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(session_mod.SlamSession, "_imu_prior", prior)
        mp.setattr(session_mod, "estimate_pose_covariance", cov)
        mp.setattr(session_mod.SlamSession, "_insert_keyframe_and_map", mapper)
        mp.setattr(session_mod.SlamSession, "process_frame", process)
        out = vi_eval.run_vi_eval(WINDOW, period=PERIOD, filter_type=filter_type,
                                  verbose=False, device="cpu", draws=draws, frames=frames)
    return out, rec


@pytest.fixture(scope="module", params=sorted(FILTERS))
def case(request, fixture):
    """(prefix, the port's run, the JAX run's arrays) for one filter."""
    p = request.param
    ref = {k[len(p) + 1:]: v for k, v in fixture.items() if k.startswith(p + "_")}
    return p, run(fixture["frames"], FILTERS[p]), ref


def scale_ratio(sess, ref) -> float:
    """t_jax ≈ k · t_port."""
    return float(ref["map_scale"]) / sess.map_scale


def test_mode_after_every_frame_matches_jax(case):
    p, (out, rec), ref = case
    np.testing.assert_array_equal(rec["modes"], ref["mode"][:WINDOW])
    assert out["transitions"]["TRACKING"] == EXPECTED[p][1]
    assert out["final_mode"] == "TRACKING"


def test_frames_match_jax(case):
    _, (out, _), ref = case
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


def test_maps_after_each_event_match_jax(case):
    _, (_, rec), ref = case
    events = ref["ev_frame_id"]
    assert len(rec["maps"]) == int(np.sum(events < WINDOW)) > 0
    for j, m in enumerate(rec["maps"]):
        for name in ("kf_valid", "mp_valid", "kf_assoc", "kf_member"):
            np.testing.assert_array_equal(getattr(m, name).numpy(), ref[f"ev{j}_{name}"],
                                          err_msg=f"event {j} (frame {events[j]})")


def test_metric_scale_matches_jax(case):
    p, (out, _), ref = case
    want = float(ref["metric_scale"][WINDOW - 1])
    if p == "f3":
        # the 3DoF filter estimates attitude only
        assert out["metric_scale"] is None and np.isnan(ref["metric_scale"][:WINDOW]).all()
        return
    k = scale_ratio(out["session"], ref)
    # metres per map unit: the port's map unit is 1/k of JAX's
    assert abs(out["metric_scale"] / k - want) <= METRIC_SCALE_RTOL * want, \
        (out["metric_scale"], k, want)


def test_priors_and_covariances_match_jax(case):
    p, (out, rec), ref = case
    k = scale_ratio(out["session"], ref)
    first = EXPECTED[p][0]
    assert sorted(rec["priors"]) == np.flatnonzero(ref["prior_valid"][:WINDOW]).tolist() \
        == list(range(first, WINDOW))
    for i, (R, t) in rec["priors"].items():
        err = max(np.abs(R - ref["prior_R"][i]).max(), np.abs(t * k - ref["prior_t"][i]).max())
        assert err <= POSE_ATOL, (i, err)
    vi_frames = np.flatnonzero(ref["cov_ok"][:WINDOW] >= 0).tolist()
    assert sorted(rec["covs"]) == vi_frames == list(range(first, WINDOW))
    D = np.diag([k, k, k, 1.0, 1.0, 1.0])        # [rho, phi] in JAX's map units
    for i, (c, ok) in rec["covs"].items():
        assert ok == bool(ref["cov_ok"][i]), i
        want = ref["cov"][i]
        err = np.abs(D @ c @ D - want).max() / np.abs(want).max()
        assert err <= COV_ATOL, (i, err)


def test_filter_state_matches_jax(case):
    _, (_, rec), ref = case
    for i, (q, p, v, bg, ba, P) in enumerate(rec["states"]):
        assert np.abs(q.numpy() - ref["ekf_q"][i]).max() <= EKF_Q_ATOL, i
        for name, x in (("p", p), ("v", v), ("bg", bg), ("ba", ba)):
            assert np.abs(x.numpy() - ref[f"ekf_{name}"][i]).max() <= EKF_ATOL, (i, name)
