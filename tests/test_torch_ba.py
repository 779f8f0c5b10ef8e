"""The port's bundle adjustment (ba/residuals, schur, step; worldmap/ba_window)
against the JAX package on seeded numpy problems. The problems are built by
the JAX package (a window of the small scene of tests/test_torch_worldmap.py,
or a synthetic problem with tethers) and cross as numpy arrays.

Tolerances: residuals and Jacobians atol 1e-4 relative to pixel-scale values
of up to a few hundred; the normal equations agree to a relative 1e-5 of
their largest block (float32 sums in another order: `ops/indexing.add_at_`
against XLA's scatter-add); `add_at_` itself sums in index order, bit for
bit as a sequential loop, and the same on every call; one damped solve agrees to atol 2e-4 on steps of up to
0.1; poses after LM steps agree to atol 1e-4 and points to 1e-4, or 5e-4
after four and more steps (a relative 1e-4 of depths of 4 to 7 units, the
direction a 1.4-unit baseline constrains least); outlier masks and every
integer output are equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mageslam_tpu.ba import problem as jproblem
from mageslam_tpu.ba import residuals as jres
from mageslam_tpu.ba import schur as jschur
from mageslam_tpu.ba import step as jstep
from mageslam_tpu.geometry.se3 import Pose as JPose
from mageslam_tpu.geometry.se3 import exp_so3 as jexp_so3
from mageslam_tpu.geometry.se3 import retract as jretract
from mageslam_tpu.worldmap import ba_window as jwin
from mageslam_tpu.worldmap import member_index as jmi
from mageslam_tpu_torch import interop
from mageslam_tpu_torch.ba import problem, residuals, schur, step
from mageslam_tpu_torch.worldmap import ba_window
from test_torch_worldmap import LEVELS, SCALE, T, assert_same, build_scene, to_torch

# the suite runs several worker processes on few cores: a small thread pool
# each costs less than the default of one thread a core
torch.set_num_threads(2)


def problem_to_torch(p) -> problem.BAProblem:
    leaves = {f"s{i}": np.asarray(x) for i, x in enumerate(jax.tree.flatten(p[:-1])[0])}
    fields = interop.unflatten(problem.BAProblem, "s", leaves, "cpu")
    return fields._replace(points_fixed=bool(p.points_fixed))


def close(got, want, atol, name=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol, err_msg=name)


def perturbed_scene(seed=0, noise=0.0):
    """The small scene with keyframe 4's pose and every point knocked off
    the truth, and `noise` pixels on the observations. Keyframes 0 and 1 are
    fixed, which pins the scale: with one fixed camera the monocular problem
    keeps a gauge direction along which two float32 solvers drift apart."""
    m, _, _ = build_scene(seed)
    m = m._replace(kf_fixed=m.kf_fixed.at[1].set(True))
    rng = np.random.RandomState(seed + 100)
    bad = jretract(JPose(m.kf_pose.R[4], m.kf_pose.t[4]),
                   jnp.asarray([0.02, -0.01, 0.015, 0.008, -0.006, 0.004], jnp.float32))
    return m._replace(
        kf_pose=JPose(m.kf_pose.R.at[4].set(bad.R), m.kf_pose.t.at[4].set(bad.t)),
        mp_pos=m.mp_pos + jnp.asarray(rng.randn(*m.mp_pos.shape).astype(np.float32) * 0.01),
        kf_kp_xy=m.kf_kp_xy + jnp.asarray(
            rng.randn(*m.kf_kp_xy.shape).astype(np.float32) * noise))


WINDOW_KW = dict(max_cams=8, max_points=128, max_obs=256, theta0=5, theta_min=5,
                 upper_connections=2000, lower_connections=50)


@pytest.fixture(scope="module")
def window():
    m = perturbed_scene(noise=0.3)
    w = jwin.build_local_ba_window(m, jnp.int32(4), **WINDOW_KW)
    return {"map": m, "jax": w, "problem": problem_to_torch(w.problem)}


def tether_problem(seed=0, K=6, Pn=40, O=160, Tn=5):
    """A synthetic problem with all three tether kinds (and one invalid)."""
    rng = np.random.RandomState(seed)
    p = jproblem.empty_problem(K, Pn, O, n_tethers=Tn)
    R = np.asarray(jexp_so3(jnp.asarray(rng.randn(K, 3).astype(np.float32) * 0.05)))
    t = np.concatenate([rng.randn(K, 2) * 0.4, np.zeros((K, 1))], 1).astype(np.float32)
    pts = np.stack([rng.uniform(-1, 1, Pn), rng.uniform(-1, 1, Pn), rng.uniform(4, 7, Pn)],
                   1).astype(np.float32)
    oc, op = rng.randint(0, K, O).astype(np.int32), rng.randint(0, Pn, O).astype(np.int32)
    Xc = np.einsum("oij,oj->oi", R[oc], pts[op]) + t[oc]
    uv = (300 * Xc[:, :2] / Xc[:, 2:3] + [160, 120] + rng.randn(O, 2)).astype(np.float32)
    info = np.where(rng.rand(O) < 0.9, rng.uniform(0.5, 1, O), 0).astype(np.float32)
    c1, c2 = rng.randint(0, K, Tn).astype(np.int32), rng.randint(0, K, Tn).astype(np.int32)
    c2 = np.where(c1 == c2, (c2 + 1) % K, c2).astype(np.int32)
    dR = np.asarray(jexp_so3(jnp.asarray(rng.randn(Tn, 3).astype(np.float32) * 0.1)))
    return p._replace(
        poses=JPose(jnp.asarray(R), jnp.asarray(t)),
        intrinsics=jnp.tile(jnp.asarray([[300.0, 300.0, 160.0, 120.0]]), (K, 1)),
        cam_fixed=jnp.arange(K) < 2, cam_valid=jnp.arange(K) < K - 1,
        points=jnp.asarray(pts), pt_valid=jnp.arange(Pn) < Pn - 2,
        obs_cam=jnp.asarray(oc), obs_pt=jnp.asarray(op), obs_uv=jnp.asarray(uv),
        obs_info=jnp.asarray(info),
        tether_kind=jnp.asarray(np.arange(Tn) % 3, jnp.int32),
        tether_cam1=jnp.asarray(c1), tether_cam2=jnp.asarray(c2),
        tether_pose=JPose(jnp.asarray(dR), jnp.asarray(rng.randn(Tn, 3).astype(np.float32) * 0.3)),
        tether_distance=jnp.asarray(rng.uniform(0.2, 1, Tn).astype(np.float32)),
        tether_weight=jnp.asarray(np.where(np.arange(Tn) == Tn - 1, 0, 2.0).astype(np.float32)))


@pytest.fixture(scope="module")
def tethered():
    p = tether_problem()
    return {"jax": p, "torch": problem_to_torch(p)}


def both(fixture):
    if "problem" in fixture:
        return fixture["jax"].problem, fixture["problem"]
    return fixture["jax"], fixture["torch"]


# ---- residuals ----------------------------------------------------------- #
@pytest.mark.parametrize("which", ["window", "tethered"])
@pytest.mark.parametrize("huber", [0.0, 1.5])
def test_observation_residuals(request, which, huber):
    jp, tp = both(request.getfixturevalue(which))
    got = residuals.observation_residuals(tp, tp.poses, tp.points, tp.obs_info, huber)
    want = jres.observation_residuals(jp, jp.poses, jp.points, jp.obs_info,
                                      jnp.float32(huber))
    for name in got._fields:
        # Jacobian entries reach a few hundred: 1e-4 is a relative 1e-6
        close(getattr(got, name), getattr(want, name), 1e-4, name)
    np.testing.assert_array_equal(residuals.behind_camera(got).numpy(),
                                  np.asarray(jres.behind_camera(want)))
    cost = residuals.robust_cost(got.chi2, huber, got.w)
    jcost = jres.robust_cost(want.chi2, jnp.float32(huber), want.w)
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-5)
    uv, Xc = residuals.project_obs(tp.poses, tp.intrinsics, tp.points, tp.obs_cam, tp.obs_pt)
    juv, jXc = jres.project_obs(jp.poses, jp.intrinsics, jp.points, jp.obs_cam, jp.obs_pt)
    close(uv, juv, 1e-4)
    close(Xc, jXc, 1e-5)


def test_tether_residuals(tethered):
    jp, tp = both(tethered)
    got = residuals.tether_residuals(tp, tp.poses)
    want = jres.tether_residuals(jp, jp.poses)
    for name in got._fields:
        close(getattr(got, name), getattr(want, name), 1e-5, name)
    assert float(got.chi2.sum()) > 0 and float(got.w[-1]) == 0
    no_jac = residuals.tether_residuals(tp, tp.poses, jacobians=False)
    torch.testing.assert_close(no_jac.chi2, got.chi2)
    assert not no_jac.Jc1.any()
    empty = residuals.tether_residuals(problem.empty_problem(2, 2, 2, n_tethers=0), tp.poses)
    assert empty.r.shape == (0, 6) and empty.Jc1.shape == (0, 6, 6)


# ---- normal equations and the solve -------------------------------------- #
def _equations(fixture, huber=1.5):
    jp, tp = both(fixture)
    tobs = residuals.observation_residuals(tp, tp.poses, tp.points, tp.obs_info, huber)
    jobs = jres.observation_residuals(jp, jp.poses, jp.points, jp.obs_info, jnp.float32(huber))
    teq = schur.build_normal_equations(tp, tobs, residuals.tether_residuals(tp, tp.poses))
    jeq = jschur.build_normal_equations(jp, jobs, jres.tether_residuals(jp, jp.poses))
    return jp, tp, jeq, teq


@pytest.mark.parametrize("which", ["window", "tethered"])
def test_normal_equations(request, which):
    _, _, jeq, teq = _equations(request.getfixturevalue(which))
    for name in teq._fields:
        want = np.asarray(getattr(jeq, name))
        close(getattr(teq, name), want, 1e-5 * max(np.abs(want).max(), 1.0), name)
    assert float(teq.H_cc.abs().max()) > 1e3


@pytest.mark.parametrize("rest", [(), (6, 3)])
def test_add_at_sums_in_index_order(rest):
    """The normal equations' scatter-add on the CPU: duplicates summed one
    after another in index order (a float32 loop, bit for bit), negative
    indices wrapped as `index_put_` wraps them, and the same bits on every
    call (`index_put_(accumulate=True)` adds from parallel threads there)."""
    from mageslam_tpu_torch.ops.indexing import add_at_

    rng = np.random.RandomState(3)
    rows = rng.randint(-4, 4, 5000)
    cols = rng.randint(0, 7, 5000)
    vals = (rng.standard_normal((5000,) + rest) * 10.0 ** rng.randint(-3, 4, (5000,) + rest)
            ).astype(np.float32)
    want = np.zeros((4, 7) + rest, np.float32)
    for r, c, v in zip(rows, cols, vals):
        want[r, c] += v
    args = ((torch.from_numpy(rows), torch.from_numpy(cols)), torch.from_numpy(vals))
    for _ in range(3):
        got = add_at_(torch.zeros((4, 7) + rest), *args)
        np.testing.assert_array_equal(got.numpy(), want)
    close(torch.zeros((4, 7) + rest).index_put_(*args, accumulate=True), want,
          1e-5 * np.abs(want).max())


def test_points_fixed_zeroes_the_point_blocks(window):
    jp, tp = both(window)
    tp = tp._replace(points_fixed=True)
    obs = residuals.observation_residuals(tp, tp.poses, tp.points, tp.obs_info, 0.0)
    eq = schur.build_normal_equations(tp, obs, residuals.tether_residuals(tp, tp.poses))
    assert not eq.V.any() and not eq.Wc.any() and not eq.g_p.any() and eq.H_cc.any()


@pytest.mark.parametrize("which", ["window", "tethered"])
@pytest.mark.parametrize("lam", [1.0, 10.0])
def test_solve_lm_system(request, which, lam):
    # lambda as the LM loop sets it, 1e-5 of the largest diagonal entry (1e5
    # to 1e6 here) and its first updates. Far below that, S = H_cc - W V^-1
    # W^T cancels in float32 and no two solvers agree.
    jp, tp, jeq, _ = _equations(request.getfixturevalue(which))
    # the same equations on both sides: the solve alone
    teq = schur.NormalEquations(*(T(x) for x in jeq))
    dx_c, dx_p = schur.solve_lm_system(tp, teq, torch.tensor(lam))
    jdx_c, jdx_p = jschur.solve_lm_system(jp, jeq, jnp.float32(lam))
    close(dx_c, jdx_c, 2e-4, "dx_c")
    close(dx_p, jdx_p, 2e-4, "dx_p")
    frozen = np.asarray(jp.cam_fixed | ~jp.cam_valid)
    assert not dx_c[torch.from_numpy(frozen)].any() and dx_c.any()


def test_solve_takes_the_lu_path_when_cholesky_fails(window):
    jp, tp, jeq, _ = _equations(window)
    # a negative damping makes S indefinite: Cholesky fails, LU answers
    teq = schur.NormalEquations(*(T(x) for x in jeq))
    dx_c, dx_p = schur.solve_lm_system(tp, teq, torch.tensor(-50.0))
    assert torch.isfinite(dx_c).all() and torch.isfinite(dx_p).all()
    jdx_c, _ = jschur.solve_lm_system(jp, jeq, jnp.float32(-50.0))
    scale = max(float(jnp.abs(jdx_c).max()), 1.0)
    close(dx_c, jdx_c, 2e-3 * scale, "dx_c")


def _states(jp, tp, lam=-1.0):
    return jproblem.BAState.from_problem(jp, lam), problem.BAState.from_problem(tp, lam)


@pytest.mark.parametrize("which", ["window", "tethered"])
def test_lm_iteration(request, which):
    jp, tp = both(request.getfixturevalue(which))
    jst, tst = _states(jp, tp)
    for huber in (1.5, 0.0):                       # the second starts from lambda > 0
        jr = jschur.lm_iteration(jp, jst, jnp.float32(huber))
        tr = schur.lm_iteration(tp, tst, huber)
        assert bool(tr.accepted) == bool(jr.accepted)
        np.testing.assert_allclose(float(tr.cost), float(jr.cost), rtol=1e-3)
        np.testing.assert_allclose(float(tr.state.lam), float(jr.state.lam), rtol=2e-2)
        assert float(tr.state.ni) == float(jr.state.ni)
        close(tr.state.poses.R, jr.state.poses.R, 1e-4)
        close(tr.state.poses.t, jr.state.poses.t, 1e-4)
        close(tr.state.points, jr.state.points, 1e-4)
        jst, tst = jr.state, tr.state


# ---- step_bundle_adjust --------------------------------------------------- #
def test_step_bundle_adjust_noiseless_scene_recovers_the_truth():
    truth, _, _ = build_scene()
    m = perturbed_scene(noise=0.0)
    # one gross outlier observation, and one point pushed behind its cameras
    m = m._replace(kf_kp_xy=m.kf_kp_xy.at[3, 0].add(25.0))
    w = jwin.build_local_ba_window(m, jnp.int32(4), **WINDOW_KW)
    jp, tp = w.problem, problem_to_torch(w.problem)
    jst, tst = _states(jp, tp)
    widths = np.float32(1.5) * np.float32(0.9) ** np.arange(4, dtype=np.float32)
    jst, jmse, jout = jstep.step_bundle_adjust(jp, jst, jnp.asarray(widths), jnp.float32(4.0))
    tst, tmse, tout = step.step_bundle_adjust(tp, tst, T(widths), 4.0)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert int(tout.sum()) == 1
    np.testing.assert_allclose(float(tmse), float(jmse), rtol=0, atol=1e-4)
    close(tst.poses.R, jst.poses.R, 1e-4)
    close(tst.poses.t, jst.poses.t, 1e-4)
    close(tst.points, jst.points, 5e-4)
    close(tst.obs_info, jst.obs_info, 0)
    # and keyframe 4 is pulled back toward the truth
    cam4 = int(np.flatnonzero(np.asarray(w.cam_slot) == 4)[0])
    before = np.abs(np.asarray(m.kf_pose.t[4]) - np.asarray(truth.kf_pose.t[4])).max()
    after = np.abs(tst.poses.t[cam4].numpy() - np.asarray(truth.kf_pose.t[4])).max()
    assert after < 0.75 * before


def test_step_accepts_a_list_of_widths(window):
    jp, tp = both(window)
    _, tst = _states(jp, tp)
    a = step.step_bundle_adjust(tp, tst, [1.5, 1.2], 9.0)
    b = step.step_bundle_adjust(tp, tst, torch.tensor([1.5, 1.2]), 9.0)
    torch.testing.assert_close(a[0].points, b[0].points)
    assert torch.equal(a[2], b[2])


def test_iterate_bundle_adjust(window):
    jp, tp = both(window)
    jst, tst = _states(jp, tp)
    kw = dict(huber_width=1.5, max_outlier_error=3.0, huber_width_scale=0.9,
              max_outlier_error_scale=0.9, min_mean_square_error=1e-9, num_steps=4,
              steps_per_run=2, min_steps=2)
    jst, jmse, jsteps, jout = jstep.iterate_bundle_adjust(jp, jst, **kw)
    tst, tmse, tsteps, tout = step.iterate_bundle_adjust(tp, tst, **kw)
    assert tsteps == jsteps == 4
    np.testing.assert_allclose(tmse, jmse, rtol=1e-3)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    close(tst.points, jst.points, 5e-4)
    close(tst.poses.t, jst.poses.t, 5e-4)      # four steps on 0.3 px of noise


# ---- window build and write-back ----------------------------------------- #
WINDOW_FIELDS = ("cam_slot", "pt_slot", "obs_kf", "obs_feat", "theta")


def assert_window_equal(got, want):
    for f in WINDOW_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
    jp, tp = want.problem, got.problem
    for f in jp._fields[:-1]:
        a, b = getattr(tp, f), getattr(jp, f)
        for x, y in (zip(a, b) if isinstance(b, JPose) else [(a, b)]):
            assert x.numpy().dtype == np.asarray(y).dtype, f
            np.testing.assert_array_equal(x.numpy(), np.asarray(y), f)


@pytest.mark.parametrize("kw", [
    {},                                              # the whole covisible set fits
    {"max_cams": 3, "max_points": 50, "max_obs": 90},   # every bank overflows
    {"upper_connections": 120, "theta_step": 10, "theta_max_steps": 2},   # theta walks up
    {"theta0": 40, "lower_connections": 150, "theta_step": 10, "theta_max_steps": 2},  # down
    {"global_window": True},
])
def test_build_local_ba_window(window, kw):
    m = window["map"]
    args = {**WINDOW_KW, **kw}
    want = jwin.build_local_ba_window(m, jnp.int32(4), **args)
    got = ba_window.build_local_ba_window(to_torch(m), torch.tensor(4), **args)
    assert_window_equal(got, want)
    member = jmi.build_fidx(m) >= 0
    again = ba_window.build_local_ba_window(to_torch(m), torch.tensor(4), member=T(member),
                                            **args)
    assert_window_equal(again, want)
    assert int(got.problem.cam_valid.sum()) >= 2


def test_window_without_tethers_is_the_same_problem(window):
    m = to_torch(window["map"])
    full = ba_window.build_local_ba_window(m, torch.tensor(4), **WINDOW_KW)
    p = full.problem
    assert p.tether_weight.shape == m.tether_weight.shape and not p.tether_weight.any()
    bare = full._replace(problem=problem.without_tethers(p))
    assert bare.problem.tether_weight.shape == (0,) and bare.problem.obs_uv is p.obs_uv
    a = step.step_bundle_adjust(full.problem, problem.BAState.from_problem(full.problem),
                                [1.5, 1.2], 9.0)
    b = step.step_bundle_adjust(bare.problem, problem.BAState.from_problem(bare.problem),
                                [1.5, 1.2], 9.0)
    assert torch.equal(a[0].points, b[0].points) and torch.equal(a[0].poses.t, b[0].poses.t)
    assert torch.equal(a[2], b[2])


@pytest.mark.parametrize("with_fidx", [False, True])
def test_apply_ba_results(window, with_fidx):
    m, w = window["map"], window["jax"]
    jst = jproblem.BAState.from_problem(w.problem)
    jst, _, jout = jstep.step_bundle_adjust(w.problem, jst, jnp.asarray([1.5, 1.2]),
                                            jnp.float32(1.0))
    # the same optimized values on both sides: the write-back alone; enough
    # outliers that some points fall under two observers
    out = np.asarray(jout) | (np.random.RandomState(0).rand(len(jout)) < 0.45)
    jf = jmi.build_fidx(m) if with_fidx else None
    want = jwin.apply_ba_results(m, w, jst.poses, jst.points, jnp.asarray(out), LEVELS, SCALE,
                                 fidx=jf)
    tw = ba_window.build_local_ba_window(to_torch(m), torch.tensor(4), **WINDOW_KW)
    tposes = type(tw.problem.poses)(T(jst.poses.R), T(jst.poses.t))
    got = ba_window.apply_ba_results(to_torch(m), tw, tposes, T(jst.points), T(out), LEVELS,
                                     SCALE, fidx=T(jf) if with_fidx else None)
    if with_fidx:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        got, want = got[0], want[0]
    assert_same(got, want)
    assert int(got.mp_valid.sum()) < int(np.asarray(m.mp_valid).sum())
    assert int(got.mp_refine_count.sum()) > int(np.asarray(m.mp_refine_count).sum())
