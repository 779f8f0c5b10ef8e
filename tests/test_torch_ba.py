"""The port's bundle adjustment (ba/residuals, schur, step; worldmap/ba_window)
against the JAX package on seeded problems: a window of the small scene of
tests/test_torch_worldmap.py, and a synthetic problem with tethers. The
JAX package's problems and its outputs on them are committed in
tests/data/torch_port_ba.npz (`python tools/export_jax_state.py ba`, which
computes them as this file did live: the residuals, `project_obs` and the
LM iteration jitted as the JAX pipeline runs them, the normal equations
eager apart from the jitted tether residuals, the rest eager).

Tolerances: residuals and Jacobians atol 1e-4 relative to pixel-scale values
of up to a few hundred; the normal equations agree to a relative 1e-5 of
their largest block (float32 sums in another order: `ops/indexing.add_at_`
against XLA's scatter-add); `add_at_` itself sums in index order, bit for
bit as a sequential loop, and the same on every call; one damped solve agrees to atol 2e-4 on steps of up to
0.1; poses after LM steps agree to atol 1e-4 and points to 1e-4, or 5e-4
after four and more steps (a relative 1e-4 of depths of 4 to 7 units, the
direction a 1.4-unit baseline constrains least); outlier masks and every
integer output are equal."""

import torch_threads  # noqa: F401  (first: torch's OpenMP threads wait passively)

import os

import numpy as np
import pytest
import torch

from mageslam_tpu_torch import interop
from mageslam_tpu_torch.ba import problem, residuals, schur, step
from mageslam_tpu_torch.geometry.se3 import Pose
from mageslam_tpu_torch.worldmap import ba_window
from mageslam_tpu_torch.worldmap.map_state import MapState

# the suite runs several worker processes on few cores: a small thread pool
# each costs less than the default of one thread a core
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_ba.npz")
LEVELS, SCALE = 3, 1.2       # tests/test_torch_worldmap.py's pyramid
WINDOW_KW = dict(max_cams=8, max_points=128, max_obs=256, theta0=5, theta_min=5,
                 upper_connections=2000, lower_connections=50)
WINDOW_FIELDS = ("cam_slot", "pt_slot", "obs_kf", "obs_feat", "theta")


@pytest.fixture(scope="module")
def ref():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


def T(a):
    return torch.from_numpy(np.asarray(a).copy())


def close(got, want, atol, name=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol, err_msg=name)


def stored_problem(ref, w: str) -> problem.BAProblem:
    """The JAX problem `{w}_p{i}` (and `{w}_points_fixed`) as the port's."""
    p = interop.unflatten(problem.BAProblem, f"{w}_p", ref, "cpu")
    return p._replace(points_fixed=bool(ref.get(f"{w}_points_fixed", False)))


@pytest.fixture(scope="module")
def window(ref):
    return {"map": interop.unflatten(MapState, "win_map", ref, "cpu"),
            "problem": stored_problem(ref, "win"), "name": "window"}


@pytest.fixture(scope="module")
def tethered(ref):
    return {"problem": stored_problem(ref, "teth"), "name": "tethered"}


def state_fields(ref, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in ref.items() if k.startswith(prefix + "_")}


# ---- residuals ----------------------------------------------------------- #
@pytest.mark.parametrize("which", ["window", "tethered"])
@pytest.mark.parametrize("huber", [0.0, 1.5])
def test_observation_residuals(request, ref, which, huber):
    tp = request.getfixturevalue(which)["problem"]
    pre = f"obs_{which}_{huber}"
    got = residuals.observation_residuals(tp, tp.poses, tp.points, tp.obs_info, huber)
    for name in got._fields:
        # Jacobian entries reach a few hundred: 1e-4 is a relative 1e-6
        close(getattr(got, name), ref[f"{pre}_{name}"], 1e-4, name)
    np.testing.assert_array_equal(residuals.behind_camera(got).numpy(), ref[f"{pre}_behind"])
    cost = residuals.robust_cost(got.chi2, huber, got.w)
    np.testing.assert_allclose(float(cost), float(ref[f"{pre}_cost"]), rtol=1e-5)
    uv, Xc = residuals.project_obs(tp.poses, tp.intrinsics, tp.points, tp.obs_cam, tp.obs_pt)
    close(uv, ref[f"proj_{which}_uv"], 1e-4)
    close(Xc, ref[f"proj_{which}_Xc"], 1e-5)


def test_tether_residuals(ref, tethered):
    tp = tethered["problem"]
    got = residuals.tether_residuals(tp, tp.poses)
    for name in got._fields:
        close(getattr(got, name), ref[f"teth_{name}"], 1e-5, name)
    assert float(got.chi2.sum()) > 0 and float(got.w[-1]) == 0
    no_jac = residuals.tether_residuals(tp, tp.poses, jacobians=False)
    torch.testing.assert_close(no_jac.chi2, got.chi2)
    assert not no_jac.Jc1.any()
    empty = residuals.tether_residuals(problem.empty_problem(2, 2, 2, n_tethers=0), tp.poses)
    assert empty.r.shape == (0, 6) and empty.Jc1.shape == (0, 6, 6)


# ---- normal equations and the solve -------------------------------------- #
def jax_equations(ref, which: str) -> schur.NormalEquations:
    """The JAX side's normal equations at huber 1.5 (the solves' input)."""
    return schur.NormalEquations(*(T(ref[f"eq_{which}_{f}"])
                                   for f in schur.NormalEquations._fields))


@pytest.mark.parametrize("which", ["window", "tethered"])
def test_normal_equations(request, ref, which):
    tp = request.getfixturevalue(which)["problem"]
    tobs = residuals.observation_residuals(tp, tp.poses, tp.points, tp.obs_info, 1.5)
    teq = schur.build_normal_equations(tp, tobs, residuals.tether_residuals(tp, tp.poses))
    for name in teq._fields:
        want = ref[f"eq_{which}_{name}"]
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
    tp = window["problem"]._replace(points_fixed=True)
    obs = residuals.observation_residuals(tp, tp.poses, tp.points, tp.obs_info, 0.0)
    eq = schur.build_normal_equations(tp, obs, residuals.tether_residuals(tp, tp.poses))
    assert not eq.V.any() and not eq.Wc.any() and not eq.g_p.any() and eq.H_cc.any()


@pytest.mark.parametrize("which", ["window", "tethered"])
@pytest.mark.parametrize("lam", [1.0, 10.0])
def test_solve_lm_system(request, ref, which, lam):
    # lambda as the LM loop sets it, 1e-5 of the largest diagonal entry (1e5
    # to 1e6 here) and its first updates. Far below that, S = H_cc - W V^-1
    # W^T cancels in float32 and no two solvers agree.
    tp = request.getfixturevalue(which)["problem"]
    # the same equations on both sides: the solve alone
    dx_c, dx_p = schur.solve_lm_system(tp, jax_equations(ref, which), torch.tensor(lam))
    close(dx_c, ref[f"solve_{which}_{lam}_dx_c"], 2e-4, "dx_c")
    close(dx_p, ref[f"solve_{which}_{lam}_dx_p"], 2e-4, "dx_p")
    frozen = (tp.cam_fixed | ~tp.cam_valid).numpy()
    assert not dx_c[torch.from_numpy(frozen)].any() and dx_c.any()


def test_solve_takes_the_lu_path_when_cholesky_fails(ref, window):
    tp = window["problem"]
    # a negative damping makes S indefinite: Cholesky fails, LU answers
    dx_c, dx_p = schur.solve_lm_system(tp, jax_equations(ref, "window"), torch.tensor(-50.0))
    assert torch.isfinite(dx_c).all() and torch.isfinite(dx_p).all()
    jdx_c = ref["solve_window_-50.0_dx_c"]
    scale = max(float(np.abs(jdx_c).max()), 1.0)
    close(dx_c, jdx_c, 2e-3 * scale, "dx_c")


@pytest.mark.parametrize("which", ["window", "tethered"])
def test_lm_iteration(request, ref, which):
    tp = request.getfixturevalue(which)["problem"]
    tst = problem.BAState.from_problem(tp, -1.0)
    for j, huber in enumerate((1.5, 0.0)):       # the second starts from lambda > 0
        pre = f"lm_{which}_{j}"
        jr = state_fields(ref, f"{pre}_state")
        tr = schur.lm_iteration(tp, tst, huber)
        assert bool(tr.accepted) == bool(ref[f"{pre}_accepted"])
        np.testing.assert_allclose(float(tr.cost), float(ref[f"{pre}_cost"]), rtol=1e-3)
        np.testing.assert_allclose(float(tr.state.lam), float(jr["lam"]), rtol=2e-2)
        assert float(tr.state.ni) == float(jr["ni"])
        close(tr.state.poses.R, jr["poses.R"], 1e-4)
        close(tr.state.poses.t, jr["poses.t"], 1e-4)
        close(tr.state.points, jr["points"], 1e-4)
        tst = tr.state


# ---- step_bundle_adjust --------------------------------------------------- #
def test_step_bundle_adjust_noiseless_scene_recovers_the_truth(ref):
    tp = stored_problem(ref, "nl")
    tst = problem.BAState.from_problem(tp, -1.0)
    jst = state_fields(ref, "nl_state")
    tst, tmse, tout = step.step_bundle_adjust(tp, tst, T(ref["nl_widths"]), 4.0)
    np.testing.assert_array_equal(tout.numpy(), ref["nl_out"])
    assert int(tout.sum()) == 1
    np.testing.assert_allclose(float(tmse), float(ref["nl_mse"]), rtol=0, atol=1e-4)
    close(tst.poses.R, jst["poses.R"], 1e-4)
    close(tst.poses.t, jst["poses.t"], 1e-4)
    close(tst.points, jst["points"], 5e-4)
    close(tst.obs_info, jst["obs_info"], 0)
    # and keyframe 4 is pulled back toward the truth
    cam4 = int(np.flatnonzero(ref["nl_cam_slot"] == 4)[0])
    before = np.abs(ref["nl_before_t4"] - ref["nl_truth_t4"]).max()
    after = np.abs(tst.poses.t[cam4].numpy() - ref["nl_truth_t4"]).max()
    assert after < 0.75 * before


def test_step_accepts_a_list_of_widths(window):
    tp = window["problem"]
    tst = problem.BAState.from_problem(tp, -1.0)
    a = step.step_bundle_adjust(tp, tst, [1.5, 1.2], 9.0)
    b = step.step_bundle_adjust(tp, tst, torch.tensor([1.5, 1.2]), 9.0)
    torch.testing.assert_close(a[0].points, b[0].points)
    assert torch.equal(a[2], b[2])


def test_iterate_bundle_adjust(ref, window):
    tp = window["problem"]
    tst = problem.BAState.from_problem(tp, -1.0)
    kw = dict(huber_width=1.5, max_outlier_error=3.0, huber_width_scale=0.9,
              max_outlier_error_scale=0.9, min_mean_square_error=1e-9, num_steps=4,
              steps_per_run=2, min_steps=2)
    tst, tmse, tsteps, tout = step.iterate_bundle_adjust(tp, tst, **kw)
    jst = state_fields(ref, "it_state")
    assert tsteps == int(ref["it_steps"]) == 4
    np.testing.assert_allclose(tmse, float(ref["it_mse"]), rtol=1e-3)
    np.testing.assert_array_equal(tout.numpy(), ref["it_out"])
    close(tst.points, jst["points"], 5e-4)
    close(tst.poses.t, jst["poses.t"], 5e-4)      # four steps on 0.3 px of noise


# ---- window build and write-back ----------------------------------------- #
def assert_window_equal(got, ref, w: str):
    for f in WINDOW_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), ref[f"{w}_{f}"], f)
    want = stored_problem(ref, w)
    for f in want._fields[:-1]:
        a, b = getattr(got.problem, f), getattr(want, f)
        for x, y in (zip(a, b) if isinstance(b, Pose) else [(a, b)]):
            assert x.numpy().dtype == y.numpy().dtype, f
            np.testing.assert_array_equal(x.numpy(), y.numpy(), f)


@pytest.mark.parametrize("j,kw", list(enumerate([
    {},                                              # the whole covisible set fits
    {"max_cams": 3, "max_points": 50, "max_obs": 90},   # every bank overflows
    {"upper_connections": 120, "theta_step": 10, "theta_max_steps": 2},   # theta walks up
    {"theta0": 40, "lower_connections": 150, "theta_step": 10, "theta_max_steps": 2},  # down
    {"global_window": True},
])), ids=["kw0", "kw1", "kw2", "kw3", "kw4"])
def test_build_local_ba_window(ref, window, j, kw):
    m = window["map"]
    args = {**WINDOW_KW, **kw}
    got = ba_window.build_local_ba_window(m, torch.tensor(4), **args)
    assert_window_equal(got, ref, f"kw{j}")
    member = T(ref["fidx"] >= 0)
    again = ba_window.build_local_ba_window(m, torch.tensor(4), member=member, **args)
    assert_window_equal(again, ref, f"kw{j}")
    assert int(got.problem.cam_valid.sum()) >= 2


def test_window_without_tethers_is_the_same_problem(window):
    m = window["map"]
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


def assert_same(got, ref, prefix: str, atol=1e-5):
    """Every leaf of the port's state `got` against the JAX state's leaves
    `{prefix}{i}`."""
    g = interop.to_numpy(got)
    assert f"{prefix}{len(g)}" not in ref and f"{prefix}{len(g) - 1}" in ref
    for i, (name, a) in enumerate(g.items()):
        b = ref[f"{prefix}{i}"]
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("with_fidx", [False, True])
def test_apply_ba_results(ref, window, with_fidx):
    m = window["map"]
    # the same optimized values on both sides: the write-back alone; enough
    # outliers that some points fall under two observers
    jst = state_fields(ref, "apply_state")
    out = ref["apply_out"]
    tw = ba_window.build_local_ba_window(m, torch.tensor(4), **WINDOW_KW)
    tposes = Pose(T(jst["poses.R"]), T(jst["poses.t"]))
    got = ba_window.apply_ba_results(m, tw, tposes, T(jst["points"]), T(out), LEVELS,
                                     SCALE, fidx=T(ref["fidx"]) if with_fidx else None)
    if with_fidx:
        np.testing.assert_array_equal(got[1].numpy(), ref["apply1_fidx"])
        got = got[0]
    assert_same(got, ref, f"apply{int(with_fidx)}_map")
    assert int(got.mp_valid.sum()) < int(m.mp_valid.sum())
    assert int(got.mp_refine_count.sum()) > int(m.mp_refine_count.sum())
