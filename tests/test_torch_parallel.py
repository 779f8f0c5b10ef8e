"""The port's parallel package (mageslam_tpu_torch/parallel) against the JAX
package's on the virtual 8-device CPU mesh, through
tests/data/torch_port_parallel.npz (`python tools/export_jax_state.py
parallel`): meshes here repeat the CPU device, as the reference's tests
use virtual devices.

- The sharded guided matcher at tests/test_parallel.py's size (512, 128)
  and at the budgets' (8192, 512), over 1, 2 and 8 shards, exactly equal
  to JAX's answer over 8; `local_best_plain` exactly equal to the plain
  per-target loop of tests/test_parallel.py:14-34.
- One sharded LM iteration on tests/test_parallel.py's problem against
  JAX's dense iteration and the port's (the same accept, cost rtol 1e-3,
  points atol 5e-3, poses 1e-3: tests/test_parallel.py:188-196), and
  against JAX's sharded one on accept, cost and points; four chained
  iterations do not raise the cost and follow JAX's costs.
- The sharded global-BA step at the budgets' window over 4 shards against
  the dense step and JAX's two, at tests/test_global_ba_capacity.py's
  tolerances.
- The batched track step over 8 sessions at 640x480 (golden settings):
  poses within 1e-3, `succeeded` equal, tracked counts within 3.
- The session's sharded global BA (`enable_sharded_global_ba`,
  `parallel.mesh_devices` replaced by 4 CPU devices) closing
  tests/test_loop_closure.py's scene `a`: masks equal to the dense
  branch's and JAX's, points and centers within 1e-4 after one similarity
  (the global BA's gauge is free).
"""

import torch_threads  # noqa: F401  (first: torch's OpenMP threads wait passively)

import os
import sys

import numpy as np
import pytest
import torch

from mageslam_tpu_torch import SlamSession, golden_path_settings, parallel
from mageslam_tpu_torch.apps.evaluate import umeyama_align
from mageslam_tpu_torch.ba.problem import BAProblem, BAState
from mageslam_tpu_torch.ba.schur import lm_iteration
from mageslam_tpu_torch.bow.index import BowIndex
from mageslam_tpu_torch.interop import unflatten
from mageslam_tpu_torch.ops.hamming import hamming_matrix_plain
from mageslam_tpu_torch.ops.local_best import BIG, local_best_plain
from mageslam_tpu_torch.parallel import (batched_track_step, make_session_mesh,
                                         make_sharded_guided_matcher,
                                         make_sharded_lm_iteration)
from mageslam_tpu_torch.runtime.loop_closure import detect_loop
from mageslam_tpu_torch.tracking.frame_state import TrackedFrame, TrackingHistory
from mageslam_tpu_torch.worldmap.map_state import MapState

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_parallel.npz")
LOOP = os.path.join(REPO, "tests", "data", "torch_port_loop.npz")
MATCH_SIZES = {"small": (512, 128), "full": (8192, 512)}
GATES = (12.0, 45, 8)
BATCH = 8
MASKS = ("kf_valid", "mp_valid", "kf_assoc", "kf_member")
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def ref():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


def mesh(d: int, name: str = "model"):
    return make_session_mesh(["cpu"] * d, name)


def matcher_case(P: int, N: int, seed: int = 0) -> list[torch.Tensor]:
    """tests/test_parallel.py:44-51's case at (P, N), as the export builds it."""
    rng = np.random.RandomState(seed)
    q_desc = rng.randint(0, 2**31, (P, 8)).astype(np.uint32)
    t_desc = rng.randint(0, 2**31, (N, 8)).astype(np.uint32)
    t_desc[:64] = q_desc[100:164]
    q_xy = rng.uniform(0, 300, (P, 2)).astype(np.float32)
    t_xy = q_xy[100:100 + N].copy()
    q_valid = rng.rand(P) > 0.1
    t_valid = np.ones((N,), bool)
    return [torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)
            for a in (q_desc, q_xy, q_valid, t_desc, t_xy, t_valid)]


@pytest.mark.parametrize("d", [1, 2, 8])
@pytest.mark.parametrize("size", ["small", "full"])
def test_sharded_matcher_equals_jax(ref, size, d):
    args = matcher_case(*MATCH_SIZES[size])
    got = make_sharded_guided_matcher(mesh(d))(*args, *GATES)
    want = ref[f"mt_{size}_d8"]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum() >= 32         # real matches found


# the plain version's cases: tests/test_parallel.py's size, then the list
# the card holds local_best.cu to (chip_smoke.py phase 3)
LOCAL_BEST_CASES = [("small 512x128", [a.numpy() for a in matcher_case(*MATCH_SIZES["small"])],
                     *GATES[:2])] + chip_smoke.local_best_cases(np.random.RandomState(15))


@pytest.mark.parametrize("case", range(len(LOCAL_BEST_CASES)),
                         ids=[c[0] for c in LOCAL_BEST_CASES])
def test_local_best_plain_equals_the_per_target_loop(case):
    """The reference's oracle (tests/test_parallel.py:14-34), per target:
    argmin over the gated column, the second-best with that row set to BIG."""
    name, arrays, radius, max_h = LOCAL_BEST_CASES[case]
    q_desc, q_xy, q_valid, t_desc, t_xy, t_valid = (torch.from_numpy(np.array(a))
                                                    for a in arrays)
    best, best_q, second = local_best_plain(q_desc, q_xy, q_valid, t_desc, t_xy, t_valid,
                                            radius, max_h)
    d = hamming_matrix_plain(q_desc, t_desc).numpy().astype(np.float64)
    with np.errstate(invalid="ignore"):       # inf - inf: NaN, outside every box
        dx = np.abs(q_xy.numpy()[:, None, 0] - t_xy.numpy()[None, :, 0])
        dy = np.abs(q_xy.numpy()[:, None, 1] - t_xy.numpy()[None, :, 1])
        r = np.float32(radius)
        ok = (dx <= r) & (dy <= r) & q_valid.numpy()[:, None] & t_valid.numpy()[None]
    d = np.where(ok & (d <= max_h), d, float(BIG))
    want = np.zeros((3, d.shape[1]), np.int64)
    for j in range(d.shape[1]):
        col = d[:, j]
        i = int(np.argmin(col))
        col2 = col.copy()
        col2[i] = float(BIG)
        want[:, j] = (int(col[i]), i, int(col2.min()))
    for part, got, w in zip(("best", "best_q", "second"), (best, best_q, second), want):
        assert got.dtype in (torch.int32, torch.int64), part
        np.testing.assert_array_equal(got.numpy(), w, err_msg=f"{name}: {part}")
    if name.startswith(("small", "path")):
        assert (best < BIG).sum() >= 32         # real matches found


def lm_problem(ref):
    return (unflatten(BAProblem, "lm_p", ref, "cpu")._replace(points_fixed=False),
            unflatten(BAState, "lm_st", ref, "cpu"))


def assert_lm_close(got, state: BAState, cost, accepted):
    assert bool(got.accepted) == bool(accepted)
    np.testing.assert_allclose(float(got.cost), float(cost), rtol=1e-3)
    np.testing.assert_allclose(got.state.points.numpy(), state.points.numpy(), atol=5e-3)
    np.testing.assert_allclose(got.state.poses.t.numpy(), state.poses.t.numpy(), atol=1e-3)
    np.testing.assert_allclose(got.state.poses.R.numpy(), state.poses.R.numpy(), atol=1e-3)


def test_sharded_lm_iteration_equals_jax_and_the_dense_iteration(ref):
    """The reference holds its sharded iteration against its dense one
    (tests/test_parallel.py:188-196); the port's is held against both dense
    iterations at those tolerances. Against JAX's sharded iteration the
    poses differ by up to 1.64e-3: S = H_cc - sum Y W^T cancels to 1.2e-4
    relative in float32, and each package's step lies ~1e-3 from the
    float64 solution (ROADMAP queue 3); accept, cost and points hold."""
    p, st = lm_problem(ref)
    got = make_sharded_lm_iteration(mesh(8))(p, st, 1.5)
    assert_lm_close(got, unflatten(BAState, "lmd_st", ref, "cpu"), ref["lmd_cost"],
                    ref["lmd_accepted"])
    dense = lm_iteration(p, st, 1.5)
    assert_lm_close(got, dense.state, dense.cost, dense.accepted)
    jax_sharded = unflatten(BAState, "lm1_st", ref, "cpu")
    assert bool(got.accepted) == bool(ref["lm1_accepted"])
    np.testing.assert_allclose(float(got.cost), float(ref["lm1_cost"]), rtol=1e-3)
    np.testing.assert_allclose(got.state.points.numpy(), jax_sharded.points.numpy(), atol=5e-3)


def test_sharded_lm_iterations_converge(ref):
    p, st = lm_problem(ref)
    it = make_sharded_lm_iteration(mesh(8))
    costs = []
    for _ in range(4):
        res = it(p, st, 1.5)
        st = res.state
        costs.append(float(res.cost))
    assert costs[-1] <= costs[0]
    assert np.isfinite(st.points.numpy()).all()
    np.testing.assert_allclose(costs, ref["lm4_costs"], rtol=1e-3)


def test_sharded_step_matches_dense_at_capacity(ref):
    """tests/test_global_ba_capacity.py's full-budget window (K = 256, P =
    8192, O = 16,384): the sharded step over 4 shards against the port's
    dense step and JAX's dense and sharded steps, at that test's
    tolerances (mse rtol 1e-3; poses.t and points rtol 1e-3, atol 1e-4; at
    most 5 outlier flags differing)."""
    from mageslam_tpu_torch.ba.step import step_bundle_adjust
    from mageslam_tpu_torch.parallel import make_sharded_step_bundle_adjust

    p = unflatten(BAProblem, "cap_p", ref, "cpu")._replace(points_fixed=False)
    st = BAState.from_problem(p)
    args = ([float(w) for w in ref["cap_widths"]], float(ref["cap_max_error_sq"]))
    got = make_sharded_step_bundle_adjust(mesh(4))(p, st, *args)
    wants = [step_bundle_adjust(p, st, *args)]
    wants += [(unflatten(BAState, f"cap_{k}_st", ref, "cpu"), torch.from_numpy(
        ref[f"cap_{k}_mse"]), torch.from_numpy(ref[f"cap_{k}_out"])) for k in ("dense", "sharded")]
    for st_w, mse_w, out_w in wants:
        np.testing.assert_allclose(float(got[1]), float(mse_w), rtol=1e-3)
        np.testing.assert_allclose(got[0].poses.t.numpy(), st_w.poses.t.numpy(), rtol=1e-3,
                                   atol=1e-4)
        np.testing.assert_allclose(got[0].points.numpy(), st_w.points.numpy(), rtol=1e-3,
                                   atol=1e-4)
        assert int((got[2] != out_w).sum()) <= 5


def batch_inputs(ref) -> list:
    """Session b's map (the leaves that differ from session 0's stored for
    b > 0), history and frame, stacked."""
    maps, hists, frames = [], [], []
    for b in range(BATCH):
        leaves = {f"m{i}": ref.get(f"bt{b}_map{i}", ref[f"bt0_map{i}"])
                  for i in range(sum(1 for k in ref if k.startswith("bt0_map")))}
        maps.append(unflatten(MapState, "m", leaves, "cpu"))
        hists.append(unflatten(TrackingHistory, f"bt{b}_hist", ref, "cpu"))
        frames.append(unflatten(TrackedFrame, f"bt{b}_frame", ref, "cpu"))
    return [parallel.tree_stack(t) for t in (maps, hists, frames)]


def test_batched_track_step_equals_jax(ref):
    step, shard = batched_track_step(mesh(BATCH, "sessions"), golden_path_settings(),
                                     640.0, 480.0)
    out = step(*(shard(t) for t in batch_inputs(ref)))
    assert out.frame.pose.t.shape == (BATCH, 3)
    np.testing.assert_array_equal(out.succeeded.numpy(), ref["bt_succeeded"])
    assert ref["bt_succeeded"].all()
    np.testing.assert_allclose(out.frame.pose.R.numpy(), ref["bt_R"], atol=1e-3)
    np.testing.assert_allclose(out.frame.pose.t.numpy(), ref["bt_t"], atol=1e-3)
    assert np.abs(out.tracked_count.numpy() - ref["bt_tracked"]).max() <= 3


def _aligned_error(got: MapState, want: MapState) -> float:
    kv, pv = want.kf_valid.numpy(), want.mp_valid.numpy()
    src = np.concatenate([got.kf_pose.center().numpy()[kv], got.mp_pos.numpy()[pv]])
    dst = np.concatenate([want.kf_pose.center().numpy()[kv], want.mp_pos.numpy()[pv]])
    s, R, t = umeyama_align(src.astype(np.float64), dst.astype(np.float64))
    return float(np.abs((s * (R @ src.T)).T + t - dst).max())


def test_session_sharded_global_ba_closes_as_the_dense_branch(monkeypatch):
    with np.load(LOOP) as z:
        loop = {k: z[k] for k in z.files}
    m = unflatten(MapState, "a_map", loop, "cpu")
    bow = unflatten(BowIndex, "a_bow", loop, "cpu")
    frame = unflatten(TrackedFrame, "a_frame", loop, "cpu")
    det, live, qualified = detect_loop(m, bow, frame, 5, lambda: torch.from_numpy(
        loop["a_draws"]), min_keyframes=5, min_cluster_size=2)
    assert live and qualified and bool(det.detected)
    monkeypatch.setattr(parallel, "mesh_devices", lambda device: [torch.device("cpu")] * 4)
    maps = {}
    for sharded in (False, True):
        sess = SlamSession(golden_path_settings(), loop["cam"], 320, 180, device="cpu")
        sess.enable_sharded_global_ba = sharded
        sess.map, sess.last_kf_slot = m, 5
        assert sess._apply_loop_closure(det, frame, 5)
        assert (sess._sharded_ba_step[1] is not None) == sharded
        assert sess._sharded_ba_step[0] == (sharded, 4)
        maps[sharded] = sess.map
    # auto: a CPU session keeps the dense step even with several devices
    sess.enable_sharded_global_ba = None
    assert sess._global_ba_step_fn() is None
    want = unflatten(MapState, "a_gba", loop, "cpu")
    for f in MASKS:
        assert torch.equal(getattr(maps[True], f), getattr(maps[False], f)), f
        assert torch.equal(getattr(maps[True], f), getattr(want, f)), f
    assert _aligned_error(maps[True], maps[False]) < 1e-4
    assert _aligned_error(maps[True], want) < 1e-4
    np.testing.assert_allclose(maps[True].mp_pos.numpy(), want.mp_pos.numpy(), atol=1e-2)
