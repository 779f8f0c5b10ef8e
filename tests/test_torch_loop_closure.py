"""The port's loop detection and closure against the JAX package's, and
the session's in-memory snapshot.

Small pieces run live against JAX on seeded inputs: label propagation,
the spanning tree, Sim(3) exp/log, the pose graph and the point merge.
Detection and closure read tests/data/torch_port_loop.npz (`python
tools/export_jax_state.py loop`): tests/test_loop_closure.py's drifted maps
(scene `a`: drift only; `b`: drift and scale 1.3 with 30 keypoints
visible), the JAX results with the relocalization's draws, the closure
with and without the essential graph, the session's global BA after it,
and the 12-keyframe circuit of test_essential_graph_distributes_drift.

Tolerances: labels, trees, masks, detection flags, clusters and
associations exact; Sim(3) and pose-graph values 1e-4 (the graph's LM in
float32 sums in another order); the closure's poses and points 1e-4 (5e-4
after the essential graph's 12 float32 LM iterations), its viewing ranges
also 1e-4 relative, its scale 1e-5. Global BA leaves the similarity gauge free (no camera is
fixed), so its result is compared after a similarity alignment, to 1e-4,
and raw to 1e-2.
"""

import torch_threads  # noqa: F401  (first: torch's OpenMP threads wait passively)

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mageslam_tpu.ba import pose_graph as jpg
from mageslam_tpu.runtime.loop_closure import _connected_components as jax_components
from mageslam_tpu.worldmap import spanning_tree as jst
from mageslam_tpu.worldmap.operations import merge_map_points as jax_merge
from mageslam_tpu_torch import SlamSession, golden_path_settings
from mageslam_tpu_torch.apps.evaluate import umeyama_align
from mageslam_tpu_torch.ba import pose_graph as pg
from mageslam_tpu_torch.bow.index import BowIndex
from mageslam_tpu_torch.geometry.se3 import Pose
from mageslam_tpu_torch.interop import to_numpy, unflatten
from mageslam_tpu_torch.runtime.draws import ReplayDraws
from mageslam_tpu_torch.runtime.global_ba import global_ba
from mageslam_tpu_torch.runtime.loop_closure import (_connected_components, close_loop,
                                                     detect_loop, essential_graph_refine)
from mageslam_tpu_torch.tracking.frame_state import TrackedFrame
from mageslam_tpu_torch.worldmap import spanning_tree as st
from mageslam_tpu_torch.worldmap.map_state import MapState, refresh_membership
from mageslam_tpu_torch.worldmap.operations import merge_map_points

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_loop.npz")
PHOTOREAL = os.path.join(REPO, "tests", "data", "torch_port_photoreal.npz")
MASKS = ("kf_valid", "mp_valid", "kf_assoc", "kf_member")
ATOL = 1e-4


@pytest.fixture(scope="module")
def ref():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


def scene(ref, s):
    return (unflatten(MapState, f"{s}_map", ref, "cpu"),
            unflatten(BowIndex, f"{s}_bow", ref, "cpu"),
            unflatten(TrackedFrame, f"{s}_frame", ref, "cpu"))


def assert_map_close(got: MapState, ref, prefix: str, atol: float = ATOL):
    want = unflatten(MapState, prefix, ref, "cpu")
    for f in MASKS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in ("kf_pose.R", "kf_pose.t", "mp_pos", "mp_dmin", "mp_dmax"):
        a, b = to_numpy(got)[f], to_numpy(want)[f]
        np.testing.assert_allclose(a, b, atol=atol, rtol=1e-4, err_msg=f)


# ---------------------------------------------------------------- pieces ----

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_connected_components_matches_jax(seed):
    rng = np.random.RandomState(seed)
    K = 24
    adj = rng.rand(K, K) < 0.08
    adj = adj | adj.T
    active = rng.rand(K) < 0.7
    want = np.asarray(jax_components(jnp.asarray(adj), jnp.asarray(active)))
    got = _connected_components(torch.from_numpy(adj), torch.from_numpy(active))
    np.testing.assert_array_equal(got.numpy(), want)


def test_connected_components_reference_case():
    """tests/test_loop_closure.py::TestComponents on the port."""
    K = 8
    adj = torch.zeros((K, K), dtype=torch.bool)
    for a, b in [(1, 2), (2, 3), (5, 6)]:
        adj[a, b] = adj[b, a] = True
    active = torch.tensor([True, True, True, True, False, True, True, False])
    labels = _connected_components(adj, active).numpy()
    assert labels[1] == labels[2] == labels[3] == 1
    assert labels[5] == labels[6] == 5 and labels[0] == 0 and labels[4] == K


@pytest.mark.parametrize("seed", [0, 1])
def test_spanning_tree_matches_jax(seed):
    rng = np.random.RandomState(seed)
    K = 16
    cv = rng.randint(0, 60, (K, K)).astype(np.int32)
    cv = np.triu(cv, 1)
    cv = cv + cv.T
    cv[rng.rand(K, K) < 0.5] = 0
    cv = np.minimum(cv, cv.T)
    valid = rng.rand(K) < 0.85
    valid[0] = True
    parent = st.spanning_tree(torch.from_numpy(cv), torch.from_numpy(valid))
    want = np.asarray(jst.spanning_tree(jnp.asarray(cv), jnp.asarray(valid)))
    np.testing.assert_array_equal(parent.numpy(), want)
    assert bool(st.tree_valid(parent, torch.from_numpy(valid))) == bool(
        jst.tree_valid(jnp.asarray(want), jnp.asarray(valid)))
    np.testing.assert_array_equal(
        st.essential_graph_edges(torch.from_numpy(cv), torch.from_numpy(valid), parent,
                                 theta=40).numpy(),
        np.asarray(jst.essential_graph_edges(jnp.asarray(cv), jnp.asarray(valid),
                                             jnp.asarray(want), theta=40)))


def _random_sim3(rng, n):
    xi = rng.normal(0, 0.3, (n, 7)).astype(np.float32)
    return xi, jpg.sim3_exp(jnp.asarray(xi)), pg.sim3_exp(torch.from_numpy(xi))


def test_sim3_exp_log_match_jax():
    rng = np.random.RandomState(0)
    xi, gj, gt = _random_sim3(rng, 32)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    np.testing.assert_allclose(pg.sim3_log(gt).numpy(), np.asarray(jpg.sim3_log(gj)),
                               atol=1e-4)
    comp = gt.compose(gt.inverse())
    np.testing.assert_allclose(comp.R.numpy(), np.broadcast_to(np.eye(3), (32, 3, 3)),
                               atol=1e-5)


def _graph(rng, K=8, E=20):
    """A pose graph around a chain with noisy relative measurements."""
    _, gj, gt = _random_sim3(rng, K)
    ei = np.concatenate([np.arange(K - 1), rng.randint(0, K, E - K + 1)]).astype(np.int32)
    ej = np.concatenate([np.arange(1, K), rng.randint(0, K, E - K + 1)]).astype(np.int32)
    ej = np.where(ej == ei, (ej + 1) % K, ej).astype(np.int32)
    noise = rng.normal(0, 0.02, (E, 7)).astype(np.float32)
    meas_j = jpg.sim3_exp(jnp.asarray(noise)).compose(
        jax.tree.map(lambda a: a[ej], gj).compose(jax.tree.map(lambda a: a[ei], gj).inverse()))
    # start from perturbed vertices
    pert = rng.normal(0, 0.05, (K, 7)).astype(np.float32)
    v_j = jpg.sim3_exp(jnp.asarray(pert)).compose(gj)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    w = rng.uniform(0.5, 2.0, E).astype(np.float32)
    jprob = jpg.PoseGraphProblem(v_j, jnp.asarray(fixed), jnp.ones(K, bool), jnp.asarray(ei),
                                 jnp.asarray(ej), meas_j, jnp.asarray(w))

    def t(x):
        return torch.from_numpy(np.array(x))
    tprob = pg.PoseGraphProblem(pg.Sim3(*(t(a) for a in v_j)), t(fixed),
                                torch.ones(K, dtype=torch.bool), t(ei), t(ej),
                                pg.Sim3(*(t(a) for a in meas_j)), t(w))
    return jprob, tprob


@pytest.mark.parametrize("seed", [0, 1])
def test_optimize_pose_graph_matches_jax(seed):
    jprob, tprob = _graph(np.random.RandomState(seed))
    want = jpg.optimize_pose_graph(jprob, iterations=8)
    got = pg.optimize_pose_graph(tprob, iterations=8)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


def test_pose_graph_jacobians_stay_float32():
    """One batched forward-mode pass gives the Jacobians in float32, and
    they agree with JAX's jacfwd."""
    jprob, tprob = _graph(np.random.RandomState(0))
    ei, ej = tprob.edge_i.long(), tprob.edge_j.long()
    r, Ji, Jj = pg.edge_jacobians(tprob.vertices.index(ei), tprob.vertices.index(ej),
                                  tprob.edge_meas)
    assert r.dtype == Ji.dtype == Jj.dtype == torch.float32
    gi = jax.tree.map(lambda a: a[jprob.edge_i], jprob.vertices)
    gj = jax.tree.map(lambda a: a[jprob.edge_j], jprob.vertices)
    z7 = jnp.zeros((ei.shape[0], 7))
    want_i = jax.vmap(jax.jacfwd(jpg._edge_residual, argnums=0))(z7, z7, gi, gj, jprob.edge_meas)
    want_j = jax.vmap(jax.jacfwd(jpg._edge_residual, argnums=1))(z7, z7, gi, gj, jprob.edge_meas)
    np.testing.assert_allclose(Ji.numpy(), np.asarray(want_i), atol=1e-4)
    np.testing.assert_allclose(Jj.numpy(), np.asarray(want_j), atol=1e-4)


def test_merge_map_points_matches_jax(ref):
    """Merge scene a's region-B points into region A's, with conflicts: a
    keyframe that already observes the destination keeps its own."""
    from mageslam_tpu.worldmap import empty_map as jax_empty_map

    m = unflatten(MapState, "a_map", ref, "cpu")
    n = int(ref["a_n_pts"])
    rng = np.random.RandomState(0)
    src = (n + rng.randint(0, n, 48)).astype(np.int32)
    dst = rng.randint(0, n, 48).astype(np.int32)
    want = rng.rand(48) < 0.8
    got = merge_map_points(m, torch.from_numpy(src), torch.from_numpy(dst),
                           torch.from_numpy(want))
    # the port's leaves are the reference's, in its flatten order
    jm = jax.tree.unflatten(jax.tree.structure(jax_empty_map(1, 1, 1)),
                            [jnp.asarray(v) for v in to_numpy(m).values()])
    out = jax_merge(jm, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(want))
    np.testing.assert_array_equal(got.kf_assoc.numpy(), np.asarray(out.kf_assoc))
    np.testing.assert_array_equal(got.mp_valid.numpy(), np.asarray(out.mp_valid))


# ----------------------------------------------------- detect and close ----

@pytest.fixture(scope="module")
def detections(ref):
    out = {}
    for s in "ab":
        m, bow, frame = scene(ref, s)
        calls = []

        def draws(s=s, calls=calls):
            calls.append(1)
            return torch.from_numpy(ref[f"{s}_draws"])
        det, live, qualified = detect_loop(m, bow, frame, 5, draws, min_keyframes=5,
                                           min_cluster_size=2)
        assert live and qualified
        out[s] = (m, frame, det, len(calls))
    return out


@pytest.mark.parametrize("s", ["a", "b"])
def test_detect_loop_matches_jax(ref, detections, s):
    _, _, det, n_draws = detections[s]
    assert bool(det.detected) and bool(ref[f"{s}_det_detected"]) and n_draws == 1
    np.testing.assert_array_equal(det.cluster_mask.numpy(), ref[f"{s}_det_cluster_mask"])
    np.testing.assert_array_equal(det.reloc_assoc.numpy(), ref[f"{s}_det_reloc_assoc"])
    np.testing.assert_allclose(float(det.scale), float(ref[f"{s}_det_scale"]), atol=1e-5)
    np.testing.assert_allclose(det.reloc_pose.R.numpy(), ref[f"{s}_det_R"], atol=ATOL)
    np.testing.assert_allclose(det.reloc_pose.t.numpy(), ref[f"{s}_det_t"], atol=ATOL)
    # the relocalized pose is Ki's viewpoint in the undrifted region
    np.testing.assert_allclose(det.reloc_pose.t.numpy(), ref[f"{s}_true_t"], atol=2e-2)


def test_detect_loop_gate_draws_nothing(ref):
    """Below MinKeyframe nothing qualifies: no relocalization, no draw."""
    m, bow, frame = scene(ref, "a")

    def no_draws():
        raise AssertionError("drew below the gate")
    det, live, qualified = detect_loop(m, bow, frame, 0, no_draws, min_keyframes=20)
    assert not live and not qualified and not bool(det.detected)


@pytest.mark.parametrize("s,eg", [("a", False), ("a", True), ("b", False), ("b", True)])
def test_close_loop_matches_jax(ref, detections, s, eg):
    m, frame, det, _ = detections[s]
    lc = golden_path_settings().LoopClosureSettings
    kw = (dict(covis_theta=golden_path_settings().CovisibilitySettings.CovisMinThreshold,
               essential_graph_iters=lc.EssentialGraphIterations) if eg else {})
    got = close_loop(m, det, frame, 5, **kw)
    assert_map_close(got, ref, f"{s}_closed_eg" if eg else f"{s}_closed",
                     atol=ATOL if not eg else 5e-4)


def test_essential_graph_refine_matches_jax(ref):
    m = unflatten(MapState, "eg_map", ref, "cpu")
    got = essential_graph_refine(
        m, Pose(m.kf_pose.R, torch.from_numpy(ref["eg_pre_t"])),
        torch.from_numpy(ref["eg_move"]), torch.from_numpy(ref["eg_cluster"]),
        float(ref["eg_scale"]), 11, pre_covis=torch.from_numpy(ref["eg_pre_cv"]),
        iterations=int(ref["eg_iterations"]))
    assert_map_close(got, ref, "eg_out")
    # the drift is spread: mid-chain keyframes land near the truth
    c = got.kf_pose.center().numpy()[3:10]
    assert np.linalg.norm(c - ref["eg_c_true"][3:10], axis=1).max() < 0.1


def _aligned_error(got: MapState, want: MapState) -> float:
    """Largest residual after one similarity aligns the port's keyframe
    centers and points to JAX's."""
    kv = want.kf_valid.numpy()
    pv = want.mp_valid.numpy()
    src = np.concatenate([got.kf_pose.center().numpy()[kv], got.mp_pos.numpy()[pv]])
    dst = np.concatenate([want.kf_pose.center().numpy()[kv], want.mp_pos.numpy()[pv]])
    s, R, t = umeyama_align(src.astype(np.float64), dst.astype(np.float64))
    return float(np.abs((s * (R @ src.T)).T + t - dst).max())


@pytest.mark.parametrize("s", ["a", "b"])
def test_session_closure_matches_jax(ref, detections, s):
    """The session's closure (`_apply_loop_closure`: close with the
    essential graph, global BA with the loop-closure settings, membership
    refresh) on the detected loop, against the JAX session's."""
    m, frame, det, _ = detections[s]
    sess = SlamSession(golden_path_settings(), ref["cam"], 320, 180, device="cpu")
    sess.map, sess.last_kf_slot = m, 5
    assert sess._apply_loop_closure(det, frame, 5) and sess.n_loops_closed == 1
    want = unflatten(MapState, f"{s}_gba", ref, "cpu")
    for f in MASKS:
        assert torch.equal(getattr(sess.map, f), getattr(want, f)), f
    assert _aligned_error(sess.map, want) < ATOL
    np.testing.assert_allclose(sess.map.mp_pos.numpy(), want.mp_pos.numpy(), atol=1e-2)


def test_global_ba_keeps_a_consistent_map(ref):
    """Global BA on the closed map: masks unchanged and the residual near
    zero (the map is noiseless), as the JAX session's."""
    m = unflatten(MapState, "a_closed_eg", ref, "cpu")
    s = golden_path_settings()
    bas = s.LoopClosureSettings.BundleAdjustSettings
    out, mse = global_ba(s, m, 5, steps=5, huber=bas.HuberWidth,
                         max_outlier_error=bas.MaxOutlierError, bas=bas)
    assert mse < 1e-8 and float(ref["a_gba_mse"]) < 1e-8
    out = refresh_membership(out)
    for f in MASKS:
        assert torch.equal(getattr(out, f), getattr(unflatten(MapState, "a_gba", ref, "cpu"),
                                                    f)), f


# --------------------------------------------------------------- snapshot ----

def test_snapshot_restore_is_bit_identical():
    """snapshot_state → frames → restore_state → the same frames: identical
    results, map, index and draw position (photoreal frames 0-11, JAX
    draws replayed: init at 5, keyframes at 6, 7 and 11)."""
    with np.load(PHOTOREAL) as z:
        frames, ts, cam = z["frames"][:12], z["timestamps"][:12], z["cam"]
    sess = SlamSession(golden_path_settings(), cam, 320, 180, device="cpu",
                       draws=ReplayDraws.from_npz(PHOTOREAL, "cpu"))
    for i in range(5):
        sess.process_frame(frames[i], float(ts[i]), i)
    snap = sess.snapshot_state()
    first = [sess.process_frame(frames[i], float(ts[i]), i) for i in range(5, 12)]
    map1, bow1, left1 = sess.map, sess.bow, sess.draws.remaining()
    sess.restore_state(snap)
    assert len(sess.results) == 5 and not sess.initialized
    again = [sess.process_frame(frames[i], float(ts[i]), i) for i in range(5, 12)]
    assert sum(r.is_keyframe for r in first) >= 3
    for a, b in zip(first, again):
        assert (a.state, a.tracked_count, a.is_keyframe) == (b.state, b.tracked_count,
                                                           b.is_keyframe)
        assert torch.equal(a.pose.R, b.pose.R) and torch.equal(a.pose.t, b.pose.t)
    for name, x in to_numpy(map1).items():
        np.testing.assert_array_equal(x, to_numpy(sess.map)[name], err_msg=name)
    for x, y in zip(bow1, sess.bow):
        assert torch.equal(x, y)
    assert left1 == sess.draws.remaining()


def test_replay_draws_rewind_hands_out_the_same_draws():
    """`rewind` to a `position` hands out the draws taken since, in order;
    a position not reached yet cannot be rewound to."""
    draws = ReplayDraws.from_npz(PHOTOREAL, "cpu")
    start = draws.position()
    shapes = [tuple(a.shape) for a in draws.queues["vocab"]]
    first = [draws.gumbel("vocab", shape) for shape in shapes]
    later = draws.position()
    assert later["vocab"] == start["vocab"] + len(shapes) == 2
    draws.rewind(start)
    assert draws.position() == start
    again = [draws.gumbel("vocab", shape) for shape in shapes]
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    draws.rewind(start)
    with pytest.raises(ValueError):
        draws.rewind(later)
