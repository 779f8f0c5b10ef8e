"""The port's keyframe mapping step and the session that runs it, at full
width on the CPU, against the committed reference of the JAX session
(tests/data/torch_port_bench640_map.npz, written by
tools/export_jax_state.py): the benchmark world's frames 31-95 with the
keyframes at 54, 68 and 93 mapped.

- One whole mapping event from the JAX state just before the first
  keyframe: masks and every integer leaf equal to the JAX map after it;
  `kf_pose` within 1e-4, `mp_pos` and the viewing ranges derived from it
  within 2e-3 (four float32 LM steps, sums in another order).
- The session over the whole window: every frame TRACKING, keyframes at the
  JAX session's frames, tracked counts within 2, poses within 1e-3; the map
  after the first event equal in every mask, and after the later events
  too (a float32 difference near a gate could flip a point there: the test
  names the first event and leaf that differs).
- The bag-of-words index after each event against the JAX session's
  (tests/data/torch_port_bench640_bow.npz, from the same JAX run): the
  mapped keyframe's histogram added, culled keyframes dropped; anchors and
  kf_has exact, idf and kf_vectors within 1e-6.
- The fixture's first event against one live JAX mapping step (the JAX
  mapping core compiled at full width, about 20 s on the CPU).
"""

import torch_threads  # noqa: F401  (first: torch's OpenMP threads wait passively)

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mageslam_tpu.geometry.se3 import Pose as JPose
from mageslam_tpu.tracking.frame_state import TrackedFrame as JTrackedFrame
from mageslam_tpu_torch import SlamSession, TrackingState, bench_world, golden_path_settings
from mageslam_tpu_torch import interop
from mageslam_tpu_torch.bow.index import BowIndex
from mageslam_tpu_torch.ops import hamming, matching
from mageslam_tpu_torch.runtime import mapping_step
from mageslam_tpu_torch.runtime.pose_history import PoseHistory
from mageslam_tpu_torch.tracking.frame_state import TrackedFrame
from mageslam_tpu_torch.worldmap.map_state import MapState, grow_map

# the suite runs several worker processes on few cores: a small thread pool
# each costs less than the default of one thread a core
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT = os.path.join(REPO, "tests", "data", "torch_port_bench640_f30.npz")
BOW_FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_bench640_bow.npz")
MAP_FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_bench640_map.npz")
CAM = (520.0, 520.0, 320.0, 240.0)
MASKS = ("kf_valid", "mp_valid", "kf_assoc", "kf_member")
# leaves that follow the optimized point positions
POINT_LEAVES = ("mp_pos", "mp_dmin", "mp_dmax")


@pytest.fixture(scope="module")
def fixture():
    with np.load(MAP_FIXTURE) as z:
        return {k: z[k] for k in z.files}


def event_inputs(fixture):
    return (interop.unflatten(MapState, "ev0_pre_map", fixture, "cpu"),
            interop.unflatten(PoseHistory, "ev0_pre_ph", fixture, "cpu"),
            interop.unflatten(TrackedFrame, "ev0_frame", fixture, "cpu"),
            float(fixture["ev0_map_scale"]))


def assert_state_close(got, fixture, prefix, cls, pose_atol=1e-4, point_atol=2e-3):
    want = interop.to_numpy(interop.unflatten(cls, prefix, fixture, "cpu"))
    for name, a in interop.to_numpy(got).items():
        b = want[name]
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype.kind == "f":
            atol = point_atol if name in POINT_LEAVES else pose_atol
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=f"{prefix}: {name}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{prefix}: {name}")


def test_one_mapping_event_equals_the_jax_map(fixture):
    pre_map, pre_ph, frame, map_scale = event_inputs(fixture)
    fused, two_way, ham = matching.LAUNCHES, matching.TWO_WAY_LAUNCHES, hamming.LAUNCHES
    stages = []
    new_map, new_ph, ki, live = mapping_step.mapping(
        golden_path_settings(), 640, 480, pre_map, pre_ph, frame, map_scale,
        probe=stages.append)
    assert ki == int(fixture["ev_ki"][0]) == 3
    # the counts before local BA bound the mapped map's from above
    assert live[0] == int(new_map.kf_valid.sum()) == 4
    assert int(new_map.mp_valid.sum()) <= live[1] <= int(new_map.mp_valid.sum()) + 20
    assert tuple(stages) == mapping_step.STAGES
    assert_state_close(new_map, fixture, "ev0_post_map", MapState)
    assert_state_close(new_ph, fixture, "ev0_post_ph", PoseHistory)
    assert int(new_map.mp_valid.sum()) > int(pre_map.mp_valid.sum())
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (matching.LAUNCHES, matching.TWO_WAY_LAUNCHES, hamming.LAUNCHES) == (
        fused, two_way, ham)


def test_with_tethers_gives_the_same_map(fixture):
    """Tether slots of weight 0 are inert whatever else they hold; a live
    tether between two window keyframes moves the map."""
    pre_map, pre_ph, frame, map_scale = event_inputs(fixture)
    assert not pre_map.tether_weight.any()
    rng = np.random.RandomState(3)
    n = pre_map.tether_weight.shape[0]
    junk = pre_map._replace(
        tether_kind=torch.from_numpy(rng.randint(0, 3, n).astype(np.int32)),
        tether_origin=torch.from_numpy(rng.randint(-1, 3, n).astype(np.int32)),
        tether_owner=torch.from_numpy(rng.randint(-1, 3, n).astype(np.int32)),
        tether_distance=torch.from_numpy(rng.uniform(0.1, 2.0, n).astype(np.float32)))
    a = mapping_step.mapping(golden_path_settings(), 640, 480, pre_map, pre_ph, frame,
                             map_scale)
    b = mapping_step.mapping(golden_path_settings(), 640, 480, junk, pre_ph, frame,
                             map_scale)
    live = junk._replace(
        tether_kind=torch.zeros_like(junk.tether_kind),            # distance tethers
        tether_origin=torch.full_like(junk.tether_origin, 1),
        tether_owner=torch.full_like(junk.tether_owner, 2),
        tether_distance=torch.full_like(junk.tether_distance, 3.0),
        tether_weight=torch.cat([torch.full((1,), 50.0), torch.zeros(n - 1)]))
    c = mapping_step.mapping(golden_path_settings(), 640, 480, live, pre_ph, frame,
                             map_scale)
    assert not torch.allclose(c[0].kf_pose.t, a[0].kf_pose.t, atol=1e-3)
    assert bool(torch.isfinite(c[0].kf_pose.t).all())
    # zero-weight tethers add exact zeros to the normal equations
    for (name, x), y in zip(interop.to_numpy(a[0]).items(), interop.to_numpy(b[0]).values()):
        if name.startswith("tether_"):
            continue
        if x.dtype.kind == "f":
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(x, y, err_msg=name)


def test_full_keyframe_bank_leaves_everything_as_it_was(fixture):
    pre_map, pre_ph, frame, map_scale = event_inputs(fixture)
    full = pre_map._replace(kf_valid=torch.ones_like(pre_map.kf_valid))
    new_map, new_ph, ki, _ = mapping_step.mapping(golden_path_settings(), 640, 480, full,
                                                  pre_ph, frame, map_scale)
    assert ki == -1 and new_map is full and new_ph is pre_ph


def test_ba_tiers_follow_the_bank_capacity():
    s = golden_path_settings()
    assert mapping_step.ba_tiers(s, (48, 2048, 512)) == ((16, 1024, 2048), (32, 2048, 4096))
    assert mapping_step.ba_tiers(s, (8, 256, 64)) == ((8, 256, 512), (8, 256, 512))


def test_cheap_loop_closure_adds_only_free_distinct_associations(fixture):
    pre_map, _, frame, _ = event_inputs(fixture)
    # forget a third of the frame's associations: the wide match finds them again
    had = torch.nonzero(frame.assoc >= 0)[::3, 0]
    stripped = frame._replace(assoc=frame.assoc.index_fill(0, had, -1))
    closed = mapping_step.cheap_loop_closure(golden_path_settings(), 640, 480, pre_map,
                                             stripped)
    kept = stripped.assoc >= 0
    assert torch.equal(closed.assoc[kept], stripped.assoc[kept])
    new = closed.assoc[~kept]
    new = new[new >= 0]
    assert len(new) >= len(had) // 2
    assert len(torch.unique(closed.assoc[closed.assoc >= 0])) == int((closed.assoc >= 0).sum())
    assert (closed.assoc[had] == frame.assoc[had]).float().mean() > 0.5


@pytest.fixture(scope="module")
def window_run(fixture):
    """The session over the fixture's window; the map after each event."""
    sess = SlamSession.from_jax_snapshot(SNAPSHOT, golden_path_settings(), CAM, 640, 480,
                                         device="cpu")
    ids = fixture["ref_frame_id"].tolist()
    frames = bench_world.frames(ids[0], ids[-1] + 1)
    results, maps, histories, bows = [], [], [], []
    for img, i in zip(frames, ids):
        r = sess.process_frame(img, i * 0.033, i)
        results.append(r)
        if r.is_keyframe:
            maps.append(sess.map)
            histories.append(sess.pose_history)
            bows.append(sess.bow)
    return {"sess": sess, "results": results, "maps": maps, "histories": histories,
            "bows": bows}


def test_window_tracks_every_frame_like_the_jax_session(fixture, window_run):
    results = window_run["results"]
    assert all(r.state == TrackingState.TRACKING for r in results)
    assert [r.frame_id for r in results if r.is_keyframe] == fixture["ev_frame_id"].tolist() \
        == [54, 68, 93]
    for j, r in enumerate(results):
        assert abs(r.tracked_count - int(fixture["ref_tracked"][j])) <= 2, r.frame_id
        np.testing.assert_allclose(r.pose.R.numpy(), fixture["ref_R"][j], atol=1e-3)
        np.testing.assert_allclose(r.pose.t.numpy(), fixture["ref_t"][j], atol=1e-3)
    sess = window_run["sess"]
    assert sess.last_kf_slot == int(fixture["ev_ki"][-1]) == 5
    assert sess.frames_since_keyframe == 2 and not sess._grow_pending


@pytest.mark.parametrize("event", [0, 1, 2])
def test_window_maps_equal_the_jax_maps(fixture, window_run, event):
    got = window_run["maps"][event]
    want = interop.unflatten(MapState, f"ev{event}_post_map", fixture, "cpu")
    for name in MASKS:
        differ = int((getattr(got, name) != getattr(want, name)).sum())
        assert differ == 0, (f"event {event} (frame {int(fixture['ev_frame_id'][event])}): "
                             f"{name} differs in {differ} entries")
    assert_state_close(got, fixture, f"ev{event}_post_map", MapState, pose_atol=1e-3,
                       point_atol=5e-3)
    assert_state_close(window_run["histories"][event], fixture, f"ev{event}_post_ph",
                       PoseHistory, pose_atol=1e-3)


@pytest.mark.parametrize("event", [0, 1, 2])
def test_window_bow_index_equals_the_jax_index(window_run, event):
    with np.load(BOW_FIXTURE) as z:
        want = interop.to_numpy(interop.unflatten(BowIndex, f"ev{event}_post_bow",
                                                  {k: z[k] for k in z.files}, "cpu"))
    got = interop.to_numpy(window_run["bows"][event])
    np.testing.assert_array_equal(got["anchors"], want["anchors"])
    np.testing.assert_array_equal(got["kf_has"], want["kf_has"])
    np.testing.assert_allclose(got["idf"], want["idf"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["kf_vectors"], want["kf_vectors"], rtol=0, atol=1e-6)
    assert got["kf_has"].sum() == window_run["maps"][event].kf_valid.sum()


def test_bank_growth_is_armed_and_served(fixture):
    sess = SlamSession.from_jax_snapshot(SNAPSHOT, golden_path_settings(), CAM, 640, 480,
                                         device="cpu")
    sess._maybe_grow_banks(36, 100)
    assert not sess._grow_pending
    sess._maybe_grow_banks(37, 100)
    assert sess._grow_pending
    before = interop.to_numpy(sess.map)
    r = sess.process_frame(bench_world.frames(31, 32)[0], 31 * 0.033, 31)
    b = sess.settings.Budgets
    assert sess.map.capacity == (b.MaxKeyframes, b.MaxMapPoints, 512) and not sess._grow_pending
    # the index's keyframe rows grow with the keyframe bank
    assert sess.bow.kf_vectors.shape == (b.MaxKeyframes, 64)
    assert sess.bow.kf_has.shape == (b.MaxKeyframes,) and int(sess.bow.kf_has.sum()) == 3
    assert r.state == TrackingState.TRACKING and r.tracked_count == 161
    grown = interop.to_numpy(grow_map(sess.map, b.MaxKeyframes, b.MaxMapPoints))
    for name in ("kf_valid", "mp_valid", "kf_assoc", "mp_desc"):
        n = before[name].shape[0]
        np.testing.assert_array_equal(grown[name][:n], before[name])
        assert not grown[name][n:].any() or name == "kf_assoc"


def _load_tool():
    spec = importlib.util.spec_from_file_location(
        "export_jax_state", os.path.join(REPO, "tools", "export_jax_state.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_tree(template, fixture, prefix):
    leaves, treedef = jax.tree.flatten(template)
    return jax.tree.unflatten(treedef, [jnp.asarray(fixture[f"{prefix}{i}"])
                                        for i in range(len(leaves))])


def test_fixture_event_matches_a_live_jax_mapping_step(fixture):
    sess = _load_tool().make_jax_session()
    frame_template = JTrackedFrame(**{f: JPose(0, 0) if f == "pose" else 0
                                      for f in JTrackedFrame._fields})
    new_map, new_ph, ki = sess._mapping_core(
        _jax_tree(sess.map, fixture, "ev0_pre_map"),
        _jax_tree(sess.pose_history, fixture, "ev0_pre_ph"),
        _jax_tree(frame_template, fixture, "ev0_frame"),
        jnp.float32(fixture["ev0_map_scale"]))
    assert int(ki) == int(fixture["ev_ki"][0])
    for prefix, tree in (("ev0_post_map", new_map), ("ev0_post_ph", new_ph)):
        for i, leaf in enumerate(jax.tree.flatten(tree)[0]):
            a, b = np.asarray(leaf), fixture[f"{prefix}{i}"]
            assert a.dtype == b.dtype and a.shape == b.shape, (prefix, i)
            if a.dtype.kind == "f":
                np.testing.assert_allclose(b, a, rtol=0, atol=1e-5, err_msg=f"{prefix}{i}")
            else:
                np.testing.assert_array_equal(b, a, err_msg=f"{prefix}{i}")
