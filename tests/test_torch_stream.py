"""The port's throughput and realtime entry points against the JAX session's.

tests/data/torch_port_stream.npz (`python tools/export_jax_state.py stream`)
holds a JAX session at bench.py's settings (golden, MinKeyframe 3) after
frames 0-30 (its snapshot, the file's own keys) and, from that state, its
`process_frame_stream` over frames 31-95 and 31-71 (chunk 8,
`_chunk_pipeline_depth` 4; `s95_*`, `s71_*`; the port runs the first) and
its `process_frame_pipelined` over 31-58 (`p58_*`; the port runs 31-55 of
it): per
frame the state, keyframe flag, pose and tracked count, the map's masks
right after each mapping step, `loop_det_stats`, the index at the end and
the draws of every relocalization. Its `dr_*` keys hold
tests/test_stream_loop_closure.py's deferred-resolution scene.
tests/data/torch_port_diag.npz (`python tools/export_jax_state.py diag`)
holds the JAX stream call over 31-95 again with a Determinator attached:
its checkpoint stream and the hash of the `Mapping.Map` tree after each
mapping step. The port's stream run carries a Determinator too, and one
run serves every stream test.

Tolerances (as chip_smoke.py phase 13): states and keyframe flags exact,
R and t within 1e-3, tracked counts within 3, masks after each mapping
step exact, `loop_det_stats` equal on the JAX keys; the gated step equals
the per-frame host branch bit for bit, and the chunked call, bank growth
and a disk snapshot mid-stream give the stream call's results bit for
bit; the index's vectors within 1e-5; checkpoint names in JAX's order, and
the hashes of the integer trees (`Post.KeyframeDecision`, `Mapping.Map`, a
detection that detects nothing) equal to JAX's.
"""

import torch_threads  # noqa: F401  (first: torch's OpenMP threads wait passively)

import dataclasses
import os

import numpy as np
import pytest
import torch

from mageslam_tpu_torch import SlamSession, TrackingState, bench_world, golden_path_settings
from mageslam_tpu_torch.bow.index import BowIndex
from mageslam_tpu_torch.config import Budgets, MageSlamSettings
from mageslam_tpu_torch.diagnostics import Determinator
from mageslam_tpu_torch.interop import to_numpy, unflatten
from mageslam_tpu_torch.io.snapshot import load_session_snapshot, save_session_snapshot
from mageslam_tpu_torch.ops.frontend import detect_and_compute
from mageslam_tpu_torch.runtime import session as session_module
from mageslam_tpu_torch.runtime import streaming
from mageslam_tpu_torch.runtime.draws import ReplayDraws
from mageslam_tpu_torch.runtime.frame_step import gated_step
from mageslam_tpu_torch.runtime.loop_closure import LoopDetection, detect_loop
from mageslam_tpu_torch.tracking.frame_state import TrackedFrame
from mageslam_tpu_torch.worldmap.map_state import MapState

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_stream.npz")
LOOP_FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_loop.npz")
DIAG_FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_diag.npz")
CAM = np.float32([520.0, 520.0, 320.0, 240.0])
DT = 0.033
MASKS = ("kf_valid", "mp_valid", "kf_assoc", "kf_member")
DET_STATS = ("deferred", "resolved", "stale_slot", "closed", "requeued", "same_loop_dropped")
LAST = 95
# checkpoints whose trees hold integers and flags only: JAX's hashes
EXACT_SITES = ("Post.KeyframeDecision", "Mapping.Map", "LoopClosure.Detect")


def bench_settings():
    s = golden_path_settings()
    return dataclasses.replace(s, LoopClosureSettings=dataclasses.replace(
        s.LoopClosureSettings, MinKeyframe=3))


def session(prefix: str, settings=None) -> SlamSession:
    sess = SlamSession.from_jax_snapshot(
        FIXTURE, settings or bench_settings(), CAM, 640, 480, device="cpu",
        draws=ReplayDraws.from_npz(FIXTURE, "cpu", kinds=("reloc",), prefix=prefix))
    sess._chunk_pipeline_depth = 4
    return sess


@pytest.fixture(scope="module")
def ref():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def frames():
    return np.stack(bench_world.frames(0, LAST + 1))


class recording_mapping:
    """Records the map's masks right after every mapping step the session
    runs, on the chunk path and the per-frame path, with the hash of the
    `Mapping.Map` checkpoint's tree."""

    def __init__(self):
        self.events = []

    def __enter__(self):
        self.real = streaming.mapping

        def rec(*args, **kwargs):
            out = self.real(*args, **kwargs)
            d = Determinator()
            d.check("Mapping.Map", out[0].kf_valid, out[0].mp_valid, out[0].kf_assoc)
            self.events.append((int(args[5].frame_id), out[2],
                                {n: getattr(out[0], n).clone() for n in MASKS},
                                d._stream[0][1]))
            return out

        streaming.mapping = session_module.mapping = rec
        return self.events

    def __exit__(self, *exc):
        streaming.mapping = session_module.mapping = self.real


@pytest.fixture(scope="module")
def stream_run(frames):
    """The port's `process_frame_stream` over 31-95, as the fixture's call,
    with a Determinator attached."""
    sess = session("s95_")
    sess.determinator = Determinator()
    with recording_mapping() as events:
        res = sess.process_frame_stream(torch.from_numpy(frames),
                                        [i * DT for i in range(LAST + 1)],
                                        list(range(LAST + 1)), start=31, stop=LAST + 1,
                                        chunk=8)
    return sess, res, events


def poses(res):
    return (np.array([np.asarray(r.pose.R) for r in res]),
            np.array([np.asarray(r.pose.t) for r in res]))


def assert_results(res, ref, prefix, ids):
    assert [r.frame_id for r in res] == list(ids)
    n = len(res)
    assert [r.state.value for r in res] == ref[prefix + "ref_state"][:n].tolist()
    assert [r.is_keyframe for r in res] == ref[prefix + "ref_is_kf"][:n].tolist()
    R, t = poses(res)
    np.testing.assert_allclose(R, ref[prefix + "ref_R"][:n], atol=1e-3)
    np.testing.assert_allclose(t, ref[prefix + "ref_t"][:n], atol=1e-3)
    tracked = np.array([r.tracked_count for r in res])
    assert np.abs(tracked - ref[prefix + "ref_tracked"][:n]).max() <= 3


# ------------------------------------------------------------ gated step ----

@pytest.mark.parametrize("blank", [False, True], ids=["tracked", "blank"])
def test_gated_step_equals_host_branch(ref, frames, blank):
    """The gated step gives the host-branched `_track`'s state bit for bit:
    on a tracked frame (31) and on a blank one, where tracking fails."""
    image = np.zeros_like(frames[31]) if blank else frames[31]
    host, gated = session("s71_"), session("s71_")
    feats = detect_and_compute(torch.from_numpy(image).to(torch.float32), host.cam16,
                               host.fes, host.N)
    r = host._track(feats, 31 * DT, 31)
    out = gated_step(gated.settings, 640, 480, gated.map, gated.history, gated.pose_history,
                     gated._frame(feats, 31 * DT, 31),
                     gated._scalar(gated.frames_since_keyframe + 1, torch.int32),
                     gated._scalar(min(gated.frames_since_reloc + 1, 10_000), torch.int32))
    assert (r.state == TrackingState.TRACKING) == (not blank)
    ok, tracked, kf = out.flags.tolist()
    assert (ok, kf) == (int(not blank), 0)
    if not blank:
        assert tracked == r.tracked_count
        assert torch.equal(out.frame.pose.R, r.pose.R) and torch.equal(out.frame.pose.t, r.pose.t)
    for a, b in ((host.map, out.map), (host.history, out.history),
                 (host.pose_history, out.pose_history)):
        for name, x in to_numpy(a).items():
            assert np.array_equal(x, to_numpy(b)[name], equal_nan=True), name


# ---------------------------------------------------------------- stream ----

def test_stream_results_match_jax(ref, stream_run):
    _, res, _ = stream_run
    assert_results(res, ref, "s95_", range(31, LAST + 1))


def test_stream_masks_after_each_event_match_jax(ref, stream_run):
    _, _, events = stream_run
    assert [e[0] for e in events] == ref["s95_ev_frame_id"].tolist()
    assert [e[1] for e in events] == ref["s95_ev_ki"].tolist()
    for j, (_, _, masks, _) in enumerate(events):
        for n in MASKS:
            assert np.array_equal(masks[n].numpy(), ref[f"s95_ev{j}_{n}"]), (j, n)


def test_stream_loop_det_stats_match_jax(ref, stream_run):
    sess, _, _ = stream_run
    assert [sess.loop_det_stats[k] for k in DET_STATS] == ref["s95_det_stats"].tolist()
    assert sess.loop_det_stats["deferred"] > 0
    assert not sess._pending_chunks and not sess._pending_loop_dets


def test_stream_index_matches_jax(ref, stream_run):
    sess, _, _ = stream_run
    want = to_numpy(unflatten(BowIndex, "s95_bow", ref, "cpu"))
    for name, got in to_numpy(sess.bow).items():
        if got.dtype.kind == "f":
            np.testing.assert_allclose(got, want[name], atol=1e-5, err_msg=name)
        else:
            assert np.array_equal(got, want[name]), name


def test_stream_checkpoints_follow_jax(stream_run):
    """The Determinator's stream of the run against the JAX session's
    (tests/data/torch_port_diag.npz): the same checkpoints in the same
    order (the chunk summaries, the deferred detections, the tail frame's
    per-frame sites); the integer trees' hashes equal, float trees' in
    the last bits apart (sums in another order); and the `Mapping.Map`
    tree after each mapping step inside the chunks hashed as JAX's."""
    sess, _, events = stream_run
    with np.load(DIAG_FIXTURE) as z:
        names, hashes = [n.decode() for n in z["st_names"].tolist()], z["st_hashes"].tolist()
        map_frames, map_hashes = z["st_map_frame"].tolist(), z["st_map_hash"].tolist()
    got = sess.determinator._stream
    assert [n for n, _ in got] == names
    assert {"Stream.Chunk", "LoopClosure.Detect", "Post.KeyframeDecision"} <= set(names)
    for (name, h), want in zip(got, hashes):
        if name in EXACT_SITES:
            assert h == want, name
    assert [e[0] for e in events] == map_frames
    assert [e[3] for e in events] == map_hashes


def assert_same_results(got, want):
    assert [r.frame_id for r in got] == [r.frame_id for r in want]
    assert [(r.state, r.is_keyframe, r.tracked_count) for r in got] == \
        [(r.state, r.is_keyframe, r.tracked_count) for r in want]
    for a, b in zip(poses(got), poses(want)):
        np.testing.assert_array_equal(a, b)


def test_chunked_with_growth_and_disk_snapshot_equals_stream(frames, stream_run, tmp_path):
    """`process_frames_chunked` at chunk 4 over 31-54 (the keyframe at 54
    included), interrupted after 38: the session saved to disk (which
    drains the two chunks in flight), loaded into a fresh one, bank growth
    armed. Its results are the stream call's frame by frame, bit for bit,
    and the banks grew (resolution points differ, so `loop_det_stats` is
    not compared)."""
    _, want, _ = stream_run
    sess = session("s71_")
    for base in (31, 35):
        ids = list(range(base, base + 4))
        assert sess.process_frames_chunked([frames[i] for i in ids], [i * DT for i in ids],
                                           ids) == []        # in flight
    path = str(tmp_path / "snap.npz")
    save_session_snapshot(path, sess)
    got = list(sess.results)
    fresh = SlamSession(bench_settings(), CAM, 640, 480, device="cpu",
                        draws=ReplayDraws({}, "cpu"))
    load_session_snapshot(path, fresh)
    fresh._chunk_pipeline_depth = 4
    fresh._grow_pending = True
    for base in range(39, 55, 4):
        ids = list(range(base, base + 4))
        got += fresh.process_frames_chunked([frames[i] for i in ids], [i * DT for i in ids],
                                            ids)
    got += fresh.flush_chunks()
    b = fresh.settings.Budgets
    assert fresh.map.capacity[:2] == (b.MaxKeyframes, b.MaxMapPoints)
    assert_same_results(got, want[:24])


# ------------------------------------------------------------- pipelined ----

def test_pipelined_matches_jax(ref, frames):
    """`process_frame_pipelined` over 31-55 of JAX's call over 31-58 (the
    queue resolves at 35, 40, ..., 55, so both keyframes are mapped by
    then): mapping lags to the resolution (keyframes at 54 and 55, as
    JAX's), results, masks after each event."""
    sess = session("p58_")
    n0 = len(sess.results)
    with recording_mapping() as events:
        for i in range(31, 56):
            sess.process_frame_pipelined(frames[i], i * DT, i)
        assert not sess._pending
    assert_results(sess.results[n0:], ref, "p58_", range(31, 56))
    assert [e[0] for e in events] == ref["p58_ev_frame_id"].tolist()
    for j, (_, _, masks, _) in enumerate(events):
        for n in MASKS:
            assert np.array_equal(masks[n].numpy(), ref[f"p58_ev{j}_{n}"]), (j, n)


def test_realtime_backpressure(frames):
    """tests/test_pipeline.py::TestRealtimeBackpressure's twin: paced frames
    all track; with max_inflight=0 every frame drops as SKIPPED and the lost
    count stays; then tracking resumes."""
    sess = session("p58_", golden_path_settings())
    for i in range(31, 37):
        sess.process_frame_realtime(frames[i], i * DT, i)
        sess.flush()
    assert all(r.state == TrackingState.TRACKING for r in sess.results[-6:]), sess.results[-6:]
    lc = sess.lost_count
    dropped = [sess.process_frame_realtime(frames[i], i * DT, i, max_inflight=0)
               for i in range(37, 41)]
    assert all(r is not None and r.state == TrackingState.SKIPPED for r in dropped)
    assert sess.lost_count == lc
    sess.process_frame_realtime(frames[41], 41 * DT, 41)
    sess.flush()
    assert sess.results[-1].state == TrackingState.TRACKING


# ------------------------------------------------- deferred loop closure ----

def fake_det(hit: bool, K: int) -> LoopDetection:
    mask = torch.zeros(K, dtype=torch.bool)
    mask[0] = True        # every detection shares cluster bit 0: same-loop siblings
    return LoopDetection(detected=torch.tensor(hit), reloc_pose=None,
                         reloc_assoc=torch.zeros(4, dtype=torch.int32),
                         scale=torch.tensor(1.0), cluster_mask=mask)


def test_deferred_resolution_guards_and_flag_riding():
    """tests/test_pipeline.py::TestDeferredLoopDets's twin: a hit on a
    reused slot is dropped, one on a live slot applies, a same-loop sibling
    is dropped without a re-attempt, a miss is dropped; both the ride
    (flags given) and the flush (read here) forms."""
    sess = SlamSession(golden_path_settings(), CAM, 640, 480, device="cpu")
    K = sess.map.kf_frame_id.shape[0]
    kf_frame_id = sess.map.kf_frame_id.clone()
    kf_frame_id[3], kf_frame_id[5] = 77, 99
    sess.map = sess.map._replace(kf_frame_id=kf_frame_id)
    applied = []
    sess._apply_loop_closure = lambda det, frame, ki: applied.append(int(ki))
    sess._pending_loop_dets = [(fake_det(True, K), "frameB", 5, 42),
                               (fake_det(True, K), "frameA", 3, 77),
                               (fake_det(True, K), "frameC", 3, 77),
                               (fake_det(False, K), "frameD", 3, 77)]
    sess._resolve_loop_dets(flags=np.array([1.0, 1.0, 1.0, 0.0], np.float32))
    assert applied == [3] and sess._pending_loop_dets == []
    st = sess.loop_det_stats
    assert st["stale_slot"] == 1 and st["closed"] == 1, st
    assert st["same_loop_dropped"] == 1 and st["requeued"] == 0, st
    sess._pending_loop_dets = [(fake_det(True, K), "frameA", 3, 77)]
    sess._resolve_loop_dets()
    assert applied == [3, 3]
    sess._resolve_loop_dets()
    assert applied == [3, 3]


@pytest.fixture
def drifted(ref, monkeypatch):
    """tests/test_stream_loop_closure.py's scene: the drifted map, keyframes
    5 (frame 12) and 4 (frame 11) with their detections from JAX's draws,
    and a session at its budgets with global BA skipped, as there."""
    m = unflatten(MapState, "dr_map", ref, "cpu")
    bow = unflatten(BowIndex, "dr_bow", ref, "cpu")
    f5 = unflatten(TrackedFrame, "dr_frame5", ref, "cpu")
    f4 = unflatten(TrackedFrame, "dr_frame4", ref, "cpu")
    kw = dict(min_keyframes=5, min_cluster_size=2)
    det5, _, _ = detect_loop(m, bow, f5, 5, lambda: torch.from_numpy(ref["dr_det5_draws"]), **kw)
    det4, _, _ = detect_loop(m, bow, f4, 4, lambda: torch.from_numpy(ref["dr_det4_draws"]), **kw)
    for name, det in (("det5", det5), ("det4", det4)):
        assert bool(det.detected) == bool(ref[f"dr_{name}_detected"])
        assert np.array_equal(det.cluster_mask.numpy(), ref[f"dr_{name}_cluster_mask"])
    K, P, N = m.capacity
    s = MageSlamSettings()
    s = dataclasses.replace(
        s, LoopClosureSettings=dataclasses.replace(
            s.LoopClosureSettings, EnableLoopClosure=True, MinKeyframe=5, MinClusterSize=2),
        Budgets=Budgets(MaxFeatures=N, MaxKeyframes=K, MaxMapPoints=P))
    with np.load(LOOP_FIXTURE) as z:
        cam = z["cam"]
    sess = SlamSession(s, cam, 320, 180, device="cpu",
                       draws=ReplayDraws.from_npz(FIXTURE, "cpu", kinds=("reloc",),
                                                  prefix="dr_"))
    sess.map, sess.bow, sess.initialized = m, bow, True
    monkeypatch.setattr(session_module, "global_ba", lambda settings, m, *a, **k: (m, 0.0))
    return sess, det5, det4, f5, f4


def test_deferred_resolution_requeues_distinct_loops(ref, drifted):
    """tests/test_stream_loop_closure.py::test_deferred_resolution_guards_and_requeue's
    twin: a stale slot, a live detection, a same-loop sibling and a
    distinct-loop sibling in one batch give JAX's counters and closure."""
    sess, det5, det4, f5, f4 = drifted
    det4_distinct = det4._replace(cluster_mask=torch.zeros_like(det4.cluster_mask))
    det4_distinct.cluster_mask[9] = True
    sess._pending_loop_dets = [(det5, f5, 5, 999), (det5, f5, 5, 12), (det4, f4, 4, 11),
                               (det4_distinct, f4, 4, 11)]
    sess._resolve_loop_dets()
    st = sess.loop_det_stats
    assert (st["stale_slot"], st["closed"], st["same_loop_dropped"], st["requeued"]) == \
        (1, 1, 1, 1), st
    assert sess.n_loops_closed == 1
    assert [[k, f, int(bool(d.detected))] for d, _, k, f in sess._pending_loop_dets] == \
        ref["dr_requeued"].tolist()
    n_pts = int(ref["dr_n_pts"])
    assoc5 = sess.map.kf_assoc[5].numpy()
    assert ((assoc5 >= 0) & (assoc5 < n_pts)).sum() > n_pts * 0.8
    assert np.array_equal(sess.map.kf_assoc.numpy(), ref["dr_post_kf_assoc"])
    sess._resolve_loop_dets()
    assert sess._pending_loop_dets == [] and sess.n_loops_closed == 1
    assert [st[k] for k in DET_STATS] == ref["dr_det_stats"].tolist()
    assert st["resolved"] == 5


def test_deferred_single_detection_closes(drifted):
    """tests/test_stream_loop_closure.py::test_deferred_single_detection_closes's
    twin: one deferred detection, its flag read here, closes as the
    per-frame path would."""
    sess, det5, _, f5, _ = drifted
    sess._pending_loop_dets = [(det5, f5, 5, 12)]
    sess._resolve_loop_dets()
    assert sess.n_loops_closed == 1 and sess.loop_det_stats["requeued"] == 0
    assert sess.loop_det_stats["closed"] == 1
    with np.load(LOOP_FIXTURE) as z:
        true_t = z["a_true_t"]
    np.testing.assert_allclose(sess.map.kf_pose.t[5].numpy(), true_t, atol=3e-2)
