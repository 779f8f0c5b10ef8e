"""The session's mapping offload (`SlamSession.enable_mapping_offload`)
against the JAX session's, through tests/data/torch_port_parallel.npz
(`python tools/export_jax_state.py parallel`): the JAX session from the
frame-30 state with `enable_mapping_offload(jax.devices()[1])` over bench
frames 31-95, then `fossilize(global_ba_steps=0)`, a Determinator
attached.

The port runs the same window on the CPU, its mapping on the worker
thread. Held: every frame's state and keyframe flag equal, R and t within
1e-3, tracked counts within 3; the adoptions at the same frames and the
map's masks after each equal; the checkpoint names in JAX's order and the
integer trees' hashes (`Post.KeyframeDecision`, `Mapping.Map`) equal;
the fossilized trajectory's frame ids equal and its matrices within 1e-3.
"""

import torch_threads  # noqa: F401  (first: torch's OpenMP threads wait passively)

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mageslam_tpu_torch import SlamSession, bench_world, golden_path_settings
from mageslam_tpu_torch.diagnostics import Determinator
from mageslam_tpu_torch.runtime import session as session_module

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_parallel.npz")
SNAPSHOT = os.path.join(REPO, "tests", "data", "torch_port_bench640_f30.npz")
FIRST, LAST = 31, 95
DT = 0.033
MASKS = ("kf_valid", "mp_valid", "kf_assoc", "kf_member")
EXACT_SITES = ("Post.KeyframeDecision", "Mapping.Map")


@pytest.fixture(scope="module")
def ref():
    with np.load(FIXTURE) as z:
        return {k[4:]: z[k] for k in z.files if k.startswith("off_")}


@pytest.fixture(scope="module")
def run():
    """The offloaded session over frames FIRST..LAST, then fossilize(0)."""
    det = Determinator()
    sess = SlamSession.from_jax_snapshot(SNAPSHOT, golden_path_settings(),
                                         (520.0, 520.0, 320.0, 240.0), 640, 480,
                                         device="cpu", determinator=det)
    sess.enable_mapping_offload("cpu")
    adoptions, threads = [], []
    adopt = sess._adopt_offloaded_mapping
    body = session_module.mapping_body

    def recording_adopt():
        pending = sess._offload_pending
        adopt()
        if pending is not None:
            adoptions.append((int(pending[1].frame_id),
                              {k: getattr(sess.map, k).clone() for k in MASKS}))

    def recording_body(*args, **kwargs):
        threads.append(threading.current_thread().name)
        return body(*args, **kwargs)

    sess._adopt_offloaded_mapping = recording_adopt
    session_module.mapping_body = recording_body
    try:
        results = [sess.process_frame(img, i * DT, i)
                   for i, img in enumerate(bench_world.frames(FIRST, LAST + 1), FIRST)]
        fossil = sess.fossilize(global_ba_steps=0)
    finally:
        session_module.mapping_body = body
    return {"results": results, "adoptions": adoptions, "threads": threads,
            "det": det, "fossil": fossil, "sess": sess}


def test_states_and_keyframes_equal_jax(ref, run):
    res = run["results"]
    assert [r.frame_id for r in res] == ref["frame_id"].tolist()
    assert [r.state.value for r in res] == ref["state"].tolist()
    assert [r.is_keyframe for r in res] == ref["is_kf"].tolist()
    # the offload moves the keyframes: tracking decides on the map as it was
    assert ref["is_kf"].sum() >= 3


def test_poses_and_tracked_counts_follow_jax(ref, run):
    res = run["results"]
    np.testing.assert_allclose(np.stack([np.asarray(r.pose.R) for r in res]), ref["R"],
                               atol=1e-3)
    np.testing.assert_allclose(np.stack([np.asarray(r.pose.t) for r in res]), ref["t"],
                               atol=1e-3)
    assert np.abs(np.array([r.tracked_count for r in res]) - ref["tracked"]).max() <= 3


def test_adopted_maps_equal_jax(ref, run):
    got = run["adoptions"]
    assert [f for f, _ in got] == ref["adopt_frame"].tolist()
    for j, (_, masks) in enumerate(got):
        for k in MASKS:
            np.testing.assert_array_equal(masks[k].numpy(), ref[f"ad{j}_{k}"],
                                          err_msg=f"adoption {j} {k}")


def test_checkpoints_follow_jax(ref, run):
    stream = run["det"]._stream
    assert [n for n, _ in stream] == [n.decode() for n in ref["names"].tolist()]
    exact = [(h, want) for (n, h), want in zip(stream, ref["hashes"].tolist())
             if n in EXACT_SITES]
    assert exact and all(h == want for h, want in exact)


def test_fossilized_trajectory_follows_jax(ref, run):
    ids, mats = run["fossil"]
    np.testing.assert_array_equal(ids, ref["fossil_ids"])
    np.testing.assert_allclose(mats, ref["fossil_mats"], atol=1e-3)
    assert run["sess"]._offload_pending is None


def test_mapping_ran_on_the_worker_thread(ref, run):
    assert run["threads"] and all(t.startswith("mapping") for t in run["threads"])
    assert len(run["threads"]) == len(run["adoptions"]) == int(ref["is_kf"].sum())


def test_launch_counts_lose_no_update_across_threads():
    """The worker and the main thread both count launches: `count_launch`
    adds under a lock, so no update is lost with 16 threads switching
    every microsecond, even where the read yields between the read and the
    write."""
    from mageslam_tpu_torch.ops import _build

    class Yielding(dict):
        def __getitem__(self, key):
            value = super().__getitem__(key)
            time.sleep(0)
            return value

    counts = Yielding(LAUNCHES=0)
    n_threads, each = 16, 500

    def work():
        for _ in range(each):
            _build.count_launch(counts, "LAUNCHES")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert counts["LAUNCHES"] == n_threads * each
