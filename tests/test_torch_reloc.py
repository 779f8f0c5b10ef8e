"""The port's relocalization against the JAX package's.

tests/data/torch_port_reloc.npz (`python tools/export_jax_state.py reloc`)
holds tests/test_bow_reloc.py's lost-and-relocalize session: every frame's
synthetic features, the JAX session's outputs, its snapshot after frame 29
(the last tracked frame before five garbage frames), the draws of its three
relocalizations (frames 33-35), and the first successful relocalization's
inputs and results. Tolerances: scores 1e-6, qualified candidates,
success, winning candidate and associations exact, pose 1e-4; the
session's states exact, tracked count within 3, pose within 1e-3.
"""

import torch_threads  # noqa: F401  (first: torch's OpenMP threads wait passively)

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mageslam_tpu.bow import add_keyframe as jax_add_keyframe
from mageslam_tpu.bow import compute_idf as jax_compute_idf
from mageslam_tpu.bow import empty_index as jax_empty_index
from mageslam_tpu.bow import query_keyframes as jax_query_keyframes
from mageslam_tpu.bow import train_vocabulary as jax_train_vocabulary
from mageslam_tpu_torch import SlamSession, TrackingState, golden_path_settings
from mageslam_tpu_torch.bow.index import BowIndex, query_keyframes
from mageslam_tpu_torch.interop import unflatten
from mageslam_tpu_torch.ops.frontend import FrameFeatures
from mageslam_tpu_torch.runtime.draws import ReplayDraws
from mageslam_tpu_torch.runtime.reloc_step import reloc_candidates, reloc_kwargs
from mageslam_tpu_torch.tracking.frame_state import TrackedFrame
from mageslam_tpu_torch.tracking.relocalization import relocalize
from mageslam_tpu_torch.worldmap.map_state import MapState

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_reloc.npz")
CHECKS = os.path.join(REPO, "tests", "data", "torch_port_init_checks.npz")
SNAP_FRAME = 29


@pytest.fixture(scope="module")
def ref():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def reloc_inputs(ref):
    return (unflatten(MapState, "relocin_map", ref, "cpu"),
            unflatten(BowIndex, "relocin_bow", ref, "cpu"),
            unflatten(TrackedFrame, "relocin_frame", ref, "cpu"))


def _as_tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy((a.view(np.int32) if a.dtype == np.uint32 else a).copy())


def test_query_keyframes_matches_fixture(ref, reloc_inputs):
    m, bow, frame = reloc_inputs
    s = golden_path_settings()
    scores, qualified = query_keyframes(
        bow, frame.desc, frame.kp_valid,
        qualifying_score=s.BagOfWordsSettings.QualifyingCandidateScore)
    np.testing.assert_allclose(scores.numpy(), ref["relocin_scores"], atol=1e-6)
    np.testing.assert_array_equal(qualified.numpy(), ref["relocin_qualified"])
    cand, cand_ok = reloc_candidates(s, m, bow, frame)
    np.testing.assert_array_equal(cand.numpy(), ref["relocin_cand"])
    np.testing.assert_array_equal(cand_ok.numpy(), ref["relocin_cand_ok"])


@pytest.mark.parametrize("exclude", [False, True])
def test_query_keyframes_matches_jax(exclude):
    """A trained 32-word index over four keyframes (test_bow_reloc.py's
    scene), queried with a subset of keyframe 2's descriptors, live
    against the JAX index."""
    rng = np.random.RandomState(0)
    pool = rng.randint(0, 2**31, (512, 8)).astype(np.uint32)
    banks = [rng.randint(0, 2**31, (128, 8)).astype(np.uint32) for _ in range(4)]
    idx = jax_empty_index(8, num_words=32)
    idx = idx._replace(anchors=jax_train_vocabulary(jnp.asarray(pool), jnp.ones(512, bool),
                                                    jax.random.PRNGKey(0), num_words=32),
                       trained=jnp.asarray(True))
    idx = jax_compute_idf(idx, jnp.asarray(pool), jnp.ones(512, bool))
    for k, b in enumerate(banks):
        idx = jax_add_keyframe(idx, jnp.int32(k), jnp.asarray(b), jnp.ones(128, bool))
    excl = np.zeros(8, bool)
    excl[2] = exclude
    want = jax_query_keyframes(idx, jnp.asarray(banks[2][:100]), jnp.ones(100, bool),
                               exclude=jnp.asarray(excl))
    port = BowIndex(*(_as_tensor(np.asarray(a)) for a in idx))
    got = query_keyframes(port, _as_tensor(banks[2][:100]), torch.ones(100, dtype=torch.bool),
                          exclude=torch.from_numpy(excl))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert bool(got[1][2]) is not exclude


def test_relocalize_matches_jax(ref, reloc_inputs):
    """The first successful relocalization (frame 35) with the JAX draws."""
    m, _, frame = reloc_inputs
    r = relocalize(frame, m, torch.from_numpy(ref["relocin_cand"]),
                   torch.from_numpy(ref["relocin_cand_ok"]),
                   torch.from_numpy(ref["relocin_draws"]),
                   **reloc_kwargs(golden_path_settings()))
    assert bool(r.succeeded) and bool(ref["relocin_out_succeeded"])
    assert int(r.candidate) == int(ref["relocin_out_candidate"])
    np.testing.assert_array_equal(r.assoc.numpy(), ref["relocin_out_assoc"])
    np.testing.assert_allclose(r.pose.R.numpy(), ref["relocin_out_R"], atol=1e-4)
    np.testing.assert_allclose(r.pose.t.numpy(), ref["relocin_out_t"], atol=1e-4)


def test_relocalize_without_candidates(reloc_inputs):
    """No qualified candidate: no success, no association."""
    m, _, frame = reloc_inputs
    r = relocalize(frame, m, torch.zeros(4, dtype=torch.int32),
                   torch.zeros(4, dtype=torch.bool), torch.zeros((4, 64, frame.desc.shape[0])),
                   **reloc_kwargs(golden_path_settings()))
    assert not bool(r.succeeded) and int(r.candidate) == -1
    assert bool(torch.all(r.assoc == -1))


def _features(ref, i) -> FrameFeatures:
    return FrameFeatures(*(_as_tensor(ref[f"feat{i}_{n}"]) for n in (
        "xy", "und_xy", "response", "octave", "angle", "desc", "valid")))


@pytest.fixture(scope="module")
def session_run(ref):
    """The port's session from the JAX state after frame 29, over the
    garbage frames 30-34 and the returned view 35-37, the JAX draws
    replayed."""
    W, H = (int(v) for v in ref["size"])
    # the draws of mono init and the vocabulary were used before frame 29
    draws = ReplayDraws.from_npz(FIXTURE, "cpu", kinds=("reloc",))
    sess = SlamSession.from_jax_snapshot(FIXTURE, golden_path_settings(), ref["cam"], W, H,
                                         device="cpu", draws=draws)
    results = [sess.process_features(_features(ref, i), i * 0.033, i)
               for i in range(SNAP_FRAME + 1, int(ref["n_frames"]))]
    return sess, results, draws


def test_session_lost_then_relocalized(ref, session_run):
    sess, results, draws = session_run
    first = SNAP_FRAME + 1
    want = ref["ref_state"][first:]
    assert [r.state.value for r in results] == want.tolist()
    assert TrackingState.RELOCALIZING in [r.state for r in results]
    assert results[-3].state == TrackingState.TRACKING      # the relocalized frame
    assert not any(r.is_keyframe for r in results[-3:])
    assert draws.remaining()["reloc"] == 0
    assert sess.lost_count == 0 and sess.frames_since_reloc == 2
    for r, i in zip(results, range(first, first + len(results))):
        assert abs(r.tracked_count - int(ref["ref_tracked"][i])) <= 3, i
        if r.pose is not None:
            np.testing.assert_allclose(r.pose.R.numpy(), ref["ref_R"][i], atol=1e-3)
            np.testing.assert_allclose(r.pose.t.numpy(), ref["ref_t"][i], atol=1e-3)


def test_session_relocalized_pose_near_last_view(ref, session_run):
    """test_bow_reloc.py's own check: the recovered pose is near the
    revisited viewpoint in map scale."""
    _, results, _ = session_run
    last_map_center = -ref["ref_R"][SNAP_FRAME].T @ ref["ref_t"][SNAP_FRAME]
    est_c = results[-1].pose.center().numpy()
    assert np.linalg.norm(est_c - last_map_center) < 0.1 * np.linalg.norm(last_map_center)


def test_mono_init_verdict_moves_with_float_width(ref):
    """ROADMAP queue 3 (found, not a fault): on this scene the JAX session's
    init attempts fail at frames 6 and 7 and adopt at 8 in float32; the
    reference's own attempt at frame 7 succeeds in float64 (its recorded
    draws, `jax.enable_x64`; tests/data/torch_port_init_checks.npz), and
    the port (its 5-point solve in float64) succeeds at 6. The gates decide these borderline attempts by rounding;
    the tests start relocalization from the JAX state after frame 29."""
    from mageslam_tpu_torch.tracking import map_init

    names = ("xy1", "desc1", "valid1", "xy2", "desc2", "valid2")
    settings = map_init.init_settings(golden_path_settings())
    att = {int(ref[f"init_att{j}_frame"]): f"init_att{j}_"
           for j in range(int(ref["init_n_attempt"]))}
    assert [bool(ref[att[f] + "succeeded"]) for f in (6, 7, 8)] == [False, False, True]
    p = att[6]
    res = map_init.try_initialize_pair(*(_as_tensor(ref[p + n]) for n in names),
                                       _as_tensor(ref["cam"]), _as_tensor(ref[p + "draws"]),
                                       settings)
    assert bool(res.succeeded) and int(res.point_valid.sum()) == 276

    # the reference's own attempt at frame 7 in float64, as `tools/
    # export_jax_state.py init_checks` solved it (the recorded float32 draws
    # widened, the LM's lambda in float64)
    with np.load(CHECKS) as z:
        assert z["fw_dtype"].item() == b"float64"
        assert bool(z["fw_succeeded"]) and int(z["fw_points"]) == 276
