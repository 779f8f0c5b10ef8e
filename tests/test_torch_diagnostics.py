"""The port's diagnostics (mageslam_tpu_torch/diagnostics, the session's
checkpoint sites and the stream path's state digest) against the JAX
package's.

Live against JAX on seeded numpy data: `hash_tree` on every leaf kind,
the Determinator's stream and divergence records, the metric channels,
the introspection log, the xray decorator's records and an XRay capture
(byte-equal JSON, `diff_dumps` across the packages clean). From
tests/data/torch_port_diag.npz (`python tools/export_jax_state.py diag`):
the JAX stream call's 20-column summaries and the digest's inputs at
three of its frames (that call's checkpoint stream is held by
tests/test_torch_stream.py on its shared stream run); the checkpoint
stream of the photoreal session
(tests/data/torch_port_photoreal.npz, its draws replayed) over frames 0-7
per frame: mono init, the adoption at 5 and the keyframes 6 and 7 mapped;
the xray captures of one loop closure on tests/data/torch_port_loop.npz's
scene `a`.

Tolerances: hashes, digests, names and records exact. A checkpoint's hash
equals JAX's where its tree holds integers and flags only and they agree:
`Post.KeyframeDecision`, `Mapping.Map` (and `LoopClosure.Detect` where
nothing is detected). Float trees differ in the last bits (sums in another
order), and `DTYPE_SITES` differ by dtype alone. The xray captures keep
every path, dtype and shape; values within the loop-closure test's
tolerances (tests/test_torch_loop_closure.py: 1e-4, global BA's free gauge
1e-2 raw).
"""

import torch_threads  # noqa: F401  (first: torch's OpenMP threads wait passively)

import dataclasses
import filecmp
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mageslam_tpu import config as jconfig
from mageslam_tpu import diagnostics as jdiag
from mageslam_tpu.diagnostics import trace as jtrace
from mageslam_tpu.geometry.se3 import Pose as JPose
from mageslam_tpu_torch import SlamSession, bench_world, golden_path_settings
from mageslam_tpu_torch import config as pconfig
from mageslam_tpu_torch import diagnostics as pdiag
from mageslam_tpu_torch.bow.index import BowIndex
from mageslam_tpu_torch.config import Budgets, CameraIdentity
from mageslam_tpu_torch.diagnostics import trace as ptrace
from mageslam_tpu_torch.geometry.se3 import Pose
from mageslam_tpu_torch.interop import unflatten
from mageslam_tpu_torch.ops.digest import state_digest
from mageslam_tpu_torch.runtime import streaming
from mageslam_tpu_torch.runtime.draws import ReplayDraws
from mageslam_tpu_torch.tracking.frame_state import TrackedFrame
from mageslam_tpu_torch.worldmap.map_state import MapState

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIAG = os.path.join(REPO, "tests", "data", "torch_port_diag.npz")
STREAM = os.path.join(REPO, "tests", "data", "torch_port_stream.npz")
PHOTOREAL = os.path.join(REPO, "tests", "data", "torch_port_photoreal.npz")
LOOP = os.path.join(REPO, "tests", "data", "torch_port_loop.npz")
CAM = np.float32([520.0, 520.0, 320.0, 240.0])
DT = 0.033
# sites whose trees differ from JAX's by dtype alone, with the reason
DTYPE_SITES = {"Init.Adopt.Bow": "anchors are int32 descriptor words here, uint32 in JAX"}
# sites hashed equal to JAX's on these windows: integer and flag trees
EXACT_SITES = ("Post.KeyframeDecision", "Mapping.Map")
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

# the digest's cases without JAX's value, as the card holds its kernel to them
DIGEST_CASES = chip_smoke.synthetic_digest_cases()


@pytest.fixture(scope="module")
def ref():
    with np.load(DIAG) as z:
        return {k: z[k] for k in z.files}


def names(arr) -> list[str]:
    return [n.decode() for n in arr.tolist()]


# ---- trace --------------------------------------------------------------- #
LEAVES = {
    "float32": lambda r: r.randn(5, 3).astype(np.float32),
    "int32": lambda r: r.randint(-9, 9, (4, 2)).astype(np.int32),
    "uint32": lambda r: r.randint(0, 2**32 - 1, (6,), dtype=np.uint64).astype(np.uint32),
    "bool": lambda r: r.rand(7) > 0.5,
    "uint8": lambda r: r.randint(0, 255, (3, 3)).astype(np.uint8),
    "0-d": lambda r: np.float32(r.randn()),
}


@pytest.mark.parametrize("kind", [*LEAVES, "pose", "nested"])
def test_hash_tree_equals_jax(kind):
    r = np.random.RandomState(len(kind))
    if kind in LEAVES:
        a = LEAVES[kind](r)
        jtree, ptree = jnp.asarray(a), torch.from_numpy(np.array(a))
        assert ptrace.hash_tree(a) == jtrace.hash_tree(a)     # numpy leaves alike
    elif kind == "pose":
        R, t = r.randn(4, 3, 3).astype(np.float32), r.randn(4, 3).astype(np.float32)
        jtree, ptree = JPose(jnp.asarray(R), jnp.asarray(t)), Pose(torch.from_numpy(R),
                                                                   torch.from_numpy(t))
    else:
        leaves = {k: f(r) for k, f in LEAVES.items() if k != "uint32"}
        jtree = {"z": [jnp.asarray(leaves["float32"]), None, 3],
                 "a": {"y": jnp.asarray(leaves["bool"]), "b": 2.5},
                 "m": (jnp.asarray(leaves["int32"]), jnp.asarray(leaves["uint8"]))}
        ptree = {"m": (torch.from_numpy(leaves["int32"]), torch.from_numpy(leaves["uint8"])),
                 "a": {"b": 2.5, "y": torch.from_numpy(leaves["bool"])},
                 "z": [torch.from_numpy(leaves["float32"]), None, 3]}
    assert ptrace.hash_tree(ptree) == jtrace.hash_tree(jtree)


def test_determinator_records_and_verifies_as_jax(tmp_path):
    a = np.arange(10.0, dtype=np.float32)
    seqs = {
        "same": [("stage1", a), ("stage2", a * 2)],
        "diverges": [("stage1", a), ("stage2", a * 3)],
        "renamed": [("stage1", a), ("other", a * 2)],
        "extra": [("stage1", a), ("stage2", a * 2), ("stage3", a)],
    }
    for pkg, mod, conv in ((ptrace, "p", torch.from_numpy), (jtrace, "j", jnp.asarray)):
        d = pkg.Determinator()
        d.check("stage1", conv(a))
        d.check("stage2", conv(a * 2), {"k": conv(a)})
        d.save(str(tmp_path / f"{mod}.json"))
    assert filecmp.cmp(tmp_path / "p.json", tmp_path / "j.json", shallow=False)
    for name, seq in seqs.items():
        got = []
        for pkg, conv in ((ptrace, torch.from_numpy), (jtrace, jnp.asarray)):
            v = pkg.Determinator()
            v.load_for_verify(str(tmp_path / "j.json"))
            for i, (stage, x) in enumerate(seq):
                v.check(stage, conv(x), *([{"k": conv(a)}] if i == 1 else []))
            got.append((v.is_deterministic, v.divergences))
        assert got[0] == got[1], name
        assert got[0][0] == (name == "same"), name
    off = ptrace.Determinator(enabled=False)
    off.check("stage1", a)
    assert off._stream == []


def test_metric_channels_and_introspection_match_jax(tmp_path):
    R = np.random.RandomState(1).randn(3, 3).astype(np.float32)
    t = np.float32([0.5, -1.0, 2.0])
    out = []
    for pkg, pose in ((pdiag, Pose(torch.from_numpy(R), torch.from_numpy(t))),
                      (jdiag, JPose(jnp.asarray(R), jnp.asarray(t)))):
        m = pkg.MetricChannels()
        seen = []
        m.subscribe("TrackLocalMap.NumMatchedKeypoints", lambda f, v: seen.append((f, v)))
        m.fire("TrackLocalMap.NumMatchedKeypoints", 3, 7)
        m.fire("Mappoints.Total", 4, 120.0)
        intr = pkg.Introspection(pkg.LogLevel.TRACKING | pkg.LogLevel.INITIALIZATION)
        observed = []
        intr.attach(observed.append)
        intr.log_pose(3, 12, pose)
        intr.log_match_counts(12, guided=40, local=55)
        intr.log_map_stats(12, 5, 300)
        intr.log(pkg.LogLevel.INITIALIZATION, "anchor", frame_id=2)
        path = tmp_path / f"{pkg.__name__}.jsonl"
        intr.dump(str(path))
        out.append((m.points("TrackLocalMap.NumMatchedKeypoints"), m.channels(), seen,
                    intr.events, observed, path.read_bytes()))
    assert out[0] == out[1]
    assert len(out[0][3]) == 3 and len(out[0][4]) == 4     # MAPPING filtered, observed


def test_xray_decorator_records_equal_jax():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    b = np.ones(3, np.int32)
    sinks = []
    for pkg, conv in ((ptrace, torch.from_numpy), (jtrace, jnp.asarray)):
        sink = []

        @pkg.xray("stage", sink)
        def f(x, y, scale):
            return {"sum": x + y, "pair": (x * scale, None)}

        f(conv(a), conv(b), 2.0)
        sinks.append(sink)
    assert sinks[0] == sinks[1]
    assert sinks[0][0]["outputs"]["sum"]["shape"] == [2, 3]


def _capture_tree(conv):
    r = np.random.RandomState(5)
    pose = (Pose if conv is torch.from_numpy else JPose)(
        conv(r.randn(2, 3, 3).astype(np.float32)), conv(r.randn(2, 3).astype(np.float32)))
    return ({"pose": pose, "ki": 4, "mask": conv(r.rand(5) > 0.5),
             "ids": [conv(np.arange(3, dtype=np.int32)), None]},
            {"mse": 0.25, "points": conv(r.randn(4, 3).astype(np.float32)),
             "words": conv(r.randint(0, 2**31, (2, 8)).astype(np.uint32))})


def test_xray_capture_is_the_jax_document(tmp_path):
    px = pdiag.XRay(str(tmp_path / "p"))
    jx = jdiag.XRay(str(tmp_path / "j"))
    pa = px.capture("GlobalBA", *_capture_tree(torch.from_numpy))
    ja = jx.capture("GlobalBA", *_capture_tree(jnp.asarray))
    assert os.path.basename(pa) == os.path.basename(ja) == "000000_GlobalBA.json"
    assert filecmp.cmp(pa, ja, shallow=False)
    assert pdiag.diff_dumps(pa, ja) == [] == jdiag.diff_dumps(ja, pa)


def test_diff_dumps_reports_divergence(tmp_path):
    x = pdiag.XRay(str(tmp_path), stages={"s"})
    assert not x.wants("other") and x.capture("other", {}, {}) is None
    p1 = x.capture("s", {"a": torch.arange(4.0)}, {"b": torch.ones((2, 2))})
    b = torch.ones((2, 2))
    b[0, 1] = 3.0
    p2 = x.capture("s", {"a": torch.arange(4.0)}, {"b": b})
    p3 = x.capture("s", {"a": torch.arange(4)}, {"b": b, "c": torch.zeros(1)})
    d = pdiag.diff_dumps(p1, p2)
    assert d == jdiag.diff_dumps(p1, p2)
    assert len(d) == 1 and d[0]["path"] == "outputs.b"
    assert d[0]["n_diff"] == 1 and d[0]["max_abs_delta"] == 2.0
    assert pdiag.diff_dumps(p1, p2, atol=2.5) == []
    d3 = pdiag.diff_dumps(p1, p3)
    assert d3 == jdiag.diff_dumps(p1, p3)
    assert [(e["path"], e["kind"]) for e in d3] == [
        ("inputs.a", "shape/dtype"), ("outputs.b", "value"), ("outputs.c", "missing")]


# ---- state digest -------------------------------------------------------- #
@pytest.mark.parametrize("j", [0, 1, 2])
def test_plain_digest_equals_jax_summary_column(ref, j):
    args = [torch.from_numpy(np.array(ref[f"dg{j}_{n}"]))
            for n in ("mp_pos", "kf_t", "mp_valid", "kf_valid", "fsk")]
    got = state_digest(*args)
    want = ref[f"dg{j}_digest"]
    assert got.shape == (1,) and got.dtype == torch.float32
    assert float(got[0]) == float(want) and float(want) > 0
    # the same value rides the JAX stream call's summary at that frame
    frame = int(ref[f"dg{j}_frame"])
    rows = ref["st_summary"].reshape(-1, 20)
    ids = np.arange(31, 31 + len(rows))
    assert rows[ids == frame, 19][0] == float(want)


def numpy_digest(mp_pos, kf_t, mp_valid, kf_valid, fsk) -> float:
    """mageslam_tpu/runtime/pipeline.py:1203-1216 in numpy's uint32
    arithmetic (products wrap mod 2^32, as jnp.uint32's)."""
    u32 = np.uint32
    bits = np.concatenate([np.asarray(mp_pos, np.float32).reshape(-1),
                           np.asarray(kf_t, np.float32).reshape(-1)]).view(u32)
    idx = np.arange(bits.size, dtype=u32)
    with np.errstate(over="ignore"):
        mixed = (bits ^ (bits >> u32(16))) * (u32(2654435761) + idx * u32(2246822519))
        h = u32(np.bitwise_xor.reduce(mixed, initial=u32(0)))
        h ^= u32(np.count_nonzero(mp_valid)) * u32(2654435769)
        h ^= np.asarray(fsk).astype(np.int32).astype(u32) * u32(40503)
        h ^= u32(np.count_nonzero(kf_valid)) * u32(668265263)
    return float(np.float32((h ^ (h >> u32(8))) & u32(0xFFFFFF)))


@pytest.mark.parametrize("name", list(DIGEST_CASES))
def test_plain_digest_equals_a_numpy_transcription(name):
    """state_digest_plain (the CPU path of ops/digest.state_digest) on every
    case chip_smoke.py holds the kernel to besides JAX's frames, the
    unaligned ones as row slices of larger tensors."""
    case = DIGEST_CASES[name]
    got = state_digest(*chip_smoke.digest_args(case, "cpu"))
    assert got.shape == (1,) and got.dtype == torch.float32
    assert float(got[0]) == numpy_digest(*chip_smoke.digest_arrays(case)), name


def test_digest_reads_every_input():
    r = np.random.RandomState(2)
    base = [r.randn(64, 3).astype(np.float32), r.randn(8, 3).astype(np.float32),
            r.rand(64) > 0.3, r.rand(8) > 0.5, np.int32(3)]

    def digest(a):
        return float(state_digest(*(torch.from_numpy(np.array(x)) for x in a))[0])

    d0 = digest(base)
    for i in range(5):
        moved = [np.array(x) for x in base]
        flat = moved[i].reshape(-1)
        if moved[i].dtype == bool:
            flat[1] = not flat[1]
        elif i == 4:
            moved[i] = np.int32(4)
        else:
            flat[5] = np.nextafter(flat[5], np.float32(np.inf))
        assert digest(moved) != d0, i
    assert 0 <= d0 < 2**24 and d0 == int(d0)


# ---- the session's checkpoints ------------------------------------------- #
def bench_settings():
    s = golden_path_settings()
    return dataclasses.replace(s, LoopClosureSettings=dataclasses.replace(
        s.LoopClosureSettings, MinKeyframe=3))


def stream_session(det) -> SlamSession:
    sess = SlamSession.from_jax_snapshot(
        STREAM, bench_settings(), CAM, 640, 480, device="cpu",
        draws=ReplayDraws.from_npz(STREAM, "cpu", kinds=("reloc",), prefix="s95_"),
        determinator=det)
    sess._chunk_pipeline_depth = 4
    return sess


@pytest.fixture(scope="module")
def frames():
    return np.stack(bench_world.frames(0, 33))


def test_summary_digest_column(ref, frames):
    """The 20th column holds the digest with a Determinator and 0 without
    one; the other columns are the same either way."""
    assert len(streaming.SUMMARY_COLUMNS) == 20 == ref["st_summary"].shape[-1]
    rows = []
    for det in (pdiag.Determinator(), None):
        sess = stream_session(det)
        sess.process_frames_chunked([frames[31], frames[32]], [31 * DT, 32 * DT], [31, 32])
        rows.append(sess._pending_chunks[0][1])
        m = sess.map
        assert float(rows[-1][-1, 19]) == (0.0 if det is None else float(state_digest(
            m.mp_pos, m.kf_pose.t, m.mp_valid, m.kf_valid, sess._dev_counters[0])[0]))
    assert torch.equal(rows[0][:, :19], rows[1][:, :19])
    assert (rows[0][:, 19] > 0).all() and not rows[1][:, 19].any()


@pytest.fixture(scope="module")
def per_frame_runs(tmp_path_factory):
    """The photoreal session over frames 0-7, recorded, then again from a
    bare session verifying against the recording."""
    with np.load(PHOTOREAL) as z:
        frames, ts, cam = z["frames"][:8], z["timestamps"][:8], z["cam"]
    path = str(tmp_path_factory.mktemp("det") / "photoreal.json")
    runs = []
    for _ in range(2):
        det = pdiag.Determinator()
        if runs:
            runs[0].save(path)
            det.load_for_verify(path)
        sess = SlamSession(golden_path_settings(), cam, 320, 180, device="cpu",
                           draws=ReplayDraws.from_npz(PHOTOREAL, "cpu"), determinator=det,
                           metrics=pdiag.MetricChannels(),
                           introspection=pdiag.Introspection(pdiag.LogLevel.ALL))
        res = [sess.process_frame(img, float(t), i) for i, (img, t) in enumerate(zip(frames, ts))]
        runs.append(det)
    return runs, sess, res


def test_per_frame_checkpoints_follow_jax(ref, per_frame_runs):
    (det, _), sess, res = per_frame_runs
    got = det._stream
    assert [r.is_keyframe for r in res] == ref["ph_is_kf"].tolist()
    assert [n for n, _ in got] == names(ref["ph_names"])
    exact = 0
    for (name, h), want in zip(got, ref["ph_hashes"].tolist()):
        if name in EXACT_SITES:
            assert h == want, name
            exact += 1
    assert exact == 4      # frames 6 and 7: a keyframe decision and the map each
    assert {"Init.Accepted", "Init.Adopt.Map", *DTYPE_SITES} <= {n for n, _ in got}
    ch, intr = sess.metrics, sess.introspection
    assert [f for f, _ in ch.points("TrackLocalMap.NumMatchedKeypoints")] == [6, 7]
    assert [f for f, _ in ch.points("Mappoints.Total")] == [6, 7]
    assert [e["event"] for e in intr.events] == ["pose", "map", "pose", "map"]


def test_two_identical_runs_replay_bit_identically(per_frame_runs):
    (first, again), _, _ = per_frame_runs
    assert again.is_deterministic and again._cursor == len(first._stream) > 10
    assert again._stream == first._stream


# ---- xray at the session's sites ----------------------------------------- #
def loop_settings():
    s = golden_path_settings()
    return dataclasses.replace(
        s, LoopClosureSettings=dataclasses.replace(
            s.LoopClosureSettings, EnableLoopClosure=True, MinKeyframe=5, MinClusterSize=2),
        Budgets=Budgets(MaxFeatures=64, MaxKeyframes=16, MaxMapPoints=256))


@pytest.mark.parametrize("stage,atol", [("LoopClosure.Detect", 1e-4), ("GlobalBA", 1e-2)])
def test_session_xray_captures_diff_against_jax(ref, tmp_path, stage, atol):
    with np.load(LOOP) as z:
        loop = {k: z[k] for k in z.files}
    sess = SlamSession(loop_settings(), loop["cam"], 320, 180, device="cpu",
                       draws=ReplayDraws({"reloc": [ref["xr_draws"]]}, "cpu"),
                       xray=pdiag.XRay(str(tmp_path / "port"), stages={stage}))
    sess.map = unflatten(MapState, "a_map", loop, "cpu")
    sess.bow = unflatten(BowIndex, "a_bow", loop, "cpu")
    sess.initialized, sess.last_kf_slot = True, 5
    frame = unflatten(TrackedFrame, "a_frame", loop, "cpu")
    assert sess._post_keyframe(frame, 5, None) is True
    (got,) = os.listdir(tmp_path / "port")
    jax_doc = tmp_path / "jax.json"
    jax_doc.write_bytes(bytes(ref["xr_detect_json" if stage != "GlobalBA" else "xr_gba_json"]))
    d = pdiag.diff_dumps(str(jax_doc), str(tmp_path / "port" / got), atol=atol)
    assert not [e for e in d if e["kind"] != "value"], d
    assert not d, d
    with open(tmp_path / "port" / got) as f:
        assert json.load(f)["stage"] == stage


# ---- settings ------------------------------------------------------------ #
def test_to_dict_and_camera_settings_equal_jax():
    assert pconfig.to_dict(golden_path_settings()) == jconfig.to_dict(
        jconfig.golden_path_settings())
    assert pconfig.to_dict(pconfig.MageSlamSettings()) == jconfig.to_dict(
        jconfig.MageSlamSettings())
    s, js = golden_path_settings(), jconfig.golden_path_settings()
    for cam in CameraIdentity:
        assert dataclasses.asdict(pconfig.get_settings_for_camera(s, cam)) == \
            dataclasses.asdict(jconfig.get_settings_for_camera(
                js, jconfig.CameraIdentity(int(cam))))
    with pytest.raises(ValueError):
        pconfig.get_settings_for_camera(s, 7)
