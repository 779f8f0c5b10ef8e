"""The port's tracking slice against the JAX session, and the committed
fixtures that chip_smoke.py reads against live JAX.

tests/data/torch_port_bench640_f30.npz (tools/export_jax_state.py) holds
the JAX session's state after bench.py's frames 0-30
(`save_session_snapshot`) and its outputs over frames 31-54. The port loads
that state and tracks frames 31-36. Tolerances: states and keyframe flags
identical, tracked count within 2, pose atol 4e-4 (the reference's own
chunk-vs-sync reassociation bound, tests/test_pipeline.py), associations
equal on at least 99 % of valid keypoints.

Live JAX holds the fixtures: a JAX session restored from the committed
state (the reference's own loader) tracks frames 31-36 and gives the
fixture's outputs and, saved again, its state leaves; every draw of the
init fixture equals JAX's draw from its recorded key, and every recorded
init attempt, run again from its recorded inputs and key, gives the
recorded result.
"""

import torch_threads  # noqa: F401  (first: torch's OpenMP threads wait passively)

import ast
import dataclasses
import importlib.util
import os
import subprocess
import sys
import typing

import jax
import numpy as np
import pytest
import torch

from mageslam_tpu.geometry.se3 import Pose as JaxPose
from mageslam_tpu_torch import SlamSession, TrackingState, golden_path_settings
from mageslam_tpu_torch.bow.index import BowIndex
from mageslam_tpu_torch.fuser import Fuser, SampleType, SensorSample
from mageslam_tpu_torch.interop import PREFIXES, leaf_names, load_jax_snapshot, to_numpy

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_bench640_f30.npz")
INIT_FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_bench640_init.npz")
WINDOW = range(31, 37)
CAM = np.float32([520.0, 520.0, 320.0, 240.0])


def _load_tool():
    spec = importlib.util.spec_from_file_location(
        "export_jax_state", os.path.join(REPO, "tools", "export_jax_state.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_leaf_names(cls) -> list[str]:
    """Leaf names of a JAX state NamedTuple in flatten order, from its own
    fields: a Pose field `f` gives `f.R` and `f.t`."""
    hints = typing.get_type_hints(cls)
    return [n for f in cls._fields
            for n in ([f"{f}.R", f"{f}.t"] if hints[f] is JaxPose else [f])]


def _file_leaves(data: dict, prefix: str, cls) -> dict:
    """{leaf name: array} of the `{prefix}{i}` arrays of a snapshot file,
    named by the JAX class's fields."""
    names = _jax_leaf_names(cls)
    assert f"{prefix}{len(names)}" not in data and f"{prefix}{len(names) - 1}" in data
    return {n: data[f"{prefix}{i}"] for i, n in enumerate(names)}


@pytest.fixture(scope="module")
def committed():
    from mageslam_tpu.bow.index import BowIndex as JaxBowIndex
    from mageslam_tpu.runtime.pose_history import PoseHistory as JaxPoseHistory
    from mageslam_tpu.tracking.frame_state import TrackingHistory as JaxTrackingHistory
    from mageslam_tpu.worldmap.map_state import MapState as JaxMapState

    with np.load(FIXTURE) as z:
        data = {k: z[k] for k in z.files}
    classes = {"map": JaxMapState, "hist": JaxTrackingHistory, "ph": JaxPoseHistory,
               "bow": JaxBowIndex}
    return {"data": data, "leaves": {p: _file_leaves(data, p, c) for p, c in classes.items()}}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX session restored from the committed state over frames 31-36,
    and its state saved again before them."""
    from mageslam_tpu.io.snapshot import load_session_snapshot, save_session_snapshot

    tool = _load_tool()
    frames = tool.bench_frames(WINDOW.stop)
    sess = tool.make_jax_session()
    load_session_snapshot(FIXTURE, sess)
    snap = str(tmp_path_factory.mktemp("snap") / "snap.npz")
    save_session_snapshot(snap, sess)
    ref = tool.record_window(sess, frames, WINDOW.start, WINDOW.stop)
    return {"tool": tool, "frames": frames, "snap": snap, "ref": ref}


def test_interop_round_trip(committed):
    """The port loads the JAX package's snapshot: every leaf, named by the
    JAX classes' own fields, bit for bit."""
    states = load_jax_snapshot(FIXTURE, "cpu")
    for (prefix, cls), state in zip(PREFIXES, states):
        want = committed["leaves"][prefix]
        got = to_numpy(state)
        assert leaf_names(cls) == list(want) == list(got), prefix
        for name, arr in want.items():
            assert got[name].dtype == arr.dtype and got[name].shape == arr.shape, name
            np.testing.assert_array_equal(np.atleast_1d(got[name]).view(np.uint8),
                                          np.atleast_1d(arr).view(np.uint8), err_msg=name)
    meta = states[3]
    assert meta["initialized"] and (meta["width"], meta["height"]) == (640, 480)
    # descriptor bits cross as int32 views, sign bit included
    assert (states[0].kf_desc < 0).any()
    # the bag-of-words index too, its anchors as descriptor words
    bow = states[4]
    assert isinstance(bow, BowIndex) and (bow.anchors < 0).any()
    got = to_numpy(bow)
    assert list(got) == leaf_names(BowIndex) == list(committed["leaves"]["bow"])
    for name, arr in committed["leaves"]["bow"].items():
        assert got[name].dtype == arr.dtype and got[name].shape == arr.shape, name
        np.testing.assert_array_equal(np.atleast_1d(got[name]).view(np.uint8),
                                      np.atleast_1d(arr).view(np.uint8), err_msg=name)


def test_committed_fixture_matches_live_jax_run(jax_run, committed):
    """A live JAX session restored from the committed state gives its
    leaves back and the fixture's outputs over frames 31-36."""
    live = np.load(jax_run["snap"])
    fixed = committed["data"]
    keys = [k for k in live.files if k.startswith(("map", "hist", "ph"))]
    assert keys and all(k in fixed for k in keys)
    for k in keys + ["meta_json"]:
        a, b = live[k], fixed[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)
    ref = jax_run["ref"]
    n = len(WINDOW)
    for k, v in ref.items():
        if v.dtype.kind == "f":
            np.testing.assert_allclose(fixed[k][:n], v, rtol=0, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(fixed[k][:n], v, err_msg=k)


def test_init_fixture_matches_live_jax_run():
    """The init fixture's record of frames 0-30 against live JAX: every
    draw equals `jax.random.gumbel` of its recorded key (the vmapped draw
    over the key's splits for the attempts and the third-frame check), and
    every attempt, run again from its recorded inputs and key, gives the
    recorded result: integers exact, floats within 1e-5."""
    import jax.numpy as jnp

    from mageslam_tpu.tracking import map_init as jax_map_init
    from mageslam_tpu_torch.tracking.map_init import init_settings

    with np.load(INIT_FIXTURE) as z:
        fixed = {k: z[k] for k in z.files}
    assert int(fixed["init_adopt_frame"]) == 7 and int(fixed["init_retrain_frame"]) == 14
    draw = jax.jit(lambda keys, shape: jax.vmap(lambda k: jax.random.gumbel(k, shape))(keys),
                   static_argnums=1)
    settings = jax_map_init.InitSettings(*init_settings(golden_path_settings()))
    names = ("xy1", "desc1", "valid1", "xy2", "desc2", "valid2")
    for j in range(int(fixed["init_n_attempt"])):
        p = f"init_att{j}_"
        d = fixed[p + "draws"]
        np.testing.assert_array_equal(
            np.asarray(draw(jax.random.split(fixed[p + "key"], d.shape[0]), d.shape[1:])), d)
        res = jax_map_init.try_initialize_pair(
            *(jnp.asarray(fixed[p + n]) for n in names), jnp.asarray(CAM),
            jnp.asarray(fixed[p + "key"]), settings, ransac_batch=d.shape[0])
        for name, got in (("succeeded", res.succeeded), ("point_valid", res.point_valid),
                          ("feat2", res.feat2), ("match_count", res.match_count),
                          ("pose2_R", res.pose2.R), ("pose2_t", res.pose2.t),
                          ("points", res.points)):
            want, got = fixed[p + name], np.asarray(got)
            if want.dtype.kind == "f":
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=p + name)
            else:
                np.testing.assert_array_equal(got, want, err_msg=p + name)
    for j in range(int(fixed["init_n_third"])):
        p = f"init_third{j}_"
        d = fixed[p + "draws"]
        np.testing.assert_array_equal(
            np.asarray(draw(jax.random.split(fixed[p + "key"], d.shape[0]), d.shape[1:])), d)
    for j in range(int(fixed["init_n_vocab"])):
        p = f"init_vocab{j}_"
        np.testing.assert_array_equal(
            np.asarray(jax.random.gumbel(fixed[p + "key"], fixed[p + "draws"].shape)),
            fixed[p + "draws"])


def test_slice_tracks_like_jax(committed):
    ref = committed["data"]
    frames = _load_tool().bench_frames(WINDOW.stop)
    sess = SlamSession.from_jax_snapshot(FIXTURE, golden_path_settings(),
                                         tuple(CAM.tolist()), 640, 480, "cpu")
    for j, i in enumerate(WINDOW):
        r = sess.process_frame(frames[i], i * 0.033, i)
        assert r.frame_id == i
        assert r.state.value == ref["ref_state"][j]
        assert r.is_keyframe == bool(ref["ref_is_kf"][j])
        assert abs(r.tracked_count - int(ref["ref_tracked"][j])) <= 2
        np.testing.assert_allclose(r.pose.R.numpy(), ref["ref_R"][j], atol=4e-4)
        np.testing.assert_allclose(r.pose.t.numpy(), ref["ref_t"][j], atol=4e-4)
        valid = sess.history.kp_xy[0, :, 0].numpy() > -1e5
        agree = (sess.history.assoc[0].numpy() == ref["ref_assoc"][j])[valid].mean()
        assert agree >= 0.99, f"frame {i}: assoc agreement {agree:.4f}"
    assert all(r.state == TrackingState.TRACKING for r in sess.results)


def test_untracked_paths_fail_loudly():
    # a bare session starts mono init: a blank frame becomes its anchor
    sess = SlamSession(golden_path_settings(), (520.0, 520.0, 320.0, 240.0), 640, 480,
                       device="cpu")
    r = sess.process_frame(np.zeros((480, 640), np.uint8), 0.0, 0)
    assert r.state == TrackingState.INITIALIZING and r.pose is None
    assert sess.init_window.anchor_meta == (0, 0.0) and not sess.initialized
    lost = SlamSession.from_jax_snapshot(FIXTURE, golden_path_settings(),
                                         (520.0, 520.0, 320.0, 240.0), 640, 480,
                                         device="cpu")
    blank = np.zeros((480, 640), np.uint8)
    states = [lost.process_frame(blank, 1.0 + k * 0.033, 100 + k).state for k in range(3)]
    assert states == [TrackingState.SKIPPED, TrackingState.SKIPPED,
                      TrackingState.RELOCALIZING]
    assert not lost.history.valid.any()
    # a lost session relocalizes; a blank frame has nothing to match
    r = lost.process_frame(blank, 2.0, 200)
    assert r.state == TrackingState.RELOCALIZING and r.pose is None
    assert lost.lost_count == 3
    # the visual-inertial fuser: a UseFuser session builds its Fuser on the
    # session's device, and add_sensor_sample reaches its queue
    s = golden_path_settings()
    fused = dataclasses.replace(s, FuserSettings=dataclasses.replace(s.FuserSettings,
                                                                     UseFuser=True))
    vi = SlamSession(fused, (520.0, 520.0, 320.0, 240.0), 640, 480, device="cpu")
    assert isinstance(vi.fuser, Fuser) and vi.fuser.device == vi.device
    assert vi.fuser.state.q.device == vi.device
    assert vi.fuser.filter_type == fused.FuserSettings.FilterType
    vi.add_sensor_sample(SensorSample(SampleType.ACCELEROMETER, 0.01,
                                      np.array([0.0, 0.0, 9.8], np.float32)))
    assert len(vi.fuser.queue) == 1
    assert sess.fuser is None


def test_port_runs_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import torch; torch.set_num_threads(2)\n"   # as the test files: the suite shares its cores
        "import mageslam_tpu_torch as m\n"
        "from mageslam_tpu_torch import bench_world\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'mageslam_tpu.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "img = bench_world.frames(31, 32)[0]\n"
        f"s = m.SlamSession.from_jax_snapshot({FIXTURE!r}, m.golden_path_settings(),\n"
        "                                    (520., 520., 320., 240.), 640, 480, 'cpu')\n"
        "print(s.process_frame(img, 31 * 0.033, 31).state.name)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "TRACKING"


def test_package_never_imports_jax():
    pkg = os.path.join(REPO, "mageslam_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in (f for f in files if f.endswith(".py")):
            with open(os.path.join(root, f)) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                         else [node.module or ""] if isinstance(node, ast.ImportFrom)
                         else [])
                for name in names:
                    top = name.split(".")[0]
                    assert top not in ("jax", "jaxlib", "mageslam_tpu"), (f, name)
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
