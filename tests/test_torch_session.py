"""The port's tracking slice against a live JAX session.

A JAX `SlamSession` runs bench.py's world over frames 0-30 through
`process_frame` and is saved with `save_session_snapshot`. The port loads
that file; then frames 31-36 go through both sessions. Tolerances: states
and keyframe flags identical, tracked count within 2, pose atol 4e-4 (the
reference's own chunk-vs-sync reassociation bound, tests/test_pipeline.py),
associations equal on at least 99 % of valid keypoints.

The same live run also checks the committed fixture that chip_smoke.py
reads (tools/export_jax_state.py wrote it): its state leaves and its stored
outputs for frames 31-36.
"""

import ast
import importlib.util
import os
import subprocess
import sys

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch

from mageslam_tpu.geometry.se3 import Pose as JaxPose
from mageslam_tpu_torch import SlamSession, TrackingState, golden_path_settings
from mageslam_tpu_torch.interop import PREFIXES, leaf_names, load_jax_snapshot, to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_bench640_f30.npz")
WINDOW = range(31, 37)


def _load_tool():
    spec = importlib.util.spec_from_file_location(
        "export_jax_state", os.path.join(REPO, "tools", "export_jax_state.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_leaves(state) -> dict:
    """{leaf name: array} of a JAX state NamedTuple, names from its own fields."""
    out = {}
    for f in type(state)._fields:
        v = getattr(state, f)
        parts = {f"{f}.R": v.R, f"{f}.t": v.t} if isinstance(v, JaxPose) else {f: v}
        out.update({k: np.asarray(a) for k, a in parts.items()})
    return out


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    tool = _load_tool()
    frames = tool.bench_frames(WINDOW.stop)
    snap = str(tmp_path_factory.mktemp("snap") / "snap.npz")
    sess = tool.run_to_snapshot(frames, snap)
    leaves = {"map": _jax_leaves(sess.map), "hist": _jax_leaves(sess.history),
              "ph": _jax_leaves(sess.pose_history)}
    ref = tool.record_window(sess, frames, WINDOW.start, WINDOW.stop)
    return {"tool": tool, "frames": frames, "snap": snap, "leaves": leaves, "ref": ref}


def test_interop_round_trip(jax_run):
    states = load_jax_snapshot(jax_run["snap"], "cpu")
    for (prefix, cls), state in zip(PREFIXES, states):
        want = jax_run["leaves"][prefix]
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


def test_committed_fixture_matches_live_jax_run(jax_run):
    live = np.load(jax_run["snap"])
    with np.load(FIXTURE) as z:
        fixed = {k: z[k] for k in z.files}
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


def test_slice_tracks_like_jax(jax_run):
    ref = jax_run["ref"]
    sess = SlamSession.from_jax_snapshot(jax_run["snap"], golden_path_settings(),
                                         jax_run["tool"].CAM, 640, 480, "cpu")
    for j, i in enumerate(WINDOW):
        r = sess.process_frame(jax_run["frames"][i], i * 0.033, i)
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
    sess = SlamSession(golden_path_settings(), (520.0, 520.0, 320.0, 240.0), 640, 480)
    with pytest.raises(NotImplementedError, match="mono initialization"):
        sess.process_frame(np.zeros((480, 640), np.uint8), 0.0, 0)
    lost = SlamSession.from_jax_snapshot(FIXTURE, golden_path_settings(),
                                         (520.0, 520.0, 320.0, 240.0), 640, 480)
    blank = np.zeros((480, 640), np.uint8)
    states = [lost.process_frame(blank, 1.0 + k * 0.033, 100 + k).state for k in range(3)]
    assert states == [TrackingState.SKIPPED, TrackingState.SKIPPED,
                      TrackingState.RELOCALIZING]
    assert not lost.history.valid.any()
    with pytest.raises(NotImplementedError, match="relocalization"):
        lost.process_frame(blank, 2.0, 200)


def test_port_runs_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import numpy as np, bench, mageslam_tpu_torch as m\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'mageslam_tpu.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "pts, patches = bench.build_world(np.random.RandomState(7))\n"
        "img = np.clip(bench.render(pts, patches, 31 * 0.033), 0, 255).astype(np.uint8)\n"
        f"s = m.SlamSession.from_jax_snapshot({FIXTURE!r}, m.golden_path_settings(),\n"
        "                                    (520., 520., 320., 240.), 640, 480)\n"
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
