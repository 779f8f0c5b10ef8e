"""The port's host IO and console against the JAX package's.

The on-disk snapshot crosses both ways leaf for leaf (a port file through
the JAX package's own `load_session_snapshot`, a JAX file into the port's),
and a port file brings back the port's own state (the vocabulary's
training pool and `retrained` flag, the draw source's position). A `.mgts`
capture written by either package reads in the other, byte for byte the
same file, and the native loader's frames equal `CaptureReader`'s. The
console on the first photoreal frames (tests/data/torch_port_photoreal.npz,
the JAX run's draws replayed) writes the rows of a direct session's
`fossilize`, byte for byte as the JAX package's `write_pose_csv` writes
them; the evaluate CLI reads them as the JAX one does. All exact.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from mageslam_tpu.apps import console as jax_console
from mageslam_tpu.apps import evaluate as jax_evaluate
from mageslam_tpu.apps.loop_eval import loop_profile_settings as jax_loop_profile
from mageslam_tpu.config import golden_path_settings as jax_golden_path_settings
from mageslam_tpu.io import capture as jax_capture
from mageslam_tpu.io.snapshot import load_session_snapshot as jax_load
from mageslam_tpu.io.snapshot import save_session_snapshot as jax_save
from mageslam_tpu.runtime import SlamSession as JaxSession
from mageslam_tpu_torch import SlamSession, bench_world, golden_path_settings
from mageslam_tpu_torch.apps import console, evaluate
from mageslam_tpu_torch.apps.loop_eval import loop_profile_settings
from mageslam_tpu_torch.interop import to_numpy
from mageslam_tpu_torch.io import capture
from mageslam_tpu_torch.io.native_loader import NativeFrameLoader, native_available
from mageslam_tpu_torch.io.snapshot import load_session_snapshot, save_session_snapshot
from mageslam_tpu_torch.runtime.draws import ReplayDraws

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAM = os.path.join(REPO, "tests", "data", "torch_port_stream.npz")
PHOTOREAL = os.path.join(REPO, "tests", "data", "torch_port_photoreal.npz")
CAM = np.float32([520.0, 520.0, 320.0, 240.0])
CONSOLE_FRAMES = 9


@pytest.fixture(scope="module")
def photoreal():
    with np.load(PHOTOREAL) as z:
        return {k: z[k] for k in ("frames", "timestamps", "cam", "gt_c")}


def jax_leaves(sess) -> dict[str, np.ndarray]:
    out = {}
    for prefix, state in (("map", sess.map), ("hist", sess.history),
                          ("ph", sess.pose_history), ("bow", sess.bow)):
        out.update({f"{prefix}{i}": np.asarray(leaf)
                    for i, leaf in enumerate(jax.tree.flatten(state)[0])})
    return out


def port_leaves(sess) -> dict[str, np.ndarray]:
    out = {}
    for prefix, state in (("map", sess.map), ("hist", sess.history),
                          ("ph", sess.pose_history), ("bow", sess.bow)):
        out.update({f"{prefix}{i}": v for i, v in enumerate(to_numpy(state).values())})
    return out


COUNTERS = ("initialized", "lost_count", "frames_since_keyframe", "frames_since_reloc",
            "map_scale", "last_kf_slot")


@pytest.fixture(scope="module")
def port_file(tmp_path_factory):
    """A port session on from the stream fixture's frame-30 state over
    frames 31-32, saved by the port."""
    sess = SlamSession.from_jax_snapshot(STREAM, golden_path_settings(), CAM, 640, 480,
                                         device="cpu")
    for i, img in zip((31, 32), bench_world.frames(31, 33)):
        sess.process_frame(img, i * 0.033, i)
    path = str(tmp_path_factory.mktemp("snap") / "port.npz")
    save_session_snapshot(path, sess)
    return path, sess


def test_port_snapshot_loads_into_jax(port_file):
    path, sess = port_file
    jsess = JaxSession(jax_golden_path_settings(), cam=CAM, image_width=640, image_height=480)
    jax_load(path, jsess)
    got, want = jax_leaves(jsess), port_leaves(sess)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    for c in COUNTERS:
        assert getattr(jsess, c) == getattr(sess, c), c


def test_jax_snapshot_loads_into_port(port_file, tmp_path):
    """A file the JAX package writes loads into the port leaf for leaf. The
    JAX load path leaves the vocabulary's `retrained` flag as the session
    had it; `from_jax_snapshot` counts an initialized snapshot as retrained."""
    path, _ = port_file
    jsess = JaxSession(jax_golden_path_settings(), cam=CAM, image_width=640, image_height=480)
    jax_load(path, jsess)
    jax_path = str(tmp_path / "jax.npz")
    jax_save(jax_path, jsess)
    sess = SlamSession(golden_path_settings(), CAM, 640, 480, device="cpu")
    load_session_snapshot(jax_path, sess)
    got, want = port_leaves(sess), jax_leaves(jsess)
    for k, v in want.items():
        assert np.array_equal(got[k], v), k
    for c in COUNTERS:
        assert getattr(sess, c) == getattr(jsess, c), c
    assert sess.bow_training.retrained is False
    assert SlamSession.from_jax_snapshot(jax_path, golden_path_settings(), CAM, 640, 480,
                                         device="cpu").bow_training.retrained is True


def test_port_snapshot_keeps_the_port_state(photoreal, tmp_path):
    """Before init: the training pool, its frame count, `retrained` and the
    replayed draws' position come back from a port file."""
    draws = ReplayDraws.from_npz(PHOTOREAL, "cpu")
    sess = SlamSession(golden_path_settings(), photoreal["cam"], 320, 180, device="cpu",
                       draws=draws)
    for i in range(3):
        sess.process_frame(photoreal["frames"][i], float(photoreal["timestamps"][i]), i)
    path = str(tmp_path / "pre.npz")
    save_session_snapshot(path, sess)
    fresh = SlamSession(golden_path_settings(), photoreal["cam"], 320, 180, device="cpu",
                        draws=ReplayDraws.from_npz(PHOTOREAL, "cpu"))
    load_session_snapshot(path, fresh)
    bt, ft = sess.bow_training, fresh.bow_training
    assert (ft.retrained, ft.frames, len(ft.pool)) == (bt.retrained, bt.frames, len(bt.pool))
    for (d0, v0), (d1, v1) in zip(bt.pool, ft.pool):
        assert torch.equal(d0, d1) and torch.equal(v0, v1)
    assert fresh.draws.position() == sess.draws.position()


def test_generator_state_crosses_only_to_its_own_device(port_file, tmp_path):
    """A port file keeps the draw generator's position for a session on the
    same kind of device. A file from a card session cannot go into a CPU
    session's generator (the two states differ in kind), nor a generator's
    state into replayed draws: the loader raises, and with
    `restore_draws=False` leaves the session's draws where they are."""
    path, sess = port_file
    fresh = SlamSession(golden_path_settings(), CAM, 640, 480, device="cpu", seed=5)
    load_session_snapshot(path, fresh)
    assert torch.equal(fresh.draws.position(), sess.draws.position())
    replayed = SlamSession(golden_path_settings(), CAM, 640, 480, device="cpu",
                           draws=ReplayDraws({}, "cpu"))
    with pytest.raises(ValueError, match="restore_draws=False"):
        load_session_snapshot(path, replayed)
    assert not replayed.initialized          # nothing restored
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    port = json.loads(bytes(arrays["port_meta_json"]).decode())
    port["draws_device"] = "cuda"
    arrays["port_meta_json"] = np.frombuffer(json.dumps(port).encode(), dtype=np.uint8)
    arrays["port_draws_state"] = np.zeros(16, np.uint8)
    card_path = str(tmp_path / "card.npz")
    np.savez(card_path, **arrays)
    fresh = SlamSession(golden_path_settings(), CAM, 640, 480, device="cpu", seed=5)
    before = fresh.draws.position()
    with pytest.raises(ValueError, match="cuda generator's state"):
        load_session_snapshot(card_path, fresh)
    load_session_snapshot(card_path, fresh, restore_draws=False)
    assert torch.equal(fresh.draws.position(), before)
    assert fresh.initialized == sess.initialized


# ---------------------------------------------------------------- capture ----

def write_capture(module, path, frames, timestamps, cam16):
    header = module.CaptureHeader(frames.shape[2], frames.shape[1], cam16, "rig")
    with module.CaptureWriter(path, header) as w:
        for i, (px, ts) in enumerate(zip(frames, timestamps)):
            w.write_frame(px, float(ts), i)


def read_capture(module, path):
    with module.CaptureReader(path) as r:
        header = r.header
        frames = [(px.copy(), ts, fid) for px, ts, fid in r.frames()]
    return header, frames


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_capture_crosses_between_packages(photoreal, tmp_path, writer):
    frames, ts = photoreal["frames"][:4], photoreal["timestamps"][:4]
    cam16 = np.arange(16, dtype=np.float32)
    mods = {"jax": jax_capture, "port": capture}
    paths = {}
    for name, mod in mods.items():
        paths[name] = str(tmp_path / f"{name}.mgts")
        write_capture(mod, paths[name], frames, ts, cam16)
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    reader = mods["port" if writer == "jax" else "jax"]
    header, got = read_capture(reader, paths[writer])
    assert (header.width, header.height, header.device) == (320, 180, "rig")
    assert np.array_equal(header.cam, cam16)
    assert len(got) == 4
    for (px, t, fid), i in zip(got, range(4)):
        assert np.array_equal(px, frames[i]) and t == ts[i] and fid == i


@pytest.mark.skipif(not native_available(), reason="native/libframe_loader.so not built")
def test_native_loader_equals_capture_reader(photoreal, tmp_path):
    path = str(tmp_path / "c.mgts")
    write_capture(capture, path, photoreal["frames"][:5], photoreal["timestamps"][:5],
                  np.zeros(16, np.float32))
    _, want = read_capture(capture, path)
    loader = NativeFrameLoader(path, 320, 180)
    got = list(loader.frames())
    loader.close()
    assert len(got) == len(want)
    for (a, ta, fa), (b, tb, fb) in zip(got, want):
        assert np.array_equal(a, b) and ta == tb and fa == fb


# ---------------------------------------------------------------- console ----

def test_console_writes_a_direct_sessions_fossilize(photoreal, tmp_path):
    """The console over a capture of the first photoreal frames (on the
    CPU, the JAX run's draws replayed) writes the rows of a direct
    session's `fossilize`, byte for byte as JAX's `write_pose_csv`; the
    evaluate CLI reads them as JAX's does."""
    n = CONSOLE_FRAMES
    cap_path, out = str(tmp_path / "p.mgts"), str(tmp_path / "t.csv")
    write_capture(capture, cap_path, photoreal["frames"][:n], photoreal["timestamps"][:n],
                  np.zeros(16, np.float32))
    fx, fy, cx, cy = (str(v) for v in photoreal["cam"].tolist())
    assert console.main([cap_path, "-o", out, "--device", "cpu", "--draws", PHOTOREAL,
                         "--fx", fx, "--fy", fy, "--cx", cx, "--cy", cy,
                         "--global-ba-steps", "3"]) == 0
    sess = SlamSession(golden_path_settings(), photoreal["cam"], 320, 180, device="cpu",
                       draws=ReplayDraws.from_npz(PHOTOREAL, "cpu"))
    for i in range(n):
        sess.process_frame(photoreal["frames"][i], float(photoreal["timestamps"][i]), i)
    ids, mats = sess.fossilize(3)
    assert len(ids) >= 4
    want = str(tmp_path / "jax.csv")
    jax_console.write_pose_csv(want, ids, mats, [photoreal["timestamps"][int(i)] for i in ids])
    with open(out, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    for got, ref in zip(evaluate.load_trajectory_csv(out), jax_evaluate.load_trajectory_csv(out)):
        assert np.array_equal(got, ref)
    gt = str(tmp_path / "gt.txt")
    with open(gt, "w") as f:
        for t, c in zip(photoreal["timestamps"][:n], photoreal["gt_c"][:n]):
            f.write(f"{t:.6f} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f} 0 0 0 1\n")
    for got, ref in zip(evaluate.load_tum_groundtruth(gt), jax_evaluate.load_tum_groundtruth(gt)):
        assert np.array_equal(got, ref)
    assert evaluate.main([out, gt]) == 0


def test_console_without_cv2_is_a_clear_error(tmp_path, monkeypatch):
    import builtins

    real = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError("no cv2")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(SystemExit, match="need OpenCV"):
        console.main([str(tmp_path / "clip.mp4"), "--device", "cpu"])


def test_loop_profile_settings_match_jax():
    assert dataclasses.asdict(loop_profile_settings()) == \
        dataclasses.asdict(jax_loop_profile())

