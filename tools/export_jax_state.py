"""Export a JAX session's tracking state and its reference outputs for the
PyTorch port (`mageslam_tpu_torch`).

Runs the JAX `SlamSession` through `process_frame` over bench.py's world
(`build_world(RandomState(7))`, 640x480, cam [520, 520, 320, 240], golden
settings) on the local CPU. After frame `SNAP_FRAME` it saves the session with
`mageslam_tpu.io.snapshot.save_session_snapshot`; over frames
`SNAP_FRAME+1 .. LAST_FRAME` it records what the JAX session computes per
frame (pose R/t, tracked count, keyframe flag, tracking state, and the frame's
keypoint -> map point associations). Both go into one `.npz`: the snapshot's
own keys plus `ref_*` keys.

The window is chosen so that no keyframe fires inside it except at its last
frame: mapping runs after a frame's pose and keyframe decision are made, so a
tracking-only session reproduces every output of the window.

    python tools/export_jax_state.py [out.npz]

Default output: tests/data/torch_port_bench640_f30.npz.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(REPO, "tests", "data", "torch_port_bench640_f30.npz")

SNAP_FRAME = 30
LAST_FRAME = 54
CAM = (520.0, 520.0, 320.0, 240.0)
DT = 0.033


def bench_frames(stop: int) -> list[np.ndarray]:
    """bench.py's rendered frames 0..stop-1, clipped and cast to uint8."""
    sys.path.insert(0, REPO)
    import bench

    pts, patches = bench.build_world(np.random.RandomState(7))
    return [np.clip(bench.render(pts, patches, i * DT), 0, 255).astype(np.uint8)
            for i in range(stop)]


def make_jax_session():
    import jax.numpy as jnp

    from mageslam_tpu.config import golden_path_settings
    from mageslam_tpu.runtime import SlamSession

    return SlamSession(golden_path_settings(), cam=jnp.asarray(CAM, jnp.float32),
                       image_width=640, image_height=480)


def run_to_snapshot(frames, snap_path: str):
    """Drive a JAX session over frames 0..SNAP_FRAME and save its snapshot."""
    from mageslam_tpu.io.snapshot import save_session_snapshot

    sess = make_jax_session()
    for i in range(SNAP_FRAME + 1):
        sess.process_frame(frames[i], i * DT, i)
    save_session_snapshot(snap_path, sess)
    return sess


def record_window(sess, frames, start: int, stop: int) -> dict:
    """Per-frame JAX outputs over frames start..stop-1 as `ref_*` arrays."""
    out = {k: [] for k in ("frame_id", "R", "t", "tracked", "is_kf", "state",
                           "assoc")}
    for i in range(start, stop):
        r = sess.process_frame(frames[i], i * DT, i)
        out["frame_id"].append(i)
        out["R"].append(np.asarray(r.pose.R) if r.pose is not None
                        else np.full((3, 3), np.nan, np.float32))
        out["t"].append(np.asarray(r.pose.t) if r.pose is not None
                        else np.full((3,), np.nan, np.float32))
        out["tracked"].append(r.tracked_count)
        out["is_kf"].append(r.is_keyframe)
        out["state"].append(r.state.value)
        # a tracked frame's associations are the newest tracking-history row
        # (mapping, when the frame is a keyframe, leaves the history alone)
        out["assoc"].append(np.asarray(sess.history.assoc[0]))
    return {
        "ref_frame_id": np.asarray(out["frame_id"], np.int32),
        "ref_R": np.asarray(out["R"], np.float32),
        "ref_t": np.asarray(out["t"], np.float32),
        "ref_tracked": np.asarray(out["tracked"], np.int32),
        "ref_is_kf": np.asarray(out["is_kf"], bool),
        "ref_state": np.asarray(out["state"], np.int32),
        "ref_assoc": np.asarray(out["assoc"], np.int32),
    }


def main(out_path: str = DEFAULT_OUT) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    frames = bench_frames(LAST_FRAME + 1)
    with tempfile.TemporaryDirectory() as tmp:
        snap = os.path.join(tmp, "snap.npz")
        sess = run_to_snapshot(frames, snap)
        with np.load(snap) as z:
            arrays = {k: z[k] for k in z.files}
    ref = record_window(sess, frames, SNAP_FRAME + 1, LAST_FRAME + 1)
    kf = ref["ref_is_kf"]
    if kf[:-1].any() or not kf[-1] or (ref["ref_state"] != 1).any():
        raise RuntimeError(
            f"window {SNAP_FRAME + 1}..{LAST_FRAME} is not an all-tracked "
            f"keyframe-free window ending in a keyframe: keyframes at "
            f"{ref['ref_frame_id'][kf].tolist()}, states "
            f"{ref['ref_state'].tolist()}")
    arrays.update(ref)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez_compressed(out_path, **arrays)
    print(f"wrote {out_path}: {os.path.getsize(out_path)} bytes, tracked "
          f"{ref['ref_tracked'].tolist()}")


if __name__ == "__main__":
    main(*sys.argv[1:])
