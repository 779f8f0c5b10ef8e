"""Where the port's stream-path orbit parts from the JAX package's.

tests/test_stream_loop_ci.py's orbit (324 frames at 240x135, period 288,
`loop_profile_settings`, chunks of 8) closes a second loop near frame 41
more often in the JAX package than in the port (tools/orbit_closures.py).
This tool starts both packages from one state and shows where they part:

1. A JAX session (key 11) runs frames 0-15 (0-7 per frame, then one chunk),
   drains, and is saved with the JAX package's `save_session_snapshot`
   (state S15); it goes on over 16-39, drains and is saved again (S39).
2. Keyframe 16's mapping event from S15: the port's mapping step runs on
   it, and the inputs it hands `create_new_map_points` go through the JAX
   package's `create_new_map_points` eagerly and jitted. Prints the new
   points each of the three creates.
3. Frames 16-47 from S15 in both packages (a fresh session each, loaded
   with each package's `load_session_snapshot`, chunks of 8, drained at
   the end): each frame's tracked counts, keyframe flags and the largest
   difference of t between the two, and the closures.
4. Frames 40-87 from S39 in both packages: the closures.

    python tools/orbit_divergence.py

JAX on the CPU, the port on the CPU; ~4 min on 8 cores. The frames come from
the cache tools/orbit_closures.py keeps in `.cache/`.
"""

from __future__ import annotations

import functools
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from orbit_closures import FRAMES, HEIGHT, WIDTH, load_frames  # noqa: E402

JAX_KEY, CHUNK = 11, 8


def host(x) -> np.ndarray:
    return np.asarray(x.cpu() if hasattr(x, "detach") else x)


class Package:
    """One package's session class, settings and snapshot IO."""

    def __init__(self, name: str):
        self.name = name
        if name == "jax":
            from mageslam_tpu.apps import loop_eval, render_scene
            from mageslam_tpu.io import snapshot
            from mageslam_tpu.runtime.pipeline import SlamSession
        else:
            from mageslam_tpu_torch.apps import loop_eval, render_scene
            from mageslam_tpu_torch.io import snapshot
            from mageslam_tpu_torch.runtime.session import SlamSession
        self.cls, self.settings, self.snapshot = SlamSession, loop_eval.loop_profile_settings(), \
            snapshot
        r = render_scene
        self.cam = np.array([r.FX * WIDTH / 640, r.FY * HEIGHT / 480, r.CX * WIDTH / 640,
                             r.CY * HEIGHT / 480], np.float32)
        self.closures: list = []
        real = SlamSession._apply_loop_closure

        def apply(sess, det, frame, ki):
            self.closures.append((int(host(frame.frame_id)),
                                  int(host(det.cluster_mask).sum()), float(host(det.scale))))
            return real(sess, det, frame, ki)

        SlamSession._apply_loop_closure = apply

    def session(self, seed: int, snapshot: str | None = None):
        cam = jnp.asarray(self.cam) if self.name == "jax" else self.cam
        kw = {} if self.name == "jax" else {"device": "cpu"}
        sess = self.cls(self.settings, cam=cam, image_width=WIDTH, image_height=HEIGHT,
                        seed=seed, **kw)
        if snapshot is not None:
            self.snapshot.load_session_snapshot(snapshot, sess)
        return sess


def run_chunks(sess, frames, lo: int, hi: int) -> list:
    """Frames [lo, hi) in chunks of CHUNK, drained; returns their results."""
    for b in range(lo, hi, CHUNK):
        ids = list(range(b, min(b + CHUNK, hi)))
        sess.process_frames_chunked([frames[i][0].astype(np.float32) for i in ids],
                                    [frames[i][1] for i in ids], ids)
    sess.flush_chunks()
    return sorted((r for r in sess.results if lo <= r.frame_id < hi), key=lambda r: r.frame_id)


def new_points(port: Package, frames, s15: str) -> None:
    """Step 2."""
    from mageslam_tpu.geometry.se3 import Pose as JPose
    from mageslam_tpu.worldmap.map_state import MapState as JMapState
    from mageslam_tpu.worldmap.new_points import create_new_map_points as jax_create
    from mageslam_tpu_torch import interop
    from mageslam_tpu_torch.runtime import mapping_step

    sess = port.session(0, s15)
    seen = {}
    real = mapping_step.create_new_map_points

    def capture(state, ki, covis, map_scale, **kw):
        out = real(state, ki, covis, map_scale, **kw)
        seen.update(state=interop.to_numpy(state), ki=int(ki), covis=host(covis),
                    map_scale=float(map_scale), kw=kw, created=int(out.created))
        return out

    mapping_step.create_new_map_points = capture
    try:
        sess.process_frame(frames[16][0].astype(np.float32), frames[16][1], 16)
    finally:
        mapping_step.create_new_map_points = real
    st = seen["state"]
    state = JMapState(**{f: (JPose(jnp.asarray(st[f + ".R"]), jnp.asarray(st[f + ".t"]))
                             if f + ".R" in st else jnp.asarray(st[f]))
                         for f in JMapState._fields})
    statics = {k: v for k, v in seen["kw"].items() if k != "fidx"}
    args = (state, jnp.int32(seen["ki"]), jnp.asarray(seen["covis"]),
            jnp.float32(seen["map_scale"]))
    fidx = jnp.asarray(host(seen["kw"]["fidx"]))
    eager = jax_create(*args, fidx=fidx, **statics)
    jitted = jax.jit(functools.partial(jax_create, **statics))(*args, fidx=fidx)
    differ = np.flatnonzero(host(eager.state.mp_valid) != host(jitted.state.mp_valid))
    print(f"keyframe 16's new points on the port's inputs: port {seen['created']}, JAX eager "
          f"{int(eager.created)}, JAX jitted {int(jitted.created)} (point slots that differ "
          f"between eager and jitted: {differ.tolist()})", flush=True)


def main() -> int:
    torch.set_num_threads(2)
    frames = load_frames(FRAMES)
    jax_pkg, port = Package("jax"), Package("port")
    with tempfile.TemporaryDirectory() as tmp:
        s15, s39 = os.path.join(tmp, "s15.npz"), os.path.join(tmp, "s39.npz")
        sess = jax_pkg.session(JAX_KEY)
        for i in range(CHUNK):
            sess.process_frame(frames[i][0].astype(np.float32), frames[i][1], i)
        run_chunks(sess, frames, CHUNK, 16)
        jax_pkg.snapshot.save_session_snapshot(s15, sess)
        run_chunks(sess, frames, 16, 40)
        jax_pkg.snapshot.save_session_snapshot(s39, sess)
        print(f"JAX key {JAX_KEY} over frames 0-39: closures (frame, cluster size, scale) "
              f"{jax_pkg.closures}", flush=True)

        new_points(port, frames, s15)

        runs = {}
        for pkg in (jax_pkg, port):
            pkg.closures.clear()
            runs[pkg.name] = run_chunks(pkg.session(0, s15), frames, 16, 48)
            print(f"{pkg.name} from S15 over 16-47: closures {pkg.closures}", flush=True)
        for a, b in zip(runs["jax"], runs["port"]):
            dt = float(np.abs(host(a.pose.t) - host(b.pose.t)).max()) \
                if a.pose is not None and b.pose is not None else float("nan")
            print(f"  frame {a.frame_id}: tracked JAX {a.tracked_count} port {b.tracked_count}, "
                  f"keyframe JAX {int(a.is_keyframe)} port {int(b.is_keyframe)}, |dt| {dt:.3g}")
        for pkg in (jax_pkg, port):
            pkg.closures.clear()
            run_chunks(pkg.session(0, s39), frames, 40, 88)
            print(f"{pkg.name} from S39 over 40-87: closures {pkg.closures}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
