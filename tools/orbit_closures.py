"""Loop closures of the stream-path orbit over many draw seeds.

Runs tests/test_stream_loop_ci.py's orbit (324 frames at 240x135, period
288, `run_orbit_eval(..., mode="stream")` with `loop_profile_settings`)
once a seed, with the port (`--package port`, on `--device cpu` or `cuda`)
or with the JAX package (`--package jax`, on the CPU; the seed is the
session's PRNG key), a few seeds at a time in worker processes. Prints one
JSON line a run: the seed, whether the run meets the CI test's gates (a loop
closed, tracked >= 100, ATE < 0.15 m), each closure's frame and keyframe
slot with the frame ids of the keyframes in its cluster, tracked, ATE and
loop_det_stats; then the closure rate over the seeds.

    python tools/orbit_closures.py --package port --device cpu --seeds 0-15 --procs 4
    python tools/orbit_closures.py --package jax --seeds 0-11 --procs 3
    python tools/orbit_closures.py --package port --device cuda --seeds 0,0,0,0,1-7

A seed may repeat (repeated runs on the card, where scatter-adds with atomics
can order their sums differently). Both packages run on the same frames, the
port's renderer's (checked against the JAX package's renderer before a JAX
run), cached in `.cache/` and rendered once where the file is missing. A
worker runs torch on 2 threads.
"""

from __future__ import annotations

import argparse
import functools
import json
import multiprocessing
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_FRAMES, PERIOD, WIDTH, HEIGHT = 324, 288, 240, 135   # tests/test_stream_loop_ci.py
TRACKED_MIN, ATE_LIMIT = 100, 0.15
FRAMES = os.path.join(REPO, ".cache", "orbit_324_240x135.npz")

_FRAMES: list = []


def seeds_arg(text: str) -> list[int]:
    """'0-3,7,7' -> [0, 1, 2, 3, 7, 7]."""
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def load_frames(path: str) -> list:
    """The orbit's frames as `render_sequence` yields them, from the cache
    at `path` (rendered with the port's renderer and saved there first where
    it is missing)."""
    if not os.path.exists(path):
        sys.modules.setdefault("jax", None)
        from mageslam_tpu_torch.apps.render_scene import render_sequence

        seq = list(render_sequence(N_FRAMES, WIDTH, HEIGHT, trajectory="orbit", period=PERIOD))
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path, img=np.stack([s[0] for s in seq]), ts=np.array([s[1] for s in seq]),
                 R=np.stack([s[3] for s in seq]), c=np.stack([s[4] for s in seq]))
    with np.load(path) as z:
        return [(z["img"][i], float(z["ts"][i]), i, z["R"][i], z["c"][i])
                for i in range(N_FRAMES)]


def check_jax_renderer(frames: list) -> None:
    """The cached frames (the port's renderer) against the JAX package's
    renderer at the first and the last frame: equal bit for bit."""
    from mageslam_tpu.apps import render_scene as ref

    surfaces = ref.build_scene(7, variant="loop")
    for i in (0, N_FRAMES - 1):
        R, c = ref.trajectory_pose_orbit(i, PERIOD)
        img = ref.render_frame(surfaces, R, c, WIDTH, HEIGHT, frame_index=i, supersample=2)
        if not np.array_equal(img, frames[i][0]):
            raise SystemExit(f"frame {i}: the JAX package's renderer differs from the cache")


def _start(package: str) -> None:
    if package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
    else:
        sys.modules.setdefault("jax", None)
        import torch

        torch.set_num_threads(2)
    _FRAMES[:] = load_frames(FRAMES)


def host(x) -> np.ndarray:
    return np.asarray(x.cpu() if hasattr(x, "detach") else x)


def run_one(seed: int, package: str, device: str) -> dict:
    """One orbit with `seed`; the closures are recorded as they are applied."""
    if package == "jax":
        from mageslam_tpu import runtime
        from mageslam_tpu.apps import loop_eval, render_scene
        from mageslam_tpu.runtime.pipeline import SlamSession

        render_scene.render_sequence = lambda *a, **k: iter(_FRAMES)
        kwargs = {}
    else:
        from mageslam_tpu_torch import runtime
        from mageslam_tpu_torch.apps import loop_eval
        from mageslam_tpu_torch.runtime.session import SlamSession

        kwargs = dict(device=device, frames=_FRAMES)
    closures = []
    real_apply = SlamSession._apply_loop_closure

    def apply(self, det, frame, ki):
        fids = host(self.map.kf_frame_id).tolist()
        closures.append({"frame": int(host(frame.frame_id)), "slot": int(ki),
                         "cluster_frames": [fids[j] for j in np.flatnonzero(host(det.cluster_mask))],
                         "scale": float(host(det.scale))})
        return real_apply(self, det, frame, ki)

    SlamSession._apply_loop_closure = apply
    runtime.SlamSession = functools.partial(SlamSession, seed=seed)
    try:
        r = loop_eval.run_orbit_eval(N_FRAMES, PERIOD, WIDTH, HEIGHT, verbose=False,
                                     mode="stream", **kwargs)
    finally:
        SlamSession._apply_loop_closure = real_apply
        runtime.SlamSession = SlamSession
    st = r["loop_det_stats"]
    gates = (r["loops_closed"] >= 1 and r["tracked"] >= TRACKED_MIN
             and r["ate_rmse"] < ATE_LIMIT and st["deferred"] > 0
             and st["resolved"] >= st["deferred"] and st["closed"] >= 1)
    return {"package": package, "device": device, "seed": seed, "gates": bool(gates),
            "loops_closed": r["loops_closed"], "closures": closures, "tracked": r["tracked"],
            "keyframes": r["keyframes"], "ate_rmse": r["ate_rmse"],
            "loop_det_stats": st, "elapsed_s": round(r["elapsed_s"], 1)}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--package", choices=("port", "jax"), default="port")
    p.add_argument("--device", default="cpu", help="the port's device (cpu or cuda)")
    p.add_argument("--seeds", type=seeds_arg, default=seeds_arg("0-7"))
    p.add_argument("--procs", type=int, default=4, help="runs at a time")
    args = p.parse_args()
    device = "cpu" if args.package == "jax" else args.device
    t0 = time.perf_counter()
    frames = load_frames(FRAMES)
    if args.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        check_jax_renderer(frames)
    elif device == "cuda":
        from mageslam_tpu_torch.ops import _build

        _build.build()   # once, before the workers load it
    ctx = multiprocessing.get_context("spawn")
    rows = []
    with ctx.Pool(args.procs, _start, (args.package,)) as pool:
        for row in pool.imap_unordered(functools.partial(run_one, package=args.package,
                                                         device=device), args.seeds):
            rows.append(row)
            print(json.dumps(row), flush=True)
    closed = sum(r["loops_closed"] >= 1 for r in rows)
    passed = sum(r["gates"] for r in rows)
    print(json.dumps({"package": args.package, "device": device, "runs": len(rows),
                      "closed_a_loop": closed, "met_gates": passed,
                      "wall_s": round(time.perf_counter() - t0, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
