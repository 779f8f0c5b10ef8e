"""How far float summation order moves the port's stereo, distorted-camera and
visual-inertial runs, against the JAX runs they are held to (ROADMAP queue 3).

    python tools/float_spread.py rig       # the rig-tether session at 1-8 torch threads
    python tools/float_spread.py mixed     # the mixed-FOV rig at 1-8 torch threads
    python tools/float_spread.py warp      # JAX's jitted and eager warp against the port's
    python tools/float_spread.py vi        # apps/vi_eval.py's 80-frame run at 1-8 threads

`rig` and `mixed` run the port's session (CPU) on tests/test_stereo.py's
scenes from tests/data/torch_port_stereo.npz with JAX's draws replayed, once
per thread count, and print the largest unscaled pose error against the
JAX session (up to frame 17 and after it for the rig), R's, and the mask
entries that differ from the JAX map's after the mapping events. `warp`
compares the JAX package's `undistort_image` jitted (as its session runs
it) and eager with the port's on the distorted scene's frame 13
(tests/data/torch_port_cameras.npz): the rectify map (also with the
distortion chain's multiply-adds fused, emulated in float64), the warped
image, and the two keypoints of the frontend that swap slots. `vi` runs the
port's `run_vi_eval` (CPU, SIMPLE6DOF) on the photoreal frames with the JAX
run's draws, once per thread count, against tests/data/torch_port_vi.npz:
the fuser's transitions, the largest pose error with t scaled by the
map-scale ratio (and the frames beyond 1e-3), the metric scale's relative
error in JAX's map units, mask entries differing after the mapping events,
and the ATE beside JAX's.
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
THREADS = (1, 2, 3, 4, 6, 8)


def sessions(which: str) -> None:
    import torch

    import test_torch_stereo as t

    ref = {k: v for k, v in np.load(t.FIXTURE).items()}
    prefix = {"rig": "rig_", "mixed": "mix_"}[which]
    run = {"rig": t.rig_run, "mixed": t.mixed_run}[which].__wrapped__
    for n in THREADS:
        torch.set_num_threads(n)
        out = run(ref)
        results, maps = out[1] if which == "rig" else out[2], out[2] if which == "rig" else out[3]
        et = [float(np.abs(r.pose.t.numpy() - ref[prefix + "ref_t"][i]).max())
              for i, r in enumerate(results)]
        eR = [float(np.abs(r.pose.R.numpy() - ref[prefix + "ref_R"][i]).max())
              for i, r in enumerate(results)]
        events = len(ref[prefix + "ev_frame_id"])
        masks = sum(int((getattr(m, name).numpy() != ref[f"{prefix}ev{j}_{name}"]).sum())
                    for j, m in enumerate(maps[:events]) for name in t.MASKS)
        print(f"{which}, {n} threads: t err frames 0-17 {max(et[:18]):.3g}, frames 18- "
              f"{max(et[18:]):.3g}; R err {max(eR):.3g}; differing mask entries {masks}; "
              f"mapping events {len(maps)} (JAX {events})", flush=True)


def vi() -> None:
    import torch

    from mageslam_tpu_torch.apps.vi_eval import run_vi_eval
    from mageslam_tpu_torch.runtime import session as session_mod
    from mageslam_tpu_torch.runtime.draws import ReplayDraws

    data = os.path.join(REPO, "tests", "data")
    photo = os.path.join(data, "torch_port_photoreal.npz")
    path = os.path.join(data, "torch_port_vi.npz")
    ref = dict(np.load(path))
    frames = np.load(photo)["frames"]
    masks = ("kf_valid", "mp_valid", "kf_assoc", "kf_member")
    real_map = session_mod.SlamSession._insert_keyframe_and_map
    for n in THREADS:
        torch.set_num_threads(n)
        maps = []

        def mapper(self, frame):
            real_map(self, frame)
            maps.append(self.map)
        session_mod.SlamSession._insert_keyframe_and_map = mapper
        try:
            draws = ReplayDraws.from_npzs(((photo, ("init", "pnp", "vocab")), (path, ("reloc",))),
                                          "cpu")
            out = run_vi_eval(80, verbose=False, device="cpu", draws=draws, frames=frames)
        finally:
            session_mod.SlamSession._insert_keyframe_and_map = real_map
        sess = out["session"]
        k = float(ref["map_scale"]) / sess.map_scale
        errs = {r.frame_id: max(float(np.abs(r.pose.R.numpy() - ref["ref_R"][r.frame_id]).max()),
                                float(np.abs(r.pose.t.numpy() * k
                                             - ref["ref_t"][r.frame_id]).max()))
                for r in sess.results if r.pose is not None}
        diff = sum(int((getattr(m, name).numpy() != ref[f"ev{j}_{name}"]).sum())
                   for j, m in enumerate(maps) for name in masks)
        scale = out["metric_scale"] / k / float(ref["final_metric_scale"]) - 1.0
        print(f"vi, {n} threads: transitions {out['transitions']}; max pose err "
              f"{max(errs.values()):.3g} (t scaled by {k:.6f}), frames beyond 1e-3 "
              f"{[(f, round(e, 6)) for f, e in errs.items() if e > 1e-3]}; metric scale "
              f"{out['metric_scale']:.6f} ({scale:.3g} from JAX's); differing mask entries "
              f"{diff} over {len(maps)} events (JAX {len(ref['ev_frame_id'])}); ATE "
              f"{out['ate_rmse']:.6f} m (JAX {float(ref['jax_ate']):.6f})", flush=True)


def warp() -> None:
    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    from mageslam_tpu.config import golden_path_settings as jax_settings
    from mageslam_tpu.ops import undistort as jund
    from mageslam_tpu.ops.frontend import detect_and_compute as jax_frontend
    from mageslam_tpu_torch import golden_path_settings
    from mageslam_tpu_torch.ops import undistort
    from mageslam_tpu_torch.ops.frontend import detect_and_compute

    z = np.load(os.path.join(REPO, "tests", "data", "torch_port_cameras.npz"))
    cam = z["dist_camera"]
    img = z["dist_frames"][13].astype(np.float32)
    h, w = img.shape

    def jax_map(c):
        return jund.undistort_rectify_map(c, jund.undistorted_calibration(c), h, w)

    jit_map = np.asarray(jax.jit(jax_map)(jnp.asarray(cam)))
    eager_map = np.asarray(jax_map(jnp.asarray(cam)))
    port_map = undistort.rectify_map(torch.from_numpy(cam), h, w).numpy()

    # the radial chain with its multiply-adds fused (one rounding each)
    f32 = np.float32

    def fma(a, b, c):
        return (np.float64(a) * np.float64(b) + np.float64(c)).astype(f32)

    u, v = np.meshgrid(np.arange(w, dtype=f32), np.arange(h, dtype=f32))
    x = ((u - f32(w / 2)) / cam[0]).astype(f32)
    y = ((v - f32(h / 2)) / cam[1]).astype(f32)
    r2 = fma(x, x, (y * y).astype(f32))
    r4, r6 = (r2 * r2).astype(f32), (r2 * r2 * r2).astype(f32)
    num = fma(cam[6], r6, fma(cam[5], r4, fma(cam[4], r2, f32(1))))
    den = fma(cam[9], r6, fma(cam[8], r4, fma(cam[7], r2, f32(1))))
    s = (num / den).astype(f32)
    fused = np.stack([fma(cam[0], (x * s).astype(f32), cam[2]),
                      fma(cam[1], (y * s).astype(f32), cam[3])], -1)
    print(f"rectify map: port vs JAX eager {np.abs(port_map - eager_map).max():.3g}, vs "
          f"JAX jitted {np.abs(port_map - jit_map).max():.3g} ({(port_map != jit_map).mean():.3f} "
          f"of entries); fused multiply-adds vs JAX jitted "
          f"{int((fused != jit_map).sum())} entries differ")

    jit_img = np.asarray(jax.jit(lambda im: jund.undistort_image(im, jnp.asarray(cam))[0])(
        jnp.asarray(img)))
    eager_img = np.asarray(jund.undistort_image(jnp.asarray(img), jnp.asarray(cam))[0])
    port_img, port_cal = undistort.undistort_image(torch.from_numpy(img), torch.from_numpy(cam))
    port_img = port_img.numpy()
    print(f"warped frame 13: port vs JAX eager {np.abs(port_img - eager_img).max():.3g}, "
          f"vs JAX jitted {np.abs(port_img - jit_img).max():.3g} gray levels")
    fes = golden_path_settings().MonoSettings.MonoCamera.FeatureExtractorSettings
    jfes = jax_settings().MonoSettings.MonoCamera.FeatureExtractorSettings
    jf = jax_frontend(jnp.asarray(jit_img), jund.undistorted_calibration(jnp.asarray(cam)),
                      jfes, 512)
    pf = detect_and_compute(torch.from_numpy(port_img), port_cal, fes, 512)
    diff = np.flatnonzero((np.asarray(jf.xy) != pf.xy.numpy()).any(1))
    print(f"frontend on frame 13: slots whose keypoint differs {diff.tolist()}; JAX "
          f"{np.asarray(jf.xy)[diff].tolist()} responses "
          f"{np.asarray(jf.response)[diff].tolist()}; port {pf.xy.numpy()[diff].tolist()} "
          f"responses {pf.response.numpy()[diff].tolist()}")


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else ""
    if which in ("rig", "mixed"):
        sessions(which)
    elif which == "warp":
        warp()
    elif which == "vi":
        vi()
    else:
        sys.exit(__doc__)
