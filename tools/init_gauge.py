"""What fixes, and what does not fix, the result of one mono-init attempt.

The init bundle adjustment fixes only frame 1, so its cost does not see
the map's scale; where the LM leaves the scale depends on float noise in
its start. And RANSAC's winner depends on the 5-point solver's candidate
set, whose float32 roots move with the SVD's null-space basis; the winner's
pose then decides the unit-scale median-depth gate (20).

    python tools/init_gauge.py              # JAX jitted, JAX eager, the port (CPU)
    python tools/init_gauge.py --port cuda  # the port only, on the card

The first form runs the adoption attempt recorded in
tests/data/torch_port_bench640_init.npz (the JAX session's frame pair and
key) through JAX's `try_initialize_pair` jitted and eagerly
(jax.disable_jit) and through the port's with the key's draws, and prints
each result's pose (R, t, |t|), its surviving point count and the
differences: R and the direction of t agree, |t| does not. The second
form needs no JAX: for each recorded attempt it runs the port with the
5-point solver in float32 and in float64 on the given device and prints
the winning candidate, its pose before the BA, that pose's median depth
and the verdict.
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_bench640_init.npz")
CAM = np.array([520.0, 520.0, 320.0, 240.0], np.float32)
NAMES = ("xy1", "desc1", "valid1", "xy2", "desc2", "valid2")


def load() -> dict:
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


def port_args(f: dict, p: str, device):
    import torch

    return [torch.from_numpy(np.ascontiguousarray(
        f[p + k].view(np.int32) if f[p + k].dtype == np.uint32 else f[p + k])).to(device)
        for k in NAMES]


def port_attempts(device: str) -> None:
    """Each recorded attempt through the port on `device`, the 5-point
    solver in float32 and in float64."""
    import torch

    sys.path.insert(0, REPO)
    from mageslam_tpu_torch import golden_path_settings
    from mageslam_tpu_torch.tracking import map_init as tm

    f = load()
    settings = tm.init_settings(golden_path_settings())
    cam = torch.from_numpy(CAM).to(device)
    real_five, real_eval, real_score = (tm.five_point_essential, tm._eval_poses,
                                        tm._symmetric_transfer_score)
    seen = {}

    def evaluate(poses4, best_E, *args):
        scores, good, X = real_eval(poses4, best_E, *args)
        k = int(torch.argmax(good.sum(1)))
        n_good = int(good[k].sum())
        depth = torch.sort(torch.where(good[k], X[k, :, 2], torch.inf)).values
        seen.update(pose_t=poses4.t[k].cpu().numpy(), n_good=n_good,
                    median=float(depth[n_good // 2]) if n_good else float("nan"))
        return scores, good, X

    def score(F, *args):
        out = real_score(F, *args)
        seen["best"] = int(torch.argmax(out[0]))
        return out

    tm._eval_poses, tm._symmetric_transfer_score = evaluate, score
    try:
        for dtype in (torch.float32, torch.float64):
            tm.five_point_essential = lambda p1, p2, basis=None, d=dtype: real_five(
                p1.to(d), p2.to(d))
            for j in range(int(f["init_n_attempt"])):
                p = f"init_att{j}_"
                res = tm.try_initialize_pair(*port_args(f, p, device), cam,
                                             torch.from_numpy(f[p + "draws"]).to(device),
                                             settings)
                print(f"{device} {str(dtype)[6:]} attempt {j} (frame {int(f[p + 'frame'])}): "
                      f"succeeded {bool(res.succeeded)} (JAX {bool(f[p + 'succeeded'])}); "
                      f"best raw candidate {seen['best']}; the pose with the most good "
                      f"points: {seen['n_good']} points, t before the BA "
                      f"{np.round(seen['pose_t'], 4).tolist()}, median depth "
                      f"{seen['median']:.4f} (gate 20)", flush=True)
    finally:
        tm.five_point_essential, tm._eval_poses = real_five, real_eval
        tm._symmetric_transfer_score = real_score


def three_ways() -> None:
    """The adoption's attempt through JAX jitted, JAX eager and the port."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    sys.path.insert(0, REPO)
    from mageslam_tpu.tracking import map_init as jm
    from mageslam_tpu_torch import golden_path_settings
    from mageslam_tpu_torch.tracking import map_init as tm

    f = load()
    p = f"init_att{int(f['init_n_attempt']) - 1}_"
    settings = tm.init_settings(golden_path_settings())
    jargs = [jnp.asarray(f[p + k]) for k in NAMES] + [jnp.asarray(CAM), jnp.asarray(f[p + "key"])]
    js = jm.InitSettings(**settings._asdict())
    batch = f[p + "draws"].shape[0]
    out = {}
    r = jm.try_initialize_pair(*jargs, js, ransac_batch=batch)
    out["jax jit"] = (np.asarray(r.pose2.R), np.asarray(r.pose2.t), np.asarray(r.point_valid))
    with jax.disable_jit():
        r = jm.try_initialize_pair(*jargs, js, ransac_batch=batch)
    out["jax eager"] = (np.asarray(r.pose2.R), np.asarray(r.pose2.t), np.asarray(r.point_valid))
    r = tm.try_initialize_pair(*port_args(f, p, "cpu"), torch.from_numpy(CAM),
                               torch.from_numpy(f[p + "draws"]), settings)
    out["port (CPU)"] = (r.pose2.R.numpy(), r.pose2.t.numpy(), r.point_valid.numpy())
    print(f"attempt at frame {int(f[p + 'frame'])}, recorded t {f[p + 'pose2_t'].tolist()}")
    for name, (R, t, pv) in out.items():
        print(f"{name:11s} t {np.round(t, 6).tolist()} |t| {np.linalg.norm(t):.6f} "
              f"points {int(pv.sum())}")
    ref_R, ref_t, ref_pv = out["jax jit"]
    for name, (R, t, pv) in out.items():
        if name == "jax jit":
            continue
        d = t / np.linalg.norm(t) - ref_t / np.linalg.norm(ref_t)
        print(f"{name} vs jax jit: R err {np.abs(R - ref_R).max():.3g}, t err "
              f"{np.abs(t - ref_t).max():.3g}, direction err {np.abs(d).max():.3g}, scale "
              f"ratio {np.linalg.norm(ref_t) / np.linalg.norm(t):.6f}, point_valid differs in "
              f"{int((pv != ref_pv).sum())}")


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--port":
        port_attempts(sys.argv[2])
    elif len(sys.argv) == 1:
        three_ways()
    else:
        sys.exit(__doc__)
