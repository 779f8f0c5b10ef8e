"""Smoke run of the PyTorch/CUDA port (`mageslam_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each reported on its own line; any failure ends the run non-zero:

1. Device: a CUDA device is required (there is no CPU path); prints its name
   and `nvidia-smi --query-gpu=name,power.limit` for the card.
2. Build: compiles the port's CUDA sources with nvcc (ops/_build.py).
3. Kernel check: the Hamming kernel against its plain PyTorch version on
   the card, exact, on full-range 32-bit words; times both at the tracking
   path's shapes with CUDA events.
4. Slice: starts a session on the card from the committed JAX state
   (tests/data/torch_port_bench640_f30.npz: bench.py's world after frame 30),
   tracks frames 31-54 through `SlamSession.process_frame`, and holds every
   frame against the stored JAX outputs: state TRACKING, keyframe flag,
   pose R and t within 1e-3, tracked count within 3. The kernel must have
   launched at least twice per frame in that run.

The next-to-last line is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_bench640_f30.npz")
CAM = (520.0, 520.0, 320.0, 240.0)
WIDTH, HEIGHT = 640, 480
DT = 0.033
KERNEL_SHAPES = ((1, 1), (129, 257), (1000, 440), (1024, 512), (2048, 512))
PATH_SHAPES = ((1024, 512), (2048, 512))   # guided cascade, track-local-map
POSE_ATOL = 1e-3
TRACKED_TOL = 3


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def random_words(rng: np.random.RandomState, rows: int) -> np.ndarray:
    """(rows, 8) full-range uint32 words (bit 31 set about half the time)."""
    return rng.randint(0, 2**32, size=(rows, 8), dtype=np.uint64).astype(np.uint32)


def cuda_ms(fn, iters: int = 200, warmup: int = 20, reps: int = 5) -> float:
    """Median over `reps` of the mean time of `iters` back-to-back calls,
    from CUDA events, after warmup."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / iters)
    return statistics.median(times)


def check_kernel(device) -> dict:
    from mageslam_tpu_torch.ops import hamming

    rng = np.random.RandomState(0)
    max_err = 0
    for n, m in KERNEL_SHAPES:
        a = torch.from_numpy(random_words(rng, n).view(np.int32)).to(device)
        b = torch.from_numpy(random_words(rng, m).view(np.int32)).to(device)
        got = hamming.hamming_matrix(a, b)
        want = hamming.hamming_matrix_plain(a, b)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        if got.shape != (n, m) or got.dtype != torch.int32 or err != 0:
            raise AssertionError(f"hamming kernel != plain at ({n}, {m}): max err {err}")
        if not bool(((got >= 0) & (got <= 256)).all()):
            raise AssertionError(f"hamming kernel out of range at ({n}, {m})")
        max_err = max(max_err, err)
        phase("kernel", f"hamming ({n}, {m}): equal to plain (max abs err {err})")
    times = {}
    for n, m in PATH_SHAPES:
        a = torch.from_numpy(random_words(rng, n).view(np.int32)).to(device)
        b = torch.from_numpy(random_words(rng, m).view(np.int32)).to(device)
        t_plain_1 = cuda_ms(lambda: hamming.hamming_matrix_plain(a, b))
        t_kernel_1 = cuda_ms(lambda: hamming.hamming_matrix(a, b))
        t_kernel_2 = cuda_ms(lambda: hamming.hamming_matrix(a, b))
        t_plain_2 = cuda_ms(lambda: hamming.hamming_matrix_plain(a, b))
        times[(n, m)] = (min(t_kernel_1, t_kernel_2), min(t_plain_1, t_plain_2))
        phase("kernel", f"hamming ({n}, {m}): kernel {t_kernel_1:.5f} / "
                        f"{t_kernel_2:.5f} ms, plain {t_plain_1:.5f} / {t_plain_2:.5f} ms "
                        f"(plain, kernel, kernel, plain; median of 5 x 200 calls)")
    return {"max_abs_err": max_err, "times": times}


def render_window(start: int, stop: int) -> list[np.ndarray]:
    """bench.py's frames start..stop-1, clipped and cast to uint8."""
    sys.path.insert(0, REPO)
    import bench

    pts, patches = bench.build_world(np.random.RandomState(7))
    return [np.clip(bench.render(pts, patches, i * DT), 0, 255).astype(np.uint8)
            for i in range(start, stop)]


def run_window(device, frames, first_id: int):
    """A session from the fixture, tracked over `frames`. Returns the
    results and each frame's wall time (ms, synchronized)."""
    from mageslam_tpu_torch import SlamSession, golden_path_settings

    sess = SlamSession.from_jax_snapshot(FIXTURE, golden_path_settings(), CAM,
                                         WIDTH, HEIGHT, device)
    results, ms = [], []
    for j, img in enumerate(frames):
        i = first_id + j
        t0 = time.perf_counter()
        results.append(sess.process_frame(img, i * DT, i))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return results, ms


def check_window(results, ref) -> tuple[float, int]:
    """Hold each frame against the stored JAX outputs. Returns (max pose
    error, max tracked-count difference)."""
    pose_err, count_err = 0.0, 0
    for j, r in enumerate(results):
        fid = int(ref["ref_frame_id"][j])
        if r.frame_id != fid or r.state.name != "TRACKING" or r.pose is None:
            raise AssertionError(f"frame {fid}: {r.state.name}, expected TRACKING")
        if r.is_keyframe != bool(ref["ref_is_kf"][j]):
            raise AssertionError(f"frame {fid}: is_keyframe {r.is_keyframe}, JAX "
                                 f"{bool(ref['ref_is_kf'][j])}")
        R = r.pose.R.cpu().numpy()
        t = r.pose.t.cpu().numpy()
        if R.shape != (3, 3) or t.shape != (3,) or not (np.isfinite(R).all()
                                                        and np.isfinite(t).all()):
            raise AssertionError(f"frame {fid}: pose not finite or misshapen")
        err = max(float(np.abs(R - ref["ref_R"][j]).max()),
                  float(np.abs(t - ref["ref_t"][j]).max()))
        d_count = abs(r.tracked_count - int(ref["ref_tracked"][j]))
        if err > POSE_ATOL or d_count > TRACKED_TOL:
            raise AssertionError(f"frame {fid}: pose err {err:.3g} (limit {POSE_ATOL}),"
                                 f" tracked {r.tracked_count} vs JAX "
                                 f"{int(ref['ref_tracked'][j])}")
        pose_err, count_err = max(pose_err, err), max(count_err, d_count)
    return pose_err, count_err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    phase("device", f"{name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(card, flush=True)   # name, power limit: as nvidia-smi prints them

    from mageslam_tpu_torch.ops import _build, hamming

    path, build_s, log = _build.build()
    _build.library()
    phase("build", f"{os.path.relpath(path, REPO)} built in {build_s:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            phase("build", line.strip())

    kernel = check_kernel(device)

    with np.load(FIXTURE) as z:
        ref = {k: z[k] for k in z.files if k.startswith("ref_")}
    first = int(ref["ref_frame_id"][0])
    frames = render_window(first, first + len(ref["ref_frame_id"]))
    run_window(device, frames, first)          # warm pass: allocator, caches
    hamming.LAUNCHES = 0
    results, ms = run_window(device, frames, first)
    launches = hamming.LAUNCHES
    pose_err, count_err = check_window(results, ref)
    if launches < 2 * len(frames):
        raise AssertionError(f"hamming kernel launched {launches} times over "
                             f"{len(frames)} frames, expected >= 2 per frame")
    kf = [r.frame_id for r in results if r.is_keyframe]
    phase("slice", f"frames {first}-{first + len(frames) - 1}: all TRACKING, "
                   f"keyframes at {kf}, max pose err {pose_err:.3g} (limit "
                   f"{POSE_ATOL}), max tracked diff {count_err} (limit {TRACKED_TOL})")
    phase("slice", f"hamming kernel launches in the run: {launches} "
                   f"({launches / len(frames):.1f} per frame)")
    phase("slice", f"per-frame wall time (process_frame + synchronize): median "
                   f"{statistics.median(ms):.3f} ms, min {min(ms):.3f}, max "
                   f"{max(ms):.3f} over {len(ms)} frames after one warm pass; {card}")

    t_kernel, t_plain = kernel["times"][PATH_SHAPES[-1]]
    print(json.dumps({"kernels": [{
        "name": "hamming_matrix", "route": "cuda",
        "source": "mageslam_tpu_torch/csrc/hamming.cu",
        "replaces": "mageslam_tpu/ops/pallas_kernels.py:57",
        "launches": launches, "max_abs_err": kernel["max_abs_err"],
        "ms": t_kernel, "plain_ms": t_plain,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
