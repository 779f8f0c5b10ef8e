"""Smoke run of the PyTorch/CUDA port (`mageslam_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each reported on its own line; any failure ends the run non-zero:

1. Device: a CUDA device is required (there is no CPU path); prints its name
   and `nvidia-smi --query-gpu=name,power.limit` for the card.
2. Build: compiles the port's CUDA sources with nvcc (ops/_build.py) and
   prints what ptxas reports for each kernel.
3. Kernel check, each kernel against its plain PyTorch version on the card,
   exact:
   - the standalone Hamming kernel (`csrc/hamming.cu`) on full-range 32-bit
     words; timed at the tracking shapes beside `torch._int_mm` of the ±1
     unpacked bits (256 - 2 * Hamming), the library yardstick;
   - the fused radius-match kernel (`csrc/radius_match.cu`) at S in {1, 3}
     stages and (Q, T) up to (2048, 512) and (700, 3000), on low-entropy
     descriptors (ties at best and second), rows without candidates and
     points exactly on the radius; timed on the inputs the tracking path
     gives it on frame 31 (no single PyTorch call computes it).
   Each call is timed with CUDA events in turns (kernel, plain, plain,
   kernel), and each launch's device time is read from torch.profiler.
4. Slice: starts a session on the card from the committed JAX state
   (tests/data/torch_port_bench640_f30.npz: the benchmark world after frame
   30), tracks frames 31-54 through `SlamSession.process_frame`, and holds
   every frame against the stored JAX outputs: state TRACKING, keyframe
   flag, pose R and t within 1e-3, tracked count within 3. In that run the
   fused kernel must launch exactly twice a frame (cascade, track-local-map)
   and the standalone Hamming kernel never. Then torch.profiler traces 8
   frames for the device events and device time per frame.

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
RADIUS_SHAPES = ((1, 1), (129, 257), (1024, 512), (2048, 512), (700, 3000))
RADIUS_STAGES = (1, 3)
POSE_ATOL = 1e-3
TRACKED_TOL = 3
PROFILE_FRAMES = 8
# NVIDIA H100 SXM data sheet (dense): HBM rate, int8 tensor-core rate (the
# ±1 bit product's densest form), float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
F32_OPS_PER_S = 67e12
# radius_match_stages' tensor arguments, in order
TENSOR_ARGS = ("query_desc", "query_xy", "query_octave", "query_valid", "target_desc",
               "target_xy", "target_octave", "target_valid", "radius")
# few distinct words with close popcounts: distances tie often
LOW_ENTROPY_WORDS = np.array([0, 1, 3, 0x80000000, 0x80000003, 0xFFFF0000], np.uint32)


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


def radius_case(rng: np.random.RandomState, n_stages: int, n_query: int,
                n_target: int) -> dict:
    """numpy inputs of `radius_match_stages` that reach its edge cases:
    low-entropy descriptors (ties at best and at second), a third of the
    queries copying a target near it (exact matches), integer positions and
    radii (targets exactly on a box edge), invalid queries and targets, and
    queries parked far from every target (rows with no candidate)."""
    side = int(2 * np.sqrt(n_target)) + 4
    t_desc = LOW_ENTROPY_WORDS[rng.randint(0, 6, (n_target, 8))]
    t_xy = rng.randint(0, side, (n_target, 2)).astype(np.float32)
    t_xy[rng.rand(n_target) < 0.3] += 0.5
    q_desc = LOW_ENTROPY_WORDS[rng.randint(0, 6, (n_query, 8))]
    q_xy = np.repeat(rng.randint(0, side, (1, n_query, 2)), n_stages, 0).astype(np.float32)
    if n_target:
        copy = np.flatnonzero(rng.rand(n_query) < 0.3)
        src = rng.randint(0, n_target, copy.size)
        q_desc[copy] = t_desc[src]
        q_xy[:, copy] = t_xy[src] + rng.randint(-2, 3, (copy.size, 2))
    moved = rng.rand(n_stages, n_query) < 0.5
    moved[0] = False
    q_xy[moved] = rng.randint(0, side, (int(moved.sum()), 2))
    q_xy[:, rng.rand(n_query) < 0.1] = 1e4
    return {
        "query_desc": q_desc.view(np.int32),
        "query_xy": q_xy,
        "query_octave": rng.randint(0, 2, n_query).astype(np.int32),
        "query_valid": rng.rand(n_query) < 0.85,
        "target_desc": t_desc.view(np.int32),
        "target_xy": t_xy,
        "target_octave": rng.randint(0, 2, n_target).astype(np.int32),
        "target_valid": rng.rand(n_target) < 0.85,
        "radius": rng.choice(np.float32([0, 1, 2, 4, 8]), (n_stages, n_query)),
    }


def candidates(a: dict, octave_tol: int) -> torch.Tensor:
    """(S, Q, T) bool: the pairs each stage may match, from a dict of
    `radius_match_stages`' tensor arguments."""
    from mageslam_tpu_torch.ops.matching import candidate_mask

    return candidate_mask(*(a[k] for k in ("query_xy", "query_octave", "query_valid",
                                            "target_xy", "target_octave", "target_valid",
                                            "radius")), octave_tol)


def case_stats(a: dict, octave_tol: int) -> dict:
    """How many rows and pairs of a case reach each edge: rows with no
    candidate, rows whose best distance ties, candidates exactly on the
    box edge."""
    from mageslam_tpu_torch.ops.hamming import hamming_matrix_plain

    cand = candidates(a, octave_tol)
    d = torch.where(cand, hamming_matrix_plain(a["query_desc"], a["target_desc"])[None],
                    1 << 20)
    two = d.topk(2, dim=-1, largest=False).values if d.shape[-1] > 1 else None
    edge = (a["query_xy"][:, :, None, :] - a["target_xy"][None, None, :, :]).abs()
    return {
        "rows_without_candidate": int((~cand.any(-1)).sum()),
        "rows_tied_at_best": 0 if two is None else int(
            ((two[..., 0] == two[..., 1]) & (two[..., 0] < 1 << 20)).sum()),
        "candidates_on_the_edge": int((cand & (edge.amax(-1) == a["radius"][:, :, None])).sum()),
    }


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


def in_turns(kernel, plain) -> tuple[float, float, str]:
    """(kernel ms, plain ms, report): each timed twice, kernel, plain, plain,
    kernel; the better of each pair."""
    k1, p1, p2, k2 = cuda_ms(kernel), cuda_ms(plain), cuda_ms(plain), cuda_ms(kernel)
    return min(k1, k2), min(p1, p2), (f"kernel {k1:.5f} / {k2:.5f} ms, plain {p1:.5f} / "
                                      f"{p2:.5f} ms (kernel, plain, plain, kernel; "
                                      f"median of 5 x 200 calls)")


def _device_us(e) -> float:
    """A device event's time in microseconds (the attribute was renamed from
    cuda_time_total to device_time_total across PyTorch versions)."""
    for n in ("device_time_total", "cuda_time_total"):
        if hasattr(e, n):
            return float(getattr(e, n))
    return 0.0


def profile(fn) -> list:
    """The device events of one traced call of `fn`."""
    from torch.profiler import ProfilerActivity, profile as trace

    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type.name == "CUDA"]


def launch_us(fn, kernel_name: str, launches: int = 20) -> float | None:
    """Mean device time of one launch of `kernel_name`, over `launches`
    calls of `fn` under the profiler; None where the trace has no device
    time."""
    events = [e for e in profile(lambda: [fn() for _ in range(launches)])
              if kernel_name in e.name]
    times = [_device_us(e) for e in events]
    return sum(times) / len(times) if times and sum(times) > 0 else None


def bound(n_bytes: float, f32_ops: float = 0.0, int8_ops: float = 0.0) -> tuple[float, str]:
    """(least ms the card could take, what sets it): the larger of the bytes
    over the HBM rate and each operation count over its peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(f32_ops / F32_OPS_PER_S, int8_ops / INT8_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_hamming(device) -> dict:
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
    rows = {}
    for n, m in PATH_SHAPES:
        a = torch.from_numpy(random_words(rng, n).view(np.int32)).to(device)
        b = torch.from_numpy(random_words(rng, m).view(np.int32)).to(device)
        t_kernel, t_plain, report = in_turns(lambda: hamming.hamming_matrix(a, b),
                                             lambda: hamming.hamming_matrix_plain(a, b))
        # library yardstick: ±1 int8 bits, (N, 256) x (256, M) -> 256 - 2 * Hamming
        shifts = torch.arange(32, device=device, dtype=torch.int64)
        a_pm, b_pm = ((((w.to(torch.int64) & 0xFFFFFFFF)[:, :, None] >> shifts) & 1)
                      .reshape(w.shape[0], 256).to(torch.int8) * 2 - 1 for w in (a, b))
        b_pm_t = b_pm.t()   # column-major (256, M), as cuBLASLt takes it
        if not torch.equal(torch._int_mm(a_pm, b_pm_t), 256 - 2 * hamming.hamming_matrix(a, b)):
            raise AssertionError(f"_int_mm yardstick != 256 - 2 * hamming at ({n}, {m})")
        t_library = cuda_ms(lambda: torch._int_mm(a_pm, b_pm_t))
        us = launch_us(lambda: hamming.hamming_matrix(a, b), "hamming_kernel")
        bound_ms, bound_by = bound((n + m) * 32 + n * m * 4, int8_ops=2 * 256 * n * m)
        rows[(n, m)] = {"ms": t_kernel, "plain_ms": t_plain, "library_ms": t_library,
                        "device_us": us, "bound_ms": bound_ms, "bound_by": bound_by}
        phase("kernel", f"hamming ({n}, {m}): {report}; torch._int_mm {t_library:.5f} ms; "
                        f"device {us} us a launch (profiler); bound {bound_ms * 1e3:.3f} us "
                        f"({bound_by})")
    return {"max_abs_err": max_err, "rows": rows}


def _to_device(case: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(case[k])).to(device) for k in TENSOR_ARGS}


def check_radius_match(device) -> int:
    """The fused kernel against its plain version, exact, at every listed
    shape and stage count. Returns the max abs error (0)."""
    from mageslam_tpu_torch.ops import matching

    rng = np.random.RandomState(1)
    for n_stages in RADIUS_STAGES:
        for n_query, n_target in RADIUS_SHAPES:
            octave_tol = n_query % 2            # both 0 and 1 occur
            a = _to_device(radius_case(rng, n_stages, n_query, n_target), device)
            gates = (6, 1)
            args = [a[k] for k in TENSOR_ARGS]
            got = matching.radius_match_stages(*args, *gates, octave_tol)
            want = matching.radius_match_stages_plain(*args, *gates, octave_tol)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                if g.shape != (n_stages, n_query) or g.dtype != torch.int32 or not torch.equal(g, w):
                    raise AssertionError(f"radius_match kernel != plain at S={n_stages}, "
                                         f"({n_query}, {n_target})")
            stats = case_stats(a, octave_tol)
            matched = int((got[0] >= 0).sum())
            phase("kernel", f"radius_match S={n_stages} ({n_query}, {n_target}) "
                            f"octave_tol={octave_tol}: equal to plain; {matched} matched, "
                            f"{stats}")
    return 0


def capture_path_calls(device, frame: np.ndarray, frame_id: int) -> list[dict]:
    """The tensor arguments of every `radius_match_stages` call that
    tracking one frame makes (a fresh session from the fixture)."""
    from mageslam_tpu_torch import SlamSession, golden_path_settings
    from mageslam_tpu_torch.ops import matching
    from mageslam_tpu_torch.tracking import pose_estimation

    names = TENSOR_ARGS + ("max_hamming", "min_diff", "octave_tol")
    calls, real = [], matching.radius_match_stages

    def recording(*args, **kwargs):
        call = dict(zip(names, args), **kwargs)
        calls.append({k: v.clone() if isinstance(v, torch.Tensor) else v
                      for k, v in call.items()})
        return real(*args, **kwargs)

    sess = SlamSession.from_jax_snapshot(FIXTURE, golden_path_settings(), CAM, WIDTH,
                                         HEIGHT, device)
    matching.radius_match_stages = pose_estimation.radius_match_stages = recording
    try:
        sess.process_frame(frame, frame_id * DT, frame_id)
    finally:
        matching.radius_match_stages = pose_estimation.radius_match_stages = real
    return calls


def time_radius_path(device, frame: np.ndarray, frame_id: int) -> dict:
    """Times the fused kernel on the path's own inputs of one frame: per
    call, kernel and plain in turns, device time a launch, and the bound."""
    from mageslam_tpu_torch.ops import matching

    per_call = []
    for c in capture_path_calls(device, frame, frame_id):
        tensors = [c[k] for k in TENSOR_ARGS]
        scalars = (c["max_hamming"], c["min_diff"], c.get("octave_tol", 0))
        got = matching.radius_match_stages(*tensors, *scalars)
        want = matching.radius_match_stages_plain(*tensors, *scalars)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError("radius_match kernel != plain on the path's inputs")
        n_stages, n_query = c["radius"].shape
        n_target = c["target_desc"].shape[0]
        cand = candidates(c, scalars[2])
        # an unbounded box leaves the validity and octave gate
        gated = candidates({**c, "radius": torch.full_like(c["radius"], float("inf"))},
                           scalars[2])[0]
        n_bytes = (n_query * (32 + 4 + 1) + n_stages * n_query * (8 + 4)
                   + n_target * (32 + 8 + 4 + 1) + 2 * n_stages * n_query * 4)
        # per (gated pair, stage): 2 subtractions, 2 comparisons; per pair that
        # is a candidate in some stage: 256 multiply-adds of the ±1 bit product
        bound_ms, bound_by = bound(n_bytes, f32_ops=4 * n_stages * int(gated.sum()),
                                   int8_ops=2 * 256 * int(cand.any(0).sum()))
        t_kernel, t_plain, report = in_turns(
            lambda: matching.radius_match_stages(*tensors, *scalars),
            lambda: matching.radius_match_stages_plain(*tensors, *scalars))
        us = launch_us(lambda: matching.radius_match_stages(*tensors, *scalars),
                       f"radius_match_kernel<{n_stages}>")
        row = {"stages": n_stages, "shape": [n_query, n_target], "ms": t_kernel,
               "plain_ms": t_plain, "device_us": us, "bound_ms": bound_ms,
               "bound_by": bound_by, "candidate_pairs": int(cand.any(0).sum())}
        per_call.append(row)
        phase("kernel", f"radius_match on frame {frame_id}'s call S={n_stages} "
                        f"({n_query}, {n_target}): {report}; device {us} us a launch "
                        f"(profiler); bound {bound_ms * 1e3:.3f} us ({bound_by}; "
                        f"{row['candidate_pairs']} candidate pairs)")
    if [r["stages"] for r in per_call] != [3, 1]:
        raise AssertionError(f"expected a cascade call (S=3) and a track-local-map call "
                             f"(S=1) per frame, got {[r['stages'] for r in per_call]}")
    return {"calls": per_call,
            **{k: sum(r[k] for r in per_call) for k in ("ms", "plain_ms", "bound_ms")},
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in per_call)
            else "operations"}


def render_window(start: int, stop: int) -> list[np.ndarray]:
    """The benchmark world's frames start..stop-1, clipped and cast to
    uint8 (the port's own copy of the scene, mageslam_tpu_torch/bench_world.py)."""
    from mageslam_tpu_torch import bench_world

    return bench_world.frames(start, stop)


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


def profile_window(device, frames, first_id: int, card: str) -> None:
    """Device events and device time per frame over PROFILE_FRAMES frames."""
    from mageslam_tpu_torch import SlamSession, golden_path_settings

    sess = SlamSession.from_jax_snapshot(FIXTURE, golden_path_settings(), CAM,
                                         WIDTH, HEIGHT, device)
    events = profile(lambda: [sess.process_frame(frames[j], (first_id + j) * DT, first_id + j)
                              for j in range(PROFILE_FRAMES)])
    device_ms = sum(_device_us(e) for e in events) / 1e3
    if not events or device_ms == 0:
        phase("profile", "the profiler recorded no device time: not measured")
        return
    fused = [e for e in events if "radius_match_kernel" in e.name]
    phase("profile", f"{PROFILE_FRAMES} frames: {len(events) / PROFILE_FRAMES:.1f} device "
                     f"events a frame, {device_ms / PROFILE_FRAMES:.3f} ms of device time a "
                     f"frame; radius_match_kernel {len(fused)} launches, "
                     f"{sum(_device_us(e) for e in fused) / max(len(fused), 1):.2f} us "
                     f"each; {card}")


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

    from mageslam_tpu_torch.ops import _build, hamming, matching

    path, build_s, log = _build.build()
    _build.library()
    phase("build", f"{os.path.relpath(path, REPO)} built in {build_s:.1f} s")
    for line in log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            phase("build", line.strip())

    ham = check_hamming(device)
    fused_err = check_radius_match(device)

    with np.load(FIXTURE) as z:
        ref = {k: z[k] for k in z.files if k.startswith("ref_")}
    first = int(ref["ref_frame_id"][0])
    frames = render_window(first, first + len(ref["ref_frame_id"]))
    fused = time_radius_path(device, frames[0], first)

    run_window(device, frames, first)          # warm pass: allocator, caches
    hamming.LAUNCHES = matching.LAUNCHES = 0
    results, ms = run_window(device, frames, first)
    fused_launches, ham_launches = matching.LAUNCHES, hamming.LAUNCHES
    pose_err, count_err = check_window(results, ref)
    if fused_launches != 2 * len(frames) or ham_launches != 0:
        raise AssertionError(f"over {len(frames)} frames: radius_match kernel launched "
                             f"{fused_launches} times (expected 2 a frame), hamming "
                             f"kernel {ham_launches} times (expected 0)")
    kf = [r.frame_id for r in results if r.is_keyframe]
    phase("slice", f"frames {first}-{first + len(frames) - 1}: all TRACKING, "
                   f"keyframes at {kf}, max pose err {pose_err:.3g} (limit "
                   f"{POSE_ATOL}), max tracked diff {count_err} (limit {TRACKED_TOL})")
    phase("slice", f"kernel launches in the run: radius_match {fused_launches} "
                   f"({fused_launches / len(frames):.1f} a frame), hamming {ham_launches}")
    phase("slice", f"per-frame wall time (process_frame + synchronize): median "
                   f"{statistics.median(ms):.3f} ms, min {min(ms):.3f}, max "
                   f"{max(ms):.3f} over {len(ms)} frames after one warm pass; {card}")
    profile_window(device, frames, first, card)

    ham_row = ham["rows"][PATH_SHAPES[-1]]
    print(json.dumps({"kernels": [
        {"name": "radius_match", "route": "cuda",
         "source": "mageslam_tpu_torch/csrc/radius_match.cu",
         "replaces": "mageslam_tpu/ops/pallas_kernels.py:57",
         "launches": fused_launches, "max_abs_err": fused_err,
         "ms": fused["ms"], "plain_ms": fused["plain_ms"], "bound_ms": fused["bound_ms"],
         "bound_by": fused["bound_by"], "library_ms": None,
         "note": "ms, plain_ms, bound_ms: sum of one frame's two calls", "calls": fused["calls"]},
        {"name": "hamming_matrix", "route": "cuda",
         "source": "mageslam_tpu_torch/csrc/hamming.cu",
         "replaces": "mageslam_tpu/ops/pallas_kernels.py:57",
         "launches": ham_launches, "max_abs_err": ham["max_abs_err"],
         "ms": ham_row["ms"], "plain_ms": ham_row["plain_ms"],
         "bound_ms": ham_row["bound_ms"], "bound_by": ham_row["bound_by"],
         "library_ms": ham_row["library_ms"], "shape": list(PATH_SHAPES[-1]),
         "rows": {f"{n}x{m}": r for (n, m), r in ham["rows"].items()}},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
