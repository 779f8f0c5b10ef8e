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
     stages and (Q, T) up to (2048, 512) and (700, 3000), the mapping
     step's (512, 512) among them, on low-entropy descriptors (ties at best
     and second), rows without candidates and points exactly on the radius;
     held exactly against the plain version and timed on the inputs the
     tracking path gives it on frame 31 (2 calls) and on those the first
     keyframe event gives it (6 calls: the loop-closure match and the five
     re-association matches); no single PyTorch call computes it;
   - the fused two-way match kernel (`csrc/two_way_match.cu`) at B in {1, 5}
     and (N, M) up to (512, 512) and (440, 700), on low-entropy descriptors
     (ties in both directions), rows and columns without candidates and
     min_diff in {1, 8}; timed on the inputs the first keyframe event gives
     it, beside the two composites it replaces (per neighbour the standalone
     Hamming kernel, or `torch._int_mm` of the ±1 bits, and the eager
     epilogue; no single PyTorch call computes it).
   Each call is timed with CUDA events in turns (kernel, plain, plain,
   kernel), and each launch's device time is read from torch.profiler.
4. Slice: starts a session on the card from the committed JAX state
   (tests/data/torch_port_bench640_f30.npz: the benchmark world after frame
   30), tracks frames 31-54 through `SlamSession.process_frame`, and holds
   every frame against the stored JAX outputs: state TRACKING, keyframe
   flag, pose R and t within 1e-3, tracked count within 3. In that run the
   fused kernel must launch exactly twice a frame (cascade, track-local-map),
   plus the mapping step's launches on the window's one keyframe (its last
   frame), and the standalone Hamming kernel never. Then torch.profiler traces 8
   frames for the device events and device time per frame.
5. Mapping event: the first keyframe's mapping step (runtime/mapping_step.py)
   on the card from the committed JAX state just before it
   (tests/data/torch_port_bench640_map.npz), held against the JAX map after
   it: `kf_valid`, `mp_valid`, `kf_assoc`, `kf_member` exact, `kf_pose`
   within 1e-4 and `mp_pos` within 2e-3 (float32 LM with sums in another
   order). Timed over repeats and traced once for its device events. The
   event is mapped once more with one live tether put into the map, so that
   local BA's tether residuals run on the card (a map without a live tether
   skips them): the tethered keyframes must end nearer the tether's distance.
6. Mapping window: a session from the frame-30 state runs frames 31-95
   through `process_frame`, mapping the keyframes at 54, 68 and 93. Every
   frame is held against the JAX session as in phase 4; the map after the
   first event must equal the JAX map's masks exactly, and a later event's
   differing mask entries are reported, not hidden. Per frame the launch
   counts must be 2 fused radius-match launches without a keyframe, and on
   a keyframe 8 radius-match (2 tracking, 1 loop-closure match, 5
   re-association) and 1 two-way match; the standalone Hamming kernel never.

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
MAP_FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_bench640_map.npz")
CAM = (520.0, 520.0, 320.0, 240.0)
WIDTH, HEIGHT = 640, 480
DT = 0.033
KERNEL_SHAPES = ((1, 1), (129, 257), (1000, 440), (1024, 512), (2048, 512))
PATH_SHAPES = ((1024, 512), (2048, 512))   # guided cascade, track-local-map
RADIUS_SHAPES = ((1, 1), (129, 257), (512, 512), (1024, 512), (2048, 512), (700, 3000))
# (stages, Q, T) of the radius matches of a tracked frame and of a keyframe event
RADIUS_CALLS_TRACKED = ((3, 1024, 512), (1, 2048, 512))
RADIUS_CALLS_KEYFRAME = ((1, 2048, 512),) + 5 * ((1, 512, 512),)
RADIUS_STAGES = (1, 3)
TWO_WAY_SHAPES = ((1, 1), (129, 257), (512, 512), (440, 700))
TWO_WAY_BATCHES = (1, 5)
TWO_WAY_MIN_DIFFS = (1, 8)
POSE_ATOL = 1e-3
MAP_POSE_ATOL = 1e-4      # kf_pose after a mapping event, against the JAX map
MAP_POINT_ATOL = 2e-3     # mp_pos after a mapping event
MAP_MASKS = ("kf_valid", "mp_valid", "kf_assoc", "kf_member")
MAP_REPEATS = 5
# kernel launches of one frame: (radius_match, two_way_match, hamming)
LAUNCHES_TRACKED = (2, 0, 0)
LAUNCHES_KEYFRAME = (8, 1, 0)
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
    calls of `fn` under the profiler; None where the trace holds no device
    time for it (reported as not measured)."""
    times = [_device_us(e) for e in profile(lambda: [fn() for _ in range(launches)])
             if kernel_name in e.name]
    if times and sum(times) > 0:
        return sum(times) / len(times)
    return None


def us_text(us: float | None) -> str:
    return "not measured" if us is None else f"{us:.2f} us"


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
                        f"device {us_text(us)} a launch (profiler); bound "
                        f"{bound_ms * 1e3:.3f} us ({bound_by})")
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


def capture_radius_calls(run) -> list[dict]:
    """The arguments of every `radius_match_stages` call that `run()`
    makes, tensors cloned."""
    from mageslam_tpu_torch.ops import matching
    from mageslam_tpu_torch.tracking import pose_estimation

    names = TENSOR_ARGS + ("max_hamming", "min_diff", "octave_tol")
    calls, real = [], matching.radius_match_stages

    def recording(*args, **kwargs):
        call = dict(zip(names, args), **kwargs)
        calls.append({k: v.clone() if isinstance(v, torch.Tensor) else v
                      for k, v in call.items()})
        return real(*args, **kwargs)

    matching.radius_match_stages = pose_estimation.radius_match_stages = recording
    try:
        run()
    finally:
        matching.radius_match_stages = pose_estimation.radius_match_stages = real
    return calls


def time_radius_calls(calls: list[dict], where: str, expected) -> dict:
    """Holds the fused kernel exactly against its plain version on each
    captured call and times it there: kernel and plain in turns, device
    time a launch, and the bound from the call's own inputs. `expected` is
    the (stages, Q, T) of each call, in order."""
    from mageslam_tpu_torch.ops import matching

    per_call = []
    for c in calls:
        tensors = [c[k] for k in TENSOR_ARGS]
        scalars = (c["max_hamming"], c["min_diff"], c.get("octave_tol", 0))
        got = matching.radius_match_stages(*tensors, *scalars)
        want = matching.radius_match_stages_plain(*tensors, *scalars)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"radius_match kernel != plain on the inputs of {where}")
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
               "bound_by": bound_by, "candidate_pairs": int(cand.any(0).sum()),
               "matched": int((got[0] >= 0).sum())}
        per_call.append(row)
        phase("kernel", f"radius_match on {where}, call S={n_stages} "
                        f"({n_query}, {n_target}): equal to plain, {row['matched']} matched; "
                        f"{report}; device {us_text(us)} a launch (profiler); bound "
                        f"{bound_ms * 1e3:.3f} us ({bound_by}; {row['candidate_pairs']} "
                        f"candidate pairs)")
    shapes = tuple((r["stages"], *r["shape"]) for r in per_call)
    if shapes != tuple(expected):
        raise AssertionError(f"{where}: radius_match calls (stages, Q, T) {shapes}, "
                             f"expected {tuple(expected)}")
    return {"calls": per_call,
            **{k: sum(r[k] for r in per_call) for k in ("ms", "plain_ms", "bound_ms")},
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in per_call)
            else "operations"}


def time_radius_path(device, frame: np.ndarray, frame_id: int) -> dict:
    """The fused kernel on the two calls that tracking one frame makes (a
    fresh session from the fixture)."""
    from mageslam_tpu_torch import SlamSession, golden_path_settings

    sess = SlamSession.from_jax_snapshot(FIXTURE, golden_path_settings(), CAM, WIDTH,
                                         HEIGHT, device)
    calls = capture_radius_calls(lambda: sess.process_frame(frame, frame_id * DT, frame_id))
    return time_radius_calls(calls, f"frame {frame_id}", RADIUS_CALLS_TRACKED)


def time_radius_mapping(device) -> dict:
    """The fused kernel on the six calls of the first keyframe event: the
    loop-closure match and the five re-association matches."""
    pre = load_event(device)
    calls = capture_radius_calls(lambda: map_event(pre))
    return time_radius_calls(calls, "the first keyframe event", RADIUS_CALLS_KEYFRAME)


def two_way_case(rng: np.random.RandomState, n_batch: int, n_a: int, n_b: int,
                 shared_a: bool) -> dict:
    """numpy inputs of `match_two_way` that reach its edge cases: low-entropy
    descriptors (ties at best and second in both directions), invalid rows
    and columns, and one batch entry with no valid row at all."""
    a_shape = (n_a, 8) if shared_a else (n_batch, n_a, 8)
    valid_a = rng.rand(n_batch, n_a) < 0.8
    valid_a[-1] = n_batch == 1      # the last entry of a real batch is empty
    return {
        "desc_a": LOW_ENTROPY_WORDS[rng.randint(0, 6, a_shape)].view(np.int32),
        "valid_a": valid_a,
        "desc_b": LOW_ENTROPY_WORDS[rng.randint(0, 6, (n_batch, n_b, 8))].view(np.int32),
        "valid_b": rng.rand(n_batch, n_b) < 0.8,
    }


TWO_WAY_ARGS = ("desc_a", "valid_a", "desc_b", "valid_b")


def check_two_way(device) -> int:
    """The fused two-way kernel against its plain version, exact, at every
    listed batch, shape and min_diff. Returns the max abs error (0)."""
    from mageslam_tpu_torch.ops import matching

    rng = np.random.RandomState(2)
    for n_batch in TWO_WAY_BATCHES:
        for n_a, n_b in TWO_WAY_SHAPES:
            for min_diff in TWO_WAY_MIN_DIFFS:
                shared = n_batch > 1 and min_diff == 8   # both layouts of desc_a
                case = two_way_case(rng, n_batch, n_a, n_b, shared)
                args = [torch.from_numpy(np.ascontiguousarray(case[k])).to(device)
                        for k in TWO_WAY_ARGS]
                got = matching.match_two_way(*args, 6, min_diff)
                want = matching.match_two_way_plain(*args, 6, min_diff)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    if (g.shape != (n_batch, n_a) or g.dtype != torch.int32
                            or not torch.equal(g, w)):
                        raise AssertionError(f"two_way_match kernel != plain at B={n_batch}, "
                                             f"({n_a}, {n_b}), min_diff={min_diff}")
                d = torch.stack([matching.hamming_matrix_plain(
                    args[0] if shared else args[0][b], args[2][b]) for b in range(n_batch)])
                d = torch.where(args[1][:, :, None] & args[3][:, None, :] & (d <= 6), d, 1 << 20)
                best_r, best_c = d.amin(2, keepdim=True), d.amin(1, keepdim=True)
                phase("kernel", f"two_way_match B={n_batch} ({n_a}, {n_b}) min_diff={min_diff}"
                                f"{' shared desc_a' if shared else ''}: equal to plain; "
                                f"{int((got[0] >= 0).sum())} matched, rows tied at best "
                                f"{int((((d == best_r) & (d < 1 << 20)).sum(2) > 1).sum())}, "
                                f"columns tied at best "
                                f"{int((((d == best_c) & (d < 1 << 20)).sum(1) > 1).sum())}, "
                                f"rows without candidate {int((best_r >= 1 << 20).sum())}")
    return 0


def load_post_map(device, j: int):
    """The JAX map after the map fixture's event j, as the port's MapState."""
    from mageslam_tpu_torch import interop
    from mageslam_tpu_torch.worldmap.map_state import MapState

    with np.load(MAP_FIXTURE) as z:
        data = {k: z[k] for k in z.files if k.startswith(f"ev{j}_post_map")}
    return interop.unflatten(MapState, f"ev{j}_post_map", data, device)


def load_event(device):
    """(pre_map, pre_pose_history, frame, map_scale, post_map) of the map
    fixture's first event as the port's states on `device`."""
    from mageslam_tpu_torch import interop
    from mageslam_tpu_torch.runtime.pose_history import PoseHistory
    from mageslam_tpu_torch.tracking.frame_state import TrackedFrame
    from mageslam_tpu_torch.worldmap.map_state import MapState

    with np.load(MAP_FIXTURE) as z:
        data = {k: z[k] for k in z.files if k.startswith("ev0_")}
    return (interop.unflatten(MapState, "ev0_pre_map", data, device),
            interop.unflatten(PoseHistory, "ev0_pre_ph", data, device),
            interop.unflatten(TrackedFrame, "ev0_frame", data, device),
            float(data["ev0_map_scale"]), load_post_map(device, 0))


def with_live_tether(pre, distance: float = 3.0, weight: float = 50.0):
    """`pre` with one heavy distance tether between the keyframes in slots 1
    and 2 (no ported path adds a tether yet, so the fixture's map has none)."""
    pre_map = pre[0]
    w = torch.zeros_like(pre_map.tether_weight)
    w[0] = weight
    return (pre_map._replace(
        tether_origin=torch.full_like(pre_map.tether_origin, 1),
        tether_owner=torch.full_like(pre_map.tether_owner, 2),
        tether_kind=torch.zeros_like(pre_map.tether_kind),
        tether_distance=torch.full_like(pre_map.tether_distance, distance),
        tether_weight=w),) + tuple(pre[1:])


def map_event(pre):
    """Map the fixture's first keyframe from `pre` (what `load_event` gives
    for it). Returns (map, pose_history, slot)."""
    from mageslam_tpu_torch import golden_path_settings
    from mageslam_tpu_torch.runtime.mapping_step import mapping

    pre_map, pre_ph, frame, map_scale, _ = pre
    return mapping(golden_path_settings(), WIDTH, HEIGHT, pre_map, pre_ph, frame,
                   map_scale)[:3]


def mask_diffs(got, want) -> dict:
    """{mask: differing entries} over MAP_MASKS of two maps."""
    return {f: int((getattr(got, f) != getattr(want, f)).sum()) for f in MAP_MASKS}


def check_map_event(device, card: str) -> None:
    """Phase 5: the first mapping event against the JAX map after it."""
    from mageslam_tpu_torch.ops import hamming, matching

    pre = load_event(device)
    post = pre[4]
    hamming.LAUNCHES = matching.LAUNCHES = matching.TWO_WAY_LAUNCHES = 0
    new_map, _, ki = map_event(pre)
    torch.cuda.synchronize()
    launches = (matching.LAUNCHES, matching.TWO_WAY_LAUNCHES, hamming.LAUNCHES)
    with np.load(MAP_FIXTURE) as z:
        want_ki = int(z["ev_ki"][0])
    diffs = mask_diffs(new_map, post)
    pose_err = max(float((new_map.kf_pose.R - post.kf_pose.R).abs().max()),
                   float((new_map.kf_pose.t - post.kf_pose.t).abs().max()))
    live = new_map.mp_valid
    point_err = float((new_map.mp_pos - post.mp_pos)[live].abs().max())
    if ki != want_ki or any(diffs.values()):
        raise AssertionError(f"mapping event: slot {ki} (JAX {want_ki}), differing mask "
                             f"entries {diffs}")
    if not (pose_err <= MAP_POSE_ATOL and point_err <= MAP_POINT_ATOL):
        raise AssertionError(f"mapping event: kf_pose err {pose_err:.3g} (limit "
                             f"{MAP_POSE_ATOL}), mp_pos err {point_err:.3g} (limit "
                             f"{MAP_POINT_ATOL})")
    expected = tuple(k - t for k, t in zip(LAUNCHES_KEYFRAME, LAUNCHES_TRACKED))
    if launches != expected:
        raise AssertionError(f"mapping event launched (radius_match, two_way_match, "
                             f"hamming) {launches}, expected {expected}")
    phase("mapping", f"first keyframe event from the JAX state: slot {ki}, "
                     f"{int(new_map.kf_valid.sum())} keyframes, {int(live.sum())} points; "
                     f"{', '.join(MAP_MASKS)} equal to the JAX map; kf_pose err "
                     f"{pose_err:.3g} (limit {MAP_POSE_ATOL}), mp_pos err {point_err:.3g} "
                     f"(limit {MAP_POINT_ATOL}); launches radius_match {launches[0]}, "
                     f"two_way_match {launches[1]}, hamming {launches[2]}")
    ms = []
    for _ in range(MAP_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        map_event(pre)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    phase("mapping", f"event wall time (mapping + synchronize): median "
                     f"{statistics.median(ms):.3f} ms, min {min(ms):.3f}, max {max(ms):.3f} "
                     f"over {MAP_REPEATS} repeats; {card}")
    check_tethered_event(pre, new_map, card)
    events = profile(lambda: map_event(pre))
    device_ms = sum(_device_us(e) for e in events) / 1e3
    if not events or device_ms == 0:
        phase("profile", "mapping event: the profiler recorded no device time: not measured")
        return
    ours = {n: [e for e in events if n in e.name]
            for n in ("radius_match_kernel", "two_way_scan_kernel", "two_way_gate_kernel")}
    phase("profile", f"mapping event: {len(events)} device events, {device_ms:.3f} ms of "
                     f"device time; " + ", ".join(
                         f"{n} {len(es)} launches, "
                         f"{sum(_device_us(e) for e in es) / max(len(es), 1):.2f} us each"
                         for n, es in ours.items()) + f"; {card}")


def check_tethered_event(pre, free_map, card: str) -> None:
    """The same event with one live tether in the map, so that local BA
    runs its tether residuals on the card: the tethered keyframes must end
    nearer the tether's distance than without it, with finite poses and the
    same keyframes."""
    def gap(m):
        c = m.kf_pose.center()
        return float(torch.linalg.norm(c[1] - c[2]))

    distance = gap(free_map) - 0.1
    tethered = with_live_tether(pre, distance)
    map_event(tethered)                                   # warm pass
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    held, _, ki = map_event(tethered)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if not (bool(torch.isfinite(held.kf_pose.t).all()) and torch.equal(held.kf_valid, free_map.kf_valid)
            and abs(gap(held) - distance) < 0.75 * abs(gap(free_map) - distance)):
        raise AssertionError(f"tethered mapping event: slot {ki}, keyframes 1-2 are "
                             f"{gap(held):.4f} apart, {gap(free_map):.4f} without the tether, "
                             f"tether distance {distance:.4f}")
    phase("mapping", f"event with one live distance tether (local BA with the tether "
                     f"residuals): keyframes 1-2 end {gap(held):.4f} apart for a tether of "
                     f"{distance:.4f}, {gap(free_map):.4f} without it; wall {ms:.3f} ms (one "
                     f"run after a warm pass); {card}")


def capture_two_way_call(device) -> dict:
    """The arguments of the `match_two_way` call of the first keyframe
    event."""
    from mageslam_tpu_torch.worldmap import new_points

    calls, real = [], new_points.match_two_way

    def recording(*args):
        calls.append([a.clone() if isinstance(a, torch.Tensor) else a for a in args])
        return real(*args)

    new_points.match_two_way = recording
    try:
        map_event(load_event(device))
    finally:
        new_points.match_two_way = real
    if len(calls) != 1:
        raise AssertionError(f"expected one match_two_way call a keyframe, got {len(calls)}")
    return calls[0]


def time_two_way_path(device) -> dict:
    """Times the fused two-way kernel on the first keyframe event's own
    inputs: kernel and plain in turns, the two composites it replaces,
    device time a launch and the bound."""
    from mageslam_tpu_torch.ops import hamming, matching

    desc_a, valid_a, desc_b, valid_b, max_hamming, min_diff = capture_two_way_call(device)
    n_batch, n_b = desc_b.shape[:2]
    n_a = desc_a.shape[-2]
    args = (desc_a, valid_a, desc_b, valid_b, max_hamming, min_diff)
    got = matching.match_two_way(*args)
    want = matching.match_two_way_plain(*args)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("two_way_match kernel != plain on the keyframe event's inputs")

    def composite(distances):
        return [matching.two_way_from_distances(distances(b), valid_a[b], valid_b[b],
                                                max_hamming, min_diff)
                for b in range(n_batch)]

    a_of = (lambda b: desc_a) if desc_a.dim() == 2 else (lambda b: desc_a[b])
    shifts = torch.arange(32, device=device, dtype=torch.int64)

    def pm_bits(w):
        return ((((w.to(torch.int64) & 0xFFFFFFFF)[..., None] >> shifts) & 1)
                .reshape(*w.shape[:-1], 256).to(torch.int8) * 2 - 1)

    a_pm = [pm_bits(a_of(b)) for b in range(n_batch)]
    b_pm_t = [pm_bits(desc_b[b]).t() for b in range(n_batch)]

    def with_hamming_kernel():
        return composite(lambda b: hamming.hamming_matrix(a_of(b), desc_b[b]))

    def with_int_mm():
        return composite(lambda b: (256 - torch._int_mm(a_pm[b], b_pm_t[b])) // 2)

    for name, fn in (("hamming.cu", with_hamming_kernel), ("torch._int_mm", with_int_mm)):
        out = fn()
        if not all(torch.equal(torch.stack([o[i] for o in out]), got[i]) for i in (0, 1)):
            raise AssertionError(f"the {name} composite != two_way_match kernel")
    launches_before = hamming.LAUNCHES
    t_kernel, t_plain, report = in_turns(lambda: matching.match_two_way(*args),
                                         lambda: matching.match_two_way_plain(*args))
    t_ham, t_mm = cuda_ms(with_hamming_kernel, iters=50), cuda_ms(with_int_mm, iters=50)
    hamming.LAUNCHES = launches_before      # yardstick launches are not the path's
    us_scan = launch_us(lambda: matching.match_two_way(*args), "two_way_scan_kernel")
    us_gate = launch_us(lambda: matching.match_two_way(*args), "two_way_gate_kernel")
    n_bytes = (desc_a.numel() * 4 + n_batch * n_b * 32 + n_batch * (n_a + n_b)
               + 2 * n_batch * n_a * 4)
    # the ±1 bit product, 256 multiply-adds, once for every pair of a valid
    # row and a valid column (the others read BIG whatever their bits)
    pairs = int((valid_a.sum(1) * valid_b.sum(1)).sum())
    bound_ms, bound_by = bound(n_bytes, int8_ops=2 * 256 * pairs)
    phase("kernel", f"two_way_match on the first keyframe event's call B={n_batch} "
                    f"({n_a}, {n_b}), {int(valid_a.sum())} valid rows, {int(valid_b.sum())} "
                    f"valid columns, {int((got[0] >= 0).sum())} matched: {report}; composite "
                    f"of {n_batch} x (hamming.cu + eager epilogue) {t_ham:.5f} ms, of "
                    f"{n_batch} x (torch._int_mm + eager epilogue) {t_mm:.5f} ms (median of "
                    f"5 x 50 calls); device {us_text(us_scan)} (scan) + {us_text(us_gate)} (gate) a call "
                    f"(profiler); bound {bound_ms * 1e3:.3f} us ({bound_by}; {pairs} valid "
                    f"pairs)")
    return {"shape": [n_batch, n_a, n_b], "valid_pairs": pairs, "ms": t_kernel, "plain_ms": t_plain,
            "composite_hamming_kernel_ms": t_ham, "composite_int_mm_ms": t_mm,
            "device_us_scan": us_scan, "device_us_gate": us_gate, "bound_ms": bound_ms,
            "bound_by": bound_by}


def run_map_window(device, frames, first_id: int):
    """A session from the frame-30 state over `frames`, keyframes mapped.
    Returns (results, per-frame ms, per-frame launch counts (radius_match,
    two_way_match, hamming), the mapping events' ms, the map after each
    event)."""
    from mageslam_tpu_torch import SlamSession, golden_path_settings
    from mageslam_tpu_torch.ops import hamming, matching

    sess = SlamSession.from_jax_snapshot(FIXTURE, golden_path_settings(), CAM,
                                         WIDTH, HEIGHT, device)
    map_ms, maps = [], []
    inner = sess._insert_keyframe_and_map

    def timed(frame):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inner(frame)
        torch.cuda.synchronize()
        map_ms.append((time.perf_counter() - t0) * 1e3)
        maps.append(sess.map)

    sess._insert_keyframe_and_map = timed
    results, ms, launches = [], [], []
    for j, img in enumerate(frames):
        i = first_id + j
        before = (matching.LAUNCHES, matching.TWO_WAY_LAUNCHES, hamming.LAUNCHES)
        t0 = time.perf_counter()
        results.append(sess.process_frame(img, i * DT, i))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        after = (matching.LAUNCHES, matching.TWO_WAY_LAUNCHES, hamming.LAUNCHES)
        launches.append(tuple(a - b for a, b in zip(after, before)))
    return results, ms, launches, map_ms, maps


def check_map_window(device, card: str) -> dict:
    """Phase 6. Returns the launch counts of the run, by kernel."""
    from mageslam_tpu_torch.ops import hamming, matching

    with np.load(MAP_FIXTURE) as z:
        ref = {k: z[k] for k in z.files if k.startswith(("ref_", "ev_"))}
    first = int(ref["ref_frame_id"][0])
    frames = render_window(first, first + len(ref["ref_frame_id"]))
    run_map_window(device, frames, first)      # warm pass
    hamming.LAUNCHES = matching.LAUNCHES = matching.TWO_WAY_LAUNCHES = 0
    results, ms, launches, map_ms, maps = run_map_window(device, frames, first)
    totals = {"radius_match": matching.LAUNCHES, "two_way_match": matching.TWO_WAY_LAUNCHES,
              "hamming_matrix": hamming.LAUNCHES}
    pose_err, count_err = check_window(results, ref)
    kf = [r.frame_id for r in results if r.is_keyframe]
    if kf != ref["ev_frame_id"].tolist() or len(kf) < 3:
        raise AssertionError(f"keyframes mapped at {kf}, the JAX session's at "
                             f"{ref['ev_frame_id'].tolist()}")
    for r, got in zip(results, launches):
        want = LAUNCHES_KEYFRAME if r.is_keyframe else LAUNCHES_TRACKED
        if got != want:
            raise AssertionError(f"frame {r.frame_id} (keyframe: {r.is_keyframe}) launched "
                                 f"(radius_match, two_way_match, hamming) {got}, expected "
                                 f"{want}")
    for j, got in enumerate(maps):
        diffs = mask_diffs(got, load_post_map(device, j))
        if j == 0 and any(diffs.values()):
            raise AssertionError(f"the map after the first event (frame {kf[0]}) differs "
                                 f"from the JAX map: {diffs}")
        phase("window", f"map after event {j} (frame {kf[j]}): differing mask entries "
                        f"against the JAX map {diffs}")
    tracked_ms = [t for t, r in zip(ms, results) if not r.is_keyframe]
    phase("window", f"frames {first}-{first + len(frames) - 1}: all TRACKING, keyframes "
                    f"mapped at {kf} as in the JAX session, max pose err {pose_err:.3g} "
                    f"(limit {POSE_ATOL}), max tracked diff {count_err} (limit {TRACKED_TOL})")
    phase("window", f"kernel launches: {LAUNCHES_TRACKED} a tracked frame and "
                    f"{LAUNCHES_KEYFRAME} a keyframe frame (radius_match, two_way_match, "
                    f"hamming), asserted on every frame; totals {totals}")
    phase("window", f"tracked frame (process_frame + synchronize): median "
                    f"{statistics.median(tracked_ms):.3f} ms, min {min(tracked_ms):.3f}, max "
                    f"{max(tracked_ms):.3f} over {len(tracked_ms)} frames; mapping event "
                    f"(inside its keyframe's process_frame): median "
                    f"{statistics.median(map_ms):.3f} ms, min {min(map_ms):.3f}, max "
                    f"{max(map_ms):.3f} over {len(map_ms)} events; after one warm pass; {card}")
    return totals


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
    two_way_err = check_two_way(device)

    with np.load(FIXTURE) as z:
        ref = {k: z[k] for k in z.files if k.startswith("ref_")}
    first = int(ref["ref_frame_id"][0])
    frames = render_window(first, first + len(ref["ref_frame_id"]))
    fused = time_radius_path(device, frames[0], first)

    fused_map = time_radius_mapping(device)
    two_way = time_two_way_path(device)

    run_window(device, frames, first)          # warm pass: allocator, caches
    hamming.LAUNCHES = matching.LAUNCHES = matching.TWO_WAY_LAUNCHES = 0
    results, ms = run_window(device, frames, first)
    fused_launches, two_way_launches, ham_launches = (
        matching.LAUNCHES, matching.TWO_WAY_LAUNCHES, hamming.LAUNCHES)
    pose_err, count_err = check_window(results, ref)
    kf = [r.frame_id for r in results if r.is_keyframe]
    extra = LAUNCHES_KEYFRAME[0] - LAUNCHES_TRACKED[0]      # a mapped keyframe's own
    if (fused_launches != LAUNCHES_TRACKED[0] * len(frames) + extra * len(kf)
            or two_way_launches != len(kf) or ham_launches != 0):
        raise AssertionError(f"over {len(frames)} frames with {len(kf)} keyframes mapped: "
                             f"radius_match kernel launched {fused_launches} times (expected "
                             f"{LAUNCHES_TRACKED[0]} a frame and {extra} more a keyframe), "
                             f"two_way_match {two_way_launches} (expected 1 a "
                             f"keyframe), hamming kernel {ham_launches} times (expected 0)")
    phase("slice", f"frames {first}-{first + len(frames) - 1}: all TRACKING, "
                   f"keyframes at {kf}, max pose err {pose_err:.3g} (limit "
                   f"{POSE_ATOL}), max tracked diff {count_err} (limit {TRACKED_TOL})")
    phase("slice", f"kernel launches in the run: radius_match {fused_launches} "
                   f"({LAUNCHES_TRACKED[0]} a frame, {extra} more on each of {len(kf)} "
                   f"mapped keyframes), two_way_match {two_way_launches}, hamming "
                   f"{ham_launches}")
    phase("slice", f"per-frame wall time (process_frame + synchronize): median "
                   f"{statistics.median(ms):.3f} ms, min {min(ms):.3f}, max "
                   f"{max(ms):.3f} over {len(ms)} frames after one warm pass; {card}")
    profile_window(device, frames, first, card)

    check_map_event(device, card)
    map_launches = check_map_window(device, card)

    ham_row = ham["rows"][PATH_SHAPES[-1]]
    first_path = {"radius_match": fused_launches, "two_way_match": two_way_launches,
                  "hamming_matrix": ham_launches}

    def launches(kernel: str) -> dict:
        return {"launches": first_path[kernel] + map_launches[kernel],
                "launches_by_path": {"frames_31_54": first_path[kernel],
                                     "frames_31_95_mapped": map_launches[kernel]}}

    print(json.dumps({"kernels": [
        {"name": "radius_match", "route": "cuda",
         "source": "mageslam_tpu_torch/csrc/radius_match.cu",
         "replaces": "mageslam_tpu/ops/pallas_kernels.py:57",
         **launches("radius_match"), "max_abs_err": fused_err,
         "ms": fused["ms"], "plain_ms": fused["plain_ms"], "bound_ms": fused["bound_ms"],
         "bound_by": fused["bound_by"], "library_ms": None,
         "note": "ms, plain_ms, bound_ms: sum of a tracked frame's two calls (calls); "
                 "keyframe: the same sums and calls of a keyframe event's six more",
         "calls": fused["calls"], "keyframe": fused_map},
        {"name": "hamming_matrix", "route": "cuda",
         "source": "mageslam_tpu_torch/csrc/hamming.cu",
         "replaces": "mageslam_tpu/ops/pallas_kernels.py:57",
         **launches("hamming_matrix"), "max_abs_err": ham["max_abs_err"],
         "ms": ham_row["ms"], "plain_ms": ham_row["plain_ms"],
         "bound_ms": ham_row["bound_ms"], "bound_by": ham_row["bound_by"],
         "library_ms": ham_row["library_ms"], "shape": list(PATH_SHAPES[-1]),
         "rows": {f"{n}x{m}": r for (n, m), r in ham["rows"].items()}},
        {"name": "two_way_match", "route": "cuda",
         "source": "mageslam_tpu_torch/csrc/two_way_match.cu",
         "replaces": "mageslam_tpu/ops/pallas_kernels.py:57",
         **launches("two_way_match"), "max_abs_err": two_way_err,
         "ms": two_way["ms"], "plain_ms": two_way["plain_ms"],
         "bound_ms": two_way["bound_ms"], "bound_by": two_way["bound_by"],
         "library_ms": None,
         "note": "no single PyTorch call computes it; the composites it replaces are timed",
         **{k: two_way[k] for k in ("shape", "composite_hamming_kernel_ms",
                                    "composite_int_mm_ms", "valid_pairs", "device_us_scan",
                                    "device_us_gate")}},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
