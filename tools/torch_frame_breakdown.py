"""Where a tracked frame's and a mapping event's time go in the PyTorch
port, on one GPU.

    python tools/torch_frame_breakdown.py [--frames 8] [--out breakdown.json]

Starts a session from the committed JAX state (as chip_smoke.py does) and,
on bench.py's frames 31.., times with CUDA events:
  - the whole `process_frame` and its three steps (frontend, track, post);
  - the frontend's stages (FAST score map, NMS, candidate selection, ANMS,
    blur, descriptor bit planes, gather) on the same frames;
then traces `--frames` frames with torch.profiler for the number of device
kernels per frame, the device-busy share of the wall time, and the top
kernels by device time.

Then the first keyframe's mapping event (from the committed JAX state just
before it, as chip_smoke.py maps it) `--map-repeats` times, with the wall
time of each stage of runtime/mapping_step.py (loop-closure match, insert +
feature index, recent-point cull, covisibility, new points, statistics
refresh, window build, LM, write-back, keyframe cull, rebase), each ending
in a device synchronize, and one traced event for its device events, device
time and top kernels; then the same with one live tether put into the map,
which makes local BA run its tether residuals (a map without a live tether
skips them). Requires a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _device_us(e, total: bool) -> float:
    """Device time of a profiler event in microseconds (the attribute was
    renamed from cuda_* to device_* across PyTorch versions)."""
    names = ("device_time_total", "cuda_time_total") if total else ("device_time", "cuda_time")
    for n in names:
        if hasattr(e, n):
            return float(getattr(e, n))
    return 0.0


def event_ms(fn) -> tuple[float, object]:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop), out


def frontend_stages(img: torch.Tensor, fes) -> dict[str, float]:
    from mageslam_tpu_torch.ops import anms, fast, image, orb
    from mageslam_tpu_torch.ops.frontend import CANDIDATES_PER_LEVEL

    t = {}
    t["fast_score_map"], score = event_ms(lambda: fast.fast_score_map(img, fes.FastThreshold))
    t["nms3x3"], score = event_ms(lambda: fast.nms3x3(score))
    t["extract_candidates"], (xy, resp, valid) = event_ms(
        lambda: fast.extract_candidates(score, CANDIDATES_PER_LEVEL, fes.ImageBorder))
    n = fes.NumFeatures

    def select():
        v = anms.retain_best_features(resp, valid, n, int(n * fes.FeatureFactor),
                                      fes.FastThreshold, fes.FeatureStrength)
        return anms.adaptive_nms(xy, resp, v, n, fes.FastThreshold, fes.StrongResponse,
                                 fes.MinRobustnessFactor, fes.MaxRobustnessFactor)
    t["anms"], _ = event_ms(select)
    t["gaussian_blur"], blurred = event_ms(
        lambda: image.gaussian_blur(img, fes.GaussianKernelSize, 2.0))
    t["descriptor_bit_planes"], planes = event_ms(
        lambda: orb.descriptor_bit_planes(blurred, fes.PatchSize))
    t["gather_descriptors"], _ = event_ms(lambda: orb.gather_descriptors(planes, xy[:n]))
    return t


def mapping_breakdown(device, card: str, repeats: int, tethered: bool = False) -> dict:
    """Stage times and a device profile of the first keyframe's mapping
    event; `tethered` puts one live tether into the map first."""
    from mageslam_tpu_torch import golden_path_settings
    from mageslam_tpu_torch.runtime.mapping_step import STAGES, mapping
    from torch.profiler import ProfilerActivity, profile

    pre = chip_smoke.load_event(device)
    pre_map, pre_ph, frame, map_scale, _ = chip_smoke.with_live_tether(pre) if tethered else pre
    settings = golden_path_settings()
    tag = "mapping, one live tether" if tethered else "mapping"

    def run(probe=None):
        return mapping(settings, chip_smoke.WIDTH, chip_smoke.HEIGHT, pre_map, pre_ph,
                       frame, map_scale, probe=probe)

    run()                                               # warm pass
    stage_ms = {name: [] for name in STAGES}
    whole_ms = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        mark = [time.perf_counter()]

        def probe(name):
            torch.cuda.synchronize()
            now = time.perf_counter()
            stage_ms[name].append((now - mark[0]) * 1e3)
            mark[0] = now

        t0 = mark[0]
        run(probe)
        whole_ms.append((time.perf_counter() - t0) * 1e3)
    out = {"repeats": repeats, "event_median_ms": statistics.median(whole_ms),
           "stages_median_ms": {k: statistics.median(v) for k, v in stage_ms.items()}}
    print(f"[{tag}] event: {out['event_median_ms']:.3f} ms (median of {repeats}, a "
          f"synchronize after each stage; {card})")
    for k, v in out["stages_median_ms"].items():
        print(f"[{tag}] {k}: {v:.3f} ms")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - w0) * 1e3
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_ms = sum(_device_us(e, False) for e in kernels) / 1e3
    top = sorted(prof.key_averages(), key=lambda e: -_device_us(e, True))[:15]
    out["profile"] = {
        "wall_ms": wall_ms, "device_events": len(kernels), "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms if kernels else None,
        "top": [{"name": e.key, "count": e.count, "device_ms": _device_us(e, True) / 1e3}
                for e in top]}
    if kernels:
        print(f"[{tag}] traced event: {len(kernels)} device events, device busy "
              f"{busy_ms:.3f} of {wall_ms:.2f} ms wall "
              f"({100 * busy_ms / wall_ms:.1f} % under the profiler)")
    else:
        print(f"[{tag}] the profiler recorded no device events: not measured")
    for e in out["profile"]["top"]:
        print(f"[{tag}] {e['device_ms']:9.3f} ms  x{e['count']:6d}  {e['name'][:90]}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--map-repeats", type=int, default=5)
    ap.add_argument("--out", help="also write the summary here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_frame_breakdown: no CUDA device", file=sys.stderr)
        return 1
    from mageslam_tpu_torch import SlamSession, golden_path_settings
    from mageslam_tpu_torch.ops.frontend import detect_and_compute
    from mageslam_tpu_torch.runtime.post_step import post_step
    from mageslam_tpu_torch.runtime.track_step import track_step

    device = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    first = 31
    frames = chip_smoke.render_window(first, first + 24)
    settings = golden_path_settings()
    chip_smoke.run_window(device, frames, first)       # warm pass

    sess = SlamSession.from_jax_snapshot(chip_smoke.FIXTURE, settings, chip_smoke.CAM,
                                         chip_smoke.WIDTH, chip_smoke.HEIGHT, device)
    steps = {"frontend": [], "track": [], "post": [], "frame_wall": []}
    stages: dict[str, list[float]] = {}
    for j, img_np in enumerate(frames):
        i = first + j
        img = torch.as_tensor(img_np).to(device).to(torch.float32)
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        t_f, feats = event_ms(lambda: detect_and_compute(img, sess.cam16, sess.fes, sess.N))
        frame = sess._frame(feats, i * chip_smoke.DT, i)
        t_t, res = event_ms(lambda: track_step(settings, sess.width, sess.height,
                                               sess.map, sess.history, frame))
        if not bool(res.succeeded):
            raise AssertionError(f"frame {i} lost")
        sess.frames_since_keyframe += 1
        sess.frames_since_reloc += 1
        fsk = sess._scalar(sess.frames_since_keyframe, torch.int32)
        fsr = sess._scalar(min(sess.frames_since_reloc, 10_000), torch.int32)
        t_p, out = event_ms(lambda: post_step(
            settings, sess.width, sess.height, sess.map, sess.history,
            sess.pose_history, res.frame, res.found_delta, res.predicted_delta, fsk, fsr))
        sess.map, sess.history, sess.pose_history, _ = out
        steps["frame_wall"].append((time.perf_counter() - w0) * 1e3)
        steps["frontend"].append(t_f)
        steps["track"].append(t_t)
        steps["post"].append(t_p)
        for k, v in frontend_stages(img, sess.fes).items():
            stages.setdefault(k, []).append(v)

    summary = {"card": card, "device": torch.cuda.get_device_name(0),
               "steps_median_ms": {k: statistics.median(v) for k, v in steps.items()},
               "frontend_stages_median_ms": {k: statistics.median(v)
                                             for k, v in stages.items()}}
    for k, v in summary["steps_median_ms"].items():
        print(f"[steps] {k}: {v:.3f} ms (median of {len(frames)} frames; {card})")
    for k, v in summary["frontend_stages_median_ms"].items():
        print(f"[frontend] {k}: {v:.3f} ms")

    # device kernels per frame and device-busy share, from the profiler
    from torch.profiler import ProfilerActivity, profile

    sess2 = SlamSession.from_jax_snapshot(chip_smoke.FIXTURE, settings, chip_smoke.CAM,
                                          chip_smoke.WIDTH, chip_smoke.HEIGHT, device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        for j in range(args.frames):
            sess2.process_frame(frames[j], (first + j) * chip_smoke.DT, first + j)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - w0) * 1e3
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_ms = sum(_device_us(e, False) for e in kernels) / 1e3
    top = sorted(prof.key_averages(), key=lambda e: -_device_us(e, True))[:15]
    summary["profile"] = {
        "frames": args.frames, "wall_ms": wall_ms,
        "device_events": len(kernels),
        "device_events_per_frame": len(kernels) / args.frames,
        "device_busy_ms": busy_ms,
        "device_busy_ms_per_frame": busy_ms / args.frames,
        "device_busy_share": busy_ms / wall_ms if kernels else None,
        "top": [{"name": e.key, "count": e.count, "device_ms": _device_us(e, True) / 1e3}
                for e in top],
    }
    p = summary["profile"]
    if kernels:
        print(f"[profile] {p['frames']} frames: {p['device_events_per_frame']:.0f} device "
              f"events/frame, device busy {busy_ms:.2f} of {wall_ms:.2f} ms wall "
              f"({100 * p['device_busy_share']:.1f} % under the profiler; "
              f"{p['device_busy_ms_per_frame']:.3f} ms of device time per frame)")
    else:
        print("[profile] the profiler recorded no device events: not measured")
    ham = [e for e in kernels if "hamming_kernel" in e.name]
    if ham:
        p["hamming_kernel_device_us_per_launch"] = (
            sum(_device_us(e, False) for e in ham) / len(ham))
        print(f"[profile] hamming_kernel: {len(ham)} launches, "
              f"{p['hamming_kernel_device_us_per_launch']:.2f} us device time each")
    for e in p["top"]:
        print(f"[profile] {e['device_ms']:9.3f} ms  x{e['count']:6d}  {e['name'][:90]}")
    summary["mapping_event"] = mapping_breakdown(device, card, args.map_repeats)
    summary["mapping_event_tethered"] = mapping_breakdown(device, card, args.map_repeats,
                                                          tethered=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
