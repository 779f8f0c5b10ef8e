"""One run of one cell: everything `run.py` does after the card check.

The harness is driven by `BENCHMARK.json` and finds each piece by name:

- a configuration, `slambench/configs/<config>.json`: the settings keys it
  changes from the program's `golden_path_settings()` (nested as the
  settings are), the camera, and the source, `assumed` and `reduced`;
- a traffic mix, `slambench/traffic/<traffic>.json`: its generator
  (`slambench/traffic/<generator>.py`, a `World(seed, traffic, config)`),
  the scene and trajectory, the entry point (`process_frame`, or `stream`
  with its chunk and segment), the warm-up and the pass;
- a metric, `slambench/metrics/<name>.py`, whose `read(ctx)` returns the
  number or None.

A run builds the session from the seed, warms it up through the traffic's
warm-up frames (initialization, the vocabulary retrain, mapping events),
snapshots it, warms the pass's own shapes, and then times passes, each from
the snapshot, until the window is full. The traced run (`trace=True`) times
the layer spans over its window and profiles a short stretch after it.
Once the window has closed and the device's peak is read, the session is
freed and the captured outputs are held against the reference (check.py).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TORCH_THREADS = 2
STRETCH_FRAMES = 24


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(os.path.join(ROOT, c["file"]))
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return _json(os.path.join(HERE, "traffic", f"{name}.json"))


def generator(name: str):
    return _module(os.path.join(HERE, "traffic", f"{name}.py"), f"slambench_gen_{name}")


def reader(name: str):
    return _module(os.path.join(HERE, "metrics", f"{name}.py"),
                   "slambench_metric_" + name.replace(".", "_"))


def metrics_for(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with `trace` its per-layer ones."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def override(obj, changes: dict):
    """A settings dataclass with `changes` (nested dicts) applied."""
    kw = {}
    for key, value in changes.items():
        cur = getattr(obj, key)
        kw[key] = override(cur, value) if isinstance(value, dict) else type(cur)(value)
    return dataclasses.replace(obj, **kw)


def port_modules() -> dict:
    """The program's modules whose looked-up functions the harness wraps."""
    names = {"session": "runtime.session", "streaming": "runtime.streaming",
             "frame_step": "runtime.frame_step", "mapping_step": "runtime.mapping_step",
             "track_local_map": "tracking.track_local_map",
             "pose_estimation": "tracking.pose_estimation", "matching": "ops.matching",
             "relocalization": "tracking.relocalization", "new_points": "worldmap.new_points",
             "bow_words": "ops.bow_words"}
    return {k: importlib.import_module(f"mageslam_tpu_torch.{v}") for k, v in names.items()}


class Feeder:
    """Feeds frames of the pass bank through the traffic's entry point."""

    def __init__(self, sess, world, tr: dict, i0: int, bank, capture):
        self.sess, self.tr, self.bank, self.capture = sess, tr, bank, capture
        self.n = bank.shape[0]
        self.ts = [world.timestamp(i0 + k) for k in range(self.n)]
        self.ids = [i0 + k for k in range(self.n)]
        self.stream = tr["entry"] == "stream"
        self.step = tr.get("segment", 1) if self.stream else 1

    def feed(self, k: int) -> list:
        """Frames from pass index k: one frame, or one stream segment.
        Returns their FrameResults."""
        self.capture.next_frame = k
        if not self.stream:
            return [self.sess.process_frame(self.bank[k], self.ts[k], self.ids[k])]
        stop = min(k + self.step, self.n)
        return self.sess.process_frame_stream(self.bank, self.ts, self.ids, start=k, stop=stop,
                                              chunk=self.tr["chunk"])

    def feed_range(self, k0: int, k1: int) -> None:
        """Frames [k0, k1): frame by frame, or as one stream call."""
        self.capture.next_frame = k0
        if self.stream:
            if k1 > k0:
                self.sess.process_frame_stream(self.bank, self.ts, self.ids, start=k0, stop=k1,
                                               chunk=self.tr["chunk"])
            return
        for k in range(k0, k1):
            self.feed(k)


def warm_up(sess, world, tr: dict, modules) -> int:
    """Per-frame from frame 0 until the traffic's warm-up holds: at least
    `min_frames`, initialized and retrained, `mapping_events` keyframes
    mapped after the adoption, and tracking. Returns the pass's first
    frame."""
    w = tr["warmup"]
    track = modules["session"].TrackingState.TRACKING
    events, adopted = 0, False
    for i in range(w["max_frames"]):
        res = sess.process_frame(world.frame(i), world.timestamp(i), i)
        if adopted and res.is_keyframe:
            events += 1
        adopted = adopted or sess.initialized
        n = i + 1
        if (n >= w["min_frames"] and sess.initialized and sess.bow_training.retrained
                and events >= w["mapping_events"] and res.state == track):
            return n
    raise RuntimeError(f"warm-up not reached in {w['max_frames']} frames "
                       f"(initialized {sess.initialized}, mapping events {events})")


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", control: bool = False,
             on_window=None) -> dict:
    """One run. Returns {"result": the result line's dict, "check": the
    compared numbers beside their limits, "extra": what the run saw}; with
    `control`, "control" holds the numbers of the reference computed in
    TF32 put in the program's place, on the same captured calls, and
    `match_mismatch.planted`, the program's matcher answers with a fault
    planted (`check.planted_match_fault`).
    `on_window()`, if given, is called as the window opens (the tests break
    the timed path there)."""
    import torch

    from . import check
    from . import trace as tracing

    torch.set_num_threads(TORCH_THREADS)
    cell = workload(bench, cell_name)
    cfg = config(bench, cell["config"])
    tr = traffic(cell["traffic"])
    world = generator(tr["generator"]).World(seed, tr, cfg)

    import mageslam_tpu_torch as port

    modules = port_modules()
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    settings = override(port.golden_path_settings(), cfg.get("settings", {}))
    cam = cfg["camera"]["pinhole"]
    sess = port.SlamSession(settings, cam, world.width, world.height, device=device, seed=seed)
    capture = check.Capture(seed, modules)
    spans = tracing.Spans(modules, sync) if trace else None
    try:
        i0 = warm_up(sess, world, tr, modules)
        bank = torch.from_numpy(world.frames(i0, i0 + tr["pass"]["frames"])).to(dev)
        snap = sess.snapshot_state()
        feeder = Feeder(sess, world, tr, i0, bank, capture)

        # the pass's own shapes: its first mapping event (or its first
        # frames) through the entry point, then back to the snapshot
        k = 0
        while k < feeder.n:
            res = feeder.feed(k)
            k += len(res)
            if k >= tr["pass"]["warm_frames"] and (
                    not tr["expects_mapping"] or any(r.is_keyframe for r in res)):
                break
        sync()
        sess.restore_state(snap)
        setup_s = time.perf_counter() - t_start

        # the window: passes from the snapshot until `seconds` are timed
        frame_s, results, window_s, first_kf, passes = [], [], 0.0, None, []
        if on_window:
            on_window()
        capture.active = True
        if spans:
            spans.timing = True
        while window_s < seconds:
            sess.restore_state(snap)
            sync()
            t_pass = time.perf_counter()
            k = 0
            while k < feeder.n:
                t0 = time.perf_counter()
                res = feeder.feed(k)
                t1 = time.perf_counter()
                if not feeder.stream:
                    frame_s.append(t1 - t0)
                for j, r in enumerate(res):
                    if r.is_keyframe and first_kf is None:
                        first_kf = k + j
                results.extend(res)
                k += len(res)
                if window_s + (t1 - t_pass) >= seconds:
                    break
            sync()
            window_s += time.perf_counter() - t_pass
            passes.append((k, time.perf_counter() - t_pass))
        capture.active = False
        if spans:
            spans.timing = False
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

        stretch = None
        if trace:
            stretch = _stretch(sess, snap, feeder, first_kf, spans, modules, sync, tracing)
        track = modules["session"].TrackingState.TRACKING
        failed = sum(r.state != track for r in results)
        fes = settings.MonoSettings.MonoCamera.FeatureExtractorSettings
        n_slots = settings.Budgets.MaxFeatures
    finally:
        if spans:       # the wrappers come off in the reverse order of going on
            spans.close()
        capture.close()

    # the program's state is freed before the reference runs
    del sess, snap, feeder
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = check.compare(capture, bank, fes, cam, n_slots, tr["expects_mapping"])
    matches = capture.match_counts
    correct, table = check.verdict(numbers, check.limits())
    controls = None
    if control:
        controls = check.compare(capture, bank, fes, cam, n_slots, tr["expects_mapping"],
                                 control=True)
        controls["match_mismatch.planted"] = check.planted_match_fault(capture)

    ctx = {"frames": len(results), "window_s": window_s, "frame_s": frame_s,
           "setup_s": setup_s, "spans": spans.seconds if spans else {}, "stretch": stretch}
    metrics = {}
    for m in metrics_for(bench, cell_name, trace):
        value = reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(results), "failed": failed,
              "metrics": metrics, "device": dev_info}
    if stretch:
        dev_info["busy_s"] = stretch["busy_s"]
        dev_info["window_s"] = stretch["window_s"]
        result["breakdown"] = {"device_ops": [list(x) for x in stretch["device_ops"]],
                               "idle_gaps": [list(x) for x in stretch["idle_gaps"]]}
    extra = {"warmup_frames": i0, "window_frames": len(results), "first_keyframe": first_kf,
             "keyframes": sum(r.is_keyframe for r in results),
             "passes": [[k, round(t, 4)] for k, t in passes],
             "tracked_mean": sum(r.tracked_count for r in results) / max(len(results), 1),
             "frame_p95_ms": reader("frame_p95_ms.host").read(ctx),
             "sampled": {k: len(r.items) for k, r in capture.sample.items()},
             "matches": matches}
    return {"result": result, "check": table, "extra": extra, "control": controls,
            "stretch": stretch}


def _stretch(sess, snap, feeder, first_kf, spans, modules, sync, tracing) -> dict:
    """Profile a short steady stretch from the snapshot: around the window's
    first mapping event where it had one (for the stream, the chunk holding
    it), else the pass's first frames."""
    if feeder.stream:
        n = min(feeder.tr["chunk"], feeder.n)
        start = 0 if first_kf is None else first_kf - first_kf % n
    else:
        n = min(STRETCH_FRAMES, feeder.n)
        start = 0 if first_kf is None else max(0, first_kf - n // 2)
    start = min(start, feeder.n - n)
    sess.restore_state(snap)
    feeder.feed_range(0, start)
    sync()
    spans.annotate = True
    try:
        return tracing.profile_stretch(lambda: feeder.feed_range(start, start + n), n, modules,
                                       sync)
    finally:
        spans.annotate = False
