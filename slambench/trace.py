"""The traced run's instruments, all from the benchmark's own files.

- `Spans`: host-clock spans around the calls into each layer (the module
  functions the session looks up, wrapped for the traced window only), each
  ending in a synchronize, so that a span holds its layer's device work.
- `profile_stretch`: torch.profiler over a short steady stretch, reduced to
  device events, busy time, the window (the trace's own span, from the first
  device event or layer range to the end of the last), idle gaps labelled
  with the host's stage (the `record_function` ranges the spans open), and
  each recorded `radius_match_stages` call's device time against its least
  time.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time

import torch

from . import roofline

# layer name → (module key, function name) of each call the spans wrap
LAYER_CALLS = {
    "frontend": (("session", "detect_and_compute"), ("streaming", "detect_and_compute")),
    "track": (("session", "track_step"), ("frame_step", "track_step")),
    "mapping_event": (("session", "mapping"), ("streaming", "mapping")),
}
RADIUS_CALLS = (("matching", "radius_match_stages"), ("pose_estimation", "radius_match_stages"))
RADIUS_ARGS = ("query_desc", "query_xy", "query_octave", "query_valid", "target_desc",
               "target_xy", "target_octave", "target_valid", "radius", "max_hamming",
               "min_diff", "octave_tol", "group_rows")


class Patches:
    """Module attributes replaced for a while, put back on `close()`."""

    def __init__(self):
        self._undo = []

    def wrap(self, mod, name, make) -> None:
        orig = getattr(mod, name)
        setattr(mod, name, make(orig))
        self._undo.append((mod, name, orig))

    def close(self) -> None:
        for mod, name, orig in reversed(self._undo):
            setattr(mod, name, orig)
        self._undo = []


class Spans(Patches):
    """Seconds of every call into each layer while `timing`; with
    `annotate`, each call also opens a profiler range of its layer's name."""

    def __init__(self, modules: dict, sync):
        super().__init__()
        self.sync = sync
        self.timing = False
        self.annotate = False
        self.seconds = {layer: [] for layer in LAYER_CALLS}
        for layer, calls in LAYER_CALLS.items():
            for mod, name in calls:
                self.wrap(modules[mod], name, self._span(layer))

    def _span(self, layer):
        def make(orig):
            def wrapped(*args, **kwargs):
                if self.annotate:
                    with torch.profiler.record_function(layer):
                        return orig(*args, **kwargs)
                if not self.timing:
                    return orig(*args, **kwargs)
                self.sync()
                t0 = time.perf_counter()
                out = orig(*args, **kwargs)
                self.sync()
                self.seconds[layer].append(time.perf_counter() - t0)
                return out
            return wrapped
        return make


class RadiusCalls(Patches):
    """Every `radius_match_stages` call's tensors while it stands."""

    def __init__(self, modules: dict):
        super().__init__()
        self.calls = []
        for mod, name in RADIUS_CALLS:
            self.wrap(modules[mod], name, self._record)

    def _record(self, orig):
        def wrapped(*args, **kwargs):
            call = dict(zip(RADIUS_ARGS, args))
            call.update(kwargs)
            self.calls.append({k: v for k, v in call.items() if torch.is_tensor(v)}
                              | {"octave_tol": int(call.get("octave_tol") or 0)})
            return orig(*args, **kwargs)
        return wrapped


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals):
    """Total length and the gaps of a list of (start, end)."""
    busy, gaps, end = 0.0, [], None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy, gaps


def profile_stretch(run, frames: int, modules: dict, sync) -> dict:
    """Run `run()` (a stretch of `frames` frames) under the profiler and
    reduce its trace. Returns a summary: events, busy_s, window_s,
    device_ops, idle_gaps, radius (least s, device s, launches)."""
    from torch.profiler import ProfilerActivity, profile

    radius = RadiusCalls(modules)
    sync()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            sync()
    finally:
        radius.close()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    ranges = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    iv = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in dev]
    busy_us, gaps = _union(iv)
    # the window is the trace's own: from the first device event or layer
    # range to the end of the last, on the trace's clock
    ends = iv + [(float(r["ts"]), float(r["ts"]) + float(r.get("dur", 0.0))) for r in ranges]
    window_us = max(e for _, e in ends) - min(s for s, _ in ends) if ends else 0.0
    by_name = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e.get("dur", 0.0)) * 1e-6

    spans = sorted((float(r["ts"]), float(r["ts"]) + float(r.get("dur", 0.0)), r["name"])
                   for r in ranges)
    starts = [s for s, _, _ in spans]

    def stage_at(t):
        """The layer range the host was in at trace time `t` (the ranges do
        not overlap: one layer call at a time), else "session"."""
        i = bisect.bisect_right(starts, t) - 1
        return spans[i][2] if i >= 0 and t <= spans[i][1] else "session"

    labelled = {}
    for s, e in gaps:
        name = stage_at(0.5 * (s + e))
        labelled[name] = labelled.get(name, 0.0) + (e - s) * 1e-6
    radius_us = [float(e.get("dur", 0.0)) for e in dev
                 if e.get("cat") == "kernel" and "radius_match_kernel" in e["name"]]
    least = sum(roofline.radius_match_bound_s(c) for c in radius.calls)
    return {
        "frames": frames,
        "events": len(dev),
        "busy_s": busy_us * 1e-6,
        "window_s": window_us * 1e-6,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(labelled.items(), key=lambda kv: -kv[1])[:10],
        "radius": {"least_s": least, "device_s": sum(radius_us) * 1e-6,
                   "launches": len(radius_us), "calls": len(radius.calls)},
    }
