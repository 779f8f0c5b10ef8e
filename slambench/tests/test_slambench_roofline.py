"""The roofline arithmetic against the bounds PERF.md records for the port's
radius-match kernel, and the per-layer readers' arithmetic."""

import math

import pytest
import torch

from slambench import harness, roofline


def test_cascade_bound_is_0_037_us_at_1024x512_three_stages():
    # bytes alone: PERF.md's kernel table records 0.037 us (bytes) here
    t, by = roofline.bound_s(roofline.radius_match_bytes(3, 1024, 512))
    assert by == "bytes"
    assert t * 1e6 == pytest.approx(0.0365, abs=5e-4)


def test_track_local_map_bound_is_0_042_us_at_2048x512():
    t, _ = roofline.bound_s(roofline.radius_match_bytes(1, 2048, 512))
    assert t * 1e6 == pytest.approx(0.042, abs=5e-4)


def test_operations_set_the_bound_when_every_pair_is_a_candidate():
    f32, int8 = roofline.radius_match_ops(3, 1024 * 512, 1024 * 512)
    t, by = roofline.bound_s(roofline.radius_match_bytes(3, 1024, 512), f32, int8)
    assert by == "operations"
    assert t == pytest.approx(max(f32 / roofline.F32_OPS_PER_S, int8 / roofline.INT8_OPS_PER_S))


def test_counts_of_a_small_call():
    g = torch.Generator().manual_seed(0)
    q, n = 5, 7
    call = {"query_desc": torch.zeros((q, 8), dtype=torch.int32),
            "query_xy": torch.rand((2, q, 2), generator=g) * 10,
            "query_octave": torch.zeros(q, dtype=torch.int32),
            "query_valid": torch.ones(q, dtype=torch.bool),
            "target_desc": torch.zeros((n, 8), dtype=torch.int32),
            "target_xy": torch.rand((n, 2), generator=g) * 10,
            "target_octave": torch.zeros(n, dtype=torch.int32),
            "target_valid": torch.tensor([True] * (n - 1) + [False]),
            "radius": torch.full((2, q), 3.0)}
    gated, cand = roofline.radius_match_counts(
        call["query_xy"], call["query_octave"], call["query_valid"], call["target_xy"],
        call["target_octave"], call["target_valid"], call["radius"])
    assert gated == q * (n - 1)
    want = 0
    for i in range(q):
        for j in range(n - 1):
            d = (call["query_xy"][:, i] - call["target_xy"][j]).abs().amax(-1)
            want += bool((d <= 3.0).any())
    assert cand == want
    assert roofline.radius_match_bound_s(call) > 0


def test_readers():
    ctx = {"frames": 300, "window_s": 30.0, "frame_s": [0.1] * 95 + [0.2] * 5,
           "setup_s": 12.5, "spans": {"frontend": [0.02, 0.04], "track": [], "mapping_event": []},
           "stretch": {"frames": 24, "events": 24 * 4626, "busy_s": 0.3, "window_s": 3.0,
                       "radius": {"least_s": 48 * 4e-8, "device_s": 48 * 1e-5, "launches": 48,
                                  "calls": 48}}}
    read = {n: harness.reader(n).read(ctx) for n in (
        "frames_per_s", "frame_p95_ms.host", "setup_s", "frontend_ms", "track_ms",
        "mapping_event_ms", "radius_match_roofline_pct", "device_events_per_frame",
        "device_idle_pct")}
    assert read["frames_per_s"] == 10.0
    assert 100.0 <= read["frame_p95_ms.host"] <= 200.0
    assert read["setup_s"] == 12.5
    assert read["frontend_ms"] == pytest.approx(30.0)
    assert read["track_ms"] is None and read["mapping_event_ms"] is None
    assert read["radius_match_roofline_pct"] == pytest.approx(0.4)
    assert read["device_events_per_frame"] == 4626
    assert read["device_idle_pct"] == pytest.approx(90.0)
    # a reader finds nothing to read: no number, never 0
    empty = {"frames": 0, "window_s": 0.0, "frame_s": [], "setup_s": 1.0, "spans": {},
             "stretch": None}
    assert harness.reader("radius_match_roofline_pct").read(empty) is None
    assert harness.reader("device_idle_pct").read(empty) is None
    assert not math.isnan(read["frames_per_s"])
