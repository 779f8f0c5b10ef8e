"""A whole run of the explore cell on the CPU (the harness's look for a card
skipped), sound and with the timed path broken underneath as the window
opens: each fault a SLAM cell can have must bring `correct` out false. The
sound run also puts the control, the reference in TF32, in the program's
place on the same captured calls: it fails every compared number that has
a product to round (the matchers have none: there the control is the
reference itself, and a planted fault is what they must catch)."""

import time

import pytest
import torch

from mageslam_tpu_torch.geometry.se3 import Pose
from slambench import check, harness

CELL = "mono320.explore"
SEED = 2**31 + 77


class Fault:
    """A break in the program, live once `arm()` is called."""

    def __init__(self):
        self.armed = False

    def arm(self):
        self.armed = True


def install(kind: str, fault: Fault, monkeypatch):
    m = harness.port_modules()
    if kind in ("pose_state_unchanged", "pose_altered"):
        orig = m["track_local_map"].optimize_pose

        def optimize_pose(pose, *args, **kwargs):
            out = orig(pose, *args, **kwargs)
            if not fault.armed:
                return out
            if kind == "pose_state_unchanged":     # the step returns its state
                return (pose,) + tuple(out[1:])
            p = out[0]                              # the answer altered
            return (Pose(p.R, p.t + torch.tensor([0.01, 0.0, 0.0])),) + tuple(out[1:])
        monkeypatch.setattr(m["track_local_map"], "optimize_pose", optimize_pose)
    elif kind == "frontend_half":                   # half of the keypoints left out
        for key in ("session", "streaming"):
            orig = getattr(m[key], "detect_and_compute")

            def detect(*args, _orig=orig, **kwargs):
                f = _orig(*args, **kwargs)
                if not fault.armed:
                    return f
                valid = f.valid.clone()
                valid[1::2] = False
                return f._replace(valid=valid)
            monkeypatch.setattr(m[key], "detect_and_compute", detect)
    elif kind == "radius_altered":                  # the track step's guided match
        orig = m["pose_estimation"].radius_match_stages

        def radius_match_stages(*args, **kwargs):
            idx, dist = orig(*args, **kwargs)
            if not fault.armed:
                return idx, dist
            idx = idx.clone()
            hit = torch.nonzero(idx[-1] >= 0)
            if len(hit):
                idx[-1, int(hit[0])] += 1
            return idx, dist
        monkeypatch.setattr(m["pose_estimation"], "radius_match_stages", radius_match_stages)
    elif kind == "two_way_altered":                 # a mapping event's new points
        orig = m["new_points"].match_two_way

        def match_two_way(*args, **kwargs):
            idx, dist = orig(*args, **kwargs)
            if not fault.armed:
                return idx, dist
            idx = idx.clone()
            hit = torch.nonzero(idx.reshape(-1) >= 0)
            if len(hit):
                idx.view(-1)[int(hit[0])] = -1
            return idx, dist
        monkeypatch.setattr(m["new_points"], "match_two_way", match_two_way)
    elif kind == "ba_state_unchanged":              # local BA returns its state
        orig = m["mapping_step"].step_bundle_adjust

        def step_bundle_adjust(problem, state, *args, **kwargs):
            out = orig(problem, state, *args, **kwargs)
            return (state,) + tuple(out[1:]) if fault.armed else out
        monkeypatch.setattr(m["mapping_step"], "step_bundle_adjust", step_bundle_adjust)


def run(seconds, **kwargs):
    return harness.run_cell(harness.benchmark(), CELL, SEED, seconds, False,
                            time.perf_counter(), device="cpu", **kwargs)


def test_sound_run_is_correct_and_the_control_fails():
    out = run(15.0, control=True)
    assert out["result"]["correct"], out["check"]
    assert out["extra"]["sampled"]["ba"] >= 1
    assert out["extra"]["matches"]["radius"]["answers"] > 0
    assert out["extra"]["matches"]["two_way"]["calls"] >= 1
    lim = check.limits()
    for name, value in out["control"].items():
        if name == "match_mismatch":            # no product to round
            assert value == 0.0
        else:                                   # match_mismatch.planted: one answer a call moved
            limit = lim[name.split(".")[0]]
            assert value is not None and value > limit, (name, value, limit)


@pytest.mark.parametrize("kind, seconds", [("pose_state_unchanged", 3.0),
                                           ("pose_altered", 3.0),
                                           ("frontend_half", 3.0),
                                           ("radius_altered", 3.0),
                                           ("two_way_altered", 15.0),
                                           ("ba_state_unchanged", 15.0)])
def test_a_broken_timed_path_is_not_correct(kind, seconds, monkeypatch):
    fault = Fault()
    install(kind, fault, monkeypatch)
    out = run(seconds, on_window=fault.arm)
    assert not out["result"]["correct"], out["check"]
