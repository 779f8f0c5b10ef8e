"""run.py: the last line's shape, and a run with no card fails."""

import json
import os
import subprocess
import sys

import pytest

from slambench import harness, run

ROOT = harness.ROOT


def test_no_card_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "slambench/run.py", "--workload", "mono320.explore",
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_unknown_workload_fails():
    with pytest.raises(KeyError):
        harness.workload(harness.benchmark(), "mono320.nope")


def fake_run(*args, **kwargs):
    return {"result": {"correct": True, "attempted": 3, "failed": 0,
                       "metrics": {"frames_per_s": {"value": 10.5, "unit": "frames/s"}},
                       "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                                  "count": 1, "memory_peak_bytes": 123}},
            "check": {"pose_gap_px": {"value": 0.001, "limit": 0.01}},
            "extra": {"warmup_frames": 31}}


def test_last_line_shape(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", fake_run)
    assert run.main(["--workload", "mono320.explore", "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) == 0
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert list(last) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert last["device"]["platform"] == "gpu"
    assert err.strip().splitlines()[-1] == "check pose_gap_px 0.001 limit 0.01"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "mageslam_tpu_torch", sys.modules.get(
        "mageslam_tpu_torch", object()))
    monkeypatch.setitem(sys.modules, "mageslam_tpu_torch.ops", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in run.forbidden_modules()


def test_a_loaded_jax_refuses_the_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", fake_run)
    monkeypatch.setitem(sys.modules, "mageslam_tpu", object())
    assert run.main(["--workload", "mono320.explore", "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) != 0
    out, err = capsys.readouterr()
    assert out.strip() == "" and "mageslam_tpu" in err
