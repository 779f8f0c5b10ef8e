"""The harness finds configurations, traffic mixes and metrics by the names
in BENCHMARK.json, and a new one is added as files and entries alone."""

import json
import os
import shutil
import subprocess
import sys

from slambench import harness

ROOT = harness.ROOT


def test_every_name_in_benchmark_json_resolves():
    b = harness.benchmark()
    for w in b["workloads"]:
        cfg = harness.config(b, w["config"])
        tr = harness.traffic(w["traffic"])
        harness.generator(tr["generator"])
        assert set(cfg) >= {"source", "settings", "camera", "assumed", "reduced"}
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(harness.reader(m["name"]).read)
    for c in b["configs"]:
        assert c["file"].startswith("slambench/configs/")
        assert set(c["reduced"]) == set(harness._json(os.path.join(ROOT, c["file"]))["reduced"])


def test_metrics_for_a_cell_follow_workloads_keys():
    b = harness.benchmark()
    e2e = {m["name"] for m in harness.metrics_for(b, "mono320.explore", False)}
    assert e2e == {"frames_per_s", "setup_s"}
    assert {m["name"] for m in harness.metrics_for(b, "mono320.explore", True)} >= {
        "track_ms", "mapping_event_ms", "frame_p95_ms.host"}
    layer = {m["name"] for m in harness.metrics_for(b, "mono320.dwell", True)}
    assert "mapping_event_ms" not in layer and "track_ms" in layer


def test_config_overrides_apply_to_the_golden_settings():
    from mageslam_tpu_torch.config import golden_path_settings

    s = harness.override(golden_path_settings(), {"MonoSettings": {"MonoCamera": {
        "FeatureExtractorSettings": {"NumLevels": 3}}}})
    fes = s.MonoSettings.MonoCamera.FeatureExtractorSettings
    assert fes.NumLevels == 3 and fes.ScaleFactor == 1.5
    assert harness.override(golden_path_settings(), {}) == golden_path_settings()


NEW_FILES = {
    "configs/mono320_l2.json": {"source": "test", "settings": {"MonoSettings": {"MonoCamera": {
        "FeatureExtractorSettings": {"NumLevels": 2}}}}, "camera": {
        "pinhole": [260.0, 195.0, 160.0, 90.0], "width": 320, "height": 180},
        "assumed": [], "reduced": []},
    "traffic/slow.json": None,          # explore with another speed, filled below
}
NEW_READER = '"""A test metric."""\n\n\ndef read(ctx):\n    return 2.0 * ctx["frames"]\n'


def test_a_new_config_traffic_and_metric_are_files_and_entries_alone(tmp_path):
    """Copy the benchmark, add a configuration, a mix and a metric as new
    files with new entries, and resolve them from the copy: no file that
    was there changes."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "slambench"), root / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: (root / "slambench" / p).read_bytes()
              for p in os.listdir(root / "slambench") if (root / "slambench" / p).is_file()}
    b = harness.benchmark()
    slow = harness.traffic("explore")
    slow["trajectory"]["speed"] = 0.75
    NEW_FILES["traffic/slow.json"] = slow
    for rel, body in NEW_FILES.items():
        (root / "slambench" / rel).write_text(json.dumps(body))
    (root / "slambench" / "metrics" / "twice_frames.py").write_text(NEW_READER)
    b["configs"].append({"name": "mono320_l2", "source": "test",
                         "file": "slambench/configs/mono320_l2.json", "reduced": [],
                         "why": "test"})
    b["workloads"].append({"name": "mono320l2.slow", "config": "mono320_l2",
                           "traffic": "slow", "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "twice_frames", "unit": "frames", "better": "higher",
                           "source": "program_counter", "layer": "session",
                           "moves": "frames_per_s", "workloads": ["mono320l2.slow"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    probe = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(root)!r})\n"
        "from slambench import harness\n"
        "b = harness.benchmark()\n"
        "w = harness.workload(b, 'mono320l2.slow')\n"
        "cfg = harness.config(b, w['config'])\n"
        "tr = harness.traffic(w['traffic'])\n"
        "world = harness.generator(tr['generator']).World(5, tr, cfg)\n"
        "names = [m['name'] for m in harness.metrics_for(b, w['name'], True)]\n"
        "print(json.dumps({'levels': cfg['settings']['MonoSettings']['MonoCamera']"
        "['FeatureExtractorSettings']['NumLevels'], 'speed': tr['trajectory']['speed'],"
        " 'x': float(world.center(100)[0]), 'names': names,"
        " 'read': harness.reader('twice_frames').read({'frames': 4}),"
        " 'file': harness.__file__}))\n")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         check=True, cwd=str(root))
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["levels"] == 2 and got["speed"] == 0.75
    assert abs(got["x"] - 0.75 * 100 * 0.033) < 1e-5
    assert "twice_frames" in got["names"] and got["read"] == 8.0
    assert got["file"].startswith(str(root))
    for p, body in before.items():
        assert (root / "slambench" / p).read_bytes() == body
