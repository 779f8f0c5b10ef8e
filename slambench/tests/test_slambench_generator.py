"""The benchmark's generator against the program's copy of the original
benchmark scene: bit for bit at seed 7 with the explore parameters and
that scene's 640x480 camera; and the cells' own frames."""

import json
import os

import numpy as np

from mageslam_tpu_torch import bench_world
from slambench import harness

HERE = os.path.dirname(os.path.abspath(__file__))


# the original scene's camera (bench_world.py), which the cells resize
BENCH_WORLD_CAMERA = {"camera": {"pinhole": [520.0, 520.0, 320.0, 240.0], "width": 640,
                                 "height": 480}}


def world(seed, traffic="explore", config="mono320_golden"):
    gen = harness.generator("patch_world")
    cfg = config if isinstance(config, dict) else harness.config(harness.benchmark(), config)
    return gen.World(seed, harness.traffic(traffic), cfg)


def test_explore_frames_equal_bench_world_at_seed_7():
    w = world(7, config=BENCH_WORLD_CAMERA)
    want = bench_world.frames(0, 3) + bench_world.frames(31, 32) + bench_world.frames(200, 201)
    got = [w.frame(i) for i in (0, 1, 2, 31, 200)]
    for g, x in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == (480, 640)
        np.testing.assert_array_equal(g, x)
    pts, patches = bench_world.build_world(np.random.RandomState(7))
    np.testing.assert_array_equal(w.pts, pts)
    np.testing.assert_array_equal(w.patches, patches)


def test_the_cells_frames_are_the_consoles_size():
    w = world(2**31 + 3)
    f = w.frame(40)
    assert f.dtype == np.uint8 and f.shape == (180, 320)
    assert 0.2 < float((f > 0).mean()) < 0.8        # textured, not blank or full


def test_same_seed_same_frames_and_large_seeds():
    a, b = world(2**31 + 57), world(2**31 + 57)
    np.testing.assert_array_equal(a.frames(40, 43), b.frames(40, 43))
    assert not np.array_equal(a.frame(40), world(2**31 + 58).frame(40))


def test_dwell_trajectory_stops_and_sways_periodically():
    w = world(3, "dwell")
    tr = w.traffic["trajectory"]
    stop, period = tr["stop_frame"], tr["dwell"]["period_frames"]
    np.testing.assert_allclose(w.center(stop + 5), w.center(stop + 5 + period), atol=1e-6)
    sway = np.array([w.center(stop + k) for k in range(period)])
    amp = np.array(tr["dwell"]["amplitude"])
    assert np.all(np.abs(sway - w.center(stop)).max(0) <= amp + 1e-5)
    # before the stop the camera travels as in explore
    np.testing.assert_array_equal(w.center(10), world(3).center(10))


def test_every_traffic_file_names_a_generator_that_exists():
    for name in os.listdir(os.path.join(HERE, "..", "traffic")):
        if name.endswith(".json"):
            with open(os.path.join(HERE, "..", "traffic", name)) as f:
                tr = json.load(f)
            assert os.path.exists(os.path.join(HERE, "..", "traffic", tr["generator"] + ".py"))
