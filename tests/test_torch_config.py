"""The port stands alone: its own settings and synthetic scene, equal to the
JAX package's and bench.py's, no import of either, and entry points that
run on the card unless the caller asks for the CPU."""

import torch_threads  # noqa: F401  (first: torch's OpenMP threads wait passively)

import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from mageslam_tpu import config as jax_config
from mageslam_tpu_torch import MageSlamSettings, SlamSession, bench_world, golden_path_settings
from mageslam_tpu_torch import config as port_config
from mageslam_tpu_torch import interop

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_bench640_f30.npz")
MAP_FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_bench640_map.npz")
sys.path.insert(0, REPO)

import bench  # noqa: E402


@pytest.mark.parametrize("make", ["MageSlamSettings", "golden_path_settings"])
def test_settings_equal_the_jax_package(make):
    port = getattr(port_config, make)()
    assert type(port).__module__ == "mageslam_tpu_torch.config"
    assert MageSlamSettings is port_config.MageSlamSettings
    assert dataclasses.asdict(port) == dataclasses.asdict(getattr(jax_config, make)())


def test_bench_world_equals_bench_py():
    pts, patches = bench_world.build_world(np.random.RandomState(7))
    ref_pts, ref_patches = bench.build_world(np.random.RandomState(7))
    np.testing.assert_array_equal(pts, ref_pts)
    np.testing.assert_array_equal(patches, ref_patches)
    port_frames = bench_world.frames(31, 55)
    for i in (31, 42, 54):
        img = bench_world.render(pts, patches, i * 0.033)
        ref = bench.render(ref_pts, ref_patches, i * 0.033)
        assert img.dtype == ref.dtype == np.float32 and img.shape == (480, 640)
        np.testing.assert_array_equal(img, ref)
        np.testing.assert_array_equal(port_frames[i - 31],
                                      np.clip(ref, 0, 255).astype(np.uint8))


def test_port_stands_alone(tmp_path):
    """A copy of the package, imported where neither the repo nor the JAX
    package is on the path, tracks a frame and maps a keyframe on the CPU,
    imports every one of its modules (the fuser, the analysis and the apps
    among them) and loads no module of jax or mageslam_tpu."""
    shutil.copytree(os.path.join(REPO, "mageslam_tpu_torch"),
                    tmp_path / "mageslam_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    code = (
        "import sys\n"
        f"assert not any(p and {REPO!r} in p for p in sys.path), sys.path\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "import mageslam_tpu_torch as m\n"
        "from mageslam_tpu_torch import bench_world\n"
        "assert m.__file__.startswith(sys.argv[1]), m.__file__\n"
        "img = bench_world.frames(31, 32)[0]\n"
        f"s = m.SlamSession.from_jax_snapshot({FIXTURE!r}, m.golden_path_settings(),\n"
        "    (520., 520., 320., 240.), 640, 480, device='cpu')\n"
        "state = s.process_frame(img, 31 * 0.033, 31).state.name\n"
        "import numpy as np\n"
        "from mageslam_tpu_torch import interop\n"
        "from mageslam_tpu_torch.runtime.mapping_step import mapping\n"
        "from mageslam_tpu_torch.runtime.pose_history import PoseHistory\n"
        "from mageslam_tpu_torch.tracking.frame_state import TrackedFrame\n"
        "from mageslam_tpu_torch.worldmap.map_state import MapState\n"
        f"z = dict(np.load({MAP_FIXTURE!r}))\n"
        "pre = [interop.unflatten(c, p, z, 'cpu') for c, p in ((MapState, 'ev0_pre_map'),\n"
        "       (PoseHistory, 'ev0_pre_ph'), (TrackedFrame, 'ev0_frame'))]\n"
        "new_map, _, ki, live = mapping(m.golden_path_settings(), 640, 480, *pre,\n"
        "                               float(z['ev0_map_scale']))\n"
        "assert ki == 3 and int(new_map.kf_valid.sum()) == 4, ki\n"
        "assert int(new_map.mp_valid.sum()) > int(pre[0].mp_valid.sum())\n"
        "import importlib, pkgutil\n"
        "for mod in pkgutil.walk_packages(m.__path__, 'mageslam_tpu_torch.'):\n"
        "    importlib.import_module(mod.name)\n"
        "assert 'mageslam_tpu_torch.fuser.fuser' in sys.modules\n"
        "assert 'mageslam_tpu_torch.parallel.sharded_ba' in sys.modules\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(\n"
        "    ('jax.', 'jaxlib', 'mageslam_tpu.')) or k == 'mageslam_tpu')\n"
        "print(state, bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "TRACKING []"


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a device argument the entry points ask for the card; where
    torch sees none they raise instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cam = (520.0, 520.0, 320.0, 240.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SlamSession(golden_path_settings(), cam, 640, 480)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SlamSession.from_jax_snapshot(FIXTURE, golden_path_settings(), cam, 640, 480)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.load_jax_snapshot(FIXTURE)
    assert SlamSession(golden_path_settings(), cam, 640, 480, device="cpu").device.type == "cpu"
    # the visual-inertial path's entry points too
    from mageslam_tpu_torch.apps.vi_eval import run_vi_eval, vi_settings
    from mageslam_tpu_torch.fuser import Fuser, ekf_init

    for make in (Fuser, ekf_init, lambda: SlamSession(vi_settings(), cam, 640, 480),
                 lambda: run_vi_eval(1, frames=np.zeros((1, 180, 320), np.uint8))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert Fuser(device="cpu").state.P.device.type == "cpu"
    # the console and the stream-path orbit too
    from mageslam_tpu_torch.apps import console
    from mageslam_tpu_torch.apps.loop_eval import run_orbit_eval

    for make in (lambda: console.main(["missing.mgts"]), lambda: run_orbit_eval(1, frames=[])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
