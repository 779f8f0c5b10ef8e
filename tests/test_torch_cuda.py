"""The port on an NVIDIA GPU: the CUDA Hamming kernel against its plain
version, and the tracking slice against the stored JAX outputs.

Every test here is marked `cuda` and skips where torch.cuda.is_available()
is false. This file imports no JAX, so on a machine with a GPU and no JAX
it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import os
import sys

import numpy as np
import pytest
import torch

from mageslam_tpu_torch import SlamSession, golden_path_settings
from mageslam_tpu_torch.ops import hamming

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_bench640_f30.npz")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def words(rng, rows, device):
    w = rng.randint(0, 2**32, size=(rows, 8), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(w.view(np.int32).copy()).to(device)


@pytest.mark.parametrize("n,m", [(1, 1), (129, 257), (1000, 440), (2048, 512)])
def test_kernel_matches_plain(cuda_device, n, m):
    rng = np.random.RandomState(n * 7919 + m)
    a, b = words(rng, n, cuda_device), words(rng, m, cuda_device)
    before = hamming.LAUNCHES
    got = hamming.hamming_matrix(a, b)
    torch.cuda.synchronize()
    assert hamming.LAUNCHES == before + 1
    torch.testing.assert_close(got, hamming.hamming_matrix_plain(a, b), rtol=0, atol=0)


def test_wrapper_rejects_what_the_kernel_cannot_take(cuda_device):
    rng = np.random.RandomState(1)
    a = words(rng, 64, cuda_device)
    with pytest.raises(ValueError):
        hamming.hamming_matrix(a, a.cpu())
    with pytest.raises(TypeError):
        hamming.hamming_matrix(a, a.to(torch.int64))
    with pytest.raises(ValueError):
        hamming.hamming_matrix(a, words(rng, 64, cuda_device)[::2])


def test_slice_on_the_card_matches_stored_jax_outputs(cuda_device):
    sys.path.insert(0, REPO)
    import bench

    with np.load(FIXTURE) as z:
        ref = {k: z[k] for k in z.files if k.startswith("ref_")}
    sess = SlamSession.from_jax_snapshot(FIXTURE, golden_path_settings(),
                                         (520.0, 520.0, 320.0, 240.0), 640, 480,
                                         cuda_device)
    pts, patches = bench.build_world(np.random.RandomState(7))
    before = hamming.LAUNCHES
    for j, i in enumerate(ref["ref_frame_id"][:6].tolist()):
        img = np.clip(bench.render(pts, patches, i * 0.033), 0, 255).astype(np.uint8)
        r = sess.process_frame(img, i * 0.033, i)
        assert r.state.value == ref["ref_state"][j] and not r.is_keyframe
        assert abs(r.tracked_count - int(ref["ref_tracked"][j])) <= 3
        np.testing.assert_allclose(r.pose.R.cpu().numpy(), ref["ref_R"][j], atol=1e-3)
        np.testing.assert_allclose(r.pose.t.cpu().numpy(), ref["ref_t"][j], atol=1e-3)
    assert hamming.LAUNCHES - before == 12
