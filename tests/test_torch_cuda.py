"""The port on an NVIDIA GPU: the CUDA kernels (standalone Hamming, fused
radius match) against their plain versions, and the tracking slice against
the stored JAX outputs.

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

from mageslam_tpu_torch import SlamSession, bench_world, golden_path_settings
from mageslam_tpu_torch.ops import hamming, matching

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_bench640_f30.npz")
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

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


@pytest.mark.parametrize("n_query,n_target", chip_smoke.RADIUS_SHAPES)
@pytest.mark.parametrize("n_stages", chip_smoke.RADIUS_STAGES)
def test_radius_match_kernel_matches_plain(cuda_device, n_stages, n_query, n_target):
    rng = np.random.RandomState(n_stages * 7919 + n_query * 31 + n_target)
    case = chip_smoke.radius_case(rng, n_stages, n_query, n_target)
    args = [torch.from_numpy(np.ascontiguousarray(case[k])).to(cuda_device)
            for k in chip_smoke.TENSOR_ARGS]
    for octave_tol in (0, 1):
        before = matching.LAUNCHES
        got = matching.radius_match_stages(*args, 6, 1, octave_tol)
        torch.cuda.synchronize()
        assert matching.LAUNCHES == before + 1
        want = matching.radius_match_stages_plain(*args, 6, 1, octave_tol)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_radius_match_wrapper_rejects_what_the_kernel_cannot_take(cuda_device):
    rng = np.random.RandomState(2)
    case = chip_smoke.radius_case(rng, 3, 64, 64)
    args = [torch.from_numpy(np.ascontiguousarray(case[k])).to(cuda_device)
            for k in chip_smoke.TENSOR_ARGS]

    def call(i, value):
        return matching.radius_match_stages(*args[:i], value, *args[i + 1:], 45, 1)

    with pytest.raises(ValueError):                       # a CPU tensor among CUDA ones
        call(5, args[5].cpu())
    with pytest.raises(TypeError):                        # dtype
        call(2, args[2].to(torch.int64))
    with pytest.raises(ValueError):                       # not contiguous
        call(4, torch.cat([args[4], args[4]], 1)[:, ::2])
    with pytest.raises(ValueError):                       # not 16-byte aligned
        call(4, torch.cat([args[4].reshape(-1), args[4].reshape(-1)[:1]])[1:].reshape(64, 8))
    with pytest.raises(ValueError):                       # not 8-byte aligned
        call(5, torch.cat([args[5].reshape(-1), args[5].reshape(-1)[:1]])[1:].reshape(64, 2))
    with pytest.raises(ValueError):                       # S = 5 > 4 stages
        matching.radius_match_stages(*args[:1], args[1][[0, 1, 2, 0, 1]].contiguous(),
                                     *args[2:8], args[8][[0, 1, 2, 0, 1]].contiguous(), 45, 1)


def test_slice_on_the_card_matches_stored_jax_outputs(cuda_device):
    with np.load(FIXTURE) as z:
        ref = {k: z[k] for k in z.files if k.startswith("ref_")}
    sess = SlamSession.from_jax_snapshot(FIXTURE, golden_path_settings(),
                                         (520.0, 520.0, 320.0, 240.0), 640, 480,
                                         cuda_device)
    ids = ref["ref_frame_id"][:6].tolist()
    frames = bench_world.frames(ids[0], ids[-1] + 1)
    fused, ham = matching.LAUNCHES, hamming.LAUNCHES
    for j, i in enumerate(ids):
        r = sess.process_frame(frames[j], i * 0.033, i)
        assert r.state.value == ref["ref_state"][j] and not r.is_keyframe
        assert abs(r.tracked_count - int(ref["ref_tracked"][j])) <= 3
        np.testing.assert_allclose(r.pose.R.cpu().numpy(), ref["ref_R"][j], atol=1e-3)
        np.testing.assert_allclose(r.pose.t.cpu().numpy(), ref["ref_t"][j], atol=1e-3)
    # one fused launch for the cascade and one for track-local-map a frame
    assert matching.LAUNCHES - fused == 12
    assert hamming.LAUNCHES - ham == 0
