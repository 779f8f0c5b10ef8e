"""The port's ORB frontend against the JAX package, on a bench.py frame.

Integer outputs (FAST scores, NMS, candidates, ANMS masks, descriptor bits
from the same blurred image) must match exactly. The blur itself is a float
sum in another order than XLA's convolution, so the full frontend's
descriptors may differ where two blurred samples nearly tie: at least
99.5 % of valid keypoints must carry identical descriptors and none may
differ in more than 2 bits. Undistorted positions: atol 1e-4 px.
"""

import torch_threads  # noqa: F401  (first: torch's OpenMP threads wait passively)

import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mageslam_tpu.config import golden_path_settings
from mageslam_tpu.geometry.camera import make_pinhole as jmake_pinhole
from mageslam_tpu.ops import anms as janms
from mageslam_tpu.ops import fast as jfast
from mageslam_tpu.ops import image as jimage
from mageslam_tpu.ops import orb as jorb
from mageslam_tpu.ops.frontend import detect_and_compute as jdetect
from mageslam_tpu_torch.geometry.camera import make_pinhole
from mageslam_tpu_torch.ops import anms, fast, image, orb
from mageslam_tpu_torch.ops.frontend import CANDIDATES_PER_LEVEL, detect_and_compute

torch.set_num_threads(2)

FES = golden_path_settings().MonoSettings.MonoCamera.FeatureExtractorSettings
SIZES = ["640x480", "160x120"]


@pytest.fixture(scope="module")
def frames():
    sys.path.insert(0, ".")
    import bench

    pts, patches = bench.build_world(np.random.RandomState(7))
    full = np.clip(bench.render(pts, patches, 31 * 0.033), 0, 255).astype(np.uint8)
    return {"640x480": full.astype(np.float32),
            "160x120": full[180:300, 240:400].astype(np.float32)}


def _jax_candidates(img):
    score = jfast.nms3x3(jfast.fast_score_map(jnp.asarray(img), FES.FastThreshold))
    return score, jfast.extract_candidates(score, CANDIDATES_PER_LEVEL, FES.ImageBorder)


@pytest.mark.parametrize("size", SIZES)
def test_fast_nms_exact(frames, size):
    img = frames[size]
    want_score = jfast.fast_score_map(jnp.asarray(img), FES.FastThreshold)
    got_score = fast.fast_score_map(torch.from_numpy(img), FES.FastThreshold)
    np.testing.assert_array_equal(got_score.numpy(), np.asarray(want_score))
    got_nms = fast.nms3x3(got_score).numpy()
    np.testing.assert_array_equal(got_nms, np.asarray(jfast.nms3x3(want_score)))
    assert np.isfinite(got_nms).sum() > 20


@pytest.mark.parametrize("size", SIZES)
def test_extract_candidates_exact_in_slot_order(frames, size):
    score, want = _jax_candidates(frames[size])
    got = fast.extract_candidates(torch.from_numpy(np.array(score)),
                                  CANDIDATES_PER_LEVEL, FES.ImageBorder)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # integer scores tie often: the slot order is the tie rule under test
    resp = np.asarray(want[1])[np.asarray(want[2])]
    assert len(resp) > len(np.unique(resp))


@pytest.mark.parametrize("size", SIZES)
def test_anms_masks_exact(frames, size):
    _, (xy, resp, valid) = _jax_candidates(frames[size])
    n = FES.NumFeatures
    max_num = int(n * FES.FeatureFactor)
    want = janms.retain_best_features(resp, valid, n, max_num, FES.FastThreshold,
                                      FES.FeatureStrength)
    t_xy, t_resp, t_valid = (torch.from_numpy(np.array(a)) for a in (xy, resp, valid))
    got = anms.retain_best_features(t_resp, t_valid, n, max_num, FES.FastThreshold,
                                    FES.FeatureStrength)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    args = (n, FES.FastThreshold, FES.StrongResponse, FES.MinRobustnessFactor,
            FES.MaxRobustnessFactor)
    want2 = janms.adaptive_nms(xy, resp, want, *args)
    got2 = anms.adaptive_nms(t_xy, t_resp, got, *args)
    np.testing.assert_array_equal(got2.numpy(), np.asarray(want2))
    # with a budget below the candidate count ANMS really selects
    small = max(8, int(np.asarray(want).sum()) // 3)
    want3 = janms.adaptive_nms(xy, resp, want, small, *args[1:])
    got3 = anms.adaptive_nms(t_xy, t_resp, got, small, *args[1:])
    np.testing.assert_array_equal(got3.numpy(), np.asarray(want3))
    assert got3.sum() == small


@pytest.mark.parametrize("size", SIZES)
def test_spatial_select_exact(frames, size):
    _, (xy, resp, valid) = _jax_candidates(frames[size])
    h, w = frames[size].shape
    n = max(8, int(np.asarray(valid).sum()) // 4)
    want = janms.spatial_select(xy, resp, valid, n, w, h, 8, 6)
    got = anms.spatial_select(*(torch.from_numpy(np.array(a)) for a in (xy, resp, valid)),
                              n, w, h, 8, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.sum() == n


@pytest.mark.parametrize("size", SIZES)
def test_blur_and_bit_planes(frames, size):
    img = frames[size]
    want_blur = jimage.gaussian_blur(jnp.asarray(img), FES.GaussianKernelSize, 2.0)
    got_blur = image.gaussian_blur(torch.from_numpy(img), FES.GaussianKernelSize, 2.0)
    np.testing.assert_allclose(got_blur.numpy(), np.asarray(want_blur), atol=1e-4)
    # from the same blurred image the bits are exact, sign bit included
    want_planes = np.asarray(jorb.descriptor_bit_planes(want_blur, FES.PatchSize))
    got_planes = orb.descriptor_bit_planes(torch.from_numpy(np.array(want_blur)),
                                           FES.PatchSize).numpy()
    np.testing.assert_array_equal(got_planes.view(np.uint32), want_planes)
    assert (want_planes >= 2**31).any()


@pytest.mark.parametrize("size", SIZES)
def test_detect_and_compute(frames, size):
    img = frames[size]
    h, w = img.shape
    cam = (0.82 * w, 0.82 * w, w / 2.0, h / 2.0)
    want = jdetect(jnp.asarray(img), jmake_pinhole(*cam, w, h), FES, 512)
    got = detect_and_compute(torch.from_numpy(img), make_pinhole(*cam, w, h), FES, 512)
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    for name in ("xy", "response", "octave", "angle"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(got.und_xy.numpy(), np.asarray(want.und_xy), atol=1e-4)
    gd = got.desc.numpy().view(np.uint32)[valid]
    wd = np.asarray(want.desc)[valid]
    bits = np.unpackbits((gd ^ wd).view(np.uint8), axis=-1).sum(-1)
    assert valid.sum() > 20
    assert (bits == 0).mean() >= 0.995, f"{(bits != 0).sum()} of {len(bits)} differ"
    assert bits.max() <= 2


def test_pyramid_levels_close(frames):
    img = frames["160x120"]
    want = jimage.build_pyramid(jnp.asarray(img), 3, 1.5)
    got = image.build_pyramid(torch.from_numpy(img), 3, 1.5)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3)
    assert image.features_per_level(440, 3, 1.5) == jimage.features_per_level(440, 3, 1.5)
