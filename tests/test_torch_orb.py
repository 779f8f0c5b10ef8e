"""The port's oriented ORB (UseOrientation) against the JAX package: the
intensity-centroid angle map, steered BRIEF, and the whole frontend at 3
pyramid levels on two photoreal frames
(tests/data/torch_port_cameras.npz, `python tools/export_jax_state.py
cameras`).

Tolerances: angles within 1e-6 rad at level 0 (moments of an integer image
are exact sums); descriptors exact given JAX's angles. The frontend: valid
masks, keypoints and descriptors exact. The pyramid equals JAX's bit for
bit; above level 0 its images are no longer integers, the moments are sums
in another order and the angles move by a few ulps (printed), but on these
frames no rotated offset moves across a rounding boundary.
"""

import torch_threads  # noqa: F401  (first: torch's OpenMP threads wait passively)

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mageslam_tpu.ops import image as jimage
from mageslam_tpu.ops import orb as jorb
from mageslam_tpu_torch import golden_path_settings
from mageslam_tpu_torch.geometry.camera import make_pinhole
from mageslam_tpu_torch.ops import image, orb
from mageslam_tpu_torch.ops.frontend import detect_and_compute

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "torch_port_cameras.npz")
PHOTOREAL = os.path.join(REPO, "tests", "data", "torch_port_photoreal.npz")
ANGLE_ATOL = 1e-6
DESC_SHARE = 1.0


@pytest.fixture(scope="module")
def photo():
    with np.load(PHOTOREAL) as z:
        return z["frames"], z["cam"]


def angle_diff(a, b):
    d = np.abs(a - b)
    return np.minimum(d, 2 * np.pi - d)


def test_ic_angle_map_level0(photo):
    """Half patch 7 (PatchSize 15), on a photoreal frame's integers."""
    img = photo[0][0].astype(np.float32)
    got = image.ic_angle_map(torch.from_numpy(img), 7).numpy()
    want = np.asarray(jimage.ic_angle_map(jnp.asarray(img), 7))
    assert angle_diff(got, want).max() <= ANGLE_ATOL


def test_oriented_descriptors_exact_given_jax_angles(rng, photo):
    img = photo[0][10].astype(np.float32)
    blurred = image.gaussian_blur(torch.from_numpy(img), 7, 2.0)
    xy = np.stack([rng.randint(0, 320, 400), rng.randint(0, 180, 400)], 1).astype(np.float32)
    angle = np.asarray(jimage.ic_angle_map(jnp.asarray(img), 7))[xy[:, 1].astype(int),
                                                                   xy[:, 0].astype(int)]
    want = np.asarray(jorb.oriented_descriptors(jnp.asarray(blurred.numpy()), jnp.asarray(xy),
                                                jnp.asarray(angle), 15))
    got = orb.oriented_descriptors(blurred, torch.from_numpy(xy), torch.from_numpy(angle), 15)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.fixture(scope="module")
def ref():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files if k.startswith("orb")}


@pytest.mark.parametrize("j", [0, 1])
def test_oriented_frontend_three_levels(ref, photo, j):
    frames, cam = photo
    fes = dataclasses.replace(golden_path_settings().MonoSettings.MonoCamera
                              .FeatureExtractorSettings, UseOrientation=True, NumLevels=3)
    i = int(ref["orb_frames"][j])
    cam16 = make_pinhole(*cam.tolist(), 320, 180)
    feats = detect_and_compute(torch.from_numpy(frames[i]), cam16, fes, 512)
    valid = ref[f"orb{j}_valid"]
    np.testing.assert_array_equal(feats.valid.numpy(), valid)
    np.testing.assert_array_equal(feats.xy.numpy(), ref[f"orb{j}_xy"])
    np.testing.assert_array_equal(feats.octave.numpy(), ref[f"orb{j}_octave"])
    same = (feats.desc.numpy().view(np.uint32) == ref[f"orb{j}_desc"]).all(axis=1)[valid]
    lv0 = feats.octave.numpy()[valid] == 0
    print(f"frame {i}: {int(valid.sum())} keypoints, descriptors equal on "
          f"{same.mean():.4f} ({int((~same).sum())} differ, {int((~same[lv0]).sum())} of "
          f"them at level 0); angles max diff "
          f"{angle_diff(feats.angle.numpy(), ref[f'orb{j}_angle'])[valid].max():.3g}")
    assert same.mean() >= DESC_SHARE
    assert same[lv0].all()
