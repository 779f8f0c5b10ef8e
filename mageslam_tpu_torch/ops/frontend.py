"""ORB front end: pyramid → FAST → ANMS → rBRIEF → undistort, fixed shapes
(port of mageslam_tpu/ops/frontend.py)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import camera as cam_mod
from . import anms as anms_mod
from . import fast as fast_mod
from . import image as image_mod
from . import orb as orb_mod
from .indexing import topk_stable

# per-level candidate pool before ANMS
CANDIDATES_PER_LEVEL = 2048


class FrameFeatures(NamedTuple):
    """Fixed-shape analyzed frame (the reference's AnalyzedImage)."""

    xy: torch.Tensor        # (N, 2) f32 level-0 distorted pixel coords
    und_xy: torch.Tensor    # (N, 2) f32 undistorted pixel coords (matching space)
    response: torch.Tensor  # (N,) f32
    octave: torch.Tensor    # (N,) int32
    angle: torch.Tensor     # (N,) f32 radians (0 when UseOrientation=false)
    desc: torch.Tensor      # (N, 8) int32 bits of the 256-bit rBRIEF
    valid: torch.Tensor     # (N,) bool

    @property
    def count(self) -> torch.Tensor:
        return torch.sum(self.valid.to(torch.int32))


def _level_features(img: torch.Tensor, n_level: int, scale: float, level: int, fes):
    """Detect and describe on one pyramid level; exactly n_level slots."""
    if fes.UseOrientation:
        raise NotImplementedError(
            "UseOrientation=True (steered BRIEF, mageslam_tpu/ops/orb.py:82 "
            "oriented_descriptors) is not ported yet")
    score = fast_mod.fast_score_map(img, fes.FastThreshold)
    score = fast_mod.nms3x3(score)
    xy, resp, valid = fast_mod.extract_candidates(score, CANDIDATES_PER_LEVEL,
                                                  fes.ImageBorder)
    if fes.SpatialFeatureSelection:
        valid = anms_mod.spatial_select(
            xy, resp, valid, n_level, img.shape[1], img.shape[0],
            fes.SpatialSelectionGridX, fes.SpatialSelectionGridY)
    else:
        max_num = int(n_level * fes.FeatureFactor)
        valid = anms_mod.retain_best_features(
            resp, valid, n_level, max_num, fes.FastThreshold, fes.FeatureStrength)
        valid = anms_mod.adaptive_nms(
            xy, resp, valid, n_level, fes.FastThreshold, fes.StrongResponse,
            fes.MinRobustnessFactor, fes.MaxRobustnessFactor)

    # compact survivors into exactly n_level slots, strongest first
    key = torch.where(valid, resp + 1.0, float("-inf"))
    _, idx = topk_stable(key, n_level)
    xy, resp, valid = xy[idx], resp[idx], valid[idx]

    blurred = image_mod.gaussian_blur(img, fes.GaussianKernelSize, 2.0)
    angle = torch.zeros((n_level,), dtype=torch.float32, device=img.device)
    planes = orb_mod.descriptor_bit_planes(blurred, fes.PatchSize)
    desc = orb_mod.gather_descriptors(planes, xy)
    octave = torch.full((n_level,), level, dtype=torch.int32, device=img.device)
    return xy * scale, resp, octave, angle, desc, valid


def detect_and_compute(image: torch.Tensor, cam: torch.Tensor, fes,
                       max_features: int = 512) -> FrameFeatures:
    """Front end for one grayscale frame (H, W), uint8 or float32 [0, 255].
    Outputs are padded to `max_features` slots; invalid slots have
    valid=False and xy parked at -1e6 so spatial matchers never hit them."""
    image = image.to(torch.float32)
    levels = image_mod.build_pyramid(image, fes.NumLevels, fes.ScaleFactor)
    n_per_level = image_mod.features_per_level(fes.NumFeatures, fes.NumLevels,
                                               fes.ScaleFactor)
    parts = [_level_features(img, n_per_level[lv], fes.ScaleFactor**lv, lv, fes)
             for lv, img in enumerate(levels)]
    xy, resp, octave, angle, desc, valid = (torch.cat([p[i] for p in parts])
                                            for i in range(6))

    n = xy.shape[0]
    if n > max_features:
        raise ValueError(f"NumFeatures {n} exceeds max_features budget {max_features}")
    pad = max_features - n
    if pad:
        def padded(t):
            return torch.cat([t, t.new_zeros((pad,) + t.shape[1:])])
        xy, resp, octave, angle, desc, valid = map(
            padded, (xy, resp, octave, angle, desc, valid))

    und = cam_mod.undistort_pixels(cam, xy)
    far = torch.full((), -1e6, dtype=torch.float32, device=image.device)
    xy = torch.where(valid[:, None], xy, far)
    und = torch.where(valid[:, None], und, far)
    return FrameFeatures(xy, und, torch.where(valid, resp, 0.0), octave, angle,
                         desc, valid)
