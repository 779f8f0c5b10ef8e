"""Volume of interest: teardrop-kernel confidence volume over keyframe poses
(port of mageslam_tpu/analysis/voi.py).

Replaces VolumeOfInterest/ (294 LoC): each pose contributes a "teardrop"
score field oriented along its viewing direction (VOIKeyframe::TeardropScore,
VolumeOfInterest.cpp:60-79); the interesting volume is the AABB of voxels
whose summed score passes an iteratively-tightened threshold
(CalculateVolumeOfInterest LOD loop, :120-220).

Each LOD evaluates a fixed (G³, KF) score tensor over the current AABB, all
keyframes and voxels at once; the levels run in a host loop (the reference
package scans over them) with no host read: a level that keeps no voxel
leaves the box as it was, on the device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..geometry.se3 import Pose


class VoiSettings(NamedTuple):
    """VolumeOfInterestSettings (MageSettings.h:290-307), defaults preserved."""

    away_prominence: float = 1.2
    toward_prominence: float = 0.1
    side_prominence: float = 1.0
    kernel_angle_x: float = 60.0 * math.pi / 180.0
    kernel_angle_y: float = 40.0 * math.pi / 180.0
    kernel_depth_modifier: float = 1.0
    threshold: float = 0.5
    iterations: int = 3
    grid: int = 24


class VoiKeyframes(NamedTuple):
    """Per-keyframe teardrop kernel parameters (VOIKeyframe ctor)."""

    centroid: torch.Tensor      # (K, 3)
    forward: torch.Tensor       # (K, 3)
    dist_alpha_xi: torch.Tensor   # (K,)
    mod_dist_alpha_omega: torch.Tensor  # (K,)
    valid: torch.Tensor         # (K,)


def make_voi_keyframes(poses: Pose, near_depth: torch.Tensor, far_depth: torch.Tensor,
                       valid: torch.Tensor, settings: VoiSettings) -> VoiKeyframes:
    center = poses.center()
    fwd = poses.forward()
    centroid = center + fwd * (near_depth * settings.kernel_depth_modifier)[:, None]
    angle = torch.full((), min(settings.kernel_angle_x, settings.kernel_angle_y),
                       dtype=torch.float32, device=near_depth.device)
    dist_alpha_xi = near_depth * torch.tan(angle)
    mod = (far_depth - near_depth) * settings.away_prominence
    return VoiKeyframes(centroid, fwd, dist_alpha_xi, mod, valid)


def teardrop_scores(kf: VoiKeyframes, points: torch.Tensor,
                    settings: VoiSettings) -> torch.Tensor:
    """(P,) summed teardrop score of each point over all keyframes
    (TeardropScore, VolumeOfInterest.cpp:60-79, batched over K×P)."""
    d = points[None, :, :] - kf.centroid[:, None, :]          # (K, P, 3)
    dist = torch.linalg.vector_norm(d, dim=-1)
    cos_a = torch.einsum("kpi,ki->kp", d, kf.forward) / torch.clamp_min(dist, 1e-12)
    angle = torch.arccos(torch.clamp(cos_a, -1.0, 1.0))

    parallel_bias = 2.0 * torch.abs(angle - math.pi / 2.0) / math.pi
    omega = kf.mod_dist_alpha_omega[:, None]
    direct_slope = 1.0 / omega + angle * (1.0 / settings.toward_prominence - 1.0) / (
        omega * math.pi)
    angle_factor = parallel_bias * direct_slope + (1.0 - parallel_bias) / (
        kf.dist_alpha_xi[:, None] * settings.side_prominence)
    x = angle_factor * dist
    score = torch.where(dist < 1e-12, 1.0, torch.exp(-2.0 * x * x))
    return torch.sum(torch.where(kf.valid[:, None], score, 0.0), dim=0)


def _unit_lattice(G: int, device) -> torch.Tensor:
    """(G³, 3) lattice of [0, 1]³, 'ij' order, with the reference's
    linspace values (i · (1/(G-1)) in float32, the last exactly 1)."""
    lin = np.append(np.arange(G - 1, dtype=np.float32) * (np.float32(1) / np.float32(G - 1)),
                    np.float32(1))
    gx, gy, gz = np.meshgrid(lin, lin, lin, indexing="ij")
    return torch.from_numpy(np.stack([gx.ravel(), gy.ravel(), gz.ravel()], -1)).to(device)


def calculate_volume_of_interest(
    kf: VoiKeyframes, settings: VoiSettings = VoiSettings()
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (min_corner (3,), max_corner (3,), ok ()) — the AABB of the
    interesting volume after the LOD refinement loop."""
    big = 1e30
    valid = kf.valid[:, None]
    # initial bounds: keyframe centroids padded by their reach
    pad = torch.amax(torch.where(kf.valid, kf.mod_dist_alpha_omega, 0.0)) + 1e-3
    lo = torch.amin(torch.where(valid, kf.centroid, big), dim=0) - pad
    hi = torch.amax(torch.where(valid, kf.centroid, -big), dim=0) + pad
    unit = _unit_lattice(settings.grid, kf.centroid.device)

    any_keep = None
    for lod_idx in range(settings.iterations):
        pts = lo[None, :] + unit * (hi - lo)[None, :]
        scores = teardrop_scores(kf, pts, settings)
        smin, smax = torch.amin(scores), torch.amax(scores)
        # threshold tightens as lod decreases (Threshold / lod, :196)
        frac = float(np.float32(settings.threshold) / np.float32(settings.iterations - lod_idx))
        keep = (scores > (smax - smin) * frac + smin)[:, None]
        any_keep = torch.any(keep)
        lo = torch.where(any_keep, torch.amin(torch.where(keep, pts, big), dim=0), lo)
        hi = torch.where(any_keep, torch.amax(torch.where(keep, pts, -big), dim=0), hi)
    return lo, hi, torch.any(kf.valid) & any_keep
