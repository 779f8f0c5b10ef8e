"""RetainBestFeatures + Adaptive Non-Maximal Suppression (port of
mageslam_tpu/ops/anms.py). Exact ANMS radii from the dense (K, K) pair
matrix; selections use `topk_stable`, the reference's top_k tie order."""

from __future__ import annotations

import torch

from .indexing import topk_stable

ROBUST_EPS = 0.002  # OpenCVModified.cpp:157


def retain_best_features(response: torch.Tensor, valid: torch.Tensor,
                         min_num: int, max_num: int, min_threshold: int,
                         response_factor: float) -> torch.Tensor:
    """Updated valid mask. `response` is sorted descending with invalid
    entries last, as `fast.extract_candidates` gives it. Responses are
    u8-clamped bins; ties at the cut survive together."""
    r_int = torch.clamp(response, 0.0, 255.0).to(torch.int32)
    r_int = torch.where(valid, r_int, -1)
    n_valid = torch.sum(valid.to(torch.int32))

    # the bin of the min_num-th strongest, never below min_threshold
    idx_min = torch.clamp(torch.clamp_min(n_valid - 1, 0), max=min_num - 1)
    bin_at_min = r_int[idx_min.reshape(1)][0]
    have_min = (n_valid >= min_num) & (bin_at_min >= min_threshold)
    min_num_threshold = torch.where(have_min, bin_at_min, min_threshold)

    thr2 = torch.clamp_min(
        (min_num_threshold.to(torch.float32) * response_factor).to(torch.int32),
        min_threshold)

    # early-break bin: all of the bin holding the max_num-th item survives
    idx_max = torch.clamp(torch.clamp_min(n_valid - 1, 0), max=max_num - 1)
    bin_stop = torch.where(n_valid > max_num, r_int[idx_max.reshape(1)][0], 0)

    cut = torch.maximum(thr2, bin_stop)
    return valid & (r_int >= cut)


def adaptive_nms(xy: torch.Tensor, response: torch.Tensor, valid: torch.Tensor,
                 num_to_keep: int, fast_threshold: int, strong_response: int,
                 min_robustness: float, max_robustness: float) -> torch.Tensor:
    """Exact ANMS radii; returns the valid mask with at most num_to_keep
    survivors (all of them when there are fewer candidates)."""
    k = xy.shape[0]
    n_valid = torch.sum(valid.to(torch.int32))

    zero = torch.zeros((), dtype=torch.float32, device=xy.device)
    x = torch.where(valid, xy[..., 0], zero).to(torch.int32)
    y = torch.where(valid, xy[..., 1], zero).to(torch.int32)
    strength = torch.where(valid, response, zero)

    big = 2**30
    minx = torch.min(torch.where(valid, x, big))
    maxx = torch.max(torch.where(valid, x, -big))
    miny = torch.min(torch.where(valid, y, big))
    maxy = torch.max(torch.where(valid, y, -big))
    min_strength = torch.min(torch.where(valid, strength, float("inf")))

    # adaptive robustness factor (OpenCVModified.cpp:204-215)
    rng = max(0.0, max_robustness - min_robustness)
    denom = float(strong_response - fast_threshold)
    val = torch.clamp(min_strength - fast_threshold, 0.0, denom)
    rf = max_robustness - (val / denom) * rng

    global_max_r2 = ((maxx - minx).to(torch.float32)
                     * (maxy - miny).to(torch.float32)
                     / num_to_keep).to(torch.int32)

    # all-pairs suppression radii: r_i = min d² to any j with strength_j > s_i
    s = strength * rf + ROBUST_EPS
    dx = x[:, None] - x[None, :]
    dy = y[:, None] - y[None, :]
    d2 = dx * dx + dy * dy
    stronger = (strength[None, :] > s[:, None]) & valid[None, :]
    d2 = torch.where(stronger, d2, big)
    r = torch.minimum(torch.min(d2, dim=1).values, global_max_r2)

    # keep the top num_to_keep by (r desc, strength desc, index asc): the
    # composite key is exact in f32 (r small, strength <= 255, integers)
    key = r.to(torch.float32) * 16384.0 + strength
    key = torch.where(valid, key, float("-inf"))
    _, top_idx = topk_stable(key, min(num_to_keep, k))
    keep = torch.zeros((k,), dtype=torch.bool, device=xy.device)
    keep[top_idx] = True
    keep &= valid

    # the reference skips ANMS when numToKeep exceeds the candidate count
    return torch.where(n_valid <= num_to_keep, valid, keep)


def spatial_select(xy: torch.Tensor, response: torch.Tensor, valid: torch.Tensor,
                   num_to_keep: int, image_width: int, image_height: int,
                   grid_w: int = 8, grid_h: int = 6) -> torch.Tensor:
    """Spatially uniform budget selection (the SpatialFeatureSelection
    extension): rank candidates within their grid cell by response, then
    select globally by (rank in cell asc, response desc)."""
    k = xy.shape[0]
    n_valid = torch.sum(valid.to(torch.int32))
    gx = torch.clamp((xy[:, 0] * grid_w / image_width).to(torch.int32), 0, grid_w - 1)
    gy = torch.clamp((xy[:, 1] * grid_h / image_height).to(torch.int32), 0, grid_h - 1)
    cell = torch.where(valid, gx + gy * grid_w, -1)

    resp = torch.where(valid, response, float("-inf"))
    idx = torch.arange(k, device=xy.device)
    better = (resp[None, :] > resp[:, None]) | (
        (resp[None, :] == resp[:, None]) & (idx[None, :] < idx[:, None]))
    same_cell = (cell[None, :] == cell[:, None]) & valid[None, :] & valid[:, None]
    rank_in_cell = torch.sum((same_cell & better).to(torch.int32), dim=1)

    key = -rank_in_cell.to(torch.float32) * 1024.0 + torch.clamp(resp, 0.0, 255.0)
    key = torch.where(valid, key, float("-inf"))
    _, top_idx = topk_stable(key, min(num_to_keep, k))
    keep = torch.zeros((k,), dtype=torch.bool, device=xy.device)
    keep[top_idx] = True
    return torch.where(n_valid <= num_to_keep, valid, keep & valid)
