"""FAST-9/16 corners as dense whole-image tensor ops (port of
mageslam_tpu/ops/fast.py).

Semantics of cornerScore<16> (OpenCVModified.cpp:927-1010):
    d_k = center - circle_k
    dark   = max over 16 windows of (min over 9 contiguous d_k)
    bright = max over 16 windows of (min over 9 contiguous -d_k)
    response = max(dark, bright) - 1;    corner iff response >= threshold

In eager PyTorch each plane operation below is its own launch (several
hundred per 640x480 frame); they are the first candidates for a fused
kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .indexing import topk_stable

# Bresenham circle of radius 3 as (dx, dy), OpenCV's makeOffsets order
CIRCLE16 = (
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
)


def fast_score_map(img: torch.Tensor, threshold: int) -> torch.Tensor:
    """Dense FAST-9/16 response map (H, W) float32; non-corners and the
    3 px border get -1."""
    img = img.to(torch.float32)
    h, w = img.shape
    pad = 3
    p = F.pad(img, (pad, pad, pad, pad))
    d = [img - p[pad + dy:pad + dy + h, pad + dx:pad + dx + w]
         for (dx, dy) in CIRCLE16]
    ext = d + d[:8]                      # circular extension, 24 planes

    def window9_min(planes):
        """Sparse-table min over each contiguous window of 9."""
        m2 = [torch.minimum(planes[i], planes[i + 1]) for i in range(len(planes) - 1)]
        m4 = [torch.minimum(m2[i], m2[i + 2]) for i in range(len(m2) - 2)]
        m8 = [torch.minimum(m4[i], m4[i + 4]) for i in range(len(m4) - 4)]
        return [torch.minimum(m8[k], planes[k + 8]) for k in range(16)]

    dark_w = window9_min(ext)
    bright_w = window9_min([-q for q in ext])
    dark = dark_w[0]
    bright = bright_w[0]
    for k in range(1, 16):
        dark = torch.maximum(dark, dark_w[k])
        bright = torch.maximum(bright, bright_w[k])
    score = torch.maximum(dark, bright) - 1.0

    is_corner = score >= threshold
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    interior = (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)
    return torch.where(is_corner & interior, score, -1.0)


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Strict 3x3 non-max suppression: keep a score only where it is strictly
    greater than all 8 neighbours; elsewhere -inf."""
    h, w = score.shape
    p = F.pad(score, (1, 1, 1, 1), value=float("-inf"))
    keep = torch.ones_like(score, dtype=torch.bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            keep &= score > p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    return torch.where(keep, score, float("-inf"))


def extract_candidates(score: torch.Tensor, k: int, border: float):
    """Top-k corner candidates of an NMS'd score map after the image-border
    cull. Exact selection (the reference's TPU path used approx_max_k), ties
    lower flat index first. Returns (xy (k, 2) f32, response (k,), valid (k,))."""
    h, w = score.shape
    ys = torch.arange(h, device=score.device, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=score.device, dtype=torch.float32)[None, :]
    inb = (xs >= border) & (xs < w - border) & (ys >= border) & (ys < h - border)
    s = torch.where(inb, score, float("-inf"))
    vals, idx = topk_stable(s.reshape(-1), k)
    yy = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
    xx = (idx % w).to(torch.float32)
    valid = vals > 0.0
    xy = torch.stack([xx, yy], dim=-1)
    return xy, torch.where(valid, vals, 0.0), valid
