"""Image ops: Gaussian blur, bilinear resize, pyramid, the intensity-centroid
angle map (port of mageslam_tpu/ops/image.py). Images are float32 [0, 255],
(H, W)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel-compatible 1D kernel."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur with REFLECT_101 border (torch's `reflect`),
    rows then columns, as a shifted-add over the taps in order. Plain float32
    multiply-adds: no convolution library, so no TF32 on the card."""
    if ksize <= 1:
        return img
    k = gaussian_kernel_1d(ksize, sigma).tolist()
    pad = ksize // 2
    h, w = img.shape
    x = F.pad(img[None, None], (pad, pad, pad, pad), mode="reflect")[0, 0]
    rows = k[0] * x[:, 0:w]
    for i in range(1, ksize):
        rows = rows + k[i] * x[:, i:i + w]
    out = k[0] * rows[0:h]
    for i in range(1, ksize):
        out = out + k[i] * rows[i:i + h]
    return out


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Half-pixel-center bilinear resize without antialiasing."""
    return F.interpolate(img[None, None], size=(out_h, out_w), mode="bilinear",
                         align_corners=False, antialias=False)[0, 0]


def pyramid_shapes(h: int, w: int, num_levels: int,
                   scale_factor: float) -> list[tuple[int, int]]:
    """Level i is round(dim / scale^i)."""
    return [(int(round(h / scale_factor**lv)), int(round(w / scale_factor**lv)))
            for lv in range(num_levels)]


def build_pyramid(img: torch.Tensor, num_levels: int,
                  scale_factor: float) -> list[torch.Tensor]:
    """Per-level images; level i+1 is resized from level i."""
    h, w = img.shape
    levels = [img]
    for lh, lw in pyramid_shapes(h, w, num_levels, scale_factor)[1:]:
        levels.append(resize_bilinear(levels[-1], lh, lw))
    return levels


def features_per_level(n_features: int, num_levels: int,
                       scale_factor: float) -> list[int]:
    """Geometric per-level feature budget (OpenCVModified.cpp:660-670)."""
    if num_levels == 1:
        return [n_features]
    factor = 1.0 / scale_factor
    n_desired = n_features * (1 - factor) / (1 - factor**num_levels)
    out = []
    total = 0
    for _ in range(num_levels - 1):
        n = int(round(n_desired))
        out.append(n)
        total += n
        n_desired *= factor
    out.append(max(n_features - total, 0))
    return out


def ic_angle_map(img: torch.Tensor, half_patch: int) -> torch.Tensor:
    """Dense intensity-centroid angle map (radians): atan2(m01, m10) over
    the circular patch of radius half_patch at every pixel (ICAngles,
    OpenCVModified.cpp:399), zero outside the image. The moments are
    correlations in float64, rounded to float32 once: on an integer image
    they are exact, as the reference's float32 sums of integers are."""
    r = half_patch
    ys, xs = np.mgrid[-r:r + 1, -r:r + 1]
    mask = (xs * xs + ys * ys) <= (r * r + 1)     # the standard ORB circle
    # correlation with the flipped kernels, as the reference computes them
    # (the kernels are antisymmetric: the moments come out negated)
    flipped = np.stack([xs * mask, ys * mask])[:, ::-1, ::-1]
    weights = torch.from_numpy(np.ascontiguousarray(flipped, dtype=np.float64))
    m = F.conv2d(img.to(torch.float64)[None, None],
                 weights.to(img.device)[:, None], padding=r)[0].to(torch.float32)
    return torch.atan2(m[1], m[0])
