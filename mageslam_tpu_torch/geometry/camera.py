"""Camera models (port of mageslam_tpu/geometry/camera.py).

A camera is a flat (16,) float32 parameter vector, batched as (K, 16):

    [fx, fy, cx, cy, k1, k2, k3, k4, k5, k6, p1, p2, width, height, model, pad]

`model` is 0 = pinhole, 1 = poly3k, 2 = rational6k. Distortion is evaluated
branchlessly: unused coefficients are zero and the rational denominator
reduces to 1, so one code path serves all three models.
"""

from __future__ import annotations

import torch

CAM_PARAMS = 16
MODEL_PINHOLE = 0.0
MODEL_POLY3K = 1.0
MODEL_RATIONAL6K = 2.0


def make_pinhole(fx, fy, cx, cy, width, height, device=None) -> torch.Tensor:
    v = torch.zeros((CAM_PARAMS,), dtype=torch.float32, device=device)
    v[0], v[1], v[2], v[3] = fx, fy, cx, cy
    v[12], v[13], v[14] = width, height, MODEL_PINHOLE
    return v


def make_poly3k(fx, fy, cx, cy, k1, k2, k3, p1, p2, width, height,
                device=None) -> torch.Tensor:
    """Reference coefficient order: k1, k2, k3, p1, p2."""
    v = make_pinhole(fx, fy, cx, cy, width, height, device)
    v[4], v[5], v[6], v[10], v[11] = k1, k2, k3, p1, p2
    v[14] = MODEL_POLY3K
    return v


def distort_normalized(cam: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """Radial + tangential distortion of normalized coords (..., 2)."""
    x, y = xn[..., 0], xn[..., 1]
    k1, k2, k3 = cam[..., 4], cam[..., 5], cam[..., 6]
    k4, k5, k6 = cam[..., 7], cam[..., 8], cam[..., 9]
    p1, p2 = cam[..., 10], cam[..., 11]
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2
    num = 1.0 + k1 * r2 + k2 * r4 + k3 * r6
    den = 1.0 + k4 * r2 + k5 * r4 + k6 * r6
    scale = num / den
    xy = x * y
    xd = x * scale + 2.0 * p1 * xy + p2 * (r2 + 2.0 * x * x)
    yd = y * scale + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * xy
    return torch.stack([xd, yd], dim=-1)


def undistort_normalized(cam: torch.Tensor, xd: torch.Tensor,
                         iters: int = 8) -> torch.Tensor:
    """Invert `distort_normalized` by a fixed number of fixed-point
    iterations (cv::undistortPoints semantics)."""
    k1, k2, k3 = cam[..., 4], cam[..., 5], cam[..., 6]
    k4, k5, k6 = cam[..., 7], cam[..., 8], cam[..., 9]
    p1, p2 = cam[..., 10], cam[..., 11]
    x0, y0 = xd[..., 0], xd[..., 1]
    x, y = x0, y0
    for _ in range(iters):
        r2 = x * x + y * y
        r4 = r2 * r2
        r6 = r4 * r2
        num = 1.0 + k1 * r2 + k2 * r4 + k3 * r6
        den = 1.0 + k4 * r2 + k5 * r4 + k6 * r6
        inv_scale = den / num
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (x0 - dx) * inv_scale
        y = (y0 - dy) * inv_scale
    return torch.stack([x, y], dim=-1)


def _safe_inv_z(z: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)


def project_camera_points(cam: torch.Tensor, pts_cam: torch.Tensor):
    """Camera-frame points (..., 3) → distorted pixels (..., 2), and depth.
    Callers mask with depth > 0."""
    z = pts_cam[..., 2]
    xn = pts_cam[..., :2] * _safe_inv_z(z)[..., None]
    xd = distort_normalized(cam, xn)
    u = cam[..., 0] * xd[..., 0] + cam[..., 2]
    v = cam[..., 1] * xd[..., 1] + cam[..., 3]
    return torch.stack([u, v], dim=-1), z


def project_undistorted(cam: torch.Tensor, pts_cam: torch.Tensor):
    """Pinhole-only projection of camera-frame points (the pipeline runs on
    undistorted keypoints)."""
    z = pts_cam[..., 2]
    inv_z = _safe_inv_z(z)
    u = cam[..., 0] * pts_cam[..., 0] * inv_z + cam[..., 2]
    v = cam[..., 1] * pts_cam[..., 1] * inv_z + cam[..., 3]
    return torch.stack([u, v], dim=-1), z


def pixel_to_normalized(cam: torch.Tensor, px: torch.Tensor) -> torch.Tensor:
    x = (px[..., 0] - cam[..., 2]) / cam[..., 0]
    y = (px[..., 1] - cam[..., 3]) / cam[..., 1]
    return torch.stack([x, y], dim=-1)


def undistort_pixels(cam: torch.Tensor, px: torch.Tensor,
                     iters: int = 8) -> torch.Tensor:
    """Distorted pixels → undistorted pixels under the same pinhole
    intrinsics (undistort with P = K)."""
    xn = undistort_normalized(cam, pixel_to_normalized(cam, px), iters=iters)
    u = cam[..., 0] * xn[..., 0] + cam[..., 2]
    v = cam[..., 1] * xn[..., 1] + cam[..., 3]
    return torch.stack([u, v], dim=-1)
