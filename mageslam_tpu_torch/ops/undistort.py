"""Dense image undistortion and the stereo rescale (port of
mageslam_tpu/ops/undistort.py; the reference's Image/ImagePreprocessor).

- `undistorted_calibration`: the distorted fx/fy with the principal point
  moved to the image center (ImagePreprocessor.cpp:77-105).
- `undistort_image`: cv::initUndistortRectifyMap + cv::remap as one
  (H, W, 2) source-coordinate map and a bilinear gather. The map is cached
  per calibration, image size and device, as the reference caches its
  undistortion maps.
- `overlap_crop_source_in_target` / `scale_for_camera_configuration` /
  `rescale_image`: ScaleImageForCameraConfiguration (:18-66), the stereo
  rescale that brings the secondary camera to the primary's angular
  resolution (ImageAnalyzer.cpp:131-240).

Plain tensor code in the reference's order of operations, so bilinear
weights round alike. Cameras are geometry/camera.py's (16,) vectors.
"""

from __future__ import annotations

import torch

from ..geometry import camera as cam_mod
from ..geometry.se3 import Pose

_MAPS: dict = {}   # (calibration bytes, H, W, device) -> rectify map


def undistorted_calibration(cam16: torch.Tensor) -> torch.Tensor:
    """Pinhole calibration of the undistorted image: distorted fx/fy, the
    principal point at the image center (ImagePreprocessor.cpp:88-92)."""
    w, h = cam16[12], cam16[13]
    out = torch.zeros_like(cam16)
    out[0], out[1] = cam16[0], cam16[1]
    out[2], out[3] = w * 0.5, h * 0.5
    out[12], out[13], out[14] = w, h, cam_mod.MODEL_PINHOLE
    return out


def _pixel_grid(height: int, width: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    v, u = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=device),
                          torch.arange(width, dtype=torch.float32, device=device),
                          indexing="ij")
    return u, v


def undistort_rectify_map(cam16: torch.Tensor, und_cam16: torch.Tensor,
                          height: int, width: int) -> torch.Tensor:
    """(H, W, 2) distorted-source pixel of each undistorted output pixel
    (cv::initUndistortRectifyMap): output pixel → normalized under the
    undistorted calibration → distort → distorted-camera pixel."""
    u, v = _pixel_grid(height, width, cam16.device)
    xn = cam_mod.pixel_to_normalized(und_cam16, torch.stack([u, v], dim=-1))
    xd = cam_mod.distort_normalized(cam16, xn)
    su = cam16[0] * xd[..., 0] + cam16[2]
    sv = cam16[1] * xd[..., 1] + cam16[3]
    return torch.stack([su, sv], dim=-1)


def remap_bilinear(image: torch.Tensor, map_xy: torch.Tensor) -> torch.Tensor:
    """cv::remap with INTER_LINEAR: sample `image` (H, W) at map_xy
    (H', W', 2); samples outside clamp to the border."""
    H, W = image.shape
    x = torch.clamp(map_xy[..., 0], 0.0, W - 1.0)
    y = torch.clamp(map_xy[..., 1], 0.0, H - 1.0)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, W - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, H - 2)
    wx = x - x0.to(torch.float32)
    wy = y - y0.to(torch.float32)
    i00 = image[y0, x0]
    i01 = image[y0, x0 + 1]
    i10 = image[y0 + 1, x0]
    i11 = image[y0 + 1, x0 + 1]
    return (1 - wy) * ((1 - wx) * i00 + wx * i01) + wy * ((1 - wx) * i10 + wx * i11)


def rectify_map(cam16: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """`undistort_rectify_map` of `cam16` to its undistorted calibration,
    computed once per calibration, size and device."""
    key = (cam16.detach().cpu().numpy().tobytes(), height, width, str(cam16.device))
    m = _MAPS.get(key)
    if m is None:
        m = _MAPS[key] = undistort_rectify_map(cam16, undistorted_calibration(cam16),
                                               height, width)
    return m


def undistort_image(image: torch.Tensor, cam16: torch.Tensor):
    """Warp a distorted image (H, W) float32 to its undistorted pinhole
    space. Returns (undistorted image, undistorted calibration)."""
    H, W = image.shape
    return remap_bilinear(image, rectify_map(cam16, H, W)), undistorted_calibration(cam16)


def overlap_crop_source_in_target(src_cam16: torch.Tensor, tgt_cam16: torch.Tensor,
                                  target_to_source: Pose, max_depth: float) -> torch.Tensor:
    """Bounding box (x0, y0, w, h) of the source frame seen in the target
    image (CalculateOverlapCropSourceInTarget): the source image corners
    unprojected at `max_depth`, moved into the target camera and projected
    with the target calibration."""
    dev = src_cam16.device
    sw, sh = src_cam16[12], src_cam16[13]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    corners = torch.stack([torch.stack([zero, zero]), torch.stack([sw, zero]),
                           torch.stack([zero, sh]), torch.stack([sw, sh])])
    xn = cam_mod.undistort_normalized(
        src_cam16, cam_mod.pixel_to_normalized(src_cam16, corners))
    rays = torch.cat([xn, torch.ones((4, 1), dtype=torch.float32, device=dev)],
                     dim=-1) * max_depth
    pts_t = target_to_source.inverse().transform(rays)
    uv, z = cam_mod.project_camera_points(tgt_cam16, pts_t)
    # corners behind the target camera cannot contribute to the crop
    front = z > 0
    big = torch.tensor(1e9, dtype=torch.float32, device=dev)
    x0 = torch.min(torch.where(front, uv[:, 0], big))
    y0 = torch.min(torch.where(front, uv[:, 1], big))
    x1 = torch.max(torch.where(front, uv[:, 0], -big))
    y1 = torch.max(torch.where(front, uv[:, 1], -big))
    w = torch.where(torch.any(front), x1 - x0, zero)
    h = torch.where(torch.any(front), y1 - y0, zero)
    return torch.stack([x0, y0, w, h])


def scale_for_camera_configuration(src_cam16: torch.Tensor, tgt_cam16: torch.Tensor,
                                   target_to_source: Pose, max_depth: float):
    """(scale, overlap_ok): the resize factor that brings the source image to
    the target's angular resolution (the larger crop/source ratio), and
    whether the frusta overlap inside the target frame at all."""
    crop = overlap_crop_source_in_target(src_cam16, tgt_cam16, target_to_source,
                                         max_depth)
    sw, sh = src_cam16[12], src_cam16[13]
    tw, th = tgt_cam16[12], tgt_cam16[13]
    scale = torch.maximum(crop[2] / sw, crop[3] / sh)
    ok = ((crop[0] + crop[2] > 0) & (crop[0] < tw)
          & (crop[1] + crop[3] > 0) & (crop[1] < th) & (scale > 0))
    return scale, ok


def rescale_map(scale: float, out_height: int, out_width: int, device) -> torch.Tensor:
    """`rescale_image`'s (H, W, 2) source coordinates."""
    u, v = _pixel_grid(out_height, out_width, device)
    inv = 1.0 / torch.clamp_min(torch.tensor(scale, dtype=torch.float32, device=device),
                                1e-6)
    return torch.stack([u * inv, v * inv], dim=-1)


def rescale_image(image: torch.Tensor, scale: float, out_height: int,
                  out_width: int) -> torch.Tensor:
    """Bilinear resize by `scale` into a fixed (out_height, out_width) frame:
    the scaled image fills the top-left crop and the border replicates
    (scaled intrinsics = intrinsics × scale, GetScaledIntrinsics)."""
    return remap_bilinear(image, rescale_map(scale, out_height, out_width, image.device))
