"""Image ops: Gaussian blur, bilinear resize, pyramid, the intensity-centroid
angle map (port of mageslam_tpu/ops/image.py). Images are float32 [0, 255],
(H, W)."""

from __future__ import annotations

import functools

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


@functools.lru_cache(maxsize=None)
def _taps(in_size: int, out_size: int) -> tuple[np.ndarray, ...]:
    """The reference's linear resize weights along one axis, as two taps per
    output sample: (lo, hi) input indices and their float32 weights.

    `jax.image.resize(..., "linear", antialias=False)` builds the (in, out)
    triangle-kernel matrix of `scale_and_translate` (jax/_src/image/scale.py,
    `compute_weight_mat`) and contracts it; each column holds at most two
    nonzeros. The sample position is (j + 0.5) * (in / out) - 0.5 with the
    inverse scale rounded from float64 once. On the CPU the reference's
    fused loop computes it as one fused multiply-add in its 8-wide vector
    body, taken when the row has at least 96 samples, and as a multiply then
    an add in the scalar remainder; the weights here follow the same rule, so
    they equal the reference's bit for bit. The rule, and the fused add on
    the first axis in `_resize_axis0`, were read from XLA:CPU as jaxlib 0.9.0
    compiles the reference for an x86-64 CPU with AVX-512; another build or
    ISA may round otherwise, so the port's tests hold it against pyramids
    recorded from that build (tests/data/torch_port_levels.npz, which names
    it)."""
    inv = np.float32(in_size / out_size)
    j = np.arange(out_size)
    fused = ((j + 0.5) * np.float64(inv) - 0.5).astype(np.float32)
    split = (j.astype(np.float32) + np.float32(0.5)) * inv - np.float32(0.5)
    vector_body = (out_size >= 96) & (j < out_size // 8 * 8)
    sample = np.where(vector_body, fused, split).astype(np.float32)
    dist = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None])
    w = np.maximum(np.float32(0), np.float32(1) - dist)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0).astype(np.float32)
    w = np.where(((sample >= -0.5) & (sample <= in_size - 0.5))[None, :], w, 0)
    assert ((w != 0).sum(0) <= 2).all()
    lo = np.argmax(w != 0, axis=0)
    hi = np.minimum(lo + 1, in_size - 1)
    cols = np.arange(out_size)
    w_lo = w[lo, cols]
    w_hi = np.where(hi != lo, w[hi, cols], 0).astype(np.float32)
    return lo, hi, w_lo, w_hi


@functools.lru_cache(maxsize=None)
def _taps_on(in_size: int, out_size: int, device: torch.device) -> tuple[torch.Tensor, ...]:
    """`_taps` as tensors on `device`, copied there once."""
    return tuple(torch.from_numpy(a).to(device) for a in _taps(in_size, out_size))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once. The float64 product is exact; the
    float64 sum is corrected where rounding it to float32 would round twice
    (it lies on a float32 midpoint while the exact sum does not)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)                  # s + err == p + c exactly
    low = s.view(torch.int64) & ((1 << 29) - 1)      # the bits float32 drops
    tie = (low == (1 << 28)) & (err != 0)
    s = torch.where(tie, torch.nextafter(s, s + err), s)
    return s.float()


def _resize_axis0(x: torch.Tensor, out_size: int, fused: bool) -> torch.Tensor:
    """Contract axis 0 with the reference's weights: w_lo * x[lo] rounded,
    then the w_hi term added, fused into one rounding as the reference's CPU
    matrix product adds it on the first axis, or rounded on its own as on
    the second."""
    lo, hi, w_lo, w_hi = _taps_on(x.shape[0], out_size, x.device)
    first = w_lo[:, None] * x[lo]
    if fused:
        return _fma(w_hi[:, None].expand(-1, x.shape[1]), x[hi], first)
    return first + w_hi[:, None] * x[hi]


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Half-pixel-center linear resize without antialiasing, as
    `jax.image.resize(img, (out_h, out_w), "linear", antialias=False)`:
    rows first, then columns, each skipped where its size stays. Plain
    elementwise float32 (no matrix product, so no TF32 on the card)."""
    h, w = img.shape
    x = img if out_h == h else _resize_axis0(img, out_h, fused=True)
    if out_w != w:
        x = _resize_axis0(x.T, out_w, fused=False).T.contiguous()
    return x


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
