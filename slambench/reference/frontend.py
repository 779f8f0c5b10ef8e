"""The plain ORB front end: pyramid → FAST-9/16 → RetainBestFeatures + ANMS
→ rBRIEF on the unrotated pattern → pinhole keypoints, as eager PyTorch on
fixed shapes.

A frozen copy of the plain routines the program started from (its JAX
package's frontend as first ported), kept here so that the yardstick does
not move when the program's frontend is redesigned. It imports nothing of
the program. `prec="f32"` computes as the configuration states (float32,
no TF32); `prec="tf32"` is the control: every product of the blur and the
pyramid resize takes operands rounded to TF32's 10-bit mantissa, as a
tensor core computes them, with float32 sums.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

CANDIDATES_PER_LEVEL = 2048
ROBUST_EPS = 0.002
CIRCLE16 = (
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
)
DESCRIPTOR_BITS = 256
DESCRIPTOR_WORDS = 8
_BIT_VALUES = np.left_shift(np.uint32(1), np.arange(32, dtype=np.uint32)).view(np.int32)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits, nearest even)."""
    i = x.contiguous().view(torch.int32)
    r = (i + 0x0FFF + ((i >> 13) & 1)) & -8192
    return r.view(torch.float32)


def _mul(a, b, prec: str):
    """a * b, with TF32 operands under the control precision."""
    if prec == "tf32":
        a = tf32(a) if torch.is_tensor(a) else float(tf32(torch.tensor([a]))[0])
        b = tf32(b) if torch.is_tensor(b) else float(tf32(torch.tensor([b]))[0])
    return a * b


def topk_stable(x: torch.Tensor, k: int):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# ---- FAST ---------------------------------------------------------------

def fast_score_map(img: torch.Tensor, threshold: int) -> torch.Tensor:
    h, w = img.shape
    p = F.pad(img, (3, 3, 3, 3))
    d = [img - p[3 + dy:3 + dy + h, 3 + dx:3 + dx + w] for (dx, dy) in CIRCLE16]
    ext = d + d[:8]

    def window9_min(planes):
        m2 = [torch.minimum(planes[i], planes[i + 1]) for i in range(len(planes) - 1)]
        m4 = [torch.minimum(m2[i], m2[i + 2]) for i in range(len(m2) - 2)]
        m8 = [torch.minimum(m4[i], m4[i + 4]) for i in range(len(m4) - 4)]
        return [torch.minimum(m8[k], planes[k + 8]) for k in range(16)]

    dark_w = window9_min(ext)
    bright_w = window9_min([-q for q in ext])
    dark, bright = dark_w[0], bright_w[0]
    for k in range(1, 16):
        dark = torch.maximum(dark, dark_w[k])
        bright = torch.maximum(bright, bright_w[k])
    score = torch.maximum(dark, bright) - 1.0
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    interior = (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)
    return torch.where((score >= threshold) & interior, score, -1.0)


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    h, w = score.shape
    p = F.pad(score, (1, 1, 1, 1), value=float("-inf"))
    keep = torch.ones_like(score, dtype=torch.bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx or dy:
                keep &= score > p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    return torch.where(keep, score, float("-inf"))


def extract_candidates(score: torch.Tensor, k: int, border: float):
    h, w = score.shape
    ys = torch.arange(h, device=score.device, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=score.device, dtype=torch.float32)[None, :]
    inb = (xs >= border) & (xs < w - border) & (ys >= border) & (ys < h - border)
    vals, idx = topk_stable(torch.where(inb, score, float("-inf")).reshape(-1), k)
    yy = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
    xx = (idx % w).to(torch.float32)
    valid = vals > 0.0
    return torch.stack([xx, yy], dim=-1), torch.where(valid, vals, 0.0), valid


# ---- selection ----------------------------------------------------------

def retain_best_features(response, valid, min_num: int, max_num: int, min_threshold: int,
                         response_factor: float):
    r_int = torch.where(valid, torch.clamp(response, 0.0, 255.0).to(torch.int32), -1)
    n_valid = torch.sum(valid.to(torch.int32))
    idx_min = torch.clamp(torch.clamp_min(n_valid - 1, 0), max=min_num - 1)
    bin_at_min = r_int[idx_min.reshape(1)][0]
    have_min = (n_valid >= min_num) & (bin_at_min >= min_threshold)
    min_num_threshold = torch.where(have_min, bin_at_min, min_threshold)
    thr2 = torch.clamp_min(
        (min_num_threshold.to(torch.float32) * response_factor).to(torch.int32), min_threshold)
    idx_max = torch.clamp(torch.clamp_min(n_valid - 1, 0), max=max_num - 1)
    bin_stop = torch.where(n_valid > max_num, r_int[idx_max.reshape(1)][0], 0)
    return valid & (r_int >= torch.maximum(thr2, bin_stop))


def adaptive_nms(xy, response, valid, num_to_keep: int, fast_threshold: int,
                 strong_response: int, min_robustness: float, max_robustness: float):
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
    rng = max(0.0, max_robustness - min_robustness)
    denom = float(strong_response - fast_threshold)
    val = torch.clamp(min_strength - fast_threshold, 0.0, denom)
    rf = max_robustness - (val / denom) * rng
    global_max_r2 = ((maxx - minx).to(torch.float32) * (maxy - miny).to(torch.float32)
                     / num_to_keep).to(torch.int32)
    s = strength * rf + ROBUST_EPS
    dx = x[:, None] - x[None, :]
    dy = y[:, None] - y[None, :]
    d2 = torch.where((strength[None, :] > s[:, None]) & valid[None, :], dx * dx + dy * dy, big)
    r = torch.minimum(torch.min(d2, dim=1).values, global_max_r2)
    key = torch.where(valid, r.to(torch.float32) * 16384.0 + strength, float("-inf"))
    _, top_idx = topk_stable(key, min(num_to_keep, k))
    keep = torch.zeros((k,), dtype=torch.bool, device=xy.device)
    keep[top_idx] = True
    return torch.where(n_valid <= num_to_keep, valid, keep & valid)


def spatial_select(xy, response, valid, num_to_keep: int, image_width: int,
                   image_height: int, grid_w: int, grid_h: int):
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
    rank = torch.sum((same_cell & better).to(torch.int32), dim=1)
    key = torch.where(valid, -rank.to(torch.float32) * 1024.0 + torch.clamp(resp, 0.0, 255.0),
                      float("-inf"))
    _, top_idx = topk_stable(key, min(num_to_keep, k))
    keep = torch.zeros((k,), dtype=torch.bool, device=xy.device)
    keep[top_idx] = True
    return torch.where(n_valid <= num_to_keep, valid, keep & valid)


# ---- image --------------------------------------------------------------

def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img, ksize: int, sigma: float, prec: str):
    """Separable, REFLECT_101 border, rows then columns, taps in order."""
    if ksize <= 1:
        return img
    k = gaussian_kernel_1d(ksize, sigma).tolist()
    pad = ksize // 2
    h, w = img.shape
    x = F.pad(img[None, None], (pad, pad, pad, pad), mode="reflect")[0, 0]
    rows = _mul(k[0], x[:, 0:w], prec)
    for i in range(1, ksize):
        rows = rows + _mul(k[i], x[:, i:i + w], prec)
    out = _mul(k[0], rows[0:h], prec)
    for i in range(1, ksize):
        out = out + _mul(k[i], rows[i:i + h], prec)
    return out


@functools.lru_cache(maxsize=None)
def _taps(in_size: int, out_size: int):
    """Half-pixel-center linear resize weights, two taps an output sample,
    with the sample positions rounded as the JAX package's CPU build does
    (a fused multiply-add in its 8-wide vector body)."""
    inv = np.float32(in_size / out_size)
    j = np.arange(out_size)
    fused = ((j + 0.5) * np.float64(inv) - 0.5).astype(np.float32)
    split = (j.astype(np.float32) + np.float32(0.5)) * inv - np.float32(0.5)
    sample = np.where((out_size >= 96) & (j < out_size // 8 * 8), fused, split).astype(np.float32)
    dist = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None])
    w = np.maximum(np.float32(0), np.float32(1) - dist)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0).astype(np.float32)
    w = np.where(((sample >= -0.5) & (sample <= in_size - 0.5))[None, :], w, 0)
    lo = np.argmax(w != 0, axis=0)
    hi = np.minimum(lo + 1, in_size - 1)
    cols = np.arange(out_size)
    return lo, hi, w[lo, cols], np.where(hi != lo, w[hi, cols], 0).astype(np.float32)


def _fma(a, b, c):
    """float32 a * b + c rounded once."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    low = s.view(torch.int64) & ((1 << 29) - 1)
    s = torch.where((low == (1 << 28)) & (err != 0), torch.nextafter(s, s + err), s)
    return s.float()


def _resize_axis0(x, out_size: int, fused: bool, prec: str):
    lo, hi, w_lo, w_hi = (torch.from_numpy(a).to(x.device) for a in _taps(x.shape[0], out_size))
    if prec == "tf32":
        return _mul(w_lo[:, None], x[lo], prec) + _mul(w_hi[:, None], x[hi], prec)
    first = w_lo[:, None] * x[lo]
    if fused:
        return _fma(w_hi[:, None].expand(-1, x.shape[1]), x[hi], first)
    return first + w_hi[:, None] * x[hi]


def build_pyramid(img, num_levels: int, scale: float, prec: str):
    h, w = img.shape
    levels = [img]
    for lv in range(1, num_levels):
        lh, lw = int(round(h / scale**lv)), int(round(w / scale**lv))
        x = levels[-1]
        if lh != x.shape[0]:
            x = _resize_axis0(x, lh, True, prec)
        if lw != x.shape[1]:
            x = _resize_axis0(x.T, lw, False, prec).T.contiguous()
        levels.append(x)
    return levels


def features_per_level(n_features: int, num_levels: int, scale: float) -> list[int]:
    if num_levels == 1:
        return [n_features]
    factor = 1.0 / scale
    n_desired = n_features * (1 - factor) / (1 - factor**num_levels)
    out, total = [], 0
    for _ in range(num_levels - 1):
        n = int(round(n_desired))
        out.append(n)
        total += n
        n_desired *= factor
    out.append(max(n_features - total, 0))
    return out


# ---- rBRIEF -------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def brief_pattern(patch_size: int = 15, seed: int = 0x5EED) -> np.ndarray:
    half = patch_size // 2
    sigma = patch_size / 5.0
    rs = np.random.RandomState(seed)
    pts = np.clip(np.round(rs.randn(DESCRIPTOR_BITS, 2, 2) * sigma), -half, half)
    for i in range(DESCRIPTOR_BITS):
        while np.all(pts[i, 0] == pts[i, 1]):
            pts[i, 1] = np.clip(np.round(rs.randn(2) * sigma), -half, half)
    return pts.astype(np.int32)


def descriptors_at(blurred, xy, patch_size: int):
    """(N, 8) int32 words of the unrotated pattern at integer keypoints."""
    pattern = torch.from_numpy(brief_pattern(patch_size).astype(np.int64)).to(blurred.device)
    h, w = blurred.shape
    pad = int(pattern.abs().max()) + 1
    p = F.pad(blurred, (pad, pad, pad, pad))
    x = torch.clamp(xy[:, 0].to(torch.int64), 0, w - 1) + pad
    y = torch.clamp(xy[:, 1].to(torch.int64), 0, h - 1) + pad
    a = p[y[:, None] + pattern[None, :, 0, 1], x[:, None] + pattern[None, :, 0, 0]]
    b = p[y[:, None] + pattern[None, :, 1, 1], x[:, None] + pattern[None, :, 1, 0]]
    bits = (a < b).reshape(-1, DESCRIPTOR_WORDS, 32)
    values = torch.from_numpy(_BIT_VALUES.astype(np.int64)).to(blurred.device)
    return torch.sum(torch.where(bits, values, 0), dim=-1).to(torch.int32)


# ---- the frame ----------------------------------------------------------

def _level(img, n_level: int, scale: float, level: int, fes: dict, prec: str):
    score = nms3x3(fast_score_map(img, fes["FastThreshold"]))
    border = fes["PatchSize"] / 2.0
    xy, resp, valid = extract_candidates(score, CANDIDATES_PER_LEVEL, border)
    if fes["SpatialFeatureSelection"]:
        valid = spatial_select(xy, resp, valid, n_level, img.shape[1], img.shape[0],
                               fes["SpatialSelectionGridX"], fes["SpatialSelectionGridY"])
    else:
        valid = retain_best_features(resp, valid, n_level, int(n_level * fes["FeatureFactor"]),
                                     fes["FastThreshold"], fes["FeatureStrength"])
        valid = adaptive_nms(xy, resp, valid, n_level, fes["FastThreshold"],
                             fes["StrongResponse"], fes["MinRobustnessFactor"],
                             fes["MaxRobustnessFactor"])
    key = torch.where(valid, resp + 1.0, float("-inf"))
    _, idx = topk_stable(key, n_level)
    xy, resp, valid = xy[idx], resp[idx], valid[idx]
    blurred = gaussian_blur(img, fes["GaussianKernelSize"], 2.0, prec)
    desc = descriptors_at(blurred, xy, fes["PatchSize"])
    octave = torch.full((n_level,), level, dtype=torch.int32, device=img.device)
    return xy * scale, resp, octave, desc, valid


def detect(image_u8: torch.Tensor, fes: dict, cam, max_features: int, prec: str = "f32"):
    """Keypoints of one uint8 frame (H, W): dict of xy (N, 2) level-0 pixels,
    und_xy (N, 2) pinhole keypoints, octave (N,), desc (N, 8) int32, valid
    (N,), padded to `max_features` slots, invalid slots at -1e6. `fes` holds
    the FeatureExtractorSettings by name (unrotated descriptors only), `cam`
    the pinhole fx, fy, cx, cy."""
    if fes["UseOrientation"]:
        raise ValueError("the reference frontend describes unrotated keypoints only")
    img = image_u8.to(torch.float32)
    levels = build_pyramid(img, fes["NumLevels"], fes["ScaleFactor"], prec)
    n_per = features_per_level(fes["NumFeatures"], fes["NumLevels"], fes["ScaleFactor"])
    parts = [_level(im, n_per[lv], fes["ScaleFactor"]**lv, lv, fes, prec)
             for lv, im in enumerate(levels)]
    xy, resp, octave, desc, valid = (torch.cat([p[i] for p in parts]) for i in range(5))
    pad = max_features - xy.shape[0]
    if pad < 0:
        raise ValueError(f"NumFeatures {xy.shape[0]} exceeds {max_features} slots")
    if pad:
        xy, octave, desc, valid = (torch.cat([t, t.new_zeros((pad,) + t.shape[1:])])
                                   for t in (xy, octave, desc, valid))
    fx, fy, cx, cy = (torch.tensor(float(v), dtype=torch.float32, device=img.device)
                      for v in cam)
    und = torch.stack([fx * ((xy[:, 0] - cx) / fx) + cx, fy * ((xy[:, 1] - cy) / fy) + cy], -1)
    far = torch.full((), -1e6, dtype=torch.float32, device=img.device)
    return {"xy": torch.where(valid[:, None], xy, far),
            "und_xy": torch.where(valid[:, None], und, far),
            "octave": octave, "desc": desc, "valid": valid}
