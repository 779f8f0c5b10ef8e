"""rBRIEF descriptors as dense bit planes (port of mageslam_tpu/ops/orb.py).

For the unrotated (golden) path every pattern bit is computed for every
pixel at once, as a comparison of two shifted views of the blurred image,
and 32 bits are packed per word into an (8, H, W) int32 tensor that holds
the reference's uint32 bits; one row per keypoint is then gathered. The
256 comparisons are 256 eager launches per frame here (XLA fused them into
a few passes): the second candidate for a fused kernel after FAST.

`brief_pattern` is the reference's own numpy code with the same seed, so
the two packages describe a pixel with the same bits.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

DESCRIPTOR_BITS = 256
DESCRIPTOR_WORDS = 8  # 32-bit words
# bit b of a word as an int32 (bit 31 is the sign bit)
_BIT_VALUES = np.left_shift(np.uint32(1), np.arange(32, dtype=np.uint32)).view(np.int32)


@lru_cache(maxsize=None)
def brief_pattern(patch_size: int = 15, seed: int = 0x5EED) -> np.ndarray:
    """(256, 2, 2) int32 sample-offset pairs [(dx1,dy1),(dx2,dy2)] within the patch."""
    half = patch_size // 2
    sigma = patch_size / 5.0
    rs = np.random.RandomState(seed)
    pts = np.clip(np.round(rs.randn(DESCRIPTOR_BITS, 2, 2) * sigma), -half, half)
    # nudge degenerate pairs (identical sample points give constant bits)
    for i in range(DESCRIPTOR_BITS):
        while np.all(pts[i, 0] == pts[i, 1]):
            pts[i, 1] = np.clip(np.round(rs.randn(2) * sigma), -half, half)
    return pts.astype(np.int32)


def descriptor_bit_planes(blurred: torch.Tensor, patch_size: int = 15) -> torch.Tensor:
    """(8, H, W) int32 packed descriptor planes for every pixel (zero border)."""
    pattern = brief_pattern(patch_size)
    pad = int(np.abs(pattern).max()) + 1
    h, w = blurred.shape
    p = F.pad(blurred, (pad, pad, pad, pad))

    def view(dx: int, dy: int) -> torch.Tensor:
        return p[pad + dy:pad + dy + h, pad + dx:pad + dx + w]

    zero = torch.zeros((), dtype=torch.int32, device=blurred.device)
    words = []
    for wd in range(DESCRIPTOR_WORDS):
        acc = torch.zeros((h, w), dtype=torch.int32, device=blurred.device)
        for b in range(32):
            (x1, y1), (x2, y2) = pattern[wd * 32 + b]
            bit = view(int(x1), int(y1)) < view(int(x2), int(y2))
            acc |= torch.where(bit, int(_BIT_VALUES[b]), zero)
        words.append(acc)
    return torch.stack(words)


def gather_descriptors(planes: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """planes (8, H, W), xy (N, 2) float pixel coords → (N, 8) int32."""
    x = torch.clamp(xy[:, 0].to(torch.int64), 0, planes.shape[2] - 1)
    y = torch.clamp(xy[:, 1].to(torch.int64), 0, planes.shape[1] - 1)
    return planes[:, y, x].T.contiguous()
