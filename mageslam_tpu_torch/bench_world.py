"""The synthetic scene of the repo's benchmark (`bench.py`), numpy only.

A world of 700 textured 17×17 patches in front of a camera that explores
sideways at 1.5 units/s, rendered as 640×480 grayscale frames with the
pinhole [520, 520, 320, 240]. `build_world(np.random.RandomState(7))` and
`render(pts, patches, i * 0.033)` give the same frames, bit for bit, as
`bench.py`'s functions of the same names (tests/test_torch_config.py holds
them equal); the port keeps its own copy so that it never imports that file,
which imports jax.
"""

from __future__ import annotations

import numpy as np

W, H = 640, 480
FX = FY = 520.0
CX, CY = 320.0, 240.0
N_POINTS = 700
SPEED = 1.5     # units/s of sideways travel
DT = 0.033      # seconds between frames


def build_world(rng: np.random.RandomState) -> tuple[np.ndarray, np.ndarray]:
    """(N_POINTS, 3) float32 world points spread along the whole trajectory
    and (N_POINTS, 17, 17) float32 patches, bilinear upsamplings of random
    5×5 grids."""
    pts = np.stack([
        rng.uniform(-4, 23, N_POINTS),
        rng.uniform(-3, 3, N_POINTS),
        rng.uniform(3, 8, N_POINTS),
    ], 1).astype(np.float32)
    coarse = rng.randint(0, 256, (N_POINTS, 5, 5)).astype(np.float32)
    patches = np.empty((N_POINTS, 17, 17), np.float32)
    xs = np.linspace(0, 4, 17)
    for i in range(N_POINTS):
        rows = np.stack([np.interp(xs, np.arange(5), coarse[i, r]) for r in range(5)])
        patches[i] = np.stack([np.interp(xs, np.arange(5), rows[:, c])
                               for c in range(17)], axis=1)
    return pts, patches


def camera_center(t: float) -> np.ndarray:
    return np.array([SPEED * t, 0.05 * np.sin(1.5 * t), 0.0], np.float32)


def render(pts: np.ndarray, patches: np.ndarray, t: float) -> np.ndarray:
    """(H, W) float32 frame at time `t`: each visible point's patch pasted
    at its rounded projection, later points over earlier ones."""
    c = camera_center(t)
    Xc = pts - c[None, :]
    z = Xc[:, 2]
    u = FX * Xc[:, 0] / z + CX
    v = FY * Xc[:, 1] / z + CY
    img = np.zeros((H, W), np.float32)
    vis = (z > 1.0) & (u > 12) & (u < W - 12) & (v > 12) & (v < H - 12)
    for i in np.where(vis)[0]:
        x, y = int(round(u[i])), int(round(v[i]))
        img[y - 8:y + 9, x - 8:x + 9] = patches[i]
    return img


def frames(start: int, stop: int, seed: int = 7) -> list[np.ndarray]:
    """Frames start..stop-1 of the world built from `seed`, clipped and cast
    to uint8 as a camera delivers them."""
    pts, patches = build_world(np.random.RandomState(seed))
    return [np.clip(render(pts, patches, i * DT), 0, 255).astype(np.uint8)
            for i in range(start, stop)]
