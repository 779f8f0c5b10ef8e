"""The benchmark's scene and trajectory generator, numpy only.

A world of textured patches in front of a pinhole camera that translates
without rotating: the scene of the repo's original benchmark, made from the
seed and extended to take a trajectory from a traffic file. With the
`explore` parameters and seed 7 it renders the frames of
`mageslam_tpu_torch/bench_world.py` bit for bit (a frozen copy: the program
may change its own, and this one must not move with it).

A traffic file names this generator and gives:

- `scene`: `points`, the x / y / z ranges the points are drawn from;
- `trajectory`: `speed` (units/s of sideways travel), `bob` (amplitude of the
  vertical bob, units) and `bob_rate` (rad/s), `stop_frame` (null: never;
  else the camera stops travelling there and dwells) and `dwell`
  (`amplitude` [x, y, z] and `period_frames` of the periodic head motion
  after the stop);
- `dt`: seconds between frames.

The true camera center of every frame comes from `camera_center`; the
rotation is the identity throughout.
"""

from __future__ import annotations

import numpy as np

PATCH = 17       # rendered patch side, pixels
COARSE = 5       # the random grid each patch is upsampled from


def build_world(rng: np.random.RandomState, scene: dict) -> tuple[np.ndarray, np.ndarray]:
    """(N, 3) float32 points drawn uniformly in the scene's ranges and
    (N, 17, 17) float32 patches, bilinear upsamplings of random 5x5 grids."""
    n = int(scene["points"])
    (x0, x1), (y0, y1), (z0, z1) = scene["x_range"], scene["y_range"], scene["z_range"]
    pts = np.stack([
        rng.uniform(x0, x1, n),
        rng.uniform(y0, y1, n),
        rng.uniform(z0, z1, n),
    ], 1).astype(np.float32)
    coarse = rng.randint(0, 256, (n, COARSE, COARSE)).astype(np.float32)
    patches = np.empty((n, PATCH, PATCH), np.float32)
    xs = np.linspace(0, COARSE - 1, PATCH)
    for i in range(n):
        rows = np.stack([np.interp(xs, np.arange(COARSE), coarse[i, r])
                         for r in range(COARSE)])
        patches[i] = np.stack([np.interp(xs, np.arange(COARSE), rows[:, c])
                               for c in range(PATCH)], axis=1)
    return pts, patches


def camera_center(frame: int, traffic: dict) -> np.ndarray:
    """The true camera center (3,) float32 of frame `frame`."""
    tr = traffic["trajectory"]
    dt = traffic["dt"]
    t = frame * dt
    stop = tr.get("stop_frame")
    if stop is None or frame <= stop:
        return np.array([tr["speed"] * t, tr["bob"] * np.sin(tr["bob_rate"] * t), 0.0],
                        np.float32)
    ts = stop * dt
    phase = np.sin(2.0 * np.pi * (frame - stop) / tr["dwell"]["period_frames"])
    ax, ay, az = tr["dwell"]["amplitude"]
    return np.array([tr["speed"] * ts + ax * phase,
                     tr["bob"] * np.sin(tr["bob_rate"] * ts) + ay * phase,
                     az * phase], np.float32)


def render(pts: np.ndarray, patches: np.ndarray, c: np.ndarray, cam, width: int,
           height: int) -> np.ndarray:
    """(H, W) float32 frame seen from center `c`: each visible point's patch
    pasted at its rounded projection, later points over earlier ones."""
    fx, fy, cx, cy = cam
    Xc = pts - c[None, :]
    z = Xc[:, 2]
    u = fx * Xc[:, 0] / z + cx
    v = fy * Xc[:, 1] / z + cy
    img = np.zeros((height, width), np.float32)
    m = PATCH // 2 + 4
    vis = (z > 1.0) & (u > m) & (u < width - m) & (v > m) & (v < height - m)
    h = PATCH // 2
    for i in np.where(vis)[0]:
        x, y = int(round(u[i])), int(round(v[i]))
        img[y - h:y + h + 1, x - h:x + h + 1] = patches[i]
    return img


class World:
    """The scene of one seed under one traffic file: frames as a camera
    delivers them (uint8) and the true camera centers."""

    def __init__(self, seed: int, traffic: dict, config: dict):
        self.traffic = traffic
        self.cam = tuple(float(v) for v in config["camera"]["pinhole"])
        self.width = int(config["camera"]["width"])
        self.height = int(config["camera"]["height"])
        self.pts, self.patches = build_world(np.random.RandomState(seed % 2**32),
                                             traffic["scene"])

    def timestamp(self, frame: int) -> float:
        return frame * self.traffic["dt"]

    def frame(self, frame: int) -> np.ndarray:
        img = render(self.pts, self.patches, camera_center(frame, self.traffic), self.cam,
                     self.width, self.height)
        return np.clip(img, 0, 255).astype(np.uint8)

    def frames(self, start: int, stop: int) -> np.ndarray:
        """(stop - start, H, W) uint8."""
        return np.stack([self.frame(i) for i in range(start, stop)])

    def center(self, frame: int) -> np.ndarray:
        return camera_center(frame, self.traffic)
