"""The mixed-FOV stereo rig of tests/test_stereo.py, numpy only.

300 textured points 3-7 m in front of a rig whose secondary camera (fx =
fy = 325) is narrower than its primary (260), 0.12 m to the side, both
320×180 with the principal point (160, 90). Each camera pastes a point's
patch at its rounded projection; the secondary's patches are resampled to
its focal length, the fact the stereo rescale undoes. The rig moves along
+x at 1.8 units/s with a slight y wobble. `frames()` gives the same pairs,
bit for bit, as `tools/export_jax_state.py stereo` renders for the JAX
session (the fixture stores each frame's SHA-256); the port keeps its own
copy.
"""

from __future__ import annotations

import hashlib

import numpy as np

W, H = 320, 180
CAMS = ((260.0, 260.0), (325.0, 325.0))   # primary, secondary (fx, fy)
PP = (160.0, 90.0)
BASELINE = 0.12
N_FRAMES = 24
DT = 0.033


def world() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(300, 3) points, their 13×13 patches and the secondary's resampled
    patches."""
    rng = np.random.RandomState(17)
    n_pts = 300
    pts = np.stack([rng.uniform(-3.0, 7.0, n_pts), rng.uniform(-2.0, 2.0, n_pts),
                    rng.uniform(3.0, 7.0, n_pts)], 1).astype(np.float32)
    patches = rng.uniform(30, 220, (n_pts, 13, 13)).astype(np.float32)

    def resize_patch(p, n):
        xs = np.linspace(0, p.shape[1] - 1, n)
        rows = np.stack([np.interp(xs, np.arange(p.shape[1]), p[r])
                         for r in range(p.shape[0])])
        ys = np.linspace(0, p.shape[0] - 1, n)
        return np.stack([np.interp(ys, np.arange(p.shape[0]), rows[:, c])
                         for c in range(n)], axis=1).astype(np.float32)

    n1 = int(round(13 * CAMS[1][0] / CAMS[0][0])) | 1
    return pts, patches, np.stack([resize_patch(p, n1) for p in patches])


def render(pts, R, t, fx, fy, bank) -> np.ndarray:
    """(H, W) float32: each visible point's patch pasted at its rounded
    projection under the world→camera (R, t)."""
    half = bank.shape[1] // 2
    Xc = pts @ np.asarray(R, np.float32).T + np.asarray(t, np.float32)
    z = Xc[:, 2]
    u = fx * Xc[:, 0] / z + PP[0]
    v = fy * Xc[:, 1] / z + PP[1]
    img = np.zeros((H, W), np.float32)
    m = half + 3
    vis = (z > 1.0) & (u > m) & (u < W - m) & (v > m) & (v < H - m)
    for i in np.where(vis)[0]:
        x, y = int(round(u[i])), int(round(v[i]))
        img[y - half:y + half + 1, x - half:x + half + 1] = bank[i]
    return img


def frames(n: int = N_FRAMES) -> list[tuple[np.ndarray, np.ndarray, float]]:
    """(primary image, secondary image, timestamp) of the first n pairs; the
    rig's camera 0 → camera 1 transform is `rig()`."""
    pts, patches, patches1 = world()
    eye = np.eye(3, dtype=np.float32)
    out = []
    for i in range(n):
        ts = i * DT
        c = np.array([1.8 * ts, 0.05 * np.sin(2 * ts), 0.0], np.float32)
        t1 = -c + np.array([-BASELINE, 0.0, 0.0], np.float32)
        out.append((render(pts, eye, -c, *CAMS[0], patches),
                    render(pts, eye, t1, *CAMS[1], patches1), ts))
    return out


def rig() -> tuple[np.ndarray, np.ndarray]:
    """(R, t) of camera 0 → camera 1."""
    return np.eye(3, dtype=np.float32), np.array([-BASELINE, 0.0, 0.0], np.float32)


def secondary_camera() -> np.ndarray:
    """The secondary's (16,) pinhole vector."""
    cam = np.zeros(16, np.float32)
    cam[:4] = [*CAMS[1], *PP]
    cam[12], cam[13] = W, H
    return cam


def frame_hash(img: np.ndarray) -> str:
    """SHA-256 of a frame's float32 bytes."""
    return hashlib.sha256(np.ascontiguousarray(img, np.float32).tobytes()).hexdigest()
