"""Photorealistic synthetic scene renderer with ground truth (ATE harness);
the port's own copy of mageslam_tpu/apps/render_scene.py (numpy only: the
same frames, bit for bit).

A textured room (walls, floor, ceiling, boxes, posters) raycast at 640×480
along a smooth exploring trajectory, with Lambertian shading, per-frame
lighting variation, distance falloff, vignette and sensor noise. Textures
are 1/f ("pink") noise shaped by structured patterns (bricks, wood grain,
checkers, blobs) — the spectral statistics FAST/rBRIEF see on natural
images.

Written as a TUM RGB-D sequence directory (rgb.txt + rgb/*.png +
groundtruth.txt):

    python -m mageslam_tpu_torch.apps.render_scene /tmp/scene --frames 300

Everything is also importable (build_scene / render_frame / trajectory_pose
/ render_sequence) so the visual-inertial evaluation (apps/vi_eval.py) and
tests can drive the full image path in memory.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import NamedTuple

import numpy as np

# TUM fr1 intrinsics at 640×480 — matches the console's camera defaults so no
# flags are needed on the SLAM side.
FX, FY, CX, CY = 517.3, 516.5, 318.6, 255.3
BASE_W, BASE_H = 640, 480


class Surface(NamedTuple):
    p0: np.ndarray       # (3,) corner
    eu: np.ndarray       # (3,) edge vector (u, full extent)
    ev: np.ndarray       # (3,) edge vector (v, full extent)
    texture: np.ndarray  # (Th, Tw) float32 albedo in [0, 1]


# --------------------------------------------------------------------------- #
# textures


def _pink_noise(rng: np.random.Generator, n: int, alpha: float = 1.8) -> np.ndarray:
    """1/f^alpha noise field in [0, 1] — natural-image power spectrum."""
    f = np.fft.fftfreq(n)
    fx, fy = np.meshgrid(f, f)
    r2 = fx * fx + fy * fy
    r2[0, 0] = 1.0
    spec = r2 ** (-alpha / 2.0)
    spec[0, 0] = 0.0
    phase = rng.uniform(0.0, 2.0 * np.pi, (n, n))
    img = np.real(np.fft.ifft2(np.sqrt(spec) * np.exp(1j * phase)))
    lo, hi = img.min(), img.max()
    return ((img - lo) / max(hi - lo, 1e-9)).astype(np.float32)


_detail_counter = [0]


def _detail(rng: np.random.Generator, n: int, strength: float = 0.4) -> np.ndarray:
    """Fine-scale multiplicative detail layer (near-white 1/f^1.1 noise).

    Real surfaces are fractal — paint grain, paper fiber, wear marks carry
    corner energy at EVERY magnification. A texture whose power lives at one
    coarse scale turns into featureless flats when the camera gets close
    (measured: the 360° orbit lost tracking at 85° when a 1.4 m blob poster
    at 1.4 m filled the view with 40 px uniform patches). The coarse makers
    (_blobs, _checker) multiply this in so close-range views keep
    FAST-detectable structure; _brick/_wood already carry their own grain
    and stay detail-free (adding it measurably delays sweep init — detail
    churns the response ranking between the init pair's detections).

    Uses its own counter-seeded stream (NOT the caller's rng) so the base
    texture layouts are bit-identical with detail on or off — the shared
    stream must not shift or every surface in the scene reshuffles."""
    own = np.random.default_rng(90210 + _detail_counter[0])
    _detail_counter[0] += 1
    return 1.0 + strength * (_pink_noise(own, n, 1.1) - 0.5)


def _brick(rng: np.random.Generator, n: int) -> np.ndarray:
    y, x = np.mgrid[0:n, 0:n]
    row = y // (n // 8)
    xx = x + (row % 2) * (n // 8)
    col = xx // (n // 4)
    mortar_y = (y % (n // 8)) < 2
    mortar_x = (xx % (n // 4)) < 2
    base = 0.45 + 0.25 * _pink_noise(rng, n, 1.6)
    # per-brick tone: real bricks vary unit to unit. A perfectly uniform
    # brick grid is translationally self-similar — every mortar crossing
    # matches every other and the two-way matcher's ambiguity gate rejects
    # the whole wall (measured: the orbit died at 26° staring at a uniform
    # brick field). Tones come from a counter-seeded stream (see _detail)
    # so the caller's rng — and with it every other surface's layout — is
    # untouched.
    own = np.random.default_rng(424242 + _detail_counter[0])
    _detail_counter[0] += 1
    tones = own.uniform(0.74, 1.26, (row.max() + 1, col.max() + 2))
    base = base * tones[row, col]
    base[mortar_y | mortar_x] = 0.85
    return np.clip(base + 0.08 * rng.standard_normal((n, n)), 0.05, 0.98).astype(np.float32)


def _wood(rng: np.random.Generator, n: int) -> np.ndarray:
    y, x = np.mgrid[0:n, 0:n].astype(np.float32) / n
    warp = 0.25 * _pink_noise(rng, n, 2.2)
    grain = 0.5 + 0.45 * np.sin(2 * np.pi * (10 * x + 6 * warp))
    base = 0.25 + 0.55 * grain * (0.6 + 0.4 * _pink_noise(rng, n, 1.5))
    # plank structure: pure grain is self-similar along y (vertical stripes —
    # every point on a stripe matches every other; measured: the orbit died
    # at 251° staring at a uniform grain field). Real wood panelling is
    # planks: per-plank tone + staggered horizontal seams break the
    # translational symmetry. Counter-seeded stream — caller's rng untouched.
    yi, xi = np.mgrid[0:n, 0:n]
    px = xi * 6 // n                                   # 6 plank columns
    own = np.random.default_rng(515151 + _detail_counter[0])
    _detail_counter[0] += 1
    offs = own.integers(0, n // 3, 7)
    py = (yi + offs[px]) * 3 // n                      # staggered 3 rows
    tones = own.uniform(0.76, 1.24, (7, 5)).astype(np.float32)
    base = base * tones[px, py]
    seam_y = ((yi + offs[px]) * 3 % n) < max(n // 128, 2)
    seam_x = (xi * 6 % n) < max(n // 128, 2)
    base[seam_y | seam_x] *= 0.55
    return np.clip(base, 0.05, 0.98).astype(np.float32)


def _checker(rng: np.random.Generator, n: int, cells: int = 10) -> np.ndarray:
    y, x = np.mgrid[0:n, 0:n]
    cr = y * cells // n
    cc = x * cells // n
    c = (cr + cc) % 2
    base = np.where(c, 0.75, 0.25).astype(np.float32)
    # per-square tone (same counter-seeded stream trick as _brick/_detail):
    # a uniform checkerboard is translationally self-similar — every square
    # crossing matches every other and the two-way matcher's ambiguity gate
    # rejects the whole wall (measured: the orbit died at 104° staring at
    # the uniform checker wall). Real painted/tiled checkers vary per tile.
    own = np.random.default_rng(777000 + _detail_counter[0])
    _detail_counter[0] += 1
    tones = own.uniform(0.72, 1.28, (cells + 1, cells + 1)).astype(np.float32)
    base = base * tones[cr, cc]
    return np.clip(base * (0.65 + 0.55 * _pink_noise(rng, n, 1.7))
                   * _detail(rng, n, 0.5), 0.05, 0.98)


def _blobs(rng: np.random.Generator, n: int) -> np.ndarray:
    """Poster-like high-contrast blob field."""
    img = _pink_noise(rng, n, 2.4)
    img = np.where(img > 0.55, 0.85, 0.2).astype(np.float32)
    return np.clip(img * (0.7 + 0.5 * _pink_noise(rng, n, 1.4))
                   * _detail(rng, n, 0.5), 0.05, 0.98)


_TEX_MAKERS = [_brick, _wood, _checker, _blobs]


# --------------------------------------------------------------------------- #
# scene


def build_scene(seed: int = 7, tex: int = 384,
                variant: str = "default") -> list[Surface]:
    """A 8×3×9 m room (y down: floor at y=+1.2) with boxes and posters.

    variant="loop" clears the room center (the orbit trajectory's ring) and
    spreads boxes/posters along the walls, so a 360° outward-looking circuit
    always has textured structure at 2-4 m — the depth band where a ~4 cm/
    frame baseline keeps translation observable for monocular tracking."""
    rng = np.random.default_rng(seed)
    _detail_counter[0] = seed * 1000   # reproducible across build_scene calls
    v = lambda *a: np.array(a, np.float32)
    surfaces: list[Surface] = []

    def add(p0, eu, ev, maker):
        surfaces.append(Surface(v(*p0), v(*eu), v(*ev), maker(rng, tex)))

    # room shell (normals irrelevant; raycaster is double-sided)
    add((-4, 1.2, -1), (8, 0, 0), (0, 0, 10), _wood)        # floor
    add((-4, -1.8, -1), (8, 0, 0), (0, 0, 10), _pink_noise)  # ceiling
    add((-4, -1.8, 9), (8, 0, 0), (0, 3, 0), _brick)         # back wall
    add((-4, -1.8, -1), (0, 0, 10), (0, 3, 0), _brick)       # left wall
    add((4, -1.8, -1), (0, 0, 10), (0, 3, 0), _checker)      # right wall

    # posters on the walls (slightly proud so they occlude the wall)
    add((-1.6, -1.2, 8.98), (1.4, 0, 0), (0, 1.5, 0), _blobs)
    add((0.6, -1.0, 8.98), (1.8, 0, 0), (0, 1.2, 0), _wood)
    add((-3.98, -1.1, 2.0), (0, 0, 2.0), (0, 1.4, 0), _blobs)
    add((3.98, -1.2, 3.5), (0, 0, 1.6), (0, 1.6, 0), _blobs)

    # boxes standing on the floor (5 faces each; bottom omitted)
    def box(cx_, cz, w, h, d, maker):
        x0, z0, y0 = cx_ - w / 2, cz - d / 2, 1.2
        add((x0, y0 - h, z0), (w, 0, 0), (0, 0, d), maker)              # top
        add((x0, y0, z0), (w, 0, 0), (0, -h, 0), maker)                 # front
        add((x0, y0, z0 + d), (w, 0, 0), (0, -h, 0), maker)             # back
        add((x0, y0, z0), (0, 0, d), (0, -h, 0), maker)                 # left
        add((x0 + w, y0, z0), (0, 0, d), (0, -h, 0), maker)             # right

    if variant == "loop":
        # perimeter structure only; the center stays clear for the orbit
        # ring. The four pillars sit snug in the room corners and rise to
        # 2.3 m — TALL enough to cross the camera's eye line (y ≈ −0.3) so
        # corner-facing views always have textured structure, but far enough
        # from any trajectory (≥1.7 m clearance from the circuit path) that
        # no surface is ever seen at grazing close range. A surface closer
        # than ~1.2 m magnifies its texture past the FAST scale: responses
        # collapse and the global RetainBestFeatures response cut then
        # starves the whole region (measured on the circuit: a pillar face
        # at 0.5 m held 3/4 of the view with max response 27 vs 86 in the
        # far sliver — 67 of 440 budget slots left of the cut).
        box(3.3, 8.3, 1.2, 2.3, 1.2, _brick)        # corner (4, 9)
        box(3.3, -0.3, 1.2, 2.3, 1.2, _wood)        # corner (4, -1)
        box(-3.3, -0.3, 1.2, 2.3, 1.2, _checker)    # corner (-4, -1)
        box(-3.3, 8.3, 1.2, 2.3, 1.2, _pink_noise)  # corner (-4, 9)
        # wall-hugging crates: mid-height depth relief along every wall so
        # no viewpoint sees a single plane — 5-point initialization (no H/F
        # model selection, like the reference) is ambiguous on pure planes
        # (the wall-middle crates sit off-center along their walls: at the
        # wall midpoint the orbit ring passes within 0.5 m and the crate
        # face fills the whole view as a featureless close-up — the same
        # <1.2 m grazing-range collapse the pillar comment documents)
        box(3.7, 6.2, 0.6, 1.9, 0.8, _blobs)         # right wall, off-middle
        box(-3.7, 2.4, 0.6, 2.1, 0.8, _wood)         # left wall, off-middle
        box(-1.2, 8.5, 1.0, 1.8, 0.9, _checker)      # back wall
        box(1.6, 8.55, 0.8, 2.2, 0.8, _brick)        # back wall
        box(-1.4, -0.5, 0.9, 2.0, 0.9, _pink_noise)  # front wall
        box(1.2, -0.55, 0.8, 1.7, 0.8, _blobs)       # front wall
        add((-2.2, -1.1, -0.98), (1.6, 0, 0), (0, 1.6, 0), _blobs)   # front wall
        add((1.0, -1.3, -0.98), (1.5, 0, 0), (0, 1.3, 0), _checker)  # front wall
        add((-3.98, -1.0, 5.6), (0, 0, 1.8), (0, 1.3, 0), _wood)
        add((3.98, -1.3, 5.8), (0, 0, 1.7), (0, 1.5, 0), _blobs)
        # poster ring: unique high-contrast texture at eye height every ~2 m
        # on all four walls, so NO viewpoint ever sees self-similar brick
        # alone — repetitive texture makes ORB matching ambiguous (measured:
        # gather-stage match rate fell to 9/91 on a brick-only corner view
        # and pose-only LM lost lock). Each poster gets its own rng state so
        # the blob/checker layouts differ — uniqueness is the point.
        for k, zc in enumerate((0.8, 2.6, 4.4, 7.6)):
            mk = (_blobs, _checker, _wood, _pink_noise)[k % 4]
            add((-3.98, -1.2 + 0.1 * (k % 3), zc), (0, 0, 1.4), (0, 1.5, 0), mk)
        for k, zc in enumerate((0.6, 2.4, 4.6, 7.4)):
            mk = (_checker, _pink_noise, _blobs, _wood)[k % 4]
            add((3.98, -1.25 + 0.1 * (k % 3), zc), (0, 0, 1.4), (0, 1.5, 0), mk)
        for k, xc in enumerate((-3.2, -0.4, 1.0, 2.4)):
            mk = (_wood, _blobs, _pink_noise, _checker)[k % 4]
            add((xc, -1.2 + 0.08 * (k % 3), 8.97), (1.2, 0, 0), (0, 1.4, 0), mk)
        for k, xc in enumerate((-3.4, -0.6, 2.2)):
            mk = (_pink_noise, _wood, _blobs)[k % 3]
            add((xc, -1.15 + 0.08 * (k % 3), -0.97), (1.2, 0, 0), (0, 1.4, 0), mk)
    else:
        box(-1.8, 4.0, 1.1, 1.0, 0.9, _checker)
        box(1.5, 5.5, 1.4, 1.6, 1.0, _wood)
        box(0.2, 3.0, 0.7, 0.6, 0.7, _blobs)
        box(-2.6, 6.8, 1.0, 2.0, 1.0, _brick)
        box(2.8, 2.6, 0.8, 0.9, 0.8, _pink_noise)
    return surfaces


# --------------------------------------------------------------------------- #
# trajectory (ground truth)


def trajectory_pose_orbit(i: int, n_frames: int) -> tuple[np.ndarray, np.ndarray]:
    """Ground-truth pose for a full 360° outward-looking orbit: the camera
    circles a small ring near the room center, always facing radially
    outward, and returns exactly to its start pose at frame n_frames.

    Views sweep the entire room once, so keyframes from opposite phases of
    the circuit share no scenery — covisibility to the first keyframes decays
    to zero and the final frames form a genuine loop-closure event (the
    revisit geometry of LoopClosureWorker::DetectLoop) rather than staying
    inside one covisible cluster like the default sweep."""
    t = i / max(n_frames, 1)               # frame n_frames == frame 0
    th = 2.0 * np.pi * t
    # ring radius sets the parallax-to-content-turnover ratio r·FOV/depth
    # (independent of orbit speed): 2.6 m brings the nearest walls to
    # 1.2-1.4 m so frontier triangulations get ~2.5deg of parallax per
    # frame — enough for new-point creation to keep pace with the rotating
    # view. At r=2.0 the ratio starves the frontier and tracking dies
    # mid-circuit (rotation-dominant mono degeneracy).
    r = 2.6
    c = np.array([
        r * np.sin(th),
        -0.3 + 0.06 * np.sin(4.0 * np.pi * t),
        4.2 + r * np.cos(th),
    ], np.float32)
    yaw = th                                # camera z looks along (sin, 0, cos)
    pitch = 0.04 * np.sin(6.0 * np.pi * t)
    cy_, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    R_yaw = np.array([[cy_, 0, -sy], [0, 1, 0], [sy, 0, cy_]], np.float32)
    R_pitch = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float32)
    return (R_pitch @ R_yaw).astype(np.float32), c


def trajectory_pose_circuit(i: int, n_frames: int) -> tuple[np.ndarray, np.ndarray]:
    """Ground-truth pose for a tangent-looking rounded-rectangle circuit —
    the classic indoor loop-closure geometry (translation-dominant, camera
    facing along the direction of travel; the view revisits the start only
    when the circuit completes at frame n_frames). Counterclockwise around
    a 4x5.6 m rounded rectangle (corner radius 1.2 m) centred in the room."""
    # corner radius 1.6 keeps the turn rate at ~2.2°/frame (≈66°/s at
    # 30 fps, a realistic handheld pan) — at rc=1.2 the 3.4°/frame turn
    # (~100°/s) outran per-frame map-point creation on repetitive texture
    a, b, rc = 2.0, 2.8, 1.6           # x/z half-extents, corner radius
    cx0, cz0 = 0.0, 4.0                # room centre
    sx, sz = a - rc, b - rc            # straight-segment half-lengths
    straight_x, straight_z = 2 * sx, 2 * sz
    corner = 0.5 * np.pi * rc
    per = 2 * straight_x + 2 * straight_z + 4 * corner
    t = (i / max(n_frames, 1)) % 1.0
    s = t * per

    # segments, counterclockwise from (a, cz0 - sz) heading +z
    segs = [
        ("s", straight_z, (a, -sz), (0.0, 1.0)),
        ("c", corner, (sx, sz), 0.0),
        ("s", straight_x, (sx, b), (-1.0, 0.0)),
        ("c", corner, (-sx, sz), 0.5 * np.pi),
        ("s", straight_z, (-a, sz), (0.0, -1.0)),
        ("c", corner, (-sx, -sz), np.pi),
        ("s", straight_x, (-sx, -b), (1.0, 0.0)),
        ("c", corner, (sx, -sz), 1.5 * np.pi),
    ]
    x = z = dx = dz = 0.0
    for kind, length, p, q in segs:
        if s > length:
            s -= length
            continue
        if kind == "s":
            (x0_, z0_), (dx, dz) = p, q
            x, z = x0_ + dx * s, z0_ + dz * s
        else:
            ccx, ccz = p
            # corner turns the tangent by +90deg counterclockwise; radius
            # vector starts perpendicular-outward from the incoming tangent
            phi = q + s / rc
            x = ccx + rc * np.cos(phi)
            z = ccz + rc * np.sin(phi)
            dx, dz = -np.sin(phi), np.cos(phi)
        break
    c = np.array([cx0 + x, -0.3 + 0.05 * np.sin(6.0 * np.pi * t), cz0 + z],
                 np.float32)
    # look 57° off-tangent toward the outside of the circuit (a side-window
    # view): pure along-tangent viewing puts the translation at the focus
    # of expansion where parallax vanishes, and the 5-point initializer's
    # MaxPoseContributionZ=0.66 gate (MageSettings.h:108 — camera-z fraction
    # of the baseline) deliberately refuses any pair whose motion is within
    # ~49° of the optical axis. 57° keeps every frame pair's translation
    # clearly lateral-in-view: strong per-frame parallax on the near walls.
    yaw = np.arctan2(dx, dz) + 1.0     # forward = (sin yaw, 0, cos yaw)
    pitch = 0.03 * np.sin(8.0 * np.pi * t)
    cy_, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    R_yaw = np.array([[cy_, 0, -sy], [0, 1, 0], [sy, 0, cy_]], np.float32)
    R_pitch = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float32)
    return (R_pitch @ R_yaw).astype(np.float32), c


def trajectory_pose_fig8(i: int, n_frames: int) -> tuple[np.ndarray, np.ndarray]:
    """Ground-truth pose for a figure-8: two tangent circles (radius 1.8 m)
    through the crossing P=(0, 4.2) — lobe A below (center (0, 2.4),
    counterclockwise), lobe B above (center (0, 6.0), clockwise). The
    tangent is continuous through the crossing (both circles pass P heading
    +x), giving the classic two-distinct-loop geometry: completing lobe A
    revisits lobe A's start (closure 1), completing lobe B revisits the
    crossing region again (closure 2) — two separate loop-closure events in
    one trajectory (LoopClosureWorker re-attempt schedule;
    Tasks/LoopClosureWorker.cpp:90-208).

    The camera looks ~57° off-tangent toward the OUTSIDE of the current
    lobe (the circuit trajectory's side-window geometry — pure along-track
    viewing puts translation at the focus of expansion). Outward flips
    sides when the winding flips, so the yaw offset ramps smoothly through
    zero across each crossing instead of jumping 114°.

    The sequence STARTS at mid-lobe-A (phase 0.25): the crossing region is
    briefly along-track with the fastest pan (ramp + lobe turn ≈ 5°/frame)
    — initializing there dies (measured: 5/324 tracked starting at the
    crossing), while mid-lobe gives the full side view monocular init
    wants. Revisit structure from phase 0.25: the t=0.5 crossing pass is
    first-visit; t=1.0 revisits it (loop 1, lobe B's circuit closes);
    t=1.25 revisits the start (loop 2, lobe A's circuit) — two distinct
    closures within period + tail frames."""
    t = (i / max(n_frames, 1) + 0.25) % 1.0   # frame n_frames == frame 0
    rl = 1.8
    if t < 0.5:                            # lobe A: CCW, center (0, 2.4)
        a = 2.0 * np.pi * (2.0 * t)
        cen = np.array([0.0, 2.4], np.float32)
        x, z = cen[0] + rl * np.sin(a), cen[1] + rl * np.cos(a)
        dx, dz = np.cos(a), -np.sin(a)
        s_lobe = -1.0
    else:                                  # lobe B: CW, center (0, 6.0)
        b = np.pi - 2.0 * np.pi * (2.0 * (t - 0.5))
        cen = np.array([0.0, 6.0], np.float32)
        x, z = cen[0] + rl * np.sin(b), cen[1] + rl * np.cos(b)
        dx, dz = -np.cos(b), np.sin(b)
        s_lobe = 1.0
    # smooth off-tangent offset: full ±1 rad mid-lobe, 0 at the crossings
    # (t = 0, 0.5, 1); smoothstep over w = 11% of the cycle each side keeps
    # the peak pan rate ≈4.5°/frame at period 288 (measured: w=0.08 peaked
    # at 6.2°/frame and the ramp outran keypoint repeatability)
    d_cross = min(t, abs(t - 0.5), abs(t - 1.0))
    w = 0.11
    u = min(d_cross / w, 1.0)
    f = u * u * (3.0 - 2.0 * u)
    c = np.array([x, -0.3 + 0.05 * np.sin(6.0 * np.pi * t), z], np.float32)
    yaw = np.arctan2(dx, dz) + s_lobe * f * 1.0
    pitch = 0.03 * np.sin(8.0 * np.pi * t)
    cy_, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    R_yaw = np.array([[cy_, 0, -sy], [0, 1, 0], [sy, 0, cy_]], np.float32)
    R_pitch = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float32)
    return (R_pitch @ R_yaw).astype(np.float32), c


def trajectory_pose(i: int, n_frames: int) -> tuple[np.ndarray, np.ndarray]:
    """Ground-truth camera pose for frame i: returns (R, c) with R the
    world→camera rotation and c the camera center. A smooth exploring sweep:
    lateral figure with gentle push-in and yaw, translation-dominant (mono
    SLAM needs parallax)."""
    t = i / max(n_frames - 1, 1)
    c = np.array([
        1.1 * np.sin(2.0 * np.pi * t),
        -0.25 + 0.12 * np.sin(4.0 * np.pi * t + 1.0),
        0.55 * np.sin(2.0 * np.pi * t + np.pi / 2) + 0.4,
    ], np.float32)
    yaw = 0.16 * np.sin(2.0 * np.pi * t + np.pi)          # ±9°
    pitch = 0.05 * np.sin(4.0 * np.pi * t)
    cy_, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    R_yaw = np.array([[cy_, 0, -sy], [0, 1, 0], [sy, 0, cy_]], np.float32)
    R_pitch = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float32)
    R = (R_pitch @ R_yaw).astype(np.float32)               # world→camera
    return R, c


# --------------------------------------------------------------------------- #
# raycaster


def render_frame(
    surfaces: list[Surface],
    R: np.ndarray,
    c: np.ndarray,
    width: int = BASE_W,
    height: int = BASE_H,
    frame_index: int = 0,
    noise_sigma: float = 1.5,
    light_dir: np.ndarray | None = None,
    supersample: int = 1,
    return_depth: bool = False,
) -> np.ndarray:
    """Render one grayscale uint8 frame from world→camera pose (R, c).

    supersample=k raycasts at k× resolution and box-averages down — the
    antialiasing a real camera's optics/Bayer pipeline provides. Use ≥2 when
    rendering below ~640×480 or texture aliasing breaks descriptor
    repeatability. return_depth=True additionally returns the (H, W) f32
    ray-depth map (np.inf where no surface) — ground truth for reprojection
    harnesses (tools/repeatability.py)."""
    if supersample > 1:
        # sensor noise is applied at the SUPERSAMPLED (sensor-native)
        # resolution inside the recursive call; the box-average below then
        # attenuates it by 1/supersample — exactly what the reference's
        # software downscale (640×480 capture → 320×180 tracking,
        # MageSettings.h TrackingWidth) does to real camera noise. Adding
        # full-strength noise AFTER downsampling double-counts it: at FAST
        # threshold 4 that costs a quarter of frame-to-frame detection
        # repeatability (measured 66% → 81% keypoint recurrence at a
        # static pose).
        hi = render_frame(surfaces, R, c, width * supersample,
                          height * supersample, frame_index, noise_sigma,
                          light_dir, return_depth=return_depth)
        if return_depth:
            hi, dep = hi
        lo = hi.astype(np.float32).reshape(
            height, supersample, width, supersample).mean(axis=(1, 3))
        out = np.clip(lo, 0, 255).astype(np.uint8)
        if return_depth:
            # center-sample (not average): depth is discontinuous at
            # occlusions, averaging invents phantom surfaces
            off = supersample // 2
            return out, dep[off::supersample, off::supersample]
        return out
    sx = width / BASE_W
    sy = height / BASE_H
    fx, fy, cx, cy = FX * sx, FY * sy, CX * sx, CY * sy

    u, v_pix = np.meshgrid(np.arange(width, dtype=np.float32),
                           np.arange(height, dtype=np.float32))
    d_cam = np.stack([(u - cx) / fx, (v_pix - cy) / fy,
                      np.ones_like(u)], axis=-1).reshape(-1, 3)
    d = d_cam @ R                                # rows ⋅ R = R^T d_cam (world)

    n_px = d.shape[0]
    zbuf = np.full(n_px, np.inf, np.float32)
    shade = np.zeros(n_px, np.float32)
    if light_dir is None:
        light_dir = np.array([0.3, -0.8, 0.52], np.float32)
    light_dir = light_dir / np.linalg.norm(light_dir)
    # lighting varies over the sequence (exposure/illumination drift)
    intensity = 1.0 + 0.15 * np.sin(2.0 * np.pi * frame_index / 90.0)

    for s in surfaces:
        n = np.cross(s.eu, s.ev)
        n_hat = n / np.linalg.norm(n)
        denom = d @ n
        denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        t = ((s.p0 - c) @ n) / denom
        h = c[None, :] + t[:, None] * d
        rel = h - s.p0[None, :]
        a = (rel @ s.eu) / float(s.eu @ s.eu)
        b = (rel @ s.ev) / float(s.ev @ s.ev)
        hit = (t > 0.05) & (t < zbuf) & (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1)
        if not hit.any():
            continue
        th, tw = s.texture.shape
        ax = np.clip(a[hit] * (tw - 1), 0, tw - 1.001)
        by = np.clip(b[hit] * (th - 1), 0, th - 1.001)
        x0 = ax.astype(np.int32)
        y0 = by.astype(np.int32)
        wx = ax - x0
        wy = by - y0
        tex = s.texture
        albedo = ((1 - wy) * ((1 - wx) * tex[y0, x0] + wx * tex[y0, x0 + 1])
                  + wy * ((1 - wx) * tex[y0 + 1, x0] + wx * tex[y0 + 1, x0 + 1]))
        lambert = 0.45 + 0.55 * abs(float(n_hat @ light_dir))
        falloff = 1.0 / (1.0 + 0.012 * t[hit] ** 2)
        zbuf[hit] = t[hit]
        shade[hit] = albedo * lambert * falloff

    img = shade.reshape(height, width) * intensity
    # vignette
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    r2 = (((xx - cx) / (width / 2)) ** 2 + ((yy - cy) / (height / 2)) ** 2)
    img = img * (1.0 - 0.25 * r2)
    # sensor noise (deterministic per frame)
    nrng = np.random.default_rng(1000 + frame_index)
    img = 255.0 * np.clip(img, 0.0, 1.0) ** (1 / 1.8)
    img = img + nrng.normal(0.0, noise_sigma, img.shape)
    out = np.clip(img, 0, 255).astype(np.uint8)
    if return_depth:
        return out, zbuf.reshape(height, width)
    return out


def render_sequence(n_frames: int, width: int = BASE_W, height: int = BASE_H,
                    seed: int = 7, fps: float = 30.0,
                    supersample: int | None = None,
                    trajectory: str = "sweep",
                    period: int | None = None):
    """Yield (image uint8 (H,W), timestamp, frame_id, R, c) along the
    ground-truth trajectory ("sweep" default, "orbit" for the 360°
    loop-closure circuit). Supersampling defaults to 2× below 640-wide.

    `period` (default n_frames) sets the frame count of one full trajectory
    cycle; n_frames > period continues past the closure point — the revisit
    phase where loop-closure consolidation happens."""
    if supersample is None:
        supersample = 2 if width < BASE_W else 1
    traj = {"sweep": trajectory_pose, "orbit": trajectory_pose_orbit,
            "circuit": trajectory_pose_circuit,
            "fig8": trajectory_pose_fig8}[trajectory]
    surfaces = build_scene(
        seed, variant="default" if trajectory == "sweep" else "loop")
    for i in range(n_frames):
        R, c = traj(i, period if period is not None else n_frames)
        img = render_frame(surfaces, R, c, width, height, frame_index=i,
                           supersample=supersample)
        yield img, i / fps, i, R, c


# --------------------------------------------------------------------------- #
# TUM sequence writer


def _rot_to_quat_xyzw(R_cw: np.ndarray) -> np.ndarray:
    """camera→world rotation to TUM quaternion (qx qy qz qw)."""
    m = R_cw
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        qw = 0.25 * s
        qx = (m[2, 1] - m[1, 2]) / s
        qy = (m[0, 2] - m[2, 0]) / s
        qz = (m[1, 0] - m[0, 1]) / s
    else:
        i = int(np.argmax([m[0, 0], m[1, 1], m[2, 2]]))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1.0 + m[i, i] - m[j, j] - m[k, k], 1e-12)) * 2
        q = [0.0, 0.0, 0.0]
        q[i] = 0.25 * s
        q[j] = (m[j, i] + m[i, j]) / s
        q[k] = (m[k, i] + m[i, k]) / s
        qw = (m[k, j] - m[j, k]) / s
        qx, qy, qz = q
    return np.array([qx, qy, qz, qw])


def write_tum_sequence(out_dir: str, n_frames: int, width: int, height: int,
                       seed: int = 7, fps: float = 30.0,
                       trajectory: str = "sweep",
                       period: int | None = None) -> None:
    import cv2

    rgb_dir = os.path.join(out_dir, "rgb")
    os.makedirs(rgb_dir, exist_ok=True)
    rgb_lines = ["# color images", "# timestamp filename"]
    gt_lines = ["# ground truth trajectory", "# timestamp tx ty tz qx qy qz qw"]
    for img, ts, fid, R, c in render_sequence(n_frames, width, height, seed,
                                              fps, trajectory=trajectory,
                                              period=period):
        name = f"rgb/{ts:.6f}.png"
        cv2.imwrite(os.path.join(out_dir, name), img)
        rgb_lines.append(f"{ts:.6f} {name}")
        q = _rot_to_quat_xyzw(R.T)
        gt_lines.append(f"{ts:.6f} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f} "
                        f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}")
        if fid % 50 == 0:
            print(f"rendered {fid + 1}/{n_frames}", file=sys.stderr)
    with open(os.path.join(out_dir, "rgb.txt"), "w") as f:
        f.write("\n".join(rgb_lines) + "\n")
    with open(os.path.join(out_dir, "groundtruth.txt"), "w") as f:
        f.write("\n".join(gt_lines) + "\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("output", help="output sequence directory (TUM layout)")
    p.add_argument("--frames", type=int, default=300)
    p.add_argument("--width", type=int, default=BASE_W)
    p.add_argument("--height", type=int, default=BASE_H)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--trajectory", choices=("sweep", "orbit", "circuit",
                                            "fig8"),
                   default="sweep",
                   help="'orbit' = 360° outward-looking ring; 'circuit' = "
                        "tangent-looking rounded-rectangle loop")
    p.add_argument("--period", type=int, default=None,
                   help="frames per full trajectory cycle (default --frames); "
                        "set below --frames to continue into the revisit "
                        "phase where loop closure consolidates")
    args = p.parse_args(argv)
    write_tum_sequence(args.output, args.frames, args.width, args.height,
                       args.seed, trajectory=args.trajectory,
                       period=args.period)
    print(f"wrote {args.frames} frames -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
