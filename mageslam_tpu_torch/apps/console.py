"""Console golden path: capture / video / TUM sequence → trajectory CSV (port
of mageslam_tpu/apps/console.py; Apps/Console/console.cpp).

Feeds grayscale frames through `SlamSession.process_frame` one at a time,
then fossilizes and writes a CSV of 4×4 world matrices for the visualizer,
in the reference's exact format (`write_pose_csv`). Inputs:

  - an .mgts capture (io/capture.py; read by the native prefetching loader
    where native/libframe_loader.so is built, by `CaptureReader` otherwise)
  - a video file (cv2.VideoCapture)
  - a TUM RGB-D sequence directory (rgb.txt timestamps)

Video and TUM input need OpenCV (cv2); a capture does not. The session runs
on the card unless `--device cpu` is given.

Usage: python -m mageslam_tpu_torch.apps.console INPUT -o out.csv [--settings s.json]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def iter_capture(path: str, width: int, height: int):
    from ..io.native_loader import NativeFrameLoader, native_available

    if native_available():
        loader = NativeFrameLoader(path, width, height)
        yield from loader.frames()
        loader.close()
        return
    from ..io.capture import CaptureReader

    with CaptureReader(path) as r:
        for px, ts, fid in r.frames():
            yield _resize(px, width, height), ts, fid


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise SystemExit("video and TUM input need OpenCV (cv2), which is not installed; "
                         "an .mgts capture does not") from e
    return cv2


def iter_video(path: str, width: int, height: int):
    cv2 = _cv2()
    cap = cv2.VideoCapture(path)
    fid = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        gray = cv2.resize(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY), (width, height))
        # synthetic 33 ms timestamps, like console.cpp:327
        yield gray, fid * (1.0 / 30.0), fid
        fid += 1
    cap.release()


def iter_tum(directory: str, width: int, height: int):
    cv2 = _cv2()
    fid = 0
    with open(os.path.join(directory, "rgb.txt")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts_str, rel = line.split()[:2]
            img = cv2.imread(os.path.join(directory, rel), cv2.IMREAD_GRAYSCALE)
            if img is None:
                continue
            yield cv2.resize(img, (width, height)), float(ts_str), fid
            fid += 1


def _resize(px: np.ndarray, w: int, h: int) -> np.ndarray:
    if px.shape == (h, w):
        return px
    ys = (np.arange(h) * px.shape[0] / h).astype(np.int32)
    xs = (np.arange(w) * px.shape[1] / w).astype(np.int32)
    return px[ys][:, xs]


def write_pose_csv(path: str, frame_ids, mats, timestamps=None) -> None:
    """4×4 world matrices as CSV rows (console.cpp:15-54 writes the inverse
    view, the world matrix, row-major)."""
    with open(path, "w") as f:
        for i, fid in enumerate(frame_ids):
            world = np.linalg.inv(mats[i])
            row = [str(fid)] + [f"{v:.9g}" for v in world.reshape(-1)]
            if timestamps is not None:
                row.insert(1, f"{timestamps[i]:.9f}")
            f.write(",".join(row) + "\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("input", help=".mgts capture, video file, or TUM directory")
    p.add_argument("-o", "--output", default="trajectory.csv")
    p.add_argument("--settings", default=None, help="settings JSON")
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=180)
    p.add_argument("--fx", type=float, default=None)
    p.add_argument("--fy", type=float, default=None)
    p.add_argument("--cx", type=float, default=None)
    p.add_argument("--cy", type=float, default=None)
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--global-ba-steps", type=int, default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--draws", default=None,
                   help="replay the random draws stored in this .npz "
                        "(tools/export_jax_state.py) in place of the generator's")
    args = p.parse_args(argv)

    from ..config import golden_path_settings, load_settings
    from ..runtime import SlamSession, TrackingState
    from ..runtime.draws import ReplayDraws

    settings = load_settings(args.settings) if args.settings else golden_path_settings()
    # camera defaults: TUM fr1 intrinsics scaled to the tracking resolution
    sx, sy = args.width / 640.0, args.height / 480.0
    cam = np.array([args.fx if args.fx is not None else 517.3 * sx,
                    args.fy if args.fy is not None else 516.5 * sy,
                    args.cx if args.cx is not None else 318.6 * sx,
                    args.cy if args.cy is not None else 255.3 * sy], np.float32)

    if os.path.isdir(args.input):
        frames = iter_tum(args.input, args.width, args.height)
    elif args.input.endswith(".mgts"):
        frames = iter_capture(args.input, args.width, args.height)
    else:
        frames = iter_video(args.input, args.width, args.height)

    draws = ReplayDraws.from_npz(args.draws, args.device) if args.draws else None
    sess = SlamSession(settings, cam=cam, image_width=args.width, image_height=args.height,
                       device=args.device, draws=draws)
    t0 = time.perf_counter()
    n = tracked = 0
    ts_by_id = {}
    for px, ts, fid in frames:
        ts_by_id[fid] = ts
        r = sess.process_frame(px, ts, fid)
        tracked += r.state == TrackingState.TRACKING
        n += 1
        if args.max_frames and n >= args.max_frames:
            break
    elapsed = time.perf_counter() - t0

    ids, mats = sess.fossilize(args.global_ba_steps)
    write_pose_csv(args.output, ids, mats, [ts_by_id.get(int(i), 0.0) for i in ids])
    print(f"frames={n} tracked={tracked} fps={n / max(elapsed, 1e-9):.1f} "
          f"poses={len(ids)} -> {args.output}")
    return 0 if tracked > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
