"""Place-recognition precision and recall at scale for the flat online
bag-of-words (port of mageslam_tpu/apps/bow_eval.py).

The rebuild replaces the reference's vocabulary tree
(OnlineBow::CreateVocabularyTree / QueryUnknownImage,
BoW/OnlineBow.cpp:153-255, 454-587) by a flat 64-word k-medoid vocabulary
(bow/vocab.py). This harness measures it where a flat histogram is most
likely to lose the tree's discrimination: a large map over several areas.

Map: the photoreal room rendered under several texture seeds (visually
distinct "rooms"), each with a full outward-looking orbit of keyframes
(>= 200 keyframes in all at the defaults). Queries are held-out views at
half-step orbit phases, never indexed. A candidate is correct if it lies in
the query's room within ±tol views of its phase. Metrics:

  top1        precision of the best-scoring keyframe
  p_at_4      precision among the top MaxRelocQueryResults = 4 candidates
  qual_recall share of queries whose qualifying set (score >= 0.75 · max)
              holds a correct keyframe
  cross_room  share of queries whose top-1 lies in another room

Two vocabularies are trained: from every 7th keyframe over all rooms
(`all_rooms_vocab`, N = 30 · 512 descriptors at the defaults) and from
every 2nd keyframe of room 0 (`room0_vocab`, N = 35 · 512). Each starts
from its pool's Gumbel draws (`draws`, a dict by vocabulary name; the JAX
package takes them from `jax.random.gumbel(PRNGKey(0), (N,))`, which the
fixture tests/data/torch_port_diag.npz holds). Without `draws` the port's
own generator (seed 0) draws them.

`view_jobs` lists the views, `render_view` renders one (numpy, so the
views can be rendered in other processes and handed in as `images`),
`render_views` renders and analyzes them, `evaluate` trains, indexes and
queries; `run_bow_scale_eval` is both. Runs on the card unless
`device="cpu"`.

Usage: python -m mageslam_tpu_torch.apps.bow_eval [--views 70] [--words 64]
"""

from __future__ import annotations

import argparse
import functools
import sys
import time

import numpy as np
import torch

from ..bow.index import add_keyframe, compute_idf, empty_index, query_keyframes
from ..bow.vocab import train_vocabulary
from ..config import golden_path_settings
from ..geometry.camera import make_pinhole
from ..interop import resolve_device
from ..ops.frontend import detect_and_compute
from ..runtime.draws import GeneratorDraws
from .render_scene import CX, CY, FX, FY, build_scene, render_frame, trajectory_pose_orbit

MAX_FEATURES = 512
TOP = 4          # MaxRelocQueryResults


def view_jobs(views_per_room: int = 70, query_stride: int = 6,
              seeds=(7, 21, 42)) -> list[tuple[int, int, float]]:
    """Every view in the reference's order, as (room, seed, orbit phase):
    a room's keyframe views at whole phases, then its queries at halves."""
    jobs = []
    for room, seed in enumerate(seeds):
        jobs += [(room, seed, float(i)) for i in range(views_per_room)]
        jobs += [(room, seed, i + 0.5) for i in range(0, views_per_room, query_stride)]
    return jobs


@functools.lru_cache(maxsize=4)
def _scene(seed: int):
    return build_scene(seed, variant="loop")


def render_view(seed: int, phase: float, views_per_room: int = 70, width: int = 320,
                height: int = 180) -> np.ndarray:
    """One view of the room of `seed` at orbit `phase`, uint8 (height, width)."""
    R, c = trajectory_pose_orbit(phase, views_per_room)
    return render_frame(_scene(seed), R, c, width, height, frame_index=int(phase * 7) % 97,
                        supersample=2)


def render_views(views_per_room: int = 70, width: int = 320, height: int = 180,
                 query_stride: int = 6, seeds=(7, 21, 42), device="cuda",
                 verbose: bool = True, images=None):
    """Render (or take from `images`, one a `view_jobs` entry) and analyze
    every keyframe view and query of the rooms. Returns (kf_desc (K, 512, 8)
    int32, kf_valid (K, 512) bool, queries: list of (room, phase, desc
    (512, 8), valid (512,))), tensors on `device`."""
    device = resolve_device(device)
    t0 = time.time()
    fes = golden_path_settings().MonoSettings.MonoCamera.FeatureExtractorSettings
    sx, sy = width / 640.0, height / 480.0
    # the reference's float32 intrinsics
    cam = make_pinhole(*(float(v) for v in np.float32([FX * sx, FY * sy, CX * sx, CY * sy])),
                       width, height, device=device)
    jobs = view_jobs(views_per_room, query_stride, seeds)
    kf_desc, kf_valid, queries = [], [], []
    for j, (room, seed, phase) in enumerate(jobs):
        img = (images[j] if images is not None else
               render_view(seed, phase, views_per_room, width, height))
        f = detect_and_compute(torch.from_numpy(np.asarray(img)).to(device), cam, fes,
                               max_features=MAX_FEATURES)
        if phase == int(phase):
            kf_desc.append(f.desc)
            kf_valid.append(f.valid)
        else:
            queries.append((room, phase, f.desc, f.valid))
        if verbose and (j + 1 == len(jobs) or jobs[j + 1][0] != room):
            print(f"room {room} (seed {seed}): {views_per_room} keyframes + "
                  f"{len(range(0, views_per_room, query_stride))} queries analyzed "
                  f"({time.time() - t0:.0f}s)", file=sys.stderr, flush=True)
    return torch.stack(kf_desc), torch.stack(kf_valid), queries


def vocabulary_pools(kf_desc: torch.Tensor, kf_valid: torch.Tensor,
                     views_per_room: int) -> dict:
    """The two training pools by vocabulary name: (desc (N, 8), valid (N,))."""
    return {
        "all_rooms_vocab": (kf_desc[::7].reshape(-1, 8), kf_valid[::7].reshape(-1)),
        "room0_vocab": (kf_desc[:views_per_room:2].reshape(-1, 8),
                        kf_valid[:views_per_room:2].reshape(-1)),
    }


def evaluate(kf_desc: torch.Tensor, kf_valid: torch.Tensor, queries, views_per_room: int,
             num_words: int = 64, tol: int = 5, draws: dict | None = None,
             verbose: bool = True) -> dict:
    """Train both vocabularies, index every keyframe and score the queries.
    Returns {vocabulary: {"top1", "p_at_4", "qual_recall", "cross_room",
    "top4": (Q, 4) int keyframe ids}} plus "keyframes" and "queries"."""
    t0 = time.time()
    device = kf_desc.device
    K = kf_desc.shape[0]
    results = {}
    for name, (pd, pv) in vocabulary_pools(kf_desc, kf_valid, views_per_room).items():
        g = (torch.as_tensor(np.asarray(draws[name]), dtype=torch.float32, device=device)
             if draws is not None else GeneratorDraws(0, device).gumbel("vocab", (pd.shape[0],)))
        idx = empty_index(K, num_words=num_words, device=device)
        anchors = train_vocabulary(pd, pv, g, num_words=num_words)
        idx = idx._replace(anchors=anchors, trained=torch.ones_like(idx.trained))
        idx = compute_idf(idx, pd, pv)
        for k in range(K):
            idx = add_keyframe(idx, k, kf_desc[k], kf_valid[k])

        def correct(k, room, phase):
            r, i = divmod(int(k), views_per_room)
            dphase = abs(i - phase)
            dphase = min(dphase, views_per_room - dphase)      # circular
            return r == room and dphase <= tol

        top1 = p4 = qual_rec = cross = 0
        top4 = []
        for room, phase, d, v in queries:
            scores, qualified = query_keyframes(idx, d, v)
            order = np.argsort(-scores.cpu().numpy())
            top1 += correct(order[0], room, phase)
            cross += (order[0] // views_per_room) != room
            p4 += np.mean([correct(k, room, phase) for k in order[:TOP]])
            qual = np.where(qualified.cpu().numpy())[0]
            qual_rec += any(correct(k, room, phase) for k in qual)
            top4.append(order[:TOP])
        nq = len(queries)
        results[name] = {"top1": top1 / nq, "p_at_4": p4 / nq,
                         "qual_recall": qual_rec / nq, "cross_room": cross / nq,
                         "top4": np.asarray(top4, np.int64)}
        if verbose:
            shown = {k: v for k, v in results[name].items() if k != "top4"}
            print(f"{name}: {shown} ({time.time() - t0:.0f}s)", file=sys.stderr, flush=True)
    results["keyframes"] = K
    results["queries"] = len(queries)
    return results


def run_bow_scale_eval(views_per_room: int = 70, width: int = 320, height: int = 180,
                       num_words: int = 64, query_stride: int = 6, tol: int = 5,
                       seeds=(7, 21, 42), verbose: bool = True, device="cuda",
                       draws: dict | None = None, images=None) -> dict:
    """`render_views` then `evaluate`; adds "elapsed_s"."""
    t0 = time.time()
    kf_desc, kf_valid, queries = render_views(views_per_room, width, height, query_stride,
                                              seeds, device, verbose, images)
    results = evaluate(kf_desc, kf_valid, queries, views_per_room, num_words, tol, draws,
                       verbose)
    results["elapsed_s"] = time.time() - t0
    return results


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--views", type=int, default=70)
    p.add_argument("--words", type=int, default=64)
    p.add_argument("--stride", type=int, default=6)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    r = run_bow_scale_eval(views_per_room=args.views, num_words=args.words,
                           query_stride=args.stride, device=args.device)
    print({k: ({m: x for m, x in v.items() if m != "top4"} if isinstance(v, dict) else v)
           for k, v in r.items()})


if __name__ == "__main__":
    main()
