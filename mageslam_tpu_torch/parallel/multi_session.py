"""A batch of independent sessions' tracking step over a mesh (port of
mageslam_tpu/parallel/multi_session.py).

The serving shape: B cameras stream frames, and each session's map,
history and frame sit in a batch whose leading axis is split over the
mesh's devices. Sessions share nothing, so the step has no collective. The
reference vmaps one session's step and compiles it once; here each shard
runs its sessions one after another on its device, each the single step
below (one batched set of launches for B sessions is later work, ROADMAP
queue 2).

The single step keeps the reference's composition, `_single_track_step`,
which leaves `track_local_map`'s iteration counts and Huber widths at their
defaults (4 / 10 / 2.0 / 1.0) where the session's step
(runtime/track_step.py) passes its settings' (3 / 4 / 4.0 / 0.9 golden): a
divergence inside the reference, logged in ROADMAP queue 3.
"""

from __future__ import annotations

from functools import partial

from ..config import MageSlamSettings, golden_path_settings
from ..tracking.frame_state import TrackedFrame, TrackingHistory
from ..tracking.pose_estimation import estimate_next_pose_from_history, estimate_pose_with_prior
from ..tracking.track_local_map import TrackLocalMapResult, track_local_map
from ..worldmap.map_state import MapState
from . import Mesh, all_gather, on, tree_map, tree_stack


def _single_track_step(settings: MageSlamSettings, width: float, height: float,
                       map_state: MapState, history: TrackingHistory,
                       frame: TrackedFrame) -> TrackLocalMapResult:
    """One session's tracking step (mageslam_tpu/parallel/multi_session.py:
    35-71)."""
    ts = settings.TrackLocalMapSettings
    ps = settings.PoseEstimationSettings
    fes = settings.MonoSettings.MonoCamera.FeatureExtractorSettings

    prior = estimate_next_pose_from_history(history, frame.timestamp)
    frame = frame._replace(pose=prior)
    gm = estimate_pose_with_prior(
        frame, history, map_state.mp_pos, map_state.mp_valid, map_state.mp_refine_count,
        minimum_feature_matches=ps.FeatureMatchThreshold,
        search_radius=ps.SearchRadius,
        wider_search_radius=ps.WiderSearchRadius,
        extra_wider_search_radius=ps.ExtraWiderSearchRadius,
        small_match_ratio=ps.FeatureSmallMatchRatioThreshold,
        max_hamming=ps.OrbMatcherSettings.MaxHammingDistance,
        min_hamming_diff=ps.OrbMatcherSettings.MinHammingDifference,
    )
    frame = frame._replace(assoc=gm.assoc)
    res = track_local_map(
        frame, map_state, map_state.mp_valid,
        num_levels=fes.NumLevels, pyramid_scale=fes.ScaleFactor,
        image_width=width, image_height=height,
        image_border=fes.PatchSize / 2.0,
        min_degrees_view_angle=ts.MinDegreesBetweenCurrentViewAndMapPointView,
        match_search_radius=ts.MatchSearchRadius,
        max_hamming=ts.OrbMatcherSettings.MaxHammingDistance,
        min_hamming_diff=ts.OrbMatcherSettings.MinHammingDifference,
        max_outlier_error=ts.MaxOutlierError,
        max_outlier_error_pose_estimation=ts.MaxOutlierErrorPoseEstimation,
        min_tracked_features=ts.MinTrackedFeatureCount,
    )
    return res._replace(succeeded=gm.succeeded & res.succeeded)


def batched_track_step(mesh: Mesh, settings: MageSlamSettings | None = None,
                       width: float = 320.0, height: float = 180.0,
                       axis: str = "sessions"):
    """Returns (step, shard_leading). `shard_leading(tree)` splits a stacked
    tree's leading batch axis (B, a multiple of the mesh's size) into
    contiguous chunks, a list of trees, chunk s on shard s's device;
    `step(map_states, histories, frames)` takes three such and returns the
    stacked TrackLocalMapResult of every session, on the mesh's first
    device."""
    settings = settings or golden_path_settings()
    single = partial(_single_track_step, settings, width, height)
    d = mesh.size

    def shard_leading(tree) -> list:
        B = tree_leading(tree)
        if B % d:
            raise ValueError(f"batched_track_step: a batch of {B} does not split over {d}")
        n = B // d
        return [tree_map(lambda x, s=s, dev=dev: x[s * n:(s + 1) * n].to(dev), tree)
                for s, dev in enumerate(mesh.devices)]

    def step(map_states: list, histories: list, frames: list) -> TrackLocalMapResult:
        outs = []
        for dev, m, h, f in zip(mesh.devices, map_states, histories, frames):
            with on(dev):
                results = [single(tree_map(lambda x, b=b: x[b], m),
                                  tree_map(lambda x, b=b: x[b], h),
                                  tree_map(lambda x, b=b: x[b], f))
                           for b in range(tree_leading(f))]
                outs.append(tree_stack(results))
        return tree_map(lambda *xs: all_gather(list(xs), mesh), *outs)

    return step, shard_leading


def tree_leading(tree) -> int:
    """The leading axis's length of a tree's first tensor."""
    found = []
    tree_map(lambda x: found.append(x.shape[0]), tree)
    return found[0]

