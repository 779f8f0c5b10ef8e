"""The per-frame tracking step: motion prior → guided match cascade →
two-stage track-local-map (port of the reference's `_build_track_core`,
mageslam_tpu/runtime/pipeline.py:848-907)."""

from __future__ import annotations

from ..geometry.se3 import Pose
from ..tracking.frame_state import TrackedFrame, TrackingHistory
from ..tracking.pose_estimation import (estimate_next_pose_from_history,
                                        estimate_pose_with_prior)
from ..tracking.track_local_map import TrackLocalMapResult, track_local_map
from ..worldmap.map_state import MapState


def track_step(settings, width: int, height: int, map_state: MapState,
               history: TrackingHistory, frame: TrackedFrame) -> TrackLocalMapResult:
    """Track one frame against the map. `succeeded` is the guided cascade's
    and track-local-map's success together. Nothing here waits on the
    device."""
    ts = settings.TrackLocalMapSettings
    ps = settings.PoseEstimationSettings
    fes = settings.MonoSettings.MonoCamera.FeatureExtractorSettings

    prior = estimate_next_pose_from_history(history, frame.timestamp)
    frame = frame._replace(pose=Pose(prior.R, prior.t))
    gm = estimate_pose_with_prior(
        frame, history, map_state.mp_pos, map_state.mp_valid,
        map_state.mp_refine_count,
        minimum_feature_matches=ps.FeatureMatchThreshold,
        search_radius=ps.SearchRadius,
        wider_search_radius=ps.WiderSearchRadius,
        extra_wider_search_radius=ps.ExtraWiderSearchRadius,
        small_match_ratio=ps.FeatureSmallMatchRatioThreshold,
        max_hamming=ps.OrbMatcherSettings.MaxHammingDistance,
        min_hamming_diff=ps.OrbMatcherSettings.MinHammingDifference,
        min_refinement_count=ps.MinMapPointRefinementCount,
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
        min_refinement_count=ts.MinMapPointRefinementCount,
        max_outlier_error=ts.MaxOutlierError,
        max_outlier_error_pose_estimation=ts.MaxOutlierErrorPoseEstimation,
        min_tracked_features=ts.MinTrackedFeatureCount,
        stage1_iters=ts.InitialPoseEstimateBundleAdjustmentSteps,
        stage2_iters=ts.BundleAdjustmentG2OSteps,
        stage1_huber=ts.InitialPoseEstimateBundleAdjustmentHuberWidth,
        stage2_huber=ts.BundleAdjustmentHuberWidth,
    )
    return res._replace(succeeded=gm.succeeded & res.succeeded)
