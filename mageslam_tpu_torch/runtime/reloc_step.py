"""The lost-tracking recovery step (port of the reference's
`_build_reloc_core`, mageslam_tpu/runtime/pipeline.py:1835-1885;
PoseEstimationWorker's relocalization path and TrackLocalMap,
Tasks/PoseEstimationWorker.cpp:39-99):

  bag-of-words query → top-C qualified keyframes → relocalize →
  track-local-map from the relocalized pose.

Nothing here reads the device back to the host.
"""

from __future__ import annotations

import torch

from ..bow.index import BowIndex, query_keyframes
from ..tracking.frame_state import TrackedFrame
from ..tracking.relocalization import relocalize
from ..tracking.track_local_map import TrackLocalMapResult, track_local_map
from ..worldmap.map_state import MapState


def reloc_kwargs(settings) -> dict:
    """`relocalize`'s gates from the RelocalizationSettings."""
    rs = settings.RelocalizationSettings
    return dict(
        min_brute_force=rs.MinBruteForceCorrespondences,
        min_radius_matches=rs.MinRadiusMatchCorrespondences,
        ransac_inlier_pct=rs.RansacInliersPctRequired,
        ba_inlier_pct=rs.BundleAdjustInliersPctRequired,
        max_pnp_error=rs.MaxBundlePnPReprojectionError,
        max_ba_error=rs.MaxBundleAdjustReprojectionError,
        ba_iterations=rs.BundleAdjustIterations,
        search_radius=rs.SearchRadius,
        max_hamming=rs.OrbMatcherSettings.MaxHammingDistance,
        min_hamming_diff=rs.OrbMatcherSettings.MinHammingDifference,
    )


def reloc_candidates(settings, map_state: MapState, bow: BowIndex,
                     frame: TrackedFrame):
    """(slots (C,) int32, ok (C,) bool): the C best-scoring qualified
    keyframes, in the order of a stable sort of the masked scores."""
    C = settings.MappingSettings.MaxRelocQueryResults
    scores, qualified = query_keyframes(
        bow, frame.desc, frame.kp_valid,
        qualifying_score=settings.BagOfWordsSettings.QualifyingCandidateScore)
    ranked = torch.sort(-torch.where(qualified, scores, -1.0), stable=True).indices
    cand = ranked[:C]
    return cand.to(torch.int32), qualified[cand] & map_state.kf_valid[cand]


def reloc_step(settings, width: int, height: int, map_state: MapState, bow: BowIndex,
               frame: TrackedFrame, draws: torch.Tensor) -> TrackLocalMapResult:
    """Relocalize one frame against the map. draws (C, H, N) are the
    candidates' PnP hypotheses. `succeeded` is relocalization's and
    track-local-map's success together."""
    ts = settings.TrackLocalMapSettings
    fes = settings.MonoSettings.MonoCamera.FeatureExtractorSettings
    cand, cand_ok = reloc_candidates(settings, map_state, bow, frame)
    r = relocalize(frame, map_state, cand, cand_ok, draws, **reloc_kwargs(settings))
    frame = frame._replace(pose=r.pose, assoc=r.assoc)
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
    return res._replace(succeeded=r.succeeded & res.succeeded)
