"""The mapping schedule of one keyframe (port of `_build_mapping_core`,
mageslam_tpu/runtime/pipeline.py:1908-2174; MappingWorker::MappingTask,
Tasks/MappingWorker.cpp:148-316):

  cheap loop-closure match → insert → cull recent points → create new
  points → local BA → cull keyframes → pose-history rebase.

The reference compiles the schedule into one dispatch and picks the BA tier
with a device-side conditional. Here it runs eagerly and reads the device
once: the three counts that choose the BA tier come back together with the
keyframe's slot, so only the taken tier is computed and a full keyframe
bank returns the map untouched. The same read says whether the map holds
a live tether: a mono map holds none, and local BA then runs without the
tether bank, whose forward-mode Jacobians cost more host time than the rest
of the event. The read's keyframe and point counts go back to the caller,
which arms bank growth by them. With the session's mapping offload
(`SlamSession.enable_mapping_offload`), `mapping_body` runs on a worker
thread and a second CUDA stream, and its one read blocks that thread only.
"""

from __future__ import annotations

import math

import torch

from ..ba.problem import BAState, without_tethers
from ..ba.step import step_bundle_adjust
from ..ops.indexing import any_drop, set_drop
from ..ops.matching import radius_match
from ..tracking.frame_state import TrackedFrame
from ..worldmap.ba_window import apply_ba_results, build_local_ba_window
from ..worldmap.covisibility import covisibility_matrix
from ..worldmap.map_state import MapState, predict_octave, refresh_point_stats_slots
from ..worldmap.member_index import build_fidx
from ..worldmap.new_points import create_new_map_points
from ..worldmap.operations import (cull_local_keyframes, cull_recent_map_points,
                                   insert_keyframe)
from .pose_history import PoseHistory

# the stages `probe` is called after, in order
STAGES = ("loop_closure_match", "insert_fidx", "cull_recent", "covisibility",
          "new_points", "stats_refresh", "window_build", "lm", "write_back",
          "keyframe_cull", "rebase")


def cheap_loop_closure(settings, width: int, height: int, map_state: MapState,
                       frame: TrackedFrame) -> TrackedFrame:
    """Extra associations against the whole point bank at the wide
    loop-closure radius, before insertion (MappingWorker.cpp:20-73):
    reconnects points that tracking discarded. One radius match with the
    bank's P points as queries and the frame's N features as targets."""
    fes = settings.MonoSettings.MonoCamera.FeatureExtractorSettings
    lc = settings.LoopClosureSettings
    ts = settings.TrackLocalMapSettings
    P = map_state.mp_valid.shape[0]
    N = frame.kp_xy.shape[0]
    dev = frame.kp_xy.device

    a_ok = (frame.assoc >= 0) & frame.kp_valid
    already = any_drop(P, torch.where(a_ok, frame.assoc, 0), a_ok)
    cand = map_state.mp_valid & ~already

    Xc = frame.pose.transform(map_state.mp_pos)
    z = Xc[:, 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-12, 1e-12, z)
    u = frame.cam[0] * Xc[:, 0] * inv_z + frame.cam[2]
    v = frame.cam[1] * Xc[:, 1] * inv_z + frame.cam[3]
    border = fes.PatchSize / 2.0 - lc.MatchSearchRadius / 2.0
    in_b = (u >= border) & (u < width - border) & (v >= border) & (v < height - border)
    angle_ok = torch.einsum("pi,i->p", map_state.mp_mean_dir, frame.pose.forward()) \
        >= math.cos(math.radians(ts.MinDegreesBetweenCurrentViewAndMapPointView))
    dist = torch.linalg.norm(map_state.mp_pos - frame.pose.center()[None], dim=-1)
    range_ok = (dist >= map_state.mp_dmin) & (dist <= map_state.mp_dmax)
    octv = predict_octave(dist, map_state.mp_dmin, fes.ScaleFactor)
    good = (cand & (z > 0) & in_b & angle_ok & range_ok
            & (octv >= 0) & (octv <= fes.NumLevels))

    unassoc = frame.kp_valid & (frame.assoc < 0)
    m_idx, _ = radius_match(
        map_state.mp_desc, torch.stack([u, v], dim=-1),
        torch.clamp(octv, 0, fes.NumLevels - 1), good,
        frame.desc, frame.kp_xy, frame.kp_octave, unassoc,
        float(lc.MatchSearchRadius),
        lc.CheapLoopClosureMatchingSettings.MaxHammingDistance,
        lc.CheapLoopClosureMatchingSettings.MinHammingDifference)
    hit = m_idx >= 0
    # distinct targets after the dedup: one writer a feature
    new_assoc = set_drop(frame.assoc, torch.where(hit, m_idx, N),
                         torch.where(hit, torch.arange(P, dtype=torch.int32, device=dev), -1))
    return frame._replace(assoc=new_assoc)


def ba_tiers(settings, capacity) -> tuple[tuple[int, int, int], tuple[int, int, int]]:
    """(small, full) padded BA capacities (cameras, points, observations) for
    a map of `capacity` (K, P, N). The full tier is sized for mature maps;
    while the whole map fits the small tier, the full one is padding."""
    b = settings.Budgets
    K, P, N = capacity
    full = (min(b.MaxBaCameras, K), min(b.MaxBaPoints, P),
            min(b.MaxBaObservations, K * N))
    small = (min(16, full[0]), min(1024, full[1]), min(2048, full[2]))
    return small, full


def mapping_body(settings, width: int, height: int, map_state: MapState,
                 frame: TrackedFrame, map_scale, probe=None):
    """The schedule without the pose-history rebase. Returns (map_state,
    ki, culled (K,) bool, old_poses, live): `ki` is the new keyframe's slot
    as a Python int, -1 when the keyframe bank is full, and then the map is
    the one passed in. `live` is the (keyframes, points) count of the map
    before local BA, as Python ints: BA and the culls only remove, so it
    bounds the returned map's counts from above. `probe(stage)`, if given,
    is called after each of STAGES but the last."""
    fes = settings.MonoSettings.MonoCamera.FeatureExtractorSettings
    cs = settings.CovisibilitySettings
    ms = settings.MappingSettings
    ts = settings.TrackLocalMapSettings
    bas = settings.BundleAdjustSettings
    ks = settings.KeyframeSettings
    lc = settings.LoopClosureSettings
    nps = ms.NewMapPointsCreationSettings
    per_cam = settings.MonoSettings.MonoCamera
    dev = map_state.kf_valid.device
    probe = probe or (lambda stage: None)

    state0 = map_state
    n_kf = torch.sum(map_state.kf_valid.to(torch.int32))
    closed = cheap_loop_closure(settings, width, height, map_state, frame)
    frame = frame._replace(
        assoc=torch.where(n_kf >= lc.MinKeyframe, closed.assoc, frame.assoc))
    probe("loop_closure_match")

    # frame.cam, not the session's: a keyframe carries its own camera's
    # intrinsics
    map_state, ki = insert_keyframe(
        map_state, frame.pose, frame.cam, frame.frame_id, frame.kp_xy,
        frame.kp_octave, frame.desc, frame.kp_valid, frame.assoc)
    ki_s = torch.where(ki >= 0, ki, 0)

    # one feature-index membership build for the whole schedule, updated
    # at each mutation; it becomes the kf_member cache at the end
    fidx = build_fidx(map_state)
    probe("insert_fidx")

    # recent map point culling (the found / predicted 25 % rule)
    fp_ratio = (map_state.mp_found.to(torch.float32) + 1.0) / (
        map_state.mp_predicted.to(torch.float32) + 1.0)
    failed = map_state.mp_valid & (fp_ratio < ts.RecentMapPointPctSuccess)
    map_state, fidx = cull_recent_map_points(
        map_state, ki_s, failed,
        min_keyframes_for_culling=ms.MinNumKeyframesForMapPointCulling, fidx=fidx)
    probe("cull_recent")

    covis = covisibility_matrix(map_state, fidx >= 0)
    probe("covisibility")
    npr = create_new_map_points(
        map_state, ki_s, covis, map_scale,
        num_levels=fes.NumLevels, pyramid_scale=fes.ScaleFactor,
        image_width=width, image_height=height,
        image_border=fes.PatchSize / 2.0,
        max_frames=nps.MaxFramesForNewPointsCreation,
        covis_theta=cs.CovisMinThreshold,
        max_epipolar_error=nps.MaxEpipolarError,
        min_distance_ratio=nps.MinAcceptedDistanceRatio,
        min_parallax_degrees=nps.MinParallaxDegrees,
        min_kf_distance_sq=nps.MinKeyframeDistanceForCreatingMapPointsSquared,
        grid_w=per_cam.NewPointGridWidth, grid_h=per_cam.NewPointGridHeight,
        max_grid_count=per_cam.NewPointMaxGridCount,
        max_hamming=nps.InitialMatcherSettings.MaxHammingDistance,
        min_hamming_diff=nps.InitialMatcherSettings.MinHammingDifference,
        search_radius=nps.NewMapPointsSearchRadius,
        max_keyframe_angle_degrees=nps.MaxKeyframeAngleDegrees,
        fidx=fidx)
    fidx = npr.fidx
    probe("new_points")
    # statistics of the created slots only; a just-created point has at most
    # 2 + MaxFramesForNewPointsCreation observers, hence max_obs_kf = 8
    map_state = refresh_point_stats_slots(
        npr.state, npr.slots, fes.NumLevels, fes.ScaleFactor, max_obs_kf=8, fidx=fidx)
    probe("stats_refresh")

    # the one host read: the new keyframe's slot, the three counts that
    # choose the BA tier (the reference's lax.cond gate: the whole map fits
    # the small tier, so the window does) and the number of live tethers
    small_caps, full_caps = ba_tiers(settings, map_state.capacity)
    n_obs_v = torch.sum(((map_state.kf_assoc >= 0) & map_state.kf_kp_valid
                         & map_state.kf_valid[:, None]).to(torch.int32))
    ki_host, n_kf_v, n_mp_v, n_obs_v, n_tethers = torch.stack([
        ki.to(torch.int32), torch.sum(map_state.kf_valid.to(torch.int32)),
        torch.sum(map_state.mp_valid.to(torch.int32)), n_obs_v,
        torch.sum((map_state.tether_weight > 0).to(torch.int32))]).tolist()
    if ki_host < 0:   # keyframe bank full: the whole step is a no-op
        return state0, -1, torch.zeros_like(state0.kf_valid), state0.kf_pose, (n_kf_v, n_mp_v)
    fits_small = (n_kf_v <= small_caps[0] and n_mp_v <= small_caps[1]
                  and n_obs_v <= small_caps[2])
    max_cams, max_points, max_obs = small_caps if fits_small else full_caps

    # local BA: at least 4 batched LM iterations a keyframe (golden
    # NumSteps = 1 assumes g2o's inner lambda-retry loop)
    n_steps = max(bas.NumSteps, 4)
    widths = bas.HuberWidth * (
        torch.tensor(bas.HuberWidthScale, dtype=torch.float32, device=dev)
        ** torch.arange(n_steps, dtype=torch.float32, device=dev))
    window = build_local_ba_window(
        map_state, ki_s, max_cams=max_cams, max_points=max_points, max_obs=max_obs,
        theta0=cs.CovisMinThreshold, upper_connections=cs.UpperConnectionsForBA,
        lower_connections=cs.LowerConnectionsForBA, theta_min=cs.CovisMinThreshold,
        theta_step=cs.CovisBaStepThreshold, theta_max_steps=cs.MaxSteps,
        member=fidx >= 0)
    problem = window.problem if n_tethers else without_tethers(window.problem)
    probe("window_build")
    st, _, outliers = step_bundle_adjust(
        problem, BAState.from_problem(problem), widths, float(bas.MaxOutlierError) ** 2)
    probe("lm")
    map_state, fidx = apply_ba_results(map_state, window, st.poses, st.points,
                                       outliers, fes.NumLevels, fes.ScaleFactor,
                                       fidx=fidx)
    probe("write_back")

    # keyframe culling (a no-op when nothing is redundant)
    covis2 = covisibility_matrix(map_state, fidx >= 0)
    old_poses = map_state.kf_pose
    map_state, culled, fidx = cull_local_keyframes(
        map_state, ki_s, covis2, fes.NumLevels,
        covis_theta=cs.CovisMinThreshold,
        max_tracking_point_overlap=ks.MappingMaxTrackingPointOverlap,
        min_keyframe_covis_count=ks.MinimumKeyframeCovisibilityCount, fidx=fidx)
    # the maintained index is the membership cache
    map_state = map_state._replace(kf_member=fidx >= 0)
    probe("keyframe_cull")
    return map_state, ki_host, culled, old_poses, (n_kf_v, n_mp_v)


def mapping(settings, width: int, height: int, map_state: MapState,
            pose_history: PoseHistory, frame: TrackedFrame, map_scale, probe=None):
    """Map one keyframe. Returns (map_state, pose_history, ki, live): the
    new keyframe's slot as a Python int, -1 (and nothing changed) when the
    keyframe bank is full; `live` as `mapping_body` gives it."""
    new_state, ki, culled, old_poses, live = mapping_body(
        settings, width, height, map_state, frame, map_scale, probe)
    if ki < 0:
        return map_state, pose_history, ki, live
    pose_history = pose_history.rebase(
        old_poses, culled, torch.tensor(ki, device=culled.device), new_state.kf_pose)
    if probe is not None:
        probe("rebase")
    return new_state, pose_history, ki, live
