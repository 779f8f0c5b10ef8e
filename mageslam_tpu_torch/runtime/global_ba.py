"""Whole-map bundle adjustment (port of the reference's `_global_ba`,
mageslam_tpu/runtime/pipeline.py:2297-2358): loop closure and `fossilize`
both run it.

The global window covers every live keyframe and point, its caps clamped
to the live bank capacity; `iterate_bundle_adjust` runs the BundleAdjustTask
schedule (the Huber width and the outlier threshold shrink between runs,
and the loop stops once the MSE reaches MinMeanSquareError after
MinSteps, Tasks/MappingWorker.cpp:357-361), and `apply_ba_results` writes
back. The host reads the live tether count once (a map without a live
tether runs without the tether bank, as the mapping step does) and the MSE
once a run. `step_fn` is the per-run step: the dense
ba/step.step_bundle_adjust by default, or the point-sharded one
(parallel/sharded_ba.py) that the session chooses where it has several
devices (SlamSession._global_ba_step_fn, pipeline.py:2264-2295).
"""

from __future__ import annotations

import torch

from ..ba.problem import BAState, without_tethers
from ..ba.step import iterate_bundle_adjust
from ..worldmap.ba_window import apply_ba_results, build_local_ba_window
from ..worldmap.map_state import MapState


def global_ba(settings, map_state: MapState, ki: int, steps: int, huber: float = 0.9,
              max_outlier_error: float = 4.0, bas=None, capture=None, step_fn=None):
    """Returns (map_state, mse as a float). `bas` gives the schedule's
    constants (default: settings.BundleAdjustSettings). `capture`, where
    given, is called with the reference's xray inputs and outputs
    (pipeline.py:2351-2356)."""
    b = settings.Budgets
    fes = settings.MonoSettings.MonoCamera.FeatureExtractorSettings
    if bas is None:
        bas = settings.BundleAdjustSettings
    K, P, N = map_state.capacity
    window = build_local_ba_window(
        map_state, torch.tensor(ki, dtype=torch.int32, device=map_state.kf_valid.device),
        max_cams=min(b.MaxKeyframes, K), max_points=min(b.MaxMapPoints, P),
        max_obs=min(b.MaxGlobalBaObservations, K * N), global_window=True)
    problem = window.problem
    if not bool(torch.any(problem.tether_weight > 0)):
        problem = without_tethers(problem)
    st, mse, _, outliers = iterate_bundle_adjust(
        problem, BAState.from_problem(problem), huber, max_outlier_error,
        huber_width_scale=bas.HuberWidthScale,
        max_outlier_error_scale=bas.MaxOutlierErrorScaleFactor,
        min_mean_square_error=bas.MinMeanSquareError, num_steps=steps,
        steps_per_run=max(bas.NumStepsPerRun, 1), min_steps=bas.MinSteps, step_fn=step_fn)
    new_map = apply_ba_results(map_state, window, st.poses, st.points, outliers,
                               fes.NumLevels, fes.ScaleFactor)
    if capture is not None:
        capture({"poses_in": map_state.kf_pose, "points_in": map_state.mp_pos,
                 "obs_kf": window.obs_kf, "pt_slot": window.pt_slot},
                {"poses_out": new_map.kf_pose, "points_out": new_map.mp_pos,
                 "outliers": outliers, "mse": mse})
    return new_map, mse
