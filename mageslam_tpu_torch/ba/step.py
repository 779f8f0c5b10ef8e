"""StepBundleAdjustment semantics (BundlerLib.cpp:364-446), fixed-shape
(port of mageslam_tpu/ba/step.py).

One call is one LM iteration per entry of the Huber-width schedule, then
outlier extraction: an observation is removed (its information zeroed)
when its unweighted squared pixel error exceeds max_error_square or its
point projects behind the camera (BundlerLib.cpp:388-436). Returns the mean
square error over the survivors.

The calling policy (BundleAdjustTask::IterateBundleAdjust) that shrinks the
Huber width and outlier threshold between calls is `iterate_bundle_adjust`.
"""

from __future__ import annotations

import torch

from .problem import BAProblem, BAState
from .residuals import observation_residuals
from .schur import lm_iteration


def step_bundle_adjust(problem: BAProblem, state: BAState, huber_widths,
                       max_error_square, iteration=lm_iteration):
    """huber_widths: a sequence of numbers or a (steps,) tensor, one LM
    iteration each. Returns (new_state, mean_square_error,
    newly_outlier_mask (O,) bool). Reads nothing back to the host.
    `iteration` is the LM iteration (the sharded one in
    parallel/sharded_ba.py)."""
    for hw in huber_widths:
        state = iteration(problem, state, hw).state

    obs = observation_residuals(problem, state.poses, state.points, state.obs_info, 0.0)
    sum_sq = torch.sum(obs.r * obs.r, dim=-1)            # unweighted, as errorData()
    active = state.obs_info > 0
    is_outlier = active & ((obs.depth <= 0.0) | (sum_sq > max_error_square))
    survivors = active & ~is_outlier
    mse = torch.sum(torch.where(survivors, sum_sq, 0.0)) / torch.clamp_min(
        torch.sum(survivors.to(torch.float32)), 1.0)
    new_state = state._replace(obs_info=torch.where(is_outlier, 0.0, state.obs_info))
    return new_state, mse, is_outlier


def iterate_bundle_adjust(problem: BAProblem, state: BAState, huber_width: float,
                          max_outlier_error: float, huber_width_scale: float,
                          max_outlier_error_scale: float,
                          min_mean_square_error: float, num_steps: int,
                          steps_per_run: int = 1, min_steps: int = 0, step_fn=None):
    """The BundleAdjustTask loop: call step_bundle_adjust with a
    geometrically shrinking Huber width and outlier threshold while total
    steps < num_steps and (MSE > min_mean_square_error or total steps <
    min_steps) (Tasks/MappingWorker.cpp:357-361). A host loop with one host
    read (the MSE) per run; its callers are rare paths. Returns (state, mse,
    steps_taken, cumulative_outlier_mask (O,) bool). `step_fn` swaps the
    per-call primitive, same contract as step_bundle_adjust."""
    if step_fn is None:
        step_fn = step_bundle_adjust
    active0 = state.obs_info > 0
    hw = float(huber_width)
    moe = float(max_outlier_error)
    mse = float("inf")
    steps = 0
    while steps < num_steps:
        widths = [hw * huber_width_scale ** i for i in range(steps_per_run)]
        state, mse_d, _ = step_fn(problem, state, widths, moe * moe)
        hw *= huber_width_scale ** steps_per_run
        moe *= max_outlier_error_scale ** steps_per_run
        steps += steps_per_run
        mse = float(mse_d)
        if steps >= min_steps and mse < min_mean_square_error:
            break
    outliers = active0 & ~(state.obs_info > 0)
    return state, mse, steps, outliers
