"""Covisibility as dense masked matrix operations (port of
mageslam_tpu/worldmap/covisibility.py).

The (K, K) shared-observation count matrix is one product of the membership
matrix with its transpose. The reference takes it in int8 with an int32
accumulator on the TPU's matrix unit; here it is a float32 `torch.matmul`
with TF32 off (the package turns it off at import). The operands are 0 / 1
and a count is at most the point capacity (8192 < 2^24), so every partial
sum is an integer that float32 holds exactly, in any summation order.
"""

from __future__ import annotations

import torch

from .map_state import MapState, point_keyframe_matrix


def membership_matrix(state: MapState) -> torch.Tensor:
    """(K, P) bool: keyframe k observes point p."""
    return point_keyframe_matrix(state)


def covisibility_matrix(state: MapState, member: torch.Tensor | None = None):
    """(K, K) int32 shared-map-point counts. The diagonal is zero; invalid
    keyframes have zero rows and columns."""
    m = member if member is not None else membership_matrix(state)
    mf = m.to(torch.float32)
    counts = torch.matmul(mf, mf.T).to(torch.int32)
    K = counts.shape[0]
    counts = counts * (1 - torch.eye(K, dtype=torch.int32, device=counts.device))
    valid = state.kf_valid.to(torch.int32)
    return counts * valid[:, None] * valid[None, :]


def connected_keyframes(covis, kf_idx, theta) -> torch.Tensor:
    """(K,) bool: keyframes sharing at least theta map points with kf_idx."""
    return covis[kf_idx] >= theta
