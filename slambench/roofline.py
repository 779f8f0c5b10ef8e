"""Peaks of one NVIDIA H100 and the least time of each hand kernel's call.

NVIDIA's H100 SXM data sheet, dense rates, at the full 700 W power limit:
the HBM rate, the int8 tensor-core rate (the densest form of a ±1 bit
product) and float32 outside the tensor cores. A kernel's least time is the
larger of its bytes over the HBM rate and each operation count over its peak;
its roofline share is that least time over its measured device time.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
F32_OPS_PER_S = 67e12


def bound_s(n_bytes: float, f32_ops: float = 0.0, int8_ops: float = 0.0) -> tuple[float, str]:
    """(least seconds, what sets it: "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(f32_ops / F32_OPS_PER_S, int8_ops / INT8_OPS_PER_S)
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def radius_match_bytes(n_stages: int, n_query: int, n_target: int) -> int:
    """Bytes one `radius_match_stages` call must move, each input read once
    and each output written once: per query its 32-byte descriptor, octave
    and valid flag; per stage and query its position and radius; per target
    its descriptor, position, octave and valid flag; per stage and query the
    (index, distance) answer."""
    return (n_query * (32 + 4 + 1) + n_stages * n_query * (8 + 4)
            + n_target * (32 + 8 + 4 + 1) + 2 * n_stages * n_query * 4)


def radius_match_ops(n_stages: int, gated_pairs: int, candidate_pairs: int) -> tuple[int, int]:
    """(float32 operations, int8 operations) of one call: per gated pair
    (valid, same octave) and stage two subtractions and two comparisons; per
    pair inside some stage's box 256 multiply-adds of the ±1 bit product."""
    return 4 * n_stages * gated_pairs, 2 * 256 * candidate_pairs


def radius_match_counts(query_xy, query_octave, query_valid, target_xy, target_octave,
                        target_valid, radius, octave_tol: int = 0) -> tuple[int, int]:
    """(gated pairs, candidate pairs) of one call's tensors: the validity and
    octave gate, and that gate with the Chebyshev box of some stage."""
    same = (query_octave[:, None] - target_octave[None, :]).abs() <= octave_tol
    gated = same & query_valid[:, None] & target_valid[None, :]
    r = radius[:, :, None]
    dx = (query_xy[:, :, None, 0] - target_xy[None, None, :, 0]).abs()
    dy = (query_xy[:, :, None, 1] - target_xy[None, None, :, 1]).abs()
    cand = gated[None] & (dx <= r) & (dy <= r)
    return int(gated.sum()), int(cand.any(0).sum())


def radius_match_bound_s(call: dict) -> float:
    """Least seconds of one recorded call (`radius_match_stages`' tensor
    arguments by name, and `octave_tol`)."""
    n_stages, n_query = call["radius"].shape
    n_target = call["target_desc"].shape[0]
    gated, cand = radius_match_counts(
        call["query_xy"], call["query_octave"], call["query_valid"], call["target_xy"],
        call["target_octave"], call["target_valid"], call["radius"], call.get("octave_tol", 0))
    f32, int8 = radius_match_ops(n_stages, gated, cand)
    return bound_s(radius_match_bytes(n_stages, n_query, n_target), f32, int8)[0]
