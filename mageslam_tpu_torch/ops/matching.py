"""Hamming-distance feature matching (port of mageslam_tpu/ops/matching.py).

Every matcher is a dense masked computation on the (N, M) distance matrix
from `hamming_matrix`, which launches the CUDA kernel for CUDA tensors
(`ops/hamming.py`). The reference's bf16 bit-unpack matmul (`use_mxu=True`)
gives the same exact integers, so the port has no `use_mxu`.

All matchers return, per query, the best target index (or -1).
"""

from __future__ import annotations

import torch

from .hamming import hamming_matrix  # noqa: F401  (re-exported)
from .indexing import gather_clamped, scatter_drop

BIG = 1 << 20


def _best_and_second(dist: torch.Tensor):
    """Row-wise (best_idx, best_val, second_val) of an int32 matrix; the
    first minimum wins ties, as jnp.argmin does."""
    best_idx = torch.argmin(dist, dim=1)
    best_val = torch.gather(dist, 1, best_idx[:, None])[:, 0]
    masked = dist.scatter(1, best_idx[:, None], BIG)
    second_val = torch.min(masked, dim=1).values
    return best_idx.to(torch.int32), best_val, second_val


def match_two_way(desc_a, valid_a, desc_b, valid_b, max_hamming: int,
                  min_diff: int):
    """Mutual-best match with the max-distance and best/second-best gates.
    Returns (match_b_idx (N,), dist (N,)), -1 for no match."""
    d = hamming_matrix(desc_a, desc_b)
    d = torch.where(valid_a[:, None] & valid_b[None, :], d, BIG)
    d_thr = torch.where(d <= max_hamming, d, BIG)

    fwd_idx, fwd_best, fwd_second = _best_and_second(d_thr)
    bwd_idx, bwd_best, bwd_second = _best_and_second(d_thr.T)

    fwd_ok = (fwd_best < BIG) & ((fwd_second >= BIG)
                                 | (fwd_second - fwd_best >= min_diff))
    bwd_ok = (bwd_best < BIG) & ((bwd_second >= BIG)
                                 | (bwd_second - bwd_best >= min_diff))
    fi = fwd_idx.to(torch.int64)
    mutual = bwd_idx[fi] == torch.arange(desc_a.shape[0], dtype=torch.int32,
                                         device=desc_a.device)
    ok = fwd_ok & bwd_ok[fi] & mutual
    return torch.where(ok, fwd_idx, -1), torch.where(ok, fwd_best, -1)


def radius_match(query_desc, query_xy, query_octave, query_valid,
                 target_desc, target_xy, target_octave, target_valid,
                 radius, max_hamming, min_diff, octave_tol: int = 0):
    """Guided spatial match: per query, the best target inside the Chebyshev
    `radius` box on the same octave (± octave_tol). Accepts best <=
    max_hamming with second - best > min_diff. Returns (idx or -1, dist)."""
    d = hamming_matrix(query_desc, target_desc)
    radius = torch.as_tensor(radius, dtype=torch.float32,
                             device=query_xy.device).expand(query_desc.shape[0])
    dx = torch.abs(query_xy[:, None, 0] - target_xy[None, :, 0])
    dy = torch.abs(query_xy[:, None, 1] - target_xy[None, :, 1])
    in_box = (dx <= radius[:, None]) & (dy <= radius[:, None])
    same_oct = torch.abs(query_octave[:, None] - target_octave[None, :]) <= octave_tol
    cand = in_box & same_oct & query_valid[:, None] & target_valid[None, :]

    d = torch.where(cand, d, BIG)
    best_idx, best_val, second_val = _best_and_second(d)
    ok = (best_val <= max_hamming) & ((second_val >= BIG)
                                      | (second_val - best_val > min_diff))
    return torch.where(ok, best_idx, -1), torch.where(ok, best_val, -1)


def dedup_by_target(match_idx: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """When several queries claim one target, keep only the strictly best
    claim; on a tie for best, drop every claim of that target. Target ids
    beyond the bank (len(match_idx) + 1) read and write as the reference's
    dropped scatter and clamped gather do."""
    has = match_idx >= 0
    d = torch.where(has, dist, BIG)
    n_targets = match_idx.shape[0] + 1
    t_w = torch.where(has, match_idx, n_targets)
    t_r = torch.where(has, match_idx, 0)
    best = scatter_drop(torch.full((n_targets + 1,), BIG, dtype=torch.int32,
                                   device=d.device), t_w, d, "min")
    is_best = has & (d == gather_clamped(best, t_r))
    n_best = scatter_drop(torch.zeros((n_targets + 1,), dtype=torch.int32,
                                      device=d.device), t_w,
                          is_best.to(torch.int32), "add")
    keep = is_best & (gather_clamped(n_best, t_r) == 1)
    return torch.where(keep, match_idx, -1)
