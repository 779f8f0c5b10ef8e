"""Indexed membership: the (K, P) feature-index form of the membership
matrix (port of mageslam_tpu/worldmap/member_index.py).

`fidx[k, p]` is the feature index of keyframe k's observation of point p,
or -1. It subsumes the bool membership matrix (`member = fidx >= 0`) and
also answers which feature observes p. The mapping step builds it once per
keyframe and updates it at each map mutation: row rebuilds on insert and
association, column clears on point removal.

Invariant, as in the reference: a keyframe observes a map point through at
most one feature. Where two features of one keyframe point at one point,
fidx keeps the lowest feature index.
"""

from __future__ import annotations

import torch

from ..ops.indexing import pair_index, scatter_drop, set_drop
from .map_state import MapState


def _rows_from_assoc(assoc_rows: torch.Tensor, ok: torch.Tensor, P: int) -> torch.Tensor:
    """(F, P) feature-index rows of (F, N) association rows: per point the
    lowest feature with ok[f, n] that points at it, else -1."""
    F, N = assoc_rows.shape
    dev = assoc_rows.device
    rows = torch.arange(F, device=dev)[:, None].expand(F, N)
    flat = torch.where(ok, pair_index(rows, assoc_rows, F, P), -1).reshape(-1)
    feats = torch.arange(N, dtype=torch.int32, device=dev)[None, :].expand(F, N)
    out = scatter_drop(torch.full((F * P,), N, dtype=torch.int32, device=dev),
                       flat, feats.reshape(-1), "min").reshape(F, P)
    return torch.where(out >= N, -1, out)


def build_fidx(state: MapState) -> torch.Tensor:
    """(K, P) int32 from the association matrix: the one full scatter."""
    K, P, N = state.capacity
    valid = (state.kf_assoc >= 0) & state.kf_kp_valid & state.kf_valid[:, None]
    return _rows_from_assoc(state.kf_assoc, valid, P)


def fidx_set_row(fidx, k, assoc_row, kp_valid) -> torch.Tensor:
    """Rebuild row k (a tensor index) from a fresh association row."""
    row = _rows_from_assoc(assoc_row[None], ((assoc_row >= 0) & kp_valid)[None],
                           fidx.shape[1])
    return set_drop(fidx, k.reshape(1), row)


def fidx_set_rows(fidx, ks, assoc_rows, kp_valid_rows, ok_rows,
                  kf_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Rebuild a small batch of rows ks (F,) from association rows (F, N);
    rows with ok_rows[f] false keep their contents. ks must be distinct where
    ok. `kf_valid` (K,) folds in the keyframe validity that build_fidx
    applies."""
    K, P = fidx.shape
    kfv = (torch.ones_like(ok_rows) if kf_valid is None
           else kf_valid[torch.clamp(ks, 0, K - 1)])
    okm = (assoc_rows >= 0) & kp_valid_rows & (ok_rows & kfv)[:, None]
    rows = _rows_from_assoc(assoc_rows, okm, P)
    return set_drop(fidx, torch.where(ok_rows, ks, K), rows)


def fidx_add(fidx, ks, feats, points, want) -> torch.Tensor:
    """Add individual associations (k, feat) -> point; the (k, point) pairs
    must be distinct where wanted."""
    K, P = fidx.shape
    flat = torch.where(want, pair_index(ks, points, K, P), -1)
    return set_drop(fidx.reshape(-1), flat, feats.to(torch.int32)).reshape(K, P)


def fidx_remove_obs(fidx, ks, points, want) -> torch.Tensor:
    """Clear individual associations (k, point)."""
    K, P = fidx.shape
    flat = torch.where(want, pair_index(ks, points, K, P), -1)
    return set_drop(fidx.reshape(-1), flat, -1).reshape(K, P)


def fidx_remove_points(fidx, removed) -> torch.Tensor:
    """Clear the columns of removed points (P,) bool."""
    return torch.where(removed[None, :], -1, fidx)


def fidx_remove_keyframes(fidx, removed) -> torch.Tensor:
    """Clear the rows of removed keyframes (K,) bool."""
    return torch.where(removed[:, None], -1, fidx)


def member_of(fidx) -> torch.Tensor:
    """(K, P) bool membership view."""
    return fidx >= 0


def octave_histogram_of(fidx, kf_kp_octave, num_levels: int) -> torch.Tensor:
    """(P, L) per-point observation count by pyramid level, from gathers and
    L masked column sums."""
    safe = torch.where(fidx >= 0, fidx, 0).to(torch.int64)
    octv = torch.clamp(torch.gather(kf_kp_octave, 1, safe), 0, num_levels - 1)
    okt = torch.where(fidx >= 0, octv, -1)
    return torch.stack([torch.sum((okt == level).to(torch.int32), dim=0)
                        for level in range(num_levels)], dim=1)
