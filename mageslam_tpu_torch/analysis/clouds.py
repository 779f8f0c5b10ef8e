"""Point cloud denoising: kNN, PCA normals, mollification, repositioning
(port of mageslam_tpu/analysis/clouds.py).

Replaces Clouds/DeNoising.{h,cpp} (686 LoC) — the offline cleanup applied to
fossilized map clouds. The reference builds a spatial kNN index and runs
per-point loops with OS-thread parallelism; here the whole cloud is dense
batched linear algebra on the device (clouds are ≤ tens of thousands of
points — an (N, N) distance matrix is cheap):

  - `knn`: top-k via one pairwise distance matrix (DeNoising.h Knn struct),
    ties to the lower index as `jax.lax.top_k` breaks them
  - `compute_normals`: per-point PCA of the kNN neighborhood — batched 3×3
    eigh, smallest eigenvector, sign-aligned to the previous normal
    (DeNoising.cpp:128-191)
  - `mollify_normals`: joint bilateral smoothing with Gaussian weights
    exp(-(‖ni-nj‖²/σn² + ‖vi-vj‖²/σs²)) (DeNoising.cpp:248-295)
  - `compute_characteristics`: homogeneity (mean neighbor distance),
    distance score, effective dissimilarity Σ ‖v∥‖²/(‖v⊥‖²+ε)
    (DeNoising.cpp:193-246)
  - `reposition_points`: bilateral-normal projection steps — each point moves
    along its mollified normal toward the Gaussian-weighted neighborhood
    plane (the WLOP-style RepositionPointSets, :327-…)

An eigenvector's sign is the eigensolver's choice, and it differs between
LAPACK builds and the card's solver: compare normals as |n·n'|.
"""

from __future__ import annotations

import torch

from ..ops.indexing import topk_stable

_BIG = 1e30


def _pairwise_sq(a: torch.Tensor) -> torch.Tensor:
    return torch.sum((a[:, None, :] - a[None, :, :]) ** 2, dim=-1)


def knn(points: torch.Tensor, valid: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, k) neighbor indices + distances (self excluded)."""
    N = points.shape[0]
    d2 = torch.where(valid[None, :] & valid[:, None], _pairwise_sq(points), _BIG)
    d2 = d2 + torch.eye(N, dtype=d2.dtype, device=d2.device) * _BIG
    neg, idx = topk_stable(-d2, k)
    return idx, torch.sqrt(torch.clamp_min(-neg, 0.0))


def compute_normals(points: torch.Tensor, valid: torch.Tensor, neighbors: torch.Tensor,
                    prev_normals: torch.Tensor | None = None) -> torch.Tensor:
    """(N, 3) unit normals: smallest principal axis of each kNN neighborhood."""
    nb = points[neighbors]                                    # (N, k, 3)
    c = nb - torch.mean(nb, dim=1, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", c, c)                  # (N, 3, 3)
    _, V = torch.linalg.eigh(cov)
    normal = V[:, :, 0]                                       # smallest eigval
    if prev_normals is not None:
        flip = torch.sum(normal * prev_normals, dim=-1) < 0
        normal = torch.where(flip[:, None], -normal, normal)
    return normal


def mollify_normals(points: torch.Tensor, normals: torch.Tensor, valid: torch.Tensor,
                    normal_scale: float, spatial_scale: float,
                    iterations: int = 1) -> torch.Tensor:
    """Bilateral normal smoothing (DeNoising.cpp MollifyNormals)."""
    dv = _pairwise_sq(points) / (spatial_scale * spatial_scale)
    pair_ok = valid[None, :] & valid[:, None]
    for _ in range(iterations):
        w = torch.exp(-(_pairwise_sq(normals) / (normal_scale * normal_scale) + dv))
        w = torch.where(pair_ok, w, 0.0)
        summed = w @ normals
        normals = summed / torch.clamp_min(
            torch.linalg.vector_norm(summed, dim=-1, keepdim=True), 1e-12)
    return normals


def compute_characteristics(points: torch.Tensor, normals: torch.Tensor,
                            valid: torch.Tensor, neighbors: torch.Tensor,
                            distances: torch.Tensor):
    """(effective_dissimilarity, distance_score, homogeneity) per point
    (ComputeCharacteristics, DeNoising.cpp:193-246)."""
    v = points[neighbors] - points[:, None, :]                # (N, k, 3)
    n = normals[neighbors]                                    # (N, k, 3)
    par = torch.sum(v * n, dim=-1, keepdim=True) * n          # component ∥ normal
    perp = v - par
    dissim = torch.sum(par * par, dim=-1) / (torch.sum(perp * perp, dim=-1) + 1e-4)
    mask = valid.to(torch.float32)
    return (torch.sum(dissim, dim=1) * mask, torch.amax(distances, dim=1) * mask,
            torch.mean(distances, dim=1) * mask)


def reposition_points(points: torch.Tensor, valid: torch.Tensor, sigma_s: float = 0.1,
                      moll_sigma_n: float = 0.5, moll_sigma_s: float = 0.2,
                      step: float = 0.3, steps: int = 3, k: int = 8) -> torch.Tensor:
    """Denoise: iteratively project each point along its (mollified) normal
    toward the Gaussian-weighted plane of its neighborhood."""
    for _ in range(steps):
        nbr, dist = knn(points, valid, k)
        normals = compute_normals(points, valid, nbr)
        normals = mollify_normals(points, normals, valid, moll_sigma_n, moll_sigma_s)
        w = torch.exp(-dist * dist / (sigma_s * sigma_s))     # (N, k)
        # signed distance of each neighbor's offset along the point's normal
        off = torch.einsum("nki,ni->nk", points[nbr] - points[:, None, :], normals)
        corr = torch.sum(w * off, dim=1) / torch.clamp_min(torch.sum(w, dim=1), 1e-12)
        moved = points + step * corr[:, None] * normals
        points = torch.where(valid[:, None], moved, points)
    return points
