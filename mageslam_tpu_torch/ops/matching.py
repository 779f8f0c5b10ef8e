"""Hamming-distance feature matching (port of mageslam_tpu/ops/matching.py).

- `radius_match_stages` / `radius_match`: the guided spatial match, then
  `dedup_by_target` on each stage's result (in groups of `group_rows` query
  rows). CUDA tensors launch the fused kernel `csrc/radius_match.cu` once a
  call (masked best and second-best per query and stage, then the dedup
  across the call's rows; no (Q, T) matrix in device memory); CPU tensors
  take `radius_match_stages_plain`: `radius_from_distances` on the (Q, T)
  matrix from `hamming_matrix_plain`, then `dedup_stages_plain`. There is
  no fallback between the two. `LAUNCHES` counts the fused kernel's
  launches.
- `match_two_way`: the mutual best match, batched. CUDA tensors launch the
  fused kernel `csrc/two_way_match.cu` once for the whole batch (both
  directions scanned, no (N, M) matrix in device memory); CPU tensors take
  `match_two_way_plain`, the same gates on the (N, M) matrix from
  `hamming_matrix_plain`. `TWO_WAY_LAUNCHES` counts the wrapper's launches
  of the kernel (one per call: the scan and its gate pass together).

The reference's bf16 bit-unpack matmul (`use_mxu=True`) gives the same exact
integers, so the port has no `use_mxu`. All matchers return, per query, the
best target index (or -1).
"""

from __future__ import annotations

import torch

from . import _build
from .hamming import WORDS, hamming_matrix_plain
from .indexing import gather_clamped, scatter_drop

BIG = 1 << 20
MAX_STAGES = 4
LAUNCHES = 0
TWO_WAY_LAUNCHES = 0
# the fused dedup's scratch, one a (device, stream): a zeroed buffer (a
# 64-bit claim and ticket count padded to 16 bytes, then the per-stage
# tables), which the kernel leaves zero, and the claim list
_dedup_scratch: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _best_and_second(dist: torch.Tensor):
    """Row-wise (best_idx, best_val, second_val) of an int32 matrix; the
    first minimum wins ties, as jnp.argmin does."""
    best_idx = torch.argmin(dist, dim=1)
    best_val = torch.gather(dist, 1, best_idx[:, None])[:, 0]
    masked = dist.scatter(1, best_idx[:, None], BIG)
    second_val = torch.min(masked, dim=1).values
    return best_idx.to(torch.int32), best_val, second_val


def two_way_from_distances(d, valid_a, valid_b, max_hamming: int, min_diff: int):
    """The two-way match's gates on an (N, M) int32 distance matrix:
    (match_b_idx (N,), dist (N,)), -1 for no match."""
    n = d.shape[0]
    d = torch.where(valid_a[:, None] & valid_b[None, :], d, BIG)
    d_thr = torch.where(d <= max_hamming, d, BIG)

    fwd_idx, fwd_best, fwd_second = _best_and_second(d_thr)
    bwd_idx, bwd_best, bwd_second = _best_and_second(d_thr.T)

    fwd_ok = (fwd_best < BIG) & ((fwd_second >= BIG)
                                 | (fwd_second - fwd_best >= min_diff))
    bwd_ok = (bwd_best < BIG) & ((bwd_second >= BIG)
                                 | (bwd_second - bwd_best >= min_diff))
    fi = fwd_idx.to(torch.int64)
    mutual = bwd_idx[fi] == torch.arange(n, dtype=torch.int32, device=d.device)
    ok = fwd_ok & bwd_ok[fi] & mutual
    return torch.where(ok, fwd_idx, -1), torch.where(ok, fwd_best, -1)


def _match_two_way_single(desc_a, valid_a, desc_b, valid_b, max_hamming: int,
                          min_diff: int):
    n, m = desc_a.shape[0], desc_b.shape[0]
    if n == 0 or m == 0:
        none = torch.full((n,), -1, dtype=torch.int32, device=desc_a.device)
        return none, none.clone()
    return two_way_from_distances(hamming_matrix_plain(desc_a, desc_b), valid_a,
                                  valid_b, max_hamming, min_diff)


def match_two_way_plain(desc_a, valid_a, desc_b, valid_b, max_hamming: int,
                        min_diff: int):
    """`match_two_way` as tensor code on the (N, M) distance matrix from
    `hamming_matrix_plain`, one batch entry at a time."""
    if desc_b.dim() == 2:
        return _match_two_way_single(desc_a, valid_a, desc_b, valid_b,
                                     max_hamming, min_diff)
    pairs = [_match_two_way_single(desc_a if desc_a.dim() == 2 else desc_a[b],
                                   valid_a[b], desc_b[b], valid_b[b],
                                   max_hamming, min_diff)
             for b in range(desc_b.shape[0])]
    shape = (desc_b.shape[0], desc_a.shape[-2])
    if not pairs:
        none = torch.full(shape, -1, dtype=torch.int32, device=desc_a.device)
        return none, none.clone()
    return (torch.stack([p[0] for p in pairs]).reshape(shape),
            torch.stack([p[1] for p in pairs]).reshape(shape))


def match_two_way(desc_a, valid_a, desc_b, valid_b, max_hamming: int,
                  min_diff: int):
    """Mutual-best match with the max-distance and best/second-best gates.

    Unbatched: desc_a (N, 8) int32 words, valid_a (N,) bool, desc_b (M, 8),
    valid_b (M,); returns (match_b_idx (N,), dist (N,)) int32, -1 for no
    match. Batched: desc_b (B, M, 8), valid_b (B, M), valid_a (B, N) and
    desc_a (B, N, 8) or one (N, 8) bank shared by all entries; returns (B, N).

    Distances above max_hamming or on an invalid row or column count as BIG.
    A side passes when best < BIG and (second >= BIG or second - best >=
    min_diff); a row is matched when its side passes, its best column's side
    passes, and that column's best row is this row. The first minimum wins a
    tie in both directions.

    CUDA tensors launch `csrc/two_way_match.cu` once for the whole batch
    (no (N, M) matrix in device memory); CPU tensors take
    `match_two_way_plain`."""
    tensors = (desc_a, valid_a, desc_b, valid_b)
    if all(t.device.type == "cpu" for t in tensors):
        return match_two_way_plain(*tensors, max_hamming, min_diff)
    device = desc_a.device
    if device.type != "cuda" or device.index != torch.cuda.current_device():
        raise ValueError(f"match_two_way: unsupported device {device} (the "
                         f"current CUDA device is the launch's device)")
    batched = desc_b.dim() == 3
    if not batched:
        desc_b, valid_b, valid_a = desc_b[None], valid_b[None], valid_a[None]
    if desc_b.dim() != 3 or desc_a.dim() not in (2, 3):
        raise ValueError(f"match_two_way: desc_a {tuple(desc_a.shape)} and desc_b "
                         f"{tuple(desc_b.shape)} are not (N, 8) / (B, N, 8) and (B, M, 8)")
    n_batch, n_b = desc_b.shape[:2]
    n_a = desc_a.shape[-2]
    shared_a = desc_a.dim() == 2
    for t, name, dtype, shape in (
            (desc_a, "desc_a", torch.int32,
             (n_a, WORDS) if shared_a else (n_batch, n_a, WORDS)),
            (valid_a, "valid_a", torch.bool, (n_batch, n_a)),
            (desc_b, "desc_b", torch.int32, (n_batch, n_b, WORDS)),
            (valid_b, "valid_b", torch.bool, (n_batch, n_b))):
        _check(t, name, device, dtype, shape, "match_two_way")
    if desc_a.data_ptr() % 16 or desc_b.data_ptr() % 16:   # staged with 16-byte cp.async
        raise ValueError("match_two_way: descriptors must be 16-byte aligned")
    if n_batch > 65535:   # gridDim.y
        raise ValueError(f"match_two_way: batch {n_batch} exceeds the launch grid")
    out_idx = torch.empty((n_batch, n_a), dtype=torch.int32, device=device)
    out_dist = torch.empty((n_batch, n_a), dtype=torch.int32, device=device)
    if n_batch == 0 or n_a == 0 or n_b == 0:   # nothing to launch: no match
        out_idx.fill_(-1)
        out_dist.fill_(-1)
    else:
        scratch = torch.empty((n_batch, n_a + n_b, 4), dtype=torch.int32, device=device)
        rc = _build.library().mageslam_two_way_match(
            desc_a.data_ptr(), valid_a.data_ptr(), desc_b.data_ptr(),
            valid_b.data_ptr(), scratch.data_ptr(), out_idx.data_ptr(),
            out_dist.data_ptr(), 0 if shared_a else n_a, n_batch, n_a, n_b,
            int(max_hamming), int(min_diff),
            torch._C._cuda_getCurrentRawStream(device.index))
        if rc != 0:
            raise RuntimeError(f"two_way_match kernel launch failed: cudaError {rc}")
        _build.count_launch(globals(), "TWO_WAY_LAUNCHES")
    return (out_idx, out_dist) if batched else (out_idx[0], out_dist[0])


def candidate_mask(query_xy, query_octave, query_valid, target_xy, target_octave,
                   target_valid, radius, octave_tol: int = 0) -> torch.Tensor:
    """(S, Q, T) bool: the pairs that stage s may match, as the reference's
    radius_match masks them (Chebyshev box, octave gate, validity)."""
    same_oct = torch.abs(query_octave[:, None] - target_octave[None, :]) <= octave_tol
    base = same_oct & query_valid[:, None] & target_valid[None, :]
    r = radius[:, :, None]
    dx = torch.abs(query_xy[:, :, None, 0] - target_xy[None, None, :, 0])
    dy = torch.abs(query_xy[:, :, None, 1] - target_xy[None, None, :, 1])
    return base[None] & (dx <= r) & (dy <= r)


def radius_from_distances(d, query_xy, query_octave, query_valid, target_xy, target_octave,
                          target_valid, radius, max_hamming: int, min_diff: int,
                          octave_tol: int = 0):
    """The guided match's gates on a (Q, T) int32 distance matrix: the
    reference's radius_match once per stage, sharing the distances, before
    any dedup. Returns (S, Q) int32 (idx or -1, dist or -1)."""
    n_stages, n_query = radius.shape
    if d.shape[1] == 0:
        none = torch.full((n_stages, n_query), -1, dtype=torch.int32, device=d.device)
        return none, none.clone()
    cand = candidate_mask(query_xy, query_octave, query_valid, target_xy,
                          target_octave, target_valid, radius, octave_tol)
    idx, dist = [], []
    for s in range(n_stages):
        best_idx, best_val, second_val = _best_and_second(torch.where(cand[s], d, BIG))
        ok = (best_val <= max_hamming) & ((second_val >= BIG)
                                          | (second_val - best_val > min_diff))
        idx.append(torch.where(ok, best_idx, -1))
        dist.append(torch.where(ok, best_val, -1))
    return torch.stack(idx), torch.stack(dist)


def radius_match_stages_plain(query_desc, query_xy, query_octave, query_valid,
                              target_desc, target_xy, target_octave, target_valid,
                              radius, max_hamming: int, min_diff: int,
                              octave_tol: int = 0, group_rows: int | None = None):
    """`radius_match_stages` as tensor code: `radius_from_distances` on the
    (Q, T) matrix from `hamming_matrix_plain`, then `dedup_stages_plain`."""
    idx, dist = radius_from_distances(
        hamming_matrix_plain(query_desc, target_desc), query_xy, query_octave, query_valid,
        target_xy, target_octave, target_valid, radius, max_hamming, min_diff, octave_tol)
    return dedup_stages_plain(idx, dist, group_rows)


def _check(t: torch.Tensor, name: str, device: torch.device, dtype: torch.dtype,
           shape: tuple[int, ...], fn: str = "radius_match_stages") -> None:
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{fn}: {name} must be {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def dedup_stages_plain(idx: torch.Tensor, dist: torch.Tensor,
                       group_rows: int | None = None):
    """`dedup_by_target` on each stage of (S, Q) (idx, dist), the target
    ids of row q offset by (q // group_rows) * group_rows so that claims of
    different groups never meet (relocalization's stacked candidates; None:
    one group). Returns (idx, dist), both -1 where a claim lost."""
    n_query = idx.shape[1]
    offset = None
    if group_rows is not None and group_rows < n_query:
        rows = torch.arange(n_query, dtype=torch.int32, device=idx.device)
        offset = torch.div(rows, group_rows, rounding_mode="floor") * group_rows
    out_idx, out_dist = [], []
    for s in range(idx.shape[0]):
        flat = idx[s] if offset is None else torch.where(idx[s] >= 0, idx[s] + offset, -1)
        kept = dedup_by_target(flat, dist[s]) >= 0
        out_idx.append(torch.where(kept, idx[s], -1))
        out_dist.append(torch.where(kept, dist[s], -1))
    return torch.stack(out_idx), torch.stack(out_dist)


def _dedup_buffers(device: torch.device, stream: int, n_stages: int, n_query: int):
    """(zeroed, claims) scratch of the fused dedup for this (device,
    stream), grown to the call's size; a new zeroed buffer is filled once."""
    key = (device.index, stream)
    with _build.CACHE_LOCK:   # filled from the mapping offload's worker too
        zeroed, claims = _dedup_scratch.get(key, (None, None))
        n_zeroed = 4 + n_stages * 2 * (n_query + 2)
        if zeroed is None or zeroed.shape[0] < n_zeroed:
            zeroed = torch.zeros((max(n_zeroed, 2 * (0 if zeroed is None else zeroed.shape[0])),),
                                 dtype=torch.int32, device=device)
        if claims is None or claims.shape[0] < n_stages * n_query:
            claims = torch.empty((max(n_stages * n_query, 4096), 4), dtype=torch.int32,
                                 device=device)
        _dedup_scratch[key] = (zeroed, claims)
        return zeroed, claims


def radius_match_stages(query_desc, query_xy, query_octave, query_valid,
                        target_desc, target_xy, target_octave, target_valid,
                        radius, max_hamming: int, min_diff: int, octave_tol: int = 0,
                        group_rows: int | None = None):
    """Guided spatial match for S <= 4 stages over one distance computation.

    query_desc (Q, 8) int32 words, query_octave (Q,) int32, query_valid (Q,)
    bool; target_desc (T, 8), target_xy (T, 2) float32, target_octave (T,),
    target_valid (T,); per stage s the query positions query_xy[s] (S, Q, 2)
    float32 and radii radius[s] (S, Q) float32. Per stage and query: the
    best target inside the Chebyshev box on the same octave (± octave_tol),
    accepted when best <= max_hamming and second - best > min_diff. Each
    stage's result then goes through `dedup_by_target` with the targets of
    row q offset by (q // group_rows) * group_rows, so that claims of
    different groups never meet (None: one group; `dedup_stages_plain`).
    Returns (S, Q) int32 (idx or -1, dist or -1)."""
    tensors = (query_desc, query_xy, query_octave, query_valid, target_desc,
               target_xy, target_octave, target_valid, radius)
    if group_rows is not None and group_rows < 1:
        raise ValueError(f"radius_match_stages: group_rows {group_rows} < 1")
    if all(t.device.type == "cpu" for t in tensors):
        return radius_match_stages_plain(*tensors, max_hamming, min_diff, octave_tol,
                                         group_rows)
    device = query_desc.device
    if device.type != "cuda" or device.index != torch.cuda.current_device():
        raise ValueError(f"radius_match_stages: unsupported device {device} (the "
                         f"current CUDA device is the launch's device)")
    if radius.dim() != 2 or not 1 <= radius.shape[0] <= MAX_STAGES:
        raise ValueError(f"radius_match_stages: radius must be (S, Q) with 1 <= S <= "
                         f"{MAX_STAGES}, got {tuple(radius.shape)}")
    (n_stages, n_query), n_target = radius.shape, target_desc.shape[0]
    for t, name, dtype, shape in (
            (query_desc, "query_desc", torch.int32, (n_query, WORDS)),
            (query_xy, "query_xy", torch.float32, (n_stages, n_query, 2)),
            (query_octave, "query_octave", torch.int32, (n_query,)),
            (query_valid, "query_valid", torch.bool, (n_query,)),
            (target_desc, "target_desc", torch.int32, (n_target, WORDS)),
            (target_xy, "target_xy", torch.float32, (n_target, 2)),
            (target_octave, "target_octave", torch.int32, (n_target,)),
            (target_valid, "target_valid", torch.bool, (n_target,)),
            (radius, "radius", torch.float32, (n_stages, n_query))):
        _check(t, name, device, dtype, shape)
    # staged with 16-byte bulk copies (or, off that alignment, loads)
    if target_desc.data_ptr() % 16 or target_xy.data_ptr() % 8:
        raise ValueError("radius_match_stages: target_desc must be 16-byte and "
                         "target_xy 8-byte aligned")
    out_idx = torch.empty((n_stages, n_query), dtype=torch.int32, device=device)
    out_dist = torch.empty((n_stages, n_query), dtype=torch.int32, device=device)
    if n_query == 0:
        return out_idx, out_dist
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    zeroed, claims = _dedup_buffers(device, stream, n_stages, n_query)
    group = n_query if group_rows is None else min(int(group_rows), n_query)
    rc = _build.library().mageslam_radius_match(
        *(t.data_ptr() for t in (query_desc, query_octave, query_valid, query_xy,
                                 radius, target_desc, target_xy, target_octave,
                                 target_valid, out_idx, out_dist)),
        zeroed.data_ptr(), claims.data_ptr(),
        n_stages, n_query, n_target, int(octave_tol), int(max_hamming),
        int(min_diff), group, stream)
    if rc != 0:
        raise RuntimeError(f"radius_match kernel launch failed: cudaError {rc}")
    _build.count_launch(globals(), "LAUNCHES")
    return out_idx, out_dist


def radius_match(query_desc, query_xy, query_octave, query_valid,
                 target_desc, target_xy, target_octave, target_valid,
                 radius, max_hamming, min_diff, octave_tol: int = 0,
                 group_rows: int | None = None):
    """Guided spatial match, one stage: per query, the best target inside
    the Chebyshev `radius` box (a number or a (Q,) tensor) on the same
    octave (± octave_tol). Accepts best <= max_hamming with second - best >
    min_diff, then the dedup by target (`group_rows` as
    `radius_match_stages`). Returns (idx or -1, dist or -1), each (Q,)."""
    n_query = query_desc.shape[0]
    if isinstance(radius, torch.Tensor):
        radius = radius.to(device=query_xy.device, dtype=torch.float32)
        radius = radius.expand(n_query).reshape(1, n_query).contiguous()
    else:
        radius = torch.full((1, n_query), float(radius), dtype=torch.float32,
                            device=query_xy.device)
    idx, dist = radius_match_stages(
        query_desc, query_xy[None].contiguous(), query_octave, query_valid,
        target_desc, target_xy, target_octave, target_valid, radius,
        max_hamming, min_diff, octave_tol, group_rows)
    return idx[0], dist[0]


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
