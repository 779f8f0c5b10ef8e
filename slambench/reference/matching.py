"""The plain binary-descriptor matchers, as eager PyTorch on whole distance
matrices: the guided radius match with its dedup by target, the mutual
two-way match, and the bag-of-words word assignment.

Written from the matchers' stated rules (ORB-SLAM's SearchByProjection and
SearchForTriangulation gates as MAGE-SLAM sets them), not from the
program's code: distances come from a byte popcount table, the dedup from
a plain claim count. It imports nothing of the program. Every answer is an
integer, so the comparison is exact.
"""

from __future__ import annotations

import torch

BIG = 1 << 20
_POP8 = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int32)


def hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, M) int32 Hamming distances between (N, 8) and (M, 8) int32
    descriptor words, one byte at a time through a popcount table."""
    table = _POP8.to(a.device)
    out = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int32, device=a.device)
    for w in range(a.shape[1]):
        x = a[:, w, None] ^ b[None, :, w]
        for byte in range(4):
            out += table[((x >> (8 * byte)) & 0xFF).long()]
    return out


def _best_two(d: torch.Tensor):
    """Row-wise (index of the first minimum, the minimum, the least of the
    rest) of an int32 matrix with at least one column."""
    idx = torch.argmin(d, dim=1)
    best = d.gather(1, idx[:, None])[:, 0]
    second = d.scatter(1, idx[:, None], BIG).amin(dim=1)
    return idx.to(torch.int32), best, second


def dedup(idx: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Where several rows claim one target, keep the claim only if it is the
    single best; a tie for best drops them all. The claims are counted in a
    table of Q + 2 entries, as the matcher's specification sets it: a
    target id beyond the table writes nothing and reads the last entry."""
    q = idx.shape[0]
    size = q + 2
    has = idx >= 0
    d = torch.where(has, dist, BIG).long()
    slot = torch.where(has, idx, 0).long().clamp(max=size - 1)
    fits = has & (idx < size)
    best = torch.full((size,), BIG, dtype=torch.long, device=idx.device)
    best.scatter_reduce_(0, torch.where(fits, idx.long(), 0), torch.where(fits, d, BIG),
                         reduce="amin")
    is_best = has & (d == best[slot])
    count = torch.zeros((size,), dtype=torch.long, device=idx.device)
    count.scatter_add_(0, torch.where(fits, idx.long(), 0), (is_best & fits).long())
    return torch.where(is_best & (count[slot] == 1), idx, -1)


def radius_match_stages(query_desc, query_xy, query_octave, query_valid, target_desc,
                        target_xy, target_octave, target_valid, radius, max_hamming,
                        min_diff, octave_tol=0, group_rows=None):
    """(S, Q) int32 (target or -1, distance or -1). Per stage s and query q:
    the targets inside the box |dx|, |dy| <= radius[s, q] around
    query_xy[s, q], on an octave within octave_tol, both valid; the best is
    kept if best <= max_hamming and the second best is absent or more than
    min_diff worse. Then each stage's claims go through `dedup`, the target
    ids of row q offset by (q // group_rows) * group_rows."""
    n_stages, n_query = radius.shape
    none = torch.full((n_stages, n_query), -1, dtype=torch.int32, device=radius.device)
    if n_query == 0 or target_desc.shape[0] == 0:
        return none, none.clone()
    d = hamming(query_desc, target_desc)
    base = ((query_octave[:, None] - target_octave[None, :]).abs() <= octave_tol) \
        & query_valid[:, None] & target_valid[None, :]
    rows = torch.arange(n_query, device=radius.device, dtype=torch.int32)
    offset = (rows // group_rows) * group_rows if group_rows else torch.zeros_like(rows)
    out_idx, out_dist = [], []
    for s in range(n_stages):
        r = radius[s][:, None]
        inside = base & ((query_xy[s, :, None, 0] - target_xy[None, :, 0]).abs() <= r) \
            & ((query_xy[s, :, None, 1] - target_xy[None, :, 1]).abs() <= r)
        idx, best, second = _best_two(torch.where(inside, d, BIG))
        ok = (best <= max_hamming) & ((second >= BIG) | (second - best > min_diff))
        idx = torch.where(ok, idx, -1)
        kept = dedup(torch.where(ok, idx + offset, -1), best) >= 0
        out_idx.append(torch.where(kept, idx, -1))
        out_dist.append(torch.where(kept, best, -1))
    return torch.stack(out_idx), torch.stack(out_dist)


def _two_way_one(desc_a, valid_a, desc_b, valid_b, max_hamming, min_diff):
    n, m = desc_a.shape[0], desc_b.shape[0]
    if n == 0 or m == 0:
        none = torch.full((n,), -1, dtype=torch.int32, device=desc_a.device)
        return none, none.clone()
    d = hamming(desc_a, desc_b)
    d = torch.where(valid_a[:, None] & valid_b[None, :] & (d <= max_hamming), d, BIG)
    f_idx, f_best, f_second = _best_two(d)
    b_idx, b_best, b_second = _best_two(d.T)
    f_ok = (f_best < BIG) & ((f_second >= BIG) | (f_second - f_best >= min_diff))
    b_ok = (b_best < BIG) & ((b_second >= BIG) | (b_second - b_best >= min_diff))
    back = f_idx.long()
    ok = f_ok & b_ok[back] & (b_idx[back] == torch.arange(n, device=d.device))
    return torch.where(ok, f_idx, -1), torch.where(ok, f_best, -1)


def match_two_way(desc_a, valid_a, desc_b, valid_b, max_hamming, min_diff):
    """Mutual best matches from a to b: (idx into b or -1, distance or -1).
    Distances above max_hamming or on an invalid row or column do not
    count; each side needs its second best absent or at least min_diff
    worse, and the best of a's best must be a. The first minimum wins a
    tie. Unbatched: (N, 8), (N,), (M, 8), (M,) → (N,). Batched: desc_b
    (B, M, 8), valid_b (B, M), valid_a (B, N), desc_a (N, 8) shared or
    (B, N, 8) → (B, N)."""
    if desc_b.dim() == 2:
        return _two_way_one(desc_a, valid_a, desc_b, valid_b, max_hamming, min_diff)
    pairs = [_two_way_one(desc_a if desc_a.dim() == 2 else desc_a[b], valid_a[b], desc_b[b],
                          valid_b[b], max_hamming, min_diff) for b in range(desc_b.shape[0])]
    if not pairs:
        none = torch.full((0, desc_a.shape[-2]), -1, dtype=torch.int32, device=desc_a.device)
        return none, none.clone()
    return torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])


def assign_words(desc, valid, anchors) -> torch.Tensor:
    """(R,) int32: each valid descriptor's nearest anchor (the first on a
    tie), -1 where it is not valid."""
    if desc.shape[0] == 0 or anchors.shape[0] == 0:
        return torch.full((desc.shape[0],), -1, dtype=torch.int32, device=desc.device)
    word = torch.argmin(hamming(desc, anchors), dim=1).to(torch.int32)
    return torch.where(valid, word, -1)
