"""The map-point bank sharded over a mesh for guided matching (port of
mageslam_tpu/parallel/sharded_matching.py).

Each shard holds a contiguous P/d block of the queries (map points) and
computes, on its device, each target's best and second-best gated distance
over its block (`ops/local_best.local_best`: the fused kernel on the card,
its plain version on the CPU). The per-target winner then combines across
shards exactly as the reference's (d, 3, N) all_gather does: the shard
bests sorted stably (equal bests pick the lower shard, hence the lower
query), the runner-up the smaller of the next shard's best and the
winner's own second, and the ratio gate. The reference gathers the
operands as float32, exact for these integers; here they stay int32.
"""

from __future__ import annotations

import torch

from ..ops.local_best import BIG, local_best
from . import Mesh, all_gather, on


def make_sharded_guided_matcher(mesh: Mesh, axis: str = "model"):
    """Returns match(q_desc, q_xy, q_valid, t_desc, t_xy, t_valid, radius,
    max_hamming, min_diff) with the query (map-point) axis split over the
    mesh; P must divide by its size. Output: per target the best query's
    index into the full bank, or -1, (N,) int32 on the mesh's first
    device. `axis` names the mesh axis as the reference's does; the mesh
    has one."""
    d = mesh.size

    def match(q_desc, q_xy, q_valid, t_desc, t_xy, t_valid, radius, max_hamming: int,
              min_diff: int):
        P = q_desc.shape[0]
        if P % d:
            raise ValueError(f"sharded matcher: {P} queries do not split over {d} shards")
        p_local = P // d
        parts = []
        for s, dev in enumerate(mesh.devices):
            rows = slice(s * p_local, (s + 1) * p_local)
            with on(dev):
                best, best_q, second = local_best(
                    q_desc[rows].to(dev), q_xy[rows].to(dev), q_valid[rows].to(dev),
                    t_desc.to(dev), t_xy.to(dev), t_valid.to(dev), radius, max_hamming)
                parts.append(torch.stack([best, best_q + s * p_local, second])[None])
        gathered = all_gather(parts, mesh)                       # (d, 3, N)
        bests, idxs, seconds = gathered[:, 0], gathered[:, 1], gathered[:, 2]
        order = torch.argsort(bests, dim=0, stable=True)
        b1 = torch.gather(bests, 0, order[:1])[0]
        b2_cand = (torch.gather(bests, 0, order[1:2])[0] if d > 1
                   else torch.full_like(b1, BIG))
        win = torch.gather(idxs, 0, order[:1])[0]
        win_second = torch.gather(seconds, 0, order[:1])[0]
        b2 = torch.minimum(b2_cand, win_second)
        ok = (b1 <= max_hamming) & ((b2 >= BIG) | (b2 - b1 > min_diff))
        return torch.where(ok, win, -1)

    return match
