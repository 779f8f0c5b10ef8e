"""Maximum-covisibility spanning tree, the essential graph's backbone (port
of mageslam_tpu/worldmap/spanning_tree.py; Map/SpanningTree.{h,cpp}).

Rebuilt from the covisibility matrix by Prim's algorithm as a fixed loop of
K - 1 steps, each adding the strongest tree → non-tree edge (a masked
argmax over the (K, K) weights); a step with no positive edge changes
nothing. Nothing reads the device back to the host.
"""

from __future__ import annotations

import torch


def spanning_tree(covis: torch.Tensor, kf_valid: torch.Tensor, root: int = 0) -> torch.Tensor:
    """(K,) int32 parent per keyframe (-1 for the root and for invalid or
    disconnected keyframes). Edges maximize the covisibility weight; ties go
    to the first (tree node, new node) pair in row-major order."""
    K = covis.shape[0]
    dev = covis.device
    w = torch.where(kf_valid[:, None] & kf_valid[None, :], covis, -1)
    in_tree = torch.zeros((K,), dtype=torch.bool, device=dev)
    in_tree[root] = kf_valid[root]
    parent = torch.full((K,), -1, dtype=torch.int32, device=dev)
    for _ in range(K - 1):
        cand = torch.where(in_tree[:, None] & ~in_tree[None, :] & (w > 0), w, -1)
        flat = torch.argmax(cand.reshape(-1))                 # first maximum
        i, j = flat // K, flat % K
        ok = cand.reshape(-1)[flat] > 0
        parent = parent.index_put((j.reshape(1),), torch.where(
            ok, i.to(torch.int32), parent[j]).reshape(1))
        in_tree = in_tree.index_put((j.reshape(1),), (in_tree[j] | ok).reshape(1))
    return parent


def tree_valid(parent: torch.Tensor, kf_valid: torch.Tensor, root: int = 0) -> torch.Tensor:
    """SpanningTree::ValidSpanningTree: () bool, every valid keyframe
    reachable from the root."""
    K = parent.shape[0]
    reach = torch.zeros((K,), dtype=torch.bool, device=parent.device)
    reach[root] = True
    has_parent = parent >= 0
    p_safe = torch.where(has_parent, parent, 0).to(torch.int64)
    for _ in range(K):
        reach = reach | (has_parent & reach[p_safe])
    return torch.all(torch.where(kf_valid, reach, True))


def essential_graph_edges(covis: torch.Tensor, kf_valid: torch.Tensor,
                          parent: torch.Tensor, theta: int = 100) -> torch.Tensor:
    """(K, K) bool: the spanning tree's edges and the strong covisibility
    edges (CovisEssentialThreshold, MageSettings.h:76)."""
    K = covis.shape[0]
    strong = (covis >= theta) & kf_valid[:, None] & kf_valid[None, :]
    has_p = parent >= 0
    p_safe = torch.where(has_p, parent, 0).to(torch.int64)
    tree = torch.zeros((K, K), dtype=torch.bool, device=covis.device)
    tree[torch.arange(K, device=covis.device), p_safe] |= has_p
    return strong | tree | tree.T
