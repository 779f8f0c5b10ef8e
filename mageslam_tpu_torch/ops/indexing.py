"""Selection and scatter helpers with the JAX reference's semantics.

- `topk_stable` is `jax.lax.top_k`: descending values, and on ties the lower
  index first. `torch.topk` promises no order among equal values, and FAST
  scores, ANMS keys and masked distances tie often, so every `top_k` (and
  every TPU `approx_max_k`) of the reference goes through this one helper.
- `scatter_drop` is `x.at[idx].{min,max,add}(v, mode="drop")` for 1-D
  banks: JAX drops out-of-range writes, torch raises on them. Out-of-range
  indices are sent to a sink slot past the end, which is then cut off, so
  the scatter never needs a host sync to filter them.
"""

from __future__ import annotations

import torch

_REDUCE = {"min": "amin", "max": "amax", "add": "sum"}


def topk_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries along the last dim,
    descending, ties broken by ascending index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def scatter_drop(bank: torch.Tensor, idx: torch.Tensor, src: torch.Tensor,
                 reduce: str) -> torch.Tensor:
    """Return `bank` with `src` scattered at `idx` along dim 0, combining
    with the existing values (`reduce` in min / max / add). Entries
    whose index is outside [0, len(bank)) are dropped."""
    n = bank.shape[0]
    ok = (idx >= 0) & (idx < n)
    idx = torch.where(ok, idx, n).to(torch.int64)
    padded = torch.cat([bank, bank[:1]])
    padded = padded.scatter_reduce(0, idx, src.to(bank.dtype),
                                   reduce=_REDUCE[reduce], include_self=True)
    return padded[:n]


def gather_clamped(bank: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`bank[idx]` with indices clamped into range, as a JAX gather does."""
    return bank[torch.clamp(idx, 0, bank.shape[0] - 1)]
