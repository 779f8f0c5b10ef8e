"""Selection and scatter helpers with the JAX reference's semantics.

- `topk_stable` is `jax.lax.top_k`: descending values, and on ties the lower
  index first. `torch.topk` promises no order among equal values, and FAST
  scores, ANMS keys and masked distances tie often, so every `top_k` (and
  every TPU `approx_max_k`) of the reference goes through this one helper.
- `scatter_drop` is `x.at[idx].{min,max,add}(v, mode="drop")` for 1-D
  banks: JAX drops out-of-range writes, torch raises on them. Out-of-range
  indices are sent to a sink slot past the end, which is then cut off, so
  the scatter never needs a host sync to filter them.
- `set_drop` / `add_drop` are `x.at[idx].set(v, mode="drop")` and
  `.add(v, mode="drop")` over the rows of a bank of any rank, with the same
  sink slot. Every caller masks a write by sending it past the end, never
  by a negative index, so a negative index is dropped too. `set_drop` with
  equal in-range indices has no defined winner on CUDA: callers pass
  distinct ones. `add_drop` sums float32 duplicates in no fixed order on
  CUDA (atomics), so sums agree to rounding only.
- `add_at_` is `x.at[index].add(v)` for float banks, in place: on the CPU
  it adds the rows one after another in index order (`index_add_` over
  the flattened indexed dims), as the reference's scatter-add does, where
  `index_put_(accumulate=True)` adds from parallel threads with atomics in
  an order that moves with their timing, so a loaded machine gave other
  sums on the same inputs. On CUDA it is `index_put_(accumulate=True)`.
- `pair_index` turns (row, column) pairs into indices of the flattened
  (rows x columns) bank, -1 (dropped) where either is out of range, for the
  reference's two-index scatters.
- `any_drop` is `zeros(n, bool).at[idx].max(flag, mode="drop")`.
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


def _sink(idx: torch.Tensor, n: int) -> torch.Tensor:
    return torch.where((idx >= 0) & (idx < n), idx, n).to(torch.int64)


def set_drop(bank: torch.Tensor, idx: torch.Tensor, value) -> torch.Tensor:
    """`bank` with row idx[i] set to value[i] (or a scalar); indices outside
    [0, len(bank)) are dropped."""
    n = bank.shape[0]
    value = torch.as_tensor(value, dtype=bank.dtype, device=bank.device)
    padded = torch.cat([bank, bank.new_zeros((1,) + bank.shape[1:])])
    padded.index_put_((_sink(idx, n),), value)
    return padded[:n]


def add_drop(bank: torch.Tensor, idx: torch.Tensor, value) -> torch.Tensor:
    """`bank` with value[i] added to row idx[i]; indices outside
    [0, len(bank)) are dropped."""
    n = bank.shape[0]
    value = torch.as_tensor(value, dtype=bank.dtype, device=bank.device)
    padded = torch.cat([bank, bank.new_zeros((1,) + bank.shape[1:])])
    padded.index_put_((_sink(idx, n),), value.expand(idx.shape + bank.shape[1:]),
                      accumulate=True)
    return padded[:n]


def add_at_(bank: torch.Tensor, index: tuple, values: torch.Tensor) -> torch.Tensor:
    """Add `values` into `bank` at the index tuple over its leading dims,
    duplicates summed; returns `bank`."""
    if bank.device.type != "cpu":
        return bank.index_put_(index, values, accumulate=True)
    lead, rest = bank.shape[:len(index)], bank.shape[len(index):]
    flat = torch.zeros((), dtype=torch.int64)
    for ix, n in zip(index, lead):
        ix = ix.to(torch.int64)
        flat = flat * n + torch.where(ix < 0, ix + n, ix)
    flat = flat.reshape(-1)
    bank.view((-1,) + rest).index_add_(
        0, flat, values.expand(flat.shape + rest).reshape((-1,) + rest))
    return bank


def pair_index(rows: torch.Tensor, cols: torch.Tensor, n_rows: int,
               n_cols: int) -> torch.Tensor:
    """Flat index rows * n_cols + cols, -1 where a row or column is out of
    range."""
    ok = (rows >= 0) & (rows < n_rows) & (cols >= 0) & (cols < n_cols)
    return torch.where(ok, rows.to(torch.int64) * n_cols + cols.to(torch.int64), -1)


def any_drop(n: int, idx: torch.Tensor, flag: torch.Tensor) -> torch.Tensor:
    """(n,) bool: true where some in-range idx[i] with flag[i] points."""
    hits = scatter_drop(torch.zeros((n,), dtype=torch.int32, device=idx.device),
                        idx, flag.to(torch.int32), "max")
    return hits > 0
