"""The random draws of mono init, vocabulary training and relocalization,
as inputs.

The reference splits `jax.random` keys and draws Gumbel noise inside
`try_initialize_pair` (B, 5, N), `pnp_ransac` (H, M, in
`validate_third_frame`), `train_vocabulary` (N,), for the adoption's
vocabulary and for the retrain, and `relocalize` (C, H, M: each of its C
candidates' `pnp_ransac` hypotheses, on a lost frame and in loop
detection once a cluster qualifies). Torch cannot reproduce those streams, so
the port's functions take the draws themselves, and a session asks its
draw source for each, by kind, in the order the reference draws them:

- `GeneratorDraws`: Gumbel noise as -log(Exponential(1)) from a
  `torch.Generator` on the session's device, seeded by the session's
  `seed`: the default, no global RNG state;
- `ReplayDraws`: recorded draws handed out in order, so that the port
  draws what a recorded session drew (`from_npz` reads the ones that
  `tools/export_jax_state.py` stores).
"""

from __future__ import annotations

import numpy as np
import torch

# the kinds a session asks for: RANSAC samples (B, 5, N), third-frame PnP
# hypotheses (H, M), vocabulary seeds (N,), relocalization's candidates'
# PnP hypotheses (C, H, M)
KINDS = ("init", "pnp", "vocab", "reloc")
# the key prefix of each kind's draws in a file of tools/export_jax_state.py
PREFIXES = {"init": "init_att", "pnp": "init_third", "vocab": "init_vocab",
            "reloc": "reloc"}


class GeneratorDraws:
    """Gumbel draws from a seeded generator on `device`."""

    def __init__(self, seed: int, device):
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(int(seed))
        self.device = torch.device(device)

    def position(self) -> torch.Tensor:
        """The generator's state, for `rewind`."""
        return self.generator.get_state()

    def rewind(self, position: torch.Tensor) -> None:
        self.generator.set_state(position)

    seek = rewind

    def gumbel(self, kind: str, shape: tuple[int, ...]) -> torch.Tensor:
        if kind not in KINDS:
            raise ValueError(f"unknown draw kind {kind!r}")
        e = torch.empty(shape, dtype=torch.float32, device=self.device)
        e.exponential_(generator=self.generator)
        return -torch.log(torch.clamp_min(e, torch.finfo(torch.float32).tiny))


class ReplayDraws:
    """Recorded draws, handed out in order per kind; asking for more than
    were recorded, or for another shape, raises."""

    def __init__(self, draws: dict[str, list[np.ndarray]], device):
        self.queues = {k: list(draws.get(k, ())) for k in KINDS}
        self._taken: dict[str, list[np.ndarray]] = {k: [] for k in KINDS}
        self.device = torch.device(device)

    @classmethod
    def from_npz(cls, path: str, device, kinds=KINDS, prefix: str = "") -> "ReplayDraws":
        """The draws `tools/export_jax_state.py` stored with the keys they
        came from: `init_att{j}_draws`, `init_third{j}_draws`,
        `init_vocab{j}_draws`, `reloc{j}_draws`, each after `prefix` (a file
        holding several sessions); only those of `kinds` (a session started
        from a snapshot has used the others)."""
        with np.load(path) as z:
            draws = {}
            for kind in kinds:
                prefix_of = prefix + PREFIXES[kind]
                j, arrays = 0, []
                while f"{prefix_of}{j}_draws" in z.files:
                    arrays.append(z[f"{prefix_of}{j}_draws"])
                    j += 1
                draws[kind] = arrays
        return cls(draws, device)

    @classmethod
    def from_npzs(cls, sources, device) -> "ReplayDraws":
        """`from_npz` over several files: `sources` holds (path, kinds) or
        (path, kinds, prefix), each kind read from one of them (a run whose
        init draws are another recorded run's)."""
        draws = {}
        for path, kinds, *prefix in sources:
            queues = cls.from_npz(path, "cpu", kinds, *prefix).queues
            draws.update({k: queues[k] for k in kinds})
        return cls(draws, device)

    def remaining(self) -> dict[str, int]:
        return {k: len(q) for k, q in self.queues.items()}

    def position(self) -> dict[str, int]:
        """How many draws of each kind were handed out, for `rewind`."""
        return {k: len(t) for k, t in self._taken.items()}

    def rewind(self, position: dict[str, int]) -> None:
        """Hand out again the draws handed out since `position` (an
        earlier one: draws not handed out yet cannot be skipped)."""
        for k, n_taken in position.items():
            taken = self._taken[k]
            if n_taken > len(taken):
                raise ValueError(f"cannot rewind {k!r} forward ({n_taken} > {len(taken)})")
            self.queues[k] = taken[n_taken:] + self.queues[k]
            del taken[n_taken:]

    def seek(self, position: dict[str, int]) -> None:
        """Go to `position`, earlier or later: a later one skips the draws
        in between (a session that loads a snapshot taken further on)."""
        for k, n_taken in position.items():
            skip = n_taken - len(self._taken[k])
            if skip > len(self.queues[k]):
                raise ValueError(f"cannot skip {skip} {k!r} draws: {len(self.queues[k])} left")
            if skip > 0:
                self._taken[k].extend(self.queues[k][:skip])
                del self.queues[k][:skip]
        self.rewind({k: min(n, len(self._taken[k])) for k, n in position.items()})

    def gumbel(self, kind: str, shape: tuple[int, ...]) -> torch.Tensor:
        if not self.queues.get(kind):
            raise RuntimeError(f"no recorded {kind!r} draw left")
        arr = self.queues[kind].pop(0)
        self._taken[kind].append(arr)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"recorded {kind!r} draw has shape {arr.shape}, "
                             f"asked for {tuple(shape)}")
        return torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(self.device)
