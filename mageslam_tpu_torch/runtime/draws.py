"""The random draws of mono init and vocabulary training, as inputs.

The reference splits `jax.random` keys and draws Gumbel noise inside
`try_initialize_pair` (B, 5, N), `pnp_ransac` (H, M, in
`validate_third_frame`) and `train_vocabulary` (N,), for the adoption's
vocabulary and for the retrain. Torch cannot reproduce those streams, so
the port's functions take the draws themselves, and a session asks its
draw source for each, by kind, in the order the reference draws them:

- `GeneratorDraws`: Gumbel noise as -log(Exponential(1)) from a
  `torch.Generator` on the session's device, seeded by the session's
  `seed`: the default, no global RNG state;
- `ReplayDraws`: recorded draws handed out in order, so that the port
  draws what a recorded session drew (`from_npz` reads the ones that
  `tools/export_jax_state.py init` stores).
"""

from __future__ import annotations

import numpy as np
import torch

# the kinds a session asks for: RANSAC samples (B, 5, N), third-frame PnP
# hypotheses (H, M), vocabulary seeds (N,)
KINDS = ("init", "pnp", "vocab")


class GeneratorDraws:
    """Gumbel draws from a seeded generator on `device`."""

    def __init__(self, seed: int, device):
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(int(seed))
        self.device = torch.device(device)

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
        self.device = torch.device(device)

    @classmethod
    def from_npz(cls, path: str, device) -> "ReplayDraws":
        """The draws `tools/export_jax_state.py init` stored with the keys
        they came from: `init_att{j}_draws`, `init_third{j}_draws`,
        `init_vocab{j}_draws`."""
        prefixes = {"init": "init_att", "pnp": "init_third", "vocab": "init_vocab"}
        with np.load(path) as z:
            draws = {}
            for kind, prefix in prefixes.items():
                j, arrays = 0, []
                while f"{prefix}{j}_draws" in z.files:
                    arrays.append(z[f"{prefix}{j}_draws"])
                    j += 1
                draws[kind] = arrays
        return cls(draws, device)

    def remaining(self) -> dict[str, int]:
        return {k: len(q) for k, q in self.queues.items()}

    def gumbel(self, kind: str, shape: tuple[int, ...]) -> torch.Tensor:
        if not self.queues.get(kind):
            raise RuntimeError(f"no recorded {kind!r} draw left")
        arr = self.queues[kind].pop(0)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"recorded {kind!r} draw has shape {arr.shape}, "
                             f"asked for {tuple(shape)}")
        return torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(self.device)
