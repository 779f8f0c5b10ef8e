"""Scaling over several devices (port of mageslam_tpu/parallel).

The reference shards with `jax.sharding` under one controller: one Python
process drives every device, and the session calls the sharded global BA
from inside its own loop. The port keeps that shape: a `Mesh` is an ordered
tuple of `torch.device`s with an axis name, and one process walks its
shards, each shard's work issued on that shard's device (asynchronously, so
shards on distinct cards overlap). A mesh may repeat a device, as the
reference's tests run 8 virtual CPU devices: `[cuda:0] * 4` runs 4 shards
on one card, one after another.

The collectives: `psum` moves each shard's partial to the mesh's first
device and adds them in shard order 0..d-1, a fixed order, so the sum is
deterministic; `all_gather` concatenates in shard order there.

- `multi_session.batched_track_step`: a batch of independent sessions'
  tracking step, the batch split over the mesh;
- `sharded_matching.make_sharded_guided_matcher`: the map-point bank split
  over the mesh, each shard's per-target best from `ops/local_best.py`;
- `sharded_ba`: the global BA's Schur system split over the point axis.

The pipeline form, mapping on a second stream beside tracking, is the
session's `enable_mapping_offload` (runtime/session.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import torch

from ..interop import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A one-axis device mesh: the counterpart of a one-axis
    `jax.sharding.Mesh`."""

    devices: tuple[torch.device, ...]
    axis: str

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis: len(self.devices)}


def make_session_mesh(devices=None, name: str = "sessions") -> Mesh:
    """A mesh over `devices` (torch devices or their names, repeats allowed),
    by default every visible CUDA device; without a card the default
    raises."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = tuple(resolve_device(d) for d in devices)
    devs = tuple(torch.device("cuda", torch.cuda.current_device())
                 if d.type == "cuda" and d.index is None else d for d in devs)
    if not devs:
        raise ValueError("make_session_mesh: no devices")
    return Mesh(devs, name)


def mesh_devices(device) -> list[torch.device]:
    """The devices a session on `device` shards its global BA over: every
    visible CUDA device for a CUDA session, the device alone otherwise.
    Tests and chip_smoke.py replace it to run several shards on one
    device, as the reference's tests use virtual CPU devices."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def on(device: torch.device):
    """A context that makes `device` the current CUDA device (nothing on the
    CPU): the kernel wrappers launch on the current device."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def tree_map(fn, tree, *rest):
    """`fn(leaf, *leaves)` on every tensor of equal-structure trees of
    NamedTuples, tuples and lists; other leaves are kept from `tree`."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, (tuple, list)):
        parts = [tree_map(fn, *vs) for vs in zip(tree, *rest)]
        return type(tree)(*parts) if hasattr(tree, "_fields") else type(tree)(parts)
    return tree


def tree_stack(trees: list):
    """Stack equal-structure trees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def psum(parts: list[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The shards' partials summed on the mesh's first device, in shard
    order."""
    dev = mesh.devices[0]
    total = parts[0].to(dev)
    for p in parts[1:]:
        total = total + p.to(dev)
    return total


def all_gather(parts: list[torch.Tensor], mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """The shards' blocks concatenated in shard order on the first device."""
    return torch.cat([p.to(mesh.devices[0]) for p in parts], dim=dim)


from .multi_session import batched_track_step  # noqa: E402,F401
from .sharded_ba import (make_sharded_lm_iteration, make_sharded_lm_solver,  # noqa: E402,F401
                         make_sharded_step_bundle_adjust)
from .sharded_matching import make_sharded_guided_matcher  # noqa: E402,F401
