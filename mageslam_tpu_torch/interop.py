"""State carried across from the JAX package.

`mageslam_tpu.io.snapshot.save_session_snapshot` writes one `.npz` with the
leaves of `MapState`, `TrackingHistory` and `PoseHistory` under `map{i}`,
`hist{i}` and `ph{i}` (NamedTuple declaration order, a `Pose` flattened as
R then t) and the host counters as JSON in `meta_json`. The leaf-to-field
map here comes from the port's own field lists, which keep the reference's
order. Descriptor words cross as int32 tensors with the same bits as the
reference's uint32; `to_numpy` turns them back.
"""

from __future__ import annotations

import json
import typing

import numpy as np
import torch

from .geometry.se3 import Pose
from .runtime.pose_history import PoseHistory
from .tracking.frame_state import TrackingHistory
from .worldmap.map_state import MapState

# prefix of each state's leaves in the snapshot file
PREFIXES = (("map", MapState), ("hist", TrackingHistory), ("ph", PoseHistory))
# int32 fields that hold the reference's uint32 descriptor words
DESCRIPTOR_FIELDS = frozenset({"kf_desc", "mp_desc", "desc"})


def _pose_fields(cls) -> set[str]:
    return {name for name, ann in typing.get_type_hints(cls).items() if ann is Pose}


def leaf_names(cls) -> list[str]:
    """Leaf names of a state NamedTuple in flatten order; a Pose field
    `f` contributes `f.R` and `f.t`."""
    poses = _pose_fields(cls)
    names = []
    for f in cls._fields:
        names.extend([f"{f}.R", f"{f}.t"] if f in poses else [f])
    return names


def _to_tensor(name: str, arr: np.ndarray, device) -> torch.Tensor:
    if arr.dtype == np.uint32:
        if name.split(".")[0] not in DESCRIPTOR_FIELDS:
            raise TypeError(f"unexpected uint32 leaf {name}")
        arr = arr.view(np.int32)
    elif arr.dtype not in (np.int32, np.float32, np.bool_):
        raise TypeError(f"unexpected dtype {arr.dtype} for leaf {name}")
    return torch.from_numpy(arr.copy()).to(device)   # copy keeps 0-d leaves 0-d


def _unflatten(cls, prefix: str, data, device):
    names = leaf_names(cls)
    if f"{prefix}{len(names)}" in data or f"{prefix}{len(names) - 1}" not in data:
        raise ValueError(f"snapshot '{prefix}*' leaves do not match {cls.__name__}")
    leaves = {n: _to_tensor(n, data[f"{prefix}{i}"], device)
              for i, n in enumerate(names)}
    poses = _pose_fields(cls)
    return cls(*(Pose(leaves[f"{f}.R"], leaves[f"{f}.t"]) if f in poses
                 else leaves[f] for f in cls._fields))


def load_jax_snapshot(path: str, device="cpu"):
    """Read a snapshot written by the JAX package's save_session_snapshot.
    Returns (MapState, TrackingHistory, PoseHistory, meta dict) with tensors
    on `device`. BoW (`bow*`) and RNG key (`key*`) leaves are ignored: the
    bag-of-words index is not ported yet."""
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    states = [_unflatten(cls, prefix, data, device) for prefix, cls in PREFIXES]
    meta = json.loads(bytes(data["meta_json"]).decode())
    return (*states, meta)


def to_numpy(state) -> dict[str, np.ndarray]:
    """{leaf name: array} of a state NamedTuple in flatten order, with the
    descriptor fields back as uint32 views."""
    poses = _pose_fields(type(state))
    out = {}
    for f in type(state)._fields:
        value = getattr(state, f)
        parts = ({f"{f}.R": value.R, f"{f}.t": value.t} if f in poses
                 else {f: value})
        for name, t in parts.items():
            arr = t.detach().cpu().numpy()
            out[name] = arr.view(np.uint32) if f in DESCRIPTOR_FIELDS else arr
    return out
