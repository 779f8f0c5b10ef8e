"""Determinism tracing and metric channels (port of
mageslam_tpu/diagnostics/trace.py).

The reference's `mira::determinator` CRC32-hashes intermediate state at ~40
pipeline callsites; a recorded hash stream lets a later run be compared
against it checkpoint by checkpoint (analysis/determinator.h:16-61:
correctness is bit-identical replay). `FIRE_OBJECT_TRACE` publishes typed
per-frame metric points (analysis/object_trace.h, Analysis/DataPoints.h:14-32).

`hash_tree` CRCs the host copy of a tree of tensors, numpy arrays and Python
scalars: each leaf is fetched once a checkpoint, so diagnostics stay off the
hot path and opt-in, like the reference's debug-only macros. The leaves come
in the JAX package's order (`leaves`): NamedTuple fields in order, dict keys
sorted, `None` no leaf, a Python scalar a 0-d array. The same data hashes to
the same CRC in both packages.
"""

from __future__ import annotations

import functools
import json
import zlib
from collections import defaultdict
from typing import Any, Callable

import numpy as np
import torch


def leaf_array(leaf: Any) -> np.ndarray:
    """A leaf as a host numpy array: a tensor's `.cpu().numpy()`, else
    `np.asarray`."""
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """`fn` over every leaf, keeping the containers: a NamedTuple stays its
    type, a dict comes back with its keys sorted, a list or tuple stays one,
    `None` stays `None`."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def leaves(tree: Any) -> list[np.ndarray]:
    """Every leaf of `tree` as a host array, in `tree_map`'s order."""
    out: list[np.ndarray] = []
    tree_map(lambda leaf: out.append(leaf_array(leaf)), tree)
    return out


def hash_tree(tree: Any) -> int:
    """CRC32 over the bytes, dtype and shape of every leaf, in order."""
    crc = 0
    for arr in leaves(tree):
        crc = zlib.crc32(arr.tobytes(), crc)
        crc = zlib.crc32(str(arr.dtype).encode(), crc)
        crc = zlib.crc32(str(arr.shape).encode(), crc)
    return crc


class Determinator:
    """DETERMINISTIC_CHECK: in record mode each checkpoint appends
    (name, hash); after `load_for_verify` each checkpoint is also compared
    with the recording at the same index, and a mismatch (or a checkpoint
    past the recording's end) is kept in `divergences`."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._stream: list[tuple[str, int]] = []
        self._expected: list[tuple[str, int]] | None = None
        self._cursor = 0
        self.divergences: list[dict] = []

    def check(self, name: str, *trees: Any) -> None:
        if not self.enabled:
            return
        h = 0
        for t in trees:
            h = (h * 1000003 + hash_tree(t)) & 0xFFFFFFFF
        self._stream.append((name, h))
        if self._expected is not None:
            if self._cursor >= len(self._expected):
                self.divergences.append(
                    {"index": self._cursor, "name": name, "reason": "extra checkpoint"})
            else:
                exp_name, exp_hash = self._expected[self._cursor]
                if exp_name != name or exp_hash != h:
                    self.divergences.append({
                        "index": self._cursor, "name": name,
                        "expected": [exp_name, exp_hash], "got": [name, h],
                    })
            self._cursor += 1

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self._stream, f)

    def load_for_verify(self, path: str) -> None:
        with open(path) as f:
            self._expected = [tuple(x) for x in json.load(f)]
        self._cursor = 0
        self.divergences = []

    @property
    def is_deterministic(self) -> bool:
        return not self.divergences


class MetricChannels:
    """FIRE_OBJECT_TRACE: named channels of (frame_id, value) points, with
    subscriber callbacks."""

    def __init__(self):
        self._points: dict[str, list[tuple[int, float]]] = defaultdict(list)
        self._subs: dict[str, list[Callable[[int, float], None]]] = defaultdict(list)

    def fire(self, channel: str, frame_id: int, value: float) -> None:
        self._points[channel].append((int(frame_id), float(value)))
        for cb in self._subs[channel]:
            cb(int(frame_id), float(value))

    def subscribe(self, channel: str, cb: Callable[[int, float], None]) -> None:
        self._subs[channel].append(cb)

    def points(self, channel: str) -> list[tuple[int, float]]:
        return list(self._points[channel])

    def channels(self) -> list[str]:
        return sorted(self._points)


def _summarize(x: Any) -> Any:
    """A leaf as {shape, dtype, crc32 of its bytes}, or its repr (cut to
    200 characters) where it is no array."""
    try:
        arr = leaf_array(x)
        if arr.dtype == object:
            raise TypeError
        return {"shape": list(arr.shape), "dtype": str(arr.dtype),
                "crc": zlib.crc32(arr.tobytes())}
    except Exception:
        return repr(x)[:200]


def xray(name: str, sink: list | None = None):
    """XRAY_FUNCTION (arcana/analysis/xray.h:28-43): a decorator recording a
    function's inputs and outputs for offline diffing, each array as
    (shape, dtype, crc32) to keep the records bounded. Records go to `sink`
    where given, else to `xray.records`."""
    target = sink if sink is not None else xray.records

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            target.append({
                "scope": name,
                "inputs": [tree_map(_summarize, a) for a in args],
                "outputs": tree_map(_summarize, out),
            })
            return out

        return wrapper

    return deco


xray.records = []
