"""Per-stage full I/O capture for offline diffing, the xray / DataFlow
analog (port of mageslam_tpu/diagnostics/xray.py).

The reference serializes a stage's complete inputs and outputs as JSON via
cereal so two runs can be diffed offline (arcana xray: Dependencies/Arcana/
Shared/arcana/analysis/xray.h:28-43, used e.g. at Map/ThreadSafeMap.cpp:879-
883) and captures byte-level stage I/O through `DataFlow` declarations
(Core/MAGESLAM/Source/Analysis/DataFlow.h:14-66).

`XRay.capture(stage, inputs, outputs)` fetches both trees once and writes
one self-describing JSON document a call: every leaf with its dtype, shape
and full data, NamedTuples as dicts of their fields with a `__type__`. The
document is the JAX package's for the same data (dict keys sorted, the
NamedTuple and field names the same), so `diff_dumps` compares a capture of
this package with one of the JAX package leaf by leaf, with an absolute
tolerance, and reports the first and worst divergences.

Wired sites (a session's `attach_xray`): the global BA's window and
write-back ("GlobalBA") and loop detection ("LoopClosure.Detect").
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

from .trace import leaf_array, tree_map


def _encode_tree(tree: Any) -> Any:
    """A tree of host arrays → JSON-able: leaves become {"dtype", "shape",
    "data"}; containers keep their structure (NamedTuples become dicts of
    fields)."""
    if tree is None:
        return None
    if hasattr(tree, "_asdict"):
        return {"__type__": type(tree).__name__,
                **{k: _encode_tree(v) for k, v in tree._asdict().items()}}
    if isinstance(tree, dict):
        return {k: _encode_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_encode_tree(v) for v in tree]
    arr = np.asarray(tree)
    return {"dtype": str(arr.dtype), "shape": list(arr.shape),
            "data": arr.tolist()}


def _iter_leaves(enc: Any, path: str = ""):
    """Yield (path, dtype, shape, ndarray) for every encoded leaf."""
    if enc is None:
        return
    if isinstance(enc, dict):
        if "dtype" in enc and "shape" in enc and "data" in enc:
            arr = np.asarray(enc["data"], dtype=enc["dtype"]).reshape(enc["shape"])
            yield path, enc["dtype"], tuple(enc["shape"]), arr
            return
        for k, v in enc.items():
            if k == "__type__":
                continue
            yield from _iter_leaves(v, f"{path}.{k}" if path else k)
        return
    if isinstance(enc, list):
        for i, v in enumerate(enc):
            yield from _iter_leaves(v, f"{path}[{i}]")


class XRay:
    """Opt-in stage I/O recorder.

    directory: where capture files go (one JSON a capture,
    `<seq>_<stage>.json`). stages: the stage names to capture, or None for
    all. Attach to a session with `session.attach_xray(xray)`; every wired
    site then dumps its full input and output trees."""

    def __init__(self, directory: str, stages=None):
        self.directory = directory
        self.stages = set(stages) if stages is not None else None
        self.seq = 0
        os.makedirs(directory, exist_ok=True)

    def wants(self, stage: str) -> bool:
        return self.stages is None or stage in self.stages

    def capture(self, stage: str, inputs: Any, outputs: Any) -> str | None:
        """Fetch and dump one stage call. Returns the file's path (None where
        the stage is filtered out)."""
        if not self.wants(stage):
            return None
        doc = {
            "stage": stage,
            "seq": self.seq,
            "inputs": _encode_tree(tree_map(leaf_array, inputs)),
            "outputs": _encode_tree(tree_map(leaf_array, outputs)),
        }
        path = os.path.join(self.directory, f"{self.seq:06d}_{stage}.json")
        with open(path, "w") as f:
            json.dump(doc, f)
        self.seq += 1
        return path


def diff_dumps(path_a: str, path_b: str, atol: float = 0.0,
               max_report: int = 16) -> list[dict]:
    """Offline diff of two xray captures: leaf by leaf, returning divergence
    records {"path", "kind", ...}, empty where the captures match within
    atol. `kind` is "missing" (a leaf in one capture only), "shape/dtype" or
    "value" (float leaves: the count past atol and the largest difference;
    other leaves: the count of unequal entries)."""
    with open(path_a) as f:
        a = json.load(f)
    with open(path_b) as f:
        b = json.load(f)
    out: list[dict] = []
    for side in ("inputs", "outputs"):
        la = {p: (d, s, arr) for p, d, s, arr in _iter_leaves(a.get(side))}
        lb = {p: (d, s, arr) for p, d, s, arr in _iter_leaves(b.get(side))}
        for p in sorted(set(la) | set(lb)):
            if len(out) >= max_report:
                return out
            if p not in la or p not in lb:
                out.append({"path": f"{side}.{p}", "kind": "missing",
                            "present_in": "a" if p in la else "b"})
                continue
            da, sa, va = la[p]
            db, sb, vb = lb[p]
            if sa != sb or da != db:
                out.append({"path": f"{side}.{p}", "kind": "shape/dtype",
                            "a": [da, list(sa)], "b": [db, list(sb)]})
                continue
            if va.dtype.kind in "fc":
                delta = np.abs(va.astype(np.float64) - vb.astype(np.float64))
                bad = delta > atol
                if bad.any():
                    out.append({
                        "path": f"{side}.{p}", "kind": "value",
                        "n_diff": int(bad.sum()),
                        "max_abs_delta": float(delta.max()),
                    })
            elif not np.array_equal(va, vb):
                out.append({"path": f"{side}.{p}", "kind": "value",
                            "n_diff": int((va != vb).sum())})
    return out
