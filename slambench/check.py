"""What decides `correct`: the timed path's own outputs, captured during the
window from a sample drawn from the seed, and held against the plain
reference in `slambench/reference/` once the window has closed.

Three numbers are compared, each against its limit in `limits.json`:

- `frontend_mismatch`: the share of the sampled frames' keypoint slots
  whose validity, position, octave or any descriptor bit differs from the
  reference frontend's on the same uint8 frame (from the generator).
- `pose_gap_px`: over the sampled frames' final motion-only refinement (the
  track step's second stage), the largest RMS distance, in pixels, between
  the projections of the refinement's points under the program's pose and
  under the reference's float64 refinement of the same problem.
- `ba_gap_px`: over the sampled mapping events' local bundle adjustment, the
  largest RMS distance, in pixels, between each active observation's
  projection under the program's result and under the reference's float64
  run of the same problem; in cells whose traffic maps in the window.
- `match_mismatch`: over the sampled matcher calls (the guided radius
  matches of the track step and the mapping step, the two-way matches of a
  mapping event's new points, the bag-of-words word assignment), the share
  of answers, where either side gives one, whose index or distance differs
  from the reference matcher's on the same inputs.

The refinement and the bundle adjustment start from the program's own
state (its map and its association set at that frame): the reference
follows the program step by step there, and the matches that make that
association set are held by `match_mismatch`. `control=True` puts the
reference, computed in TF32, in the program's place; the matchers compute
no product, so there the control is the reference itself.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import os
import random

import torch

from .reference import frontend as ref_frontend
from .reference import lm as ref_lm
from .reference import matching as ref_matching
from .trace import RADIUS_CALLS, Patches

HERE = os.path.dirname(os.path.abspath(__file__))


def limits() -> dict:
    with open(os.path.join(HERE, "limits.json")) as f:
        return {k: float(v) for k, v in json.load(f)["limits"].items()}


class Reservoir:
    """A uniform sample of at most `k` items of a stream, drawn from `rng`;
    `offer(make)` calls `make()` only for an item it keeps."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, make) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = make()


def _clone(tree):
    if torch.is_tensor(tree):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(*(_clone(t) for t in tree)) if hasattr(tree, "_fields") \
            else type(tree)(_clone(t) for t in tree)
    return tree


# the matchers the session looks up, by (module key, function name), and
# the reference that answers each kind
MATCH_CALLS = {
    "radius": RADIUS_CALLS,
    "two_way": (("new_points", "match_two_way"), ("relocalization", "match_two_way")),
    "bow": (("bow_words", "assign"),),
}
MATCH_REFERENCE = {"radius": ref_matching.radius_match_stages,
                   "two_way": ref_matching.match_two_way, "bow": ref_matching.assign_words}


class Capture(Patches):
    """Wraps the functions the session looks up, records a sample of their
    calls while `active`, and puts the originals back on `close()`. A kept
    call is copied on the device; nothing is read back to the host until
    the window has closed."""

    SAMPLES = {"frontend": 6, "pose": 12, "ba": 4, "radius": 12, "two_way": 4, "bow": 4}

    def __init__(self, seed: int, modules: dict):
        super().__init__()
        rng = random.Random(seed * 1_000_003 + 12_345)
        self.sample = {k: Reservoir(n, rng) for k, n in self.SAMPLES.items()}
        self.active = False
        self.next_frame = 0       # the pass-bank index of the next frontend call
        self._pose_calls = 0
        m = modules
        for mod in (m["session"], m["streaming"]):
            self.wrap(mod, "detect_and_compute", self._frontend)
        self.wrap(m["track_local_map"], "optimize_pose", self._pose)
        self.wrap(m["mapping_step"], "step_bundle_adjust", self._ba)
        for kind, calls in MATCH_CALLS.items():
            for mod, name in calls:
                self.wrap(m[mod], name, self._match(kind))

    def _frontend(self, orig):
        def wrapped(*args, **kwargs):
            out = orig(*args, **kwargs)
            idx = self.next_frame
            self.next_frame += 1
            if self.active:
                self.sample["frontend"].offer(lambda: (idx, _clone(out)))
            return out
        return wrapped

    def _pose(self, orig):
        def wrapped(pose, intrinsics, points, uv, info, huber_width=1.8, num_iters=10):
            out = orig(pose, intrinsics, points, uv, info, huber_width=huber_width,
                       num_iters=num_iters)
            self._pose_calls += 1
            if self.active and self._pose_calls % 2 == 0:   # the second stage
                self.sample["pose"].offer(lambda: _clone({
                    "R0": pose.R, "t0": pose.t, "cam": intrinsics, "points": points,
                    "uv": uv, "info": info, "huber": float(huber_width),
                    "iters": int(num_iters), "R": out[0].R, "t": out[0].t}))
            return out
        return wrapped

    def _ba(self, orig):
        def wrapped(problem, state, widths, max_error_sq, *args, **kwargs):
            out = orig(problem, state, widths, max_error_sq, *args, **kwargs)
            if self.active:
                self.sample["ba"].offer(lambda: _clone({
                    "problem": {
                        "poses_R": problem.poses.R, "poses_t": problem.poses.t,
                        "intrinsics": problem.intrinsics, "cam_fixed": problem.cam_fixed,
                        "cam_valid": problem.cam_valid, "points": problem.points,
                        "pt_valid": problem.pt_valid, "obs_cam": problem.obs_cam,
                        "obs_pt": problem.obs_pt, "obs_uv": problem.obs_uv,
                        "obs_info": state.obs_info},
                    "tether_weight": problem.tether_weight,
                    "widths": [float(w) for w in widths], "max_error_sq": float(max_error_sq),
                    "R": out[0].poses.R, "t": out[0].poses.t, "X": out[0].points}))
            return out
        return wrapped

    def _match(self, kind):
        sig = inspect.signature(MATCH_REFERENCE[kind])   # the program's names and order

        def make(orig):

            def wrapped(*args, **kwargs):
                out = orig(*args, **kwargs)
                if self.active:
                    def keep():
                        call = sig.bind(*args, **kwargs)
                        call.apply_defaults()
                        return _clone({"args": dict(call.arguments), "out": out})
                    self.sample[kind].offer(keep)
                return out
            return wrapped
        return make


def _project(R, t, cam, X):
    Xc = (R @ X[..., None])[..., 0] + t
    z = Xc[..., 2]
    return torch.stack([cam[..., 0] * Xc[..., 0] / z + cam[..., 2],
                        cam[..., 1] * Xc[..., 1] / z + cam[..., 3]], -1)


def _rms(a, b) -> float:
    d = (a - b).double()
    return float(torch.sqrt(torch.mean(torch.sum(d * d, -1)))) if d.numel() else 0.0


def frontend_mismatch(items, bank, fes, cam, max_features: int, control: bool) -> float | None:
    """Share of the reference's valid slots (or the program's) that differ."""
    if not items:
        return None
    fes_d = dataclasses.asdict(fes)
    bad = total = 0
    for idx, out in items:
        ref = ref_frontend.detect(bank[idx], fes_d, cam, max_features, "f32")
        got = ({"xy": out.xy, "und_xy": out.und_xy, "octave": out.octave, "desc": out.desc,
                "valid": out.valid} if not control else
               ref_frontend.detect(bank[idx], fes_d, cam, max_features, "tf32"))
        either = ref["valid"] | got["valid"]
        same = ((ref["valid"] == got["valid"])
                & torch.all(ref["xy"] == got["xy"], -1)
                & (torch.abs(ref["und_xy"] - got["und_xy"]).amax(-1) <= 1e-3)
                & (ref["octave"] == got["octave"])
                & torch.all(ref["desc"] == got["desc"], -1))
        bad += int((either & ~same).sum())
        total += int(either.sum())
    return bad / max(total, 1)


def pose_gap_px(items, control: bool) -> float | None:
    if not items:
        return None
    worst = 0.0
    for c in items:
        args = (c["R0"], c["t0"], c["cam"], c["points"], c["uv"], c["info"], c["huber"],
                c["iters"])
        R_ref, t_ref = ref_lm.optimize_pose(*args, prec="f64")
        if control:
            R_got, t_got = ref_lm.optimize_pose(*args, prec="tf32")
        else:
            R_got, t_got = c["R"], c["t"]
        keep = c["info"] > 0
        X = c["points"][keep].double()
        cam = c["cam"].double()
        worst = max(worst, _rms(_project(R_got.double(), t_got.double(), cam, X),
                                _project(R_ref, t_ref, cam, X)))
    return worst


def ba_gap_px(items, control: bool) -> float | None:
    if not items:
        return None
    worst = 0.0
    for c in items:
        if int((c["tether_weight"] > 0).sum()):
            raise ValueError("the reference bundle adjustment holds no tethers")
        p = c["problem"]
        R_ref, t_ref, X_ref, _ = ref_lm.bundle_adjust(p, c["widths"], c["max_error_sq"], "f64")
        if control:
            R_got, t_got, X_got, _ = ref_lm.bundle_adjust(p, c["widths"], c["max_error_sq"],
                                                          "tf32")
        else:
            R_got, t_got, X_got = c["R"], c["t"], c["X"]
        oc, op = p["obs_cam"].long(), p["obs_pt"].long()
        act = (p["obs_info"] > 0) & p["cam_valid"][oc] & p["pt_valid"][op]
        oc, op = oc[act], op[act]
        cam = p["intrinsics"].double()[oc]
        a = _project(R_got.double()[oc], t_got.double()[oc], cam, X_got.double()[op])
        b = _project(R_ref[oc], t_ref[oc], cam, X_ref[op])
        worst = max(worst, _rms(a, b))
    return worst


def _answers(kind: str, out):
    """The answers of one matcher call as (index, distance) tensors; the
    word assignment gives no distance."""
    return (out, out) if kind == "bow" else out


def match_mismatch(samples: dict, control: bool) -> tuple[float | None, dict]:
    """Share of the sampled matcher answers, where either side gives one,
    that differ from the reference's; and the counts by kind. Under the
    control the reference stands in the program's place."""
    bad = total = 0
    counts = {}
    for kind, items in samples.items():
        k_bad = k_total = 0
        for c in items:
            ref_idx, ref_dist = _answers(kind, MATCH_REFERENCE[kind](**c["args"]))
            got_idx, got_dist = (ref_idx, ref_dist) if control else _answers(kind, c["out"])
            either = (ref_idx >= 0) | (got_idx >= 0)
            differ = (ref_idx != got_idx) | (ref_dist != got_dist)
            k_bad += int((either & differ).sum())
            k_total += int(either.sum())
        counts[kind] = {"calls": len(items), "answers": k_total, "differ": k_bad}
        bad, total = bad + k_bad, total + k_total
    if not any(samples.values()):
        return None, counts
    return bad / max(total, 1), counts


def planted_match_fault(capture: Capture) -> float | None:
    """`match_mismatch` with a fault planted where each sampled matcher call
    produced its answer: its first answer moved to the next target (or, for
    a word, the next word). The reading an altered answer gives at the
    cell's own size."""
    altered = {}
    for kind in MATCH_CALLS:
        items = []
        for c in capture.sample[kind].items:
            idx, dist = _answers(kind, c["out"])
            idx = idx.clone()
            hit = torch.nonzero(idx.reshape(-1) >= 0)
            if len(hit):
                idx.view(-1)[int(hit[0])] += 1
            items.append({"args": c["args"], "out": idx if kind == "bow" else (idx, dist)})
        altered[kind] = items
    return match_mismatch(altered, control=False)[0]


def compare(capture: Capture, bank, fes, cam, max_features: int, expects_mapping: bool,
            control: bool = False) -> dict:
    """The compared numbers as {name: value or None}; None where the cell
    has nothing of that kind to compare (a traffic that maps nothing).
    `capture.match_counts` is left with the matcher answers by kind."""
    s = {k: r.items for k, r in capture.sample.items()}
    out = {"frontend_mismatch": frontend_mismatch(s["frontend"], bank, fes, cam, max_features,
                                                  control),
           "pose_gap_px": pose_gap_px(s["pose"], control)}
    if expects_mapping:
        out["ba_gap_px"] = ba_gap_px(s["ba"], control)
    out["match_mismatch"], capture.match_counts = match_mismatch(
        {k: s[k] for k in MATCH_CALLS}, control)
    return out


def verdict(numbers: dict, lim: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}). A number the cell should have
    and has not (nothing captured) fails."""
    table = {k: {"value": v, "limit": lim[k]} for k, v in numbers.items()}
    ok = all(v is not None and v <= lim[k] for k, v in numbers.items())
    return ok, table
