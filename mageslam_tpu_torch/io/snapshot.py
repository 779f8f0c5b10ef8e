"""Session snapshots on disk, in the reference's format (port of
mageslam_tpu/io/snapshot.py).

One `.npz`: the leaves of `MapState`, `TrackingHistory`, `PoseHistory` and
the bag-of-words `BowIndex` under `map{i}`, `hist{i}`, `ph{i}` and `bow{i}`
in declaration order (descriptor words as uint32; interop.py), and the host
counters as JSON under `meta_json` with the reference's keys. The JAX
package's `load_session_snapshot` reads a file written here, and
`load_session_snapshot` here reads one written there.

The port's own state rides under names the reference's loader does not
read: `port_meta_json` (the vocabulary's `retrained` flag and pooled frame
count, the loop counters, the draw source's kind and position),
`port_pool_desc{j}` / `port_pool_valid{j}` (the vocabulary's training pool)
and `port_draws_state` (a generator's state; the card's and the CPU's
states differ in kind). A JAX file has none of them;
loading one follows the reference's load path, which leaves the session's
training pool and `retrained` flag as they are (where
`SlamSession.from_jax_snapshot` counts an initialized snapshot as
retrained).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..interop import BOW_PREFIX, PREFIXES, load_jax_snapshot, to_numpy
from ..runtime.draws import GeneratorDraws, ReplayDraws

# the reference's meta_json keys, in its order (mageslam_tpu/io/snapshot.py:41-50)
META_KEYS = ("initialized", "lost_count", "frames_since_keyframe", "frames_since_reloc",
             "map_scale", "last_kf_slot", "width", "height")


def _leaves(prefix: str, state) -> dict[str, np.ndarray]:
    return {f"{prefix}{i}": arr for i, arr in enumerate(to_numpy(state).values())}


def save_session_snapshot(path: str, session) -> None:
    """Write the session's state to `path` (the queues of its throughput
    entry points are drained first)."""
    session._drain()
    arrays = {}
    for prefix, state in ((PREFIXES[0][0], session.map), (PREFIXES[1][0], session.history),
                          (PREFIXES[2][0], session.pose_history), (BOW_PREFIX, session.bow)):
        arrays.update(_leaves(prefix, state))
    meta = {k: getattr(session, k) for k in META_KEYS}
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    bt = session.bow_training
    port = dict(retrained=bt.retrained, bow_frames=bt.frames,
                n_loops_closed=session.n_loops_closed,
                loop_det_stats=session.loop_det_stats)
    position = session.draws.position()
    if isinstance(session.draws, ReplayDraws):
        port["replay_position"] = position
    else:
        arrays["port_draws_state"] = position.cpu().numpy()
        port["draws_device"] = session.draws.device.type
    for j, (desc, valid) in enumerate(bt.pool):
        arrays[f"port_pool_desc{j}"] = desc.cpu().numpy().view(np.uint32)
        arrays[f"port_pool_valid{j}"] = valid.cpu().numpy()
    arrays["port_meta_json"] = np.frombuffer(json.dumps(port).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_session_snapshot(path: str, session, restore_draws: bool = True) -> None:
    """Restore the state `path` holds into `session` (same settings and
    image size), from a file of either package. The queues of the
    throughput entry points are cleared.

    A port file's draw position goes into the session's draw source, which
    must be of the kind that saved it: replayed draws into `ReplayDraws`, a
    generator's state into a `GeneratorDraws` on the same kind of device.
    Where it cannot, this raises `ValueError` before anything is restored,
    unless `restore_draws=False`: the session then keeps its own draws and
    takes other relocalization draws than the saved run would have."""
    with np.load(path) as z:
        port = (json.loads(bytes(z["port_meta_json"]).decode())
                if "port_meta_json" in z.files else None)
    if restore_draws and port is not None:
        _check_draws(port, session.draws)
    m, hist, ph, meta, bow = load_jax_snapshot(path, session.device)
    if (meta["width"], meta["height"]) != (session.width, session.height):
        raise ValueError(f"snapshot image size {meta['width']}x{meta['height']} != "
                         f"{session.width}x{session.height}")
    if m.capacity[2] != session.N:
        raise ValueError(f"snapshot has {m.capacity[2]} feature slots, settings say "
                         f"{session.N}")
    session._clear_queues()
    session.map, session.history, session.pose_history = m, hist, ph
    if bow is not None:
        session.bow = bow
    session.initialized = bool(meta["initialized"])
    session.lost_count = int(meta["lost_count"])
    session.frames_since_keyframe = int(meta["frames_since_keyframe"])
    session.frames_since_reloc = int(meta["frames_since_reloc"])
    session.map_scale = float(meta["map_scale"])
    session.last_kf_slot = int(meta["last_kf_slot"])
    if port is None:
        return
    with np.load(path) as z:
        bt = session.bow_training
        bt.retrained, bt.frames = bool(port["retrained"]), int(port["bow_frames"])
        bt.pool = []
        j = 0
        while f"port_pool_desc{j}" in z.files:
            bt.pool.append((torch.from_numpy(z[f"port_pool_desc{j}"].view(np.int32)).to(
                session.device), torch.from_numpy(z[f"port_pool_valid{j}"]).to(session.device)))
            j += 1
        session.n_loops_closed = int(port["n_loops_closed"])
        session.loop_det_stats = {**session.loop_det_stats, **port["loop_det_stats"]}
        if not restore_draws:
            return
        if "replay_position" in port:
            session.draws.seek(port["replay_position"])
        else:
            session.draws.seek(torch.from_numpy(z["port_draws_state"]))


def _check_draws(port: dict, draws) -> None:
    """Raise where the saved draw position cannot go into `draws`."""
    if "replay_position" in port:
        saved, fits = "replayed draws", isinstance(draws, ReplayDraws)
    else:
        saved = f"a {port['draws_device']} generator's state"
        fits = (isinstance(draws, GeneratorDraws)
                and draws.device.type == port["draws_device"])
    if not fits:
        where = (f"a {draws.device.type} generator" if isinstance(draws, GeneratorDraws)
                 else type(draws).__name__)
        raise ValueError(f"the snapshot holds {saved}, which cannot go into {where}; "
                         f"pass restore_draws=False to keep the session's own draws")
