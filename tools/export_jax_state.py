"""Export a JAX session's tracking state and its reference outputs for the
PyTorch port (`mageslam_tpu_torch`).

Runs the JAX `SlamSession` through `process_frame` over bench.py's world
(`build_world(RandomState(7))`, 640x480, cam [520, 520, 320, 240], golden
settings) on the local CPU. After frame `SNAP_FRAME` it saves the session with
`mageslam_tpu.io.snapshot.save_session_snapshot`; over frames
`SNAP_FRAME+1 .. LAST_FRAME` it records what the JAX session computes per
frame (pose R/t, tracked count, keyframe flag, tracking state, and the frame's
keypoint -> map point associations). Both go into one `.npz`: the snapshot's
own keys plus `ref_*` keys.

The window is chosen so that no keyframe fires inside it except at its last
frame: mapping runs after a frame's pose and keyframe decision are made, so a
tracking-only session reproduces every output of the window.

A second file holds the reference for keyframe mapping: the same session run
on from frame `SNAP_FRAME+1` until `MAP_EVENTS` keyframes have been mapped
and `MAP_TAIL` more frames tracked. It records the per-frame outputs (`ref_*`)
and, for mapping event j, the map and pose history after it
(`ev{j}_post_map{i}`, `ev{j}_post_ph{i}`, leaves in flatten order), the
keyframe's slot and frame id; for the first event also the inputs of the
mapping step (`ev0_pre_map{i}`, `ev0_pre_ph{i}`, `ev0_frame{i}`,
`ev0_map_scale`). The JAX session runs at golden settings, loop closure
as golden has it. The export fails if the map banks grow inside the window.

A third file, from the same run as the second, holds the JAX session's
bag-of-words index after each of those mapping events (`ev{j}_post_bow{i}`).

A fourth file holds the reference for mono init and the bag-of-words
vocabulary: the same session over frames 0..SNAP_FRAME from a bare
`SlamSession` (`init_*` keys): per frame its state, pose R/t, tracked count
and keyframe flag; the anchor and adoption frames; each init attempt's
inputs and `InitResult`; each third-frame check's inputs and verdict; the
index (anchors, idf, keyframe vectors) after adoption and after the
vocabulary retrain. Every key the session split for `try_initialize_pair`,
`validate_third_frame` (its `pnp_ransac`), `train_vocabulary` and the
retrain is stored with the Gumbel draws made from it (float32), in the
order the session used them: the port takes the draws as inputs, since
torch cannot reproduce `jax.random`.

    python tools/export_jax_state.py [track|map|both|bow|init|all]

`both` is track and map, `all` every file. Outputs:
tests/data/torch_port_bench640_f30.npz (track),
tests/data/torch_port_bench640_map.npz (map),
tests/data/torch_port_bench640_bow.npz (bow) and
tests/data/torch_port_bench640_init.npz (init).
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(REPO, "tests", "data", "torch_port_bench640_f30.npz")

MAP_OUT = os.path.join(REPO, "tests", "data", "torch_port_bench640_map.npz")
INIT_OUT = os.path.join(REPO, "tests", "data", "torch_port_bench640_init.npz")
BOW_OUT = os.path.join(REPO, "tests", "data", "torch_port_bench640_bow.npz")

SNAP_FRAME = 30
LAST_FRAME = 54
MAP_EVENTS = 3        # mapped keyframes in the second file's window
MAP_TAIL = 2          # frames tracked after the last of them
MAP_MAX_FRAME = 140   # give up beyond this frame
CAM = (520.0, 520.0, 320.0, 240.0)
DT = 0.033


def bench_frames(stop: int) -> list[np.ndarray]:
    """bench.py's rendered frames 0..stop-1, clipped and cast to uint8."""
    sys.path.insert(0, REPO)
    import bench

    pts, patches = bench.build_world(np.random.RandomState(7))
    return [np.clip(bench.render(pts, patches, i * DT), 0, 255).astype(np.uint8)
            for i in range(stop)]


def make_jax_session():
    import jax.numpy as jnp

    from mageslam_tpu.config import golden_path_settings
    from mageslam_tpu.runtime import SlamSession

    return SlamSession(golden_path_settings(), cam=jnp.asarray(CAM, jnp.float32),
                       image_width=640, image_height=480)


class InitRecorder:
    """Records what a JAX session's mono init and vocabulary training see
    and draw: installed on the pipeline module's functions and on the
    session's own methods while frames 0..SNAP_FRAME run."""

    def __init__(self, sess):
        import jax

        from mageslam_tpu.bow import index as bow_index
        from mageslam_tpu.runtime import pipeline

        self.sess, self.frame = sess, -1
        self.arrays: dict = {}
        self.counts = {"attempt": 0, "third": 0, "vocab": 0}
        self.adopt_frame = self.retrain_frame = -1
        self.anchors: list[int] = []
        self._jit_gumbel = jax.jit(
            lambda keys, shape: jax.vmap(lambda k: jax.random.gumbel(k, shape))(keys),
            static_argnums=1)
        self._restore = [(pipeline, "try_initialize_pair"),
                         (pipeline, "validate_third_frame"),
                         (pipeline, "train_vocabulary"),
                         (bow_index, "retrain_index_jit")]
        self._real = {n: getattr(m, n) for m, n in self._restore}
        pipeline.try_initialize_pair = self._attempt
        pipeline.validate_third_frame = self._third
        pipeline.train_vocabulary = self._vocab
        bow_index.retrain_index_jit = self._retrain
        self._process, self._adopt = sess.process_features, sess._adopt_initialization
        sess.process_features = self._process_features
        sess._adopt_initialization = self._adopt_initialization

    def close(self) -> None:
        for m, n in self._restore:
            setattr(m, n, self._real[n])
        del self.sess.process_features, self.sess._adopt_initialization

    def _put(self, name: str, value) -> None:
        self.arrays[name] = np.asarray(value)

    def _draws(self, key, rows: int, shape: tuple) -> np.ndarray:
        """The Gumbel draws of `rows` keys split from `key`, each of
        `shape`, as the reference's vmapped draw makes them."""
        import jax

        return np.asarray(self._jit_gumbel(jax.random.split(key, rows), shape),
                          np.float32)

    def _process_features(self, feats, timestamp, frame_id, *a, **k):
        self.frame = int(frame_id)
        out = self._process(feats, timestamp, frame_id, *a, **k)
        meta = self.sess.prev_meta
        if not self.sess.initialized and meta is not None and meta[0] == self.frame:
            self.anchors.append(self.frame)
        return out

    def _attempt(self, xy1, desc1, valid1, xy2, desc2, valid2, cam, key, settings,
                 ransac_batch):
        j = self.counts["attempt"]
        self.counts["attempt"] += 1
        res = self._real["try_initialize_pair"](xy1, desc1, valid1, xy2, desc2, valid2,
                                                cam, key, settings,
                                                ransac_batch=ransac_batch)
        n = xy1.shape[0]
        p = f"init_att{j}_"
        self._put(p + "frame", np.int32(self.frame))
        self._put(p + "key", key)
        self._put(p + "draws", self._draws(key, ransac_batch, (5, n)))
        for name, v in (("xy1", xy1), ("desc1", desc1), ("valid1", valid1),
                        ("xy2", xy2), ("desc2", desc2), ("valid2", valid2)):
            self._put(p + name, v)
        self._put(p + "succeeded", res.succeeded)
        self._put(p + "pose2_R", res.pose2.R)
        self._put(p + "pose2_t", res.pose2.t)
        self._put(p + "points", res.points)
        self._put(p + "point_valid", res.point_valid)
        self._put(p + "feat2", res.feat2)
        self._put(p + "match_count", res.match_count)
        return res

    def _third(self, res, anchor_desc, anchor_valid, xy, desc, valid, cam, key,
               **kw):
        j = self.counts["third"]
        self.counts["third"] += 1
        ok = self._real["validate_third_frame"](res, anchor_desc, anchor_valid, xy,
                                                desc, valid, cam, key, **kw)
        p = f"init_third{j}_"
        self._put(p + "frame", np.int32(self.frame))
        self._put(p + "key", key)
        # pnp_ransac's 64 hypotheses, each a Gumbel draw over the M points
        self._put(p + "draws", self._draws(key, 64, (res.points.shape[0],)))
        for name, v in (("xy", xy), ("desc", desc), ("valid", valid),
                        ("anchor_valid", anchor_valid)):
            self._put(p + name, v)
        self._put(p + "ok", ok)
        return ok

    def _vocab_draw(self, key, n: int, where: str) -> None:
        import jax

        j = self.counts["vocab"]
        self.counts["vocab"] += 1
        self._put(f"init_vocab{j}_frame", np.int32(self.frame))
        self._put(f"init_vocab{j}_where", np.bytes_(where))
        self._put(f"init_vocab{j}_key", key)
        self._put(f"init_vocab{j}_draws",
                  np.asarray(jax.jit(jax.random.gumbel, static_argnums=1)(key, (n,)),
                             np.float32))

    def _vocab(self, desc, valid, key, **kw):
        self._vocab_draw(key, desc.shape[0], "adopt")
        return self._real["train_vocabulary"](desc, valid, key, **kw)

    def _retrain(self, index, pool_desc, pool_valid, kf_desc, kf_kp_valid, kf_has, key,
                 **kw):
        self._vocab_draw(key, pool_desc.shape[0], "retrain")
        out = self._real["retrain_index_jit"](index, pool_desc, pool_valid, kf_desc,
                                              kf_kp_valid, kf_has, key, **kw)
        self.retrain_frame = self.frame
        self._put("init_pool_rows", np.int32(pool_desc.shape[0]))
        for name, v in zip(("anchors", "idf", "kf_vectors", "kf_has"), out[:4]):
            self._put(f"init_bow_retrain_{name}", v)
        return out

    def _adopt_initialization(self, res, feats, timestamp, frame_id):
        self._adopt(res, feats, timestamp, frame_id)
        self.adopt_frame = int(frame_id)
        bow = self.sess.bow
        for name, v in zip(("anchors", "idf", "kf_vectors", "kf_has"), bow[:4]):
            self._put(f"init_bow_adopt_{name}", v)

    def result(self) -> dict:
        """The recorded arrays with the counts, the anchor, adoption and
        retrain frames and the session's per-frame outputs."""
        out = dict(self.arrays)
        for k, v in self.counts.items():
            out[f"init_n_{k}"] = np.int32(v)
        out["init_anchor_frames"] = np.asarray(self.anchors, np.int32)
        out["init_adopt_frame"] = np.int32(self.adopt_frame)
        out["init_retrain_frame"] = np.int32(self.retrain_frame)
        rs = self.sess.results
        nan_R, nan_t = np.full((3, 3), np.nan, np.float32), np.full(3, np.nan, np.float32)
        out["init_ref_frame_id"] = np.asarray([r.frame_id for r in rs], np.int32)
        out["init_ref_state"] = np.asarray([r.state.value for r in rs], np.int32)
        out["init_ref_R"] = np.asarray([nan_R if r.pose is None else np.asarray(r.pose.R)
                                        for r in rs], np.float32)
        out["init_ref_t"] = np.asarray([nan_t if r.pose is None else np.asarray(r.pose.t)
                                        for r in rs], np.float32)
        out["init_ref_tracked"] = np.asarray([r.tracked_count for r in rs], np.int32)
        out["init_ref_is_kf"] = np.asarray([r.is_keyframe for r in rs], bool)
        return out


def run_to_snapshot(frames, snap_path: str):
    """Drive a JAX session over frames 0..SNAP_FRAME and save its snapshot.
    The session's `init_record` holds what `InitRecorder` recorded."""
    from mageslam_tpu.io.snapshot import save_session_snapshot

    sess = make_jax_session()
    rec = InitRecorder(sess)
    try:
        for i in range(SNAP_FRAME + 1):
            sess.process_frame(frames[i], i * DT, i)
    finally:
        rec.close()
    sess.init_record = rec.result()
    save_session_snapshot(snap_path, sess)
    return sess


def record_window(sess, frames, start: int, stop: int) -> dict:
    """Per-frame JAX outputs over frames start..stop-1 as `ref_*` arrays."""
    out = {k: [] for k in ("frame_id", "R", "t", "tracked", "is_kf", "state",
                           "assoc")}
    for i in range(start, stop):
        r = sess.process_frame(frames[i], i * DT, i)
        out["frame_id"].append(i)
        out["R"].append(np.asarray(r.pose.R) if r.pose is not None
                        else np.full((3, 3), np.nan, np.float32))
        out["t"].append(np.asarray(r.pose.t) if r.pose is not None
                        else np.full((3,), np.nan, np.float32))
        out["tracked"].append(r.tracked_count)
        out["is_kf"].append(r.is_keyframe)
        out["state"].append(r.state.value)
        # a tracked frame's associations are the newest tracking-history row
        # (mapping, when the frame is a keyframe, leaves the history alone)
        out["assoc"].append(np.asarray(sess.history.assoc[0]))
    return {
        "ref_frame_id": np.asarray(out["frame_id"], np.int32),
        "ref_R": np.asarray(out["R"], np.float32),
        "ref_t": np.asarray(out["t"], np.float32),
        "ref_tracked": np.asarray(out["tracked"], np.int32),
        "ref_is_kf": np.asarray(out["is_kf"], bool),
        "ref_state": np.asarray(out["state"], np.int32),
        "ref_assoc": np.asarray(out["assoc"], np.int32),
    }


def _flatten(prefix: str, tree) -> dict:
    import jax

    return {f"{prefix}{i}": np.asarray(leaf)
            for i, leaf in enumerate(jax.tree.flatten(tree)[0])}


def record_mapping_window(sess, render_frame) -> dict:
    """Run `sess` on from frame SNAP_FRAME+1 until MAP_EVENTS keyframes have
    been mapped and MAP_TAIL more frames tracked; `render_frame(i)` gives
    frame i. Returns the second file's arrays."""
    events = []
    mapper = sess._insert_keyframe_and_map

    def recording_mapper(frame, frame_id):
        pre = (sess.map, sess.pose_history, frame, np.float32(sess.map_scale))
        capacity = sess.map.capacity
        mapper(frame, frame_id)
        if sess.map.capacity != capacity or sess._grow_pending:
            raise RuntimeError(f"the map banks grow at frame {frame_id}: "
                               f"shorten the window")
        events.append((frame_id, pre, sess.map, sess.pose_history,
                       sess.last_kf_slot, sess.bow))

    sess._insert_keyframe_and_map = recording_mapper
    per_frame = []
    i, stop = SNAP_FRAME + 1, MAP_MAX_FRAME
    while i < stop:
        per_frame.append(record_window(sess, {i: render_frame(i)}, i, i + 1))
        if len(events) == MAP_EVENTS and stop == MAP_MAX_FRAME:
            stop = i + 1 + MAP_TAIL
        i += 1
    if len(events) < MAP_EVENTS:
        raise RuntimeError(f"only {len(events)} keyframes mapped by frame "
                           f"{MAP_MAX_FRAME}")
    out = {k: np.concatenate([f[k] for f in per_frame]) for k in per_frame[0]}
    out["ev_frame_id"] = np.asarray([e[0] for e in events], np.int32)
    out["ev_ki"] = np.asarray([e[4] for e in events], np.int32)
    for j, (_, pre, post_map, post_ph, _, post_bow) in enumerate(events):
        out.update(_flatten(f"ev{j}_post_map", post_map))
        out.update(_flatten(f"ev{j}_post_ph", post_ph))
        out.update(_flatten(f"ev{j}_post_bow", post_bow))
        if j == 0:
            out.update(_flatten("ev0_pre_map", pre[0]))
            out.update(_flatten("ev0_pre_ph", pre[1]))
            out.update(_flatten("ev0_frame", pre[2]))
            out["ev0_map_scale"] = pre[3]
    return out


def main_map(out_path: str = MAP_OUT, bow_path: str | None = None) -> None:
    """Write the map file; with `bow_path`, write only the bag-of-words
    index after each event (`ev{j}_post_bow{i}`) there instead."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    import bench

    pts, patches = bench.build_world(np.random.RandomState(7))

    def render_frame(i):
        return np.clip(bench.render(pts, patches, i * DT), 0, 255).astype(np.uint8)

    frames = [render_frame(i) for i in range(SNAP_FRAME + 1)]
    with tempfile.TemporaryDirectory() as tmp:
        sess = run_to_snapshot(frames, os.path.join(tmp, "snap.npz"))
    arrays = record_mapping_window(sess, render_frame)
    if (arrays["ref_state"] != 1).any():
        raise RuntimeError(f"not every frame tracked: {arrays['ref_state'].tolist()}")
    is_bow = {k: "_post_bow" in k for k in arrays}
    if bow_path is None:
        arrays = {k: v for k, v in arrays.items() if not is_bow[k]}
    else:
        out_path = bow_path
        arrays = {k: v for k, v in arrays.items() if is_bow[k] or k.startswith("ev_")}
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez_compressed(out_path, **arrays)
    print(f"wrote {out_path}: {os.path.getsize(out_path)} bytes, mapped keyframes at "
          f"{arrays['ev_frame_id'].tolist()} in slots {arrays['ev_ki'].tolist()}")


def main(out_path: str = DEFAULT_OUT) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    frames = bench_frames(LAST_FRAME + 1)
    with tempfile.TemporaryDirectory() as tmp:
        snap = os.path.join(tmp, "snap.npz")
        sess = run_to_snapshot(frames, snap)
        with np.load(snap) as z:
            arrays = {k: z[k] for k in z.files}
    ref = record_window(sess, frames, SNAP_FRAME + 1, LAST_FRAME + 1)
    kf = ref["ref_is_kf"]
    if kf[:-1].any() or not kf[-1] or (ref["ref_state"] != 1).any():
        raise RuntimeError(
            f"window {SNAP_FRAME + 1}..{LAST_FRAME} is not an all-tracked "
            f"keyframe-free window ending in a keyframe: keyframes at "
            f"{ref['ref_frame_id'][kf].tolist()}, states "
            f"{ref['ref_state'].tolist()}")
    arrays.update(ref)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez_compressed(out_path, **arrays)
    print(f"wrote {out_path}: {os.path.getsize(out_path)} bytes, tracked "
          f"{ref['ref_tracked'].tolist()}")


def main_init(out_path: str = INIT_OUT) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    frames = bench_frames(SNAP_FRAME + 1)
    with tempfile.TemporaryDirectory() as tmp:
        sess = run_to_snapshot(frames, os.path.join(tmp, "snap.npz"))
    arrays = sess.init_record
    if arrays["init_adopt_frame"] < 0 or arrays["init_retrain_frame"] < 0:
        raise RuntimeError(f"no adoption or no retrain by frame {SNAP_FRAME}")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez_compressed(out_path, **arrays)
    print(f"wrote {out_path}: {os.path.getsize(out_path)} bytes, anchors at "
          f"{arrays['init_anchor_frames'].tolist()}, attempts at "
          f"{[int(arrays[f'init_att{j}_frame']) for j in range(arrays['init_n_attempt'])]}, "
          f"adopted at {int(arrays['init_adopt_frame'])}, retrained at "
          f"{int(arrays['init_retrain_frame'])} ({int(arrays['init_pool_rows'])} pool rows), "
          f"states {arrays['init_ref_state'].tolist()}")


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which not in ("track", "map", "both", "init", "bow", "all"):
        sys.exit(__doc__)
    if which in ("track", "both", "all"):
        main()
    if which in ("map", "both", "all"):
        main_map()
    if which in ("init", "all"):
        main_init()
    if which in ("bow", "all"):
        main_map(bow_path=BOW_OUT)
