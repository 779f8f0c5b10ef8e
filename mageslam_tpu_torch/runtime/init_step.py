"""Mono init and bag-of-words upkeep of a session (port of
mageslam_tpu/runtime/pipeline.py `_try_initialize` :642-764,
`_adopt_initialization` :766-849, `_accumulate_bow_training` :543-582).

Before its map exists a session keeps an anchor frame. Every later frame
two-way matches against the anchor (`ops/matching.match_two_way`, the
fused kernel on the card) and bumps a per-anchor-feature covisibility
counter; once the frame is MinInitializationIntervalMilliseconds past the
anchor, `try_initialize_pair` runs on the anchor's covisible features and
the frame, and a success is checked on a buffered middle frame
(`validate_third_frame`). An anchor older than
MaxInitializationIntervalMilliseconds is dropped and the frame becomes the
new anchor. On success the map is built from the pair (`adopt`): two
immortal keyframes, the surviving points in the first slots, tracking and
pose history seeded with both frames, a vocabulary trained from the
pair's descriptors with both keyframes indexed, and the fuser, where the
session has one, told that the map exists.

Meanwhile every frame's descriptors go to a training pool; once the
session is initialized and TrainingFrames frames are pooled, the
vocabulary is retrained once from the whole pool (`BowTraining`).

Host reads: one per attempt (its success), one more for the third-frame
check of an attempt that succeeds, one per adoption (the map scale and the
second keyframe's associated count), one when the retrain gate is met (the
pool's valid count). Slots are assigned on the device.
"""

from __future__ import annotations

import torch

from ..bow.index import add_keyframe, compute_idf, retrain_index
from ..bow.vocab import train_vocabulary
from ..geometry.se3 import Pose
from ..ops.frontend import FrameFeatures
from ..ops.indexing import set_drop
from ..ops.matching import match_two_way
from ..tracking.map_init import (
    PNP_HYPOTHESES,
    InitResult,
    init_settings,
    try_initialize_pair,
    validate_third_frame,
)
from ..worldmap.map_state import refresh_membership, refresh_point_stats
from ..worldmap.operations import insert_keyframe

WINDOW = 16   # middle frames kept for the third-frame check


class InitWindow:
    """The anchor frame, its covisibility counters and the frames buffered
    since (the reference's `prev_features`, `_init_counters`,
    `_init_window`)."""

    def __init__(self):
        self.anchor: FrameFeatures | None = None
        self.anchor_meta: tuple[int, float] | None = None   # (frame_id, timestamp)
        self.counters: torch.Tensor | None = None           # (N,) int32
        self.n_frames = 0
        self.middles: list[tuple[FrameFeatures, float]] = []
        self.attempts = 0

    def reset(self, feats: FrameFeatures, frame_id: int, timestamp: float) -> None:
        """`feats` becomes the anchor: every descriptor seen in one frame."""
        self.anchor, self.anchor_meta = feats, (frame_id, timestamp)
        self.counters = torch.ones(feats.valid.shape, dtype=torch.int32,
                                   device=feats.valid.device)
        self.n_frames = 1
        self.middles = []


def try_initialize(sess, feats: FrameFeatures, timestamp: float, frame_id: int):
    """One init frame of `sess` (pipeline.py:642-764). Returns None, or
    where the map was adopted on it, `adopt`'s (pose, tracked count)."""
    ms = sess.settings.MonoSettings.MonoMapInitializationSettings
    win = sess.init_window
    adopted = None
    if win.anchor is not None \
            and (timestamp - win.anchor_meta[1]) * 1000.0 > ms.MaxInitializationIntervalMilliseconds:
        win.anchor = None                                   # too old: restart
    if win.anchor is not None:
        fps = ms.FivePointMatchingSettings
        m_idx, _ = match_two_way(win.anchor.desc, win.anchor.valid, feats.desc, feats.valid,
                                 fps.MaxHammingDistance, fps.MinHammingDifference)
        win.counters = win.counters + (m_idx >= 0).to(torch.int32)
        win.n_frames += 1
        if (timestamp - win.anchor_meta[1]) * 1000.0 >= ms.MinInitializationIntervalMilliseconds:
            adopted = _attempt(sess, feats, timestamp, frame_id)
    if win.anchor is None:
        win.reset(feats, frame_id, timestamp)
    elif adopted is None:
        win.middles.append((feats, timestamp))
        if len(win.middles) > WINDOW:
            win.middles.pop(0)
    return adopted


def _attempt(sess, feats: FrameFeatures, timestamp: float, frame_id: int):
    ms = sess.settings.MonoSettings.MonoMapInitializationSettings
    win = sess.init_window
    anchor = win.anchor
    win.attempts += 1
    cov_thr = int(win.n_frames * ms.FeatureCovisibilityThreshold)
    anchor_valid = anchor.valid & (win.counters > cov_thr)
    res = try_initialize_pair(
        anchor.und_xy, anchor.desc, anchor_valid, feats.und_xy, feats.desc, feats.valid,
        sess.cam, sess.draws.gumbel("init", (sess.settings.Budgets.RansacBatch, 5, sess.N)),
        init_settings(sess.settings))
    ok = bool(res.succeeded)
    if ok and win.middles:
        # 2(+1)-frame bootstrap: the buffered frame nearest the pair's middle
        t_mid = (win.anchor_meta[1] + timestamp) / 2.0
        mid, _ = min(win.middles, key=lambda e: abs(e[1] - t_mid))
        extra = ms.ExtraFrameMatchingSettings
        ok = bool(validate_third_frame(
            res, anchor.desc, anchor.valid, mid.und_xy, mid.desc, mid.valid, sess.cam,
            sess.draws.gumbel("pnp", (PNP_HYPOTHESES, sess.N)),
            min_pct=ms.MinThirdFrameMatchPercentage, max_err=ms.ExtraFrame_MaxOutlierError,
            ba_iters=ms.ExtraFrame_BundleAdjustmentSteps,
            max_hamming=extra.MaxHammingDistance, min_diff=extra.MinHammingDifference))
    if not ok:
        return None
    sess._det_check("Init.Accepted", res.pose2, res.point_valid, res.points)
    return adopt(sess, res, feats, timestamp, frame_id)


def adopt(sess, res: InitResult, feats: FrameFeatures, timestamp: float,
          frame_id: int) -> tuple[Pose, int]:
    """Build the map from an accepted pair (pipeline.py:766-849;
    InitializationWorker.cpp:44-90). Returns the second keyframe's pose
    and associated count: the adoption frame's result."""
    win = sess.init_window
    prev, (prev_id, prev_ts) = win.anchor, win.anchor_meta
    dev = sess.device
    N = sess.N
    P = sess.map.capacity[1]
    ok = res.point_valid
    # surviving points take the first slots, in feature order
    slots = torch.where(ok, torch.cumsum(ok.to(torch.int32), 0) - 1, -1).to(torch.int32)
    n_points = torch.sum(ok.to(torch.int32))
    first = torch.arange(P, device=dev) < n_points
    m = sess.map
    sess.map = m._replace(
        mp_valid=first,
        mp_pos=set_drop(torch.zeros_like(m.mp_pos), slots, res.points),
        mp_desc=set_drop(torch.zeros_like(m.mp_desc), slots, prev.desc),
        mp_refine_count=torch.where(first, 1, torch.zeros_like(m.mp_refine_count)),
        mp_created_order=torch.where(first, 0, torch.full_like(m.mp_created_order, -1)),
    )
    assoc1 = slots
    assoc2 = set_drop(torch.full((N,), -1, dtype=torch.int32, device=dev),
                      torch.where(ok, res.feat2, -1), slots)

    # frame 1 = identity (fixed, immortal), frame 2 = the recovered pose
    identity = Pose.identity(device=dev)
    sess.map, _ = insert_keyframe(sess.map, identity, sess.cam, prev_id, prev.und_xy,
                                  prev.octave, prev.desc, prev.valid, assoc1, fixed=True,
                                  immortal=True)
    sess.map, _ = insert_keyframe(sess.map, res.pose2, sess.cam, frame_id, feats.und_xy,
                                  feats.octave, feats.desc, feats.valid, assoc2, fixed=False,
                                  immortal=True)
    fes = sess.fes
    sess.map = refresh_point_stats(sess.map, torch.ones((P,), dtype=torch.bool, device=dev),
                                   fes.NumLevels, fes.ScaleFactor)
    sess.map = refresh_membership(sess.map)

    f1 = sess._frame(prev, prev_ts, prev_id)._replace(assoc=assoc1)
    f2 = sess._frame(feats, timestamp, frame_id)._replace(pose=res.pose2, assoc=assoc2)
    sess.history = sess.history.advance(f1).advance(f2)
    kf1 = Pose(sess.map.kf_pose.R[1], sess.map.kf_pose.t[1])
    sess.pose_history = sess.pose_history.add_single(prev_id, identity, identity, 0)
    sess.pose_history = sess.pose_history.add_single(frame_id, res.pose2, kf1, 1)

    # the place-recognition vocabulary from the pair's descriptors
    pool_desc = torch.cat([prev.desc, feats.desc])
    pool_valid = torch.cat([prev.valid, feats.valid])
    bow = sess.bow
    anchors = train_vocabulary(pool_desc, pool_valid,
                               sess.draws.gumbel("vocab", (pool_desc.shape[0],)),
                               num_words=bow.num_words)
    bow = bow._replace(anchors=anchors, trained=torch.ones_like(bow.trained))
    bow = compute_idf(bow, pool_desc, pool_valid)
    bow = add_keyframe(bow, 0, prev.desc, prev.valid)
    sess.bow = add_keyframe(bow, 1, feats.desc, feats.valid)
    sess._det_check("Init.Adopt.Map", sess.map.kf_pose, sess.map.kf_valid,
                    sess.map.mp_valid, sess.map.mp_pos)
    sess._det_check("Init.Adopt.Bow", sess.bow.anchors, sess.bow.idf)

    # the adoption's one host read: map scale (the two keyframes' baseline)
    # and the second keyframe's associated count
    scale, tracked = torch.stack([
        torch.linalg.norm(res.pose2.center()),
        torch.sum((sess.map.kf_assoc[1] >= 0).to(torch.float32))]).tolist()
    sess.map_scale = scale
    sess.initialized = True
    sess.lost_count = 0
    sess.frames_since_keyframe = 0
    sess.last_kf_slot = 1
    if sess.fuser is not None:
        # the map exists: the fuser starts converging on gravity (the
        # stereo bootstrap adopts through here too)
        sess.fuser.on_mage_initialized()
    return kf1, int(tracked)


class BowTraining:
    """The vocabulary's training pool (pipeline.py:543-582): descriptors of
    up to 3 · TrainingFrames frames; once the session is initialized and
    TrainingFrames frames are pooled (with at least MinTrainingSize valid
    descriptors, or 2 · TrainingFrames frames), one retrain from the whole
    pool, and never again."""

    def __init__(self, retrained: bool = False):
        self.pool: list[tuple[torch.Tensor, torch.Tensor]] = []
        self.frames = 0
        self.retrained = retrained

    def add(self, sess, desc: torch.Tensor, valid: torch.Tensor, n_frames: int = 1) -> bool:
        """Pool the descriptors of `n_frames` frames (a resolved chunk's
        stacked ones on the chunk path, pipeline.py:1578-1582); returns
        whether the vocabulary was retrained now."""
        bw = sess.settings.BagOfWordsSettings
        if self.retrained:
            return False
        if self.frames < 3 * bw.TrainingFrames:
            self.pool.append((desc.reshape(-1, desc.shape[-1]), valid.reshape(-1)))
            self.frames += n_frames
        if not sess.initialized or self.frames < bw.TrainingFrames:
            return False
        pool_desc = torch.cat([d for d, _ in self.pool])
        pool_valid = torch.cat([v for _, v in self.pool])
        if int(torch.sum(pool_valid.to(torch.int32))) < bw.MinTrainingSize \
                and self.frames < 2 * bw.TrainingFrames:
            return False                                    # thin pool: keep pooling
        m = sess.map
        sess.bow = retrain_index(sess.bow, pool_desc, pool_valid, m.kf_desc, m.kf_kp_valid,
                                 sess.bow.kf_has & m.kf_valid,
                                 sess.draws.gumbel("vocab", (pool_desc.shape[0],)),
                                 iterations=bw.MaxTrainingIteration)
        self.retrained = True
        self.pool, self.frames = [], 0
        return True
