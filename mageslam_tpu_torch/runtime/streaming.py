"""The session's throughput and realtime entry points, with deferred loop
detection (port of mageslam_tpu/runtime/pipeline.py:331-391, 1221-1239,
1307-1432, 1456-1531, 1537-1703 and 2427-2570).

`StreamEntryPoints` is a mixin of `SlamSession`; it holds three queues:

- pipelined frames (`process_features_pipelined`, `process_frame_pipelined`,
  `process_frame_realtime`): each frame runs the gated step
  (runtime/frame_step.py) against the current state and queues its outcome
  tensor; the outcomes are read MappingSettings.MaxPendingKeyframes frames
  late, in one read, and a keyframe is mapped then, so mapping lags up to
  that many frames, as in the reference. `process_frame_realtime` drops a
  frame as SKIPPED where `max_inflight` dispatches are unresolved (the
  reference's OneAtATime gate); a dispatch counts as resolved once the
  event recorded after it has passed on the card (`torch.cuda.Event.query`;
  on the CPU at once).
- chunks (`process_frames_chunked`, `process_frame_stream`): a chunk is a
  host loop over the gated step. Each frame reads its keyframe flag, the
  one read a frame that zero-lag mapping needs: a keyframe is mapped at the
  frame that triggers it and the next frame tracks against the new map, as
  in the reference's scan. The frame counters stay on the device between
  frames (frames_since_keyframe resets only on an accepted keyframe; both
  freeze on failed frames). Each frame leaves a row of the chunk summary
  (`SUMMARY_COLUMNS`) on the device; the rows of `_chunk_pipeline_depth`
  chunks and more are read together, and only then do the results surface,
  the keyframes go to the bag-of-words index and the training pool, and
  loop detection runs. The stream path has no IMU prior, as the
  reference's has none.
- deferred loop detections: a keyframe resolved from a chunk queues its
  detection; the `detected` flags ride the next chunk summaries' read (or
  `flush_chunks` reads them) and `_resolve_loop_dets` applies at most one
  closure a batch, behind the slot-identity guard, dropping the siblings
  whose cluster overlaps the closure and detecting the disjoint ones again
  against the post-closure map, queued for the next batch.

While the session is uninitialized or lost, and for a stream's tail, frames
go through the per-frame path after the queues are drained. Bank growth,
`snapshot_state` and `restore_state` are safe points: they drain every
queue first (restore clears them).
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.se3 import Pose
from ..ops.digest import state_digest
from ..ops.frontend import detect_and_compute
from ..tracking.relocalization import RELOC_HYPOTHESES
from .frame_step import gated_step, prepare_image
from .loop_closure import LoopDetection, detect_loop
from .mapping_step import mapping

# the chunk summary's columns, one row a frame (pipeline.py:1221-1239); the
# state digest (ops/digest.py) is 0 unless a Determinator is attached
SUMMARY_COLUMNS = ("ok", "tracked", "accepted", *(f"R{i}" for i in range(9)),
                   "t0", "t1", "t2", "ki", "frames_since_keyframe", "keyframes", "points",
                   "digest")
_COL = {name: i for i, name in enumerate(SUMMARY_COLUMNS)}
# the deferred-detection counters (pipeline.py:217-233), beside the per-frame
# path's live / qualified / closed
DEFERRED_STATS = ("deferred", "resolved", "stale_slot", "requeued", "same_loop_dropped")
# reads of the flags of detections queued by a drain's own resolution
DRAIN_ROUNDS = 3


class StreamEntryPoints:
    """The queues and entry points; `SlamSession` sets them up with
    `_init_streaming`."""

    def _init_streaming(self) -> None:
        self._pending: list = []          # (frame, outcome (3,), frame id, event)
        self._pipeline_depth = self.settings.MappingSettings.MaxPendingKeyframes
        self._pending_chunks: list = []   # (frames, summary (C, 20), frame ids)
        self._dev_counters = None         # (frames_since_keyframe, _reloc) on the device
        self._pending_loop_dets: list = []   # (LoopDetection, frame, slot, frame id)
        # chunks in flight before their summaries are read (bench.py sets 4)
        self._chunk_pipeline_depth = 2
        # the newest mapping step's keyframe count: an upper bound of the
        # map's until the next mapping (None: unknown)
        self._kf_bound = None
        # the summary's digest column without a Determinator, made once so
        # that a row costs no launch more
        self._zero_col = torch.zeros((1,), dtype=torch.float32, device=self.device)

    def _lost(self) -> bool:
        return (not self.initialized or self.lost_count >=
                self.settings.TrackLocalMapSettings.TrackingLostCountUntilReloc)

    # ------------------------------------------------------------------ #
    # pipelined frames

    def _dispatch(self, feats, timestamp, frame_id) -> None:
        """Run the gated step on one frame and queue its outcome, with the
        host counters as they stand (pipeline.py:356-368)."""
        out = gated_step(
            self.settings, self.width, self.height, self.map, self.history,
            self.pose_history, self._frame(feats, timestamp, frame_id),
            self._scalar(self.frames_since_keyframe + 1, torch.int32),
            self._scalar(min(self.frames_since_reloc + 1, 10_000), torch.int32),
            prior=self._imu_prior())
        self.map, self.history, self.pose_history = out.map, out.history, out.pose_history
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        self._pending.append((out.frame, out.flags, frame_id, event))

    def process_features_pipelined(self, feats, timestamp: float, frame_id: int):
        """Throughput-mode frame loop (pipeline.py:331-369): dispatch this
        frame before reading the earlier ones' outcomes. Returns the newest
        result resolved by this call (None while the queue fills); call
        `flush` at the end of the stream."""
        if self._lost():
            return self._per_frame(lambda: self.process_features(feats, timestamp, frame_id))
        self._dispatch(feats, timestamp, frame_id)
        if len(self._pending) > self._pipeline_depth:
            return self._resolve_pending()
        return None

    def process_frame_pipelined(self, image, timestamp: float, frame_id: int):
        """`process_features_pipelined` on a grayscale frame (uint8 or
        float32) (pipeline.py:1634-1656)."""
        if self._lost():
            return self._per_frame(lambda: self.process_frame(image, timestamp, frame_id))
        return self.process_features_pipelined(self._analyze(image), timestamp, frame_id)

    def process_frame_realtime(self, image, timestamp: float, frame_id: int,
                               max_inflight: int | None = None):
        """Realtime entry with frame-drop backpressure (pipeline.py:1658-1703):
        outcomes already computed resolve without waiting; a frame arriving
        while `max_inflight` dispatches (default MaxPendingKeyframes) are
        unresolved is dropped as SKIPPED, which is not a tracking failure.
        Returns the newest result resolved by this call, or the drop."""
        from .session import FrameResult, TrackingState

        if max_inflight is None:
            max_inflight = self.settings.MappingSettings.MaxPendingKeyframes
        if self._lost():
            return self._per_frame(lambda: self.process_frame(image, timestamp, frame_id))
        n_ready = 0
        for *_, event in self._pending:
            if event is not None and not event.query():
                break
            n_ready += 1
        resolved = self._resolve_pending(n_ready) if n_ready else None
        if len(self._pending) >= max_inflight:
            result = FrameResult(frame_id, TrackingState.SKIPPED, None, 0, False)
            self.results.append(result)
            return result
        self._dispatch(self._analyze(image), timestamp, frame_id)
        return resolved

    def _per_frame(self, run):
        """The frame while uninitialized or lost (pipeline.py:338-341):
        the queued frames resolve, then `run()` takes the per-frame path;
        returns the last queued result, else the frame's."""
        prev = self.flush()
        res = run()
        return prev or res

    def _analyze(self, image):
        return detect_and_compute(prepare_image(image, self.device, self._raw_cam16),
                                  self.cam16, self.fes, self.N)

    def _resolve_pending(self, count: int | None = None):
        """Resolve the oldest `count` queued frames (default all) with one
        read of their outcomes; a keyframe is mapped now
        (pipeline.py:371-388)."""
        from .session import FrameResult, TrackingState

        if not self._pending:
            return None
        count = len(self._pending) if count is None else count
        batch = self._pending[:count]
        del self._pending[:count]
        outcomes = torch.stack([flags for _, flags, _, _ in batch]).tolist()
        result = None
        for (frame, _, frame_id, _), (ok, tracked, is_kf) in zip(batch, outcomes):
            if not ok:
                result = self._tracking_failed(frame_id)
            else:
                self.lost_count = 0
                self.frames_since_keyframe += 1
                self.frames_since_reloc += 1
                if is_kf:
                    self._insert_keyframe_and_map(frame)
                result = FrameResult(frame_id, TrackingState.TRACKING, frame.pose, tracked,
                                     bool(is_kf))
            self.results.append(result)
        return result

    def flush(self):
        """Resolve every queued pipelined frame; returns the last result."""
        return self._resolve_pending()

    # ------------------------------------------------------------------ #
    # chunks

    def _device_counters(self):
        """(frames_since_keyframe, frames_since_reloc) for the next chunk:
        the device's while chunks are in flight, else the host's
        (pipeline.py:1361-1369)."""
        if self._dev_counters is not None:
            return self._dev_counters
        return (self._scalar(self.frames_since_keyframe, torch.int32),
                self._scalar(min(self.frames_since_reloc, 10_000), torch.int32))

    def _chunk_frame(self, image, timestamp, frame_id, fsk, fsr):
        """One frame of a chunk (the reference's `_scan_frame_body`,
        pipeline.py:1121-1220): the gated step, then, where the keyframe
        flag (this frame's one read) says so, mapping. Returns (frame,
        summary row, frames_since_keyframe, frames_since_reloc)."""
        out = gated_step(self.settings, self.width, self.height, self.map, self.history,
                         self.pose_history, self._frame(self._analyze(image), timestamp, frame_id),
                         fsk + 1, torch.clamp_max(fsr + 1, 10_000))
        self.map, self.history, self.pose_history = out.map, out.history, out.pose_history
        gate = out.flags[0] > 0
        ki = -1
        if bool(out.flags[2]):
            self.map, self.pose_history, ki, (n_kf, _) = mapping(
                self.settings, self.width, self.height, self.map, self.pose_history,
                out.frame, self.map_scale)
            self._kf_bound = n_kf
        accepted = ki >= 0
        fsk = torch.where(gate, torch.zeros_like(fsk) if accepted else fsk + 1, fsk)
        fsr = torch.where(gate, torch.clamp_max(fsr + 1, 10_000), fsr)
        m = self.map
        if self.determinator is None:
            digest = self._zero_col
        else:
            # the post-frame state digest (pipeline.py:1187-1217)
            digest = state_digest(m.mp_pos, m.kf_pose.t, m.mp_valid, m.kf_valid, fsk)
        row = torch.cat([
            out.flags[:2].to(torch.float32),
            torch.tensor([float(accepted)], device=self.device),
            out.frame.pose.R.reshape(9), out.frame.pose.t,
            torch.tensor([float(ki)], device=self.device),
            fsk.to(torch.float32)[None],
            torch.stack([torch.sum(m.kf_valid.to(torch.int32)),
                         torch.sum(m.mp_valid.to(torch.int32))]).to(torch.float32),
            digest])
        return out.frame, row, fsk, fsr

    def _dispatch_chunk(self, images, timestamps, frame_ids) -> None:
        fsk, fsr = self._device_counters()
        frames, rows = [], []
        for image, ts, fid in zip(images, timestamps, frame_ids):
            frame, row, fsk, fsr = self._chunk_frame(image, float(ts), int(fid), fsk, fsr)
            frames.append(frame)
            rows.append(row)
        self._dev_counters = (fsk, fsr)
        self._pending_chunks.append((frames, torch.stack(rows),
                                     [int(f) for f in frame_ids]))

    def process_frames_chunked(self, images, timestamps, frame_ids):
        """A chunk of frames (pipeline.py:1371-1414), each mapped at its own
        keyframe; results resolve once more than `_chunk_pipeline_depth`
        chunks are in flight; call `flush_chunks` at the end. While uninitialized or lost the frames go
        through the per-frame path. Returns the results resolved here."""
        if self._lost():
            results = self.flush_chunks()
            for im, ts, fid in zip(images, timestamps, frame_ids):
                results.append(self.process_frame(im, float(ts), int(fid)))
            return results
        results = self._service_bank_growth() if self._grow_pending else []
        # mapping in a chunk is not offloaded: a pending pass is adopted
        # first, or its copy of the map would overwrite the chunk's
        # (pipeline.py:1326-1330, 1403)
        self._adopt_offloaded_mapping()
        self._dispatch_chunk(images, timestamps, frame_ids)
        if len(self._pending_chunks) > self._chunk_pipeline_depth:
            results.extend(self._resolve_chunks(len(self._pending_chunks) - 1))
        return results

    def process_frame_stream(self, image_bank, timestamps, frame_ids, start: int = 0,
                             stop: int | None = None, chunk: int = 16):
        """Frames [start, stop) of a (T, H, W) bank, uint8 or float32, `chunk`
        frames at a time (pipeline.py:1307-1359). A bank already on the
        session's device is used as it is; a list of frames is stacked and
        copied there once. While uninitialized or lost, and for the tail
        shorter than a chunk, frames go through the per-frame path. Returns
        the results of [start, stop) in order."""
        T = len(frame_ids)
        stop = T if stop is None else stop
        if torch.is_tensor(image_bank):
            bank = image_bank.to(self.device)
        else:
            bank = torch.stack([torch.as_tensor(np.asarray(im)) for im in image_bank]
                               ).to(self.device)
        self._adopt_offloaded_mapping()   # see process_frames_chunked
        results = []
        base = start
        while base < stop:
            if self._grow_pending:
                results.extend(self._service_bank_growth())
            if self._lost() or base + chunk > stop:
                results.extend(self.flush_chunks())
                results.append(self.process_frame(bank[base], float(timestamps[base]),
                                                  int(frame_ids[base])))
                base += 1
                continue
            self._dispatch_chunk([bank[base + i] for i in range(chunk)],
                                 timestamps[base:base + chunk], frame_ids[base:base + chunk])
            if len(self._pending_chunks) > self._chunk_pipeline_depth:
                results.extend(self._resolve_chunks(len(self._pending_chunks) - 1))
            base += chunk
        results.extend(self.flush_chunks())
        return results

    def flush_chunks(self):
        """Resolve every chunk in flight and drain the detections that
        resolution queued (pipeline.py:1416-1432). Returns the chunks'
        results; the host counters take the device's."""
        out = self._resolve_chunks(len(self._pending_chunks))
        for _ in range(DRAIN_ROUNDS):
            if not self._pending_loop_dets:
                break
            self._resolve_loop_dets()
        self._dev_counters = None
        return out

    def _resolve_chunks(self, count: int):
        """Resolve the oldest `count` chunks with one read of their summaries,
        the queued detections' flags riding along (pipeline.py:1537-1630)."""
        from .session import FrameResult, TrackingState

        count = min(count, len(self._pending_chunks))
        if count == 0:
            self._resolve_loop_dets()
            return []
        batch = self._pending_chunks[:count]
        del self._pending_chunks[:count]
        dets = self._pending_loop_dets
        parts = [rows.reshape(-1) for _, rows, _ in batch]
        if dets:
            parts.append(torch.stack([d.detected for d, *_ in dets]).to(torch.float32))
        flat = torch.cat(parts).cpu().numpy()
        summaries, offs = [], 0
        for _, rows, _ in batch:
            summaries.append(flat[offs:offs + rows.numel()].reshape(rows.shape))
            offs += rows.numel()
        if dets:
            self._resolve_loop_dets(flags=flat[offs:])
        results = []
        for (frames, _, frame_ids), s in zip(batch, summaries):
            # the stream path's DETERMINISTIC_CHECK: the whole summary, on
            # the host already (pipeline.py:1578-1582)
            self._det_check("Stream.Chunk", np.ascontiguousarray(s))
            if not self.bow_training.retrained:
                self.bow_training.add(self, torch.stack([f.desc for f in frames]),
                                      torch.stack([f.kp_valid for f in frames]),
                                      n_frames=len(frames))
            self._maybe_grow_banks(int(s[-1, _COL["keyframes"]]), int(s[-1, _COL["points"]]))
            for k, frame_id in enumerate(frame_ids):
                row = s[k]
                if not row[_COL["ok"]]:
                    results.append(self._tracking_failed(frame_id))
                    continue
                self.lost_count = 0
                self.frames_since_keyframe = int(row[_COL["frames_since_keyframe"]])
                self.frames_since_reloc += 1
                accepted = bool(row[_COL["accepted"]])
                if accepted:
                    ki = int(row[_COL["ki"]])
                    self.last_kf_slot = ki
                    self.bow_training.add(self, frames[k].desc, frames[k].kp_valid)
                    self._post_keyframe(frames[k], ki, self._kf_bound, defer=True)
                pose = Pose(row[_COL["R0"]:_COL["R0"] + 9].reshape(3, 3).copy(),
                            row[_COL["t0"]:_COL["t0"] + 3].copy())
                results.append(FrameResult(frame_id, TrackingState.TRACKING, pose,
                                           int(row[_COL["tracked"]]), accepted))
        self.results.extend(results)
        return results

    # ------------------------------------------------------------------ #
    # deferred loop detection

    def _detect(self, frame, ki: int, slot_ok: torch.Tensor):
        """Loop detection at keyframe slot `ki` (one read, its gate), the
        flag gated by the slot guard; counts live and qualified."""
        lc = self.settings.LoopClosureSettings
        rs = self.settings.RelocalizationSettings
        C = self.settings.MappingSettings.MaxRelocQueryResults
        det, live, qualified = detect_loop(
            self.map, self.bow, frame, ki,
            lambda: self.draws.gumbel("reloc", (C, RELOC_HYPOTHESES, self.N)),
            covis_loop_threshold=self.settings.CovisibilitySettings.CovisLoopThreshold,
            covis_cluster_threshold=self.settings.CovisibilitySettings.CovisMinThreshold,
            min_cluster_size=lc.MinClusterSize, min_keyframes=lc.MinKeyframe,
            max_candidates=C,
            reloc_kwargs=dict(min_brute_force=rs.MinBruteForceCorrespondences,
                              min_radius_matches=rs.MinRadiusMatchCorrespondences,
                              search_radius=lc.MatchSearchRadius))
        self.loop_det_stats["live"] += int(live)
        self.loop_det_stats["qualified"] += int(qualified)
        return det._replace(detected=det.detected & slot_ok), qualified

    def _no_detection(self) -> LoopDetection:
        """The detection below MinKeyframe keyframes (by the newest mapping's
        count), where nothing can be detected: a constant false."""
        return LoopDetection(
            detected=torch.zeros((), dtype=torch.bool, device=self.device), reloc_pose=None,
            reloc_assoc=None, scale=None, cluster_mask=torch.zeros_like(self.map.kf_valid))

    def _resolve_loop_dets(self, flags=None) -> None:
        """Resolve the queued detections (pipeline.py:2506-2570); `flags` are
        their `detected` values where a chunk read carried them, else one
        read here. The first hit on a slot still holding its keyframe
        closes; the rest of the batch was detected against the map before
        that closure: a hit whose cluster overlaps it is dropped, one on a
        disjoint cluster is detected again and queued."""
        dets = self._pending_loop_dets
        if not dets:
            return
        self._pending_loop_dets = []
        if flags is None:
            flags = torch.stack([d.detected for d, *_ in dets]).to(torch.float32).cpu().numpy()
        stats = self.loop_det_stats
        for idx, ((det, frame, ki, fid), hit) in enumerate(zip(dets, flags)):
            self._det_check("LoopClosure.Detect", det.detected, det.scale, det.cluster_mask)
            stats["resolved"] += 1
            if not hit > 0:
                continue
            if int(self.map.kf_frame_id[ki]) != fid:
                stats["stale_slot"] += 1
                continue
            self._apply_loop_closure(det, frame, ki)
            stats["closed"] += 1
            for (det2, frame2, ki2, fid2), hit2 in zip(dets[idx + 1:], flags[idx + 1:]):
                stats["resolved"] += 1
                if not hit2 > 0:
                    continue
                if bool(torch.any(det.cluster_mask & det2.cluster_mask)):
                    stats["same_loop_dropped"] += 1
                    continue
                det2, _ = self._detect(frame2, ki2, self.map.kf_frame_id[ki2] == fid2)
                self._pending_loop_dets.append((det2, frame2, ki2, fid2))
                stats["requeued"] += 1
            break

    # ------------------------------------------------------------------ #
    # safe points

    def _drain(self) -> list:
        """Resolve every queue (chunks, pipelined frames, detections);
        returns the chunks' results."""
        drained = self.flush_chunks() if self._pending_chunks else []
        if self._pending:
            self.flush()
        for _ in range(DRAIN_ROUNDS):
            if not self._pending_loop_dets:
                break
            self._resolve_loop_dets()
        return drained

    def _clear_queues(self) -> None:
        self._pending.clear()
        self._pending_chunks.clear()
        self._pending_loop_dets = []
        self._dev_counters = None
        self._kf_bound = None
