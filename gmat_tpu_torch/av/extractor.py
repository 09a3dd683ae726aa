"""FrameExtractor / FrameSelect — smart decoding; counterpart of
`gmat_tpu/av/extractor.py`.

Port of metrans/app/FrameExtractor.h (dual-demuxer uniform-interval
extraction with GOP seek + non-reference skipping) and FrameSelect.h
(scene-cut selection), over host software decode (`av/toolkit.py`):

  * interval targets in frames or seconds (SetInterval,
    FrameExtractor.h:183-190)
  * skip non-ref frames before the target  (FrameExtractor.h:261-268 —
    H.264 nal_ref_idc==0 && type==1; extended to HEVC *_N types)
  * GOP seek: a look-ahead demuxer scans the next interval for a keyframe
    and the main demuxer fast-forwards to it without decoding
    (SeekKeyFrame, FrameExtractor.h:56-126)
  * only frames from at/after-target packets are emitted (the
    timestamp=-bReached trick, FrameExtractor.h:272-283, done here by pts
    bookkeeping)
  * FrameSelect: decode everything, score scene cuts per batch on the
    card (`ops/scene.py`; on the CPU when the caller asks for it), yield
    frames whose score exceeds the threshold (select_gpu='gt(scene,0.4)')
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from ..core.frame import from_numpy_yuv420
from ..ops.scene import scene_scores
from . import toolkit as tk

AV_NOPTS = -(1 << 63)    # AV_NOPTS_VALUE passes through the C ABI raw


class FrameExtractor:
    """Uniform-interval frame extraction with smart skipping.

    `src` is a path or an in-memory container (bytes), matching the
    reference's FrameExtractor_InitFromBuffer C ABI
    (metrans/app/CFrameExtractor.cpp) — both demuxers read the same
    buffer, each with its own cursor.  Host only: frames come out as
    numpy planes."""

    def __init__(self, src, frame_interval: int = 0,
                 time_interval: float = 0.0, threads: int = 0,
                 resize=None, crop=None):
        self.dm = tk.Demuxer(src)             # main demuxer
        self.dm_seek = tk.Demuxer(src)        # look-ahead demuxer
        self.dec = tk.Decoder.from_demuxer(self.dm, threads, resize=resize,
                                           crop=crop)
        self.frame_interval = frame_interval
        self.time_interval = time_interval
        self.width, self.height = self.dec.width, self.dec.height
        self.colorspace = self.dm.colorspace
        self._iframe = 0                      # index of next frame to demux
        self._frame_target = 0
        self._time_target: Optional[float] = None
        self._tb = self.dm.time_base[0] / self.dm.time_base[1]
        self._emit_pts: set[int] = set()
        # look-ahead stays one packet ahead of main (reference ctor behavior)
        self._seek_ahead = 0   # packets the look-ahead is ahead of main
        # stats (FrameExtractor.h:178-181)
        self.n_demuxed = 0
        self.n_skipped_seek = 0
        self.n_skipped_nonref = 0
        self.n_decoded = 0

    def set_interval(self, frames: int = 0, seconds: float = 0.0):
        self.frame_interval, self.time_interval = frames, seconds

    def _pkt_time(self, pkt: tk.Packet) -> float:
        ts = pkt.pts if pkt.pts != AV_NOPTS else pkt.dts
        if ts == AV_NOPTS:
            # timestamp-less elementary streams: synthesize from the
            # frame INDEX at the container rate.  _iframe ticks for
            # seek-skipped packets too (n_demuxed does not), so the clock
            # can't fall behind and stretch the extraction cadence; at
            # call time the current packet's index is _iframe - 1
            return (self._iframe - 1) / max(self.dm.fps, 1.0)
        return ts * self._tb

    def _seek_keyframe_frames(self, interval: int) -> int:
        """Scan `interval` packets ahead; fast-forward main past the last
        keyframe found.  Returns number of packets skipped (not decoded)."""
        found = -1
        scanned = 0
        while scanned < interval:
            p = self.dm_seek.read()
            if p is None:
                break
            if p.stream != 0:      # _seek_ahead counts VIDEO packets only
                continue
            self._seek_ahead += 1
            scanned += 1
            if p.key:
                found = self._seek_ahead
        if found <= 1:
            return 0
        skipped = 0
        # fast-forward main demuxer to just before that keyframe
        while self._seek_ahead > 1 and skipped < found - 1:
            p = self.dm.read()
            if p is None:
                break
            if p.stream == 0:
                self._iframe += 1
                skipped += 1
                self._seek_ahead -= 1
        return skipped

    def frames(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                       int]]:
        """Yield (y, u, v, pts) for each extracted frame.  Reads the
        interval attributes every packet so set_interval() takes effect
        between extract_batch calls (SetInterval semantics,
        FrameExtractor.h:183-190)."""
        self._emit_nopts = 0
        eof = False
        while not eof:
            interval_f, interval_t = self.frame_interval, self.time_interval
            pkt = self.dm.read()
            if pkt is None:
                eof = True
                frames = list(self.dec.decode(None))
            else:
                if pkt.stream != 0:
                    continue
                iframe = self._iframe
                self._iframe += 1
                if self._seek_ahead > 0:
                    self._seek_ahead -= 1
                else:
                    sp = self.dm_seek.read()
                    while sp is not None and sp.stream != 0:
                        sp = self.dm_seek.read()
                time = self._pkt_time(pkt)
                if self._time_target is None:
                    self._time_target = time
                self.n_demuxed += 1
                if interval_f:
                    reached = iframe >= self._frame_target
                else:
                    reached = time >= self._time_target - 1e-9
                if not reached and pkt.nonref:
                    self.n_skipped_nonref += 1
                    continue
                if reached:
                    if pkt.pts != AV_NOPTS:
                        self._emit_pts.add(pkt.pts)
                    else:
                        # no packet pts to match against: emit the next
                        # timestamp-less decoded frame instead
                        self._emit_nopts += 1
                frames = list(self.dec.decode(pkt.data, pkt.pts))
                if reached and (interval_f or interval_t):
                    if interval_f:
                        self.n_skipped_seek += self._seek_keyframe_frames(
                            interval_f)
                        self._frame_target += interval_f
                        self._time_target = time
                    else:
                        est = max(int(interval_t * max(self.dm.fps, 1.0)), 1)
                        self.n_skipped_seek += self._seek_keyframe_frames(est)
                        self._time_target += interval_t
                        self._frame_target = iframe
            for (y, u, v, pts) in frames:
                self.n_decoded += 1
                if pts in self._emit_pts:
                    self._emit_pts.discard(pts)
                    yield y, u, v, pts
                elif pts == AV_NOPTS and self._emit_nopts > 0:
                    self._emit_nopts -= 1
                    yield y, u, v, pts

    def extract_batch(self, max_frames: int
                      ) -> Optional[Tuple[np.ndarray, ...]]:
        """Stack up to max_frames extracted frames into planar batches."""
        ys, us, vs, pts = [], [], [], []
        it = getattr(self, "_it", None)
        if it is None:
            it = self._it = self.frames()
        for (y, u, v, p) in it:
            ys.append(y)
            us.append(u)
            vs.append(v)
            pts.append(p)
            if len(ys) >= max_frames:
                break
        if not ys:
            return None
        return (np.stack(ys), np.stack(us), np.stack(vs),
                np.asarray(pts, np.int64))

    def close(self):
        self.dm.close()
        self.dm_seek.close()
        self.dec.close()


class FrameSelect:
    """Scene-cut frame selection (FrameSelect.h analog): decode every
    frame, score scene changes per batch on `device` (the card unless the
    caller asks for the CPU), yield frames whose score exceeds the
    threshold (select_gpu='gt(scene,0.4)')."""

    def __init__(self, path, threshold: float = 0.4,
                 batch_size: int = 32, threads: int = 0, device="cuda"):
        self.dm = tk.Demuxer(path)   # path or in-memory bytes
        self.dec = tk.Decoder.from_demuxer(self.dm, threads)
        self.threshold = threshold
        self.batch_size = batch_size
        self.device = device
        self.width, self.height = self.dm.width, self.dm.height
        self.colorspace = self.dm.colorspace

    def _decoded(self):
        for pkt in self.dm:
            if pkt.stream != 0:
                continue
            yield from self.dec.decode(pkt.data, pkt.pts)
        yield from self.dec.decode(None)

    def _score(self, buf, prev_last, prev_mafd):
        """Scores of one batch of decoded frames, and the carry (last
        frame's planes on the device, last mafd) for the next."""
        fb = from_numpy_yuv420(*(np.stack([f[k] for f in buf])
                                 for k in range(3)),
                               colorspace=self.colorspace,
                               device=self.device)
        scores, last_mafd = scene_scores(fb, prev_last, prev_mafd)
        new_last = {k: v[-1] for k, v in fb.planes.items()}
        return scores.cpu().numpy(), new_last, float(last_mafd)

    def frames(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                       int, float]]:
        prev_last = None
        prev_mafd = 0.0
        buf = []
        for f in self._decoded():
            buf.append(f)
            if len(buf) >= self.batch_size:
                scores, prev_last, prev_mafd = self._score(buf, prev_last,
                                                           prev_mafd)
                for (y, u, v, pts), s in zip(buf, scores):
                    if s > self.threshold:
                        yield y, u, v, pts, float(s)
                buf = []
        if buf:
            # pad the tail to the full batch shape (repeating the last
            # frame), as the JAX package does to keep one compiled shape:
            # padded duplicates score 0 (sad == 0) and zip() stops at
            # len(buf), so the selection is the same
            padded = buf + [buf[-1]] * (self.batch_size - len(buf))
            scores, _, _ = self._score(padded, prev_last, prev_mafd)
            for (y, u, v, pts), s in zip(buf, scores):
                if s > self.threshold:
                    yield y, u, v, pts, float(s)

    def close(self):
        self.dm.close()
        self.dec.close()
