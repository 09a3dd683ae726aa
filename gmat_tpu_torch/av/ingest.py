"""Host ingest pipeline: decode workers -> prefetch queue -> device batches.

Counterpart of `gmat_tpu/av/ingest.py`, the rebuild of the reference's
producer/consumer plumbing:
  * RoundQueue (metrans/app/AppMeTrans/RoundQueue.h:5-63): single producer,
    N consumers with per-consumer cursors -> here a bounded queue.Queue fed
    by one producer thread (Python threads release the GIL in libav calls
    and in numpy copies, so decode overlaps the consumer's device work).
  * TransDataConverter pinned staging (TransDataConverter.h:12-89) -> a
    ring of `depth + 1` pinned host buffers: each batch is stacked straight
    into one, copied to the card with `non_blocking=True` on a side CUDA
    stream, and an event marks the copy's end.  The consumer's stream waits
    on that event before the batch is yielded, and a pinned buffer is
    refilled only after its last copy has completed.

Batches go to the card unless the caller asks for the CPU (`device="cpu"`,
as the tests do): then they stay host tensors over the stacked numpy
arrays.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from ..core.frame import FrameBatch

_TORCH = {np.dtype(np.uint8): torch.uint8, np.dtype(np.uint16): torch.uint16}


def _device(device) -> torch.device:
    """`device` as a torch.device with its index; a CUDA device without a
    card raises (there is no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA device was requested but torch.cuda.is_available() "
                "is false; pass device='cpu' to run on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class FrameBatchSource:
    """Iterates (y, u, v, pts) numpy tuples from any generator and groups
    them into planar numpy batches of a fixed size (padding the tail by
    repeating the last frame, with a valid-count).

    stage: optional callable (y_shape, c_shape, dtype) -> three numpy
    arrays that a batch is stacked into (pinned staging); by default
    np.stack allocates."""

    def __init__(self, frame_iter, batch: int, width: int, height: int,
                 colorspace: str = "bt709", stage=None):
        self.it = frame_iter
        self.batch = batch
        self.width, self.height = width, height
        self.colorspace = colorspace
        self.stage = stage

    def __iter__(self):
        ys, us, vs, pts, keys, poss, ilace = [], [], [], [], [], [], []
        self.dropped_resize = 0       # kept for compat; always 0 now
        self.resolution_changes = 0
        ref_shape = None

        def flush(n_valid):
            while len(ys) < self.batch:   # pad to static shape
                ys.append(ys[-1]); us.append(us[-1]); vs.append(vs[-1])
                pts.append(pts[-1]); keys.append(False); poss.append(-1)
                ilace.append(0)
            return self._pack(ys, us, vs, pts, keys, poss, ilace, n_valid)

        for item in self.it:
            y, u, v, p = item[:4]
            k = bool(item[4]) if len(item) > 4 else False
            po = int(item[5]) if len(item) > 5 else -1
            il = int(item[6]) if len(item) > 6 else 0
            if ref_shape is None:
                ref_shape = y.shape
            if y.shape != ref_shape:
                # mid-stream resolution change (NvDecLite recreates its
                # frame pool here, NvDecLite.cpp:97-106): flush the
                # partial batch of the OLD geometry, then continue at the
                # new one — every frame is delivered; batches carry their
                # own dims
                self.resolution_changes += 1
                if ys:
                    yield flush(len(ys))
                    ys, us, vs, pts, keys, poss, ilace = \
                        [], [], [], [], [], [], []
                ref_shape = y.shape
            ys.append(y); us.append(u); vs.append(v); pts.append(p)
            keys.append(k); poss.append(po); ilace.append(il)
            if len(ys) == self.batch:
                yield self._pack(ys, us, vs, pts, keys, poss, ilace,
                                 self.batch)
                ys, us, vs, pts, keys, poss, ilace = \
                    [], [], [], [], [], [], []
        if ys:
            yield flush(len(ys))

    def _pack(self, ys, us, vs, pts, keys, poss, ilace, valid):
        if self.stage is None:
            planes = (np.stack(ys), np.stack(us), np.stack(vs))
        else:
            planes = self.stage((len(ys),) + ys[0].shape,
                                (len(us),) + us[0].shape, ys[0].dtype)
            for out, frames in zip(planes, (ys, us, vs)):
                np.stack(frames, out=out)
        return (*planes, np.asarray(pts, np.int64), np.asarray(keys, bool),
                np.asarray(poss, np.int64), np.asarray(ilace, np.int8),
                valid)


class PinnedRing:
    """`slots` pinned host staging buffers for the host-to-device copies,
    used in turn.  A buffer is handed out again only after the copy that
    last read it has completed (its event)."""

    def __init__(self, slots: int):
        self.bufs: list = [None] * slots
        self.events: list = [None] * slots
        self.k = -1

    def take(self, y_shape, c_shape, dtype) -> tuple:
        """The next buffer's numpy views, to stack a batch into."""
        self.k = (self.k + 1) % len(self.bufs)
        if self.events[self.k] is not None:
            self.events[self.k].synchronize()
        bufs = self.bufs[self.k]
        shapes = (y_shape, c_shape, c_shape)
        if bufs is None or tuple(b.shape for b in bufs) != shapes \
                or bufs[0].dtype != _TORCH[np.dtype(dtype)]:
            bufs = self.bufs[self.k] = tuple(
                torch.empty(s, dtype=_TORCH[np.dtype(dtype)],
                            pin_memory=True) for s in shapes)
        return tuple(b.numpy() for b in bufs)

    def upload(self, planes, device, stream) -> tuple:
        """Copy `planes` to `device` on `stream`; returns the device
        tensors and the event that marks the copy's end.  Planes stacked
        into the buffer last handed out go as they are; any others are
        first copied into the next buffer."""
        bufs = self.bufs[self.k] if self.k >= 0 else None
        if bufs is None or any(p.ctypes.data != b.data_ptr()
                               for p, b in zip(planes, bufs)):
            for dst, src in zip(self.take(planes[0].shape, planes[1].shape,
                                          planes[0].dtype), planes):
                np.copyto(dst, src)
            bufs = self.bufs[self.k]
        with torch.cuda.stream(stream):
            dev = tuple(torch.empty(b.shape, dtype=b.dtype, device=device)
                        for b in bufs)
            for d, b in zip(dev, bufs):
                d.copy_(b, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(stream)
        self.events[self.k] = ev
        return dev, ev


class PrefetchQueue:
    """Producer thread fills a bounded queue of batches ready for the device.

    The RoundQueue analog: backpressure via the bounded queue (the
    reference spins with 1 ms sleeps, AppMeTrans.cpp:65-67).  For a CUDA
    device the producer stages each batch in `ring` (pinned) and starts its
    copy on a side stream, so the consumer overlaps compute with the next
    batch's H2D transfer; the consumer's stream waits on the copy's event.
    """

    _SENTINEL = object()

    def __init__(self, batch_iter, depth: int = 3, device="cuda",
                 ring: Optional[PinnedRing] = None,
                 colorspace: str = "bt709", width: int = 0, height: int = 0,
                 fmt: str = "yuv420p"):
        self.device = _device(device)
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
            self.ring = ring or PinnedRing(depth + 1)
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.fmt = fmt
        self.colorspace = colorspace
        self.width, self.height = width, height
        self.error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(batch_iter,), daemon=True)
        self._thread.start()

    def _run(self, batch_iter):
        try:
            for (y, u, v, pts, keys, poss, ilace, valid) in batch_iter:
                if self._stop.is_set():
                    break
                if self.device.type == "cuda":
                    planes, event = self.ring.upload((y, u, v), self.device,
                                                     self.stream)
                else:
                    planes = tuple(torch.from_numpy(p) for p in (y, u, v))
                    event = None
                # bounded put that also honors close() so an abandoned
                # consumer (e.g. an early exit) can't strand us
                while not self._stop.is_set():
                    try:
                        self.q.put((planes, event, pts, keys, poss, ilace,
                                    valid), timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:   # surface worker errors to the consumer
            self.error = e
        finally:
            # the sentinel MUST reach the consumer (a dropped sentinel
            # deadlocks q.get()); only close() may preempt delivery
            while True:
                try:
                    self.q.put(self._SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    if self._stop.is_set():
                        break

    def close(self):
        """Stop the producer and drain (safe after partial consumption)."""
        self._stop.set()
        while True:
            try:
                self.q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)

    def __iter__(self) -> Iterator[FrameBatch]:
        while True:
            item = self.q.get()
            if item is self._SENTINEL:
                if self.error:
                    raise self.error
                return
            (y, u, v), event, pts, keys, poss, ilace, valid = item
            if event is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(event)
                for t in (y, u, v):
                    # allocated on the side stream, used on this one: the
                    # caching allocator must not hand the memory back to
                    # the side stream before this stream's work ends
                    t.record_stream(stream)
            # per-batch dims: a mid-stream resolution change makes the
            # configured width/height stale for later batches
            h, w = y.shape[1], y.shape[2]
            fb = FrameBatch({"y": y, "u": u, "v": v}, self.fmt, w, h,
                            self.colorspace)
            self.last_keys = keys
            self.last_pos = poss
            self.last_interlaced = ilace
            yield fb, pts, valid


def _queue(frames, batch, depth, device, width, height, colorspace, fmt):
    ring = PinnedRing(depth + 1) if device.type == "cuda" else None
    src = FrameBatchSource(frames, batch, width, height, colorspace,
                           stage=ring.take if ring else None)
    return PrefetchQueue(iter(src), depth=depth, device=device, ring=ring,
                         colorspace=colorspace, width=width, height=height,
                         fmt=fmt)


def decode_stream(path: str, batch: int = 32, depth: int = 3,
                  device="cuda", threads: int = 0, seek: float = 0.0,
                  width: int = 0, height: int = 0, layout: str = "i420",
                  resize=None, crop=None, bits: int = 8):
    """Convenience: full-decode a file into prefetched device FrameBatches.

    Accepts compressed containers (mp4/mkv/...), .y4m, and headerless raw
    .yuv/.nv12/.iyuv (pass width/height/layout).  Yields
    (FrameBatch, pts_array, valid_count), with the planes on `device`
    (the card unless the caller asks for "cpu").

    resize=(w, h) / crop=(x, y, w, h): decoder-side early downscale/crop
    (compressed containers only) — frames shrink on the host before the
    H2D transfer (NvDecLite pCropRect/pResizeDim analog).

    bits=10 decodes through the 10-bit lane (decode16: any source depth
    normalized to lsb-aligned u16) and yields 'yuv420p10' batches — the
    reference's P016 pipeline (NvDecLite 10-bit output -> ScaleP016).
    The Y4M and raw lanes are pure Python; compressed containers need the
    libav*-linked host runtime (`av/native.py`).
    """
    from . import toolkit as tk

    device = _device(device)
    if bits not in (8, 10, 16):
        raise ValueError(f"bits must be 8, 10 or 16, got {bits}")
    lower = path.lower()
    if bits != 8 and lower.endswith((".yuv", ".nv12", ".iyuv", ".raw")):
        raise ValueError(f"bits={bits} is only supported for compressed "
                         "containers and high-depth .y4m (raw readers "
                         "are 8-bit)")
    if bits == 16 and not lower.endswith(".y4m"):
        raise ValueError("bits=16 ingest is Y4M-only (C420p16); the "
                         "compressed lane normalizes to the 10-bit path "
                         "(decode16), pass bits=10")
    if lower.endswith(".y4m"):
        from .rawvideo import Y4MReader
        rd = Y4MReader(path)
        # the Y4M header states the depth; require the caller to agree so
        # batch dtypes never change silently
        if rd.bits != bits:
            fbits = rd.bits
            rd.close()
            if fbits in (8, 10, 16):
                raise ValueError(f"{path} is {fbits}-bit "
                                 f"(C{rd.colorspace}); pass bits={fbits}")
            raise ValueError(f"{path} is {fbits}-bit (C{rd.colorspace}); "
                             "only 8-, 10- and 16-bit Y4M ingest is "
                             "supported")
        if seek > 0:   # O(1)-per-frame seek (marker + fseek, no reads)
            rd.skip(int(seek * rd.fps[0] / max(rd.fps[1], 1)))

        def frames():
            try:
                yield from rd.frames()
            finally:
                rd.close()
        # unspecified colorspace follows the swscale convention: SD
        # resolutions are bt601, HD bt709
        cs = "bt709" if rd.width > 1024 or rd.height > 576 else "bt601"
        q = _queue(frames(), batch, depth, device, rd.width, rd.height, cs,
                   {8: "yuv420p", 10: "yuv420p10", 16: "yuv420p16"}[bits])
        q.fps = rd.fps[0] / max(rd.fps[1], 1)
        return q
    if lower.endswith((".yuv", ".nv12", ".iyuv", ".raw")):
        if not (width and height):
            raise ValueError("raw input needs width/height")
        from .rawvideo import RawYUVReader
        lay = "nv12" if lower.endswith(".nv12") else layout
        rd = RawYUVReader(path, width, height, lay)
        if seek > 0:                 # raw assumes 30 fps; single fseek
            rd.skip(int(seek * 30.0))

        def frames():
            try:
                yield from rd.frames()
            finally:
                rd.close()
        cs = "bt709" if width > 1024 or height > 576 else "bt601"
        q = _queue(frames(), batch, depth, device, width, height, cs,
                   "yuv420p")
        q.fps = 30.0
        return q

    dm = tk.Demuxer(path)
    dec = tk.Decoder.from_demuxer(dm, threads, resize=resize, crop=crop)
    if seek > 0:
        dm.seek(seek)
    out_w, out_h = dec.width, dec.height
    dec_frames = dec.decode16 if bits == 10 else dec.decode

    # the backward keyframe seek lands up to a GOP before the target —
    # drop decoded frames whose time is still before `seek` (the y4m/raw
    # lanes skip to the exact frame; the compressed lane must match).
    # All stream times are offset by start_time (TS containers begin at
    # arbitrary pts); Demuxer.seek compensates too.
    AV_NOPTS = -(1 << 63)
    tbn, tbd = dm.time_base
    tb = tbn / max(tbd, 1)
    min_t = seek + dm.start_time - 1e-9 if seek > 0 else None

    def frames():
        key_pts = {}               # insertion-ordered set (oldest-first
        pos_by_pts = {}            # eviction); packet byte offsets by pts
        try:
            for pkt in dm:
                if pkt.stream != 0:
                    continue
                # NOPTS packets can't be attributed by pts (they'd all
                # collide on the sentinel): their frames report
                # key=False / pos=-1, honestly unknown
                if pkt.pts != AV_NOPTS:
                    if pkt.key:
                        key_pts[pkt.pts] = None
                    pos_by_pts[pkt.pts] = pkt.pos
                # bound both maps: orphaned entries (packets whose pts
                # never emerges as a frame) must not accumulate forever
                # in a 24/7 ingest; 512 packets >> any decoder reorder
                while len(pos_by_pts) > 512:
                    pos_by_pts.pop(next(iter(pos_by_pts)))
                while len(key_pts) > 512:
                    key_pts.pop(next(iter(key_pts)))
                for (y, u, v, p) in dec_frames(pkt.data, pkt.pts):
                    is_key = key_pts.pop(p, False) is None
                    if min_t is not None and p != AV_NOPTS and p * tb < min_t:
                        continue        # pre-roll from the keyframe seek
                    # interlaced flag: bit 0; tff: bit 1 (AVFrame props)
                    il = (int(getattr(dec, "last_interlaced", 0)) |
                          (int(getattr(dec, "last_tff", 0)) << 1))
                    yield y, u, v, p, is_key, pos_by_pts.pop(p, -1), il
            for (y, u, v, p) in dec_frames(None):
                is_key = key_pts.pop(p, False) is None
                if min_t is not None and p != AV_NOPTS and p * tb < min_t:
                    continue
                il = (int(getattr(dec, "last_interlaced", 0)) |
                      (int(getattr(dec, "last_tff", 0)) << 1))
                yield y, u, v, p, is_key, pos_by_pts.pop(p, -1), il
        finally:
            dm.close(); dec.close()

    q = _queue(frames(), batch, depth, device, out_w, out_h, dm.colorspace,
               "yuv420p10" if bits == 10 else "yuv420p")
    q.fps = dm.fps or 30.0
    return q
