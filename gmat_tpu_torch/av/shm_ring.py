"""Shared-memory frame rings: multi-process decode -> one device consumer.

Counterpart of `gmat_tpu/av/shm_ring.py` (the ring and its workers are
the same numpy and `multiprocessing.shared_memory` code; the consumer
feeds the port's `av/ingest`).  The reference's RoundQueue
(metrans/app/AppMeTrans/RoundQueue.h:5-63) is a single-producer ring of
device frames with per-consumer cursors, fanning ONE decoder out to N
encoders inside one process.  The ingest problem here is the mirror
image: software decode is the bottleneck (SURVEY §7 "hard parts"), so N
decode *processes* (real parallelism — libav decode is CPU-bound and the
GIL caps threads) must fan IN to one consumer that batches frames and
uploads them to the card.

Each worker owns one SPSC ring in POSIX shared memory
(multiprocessing.shared_memory): the producer writes I420 planes + frame
metadata into fixed-size slots and bumps `head`; the consumer copies out
at `tail`.  Single-writer-per-counter makes the ring safe without locks
(same argument as RoundQueue's per-consumer cursors); backpressure is a
bounded ring + short sleeps (the reference spins with 1 ms sleeps,
AppMeTrans.cpp:65-67).  Worker errors land in the ring header and re-raise
in the consumer; a worker that dies silently is detected via liveness.
The workers are spawned, never forked, and touch no CUDA: a child forked
after CUDA is initialised cannot use it.

    MultiProcDecodeSource(paths, procs=4)  ->  iterate (y, u, v, pts, ...)
        round-robin across rings, strict per-ring FIFO

`apps/perf.py pipeline -procs N` wires this into the fused ladder.
"""
from __future__ import annotations

import struct
import time
from multiprocessing import get_context, shared_memory
from typing import List, Optional, Sequence, Tuple

import numpy as np

# header: head u64 | tail u64 | eof u32 | err_len u32 | err bytes
_HDR_FMT = "<QQII"
_HDR_SIZE = struct.calcsize(_HDR_FMT)
_ERR_SIZE = 512
_META_FMT = "<qqBBxxxxxx"        # pts i64 | pos i64 | key u8 | ilace u8
_META_SIZE = struct.calcsize(_META_FMT)
assert _META_SIZE == 24


class ShmRing:
    """One SPSC ring of fixed-size frame slots in shared memory."""

    def __init__(self, width: int, height: int, slots: int = 8,
                 name: Optional[str] = None, create: bool = True,
                 bits: int = 8):
        # I420 chroma is ceil(w/2) x ceil(h/2) (covers odd dims too)
        cw, ch = (width + 1) // 2, (height + 1) // 2
        self.width, self.height = width, height
        self.cw, self.ch = cw, ch
        self.bits = bits
        self.dtype = np.uint16 if bits > 8 else np.uint8
        isz = 2 if bits > 8 else 1
        self.yelems = width * height
        self.celems = cw * ch
        self.ybytes = self.yelems * isz
        self.cbytes = self.celems * isz
        self.slot_bytes = _META_SIZE + self.ybytes + 2 * self.cbytes
        self.slots = slots
        total = _HDR_SIZE + _ERR_SIZE + slots * self.slot_bytes
        self.shm = shared_memory.SharedMemory(
            name=name, create=create, size=total if create else 0)
        self.buf = self.shm.buf
        if create:
            self.buf[:_HDR_SIZE + _ERR_SIZE] = bytes(_HDR_SIZE + _ERR_SIZE)
        self.name = self.shm.name

    # -- header accessors (each counter has exactly one writer) ------------
    @property
    def head(self) -> int:
        return struct.unpack_from("<Q", self.buf, 0)[0]

    @property
    def tail(self) -> int:
        return struct.unpack_from("<Q", self.buf, 8)[0]

    def _slot_off(self, idx: int) -> int:
        return _HDR_SIZE + _ERR_SIZE + (idx % self.slots) * self.slot_bytes

    # -- producer side ------------------------------------------------------
    def put(self, y: np.ndarray, u: np.ndarray, v: np.ndarray, pts: int,
            pos: int = -1, key: bool = False, interlaced: int = 0,
            stop=None, sleep: float = 0.001) -> bool:
        """Copy one frame in; blocks (1 ms sleeps) while the ring is full.
        Returns False if `stop` (an Event-like) fired while waiting."""
        head = self.head
        while head - self.tail >= self.slots:     # full: backpressure
            if stop is not None and stop.is_set():
                return False
            time.sleep(sleep)
        off = self._slot_off(head)
        struct.pack_into(_META_FMT, self.buf, off, int(pts), int(pos),
                         1 if key else 0, int(interlaced) & 0xFF)
        o = off + _META_SIZE
        dt = self.dtype
        yv = np.frombuffer(self.buf, dt, self.yelems, o)
        yv[:] = np.ascontiguousarray(y, dt).reshape(-1)
        o += self.ybytes
        uv = np.frombuffer(self.buf, dt, self.celems, o)
        uv[:] = np.ascontiguousarray(u, dt).reshape(-1)
        o += self.cbytes
        vv = np.frombuffer(self.buf, dt, self.celems, o)
        vv[:] = np.ascontiguousarray(v, dt).reshape(-1)
        # publish AFTER the payload write (CPython/x86: the buffer stores
        # above complete before this struct.pack_into's store is visible)
        struct.pack_into("<Q", self.buf, 0, head + 1)
        return True

    def set_eof(self):
        struct.pack_into("<I", self.buf, 16, 1)

    def set_error(self, msg: str):
        data = msg.encode("utf-8", "replace")[:_ERR_SIZE]
        self.buf[_HDR_SIZE:_HDR_SIZE + len(data)] = data
        struct.pack_into("<I", self.buf, 20, len(data))
        self.set_eof()

    # -- consumer side ------------------------------------------------------
    @property
    def eof(self) -> bool:
        return struct.unpack_from("<I", self.buf, 16)[0] != 0

    @property
    def error(self) -> Optional[str]:
        n = struct.unpack_from("<I", self.buf, 20)[0]
        if not n:
            return None
        return bytes(self.buf[_HDR_SIZE:_HDR_SIZE + n]).decode(
            "utf-8", "replace")

    def empty(self) -> bool:
        return self.tail >= self.head

    def get_nowait(self):
        """Pop one frame (copies out) or None if the ring is empty."""
        tail = self.tail
        if tail >= self.head:
            return None
        off = self._slot_off(tail)
        pts, pos, key, ilace = struct.unpack_from(_META_FMT, self.buf, off)
        o = off + _META_SIZE
        dt = self.dtype
        y = np.frombuffer(self.buf, dt, self.yelems, o) \
            .reshape(self.height, self.width).copy()
        o += self.ybytes
        u = np.frombuffer(self.buf, dt, self.celems, o) \
            .reshape(self.ch, self.cw).copy()
        o += self.cbytes
        v = np.frombuffer(self.buf, dt, self.celems, o) \
            .reshape(self.ch, self.cw).copy()
        struct.pack_into("<Q", self.buf, 8, tail + 1)     # release slot
        return y, u, v, pts, bool(key), pos, ilace

    def close(self, unlink: bool = False):
        # drop numpy views before closing the mapping (BufferError guard)
        self.buf = None
        self.shm.close()
        if unlink:
            try:
                self.shm.unlink()
            except FileNotFoundError:
                pass


def _decode_worker(path: str, ring_name: str, width: int, height: int,
                   slots: int, threads: int, max_frames: int,
                   bits: int = 8):
    """Child process: decode `path`, ship I420 planes into the ring
    (bits=10: the decode16 lane, u16 lsb-aligned samples)."""
    ring = ShmRing(width, height, slots, name=ring_name, create=False,
                   bits=bits)
    try:
        from . import toolkit as tk
        dm = tk.Demuxer(path)
        dec = tk.Decoder.from_demuxer(dm, threads)
        if (dec.width, dec.height) != (width, height):
            raise RuntimeError(
                f"decoder is {dec.width}x{dec.height}, ring expects "
                f"{width}x{height}")
        decode = dec.decode16 if bits == 10 else dec.decode
        sent = 0
        # key/pos attributed by pts, NOT by the packet currently being
        # fed: with decoder reorder delay (B-frames, frame threads) the
        # frames a decode() call emits belong to EARLIER packets — the
        # same mapping the single-process path uses (ingest.py frames())
        key_pts: dict = {}
        pos_by_pts: dict = {}

        def ship(frames):
            nonlocal sent
            for (y, u, v, p) in frames:
                if max_frames and sent >= max_frames:
                    return False
                il = (int(getattr(dec, "last_interlaced", 0)) |
                      (int(getattr(dec, "last_tff", 0)) << 1))
                is_key = key_pts.pop(p, False) is None
                ring.put(y, u, v, p, pos_by_pts.pop(p, -1), is_key, il)
                sent += 1
            return not (max_frames and sent >= max_frames)

        for pkt in dm:
            if pkt.stream != 0:
                continue
            if pkt.key:
                key_pts[pkt.pts] = None
            pos_by_pts[pkt.pts] = pkt.pos
            while len(pos_by_pts) > 512:     # bound orphaned entries
                pos_by_pts.pop(next(iter(pos_by_pts)))
            while len(key_pts) > 512:
                key_pts.pop(next(iter(key_pts)))
            if not ship(decode(pkt.data, pkt.pts)):
                break
        else:
            ship(decode(None))
        dm.close(); dec.close()
        ring.set_eof()
    except BaseException as e:       # propagate into the consumer
        ring.set_error(f"{type(e).__name__}: {e}")
        raise
    finally:
        ring.close()


class MultiProcDecodeSource:
    """N decode worker processes -> one frame iterator (the fan-IN ring).

    `paths` may be one path (replicated to every worker — the perf
    census shape, AppNvDecPerf.cpp:155-171) or one path per worker.  All
    inputs must decode to the same resolution (one ring geometry).

    Ordering guarantee: strict FIFO within each ring (per-stream decode
    order is preserved).  ACROSS rings the consumer polls round-robin
    but skips momentarily-empty rings, so the interleave is
    timing-dependent — do not rely on a deterministic cross-stream
    order.  Worker errors re-raise here; a worker that dies without
    reporting (SIGKILL/OOM) raises RuntimeError via liveness detection.
    """

    def __init__(self, paths, procs: int = 0, width: int = 0,
                 height: int = 0, slots: int = 8, threads: int = 1,
                 max_frames_per_worker: int = 0, bits: int = 8):
        if isinstance(paths, str):
            paths = [paths] * max(procs, 1)
        self.paths: Sequence[str] = list(paths)
        if procs and len(self.paths) != procs:
            raise ValueError("paths/procs mismatch")
        if bits not in (8, 10):
            raise ValueError(f"bits must be 8 or 10, got {bits}")
        self.bits = bits
        self.fps = 0.0
        if not (width and height):
            from . import toolkit as tk
            dm = tk.Demuxer(self.paths[0])
            dec = tk.Decoder.from_demuxer(dm, 0)
            width, height = dec.width, dec.height
            self.fps = dm.fps or 0.0
            dm.close(); dec.close()
        self.width, self.height = width, height
        ctx = get_context("spawn")
        self.rings: List[ShmRing] = []
        self.procs = []
        try:
            for p in self.paths:
                ring = ShmRing(width, height, slots, bits=bits)
                self.rings.append(ring)
                w = ctx.Process(target=_decode_worker,
                                args=(p, ring.name, width, height, slots,
                                      threads, max_frames_per_worker,
                                      bits),
                                daemon=True)
                w.start()
                self.procs.append(w)
        except BaseException:
            self.close()
            raise

    def __iter__(self):
        live = list(range(len(self.rings)))
        while live:
            progressed = False
            for i in list(live):
                ring = self.rings[i]
                item = ring.get_nowait()
                if item is not None:
                    progressed = True
                    yield item
                    continue
                if ring.eof and ring.empty():
                    err = ring.error
                    if err:
                        raise RuntimeError(
                            f"decode worker {i} ({self.paths[i]}): {err}")
                    live.remove(i)
                elif not self.procs[i].is_alive() and ring.empty() \
                        and not ring.eof:
                    raise RuntimeError(
                        f"decode worker {i} died (exitcode "
                        f"{self.procs[i].exitcode}) without EOF")
            if live and not progressed:
                time.sleep(0.001)       # all rings momentarily empty

    def close(self):
        for w in self.procs:
            if w.is_alive():
                w.terminate()
        for w in self.procs:
            w.join(timeout=5.0)
        for r in self.rings:
            r.close(unlink=True)
        self.procs, self.rings = [], []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def decode_stream_multiproc(paths, procs: int = 4, batch: int = 32,
                            depth: int = 3, device="cuda", slots: int = 8,
                            threads: int = 1, colorspace: str = "bt709",
                            bits: int = 8):
    """Multi-process decode fan-in -> prefetched device FrameBatches.

    The full multi-core ingest path: N worker processes decode, the ring
    consumer groups frames into batches (FrameBatchSource), stacking each
    batch into a pinned buffer, and a producer thread copies it to the
    card on a side stream (PrefetchQueue) while the card computes —
    RoundQueue + TransDataConverter, at process scale.  Yields
    (FrameBatch, pts, valid) like `ingest.decode_stream`, with the planes
    on `device` (the card unless the caller asks for "cpu").  bits=10
    ships u16 lsb-aligned planes ('yuv420p10' batches, the decode16
    lane).
    """
    from .ingest import _device, _queue

    device = _device(device)
    src = MultiProcDecodeSource(paths, procs, slots=slots, threads=threads,
                                bits=bits)

    def frames():
        try:
            yield from src
        finally:
            src.close()

    try:
        q = _queue(frames(), batch, depth, device, src.width, src.height,
                   colorspace, "yuv420p10" if bits == 10 else "yuv420p")
    except BaseException:
        # the generator's finally never runs if construction fails —
        # stop the worker processes and unlink the shm segments here
        src.close()
        raise
    q.fps = src.fps
    return q
