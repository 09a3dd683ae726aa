"""The port's shared-memory decode ring (`gmat_tpu_torch/av/shm_ring.py`)
against the JAX package's.

Every test of tests/test_shm_ring.py runs here with the module's
`ShmRing`, `MultiProcDecodeSource` and `decode_stream_multiproc` replaced
by twins of both packages (tests/torch_twin.py): each call goes to the
JAX ring and to the port's, and the two must agree bit for bit — every
frame's planes and metadata, head/tail counters, the same exceptions —
before the JAX test's own assertions judge the port's result.

Worker processes interleave their rings by timing, so the twins of the
decode sources first drain the JAX source, then hand the test the port's
frames (batches on the CPU) and compare the two as multisets of frames
when the port's run ends.  The one threaded test
(`test_ring_backpressure_blocks_then_drains`) runs on the port's ring
alone: a producer thread and a consumer calling two rings in turn race
each other.  Beyond the mirror, a ring written by one package is read by
the other through the same shared-memory segment, both ways.
"""
import inspect
import os

import numpy as np
import pytest

import gmat_tpu.av.shm_ring as jax_ring
from gmat_tpu_torch.av import shm_ring as port_ring

from . import test_shm_ring
from .test_shm_ring import clip  # noqa: F401  (the mirrored tests' fixture)
from .torch_deadline import deadline
from .torch_twin import Twin, _side, assert_same

MIRRORED = [n for n, fn in vars(test_shm_ring).items()
            if n.startswith("test_") and inspect.isfunction(fn)]
# a producer thread and a consumer racing over two rings
PORT_ONLY = ("test_ring_backpressure_blocks_then_drains",)
# each spawning test's own bound (worker start-up is ~3 s per process)
SPAWN_TIMEOUT_S = 120


def _frame_key(item):
    y, u, v, pts, key, pos, il = item
    return (int(pts), bool(key), int(pos), int(il), str(y.dtype),
            y.shape, y.tobytes(), u.tobytes(), v.tobytes())


def _drain(it):
    got = []
    try:
        for item in it:
            got.append(item)
    except Exception as e:        # held to the port's below
        return got, e
    return got, None


def _same_error(ea, eb, where):
    assert ea is not None and eb is not None, \
        f"{where}: JAX raised {ea!r}, the port {eb!r}"
    assert (type(ea).__name__, str(ea)) == (type(eb).__name__, str(eb)), \
        f"{where}: {ea!r} vs {eb!r}"


class SourceTwin:
    """MultiProcDecodeSource of both packages on the same arguments."""

    def __init__(self, *args, **kw):
        self._ref = jax_ring.MultiProcDecodeSource(*args, **kw)
        try:
            self._port = port_ring.MultiProcDecodeSource(*args, **kw)
        except BaseException:
            self._ref.close()
            raise
        assert (self._ref.width, self._ref.height, self._ref.fps) == \
            (self._port.width, self._port.height, self._port.fps)

    @property
    def procs(self):
        return [Twin(a, b, name="proc", distinct=("pid",))
                for a, b in zip(self._ref.procs, self._port.procs)]

    def __getattr__(self, attr):
        return getattr(self._port, attr)

    def __iter__(self):
        want, ea = _drain(self._ref)
        got = []
        try:
            for item in self._port:
                got.append(item)
                yield item
        except Exception as eb:
            _same_error(ea, eb, "MultiProcDecodeSource")
            raise
        assert ea is None, f"JAX raised {ea!r}, the port did not"
        assert sorted(map(_frame_key, got)) == \
            sorted(map(_frame_key, want))

    def close(self):
        self._ref.close()
        self._port.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _batch_frames(q):
    """Every valid frame of a decode_stream_multiproc queue, with its
    batch's format and geometry."""
    frames = []
    for fb, pts, valid in q:
        planes = [np.asarray(fb.planes[k]) for k in "yuv"]
        for i in range(int(valid)):
            frames.append((int(pts[i]), fb.format, fb.width, fb.height,
                           str(planes[0].dtype),
                           *(p[i].tobytes() for p in planes)))
    return frames


class QueueTwin:
    """decode_stream_multiproc of both packages: the JAX queue is drained
    first; the port's batches (on the CPU) go to the caller and hold the
    same frames when its run ends."""

    def __init__(self, *args, **kw):
        ref = jax_ring.decode_stream_multiproc(*args, **kw)
        try:
            self._want = _batch_frames(ref)
        finally:
            ref.close()
        self._q = port_ring.decode_stream_multiproc(*args, device="cpu",
                                                    **kw)
        assert self._q.fps == ref.fps

    def __iter__(self):
        got = []
        for fb, pts, valid in self._q:
            assert fb.device.type == "cpu"
            planes = [fb.planes[k].numpy() for k in "yuv"]
            for i in range(int(valid)):
                got.append((int(pts[i]), fb.format, fb.width, fb.height,
                            str(planes[0].dtype),
                            *(p[i].tobytes() for p in planes)))
            yield fb, pts, valid
        assert sorted(got) == sorted(self._want)

    def close(self):
        self._q.close()


class _Os:
    """`os` for the mirrored tests: kill() takes a twin of two pids."""

    def __getattr__(self, name):
        return getattr(os, name)

    @staticmethod
    def kill(pid, sig):
        for i in (0, 1):
            os.kill(_side(pid, i), sig)


@pytest.mark.parametrize("name", MIRRORED)
def test_mirrors_jax(name, request, monkeypatch):
    if name in PORT_ONLY:
        monkeypatch.setattr(test_shm_ring, "ShmRing", port_ring.ShmRing)
    else:
        monkeypatch.setattr(test_shm_ring, "ShmRing", Twin(
            jax_ring.ShmRing, port_ring.ShmRing, name="ShmRing",
            distinct=("name",)))
    monkeypatch.setattr(test_shm_ring, "MultiProcDecodeSource", SourceTwin)
    monkeypatch.setattr(test_shm_ring, "decode_stream_multiproc", QueueTwin)
    monkeypatch.setattr(test_shm_ring, "os", _Os())
    fn = getattr(test_shm_ring, name)
    kw = {p: request.getfixturevalue(p)
          for p in inspect.signature(fn).parameters}
    with deadline(SPAWN_TIMEOUT_S):
        fn(**kw)


def test_mirror_covers_every_jax_test():
    assert len(MIRRORED) == 12


def _frames(rng, n, w, h, bits):
    hi = 1 << bits
    dt = np.uint16 if bits > 8 else np.uint8
    cw, ch = (w + 1) // 2, (h + 1) // 2
    return [(rng.integers(0, hi, (h, w)).astype(dt),
             rng.integers(0, hi, (ch, cw)).astype(dt),
             rng.integers(0, hi, (ch, cw)).astype(dt), 1000 * i, 7 * i,
             i % 3 == 0, i % 4) for i in range(n)]


@pytest.mark.parametrize("bits,w,h", [(8, 64, 48), (10, 48, 32),
                                      (8, 33, 17)])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ring_is_shared_between_packages(rng, bits, w, h, writer):
    """One segment, two packages: a ring that one package creates and
    fills is read by the other's handle attached by name (odd sizes
    included), with every field equal, and the segment's bytes equal
    those of the same puts into a ring of the other package."""
    mods = {"jax": jax_ring, "port": port_ring}
    reader = "port" if writer == "jax" else "jax"
    ring = mods[writer].ShmRing(w, h, slots=4, bits=bits)
    other = mods[reader].ShmRing(w, h, slots=4, bits=bits)
    peer = mods[reader].ShmRing(w, h, slots=4, name=ring.name, create=False,
                                bits=bits)
    try:
        frames = _frames(rng, 3, w, h, bits)
        for y, u, v, pts, pos, key, il in frames:
            assert ring.put(y, u, v, pts, pos, key, il)
            assert other.put(y, u, v, pts, pos, key, il)
        ring.set_error("decoder gave up")
        other.set_error("decoder gave up")
        assert bytes(ring.buf) == bytes(other.buf)
        assert (peer.head, peer.tail, peer.eof, peer.error) == \
            (3, 0, True, "decoder gave up")
        for y, u, v, pts, pos, key, il in frames:
            got = peer.get_nowait()
            assert_same((y, u, v, pts, key, pos, il), got, where="frame")
        assert peer.get_nowait() is None and ring.tail == 3
    finally:
        peer.close()
        other.close(unlink=True)
        ring.close(unlink=True)


def test_port_source_feeds_the_card_by_default(clip, monkeypatch):
    """decode_stream_multiproc stages its batches on the card unless the
    caller asks for the CPU: with no card it raises before any worker
    starts."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = []
    monkeypatch.setattr(port_ring, "MultiProcDecodeSource",
                        lambda *a, **k: started.append(a))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_ring.decode_stream_multiproc(clip, procs=1)
    assert started == []


def test_twin_catches_a_difference(monkeypatch):
    """The ring twin is not a pass-through: a port ring that reads one
    pts wrong fails the comparison."""
    real = port_ring.ShmRing.get_nowait

    def off_by_one(self):
        item = real(self)
        return item and (*item[:3], item[3] + 1, *item[4:])
    monkeypatch.setattr(port_ring.ShmRing, "get_nowait", off_by_one)
    ring = Twin(jax_ring.ShmRing, port_ring.ShmRing, name="ShmRing",
                distinct=("name",))(16, 8, slots=2)
    try:
        ring.put(np.zeros((8, 16), np.uint8), np.zeros((4, 8), np.uint8),
                 np.zeros((4, 8), np.uint8), pts=5)
        with pytest.raises(AssertionError, match="get_nowait"):
            ring.get_nowait()
    finally:
        ring.close(unlink=True)
