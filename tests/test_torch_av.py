"""The port's host ingest (Y4M/raw readers, decode_stream, prefetch queue),
host codec toolkit and host utilities against the JAX package's, on the
same files.  The port runs with device="cpu" here (no card)."""

import numpy as np
import pytest
import torch

from gmat_tpu.av import ingest as jingest
from gmat_tpu.av import rawvideo as jraw
from gmat_tpu.av import toolkit as jtk
from gmat_tpu.utils import encparam as jencparam
from gmat_tpu_torch.av import ingest, native, rawvideo, toolkit
from gmat_tpu_torch.utils import encparam, stopwatch
from tests.test_extractor import make_clip

NF, W, H = 7, 64, 48          # 7 frames in batches of 3: a padded tail


def _frames(rng, n=NF, w=W, h=H, bits=8):
    hi, dt = (256, np.uint8) if bits == 8 else (1 << bits, np.uint16)
    return [(rng.integers(0, hi, (h, w)).astype(dt),
             rng.integers(0, hi, (h // 2, w // 2)).astype(dt),
             rng.integers(0, hi, (h // 2, w // 2)).astype(dt))
            for _ in range(n)]


def _write_y4m(path, frames, bits=8):
    h, w = frames[0][0].shape
    wr = rawvideo.Y4MWriter(str(path), w, h, (25, 1), bits=bits)
    for f in frames:
        wr.write(*f)
    wr.close()


def _drain(q):
    out = []
    for fb, pts, valid in q:
        out.append(({k: np.asarray(v) for k, v in fb.planes.items()},
                    fb.format, fb.width, fb.height, fb.colorspace,
                    np.asarray(pts), int(valid)))
    return out


def _same_stream(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        gp, wp = g[0], w[0]
        assert sorted(gp) == sorted(wp) == ["u", "v", "y"]
        for k in wp:
            assert gp[k].dtype == wp[k].dtype
            np.testing.assert_array_equal(gp[k], wp[k])
        assert g[1:5] == w[1:5]               # format, dims, colorspace
        np.testing.assert_array_equal(g[5], w[5])
        assert g[6] == w[6]


@pytest.mark.parametrize("bits", [8, 10])
def test_y4m_decode_stream_matches_jax(rng, tmp_path, bits):
    frames = _frames(rng, bits=bits)
    path = tmp_path / "in.y4m"
    _write_y4m(path, frames, bits)
    got = _drain(ingest.decode_stream(str(path), batch=3, device="cpu",
                                      bits=bits))
    want = _drain(jingest.decode_stream(str(path), batch=3, bits=bits))
    _same_stream(got, want)
    # the tail batch repeats the last frame behind its valid count
    last = got[-1]
    assert last[6] == NF % 3
    np.testing.assert_array_equal(last[0]["y"][-1], frames[-1][0])
    assert last[0]["y"].shape == (3, H, W)
    assert isinstance(next(iter(ingest.decode_stream(
        str(path), batch=3, device="cpu", bits=bits)))[0].planes["y"],
        torch.Tensor)


def test_y4m_seek_matches_jax(rng, tmp_path):
    path = tmp_path / "in.y4m"
    _write_y4m(path, _frames(rng))
    got = _drain(ingest.decode_stream(str(path), batch=4, device="cpu",
                                      seek=0.12))
    want = _drain(jingest.decode_stream(str(path), batch=4, seek=0.12))
    _same_stream(got, want)
    assert got[0][5][0] == 3              # 0.12 s at 25 fps


@pytest.mark.parametrize("layout,suffix", [("i420", ".yuv"),
                                           ("nv12", ".nv12")])
def test_raw_decode_stream_matches_jax(rng, tmp_path, layout, suffix):
    frames = _frames(rng)
    path = str(tmp_path / f"in{suffix}")
    rawvideo.write_raw(path, frames, layout)
    jpath = str(tmp_path / f"jax{suffix}")
    jraw.write_raw(jpath, frames, layout)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    kw = dict(width=W, height=H, layout=layout)
    got = _drain(ingest.decode_stream(path, batch=3, device="cpu", **kw))
    want = _drain(jingest.decode_stream(path, batch=3, **kw))
    _same_stream(got, want)
    np.testing.assert_array_equal(got[0][0]["v"][1], frames[1][2])


@pytest.mark.parametrize("bits", [8, 10, 16])
def test_y4m_writer_bytes_match_jax(rng, tmp_path, bits):
    frames = _frames(rng, n=2, bits=bits)
    a, b = tmp_path / "a.y4m", tmp_path / "b.y4m"
    _write_y4m(a, frames, bits)
    wr = jraw.Y4MWriter(str(b), W, H, (25, 1), bits=bits)
    for f in frames:
        wr.write(*f)
    wr.close()
    assert a.read_bytes() == b.read_bytes()
    rd = rawvideo.Y4MReader(str(a))
    assert (rd.width, rd.height, rd.bits, rd.fps) == (W, H, bits, (25, 1))
    back = list(rd.frames())
    rd.close()
    for (y, u, v, _i), f in zip(back, frames):
        np.testing.assert_array_equal(y, f[0])
        np.testing.assert_array_equal(v, f[2])


def test_decode_stream_validation(tmp_path, rng):
    path = tmp_path / "in.y4m"
    _write_y4m(path, _frames(rng, n=1))
    for fn in (ingest.decode_stream, jingest.decode_stream):
        kw = {"device": "cpu"} if fn is ingest.decode_stream else {}
        with pytest.raises(ValueError, match="bits"):
            fn("x.mp4", bits=12, **kw)
        with pytest.raises(ValueError, match="raw input"):
            fn("x.yuv", **kw)
        with pytest.raises(ValueError, match="pass bits=8"):
            fn(str(path), bits=10, **kw)


def test_decode_stream_refuses_cuda_without_a_card(tmp_path, rng):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = tmp_path / "in.y4m"
    _write_y4m(path, _frames(rng, n=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        ingest.decode_stream(str(path), batch=2)      # device="cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        ingest.PrefetchQueue(iter([]), device="cuda")


def test_batch_source_stacks_into_stage(rng):
    """With a `stage`, each batch is stacked straight into the arrays it
    hands out (the pinned ring on a card), padding included."""
    frames = [(y, u, v, i) for i, (y, u, v) in enumerate(_frames(rng, n=5))]
    handed = []

    def stage(y_shape, c_shape, dtype):
        bufs = (np.empty(y_shape, dtype), np.empty(c_shape, dtype),
                np.empty(c_shape, dtype))
        handed.append(bufs)
        return bufs

    src = ingest.FrameBatchSource(iter(frames), 2, W, H, stage=stage)
    out = list(src)
    want = list(jingest.FrameBatchSource(iter(frames), 2, W, H))
    assert len(out) == len(want) == len(handed) == 3
    for got, ref, bufs in zip(out, want, handed):
        for k in range(3):
            assert got[k] is bufs[k]
            np.testing.assert_array_equal(got[k], ref[k])
        for k in range(3, 7):
            np.testing.assert_array_equal(got[k], ref[k])
        assert got[7] == ref[7]


def test_prefetch_queue_mixed_resolution_and_errors(rng):
    """Mid-stream resolution changes flush per-batch dims; producer
    errors reach the consumer; close() after partial use returns."""
    big, small = _frames(rng, n=3), _frames(rng, n=2, w=32, h=16)
    frames = [(*f, i) for i, f in enumerate(big + small)]
    q = ingest.PrefetchQueue(iter(ingest.FrameBatchSource(
        iter(frames), 2, W, H)), depth=2, device="cpu")
    dims = [(fb.width, fb.height, int(valid)) for fb, _pts, valid in q]
    assert dims == [(W, H, 2), (W, H, 1), (32, 16, 2)]

    def bad():
        yield frames[0]
        raise IOError("decoder died")

    q = ingest.PrefetchQueue(iter(ingest.FrameBatchSource(bad(), 1, W, H)),
                             depth=1, device="cpu")
    with pytest.raises(IOError, match="decoder died"):
        list(q)
    q = ingest.PrefetchQueue(iter(ingest.FrameBatchSource(
        iter(frames * 4), 1, W, H)), depth=1, device="cpu")
    next(iter(q))
    q.close()
    assert not q._thread.is_alive()


def test_toolkits_decode_the_same_clip(tmp_path):
    """Both toolkits (the port's builds its own library) decode one
    libx264 clip to equal frames, and both decode_streams batch it
    equally."""
    clip = str(tmp_path / "clip.mp4")
    make_clip(clip)
    assert native._LIBDIR.name == "_lib" and \
        native._LIBDIR.parent.name == "av" and \
        native._LIBDIR.parent.parent.name == "gmat_tpu_torch"

    def decode_all(tk):
        dm = tk.Demuxer(clip)
        dec = tk.Decoder.from_demuxer(dm)
        out = []
        for pkt in dm:
            if pkt.stream == 0:
                out.extend(dec.decode(pkt.data, pkt.pts))
        out.extend(dec.decode(None))
        info = (dm.width, dm.height, dm.fps, dm.time_base, dm.colorspace)
        dm.close()
        dec.close()
        return out, info

    got, ginfo = decode_all(toolkit)
    want, winfo = decode_all(jtk)
    assert ginfo == winfo and len(got) == len(want) == 60
    for g, w in zip(got, want):
        for a, b in zip(g[:3], w[:3]):
            np.testing.assert_array_equal(a, b)
        assert g[3] == w[3]
    _same_stream(_drain(ingest.decode_stream(clip, batch=16, device="cpu")),
                 _drain(jingest.decode_stream(clip, batch=16)))


@pytest.mark.parametrize("spec", [
    "codec=hevc:fps=30:preset=p4:rc=vbr:bitrate=2M:maxbitrate=2.5M:gop=250"
    ":bf=3",
    "codec=h264:preset=p1:constqp=25",
    "codec=h264:preset=p3:bitrate=3M",
])
def test_encparam_matches_jax(spec):
    assert encparam.parse_enc_param(spec) == jencparam.parse_enc_param(spec)
    with pytest.raises(ValueError):
        encparam.parse_enc_param("bogus_opt=1")


def test_stopwatch_and_meters():
    w = stopwatch.StopWatch()
    assert w.stop() >= 0.0
    m = stopwatch.FpsMeter("t", quiet=True)
    m.add(5)
    assert m.count == 5 and m.fps > 0
    lim = stopwatch.FpsLimiter(0)
    lim.tick(10)                       # unlimited: returns at once
    assert m.count == 5
