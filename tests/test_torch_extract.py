"""Smart decode in the port (scene scores, FrameExtractor, FrameSelect,
gmat-extract, extract_to_torch, the logger) against the JAX package, on
the same libx264 clips made with the port's toolkit.  The port scores on
the CPU here (device="cpu"); there is no card."""
import socket

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gmat_tpu.apps import extract as jextract
from gmat_tpu.av import extractor as jextractor
from gmat_tpu.av import torch_interop as jinterop
from gmat_tpu.core import formats as jformats
from gmat_tpu.core.frame import FrameBatch as JFrameBatch
from gmat_tpu.ops import scene as jscene
from gmat_tpu_torch.apps import extract
from gmat_tpu_torch.av import extractor, torch_interop
from gmat_tpu_torch.av import toolkit as tk
from gmat_tpu_torch.core import formats
from gmat_tpu_torch.core.frame import FrameBatch
from gmat_tpu_torch.ops import ladder, scene
from gmat_tpu_torch.utils import logger

W, H, NFRAMES = 320, 240, 60
SCORE_RTOL = 1e-6
# extract_to_torch runs preprocess_nchw's separate-op path in both
# packages on the CPU: the bound of the port's separate-op parity tests
NCHW_ATOL = 1e-4


def make_clip(path, scene_cut_at=None, bf=0):
    """Flat-luma frames: y value encodes the frame index (20 + 3*i); the
    content jumps at `scene_cut_at`.  Encoded with the port's toolkit."""
    enc = tk.Encoder("libx264", W, H, fps=(30, 1), gop=12, bf=bf,
                     preset="veryfast", crf=14.0)
    pkts = []
    for i in range(NFRAMES):
        lum, uu, vv = 20 + 3 * i, 110, 140
        if scene_cut_at is not None and i >= scene_cut_at:
            lum, uu, vv = 235 - (i - scene_cut_at) * 2, 60, 200
        pkts += enc.encode(np.full((H, W), lum, np.uint8),
                           np.full((H // 2, W // 2), uu, np.uint8),
                           np.full((H // 2, W // 2), vv, np.uint8), pts=i)
    pkts += enc.flush()
    mux = tk.Muxer(path, W, H, (30, 1), tk.CODEC_H264, enc.extradata())
    for p in pkts:
        mux.write(p)
    mux.close()
    enc.close()


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("smart")
    out = {}
    for name, kw in (("plain", {}), ("bframes", {"bf": 2}),
                     ("cut", {"scene_cut_at": 30})):
        out[name] = str(d / f"{name}.mp4")
        make_clip(out[name], **kw)
    return out


_STATS = ("n_demuxed", "n_skipped_seek", "n_skipped_nonref", "n_decoded")


def _drain(fx):
    frames = list(fx.frames())
    stats = tuple(getattr(fx, k) for k in _STATS)
    fx.close()
    return frames, stats


def _same_frames(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[3] == w[3]                   # pts
        for a, b in zip(g[:3], w[:3]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("clip,kw", [
    ("plain", {}),
    ("plain", {"frame_interval": 10}),
    ("bframes", {"frame_interval": 10}),
    ("plain", {"time_interval": 1.0 / 3.0}),
    ("plain", {"frame_interval": 5}),
    ("memory", {"frame_interval": 30}),
], ids=["every_frame", "every_10th", "every_10th_bframes", "time_interval",
        "interval_below_gop", "memory_buffer"])
def test_frame_extractor_matches_jax(clips, clip, kw):
    src = (open(clips["plain"], "rb").read() if clip == "memory"
           else clips[clip])
    got, got_stats = _drain(extractor.FrameExtractor(src, **kw))
    want, want_stats = _drain(jextractor.FrameExtractor(src, **kw))
    _same_frames(got, want)
    assert got_stats == want_stats
    if kw.get("frame_interval") == 10:
        assert got_stats[1] > 0            # the GOP seek engaged
    if clip == "bframes":
        assert got_stats[2] > 0            # non-ref frames skipped


def test_extract_batch_and_set_interval_match_jax(clips):
    fxs = [m.FrameExtractor(clips["plain"], frame_interval=5)
           for m in (extractor, jextractor)]
    for step in ((3, None), (2, 15), (50, None), (4, None)):
        n, interval = step
        outs = []
        for fx in fxs:
            if interval:
                fx.set_interval(frames=interval)
            outs.append(fx.extract_batch(n))
        if outs[1] is None:
            assert outs[0] is None
            continue
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a, b)
    for fx in fxs:
        fx.close()


@pytest.mark.parametrize("batch", [16, 7])
def test_frame_select_matches_jax(clips, batch):
    """The same cut frames and scores, the padded tail batch included
    (60 frames: a tail of 12 of 16, or 4 of 7)."""
    fs = extractor.FrameSelect(clips["cut"], threshold=0.4,
                               batch_size=batch, device="cpu")
    js = jextractor.FrameSelect(clips["cut"], threshold=0.4,
                                batch_size=batch)
    got, want = list(fs.frames()), list(js.frames())
    fs.close()
    js.close()
    assert len(got) == len(want) == 1
    _same_frames([g[:4] for g in got], [w[:4] for w in want])
    np.testing.assert_allclose([g[4] for g in got], [w[4] for w in want],
                               rtol=SCORE_RTOL)
    # a lower threshold selects more frames, the same in both packages
    fs = extractor.FrameSelect(clips["cut"], threshold=0.0,
                               batch_size=batch, device="cpu")
    js = jextractor.FrameSelect(clips["cut"], threshold=0.0,
                                batch_size=batch)
    got, want = list(fs.frames()), list(js.frames())
    fs.close()
    js.close()
    assert [g[3] for g in got] == [w[3] for w in want] and len(got) > 1
    np.testing.assert_allclose([g[4] for g in got], [w[4] for w in want],
                               rtol=SCORE_RTOL)


# --------------------------------------------------------- scene scores

def _batch(rng, fmt, n=6, h=32, w=48):
    """Seeded planes whose content changes by a different amount from
    frame to frame (so consecutive mafds differ by much)."""
    def ramp(shape, hi, dtype):
        base = rng.integers(0, hi // 2, shape[1:])
        amp = rng.integers(1, hi // 4, (shape[0],) + (1,) * (len(shape) - 1))
        noise = rng.integers(0, hi // 4, shape)
        return np.clip(base + amp * (noise > hi // 8) + noise, 0,
                       hi - 1).astype(dtype)

    if fmt in ("yuv420p", "yuv420p10"):
        hi, dt = (256, np.uint8) if fmt == "yuv420p" else (1024, np.uint16)
        return {"y": ramp((n, h, w), hi, dt),
                "u": ramp((n, h // 2, w // 2), hi, dt),
                "v": ramp((n, h // 2, w // 2), hi, dt)}
    if fmt == "rgb24":
        return {"rgb": ramp((n, h, w, 3), 256, np.uint8)}
    # planar rgbpf32 held as (N, 3, H, W), as a direct constructor may
    return {"rgb": (ramp((n, 3, h, w), 256, np.uint8) / 255.0)
            .astype(np.float32)}


def _scores(fmt, planes, h, w, prev=None, prev_mafd=0.0, bitdepth=8):
    jfb = JFrameBatch({k: jnp.asarray(v) for k, v in planes.items()}, fmt,
                      w, h)
    fb = FrameBatch({k: torch.from_numpy(v) for k, v in planes.items()},
                    fmt, w, h)
    jprev = None if prev is None else {k: jnp.asarray(v)
                                       for k, v in prev.items()}
    tprev = None if prev is None else {k: torch.from_numpy(v)
                                       for k, v in prev.items()}
    want = jscene.scene_scores_mafd(jfb, jprev, prev_mafd, bitdepth)
    got = scene.scene_scores_mafd(fb, tprev, prev_mafd, bitdepth)
    last = scene.scene_scores(fb, tprev, prev_mafd, bitdepth)
    assert torch.equal(last[0], got[0]) and float(last[1]) == float(got[1][-1])
    return [g.numpy() for g in got], [np.asarray(x) for x in want]


@pytest.mark.parametrize("fmt,carry", [
    ("yuv420p", False), ("yuv420p10", False), ("yuv420p", True),
    ("rgb24", False), ("rgbpf32", False), ("rgbpf32", True)])
def test_scene_scores_match_jax(rng, fmt, carry):
    h, w = 32, 48
    planes = _batch(rng, fmt, h=h, w=w)
    prev, prev_mafd = None, 0.0
    if carry:
        prev = {k: v[-1] for k, v in _batch(rng, fmt, h=h, w=w).items()}
        prev_mafd = 7.25
    bitdepth = 10 if fmt == "yuv420p10" else 8
    (score, mafd), (jscore, jmafd) = _scores(fmt, planes, h, w, prev,
                                             prev_mafd, bitdepth)
    for g, wnt in ((score, jscore), (mafd, jmafd)):
        assert g.dtype == np.float32 and g.shape == wnt.shape == (6,)
    # integer planes sum exactly in f32 at this size; RGB luma and float
    # samples do not, and the two packages sum in another order: mafd
    # within 1e-6 relative, and the score, min(mafd, |mafd - prev|) / 100,
    # within the absolute error that allows (the difference of two mafds
    # can cancel most of their digits)
    np.testing.assert_allclose(mafd, jmafd, rtol=SCORE_RTOL, atol=0)
    np.testing.assert_allclose(
        score, jscore, rtol=0,
        atol=2 * SCORE_RTOL * float(np.abs(jmafd).max()) / 100.0)
    if fmt in ("yuv420p", "yuv420p10"):
        assert np.array_equal(mafd, jmafd) and np.array_equal(score, jscore)
    assert (score[0] == 0) == (prev is None)
    assert scene.score_depth(formats.get(fmt)) == \
        jscene.score_depth(jformats.get(fmt))


def test_scene_scores_hard_cut():
    """test_extractor.py's hand-computed case: a cut at frame 2."""
    n, h, w = 4, 32, 32
    y = np.zeros((n, h, w), np.uint8)
    y[2] = 200
    u = np.full((n, h // 2, w // 2), 128, np.uint8)
    fb = FrameBatch({"y": torch.from_numpy(y), "u": torch.from_numpy(u),
                     "v": torch.from_numpy(u.copy())}, "yuv420p", w, h)
    scores, last_mafd = scene.scene_scores(fb)
    mafd2 = 200.0 * h * w / (h * w * 1.5)
    assert scores[0] == 0.0 and scores[1] == 0.0
    np.testing.assert_allclose(float(scores[2]), min(mafd2 / 100.0, 1.0),
                               rtol=1e-6)
    np.testing.assert_allclose(float(last_mafd), mafd2, rtol=1e-6)


# ------------------------------------------------ gmat-extract, interop

@pytest.fixture
def no_jax_cache(monkeypatch):
    """The JAX app turns on JAX's on-disk compile cache under $HOME; keep
    the test process off it."""
    from gmat_tpu.utils import compile_cache
    monkeypatch.setattr(compile_cache, "enable", lambda *a, **k: None)


@pytest.mark.parametrize("flags", [
    ["-interval", "20"], ["-time-interval", "0.5"],
    ["-scene", "0.4"], ["-frames", "7"]],
    ids=["interval", "time_interval", "scene", "frames"])
def test_extract_app_y4m_matches_jax(clips, tmp_path, no_jax_cache, flags):
    clip = clips["cut" if "-scene" in flags else "plain"]
    got, want = tmp_path / "port.y4m", tmp_path / "jax.y4m"
    assert extract.main(["-i", clip, "-o", str(got)] + flags,
                        device="cpu") == 0
    assert jextract.main(["-i", clip, "-o", str(want)] + flags) == 0
    assert got.read_bytes() == want.read_bytes()
    assert got.read_bytes().count(b"FRAME\n") > 0


@pytest.mark.parametrize("out", ["f_%d.jpg", "still.jpeg", "img%04d.png"])
def test_extract_app_jpeg_matches_jax(clips, tmp_path, no_jax_cache, out):
    """JPEG stills (a %d pattern, a plain .jpg name that becomes
    base_%d.jpg, a %04d pattern with another extension) are byte-equal to
    the JAX app's: the same frames, full-range expansion and entropy
    coding.  An unsupported output still fails before any decode."""
    flags = ["-interval", "20", "-quality", "88"]
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    assert extract.main(["-i", clips["plain"], "-o",
                         str(tmp_path / "p" / out)] + flags,
                        device="cpu") == 0
    assert jextract.main(["-i", clips["plain"], "-o",
                          str(tmp_path / "j" / out)] + flags) == 0
    got = sorted(p.name for p in (tmp_path / "p").iterdir())
    assert got == sorted(p.name for p in (tmp_path / "j").iterdir())
    assert len(got) == NFRAMES // 20
    for name in got:
        data = (tmp_path / "p" / name).read_bytes()
        assert data[:2] == b"\xff\xd8"
        assert data == (tmp_path / "j" / name).read_bytes()

    def no_decode(*a, **k):
        raise AssertionError("decoded before the output was resolved")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(extract, "FrameExtractor", no_decode)
        mp.setattr(extract, "FrameSelect", no_decode)
        with pytest.raises(SystemExit, match="unsupported output"):
            extract.main(["-i", clips["plain"], "-o",
                          str(tmp_path / "x.mp4")])


def test_still_pattern_matches_jax_cli():
    from gmat_tpu.apps.cli import still_pattern
    for out in ("f_%d.jpg", "a%%b_%03d.jpg", "still.jpeg", "x.y.jpg",
                "100%.jpg", "noext"):
        assert extract.still_pattern(out) == still_pattern(out)


@pytest.mark.parametrize("interval,out_size,batch", [
    (20, (64, 48), 2), (7, None, 4)], ids=["resized", "native_tail"])
def test_extract_to_torch_matches_jax(clips, interval, out_size, batch):
    before = dict(ladder.LAUNCHES)
    got = list(torch_interop.extract_to_torch(
        clips["plain"], frame_interval=interval, out_size=out_size,
        batch=batch, device="cpu"))
    want = list(jinterop.extract_to_torch(
        clips["plain"], frame_interval=interval, out_size=out_size,
        batch=batch))
    assert ladder.LAUNCHES == before
    assert len(got) == len(want) > 0
    ow, oh = out_size or (W, H)
    for (t, pts), (jt, jpts) in zip(got, want):
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        assert t.shape == jt.shape and t.shape[1:] == (3, oh, ow)
        np.testing.assert_array_equal(pts, jpts)
        np.testing.assert_allclose(t.numpy(), jt.numpy(), atol=NCHW_ATOL,
                                   rtol=0)
    assert sum(t.shape[0] for t, _ in got) == len(range(0, NFRAMES,
                                                        interval))


def test_extract_to_torch_defaults_to_the_card(clips):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        next(torch_interop.extract_to_torch(clips["plain"], 20))
    fs = extractor.FrameSelect(clips["cut"])
    with pytest.raises(RuntimeError, match="CUDA"):
        next(fs.frames())
    fs.close()


# ---------------------------------------------------------------- logger

def test_logger_console_and_file(tmp_path):
    f = str(tmp_path / "log.txt")
    logger.setup(level=logger.TRACE, console=False, file=f)
    logger.trace("hello %d", 42)
    logger.error("bad thing")
    text = open(f).read()
    assert "hello 42" in text and "TRACE" in text
    assert "bad thing" in text and "ERROR" in text
    logger.setup(console=False)


def test_logger_console(capsys):
    logger.setup(level=logger.INFO, console=True)
    logger.debug("not shown")
    logger.warn("shown %s", "here")
    err = capsys.readouterr().err
    assert "shown here" in err and "WARNING" in err
    assert "not shown" not in err
    logger.setup(console=False)


def test_logger_udp():
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", 0))
    sock.settimeout(2.0)
    logger.setup(console=False, udp=("127.0.0.1", sock.getsockname()[1]))
    logger.info("over the wire")
    assert "over the wire" in sock.recv(4096).decode()
    logger.setup(console=False)
    sock.close()


def test_logger_levels_match_jax():
    from gmat_tpu.utils import logger as jlogger
    for k in ("TRACE", "DEBUG", "INFO", "WARN", "ERROR", "FATAL"):
        assert getattr(logger, k) == getattr(jlogger, k)
