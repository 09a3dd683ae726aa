"""The port's JPEG still lane (ops/dct, av/jpeg_tpu, utils/png,
utils/hostpool) against the JAX package's, on the CPU.

Bounds: the DCT tiles, quantized coefficients and decoded planes equal
bit for bit (the port's 8-term sums run as XLA's CPU dot does: four
fused multiply-add chains); the JPEG bytes equal byte for byte for every
format, size and option; the decoded batches of either package's bytes
equal; the EXIF helpers, the MJPEG stream, PNG bytes and hostpool sizes
equal."""
import struct
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gmat_tpu.av import jpeg_tpu as jjpeg, toolkit as jtk
from gmat_tpu.core.frame import FrameBatch as JFrameBatch
from gmat_tpu.ops import dct as jdct
from gmat_tpu.utils import hostpool as jhostpool, png as jpng
from gmat_tpu_torch.av import jpeg_tpu, toolkit as tk
from gmat_tpu_torch.core import formats
from gmat_tpu_torch.core.frame import FrameBatch
from gmat_tpu_torch.ops import dct
from gmat_tpu_torch.utils import hostpool, png


def _planes(fmt, h, w, n=2, seed=0):
    """Smooth gradients plus seeded noise in every plane of `fmt`."""
    rng = np.random.default_rng(seed)
    f = formats.get(fmt)
    out = {}
    for i, p in enumerate(f.planes):
        ph, pw = f.plane_shape(p.name, h, w)[:2]
        base = np.add.outer(np.linspace(20, 220, ph), np.linspace(0, 30, pw))
        out[p.name] = np.clip(base[None] + 9 * i + rng.normal(0, 6, (n, ph, pw)),
                              0, 255).astype(np.uint8)
    return out


def _pair(fmt, h, w, n=2, seed=0):
    planes = _planes(fmt, h, w, n, seed)
    jfb = JFrameBatch({k: jnp.asarray(v) for k, v in planes.items()},
                      fmt, w, h)
    return jfb, FrameBatch.from_numpy(planes, fmt, w, h, device="cpu")


# ------------------------------------------------------------- ops/dct

@pytest.mark.parametrize("q", [1, 10, 49, 50, 75, 90, 100])
def test_quality_tables_match_jax(q):
    for a, b in zip(dct.quality_tables(q), jdct.quality_tables(q)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_tables_and_zigzag_match_jax():
    np.testing.assert_array_equal(dct.dct_matrix(), jdct.dct_matrix())
    np.testing.assert_array_equal(dct.ZIGZAG, jdct.ZIGZAG)
    np.testing.assert_array_equal(dct.ZIGZAG_INV, jdct.ZIGZAG_INV)
    z = np.random.default_rng(1).integers(-500, 500, (2, 3, 4, 8, 8)
                                          ).astype(np.int16)
    got = dct.to_zigzag(torch.as_tensor(z))
    want = np.asarray(jdct.to_zigzag(jnp.asarray(z)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(dct.from_zigzag(got).numpy(), z)


@pytest.mark.parametrize("shape", [(1, 8, 8), (2, 24, 40), (3, 64, 96)])
def test_dct_tiles_match_jax_bitwise(shape):
    """blockify, dct8x8, idct8x8, unblockify: bit-equal f32 (XLA's dot:
    four FMA chains j mod 4, summed (a0 + a1) + (a2 + a3))."""
    rng = np.random.default_rng(2)
    x = rng.integers(0, 256, shape).astype(np.float32) - 128.0
    jb = jdct.blockify(jnp.asarray(x))
    b = dct.blockify(torch.as_tensor(x))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    got, want = dct.dct8x8(b), np.asarray(jdct.dct8x8(jb))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    c = rng.normal(0, 60, np.asarray(jb).shape).astype(np.float32)
    np.testing.assert_array_equal(
        dct.idct8x8(torch.as_tensor(c)).numpy(),
        np.asarray(jdct.idct8x8(jnp.asarray(c))))
    np.testing.assert_array_equal(dct.unblockify(b).numpy(), x)


@pytest.mark.parametrize("q", [50, 95])
def test_encode_decode_plane_match_jax(q):
    x = _planes("gray8", 40, 56, 3, seed=4)["y"]
    qy, _ = jdct.quality_tables(q)
    want = np.asarray(jdct.encode_plane(jnp.asarray(x), qy))
    got = dct.encode_plane(torch.as_tensor(x), qy)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        dct.decode_plane(got, qy).numpy(),
        np.asarray(jdct.decode_plane(jnp.asarray(want), qy)))


def test_fma_rounds_once():
    """dct.fma is a*b + c with one rounding: (1 + 2^-12)^2 - 1 keeps the
    2^-24 term that an f32 product, rounded before the add, loses."""
    a = torch.tensor([1.0 + 2.0 ** -12])
    got = dct.fma(a, float(a[0]), torch.tensor([-1.0]))
    assert got.dtype == torch.float32
    assert float(got[0]) == 2.0 ** -11 + 2.0 ** -24
    assert float(a * a - 1.0) == 2.0 ** -11


# ------------------------------------------------------------ encode

_SIZES = {   # format: sizes (h, w): odd, MCU-boundary (1 mod 16), plain
    "yuv420p": [(33, 47), (17, 33), (64, 96)],
    "nv12": [(32, 48)],
    "yuv422p": [(40, 50), (9, 18)],
    "yuv444p": [(24, 30)],
    "gray8": [(17, 23)],
}
_OPTS = {
    "baseline": {},
    "expand_range": {"expand_range": True},
    "optimize": {"optimize": True},
    "progressive": {"progressive": True},
    "restart": {"restart_mcus": 3},
    "all": {"progressive": True, "restart_mcus": 2, "expand_range": True},
}
_CASES = [(f, s) for f, sizes in _SIZES.items() for s in sizes]


@pytest.mark.parametrize("opt", sorted(_OPTS))
@pytest.mark.parametrize("fmt,size", _CASES,
                         ids=[f"{f}-{h}x{w}" for f, (h, w) in _CASES])
def test_encode_batch_bytes_match_jax(fmt, size, opt):
    jfb, fb = _pair(fmt, *size)
    kw = _OPTS[opt]
    got = jpeg_tpu.encode_batch(fb, 85, **kw)
    want = jjpeg.encode_batch(jfb, 85, **kw)
    assert len(got) == fb.batch and got == want


@pytest.mark.parametrize("q", [5, 30, 100])
def test_encode_quality_ladder_matches_jax(q):
    jfb, fb = _pair("yuv420p", 48, 64, n=1, seed=5)
    assert jpeg_tpu.encode_batch(fb, q) == jjpeg.encode_batch(jfb, q)


def test_encode_workers_and_errors_match_jax():
    jfb, fb = _pair("yuv420p", 32, 48, n=5, seed=6)
    serial = jpeg_tpu.encode_batch(fb, 80, workers=1)
    assert serial == jpeg_tpu.encode_batch(fb, 80, workers=3) == \
        jjpeg.encode_batch(jfb, 80, workers=2)
    with pytest.raises(ValueError, match="restart_mcus"):
        jpeg_tpu.encode_batch(fb, restart_mcus=70000)
    rgb = FrameBatch.from_numpy({"rgb": np.zeros((1, 8, 8, 3), np.uint8)},
                                "rgb24", 8, 8, device="cpu")
    with pytest.raises(ValueError, match="encode_batch expects"):
        jpeg_tpu.encode_batch(rgb)


# ------------------------------------------------------------ decode

@pytest.mark.parametrize("segment_threads", [0, 3])
@pytest.mark.parametrize("fmt,size", [("yuv420p", (33, 47)),
                                      ("yuv422p", (40, 50)),
                                      ("yuv444p", (24, 30)),
                                      ("gray8", (17, 23))],
                         ids=["yuv420p", "yuv422p", "yuv444p", "gray8"])
def test_decode_batch_matches_jax(fmt, size, segment_threads):
    """Either package's bytes (with restart intervals, so the segment
    decode has segments) decode to equal batches."""
    jfb, fb = _pair(fmt, *size, n=3, seed=7)
    datas = jpeg_tpu.encode_batch(fb, 90, restart_mcus=1)
    jdatas = jjpeg.encode_batch(jfb, 90, restart_mcus=1,
                                progressive=True)
    for d in (datas, jdatas):
        got = jpeg_tpu.decode_batch(d, segment_threads=segment_threads,
                                    device="cpu")
        want = jjpeg.decode_batch(d, segment_threads=segment_threads)
        assert (got.format, got.width, got.height, got.colorspace) == (
            want.format, want.width, want.height, want.colorspace)
        assert sorted(got.planes) == sorted(want.planes)
        for k, p in want.planes.items():
            assert got.planes[k].device.type == "cpu"
            np.testing.assert_array_equal(got.planes[k].numpy(),
                                          np.asarray(p))


def test_decode_mixed_quality_batch_matches_jax():
    jfb, fb = _pair("yuv420p", 32, 48, n=3, seed=8)
    datas = [jpeg_tpu.encode_batch(FrameBatch(
        {k: v[i:i + 1] for k, v in fb.planes.items()}, "yuv420p", 48, 32),
        q)[0] for i, q in enumerate((20, 60, 97))]
    got = jpeg_tpu.decode_batch(datas, colorspace="bt709", device="cpu")
    want = jjpeg.decode_batch(datas, colorspace="bt709")
    for k, p in want.planes.items():
        np.testing.assert_array_equal(got.planes[k].numpy(), np.asarray(p))
    with pytest.raises(ValueError, match="mixed"):
        jpeg_tpu.decode_batch([datas[0], jpeg_tpu.encode_batch(
            _pair("yuv444p", 32, 48, 1)[1])[0]], device="cpu")


def test_decode_round_trip_error():
    """Round trip of the JAX tests' smooth content within their mean bound
    (< 3 LSB at q=90, tests/test_jpeg_tpu.py test_jpeg_self_roundtrip)."""
    from gmat_tpu_torch.core.frame import from_numpy_yuv420
    from tests.test_jpeg_tpu import smooth_yuv
    fb = from_numpy_yuv420(*smooth_yuv(np.random.default_rng(9)),
                           device="cpu")
    out = jpeg_tpu.decode_batch(jpeg_tpu.encode_batch(fb, 90), device="cpu")
    for k in "yuv":
        d = (out.planes[k].to(torch.int32) - fb.planes[k].to(torch.int32))
        assert float(d.abs().float().mean()) < 3.0


def test_decode_needs_the_card_by_default():
    _, fb = _pair("gray8", 16, 16, n=1)
    datas = jpeg_tpu.encode_batch(fb)
    if torch.cuda.is_available():
        assert jpeg_tpu.decode_batch(datas).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            jpeg_tpu.decode_batch(datas)


# ------------------------------------------------------ EXIF, MJPEG

_EXIF = b"II*\x00\x08\x00\x00\x00" + b"\x00\x00" + b"\x00\x00\x00\x00"


def test_exif_helpers_match_jax():
    _, fb = _pair("yuv420p", 16, 16, n=1)
    plain = jpeg_tpu.encode_batch(fb, 90)[0]
    tagged = jpeg_tpu.insert_exif(plain, _EXIF)
    assert tagged == jjpeg.insert_exif(plain, _EXIF)
    assert jpeg_tpu.exif_from_jpeg(tagged) == \
        jjpeg.exif_from_jpeg(tagged) == _EXIF
    assert jpeg_tpu.exif_from_jpeg(plain) is None
    # an APP0 longer than the bare JFIF 16 bytes
    long_app0 = plain[:4] + struct.pack(">H", 30) + plain[6:20] + \
        bytes(14) + plain[20:]
    assert jpeg_tpu.insert_exif(long_app0, _EXIF) == \
        jjpeg.insert_exif(long_app0, _EXIF)
    with pytest.raises(ValueError, match="64KB"):
        jpeg_tpu.insert_exif(plain, b"x" * 70000)


def _mjpeg_clip(path, n=7, h=48, w=64):
    _, fb = _pair("yuv420p", h, w, n=n, seed=10)
    mux = tk.Muxer(path, w, h, (30, 1), **tk.mux_kwargs_for_encoder("mjpeg"))
    for i, d in enumerate(jpeg_tpu.encode_batch(fb, 88)):
        mux.write(tk.Packet(d, i, i, True, False, 0))
    mux.close()


def test_mjpeg_stream_matches_jax(tmp_path):
    """decode_stream_tpu over an MJPEG track: batches, pts, valid counts
    and the ingest metadata equal the JAX stream's; a drained stream
    ends cleanly."""
    path = str(tmp_path / "in.mov")
    _mjpeg_clip(path)
    st = jpeg_tpu.decode_stream_tpu(path, batch=3, device="cpu")
    jst = jjpeg.decode_stream_tpu(path, batch=3)
    assert (st.width, st.height, st.fps) == (jst.width, jst.height, jst.fps)
    got, want = list(st), list(jst)
    assert len(got) == len(want) == 3
    for (b, pts, valid), (jb, jpts, jvalid) in zip(got, want):
        assert valid == jvalid and b.batch == 3
        np.testing.assert_array_equal(pts, jpts)
        for k, p in jb.planes.items():
            np.testing.assert_array_equal(b.planes[k].numpy(),
                                          np.asarray(p))
    np.testing.assert_array_equal(st.last_keys, jst.last_keys)
    assert list(st) == []
    other = jpeg_tpu.MjpegTpuStream(path, batch=4, device="cpu")
    other.close()
    assert list(other) == []


def test_mjpeg_stream_refuses_other_codecs(tmp_path):
    path = str(tmp_path / "h264.mp4")
    y = np.full((3, 48, 64), 90, np.uint8)
    c = np.full((3, 24, 32), 128, np.uint8)
    enc = tk.Encoder("libx264", 64, 48, fps=(30, 1), crf=30.0,
                     preset="ultrafast")
    mux = tk.Muxer(path, 64, 48, (30, 1), tk.CODEC_H264, enc.extradata())
    for i in range(3):
        for p in enc.encode(y[i], c[i], c[i], pts=i):
            mux.write(p)
    for p in enc.flush():
        mux.write(p)
    enc.close()
    mux.close()
    with pytest.raises(ValueError, match="MJPEG"):
        jpeg_tpu.decode_stream_tpu(path, device="cpu")
    assert jtk.codec_id("mjpeg") == tk.codec_id("mjpeg")


# -------------------------------------------------------- PNG, hostpool

@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("chans", [0, 1, 2, 3, 4])
def test_png_write_read_match_jax(tmp_path, dtype, chans):
    rng = np.random.default_rng(chans)
    shape = (9, 13) if chans == 0 else (9, 13, chans)
    a = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    p, jp = tmp_path / "port.png", tmp_path / "jax.png"
    png.write_png(str(p), a)
    jpng.write_png(str(jp), a)
    assert p.read_bytes() == jp.read_bytes()
    got = png.read_png(str(p))
    want = a[..., 0] if chans == 1 else a
    np.testing.assert_array_equal(got, want)
    assert got.dtype == dtype


def test_png_reader_filters_match_jax():
    """Rows with every filter type (None, Sub, Up, Average, Paeth) over
    seeded bytes decode alike in both packages."""
    rng = np.random.default_rng(12)
    h, w, c = 11, 7, 3
    raw = b"".join(bytes([y % 5]) + rng.integers(0, 256, w * c).astype(
        np.uint8).tobytes() for y in range(h))

    def chunk(t, p):
        return (struct.pack(">I", len(p)) + t + p
                + struct.pack(">I", zlib.crc32(t + p) & 0xFFFFFFFF))
    blob = (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    np.testing.assert_array_equal(png.read_png(blob), jpng.read_png(blob))
    for bad in (blob[:20], b"nope" + blob[4:]):
        with pytest.raises(IOError):
            png.read_png(bad)


@pytest.mark.parametrize("workers,items", [(0, 5), (1, 9), (3, 2), (8, 100)])
def test_hostpool_matches_jax(workers, items):
    assert hostpool.n_workers(workers, items) == \
        jhostpool.n_workers(workers, items)
