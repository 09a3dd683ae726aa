"""The port's filter ops against the JAX package on the same inputs, on the
CPU: LUTs, the rest of csc (convert and friends), rotate with its three
samplers (and area), pad, the median, eq / lut tables / unsharp, and the
yadif and bwdif deinterlacers.

Bounds: 0 LSB where the JAX op is integer; <= 1 LSB for f32 resamplers
and conversions; atol 1e-6 for float outputs."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gmat_tpu.core.frame import FrameBatch as JFrameBatch
from gmat_tpu.ops import bwdif as jbwdif, csc as jcsc, enhance as jenhance
from gmat_tpu.ops import geometry as jgeom, lut as jlut, smooth as jsmooth
from gmat_tpu.ops import yadif as jyadif
from gmat_tpu_torch.core import formats
from gmat_tpu_torch.core.frame import FrameBatch
from gmat_tpu_torch.ops import bwdif, csc, enhance, geometry, lut
from gmat_tpu_torch.ops import smooth, yadif

YUV = ["yuv420p", "nv12", "p010", "p016", "yuv420p10", "yuv420p16",
       "yuv422p", "yuv444p", "yuv444p10", "yuv444p16", "gray8", "gray10",
       "gray16"]
RGB = ["rgb24", "bgr24", "rgba", "bgra", "rgba64", "bgra64", "rgb48",
       "bgr48", "rgbpf32", "rgbapf32", "bgrpf32"]


def _planes(rng, fmt, n=2, h=16, w=24):
    f = formats.get(fmt)
    out = {}
    for p in f.planes:
        shape = (n,) + f.plane_shape(p.name, h, w)
        if f.is_float:
            out[p.name] = rng.uniform(0, 1, shape).astype(np.float32)
        elif fmt in ("p010",):
            out[p.name] = (rng.integers(0, 1024, shape) << 6).astype(
                np.uint16)
        else:
            dt = np.dtype(p.dtype)
            hi = (1 << f.bits) if dt == np.uint16 else 256
            out[p.name] = rng.integers(0, hi, shape).astype(dt)
    return out


def _pair(planes, fmt, w, h, cs="bt709"):
    """The same numpy planes as a JAX batch and a CPU port batch."""
    jfb = JFrameBatch({k: jnp.asarray(v) for k, v in planes.items()}, fmt, w,
                      h, cs)
    return jfb, FrameBatch.from_numpy(planes, fmt, w, h, cs, device="cpu")


def _batch(rng, fmt, n=2, h=16, w=24):
    return _pair(_planes(rng, fmt, n, h, w), fmt, w, h)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, lsb=0):
    """Planes of two batches: same names, shapes, dtypes; integer planes
    within `lsb`, float planes within 1e-6."""
    assert (got.format, got.width, got.height) == (want.format, want.width,
                                                   want.height)
    assert sorted(got.planes) == sorted(want.planes)
    for k, w in want.planes.items():
        a, b = _np(got.planes[k]), np.asarray(w)
        assert a.shape == b.shape and a.dtype == b.dtype, (k, a.shape,
                                                           b.shape)
        if b.dtype == np.float32:
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
        else:
            d = np.abs(a.astype(np.int64) - b.astype(np.int64)).max()
            assert d <= lsb, (k, d)


# ---------------------------------------------------------------- lut

@pytest.mark.parametrize("dt,size", [(np.uint8, 256), (np.uint16, 1024),
                                     (np.uint16, 65536)])
def test_apply_lut_matches_jax(rng, dt, size):
    tab = rng.integers(0, np.iinfo(dt).max, size).astype(dt)
    x = rng.integers(0, size, (2, 9, 13)).astype(dt)
    want = np.asarray(jlut.apply_lut(jnp.asarray(x), tab))
    got = lut.apply_lut(torch.from_numpy(x), tab).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- csc

@pytest.mark.parametrize("sub", [(1, 1), (0, 1), (1, 0)])
@pytest.mark.parametrize("exact", [False, True])
def test_chroma_box_matches_jax(rng, sub, exact):
    c = rng.uniform(0, 255, (2, 8, 12)).astype(np.float32)
    want = np.asarray(jcsc._chroma_box(jnp.asarray(c), *sub, exact))
    got = csc._chroma_box(torch.from_numpy(c), *sub, exact).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


_CONVERT = ([(i, o) for i in YUV for o in ("rgb24", "rgba64", "rgbpf32",
                                             "bgrpf32")]
            + [(i, o) for i in RGB for o in ("yuv420p", "p010", "yuv444p16",
                                             "yuv422p", "gray8")]
            + [(i, o) for i in ("yuv420p", "p010", "yuv444p10", "gray8",
                                "yuv422p")
               for o in ("yuv420p", "yuv420p10", "p010", "yuv444p",
                         "yuv422p", "gray16", "yuv444p16") if i != o]
            + [(i, o) for i in ("rgb24", "rgba64", "rgbpf32", "bgra")
               for o in ("bgr24", "rgb48", "rgbapf32", "bgrpf32") if i != o])


@pytest.mark.parametrize("src,dst", _CONVERT,
                         ids=[f"{s}-{d}" for s, d in _CONVERT])
def test_convert_matches_jax(rng, src, dst):
    jfb, fb = _batch(rng, src)
    for exact in (False, True):
        kw = {} if not (formats.get(src).is_rgb or formats.get(dst).is_rgb) \
            else {"exact": exact}
        _close(csc.convert(fb, dst, **kw), jcsc.convert(jfb, dst, **kw), 1)


@pytest.mark.parametrize("src", ["yuv420p", "yuv420p10", "rgb24", "rgbpf32"])
def test_convert_norm_shift_matches_jax(rng, src):
    jfb, fb = _batch(rng, src)
    for dst in ("rgbpf32", "bgrpf32"):
        kw = {"norm": 1.0, "shift": (0.5, 0.25, 0.0)}
        _close(csc.convert(fb, dst, **kw), jcsc.convert(jfb, dst, **kw))
    assert csc.convert(fb, src) is fb


def test_from_nchw_matches_jax(rng):
    x = rng.uniform(0, 1, (2, 3, 8, 12)).astype(np.float32)
    want = jcsc.from_nchw(jnp.asarray(x), "rgbpf32")
    got = csc.from_nchw(torch.from_numpy(x), "rgbpf32")
    _close(got, want)
    np.testing.assert_array_equal(csc.to_nchw(got).numpy(), x)


# ------------------------------------------------------------ rotate

_ROT_FMTS = ["yuv420p", "yuv422p", "yuv444p", "p010", "yuv420p10", "gray8",
             "rgb24", "rgba64", "rgbpf32"]


@pytest.mark.parametrize("interp", ["linear", "cubic", "nearest", "area"])
@pytest.mark.parametrize("fmt", _ROT_FMTS)
def test_rotate_matches_jax(rng, fmt, interp):
    jfb, fb = _batch(rng, fmt)
    for args, kw in (((17.0, interp, 2.5, -1.0), {}),
                     ((-90.0, interp), {"center": True}),
                     ((33.3, interp), {"center": True})):
        _close(geometry.rotate(fb, *args, **kw),
               jgeom.rotate(jfb, *args, **kw), 1)


def test_rotate_rejects_unknown_interp(rng):
    _, fb = _batch(rng, "yuv420p")
    with pytest.raises(ValueError, match="interp"):
        geometry.rotate(fb, 10.0, "lanczos")


# --------------------------------------------------------------- pad

_PAD_FMTS = ["yuv420p", "yuv422p", "yuv444p", "p010", "yuv420p10",
             "yuv444p16", "gray8", "rgb24", "bgra", "rgba64", "rgbpf32"]


@pytest.mark.parametrize("color", ["black", "white", "#3a7", "0xFF8000",
                                   "20C0E0", "navy@0.5", "#11223344"])
@pytest.mark.parametrize("fmt", _PAD_FMTS)
def test_pad_matches_jax(rng, fmt, color):
    jfb, fb = _batch(rng, fmt)
    for args in ((40, 30, 4, 6), (33, 21, -1, -1), (24, 16, 0, 0)):
        _close(geometry.pad(fb, *args, color), jgeom.pad(jfb, *args, color))


def test_pad_and_color_errors_match_jax(rng):
    jfb, fb = _batch(rng, "yuv420p")
    for args in ((8, 8, 0, 0, "black"), (40, 40, 0, 0, "nocolor")):
        with pytest.raises(ValueError) as want:
            jgeom.pad(jfb, *args)
        with pytest.raises(ValueError) as got:
            geometry.pad(fb, *args)
        assert str(got.value) == str(want.value)
    for s in ("red@0.25", "#abcd", "0x10203040", "pink@200"):
        assert geometry.parse_color_rgba(s) == jgeom.parse_color_rgba(s)


# ------------------------------------------------------------ median

@pytest.mark.parametrize("fmt", ["yuv420p", "yuv444p", "yuv420p10", "p010",
                                 "yuv444p16", "rgb24"])
@pytest.mark.parametrize("k", [(3, 3), (5, 5), (3, 7), (1, 5)])
def test_median_smooth_matches_jax(rng, fmt, k):
    jfb, fb = _batch(rng, fmt)
    _close(smooth.smooth(fb, "median", *k), jsmooth.smooth(jfb, "median", *k))


@pytest.mark.parametrize("dt", [np.uint8, np.float32])
def test_median_blur_plane_even_and_float(rng, dt):
    """Even windows (the mean of the two middle values) and float planes
    take the sorting path, as the JAX op does for every window."""
    x = (rng.uniform(0, 255, (2, 9, 11))).astype(dt)
    for kw, kh in ((2, 2), (3, 3), (4, 1)):
        want = np.asarray(jsmooth.median_blur_plane(jnp.asarray(x), kw, kh))
        got = smooth.median_blur_plane(torch.from_numpy(x), kw, kh).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# ------------------------------------------------------ eq / lut / unsharp

@pytest.mark.parametrize("fmt", ["yuv420p", "yuv422p", "yuv444p", "nv12",
                                 "gray8"])
def test_eq_matches_jax(rng, fmt):
    jfb, fb = _batch(rng, fmt)
    for args in ((1.2, 0.05), (0.5, -0.2, 2.0, 0.8), (1.0, 0.0, 1.0, 1.0,
                                                      1.5, 0.7, 2.2, 0.5)):
        _close(enhance.eq(fb, *args), jenhance.eq(jfb, *args))
    j10, p10 = _batch(rng, "yuv420p10")
    with pytest.raises(ValueError, match="8-bit"):
        enhance.eq(p10, 1.2)


@pytest.mark.parametrize("fmt", ["rgb24", "rgba64", "yuv420p", "yuv420p10"])
def test_apply_luts_matches_jax(rng, fmt):
    jfb, fb = _batch(rng, fmt)
    f = formats.get(fmt)
    dt = np.dtype(f.planes[0].dtype)
    size = 1 << (dt.itemsize * 8)
    if f.is_rgb:
        tabs = rng.integers(0, size, (len(f.channel_order), size)).astype(dt)
        tabs[1] = np.arange(size)          # an identity channel is skipped
        luts = {"rgb": tabs}
    else:
        luts = {"y": rng.integers(0, 1 << f.bits, size).astype(dt),
                "v": np.arange(size, dtype=dt)}
    _close(enhance.apply_luts(fb, luts), jenhance.apply_luts(jfb, luts))


def test_binomial_taps_match_the_jax_band(rng):
    for steps in range(1, 12):
        band = jenhance._binomial_band(40, steps)
        row = enhance._binomial_taps(steps)
        np.testing.assert_array_equal(band[20, 20 - steps:21 + steps], row)
        assert row.sum() == 1 << (2 * steps)


@pytest.mark.parametrize("fmt", ["yuv420p", "yuv444p", "yuv420p10",
                                 "yuv444p16", "gray8", "gray16"])
@pytest.mark.parametrize("args", [(5, 5, 0.8), (3, 3, 1.5, 7, 5, -0.6),
                                  (13, 13, 5.0, 11, 13, -2.0),
                                  (23, 3, -1.3, 3, 23, 2.5)],
                         ids=["5x5", "3x3-7x5", "13x13-wrap", "23x3"])
def test_unsharp_matches_jax(rng, fmt, args):
    """13x13 on 16-bit planes sums past 2^32: the JAX op's int32
    wrap-around, reproduced in int64."""
    jfb, fb = _batch(rng, fmt, h=30, w=40)
    _close(enhance.unsharp(fb, *args), jenhance.unsharp(jfb, *args))


def test_unsharp_errors_match_jax(rng):
    jfb, fb = _batch(rng, "yuv420p")
    for args in ((25, 5, 1.0), (13, 15, 1.0)):
        with pytest.raises(ValueError) as want:
            jenhance.unsharp(jfb, *args)
        with pytest.raises(ValueError) as got:
            enhance.unsharp(fb, *args)
        assert str(got.value) == str(want.value)
    _, rgb = _batch(rng, "rgb24")
    with pytest.raises(ValueError, match="planar YUV"):
        enhance.unsharp(rgb)


# ------------------------------------------------------- yadif / bwdif

def _seq(rng, m, h, w, dt=np.uint8):
    hi = 1024 if dt == np.uint16 else 256
    return rng.integers(0, hi, (m, h, w)).astype(dt)


@pytest.mark.parametrize("dt", [np.uint8, np.uint16])
@pytest.mark.parametrize("parity,tff", [(0, 1), (1, 1), (0, 0), (1, 0)])
@pytest.mark.parametrize("skip", [False, True])
def test_yadif_plane_matches_jax(rng, dt, parity, tff, skip):
    p, c, n = (_seq(rng, 2, 12, 17, dt) for _ in range(3))
    want = np.asarray(jyadif.yadif_plane(jnp.asarray(p), jnp.asarray(c),
                                         jnp.asarray(n), parity, tff, skip))
    got = yadif.yadif_plane(*(torch.from_numpy(a) for a in (p, c, n)),
                            parity, tff, skip).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("send_field", [False, True])
@pytest.mark.parametrize("tff", [0, 1])
def test_deint_batch_matches_jax(rng, send_field, tff):
    ext = {"y": _seq(rng, 5, 16, 20), "u": _seq(rng, 5, 8, 10),
           "rgb": rng.integers(0, 256, (5, 6, 7, 3)).astype(np.uint8)}
    want = jyadif.deint_batch({k: jnp.asarray(v) for k, v in ext.items()},
                              tff, False, send_field)
    got = yadif.deint_batch({k: torch.from_numpy(v) for k, v in ext.items()},
                            tff, False, send_field)
    for k in ext:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("dt", [np.uint8, np.uint16])
@pytest.mark.parametrize("h", [4, 6, 13])
@pytest.mark.parametrize("parity,tff", [(0, 1), (1, 1)])
def test_bwdif_plane_matches_jax(rng, dt, h, parity, tff):
    """Every row class (edge, spatial check, line) and the byte-based
    mirror guards of 16-bit planes, at the smallest legal heights."""
    p, c, n = (_seq(rng, 2, h, 7, dt) for _ in range(3))
    want = np.asarray(jbwdif.bwdif_plane(jnp.asarray(p), jnp.asarray(c),
                                         jnp.asarray(n), parity, tff))
    got = bwdif.bwdif_plane(*(torch.from_numpy(a) for a in (p, c, n)),
                            parity, tff).numpy()
    np.testing.assert_array_equal(got, want)
    want_i = np.asarray(jbwdif.bwdif_intra_plane(jnp.asarray(c), parity))
    got_i = bwdif.bwdif_intra_plane(torch.from_numpy(c), parity).numpy()
    np.testing.assert_array_equal(got_i, want_i)


@pytest.mark.parametrize("send_field", [False, True])
@pytest.mark.parametrize("intra", [(-1, -1), (0, -1), (2, -1), (-1, 0),
                                   (1, 2)])
def test_bwdif_batch_matches_jax(rng, send_field, intra):
    ext = {"y": _seq(rng, 5, 12, 14), "v": _seq(rng, 5, 6, 7, np.uint16),
           "rgb": rng.integers(0, 256, (5, 8, 5, 3)).astype(np.uint8)}
    want = jbwdif.bwdif_batch({k: jnp.asarray(v) for k, v in ext.items()},
                              1, send_field, intra_first=intra[0],
                              intra_last=intra[1])
    got = bwdif.bwdif_batch({k: torch.from_numpy(v) for k, v in ext.items()},
                            1, send_field, intra_first=intra[0],
                            intra_last=intra[1])
    for k in ext:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
