"""The port's colour and LUT filters (filters/builtin part 2 and
filters/lut3d) against the JAX package's on the same seeded inputs, on
the CPU: the .cube/.3dl parsers, every 3D and 1D interpolator, and
colorchannelmixer, colorbalance, curves, exposure, colortemperature,
hue, monochrome, negate, swapuv, extractplanes, alphaextract, drawbox,
lut3d and lut1d through FilterGraph in positional and named form.

`run_pair` runs the JAX graph eagerly (each jnp op on its own, as the
JAX op functions run outside jit) and holds the port to it at 0 LSB for
integer outputs and rtol 1e-6 for float ones.  The JAX graph's jitted
form contracts f32 multiply-adds into FMAs on the CPU (XLA), so against
it the filters whose integer output comes from f32 math (colorbalance
pl=1, colortemperature, lut3d, lut1d, monochrome) are held to 1 LSB, the
bound the JAX package's own tests allow them (tests/test_enhance.py
colorbalance pl=1, tests/test_colorfilters.py colortemperature,
tests/test_lut3d.py)."""
import contextlib
from unittest import mock

import numpy as np
import pytest

import jax.numpy as jnp

from gmat_tpu.core.frame import FrameBatch as JFrameBatch
from gmat_tpu.filters import builtin as jbuiltin, graph as jgraph
from gmat_tpu.filters import lut3d as jlut3d
from gmat_tpu_torch.core import formats
from gmat_tpu_torch.core.frame import FrameBatch
from gmat_tpu_torch.filters import builtin, graph, lut3d

H, W = 48, 64


def yuv_frames(rng, n, h=H, w=W, bits=8):
    """Smooth moving content plus seeded noise, 4:2:0 (u16 at 10 bits)."""
    yy, xx = np.mgrid[0:h, 0:w]
    ys, us, vs = [], [], []
    for i in range(n):
        base = (yy * 2 + xx + 3 * i) % 200 + 20
        ys.append(np.clip(base + rng.integers(-6, 7, (h, w)), 0, 255))
        us.append(np.clip(base[::2, ::2] // 2 + 64 + i, 0, 255))
        vs.append(np.clip(200 - base[::2, ::2] // 2 - i, 0, 255))
    planes = {"y": np.stack(ys), "u": np.stack(us), "v": np.stack(vs)}
    if bits == 8:
        return {k: v.astype(np.uint8) for k, v in planes.items()}
    return {k: ((v.astype(np.uint16) << (bits - 8))
                | (v.astype(np.uint16) & ((1 << (bits - 8)) - 1)))
            for k, v in planes.items()}


def rgb_frames(rng, n, channels=3, bits=8, h=H, w=W):
    dt = np.uint8 if bits == 8 else np.uint16
    return {"rgb": rng.integers(0, 1 << bits, (n, h, w, channels))
            .astype(dt)}


def _dims(planes, fmt):
    p0 = formats.get(fmt).planes[0]
    arr = planes[p0.name]
    return arr.shape[2] << p0.sub_w, arr.shape[1] << p0.sub_h


def _pair(planes, fmt, colorspace="bt709"):
    w, h = _dims(planes, fmt)
    jfb = JFrameBatch({k: jnp.asarray(v) for k, v in planes.items()}, fmt,
                      w, h, colorspace)
    return jfb, FrameBatch.from_numpy(planes, fmt, w, h, colorspace,
                                      device="cpu")


def same_batch(got, want, lsb=0, rtol=1e-6, atol=1e-6):
    """Formats, sizes, tags and planes agree: integer planes within `lsb`,
    float planes within rtol/atol (plus `lsb` u8 codes)."""
    assert (got.format, got.width, got.height, got.colorspace) == (
        want.format, want.width, want.height, want.colorspace)
    assert sorted(got.planes) == sorted(want.planes)
    for k, wp in want.planes.items():
        a, b = got.planes[k], np.asarray(wp)
        assert a.device.type == "cpu"
        a = a.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, (k, a.shape,
                                                           b.shape)
        if not a.size:
            continue
        if b.dtype == np.float32:
            np.testing.assert_allclose(a, b, rtol=rtol,
                                       atol=atol + lsb / 255.0)
        else:
            d = np.abs(a.astype(np.int64) - b.astype(np.int64)).max()
            assert d <= lsb, (k, d)


def _same_meta(got, want):
    if want is None:
        assert got is None
        return
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def run_pair(spec, batches, lsb=0, fmt="yuv420p", eager=True,
             valid_last=None, stream_meta=None, colorspace="bt709",
             rtol=1e-6, atol=1e-6, src_fps=30.0, ilace=None):
    """The same batches (pts, times, keys per frame, and the interlace
    flags `ilace[pts]` where given) through both graphs, then flush:
    planes, keep masks, pts/times/keys (and the flushed interlace
    flags) and link state agree.  `eager` runs the JAX graph's pure
    segments op by op (no XLA fusion).  Returns the port's (batch, keep,
    pts) outputs."""
    def jit_pure(self, idx, fn):
        return fn
    ctx = (mock.patch.object(jgraph.FilterGraph, "_jit_pure", jit_pure)
           if eager else contextlib.nullcontext())
    with ctx:
        jg = jgraph.FilterGraph(spec, src_fps, stream_meta=stream_meta)
        g = graph.FilterGraph(spec, src_fps, stream_meta=stream_meta)
        assert g.link_state == jg.link_state
        assert g.fps_mul == jg.fps_mul
        assert [k for k, _ in g.segments] == [k for k, _ in jg.segments]
        outs, start = [], 0
        for i, planes in enumerate(batches):
            n = next(iter(planes.values())).shape[0]
            pts = np.arange(start, start + n, dtype=np.int64)
            start += n
            kw = dict(pts=pts, times=pts / src_fps,
                      keys=(pts % 5 == 0).astype(np.int64))
            if ilace is not None:
                kw["interlaced"] = np.asarray(ilace)[pts]
            if valid_last is not None and i == len(batches) - 1:
                kw["valid"] = valid_last
            jfb, fb = _pair(planes, fmt, colorspace)
            want, jkeep = jg.process(jfb, **kw)
            got, keep = g.process(fb, **kw)
            same_batch(got, want, lsb, rtol, atol)
            np.testing.assert_array_equal(keep, jkeep)
            _same_meta(g.out_pts, jg.out_pts)
            _same_meta(g.out_times, jg.out_times)
            _same_meta(g.out_keys, jg.out_keys)
            outs.append((got, keep, g.out_pts))
        jfl, fl = jg.flush(), g.flush()
        assert len(fl) == len(jfl)
        for (got, keep, meta), (want, jkeep, jmeta) in zip(fl, jfl):
            same_batch(got, want, lsb, rtol, atol)
            np.testing.assert_array_equal(keep, jkeep)
            for key in ("pts", "times", "keys", "interlaced"):
                _same_meta(meta.get(key), jmeta.get(key))
            outs.append((got, keep, meta.get("pts")))
        assert g.link_state == jg.link_state
    return outs


def three_batches(frames, size=4):
    """Three batches of `size` frames each from a 12-frame dict."""
    return [{k: v[i:i + size] for k, v in frames.items()}
            for i in range(0, 3 * size, size)]


# --------------------------------------------------------- lut3d files

_CUBE = """TITLE "seeded"
# a comment
DOMAIN_MIN 0 0 0
DOMAIN_MAX 1 1 1.25
LUT_3D_SIZE {s}
{rows}
"""


def cube_text(rng, s=5):
    rows = "\n".join(" ".join(f"{v:.6f}" for v in rng.random(3))
                     for _ in range(s ** 3))
    return _CUBE.format(s=s, rows=rows)


def cube1d_text(rng, s=17):
    rows = "\n".join(" ".join(f"{v:.6f}" for v in np.sort(rng.random(3)))
                     for _ in range(s))
    return f"LUT_1D_SIZE {s}\nLUT_1D_INPUT_RANGE 0.0 1.0\n{rows}\n"


def threedl_text(rng):
    ramp = " ".join(str(v) for v in range(0, 1024, 64))
    rows = "\n".join(" ".join(str(v) for v in rng.integers(0, 4096, 3))
                     for _ in range(17 ** 3))
    return f"{ramp}\n{rows}\n"


@pytest.fixture
def lut_files(tmp_path):
    rng = np.random.default_rng(11)
    paths = {}
    for name, text in (("grade.cube", cube_text(rng)),
                       ("curve.cube", cube1d_text(rng)),
                       ("look.3dl", threedl_text(rng))):
        p = tmp_path / name
        p.write_text(text)
        paths[name] = str(p)
    return paths


def test_parsers_match_jax(lut_files):
    for name, parse, jparse in (
            ("grade.cube", lut3d.load_lut_file, jlut3d.load_lut_file),
            ("look.3dl", lut3d.load_lut_file, jlut3d.load_lut_file),
            ("curve.cube", lut3d.load_lut1d_file, jlut3d.load_lut1d_file)):
        (lut, scale), (jl, js) = parse(lut_files[name]), jparse(
            lut_files[name])
        np.testing.assert_array_equal(lut, jl)
        np.testing.assert_array_equal(scale, js)
    for size in (2, 17, 32):
        np.testing.assert_array_equal(lut3d.identity_lut(size)[0],
                                      jlut3d.identity_lut(size)[0])
        np.testing.assert_array_equal(lut3d.identity_lut_1d(size)[0],
                                      jlut3d.identity_lut_1d(size)[0])


@pytest.mark.parametrize("text", [
    "LUT_3D_SIZE 2\n0 0 0\n1 1\n", "LUT_3D_SIZE 1\n", "TITLE x\n0 0 0\n",
    "LUT_3D_SIZE 2\n0 0 0\n", "LUT_1D_SIZE 4\n",
    "LUT_3D_SIZE 2\nDOMAIN_MIN 0 0\n"])
def test_parser_errors_match_jax(text):
    for fn in ("parse_cube", "parse_cube_1d"):
        with pytest.raises(ValueError) as want:
            getattr(jlut3d, fn)(text)
        with pytest.raises(ValueError) as got:
            getattr(lut3d, fn)(text)
        assert str(got.value) == str(want.value)


def _rgb_pair(rng, fmt, n=2):
    order = formats.get(fmt).channel_order
    planes = rgb_frames(rng, n, len(order), formats.get(fmt).bits)
    return _pair(planes, fmt)


@pytest.mark.parametrize("fmt", ["rgb24", "bgra", "rgb48"])
@pytest.mark.parametrize("mode", jlut3d.INTERP_MODES)
def test_apply_lut3d_matches_jax(rng, fmt, mode):
    """Every interpolator on a seeded 9^3 table, the op run eagerly in
    both packages: 0 LSB."""
    lut = rng.random((9, 9, 9, 3)).astype(np.float32)
    scale = np.array([1.0, 0.8, 1.0], np.float32)
    jfb, fb = _rgb_pair(rng, fmt)
    want = jlut3d.apply_lut3d(jfb, lut, scale, mode)
    same_batch(lut3d.apply_lut3d(fb, lut, scale, mode), want)


@pytest.mark.parametrize("fmt", ["rgb24", "rgb48"])
@pytest.mark.parametrize("mode", jlut3d.INTERP_1D_MODES)
def test_apply_lut1d_matches_jax(rng, fmt, mode):
    lut = np.sort(rng.random((33, 3)).astype(np.float32), axis=0)
    scale = np.array([1.0, 0.9, 0.8], np.float32)
    jfb, fb = _rgb_pair(rng, fmt)
    want = jlut3d.apply_lut1d(jfb, lut, scale, mode)
    same_batch(lut3d.apply_lut1d(fb, lut, scale, mode), want)


def test_lut_file_filters_match_jax(rng, lut_files):
    """lut3d/lut1d with files through the graph, positional and named."""
    rgb = rgb_frames(rng, 2)
    for spec in (f"lut3d={lut_files['grade.cube']}:trilinear",
                 f"lut3d=file={lut_files['look.3dl']}:interp=prism",
                 f"lut3d=file={lut_files['grade.cube']}",
                 f"lut1d={lut_files['curve.cube']}:cubic",
                 f"lut1d=file={lut_files['curve.cube']}:interp=spline"):
        run_pair(spec, [rgb], fmt="rgb24")
    run_pair(f"format=rgb24,lut3d={lut_files['grade.cube']},format=yuv420p",
             [yuv_frames(rng, 2)])


# ----------------------------------------------------- colour filters

_RGB = [
    "colorchannelmixer=0.5:0.3:0.2:0:0.1:0.8:0.1",
    "colorchannelmixer=rr=0.39:rg=0.77:rb=0.19:gr=0.35:gg=0.69:gb=0.17:"
    "br=0.27:bg=0.53:bb=0.13",
    "colorbalance=0.3:0:0:0:-0.2:0:0:0:0.4",
    "colorbalance=rs=0.3:gm=-0.2:bh=0.4:rm=0.1:pl=1",
    "curves=vintage", "curves=preset=strong_contrast",
    "curves=m=0/0 0.5/0.6 1/1:r=0/0.1 1/0.9",
    "curves=preset=cross_process:master=0/0.05 1/0.95",
    "curves=all=0/0.1 0.5/0.5 1/0.9",
    "colortemperature=4000:0.8:0.5", "colortemperature=temperature=9000",
    "lut3d", "lut3d=interp=pyramid", "lut1d", "lut1d=interp=cosine",
    "negate", "negate=components=r+b", "extractplanes=g",
    "drawbox=10:8:30:20:blue@0.7:2",
    "drawbox=x=4:y=4:w=20:h=10:color=invert:t=fill",
]


@pytest.mark.parametrize("spec", _RGB)
def test_rgb_filters_match_jax(rng, spec):
    run_pair(spec, [rgb_frames(rng, 2)], fmt="rgb24")


_RGB_JIT = [("colorbalance=rs=0.3:gm=-0.2:bh=0.4:rm=0.1:pl=1", 1),
            ("colortemperature=3000:0.7:1", 1), ("lut3d", 1),
            ("lut1d=interp=cubic", 1), ("curves=vintage", 0),
            ("colorchannelmixer=0.5:0.3:0.2", 0)]


@pytest.mark.parametrize("spec,lsb", _RGB_JIT, ids=[s for s, _ in _RGB_JIT])
def test_rgb_filters_match_jitted_jax(rng, spec, lsb):
    """Against the JAX graph as it runs (jitted): 1 LSB where XLA's FMA
    contraction of the f32 math may move a rounding edge."""
    run_pair(spec, [rgb_frames(rng, 2)], lsb, fmt="rgb24", eager=False)


_RGBA = ["alphaextract", "extractplanes=planes=a",
         "negate=components=r+g+b+a", "negate=negate_alpha=1",
         "drawbox=8:6:20:12:0x336699@0.5:t=3:replace=1",
         "colorchannelmixer=aa=0.5:ar=0.25",
         "colorbalance=gs=0.2:bm=-0.3", "curves=negative",
         "colortemperature=5000", "lut3d=interp=nearest"]


@pytest.mark.parametrize("spec", _RGBA)
def test_rgba_filters_match_jax(rng, spec):
    run_pair(spec, [rgb_frames(rng, 2, 4)], fmt="rgba")
    if spec.startswith(("negate", "colortemperature")):
        run_pair(spec, [rgb_frames(rng, 2, 4)], fmt="bgra")


_RGB48 = ["colorchannelmixer=rr=0.5:gg=1.2:bb=0.9", "curves=darker",
          "colorbalance=rh=0.5:gs=-0.5", "lut3d=interp=trilinear",
          "lut1d=interp=linear", "negate", "extractplanes=b"]


@pytest.mark.parametrize("spec", _RGB48)
def test_rgb48_filters_match_jax(rng, spec):
    run_pair(spec, [rgb_frames(rng, 2, bits=16)], fmt="rgb48")


_YUV = [
    "negate", "negate=components=y", "negate=u+v", "swapuv",
    "extractplanes=u", "extractplanes=planes=y",
    "monochrome", "monochrome=0.3:-0.2:2:0.3",
    "monochrome=cb=-0.5:cr=0.5:size=0.5:high=1",
    "drawbox=10:8:30:20:red@0.5:3", "drawbox=10:8:30:20:red:3",
    "drawbox=x=iw/4:y=ih/4:w=iw/2:h=ih/2:color=invert",
    "drawbox=x=-4:y=30:width=80:height=40:c=0x20C0E0@0.25:thickness=fill",
    "format=gbrpf32le,exposure=1:0.1",
    "format=gbrpf32le,exposure=exposure=-0.5",
    "format=rgb24,colorbalance=rs=0.2,format=yuv420p",
]


@pytest.mark.parametrize("spec", _YUV)
def test_yuv_filters_match_jax(rng, spec):
    run_pair(spec, [yuv_frames(rng, 2)])


_YUV_10BIT = ["negate", "negate=y", "swapuv", "extractplanes=v",
              "monochrome=0.2:0.1", "format=rgb48,curves=lighter",
              "format=rgb48,colorchannelmixer=0.9:0.1"]


@pytest.mark.parametrize("spec", _YUV_10BIT)
def test_yuv_10bit_filters_match_jax(rng, spec):
    run_pair(spec, [yuv_frames(rng, 2, bits=10)], fmt="yuv420p10")


def test_yuv444_and_gray_filters_match_jax(rng):
    planes = {k: rng.integers(0, 256, (2, H, W)).astype(np.uint8)
              for k in "yuv"}
    for spec in ("negate", "monochrome=0.5:0.5", "drawbox=4:4:9:9:red@0.4",
                 "extractplanes=v", "swapuv"):
        run_pair(spec, [planes], fmt="yuv444p")
    gray = {"y": planes["y"]}
    for spec in ("negate", "extractplanes=y", "drawbox=2:2:20:20:white"):
        run_pair(spec, [gray], fmt="gray8")


# ---------------------------------------------------------------- hue

_HUE = ["hue=30:1.2", "hue=h=30:s=1.2:b=0.5", "hue=H=PI/4*t:s=1.5",
        "hue=h=n*20:s=1+0.1*n:b=-1", "hue=s=0", "hue=b=2.5",
        r"select=not(mod(n\,3)),hue=h=n*15"]


@pytest.mark.parametrize("spec", _HUE)
def test_hue_matches_jax(rng, spec):
    """hue is a stream filter (its frame counter n): three batches, a
    dead tail of 1 frame and flush; keep masks, pts and the counter."""
    run_pair(spec, three_batches(yuv_frames(rng, 12)), valid_last=3)


def test_hue_10bit_and_counter_match_jax(rng):
    run_pair("hue=h=45:b=1:s=1.3", three_batches(yuv_frames(rng, 12,
                                                           bits=10)),
             fmt="yuv420p10", valid_last=2)
    jg = jgraph.FilterGraph("hue=h=n*5")
    g = graph.FilterGraph("hue=h=n*5")
    for b in three_batches(yuv_frames(rng, 12)):
        jfb, fb = _pair(b, "yuv420p")
        jg.process(jfb, valid=3)
        g.process(fb, valid=3)
    assert g.segments[0][1].n == jg.segments[0][1].n == 9


# ----------------------------------------------------------- errors

@pytest.mark.parametrize("spec,fmt", [
    ("colorbalance=rs=2", "rgb24"), ("colorbalance", "yuv420p"),
    ("colorchannelmixer=pc=lum", "rgb24"), ("colorchannelmixer=rr=3",
                                             "rgb24"),
    ("colorchannelmixer", "rgbpf32"), ("curves=preset=foo", "rgb24"),
    ("curves=m=0/0 0/1", "rgb24"), ("curves", "yuv420p"),
    ("exposure=5", "rgbpf32"), ("exposure", "rgb24"),
    ("colortemperature=100", "rgb24"), ("colortemperature", "rgb48"),
    ("monochrome=size=20", "yuv420p"), ("monochrome", "rgb24"),
    ("negate=components=q", "rgb24"), ("negate=components=y", "rgb24"),
    ("negate", "nv12"), ("swapuv", "gray8"),
    ("extractplanes=y+u", "yuv420p"), ("extractplanes=a", "yuv420p"),
    ("extractplanes=r", "rgbpf32"), ("alphaextract", "rgb24"),
    ("drawbox=color=nocolor", "yuv420p"), ("drawbox", "yuv420p10"),
    ("drawbox=w=-5", "yuv420p"),
    ("lut3d=interp=cubic", "rgb24"), ("lut3d", "yuv420p"),
    ("lut1d=interp=prism", "rgb24"), ("lut1d", "yuv420p"),
    ("lut3d=file=/nonexistent.cube", "rgb24"),
    ("lut3d=file=x.txt", "rgb24"),
    ("hue", "rgb24"), ("hue=h=1:H=2", "p010"),
])
def test_color_filter_errors_match_jax(rng, spec, fmt):
    """Options and formats each package refuses, with the same message."""
    f = formats.get(fmt)
    if f.is_rgb:
        dt = np.float32 if f.is_float else (np.uint8 if f.bits == 8
                                            else np.uint16)
        planes = {"rgb": (rng.random((1, 16, 24, len(f.channel_order)))
                          * (1 if f.is_float else 200)).astype(dt)}
    elif fmt == "gray8":
        planes = {"y": yuv_frames(rng, 1, 16, 24)["y"]}
    else:
        planes = yuv_frames(rng, 1, 16, 24, bits=f.bits)

    def run(gmod, pair):
        g = gmod.FilterGraph(spec)
        return g.process(pair, pts=np.arange(1), times=np.zeros(1))

    jfb, fb = _pair(planes, fmt)
    with pytest.raises((ValueError, TypeError, OSError)) as want:
        run(jgraph, jfb)
    with pytest.raises((ValueError, TypeError, OSError)) as got:
        run(graph, fb)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_tables_match_jax():
    assert builtin._CURVES_PRESETS == jbuiltin._CURVES_PRESETS
    assert builtin._COMP_BITS == jbuiltin._COMP_BITS
    assert builtin._NEGATE_FORMATS == jbuiltin._NEGATE_FORMATS
    for k in (1000.0, 1900.0, 4000.0, 6500.0, 6600.0, 12000.0, 40000.0):
        np.testing.assert_array_equal(builtin._kelvin2rgb(k),
                                      jbuiltin._kelvin2rgb(k))
    for rgb in ((0, 0, 0), (255, 0, 0), (12, 200, 99), (255, 255, 255)):
        assert builtin._rgb_to_yuv_ccir(*rgb) == \
            jbuiltin._rgb_to_yuv_ccir(*rgb)
    for pts in ("0/0 1/1", "0/0.11 0.42/0.51 1/0.95", "0.2/0.5",
                "0/0 0.3/0.5 0.6/0.2 1/1"):
        for depth in (8, 10, 16):
            p = builtin._curves_parse_points(pts, 1 << depth)
            assert p == jbuiltin._curves_parse_points(pts, 1 << depth)
            np.testing.assert_array_equal(
                builtin._curves_spline_graph(p, depth),
                jbuiltin._curves_spline_graph(p, depth))
