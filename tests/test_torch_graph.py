"""The port's filter graph (filters/graph, filters/builtin part 1,
filters/expr) against the JAX package's on the same inputs, on the CPU:
the parser, every ported filter through FilterGraph with its options in
positional and named form, multi-batch sequences of the stream and
keep-mask filters with flush, and every filter name building.

Bounds: 0 LSB for integer filters and for keep masks, pts and fps_mul;
<= 1 LSB for the f32 resamplers and conversions (scale, rotate, gaussian
smooth, format, chromakey); atol 1e-6 for float outputs (plus the 1 LSB
an upstream resampler may leave, for chains ending in float RGB)."""
import math

import numpy as np
import pytest

import jax.numpy as jnp

from gmat_tpu.core.frame import FrameBatch as JFrameBatch
from gmat_tpu.filters import builtin as jbuiltin, expr as jexpr
from gmat_tpu.filters import graph as jgraph
from gmat_tpu_torch.core import formats
from gmat_tpu_torch.core.frame import FrameBatch
from gmat_tpu_torch.filters import builtin, expr, graph

H, W = 64, 128


def _yuv_frames(rng, n, h=H, w=W, cut=None):
    """Smooth moving content plus noise; a scene cut at frame `cut`."""
    yy, xx = np.mgrid[0:h, 0:w]
    ys, us, vs = [], [], []
    for i in range(n):
        base = (yy * 2 + xx + 3 * i) % 200 + 20
        if cut is not None and i >= cut:
            base = 235 - base // 2
        y = np.clip(base + rng.integers(-6, 7, (h, w)), 0, 255)
        ys.append(y.astype(np.uint8))
        us.append(np.clip(base[::2, ::2] // 2 + 64 + i, 0, 255)
                  .astype(np.uint8))
        vs.append(np.clip(200 - base[::2, ::2] // 2 - i, 0, 255)
                  .astype(np.uint8))
    return {"y": np.stack(ys), "u": np.stack(us), "v": np.stack(vs)}


def _pair(planes, fmt="yuv420p", w=W, h=H):
    jfb = JFrameBatch({k: jnp.asarray(v) for k, v in planes.items()}, fmt, w,
                      h, "bt709")
    return jfb, FrameBatch.from_numpy(planes, fmt, w, h, device="cpu")


def _same_batch(got, want, lsb):
    assert (got.format, got.width, got.height) == (want.format, want.width,
                                                   want.height)
    assert sorted(got.planes) == sorted(want.planes)
    for k, wp in want.planes.items():
        a, b = got.planes[k], np.asarray(wp)
        assert a.device.type == "cpu"
        a = a.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, (k, a.shape,
                                                           b.shape)
        if b.dtype == np.float32:
            np.testing.assert_allclose(a, b, atol=1e-6 + lsb / 255.0, rtol=0)
        else:
            d = np.abs(a.astype(np.int64) - b.astype(np.int64)).max() \
                if a.size else 0
            assert d <= lsb, (k, d)


def _same_meta(got, want):
    if want is None:
        assert got is None
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    else:
        np.testing.assert_array_equal(got, want)


def run_both(spec, batches, lsb=0, src_fps=30.0, valid_last=None,
             ilace=None, fmt="yuv420p"):
    """Feed the same batches through both graphs (pts, times, keys and
    interlace flags per frame), then flush both; every output batch, keep
    mask and metadata track must agree.  Returns the port's outputs."""
    jg = jgraph.FilterGraph(spec, src_fps)
    g = graph.FilterGraph(spec, src_fps)
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
            kw["interlaced"] = ilace[pts]
        if valid_last is not None and i == len(batches) - 1:
            kw["valid"] = valid_last
        p0 = formats.get(fmt).planes[0]
        h, w = (s << k for s, k in zip(planes[p0.name].shape[1:3],
                                       (p0.sub_h, p0.sub_w)))
        jfb, fb = _pair(planes, fmt, w, h)
        want, jkeep = jg.process(jfb, **kw)
        got, keep = g.process(fb, **kw)
        _same_batch(got, want, lsb)
        np.testing.assert_array_equal(keep, jkeep)
        _same_meta(g.out_pts, jg.out_pts)
        _same_meta(g.out_times, jg.out_times)
        _same_meta(g.out_keys, jg.out_keys)
        outs.append((got, keep))
    jfl, fl = jg.flush(), g.flush()
    assert len(fl) == len(jfl)
    for (got, keep, meta), (want, jkeep, jmeta) in zip(fl, jfl):
        _same_batch(got, want, lsb)
        np.testing.assert_array_equal(keep, jkeep)
        for key in ("pts", "times", "keys"):
            _same_meta(meta.get(key), jmeta.get(key))
        outs.append((got, keep))
    return outs


# ------------------------------------------------------------- parser

_SPECS = [
    "scale=1280:720,format=rgbpf32le",
    "crop=w=480:h=480,rotate=angle=45,smooth=type=median:kw=5",
    "select='gt(scene,0.4)'",
    r"select=gt(scene\,0.4),fps=10",
    "select=\"between(t,1,2)\",setpts=PTS-STARTPTS",
    r"pad=iw+16:ih+8:(ow-iw)/2:'(oh-ih)/2':color=0x3366CC",
    "lutyuv=y=gammaval(0.9):u=val:v=val, unsharp=5:5:0.8 ,eq=contrast=1.2",
    r"lut=c0=if(lt(val\,128)\,0\,255)",
    "deband=1thr=0.02:range=8",
    "yadif=1:0:0,,null",
    "  ",
]


@pytest.mark.parametrize("spec", _SPECS)
def test_parse_graph_matches_jax(spec):
    assert graph.parse_graph(spec) == jgraph.parse_graph(spec)
    assert graph._split(spec, ",") == jgraph._split(spec, ",")


@pytest.mark.parametrize("spec", ["nosuchfilter=1", "scale=w=64:32",
                                  "scale=64:32:bilinear:1",
                                  "crop=1:2:3:4:5"])
def test_parse_graph_errors_match_jax(spec):
    with pytest.raises(jbuiltin.FilterError) as want:
        jgraph.parse_graph(spec)
    with pytest.raises(builtin.FilterError) as got:
        graph.parse_graph(spec)
    assert str(got.value) == str(want.value)


def test_tables_match_jax():
    assert graph.POSITIONAL == jgraph.POSITIONAL
    assert set(builtin.FILTERS) == set(jbuiltin.FILTERS)


# the options a filter needs to build (the rest build with none)
_BUILD_OPTS = {"crop": "=16:16", "crop_nvcv": "=16:16", "scale": "=32:16",
               "scale_cuda": "=32:16", "scale_npp": "=32:16",
               "delogo": "=4:4:8:8",
               # the second-input filters: the file opens at the first
               # batch, not at build time
               "blend": "=video=bottom.y4m", "xfade": "=video=b.y4m",
               "psnr": "=video=ref.y4m", "ssim": "=video=ref.y4m",
               "overlay": "=video=over.y4m",
               "overlay_cuda": "=video=over.y4m",
               # the bundled espcn_x2 checkpoint loads at build time
               "infer": "=sr2x", "tensorrt": "=sr2x:precision=fp32"}


@pytest.mark.parametrize("name", sorted(jbuiltin.FILTERS))
def test_every_filter_name_builds_or_names_its_item(name):
    """All 87 JAX filter names build in the port into the segments the
    JAX graph builds (none raises NotImplementedError any more)."""
    spec = name + _BUILD_OPTS.get(name, "")
    g = graph.FilterGraph(spec)
    assert [k for k, _ in g.segments] == \
        [k for k, _ in jgraph.FilterGraph(spec).segments]


def test_unknown_filter_raises_filter_error():
    with pytest.raises(builtin.FilterError, match="unknown filter"):
        graph.FilterGraph("scale=64:32,frobnicate")


_EXPRS = ["1+2*3^2", "gt(scene,0.3)*between(n,2,9)", "if(lt(t,1),5,ld(0))",
          "st(1,n*2);ld(1)+mod(n,3)", "trunc(-2.7)+round(2.5)+ceil(0.1)",
          "hypot(3,4)+atan2(1,1)+gauss(0.5)", "bitand(12,10)+bitor(1,2)",
          "pow(0,-1)", "log(-1)", "0x1F+1k+2Mi+3dB", "isnan(0/0)+isinf(1/0)",
          "while(lt(ld(0),5),st(0,ld(0)+1))", "lerp(1,3,0.25)+squish(1)",
          "clip(n,2,4)+max(1,2)-min(3,4)", "not(eq(key,1))+PI+E"]


@pytest.mark.parametrize("text", _EXPRS)
def test_expr_matches_jax(text):
    env = {"n": 7.0, "t": 0.5, "scene": 0.45, "key": 1.0}
    got, want = expr.compile_expr(text)(dict(env)), \
        jexpr.compile_expr(text)(dict(env))
    assert got == want or (math.isnan(got) and math.isnan(want))


def test_expr_errors_match_jax():
    for text in ("1+", "foo(1)", "(1"):
        with pytest.raises(ValueError) as want:
            jexpr.compile_expr(text)({})
        with pytest.raises(ValueError) as got:
            expr.compile_expr(text)({})
        assert str(got.value) == str(want.value)
    assert expr.av_strtod("12.5kB") == jexpr.av_strtod("12.5kB")


# ------------------------------------------------------- pure filters

# (spec, LSB bound): positional and named forms of every pure filter
_PURE = [
    ("crop=64:32:8:4", 0), ("crop=w=96:h=48", 0), ("crop_nvcv=32:16", 0),
    ("rotate=30", 1), ("rotate=angle=-12.5:interp=cubic:shift_x=3:shift_y=-2",
                       1),
    ("rotate_nvcv=45:nearest", 1), ("rotate=angle=10:interp=area:center=1",
                                    1),
    ("pad=iw+16:ih+8:8:4:red", 0),
    ("pad=w=160:h=80:x=-1:y=-1:color=#20C0E0", 0),
    ("pad=iw*1.5:ih*1.25:(ow-iw)/2:(oh-ih)/2:0x3366CC", 0),
    ("eq=1.2:0.05", 0),
    ("eq=contrast=0.8:brightness=-0.1:saturation=1.5:gamma=1.3:"
     "gamma_weight=0.6", 0),
    ("lutyuv=y=gammaval(0.9):u=val:v=val", 0),
    ("lut=c0=negval:c1=val*0.9", 0), (r"lutyuv=y=clipval*1.1:v=maxval", 0),
    ("lutyuv=gammaval709(2.2)", 0),
    ("unsharp=5:5:0.8", 0), ("unsharp=lx=3:ly=7:la=-0.5:cx=5:cy=5:ca=1.2", 0),
    ("unsharp=luma_msize_x=7:luma_msize_y=7:luma_amount=2.5", 0),
    ("flip=1", 0), ("flip_nvcv=code=-1", 0), ("hflip", 0), ("vflip", 0),
    ("transpose=1", 0), ("transpose=dir=cclock", 0),
    ("transpose=clock_flip", 0), ("transpose_npp=0", 0),
    ("transpose=dir=1:passthrough=landscape", 0),
    ("smooth=type=median:kw=5:kh=5", 0), ("smooth=median:3:3", 0),
    ("smooth=gaussian:3:5:reflect:1.2", 1),
    ("smooth_nvcv=type=gaussian:kw=5:kh=3:border_type=1", 1),
    ("scale=96:48", 1), ("scale=w=80:h=-2:interp=bicubic", 1),
    ("scale_cuda=-1:40:lanczos", 1), ("scale_npp=64:32:area", 1),
    ("scale=w=48:h=24:interp=bilinear:antialias=1", 1),
    ("format=rgbpf32le", 1), ("format=pix_fmt=yuv444p", 1),
    ("format_cuda=rgbpf32:1.0:0.5", 1), ("format=rgb24,lutrgb=r=negval:"
                                         "g=val:b=maxval-val", 1),
    ("null", 0), ("copy", 0), ("hwupload", 0), ("hwupload_cuda", 0),
    ("hwdownload", 0),
    ("chromakey=0x00FF00:0.2:0.1", 1),
    ("chromakey_cuda=color=green:similarity=0.3", 1),
]


@pytest.mark.parametrize("spec,lsb", _PURE, ids=[s for s, _ in _PURE])
def test_pure_filter_matches_jax(rng, spec, lsb):
    run_both(spec, [_yuv_frames(rng, 2)], lsb)


_PURE_10BIT = [("crop=64:32:8:4", 0), ("rotate=angle=5", 1),
               ("pad=iw+16:ih+16:8:8:red", 0),
               ("lutyuv=y=negval:u=val*0.9", 0),
               ("unsharp=5:5:0.8:5:5:0.4", 0), ("hflip", 0),
               ("transpose=1", 0), ("smooth=type=median:kw=3:kh=3", 0),
               ("scale=96:-2", 1), ("format=p010", 0), ("format=rgb48", 1)]


@pytest.mark.parametrize("spec,lsb", _PURE_10BIT,
                         ids=[s for s, _ in _PURE_10BIT])
def test_pure_filter_10bit_matches_jax(rng, spec, lsb):
    """chip_smoke.py's 10-bit leg at this size: u16 planes through the
    filters that take them."""
    planes = {k: (v.astype(np.uint16) << 2) | 2
              for k, v in _yuv_frames(rng, 2).items()}
    run_both(spec, [planes], lsb, fmt="yuv420p10")


# chip_smoke.py's long chain at this size, one (filter, LSB bound) a stage
_CHAIN = [("crop=120:56:0:4", 0), ("smooth=type=median:kw=5:kh=5", 0),
          ("rotate=angle=5", 1), ("hflip", 0), ("transpose=1", 0),
          ("pad=iw+16:ih+16:8:8", 0), ("scale=48:-2", 1),
          ("eq=contrast=1.2", 0), ("lutyuv=y=gammaval(0.9)", 0),
          ("unsharp=5:5:0.8", 0), ("format=rgbpf32le", 1)]


def test_long_chain_matches_jax(rng):
    """The long chain as one graph in both packages (the segment is one
    composed function), then stage by stage on the JAX stage's input, so
    that each filter is held to its own bound: a 1-LSB rounding edge of
    the bilinear scale grows through eq, the gamma table, unsharp and
    the CSC matrix (up to 4 LSB of float RGB on this content)."""
    spec = ",".join(s for s, _ in _CHAIN)
    assert [k for k, _ in graph.FilterGraph(spec).segments] == ["pure"]
    run_both(spec, [_yuv_frames(rng, 2)], lsb=4)
    planes, fmt, (w, h) = _yuv_frames(rng, 2), "yuv420p", (W, H)
    for stage, lsb in _CHAIN:
        jfb, _ = _pair(planes, fmt, w, h)
        run_both(stage, [planes], lsb, fmt=fmt)
        out, _ = jgraph.FilterGraph(stage).process(jfb)
        planes = {k: np.asarray(v) for k, v in out.planes.items()}
        fmt, w, h = out.format, out.width, out.height
    assert (fmt, w, h) == ("rgbpf32", 48, 92)


@pytest.mark.parametrize("spec", ["eq=1.2", "lutrgb=r=negval",
                                  "unsharp=5:5:1", "transpose_npp=1",
                                  "format=nv13", "smooth=kw=4",
                                  "scale=0:10", "scale=64:32:sinc",
                                  "crop=0:10", "transpose=dir=7",
                                  "pad=8:8", "lut=q=1",
                                  "chromakey=color=nocolor",
                                  "bwdif=mode=frame", "select=1:threshold=1"])
def test_filter_errors_match_jax(rng, spec):
    """Options and formats each package refuses, with the same message
    (an RGB batch where the filter wants YUV, and the reverse)."""
    planes = {"rgb": rng.integers(0, 256, (1, 32, 48, 3)).astype(np.uint8)} \
        if spec.split("=")[0] in ("eq", "unsharp", "transpose_npp") \
        else _yuv_frames(rng, 1, 32, 48)
    fmt = "rgb24" if "rgb" in planes else "yuv420p"

    def run(gmod, pair):
        g = gmod.FilterGraph(spec)
        return g.process(pair, pts=np.arange(1), times=np.zeros(1))

    jfb, fb = _pair(planes, fmt, 48, 32)
    with pytest.raises((ValueError, TypeError)) as want:
        run(jgraph, jfb)
    with pytest.raises((ValueError, TypeError)) as got:
        run(graph, fb)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


# ------------------------------------- stream and keep-mask filters

_STREAM = [
    "yadif", "yadif=1", "yadif=mode=1:parity=0", "yadif_cuda=0:1:0",
    "yadif=2", "bwdif", "bwdif=send_frame", "bwdif=mode=1:parity=bff",
    r"select=gt(scene\,0.3)", "select='gt(scene,0.3)'", r"select=eq(key\,1)",
    r"select_cuda=expr=not(mod(n\,3))", "select_gpu=threshold=0.2",
    "fps=15", "fps=fps=10", "trim=0.1:0.25", "trim=start_frame=2:end_frame=7",
    "trim=duration=0.2", "trim=start_pts=3:end_pts=9",
    "setpts=PTS-STARTPTS", "setpts=expr=2*PTS", "setpts=N/(30*TB)",
    "thumbnail=4", "thumbnail_cuda=n=3",
    r"select=not(mod(n\,2)),yadif=1,scale=64:32",
    "yadif,thumbnail=3", "setpts=PTS-STARTPTS,trim=start=0.1",
    r"fps=10,bwdif,select=gt(scene\,0.1)",
]


@pytest.mark.parametrize("spec", _STREAM)
def test_stream_filters_match_jax(rng, spec):
    """Three 4-frame batches (a scene cut at frame 6, a padded tail of 3
    valid frames in the last), then flush: planes, keep masks, pts,
    times, keys and fps_mul agree."""
    frames = _yuv_frames(rng, 12, 32, 48, cut=6)
    batches = [{k: v[i:i + 4] for k, v in frames.items()}
               for i in range(0, 12, 4)]
    lsb = 1 if "scale" in spec else 0
    run_both(spec, batches, lsb, valid_last=3)


@pytest.mark.parametrize("spec", ["yadif=0:-1:1", "bwdif=0:-1:1",
                                  "bwdif=1:-1:0", "yadif=1:-1:0"])
def test_deinterlacers_follow_interlace_flags(rng, spec):
    """deint=interlaced passes progressive frames through; parity -1
    locks onto the first interlaced frame's field order (bff here)."""
    frames = _yuv_frames(rng, 8, 32, 48)
    ilace = np.array([0, 0, 1, 1, 0, 1, 1, 0], np.int64)   # bit1 = 0: bff
    batches = [{k: v[i:i + 4] for k, v in frames.items()} for i in (0, 4)]
    run_both(spec, batches, ilace=ilace)


@pytest.mark.parametrize("spec", ["yadif=1", "bwdif=0",
                                  r"select=lt(n\,5),yadif,scale=32:16"])
def test_ragged_batches_match_jax(rng, spec):
    """Batches of 3, 1, 5 and 1 frames: the deinterlacers' register
    carries across batches of any size, a batch of one included."""
    frames = _yuv_frames(rng, 10, 32, 48)
    batches = [{k: v[a:b] for k, v in frames.items()}
               for a, b in ((0, 3), (3, 4), (4, 9), (9, 10))]
    run_both(spec, batches, 1 if "scale" in spec else 0)


def test_yadif_u16_and_rgb_batches(rng):
    """The deinterlacers on 10-bit planes and on a packed RGB batch."""
    p10 = {k: (v.astype(np.uint16) * 4) for k, v in
           _yuv_frames(rng, 6, 32, 48).items()}
    for spec in ("yadif=1", "bwdif"):
        run_both(spec, [{k: v[:3] for k, v in p10.items()},
                        {k: v[3:] for k, v in p10.items()}],
                 fmt="yuv420p10")
    rgb = {"rgb": rng.integers(0, 256, (6, 16, 24, 3)).astype(np.uint8)}
    run_both("yadif", [{"rgb": rgb["rgb"][:3]}, {"rgb": rgb["rgb"][3:]}],
             fmt="rgb24")


def test_run_frames_matches_jax(rng):
    """run_frames gathers the kept frames before the host copy and yields
    (planes, pts, batch) per kept frame, flush included."""
    frames = _yuv_frames(rng, 8, 32, 48, cut=5)
    spec = r"select=gt(scene\,0.2)+eq(n\,0),yadif"

    def batches(pair_index):
        for i in (0, 4):
            pair = _pair({k: v[i:i + 4] for k, v in frames.items()},
                         w=48, h=32)
            yield pair[pair_index], np.arange(i, i + 4), 4

    want = list(jgraph.FilterGraph(spec).run_frames(batches(0)))
    got = list(graph.FilterGraph(spec).run_frames(batches(1)))
    assert len(got) == len(want) > 0
    for (gp, gpts, _), (wp, wpts, _) in zip(got, want):
        assert gpts == wpts
        for k in wp:
            np.testing.assert_array_equal(gp[k], np.asarray(wp[k]))
