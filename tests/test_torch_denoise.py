"""The port's blur, denoise and grain ops (ops/blur, hqdn3d, deband,
noise, vignette, delogo) and their filters (boxblur, gblur, sharpen_npp,
hqdn3d, deband, noise, vignette, delogo) against the JAX package's on
the same seeded inputs, on the CPU.

The ops run eagerly in both packages and agree at 0 LSB: every one of
them is integer math, or f32 math that the JAX op and the port round in
the same op order (vignette's factor map and dither).  The filters go
through FilterGraph (tests/test_torch_color.run_pair: the JAX graph op
by op, 0 LSB; the stream filters over three batches with a dead tail
and flush).  gblur is the
exception: XLA compiles the JAX op's IIR scan body and contracts its
multiply-add into an FMA on the CPU, so it is held to the bounds of
tests/test_blur.py, 1 LSB and rtol/atol 2e-6 on float planes."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gmat_tpu.filters import builtin as jbuiltin
from gmat_tpu.ops import blur as jblur, deband as jdeband
from gmat_tpu.ops import delogo as jdelogo, hqdn3d as jhqdn3d
from gmat_tpu.ops import noise as jnoise, vignette as jvignette
from gmat_tpu_torch.filters import builtin
from gmat_tpu_torch.ops import blur, deband, delogo, hqdn3d, noise, vignette
from tests.test_torch_color import (_pair, run_pair, three_batches,
                                    yuv_frames)


def _t(a):
    return torch.as_tensor(a)


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- blur

@pytest.mark.parametrize("dtype,hi", [(np.uint8, 256), (np.uint16, 1024),
                                      (np.uint16, 65536)])
@pytest.mark.parametrize("radius,power", [(0, 2), (1, 1), (2, 2), (5, 3)])
def test_box_blur_plane_matches_jax(rng, dtype, hi, radius, power):
    """0 LSB, the int32 wrap-around of 16-bit sums included."""
    p = rng.integers(0, hi, (2, 24, 40)).astype(dtype)
    _eq(blur.box_blur_plane(_t(p), radius, power),
        jblur.box_blur_plane(jnp.asarray(p), radius, power))


@pytest.mark.parametrize("dtype,maxv", [(np.uint8, 255.0),
                                        (np.uint16, 1023.0),
                                        (np.float32, 0.0)])
@pytest.mark.parametrize("sigma,sigma_v,steps", [(0.5, 0.5, 1),
                                                 (1.5, 3.0, 2),
                                                 (4.0, 0.8, 3)])
def test_gblur_plane_matches_jax(rng, dtype, maxv, sigma, sigma_v, steps):
    """The f32 IIR in the scan's order.  XLA compiles the JAX op's scan
    body and contracts its `row + nu * carry` into an FMA on the CPU; the
    port rounds the product: tests/test_blur.py's bounds, 1 LSB on
    integer planes and rtol/atol 2e-6 on float ones."""
    if dtype == np.float32:
        p = rng.random((2, 20, 36)).astype(dtype)
    else:
        p = rng.integers(0, int(maxv) + 1, (2, 20, 36)).astype(dtype)
    assert blur.gblur_params(sigma, steps) == jblur.gblur_params(sigma,
                                                                 steps)
    got = blur.gblur_plane(_t(p), sigma, sigma_v, steps, maxv).numpy()
    want = np.asarray(jblur.gblur_plane(jnp.asarray(p), sigma, sigma_v,
                                        steps, maxv))
    assert got.dtype == want.dtype
    if dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
    else:
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


# -------------------------------------------------------------- hqdn3d

@pytest.mark.parametrize("depth", [8, 10, 16])
def test_hqdn3d_coefs_match_jax(depth):
    for s in (0.0, 1.5, 4.0, 6.0, 30.0, 255.0):
        np.testing.assert_array_equal(hqdn3d.precalc_coefs(s, depth),
                                      jhqdn3d.precalc_coefs(s, depth))


@pytest.mark.parametrize("fmt,bits,strengths", [
    ("yuv420p", 8, (0, 0, 0, 0)), ("yuv420p", 8, (2, 1.5, 8, 3)),
    ("yuv420p10", 10, (4, 3, 6, 4.5)), ("yuv420p", 8, (0.001, 0, 5, 5))])
def test_hqdn3d_core_matches_jax(rng, fmt, bits, strengths):
    """Three batches through one denoiser each: outputs and the carried
    frame state equal."""
    core, jcore = hqdn3d.HQDN3D(*strengths), jhqdn3d.HQDN3D(*strengths)
    for b in three_batches(yuv_frames(rng, 9, 24, 32, bits), 3):
        jfb, fb = _pair(b, fmt)
        got, want = core(fb), jcore(jfb)
        for k in "yuv":
            _eq(got.planes[k], want.planes[k])
    for k in "yuv":
        _eq(core._state[k], jcore._state[k])


def test_hqdn3d_16bit_plane_matches_jax(rng):
    p = rng.integers(0, 65536, (3, 16, 24)).astype(np.uint16)
    sp, tp = (hqdn3d.precalc_coefs(s, 16) for s in (4.0, 6.0))
    got, st = hqdn3d._denoise_plane(_t(p), sp, tp, _t(sp), _t(tp), None, 16)
    want, jst = jhqdn3d._denoise_plane(jnp.asarray(p), sp, tp, None, 16)
    _eq(got, want)
    _eq(st, jst)


# -------------------------------------------------------------- deband

@pytest.mark.parametrize("rng_,direction", [(16, 2 * np.pi), (8, 1.0),
                                            (-4, -2.0), (0, 0.5)])
def test_deband_table_and_planes_match_jax(rng, rng_, direction):
    xp, yp = deband.offset_table(48, 32, rng_, direction)
    jxp, jyp = jdeband.offset_table(48, 32, rng_, direction)
    np.testing.assert_array_equal(xp, jxp)
    np.testing.assert_array_equal(yp, jyp)
    for dtype, hi, thr in ((np.uint8, 256, 5), (np.uint16, 1024, 20)):
        p = rng.integers(0, hi, (2, 32, 48)).astype(dtype)
        idx = deband.reference_index(("t", rng_, direction), xp, yp, 32,
                                     48, "cpu")
        for blur_ in (True, False):
            _eq(deband.deband_plane(_t(p), idx, thr, blur_),
                jdeband.deband_plane(jnp.asarray(p), jnp.asarray(jxp),
                                     jnp.asarray(jyp), thr, blur_))
        planes = [rng.integers(0, hi, (2, 32, 48)).astype(dtype)
                  for _ in range(3)]
        got = deband.deband_coupled([_t(q) for q in planes], idx,
                                    [thr, thr // 2, thr], True)
        want = jdeband.deband_coupled([jnp.asarray(q) for q in planes],
                                      jnp.asarray(jxp), jnp.asarray(jyp),
                                      [thr, thr // 2, thr], True)
        for g, w in zip(got, want):
            _eq(g, w)


# --------------------------------------------------------------- noise

def test_lfg_and_noise_tables_match_jax():
    for seed in (0, 123457, 2 ** 31 + 5):
        a, b = noise.LFG(seed), jnoise.LFG(seed)
        np.testing.assert_array_equal(a.get_block(300), b.get_block(300))
    for strength, flags in ((20, 0), (7, noise.NOISE_UNIFORM),
                            (30, noise.NOISE_PATTERN),
                            (12, noise.NOISE_UNIFORM | noise.NOISE_PATTERN
                             | noise.NOISE_TEMPORAL)):
        tab, lfg = noise.build_noise(strength, flags, 99, 1)
        jtab, jlfg = jnoise.build_noise(strength, flags, 99, 1)
        np.testing.assert_array_equal(tab, jtab)
        assert lfg.index == jlfg.index
    for a, b in ((7, 2), (-7, 2), (7, -2), (-8, 3)):
        assert noise._c_div(a, b) == jnoise._c_div(a, b)


def test_apply_noise_plane_matches_jax(rng):
    tab, _ = jnoise.build_noise(40, 0, 1, 0)
    shifts = rng.integers(0, noise.MAX_SHIFT, (2, noise.MAX_RES)).astype(
        np.int32)
    p = rng.integers(0, 256, (2, 20, 4200)).astype(np.uint8)   # 2 chunks
    _eq(noise.apply_noise_plane(_t(p), tab.astype(np.int32), shifts),
        jnoise.apply_noise_plane(jnp.asarray(p), tab, shifts))


# ------------------------------------------------------------ vignette

def test_vignette_host_tables_match_jax():
    for n in (1, 2, 777):
        for a, b in zip(vignette.lcg_jump_tables(n),
                        jvignette.lcg_jump_tables(n)):
            np.testing.assert_array_equal(a, b)
    for s0, n in ((0, 1), (12345, 999), (2 ** 32 - 1, 10 ** 6)):
        assert vignette.lcg_after(s0, n) == jvignette.lcg_after(s0, n)
    for args in ((64, 48, 32.0, 24.0, 1.0, 1.0, np.pi / 5, False),
                 (64, 48, 10.5, 40.0, 1.0, 0.75, 1.2, True)):
        np.testing.assert_array_equal(vignette.natural_fmap(*args),
                                      jvignette.natural_fmap(*args))


@pytest.mark.parametrize("backward,dither", [(False, True), (True, True),
                                             (False, False)])
def test_apply_vignette_matches_jax(rng, backward, dither):
    """The closed-form LCG dither in int64 against the JAX op's uint64
    (enable_x64): 0 LSB, the backward mode's inf/nan border included."""
    planes = yuv_frames(rng, 2, 24, 32)
    names = ("y", "u", "v")
    sizes = [planes[k].shape[1] * planes[k].shape[2] for k in names]
    offsets = [0, sizes[0], sizes[0] + sizes[1]]
    A, C = vignette.lcg_jump_tables(sum(sizes))
    fmap = vignette.natural_fmap(32, 24, 16, 12, 1, 1, 1.1, backward)
    seeds = np.array([0, 3_000_000_017], np.int64)
    subs = [(0, 0), (1, 1), (1, 1)]
    got = vignette.apply_vignette(
        [_t(planes[k]) for k in names], _t(fmap), _t(A.astype(np.int64)),
        _t(C.astype(np.int64)), _t(seeds), offsets, dither, subs)
    want = jvignette.apply_vignette(
        [jnp.asarray(planes[k]) for k in names], jnp.asarray(fmap),
        jnp.asarray(A), jnp.asarray(C), jnp.asarray(seeds.astype(np.uint32)),
        offsets, dither, subs)
    for g, w in zip(got, want):
        _eq(g, w)


# -------------------------------------------------------------- delogo

@pytest.mark.parametrize("box", [(4, 4, 12, 10, 1, False),
                                 (0, 3, 9, 9, 1, False),
                                 (20, 10, 12, 14, 1, True),
                                 (-2, -3, 10, 10, 2, False),
                                 (30, 20, 8, 8, 0, False)])
def test_apply_delogo_plane_matches_jax(rng, box):
    """The int64 region math against the JAX op's uint64 (enable_x64),
    clipped logos (the live band blend) and show=1 included."""
    x, y, w, h, band, show = box
    p = rng.integers(0, 256, (2, 24, 36)).astype(np.uint8)
    _eq(delogo.apply_delogo_plane(_t(p), 36, 24, 1, 1, x, y, w, h, band,
                                  show),
        jdelogo.apply_delogo_plane(jnp.asarray(p), 36, 24, 1, 1, x, y, w, h,
                                   band, show))


# ------------------------------------------------------------- filters

_PURE = ["boxblur", "boxblur=2:1", "boxblur=3:2:1:1",
         "boxblur=luma_radius=w/32:luma_power=1:chroma_radius=1",
         "boxblur=lr=2:lp=3:cr=0:cp=1",
         "sharpen_npp", "sharpen_npp=border_type=replicate",
         "sharpen_npp=2", "delogo=10:10:20:12", "delogo=x=30:y=8:w=16:h=20",
         "delogo=4:30:40:10:1", "delogo=x=16:y=12:w=32:h=24:show=1",
         "format=yuv444p,sharpen_npp"]


@pytest.mark.parametrize("spec", _PURE)
def test_pure_filters_match_jax(rng, spec):
    run_pair(spec, [yuv_frames(rng, 2)])


# gblur: tests/test_blur.py's bounds (see test_gblur_plane_matches_jax)
_GBLUR = ["gblur", "gblur=1.5", "gblur=sigma=2:steps=3:planes=1:sigmaV=0.7",
          "gblur=3:2:6", "format=gbrpf32le,gblur=sigma=1.2:planes=5"]


@pytest.mark.parametrize("spec", _GBLUR)
def test_gblur_filter_matches_jax(rng, spec):
    run_pair(spec, [yuv_frames(rng, 2)], lsb=1, rtol=2e-6, atol=2e-6)


def test_gblur_matches_jitted_jax(rng):
    run_pair("gblur=sigma=1.5:steps=2", [yuv_frames(rng, 2)], lsb=1,
             eager=False)


_PURE_10BIT = [("boxblur=2:2", 0), ("gblur=sigma=2", 1),
               ("gblur=0.8:2:2", 1)]


@pytest.mark.parametrize("spec,lsb", _PURE_10BIT,
                         ids=[s for s, _ in _PURE_10BIT])
def test_pure_filters_10bit_match_jax(rng, spec, lsb):
    run_pair(spec, [yuv_frames(rng, 2, bits=10)], lsb, fmt="yuv420p10")


_STREAM = ["hqdn3d", "hqdn3d=2:1.5:8:3", "hqdn3d=luma_spatial=6:luma_tmp=0",
           r"select=not(mod(n\,3)),hqdn3d=4:3:6:4",
           "deband", "deband=0.05:0.05:0.05:0.05:8:1.0:0",
           "deband=1thr=0.04:2thr=0.01:range=-6:direction=-1:blur=0",
           "deband=r=10:d=3:b=1",
           "noise=alls=20:allf=t", "noise=c0s=10:c0f=u+p",
           "noise=all_seed=7:all_strength=15:all_flags=t+u",
           "noise=c1_strength=30:c1_flags=p:c2s=5",
           "vignette", "vignette=angle=PI/4:mode=backward",
           "vignette=angle=PI/6+0.01*n:eval=frame", "vignette=a=0.5:dither=0",
           "vignette=x0=w/3:y0=h/3:aspect=4/3"]


@pytest.mark.parametrize("spec", _STREAM)
def test_stream_filters_match_jax(rng, spec):
    """Three 4-frame batches, the last with 3 valid frames, then flush:
    planes, keep masks and pts agree; the LFG position, the dither state
    and the frame state carry across batches as in the JAX filters."""
    run_pair(spec, three_batches(yuv_frames(rng, 12)), valid_last=3)


_STREAM_10BIT = ["hqdn3d", "hqdn3d=3:2:5:4", "deband=1thr=0.03:range=4"]


@pytest.mark.parametrize("spec", _STREAM_10BIT)
def test_stream_filters_10bit_match_jax(rng, spec):
    run_pair(spec, three_batches(yuv_frames(rng, 12, bits=10)),
             fmt="yuv420p10", valid_last=2)


def test_deband_coupling_on_yuv444_matches_jax(rng):
    planes = {k: rng.integers(0, 256, (4, 24, 32)).astype(np.uint8)
              for k in "yuv"}
    for spec in ("deband=coupling=1", "deband=c=1:b=0:range=4"):
        run_pair(spec, [planes], fmt="yuv444p")


def test_stream_filter_state_matches_jax(rng):
    """The carried state itself after three batches: the noise LFG
    position, vignette's dither state and frame number."""
    from gmat_tpu.filters import graph as jgraph
    from gmat_tpu_torch.filters import graph
    for spec, attrs in (("noise=alls=10:allf=t", ()),
                        ("vignette", ("_dither_state", "_frame_no"))):
        jg, g = jgraph.FilterGraph(spec), graph.FilterGraph(spec)
        for b in three_batches(yuv_frames(rng, 12, 16, 24)):
            jfb, fb = _pair(b, "yuv420p")
            jg.process(jfb, valid=3)
            g.process(fb, valid=3)
        f, jf = g.segments[0][1], jg.segments[0][1]
        for a in attrs:
            assert getattr(f, a) == getattr(jf, a), a
        if spec.startswith("noise"):
            assert [p["lfg"].index for p in f.params if p["lfg"]] == \
                [p["lfg"].index for p in jf.params if p["lfg"]]


@pytest.mark.parametrize("spec,fmt", [
    ("boxblur=luma_radius=40", "yuv420p"), ("boxblur=lp=-1", "yuv420p"),
    ("boxblur", "rgb24"), ("gblur=sigma=2000", "yuv420p"),
    ("gblur=steps=9", "yuv420p"), ("gblur=planes=16", "yuv420p"),
    ("gblur", "rgb24"), ("sharpen_npp=border_type=constant", "yuv420p"),
    ("sharpen_npp", "yuv420p10"), ("hqdn3d=300", "yuv420p"),
    ("hqdn3d", "rgb24"), ("deband=1thr=0.9", "yuv420p"),
    ("deband=foo=1", "yuv420p"), ("deband=d=9", "yuv420p"),
    ("deband=c=1", "yuv420p"), ("deband", "rgbpf32"),
    ("noise=alls=200", "yuv420p"), ("noise=allf=a:alls=3", "yuv420p"),
    ("noise=allf=q", "yuv420p"), ("noise=bogus=1", "yuv420p"),
    ("noise=alls=5", "yuv420p10"), ("vignette=mode=sideways", "yuv420p"),
    ("vignette=eval=never", "yuv420p"), ("vignette=aspect=-1", "yuv420p"),
    ("vignette", "rgb24"), ("delogo=x=1:y=1:w=5", "yuv420p"),
    ("delogo=0:0:10:10", "yuv420p"), ("delogo=10:10:60:10", "yuv420p"),
    ("delogo=2:2:5:5", "yuv420p10"),
])
def test_denoise_filter_errors_match_jax(rng, spec, fmt):
    """Options and formats each package refuses, with the same message."""
    from gmat_tpu.filters import graph as jgraph
    from gmat_tpu_torch.core import formats
    from gmat_tpu_torch.filters import graph
    f = formats.get(fmt)
    if f.is_rgb:
        dt = np.float32 if f.is_float else np.uint8
        planes = {"rgb": (rng.random((1, 16, 24, 3))
                          * (1 if f.is_float else 200)).astype(dt)}
    else:
        planes = yuv_frames(rng, 1, 16, 24, bits=f.bits)

    def run(gmod, pair):
        g = gmod.FilterGraph(spec)
        return g.process(pair, pts=np.arange(1), times=np.zeros(1))

    jfb, fb = _pair(planes, fmt)
    with pytest.raises((ValueError, TypeError)) as want:
        run(jgraph, jfb)
    with pytest.raises((ValueError, TypeError)) as got:
        run(graph, fb)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_delogo_and_drawbox_helpers_match_jax():
    for r, g, b in ((0, 0, 0), (255, 255, 255), (16, 128, 240)):
        assert builtin._rgb_to_yuv_ccir(r, g, b) == \
            jbuiltin._rgb_to_yuv_ccir(r, g, b)
    for c in ("red@0.5", "0x336699AA", "white"):
        assert builtin._parse_color_rgba(c) == jbuiltin._parse_color_rgba(c)
    for v in (0.299, 0.5, 1.0):
        assert builtin._fix(v) == jbuiltin._fix(v)
