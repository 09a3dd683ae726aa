"""The port's HDR lane (core/transfer, ops/tonemap, filters/hdr) against
the JAX package's on the same seeded inputs, on the CPU: every transfer
name both ways, the primaries matrices, every tone-mapping method with
and without desaturation, zscale's options and the graph's link state,
and the whole HDR10 -> SDR chain.

Bounds: the transfer curves are f32 pow/exp/log, whose last ulp differs
between XLA's and PyTorch's CPU implementations and which the PQ curve
magnifies near its toe: rtol 1e-4 / atol 1e-5, the round-trip bound of
tests/test_tonemap.py.  tonemap_rgb: rtol 2e-5 / atol 2e-6, the operator
bound there.  Float-RGB graph outputs: tests/test_tonemap.py's pipeline
bound, rtol 3e-4 / atol 3e-5.  The chain's yuv420p output: 1 LSB, against
the JAX graph run op by op (the curves' last ulp) and against the jitted
JAX graph (XLA also contracts the f32 multiply-adds into FMAs)."""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gmat_tpu.core import transfer as JT
from gmat_tpu.filters import hdr as jhdr
from gmat_tpu.ops import tonemap as JTM
from gmat_tpu_torch.core import transfer as T
from gmat_tpu_torch.filters import builtin, hdr
from gmat_tpu_torch.ops import tonemap as TM
from tests.test_torch_color import _pair, run_pair, three_batches

CURVE_RTOL, CURVE_ATOL = 1e-4, 1e-5
TM_RTOL, TM_ATOL = 2e-5, 2e-6
PIPE_RTOL, PIPE_ATOL = 3e-4, 3e-5
HDR_META = {"trc": "smpte2084", "primaries": "bt2020",
            "max_cll": 4000, "max_luminance": 1000.0}
# tests/test_tonemap.py:243's chain, with explicit input tags: metrans
# builds its graphs without stream meta
HDR_CHAIN = ("zscale=tin=smpte2084:min=bt2020nc:pin=bt2020:t=linear:npl=100,"
             "format=gbrpf32le,zscale=p=bt709,tonemap=tonemap=hable:desat=0,"
             "zscale=t=bt709:m=bt709:r=tv,format=yuv420p")
HDR_CHAIN_META = ("zscale=t=linear:npl=100,format=gbrpf32le,zscale=p=bt709,"
                  "tonemap=hable:desat=0,zscale=t=bt709:m=bt709:r=tv,"
                  "format=yuv420p")


def pq_frames(rng, n, h=32, w=48):
    """10-bit limited-range PQ-coded 4:2:0: luma over codes 64-940 (the
    steep end of the curve included), chroma around 512."""
    yy, xx = np.mgrid[0:h, 0:w]
    ys, us, vs = [], [], []
    for i in range(n):
        base = 64 + (xx * 876 // (w - 1) + 7 * i) % 877
        ys.append(np.clip(base + rng.integers(-8, 9, (h, w)), 64, 940))
        us.append(np.clip(512 + (yy[::2, ::2] - h // 4) * 6 + i
                          + rng.integers(-20, 21, (h // 2, w // 2)), 64, 960))
        vs.append(np.clip(512 - (xx[::2, ::2] - w // 4) * 4 - i
                          + rng.integers(-20, 21, (h // 2, w // 2)), 64, 960))
    return {k: np.stack(v).astype(np.uint16)
            for k, v in zip("yuv", (ys, us, vs))}


# -------------------------------------------------------- core/transfer

@pytest.mark.parametrize("name", sorted(JT._TRC_ALIASES))
def test_transfer_curves_match_jax(rng, name):
    x = np.concatenate([rng.random(4000), [0.0, 1.0, 0.018, 0.5, 1e-6]]
                       ).astype(np.float32)
    assert T.canon_trc(name) == JT.canon_trc(name)
    for npl in (100.0, 203.0):
        np.testing.assert_allclose(
            T.linearize(torch.as_tensor(x), name, npl).numpy(),
            np.asarray(JT.linearize(jnp.asarray(x), name, npl)),
            rtol=CURVE_RTOL, atol=CURVE_ATOL)
        lin = (x * 12.0).astype(np.float32)
        np.testing.assert_allclose(
            T.delinearize(torch.as_tensor(lin), name, npl).numpy(),
            np.asarray(JT.delinearize(jnp.asarray(lin), name, npl)),
            rtol=CURVE_RTOL, atol=CURVE_ATOL)


def test_primaries_and_tables_match_jax():
    assert T.TRANSFERS == JT.TRANSFERS and T.PRIMARIES == JT.PRIMARIES
    assert T._TRC_ALIASES == JT._TRC_ALIASES
    assert T._PRIM_ALIASES == JT._PRIM_ALIASES
    for a in sorted(JT._PRIM_ALIASES):
        np.testing.assert_array_equal(T.rgb2xyz_matrix(a),
                                      JT.rgb2xyz_matrix(a))
        for b in ("bt709", "bt2020", "p3dci"):
            np.testing.assert_array_equal(T.gamut_matrix(a, b),
                                          JT.gamut_matrix(a, b))
    for bad in ("xyz", "bt2100"):
        for fn in ("canon_trc", "canon_primaries"):
            with pytest.raises(ValueError) as want:
                getattr(JT, fn)(bad)
            with pytest.raises(ValueError) as got:
                getattr(T, fn)(bad)
            assert str(got.value) == str(want.value)


# --------------------------------------------------------- ops/tonemap

@pytest.mark.parametrize("method", JTM.METHODS)
@pytest.mark.parametrize("desat", [0.0, 0.5, 2.0])
def test_tonemap_rgb_matches_jax(rng, method, desat):
    rgb = (rng.random((2, 16, 24, 3)) ** 3 * 40.0).astype(np.float32)
    for param, peak in ((float("nan"), 40.0), (0.4, 10.0), (2.5, 100.0)):
        p = TM.resolve_param(method, param)
        assert p == JTM.resolve_param(method, param) or (
            math.isnan(p) and math.isnan(JTM.resolve_param(method, param)))
        assert TM._hable32(peak) == JTM._hable32(peak)
        for coeffs in ((0.2627, 0.678, 0.0593), None):
            np.testing.assert_allclose(
                TM.tonemap_rgb(torch.as_tensor(rgb), method, p, desat, peak,
                               coeffs).numpy(),
                np.asarray(JTM.tonemap_rgb(jnp.asarray(rgb), method, p,
                                           desat, peak, coeffs)),
                rtol=TM_RTOL, atol=TM_ATOL)


def test_resolve_peak_matches_jax():
    for link, explicit in ((dict(HDR_META), 0.0), ({"max_luminance": 1000.0},
                                                   0.0),
                           ({"trc": "smpte2084"}, 0.0), ({"trc": "bt709"},
                                                         0.0),
                           (None, 0.0), ({}, 0.0), (dict(HDR_META), 25.0)):
        assert hdr.resolve_peak(link, explicit) == \
            jhdr.resolve_peak(link, explicit)


# ------------------------------------------------------- filters/hdr

def test_hdr_chain_matches_jax(rng):
    """The HDR10 -> SDR chain with explicit input tags, as metrans builds
    it (no stream meta: peak 10.0), over three batches with a dead tail,
    against the JAX graph run op by op: 1 LSB, since the curves' f32 pow
    differs by an ulp between XLA and PyTorch (0 on this content)."""
    run_pair(HDR_CHAIN, three_batches(pq_frames(rng, 12)), lsb=1,
             fmt="yuv420p10", colorspace="bt2020", valid_last=3)


def test_hdr_chain_matches_jitted_jax(rng):
    run_pair(HDR_CHAIN, [pq_frames(rng, 3)], lsb=1, fmt="yuv420p10",
             colorspace="bt2020", eager=False)


def test_hdr_chain_with_stream_meta_matches_jax(rng):
    """The probe's tags seed the link state: zscale reads trc/primaries,
    tonemap takes its peak from MaxCLL and rewrites the side data."""
    outs = run_pair(HDR_CHAIN_META, [pq_frames(rng, 2)], fmt="yuv420p10",
                    colorspace="bt2020", stream_meta=dict(HDR_META))
    assert outs[0][0].format == "yuv420p" and \
        outs[0][0].colorspace == "bt709"


_FLOAT_SPECS = [
    "zscale=tin=smpte2084:t=linear:npl=100,format=gbrpf32le,tonemap=hable",
    "zscale=transferin=pq:transfer=linear:nominal_peak_luminance=203,"
    "tonemap=tonemap=mobius:param=0.5:desat=0.5",
    "zscale=tin=smpte2084:t=linear,tonemap=reinhard:0.3:1:40",
    "zscale=tin=smpte2084:t=linear,tonemap=gamma",
    "zscale=tin=smpte2084:t=linear,tonemap=linear:2",
    "zscale=tin=smpte2084:t=linear,tonemap=tonemap=clip:param=1.5:peak=20",
    "zscale=tin=smpte2084:t=linear,tonemap",
    "zscale=tin=hlg:t=bt709:pin=bt2020:p=bt709",
    "zscale=tin=smpte2084:pin=2020:p=p3d65:t=srgb:m=bt709",
    "zscale=tin=arib-std-b67:t=bt1886:min=bt2020nc",
    "zscale=min=bt2020nc:w=24:h=16", "zscale=24:-2",
    "zscale=tin=pq:t=linear:s=16x12:f=bicubic",
    "zscale=w=-2:h=20:filter=lanczos",
    "zscale=size=qcif:filter=point",
    "zscale=tin=bt709:t=linear:r=tv:rin=limited:d=none",
]


@pytest.mark.parametrize("spec", _FLOAT_SPECS)
def test_hdr_float_graphs_match_jax(rng, spec):
    """zscale's options and tonemap's algorithms on float RGB, positional
    and named: tests/test_tonemap.py's pipeline bound."""
    run_pair(spec, [pq_frames(rng, 2)], fmt="yuv420p10", colorspace="bt2020",
             rtol=PIPE_RTOL, atol=PIPE_ATOL)


def test_zscale_on_rgb_inputs_matches_jax(rng):
    rgba = {"rgb": rng.integers(0, 256, (2, 16, 24, 4)).astype(np.uint8)}
    run_pair("zscale=tin=srgb:t=linear,tonemap=hable:peak=1.5", [rgba],
             fmt="rgba", rtol=PIPE_RTOL, atol=PIPE_ATOL)
    rgb = {"rgb": rng.random((2, 16, 24, 3)).astype(np.float32)}
    run_pair("zscale=tin=bt709:pin=bt709:p=bt2020:t=st2084", [rgb],
             fmt="rgbpf32", rtol=PIPE_RTOL, atol=PIPE_ATOL)


@pytest.mark.parametrize("spec,meta", [
    ("zscale=t=linear", {"trc": "smpte2084", "primaries": "bt2020"}),
    ("zscale=t=linear,zscale=p=bt709,zscale=t=bt709",
     {"trc": "pq", "primaries": "2020", "max_cll": 1000}),
    ("zscale=t=linear,tonemap=hable,tonemap=reinhard",
     {"trc": "hlg", "max_luminance": 600.0}),
    ("zscale=t=linear:tin=bt709:pin=bt709", None),
    ("null", {"trc": "bt709"}),
])
def test_link_state_matches_jax(spec, meta):
    from gmat_tpu.filters import graph as jgraph
    from gmat_tpu_torch.filters import graph
    g = graph.FilterGraph(spec, stream_meta=None if meta is None
                          else dict(meta))
    jg = jgraph.FilterGraph(spec, stream_meta=None if meta is None
                            else dict(meta))
    assert g.link_state == jg.link_state


@pytest.mark.parametrize("spec,fmt", [
    ("tonemap", "yuv420p10"), ("tonemap=foo", "rgbpf32"),
    ("zscale=t=linear", "yuv420p10"), ("zscale=p=bt709:tin=pq",
                                       "yuv420p10"),
    ("zscale=t=transfer=1:transfer=2", "yuv420p10"),
    ("zscale=t=linear:transfer=bt709", "yuv420p10"),
    ("zscale=d=ordered", "yuv420p10"), ("zscale=r=pc", "yuv420p10"),
    ("zscale=w=-1:h=-1", "yuv420p10"), ("zscale=f=spline36", "yuv420p10"),
    ("zscale=f=sinc", "yuv420p10"), ("zscale=s=huge", "yuv420p10"),
    ("zscale=m=xyz", "yuv420p10"), ("zscale=min=xyz", "yuv420p10"),
    ("zscale=tin=foo:t=linear", "yuv420p10"),
])
def test_hdr_filter_errors_match_jax(rng, spec, fmt):
    from gmat_tpu.filters import graph as jgraph
    from gmat_tpu_torch.filters import graph
    if fmt == "rgbpf32":
        planes = {"rgb": rng.random((1, 16, 24, 3)).astype(np.float32)}
    else:
        planes = pq_frames(rng, 1, 16, 24)

    def run(gmod, pair):
        return gmod.FilterGraph(spec).process(pair)

    jfb, fb = _pair(planes, fmt, "bt2020")
    with pytest.raises((ValueError, TypeError)) as want:
        run(jgraph, jfb)
    with pytest.raises((ValueError, TypeError)) as got:
        run(graph, fb)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_hdr_registers_into_filters():
    assert builtin.FILTERS["tonemap"] is hdr._f_tonemap
    assert builtin.FILTERS["zscale"] is hdr._f_zscale
    assert hdr._f_tonemap.wants_link and hdr._f_zscale.wants_link
    assert hdr._MATRIX_NAMES == jhdr._MATRIX_NAMES
    assert hdr._VIDEO_SIZE_ABBRS == jhdr._VIDEO_SIZE_ABBRS


def test_gamut_product_matches_jax_einsum(rng):
    """zscale's gamut product: no matmul (so no TF32 on a card), the fma
    chain of the JAX op's f32 einsum on the CPU, bit for bit."""
    x = (rng.random((64, 48, 3)) * 12.0).astype(np.float32)
    for src, dst in (("bt2020", "bt709"), ("bt709", "p3d65")):
        gm = T.gamut_matrix(src, dst)
        got = hdr._gamut(torch.as_tensor(x), gm).numpy()
        want = np.asarray(jnp.einsum("...c,dc->...d", jnp.asarray(x),
                                     jnp.asarray(gm)))
        np.testing.assert_array_equal(got, want)
