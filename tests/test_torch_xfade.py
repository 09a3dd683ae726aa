"""The port's xfade, zoompan and quality-metric filters against the JAX
package's on the same seeded inputs, on the CPU.

- xfade: filters/xfade.py is the JAX module's float32 numpy, carried
  over; every named transition and `custom` run through the stream
  machine (passthrough, blend window, second-stream tail, flush) at
  32 x 16 on yuv444p, and on rgb24 and yuv444p16: 0 LSB, keep masks,
  pts and times equal.
- zoompan: per-output expressions on the host, bicubic gathers in
  ops/resize's op order: 0 LSB, the bound of tests/test_zoompan.py.
- ops/metrics psnr/ssim: f32 means summed in another order than XLA's,
  rtol 1e-5; the psnr/ssim filters' stats files equal to their printed
  precision (4 decimals, one unit of the last digit; an MSE in the
  thousands prints more digits than f32 holds, so rtol 1e-6 too), their
  EOF summaries likewise (2 decimals for PSNR, 4 for SSIM)."""
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gmat_tpu.filters import builtin as jbuiltin, graph as jgraph
from gmat_tpu.filters import xfade as jxfade
from gmat_tpu.ops import metrics as jmetrics
from gmat_tpu_torch.av.rawvideo import Y4MWriter
from gmat_tpu_torch.filters import builtin, graph, xfade
from gmat_tpu_torch.ops import metrics
from tests.test_torch_color import _pair, run_pair, yuv_frames
from tests.test_torch_temporal import DROP, batches_of

W, H = 32, 16


def write_second(path, n, h=H, w=W, seed=31, bits=8):
    rng = np.random.default_rng(seed)
    wr = Y4MWriter(path, w, h, (30, 1), bits=bits)
    dt = np.uint8 if bits == 8 else np.uint16
    for i in range(n):
        wr.write(*(rng.integers(0, 1 << bits, s).astype(dt)
                   for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))))
    wr.close()


def _yuv444(n, seed, bits=8, h=H, w=W):
    rng = np.random.default_rng(seed)
    dt = np.uint8 if bits == 8 else np.uint16
    return {k: rng.integers(0, 1 << bits, (n, h, w)).astype(dt)
            for k in "yuv"}


def test_transition_table_matches_jax():
    assert sorted(xfade.TRANSITIONS) == sorted(jxfade.TRANSITIONS)
    assert len(xfade.TRANSITIONS) == 47        # 46 named + custom


@pytest.mark.parametrize("name", sorted(set(jxfade.TRANSITIONS)
                                        - {"custom"}))
def test_xfade_transition_through_the_stream_matches_jax(tmp_path, name):
    """13 main frames (one dropped upstream, a dead tail) fading into a
    20-frame second input from 0.1 s for 0.2 s at 30 fps: passthrough,
    six blends, the second stream after, and its tail at flush."""
    second = str(tmp_path / "b.y4m")
    write_second(second, 20)
    run_pair(f"{DROP}xfade=transition={name}:duration=0.2:offset=0.1:"
             f"video={second}", batches_of(_yuv444(13, 32)),
             fmt="yuv444p", valid_last=3)


@pytest.mark.parametrize("expr", ["A*P+B*(1-P)",
                                  "if(gt(X\\,W/2)\\,a0(X\\,Y)\\,b1(Y\\,X))"
                                  "+PLANE"])
def test_xfade_custom_matches_jax(tmp_path, expr):
    """custom: the expression per pixel on the host, getpix included."""
    second = str(tmp_path / "b.y4m")
    write_second(second, 8, 8, 12)
    frames = _yuv444(6, 33, h=8, w=12)
    run_pair(f"xfade=transition=custom:duration=0.1:offset=0:"
             f"expr={expr}:video={second}", batches_of(frames, (3, 3)),
             fmt="yuv444p")


@pytest.mark.parametrize("fmt", ["rgb24", "yuv444p16", "gray8"])
def test_xfade_other_formats_match_jax(tmp_path, fmt):
    """RGB, 16-bit and gray mains: the second input is converted to the
    main format on the main stream's device."""
    second = str(tmp_path / "b.y4m")
    write_second(second, 12)
    frames = yuv_frames(np.random.default_rng(34), 9, H, W)
    run_pair(f"format={fmt},xfade=transition=wipeleft:duration=0.1:"
             f"offset=0.05:video={second}", batches_of(frames, (3, 3, 3)))


def test_xfade_long_tail_flushes_in_chunks(tmp_path):
    second = str(tmp_path / "long.y4m")
    write_second(second, 150, 8, 8)
    frames = _yuv444(4, 35, h=8, w=8)
    outs = run_pair(f"xfade=duration=0.1:offset=0:video={second}",
                    [frames], fmt="yuv444p")
    assert [o[0].batch for o in outs[1:]] == [64, 64, 18]


@pytest.mark.parametrize("spec", ["xfade=transition=zzz:video=x.y4m",
                                  "xfade=duration=0:video=x.y4m",
                                  "xfade=duration=61:video=x.y4m",
                                  "xfade=transition=custom:video=x.y4m",
                                  "xfade=transition=fade"])
def test_xfade_option_errors_match_jax(spec):
    with pytest.raises(jbuiltin.FilterError) as want:
        jgraph.FilterGraph(spec)
    with pytest.raises(builtin.FilterError) as got:
        graph.FilterGraph(spec)
    assert str(got.value) == str(want.value)


def test_xfade_rejects_subsampled_main_as_jax(tmp_path):
    second = str(tmp_path / "b.y4m")
    write_second(second, 4)
    frames = yuv_frames(np.random.default_rng(36), 2, H, W)
    jfb, fb = _pair(frames, "yuv420p")
    spec = f"xfade=video={second}"
    with pytest.raises(jbuiltin.FilterError) as want:
        jgraph.FilterGraph(spec).process(jfb, pts=np.arange(2))
    with pytest.raises(builtin.FilterError) as got:
        graph.FilterGraph(spec).process(fb, pts=np.arange(2))
    assert str(got.value) == str(want.value) and "444" in str(got.value)


# ------------------------------------------------------------- zoompan

_ZOOMPAN = [
    "zoompan=z=2:x=16:y=12:d=2:s=32x24",
    "zoompan=zoom=min(zoom+0.1\\,2.5):x=iw/2-(iw/zoom/2):"
    "y=ih/2-(ih/zoom/2):d=3:s=40x30:fps=30",
    "zoompan=z=if(eq(on\\,0)\\,1\\,pzoom+0.25):x=px+3:y=py+1:d=2:"
    "s=48x32",
    "zoompan=z=1.7:x=5:y=3:d=1:s=24x18:fps=15",
    "zoompan=z=1+in/4:x=on*2:y=frame:d=in+1:s=32x16",
]


@pytest.mark.parametrize("jit", [False, True])
@pytest.mark.parametrize("fmt", ["yuv420p", "yuv420p10", "gray8"])
@pytest.mark.parametrize("spec", _ZOOMPAN)
def test_zoompan_matches_jax(monkeypatch, spec, fmt, jit):
    """Expressions over a few inputs with small `d`, 3 batches with a
    select drop and a dead tail; pts and times equal.  Against the JAX
    gather run op by op: 0 LSB.  Against its jitted form: 1 LSB (XLA
    contracts the f32 multiply-adds into FMAs on the CPU, which moves a
    rare 10-bit sample across a rounding edge)."""
    if not jit:
        monkeypatch.setattr(jbuiltin, "_zp_gather",
                            jbuiltin._zp_gather.__wrapped__)
    bits = 10 if fmt == "yuv420p10" else 8
    frames = yuv_frames(np.random.default_rng(37), 7, 48, 64, bits)
    if fmt == "gray8":
        frames = {"y": frames["y"]}
    run_pair(DROP + spec, batches_of(frames, (3, 2, 2)), fmt=fmt,
             valid_last=1, lsb=1 if jit else 0)


def test_zoompan_rejects_rgb_as_jax():
    frames = {"rgb": np.zeros((2, 16, 16, 3), np.uint8)}
    jfb, fb = _pair(frames, "rgb24")
    with pytest.raises(jbuiltin.FilterError) as want:
        jgraph.FilterGraph("zoompan").process(jfb, pts=np.arange(2))
    with pytest.raises(builtin.FilterError) as got:
        graph.FilterGraph("zoompan").process(fb, pts=np.arange(2))
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------- metrics

@pytest.mark.parametrize("dtype,max_val", [(np.uint8, 255.0),
                                           (np.uint16, 1023.0)])
@pytest.mark.parametrize("win", [4, 8])
def test_ops_metrics_match_jax(dtype, max_val, win):
    rng = np.random.default_rng(38)
    hi = int(max_val) + 1
    a = rng.integers(0, hi, (3, 36, 52)).astype(dtype)
    b = np.clip(a.astype(np.int64) + rng.integers(-9, 10, a.shape), 0,
                hi - 1).astype(dtype)
    got = metrics.psnr(torch.as_tensor(a), torch.as_tensor(b), max_val)
    want = jmetrics.psnr(jnp.asarray(a), jnp.asarray(b), max_val)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    got = metrics.ssim(torch.as_tensor(a), torch.as_tensor(b), max_val, win)
    want = jmetrics.ssim(jnp.asarray(a), jnp.asarray(b), max_val, win)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    # identical planes: psnr at its 1e-10 floor, ssim 1
    same = metrics.psnr(torch.as_tensor(a), torch.as_tensor(a), max_val)
    np.testing.assert_allclose(same.numpy(), np.asarray(
        jmetrics.psnr(jnp.asarray(a), jnp.asarray(a), max_val)), rtol=1e-6)


def test_ops_ssim_small_plane_error_matches_jax():
    a = torch.zeros((1, 4, 4), dtype=torch.uint8)
    with pytest.raises(ValueError) as got:
        metrics.ssim(a, a)
    with pytest.raises(ValueError) as want:
        jmetrics.ssim(jnp.zeros((1, 4, 4), jnp.uint8),
                      jnp.zeros((1, 4, 4), jnp.uint8))
    assert str(got.value) == str(want.value)


def _numbers(text):
    return [float(v) for v in re.findall(r"-?\d+\.\d+|-?\d+", text)]


def _same_printed(got, want, unit):
    """Two printed lines with the same words and numbers within one unit
    of their last printed digit, or within f32 rounding (rtol 1e-6) for
    numbers printed past f32's 7 digits (an MSE in the thousands)."""
    assert re.sub(r"-?[\d.]+", "#", got) == re.sub(r"-?[\d.]+", "#", want)
    np.testing.assert_allclose(_numbers(got), _numbers(want), rtol=1e-6,
                               atol=unit * 1.0001)


@pytest.mark.parametrize("kind", ["psnr", "ssim", "ssim_win4"])
@pytest.mark.parametrize("fmt", ["yuv420p", "gray8"])
def test_metric_filters_match_jax(tmp_path, capsys, kind, fmt):
    """Frames pass through; per-frame stats lines and the EOF summary
    agree to their printed precision.  The 13-frame main is scored
    against a 10-frame reference: the tail goes unscored with a warning
    in both packages."""
    ref = str(tmp_path / "ref.y4m")
    write_second(ref, 10, 48, 64, seed=39)
    frames = yuv_frames(np.random.default_rng(40), 13, 48, 64)
    stats = {}
    opts = ":win=4" if kind == "ssim_win4" else ""
    name = kind.split("_")[0]
    for who in ("port", "jax"):
        stats[who] = str(tmp_path / f"{who}.log")
    spec = (f"{DROP}format={fmt},{name}=video={ref}:stats_file=%s{opts}")
    import unittest.mock as mock
    # both graphs are built inside run_pair: hand each its own file
    built = []
    real_j, real_p = jgraph.FilterGraph.__init__, graph.FilterGraph.__init__

    def j_init(self, s, *a, **kw):
        built.append("jax")
        return real_j(self, s % stats["jax"], *a, **kw)

    def p_init(self, s, *a, **kw):
        built.append("port")
        return real_p(self, s % stats["port"], *a, **kw)
    with mock.patch.object(jgraph.FilterGraph, "__init__", j_init), \
            mock.patch.object(graph.FilterGraph, "__init__", p_init):
        capsys.readouterr()
        run_pair(spec, batches_of(frames), valid_last=3)
    err = capsys.readouterr().err.strip().splitlines()
    assert built == ["jax", "port"]
    summary = [l for l in err if l.startswith(("PSNR", "SSIM"))]
    warn = [l for l in err if l.startswith("warning")]
    assert len(summary) == 2 and len(warn) == 2 and warn[0] == warn[1]
    _same_printed(summary[1], summary[0], 0.01 if name == "psnr" else 1e-4)
    got = open(stats["port"]).read().splitlines()
    want = open(stats["jax"]).read().splitlines()
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        _same_printed(g, w, 1e-4)


@pytest.mark.parametrize("spec,err", [
    ("psnr", "reference"), ("ssim=stats_file=x.log", "reference")])
def test_metric_option_errors_match_jax(spec, err):
    with pytest.raises(jbuiltin.FilterError, match=err) as want:
        jgraph.FilterGraph(spec)
    with pytest.raises(builtin.FilterError) as got:
        graph.FilterGraph(spec)
    assert str(got.value) == str(want.value)


def test_metric_rejects_10bit_main_as_jax(tmp_path):
    ref = str(tmp_path / "ref.y4m")
    write_second(ref, 2, 16, 16)
    frames = yuv_frames(np.random.default_rng(41), 2, 16, 16, 10)
    jfb, fb = _pair(frames, "yuv420p10")
    spec = f"psnr=video={ref}"
    with pytest.raises(jbuiltin.FilterError) as want:
        jgraph.FilterGraph(spec).process(jfb, pts=np.arange(2))
    with pytest.raises(builtin.FilterError) as got:
        graph.FilterGraph(spec).process(fb, pts=np.arange(2))
    assert str(got.value) == str(want.value)
