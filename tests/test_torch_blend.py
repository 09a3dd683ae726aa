"""The port's blend modes (ops/blend.py) and the blend/tblend filters
against the JAX package's on the same seeded inputs, on the CPU.

`blend_plane` runs every mode name (the 39 modes and the
addition128/difference128 aliases) at depths 8, 10 and 16 and on float32
planes, at opacity 1 and 0.5.  Bounds: 0 LSB at every integer depth —
the C integer semantics (int32 wrap of the 16-bit family, exclusion and
interpolate included; truncating division; the float->PIXEL store) are
the JAX module's, as tests/test_blend.py holds it to a C transcription
at 0.  Float32: bit-equal for every mode but geometric and
interpolate, whose f32 sqrt and cos may differ by an ulp between XLA
and PyTorch (rtol 1e-6).

The filters run through FilterGraph over 3 batches with an upstream
select drop, a dead tail and flush: per-component modes and opacities,
eof_action repeat/pass/endall against a short bottom Y4M, and cN_expr
evaluated per pixel on a tiny plane (0 LSB)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gmat_tpu.filters import builtin as jbuiltin, graph as jgraph
from gmat_tpu.ops import blend as jblend
from gmat_tpu_torch.av.rawvideo import Y4MWriter
from gmat_tpu_torch.filters import builtin, graph
from gmat_tpu_torch.ops import blend
from tests.test_torch_temporal import DROP, batches_of
from tests.test_torch_color import run_pair, yuv_frames

_NAMES = sorted(jblend.MODE_NAMES)
# float32 modes whose EXPR calls sqrt or cos: XLA's CPU sqrt and cos may
# differ from PyTorch's by an ulp
_LIBM_F32 = ("geometric", "interpolate")


def _planes(depth, seed=11, shape=(3, 17, 23)):
    """Seeded planes with the corner values of the depth (0, 1, half,
    max-1, max) in their first row, so every guarded branch runs."""
    rng = np.random.default_rng(seed)
    if depth == 32:
        a = rng.random(shape).astype(np.float32)
        b = rng.random(shape).astype(np.float32)
        edge = np.array([0.0, 1.0, 0.5, 0.25, 1.0, 0.0], np.float32)
    else:
        mx = (1 << depth) - 1
        dt = np.uint8 if depth == 8 else np.uint16
        a = rng.integers(0, mx + 1, shape).astype(dt)
        b = rng.integers(0, mx + 1, shape).astype(dt)
        edge = np.array([0, 1, mx >> 1, 1 << (depth - 1), mx - 1, mx], dt)
    k = len(edge)
    a[:, 0, :k] = edge
    b[:, 0, :k] = edge[::-1]
    a[:, 1, :k] = edge
    b[:, 1, :k] = edge
    return a, b


def test_mode_tables_match_jax():
    assert blend.MODE_NAMES == jblend.MODE_NAMES
    assert blend.MODE_ENUM == jblend.MODE_ENUM
    assert len(set(blend.MODE_NAMES.values())) == 40    # 39 + normal


@pytest.mark.parametrize("depth", [8, 10, 16, 32])
@pytest.mark.parametrize("mode", _NAMES)
def test_blend_plane_matches_jax(mode, depth):
    a, b = _planes(depth)
    dt = torch.float32 if depth == 32 else None
    for opacity in (1.0, 0.5):
        want = np.asarray(jblend.blend_plane(jnp.asarray(a), jnp.asarray(b),
                                             mode, opacity, depth))
        got = blend.blend_plane(torch.as_tensor(a), torch.as_tensor(b),
                                mode, opacity, depth)
        assert got.dtype == (dt or torch.as_tensor(a).dtype)
        got = got.numpy()
        if depth == 32 and blend.MODE_NAMES[mode] in _LIBM_F32:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{mode}@{opacity}")


@pytest.mark.parametrize("mode", ["exclusion", "interpolate", "heat",
                                  "divide", "screen", "harmonic",
                                  "geometric", "multiply128"])
def test_blend_plane_16bit_full_range_matches_jax(mode):
    """Every 16-bit code pair on a grid that crosses the int32 wrap of
    the C products (2*A*B, (MAX-B)^2, MAX*A): 0 LSB."""
    g = np.linspace(0, 65535, 257).astype(np.uint16)
    a, b = np.meshgrid(g, g, indexing="ij")
    want = np.asarray(jblend.blend_plane(jnp.asarray(a[None]),
                                         jnp.asarray(b[None]), mode, 1.0, 16))
    got = blend.blend_plane(torch.as_tensor(a[None]), torch.as_tensor(b[None]),
                            mode, 1.0, 16).numpy()
    np.testing.assert_array_equal(got, want)


def test_cosf_table_matches_jax():
    for depth in (8, 10, 16):
        np.testing.assert_array_equal(blend._cosf_lut(depth),
                                      jblend._cosf_lut(depth))


def test_trunc_store_bad_lanes():
    """NaN, +-inf and out-of-range floats store INT32_MIN's low bits (0),
    as the C's cvttss2si does; in-range values truncate toward zero."""
    f = torch.tensor([float("nan"), float("inf"), -float("inf"), 3e9,
                      -3e9, 2.9, -2.9, 70000.5])
    got = blend._trunc_store(f, 16, torch.int32).tolist()
    want = np.asarray(jblend._trunc_store(jnp.asarray(f.numpy()), 16,
                                          jnp.int32)).tolist()
    assert got == want == [0, 0, 0, 0, 0, 2, 65534, 4464]


# ------------------------------------------------------------- filters

def _bottom(path, n, h=48, w=64, seed=21):
    rng = np.random.default_rng(seed)
    wr = Y4MWriter(path, w, h, (30, 1))
    for _ in range(n):
        wr.write(rng.integers(0, 256, (h, w)).astype(np.uint8),
                 rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8),
                 rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8))
    wr.close()


_TBLEND = ["tblend=all_mode=difference", "tblend=addition:multiply:screen",
           "tblend=c0_mode=heat:c1_mode=divide:c2_mode=harmonic",
           "tblend=all_mode=interpolate:all_opacity=0.5",
           "tblend=c0_mode=exclusion:c0_opacity=0.3:c2_mode=7",
           "tblend=all_mode=softlight"]


@pytest.mark.parametrize("fmt", ["yuv420p", "yuv420p10", "yuv420p16"])
@pytest.mark.parametrize("spec", _TBLEND)
def test_tblend_matches_jax(spec, fmt):
    bits = {"yuv420p": 8, "yuv420p10": 10, "yuv420p16": 16}[fmt]
    frames = yuv_frames(np.random.default_rng(12), 13, 48, 64, bits)
    run_pair(DROP + spec, batches_of(frames), fmt=fmt, valid_last=3)


def test_tblend_float_rgb_matches_jax():
    """Float RGB maps c0/c1/c2 to G/B/R (GBRP order)."""
    rng = np.random.default_rng(13)
    planes = {"rgb": rng.random((9, 16, 24, 3)).astype(np.float32)}
    run_pair("tblend=c0_mode=multiply:c1_mode=screen:c2_mode=xor",
             batches_of(planes, (3, 3, 3)), fmt="rgbpf32")


@pytest.mark.parametrize("eof", ["repeat", "pass", "endall"])
@pytest.mark.parametrize("modes", ["all_mode=lighten",
                                   "c0_mode=heat:c1_mode=harmonic:"
                                   "c2_mode=interpolate:c0_opacity=0.6"])
def test_blend_second_input_matches_jax(tmp_path, eof, modes):
    """A 7-frame bottom Y4M under a 13-frame top: eof_action decides what
    the last frames get; the decoded bottom is conformed to yuv444p."""
    bot = str(tmp_path / "bottom.y4m")
    _bottom(bot, 7)
    frames = yuv_frames(np.random.default_rng(14), 13, 48, 64)
    run_pair(f"{DROP}blend={modes}:eof_action={eof}:video={bot}",
             batches_of(frames), valid_last=3)
    run_pair(f"format=yuv444p,blend={modes}:eof_action={eof}:"
             f"video={bot}", batches_of(frames), valid_last=3)


@pytest.mark.parametrize("spec", ["tblend=c0_expr=(A+B)/2",
                                  "tblend=all_expr=if(gt(X\\,Y)\\,A\\,B)"
                                  "*N+T*10",
                                  "tblend=c1_expr=A*SW-B*SH+W-H"])
def test_tblend_expr_matches_jax(spec):
    """Per-pixel expressions on a tiny plane (8 x 12, 4 frames)."""
    frames = yuv_frames(np.random.default_rng(15), 6, 8, 12)
    run_pair(spec, batches_of(frames, (3, 3)))


def test_blend_expr_second_input_matches_jax(tmp_path):
    bot = str(tmp_path / "bottom.y4m")
    _bottom(bot, 4, 8, 12)
    frames = yuv_frames(np.random.default_rng(16), 4, 8, 12)
    run_pair(f"blend=c0_expr=A-B*2:video={bot}", [frames])


@pytest.mark.parametrize("spec", ["blend=all_mode=zz:video=x.y4m",
                                  "blend=all_mode=multiply",
                                  "tblend=c0_opacity=2", "tblend=bogus=1",
                                  "tblend=video=x.y4m",
                                  "blend=eof_action=stop:video=x.y4m",
                                  "tblend=all_mode=99"])
def test_blend_option_errors_match_jax(spec):
    with pytest.raises(jbuiltin.FilterError) as want:
        jgraph.FilterGraph(spec)
    with pytest.raises(builtin.FilterError) as got:
        graph.FilterGraph(spec)
    assert str(got.value) == str(want.value)


def test_blend_size_and_format_errors_match_jax(tmp_path):
    """A bottom of another size and a packed RGB top raise as in JAX."""
    bot = str(tmp_path / "small.y4m")
    _bottom(bot, 2, 16, 16)
    frames = yuv_frames(np.random.default_rng(17), 2, 48, 64)
    from tests.test_torch_color import _pair
    for spec, planes, fmt in (
            (f"blend=video={bot}", frames, "yuv420p"),
            ("tblend", {"rgb": np.zeros((2, 8, 8, 3), np.uint8)}, "rgb24")):
        jfb, fb = _pair(planes, fmt)
        with pytest.raises(jbuiltin.FilterError) as want:
            jgraph.FilterGraph(spec).process(jfb, pts=np.arange(2))
        with pytest.raises(builtin.FilterError) as got:
            graph.FilterGraph(spec).process(fb, pts=np.arange(2))
        assert str(got.value) == str(want.value)
