"""The port's temporal and structural filters (filters/builtin part 3)
against the JAX package's on the same seeded inputs, on the CPU:
separatefields, weave, doubleweave, telecine, detelecine (every
start_frame phase of tests/test_telecine.py), il, shuffleframes,
reverse, tpad, loop, framerate and fade, and the telecine -> detelecine
round trip.

Every stream filter runs through FilterGraph over 3 batches with a dead
tail (`valid`), an upstream `select` drop and flush, with per-frame
interlace flags; planes, keep masks, pts, times, keys and fps_mul must
agree.  Bound: 0 LSB — every op here is integer (field and row moves,
frame gathers, the 16.16 fade, framerate's `(a*f1 + b*f2 + 64) >> 7`),
as the JAX tests' own bounds are (tests/test_telecine.py,
test_fields.py, test_shuffle.py, test_tpad.py, test_loop.py,
test_framerate.py, test_filters.py:627-690)."""
import numpy as np
import pytest

from gmat_tpu.filters import builtin as jbuiltin, graph as jgraph
from gmat_tpu_torch.filters import builtin, graph
from tests.test_torch_color import (_pair, _same_meta, run_pair,
                                   same_batch, yuv_frames)

# drops the stream's 4th frame before the filter under test
DROP = r"select=not(eq(n\,3)),"


def batches_of(frames, sizes=(4, 5, 4)):
    """Consecutive batches of the given sizes from a frame dict."""
    out, lo = [], 0
    for s in sizes:
        out.append({k: v[lo:lo + s] for k, v in frames.items()})
        lo += s
    return out


def _ilace(n, rng):
    """Per-frame interlace flags: bit0 interlaced, bit1 top field first."""
    return rng.integers(0, 4, n).astype(np.int64)


# (spec, formats it runs on): 8-bit and 10/16-bit planes
_STREAM = [
    "separatefields", "weave", "weave=bottom", "doubleweave",
    "doubleweave=first_field=b", "telecine", "telecine=bottom:2332",
    "telecine=first_field=top:pattern=3", "detelecine",
    "detelecine=first_field=bottom:pattern=23:start_frame=2",
    "detelecine=top:2332", "shuffleframes=2|0|1",
    "shuffleframes=mapping=1 -1 0", "reverse", "tpad=2:3",
    "tpad=start=1:stop=2:start_mode=clone:stop_mode=clone",
    "tpad=stop_duration=0.1:color=red", "tpad=start_duration=60ms:"
    "color=0x3366CC", "loop=2:3:1", "loop=loop=1:size=20:start=0",
    "loop=1:2:6", "framerate=24", "framerate=fps=60:interp_start=0:"
    "interp_end=255:scene=100", "framerate=15:flags=0",
    "fade=in:0:5", "fade=out:3:4", "fade=t=in:st=0.1:d=0.2",
    "fade=type=out:start_frame=2:nb_frames=3:color=red",
    "fade=in:2:3:color=white",
]
_FORMATS = ("yuv420p", "yuv420p10", "yuv420p16")
# framerate takes 8-bit planes only (both packages raise on the rest)
_EIGHT_BIT_ONLY = ("framerate",)


def _frames(fmt, n, seed=0, h=48, w=64):
    bits = {"yuv420p": 8, "yuv420p10": 10, "yuv420p16": 16}[fmt]
    return yuv_frames(np.random.default_rng(seed), n, h, w, bits)


@pytest.mark.parametrize("spec,fmt", [
    (spec, fmt) for spec in _STREAM for fmt in _FORMATS
    if fmt == "yuv420p" or not spec.startswith(_EIGHT_BIT_ONLY)])
def test_stream_filter_matches_jax(spec, fmt):
    """3 batches with interlace flags, an upstream select drop, a dead
    tail and flush (0 LSB)."""
    rng = np.random.default_rng(3)
    frames = _frames(fmt, 13, seed=1)
    run_pair(DROP + spec, batches_of(frames), fmt=fmt,
             ilace=_ilace(13, rng), valid_last=3)


@pytest.mark.parametrize("spec", ["separatefields", "weave", "telecine",
                                  "detelecine", "reverse", "tpad=2:2",
                                  "fade=in:1:3", "shuffleframes=1|0",
                                  "loop=1:3:0"])
def test_stream_filter_without_metadata_tracks(spec):
    """No times and no interlace track: pts still agree."""
    frames = _frames("yuv420p", 8)
    jg, g = jgraph.FilterGraph(spec), graph.FilterGraph(spec)
    for b in batches_of(frames, (4, 4)):
        jfb, fb = _pair(b, "yuv420p")
        pts = np.arange(b["y"].shape[0], dtype=np.int64)
        want, jkeep = jg.process(jfb, pts=pts)
        got, keep = g.process(fb, pts=pts)
        same_batch(got, want)
        np.testing.assert_array_equal(keep, jkeep)
        _same_meta(g.out_pts, jg.out_pts)
    for (got, keep, meta), (want, jkeep, jmeta) in zip(g.flush(),
                                                       jg.flush()):
        same_batch(got, want)
        _same_meta(meta.get("pts"), jmeta.get("pts"))


@pytest.mark.parametrize("pattern,start_frame", [
    ("23", 0), ("23", 1), ("23", 2), ("23", 3), ("23", 4), ("32", 1),
    ("2332", 0), ("2332", 3)])
def test_detelecine_phases_match_jax(pattern, start_frame):
    """Every start_frame phase of the 23 pattern (tests/test_telecine.py
    :218-275 covers 0 and 2) and the 32 and 2332 cases there, on a
    telecined stream."""
    frames = _frames("yuv420p", 16, seed=5)
    tel = run_pair("telecine", batches_of(frames, (5, 6, 5)))
    ys = [o[0].planes for o in tel if o[0].batch]
    import torch
    cat = {k: torch.cat([p[k] for p in ys]).numpy() for k in "yuv"}
    n = cat["y"].shape[0]
    run_pair(f"detelecine=pattern={pattern}:start_frame={start_frame}",
             batches_of(cat, (n // 3, n // 3, n - 2 * (n // 3))))


def test_telecine_detelecine_round_trip():
    """telecine -> detelecine gives back the progressive frames, as
    tests/test_telecine.py:238 checks; both packages agree on the way."""
    frames = _frames("yuv420p", 16, seed=2)
    outs = run_pair("telecine=first_field=top:pattern=23,"
                    "detelecine=first_field=top:pattern=23",
                    batches_of(frames, (6, 5, 5)))
    import torch
    got = torch.cat([o[0].planes["y"][torch.as_tensor(o[1])]
                     for o in outs if o[0].batch])
    assert got.shape[0] >= 12
    np.testing.assert_array_equal(got.numpy(), frames["y"][:got.shape[0]])


_IL = ["il=l=d:c=d", "il=luma_mode=interleave:chroma_mode=i:luma_swap=1",
       "il=none:none:none:1:1", "il=deinterleave:interleave"]


@pytest.mark.parametrize("fmt", _FORMATS + ("yuv444p", "gray8"))
@pytest.mark.parametrize("spec", _IL)
def test_il_matches_jax(spec, fmt):
    """il is a pure row gather: 0 LSB, odd chroma heights included."""
    rng = np.random.default_rng(4)
    if fmt in ("yuv444p", "gray8"):
        planes = {"y": rng.integers(0, 256, (3, 46, 64)).astype(np.uint8)}
        if fmt == "yuv444p":
            planes["u"] = rng.integers(0, 256, (3, 46, 64)).astype(np.uint8)
            planes["v"] = rng.integers(0, 256, (3, 46, 64)).astype(np.uint8)
    else:
        planes = _frames(fmt, 3, h=46)
    run_pair(spec, [planes], fmt=fmt)


@pytest.mark.parametrize("spec,fmt", [
    ("fade=in:0:4", "rgb24"), ("fade=out:1:3:color=0x204080", "rgba"),
    ("fade=in:0:3:alpha=1", "rgba"), ("fade=in:0:5", "yuv444p")])
def test_fade_packed_rgb_matches_jax(spec, fmt):
    rng = np.random.default_rng(6)
    if fmt == "yuv444p":
        planes = {k: rng.integers(0, 256, (6, 24, 32)).astype(np.uint8)
                  for k in "yuv"}
    else:
        ch = 4 if fmt == "rgba" else 3
        planes = {"rgb": rng.integers(0, 256, (6, 24, 32, ch))
                  .astype(np.uint8)}
    run_pair(spec, [planes], fmt=fmt)


def test_framerate_scene_cut_matches_jax():
    """A rate change that blends, across a scene cut: the luma SAD's
    int32 (JAX) and int64 (port) sums agree where 8-bit luma fits, and
    the scene score gates the blend the same way."""
    from tests.test_torch_graph import _yuv_frames
    frames = _yuv_frames(np.random.default_rng(8), 12, 48, 64, cut=6)
    outs = run_pair("framerate=fps=50:scene=8",
                    batches_of(frames, (4, 4, 4)))
    assert sum(int(k.sum()) for _, k, _ in outs) > 12


@pytest.mark.parametrize("spec,err", [
    ("tpad=stop=-1", "infinite"), ("loop=-1:2", "infinite"),
    ("telecine=pattern=0", "all-zero"), ("detelecine=start_frame=9",
                                         "too big"),
    ("shuffleframes=3|0", "out of"), ("weave=middle", "first_field"),
    ("fade=sideways", "in|out"), ("framerate=fps=0", "positive"),
    ("il=l=sideways", "luma_mode"), ("tpad=start_mode=mirror", "mode")])
def test_option_errors_match_jax(spec, err):
    with pytest.raises(jbuiltin.FilterError, match=err) as want:
        jgraph.FilterGraph(spec)
    with pytest.raises(builtin.FilterError) as got:
        graph.FilterGraph(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec,fmt", [("framerate=24", "yuv420p10"),
                                      ("fade=in", "rgbpf32"),
                                      ("separatefields", "yuv420p")])
def test_format_errors_match_jax(spec, fmt):
    """The filters raise where the JAX filters do, with the same text:
    framerate on 10-bit planes, fade on float RGB, separatefields on an
    odd height."""
    rng = np.random.default_rng(9)
    if fmt == "rgbpf32":
        planes = {"rgb": rng.random((2, 16, 16, 3)).astype(np.float32)}
    elif fmt == "yuv420p10":
        planes = _frames(fmt, 2, h=16, w=16)
    else:
        planes = {"y": np.zeros((2, 15, 16), np.uint8),
                  "u": np.zeros((2, 7, 8), np.uint8),
                  "v": np.zeros((2, 7, 8), np.uint8)}
    jfb, fb = _pair(planes, fmt)
    pts = np.arange(2, dtype=np.int64)
    with pytest.raises(jbuiltin.FilterError) as want:
        jgraph.FilterGraph(spec).process(jfb, pts=pts)
    with pytest.raises(builtin.FilterError) as got:
        graph.FilterGraph(spec).process(fb, pts=pts)
    assert str(got.value) == str(want.value)


def test_reverse_flushes_in_chunks_of_64():
    """reverse holds the stream and flushes it through the graph's list
    flush in chunks of 64 frames."""
    planes = _frames("yuv420p", 70, h=16, w=16)
    outs = run_pair("reverse", batches_of(planes, (32, 32, 6)))
    sizes = [o[0].batch for o in outs if o[0].batch]
    assert sizes == [64, 6]
