"""The port's overlay (ops/overlay, the `overlay` / `overlay_cuda`
filter) and host JPEG helpers (av/jpeg) against the JAX package's, on
the CPU.

Bounds: ops/overlay 0 LSB against the JAX op run op by op
(`jax.disable_jit`); 1 LSB against the jitted op, where XLA contracts
a*o + (1-a)*m into a fused multiply-add on the CPU (only a fractional
alpha can move a sample).  The filter through FilterGraph over three
batches and flush (`run_pair`): 0 LSB, keep masks and pts equal, for a
`video=` Y4M or .mp4 second input (expressions, a slide-in from a
negative odd x, every eof_action and shortest, a select upstream),
`path=` .jpg and
.png stills (the .png with a graded alpha: 1 LSB, the jitted blend) on
YUV and RGB mains."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmat_tpu.av import jpeg as jjpeg
from gmat_tpu.filters import builtin as jbuiltin
from gmat_tpu.ops import overlay as jov
from gmat_tpu_torch.av import jpeg, rawvideo
from gmat_tpu_torch.filters import builtin
from gmat_tpu_torch.ops import overlay as ov
from gmat_tpu_torch.utils import png
from tests.test_torch_color import run_pair, three_batches, yuv_frames

H, W = 24, 32


def _rand(rng, shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


# ------------------------------------------------------------ ops/overlay

# per-frame (x, y): inside, overhanging every side, negative odd (slide-in)
# and fully off-canvas
_XS = [3, -5, 25, -20, 0, 40]
_YS = [7, -3, 20, -9, 17, 0]


def _yuv_case(rng, n, oh, ow):
    main = {"y": _rand(rng, (n, H, W)), "u": _rand(rng, (n, H // 2, W // 2)),
            "v": _rand(rng, (n, H // 2, W // 2))}
    over = {"y": _rand(rng, (n, oh, ow)),
            "u": _rand(rng, (n, oh // 2, ow // 2)),
            "v": _rand(rng, (n, oh // 2, ow // 2))}
    return main, over


@pytest.mark.parametrize("alpha", [False, True], ids=["opaque", "alpha"])
def test_overlay_yuv420_matches_jax(alpha):
    rng = np.random.default_rng(1)
    n = len(_XS)
    main, over = _yuv_case(rng, n, 10, 14)
    a = _rand(rng, (n, 10, 14)) if alpha else None
    xs, ys = np.asarray(_XS, np.int32), np.asarray(_YS, np.int32)
    args = ({k: jnp.asarray(v) for k, v in main.items()},
            {k: jnp.asarray(v) for k, v in over.items()},
            None if a is None else jnp.asarray(a), jnp.asarray(xs),
            jnp.asarray(ys))
    with jax.disable_jit():
        eager = jov.overlay_yuv420(*args)
    jitted = jov.overlay_yuv420(*args)
    got = ov.overlay_yuv420({k: torch.as_tensor(v) for k, v in main.items()},
                            {k: torch.as_tensor(v) for k, v in over.items()},
                            None if a is None else torch.as_tensor(a),
                            xs, ys)
    for k in "yuv":
        g = got[k].numpy().astype(np.int64)
        assert got[k].dtype == torch.uint8
        np.testing.assert_array_equal(g, np.asarray(eager[k]))
        assert np.abs(g - np.asarray(jitted[k])).max() <= 1


@pytest.mark.parametrize("chans,alpha", [(3, False), (4, True), (4, False)],
                         ids=["rgb24", "rgba_alpha", "rgba"])
def test_overlay_rgb_matches_jax(chans, alpha):
    rng = np.random.default_rng(2)
    n = len(_XS)
    main = _rand(rng, (n, H, W, chans))
    over = _rand(rng, (n, 9, 11, 3))
    a = _rand(rng, (n, 9, 11)) if alpha else None
    with jax.disable_jit():
        want = jov.overlay_rgb(jnp.asarray(main), jnp.asarray(over),
                               None if a is None else jnp.asarray(a),
                               jnp.asarray(_XS), jnp.asarray(_YS))
    got = ov.overlay_rgb(torch.as_tensor(main), torch.as_tensor(over),
                         None if a is None else torch.as_tensor(a), _XS, _YS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if chans == 4:                      # the main alpha channel is kept
        np.testing.assert_array_equal(got[..., 3].numpy(), main[..., 3])


def test_overlay_positions_take_any_form():
    rng = np.random.default_rng(3)
    main, over = _yuv_case(rng, 2, 4, 4)
    m = {k: torch.as_tensor(v) for k, v in main.items()}
    o = {k: torch.as_tensor(v) for k, v in over.items()}
    a = ov.overlay_yuv420(m, o, None, 5, -3)
    b = ov.overlay_yuv420(m, o, None, torch.tensor([5, 5]), [-3, -3])
    for k in "yuv":
        assert torch.equal(a[k], b[k])
    # x normalized even, chroma at C-truncated halves: y=-3 -> -1
    np.testing.assert_array_equal(a["y"][0, 0, 4:8].numpy(),
                                  over["y"][0, 3])
    np.testing.assert_array_equal(a["u"][0, 0, 2:4].numpy(),
                                  over["u"][0, 1])


# ------------------------------------------------------------- the filter

def _write_y4m(path, planes):
    n, h, w = planes["y"].shape
    wr = rawvideo.Y4MWriter(path, w, h, (30, 1))
    for i in range(n):
        wr.write(planes["y"][i], planes["u"][i], planes["v"][i])
    wr.close()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Seeded main frames, a 7-frame 10x14 overlay Y4M and its libx264
    .mp4 (the container path: an alpha-aware decode), a .jpg and a .png
    (graded alpha) still."""
    from gmat_tpu_torch.av import toolkit as tk
    d = tmp_path_factory.mktemp("overlay")
    rng = np.random.default_rng(4)
    ov_frames = yuv_frames(rng, 7, 10, 14)
    video = str(d / "over.y4m")
    _write_y4m(video, ov_frames)
    mp4 = str(d / "over.mp4")
    enc = tk.Encoder("libx264", 14, 10, fps=(30, 1), gop=4,
                     preset="veryfast", crf=18.0)
    pkts = []
    for i in range(7):
        pkts += enc.encode(*(ov_frames[k][i] for k in "yuv"), pts=i)
    pkts += enc.flush()
    mux = tk.Muxer(mp4, 14, 10, (30, 1), tk.CODEC_H264, enc.extradata())
    for p in pkts:
        mux.write(p)
    mux.close()
    enc.close()
    still = _rand(rng, (12, 18, 3))
    jpg = str(d / "still.jpg")
    with open(jpg, "wb") as f:
        f.write(jpeg.encode_rgb_to_jpeg(still))
    rgba = np.concatenate([_rand(rng, (10, 16, 3)),
                           np.repeat(np.linspace(0, 255, 16)[None, :, None],
                                     10, 0).astype(np.uint8)], -1)
    rgba[:3, :, 3] = 255
    pngp = str(d / "wm.png")
    png.write_png(pngp, rgba)
    return {"main": yuv_frames(rng, 12, H, W), "video": video, "mp4": mp4,
            "jpg": jpg, "png": pngp}


# spec with {video}/{mp4}/{jpg}/{png}, u8 bound
_SPECS = {
    "video_static": ("overlay=video={video}:x=4:y=2", 0),
    "video_expr": ("overlay=video={video}:x=n*3-7:y=main_h-overlay_h-n", 0),
    "video_slide_in_odd": ("overlay=video={video}:x=-9+2*n:y=-3", 0),
    "video_time_expr": ("overlay=video={video}:x=t*60:y=mod(n\\,5)", 0),
    "eof_repeat": ("overlay=video={video}:x=1:y=1:eof_action=repeat", 0),
    "eof_pass": ("overlay=video={video}:x=1:y=1:eof_action=pass", 0),
    "eof_endall": ("overlay=video={video}:x=1:y=1:eof_action=endall", 0),
    "shortest": ("overlay=video={video}:shortest=1", 0),
    "overlay_cuda": ("overlay_cuda=video={video}:x=6:y=4", 0),
    "video_mp4": ("overlay=video={mp4}:x=3:y=-4:eof_action=pass", 0),
    "select_upstream": ("select=not(eq(n\\,2)),overlay=video={video}:"
                        "x=n*2:y=1", 0),
    "rgb_main_video": ("format=rgb24,overlay=video={video}:x=5:y=3", 0),
    "rgba_main_video": ("format=rgba,overlay=video={video}:x=-2:y=9", 0),
    "jpg_yuv": ("overlay=path={jpg}:x=7:y=5", 0),
    "jpg_rgb": ("format=rgb24,overlay=path={jpg}:x=-3:y=14", 0),
    "png_alpha_yuv": ("overlay=path={png}:x=2:y=3", 1),
    "png_alpha_rgb": ("format=rgb24,overlay=path={png}:x=n:y=2", 1),
}


@pytest.mark.parametrize("case", sorted(_SPECS))
def test_overlay_filter_matches_jax(case, inputs):
    spec, lsb = _SPECS[case]
    run_pair(spec.format(**inputs), three_batches(inputs["main"]), lsb=lsb)


def test_overlay_errors_match_jax(inputs):
    for kw in ({}, {"path": "a.jpg", "video": "b.y4m"},
               {"video": "x.y4m", "eof_action": "bogus"}):
        with pytest.raises(jbuiltin.FilterError) as want:
            jbuiltin.OverlayFilter(**kw)
        with pytest.raises(builtin.FilterError) as got:
            builtin.OverlayFilter(**kw)
        assert str(got.value) == str(want.value)
    from gmat_tpu_torch.filters.graph import FilterGraph
    from gmat_tpu_torch.core.frame import FrameBatch
    g = FilterGraph(f"format=yuv444p,overlay=video={inputs['video']}")
    fb = FrameBatch.from_numpy({k: v[:2] for k, v in inputs["main"].items()},
                               "yuv420p", W, H, device="cpu")
    with pytest.raises(builtin.FilterError, match="unsupported"):
        g.process(fb)


# ----------------------------------------------------------- av/jpeg

def test_host_jpeg_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    rgb = _rand(rng, (20, 30, 3))
    for a, b in zip(jpeg._rgb_to_yuvj420(rgb), jjpeg._rgb_to_yuvj420(rgb)):
        np.testing.assert_array_equal(a, b)
    y, u, v = jjpeg._rgb_to_yuvj420(rgb)
    np.testing.assert_array_equal(jpeg._yuvj420_to_rgb(y[:19, :29], u, v),
                                  jjpeg._yuvj420_to_rgb(y[:19, :29], u, v))
    data = jpeg.encode_rgb_to_jpeg(rgb[:19, :29], quality=4)
    assert data == jjpeg.encode_rgb_to_jpeg(rgb[:19, :29], quality=4)
    for d, jd in zip(jpeg.decode_jpeg_bytes(data),
                     jjpeg.decode_jpeg_bytes(data)):
        np.testing.assert_array_equal(d, jd)
    p = tmp_path / "x.jpg"
    p.write_bytes(data)
    np.testing.assert_array_equal(jpeg.decode_jpeg_to_rgb(str(p)),
                                  jjpeg.decode_jpeg_to_rgb(data))
