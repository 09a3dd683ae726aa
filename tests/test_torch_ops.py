"""The port's separate-op path against the JAX package on the same inputs:
resize, crop, flip, gaussian and median smooth, YUV->RGB, preprocess
on RGB input and preprocess_nchw with use_kernel="never" / exact=True."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gmat_tpu.core.frame import FrameBatch as JFrameBatch
from gmat_tpu.ops import csc as jcsc, fused as jfused, geometry as jgeom
from gmat_tpu.ops import resize as jresize, smooth as jsmooth
from gmat_tpu_torch.core.frame import FrameBatch
from gmat_tpu_torch.ops import csc, fused, geometry, resize, smooth


def _pair(planes, fmt, w, h, cs="bt709"):
    """The same numpy planes as a JAX batch and a CPU port batch."""
    jfb = JFrameBatch({k: jnp.asarray(v) for k, v in planes.items()}, fmt, w,
                      h, cs)
    return jfb, FrameBatch.from_numpy(planes, fmt, w, h, cs, device="cpu")


def _yuv(rng, fmt, n=2, h=64, w=128):
    from gmat_tpu_torch.core import formats
    f = formats.get(fmt)
    dt = np.dtype(f.planes[0].dtype)
    hi = (1 << f.bits) if dt == np.uint16 else 256
    planes = {p.name: rng.integers(0, hi, (n,) + f.plane_shape(p.name, h, w))
              .astype(dt) for p in f.planes}
    return _pair(planes, fmt, w, h)


@pytest.mark.parametrize("method", ["nearest", "bilinear", "bicubic", "area",
                                    "lanczos3"])
@pytest.mark.parametrize("shape", [(2, 64, 128), (1, 30, 50, 3)],
                         ids=["plane", "rgb"])
def test_resize_plane_matches_jax(rng, method, shape):
    x = rng.integers(0, 256, shape).astype(np.uint8)
    for oh, ow in ((32, 32), (45, 70)):
        for aa in (False, True):
            want = np.asarray(jresize.resize_plane(jnp.asarray(x), oh, ow,
                                                   method, aa))
            got = resize.resize_plane(torch.from_numpy(x), oh, ow, method,
                                      aa).numpy()
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("fmt", ["yuv420p", "yuv420p10", "yuv444p"])
def test_resize_framebatch_matches_jax(rng, fmt):
    jfb, fb = _yuv(rng, fmt)
    for method in ("bilinear", "lanczos3"):
        want = jresize.resize(jfb, 48, 32, method)
        got = resize.resize(fb, 48, 32, method)
        assert (got.width, got.height) == (48, 32)
        for k in want.planes:
            a = got.planes[k].to(torch.int32).numpy()
            b = np.asarray(want.planes[k]).astype(np.int32)
            # f32 sums in another order can cross a .5 rounding edge
            assert np.abs(a - b).max() <= 1


def test_f32_matmul_refuses_reduced_precision():
    a = torch.ones(2, 2)
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="float32"):
            resize.f32_matmul(a, a)
    finally:
        torch.set_float32_matmul_precision("highest")
    assert resize.f32_matmul(a, a).sum() == 8


@pytest.mark.parametrize("fmt", ["yuv420p", "yuv420p10", "yuv444p"])
def test_crop_matches_jax(rng, fmt):
    jfb, fb = _yuv(rng, fmt)
    for args in ((32, 16, 8, 4), (64, 48, -1, -1)):
        want = jgeom.crop(jfb, *args)
        got = geometry.crop(fb, *args)
        assert (got.width, got.height) == (want.width, want.height)
        for k in want.planes:
            np.testing.assert_array_equal(got.planes[k].numpy(),
                                          np.asarray(want.planes[k]))
    if fmt != "yuv444p":      # odd sizes are legal without subsampling
        with pytest.raises(ValueError):
            geometry.crop(fb, 31, 16, 8, 4)
    with pytest.raises(ValueError):
        geometry.crop(fb, 64, 64, 100, 0)


@pytest.mark.parametrize("fmt", ["yuv420p", "yuv420p10"])
@pytest.mark.parametrize("code", [0, 1, -1])
def test_flip_matches_jax(rng, fmt, code):
    # yuv420p10 is uint16: torch has no CPU uint16 flip kernel
    jfb, fb = _yuv(rng, fmt)
    want = jgeom.flip(jfb, code)
    got = geometry.flip(fb, code)
    for k in want.planes:
        assert got.planes[k].dtype == fb.planes[k].dtype
        np.testing.assert_array_equal(got.planes[k].numpy(),
                                      np.asarray(want.planes[k]))


def test_flip_rejects_unknown_code(rng):
    _, fb = _yuv(rng, "yuv420p")
    with pytest.raises(ValueError):
        geometry.flip(fb, 2)


@pytest.mark.parametrize("border", ["reflect", "reflect101", "replicate",
                                    "wrap", "constant"])
def test_gaussian_blur_matches_jax(rng, border):
    x = rng.uniform(0, 255, (2, 9, 12)).astype(np.float32)
    for kw, kh, sx, sy in ((3, 5, 0.0, 1.2), (7, 3, 2.0, 0.0),
                           (1, 11, 0.0, 3.0)):
        want = np.asarray(jsmooth.gaussian_blur_plane(
            jnp.asarray(x), kw, kh, sx, sy, border))
        got = smooth.gaussian_blur_plane(torch.from_numpy(x), kw, kh, sx, sy,
                                         border).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("fmt", ["yuv420p", "yuv420p10"])
def test_smooth_op_matches_jax(rng, fmt):
    jfb, fb = _yuv(rng, fmt)
    want = jsmooth.smooth(jfb, "gaussian", 5, 3, "reflect", 1.1, 0.0)
    got = smooth.smooth(fb, "gaussian", 5, 3, "reflect", 1.1, 0.0)
    for k in want.planes:
        d = np.abs(got.planes[k].to(torch.int32).numpy()
                   - np.asarray(want.planes[k]).astype(np.int32))
        assert d.max() <= 1
    with pytest.raises(ValueError, match="odd"):
        smooth.smooth(fb, "gaussian", 4, 3)
    # the median is an integer op: equal to the JAX one
    want = jsmooth.smooth(jfb, "median", 3, 5)
    got = smooth.smooth(fb, "median", 3, 5)
    for k in want.planes:
        np.testing.assert_array_equal(got.planes[k].numpy(),
                                      np.asarray(want.planes[k]))


@pytest.mark.parametrize("fmt,out", [("yuv420p", "rgb24"),
                                     ("yuv420p", "rgbpf32"),
                                     ("yuv420p10", "rgb48"),
                                     ("yuv420p10", "bgrpf32"),
                                     ("yuv444p", "bgra"), ("p010", "rgba64")])
@pytest.mark.parametrize("exact", [False, True])
def test_yuv_to_rgb_matches_jax(rng, fmt, out, exact):
    jfb, fb = _yuv(rng, fmt, n=1, h=16, w=24)
    want = np.asarray(jcsc.yuv_to_rgb(jfb, out, exact=exact).planes["rgb"])
    got = csc.yuv_to_rgb(fb, out, exact=exact).planes["rgb"].numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if want.dtype == np.float32:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    else:
        np.testing.assert_array_equal(got, want)


_NEVER_CASES = [
    ("yuv420p", {}),
    ("nv12", {"method": "nearest"}),
    ("yuv420p10", {"method": "bicubic"}),
    ("yuv444p", {"method": "area", "shift": (127.5, 127.5, 127.5)}),
    ("yuv422p", {"method": "lanczos3"}),
    ("gray8", {}),
    ("yuv420p", {"crop_box": (16, 8, 64, 48),
                 "smooth": (3, 3, 0.0, 0.0, "constant"), "flip_code": -1}),
    ("yuv420p", {"exact": True}),
    ("yuv420p10", {"exact": True, "flip_code": 1}),
]


@pytest.mark.parametrize("fmt,kw", _NEVER_CASES,
                         ids=[f"{f}-{i}" for i, (f, _) in
                              enumerate(_NEVER_CASES)])
def test_preprocess_nchw_never_matches_jax(rng, fmt, kw):
    jfb, fb = _yuv(rng, fmt)
    want = np.asarray(jfused.preprocess_nchw(jfb, 40, 24, use_pallas="never",
                                             **kw))
    got = fused.preprocess_nchw(fb, 40, 24, use_kernel="never", **kw).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    d = np.abs(got - want) * 255.0
    # _pack_rgb rounds, so an f32 sum in another order can cross .5
    assert d.max() <= 1.0 + 1e-3 and d.mean() < 0.01


@pytest.mark.parametrize("out", ["rgbpf32", "rgb24", "yuv420p"])
def test_preprocess_rgb_input_matches_jax(rng, out):
    """RGB input to preprocess: crop, resize, smooth, flip, then convert,
    as gmat_tpu/ops/fused.preprocess does it."""
    rgb = rng.integers(0, 256, (1, 32, 48, 3)).astype(np.uint8)
    jfb, fb = _pair({"rgb": rgb}, "rgb24", 48, 32)
    kw = dict(method="bilinear", smooth=(3, 3, 0.0, 0.0, "reflect"),
              flip_code=1, crop_box=(8, 4, 32, 24))
    if out == "rgbpf32":
        kw.update(norm=127.5, shift=(127.5, 127.5, 127.5))
    want = jfused.preprocess(jfb, 20, 12, out, **kw)
    got = fused.preprocess(fb, 20, 12, out, **kw)
    assert (got.format, got.width, got.height) == (out, 20, 12)
    for k, w in want.planes.items():
        a, b = got.planes[k].numpy(), np.asarray(w)
        assert a.dtype == b.dtype and a.shape == b.shape
        if b.dtype == np.float32:
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
        else:     # f32 resample sums in another order: 1 LSB
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
