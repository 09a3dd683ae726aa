"""The port's numpy tables equal the JAX package's: formats, colour
matrices, resample/smooth matrices and the ladder's host-side matrices."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gmat_tpu.core import color as jcolor, formats as jformats
from gmat_tpu.core import frame as jframe
from gmat_tpu.ops import pallas_kernels as jpk, resize as jresize
from gmat_tpu.ops import smooth as jsmooth
from gmat_tpu_torch.core import color, formats, frame
from gmat_tpu_torch.ops import ladder, resize, smooth

METHODS = ("nearest", "bilinear", "bicubic", "area", "lanczos3")


@pytest.mark.parametrize("name", sorted(jformats.FORMATS))
def test_format_entry_equal(name):
    got, want = formats.get(name), jformats.get(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for h, w in ((1080, 1920), (64, 128), (6, 10)):
        for p in want.planes:
            assert got.plane_shape(p.name, h, w) == want.plane_shape(p.name,
                                                                     h, w)
    assert formats.max_value(got) == jformats.max_value(want)
    assert formats.clip_value(got) == jformats.clip_value(want)
    assert (got.is_yuv, got.is_rgb, got.is_float, got.planar_rgb) == (
        want.is_yuv, want.is_rgb, want.is_float, want.planar_rgb)


def test_format_registry_same_names():
    assert sorted(formats.FORMATS) == sorted(jformats.FORMATS)
    with pytest.raises(ValueError):
        formats.get("nope")


@pytest.mark.parametrize("cs", jcolor.COLORSPACES)
def test_colorspace_tables_equal(cs):
    np.testing.assert_array_equal(color.yuv2rgb_matrix(cs),
                                  jcolor.yuv2rgb_matrix(cs))
    np.testing.assert_array_equal(color.rgb2yuv_matrix(cs),
                                  jcolor.rgb2yuv_matrix(cs))
    for bits in (8, 10, 12, 16):
        assert color.yuv_offsets(bits) == jcolor.yuv_offsets(bits)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n_in,n_out", [(1080, 224), (64, 32), (32, 96),
                                        (540, 224), (7, 7)])
def test_resample_matrix_equal(method, n_in, n_out):
    np.testing.assert_array_equal(resize.resample_matrix(n_in, n_out, method),
                                  jresize.resample_matrix(n_in, n_out, method))
    np.testing.assert_array_equal(
        resize.resample_matrix(n_in, n_out, method, True),
        jresize.resample_matrix(n_in, n_out, method, True))
    if method in resize._TAPS:
        for a, b in zip(resize._window_taps(n_in, n_out, method),
                        jresize._window_taps(n_in, n_out, method)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("border", smooth.BORDERS)
def test_smooth_matrix_equal(border):
    for n, k, s in ((40, 3, 0.0), (32, 5, 1.3), (17, 7, 0.0), (12, 9, 2.0)):
        np.testing.assert_array_equal(smooth.smooth_matrix(n, k, s, border),
                                      jsmooth.smooth_matrix(n, k, s, border))
        np.testing.assert_array_equal(smooth.gaussian_kernel1d(k, s),
                                      jsmooth.gaussian_kernel1d(k, s))


_GEOMS = [
    (64, 128, 32, 64, 32, 32, "bilinear", None, None, None),
    (64, 128, 32, 64, 24, 32, "bilinear", (16, 8, 64, 48), None, None),
    (64, 128, 32, 64, 32, 48, "bilinear", None,
     (3, 5, 0.0, 1.2, "reflect"), -1),
    (64, 128, 32, 64, 32, 32, "nearest", (16, 8, 64, 48),
     (3, 3, 0.0, 0.0, "replicate"), 1),
    (96, 160, 48, 80, 32, 48, "lanczos3", None, None, 0),
    (64, 64, 64, 64, 32, 32, "bicubic", (0, 16, 32, 32), None, None),
    (1080, 1920, 540, 960, 224, 224, "bilinear", None, None, None),
]


@pytest.mark.parametrize("geom", _GEOMS, ids=lambda g: f"{g[6]}-{g[7]}-{g[9]}")
def test_ladder_matrices_equal(geom):
    for a, b in zip(ladder._i8_matrices(*geom), jpk._i8_matrices(*geom)):
        np.testing.assert_array_equal(a, b)
    assert ladder._i8_ok_composed(*geom) == jpk._i8_ok_composed(*geom)
    for a, b in zip(ladder._i8_matrices(*geom)[:2],
                    jpk._i8_matrices(*geom)[:2]):
        qa, sa = ladder._quant_rows(a)
        qb, sb = jpk._quant_rows(b)
        np.testing.assert_array_equal(qa, qb)
        assert sa == sb
        assert ladder._i8_quant_error_lsb(a) == jpk._i8_quant_error_lsb(b)


def _from_band(lo, n, packed, width):
    dense = np.zeros((len(lo), width), packed.dtype)
    for r in range(len(lo)):
        dense[r, lo[r]:lo[r] + n[r]] = packed[r, :n[r]]
    return dense


@pytest.mark.parametrize("kind", ["i8", "bf16"])
@pytest.mark.parametrize("geom", _GEOMS[:6],
                         ids=lambda g: f"{g[6]}-{g[7]}-{g[9]}")
def test_kernel_band_operands_hold_every_weight(kind, geom):
    """The band form the kernels read rebuilds each dense matrix the
    plain versions read, exactly, and holds the bf16/int8 values."""
    m = ladder._ladder_matrices(kind, geom)
    ops = ladder._kernel_operands(kind, geom, "cpu")
    for band, dense in (("row_y", m["ahy"]), ("col_y", m["awy"].T),
                        ("row_c", m["ahc"]), ("col_c", m["awc"].T)):
        lo, n, packed = ops[band]
        assert lo.dtype == n.dtype == torch.int32
        want = torch.int8 if (kind == "i8" and band.startswith("row")) \
            else torch.bfloat16
        assert packed.dtype == want
        np.testing.assert_array_equal(
            _from_band(lo.numpy(), n.numpy(), packed.float().numpy(),
                       dense.shape[1]), dense.astype(np.float32))
        assert (n.numpy() <= packed.shape[1]).all()


def test_ladder_i8_operands_match_builder():
    geom = _GEOMS[0]
    m = ladder._ladder_matrices("i8", geom)
    ahy_q, sy = jpk._quant_rows(jpk._i8_matrices(*geom)[0])
    offy = (128.0 * ahy_q.astype(np.float32).sum(1) / sy)
    np.testing.assert_array_equal(m["offy"], offy)
    assert m["inv_sy"] == float(np.float32(1.0 / sy))
    awy = np.asarray(jnp.asarray(jpk._i8_matrices(*geom)[2], jnp.bfloat16),
                     np.float32)
    np.testing.assert_array_equal(m["awy"], awy)


def test_framebatch_validate_and_nv12_roundtrip(rng):
    y = rng.integers(0, 256, (2, 8, 12)).astype(np.uint8)
    u = rng.integers(0, 256, (2, 4, 6)).astype(np.uint8)
    v = rng.integers(0, 256, (2, 4, 6)).astype(np.uint8)
    fb = frame.from_numpy_yuv420(y, u, v, device="cpu")
    assert fb.batch == 2 and fb.device.type == "cpu"
    wire = frame.pack_nv12(fb)
    jfb = jframe.from_numpy_yuv420(y, u, v)
    np.testing.assert_array_equal(wire.numpy(),
                                  np.asarray(jframe.pack_nv12(jfb)))
    back = frame.unpack_nv12(wire, 8, 12)
    for k in "yuv":
        np.testing.assert_array_equal(back.planes[k].numpy(),
                                      fb.planes[k].numpy())
    with pytest.raises(ValueError, match="shape"):
        frame.FrameBatch.from_numpy({"y": y, "u": u, "v": v[:, :2]},
                                    "yuv420p", 12, 8, device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        frame.FrameBatch.from_numpy(
            {"y": y.astype(np.uint16), "u": u, "v": v}, "yuv420p", 12, 8,
            device="cpu")
    fb10 = frame.FrameBatch.from_numpy(
        {k: a.astype(np.uint16) for k, a in zip("yuv", (y, u, v))},
        "yuv420p10", 12, 8, device="cpu")
    assert fb10.planes["y"].dtype == torch.uint16
