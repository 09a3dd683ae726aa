"""The rung kernels' plain PyTorch versions against the Pallas rung kernels
(interpret mode), on the same inputs; their operands and int8 gate against
the JAX builders'; the wrapper's validation and dispatch.

Bounds (u8 LSBs, on rounded u8 outputs): the plain versions round the
same f32 values the Pallas kernels do, but a sum in another order can
land a value on the other side of a .5 or of a bf16 rounding step: 1.
Against the exact per-plane resize: 3 for the int8 row stage, 1 for bf16
(the bounds of test_pallas.py:268-294)."""
import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gmat_tpu.ops import pallas_kernels as jpk
from gmat_tpu.ops import resize as jresize
from gmat_tpu_torch.ops import ladder, rungs
from gmat_tpu_torch.ops.resize import resample_matrix, resize_plane

PLAIN_LSB = 1
EXACT_LSB = {"i8": 3, "bf16": 1}
SIZES = ((96, 48), (64, 32), (32, 16))


def _data(rng, n=2, h=64, w=128):
    return (rng.integers(0, 256, (n, h, w)).astype(np.uint8),
            rng.integers(0, 256, (n, h // 2, w // 2)).astype(np.uint8),
            rng.integers(0, 256, (n, h // 2, w // 2)).astype(np.uint8))


def _port(planes, sizes, **kw):
    before = dict(rungs.LAUNCHES)
    outs = rungs.fused_rungs(*(torch.from_numpy(p) for p in planes), sizes,
                             **kw)
    assert rungs.LAUNCHES == before      # CPU tensors: plain version
    return [tuple(p.numpy() for p in r) for r in outs]


def _compare(got, want, sizes, n):
    """Largest difference and the count of differing samples, after
    checking every rung's shapes and dtypes."""
    worst, differ = 0, 0
    for (ow, oh), g, w in zip(sizes, got, want):
        for gp, wp, shape in zip(g, w, ((n, oh, ow), (n, oh // 2, ow // 2),
                                        (n, oh // 2, ow // 2))):
            wp = np.asarray(wp)
            assert gp.shape == wp.shape == shape
            assert gp.dtype == wp.dtype == np.uint8
            d = np.abs(gp.astype(int) - wp.astype(int))
            worst, differ = max(worst, int(d.max())), differ + int((d > 0).sum())
    return worst, differ


@pytest.mark.parametrize("quant", ["i8", "bf16"])
def test_plain_matches_pallas(rng, quant):
    planes = _data(rng)
    want = jpk.fused_rungs(*(jnp.asarray(p) for p in planes), SIZES,
                           interpret=True, quant=quant)
    got = _port(planes, SIZES, quant=quant)
    worst, differ = _compare(got, want, SIZES, 2)
    assert worst <= PLAIN_LSB, f"{quant}: {worst} LSB, {differ} samples differ"


def test_plain_matches_chunked_pallas(rng):
    """The port sends 4K-class widths to the same kernel; hold it against
    the TPU's column-chunked rung kernel (K5, 2 chunks), the geometry of
    test_pallas.py:372-387."""
    n, h, w = 2, 64, 512
    sizes = ((256, 32), (128, 16))
    planes = _data(rng, n, h, w)
    fn = jpk._build_rungs_i8_chunked(n, h, w, h // 2, w // 2, sizes,
                                     "bilinear", True, 2)
    want = fn(*(jnp.asarray(p) for p in planes))
    got = _port(planes, sizes, quant="i8")
    worst, differ = _compare(got, want, sizes, n)
    assert worst <= PLAIN_LSB, f"{worst} LSB, {differ} samples differ"


@pytest.mark.parametrize("quant", ["i8", "bf16"])
def test_plain_within_bound_of_exact_resize(rng, quant):
    planes = _data(rng)
    got = _port(planes, SIZES, quant=quant)
    for (ow, oh), outs in zip(SIZES, got):
        for out, src, (th, tw) in zip(outs, planes,
                                      ((oh, ow), (oh // 2, ow // 2),
                                       (oh // 2, ow // 2))):
            ref = torch.clamp(torch.round(resize_plane(
                torch.from_numpy(src), th, tw, "bilinear")), 0, 255)
            d = np.abs(out.astype(int) - ref.numpy().astype(int)).max()
            assert d <= EXACT_LSB[quant], (quant, (ow, oh), d)


def test_nearest_matches_pallas(rng):
    planes = _data(rng, 1, 48, 96)
    sizes = ((32, 24), (64, 16))
    want = jpk.fused_rungs(*(jnp.asarray(p) for p in planes), sizes,
                           method="nearest", interpret=True)
    got = _port(planes, sizes, method="nearest")
    assert _compare(got, want, sizes, 1)[0] == 0


@pytest.mark.parametrize("sizes,kw,match", [
    ([(33, 16)], {}, "even"),
    ([(32, 15)], {}, "even"),
    ([(32, 16)], {"method": "lanczos3"}, "method"),
    ([(32, 16)], {"quant": "fp8"}, "quant"),
])
def test_validation_raises(rng, sizes, kw, match):
    planes = _data(rng, 1, 32, 64)
    with pytest.raises(ValueError, match=match):
        rungs.fused_rungs(*(torch.from_numpy(p) for p in planes), sizes, **kw)
    # the JAX entry refuses the same input with the same message
    with pytest.raises(ValueError, match=match):
        jpk.fused_rungs(*(jnp.asarray(p) for p in planes), sizes,
                        interpret=True, **kw)


def test_plane_shapes_validated(rng):
    y, u, v = (torch.from_numpy(p) for p in _data(rng, 1, 32, 64))
    with pytest.raises(ValueError, match="planes"):
        rungs.fused_rungs(y, u, v[:, :8], [(32, 16)])
    with pytest.raises(ValueError, match="planes"):
        rungs.fused_rungs(y[0], u[0], v[0], [(32, 16)])


_GEOMS = [(h, oh) for h in (1080, 2160, 720, 64, 480)
          for oh in (720, 540, 360, 180, 48, 32, 16, 1080)]


@pytest.mark.parametrize("method", ["bilinear", "nearest"])
def test_i8_gate_equals_jax(method):
    got = [rungs._rung_i8_ok(h, h // 2, oh, method) for h, oh in _GEOMS]
    want = [jpk._rung_i8_ok(h, h // 2, oh, method) for h, oh in _GEOMS]
    assert got == want
    # both gates send the 1080p ladder with a 960x540 rung to bf16: the
    # 2:1 row taps (0.5, 0.5) quantize to 64/127, 2.008 LSB per row
    assert rungs.resolve_quant(1080, 540, ((1280, 720), (960, 540)),
                               "bilinear", "auto") == "bf16"
    assert rungs.resolve_quant(1080, 540, ((1280, 720), (640, 360)),
                               "bilinear", "auto") == "i8"


@pytest.mark.parametrize("h,w,sizes", [
    (1080, 1920, ((1280, 720), (960, 540), (640, 360))),
    (2160, 3840, ((1920, 1080), (1280, 720))),
    (64, 128, SIZES),
])
def test_operands_equal_jax(h, w, sizes):
    """The rung operands are the JAX builders' (`_build_rungs`
    :1089-1104), entry by entry: luma and chroma resample matrices, the
    int8 rows and scales, the offsets and f32(1/s)."""
    ch, cw = h // 2, w // 2
    geom = (h, w, ch, cw, sizes, "bilinear")
    i8 = rungs._rung_operands("i8", geom)
    bf = rungs._rung_operands("bf16", geom)
    for (ow, oh), q, b in zip(sizes, i8, bf):
        for n_in, n_out in ((h, oh), (ch, oh // 2), (w, ow), (cw, ow // 2)):
            np.testing.assert_array_equal(
                resample_matrix(n_in, n_out, "bilinear"),
                jresize.resample_matrix(n_in, n_out, "bilinear"))
        for key, n_in, n_out, inv in (("y", h, oh, "inv_sy"),
                                      ("c", ch, oh // 2, "inv_sc")):
            jq, js = jpk._quant_rows(jresize.resample_matrix(n_in, n_out,
                                                             "bilinear"))
            np.testing.assert_array_equal(q["ah" + key], jq)
            joff = 128.0 * jq.astype(np.float32).sum(1) / js
            assert q["off" + key].dtype == joff.dtype == np.float32
            np.testing.assert_array_equal(q["off" + key], joff)
            assert q[inv] == float(np.float32(1.0 / js))
            np.testing.assert_array_equal(
                b["ah" + key], np.asarray(jnp.asarray(
                    jresize.resample_matrix(n_in, n_out, "bilinear"),
                    jnp.bfloat16).astype(jnp.float32)))
        for key, n_in, n_out in (("awy", w, ow), ("awc", cw, ow // 2)):
            want = np.asarray(jnp.asarray(
                jresize.resample_matrix(n_in, n_out, "bilinear").T,
                jnp.bfloat16).astype(jnp.float32))
            np.testing.assert_array_equal(q[key], want)
            np.testing.assert_array_equal(b[key], want)


def test_fits_answers_what_the_port_takes():
    """The kernel walks any frame size: every even ladder fits, 4K and 8K
    included (the TPU's answer depended on its VMEM budget)."""
    ladder_4k = ((1920, 1080), (1280, 720), (960, 540))
    assert rungs.fused_rungs_fits(2160, 3840, ladder_4k)
    assert jpk.fused_rungs_fits(2160, 3840, ladder_4k)
    assert rungs.fused_rungs_fits(4320, 7680, ladder_4k)
    assert not rungs.fused_rungs_fits(1080, 1920, ((1281, 720),))


def test_no_fallback_off_the_cpu(rng):
    """A tensor that does not lie on the CPU launches the kernel or
    raises: here there is no card, so it raises, and nothing runs the
    plain version in its place."""
    y, u, v = (torch.from_numpy(p).to("meta") for p in _data(rng, 1, 32, 64))
    before = dict(rungs.LAUNCHES)
    for quant in ("i8", "bf16"):
        with pytest.raises(ValueError, match="CUDA"):
            rungs.fused_rungs(y, u, v, [(32, 16), (16, 8)], quant=quant)
    assert rungs.LAUNCHES == before


def test_reference_flag_runs_plain_version(rng):
    planes = _data(rng, 1, 32, 64)
    a = _port(planes, ((32, 16),), reference=True)
    b = _port(planes, ((32, 16),))
    for x, y in zip(a[0], b[0]):
        np.testing.assert_array_equal(x, y)


def test_args_struct_layout_and_split(rng):
    """The ctypes mirror has the C layout (8-byte pointers, 32-byte Band,
    184-byte Rung) and a ladder longer than MAX_RUNGS is cut into
    launches of MAX_RUNGS rungs, each rung in its slot."""
    assert ctypes.sizeof(ladder._Band) == 32
    assert ctypes.sizeof(rungs._Rung) == 184
    assert ctypes.sizeof(rungs._RungsArgs) == 48 + rungs.MAX_RUNGS * 184
    n, h, w = 1, 24, 40
    sizes = tuple((2 * k + 2, 2 * k + 4) for k in range(10))
    y, u, v = (torch.from_numpy(p) for p in _data(rng, n, h, w))
    ops = rungs._kernel_operands("i8", (h, w, h // 2, w // 2, sizes,
                                        "bilinear"), "cpu")
    outs = [tuple(torch.empty(s, dtype=torch.uint8)
                  for s in ((n, oh, ow), (n, oh // 2, ow // 2),
                            (n, oh // 2, ow // 2))) for ow, oh in sizes]
    for lo in range(0, len(sizes), rungs.MAX_RUNGS):
        args = rungs._rungs_args(y, u, v, outs[lo:lo + rungs.MAX_RUNGS],
                                 ops[lo:lo + rungs.MAX_RUNGS])
        assert args.n_rungs == min(rungs.MAX_RUNGS, len(sizes) - lo)
        assert (args.n, args.h, args.w, args.ch, args.cw) == (n, h, w, h // 2,
                                                              w // 2)
        for slot in range(args.n_rungs):
            r, (yo, uo, vo) = args.rung[slot], outs[lo + slot]
            assert (r.y, r.u, r.v) == (yo.data_ptr(), uo.data_ptr(),
                                       vo.data_ptr())
            assert (r.out_w, r.out_h) == sizes[lo + slot]
            lo_t, _n, packed = ops[lo + slot]["row_c"]
            assert r.row_c.lo == lo_t.data_ptr()
            assert r.row_c.stride == packed.shape[1]
            assert r.off_y == ops[lo + slot]["off_y"].data_ptr()


def _kernel_walk(kind, planes, geom):
    """numpy walk of the CUDA kernel's loops: the flat job table per frame
    (rung by rung, luma samples then chroma positions, each writing u and
    v), and per job the band windows of its operands."""
    h, w, ch, cw, sizes, _method = geom
    ops = rungs._kernel_operands(kind, geom, "cpu")
    n = planes[0].shape[0]
    outs = [[np.full(s, -1, np.int64) for s in ((n, oh, ow),
                                                (n, oh // 2, ow // 2),
                                                (n, oh // 2, ow // 2))]
            for ow, oh in sizes]

    def bf16(x):
        return float(torch.tensor(float(x), dtype=torch.float32)
                     .to(torch.bfloat16))

    def band(t):
        return tuple(a.float().numpy() if a.dtype == torch.bfloat16
                     else a.numpy() for a in t)

    def px(x, row, col, i, j, inv_s):
        (rlo, rn, rw), (clo, cn, cwt) = row, col
        acc = np.float32(0)
        for b in range(int(cn[j])):
            col_j = int(clo[j]) + b
            rows = range(int(rlo[i]), int(rlo[i]) + int(rn[i]))
            if kind == "i8":
                t = sum(int(rw[i, a]) * (int(x[r, col_j]) - 128)
                        for a, r in enumerate(rows))
                tb = bf16(np.float32(t) * np.float32(inv_s))
            else:
                t = np.float32(0)
                for a, r in enumerate(rows):
                    t = np.float32(t + np.float32(rw[i, a])
                                   * np.float32(x[r, col_j]))
                tb = bf16(t)
            acc = np.float32(acc + np.float32(tb) * np.float32(cwt[j, b]))
        return acc

    def u8(o):
        return int(min(max(np.rint(o), 0), 255))   # rint: half to even

    jobs = [oh * ow + (oh // 2) * (ow // 2) for ow, oh in sizes]
    for f in range(n):
        for job in range(sum(jobs)):
            r, rem = 0, job
            while rem >= jobs[r]:
                rem -= jobs[r]
                r += 1
            (ow, oh), g = sizes[r], ops[r]
            if rem < oh * ow:
                i, j = divmod(rem, ow)
                o = px(planes[0][f], band(g["row_y"]), band(g["col_y"]), i, j,
                       g.get("inv_sy", 1.0))
                if kind == "i8":
                    o = np.float32(o + g["off_y"][i].item())
                outs[r][0][f, i, j] = u8(o)
            else:
                i, j = divmod(rem - oh * ow, ow // 2)
                for p in (1, 2):
                    o = px(planes[p][f], band(g["row_c"]), band(g["col_c"]),
                           i, j, g.get("inv_sc", 1.0))
                    if kind == "i8":
                        o = np.float32(o + g["off_c"][i].item())
                    outs[r][p][f, i, j] = u8(o)
    return outs


@pytest.mark.parametrize("kind", ["i8", "bf16"])
def test_kernel_walk_matches_plain(rng, kind):
    """The kernel's job table writes every sample of every rung once, and
    its band-form walk gives the plain version's numbers exactly."""
    n, h, w = 1, 20, 36
    sizes = ((12, 8), (24, 14), (4, 2))
    planes = _data(rng, n, h, w)
    geom = (h, w, h // 2, w // 2, sizes, "bilinear")
    walked = _kernel_walk(kind, planes, geom)
    want = rungs._PLAIN[kind](*(torch.from_numpy(p) for p in planes),
                              rungs._plain_operands(kind, geom, "cpu"))
    for got_r, want_r in zip(walked, want):
        for got_p, want_p in zip(got_r, want_r):
            assert (got_p >= 0).all()
            np.testing.assert_array_equal(got_p, want_p.numpy())
