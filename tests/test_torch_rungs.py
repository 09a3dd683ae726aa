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
    """The kernel walks any frame up to 65535 samples a side: every even
    ladder from such a frame fits, 4K and 8K included (the TPU's answer
    depended on its VMEM budget); a wider or taller frame does not, since
    fused_rungs refuses its tile windows."""
    ladder_4k = ((1920, 1080), (1280, 720), (960, 540))
    assert rungs.fused_rungs_fits(2160, 3840, ladder_4k)
    assert jpk.fused_rungs_fits(2160, 3840, ladder_4k)
    assert rungs.fused_rungs_fits(4320, 7680, ladder_4k)
    assert rungs.fused_rungs_fits(65535, 65535, ladder_4k)
    assert not rungs.fused_rungs_fits(1080, 1920, ((1281, 720),))
    for h, w in ((65536, 1920), (1080, 65536)):
        assert not rungs.fused_rungs_fits(h, w, ladder_4k)
    aw = np.zeros((65537, 2), np.float32)    # (in, out): a 65537-wide window
    aw[0, 0] = aw[65536, 1] = 1.0
    with pytest.raises(ValueError, match="65535 samples a side"):
        rungs._plane_operands("bf16", np.eye(4, dtype=np.float32), aw, None,
                              1, "cpu")


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


def _outs(n, sizes):
    return [tuple(torch.empty(s, dtype=torch.uint8)
                  for s in ((n, oh, ow), (n, oh // 2, ow // 2),
                            (n, oh // 2, ow // 2))) for ow, oh in sizes]


def test_args_struct_layout_and_split(rng):
    """The ctypes mirror has the C layout (8-byte pointers, 64-byte
    RungPlane, planes from byte 120) and a ladder longer than MAX_RUNGS is
    cut into launches of MAX_RUNGS rungs, each rung's luma and chroma
    plane in its slot with its tile counts; the cached template patched
    per call equals the arguments built afresh."""
    assert ctypes.sizeof(ladder._Band) == 32
    assert ctypes.sizeof(rungs._RungPlane) == 64
    assert rungs._RungPlane.out_h.offset == 40
    assert rungs._RungPlane.inv_s.offset == 60
    assert rungs._RungsArgs.tile0.offset == 48
    assert rungs._RungsArgs.plane.offset == 120
    assert ctypes.sizeof(rungs._RungsArgs) == 120 + 2 * rungs.MAX_RUNGS * 64
    n, h, w = 1, 24, 40
    sizes = tuple((2 * k + 2, 2 * k + 4) for k in range(10))
    y, u, v = (torch.from_numpy(p) for p in _data(rng, n, h, w))
    geom = (h, w, h // 2, w // 2, sizes, "bilinear")
    ops = rungs._kernel_operands("i8", geom, "cpu")
    _ops, templates = rungs._prepared("i8", geom, "cpu")
    assert _ops is ops and len(templates) == 2
    outs = _outs(n, sizes)
    for lo in range(0, len(sizes), rungs.MAX_RUNGS):
        args = rungs._rungs_args(y, u, v, outs[lo:lo + rungs.MAX_RUNGS],
                                 ops[lo:lo + rungs.MAX_RUNGS])
        patched = rungs._patch(rungs._RungsArgs.from_buffer_copy(
            templates[lo // rungs.MAX_RUNGS]), y, u, v,
            outs[lo:lo + rungs.MAX_RUNGS])
        assert bytes(patched) == bytes(args)
        assert args.n_rungs == min(rungs.MAX_RUNGS, len(sizes) - lo)
        assert (args.n, args.h, args.w, args.ch, args.cw) == (n, h, w, h // 2,
                                                              w // 2)
        assert args.tile0[0] == 0
        for slot in range(args.n_rungs):
            (yo, uo, vo), r = outs[lo + slot], ops[lo + slot]
            py, pc = args.plane[2 * slot], args.plane[2 * slot + 1]
            assert py.out[0] == yo.data_ptr()
            assert (pc.out[0], pc.out[1]) == (uo.data_ptr(), vo.data_ptr())
            assert (py.out_w, py.out_h) == sizes[lo + slot]
            assert (pc.out_w, pc.out_h) == (sizes[lo + slot][0] // 2,
                                            sizes[lo + slot][1] // 2)
            assert pc.rows == r["c"]["rows"].data_ptr()
            assert py.cols == r["y"]["cols"].data_ptr()
            assert py.tiles == r["y"]["tiles"].data_ptr()
            for k, p in enumerate((py, pc)):
                d = r["yc"[k]]
                ty, tx = d["tiles_y"], d["tiles_x"]
                assert (args.tile0[2 * slot + k + 1] - args.tile0[2 * slot + k]
                        == tx * ty == len(d["tiles"]))
                assert p.th * ty >= p.out_h > p.th * (ty - 1)
                assert p.tw * tx >= p.out_w > p.tw * (tx - 1)
                assert p.tw >= rungs.KOUT and not p.tw & (p.tw - 1)
                assert p.tpitch % rungs.GROUP == 0
                assert tuple(d["rows"].shape) == (ty, 4, p.th)
                assert tuple(d["cols"].shape) == (tx, 3, p.tw)
                assert p.inv_s == np.float32(d["inv_s"])


def _offset_planes(rng, n, h, w, offset):
    """Random contiguous planes whose data pointers sit `offset` bytes past
    an allocation, so staged rows start at every 16-byte phase."""
    planes = []
    for p in _data(rng, n, h, w):
        buf = torch.empty(p.size + offset, dtype=torch.uint8)
        t = buf[offset:].view(p.shape)
        t.copy_(torch.from_numpy(p))
        planes.append(t)
    return planes


def _kernel_walk(kind, planes, geom):
    """numpy walk of the CUDA kernel over the arguments `_rungs_args`
    builds, reading every operand through its pointer: one block per tile
    of every frame, its plane from tile0 and its record; the row stage
    once per (output row, source column) of the tile's window, in items
    of GROUP columns read as whole 32-bit words of the plane tensor
    (clamped into it), into a shared buffer of NaNs; and the column stage
    in items of KOUT outputs of one row.  Returns the outputs and how many
    times each sample was written."""
    h, w, ch, cw, sizes, _method = geom
    n = planes[0].shape[0]
    ops = rungs._kernel_operands(kind, geom, "cpu")
    outs = _outs(n, sizes)
    mem = {}            # data pointer -> flat numpy view
    for t in [*planes, *(p for r in outs for p in r)] + [
            v for r in ops for d in r.values() for v in d.values()
            if isinstance(v, torch.Tensor)]:
        mem[t.data_ptr()] = t.reshape(-1).numpy()
    writes = {t.data_ptr(): np.zeros(t.numel(), int) for r in outs for t in r}

    def bf16(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(
            torch.bfloat16).float().numpy()

    def read(ptr, at, count):
        """`count` bytes from address `at` of the plane tensor at `ptr`,
        as the kernel reads them: 32-bit words, each clamped into the
        tensor's first and last words."""
        src = mem[ptr]
        q0 = at & ~3
        words = np.clip(q0 + 4 * np.arange((at - q0 + count + 3) // 4),
                        ptr & ~3, (ptr + src.size - 1) & ~3)
        byte = (words[:, None] + np.arange(4)[None, :]).ravel() - ptr
        # bytes of a clamped word outside the tensor: any value
        got = np.where((byte >= 0) & (byte < src.size),
                       src[np.clip(byte, 0, src.size - 1)], 0x5A)
        return got[at - q0:at - q0 + count].astype(np.int64)

    def tile(a, p, rec, f, chroma):
        srcs = (a.u, a.v) if chroma else (a.y,)
        height, width = (a.ch, a.cw) if chroma else (a.h, a.w)
        ty, tx = int(rec[0]), int(rec[1])
        r0, nr = int(rec[2]) & 0xffff, (int(rec[2]) & 0xffffffff) >> 16
        c0, nc = int(rec[3]) & 0xffff, (int(rec[3]) & 0xffffffff) >> 16
        i0, j0 = ty * p.th, tx * p.tw
        th, tw = min(p.th, p.out_h - i0), min(p.tw, p.out_w - j0)
        ng = (nc + rungs.GROUP) // rungs.GROUP
        assert ng * rungs.GROUP <= p.tpitch
        assert (rungs.tvals_bytes(len(srcs), p.th, p.tpitch)
                <= rungs.SMEM_BUDGET or (p.th, p.tw) == (1, rungs.KOUT))
        rows = mem[p.rows].reshape(-1, 4, p.th)[ty]
        cols = mem[p.cols].reshape(-1, 3, p.tw)[tx]
        first = (f * height + r0) * width + c0
        # row stage: unwritten values stay NaN, so reading one shows
        tv = np.full((len(srcs), p.th, p.tpitch), np.nan, np.float32)
        for pl, i in np.ndindex(len(srcs), th):
            k0 = int(rows[0, i]) - r0
            # every needed row lies in the window or is the row after it
            assert 0 <= k0 and k0 + 1 <= nr
            x = [read(srcs[pl], srcs[pl] + first + (k0 + tap) * width,
                      rungs.GROUP * ng) for tap in range(2)]
            if kind == "i8":
                t = (int(rows[1, i]) * (x[0] - 128)
                     + int(rows[2, i]) * (x[1] - 128))
                val = t.astype(np.float32) * np.float32(p.inv_s)
            else:
                wr = rows[1:3, i].view(np.float32)
                val = (wr[0] * x[0].astype(np.float32)
                       + wr[1] * x[1].astype(np.float32))
            tv[pl, i, :rungs.GROUP * ng] = bf16(val)
        # column stage: items of KOUT outputs, each a row's KOUT columns
        lo = cols[0] - c0
        assert (lo >= 0).all() and (lo + 1 < rungs.GROUP * ng).all()
        wc = cols[1:3].view(np.float32)
        off = rows[3].view(np.float32)
        for pl, i in np.ndindex(len(srcs), th):
            o = tv[pl, i, lo] * wc[0] + tv[pl, i, lo + 1] * wc[1]
            if kind == "i8":
                o = o + off[i]
            assert np.isfinite(o).all()
            q = np.clip(np.rint(o), 0, 255)[:tw]    # rint: half to even
            at = (f * p.out_h + i0 + i) * p.out_w + j0
            mem[p.out[pl]][at:at + tw] = q
            writes[p.out[pl]][at:at + tw] += 1

    for lo in range(0, len(sizes), rungs.MAX_RUNGS):
        a = rungs._rungs_args(*planes, outs[lo:lo + rungs.MAX_RUNGS],
                              ops[lo:lo + rungs.MAX_RUNGS])
        for f, bx in np.ndindex(a.n, a.tile0[2 * a.n_rungs]):
            pi = 0
            while bx >= a.tile0[pi + 1]:
                pi += 1
            p = a.plane[pi]
            rec = mem[p.tiles].reshape(-1, 4)[bx - a.tile0[pi]]
            tile(a, p, rec, f, pi & 1)
    return ([tuple(t.numpy() for t in r) for r in outs],
            [tuple(writes[t.data_ptr()].reshape(t.shape) for t in r)
             for r in outs])


@pytest.fixture
def tiling():
    """Set the tile and budget the host picks tiles from; the operand
    caches are cleared around the test."""
    saved = rungs.TILE, rungs.SMEM_BUDGET

    def use(tile, budget):
        rungs.TILE, rungs.SMEM_BUDGET = tile, budget
        rungs._kernel_operands.cache_clear()
        rungs._prepared.cache_clear()
    yield use
    use(*saved)


_WALKS = {   # name: (n, h, w, sizes, method, tile, smem budget, ptr offset)
    # the geometry of the flat job table's walk, at the default tile
    "today": (1, 20, 36, ((12, 8), (24, 14), (4, 2)), "bilinear",
              rungs.TILE, rungs.SMEM_BUDGET, 0),
    # a width that is not a multiple of 16 or of the tile (chroma 35 and
    # 11 wide), misaligned rows, and a budget that shrinks the tile
    "ragged": (2, 34, 70, ((40, 18), (22, 10)), "bilinear", (8, 16), 600,
               3),
    "upscale": (1, 14, 22, ((48, 30), (24, 16)), "bilinear", (8, 16),
                40960, 5),
    "nearest": (2, 24, 48, ((32, 12), (16, 24)), "nearest", (4, 16), 40960,
                1),
    # ten rungs: two launches, split at MAX_RUNGS
    "max_rungs": (1, 24, 40, tuple((2 * k + 2, 2 * k + 4) for k in range(10)),
                  "bilinear", (4, 8), 40960, 7),
}


@pytest.mark.parametrize("case", list(_WALKS))
@pytest.mark.parametrize("kind", ["i8", "bf16"])
def test_kernel_walk_matches_plain(rng, tiling, kind, case):
    """The tile schedule writes every sample of every rung and plane
    exactly once, and its walk gives the plain version's numbers
    exactly."""
    n, h, w, sizes, method, tile, budget, offset = _WALKS[case]
    tiling(tile, budget)
    planes = _offset_planes(rng, n, h, w, offset)
    geom = (h, w, h // 2, w // 2, sizes, method)
    walked, writes = _kernel_walk(kind, planes, geom)
    if case == "ragged":    # the budget halved the tile
        assert any(d["th"] * d["tw"] < 8 * 16 for r in rungs._kernel_operands(
            kind, geom, "cpu") for d in r.values())
    want = rungs._PLAIN[kind](*planes,
                              rungs._plain_operands(kind, geom, "cpu"))
    for got_r, want_r, wr in zip(walked, want, writes):
        for got_p, want_p, wp in zip(got_r, want_r, wr):
            assert (wp == 1).all()
            np.testing.assert_array_equal(got_p, want_p.numpy())
