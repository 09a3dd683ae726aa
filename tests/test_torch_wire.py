"""The wire-format lane (NV12 / P010 surfaces) of the port against the JAX
package: the plain versions of kernels K6/K7/K8 against the Pallas kernels
in interpret mode, the JAX package's own wire-vs-planar invariants held in
the port, the operands entry by entry, and a numpy walk of the CUDA
kernels' wire-layout loops and of the wire kernel's schedule.

Bounds (u8 LSBs): K7's int8 row stage is exact, so its plain version and
the Pallas kernel round the same f32 values: 0.01 (as K1).  K6 and K8 sum
the bf16 row stage in f32 and may round to the neighbouring bf16 value in
another summation order: 1 (as K2)."""
import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gmat_tpu.core.frame import FrameBatch as JFrameBatch, pack_nv12 as jpack
from gmat_tpu.ops import pallas_kernels as jpk
from gmat_tpu_torch.core.frame import FrameBatch, pack_nv12
from gmat_tpu_torch.ops import ladder
from tests.test_torch_ladder import _Memory, _bf16, _cu_const

K6_LSB, K7_LSB, K8_LSB = 1.0, 0.01, 1.0
WIRE_VS_PLANAR_LSB = 1.0        # test_pallas.py:91-101, 206-220, 308-326


def _planes(rng, n=2, h=64, w=128, hi=256, dtype=np.uint8):
    return (rng.integers(0, hi, (n, h, w)).astype(dtype),
            rng.integers(0, hi, (n, h // 2, w // 2)).astype(dtype),
            rng.integers(0, hi, (n, h // 2, w // 2)).astype(dtype))


def _nv12(planes):
    y, u, v = planes
    fb = FrameBatch(dict(zip("yuv", (torch.from_numpy(p) for p in planes))),
                    "yuv420p", y.shape[2], y.shape[1])
    return pack_nv12(fb).numpy()


def _p010(planes, low_bits=None):
    """y<<6 stacked on interleaved (u<<6, v<<6) rows, as test_pallas.py
    builds it; `low_bits` sets the 6 bits a clean P010 leaves at 0."""
    y, u, v = planes
    n, h, w = y.shape
    wire = np.zeros((n, h * 3 // 2, w), np.uint16)
    wire[:, :h] = y << 6
    wire[:, h:, 0::2] = u << 6
    wire[:, h:, 1::2] = v << 6
    if low_bits is not None:
        wire |= low_bits.astype(np.uint16) & 63
    return wire


def _jax(fn, wire, *a, **k):
    return np.asarray(fn(jnp.asarray(wire), *a, interpret=True, **k))


def _port(fn, *arrays, **k):
    before = dict(ladder.LAUNCHES)
    out = fn(*(torch.from_numpy(x) if isinstance(x, np.ndarray) else x
               for x in arrays), **k).numpy()
    assert ladder.LAUNCHES == before      # CPU tensors: plain version
    return out


def _lsb(a, b, scale=255.0):
    assert a.shape == b.shape and a.dtype == np.float32
    return float(np.abs(a - b).max()) * scale


_CASES = {
    "bilinear": ((32, 32), {}),
    "nearest": ((32, 32), {"method": "nearest"}),
    "bicubic": ((32, 48), {"method": "bicubic"}),
    "bt601_shift": ((32, 32), {"colorspace": "bt601",
                               "shift": (127.5, 127.5, 127.5)}),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_k6_plain_matches_pallas(rng, case):
    (oh, ow), kw = _CASES[case]
    wire = _nv12(_planes(rng))
    want = _jax(jpk.fused_ladder_nv12, wire, oh, ow, **kw)
    got = _port(ladder.fused_ladder_nv12, wire, oh, ow, **kw)
    assert _lsb(got, want) <= K6_LSB


@pytest.mark.parametrize("case", ["bilinear", "nearest", "bt601_shift"])
def test_k7_plain_matches_pallas(rng, case):
    (oh, ow), kw = _CASES[case]
    wire = _nv12(_planes(rng))
    want = _jax(jpk.fused_ladder_nv12_i8, wire, oh, ow, **kw)
    got = _port(ladder.fused_ladder_nv12_i8, wire, oh, ow, **kw)
    assert _lsb(got, want) <= K7_LSB


@pytest.mark.parametrize("case", ["clean", "dirty_low_bits", "bicubic",
                                  "bt601_shift_norm"])
def test_k8_plain_matches_pallas(rng, case):
    planes = _planes(rng, hi=1024, dtype=np.uint16)
    low = rng.integers(0, 64, (2, 96, 128)) if case == "dirty_low_bits" \
        else None
    wire = _p010(planes, low)
    kw = {"bicubic": {"method": "bicubic"},
          "bt601_shift_norm": {"colorspace": "bt601", "norm": 511.5,
                               "shift": (511.5, 511.5, 511.5)}}.get(case, {})
    want = _jax(jpk.fused_ladder_p010, wire, 32, 32, **kw)
    got = _port(ladder.fused_ladder_p010, wire, 32, 32, **kw)
    assert _lsb(got, want) <= K8_LSB


def test_k8_rounds_the_raw_wire_value(rng):
    """Dirty low bits: rounding the raw u16 value to bf16 is what the TPU
    kernel does; shifting the sample down first gives other numbers."""
    planes = _planes(rng, hi=1024, dtype=np.uint16)
    wire = _p010(planes, rng.integers(0, 64, (2, 96, 128)))
    got = _port(ladder.fused_ladder_p010, wire, 32, 32)
    shifted = _port(ladder.fused_ladder_p010, (wire >> 6) << 6, 32, 32)
    assert _lsb(got, shifted) > K8_LSB


def test_k7_other_methods_take_k6(rng, monkeypatch):
    """fused_ladder_nv12_i8 sends methods other than bilinear/nearest to
    fused_ladder_nv12, with no tap gate (pallas_kernels.py:710-712)."""
    wire = _nv12(_planes(rng))
    calls = []
    orig = ladder.fused_ladder_nv12
    monkeypatch.setattr(ladder, "fused_ladder_nv12",
                        lambda *a, **k: calls.append(a[3:]) or orig(*a, **k))
    got = _port(ladder.fused_ladder_nv12_i8, wire, 32, 48, method="bicubic")
    assert calls and calls[0][1] == "bicubic"
    want = _port(ladder.fused_ladder_nv12, wire, 32, 48, method="bicubic")
    assert np.array_equal(got, want)
    assert _lsb(got, _jax(jpk.fused_ladder_nv12_i8, wire, 32, 48,
                          method="bicubic")) <= K6_LSB
    calls.clear()
    _port(ladder.fused_ladder_nv12_i8, wire, 32, 32, method="nearest")
    assert not calls


# ------------------------------------- the JAX package's own invariants

def test_nv12_matches_planar(rng):
    planes = _planes(rng)
    got = _port(ladder.fused_ladder_nv12, _nv12(planes), 32, 32)
    want = _port(ladder.fused_ladder, *planes, 32, 32)
    assert _lsb(got, want) <= WIRE_VS_PLANAR_LSB


def test_nv12_i8_matches_planar_i8(rng):
    planes = _planes(rng)
    got = _port(ladder.fused_ladder_nv12_i8, _nv12(planes), 32, 32)
    want = _port(ladder.fused_ladder_i8, *planes, 32, 32)
    assert _lsb(got, want) <= WIRE_VS_PLANAR_LSB


def test_p010_matches_u16(rng):
    planes = _planes(rng, hi=1024, dtype=np.uint16)
    got = _port(ladder.fused_ladder_p010, _p010(planes), 32, 32)
    want = _port(ladder.fused_ladder_u16, *planes, 32, 32, bits=10)
    assert _lsb(got, want) <= WIRE_VS_PLANAR_LSB


def test_pack_nv12_matches_jax(rng):
    planes = _planes(rng, n=1)
    jfb = JFrameBatch(dict(zip("yuv", map(jnp.asarray, planes))), "yuv420p",
                      128, 64)
    assert np.array_equal(_nv12(planes), np.asarray(jpack(jfb)))


# ------------------------------------------------------------ operands

def _jax_operands(kind, h, w, oh, ow, method):
    """The operands as the JAX builders make them (pallas_kernels.py
    :372-383, :644-655, :763-772), with JAX's own functions, as numpy
    (bf16 operands as their f32 values)."""
    def bf(a):
        return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))

    awc = jpk.resample_matrix(w // 2, ow, method)
    awu = np.zeros((w, ow), np.float32)
    awv = np.zeros((w, ow), np.float32)
    awu[0::2, :] = awc.T
    awv[1::2, :] = awc.T
    ops = {"awy": bf(jpk.resample_matrix(w, ow, method).T), "awu": bf(awu),
           "awv": bf(awv)}
    ahy = jpk.resample_matrix(h, oh, method)
    ahc = jpk.resample_matrix(h // 2, oh, method)
    if kind != "nv12_i8":
        ops.update(ahy=bf(ahy), ahc=bf(ahc))
        return ops
    ahy_q, sy = jpk._quant_rows(ahy)
    ahc_q, sc = jpk._quant_rows(ahc)
    ops.update(ahy=ahy_q, ahc=ahc_q,
               offy=128.0 * ahy_q.astype(np.float32).sum(1) / sy,
               offc=128.0 * ahc_q.astype(np.float32).sum(1) / sc,
               inv_sy=float(np.float32(1.0 / sy)),
               inv_sc=float(np.float32(1.0 / sc)))
    return ops


def _dense_pair(band, w):
    """The kernel's planar chroma column band, walked over U,V pairs,
    written back as the dense interleave-aware (W, out_w) matrices."""
    lo, n, packed = (t.float().numpy() if t.dtype == torch.bfloat16
                     else t.numpy() for t in band)
    awu = np.zeros((w, len(lo)), np.float32)
    awv = np.zeros_like(awu)
    for j in range(len(lo)):
        for b in range(int(n[j])):
            awu[2 * (int(lo[j]) + b), j] = packed[j, b]
            awv[2 * (int(lo[j]) + b) + 1, j] = packed[j, b]
    return awu, awv


@pytest.mark.parametrize("kind", ["nv12", "nv12_i8", "p010"])
@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
def test_operands_match_jax(kind, method):
    h, w, oh, ow = 64, 128, 32, 48
    geom = (h, w, oh, ow, method)
    want = _jax_operands(kind, h, w, oh, ow, method)
    got = ladder._wire_matrices(kind, geom)
    for k, v in want.items():
        g = got[k]
        if isinstance(v, float):
            assert g == v, k
        else:
            assert g.dtype == v.dtype and np.array_equal(g, v), k
    # the kernel's band operands hold the same interleave-aware matrices
    ops = ladder._wire_kernel_operands(kind, geom, "cpu")
    awu, awv = _dense_pair(ops["col_c"], w)
    assert np.array_equal(awu, want["awu"])
    assert np.array_equal(awv, want["awv"])


# ---------------------------------------------------- the kernels' walk

def _wire_walk(kind, wire, geom, c):
    """numpy walk of the CUDA wire kernel's loops (one output pixel at a
    time): luma over the band windows of the luma rows, U and V over the
    planar chroma band at pixel stride 2 from offset 0 and 1 of the U,V
    rows, the column sums scaled by `post`, then offsets and epilogue."""
    ops = ladder._wire_kernel_operands(kind, geom, "cpu")
    row_kind, post = ladder._WIRE[kind].row, ladder._WIRE[kind].post
    h, w, oh, ow = geom[:4]

    def bf16(x):
        return float(torch.tensor(x, dtype=torch.float32).to(torch.bfloat16))

    band = {k: tuple(t.float().numpy() if t.dtype == torch.bfloat16
                     else t.numpy() for t in ops[k])
            for k in ("row_y", "col_y", "row_c", "col_c")}

    def px(rows, row, col, i, j, step, off, inv_s):
        (rlo, rn, rw), (clo, cn, cw) = row, col
        acc = np.float32(0)
        for b in range(int(cn[j])):
            x = step * (int(clo[j]) + b) + off
            hs = range(int(rlo[i]), int(rlo[i]) + int(rn[i]))
            if row_kind == "i8":
                t = sum(int(rw[i, a]) * (int(rows[r, x]) - 128)
                        for a, r in enumerate(hs))
                tb = bf16(np.float32(t) * np.float32(inv_s))
            else:
                t = np.float32(0)
                for a, r in enumerate(hs):
                    t = np.float32(t + np.float32(rw[i, a])
                                   * np.float32(bf16(float(rows[r, x]))))
                tb = bf16(t)
            acc = np.float32(acc + np.float32(tb) * np.float32(cw[j, b]))
        return np.float32(acc * np.float32(post))

    out = np.zeros((wire.shape[0], 3, oh, ow), np.float32)
    m = c["mat"]
    for f in range(wire.shape[0]):
        lum, uv = wire[f, :h], wire[f, h:]
        for i in range(oh):
            for j in range(ow):
                o = [px(lum, band["row_y"], band["col_y"], i, j, 1, 0,
                        ops.get("inv_sy", 1.0)),
                     px(uv, band["row_c"], band["col_c"], i, j, 2, 0,
                        ops.get("inv_sc", 1.0)),
                     px(uv, band["row_c"], band["col_c"], i, j, 2, 1,
                        ops.get("inv_sc", 1.0))]
                if row_kind == "i8":
                    o = [np.float32(o[0] + ops["off_y"][i].item()),
                         np.float32(o[1] + ops["off_c"][i].item()),
                         np.float32(o[2] + ops["off_c"][i].item())]
                yy, uu, vv = (np.float32(o[0] - c["low"]),
                              np.float32(o[1] - c["mid"]),
                              np.float32(o[2] - c["mid"]))
                for k in range(3):
                    s = np.float32(np.float32(m[k, 0] * yy + m[k, 1] * uu)
                                   + m[k, 2] * vv)
                    s = min(max(s, 0.0), c["maxv"])
                    out[f, k, i, j] = np.float32(
                        (s - c["shift"][k])) * np.float32(c["inv_norm"])
    return out


@pytest.mark.parametrize("kind,geom", [
    ("nv12", (24, 40, 9, 7, "lanczos3")),
    ("nv12_i8", (24, 40, 7, 9, "bilinear")),
    ("p010", (24, 40, 9, 7, "bicubic")),
])
def test_wire_walk_matches_plain(rng, kind, geom):
    """The wire kernels' walk (band windows, U,V pairs at stride 2, the
    post-scale) gives the plain versions' numbers, dirty P010 low bits
    included."""
    h, w = geom[:2]
    if kind == "p010":
        wire = rng.integers(0, 1 << 16, (1, h * 3 // 2, w)).astype(np.uint16)
        bits, norm = 10, 1023.0
    else:
        wire = rng.integers(0, 256, (1, h * 3 // 2, w)).astype(np.uint8)
        bits, norm = 8, 255.0
    c = ladder._epilogue("bt601", bits, norm, (0.5, 0.0, 2.0))
    want = ladder._WIRE_PLAIN[kind](
        torch.from_numpy(wire), ladder._wire_plain_operands(kind, geom, "cpu"),
        c).numpy()
    got = _wire_walk(kind, wire, geom, c)
    assert _lsb(got, want, norm) <= 1e-3


def _wire_kernel_walk(kind, wire, geom, c):
    """numpy walk of csrc/ladder.cu's wire kernel over the arguments
    `_wire_args` builds, reading every operand through its pointer: the
    grid of blocks (kBlockX output columns x kBlockY rows of one frame),
    one pixel a thread with its column and row records and two windows:
    luma (u8 windows of 3-4 taps as two aligned 32-bit words a row,
    funnel-shifted, both inside the tensor; otherwise a load per sample)
    and a window of U,V pairs, one pair-aligned load a pair; taps 0 walks
    the band records.  The sums in the kernel's order and rounding, scaled
    by `post`, then the int8 offsets and the epilogue.  Returns the output
    and how many times each element was written."""
    bx_, by_ = _cu_const("kBlockX"), _cu_const("kBlockY")
    row_kind = ladder._WIRE[kind].row
    ops = ladder._wire_kernel_operands(kind, geom, "cpu")
    n, oh, ow = wire.shape[0], geom[2], geom[3]
    out = torch.full((n, 3, oh, ow), float("nan"))
    a = ladder._wire_args(kind, wire, out, ops, c)
    taps, item = a.taps, wire.element_size()
    tensors = [wire] + [ops[k] for k in ("off_y", "off_c", "rows", "cols")
                        if k in ops]
    tensors += [t for k in ("row_y", "col_y", "row_c", "col_c")
                for t in ops[k]]
    mem = _Memory(tensors)
    end = wire.data_ptr() + wire.numel() * item
    f32 = np.float32

    def i32(addr):
        return int(np.uint32(mem.sample(addr, 4)).view(np.int32))

    def bf16_at(addr):
        return np.uint32(mem.sample(addr, 2) << 16).view(f32)

    def i8_at(addr):
        return int(np.uint8(mem.sample(addr, 1)).view(np.int8))

    def luma_window(addr):
        x = []
        for r in range(taps):
            at = addr + r * a.w * item
            if item == 1 and taps > 2:
                q = at & ~3
                assert q + 8 <= end, "a luma word past the tensor's end"
                s = ((mem.word(q + 4) << 32 | mem.word(q)) >> (8 * (at & 3))) \
                    & 0xffffffff
                x.append([(s >> (8 * b)) & 0xff for b in range(taps)])
            else:
                x.append([mem.sample(at + b * item, item)
                          for b in range(taps)])
        return x

    def pair_window(addr):
        xu, xv = [], []
        for r in range(taps):
            at = addr + r * a.w * item
            pairs = []
            for b in range(taps):
                assert (at + 2 * b * item) % (2 * item) == 0
                pairs.append(mem.sample(at + 2 * b * item, 2 * item))
            xu.append([p & ((1 << 8 * item) - 1) for p in pairs])
            xv.append([p >> 8 * item for p in pairs])
        return xu, xv

    def value(x, rw, bias, cw, inv_s):
        acc = f32(0)
        for b in range(taps):
            if row_kind == "i8":
                t = bias + sum(rw[r] * x[r][b] for r in range(taps))
                tb = _bf16(f32(t) * f32(inv_s))
            else:
                t = f32(0)
                for r in range(taps):
                    xs = f32(x[r][b]) if item == 1 else _bf16(x[r][b])
                    p = f32(np.int32(rw[r]).view(f32)) * xs       # exact
                    t = p if r == 0 else f32(t + p)
                tb = _bf16(t)
            p = f32(tb * cw[b])                                   # exact
            acc = p if b == 0 else f32(acc + p)
        return acc

    def band(bd, idx, wsize):
        lo, ln = i32(bd.lo + 4 * idx), i32(bd.len + 4 * idx)
        at = bd.wts + idx * bd.stride * wsize
        wts = [i8_at(at + k) if wsize == 1 else bf16_at(at + 2 * k)
               for k in range(ln)]
        return lo, wts

    def band_value(base, step, i, j, row, col, inv_s):
        """resample_px / resample_uv_px: `step` samples a column."""
        rsize = 1 if row_kind == "i8" else 2
        (h0, rw), (w0, cw) = band(row, i, rsize), band(col, j, 2)
        acc = f32(0)
        for b, cb in enumerate(cw):
            xs = [mem.sample(base + ((h0 + r) * a.w + step * (w0 + b)) * item,
                             item) for r in range(len(rw))]
            if row_kind == "i8":
                t = sum(w * (x - 128) for w, x in zip(rw, xs))
                tb = _bf16(f32(t) * f32(inv_s))
            else:
                t = f32(0)
                for w, x in zip(rw, xs):
                    t = f32(t + f32(w) * _bf16(x))
                tb = _bf16(t)
            acc = f32(acc + f32(tb) * f32(cb))
        return acc

    writes = np.zeros(out.shape, int)
    m = c["mat"]
    luma, pitch = a.h * a.w, a.w // 2
    grid = (-(-ow // bx_), -(-oh // by_), n)
    for f, gy, gx, ty, tx in np.ndindex(grid[2], grid[1], grid[0], by_, bx_):
        i, j = gy * by_ + ty, gx * bx_ + tx
        if i >= oh or j >= ow:
            continue
        y = a.yuv + f * (luma + luma // 2) * item
        uv = y + luma * item
        if taps:
            rec = [i32(a.rows + 4 * ((8 + 2 * taps) * i + k))
                   for k in range(8 + 2 * taps)]
            cy, cc = (i32(a.cols + 4 * (k * ow + j)) for k in range(2))
            cwy, cwc = ([np.int32(i32(a.cols + 4 * ((2 + k) * ow + j)))
                         .view(f32) for k in ks]
                        for ks in (range(taps), range(taps, 2 * taps)))
            assert 0 <= rec[0] <= a.h - taps and 0 <= cy <= a.w - taps
            assert 0 <= rec[1] <= a.h // 2 - taps and 0 <= cc <= pitch - taps
            xy = luma_window(y + (rec[0] * a.w + cy) * item)
            xu, xv = pair_window(uv + 2 * (rec[1] * pitch + cc) * item)
            ry, rc = rec[4:4 + taps], rec[4 + taps:4 + 2 * taps]
            by = rec[4 + 2 * taps] if row_kind == "i8" else 0
            bc = rec[5 + 2 * taps] if row_kind == "i8" else 0
            o = [value(xy, ry, by, cwy, a.inv_sy),
                 value(xu, rc, bc, cwc, a.inv_sc),
                 value(xv, rc, bc, cwc, a.inv_sc)]
            offs = [np.int32(rec[k]).view(f32) for k in (2, 3, 3)]
        else:
            o = [band_value(y, 1, i, j, a.row_y, a.col_y, a.inv_sy),
                 band_value(uv, 2, i, j, a.row_c, a.col_c, a.inv_sc),
                 band_value(uv + item, 2, i, j, a.row_c, a.col_c, a.inv_sc)]
            if row_kind == "i8":
                offs = [np.uint32(mem.sample(p + 4 * i, 4)).view(f32)
                        for p in (a.off_y, a.off_c, a.off_c)]
        o = [f32(v * f32(a.post)) for v in o]
        if row_kind == "i8":
            o = [f32(v + off) for v, off in zip(o, offs)]
        yy, uu, vv = (f32(o[0] - c["low"]), f32(o[1] - c["mid"]),
                      f32(o[2] - c["mid"]))
        for k in range(3):
            s = f32(f32(m[k, 0] * yy + m[k, 1] * uu) + m[k, 2] * vv)
            s = min(max(s, f32(0)), f32(c["maxv"]))
            out[f, k, i, j] = float(f32(s - f32(c["shift"][k]))
                                    * f32(c["inv_norm"]))
            writes[f, k, i, j] += 1
    return out.numpy(), writes


def _offset_wire(wire, offset):
    """A contiguous copy of the wire batch whose data pointer sits `offset`
    samples past an allocation that ends with its last sample."""
    t = torch.from_numpy(wire)
    buf = torch.empty(t.numel() + offset, dtype=t.dtype)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


_KERNEL_WALKS = {   # name: (geometry (h, w, out_h, out_w, method), taps)
    "bilinear": ((24, 40, 9, 7, "bilinear"), 2),
    # 70 -> 20 columns, 35 U,V pairs a row: odd W/2, every word phase
    "bilinear_odd_pairs": ((16, 70, 6, 20, "bilinear"), 2),
    "nearest_upscale": ((12, 22, 17, 35, "nearest"), 2),
    "area_2to1": ((24, 36, 12, 18, "area"), 2),
    # 4-tap windows: luma two words a row, chroma 4 x 4 pairs
    "bicubic": ((16, 40, 10, 12, "bicubic"), 4),
    "bicubic_odd_pairs": ((20, 26, 9, 11, "bicubic"), 4),
    # windows wider than 4 take the band walk
    "lanczos3": ((24, 40, 9, 7, "lanczos3"), 0),
    "area_wide": ((30, 50, 6, 9, "area"), 0),
}


@pytest.mark.parametrize("kind", ["nv12", "nv12_i8", "p010"])
@pytest.mark.parametrize("case", list(_KERNEL_WALKS))
def test_wire_kernel_walk_matches_plain(rng, kind, case):
    """The wire kernel's schedule (tiles, each thread's records, luma words
    with funnel shifts, U,V pair windows, the tap-count instances and the
    band walk) writes every output once, keeps every load inside the wire
    batch, and gives the plain version's numbers bit for bit, over two
    frames at an unaligned pointer and with dirty P010 low bits."""
    geom, taps = _KERNEL_WALKS[case]
    h, w = geom[:2]
    if kind == "p010":
        wire = rng.integers(0, 1 << 16, (2, h * 3 // 2, w)).astype(np.uint16)
        bits, norm, offset = 10, 1023.0, 2
    else:
        wire = rng.integers(0, 256, (2, h * 3 // 2, w)).astype(np.uint8)
        bits, norm, offset = 8, 255.0, 6
    wire = _offset_wire(wire, offset)
    assert ladder._wire_kernel_operands(kind, geom, "cpu")["taps"] == taps
    c = ladder._epilogue("bt601", bits, norm, (0.5, 0.0, 2.0))
    got, writes = _wire_kernel_walk(kind, wire, geom, c)
    assert (writes == 1).all()
    want = ladder._WIRE_PLAIN[kind](
        wire, ladder._wire_plain_operands(kind, geom, "cpu"), c).numpy()
    np.testing.assert_array_equal(got, want)


_WIRE_RECORD_GEOMS = [(1080, 1920, 224, 224, "bilinear"),
                      (562, 998, 223, 225, "bilinear"),
                      (562, 998, 223, 225, "bicubic"),
                      (16, 70, 6, 20, "nearest"),
                      (24, 36, 12, 18, "area")]


@pytest.mark.parametrize("kind", ["nv12", "nv12_i8", "p010"])
@pytest.mark.parametrize("geom", _WIRE_RECORD_GEOMS,
                         ids=lambda g: f"{g[1]}x{g[0]}-{g[4]}")
def test_wire_window_records_match_band(kind, geom):
    """The wire window records are `_window` of the wire matrices, entry by
    entry; every window lies inside its plane; the chroma first columns
    are U,V pair indices: written back as dense interleave-aware matrices
    (U at even samples, V at odd) they give the JAX builders' awu/awv."""
    h, w, oh, ow = geom[:4]
    m = ladder._wire_matrices(kind, geom)
    ops = ladder._wire_kernel_operands(kind, geom, "cpu")
    taps = ops["taps"]
    assert taps in ladder.TAPS
    rows, cols = ops["rows"].numpy(), ops["cols"].numpy()
    assert rows.shape == (oh, 8 + 2 * taps) and cols.shape == (2 + 2 * taps, ow)
    i8 = ladder._WIRE[kind].row == "i8"
    recs = {"ahy": (rows[:, 0], rows[:, 4:4 + taps], h),
            "ahc": (rows[:, 1], rows[:, 4 + taps:4 + 2 * taps], h // 2),
            "awy": (cols[0], cols[2:2 + taps].T, w),
            "awc": (cols[1], cols[2 + taps:].T, w // 2)}
    for name, (lo, wts, n_in) in recs.items():
        want_lo, want_w = ladder._window(np.ascontiguousarray(
            m[name] if name.startswith("ah") else m[name].T), taps)
        np.testing.assert_array_equal(lo, want_lo)
        assert (lo >= 0).all() and (lo + taps <= n_in).all()
        if not (i8 and name.startswith("ah")):
            wts = wts.copy().view(np.float32)
        np.testing.assert_array_equal(wts, want_w)
    awu = np.zeros((w, ow), np.float32)
    awv = np.zeros_like(awu)
    cwc = cols[2 + taps:].view(np.float32)
    for j in range(ow):
        for k in range(taps):
            awu[2 * (cols[1, j] + k), j] += cwc[k, j]
            awv[2 * (cols[1, j] + k) + 1, j] += cwc[k, j]
    np.testing.assert_array_equal(awu, m["awu"])
    np.testing.assert_array_equal(awv, m["awv"])
    if i8:
        np.testing.assert_array_equal(rows[:, 2].view(np.float32), m["offy"])
        np.testing.assert_array_equal(rows[:, 3].view(np.float32), m["offc"])
        for k, name in ((0, "ahy"), (1, "ahc")):
            np.testing.assert_array_equal(
                rows[:, 4 + 2 * taps + k],
                -128 * recs[name][1].astype(np.int64).sum(1))
    else:
        assert not rows[:, 2:4].any() and not rows[:, 4 + 2 * taps:].any()


def test_wire_args_template_patched_per_call(rng):
    """The ctypes mirror has the C layout, and the cached template, copied
    and patched with a call's wire batch and output, equals the arguments
    built afresh; the template itself stays unpatched."""
    assert ctypes.sizeof(ladder._WireArgs) == 280
    assert ladder._WireArgs.rows.offset == 160
    assert ladder._WireArgs.n.offset == 176
    assert ladder._WireArgs.taps.offset == 196
    geom = (24, 40, 9, 7, "bilinear")
    c = ladder._epilogue("bt601", 8, 255.0, [127.5, 127.5, 127.5])
    for kind in ("nv12", "nv12_i8"):
        ops, template = ladder._wire_prepared(kind, geom, "cpu", c["key"])
        assert ops is ladder._wire_kernel_operands(kind, geom, "cpu")
        assert ladder._wire_prepared(kind, geom, "cpu", c["key"])[1] \
            is template
        wire = torch.from_numpy(_nv12(_planes(rng, n=3, h=24, w=40)))
        out = torch.empty((3, 3, 9, 7))
        fresh = ladder._wire_args(kind, wire, out, ops, c)
        patched = ladder._wire_patch(
            ladder._WireArgs.from_buffer_copy(template), wire, out)
        assert bytes(patched) == bytes(fresh)
        assert (fresh.n, fresh.h, fresh.w, fresh.taps) == (3, 24, 40, 2)
        assert fresh.rows == ops["rows"].data_ptr()
        assert (fresh.off_y is not None) == (kind == "nv12_i8")
        assert template.yuv is None and template.out is None
        assert template.n == 0
        assert bytes(template)[ladder._WireArgs.h.offset:] \
            == bytes(fresh)[ladder._WireArgs.h.offset:]


# ---------------------------------------------------------- validation

@pytest.mark.parametrize("fn,shape,dtype,match", [
    ("fused_ladder_nv12", (1, 97, 128), np.uint8, "not an NV12 wire shape"),
    ("fused_ladder_nv12", (1, 96, 127), np.uint8, "not an NV12 wire shape"),
    ("fused_ladder_nv12_i8", (1, 98, 128), np.uint8,
     "not an NV12 wire shape"),
    ("fused_ladder_p010", (1, 100, 128), np.uint16, "not a P010 wire shape"),
    ("fused_ladder_p010", (1, 96, 129), np.uint16, "not a P010 wire shape"),
])
def test_wire_shape_validators_raise(fn, shape, dtype, match):
    """Rows not a multiple of 3, or an odd width: refused by both
    packages."""
    wire = np.zeros(shape, dtype)
    with pytest.raises(ValueError, match=match):
        getattr(ladder, fn)(torch.from_numpy(wire), 16, 16)
    with pytest.raises(ValueError, match=match):
        getattr(jpk, fn)(jnp.asarray(wire), 16, 16, interpret=True)


def test_unknown_method_raises_in_both(rng):
    wire = _nv12(_planes(rng, n=1))
    for fn in ("fused_ladder_nv12", "fused_ladder_nv12_i8"):
        with pytest.raises(ValueError, match="resize method"):
            getattr(ladder, fn)(torch.from_numpy(wire), 16, 16,
                                method="spline")
        with pytest.raises(ValueError):
            getattr(jpk, fn)(jnp.asarray(wire), 16, 16, method="spline",
                             interpret=True)


def test_wire_wrappers_take_no_other_device():
    """A tensor neither on the CPU nor on CUDA does not reach a plain
    version: the kernel path refuses it."""
    for fn, dt in (("fused_ladder_nv12", torch.uint8),
                   ("fused_ladder_nv12_i8", torch.uint8),
                   ("fused_ladder_p010", torch.uint16)):
        wire = torch.zeros((1, 24, 16), dtype=dt, device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            getattr(ladder, fn)(wire, 8, 8)
