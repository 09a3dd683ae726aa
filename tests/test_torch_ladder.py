"""The ladder kernels' plain PyTorch versions against the Pallas kernels
(interpret mode), on the same inputs, and the wrappers' validation.

Bounds (u8 LSBs): the int8 row stage is exact, so K1's plain version and
the Pallas kernel round the same f32 values to bf16: 0.01.  K2's f32 row
sum can run in another order and round to the neighbouring bf16 value:
1 (measured 3.05e-5 on these inputs: no such flip occurred)."""
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gmat_tpu.ops import pallas_kernels as jpk
from gmat_tpu_torch.ops import ladder

K1_LSB, K2_LSB = 0.01, 1.0


def _data(rng, n=2, h=64, w=128, chroma=None, hi=256, dtype=np.uint8):
    ch, cw = chroma or (h // 2, w // 2)
    return (rng.integers(0, hi, (n, h, w)).astype(dtype),
            rng.integers(0, hi, (n, ch, cw)).astype(dtype),
            rng.integers(0, hi, (n, ch, cw)).astype(dtype))


def _jax(fn, planes, *a, **k):
    return np.asarray(fn(*(jnp.asarray(p) for p in planes), *a,
                         interpret=True, **k))


def _port(fn, planes, *a, **k):
    before = dict(ladder.LAUNCHES)
    out = fn(*(torch.from_numpy(p) for p in planes), *a, **k).numpy()
    assert ladder.LAUNCHES == before      # CPU tensors: plain version
    return out


def _lsb(a, b, scale=255.0):
    assert a.shape == b.shape and a.dtype == np.float32
    return float(np.abs(a - b).max()) * scale


_K1_CASES = {
    "bilinear": ((32, 32), {}),
    "nearest": ((32, 32), {"method": "nearest"}),
    "crop": ((24, 32), {"crop_box": (16, 8, 64, 48)}),
    "smooth": ((32, 32), {"smooth": (3, 3, 0.0, 0.0, "replicate")}),
    "flip": ((32, 32), {"flip": -1}),
    "bt601_shift": ((32, 32), {"colorspace": "bt601",
                               "shift": (127.5, 127.5, 127.5)}),
    "bicubic": ((32, 48), {"method": "bicubic"}),
}


@pytest.mark.parametrize("case", sorted(_K1_CASES))
def test_k1_plain_matches_pallas(rng, case):
    (oh, ow), kw = _K1_CASES[case]
    planes = _data(rng)
    want = _jax(jpk.fused_ladder_i8, planes, oh, ow, **kw)
    got = _port(ladder.fused_ladder_i8, planes, oh, ow, **kw)
    assert _lsb(got, want) <= K1_LSB


def test_k1_plain_called_directly(rng):
    """_ladder_i8_plain on the builder's operands == the Pallas kernel."""
    planes = _data(rng)
    geom = (64, 128, 32, 64, 32, 32, "bilinear", None, None, None)
    ops = ladder._plain_operands("i8", geom, "cpu")
    c = ladder._epilogue("bt709", 8, 255.0, (0.0, 0.0, 0.0))
    got = ladder._ladder_i8_plain(*(torch.from_numpy(p) for p in planes),
                                  ops, c).numpy()
    assert _lsb(got, _jax(jpk.fused_ladder_i8, planes, 32, 32)) <= K1_LSB


_K2_CASES = {
    "u8": (dict(), {}),
    "u8_crop_flip": (dict(), {"crop_box": (16, 8, 64, 48), "flip": 1}),
    "u8_smooth": (dict(), {"smooth": (5, 3, 1.1, 0.0, "reflect101")}),
    "yuv444p": (dict(chroma=(64, 128)), {}),
    "u16_10bit": (dict(hi=1024, dtype=np.uint16), {"bits": 10}),
    "u16_10bit_smooth_flip": (dict(hi=1024, dtype=np.uint16),
                              {"bits": 10, "flip": 0,
                               "smooth": (5, 5, 0.0, 0.0, "replicate")}),
    "u16_12bit": (dict(hi=4096, dtype=np.uint16), {"bits": 12}),
}


@pytest.mark.parametrize("case", sorted(_K2_CASES))
def test_k2_plain_matches_pallas(rng, case):
    data_kw, kw = _K2_CASES[case]
    planes = _data(rng, **data_kw)
    if "bits" in kw:
        jfn, fn = jpk.fused_ladder_u16, ladder.fused_ladder_u16
    else:
        jfn, fn = jpk.fused_ladder, ladder.fused_ladder
    oh, ow = (24, 32) if "crop_box" in kw else (32, 32)
    want = _jax(jfn, planes, oh, ow, **kw)
    got = _port(fn, planes, oh, ow, **kw)
    assert _lsb(got, want) <= K2_LSB


def test_k2_plain_called_directly(rng):
    planes = _data(rng, hi=1024, dtype=np.uint16)
    geom = (64, 128, 32, 64, 32, 32, "bilinear", None, None, None)
    ops = ladder._plain_operands("bf16", geom, "cpu")
    c = ladder._epilogue("bt709", 10, 1023.0, (0.0, 0.0, 0.0))
    got = ladder._ladder_bf16_plain(*(torch.from_numpy(p) for p in planes),
                                    ops, c).numpy()
    want = _jax(jpk.fused_ladder_u16, planes, 32, 32, bits=10)
    assert _lsb(got, want) <= K2_LSB


@pytest.mark.parametrize("fusions", [(None, None, None),
                                     ((32, 8, 192, 48),
                                      (3, 3, 0.0, 0.0, "replicate"), -1)],
                         ids=["plain", "crop_smooth_flip"])
def test_k3_wide_frame_matches_chunked_pallas(rng, fusions):
    """The port sends wide frames to the same kernel as K1; hold it
    against the TPU's column-chunked kernel (2 chunks)."""
    n, h, w = 2, 64, 512
    planes = _data(rng, n=n, h=h, w=w)
    crop, sm, flip = fusions
    oh, ow = (24, 32) if crop else (32, 32)
    fn = jpk._build_ladder_i8_chunked(
        n, h, w, h // 2, w // 2, oh, ow, "bt709", "bilinear", 255.0,
        (0.0, 0.0, 0.0), True, 2, crop, sm, flip)
    want = np.asarray(fn(*(jnp.asarray(p) for p in planes)))
    if crop is None:
        got = _port(ladder.fused_ladder_i8, planes, oh, ow)
    else:
        # the Pallas builder skips the entry's i8 gate (which sends this
        # smooth to the bf16 kernel): run the int8 kernel's plain version
        geom = (h, w, h // 2, w // 2, oh, ow, "bilinear", crop, sm, flip)
        got = ladder._run("i8", *(torch.from_numpy(p) for p in planes),
                          geom, ladder._epilogue("bt709", 8, 255.0,
                                                 (0.0, 0.0, 0.0)),
                          False).numpy()
    # the same bound as the TPU's chunked-vs-whole test (test_pallas.py:152)
    assert _lsb(got, want) <= 1.0


def test_i8_gate_sends_wide_taps_to_bf16(rng, monkeypatch):
    """Where int8 cannot hold the taps, fused_ladder_i8 hands the call
    (fusions included) to the bf16 kernel, as the JAX entry does."""
    planes = _data(rng, n=1, h=96, w=160)
    calls = []
    orig = ladder.fused_ladder
    monkeypatch.setattr(ladder, "fused_ladder",
                        lambda *a, **k: calls.append(k) or orig(*a, **k))
    got = _port(ladder.fused_ladder_i8, planes, 32, 48, method="lanczos3",
                flip=1)
    assert calls and calls[0]["flip"] == 1
    want = _jax(jpk.fused_ladder_i8, planes, 32, 48, method="lanczos3",
                flip=1)
    assert _lsb(got, want) <= K2_LSB


@pytest.mark.parametrize("kw,match", [
    ({"crop_box": (1, 0, 64, 48)}, "even"),
    ({"crop_box": (0, 0, 63, 48)}, "even"),
    ({"crop_box": (-2, 0, 64, 48)}, "non-negative"),
    ({"crop_box": (96, 0, 64, 48)}, "outside"),
    ({"crop_box": (0, 0, 0, 48)}, "positive"),
    ({"smooth": (3, 3, 0.0, 0.0, "constant")}, "constant"),
    ({"smooth": (4, 3, 0.0, 0.0, "replicate")}, "odd"),
    ({"flip": 2}, "flip"),
    ({"method": "cubic"}, "method"),
])
@pytest.mark.parametrize("fn", ["fused_ladder_i8", "fused_ladder",
                                "fused_ladder_u16"])
def test_validators_raise(rng, fn, kw, match):
    if fn != "fused_ladder_i8" and "method" in kw:
        match = "resize method"
    planes = _data(rng, n=1, dtype=np.uint16 if fn.endswith("u16")
                   else np.uint8)
    with pytest.raises(ValueError, match=match):
        getattr(ladder, fn)(*(torch.from_numpy(p) for p in planes), 32, 32,
                            **kw)
    # the JAX entry points refuse the same input
    with pytest.raises(ValueError):
        getattr(jpk, fn)(*(jnp.asarray(p) for p in planes), 32, 32,
                         interpret=True, **kw)


_CU = (Path(ladder.__file__).resolve().parents[1] / "csrc"
       / "ladder.cu").read_text()


def _cu_const(name):
    """A `constexpr int` of csrc/ladder.cu: the walk follows the kernel's
    own tiling."""
    return int(re.search(rf"constexpr int {name} = (\d+);", _CU)[1])


def _bf16(x):
    return np.float32(torch.tensor(float(x)).to(torch.bfloat16).float())


class _Memory:
    """The bytes behind the tensors' data pointers, read as the kernel
    reads them: one sample, or an aligned 32-bit word that must hold at
    least one byte of its tensor (a clamped word is the tensor's last)."""

    def __init__(self, tensors):
        self.spans = [(t.data_ptr(), t.numel() * t.element_size(),
                       t.reshape(-1).view(torch.uint8).numpy())
                      for t in tensors]

    def _find(self, lo, hi):
        """The tensor holding a byte of [lo, hi)."""
        for base, size, raw in self.spans:
            if base < hi and lo < base + size:
                return base, size, raw
        raise AssertionError(f"bytes at {lo:#x} outside every tensor")

    def sample(self, addr, itemsize):
        base, size, raw = self._find(addr, addr + itemsize)
        assert base <= addr and addr + itemsize <= base + size
        return int.from_bytes(raw[addr - base:addr - base + itemsize].tobytes(),
                              "little")

    def word(self, addr):
        assert addr % 4 == 0
        base, size, raw = self._find(addr, addr + 4)
        got = bytearray(b"\x5a" * 4)     # bytes outside the tensor: any value
        for k in range(4):
            if base <= addr + k < base + size:
                got[k] = raw[addr + k - base]
        return int.from_bytes(bytes(got), "little")


def _kernel_walk(kind, planes, geom, c):
    """numpy walk of csrc/ladder.cu's planar kernel over the arguments
    `_ladder_args` builds, reading every operand through its pointer: the
    grid of blocks (kBlockX output columns x kBlockY rows of one frame),
    one pixel a thread with its column and row records and its three
    windows; u8 windows of 3-4 taps as two aligned 32-bit words per row,
    funnel-shifted, the second word clamped to the plane tensor's last in
    the last frame (every other word must lie inside the tensor); the
    others one load per sample; taps 0 walks the band records.  The sums
    in the kernel's order and rounding.  Returns the output, how many
    times each element was written, and how many words were clamped."""
    bx_, by_ = _cu_const("kBlockX"), _cu_const("kBlockY")
    ops = ladder._kernel_operands(kind, geom, "cpu")
    n, oh, ow = planes[0].shape[0], geom[4], geom[5]
    out = torch.full((n, 3, oh, ow), float("nan"))
    a = ladder._ladder_args(*planes, out, ops, c)
    taps, item = a.taps, planes[0].element_size()
    mem = _Memory(list(planes))
    writes = np.zeros(out.shape, int)
    clamped = [0]
    f32 = np.float32
    if taps:
        rec = ops["rows"].numpy()
        col = ops["cols"].numpy()
        assert a.rows == ops["rows"].data_ptr() and a.cols == ops["cols"].data_ptr()
    band = {k: tuple(t.float().numpy() if t.dtype == torch.bfloat16
                     else t.numpy() for t in ops[k])
            for k in ("row_y", "col_y", "row_c", "col_c")}

    def window(ptr, nbytes, addr, width, guard):
        """x[a][b] of the window whose first sample is at `addr`."""
        last = (ptr + nbytes - 1) & ~3
        x = []
        for r in range(taps):
            at = addr + r * width * item
            if item == 1 and taps > 2:
                q = at & ~3
                q1 = q + 4
                if q1 > last:
                    assert guard, "a word past the tensor outside the last frame"
                    q1 = last
                    clamped[0] += 1
                s = ((mem.word(q1) << 32 | mem.word(q)) >> (8 * (at & 3))) \
                    & 0xffffffff
                x.append([(s >> (8 * b)) & 0xff for b in range(taps)])
            else:
                x.append([mem.sample(at + b * item, item) for b in range(taps)])
        return x

    def value(x, rw, bias, cw, inv_s):
        acc = f32(0)
        for b in range(taps):
            if kind == "i8":
                t = bias + sum(int(rw[r]) * x[r][b] for r in range(taps))
                tb = _bf16(f32(t) * f32(inv_s))
            else:
                t = f32(0)
                for r in range(taps):
                    xs = f32(x[r][b]) if item == 1 else _bf16(x[r][b])
                    p = f32(np.int32(rw[r]).view(f32)) * xs     # exact
                    t = p if r == 0 else f32(t + p)
                tb = _bf16(t)
            p = f32(tb * cw[b])                                 # exact
            acc = p if b == 0 else f32(acc + p)
        return acc

    def band_px(x, row, colb, i, j, inv_s):
        (rlo, rn, rw), (clo, cn, cw) = row, colb
        acc = f32(0)
        for b in range(int(cn[j])):
            w = int(clo[j]) + b
            hs = range(int(rlo[i]), int(rlo[i]) + int(rn[i]))
            if kind == "i8":
                t = sum(int(rw[i, r]) * (int(x[h, w]) - 128)
                        for r, h in enumerate(hs))
                tb = _bf16(f32(t) * f32(inv_s))
            else:
                t = f32(0)
                for r, h in enumerate(hs):
                    t = f32(t + f32(rw[i, r]) * _bf16(x[h, w]))
                tb = _bf16(t)
            acc = f32(acc + f32(tb) * f32(cw[j, b]))
        return acc

    m = c["mat"]
    grid = (-(-ow // bx_), -(-oh // by_), n)
    for f, gy, gx, ty, tx in np.ndindex(grid[2], grid[1], grid[0], by_, bx_):
        i, j = gy * by_ + ty, gx * bx_ + tx
        if i >= oh or j >= ow:
            continue
        guard = item == 1 and f == n - 1
        if taps:
            w = rec[i]
            o = []
            for pl, (src, lo_c, width) in enumerate(
                    ((planes[0], col[0, j], a.w), (planes[1], col[1, j], a.cw),
                     (planes[2], col[1, j], a.cw))):
                luma = pl == 0
                height = a.h if luma else a.ch
                h0 = int(w[0] if luma else w[1])
                assert 0 <= h0 <= height - taps and 0 <= lo_c <= width - taps
                addr = src.data_ptr() + ((f * height + h0) * width
                                         + int(lo_c)) * item
                x = window(src.data_ptr(), src.numel() * item, addr, width,
                           guard)
                rw = w[4:4 + taps] if luma else w[4 + taps:4 + 2 * taps]
                bias = int(w[4 + 2 * taps] if luma else w[5 + 2 * taps])
                cw = (col[2:2 + taps, j] if luma
                      else col[2 + taps:2 + 2 * taps, j]).view(f32)
                v = value(x, rw, bias if kind == "i8" else 0, cw,
                          a.inv_sy if luma else a.inv_sc)
                if kind == "i8":
                    v = f32(v + np.int32(w[2 if luma else 3]).view(f32))
                o.append(v)
        else:
            fr = [p[f].numpy() for p in planes]
            o = [band_px(fr[0], band["row_y"], band["col_y"], i, j,
                         ops.get("inv_sy", 1.0)),
                 band_px(fr[1], band["row_c"], band["col_c"], i, j,
                         ops.get("inv_sc", 1.0)),
                 band_px(fr[2], band["row_c"], band["col_c"], i, j,
                         ops.get("inv_sc", 1.0))]
            if kind == "i8":
                o = [f32(o[0] + ops["off_y"][i].item()),
                     f32(o[1] + ops["off_c"][i].item()),
                     f32(o[2] + ops["off_c"][i].item())]
        yy, uu, vv = (f32(o[0] - c["low"]), f32(o[1] - c["mid"]),
                      f32(o[2] - c["mid"]))
        for k in range(3):
            s = f32(f32(m[k, 0] * yy + m[k, 1] * uu) + m[k, 2] * vv)
            s = min(max(s, f32(0)), f32(c["maxv"]))
            out[f, k, i, j] = float(f32(s - f32(c["shift"][k]))
                                    * f32(c["inv_norm"]))
            writes[f, k, i, j] += 1
    return out.numpy(), writes, clamped[0]


def _offset_planes(planes, offset):
    """Contiguous copies of the planes whose data pointers sit `offset`
    samples past an allocation, with slack after the last sample (device
    allocations are rounded up, so an aligned word that holds a sample of
    the tensor is inside its allocation)."""
    out = []
    for p in planes:
        buf = torch.empty(p.size + offset + 4, dtype=torch.from_numpy(p).dtype)
        t = buf[offset:offset + p.size].view(p.shape)
        t.copy_(torch.from_numpy(p))
        out.append(t)
    return out


_WALKS = {   # name: (kind, geom, bits, frames, pointer offset, taps)
    "i8_crop_smooth_flip": ("i8", (24, 40, 12, 20, 7, 9, "bilinear",
                                   (4, 2, 32, 20),
                                   (3, 3, 0.0, 0.0, "reflect"), -1), 8, 1, 0,
                            0),
    "bf16_lanczos3_flip_10bit": ("bf16", (24, 40, 12, 20, 9, 7, "lanczos3",
                                          None, None, 1), 10, 1, 0, 0),
    # 70 -> 20 columns at offset 3: windows start at every phase of a word
    "bilinear_word_phases": ("i8", (16, 70, 8, 35, 6, 20, "bilinear", None,
                                    None, None), 8, 2, 3, 2),
    # 77 and 39 wide into 37: no width a multiple of 4 or of the tile
    "ragged": ("bf16", (18, 77, 9, 39, 11, 37, "bilinear", None, None,
                        None), 8, 2, 1, 2),
    "flip": ("i8", (20, 48, 10, 24, 9, 13, "bilinear", None, None, -1), 8,
             1, 2, 2),
    "yuv444p": ("bf16", (20, 36, 20, 36, 9, 11, "bilinear", None, None,
                         None), 8, 1, 0, 2),
    # 4-tap windows: two words a row, the last frame's end words clamped
    "bicubic_i8": ("i8", (16, 40, 8, 20, 10, 12, "bicubic", None, None,
                          None), 8, 2, 0, 4),
    "bicubic_bf16": ("bf16", (16, 40, 8, 20, 12, 18, "bicubic", None, None,
                              1), 8, 3, 2, 4),
    # a fused 5-tap smooth: windows wider than 4 take the band walk
    "smooth_wide": ("bf16", (20, 36, 10, 18, 10, 14, "bilinear", None,
                             (5, 5, 1.5, 1.5, "replicate"), None), 8, 1, 0,
                    0),
    "u16_10bit": ("bf16", (20, 44, 10, 22, 9, 13, "bilinear", None, None,
                           None), 10, 2, 1, 2),
}


@pytest.mark.parametrize("case", list(_WALKS))
def test_band_walk_matches_plain(rng, case):
    """The planar kernel's schedule (tiles, each thread's column and rows,
    records, word loads with funnel shifts and the clamped edge, the
    tap-count instances and the band walk) writes every output once and
    gives the plain version's numbers, bit for bit."""
    kind, geom, bits, n, offset, taps = _WALKS[case]
    dtype = np.uint8 if bits == 8 else np.uint16
    planes = _offset_planes(_data(rng, n=n, h=geom[0], w=geom[1],
                                  chroma=geom[2:4], hi=1 << bits,
                                  dtype=dtype), offset)
    c = ladder._epilogue("bt601", bits, float((1 << bits) - 1),
                         (0.5, 0.0, 2.0))
    got, writes, clamped = _kernel_walk(kind, planes, geom, c)
    assert ladder._kernel_operands(kind, geom, "cpu")["taps"] == taps
    assert (writes == 1).all()
    if case == "bicubic_i8":
        assert clamped > 0
    want = ladder._PLAIN[kind](*(p.to(torch.int32) if bits > 8 else p
                                 for p in planes),
                               ladder._plain_operands(kind, geom, "cpu"),
                               c).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "bilinear_word_phases":
        starts = {(planes[0].data_ptr() + int(lo)) % 4
                  for lo in ladder._kernel_operands(kind, geom, "cpu")
                  ["cols"][0]}
        assert starts == {0, 1, 2, 3}


_RECORD_GEOMS = [
    (1080, 1920, 540, 960, 224, 224, "bilinear", None, None, None),
    (562, 998, 281, 499, 223, 225, "bilinear", None, None, None),
    (64, 128, 32, 64, 32, 48, "bicubic", None, None, -1),
    (64, 128, 32, 64, 20, 30, "nearest", None, None, 1),
    (64, 128, 32, 64, 24, 32, "area", (16, 8, 64, 48), None, 0),
    (20, 36, 40, 72, 40, 60, "bilinear", None, None, None),
]


@pytest.mark.parametrize("kind", ["i8", "bf16"])
@pytest.mark.parametrize("geom", _RECORD_GEOMS,
                         ids=lambda g: f"{g[1]}x{g[0]}-{g[6]}")
def test_window_records_match_band(kind, geom):
    """The window records hold, entry by entry, the band operands' windows
    (`_band`): each padded window lies inside its input and covers the
    band window, its weights are the band's with zeros around them, and
    the int8 rows carry their offsets and -128 * their weight sums."""
    ops = ladder._kernel_operands(kind, geom, "cpu")
    taps = ops["taps"]
    assert taps in ladder.TAPS
    rows, cols = ops["rows"].numpy(), ops["cols"].numpy()
    assert rows.shape == (geom[4], 8 + 2 * taps)
    assert cols.shape == (2 + 2 * taps, geom[5])
    n_in = {"row_y": geom[0], "row_c": geom[2], "col_y": geom[1],
            "col_c": geom[3]}
    recs = {"row_y": (rows[:, 0], rows[:, 4:4 + taps]),
            "row_c": (rows[:, 1], rows[:, 4 + taps:4 + 2 * taps]),
            "col_y": (cols[0], cols[2:2 + taps].T),
            "col_c": (cols[1], cols[2 + taps:].T)}
    for name, (lo, w) in recs.items():
        blo, bn, packed = (t.numpy() if t.dtype != torch.bfloat16
                           else t.float().numpy() for t in ops[name])
        if kind == "bf16" or name.startswith("col"):
            w = w.copy().view(np.float32)
        assert (lo >= 0).all() and (lo + taps <= n_in[name]).all()
        for r in range(len(lo)):
            assert lo[r] <= blo[r] and blo[r] + bn[r] <= lo[r] + taps
            want = np.zeros(taps, np.float32)
            want[blo[r] - lo[r]:blo[r] - lo[r] + bn[r]] = packed[r, :bn[r]]
            np.testing.assert_array_equal(w[r].astype(np.float32), want)
    if kind == "i8":
        np.testing.assert_array_equal(rows[:, 2].view(np.float32),
                                      ops["off_y"].numpy())
        np.testing.assert_array_equal(rows[:, 3].view(np.float32),
                                      ops["off_c"].numpy())
        for k, name in ((0, "row_y"), (1, "row_c")):
            np.testing.assert_array_equal(
                rows[:, 4 + 2 * taps + k],
                -128 * ops[name][2].numpy().astype(np.int64).sum(1))
    else:
        assert not rows[:, 2:4].any() and not rows[:, 4 + 2 * taps:].any()


def test_window_instance_from_widest_window():
    """The host picks the instance from the widest band window: bilinear,
    nearest and area at 2:1 2, bicubic and area at 3:1 4, a fused 5-tap
    smooth and
    lanczos3 the band walk; a plane narrower than the taps too."""
    def taps(geom):
        return ladder._kernel_operands("bf16", geom, "cpu")["taps"]
    g = (64, 128, 32, 64, 32, 64)
    assert taps((*g, "bilinear", None, None, None)) == 2
    assert taps((*g, "nearest", None, None, None)) == 2
    assert taps((*g, "bicubic", None, None, None)) == 4
    assert taps((*g, "area", None, None, None)) == 2
    assert taps((64, 128, 32, 64, 22, 43, "area", None, None, None)) == 4
    assert taps((*g, "lanczos3", None, None, None)) == 0
    assert taps((*g, "bilinear", None, (5, 5, 1.5, 1.5, "replicate"),
                 None)) == 0
    assert taps((6, 1, 3, 1, 4, 1, "bilinear", None, None, None)) == 0


def test_args_template_patched_per_call(rng):
    """The ctypes mirror has the C layout, and the cached argument template
    patched with a call's planes and output equals the arguments built
    afresh; the epilogue constants are one cached dict per key."""
    assert ctypes.sizeof(ladder._LadderArgs) == 296
    assert ladder._LadderArgs.rows.offset == 176
    assert ladder._LadderArgs.n.offset == 192
    assert ladder._LadderArgs.taps.offset == 220
    planes = [torch.from_numpy(p) for p in _data(rng, n=3)]
    geom = (64, 128, 32, 64, 32, 24, "bilinear", None, None, 1)
    c = ladder._epilogue("bt601", 8, 255.0, [127.5, 127.5, 127.5])
    assert ladder._epilogue("bt601", 8, 255, (127.5, 127.5, 127.5)) is c
    ops, template = ladder._prepared("i8", geom, "cpu", c["key"])
    assert ops is ladder._kernel_operands("i8", geom, "cpu")
    out = torch.empty((3, 3, 32, 24))
    fresh = ladder._ladder_args(*planes, out, ops, c)
    patched = ladder._patch(ladder._LadderArgs.from_buffer_copy(template),
                            *planes, out)
    assert bytes(patched) == bytes(fresh)
    assert (fresh.n, fresh.taps, fresh.out_h, fresh.out_w) == (3, 2, 32, 24)
    assert fresh.rows == ops["rows"].data_ptr()
    assert template.y is None and template.n == 0
