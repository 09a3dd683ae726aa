"""Fused preprocess ladder on hand-written Hopper kernels — counterpart of
`gmat_tpu/ops/pallas_kernels.py` (its host half, and kernels K1-K3, K6-K8).

    u8/u16 YUV planes -> row resample -> column resample -> 3x3 CSC ->
    clip -> (x - shift) / norm -> (N, 3, out_h, out_w) f32, one launch

Kernels (`gmat_tpu_torch/csrc/ladder.cu`, built at first use by `_build`):
  * `ladder_i8`   replaces K1 `_ladder_kernel_i8` (int8 row stage) and
    K3 `_ladder_kernel_i8_chunked`: the CUDA kernel walks any width, so
    8K frames need no column-chunked variant.  The TPU's dispatch by VMEM
    size (`_pick_w_chunks`, and its branch to the XLA path when no
    lane-aligned chunking exists) has no counterpart here:
    `fused_ladder_i8` sends every frame size to the kernel.
  * `ladder_bf16` replaces K2 `_ladder_kernel` (bf16 row stage, u8 or
    lsb-aligned u16 samples).
  * The wire-format lane: `ladder_nv12` replaces K6 `_ladder_nv12_kernel`,
    `ladder_nv12_i8` K7 `_ladder_nv12_kernel_i8` and `ladder_p010` K8
    `_ladder_p010_kernel`.  They read the (N, 3H/2, W) surface a hardware
    decoder hands over (luma rows, then interleaved U,V rows) and
    deinterleave on the fly; the TPU kernels' interleave-aware (W, out_w)
    chroma column matrices become the planar chroma band walked over
    U,V pairs.

Each kernel has a plain PyTorch version here (`_ladder_i8_plain`,
`_ladder_bf16_plain`, `_WIRE_PLAIN`) that repeats its numerics with tensor
ops on any device.  The wrappers take it only for CPU tensors, or when the
caller passes `reference=True` (the counterpart of the JAX
`interpret=True`); a CUDA tensor launches the kernel or raises.
`LAUNCHES` counts the kernel launches per kernel name.

Crop, gaussian smooth and flip fold into the four resample matrices on
the host (numpy, once per geometry), so the kernels never see them.  The
host hands each matrix over in band form and as window records padded to
2 or 4 taps (`_window_operands`: the kernel's instance for the
geometry's widest window; the wire kernels' chroma records index U,V
pairs); `_prepared` and `_wire_prepared` keep one argument template per
(kind, geometry, device, epilogue constants) that each call copies and
patches with its planes, output and batch size.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..core.color import yuv2rgb_matrix, yuv_offsets
from . import _build
from .resize import f32_matmul, resample_matrix
from .smooth import smooth_matrix

LAUNCHES = {"ladder_i8": 0, "ladder_bf16": 0, "ladder_nv12": 0,
            "ladder_nv12_i8": 0, "ladder_p010": 0}

_METHODS = ("bilinear", "nearest", "bicubic", "area", "lanczos3")


# ------------------------------------------------ validators (from the JAX)

def _validate_crop_box(crop_box, w, h):
    """Normalize a (x, y, w, h) crop to ints and validate: positive even
    dims inside the frame, non-negative origin (a negative origin would
    silently wrap to the opposite edge via Python slicing)."""
    cx, cy, cwb, chb = (int(c) for c in crop_box)
    if cx < 0 or cy < 0 or cwb <= 0 or chb <= 0:
        raise ValueError(f"crop box {crop_box} must have non-negative "
                         "origin and positive size")
    if (cx | cy | cwb | chb) & 1:
        raise ValueError("4:2:0 crop box must be even")
    if cx + cwb > w or cy + chb > h:
        raise ValueError("crop box outside the frame")
    return (cx, cy, cwb, chb)


def _validate_smooth(smooth):
    """Normalize a (kw, kh, sigmaX, sigmaY, border) gaussian spec for the
    fused ladder.  Only sum-preserving borders fuse: a 'constant' border
    scales the affine CSC offsets at the edges (G rows sum < 1), which
    the pre-CSC matrix composition cannot express."""
    kw_s, kh_s, sx, sy, border = smooth
    kw_s, kh_s = int(kw_s), int(kh_s)
    if kw_s < 1 or kh_s < 1 or not (kw_s & 1) or not (kh_s & 1):
        raise ValueError(f"gaussian kernel sizes must be odd and >=1, "
                         f"got {kw_s}x{kh_s}")
    if border == "constant":
        raise ValueError("constant-border smooth cannot fuse into the "
                         "ladder matrices (edge rows break the CSC "
                         "offsets); use the separate smooth op")
    return (kw_s, kh_s, float(sx), float(sy), str(border))


def _validate_flip(flip):
    if flip is not None and flip not in (0, 1, -1):
        raise ValueError(f"flip must be 0 (vertical), 1 (horizontal) or "
                         f"-1 (both), got {flip!r}")
    return flip


def _validate(w, h, crop_box, smooth, flip):
    if crop_box is not None:
        crop_box = _validate_crop_box(crop_box, w, h)
    flip = _validate_flip(flip)
    if smooth is not None:
        smooth = _validate_smooth(smooth)
    return crop_box, smooth, flip


# ---------------------------------------- resample matrices (numpy, host)

def _apply_post(ahy, ahc, awy, awc, out_h, out_w, smooth, flip):
    """Fold output-resolution gaussian smoothing and flip into the four
    resample matrices: out = Flip(G_h @ (A_h X A_w^T) @ G_w^T) collapses
    to a one-time numpy precomposition.

    ahy/ahc are (out_h, in) row matrices; awy/awc are the TRANSPOSED
    (in, out_w) column matrices the kernels consume.
    """
    if smooth is not None:
        kw_s, kh_s, sx, sy, border = smooth
        if kh_s > 1:
            gh = smooth_matrix(out_h, kh_s, sy, border)
            ahy = gh @ ahy
            ahc = gh @ ahc
        if kw_s > 1:
            gw = smooth_matrix(out_w, kw_s, sx, border)
            awy = awy @ gw.T
            awc = awc @ gw.T
    if flip in (0, -1):      # vertical: reverse output rows
        ahy = ahy[::-1]
        ahc = ahc[::-1]
    if flip in (1, -1):      # horizontal: reverse output columns
        awy = awy[:, ::-1]
        awc = awc[:, ::-1]
    return (np.ascontiguousarray(ahy, np.float32),
            np.ascontiguousarray(ahc, np.float32),
            np.ascontiguousarray(awy, np.float32),
            np.ascontiguousarray(awc, np.float32))


def _cropped_matrix(n_in_full: int, crop_off: int, crop_len: int,
                    n_out: int, method: str) -> np.ndarray:
    """Resample matrix that reads only [crop_off, crop_off+crop_len) of a
    full-length axis — crop fused into the interpolation weights."""
    A = resample_matrix(crop_len, n_out, method)
    if crop_off == 0 and crop_len == n_in_full:
        return A
    full = np.zeros((n_out, n_in_full), np.float32)
    full[:, crop_off:crop_off + crop_len] = A
    return full


def _quant_rows(A):
    """Quantize a resample matrix to int8 with a per-matrix scale so
    methods with taps beyond +-1 (bicubic overshoot, lanczos lobes) stay
    exact-ish: q = round(A*s), s = 127/max(1, max|A|)."""
    s = 127.0 / max(1.0, float(np.abs(A).max()))
    q = np.clip(np.round(A * s), -127, 127).astype(np.int8)
    return q, s


def _i8_quant_error_lsb(A) -> float:
    """Worst-case u8-LSB error of int8 weight quantization for one row of
    the resample matrix (drives the i8-vs-bf16 kernel dispatch)."""
    q, s = _quant_rows(A)
    return float(np.abs(q.astype(np.float32) / s - A).sum(axis=1).max()) * 255.0


@lru_cache(maxsize=256)
def _i8_ok_composed(h, w, ch, cw, out_h, out_w, method, crop, smooth,
                    flip) -> bool:
    """Dispatch gate on the ACTUAL (crop/smooth/flip-composed) row
    matrices the int8 kernel would quantize.  A fused gaussian spreads
    row weights, so the bilinear shortcut only holds without smooth."""
    if method in ("bilinear", "nearest") and smooth is None:
        return True
    ahy, ahc, _, _ = _i8_matrices(h, w, ch, cw, out_h, out_w, method,
                                  crop, smooth, flip)
    return max(_i8_quant_error_lsb(ahy), _i8_quant_error_lsb(ahc)) <= 2.0


@lru_cache(maxsize=64)
def _i8_matrices(h, w, ch, cw, out_h, out_w, method, crop, smooth, flip):
    """The four (possibly crop/smooth/flip-composed) resample matrices of
    one ladder geometry — the same for both kernels, as in the JAX
    builders."""
    if crop:
        cx, cy, cw_box, ch_box = crop
        # chroma window scales per axis from the actual plane shapes
        ahy = _cropped_matrix(h, cy, ch_box, out_h, method)
        ahc = _cropped_matrix(ch, cy * ch // h, ch_box * ch // h,
                              out_h, method)
        awy = _cropped_matrix(w, cx, cw_box, out_w, method).T
        awc = _cropped_matrix(cw, cx * cw // w, cw_box * cw // w,
                              out_w, method).T
    else:
        ahy = resample_matrix(h, out_h, method)
        ahc = resample_matrix(ch, out_h, method)
        awy = resample_matrix(w, out_w, method).T
        awc = resample_matrix(cw, out_w, method).T
    if smooth is not None or flip is not None:
        ahy, ahc, awy, awc = _apply_post(ahy, ahc, awy, awc, out_h, out_w,
                                         smooth, flip)
    return ahy, ahc, awy, awc


def _bf16_values(a: np.ndarray) -> np.ndarray:
    """f32 array rounded to bf16 (round to nearest even), kept as f32."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return t.to(torch.bfloat16).to(torch.float32).numpy()


@lru_cache(maxsize=64)
def _ladder_matrices(kind: str, geom: tuple) -> dict:
    """The operands kernel `kind` ("i8" or "bf16") reads for one geometry
    (h, w, ch, cw, out_h, out_w, method, crop, smooth, flip), as numpy.

    i8: int8 row matrices with their scales and the row offsets
    128 * rowsum(Ah_q) / s that undo the x ^ 0x80 centring; bf16: row
    matrices rounded to bf16.  Column matrices are bf16 for both."""
    return _row_col_operands(kind, *_i8_matrices(*geom))


def _row_col_operands(kind: str, ahy, ahc, awy, awc) -> dict:
    """The operands of one luma and one chroma resample, as numpy: bf16
    column matrices (transposed, (in, out)); bf16 row matrices, or int8
    row matrices with f32(1/s) and the row offsets 128 * rowsum(Ah_q) / s
    (computed as the JAX builders compute them)."""
    ops = {"awy": _bf16_values(awy), "awc": _bf16_values(awc)}
    if kind == "bf16":
        ops.update(ahy=_bf16_values(ahy), ahc=_bf16_values(ahc))
        return ops
    ahy_q, sy = _quant_rows(ahy)
    ahc_q, sc = _quant_rows(ahc)
    ops.update(ahy=ahy_q, ahc=ahc_q,
               offy=128.0 * ahy_q.astype(np.float32).sum(1) / sy,
               offc=128.0 * ahc_q.astype(np.float32).sum(1) / sc,
               inv_sy=float(np.float32(1.0 / sy)),
               inv_sc=float(np.float32(1.0 / sc)))
    return ops


class _Wire(NamedTuple):
    """One wire kernel: its launch name, row stage ("bf16" or "i8"), sample
    dtype and bits, the scale after the column stage, and its C entry."""
    name: str
    row: str
    dtype: torch.dtype
    bits: int
    post: float
    entry: str


_WIRE = {"nv12": _Wire("ladder_nv12", "bf16", torch.uint8, 8, 1.0,
                       "gmat_ladder_nv12"),
         "nv12_i8": _Wire("ladder_nv12_i8", "i8", torch.uint8, 8, 1.0,
                          "gmat_ladder_nv12_i8"),
         # samples in the high bits: 1/64 brings them to 10-bit scale
         "p010": _Wire("ladder_p010", "bf16", torch.uint16, 10, 1.0 / 64.0,
                       "gmat_ladder_p010")}


def _interleave(awc: np.ndarray):
    """(W/2, out_w) planar chroma column matrix -> the TPU kernels' (W,
    out_w) pair for interleaved U,V rows: U reads even columns, V odd."""
    awu = np.zeros((2 * awc.shape[0], awc.shape[1]), awc.dtype)
    awv = np.zeros_like(awu)
    awu[0::2] = awc
    awv[1::2] = awc
    return awu, awv


@lru_cache(maxsize=32)
def _wire_matrices(kind: str, geom: tuple) -> dict:
    """The operands wire kernel `kind` reads for geom (h, w, out_h, out_w,
    method), as numpy, as the JAX builders compute them
    (`pallas_kernels.py:372-383,644-655,763-772`): those of
    `_row_col_operands` with the planar (W/2, out_w) chroma column matrix
    `awc`, plus its interleave-aware pair `awu`/`awv` (W, out_w)."""
    h, w, out_h, out_w, method = geom
    ops = _row_col_operands(_WIRE[kind].row,
                            resample_matrix(h, out_h, method),
                            resample_matrix(h // 2, out_h, method),
                            resample_matrix(w, out_w, method).T,
                            resample_matrix(w // 2, out_w, method).T)
    ops["awu"], ops["awv"] = _interleave(ops["awc"])
    return ops


def _epilogue(colorspace: str, bits: int, norm: float, shift) -> dict:
    """CSC/normalize constants, as the f32 values the TPU kernels use; one
    dict per set of constants (shared: read it, do not change it), whose
    "key" names them."""
    return _epilogue_of(colorspace, bits, norm,
                        shift if isinstance(shift, tuple) else tuple(shift))


@lru_cache(maxsize=64)
def _epilogue_of(colorspace: str, bits: int, norm: float,
                 shift: tuple) -> dict:
    key = (str(colorspace), int(bits), float(norm),
           tuple(float(s) for s in shift))
    low, mid = yuv_offsets(key[1])
    return {"mat": yuv2rgb_matrix(key[0]), "low": float(low),
            "mid": float(mid), "maxv": 2.0 * mid - 1.0,
            "shift": tuple(float(np.float32(s)) for s in key[3]),
            "inv_norm": float(np.float32(1.0 / key[2])), "key": key}


# ------------------------------------------------------- plain versions

def _tensors(ops: dict, device: str) -> dict:
    """numpy operands as tensors on `device`; scalars stay as they are."""
    dev = torch.device(device)
    return {k: torch.as_tensor(v, device=dev) if isinstance(v, np.ndarray)
            else v for k, v in ops.items()}


@lru_cache(maxsize=32)
def _plain_operands(kind: str, geom: tuple, device: str) -> dict:
    return _tensors(_ladder_matrices(kind, geom), device)


def _csc(yy, uu, vv, c) -> torch.Tensor:
    """3x3 matrix, clip, (x - shift) * (1/norm), on offset-free planes."""
    m = c["mat"]
    chans = []
    for k in range(3):
        s = (float(m[k, 0]) * yy + float(m[k, 1]) * uu) + float(m[k, 2]) * vv
        s = torch.clamp(s, 0.0, c["maxv"])
        chans.append((s - c["shift"][k]) * c["inv_norm"])
    return torch.stack(chans, dim=1)


def _rowcol_i8_plain(x, ah_q, aw, off, inv_s):
    # x ^ 0x80 read as int8 is exactly x - 128; the row products are
    # summed in float64, exact because every partial sum is an integer
    # far below 2**53 (int32 in the kernel)
    x8 = x.to(torch.float64) - 128.0
    t = torch.matmul(ah_q.to(torch.float64), x8)
    tb = (t.to(torch.float32) * inv_s).to(torch.bfloat16).to(torch.float32)
    return f32_matmul(tb, aw) + off[:, None]


def _ladder_i8_plain(y, u, v, ops: dict, c: dict) -> torch.Tensor:
    """Plain PyTorch version of the `ladder_i8` kernel (K1/K3)."""
    yy = _rowcol_i8_plain(y, ops["ahy"], ops["awy"], ops["offy"],
                          ops["inv_sy"]) - c["low"]
    uu = _rowcol_i8_plain(u, ops["ahc"], ops["awc"], ops["offc"],
                          ops["inv_sc"]) - c["mid"]
    vv = _rowcol_i8_plain(v, ops["ahc"], ops["awc"], ops["offc"],
                          ops["inv_sc"]) - c["mid"]
    return _csc(yy, uu, vv, c)


def _rowcol_bf16_plain(x, ah, aw, k_chunks=None):
    # samples round to bf16 first (a 10-bit value above 256 is not exact
    # in bf16); the row stage sums in f32 over the TPU kernel's chunks of
    # rows (k_chunks of h // k_chunks rows, then the remainder; by default
    # 512-row chunks) and rounds to bf16 before the column stage
    xb = x.to(torch.float32).to(torch.bfloat16).to(torch.float32)
    h = x.shape[-2]
    chunk = max(h // (k_chunks or max(1, h // 512)), 1)
    acc = None
    for lo in range(0, h, chunk):
        part = f32_matmul(ah[:, lo:lo + chunk], xb[:, lo:lo + chunk])
        acc = part if acc is None else acc + part
    tb = acc.to(torch.bfloat16).to(torch.float32)
    return f32_matmul(tb, aw)


def _ladder_bf16_plain(y, u, v, ops: dict, c: dict) -> torch.Tensor:
    """Plain PyTorch version of the `ladder_bf16` kernel (K2)."""
    yy = _rowcol_bf16_plain(y, ops["ahy"], ops["awy"]) - c["low"]
    uu = _rowcol_bf16_plain(u, ops["ahc"], ops["awc"]) - c["mid"]
    vv = _rowcol_bf16_plain(v, ops["ahc"], ops["awc"]) - c["mid"]
    return _csc(yy, uu, vv, c)


_PLAIN = {"i8": _ladder_i8_plain, "bf16": _ladder_bf16_plain}


def _wire_split(yuv):
    """Luma rows and interleaved U,V rows of a (N, 3H/2, W) wire batch."""
    h = yuv.shape[-2] * 2 // 3
    return yuv[:, :h], yuv[:, h:]


def _nv12_plain(yuv, ops: dict, c: dict) -> torch.Tensor:
    """Plain PyTorch version of the `ladder_nv12` kernel (K6): luma over
    512-row chunks, the shared U,V row stage over half as many chunks
    (`pallas_kernels.py:344-345`), the interleave-aware column matrices
    splitting U (even columns) from V (odd)."""
    y, uv = _wire_split(yuv)
    k_chunks = max(1, y.shape[-2] // 512)
    kc = max(k_chunks // 2, 1)
    yy = _rowcol_bf16_plain(y, ops["ahy"], ops["awy"], k_chunks) - c["low"]
    uu = _rowcol_bf16_plain(uv, ops["ahc"], ops["awu"], kc) - c["mid"]
    vv = _rowcol_bf16_plain(uv, ops["ahc"], ops["awv"], kc) - c["mid"]
    return _csc(yy, uu, vv, c)


def _nv12_i8_plain(yuv, ops: dict, c: dict) -> torch.Tensor:
    """Plain PyTorch version of the `ladder_nv12_i8` kernel (K7)."""
    y, uv = _wire_split(yuv)
    yy = _rowcol_i8_plain(y, ops["ahy"], ops["awy"], ops["offy"],
                          ops["inv_sy"]) - c["low"]
    uu = _rowcol_i8_plain(uv, ops["ahc"], ops["awu"], ops["offc"],
                          ops["inv_sc"]) - c["mid"]
    vv = _rowcol_i8_plain(uv, ops["ahc"], ops["awv"], ops["offc"],
                          ops["inv_sc"]) - c["mid"]
    return _csc(yy, uu, vv, c)


def _p010_plain(yuv, ops: dict, c: dict) -> torch.Tensor:
    """Plain PyTorch version of the `ladder_p010` kernel (K8): the RAW u16
    wire value rounds to bf16 (not the sample shifted down: they differ
    where the low 6 bits are set), one row chunk, and the 1/64 of the msb
    alignment after the column stage."""
    y, uv = _wire_split(yuv)
    inv64 = 1.0 / 64.0
    yy = _rowcol_bf16_plain(y, ops["ahy"], ops["awy"], 1) * inv64 - c["low"]
    uu = _rowcol_bf16_plain(uv, ops["ahc"], ops["awu"], 1) * inv64 - c["mid"]
    vv = _rowcol_bf16_plain(uv, ops["ahc"], ops["awv"], 1) * inv64 - c["mid"]
    return _csc(yy, uu, vv, c)


_WIRE_PLAIN = {"nv12": _nv12_plain, "nv12_i8": _nv12_i8_plain,
               "p010": _p010_plain}


# ------------------------------------------------------- kernel launches

def _band(A: np.ndarray):
    """Band form of a (count, n_in) matrix: for each row the first column
    with a nonzero entry, the window length up to the last one, and the
    windows packed left-aligned into (count, longest).  Every nonzero lies
    inside its window, so a kernel that sums over the windows skips only
    zeros (exact)."""
    nz = A != 0
    has = nz.any(axis=1)
    lo = np.where(has, nz.argmax(axis=1), 0)
    hi = np.where(has, A.shape[1] - nz[:, ::-1].argmax(axis=1), 0)
    n = hi - lo
    packed = np.zeros((A.shape[0], max(1, int(n.max()))), A.dtype)
    for r in range(A.shape[0]):
        packed[r, :n[r]] = A[r, lo[r]:hi[r]]
    return lo.astype(np.int32), n.astype(np.int32), packed


# window widths the planar kernel has an instance for (fully unrolled);
# wider windows take its band walk
TAPS = (2, 4)


@lru_cache(maxsize=32)
def _kernel_operands(kind: str, geom: tuple, device: str) -> dict:
    """The planar kernel's operands for one geometry (`_device_operands`),
    uploaded once per (kind, geometry, device)."""
    return _device_operands(kind, _ladder_matrices(kind, geom), device)


def _device_operands(kind: str, m: dict, device: str) -> dict:
    """Band-form operands of the matrices `m` of `_row_col_operands`, and
    the window records of the kernel's instance for them
    (`_window_operands`), on `device`."""
    ops = _band_operands(kind, m, device)
    win = _window_operands(kind, m)
    ops["taps"] = win["taps"]
    if win["taps"]:
        dev = torch.device(device)
        ops.update(rows=torch.as_tensor(win["rows"], device=dev),
                   cols=torch.as_tensor(win["cols"], device=dev))
    return ops


def _window(A: np.ndarray, taps: int):
    """First input index and the `taps` weights of each row of A: its band
    window padded with zero weights to `taps` inputs, moved left where it
    would pass the input's end (so every padded window lies inside it)."""
    lo = np.minimum(_band(A)[0], A.shape[1] - taps)
    return lo, A[np.arange(A.shape[0])[:, None], lo[:, None] + np.arange(taps)]


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def _window_operands(kind: str, m: dict) -> dict:
    """The kernels' window records for the operands `m` of
    `_row_col_operands`, as numpy.  `taps` is the first of TAPS that holds
    the widest band window of the four matrices (0: none does, and the
    kernel walks the bands).  rows (out_h, 8 + 2 taps) int32: luma and
    chroma first row, off_y and off_c (f32 bits; int8 rows only), luma then
    chroma row weights (int8 values, or bf16 values as f32 bits), then for
    int8 rows -128 * each weight row's sum; cols (2 + 2 taps, out_w): luma
    and chroma first column, then luma and chroma column weights (f32
    bits)."""
    mats = (m["ahy"], m["ahc"], m["awy"].T, m["awc"].T)
    widest = max(int(_band(np.ascontiguousarray(A))[1].max()) for A in mats)
    taps = next((t for t in TAPS if widest <= t
                 and min(A.shape[1] for A in mats) >= t), 0)
    if not taps:
        return {"taps": 0}
    (ly, wy), (lc, wc), (cy, cwy), (cc, cwc) = (_window(A, taps)
                                                for A in mats)
    rows = np.zeros((len(ly), 8 + 2 * taps), np.int32)
    rows[:, 0], rows[:, 1] = ly, lc
    if kind == "i8":
        rows[:, 2], rows[:, 3] = _bits(m["offy"]), _bits(m["offc"])
        rows[:, 4:4 + taps] = wy
        rows[:, 4 + taps:4 + 2 * taps] = wc
        rows[:, 4 + 2 * taps] = -128 * wy.astype(np.int32).sum(1)
        rows[:, 5 + 2 * taps] = -128 * wc.astype(np.int32).sum(1)
    else:
        rows[:, 4:4 + taps] = _bits(wy)
        rows[:, 4 + taps:4 + 2 * taps] = _bits(wc)
    cols = np.concatenate([cy[None], cc[None], _bits(cwy).T, _bits(cwc).T])
    return {"taps": taps, "rows": rows, "cols": np.ascontiguousarray(cols)}


def _band_operands(kind: str, m: dict, device: str) -> dict:
    """The operands of `_row_col_operands` as the kernels read them: each
    matrix in band form (int8 or bf16 weights), offsets and scales."""
    dev = torch.device(device)
    row_dtype = torch.int8 if kind == "i8" else torch.bfloat16
    ops = {}
    for name, mat, dtype in (("row_y", m["ahy"], row_dtype),
                             ("col_y", m["awy"].T, torch.bfloat16),
                             ("row_c", m["ahc"], row_dtype),
                             ("col_c", m["awc"].T, torch.bfloat16)):
        lo, n, packed = _band(np.ascontiguousarray(mat))
        ops[name] = (torch.as_tensor(lo, device=dev),
                     torch.as_tensor(n, device=dev),
                     torch.as_tensor(packed, device=dev).to(dtype))
    if kind == "i8":
        ops.update(off_y=torch.as_tensor(m["offy"], device=dev),
                   off_c=torch.as_tensor(m["offc"], device=dev),
                   inv_sy=m["inv_sy"], inv_sc=m["inv_sc"])
    return ops


class _Band(ctypes.Structure):
    _fields_ = [("lo", ctypes.c_void_p), ("len", ctypes.c_void_p),
                ("wts", ctypes.c_void_p), ("stride", ctypes.c_int32)]


def _band_arg(ops: dict, name: str) -> _Band:
    lo, n, packed = ops[name]
    return _Band(lo.data_ptr(), n.data_ptr(), packed.data_ptr(),
                 packed.shape[1])


class _LadderArgs(ctypes.Structure):
    """Mirror of `struct LadderArgs` in csrc/ladder.cu."""
    _fields_ = ([(k, ctypes.c_void_p) for k in ("y", "u", "v", "out")]
                + [(k, _Band) for k in ("row_y", "col_y", "row_c", "col_c")]
                + [(k, ctypes.c_void_p) for k in ("off_y", "off_c", "rows",
                                                  "cols")]
                + [(k, ctypes.c_int32) for k in ("n", "h", "w", "ch", "cw",
                                                  "out_h", "out_w", "taps")]
                + [("inv_sy", ctypes.c_float), ("inv_sc", ctypes.c_float),
                   ("mat", ctypes.c_float * 9)]
                + [(k, ctypes.c_float) for k in ("low", "mid", "maxv",
                                                  "inv_norm")]
                + [("shift", ctypes.c_float * 3)])


def _operand_fields(ops: dict) -> tuple:
    """The band records and the off_y, off_c, rows, cols pointers of
    kernel operands, in the order LadderArgs and WireArgs hold them."""
    return (*(_band_arg(ops, k) for k in ("row_y", "col_y", "row_c",
                                          "col_c")),
            *(ops[k].data_ptr() if k in ops else None
              for k in ("off_y", "off_c", "rows", "cols")))


def _epilogue_fields(c: dict) -> tuple:
    """The epilogue constants, in the order of the structs' last fields."""
    return ((ctypes.c_float * 9)(*c["mat"].reshape(-1).tolist()),
            c["low"], c["mid"], c["maxv"], c["inv_norm"],
            (ctypes.c_float * 3)(*c["shift"]))


def _args_template(dims: tuple, ops: dict, c: dict) -> _LadderArgs:
    """Kernel arguments for planes of dims (h, w, ch, cw, out_h, out_w):
    the operands' pointers, the instance and the epilogue constants; the
    planes, output and batch size are patched in per call (`_patch`)."""
    return _LadderArgs(None, None, None, None, *_operand_fields(ops), 0,
                       *dims, ops["taps"], ops.get("inv_sy", 1.0),
                       ops.get("inv_sc", 1.0), *_epilogue_fields(c))


def _patch(args: _LadderArgs, y, u, v, out) -> _LadderArgs:
    args.y, args.u, args.v, args.out = (y.data_ptr(), u.data_ptr(),
                                        v.data_ptr(), out.data_ptr())
    args.n = y.shape[0]
    return args


def _ladder_args(y, u, v, out, ops: dict, c: dict) -> _LadderArgs:
    """Kernel arguments built afresh: pointers of the planes, output and
    operands, shapes, the instance and the epilogue constants."""
    dims = (y.shape[1], y.shape[2], u.shape[1], u.shape[2], out.shape[2],
            out.shape[3])
    return _patch(_args_template(dims, ops, c), y, u, v, out)


@lru_cache(maxsize=32)
def _prepared(kind: str, geom: tuple, device: str, key: tuple) -> tuple:
    """The operands of one geometry and its argument template for the
    epilogue constants `key` (kept together: the template holds the
    operands' device pointers)."""
    ops = _kernel_operands(kind, geom, device)
    return ops, _args_template(geom[:6], ops, _epilogue_of(*key))


_ENTRIES = {("i8", torch.uint8): ("ladder_i8", "gmat_ladder_i8"),
            ("bf16", torch.uint8): ("ladder_bf16", "gmat_ladder_bf16_u8"),
            ("bf16", torch.uint16): ("ladder_bf16", "gmat_ladder_bf16_u16")}


@lru_cache(maxsize=4)
def _checked(lib) -> ctypes.CDLL:
    """The kernel library, once its LadderArgs and WireArgs are known to
    match our mirrors."""
    for mirror, size in ((_LadderArgs, lib.gmat_ladder_args_size),
                         (_WireArgs, lib.gmat_wire_args_size)):
        if size() != ctypes.sizeof(mirror):
            raise RuntimeError(f"{mirror.__name__} does not match "
                               f"{mirror.__name__[1:]} in csrc/ladder.cu")
    return lib


def _call(fn, args, device: torch.device, name: str) -> None:
    """Launch C entry `fn` on `args` on the current stream of `device`;
    raises if the launch failed, else counts it."""
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        err = fn(ctypes.byref(args), stream)
    else:   # the kernel launches on the current device
        with torch.cuda.device(device):
            err = fn(ctypes.byref(args), stream)
    if err:
        raise RuntimeError(f"{name} launch failed: {_build.error_string(err)}")
    LAUNCHES[name] += 1


def _launch(kind: str, y, u, v, geom: tuple, c: dict) -> torch.Tensor:
    """Launch kernel `kind` on CUDA planes; raises on what it does not take."""
    if y.device.type != "cuda":
        raise ValueError(f"the {kind} ladder kernel takes CUDA tensors, got "
                         f"{y.device}")
    if (kind, y.dtype) not in _ENTRIES:
        raise TypeError(f"the {kind} ladder kernel takes no {y.dtype} planes")
    name, entry = _ENTRIES[(kind, y.dtype)]
    for t in (u, v):
        if t.device != y.device or t.dtype != y.dtype:
            raise ValueError("y, u and v must share one device and dtype")
    if y.dim() != 3 or u.dim() != 3 or u.shape != v.shape \
            or u.shape[0] != y.shape[0]:
        raise ValueError(f"planes must be (N,H,W) with equal chroma shapes, "
                         f"got {tuple(y.shape)}, {tuple(u.shape)}, "
                         f"{tuple(v.shape)}")
    if not (y.is_contiguous() and u.is_contiguous() and v.is_contiguous()):
        raise ValueError("the ladder kernels take contiguous planes")
    if not 0 < y.shape[0] <= 65535:
        raise ValueError(f"batch {y.shape[0]} outside 1..65535")
    if y.shape[1] * y.shape[2] >= 1 << 31:
        raise ValueError(f"frame {tuple(y.shape[1:])} has 2**31 samples or "
                         "more")
    fn = getattr(_checked(_build.library()), entry)
    _ops, template = _prepared(kind, geom, str(y.device), c["key"])
    out = torch.empty((y.shape[0], 3, geom[4], geom[5]), dtype=torch.float32,
                      device=y.device)
    _call(fn, _patch(_LadderArgs.from_buffer_copy(template), y, u, v, out),
          y.device, name)
    return out


def _run(kind: str, y, u, v, geom: tuple, c: dict, reference: bool):
    if reference or y.device.type == "cpu":
        ops = _plain_operands(kind, geom, str(y.device))
        return _PLAIN[kind](y, u, v, ops, c)
    return _launch(kind, y, u, v, geom, c)


@lru_cache(maxsize=32)
def _wire_plain_operands(kind: str, geom: tuple, device: str) -> dict:
    return _tensors(_wire_matrices(kind, geom), device)


@lru_cache(maxsize=32)
def _wire_kernel_operands(kind: str, geom: tuple, device: str) -> dict:
    """A wire kernel's operands (`_device_operands` of its matrices): the
    chroma columns are the planar ones (W/2 inputs), so a chroma column
    index, and a window record's first chroma column, is a U,V pair
    index."""
    return _device_operands(_WIRE[kind].row, _wire_matrices(kind, geom),
                            device)


class _WireArgs(ctypes.Structure):
    """Mirror of `struct WireArgs` in csrc/ladder.cu."""
    _fields_ = ([(k, ctypes.c_void_p) for k in ("yuv", "out")]
                + [(k, _Band) for k in ("row_y", "col_y", "row_c", "col_c")]
                + [(k, ctypes.c_void_p) for k in ("off_y", "off_c", "rows",
                                                  "cols")]
                + [(k, ctypes.c_int32) for k in ("n", "h", "w", "out_h",
                                                  "out_w", "taps")]
                + [(k, ctypes.c_float) for k in ("inv_sy", "inv_sc", "post")]
                + [("mat", ctypes.c_float * 9)]
                + [(k, ctypes.c_float) for k in ("low", "mid", "maxv",
                                                  "inv_norm")]
                + [("shift", ctypes.c_float * 3)])


def _wire_template(kind: str, dims: tuple, ops: dict, c: dict) -> _WireArgs:
    """Wire kernel arguments for surfaces of dims (h, w, out_h, out_w) (see
    `_args_template`); the surface, output and batch size are patched in
    per call (`_wire_patch`)."""
    return _WireArgs(None, None, *_operand_fields(ops), 0, *dims,
                     ops["taps"], ops.get("inv_sy", 1.0),
                     ops.get("inv_sc", 1.0), _WIRE[kind].post,
                     *_epilogue_fields(c))


def _wire_patch(args: _WireArgs, yuv, out) -> _WireArgs:
    args.yuv, args.out = yuv.data_ptr(), out.data_ptr()
    args.n = yuv.shape[0]
    return args


def _wire_args(kind: str, yuv, out, ops: dict, c: dict) -> _WireArgs:
    """Wire kernel arguments built afresh (see `_ladder_args`)."""
    dims = (yuv.shape[1] * 2 // 3, yuv.shape[2], out.shape[2], out.shape[3])
    return _wire_patch(_wire_template(kind, dims, ops, c), yuv, out)


@lru_cache(maxsize=32)
def _wire_prepared(kind: str, geom: tuple, device: str, key: tuple) -> tuple:
    """A wire kernel's operands for one geometry and its argument template
    for the epilogue constants `key` (see `_prepared`)."""
    ops = _wire_kernel_operands(kind, geom, device)
    return ops, _wire_template(kind, geom[:4], ops, _epilogue_of(*key))


def _launch_wire(kind: str, yuv, geom: tuple, c: dict) -> torch.Tensor:
    """Launch wire kernel `kind` on a CUDA wire batch; raises on what it
    does not take."""
    name, dtype = _WIRE[kind].name, _WIRE[kind].dtype
    if yuv.device.type != "cuda":
        raise ValueError(f"the {name} kernel takes CUDA tensors, got "
                         f"{yuv.device}")
    if yuv.dtype != dtype:
        raise TypeError(f"the {name} kernel takes {dtype}, got {yuv.dtype}")
    if not yuv.is_contiguous():
        raise ValueError(f"the {name} kernel takes a contiguous wire batch")
    if yuv.data_ptr() % (2 * yuv.element_size()):
        # the kernel loads each U,V pair at once
        raise ValueError(f"the {name} kernel takes a wire batch aligned "
                         "to a U,V pair")
    if not 0 < yuv.shape[0] <= 65535:
        raise ValueError(f"batch {yuv.shape[0]} outside 1..65535")
    if yuv.shape[1] * yuv.shape[2] >= 1 << 31:
        raise ValueError(f"frame {tuple(yuv.shape[1:])} has 2**31 samples or "
                         "more")
    fn = getattr(_checked(_build.library()), _WIRE[kind].entry)
    _ops, template = _wire_prepared(kind, geom, str(yuv.device), c["key"])
    out = torch.empty((yuv.shape[0], 3, geom[2], geom[3]),
                      dtype=torch.float32, device=yuv.device)
    _call(fn, _wire_patch(_WireArgs.from_buffer_copy(template), yuv, out),
          yuv.device, name)
    return out


def _wire(kind: str, what: str, yuv, out_h, out_w, colorspace, method,
          norm, shift, reference: bool) -> torch.Tensor:
    """Validate a wire batch as the JAX entries do, then run wire kernel
    `kind` (its plain version on CPU tensors or under `reference`)."""
    n, h32, w = yuv.shape
    if h32 % 3 or w % 2 or (h32 * 2 // 3) % 2:
        raise ValueError(f"{what}: ({h32}, {w}) "
                         "(rows must be H*3/2 with even H, width even)")
    geom = (h32 * 2 // 3, w, out_h, out_w, method)
    c = _epilogue(colorspace, _WIRE[kind].bits, norm, shift)
    if reference or yuv.device.type == "cpu":
        ops = _wire_plain_operands(kind, geom, str(yuv.device))
        return _WIRE_PLAIN[kind](yuv, ops, c)
    return _launch_wire(kind, yuv, geom, c)


# ------------------------------------------------------------ public API

def fused_ladder(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                 out_h: int, out_w: int, colorspace: str = "bt709",
                 method: str = "bilinear", norm: float = 255.0,
                 shift=(0.0, 0.0, 0.0), reference: bool = False,
                 crop_box=None, smooth=None, flip=None) -> torch.Tensor:
    """Batched YUV planes -> (N, 3, out_h, out_w) f32 on the bf16 kernel.

    y: (N, H, W) uint8; u, v: (N, H/2, W/2) or (N, H, W) uint8.
    crop_box=(x, y, w, h): fused crop (even coords);
    smooth=(kw, kh, sigmaX, sigmaY, border) and flip in {0, 1, -1} fold
    into the matrices (sum-preserving borders only).
    """
    n, h, w = y.shape
    ch, cw = u.shape[1], u.shape[2]
    crop_box, smooth, flip = _validate(w, h, crop_box, smooth, flip)
    geom = (h, w, ch, cw, out_h, out_w, method, crop_box, smooth, flip)
    return _run("bf16", y, u, v, geom, _epilogue(colorspace, 8, norm, shift),
                reference)


def fused_ladder_u16(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                     out_h: int, out_w: int, bits: int = 10,
                     colorspace: str = "bt709", method: str = "bilinear",
                     norm: float = 0.0, shift=(0.0, 0.0, 0.0),
                     reference: bool = False, crop_box=None,
                     smooth=None, flip=None) -> torch.Tensor:
    """High-bit-depth ladder on the bf16 kernel: u16 planes holding
    lsb-aligned `bits`-bit samples.  norm=0 defaults to full scale
    ((1<<bits)-1) so the output lands in [0,1] like the 8-bit path's
    norm=255."""
    n, h, w = y.shape
    ch, cw = u.shape[1], u.shape[2]
    if not norm:
        norm = float((1 << bits) - 1)
    crop_box, smooth, flip = _validate(w, h, crop_box, smooth, flip)
    geom = (h, w, ch, cw, out_h, out_w, method, crop_box, smooth, flip)
    return _run("bf16", y, u, v, geom,
                _epilogue(colorspace, int(bits), norm, shift), reference)


def fused_ladder_i8(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                    out_h: int, out_w: int, colorspace: str = "bt709",
                    method: str = "bilinear", norm: float = 255.0,
                    shift=(0.0, 0.0, 0.0), reference: bool = False,
                    crop_box=None, smooth=None, flip=None) -> torch.Tensor:
    """int8-row-stage ladder (weights quantized to 1/s steps, <=1 u8-LSB
    vs the bf16 kernel), for any frame size.

    The quantization gate judges the matrices actually quantized (crop
    windows, fused gaussians and flips included): where int8 cannot hold
    them, the bf16 kernel carries the call instead, fusions and all.
    """
    if method not in _METHODS:
        raise ValueError(f"int8 ladder: unknown method {method!r}")
    n, h, w = y.shape
    ch, cw = u.shape[1], u.shape[2]
    crop_box, smooth, flip = _validate(w, h, crop_box, smooth, flip)
    if not _i8_ok_composed(h, w, ch, cw, out_h, out_w, method, crop_box,
                           smooth, flip):
        return fused_ladder(y, u, v, out_h, out_w, colorspace, method, norm,
                            shift, reference, crop_box=crop_box,
                            smooth=smooth, flip=flip)
    geom = (h, w, ch, cw, out_h, out_w, method, crop_box, smooth, flip)
    return _run("i8", y, u, v, geom, _epilogue(colorspace, 8, norm, shift),
                reference)


def fused_ladder_nv12(yuv: torch.Tensor, out_h: int, out_w: int,
                      colorspace: str = "bt709", method: str = "bilinear",
                      norm: float = 255.0, shift=(0.0, 0.0, 0.0),
                      reference: bool = False) -> torch.Tensor:
    """Wire-format NV12 (N, H*3/2, W) u8 -> (N, 3, out_h, out_w) f32 on
    the `ladder_nv12` kernel; the U,V deinterleave rides the chroma
    column stage."""
    return _wire("nv12", "not an NV12 wire shape", yuv, out_h, out_w,
                 colorspace, method, norm, shift, reference)


def fused_ladder_nv12_i8(yuv: torch.Tensor, out_h: int, out_w: int,
                         colorspace: str = "bt709",
                         method: str = "bilinear", norm: float = 255.0,
                         shift=(0.0, 0.0, 0.0),
                         reference: bool = False) -> torch.Tensor:
    """Wire-format NV12 on the int8-row-stage `ladder_nv12_i8` kernel.
    Methods other than bilinear and nearest go to `fused_ladder_nv12`, as
    the JAX entry sends them (no tap gate here)."""
    if method not in ("bilinear", "nearest"):
        return fused_ladder_nv12(yuv, out_h, out_w, colorspace, method,
                                 norm, shift, reference)
    return _wire("nv12_i8", "not an NV12 wire shape", yuv, out_h, out_w,
                 colorspace, method, norm, shift, reference)


def fused_ladder_p010(yuv: torch.Tensor, out_h: int, out_w: int,
                      colorspace: str = "bt709", method: str = "bilinear",
                      norm: float = 0.0, shift=(0.0, 0.0, 0.0),
                      reference: bool = False) -> torch.Tensor:
    """P010 wire format (N, H*3/2, W) u16 (msb-aligned 10-bit samples,
    interleaved U,V rows) -> (N, 3, out_h, out_w) f32 on the `ladder_p010`
    kernel.  norm=0 defaults to 1023 (unit-range output)."""
    return _wire("p010", "not a P010 wire shape", yuv, out_h, out_w,
                 colorspace, method, norm or 1023.0, shift, reference)
