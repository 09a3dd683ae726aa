"""lut3d and lut1d (vf_lut3d.c) — counterpart of `gmat_tpu/filters/lut3d.py`.

The parsers are the JAX module's numpy code, copied: .cube (parse_cube,
vf_lut3d.c:971-1070; LUT_3D_SIZE, TITLE, DOMAIN_MIN/MAX anywhere in the
value stream, red fastest, scale = clip(1/(max-min), 0, 1) per channel),
.3dl (parse_3dl, :733-765; 17^3 integers / 4096), the size-32 identity
(set_identity_matrix, :1072-1095) and the 1D .cube (parse_cube_1d,
:1638-1694).

The five 3D interpolators (:104-291: nearest, trilinear, pyramid, prism,
tetrahedral) and the five 1D ones are float32 tensor math over the whole
batch, op for op the C kernels' (and the JAX op's) order: eight corner
gathers from the flattened table, then the lerps.  Pixel pipeline
(:322-369): s = src/maxval; scaled = clipf(s * scale_c * (S-1), 0, S-1);
interp; out = clip_uintp2(trunc(vec * maxval)).  Integer RGB formats;
alpha passes through.  The table goes to the device once per device.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from ..core.frame import FrameBatch, set_channels


class LutError(ValueError):
    pass


def _data_lines(text: str):
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        yield line


def parse_cube(text: str) -> Tuple[np.ndarray, np.ndarray]:
    """Adobe/Resolve .cube -> (lut[r,g,b,3] float32, scale[3] float32).

    File order varies red fastest (parse_cube stores line (k,j,i) at
    lut[i*S^2 + j*S + k] == [r][g][b]); DOMAIN_MIN/MAX may interleave
    with the data like the reference's try_again loop."""
    size = None
    mn = np.zeros(3, np.float64)
    mx = np.ones(3, np.float64)
    vals = []
    for line in _data_lines(text):
        u = line.upper()
        if u.startswith("LUT_3D_SIZE"):
            parts = line.split()
            try:
                size = int(parts[1], 0)
            except (IndexError, ValueError):
                raise LutError(f"bad LUT_3D_SIZE line {line!r}") from None
            if not 2 <= size <= 256:
                raise LutError(f"bad LUT_3D_SIZE {size}")
        elif size is None:
            # the reference scans for LUT_3D_SIZE first and ignores
            # EVERYTHING before it — a DOMAIN_* header above the size
            # line has no effect there, so none here either
            continue
        elif len(vals) >= size ** 3:
            break           # parse_cube `break`s after the last entry;
                            # trailing DOMAIN_*/junk is never seen
        elif u.startswith("DOMAIN_MIN") or u.startswith("DOMAIN_MAX"):
            try:
                trio = [float(v) for v in line.split()[1:4]]
            except ValueError:
                raise LutError(f"bad DOMAIN line {line!r}") from None
            if len(trio) != 3:
                raise LutError(f"bad DOMAIN line {line!r}")
            if u.startswith("DOMAIN_MIN"):
                mn = np.asarray(trio)
            else:
                mx = np.asarray(trio)
        elif u.startswith("TITLE"):
            pass
        elif u.startswith("LUT_1D_SIZE"):
            raise LutError("1D .cube passed to lut3d")
        else:
            # the reference errors on any line that isn't 3 floats here
            # (av_sscanf != 3 -> AVERROR_INVALIDDATA); skipping short
            # lines would silently shift every later entry
            parts = line.split()
            if len(parts) < 3:
                raise LutError(f"bad .cube data line {line!r}")
            try:
                vals.append((float(parts[0]), float(parts[1]),
                             float(parts[2])))
            except ValueError:
                raise LutError(f"bad .cube data line {line!r}") \
                    from None
    if size is None:
        raise LutError(".cube has no LUT_3D_SIZE")
    if len(vals) < size ** 3:
        raise LutError(f".cube has {len(vals)} entries, needs {size ** 3}")
    data = np.asarray(vals[:size ** 3], np.float32)
    # line order (b-major k, g, r-fastest i) -> transpose to [r][g][b]
    lut = data.reshape(size, size, size, 3).transpose(2, 1, 0, 3)
    scale = np.clip(1.0 / (mx - mn), 0.0, 1.0).astype(np.float32)
    return np.ascontiguousarray(lut), scale


def parse_3dl(text: str) -> Tuple[np.ndarray, np.ndarray]:
    """AfterEffects/Autodesk .3dl: 17^3 integers / 4096; the first data
    line is the ramp header (skipped); first axis varies slowest."""
    size = 17
    rows = []
    for line in _data_lines(text):
        parts = line.split()
        try:
            rows.append([int(p) for p in parts[:3]])
        except ValueError:
            continue
    if rows and len(rows[0]) >= 3 and len(rows) >= size ** 3 + 1:
        rows = rows[1:]                 # NEXT_LINE skips the ramp row
    if len(rows) < size ** 3:
        raise LutError(f".3dl has {len(rows)} entries, needs {size ** 3}")
    data = np.asarray(rows[:size ** 3], np.float32) / np.float32(4096.0)
    return data.reshape(size, size, size, 3), np.ones(3, np.float32)


def identity_lut(size: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    """set_identity_matrix: lut[r,g,b] = (r, g, b) / (size-1)."""
    c = np.float32(1.0 / (size - 1))
    r, g, b = np.meshgrid(np.arange(size), np.arange(size),
                          np.arange(size), indexing="ij")
    lut = np.stack([r * c, g * c, b * c], axis=-1).astype(np.float32)
    return lut, np.ones(3, np.float32)


def load_lut_file(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with open(path, "r", errors="replace") as f:
        text = f.read()
    low = path.lower()
    if low.endswith(".cube"):
        return parse_cube(text)
    if low.endswith(".3dl"):
        return parse_3dl(text)
    raise LutError(f"unsupported 3D LUT extension on {path!r} "
                   "(.cube and .3dl supported)")


INTERP_MODES = ("nearest", "trilinear", "tetrahedral", "pyramid", "prism")


def _interp(flat, S, ri, gi, bi, dr, dg, db, mode):
    """Corner-gather interpolation; index and fraction args (N, H, W),
    `flat` the (S^3, 3) table on their device."""
    def corner(a, b, c):
        return flat[(a * S + b) * S + c]

    if mode == "nearest":
        return corner(ri, gi, bi)       # caller passes NEAR indices
    nr = torch.clamp(ri + 1, max=S - 1)
    ng = torch.clamp(gi + 1, max=S - 1)
    nb = torch.clamp(bi + 1, max=S - 1)
    c000 = corner(ri, gi, bi)
    c001 = corner(ri, gi, nb)
    c010 = corner(ri, ng, bi)
    c011 = corner(ri, ng, nb)
    c100 = corner(nr, gi, bi)
    c101 = corner(nr, gi, nb)
    c110 = corner(nr, ng, bi)
    c111 = corner(nr, ng, nb)
    dr_, dg_, db_ = dr[..., None], dg[..., None], db[..., None]

    def lerp(a, b, f):
        return a + (b - a) * f

    if mode == "trilinear":
        c00 = lerp(c000, c100, dr_)
        c10 = lerp(c010, c110, dr_)
        c01 = lerp(c001, c101, dr_)
        c11 = lerp(c011, c111, dr_)
        c0 = lerp(c00, c10, dg_)
        c1 = lerp(c01, c11, dg_)
        return lerp(c0, c1, db_)

    if mode == "pyramid":
        a = (c000 + (c111 - c011) * dr_ + (c010 - c000) * dg_
             + (c001 - c000) * db_
             + (c011 - c001 - c010 + c000) * dg_ * db_)
        b = (c000 + (c100 - c000) * dr_ + (c111 - c101) * dg_
             + (c001 - c000) * db_
             + (c101 - c001 - c100 + c000) * dr_ * db_)
        c = (c000 + (c100 - c000) * dr_ + (c010 - c000) * dg_
             + (c111 - c110) * db_
             + (c110 - c100 - c010 + c000) * dr_ * dg_)
        m1 = ((dg > dr) & (db > dr))[..., None]
        m2 = ((dr > dg) & (db > dg))[..., None]
        return torch.where(m1, a, torch.where(m2, b, c))

    if mode == "prism":
        a = (c000 + (c001 - c000) * db_ + (c101 - c001) * dr_
             + (c010 - c000) * dg_
             + (c000 - c010 - c001 + c011) * db_ * dg_
             + (c001 - c011 - c101 + c111) * dr_ * dg_)
        b = (c000 + (c101 - c100) * db_ + (c100 - c000) * dr_
             + (c010 - c000) * dg_
             + (c100 - c110 - c101 + c111) * db_ * dg_
             + (c000 - c010 - c100 + c110) * dr_ * dg_)
        return torch.where((db > dr)[..., None], a, b)

    if mode == "tetrahedral":
        t1 = ((1.0 - dr_) * c000 + (dr_ - dg_) * c100
              + (dg_ - db_) * c110 + db_ * c111)
        t2 = ((1.0 - dr_) * c000 + (dr_ - db_) * c100
              + (db_ - dg_) * c101 + dg_ * c111)
        t3 = ((1.0 - db_) * c000 + (db_ - dr_) * c001
              + (dr_ - dg_) * c101 + dg_ * c111)
        t4 = ((1.0 - db_) * c000 + (db_ - dg_) * c001
              + (dg_ - dr_) * c011 + dr_ * c111)
        t5 = ((1.0 - dg_) * c000 + (dg_ - db_) * c010
              + (db_ - dr_) * c011 + dr_ * c111)
        t6 = ((1.0 - dg_) * c000 + (dg_ - dr_) * c010
              + (dr_ - db_) * c110 + db_ * c111)
        rg, gb, rb = dr > dg, dg > db, dr > db
        bg, br = db > dg, db > dr
        # the C nested-if branch structure, vf_lut3d.c:245-290
        hi = torch.where(gb[..., None], t1,
                         torch.where(rb[..., None], t2, t3))
        lo = torch.where(bg[..., None], t4,
                         torch.where(br[..., None], t5, t6))
        return torch.where(rg[..., None], hi, lo)

    raise LutError(f"unknown interp mode {mode!r}; use one of "
                   f"{INTERP_MODES}")


_DEVICE_LUTS: Dict = {}


def _on_device(lut: np.ndarray, device) -> torch.Tensor:
    """`lut` as an f32 tensor on `device`, uploaded once per (table,
    device); the cache holds the numpy table so its id stays unique."""
    key = (id(lut), str(device))
    hit = _DEVICE_LUTS.get(key)
    if hit is None or hit[0] is not lut:
        if len(_DEVICE_LUTS) > 32:
            _DEVICE_LUTS.clear()
        hit = (lut, torch.as_tensor(np.ascontiguousarray(lut),
                                    device=device))
        _DEVICE_LUTS[key] = hit
    return hit[1]


def apply_lut3d(fb: FrameBatch, lut: np.ndarray, scale: np.ndarray,
                interp: str = "tetrahedral") -> FrameBatch:
    """Apply a 3D LUT to an integer RGB FrameBatch (alpha untouched)."""
    fmt = fb.fmt
    if not fmt.is_rgb or fmt.is_float:
        raise LutError("lut3d operates on integer RGB frames "
                       "(format=rgb24/... first); planar YUV is not in "
                       "vf_lut3d's format list either")
    S = lut.shape[0]
    order = fmt.channel_order
    arr = fb.planes["rgb"]
    maxval = np.float32((1 << fmt.bits) - 1)
    flat = _on_device(lut, arr.device).reshape(S * S * S, 3)
    lut_max = float(np.float32(S - 1))
    inv = float(np.float32(1.0) / maxval)
    scaled = {}
    for ci, ch in enumerate("rgb"):
        s = arr[..., order.index(ch)].to(torch.float32) * inv
        sc = float(np.float32(scale[ci]) * np.float32(S - 1))
        scaled[ch] = torch.clamp(s * sc, 0.0, lut_max)
    if interp == "nearest":
        idx = {ch: (scaled[ch] + 0.5).to(torch.int64)
               for ch in "rgb"}          # NEAR(x) = (int)(x + .5)
        vec = _interp(flat, S, idx["r"], idx["g"], idx["b"],
                      None, None, None, "nearest")
    else:
        prev = {ch: scaled[ch].to(torch.int64) for ch in "rgb"}
        d = {ch: scaled[ch] - prev[ch].to(torch.float32) for ch in "rgb"}
        vec = _interp(flat, S, prev["r"], prev["g"], prev["b"],
                      d["r"], d["g"], d["b"], interp)
    imax = int(maxval)
    new = {ch: torch.clamp((vec[..., ci] * float(maxval)).to(torch.int32),
                           0, imax) for ci, ch in enumerate("rgb")}
    return fb.with_planes({"rgb": set_channels(arr, order, new)})


# ---- lut1d (vf_lut3d.c CONFIG_LUT1D_FILTER section) -------------------------

INTERP_1D_MODES = ("nearest", "linear", "cubic", "cosine", "spline")


def parse_cube_1d(text: str) -> Tuple[np.ndarray, np.ndarray]:
    """1D .cube -> (lut (S, 3) float32, scale (3,)).  Same scan/break
    structure as parse_cube (parse_cube_1d, vf_lut3d.c:1638-1694) with
    the extra LUT_1D_INPUT_RANGE header (two floats applied to all
    three channels)."""
    size = None
    mn = np.zeros(3, np.float64)
    mx = np.ones(3, np.float64)
    vals = []
    for line in _data_lines(text):
        u = line.upper()
        if u.startswith("LUT_1D_SIZE"):
            parts = line.split()
            try:
                size = int(parts[1], 0)
            except (IndexError, ValueError):
                raise LutError(f"bad LUT_1D_SIZE line {line!r}") from None
            if not 2 <= size <= 65536:          # MAX_1D_LEVEL
                raise LutError(f"bad LUT_1D_SIZE {size}")
        elif size is None:
            continue
        elif len(vals) >= size:
            break
        elif u.startswith("LUT_1D_INPUT_RANGE"):
            try:
                lo, hi = (float(v) for v in line.split()[1:3])
            except ValueError:
                raise LutError(f"bad LUT_1D_INPUT_RANGE {line!r}") \
                    from None
            mn[:] = lo
            mx[:] = hi
        elif u.startswith("DOMAIN_MIN") or u.startswith("DOMAIN_MAX"):
            try:
                trio = [float(v) for v in line.split()[1:4]]
            except ValueError:
                raise LutError(f"bad DOMAIN line {line!r}") from None
            if len(trio) != 3:
                raise LutError(f"bad DOMAIN line {line!r}")
            (mn if u.startswith("DOMAIN_MIN") else mx)[:] = trio
        elif u.startswith("TITLE"):
            pass
        elif u.startswith("LUT_3D_SIZE"):
            raise LutError("3D .cube passed to lut1d")
        else:
            parts = line.split()
            if len(parts) < 3:              # av_sscanf != 3 -> error
                raise LutError(f"bad .cube data line {line!r}")
            try:
                vals.append((float(parts[0]), float(parts[1]),
                             float(parts[2])))
            except ValueError:
                raise LutError(f"bad .cube data line {line!r}") \
                    from None
    if size is None:
        raise LutError(".cube has no LUT_1D_SIZE")
    if len(vals) < size:
        raise LutError(f".cube has {len(vals)} entries, needs {size}")
    lut = np.asarray(vals[:size], np.float32)
    scale = np.clip(1.0 / (mx - mn), 0.0, 1.0).astype(np.float32)
    return lut, scale


def identity_lut_1d(size: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    c = np.float32(1.0 / (size - 1))
    i = np.arange(size, dtype=np.float32) * c
    return np.stack([i, i, i], axis=-1), np.ones(3, np.float32)


def load_lut1d_file(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with open(path, "r", errors="replace") as f:
        text = f.read()
    if path.lower().endswith(".cube"):
        return parse_cube_1d(text)
    raise LutError(f"unsupported 1D LUT extension on {path!r} "
                   "(.cube supported)")


def _interp_1d(col, S, s, mode):
    """One channel: s (N,H,W) scaled positions, col (S,) table on their
    device."""
    prev = s.to(torch.int64)
    nxt = torch.clamp(prev + 1, max=S - 1)
    d = s - prev.to(torch.float32)
    p = col[prev]
    n = col[nxt]
    if mode == "nearest":
        return col[(s + 0.5).to(torch.int64)]
    if mode == "linear":
        return p + (n - p) * d
    if mode == "cosine":
        m = (1.0 - torch.cos(d * float(np.float32(math.pi)))) * 0.5
        return p + (n - p) * m
    y0 = col[torch.clamp(prev - 1, min=0)]
    y3 = col[torch.clamp(nxt + 1, max=S - 1)]
    if mode == "cubic":
        mu2 = d * d
        a0 = y3 - n - y0 + p
        a1 = y0 - p - a0
        a2 = n - y0
        return a0 * d * mu2 + a1 * mu2 + a2 * d + p
    if mode == "spline":
        c0 = p
        c1 = 0.5 * (n - y0)
        c2 = y0 - 2.5 * p + 2.0 * n - 0.5 * y3
        c3 = 0.5 * (y3 - y0) + 1.5 * (p - n)
        return ((c3 * d + c2) * d + c1) * d + c0
    raise LutError(f"unknown 1D interp mode {mode!r}; use one of "
                   f"{INTERP_1D_MODES}")


def apply_lut1d(fb: FrameBatch, lut: np.ndarray, scale: np.ndarray,
                interp: str = "linear") -> FrameBatch:
    """Apply per-channel 1D curves to an integer RGB FrameBatch."""
    fmt = fb.fmt
    if not fmt.is_rgb or fmt.is_float:
        raise LutError("lut1d operates on integer RGB frames "
                       "(format=rgb24/... first)")
    S = lut.shape[0]
    order = fmt.channel_order
    arr = fb.planes["rgb"]
    maxval = np.float32((1 << fmt.bits) - 1)
    table = _on_device(lut, arr.device)
    imax = int(maxval)
    new = {}
    for ci, ch in enumerate("rgb"):
        # the 1D kernel precombines ONE f32 constant
        # (scale.c / factor) * (lutsize-1) and does a single multiply,
        # with no position clip (DEFINE_INTERP_FUNC_PLANAR_1D)
        sc = float((np.float32(scale[ci]) / maxval) * np.float32(S - 1))
        pos = arr[..., order.index(ch)].to(torch.float32) * sc
        vec = _interp_1d(table[:, ci].contiguous(), S, pos, interp)
        new[ch] = torch.clamp((vec * float(maxval)).to(torch.int32), 0,
                              imax)
    return fb.with_planes({"rgb": set_channels(arr, order, new)})
