"""eq, lut and unsharp — counterpart of `gmat_tpu/ops/enhance.py`.

  * eq (vf_eq.c): per-plane 256-entry LUTs with vf_eq.c's exact math
    (create_lut, vf_eq.c:37-60) —
        v = contrast * (i/255 - 0.5) + 0.5 + brightness
        v <= 0 -> 0;  else v = v*(1-gw) + v^(1/gamma)*gw;  v >= 1 -> 255
        else floor(256*v)                   (the C uint8 truncation)
    luma gets contrast/brightness and gamma*gamma_g; chroma planes get
    contrast=saturation and gammas sqrt(gamma_b/gamma_g) (U) /
    sqrt(gamma_r/gamma_g) (V) (vf_eq.c:95-135).
  * lut / lutyuv / lutrgb: per-component tables applied as gathers.
  * unsharp (vf_unsharp.c): the exact integer pipeline.  The JAX module
    blurs with int32 band-matrix products; PyTorch has no int32 matmul
    on CUDA and an f32 one is not exact past 2^24, so the binomial blur
    here is clamped shifted sums in int64, the same on the CPU and the
    card, with the reference's uint32 wrap-around kept by masking.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.frame import FrameBatch, same_bits
from .lut import apply_lut


def _clipf(v, lo, hi):
    return min(max(float(v), lo), hi)


def _lut(contrast: float, brightness: float, gamma: float,
         gamma_weight: float) -> np.ndarray:
    i = np.arange(256, dtype=np.float64) / 255.0
    v = contrast * (i - 0.5) + 0.5 + brightness
    out = np.zeros(256, np.float64)
    pos = v > 0.0
    vp = v[pos]
    g = 1.0 / gamma
    vv = vp * (1.0 - gamma_weight) + np.power(vp, g) * gamma_weight
    out[pos] = np.where(vv >= 1.0, 255.0, np.floor(256.0 * vv))
    return np.clip(out, 0, 255).astype(np.uint8)


def _identity(contrast: float, brightness: float, gamma: float) -> bool:
    # vf_eq check_values: the plane is skipped entirely when nothing acts
    return contrast == 1.0 and brightness == 0.0 and gamma == 1.0


def eq(fb: FrameBatch, contrast: float = 1.0, brightness: float = 0.0,
       saturation: float = 1.0, gamma: float = 1.0, gamma_r: float = 1.0,
       gamma_g: float = 1.0, gamma_b: float = 1.0,
       gamma_weight: float = 1.0) -> FrameBatch:
    """Apply vf_eq adjustments; clips match the AVOption ranges
    (contrast [-1000,1000], brightness [-1,1], saturation [0,3],
    gammas [0.1,10], gamma_weight [0,1])."""
    fmt = fb.fmt
    if not fmt.is_yuv or fmt.bits != 8:
        raise ValueError("eq operates on 8-bit planar YUV (vf_eq.c "
                         "pixel_fmts_eq); convert first")
    contrast = _clipf(contrast, -1000.0, 1000.0)
    brightness = _clipf(brightness, -1.0, 1.0)
    saturation = _clipf(saturation, 0.0, 3.0)
    gamma = _clipf(gamma, 0.1, 10.0)
    gamma_r = _clipf(gamma_r, 0.1, 10.0)
    gamma_g = _clipf(gamma_g, 0.1, 10.0)
    gamma_b = _clipf(gamma_b, 0.1, 10.0)
    gamma_weight = _clipf(gamma_weight, 0.0, 1.0)

    # vf_eq.c:113-135 per-plane parameterization
    params = {
        "y": (contrast, brightness, gamma * gamma_g),
        "u": (saturation, 0.0, math.sqrt(gamma_b / gamma_g)),
        "v": (saturation, 0.0, math.sqrt(gamma_r / gamma_g)),
    }
    planes = {}
    for name, arr in fb.planes.items():
        c, b, g = params.get(name, (1.0, 0.0, 1.0))
        if _identity(c, b, g):
            planes[name] = arr
            continue
        planes[name] = apply_lut(arr, _lut(c, b, g, gamma_weight))
    return fb.with_planes(planes)


# ---- lut / lutyuv / lutrgb --------------------------------------------------

def apply_luts(fb: FrameBatch, luts) -> FrameBatch:
    """Apply per-component lookup tables, one gather per plane.

    `luts` maps plane name -> numpy table: shape (size,) for
    single-channel planes, (C, size) for packed planes (C = channel
    count).  Identity tables are skipped, so untouched planes alias the
    input tensors (observationally identical to applying them)."""
    planes = dict(fb.planes)
    for name, tab in luts.items():
        arr = fb.planes[name]
        tab = np.asarray(tab)
        if tab.ndim == 1:
            if np.array_equal(tab, np.arange(tab.size, dtype=tab.dtype)):
                continue
            planes[name] = apply_lut(arr, tab)
        else:
            ident = np.arange(tab.shape[1], dtype=tab.dtype)
            chans = [arr[..., c] if np.array_equal(tab[c], ident)
                     else apply_lut(arr[..., c], tab[c])
                     for c in range(tab.shape[0])]
            planes[name] = same_bits(lambda *c: torch.stack(c, dim=-1),
                                     *chans)
    return fb.with_planes(planes)


# ---- unsharp (vf_unsharp.c) -------------------------------------------------

def _binomial_taps(steps: int) -> np.ndarray:
    """The vf_unsharp blur along one axis as 2*steps+1 taps: the
    reference's sr/sc accumulator cascade (vf_unsharp.c:114-125) is
    2*steps chained 2-tap running sums == the BINOMIAL kernel
    C(2*steps, k), sum 2^(2*steps), read with clamp-at-edge sampling.
    (The JAX module folds the same taps into a band matrix.)"""
    row = np.ones(1, np.int64)
    for _ in range(2 * steps):
        row = np.convolve(row, [1, 1])
    return row


def _blur_axis(x: torch.Tensor, steps: int, axis: int) -> torch.Tensor:
    """out[i] = sum_k C(2s, k) * x[clamp(i + k - s)] along `axis`, int64."""
    n = x.shape[axis]
    idx = np.clip(np.arange(-steps, n + steps), 0, n - 1)
    xp = x.index_select(axis, torch.as_tensor(idx, device=x.device))
    out = None
    for k, c in enumerate(_binomial_taps(steps)):
        term = xp.narrow(axis, k, n) * int(c)
        out = term if out is None else out + term
    return out


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to the int32 range (two's complement)."""
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _unsharp_plane(arr: torch.Tensor, msx: int, msy: int, amount: int,
                   bits: int) -> torch.Tensor:
    """One plane: blur = (binomial blur + half) >> scalebits, then
    res = clip(p + ((p - blur) * amount) >> (8 + bits)) — the exact
    integer pipeline of DEF_UNSHARP_SLICE_FUNC (vf_unsharp.c:60-141), with
    the JAX module's int32 wrap-around reproduced bit for bit: the blur
    sum wraps mod 2^32 and shifts logically, the sharpening product wraps
    to int32 and shifts arithmetically."""
    sx, sy = msx // 2, msy // 2
    scalebits = (sx + sy) * 2
    half = 1 << (scalebits - 1)
    x = arr.to(torch.int64)
    acc = _blur_axis(_blur_axis(x, sy, 1), sx, 2)
    blur = ((acc + half) & 0xFFFFFFFF) >> scalebits
    res = x + (_wrap_int32((x - blur) * amount) >> (8 + bits))
    maxv = (1 << bits) - 1
    return torch.clamp(res, 0, maxv).to(arr.dtype)


def unsharp(fb: FrameBatch, lx: int = 5, ly: int = 5, la: float = 1.0,
            cx: int = 5, cy: int = 5, ca: float = 0.0) -> FrameBatch:
    """vf_unsharp: sharpen (amount>0) or blur (amount<0) luma and chroma
    independently.  Matrix sizes odd 3..23, amounts clipped like the
    AVOption range [-2, 5]; amount scales by 65536 with C double->int
    truncation (set_filter_param, vf_unsharp.c:174-183).  amount==0
    passes the plane through untouched."""
    fmt = fb.fmt
    if fmt.is_rgb or fmt.is_float or fmt.name in ("p010", "p016"):
        raise ValueError("unsharp operates on planar YUV/gray "
                         "(vf_unsharp.c avfilter_vf_unsharp formats)")
    for v, nm in ((lx, "lx"), (ly, "ly"), (cx, "cx"), (cy, "cy")):
        if not 3 <= v <= 23:        # AVOption MIN_SIZE..MAX_SIZE; even
            raise ValueError(        # values floor to odd via msize/2
                f"unsharp {nm}={v}: matrix size must be 3..23")
    la = min(max(float(la), -2.0), 5.0)
    ca = min(max(float(ca), -2.0), 5.0)
    # the reference selects the 8- vs 16-bit slice macro by CONTAINER
    # width (vf_unsharp.c:142-143): 10-bit lsb-aligned planes shift by
    # 8+16 and clip at 65535, not 1023
    bits = np.dtype(fmt.planes[0].dtype).itemsize * 8
    # the reference's only size gate (init, vf_unsharp.c:194)
    for mx, my, nm in ((lx, ly, "luma"), (cx, cy, "chroma")):
        if (mx // 2 + my // 2) * 2 >= 26:
            raise ValueError(f"unsharp: {nm} matrix size too big "
                             "(scalebits >= 26, vf_unsharp.c init)")
    lam, cam = int(la * 65536.0), int(ca * 65536.0)
    planes = {}
    for p in fmt.planes:
        arr = fb.planes[p.name]
        msx, msy, am = (lx, ly, lam) if p.name == "y" else (cx, cy, cam)
        planes[p.name] = arr if am == 0 else _unsharp_plane(
            arr, msx, msy, am, bits)
    return fb.with_planes(planes)
