"""Geometric ops: crop / flip / rotate / pad — counterpart of
`gmat_tpu/ops/geometry.py`.

  * crop_nvcv  (libavfilter/vf_crop_nvcv.c:80-86: w/h/x/y, centered when
    x or y is -1)
  * flip_nvcv  (vf_flip_nvcv.c:78: code 0=vertical, 1=horizontal, -1=both;
    OpenCV flipCode semantics)
  * rotate_nvcv (vf_rotate_nvcv.c:83-86: angle in degrees, interp
    linear/nearest/cubic/area, shift_x/shift_y added after rotation)
  * pad (vf_pad.c: the frame on a larger solid-color canvas)

Rotate maps every destination pixel back to source coordinates and
samples there with its own gathers and weights (the JAX module's
arithmetic, not `F.grid_sample`, whose coordinate and border conventions
differ).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..core import formats as F
from ..core.frame import FrameBatch, same_bits, torch_dtype


def crop(fb: FrameBatch, w: int, h: int, x: int = -1, y: int = -1) -> FrameBatch:
    """Crop to (w, h) with top-left (x, y); -1 centers (vf_crop_nvcv.c
    config_props default)."""
    if w <= 0 or h <= 0:
        raise ValueError(f"crop size must be positive, got {w}x{h}")
    if x < 0:
        x = (fb.width - w) // 2
    if y < 0:
        y = (fb.height - h) // 2
    if x + w > fb.width or y + h > fb.height:
        raise ValueError(f"crop {w}x{h}+{x}+{y} outside {fb.width}x{fb.height}")
    fmt = fb.fmt
    if fmt.is_yuv:
        # per-axis alignment: 4:2:2 subsamples width only, so odd y/h
        # are legal there (ffmpeg/CV-CUDA agree)
        sw = max((p.sub_w for p in fmt.planes), default=0)
        sh = max((p.sub_h for p in fmt.planes), default=0)
        if ((x | w) & ((1 << sw) - 1)) or ((y | h) & ((1 << sh) - 1)):
            raise ValueError(
                "subsampled crop offsets/sizes must align to the "
                f"chroma grid ({1 << sw}x{1 << sh}) for {fmt.name}")
    planes = {}
    for p in fmt.planes:
        px, py = x >> p.sub_w, y >> p.sub_h
        pw, ph = w >> p.sub_w, h >> p.sub_h
        planes[p.name] = fb.planes[p.name][:, py:py + ph, px:px + pw]
    return fb.with_planes(planes, width=w, height=h)


_FLIP_DIMS = {0: (1,), 1: (2,), -1: (1, 2)}


def flip_tensor(arr: torch.Tensor, dims) -> torch.Tensor:
    """`arr.flip(dims)` for every plane dtype (uint16 through its int16
    view: torch.flip has no uint16 kernel on the CPU)."""
    return same_bits(torch.flip, arr, dims=dims)


def flip(fb: FrameBatch, code: int = 0) -> FrameBatch:
    """code: 0 = flip vertically (around x-axis), 1 = horizontally,
    -1 = both (OpenCV flipCode, vf_flip_nvcv.c:78)."""
    if code not in _FLIP_DIMS:
        raise ValueError("flip code must be -1, 0 or 1")
    return fb.with_planes({name: flip_tensor(arr, _FLIP_DIMS[code])
                           for name, arr in fb.planes.items()})


def _gather(flat: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor,
            w: int) -> torch.Tensor:
    """(M, H*W) samples at integer (yy, xx) grids -> (M, H', W')."""
    return flat[:, (yy * w + xx).reshape(-1)].reshape(flat.shape[0],
                                                      *yy.shape)


def _inside(sy, sx, h: int, w: int, eps: float = 1e-4) -> torch.Tensor:
    return ((sy >= -eps) & (sy <= h - 1 + eps) &
            (sx >= -eps) & (sx <= w - 1 + eps))


def _bilinear_sample(img: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                     fill: float = 0.0) -> torch.Tensor:
    """Sample (N,H,W) img at float coords (H',W') grids; outside -> fill."""
    h, w = img.shape[1], img.shape[2]
    valid = _inside(sy, sx, h, w)
    sy = torch.clamp(sy, 0.0, h - 1.0)
    sx = torch.clamp(sx, 0.0, w - 1.0)
    y0 = torch.floor(sy).to(torch.int64)
    x0 = torch.floor(sx).to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    fy = (sy - y0.to(torch.float32))[None]
    fx = (sx - x0.to(torch.float32))[None]
    flat = img.reshape(img.shape[0], -1).to(torch.float32)
    v00, v01 = _gather(flat, y0, x0, w), _gather(flat, y0, x1, w)
    v10, v11 = _gather(flat, y1, x0, w), _gather(flat, y1, x1, w)
    out = (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx +
           v10 * fy * (1 - fx) + v11 * fy * fx)
    return torch.where(valid[None], out, fill)


def _cubic_weight(f: torch.Tensor, k: int) -> torch.Tensor:
    """Keys cubic (a=-0.75) weight of tap k (0..3) at fraction f."""
    x = torch.abs(f - (k - 1))
    a = -0.75
    return torch.where(
        x <= 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
        torch.where(x < 2.0, ((a * x - 5.0 * a) * x + 8.0 * a) * x - 4.0 * a,
                    0.0))


def _cubic_sample(img: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                  fill: float = 0.0) -> torch.Tensor:
    """Keys bicubic (a=-0.75, OpenCV/CV-CUDA INTER_CUBIC) 4x4 sampling."""
    h, w = img.shape[1], img.shape[2]
    valid = _inside(sy, sx, h, w)
    sy = torch.clamp(sy, 0.0, h - 1.0)
    sx = torch.clamp(sx, 0.0, w - 1.0)
    y0 = torch.floor(sy).to(torch.int64)
    x0 = torch.floor(sx).to(torch.int64)
    fy = sy - y0.to(torch.float32)
    fx = sx - x0.to(torch.float32)
    flat = img.reshape(img.shape[0], -1).to(torch.float32)
    out = wsum = None
    for ky in range(4):
        yy = torch.clamp(y0 + (ky - 1), 0, h - 1)
        wy = _cubic_weight(fy, ky)[None]
        for kx in range(4):
            xx = torch.clamp(x0 + (kx - 1), 0, w - 1)
            wx = _cubic_weight(fx, kx)[None]
            t = _gather(flat, yy, xx, w) * (wy * wx)
            out = t if out is None else out + t
            wsum = wy * wx if wsum is None else wsum + wy * wx
    out = out / torch.clamp(wsum, min=1e-6)
    return torch.where(valid[None], out, fill)


def _nearest_sample(img: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                    fill: float = 0.0) -> torch.Tensor:
    h, w = img.shape[1], img.shape[2]
    valid = (sy >= -0.5) & (sy < h - 0.5) & (sx >= -0.5) & (sx < w - 0.5)
    # floor(x+0.5), not round-half-even: half-integer coordinates would
    # duplicate even / drop odd pixels (resample_matrix's convention)
    y = torch.clamp(torch.floor(sy + 0.5), 0, h - 1).to(torch.int64)
    x = torch.clamp(torch.floor(sx + 0.5), 0, w - 1).to(torch.int64)
    flat = img.reshape(img.shape[0], -1).to(torch.float32)
    return torch.where(valid[None], _gather(flat, y, x, w), fill)


_SAMPLERS = {"linear": _bilinear_sample, "bilinear": _bilinear_sample,
             "cubic": _cubic_sample, "bicubic": _cubic_sample,
             "nearest": _nearest_sample, "point": _nearest_sample,
             "area": None}


def rotate(fb: FrameBatch, angle_deg: float, interp: str = "linear",
           shift_x: float = 0.0, shift_y: float = 0.0,
           center: Optional[bool] = None) -> FrameBatch:
    """Rotate by angle (degrees, CCW like CV-CUDA) with post-shift.

    A dst pixel (x, y) samples src at R(-angle) @ (x - shift), as
    CV-CUDA Rotate does.  center=True rotates about the image center
    (the shift is computed for you)."""
    if interp not in _SAMPLERS:
        raise ValueError(f"rotate interp {interp!r} "
                         "(linear|cubic|nearest|area)")
    a = math.radians(angle_deg)
    cos_a, sin_a = math.cos(a), math.sin(a)
    # snap exact multiples of 90 degrees (kills 6e-17 noise at the edges)
    for v in (-1.0, 0.0, 1.0):
        if abs(cos_a - v) < 1e-12:
            cos_a = v
        if abs(sin_a - v) < 1e-12:
            sin_a = v
    w, h = fb.width, fb.height
    if center:
        # shift that keeps the center fixed: c - R(angle) @ c
        cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
        shift_x = cx - (cos_a * cx + sin_a * cy)
        shift_y = cy - (-sin_a * cx + cos_a * cy)

    fmt = fb.fmt
    sample = _SAMPLERS[interp]
    planes = {}
    for p in fmt.planes:
        ph, pw = h >> p.sub_h, w >> p.sub_w
        # rotate in LUMA coordinates, conjugated by the per-axis chroma
        # scales (4:2:2 subsampling does not commute with rotation)
        fsx, fsy = float(1 << p.sub_w), float(1 << p.sub_h)
        ys = torch.arange(ph, dtype=torch.float32,
                          device=fb.device)[:, None].expand(ph, pw)
        xs = torch.arange(pw, dtype=torch.float32,
                          device=fb.device)[None, :].expand(ph, pw)

        def src_coords(xs, ys, fsx=fsx, fsy=fsy):
            xs_ = xs * fsx - shift_x
            ys_ = ys * fsy - shift_y
            return ((cos_a * xs_ - sin_a * ys_) / fsx,
                    (sin_a * xs_ + cos_a * ys_) / fsy)

        arr = fb.planes[p.name]
        packed = arr.ndim == 4
        if packed:
            n, hh, ww, c = arr.shape
            arr = arr.permute(0, 3, 1, 2).reshape(n * c, hh, ww)
        # out-of-frame fill: black, i.e. neutral chroma on u/v
        fill = 0.0
        if fmt.is_yuv and p.name in ("u", "v"):
            fill = float(1 << (fmt.bits - 1))
            if fmt.name in ("p010", "p016", "yuv420p16"):
                fill = float(1 << 15)
        if sample is None:
            # NVCV_INTERP_AREA: box-average the dst pixel's source
            # preimage, a 3x3 supersample with bilinear taps
            offs = (-1.0 / 3.0, 0.0, 1.0 / 3.0)
            acc = None
            for dy in offs:
                for dx in offs:
                    ssx, ssy = src_coords(xs + dx, ys + dy)
                    smp = _bilinear_sample(arr, ssy, ssx, fill)
                    acc = smp if acc is None else acc + smp
            out = acc / 9.0
        else:
            sx, sy = src_coords(xs, ys)
            out = sample(arr, sy, sx, fill)
        if packed:
            out = out.reshape(n, c, ph, pw).permute(0, 2, 3, 1)
        if not fmt.is_float:
            out = torch.clamp(torch.round(out), 0, F.clip_value(fmt))
        planes[p.name] = out.to(torch_dtype(fmt.planes[0].dtype)).contiguous()
    return fb.with_planes(planes)


# ---------------------------------------------------------------- pad
# vf_pad.c analog: place the frame on a larger solid-color canvas.

_COLOR_NAMES = {
    "black": (0, 0, 0), "white": (255, 255, 255), "red": (255, 0, 0),
    "lime": (0, 255, 0), "green": (0, 128, 0), "blue": (0, 0, 255),
    "yellow": (255, 255, 0), "cyan": (0, 255, 255), "aqua": (0, 255, 255),
    "magenta": (255, 0, 255), "fuchsia": (255, 0, 255),
    "gray": (128, 128, 128), "grey": (128, 128, 128),
    "navy": (0, 0, 128), "silver": (192, 192, 192),
    "orange": (255, 165, 0), "pink": (255, 192, 203),
}


def parse_color_rgba(s: str):
    """av_parse_color subset, the one color parser every filter shares:
    names, #RGB[A] / #RRGGBB[AA] / 0x-prefixed hex, bare RRGGBB hex,
    name@A (A as 0..1 float, or 0..255 when > 1).  Returns (r, g, b, a)."""
    s = str(s).strip().lower()
    alpha = 255
    explicit = False                          # av_parse_color: @A wins
    if "@" in s:
        s, aspec = s.split("@", 1)
        try:
            av = float(aspec)
        except ValueError:
            raise ValueError(f"bad alpha {aspec!r} in color") from None
        alpha = int(av * 255 + 0.5) if av <= 1.0 else int(av)
        alpha = min(max(alpha, 0), 255)
        explicit = True
    if s in _COLOR_NAMES:
        return _COLOR_NAMES[s] + (alpha,)
    h = s[1:] if s.startswith("#") else s[2:] if s.startswith("0x") else s
    if len(h) in (3, 4):                      # #RGB / #RGBA short hex
        h = "".join(c * 2 for c in h)
    if len(h) in (6, 8) and all(c in "0123456789abcdef" for c in h):
        if len(h) == 8 and not explicit:
            alpha = int(h[6:8], 16)
        return (int(h[0:2], 16), int(h[2:4], 16), int(h[4:6], 16), alpha)
    raise ValueError(f"unknown color {s!r} (use a name, #RGB, RRGGBB, "
                     "or 0xRRGGBB)")


def parse_color(s: str):
    """RGB-only view of parse_color_rgba (alpha dropped)."""
    return parse_color_rgba(s)[:3]


def _yuv_fill(rgb, cspace: str, fmt):
    """Solid RGB -> per-plane YUV fill values at the frame's depth
    (limited range, 8-bit studio math scaled to the sample layout:
    lsb-aligned for yuv*pN, msb-aligned for p010/p016)."""
    from ..core import color as cc
    mat = np.asarray(cc.rgb2yuv_matrix(cspace), np.float64)
    r, g, b = (float(v) for v in rgb)
    y = mat[0] @ (r, g, b) + 16.0      # 8-bit studio swing, scaled below
    u = mat[1] @ (r, g, b) + 128.0
    v = mat[2] @ (r, g, b) + 128.0
    msb = fmt.name in ("p010", "p016", "yuv420p16")
    scale = float(1 << (16 - 8)) if msb else float(1 << (fmt.bits - 8))
    maxv = float((1 << 16) - 1) if msb else float((1 << fmt.bits) - 1)
    return {k: int(np.clip(round(val * scale), 0, maxv))
            for k, val in (("y", y), ("u", u), ("v", v))}


def pad(fb: FrameBatch, w: int, h: int, x: int = 0, y: int = 0,
        color: str = "black") -> FrameBatch:
    """Pad to (w, h) with the frame's top-left at (x, y); the border is
    `color`.  vf_pad.c semantics: out-of-range x/y fall back to centered,
    then w/h/x/y round DOWN to the chroma grid."""
    w, h, x, y = int(w), int(h), int(x), int(y)
    # centering fallback BEFORE grid rounding, like config_output
    if x < 0 or x + fb.width > w:
        x = (w - fb.width) // 2 if w >= fb.width else x
    if y < 0 or y + fb.height > h:
        y = (h - fb.height) // 2 if h >= fb.height else y
    fmt = fb.fmt
    rgb = parse_color(color)
    if fmt.is_yuv:
        sw = max((p.sub_w for p in fmt.planes), default=0)
        sh = max((p.sub_h for p in fmt.planes), default=0)
        w, x = (w >> sw) << sw, (x >> sw) << sw
        h, y = (h >> sh) << sh, (y >> sh) << sh
        fills = _yuv_fill(rgb, fb.colorspace, fmt)
    if w < fb.width or h < fb.height:
        raise ValueError(f"pad target {w}x{h} smaller than input "
                         f"{fb.width}x{fb.height}")
    if x < 0 or y < 0 or x + fb.width > w or y + fb.height > h:
        raise ValueError(f"pad placement {x},{y} puts the frame outside "
                         f"{w}x{h}")
    planes = {}
    for p in fmt.planes:
        arr = fb.planes[p.name]
        if fmt.is_yuv:
            pw, ph = w >> p.sub_w, h >> p.sub_h
            px, py = x >> p.sub_w, y >> p.sub_h
            canvas = torch.full((arr.shape[0], ph, pw), fills.get(p.name, 0),
                                dtype=arr.dtype, device=arr.device)
            canvas[:, py:py + arr.shape[1], px:px + arr.shape[2]] = arr
        else:
            order = fmt.channel_order or "rgb"
            chan = {"r": rgb[0], "g": rgb[1], "b": rgb[2], "a": 255}
            vec = np.array([chan[c] for c in order], np.float64)
            if fmt.is_float:
                vec = vec / 255.0
            elif fmt.bits > 8:
                vec = vec * ((1 << fmt.bits) - 1) / 255.0
            val = torch.as_tensor(vec if fmt.is_float else np.round(vec),
                                  device=arr.device).to(arr.dtype)
            canvas = val.expand(arr.shape[0], h, w, len(order)).contiguous()
            canvas[:, y:y + arr.shape[1], x:x + arr.shape[2], :] = arr
        planes[p.name] = canvas
    return FrameBatch(planes, fb.format, w, h, fb.colorspace)
