"""Color-space conversion — counterpart of `gmat_tpu/ops/csc.py`.

Only what the fused preprocess ladder reaches: YUV -> RGB and the
NCHW handoff.  Chroma upsampling is nearest (2x2 shares one U,V), like
the reference kernels.  `exact=True` truncates like the reference's C
float->int casts; the default rounds to nearest.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core import formats as F
from ..core.color import yuv2rgb_matrix, yuv_offsets
from ..core.frame import FrameBatch, torch_dtype


def _container_bits(fmt: F.PixelFormat) -> int:
    return np.dtype(fmt.planes[0].dtype).itemsize * 8


def _offset_bits(fmt: F.PixelFormat) -> int:
    # p010/p016 carry samples in the high bits of u16, so offsets use the
    # container width; lsb-aligned yuv420p10 uses its true bit depth.
    if fmt.name in ("p010", "p016", "yuv420p16"):
        return 16
    return fmt.bits


def _quantize(x: torch.Tensor, maxv: float, exact: bool) -> torch.Tensor:
    x = torch.clamp(x, 0.0, maxv)
    return torch.floor(x) if exact else torch.round(x)


def _chroma_up(c: torch.Tensor, sub_h: int, sub_w: int) -> torch.Tensor:
    """Nearest chroma upsample to luma resolution for any per-axis
    subsampling (4:2:0 = 1,1; 4:2:2 = 0,1)."""
    if sub_h:
        c = torch.repeat_interleave(c, 1 << sub_h, dim=1)
    if sub_w:
        c = torch.repeat_interleave(c, 1 << sub_w, dim=2)
    return c


def _yuv_to_float(fb: FrameBatch):
    """Return (y, u, v) as f32 at luma resolution, offsets removed."""
    fmt = fb.fmt
    bits = _offset_bits(fmt)
    low, mid = yuv_offsets(bits)
    y = fb.planes["y"].to(torch.float32) - low
    if "u" not in fb.planes:           # gray8: neutral chroma
        z = torch.zeros_like(y)
        return y, z, z
    u = fb.planes["u"].to(torch.float32) - mid
    v = fb.planes["v"].to(torch.float32) - mid
    pu = fmt.plane("u")
    if pu.sub_w or pu.sub_h:   # 4:2:0 / 4:2:2 -> upsample to 4:4:4
        u = _chroma_up(u, pu.sub_h, pu.sub_w)
        v = _chroma_up(v, pu.sub_h, pu.sub_w)
    return y, u, v


def _pack_rgb(r, g, b, out_fmt: F.PixelFormat, src_maxv: float, exact: bool,
              norm: Optional[float], shift: Optional[Sequence[float]],
              src_float: bool = False) -> torch.Tensor:
    """Take float RGB in [0, src_maxv] and pack into the target format."""
    if out_fmt.is_float:
        # canonical float-RGB range is [0, 1]; (x-shift)/norm on request
        chans = {"r": r, "g": g, "b": b}
        sh = shift or (0.0, 0.0, 0.0)
        nm = norm if norm is not None else src_maxv
        if src_float:
            out = [torch.clamp(chans[c], 0, src_maxv) for c in "rgb"]
        else:
            out = [(torch.clamp(chans[c], 0, src_maxv) if exact else
                    torch.clamp(torch.round(chans[c]), 0, src_maxv))
                   for c in "rgb"]
        out = [(o - s) / nm for o, s in zip(out, sh)]
        if out_fmt.channel_order.startswith("bgr"):
            out = out[::-1]
        if len(out_fmt.channel_order) == 4:
            out.append(torch.ones_like(out[0]))
        return torch.stack(out, dim=-1).to(torch.float32)
    dst_bits = _container_bits(out_fmt)
    src_bits = int(round(np.log2(src_maxv + 1)))
    q = [_quantize(c, src_maxv, exact) for c in (r, g, b)]
    if dst_bits > src_bits:
        q = [c * (1 << (dst_bits - src_bits)) for c in q]
    elif dst_bits < src_bits:
        q = [torch.floor(c / (1 << (src_bits - dst_bits))) for c in q]
    chans = dict(r=q[0], g=q[1], b=q[2])
    # alpha=255 even at 16-bit matches the reference's DEFAULT_ALPHA quirk
    alpha = float((1 << dst_bits) - 1) if dst_bits <= 8 else 255.0
    out = [chans[c] if c != "a" else torch.full_like(q[0], alpha)
           for c in out_fmt.channel_order]
    return torch.stack(out, dim=-1).to(torch_dtype(out_fmt.planes[0].dtype))


def yuv_to_rgb(fb: FrameBatch, out_format: str = "rgb24", *,
               exact: bool = False, norm: Optional[float] = None,
               shift: Optional[Sequence[float]] = None) -> FrameBatch:
    """YUV (any registered 4:2:0 / 4:4:4 depth) -> RGB (any registered)."""
    out_fmt = F.get(out_format)
    if not out_fmt.is_rgb:
        raise ValueError(f"yuv_to_rgb needs an RGB output, got {out_format}")
    mat = yuv2rgb_matrix(fb.colorspace)
    y, u, v = _yuv_to_float(fb)
    maxv = float((1 << _offset_bits(fb.fmt)) - 1)
    m = [[float(c) for c in row] for row in mat]
    r = m[0][0] * y + m[0][1] * u + m[0][2] * v
    g = m[1][0] * y + m[1][1] * u + m[1][2] * v
    b = m[2][0] * y + m[2][1] * u + m[2][2] * v
    r, g, b = (torch.clamp(c, 0.0, maxv) for c in (r, g, b))
    rgb = _pack_rgb(r, g, b, out_fmt, maxv, exact, norm, shift)
    return fb.with_planes({"rgb": rgb}, out_format)


def to_nchw(fb: FrameBatch) -> torch.Tensor:
    """Packed (N,H,W,C) RGB batch -> NCHW fp32 planar (the RGBPF32 tensor
    shape DL models consume)."""
    return fb.planes["rgb"].permute(0, 3, 1, 2).to(torch.float32).contiguous()
