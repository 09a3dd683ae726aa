"""Color-space conversion — counterpart of `gmat_tpu/ops/csc.py`.

YUV <-> RGB, YUV depth/layout, RGB reorder/depth/float, the `convert`
dispatcher and the NCHW handoff, as plain tensor ops on the batch's
device.  Chroma upsampling is nearest (2x2 shares one U,V) and chroma
downsampling the 2x2 average, like the reference kernels.  `exact=True`
truncates like the reference's C float->int casts; the default rounds
to nearest.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core import formats as F
from ..core.color import rgb2yuv_matrix, yuv2rgb_matrix, yuv_offsets
from ..core.frame import FrameBatch, same_bits, torch_dtype


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


def _chroma_box(c: torch.Tensor, sub_h: int, sub_w: int,
                exact: bool = False) -> torch.Tensor:
    """Box-mean downsample from luma resolution by per-axis factors."""
    if not (sub_h or sub_w):
        return c
    n, h, w = c.shape
    fh, fw = 1 << sub_h, 1 << sub_w
    c = c.reshape(n, h // fh, fh, w // fw, fw)
    if exact:
        # integer //(fh*fw) of the block sum, like the reference
        return torch.floor(c.sum(dim=(2, 4)) / float(fh * fw))
    return c.mean(dim=(2, 4))


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


def _rgb_to_float(fb: FrameBatch):
    """Return (r, g, b) float at native scale, plus the scale max."""
    fmt = fb.fmt
    arr = fb.planes["rgb"].to(torch.float32)
    if fmt.is_float:
        # float sources clamp to the canonical [0,1] range on read, like
        # swscale's float input readers (av_clipf)
        arr = torch.clamp(arr, 0.0, 1.0)
    chans = {c: arr[..., i] for i, c in enumerate(fmt.channel_order)}
    maxv = 1.0 if fmt.is_float else float(F.max_value(fmt))
    return chans["r"], chans["g"], chans["b"], maxv


def _store(x: torch.Tensor, dt: torch.dtype, shift_up: int = 0):
    """Quantized float samples -> the format's container dtype, shifted
    into the msb for p010."""
    if shift_up:
        return (x.to(torch.int32) << shift_up).to(dt)
    return x.to(dt)


def rgb_to_yuv(fb: FrameBatch, out_format: str = "yuv420p", *,
               exact: bool = False) -> FrameBatch:
    """RGB -> YUV 4:2:0/4:2:2/4:4:4/gray.  Chroma = convert(mean of the
    RGB block)."""
    out_fmt = F.get(out_format)
    if not out_fmt.is_yuv:
        raise ValueError(f"rgb_to_yuv needs a YUV output, got {out_format}")
    m = [[float(c) for c in row] for row in rgb2yuv_matrix(fb.colorspace)]
    r, g, b, src_maxv = _rgb_to_float(fb)
    dst_bits = _offset_bits(out_fmt)
    if out_fmt.name == "p010":
        # write the clean <<6 wire convention: quantize at the true 10-bit
        # depth, then shift into the container msb
        dst_bits = 10
    low, mid = yuv_offsets(dst_bits)
    dst_maxv = float((1 << dst_bits) - 1)
    scale = dst_maxv / src_maxv
    y = _quantize(m[0][0] * (r * scale) + m[0][1] * (g * scale)
                  + m[0][2] * (b * scale) + low, dst_maxv, exact)
    dt = torch_dtype(out_fmt.planes[0].dtype)
    if not any(p.name == "u" for p in out_fmt.planes):   # gray: luma only
        return fb.with_planes({"y": y.to(dt)}, out_format)
    pu = out_fmt.plane("u")
    if pu.sub_w or pu.sub_h:
        ex = exact and not fb.fmt.is_float
        r, g, b = (_chroma_box(c, pu.sub_h, pu.sub_w, ex) for c in (r, g, b))
    r, g, b = r * scale, g * scale, b * scale
    u = _quantize(m[1][0] * r + m[1][1] * g + m[1][2] * b + mid, dst_maxv,
                  exact)
    v = _quantize(m[2][0] * r + m[2][1] * g + m[2][2] * b + mid, dst_maxv,
                  exact)
    sh = _container_bits(out_fmt) - dst_bits if out_fmt.name == "p010" else 0
    return fb.with_planes({"y": _store(y, dt, sh), "u": _store(u, dt, sh),
                           "v": _store(v, dt, sh)}, out_format)


def yuv_to_yuv(fb: FrameBatch, out_format: str) -> FrameBatch:
    """Depth / chroma-layout conversion between YUV formats.

    Depth changes follow yuv2yuv_cuda.cu:16-120: u8->u16 is x<<8
    (high-bit alignment), u16->u8 is x>>8.
    """
    out_fmt = F.get(out_format)
    in_fmt = fb.fmt
    dt = torch_dtype(out_fmt.planes[0].dtype)
    # significant bits + in-container alignment (p010 stores 10-bit
    # samples msb-aligned, i.e. << 6; yuv420p10 is lsb-aligned)
    src_sig, dst_sig = in_fmt.bits, out_fmt.bits
    src_sh = 6 if in_fmt.name == "p010" else 0
    dst_sh = 6 if out_fmt.name == "p010" else 0

    def conv(p):
        v = p.to(torch.int32) >> src_sh
        if dst_sig > src_sig:
            v = v << (dst_sig - src_sig)
        elif dst_sig < src_sig:
            v = v >> (src_sig - dst_sig)
        return (v << dst_sh).to(dt)

    planes = {k: conv(v) for k, v in fb.planes.items()}
    in_has_c = any(p.name == "u" for p in in_fmt.planes)
    out_has_c = any(p.name == "u" for p in out_fmt.planes)
    if in_has_c and not out_has_c:       # -> gray: drop chroma
        return fb.with_planes({"y": planes["y"]}, out_format)
    if out_has_c and not in_has_c:       # gray -> yuv: neutral chroma
        mid = 1 << (_offset_bits(out_fmt) - 1)
        pu = out_fmt.plane("u")
        # per-axis shifts: 4:2:2 halves width only (sub_h = 0)
        cshape = (fb.batch, fb.height >> pu.sub_h, fb.width >> pu.sub_w)
        neutral = torch.full(cshape, mid, dtype=dt, device=fb.device)
        planes["u"] = planes["v"] = neutral
        return fb.with_planes(planes, out_format)
    if not (in_has_c and out_has_c):     # gray -> gray: depth only
        return fb.with_planes(planes, out_format)
    ipu, opu = in_fmt.plane("u"), out_fmt.plane("u")
    if (ipu.sub_w, ipu.sub_h) != (opu.sub_w, opu.sub_h):
        # generic per-axis relayout (420<->444, 422<->444, 420<->422):
        # nearest-upsample to 4:4:4 then box-mean down to the target
        for k in ("u", "v"):
            c = same_bits(_chroma_up, planes[k], sub_h=ipu.sub_h,
                          sub_w=ipu.sub_w)
            if opu.sub_w or opu.sub_h:
                c = torch.round(_chroma_box(c.to(torch.float32), opu.sub_h,
                                            opu.sub_w))
            planes[k] = c.to(dt)
    return fb.with_planes(planes, out_format)


def rgb_to_rgb(fb: FrameBatch, out_format: str, *, exact: bool = False,
               norm: Optional[float] = None,
               shift: Optional[Sequence[float]] = None) -> FrameBatch:
    """Channel reorder / depth / float conversion between RGB formats."""
    out_fmt = F.get(out_format)
    if (fb.fmt.is_float and out_fmt.is_float and norm is None
            and shift is None):
        # pure channel reorder between float formats: bit-exact
        arr = fb.planes["rgb"]
        chans = {c: arr[..., i] for i, c in enumerate(fb.fmt.channel_order)}
        out = [chans[c] if c in chans else torch.ones_like(arr[..., 0])
               for c in out_fmt.channel_order]
        return fb.with_planes(
            {"rgb": torch.stack(out, dim=-1).to(torch.float32)}, out_format)
    r, g, b, src_maxv = _rgb_to_float(fb)
    if fb.fmt.is_float:
        r, g, b = (c * 255.0 for c in (r, g, b))
        src_maxv = 255.0
    rgb = _pack_rgb(r, g, b, out_fmt, src_maxv, exact, norm, shift,
                    src_float=fb.fmt.is_float)
    return fb.with_planes({"rgb": rgb}, out_format)


def convert(fb: FrameBatch, out_format: str, **kw) -> FrameBatch:
    """Format dispatcher (the analog of swscale's unscaled conversions)."""
    if out_format == fb.format and not kw:
        return fb
    in_rgb, out_rgb = fb.fmt.is_rgb, F.get(out_format).is_rgb
    if out_format == fb.format:
        # same RGB format with norm/shift: a rescale; same YUV: nothing
        return rgb_to_rgb(fb, out_format, **kw) if in_rgb else fb
    if in_rgb and out_rgb:
        return rgb_to_rgb(fb, out_format, **kw)
    if in_rgb:
        return rgb_to_yuv(fb, out_format, **kw)
    if out_rgb:
        return yuv_to_rgb(fb, out_format, **kw)
    return yuv_to_yuv(fb, out_format)


def to_nchw(fb: FrameBatch) -> torch.Tensor:
    """Packed (N,H,W,C) RGB batch -> NCHW fp32 planar (the RGBPF32 tensor
    shape DL models consume)."""
    return fb.planes["rgb"].permute(0, 3, 1, 2).to(torch.float32).contiguous()


def from_nchw(x: torch.Tensor, fmt: str, colorspace: str = "bt709"
              ) -> FrameBatch:
    """NCHW planar tensor -> packed (N,H,W,C) RGB batch."""
    n, c, h, w = x.shape
    return FrameBatch({"rgb": x.permute(0, 2, 3, 1).contiguous()}, fmt, w, h,
                      colorspace)
