"""Fused preprocess ladder — the main path; counterpart of
`gmat_tpu/ops/fused.py`.

Color conversion and resampling are both linear, so they reorder:

    crop -> resize each YUV plane at its native subsampled resolution
    straight to the output size -> 3x3 color matrix + offsets at OUTPUT
    resolution -> pack/normalize.

`preprocess_nchw` sends CUDA planes to the hand-written ladder kernels
(`ops/ladder.py`); CPU planes, and combinations the kernels cannot fold
(odd crops, constant-border smooth, non-4:2:0 crops), take the
separate-op path.  `exact=True` keeps the reference ordering (CSC at
source resolution, then resize) for oracle comparison.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..core import formats as F
from ..core.color import yuv2rgb_matrix, yuv_offsets
from ..core.frame import FrameBatch
from . import csc
from .geometry import crop as crop_op, flip as flip_op
from .ladder import fused_ladder, fused_ladder_i8, fused_ladder_u16
from .resize import _window_taps, resize as resize_op, resize_plane
from .smooth import smooth as smooth_op

USE_KERNEL = ("auto", "never", "bf16", "reference")


def _apply_smooth(fb: FrameBatch, smooth) -> FrameBatch:
    """(kw, kh, sigmaX, sigmaY, border) gaussian at the current res."""
    kw_s, kh_s, sx, sy, border = smooth
    return smooth_op(fb, "gaussian", int(kw_s), int(kh_s), str(border),
                     float(sx), float(sy))


def preprocess(fb: FrameBatch, out_w: int, out_h: int,
               out_format: str = "rgbpf32", *,
               method: str = "bilinear",
               crop_box: Optional[Tuple[int, int, int, int]] = None,
               flip_code: Optional[int] = None,
               smooth: Optional[Tuple] = None,
               norm: Optional[float] = None,
               shift: Optional[Sequence[float]] = None,
               exact: bool = False) -> FrameBatch:
    """YUV FrameBatch -> cropped/smoothed/flipped/resized RGB batch.

    Op order: crop -> resize -> gaussian smooth (output res) -> flip —
    the same composition the ladder kernels fold into their matrices."""
    if crop_box is not None:
        # crop_box is (x, y, w, h) — the ladder's convention — while
        # geometry.crop's signature is (w, h, x, y)
        bx, by, bw, bh = crop_box
        fb = crop_op(fb, bw, bh, bx, by)
    if fb.fmt.is_rgb:
        out = resize_op(fb, out_w, out_h, method)
        if smooth is not None:
            out = _apply_smooth(out, smooth)
        if flip_code is not None:
            out = flip_op(out, flip_code)
        kw = ({"norm": norm, "shift": shift}
              if F.get(out_format).is_rgb else {})
        return csc.convert(out, out_format, **kw)

    if exact:
        rgb = csc.yuv_to_rgb(fb, out_format, norm=norm, shift=shift)
        out = resize_op(rgb, out_w, out_h, method)
        if smooth is not None:
            out = _apply_smooth(out, smooth)
        if flip_code is not None:
            out = flip_op(out, flip_code)
        return out

    # ---- fast path: per-plane resize first, CSC at output size ----------
    bits = csc._offset_bits(fb.fmt)
    low, mid = yuv_offsets(bits)
    maxv = float((1 << bits) - 1)
    y = resize_plane(fb.planes["y"], out_h, out_w, method) - low
    if "u" in fb.planes:
        u = resize_plane(fb.planes["u"], out_h, out_w, method) - mid
        v = resize_plane(fb.planes["v"], out_h, out_w, method) - mid
    else:                      # gray8: neutral chroma, like the exact path
        u = v = torch.zeros_like(y)
    m = [[float(c) for c in row] for row in yuv2rgb_matrix(fb.colorspace)]
    r = torch.clamp(m[0][0] * y + m[0][1] * u + m[0][2] * v, 0.0, maxv)
    g = torch.clamp(m[1][0] * y + m[1][1] * u + m[1][2] * v, 0.0, maxv)
    b = torch.clamp(m[2][0] * y + m[2][1] * u + m[2][2] * v, 0.0, maxv)
    out_fmt = F.get(out_format)
    rgb = csc._pack_rgb(r, g, b, out_fmt, maxv, False, norm, shift)
    out = FrameBatch({"rgb": rgb}, out_format, out_w, out_h, fb.colorspace)
    if smooth is not None:
        out = _apply_smooth(out, smooth)
    if flip_code is not None:
        out = flip_op(out, flip_code)
    return out


_KERNEL_METHODS = ("bilinear", "nearest", "bicubic", "area", "lanczos3")


def _kernel_eligible(format: str, method: str, kw: dict, device_type: str,
                     force: bool = False) -> bool:
    """Whether the ladder kernels take this batch: the formats and methods
    they carry, on a CUDA device (any device under `force`, which runs
    their plain versions)."""
    if kw:
        return False
    if (format not in ("yuv420p", "nv12", "yuv420p10", "yuv444p")
            or method not in _KERNEL_METHODS):
        return False
    return force or device_type == "cuda"


def _fusable_crop(fb: FrameBatch, crop_box) -> bool:
    """Crop boxes the ladder folds into the matrices: 4:2:0 formats,
    integer even coords inside the frame."""
    if crop_box is None:
        return True
    if fb.format not in ("yuv420p", "nv12", "yuv420p10"):
        return False
    try:
        c = tuple(int(x) for x in crop_box)
    except (TypeError, ValueError):
        return False
    if any(float(a) != float(b) for a, b in zip(c, crop_box)):
        return False
    cx, cy, cw_b, ch_b = c
    return (cx >= 0 and cy >= 0 and cw_b > 0 and ch_b > 0
            and not ((cx | cy | cw_b | ch_b) & 1)
            and cx + cw_b <= fb.width and cy + ch_b <= fb.height)


def _fusable_smooth(smooth) -> bool:
    """Gaussians the ladder folds: odd taps, sum-preserving border."""
    if smooth is None:
        return True
    kw_s, kh_s = int(smooth[0]), int(smooth[1])
    return (kw_s >= 1 and kh_s >= 1 and bool(kw_s & 1) and bool(kh_s & 1)
            and smooth[4] != "constant")


def preprocess_nchw(fb: FrameBatch, out_w: int, out_h: int, *,
                    method: str = "bilinear",
                    norm: Optional[float] = None,
                    shift: Sequence[float] = (0.0, 0.0, 0.0),
                    crop_box=None, flip_code: Optional[int] = None,
                    smooth: Optional[Tuple] = None,
                    use_kernel: str = "auto",
                    **kw) -> torch.Tensor:
    """Model-input convenience: fused ladder straight to NCHW fp32 (the
    format_cuda=rgbpf32le -> tensorrt handoff, vf_format_cuda.c:198-206).

    norm defaults to the input's full scale (255 for 8-bit, 1023 for
    yuv420p10) so the output is [0,1] for any depth.

    use_kernel: "auto" runs the ladder kernels on CUDA planes (int8 row
    stage for yuv420p/nv12, bf16 for yuv420p10, yuv444p and where the
    int8 tap gate fails) and the separate-op path on CPU planes; "never"
    always takes the separate-op path; "bf16" forces the bf16 kernel;
    "reference" runs the same kernel dispatch but each kernel's plain
    PyTorch version, on any device (tests and chip_smoke.py).  crop_box /
    smooth=(kw, kh, sigmaX, sigmaY, border) / flip_code ride the kernels'
    matrices; ineligible combinations take the separate-op path.
    """
    if use_kernel not in USE_KERNEL:
        raise ValueError(f"use_kernel must be one of {USE_KERNEL}, "
                         f"got {use_kernel!r}")
    if norm is None:
        norm = (255.0 if fb.fmt.is_float
                else float((1 << csc._offset_bits(fb.fmt)) - 1))
    fusable = (_fusable_crop(fb, crop_box) and _fusable_smooth(smooth)
               and flip_code in (None, -1, 0, 1))
    ref = use_kernel == "reference"
    if (use_kernel != "never" and fusable
            and _kernel_eligible(fb.format, method, kw, fb.device.type,
                                 force=ref)):
        # nv12 planes unpacked from the wire format are strided views
        y, u, v = (fb.planes[k].contiguous() for k in ("y", "u", "v"))
        cb = (tuple(int(x) for x in crop_box)
              if crop_box is not None else None)
        sm = tuple(smooth) if smooth is not None else None
        if fb.format == "yuv420p10":
            return fused_ladder_u16(y, u, v, out_h, out_w, 10,
                                    fb.colorspace, method, norm,
                                    tuple(shift), ref, crop_box=cb,
                                    smooth=sm, flip=flip_code)
        if fb.format == "yuv444p":
            # 4:4:4 chroma resampling is a real downscale, so int8 tap
            # quantization x CSC gain exceeds tolerance: bf16 kernel
            k = fused_ladder
        else:
            k = fused_ladder if use_kernel == "bf16" else fused_ladder_i8
        return k(y, u, v, out_h, out_w, fb.colorspace, method, norm,
                 tuple(shift), ref, crop_box=cb, smooth=sm, flip=flip_code)
    out = preprocess(fb, out_w, out_h, "rgbpf32", method=method, norm=norm,
                     shift=shift, crop_box=crop_box, flip_code=flip_code,
                     smooth=smooth, **kw)
    return csc.to_nchw(out)


# ------------------------------------------------- resolution bucketing
# Frames padded to a bucket size share one set of shapes; the
# interpolation taps/weights of the *content* region travel as tensors.

BUCKETS = ((640, 360), (960, 540), (1280, 720), (1920, 1080),
           (2560, 1440), (3840, 2160))


def bucket_for(w: int, h: int):
    """Smallest standard bucket covering (w, h); falls back to the next
    multiple of 64."""
    for bw, bh in BUCKETS:
        if w <= bw and h <= bh:
            return bw, bh
    r = lambda x: (x + 63) // 64 * 64
    return r(w), r(h)


def _bucketed_plane(x, ridx, rw, cidx, cw):
    """2-tap gather resize with tap tensors (the content region only)."""
    acc = None
    for k in range(2):
        g = x.index_select(1, torch.clamp(ridx + k, 0, x.shape[1] - 1))
        t = g.to(torch.float32) * rw[:, k][None, :, None]
        acc = t if acc is None else acc + t
    out = None
    for k in range(2):
        g = acc.index_select(2, torch.clamp(cidx + k, 0, x.shape[2] - 1))
        t = g * cw[:, k][None, None, :]
        out = t if out is None else out + t
    return out


def preprocess_nchw_bucketed(fb: FrameBatch, content_w: int, content_h: int,
                             out_w: int, out_h: int) -> torch.Tensor:
    """Fused ladder over a bucket-padded 8-bit YUV 4:2:0 batch: only the
    (content_w, content_h) region contributes."""
    dev = fb.device

    def taps(n_in, n_out):
        idx, wts = _window_taps(n_in, n_out, "bilinear")
        return (torch.as_tensor(idx, dtype=torch.int64, device=dev),
                torch.as_tensor(wts, device=dev))

    yy = _bucketed_plane(fb.planes["y"], *taps(content_h, out_h),
                         *taps(content_w, out_w)) - 16.0
    rc, wc = taps(content_h // 2, out_h)
    cc, wwc = taps(content_w // 2, out_w)
    uu = _bucketed_plane(fb.planes["u"], rc, wc, cc, wwc) - 128.0
    vv = _bucketed_plane(fb.planes["v"], rc, wc, cc, wwc) - 128.0
    m = [[float(c) for c in row] for row in yuv2rgb_matrix(fb.colorspace)]
    r = torch.clamp(m[0][0] * yy + m[0][1] * uu + m[0][2] * vv, 0., 255.)
    g = torch.clamp(m[1][0] * yy + m[1][1] * uu + m[1][2] * vv, 0., 255.)
    b = torch.clamp(m[2][0] * yy + m[2][1] * uu + m[2][2] * vv, 0., 255.)
    return torch.stack([r, g, b], 1) * (1.0 / 255.0)
