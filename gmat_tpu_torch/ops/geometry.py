"""Geometric ops: crop and flip — counterpart of `gmat_tpu/ops/geometry.py`
(rotate comes with the filter-graph slice).

  * crop_nvcv  (libavfilter/vf_crop_nvcv.c:80-86: w/h/x/y, centered when
    x or y is -1)
  * flip_nvcv  (vf_flip_nvcv.c:78: code 0=vertical, 1=horizontal, -1=both;
    OpenCV flipCode semantics)
"""
from __future__ import annotations

import torch

from ..core.frame import FrameBatch


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


def flip(fb: FrameBatch, code: int = 0) -> FrameBatch:
    """code: 0 = flip vertically (around x-axis), 1 = horizontally,
    -1 = both (OpenCV flipCode, vf_flip_nvcv.c:78)."""
    if code not in _FLIP_DIMS:
        raise ValueError("flip code must be -1, 0 or 1")
    planes = {}
    for name, arr in fb.planes.items():
        if arr.dtype == torch.uint16:
            # torch.flip has no uint16 kernel (on the CPU at least): widen
            # to int32 for the permutation (exact), store back as u16
            planes[name] = arr.to(torch.int32).flip(_FLIP_DIMS[code]).to(
                torch.uint16)
        else:
            planes[name] = arr.flip(_FLIP_DIMS[code])
    return fb.with_planes(planes)
