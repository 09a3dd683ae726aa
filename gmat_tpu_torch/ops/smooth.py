"""Smoothing filters: gaussian and median blur — counterpart of
`gmat_tpu/ops/smooth.py`.

smooth_nvcv (libavfilter/vf_smooth_nvcv.c:88-103 — options type/kw/kh/
border_type/sigmaX/sigmaY).  The gaussian is separable: two shifted-add
1-D convolutions in exact f32.  `smooth_matrix` is the dense matrix form
that the fused ladder folds into its resample matrices.  The median is an
exact order-statistic selection over the window's shifted views.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import formats as F
from ..core.frame import FrameBatch, torch_dtype

BORDERS = ("constant", "replicate", "reflect", "wrap", "reflect101")


# OpenCV getGaussianKernel's fixed small-kernel table (used when
# sigma<=0 and ksize<=7): binomial coefficients, not the formula
_CV_FIXED = {
    1: np.array([1.0]),
    3: np.array([0.25, 0.5, 0.25]),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625]),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125,
                 0.21875, 0.109375, 0.03125]),
}


def gaussian_kernel1d(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """OpenCV getGaussianKernel semantics: sigma<=0 uses the fixed
    binomial table for ksize<=7, else derives sigma from ksize."""
    if sigma <= 0 and ksize in _CV_FIXED:
        return _CV_FIXED[ksize].astype(np.float32)
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _pad_mode(border: str) -> str:
    """Border name -> numpy pad mode ('reflect' is numpy's 'symmetric')."""
    if border not in BORDERS:
        raise ValueError(f"border_type must be one of {BORDERS}, "
                         f"got {border!r}")
    return {"constant": "constant", "replicate": "edge",
            "reflect": "symmetric", "reflect101": "reflect",
            "wrap": "wrap"}[border]


def _conv1d_axis(x: torch.Tensor, k: np.ndarray, axis: int,
                 border: str) -> torch.Tensor:
    """Separable 1-D convolution as K shifted adds (exact f32).

    The border is an index map built with numpy's own pad modes (so
    'symmetric', which torch.nn.functional.pad lacks, is exact); the
    constant border reads an appended zero slab."""
    ksize = len(k)
    half = (ksize - 1) // 2
    n = x.shape[axis]
    mode = _pad_mode(border)
    pad = (half, ksize - 1 - half)
    if mode == "constant":
        idx = np.pad(np.arange(n), pad, mode="constant", constant_values=n)
        zero = torch.zeros_like(x.narrow(axis, 0, 1))
        src = torch.cat([x, zero], dim=axis)
    else:
        idx = np.pad(np.arange(n), pad, mode=mode)
        src = x
    xp = src.index_select(axis, torch.as_tensor(idx, device=x.device))
    out = None
    for i in range(ksize):
        term = xp.narrow(axis, i, n) * float(k[i])
        out = term if out is None else out + term
    return out


def smooth_matrix(n: int, ksize: int, sigma: float = 0.0,
                  border: str = "reflect101") -> np.ndarray:
    """Dense (n, n) matrix form of the 1-D gaussian: G @ x ==
    _conv1d_axis(x, kernel, border) exactly (built from the padded
    identity, so border handling is bit-identical).  The fused ladder
    precomposes it into its resample matrices (A' = G @ A)."""
    k = gaussian_kernel1d(ksize, float(sigma)).astype(np.float32)
    half = (ksize - 1) // 2
    eye = np.eye(n, dtype=np.float32)
    pad = ((half, ksize - 1 - half), (0, 0))
    P = np.pad(eye, pad, mode=_pad_mode(border))
    G = np.zeros((n, n), np.float32)
    for i in range(ksize):
        G += float(k[i]) * P[i:i + n]
    return G


def gaussian_blur_plane(x: torch.Tensor, kw: int = 3, kh: int = 3,
                        sigma_x: float = 0.0, sigma_y: float = 0.0,
                        border: str = "reflect101") -> torch.Tensor:
    """(N,H,W[,C]) float gaussian blur, separable shifted-add conv."""
    kx = gaussian_kernel1d(kw, float(sigma_x))
    ky = gaussian_kernel1d(kh, float(sigma_y))
    y = _conv1d_axis(x.to(torch.float32), ky, 1, border)
    return _conv1d_axis(y, kx, 2, border)


def median_blur_plane(x: torch.Tensor, kw: int = 3, kh: int = 3
                      ) -> torch.Tensor:
    """(N,H,W[,C]) median over a kh x kw window (replicate border,
    matching CV-CUDA MedianBlur).

    Integer planes with an odd window select the middle order statistic
    bit by bit (from the top bit down, keep a bit when fewer than half the
    window lies below the candidate): exact, with no stacked window copy.
    Float planes and even windows sort the stacked window (an even
    window gives the mean of the two middle values, in f32)."""
    half_h, half_w = (kh - 1) // 2, (kw - 1) // 2
    h, w = x.shape[1], x.shape[2]
    k = kh * kw
    select = x.dtype in (torch.uint8, torch.uint16) and k % 2 == 1
    # u8 selects in u8; u16 widens (index_select has no u16 kernel)
    work = x.to(torch.int32) if x.dtype == torch.uint16 else x
    dev = x.device
    rows = torch.as_tensor(np.clip(np.arange(-half_h, h + kh - 1 - half_h),
                                   0, h - 1), device=dev)
    cols = torch.as_tensor(np.clip(np.arange(-half_w, w + kw - 1 - half_w),
                                   0, w - 1), device=dev)
    xp = work.index_select(1, rows).index_select(2, cols)
    wins = [xp[:, dy:dy + h, dx:dx + w] for dy in range(kh)
            for dx in range(kw)]
    if not select:
        srt = torch.sort(torch.stack(wins, dim=-1), dim=-1).values
        if k % 2:
            return srt[..., k // 2]
        return (srt[..., k // 2 - 1].to(torch.float32) +
                srt[..., k // 2].to(torch.float32)) / 2.0
    rank = k // 2
    bits = 8 if x.dtype == torch.uint8 else 16
    res = torch.zeros_like(wins[0])
    for b in reversed(range(bits)):
        cand = res | (1 << b)
        below = None
        for win in wins:
            lt = (win < cand).to(torch.int16)
            below = lt if below is None else below + lt
        res = torch.where(below <= rank, cand, res)
    return res.to(x.dtype)


def smooth(fb: FrameBatch, type: str = "gaussian", kw: int = 3, kh: int = 3,
           border_type: str = "constant", sigmaX: float = 0.0,
           sigmaY: float = 0.0) -> FrameBatch:
    """Filter-level entry matching smooth_nvcv option names."""
    if kw < 1 or kh < 1 or kw % 2 == 0 or kh % 2 == 0:
        # OpenCV/CV-CUDA reject even sizes; an even anchor would shift
        # the whole image half a pixel silently
        raise ValueError(f"smooth kernel sizes must be odd and >= 1, "
                         f"got {kw}x{kh}")
    if type not in ("gaussian", "median"):
        raise ValueError(f"smooth type {type!r} (gaussian|median)")
    fmt = fb.fmt
    planes = {}
    for p in fmt.planes:
        x = fb.planes[p.name]
        if type == "gaussian":
            y = gaussian_blur_plane(x, kw, kh, sigmaX, sigmaY, border_type)
        else:
            y = median_blur_plane(x, kw, kh).to(torch.float32)
        if not fmt.is_float:
            y = torch.clamp(torch.round(y), 0, F.clip_value(fmt))
        planes[p.name] = y.to(torch_dtype(fmt.planes[0].dtype))
    return fb.with_planes(planes)
