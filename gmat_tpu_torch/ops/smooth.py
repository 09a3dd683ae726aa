"""Gaussian smoothing — counterpart of the gaussian half of
`gmat_tpu/ops/smooth.py` (median comes with the filter-graph slice).

smooth_nvcv (libavfilter/vf_smooth_nvcv.c:88-103 — options type/kw/kh/
border_type/sigmaX/sigmaY).  The gaussian is separable: two shifted-add
1-D convolutions in exact f32.  `smooth_matrix` is the dense matrix form
that the fused ladder folds into its resample matrices.
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


def smooth(fb: FrameBatch, type: str = "gaussian", kw: int = 3, kh: int = 3,
           border_type: str = "constant", sigmaX: float = 0.0,
           sigmaY: float = 0.0) -> FrameBatch:
    """Filter-level entry matching smooth_nvcv option names."""
    if kw < 1 or kh < 1 or kw % 2 == 0 or kh % 2 == 0:
        # OpenCV/CV-CUDA reject even sizes; an even anchor would shift
        # the whole image half a pixel silently
        raise ValueError(f"smooth kernel sizes must be odd and >= 1, "
                         f"got {kw}x{kh}")
    if type == "median":
        raise NotImplementedError(
            "median smooth is ported with the filter-graph slice "
            "(ROADMAP.md, queue 1, slice 3)")
    if type != "gaussian":
        raise ValueError(f"smooth type {type!r} (gaussian|median)")
    fmt = fb.fmt
    planes = {}
    for p in fmt.planes:
        y = gaussian_blur_plane(fb.planes[p.name], kw, kh, sigmaX, sigmaY,
                                border_type)
        if not fmt.is_float:
            y = torch.clamp(torch.round(y), 0, F.clip_value(fmt))
        planes[p.name] = y.to(torch_dtype(fmt.planes[0].dtype))
    return fb.with_planes(planes)
