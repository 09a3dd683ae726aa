"""Resize — counterpart of `gmat_tpu/ops/resize.py`.

Every supported resampler (bilinear / bicubic / area / nearest / lanczos)
is a linear operator, so a 2-D resize is out = A_h @ img @ A_w^T.  The
matrices are built once per (n_in, n_out, method) with numpy (copied from
the JAX module, which the tests hold them equal to).

nearest/bilinear/bicubic run as a windowed gather (reads only the taps
each output needs, exact f32); area/lanczos3/antialias run as two f32
matrix products.  Those stay true f32, the counterpart of the JAX
module's PRECISION = "highest": `f32_matmul` refuses to run when PyTorch
would lower f32 products to TF32 or bf16.

Coordinate convention: half-pixel centers with edge clamp,
  src = (dst + 0.5) * n_in/n_out - 0.5
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..core import formats as F
from ..core.frame import FrameBatch, same_bits, torch_dtype

METHODS = ("nearest", "bilinear", "bicubic", "area", "lanczos3")


def f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`a @ b` in full float32 (no TF32, no reduced-precision passes)."""
    if torch.get_float32_matmul_precision() != "highest" or (
            a.is_cuda and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "f32 resample products need full float32: set "
            "torch.set_float32_matmul_precision('highest') and leave "
            "torch.backends.cuda.matmul.allow_tf32 False")
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def _cubic_weight(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic kernel, a=-0.75 (OpenCV/CV-CUDA INTER_CUBIC)."""
    x = np.abs(x)
    w = np.where(
        x <= 1.0,
        ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
        np.where(x < 2.0, ((a * x - 5.0 * a) * x + 8.0 * a) * x - 4.0 * a, 0.0),
    )
    return w


def _lanczos_weight(x: np.ndarray, taps: int = 3) -> np.ndarray:
    x = np.asarray(x, np.float64)
    w = np.sinc(x) * np.sinc(x / taps)
    return np.where(np.abs(x) < taps, w, 0.0)


@lru_cache(maxsize=512)
def resample_matrix(n_in: int, n_out: int, method: str = "bilinear",
                    antialias: bool = False) -> np.ndarray:
    """(n_out, n_in) float32 row-normalized interpolation matrix."""
    if method not in METHODS:
        raise ValueError(f"unknown resize method {method!r}; known {METHODS}")
    A = np.zeros((n_out, n_in), np.float64)
    scale = n_in / n_out

    if method == "area" and n_in > n_out:
        # exact fractional box coverage (OpenCV INTER_AREA downscale)
        for o in range(n_out):
            lo, hi = o * scale, (o + 1) * scale
            i0, i1 = int(np.floor(lo)), int(np.ceil(hi))
            for i in range(i0, min(i1, n_in)):
                cov = min(hi, i + 1) - max(lo, i)
                if cov > 0:
                    A[o, i] = cov
        A /= A.sum(axis=1, keepdims=True)
        return A.astype(np.float32)

    src = (np.arange(n_out) + 0.5) * scale - 0.5
    if method == "nearest":
        idx = np.clip(np.floor(src + 0.5).astype(int), 0, n_in - 1)
        A[np.arange(n_out), idx] = 1.0
        return A.astype(np.float32)

    if method in ("bilinear", "area"):
        support, weight_fn = 1.0, lambda x: np.maximum(0.0, 1.0 - np.abs(x))
    elif method == "bicubic":
        support, weight_fn = 2.0, _cubic_weight
    else:  # lanczos3
        support, weight_fn = 3.0, _lanczos_weight

    # antialias widens the kernel by the scale factor when downscaling
    fscale = max(scale, 1.0) if (antialias and n_in > n_out) else 1.0
    sup = support * fscale
    for o in range(n_out):
        c = src[o]
        i0 = int(np.floor(c - sup)) + 1
        i1 = int(np.floor(c + sup)) + 1
        idx = np.arange(i0, i1)
        w = weight_fn((idx - c) / fscale)
        idx = np.clip(idx, 0, n_in - 1)  # edge clamp
        s = w.sum()
        if s != 0:
            w = w / s
        np.add.at(A[o], idx, w)
    return A.astype(np.float32)


# tap counts for the gather (windowed) path; other methods use matmuls
_TAPS = {"nearest": 1, "bilinear": 2, "bicubic": 4}


@lru_cache(maxsize=512)
def _window_taps(n_in: int, n_out: int, method: str):
    """Decompose a resample matrix into (start_idx[n_out], w[n_out, T])
    windows of T consecutive input samples.  Exactly equivalent to the
    dense matrix (edge-clipped weights are accumulated identically)."""
    T = _TAPS[method]
    A = resample_matrix(n_in, n_out, method)
    idx = np.zeros(n_out, np.int32)
    wts = np.zeros((n_out, T), np.float32)
    for o in range(n_out):
        nz = np.nonzero(A[o])[0]
        s = int(min(nz[0], max(n_in - T, 0)))
        idx[o] = s
        span = A[o, s:s + T]
        wts[o, :len(span)] = span
    return idx, wts


def _gather_resize(x: torch.Tensor, out_h: int, out_w: int,
                   method: str) -> torch.Tensor:
    """Windowed-tap resize: reads only the input rows/cols each output
    needs; exact f32 (products and sums in the same order as the JAX
    module's `_gather_resize`)."""
    n_in_h, n_in_w = x.shape[1], x.shape[2]
    ridx, rw = _window_taps(n_in_h, out_h, method)
    cidx, cw = _window_taps(n_in_w, out_w, method)
    T = rw.shape[1]
    dev = x.device
    tail = (1,) * (x.ndim - 2)          # broadcast over W (and C)
    acc = None
    for k in range(T):
        rows = torch.as_tensor(np.minimum(ridx + k, n_in_h - 1), device=dev)
        g = same_bits(torch.index_select, x, dim=1, index=rows).to(
            torch.float32)
        wk = torch.as_tensor(rw[:, k], device=dev).reshape(1, -1, *tail)
        acc = g * wk if acc is None else acc + g * wk
    out = None
    for k in range(T):
        g = acc.index_select(2, torch.as_tensor(
            np.minimum(cidx + k, n_in_w - 1), device=dev))
        wk = torch.as_tensor(cw[:, k], device=dev).reshape(
            1, 1, -1, *tail[1:])
        out = g * wk if out is None else out + g * wk
    return out


def resize_plane(x: torch.Tensor, out_h: int, out_w: int,
                 method: str = "bilinear", antialias: bool = False,
                 dtype=torch.float32) -> torch.Tensor:
    """Resize (N, H, W) or (N, H, W, C).

    nearest/bilinear/bicubic use the windowed-gather path (exact f32);
    area/lanczos/antialias use two full-f32 matrix products.
    """
    n_in_h, n_in_w = x.shape[1], x.shape[2]
    if (n_in_h, n_in_w) == (out_h, out_w):
        return x.to(dtype)
    if method in _TAPS and not antialias:
        return _gather_resize(x, out_h, out_w, method).to(dtype)
    dev = x.device
    Ah = torch.as_tensor(resample_matrix(n_in_h, out_h, method, antialias),
                         device=dev)
    Aw = torch.as_tensor(resample_matrix(n_in_w, out_w, method, antialias),
                         device=dev)
    xf = x.to(torch.float32)
    if x.ndim == 3:
        y = f32_matmul(Ah, xf)                       # (N, oh, W)
        y = f32_matmul(y, Aw.T)                      # (N, oh, ow)
    else:
        xc = xf.movedim(3, 1)                        # (N, C, H, W)
        y = f32_matmul(f32_matmul(Ah, xc), Aw.T).movedim(1, 3)
    return y.to(dtype)


def resize(fb: FrameBatch, out_w: int, out_h: int, method: str = "bilinear",
           antialias: bool = False) -> FrameBatch:
    """Resize a FrameBatch in its own format (chroma planes scale at their
    subsampled resolution)."""
    fmt = fb.fmt
    planes = {}
    for p in fmt.planes:
        ph, pw = out_h >> p.sub_h, out_w >> p.sub_w
        y = resize_plane(fb.planes[p.name], ph, pw, method, antialias)
        if not fmt.is_float:
            y = torch.clamp(torch.round(y), 0, F.clip_value(fmt))
        planes[p.name] = y.to(torch_dtype(fmt.planes[0].dtype))
    return fb.with_planes(planes, width=out_w, height=out_h)
