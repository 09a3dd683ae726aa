"""Dual-input overlay blend — counterpart of `gmat_tpu/ops/overlay.py`,
the rebuild of vf_overlay_cuda.

Reference: ffmpeg-gpu/libavfilter/vf_overlay_cuda.cu:23-53 (per-plane
alpha blend, float math truncated to u8), vf_overlay_cuda.c:195-340
(per-plane launches: luma at (x,y) with full-res alpha, chroma at
(x/2, y/2) with alpha sampled at even coords; x normalized even via
normalize_xy, y passed through).

The overlay (and its alpha) are placed per frame onto zero canvases of
the main plane's size on the batch's device, clipped on all four sides
(the kernel's bounds check), and the blend is one elementwise pass over
the batch: out = floor(a * o + (1 - a) * main), two f32 roundings (no
fused multiply-add).  Positions are host integers, one per frame.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def _ints(v, n: int) -> np.ndarray:
    """Per-frame positions (a scalar, sequence, array or tensor) as host
    int64 of length n."""
    if isinstance(v, torch.Tensor):
        v = v.cpu().numpy()
    return np.broadcast_to(np.asarray(v, np.int64), (n,))


def _place(over: torch.Tensor, xs: np.ndarray, ys: np.ndarray,
           H: int, W: int) -> torch.Tensor:
    """Batched (N, oh, ow) patches at per-frame (x, y) on an (N, H, W)
    zero canvas, clipping overhang on all four sides."""
    n, oh, ow = over.shape
    canvas = torch.zeros((n, H, W), dtype=over.dtype, device=over.device)
    for i in range(n):
        x, y = int(xs[i]), int(ys[i])
        x0, y0 = max(x, 0), max(y, 0)
        x1, y1 = min(x + ow, W), min(y + oh, H)
        if x1 > x0 and y1 > y0:
            canvas[i, y0:y1, x0:x1] = over[i, y0 - y:y1 - y, x0 - x:x1 - x]
    return canvas


def _blend(main: torch.Tensor, over: torch.Tensor, alpha: torch.Tensor,
           xs: np.ndarray, ys: np.ndarray) -> torch.Tensor:
    """out = alpha*overlay + (1-alpha)*main, truncated like the
    reference's implicit float->uchar cast (vf_overlay_cuda.cu:52)."""
    H, W = main.shape[1], main.shape[2]
    o = _place(over.to(torch.float32), xs, ys, H, W)
    a = _place(alpha, xs, ys, H, W)
    out = a * o + (1.0 - a) * main.to(torch.float32)
    return torch.floor(out).to(main.dtype)


def _alpha(alpha: Optional[torch.Tensor], over: torch.Tensor
           ) -> torch.Tensor:
    """The (N, oh, ow) f32 alpha in [0, 1]: opaque without an alpha
    plane, else u8 / 255 (a true division on every device)."""
    if alpha is None:
        return torch.ones(over.shape[:3], dtype=torch.float32,
                          device=over.device)
    alpha = alpha.to(over.device)
    return alpha.to(torch.float32) / torch.tensor(255.0, device=over.device)


def overlay_yuv420(main_planes: Dict[str, torch.Tensor],
                   over_planes: Dict[str, torch.Tensor],
                   alpha: Optional[torch.Tensor], x, y
                   ) -> Dict[str, torch.Tensor]:
    """YUV-domain overlay on batched 4:2:0 planes.

    main_planes/over_planes: {'y','u','v'} (N, ...) u8 tensors on one
    device; alpha is an optional (N, oh, ow) u8 full-resolution alpha
    plane (yuva420p's data[3]); x/y: per-frame positions.  Plane
    geometry matches the reference launches (vf_overlay_cuda.c:289-327):
    x is normalized to even, chroma goes to (x/2, y/2) with C's
    truncating division, chroma alpha samples the full-res alpha at even
    coordinates.
    """
    oy = over_planes["y"]
    n = oy.shape[0]
    xs = _ints(x, n) & ~1               # normalize_xy(x, chroma_sub=1)
    ys = _ints(y, n)
    a_full = _alpha(alpha, oy)
    out = {"y": _blend(main_planes["y"], oy, a_full, xs, ys)}
    a_sub = a_full[:, ::2, ::2]
    # C truncating division (vf_overlay_cuda.c:303 "y_position / 2"): a
    # negative odd slide-in position -3/2 is -1, not floor's -2
    cx = np.trunc(xs / 2).astype(np.int64)
    cy = np.trunc(ys / 2).astype(np.int64)
    for c in ("u", "v"):
        out[c] = _blend(main_planes[c], over_planes[c], a_sub, cx, cy)
    return out


def overlay_rgb(main: torch.Tensor, over: torch.Tensor,
                alpha: Optional[torch.Tensor], x, y) -> torch.Tensor:
    """Packed-RGB overlay (N,H,W,C) — the still-watermark path (the
    reference filter has no RGB mode; the blend math is the same)."""
    n, h, w, c = main.shape
    xs, ys = _ints(x, n), _ints(y, n)
    a = _alpha(alpha, over)
    chans = []
    for i in range(c):
        if i == 3:   # preserve the main alpha channel
            chans.append(main[..., i])
            continue
        chans.append(_blend(main[..., i],
                            over[..., min(i, over.shape[3] - 1)], a, xs, ys))
    return torch.stack(chans, dim=-1)
