"""boxblur and gblur cores — counterpart of `gmat_tpu/ops/blur.py`.

boxblur (vf_boxblur.c + boxblur.c): the C slides a running sum along
each row/column (BLUR macro, vf_boxblur.c:126-153) with half-sample
mirrored edges, scales by the rounded fixed-point reciprocal
``inv = ((1<<16) + len/2) / len`` and emits ``(sum*inv + (1<<15)) >> 16``
truncated to the sample width.  Every step is linear in exact integers,
so the running sum is a cumsum-difference window sum, and the scale runs
in int32 with the C's two's-complement wrap-around.

gblur (vf_gblur.c + vf_gblur_init.h): per plane, ``steps`` forward and
backward first-order IIR passes along rows then columns in float32, the
boundary samples scaled by ``boundaryscale``, then one postscale
multiply, clip and lrintf.  set_params runs in float64 and is stored to
float32 like the C.  The recurrence keeps the JAX op's vectorization:
each step is one multiply and one add over a whole (N, H) or (N, W) line,
in the scan's order (no cumsum rewrite), so the card runs a host loop of
W + H steps per pass.
"""
from __future__ import annotations

import math

import numpy as np
import torch


# ---------------------------------------------------------------------------
# boxblur


def _mirror_index(n: int, radius: int, device) -> torch.Tensor:
    """Indices of a half-sample mirrored pad (src[-k] == src[k-1])."""
    idx = np.concatenate([np.arange(radius)[::-1], np.arange(n),
                          n - 1 - np.arange(radius)])
    return torch.as_tensor(idx, dtype=torch.int64, device=device)


def _box_line(x: torch.Tensor, radius: int, dim: int,
              mask: int) -> torch.Tensor:
    """Exact BLUR() over one dim of an int32 tensor (vf_boxblur.c:
    126-153): window sums over the mirrored pad, the fixed-point scale
    in int32 with wrap-around, `mask` as the uint8/uint16 store."""
    if radius == 0:
        return x
    length = 2 * radius + 1
    inv = ((1 << 16) + length // 2) // length
    n = x.shape[dim]
    xp = x.index_select(dim, _mirror_index(n, radius, x.device))
    c = torch.cumsum(xp, dim=dim)            # int64: no wrap in the sums
    # window[i] = sum(xp[i .. i+2r]) = c[i+2r] - c[i] + xp[i]
    win = (c.narrow(dim, 2 * radius, n) - c.narrow(dim, 0, n)
           + xp.narrow(dim, 0, n)).to(torch.int32)
    out = (win * inv + (1 << 15)) >> 16      # int32, wraps like the C
    return out & mask


def box_blur_plane(plane: torch.Tensor, radius: int,
                   power: int) -> torch.Tensor:
    """hblur then vblur with `power` box passes each (vf_boxblur.c
    blur_power/hblur/vblur, filter_frame:243-254).  (N, H, W) u8/u16."""
    dt = plane.dtype
    mask = 0xffff if dt == torch.uint16 else 0xff
    x = plane.to(torch.int32)
    if radius and power:
        for _ in range(power):
            x = _box_line(x, radius, dim=2, mask=mask)
        for _ in range(power):
            x = _box_line(x, radius, dim=1, mask=mask)
    return x.to(dt)


# ---------------------------------------------------------------------------
# gblur


def gblur_params(sigma: float, steps: int):
    """set_params (vf_gblur.c:201-209): double math, float storage."""
    lam = (sigma * sigma) / (2.0 * steps)
    dnu = (1.0 + 2.0 * lam - math.sqrt(1.0 + 4.0 * lam)) / (2.0 * lam)
    postscale = math.pow(dnu / lam, steps)
    boundaryscale = 1.0 / (1.0 - dnu)
    return (np.float32(postscale), np.float32(boundaryscale),
            np.float32(dnu))


def _iir_axis(x: torch.Tensor, nu, bscale, steps: int,
              dim: int) -> torch.Tensor:
    """`steps` forward+backward IIR passes along `dim` in float32,
    exactly horiz_slice_c / do_vertical_columns (vf_gblur_init.h:45-95):
    scale the first element by bscale, accumulate forwards, scale the
    last, accumulate backwards.  v[i] = row[i] + nu * v[i-1], one f32
    multiply and one f32 add per step, as the JAX scan does."""
    nu, bscale = float(nu), float(bscale)
    v = x.movedim(dim, 0).contiguous()       # (L, ...) scan axis first
    length = v.shape[0]
    for _ in range(steps):
        v[0].mul_(bscale)
        for i in range(1, length):
            v[i].add_(v[i - 1] * nu)
        v[length - 1].mul_(bscale)
        for i in range(length - 2, -1, -1):
            v[i].add_(v[i + 1] * nu)
    return v.movedim(0, dim)


def gblur_plane(plane: torch.Tensor, sigma: float, sigma_v: float,
                steps: int, maxv: float) -> torch.Tensor:
    """One plane (N, H, W): horizontal IIR steps, vertical IIR steps,
    postscale+clip+lrintf (vf_gblur.c filter_frame:216-296).  `maxv` is
    (1<<depth)-1 for integer samples; float samples are not clipped."""
    dt = plane.dtype
    x = plane.to(torch.float32)
    ps_h, bs_h, nu_h = gblur_params(sigma, steps)
    ps_v, bs_v, nu_v = gblur_params(sigma_v, steps)
    x = _iir_axis(x, nu_h, bs_h, steps, dim=2)
    x = _iir_axis(x, nu_v, bs_v, steps, dim=1)
    x = x * float(ps_h * ps_v)
    if dt.is_floating_point:
        return x.to(dt).contiguous()
    x = torch.clamp(x, 0.0, maxv)
    return torch.round(x).to(dt).contiguous()
