"""vignette, natural lens vignetting (vf_vignette.c) — counterpart of
`gmat_tpu/ops/vignette.py`.

- factor map (update_context :146-188): per-luma-pixel
  f = cos^4(angle * dnorm), dnorm = hypot((int)((x-x0)*xscale),
  (int)((y-y0)*yscale)) / dmax, 0 beyond the circle, reciprocal in
  backward mode, stored to float32 — host numpy, copied, built once per
  parameter set.
- application (filter_frame :246-276): luma dst = clip_u8(fmap[x]*src +
  dither), chroma dst = clip_u8(fmap[x<<hsub]*(src-127) + 127 + dither);
  the +127 happens in float32, the dither joins in double.
- dither (get_dither_value :190-198): one LCG draw per pixel, value =
  state/2^32 before the update, plane after plane within a frame, the
  state carried across frames.  The LCG is jumped in closed form,
  state_k = A_k*s0 + C_k (mod 2^32), with host-built A/C vectors (on the
  device once per geometry) and one 32-bit seed per frame.

The JAX op widens under a scoped `jax.enable_x64`; here the dither sum
runs in native int64 and float64.  The float->int conversion of the
backward mode's inf/nan pixels reproduces x86-64 cvttsd2si (INT_MIN,
clipped to 0).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

_LCG_A = 1664525
_LCG_C = 1013904223

_JUMP_CACHE: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}


def lcg_jump_tables(n: int):
    """(A, C) uint32 vectors with state_k = A[k]*s0 + C[k] (mod 2^32)
    for the k-th draw of the LCG (k in [0, n))."""
    t = _JUMP_CACHE.get(n)
    if t is not None:
        return t
    A = np.empty(n, np.uint32)
    A[0] = 1
    if n > 1:
        A[1:] = np.cumprod(np.full(n - 1, _LCG_A, np.uint32),
                           dtype=np.uint32)
    S = np.zeros(n, np.uint32)           # sum_{j<k} A_j, wrapped
    if n > 1:
        S[1:] = np.cumsum(A[:n - 1], dtype=np.uint32)
    C = (np.uint32(_LCG_C) * S).astype(np.uint32)
    _JUMP_CACHE[n] = (A, C)
    return A, C


def lcg_after(s0: int, n: int) -> int:
    """State after n draws (host bookkeeping across frames)."""
    a, c = 1, 0
    base_a, base_c = _LCG_A, _LCG_C
    k = n
    while k:
        if k & 1:
            a = (a * base_a) & 0xFFFFFFFF
            c = (c * base_a + base_c) & 0xFFFFFFFF
        base_c = (base_c * base_a + base_c) & 0xFFFFFFFF
        base_a = (base_a * base_a) & 0xFFFFFFFF
        k >>= 1
    return (a * s0 + c) & 0xFFFFFFFF


def natural_fmap(w: int, h: int, x0: float, y0: float, xscale: float,
                 yscale: float, angle: float, backward: bool) -> np.ndarray:
    """The float32 factor map (update_context :146-188)."""
    xx = ((np.arange(w, dtype=np.float64) - x0)
          * np.float32(xscale)).astype(np.int64)
    yy = ((np.arange(h, dtype=np.float64) - y0)
          * np.float32(yscale)).astype(np.int64)
    dmax = np.hypot(w / 2.0, h / 2.0)
    dnorm = np.hypot(xx[None, :].astype(np.float64),
                     yy[:, None].astype(np.float64)) / dmax
    c = np.cos(angle * dnorm)
    f = (c * c) * (c * c)
    f = np.where(dnorm > 1.0, 0.0, f)
    if backward:
        with np.errstate(divide="ignore"):
            f = 1.0 / f
    return f.astype(np.float32)


def _lcg_states(A: torch.Tensor, C: torch.Tensor,
                seeds: torch.Tensor) -> torch.Tensor:
    """(A*s + C) mod 2^32 per (frame, pixel) in int64 without overflow:
    the seed is split into 16-bit halves, so no product passes 2^48."""
    s = seeds.to(torch.int64)[:, None]
    lo, hi = s & 0xFFFF, s >> 16
    return (A[None, :] * lo + (((A[None, :] * hi) & 0xFFFF) << 16)
            + C[None, :]) & 0xFFFFFFFF


def apply_vignette(planes, fmap: torch.Tensor, A: torch.Tensor,
                   C: torch.Tensor, seeds: torch.Tensor, offsets,
                   do_dither: bool, subs):
    """One batch: `planes` list of (N, ph, pw) uint8; fmap (h, w) f32 on
    the planes' device; A/C the flat per-frame-pixel jump tables as int64
    on that device; seeds (N,) int64 per-frame dither states; offsets[p]
    = pixel offset of plane p within a frame's dither stream; subs[p] =
    (hsub, vsub)."""
    outs = []
    for p, plane in enumerate(planes):
        n, ph, pw = plane.shape
        hsub, vsub = subs[p]
        fm = fmap[::1 << vsub, ::1 << hsub][:ph, :pw]
        src = plane.to(torch.float32)
        if p in (1, 2):
            # float until the double dither joins (+127 in FLOAT)
            val = fm[None] * (src - 127.0) + 127.0
        else:
            val = fm[None] * src
        acc = val.to(torch.float64)
        if do_dither:
            o = offsets[p]
            st = _lcg_states(A[o:o + ph * pw], C[o:o + ph * pw], seeds)
            acc = acc + (st.to(torch.float64) / 2.0 ** 32).reshape(n, ph,
                                                                    pw)
        # double -> int: cvttsd2si saturates inf/nan/overflow to INT_MIN,
        # which av_clip_uint8 turns into 0
        big = 2.0 ** 31
        ok = torch.isfinite(acc) & (acc > -big) & (acc < big)
        iv = torch.where(ok, torch.where(ok, acc, 0.0).to(torch.int64),
                         -(2 ** 31))
        outs.append(torch.clamp(iv, 0, 255).to(plane.dtype))
    return outs
