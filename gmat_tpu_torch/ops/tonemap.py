"""HDR -> SDR tone mapping (vf_tonemap) — counterpart of
`gmat_tpu/ops/tonemap.py`.

The C filter walks GBRPF32 pixels one at a time (vf_tonemap.c
tonemap_slice:181-197); here the whole (..., 3) float batch is a few
elementwise tensor ops on its device.

Math parity notes (tonemap():110-173 and init():65-88):
  * per-operator ``param`` defaulting happens on the host exactly like
    init(): gamma NaN->1.8, mobius NaN->0.3, reinhard transforms a GIVEN
    param to (1-p)/p, anything still NaN -> 1.0.
  * desaturation uses the ORIGINAL stream colorspace's luma weights and
    mixes toward luma by
    overbright = max(luma-desat,1e-6)/max(luma,1e-6).
  * the tone curve is applied to sig = max(max3(r,g,b), 1e-6) and the
    colour is scaled linearly by sig/sig_orig — never per-channel.
  * scalar curve constants follow the C's precisions: hable(peak) is the
    FLOAT hable() (f32 throughout); the mobius a/b knee values are double
    expressions stored to float, the scale numerator float32; the gamma
    toe scale is double pow.  Per-pixel math runs in f32.
"""
from __future__ import annotations

import math

import numpy as np
import torch

METHODS = ("none", "linear", "gamma", "clip", "reinhard", "hable",
           "mobius")


def _hable32(x: float) -> float:
    """The C's `static float hable(float)` (vf_tonemap.c:90-94): float32
    arithmetic including the argument conversion."""
    f32 = np.float32
    x = f32(x)
    a, b, c, d, e, f = (f32(0.15), f32(0.50), f32(0.10), f32(0.20),
                        f32(0.02), f32(0.30))
    return float(f32(f32(x * f32(x * a + b * c) + d * e)
                     / f32(x * f32(x * a + b) + d * f)) - f32(e / f))


def resolve_param(method: str, param: float) -> float:
    """Host analog of init() (vf_tonemap.c:65-88)."""
    if method == "gamma":
        if math.isnan(param):
            param = 1.8
    elif method == "reinhard":
        if not math.isnan(param):
            param = (1.0 - param) / param
    elif method == "mobius":
        if math.isnan(param):
            param = 0.3
    if math.isnan(param):
        param = 1.0
    return float(param)


def tonemap_rgb(rgb: torch.Tensor, method: str, param: float, desat: float,
                peak: float, luma_coeffs=None) -> torch.Tensor:
    """Apply vf_tonemap to a (..., 3) linear-light float RGB tensor.

    ``param`` must already be resolved via :func:`resolve_param`;
    ``luma_coeffs`` is (kr, kg, kb) of the original stream colorspace or
    None to disable desaturation (the "unsupported color space" path,
    vf_tonemap.c:244-252)."""
    if method not in METHODS:
        raise ValueError(f"unknown tonemap algorithm {method!r}")
    x = rgb.to(torch.float32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    peak = float(peak)

    if desat > 0 and luma_coeffs is not None:
        kr, kg, kb = (float(c) for c in luma_coeffs)
        luma = kr * r + kg * g + kb * b
        over = (torch.clamp(luma - desat, min=1e-6)
                / torch.clamp(luma, min=1e-6))
        r = r * (1.0 - over) + luma * over
        g = g * (1.0 - over) + luma * over
        b = b * (1.0 - over) + luma * over

    sig_orig = torch.clamp(torch.maximum(torch.maximum(r, g), b), min=1e-6)
    sig = sig_orig

    if method == "linear":
        sig = sig * (param / peak)
    elif method == "gamma":
        inv_g = 1.0 / param
        toe_scale = math.pow(0.05 / peak, inv_g) / 0.05
        sig = torch.where(sig > 0.05, torch.pow(sig / peak, inv_g),
                          sig * toe_scale)
    elif method == "clip":
        sig = torch.clamp(sig * param, 0.0, 1.0)
    elif method == "hable":
        a, bb, c, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
        h = ((sig * (sig * a + bb * c) + d * e)
             / (sig * (sig * a + bb) + d * f) - e / f)
        sig = h / _hable32(peak)
    elif method == "reinhard":
        sig = sig / (sig + param) * ((peak + param) / peak)
    elif method == "mobius":
        f32 = np.float32
        j = param
        j32 = f32(j)
        # a/b: double expressions stored to float (vf_tonemap.c:96-107);
        # (j*j - 2.0f*j) is a FLOAT subtraction before peak promotes it
        a = f32(-float(f32(j32 * j32)) * (peak - 1.0)
                / (float(f32(f32(j32 * j32) - f32(2.0 * j32))) + peak))
        bj = f32((float(f32(j32 * j32)) - float(f32(2.0 * j32)) * peak
                  + peak) / max(peak - 1.0, 1e-6))
        scale = float(f32(f32(bj * bj + f32(f32(2.0) * bj) * j32
                              + f32(j32 * j32)) / f32(bj - a)))
        sig = torch.where(sig <= j, sig,
                          scale * (sig + float(a)) / (sig + float(bj)))

    scale = sig / sig_orig
    return torch.stack([r * scale, g * scale, b * scale], dim=-1)
