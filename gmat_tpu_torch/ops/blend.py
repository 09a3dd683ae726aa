"""Blend mode math — counterpart of `gmat_tpu/ops/blend.py`, vf_blend's
per-plane compositing kernels.

Rebuilds libavfilter's blend_modes.c (all 39 modes incl. option aliases,
blend_modes.c:119-157) and vf_blend_init.h's dispatch (copy fast paths at
vf_blend_init.h:188-196) for batched planes on their device, with the C
integer semantics the JAX module replicates:
  - int32 wraparound where the C multiplies/shifts overflow int (the
    16-bit SCREEN/heat/divide/exclusion family; blend_modes.c:63-66):
    PyTorch's int32 `*` and `<<` wrap on the CPU and on CUDA,
  - truncating (toward-zero) integer division
    (`torch.div(..., rounding_mode="trunc")`),
  - `2LL*A*B/(A+B)` for harmonic in native int64,
  - `lrintf` = round-half-even (geometric/interpolate),
  - the final store `dst[j] = top + (EXPR-top)*opacity` is a C float ->
    PIXEL conversion: truncation, INT32_MIN on nan/overflow, low 8/16
    bits kept (blend_modes.c:92-117).  A CUDA float->int cast saturates
    and turns NaN into 0, so the bad lanes get a finite value before the
    cast and INT32_MIN after it.

Float (depth 32) planes use the #else macro set (MAX=1.0, CLIP
identity, bit-ops through int32 views; blend_modes.c:72-82).  Every
division by a constant divides by a tensor on the planes' device: CUDA
divides by a host scalar through its reciprocal, which would round
differently from the CPU.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .lut import apply_lut

# option-name -> canonical mode key (blend_options, vf_blend.c:66-116;
# aliases addition128/grainmerge, difference128/grainextract share keys)
MODE_NAMES = {
    "normal": "normal", "addition": "addition",
    "addition128": "grainmerge", "grainmerge": "grainmerge",
    "and": "and", "average": "average", "burn": "burn",
    "darken": "darken", "difference": "difference",
    "difference128": "grainextract", "grainextract": "grainextract",
    "divide": "divide", "dodge": "dodge", "exclusion": "exclusion",
    "extremity": "extremity", "freeze": "freeze", "glow": "glow",
    "hardlight": "hardlight", "hardmix": "hardmix", "heat": "heat",
    "lighten": "lighten", "linearlight": "linearlight",
    "multiply": "multiply", "multiply128": "multiply128",
    "negation": "negation", "or": "or", "overlay": "overlay",
    "phoenix": "phoenix", "pinlight": "pinlight", "reflect": "reflect",
    "screen": "screen", "softlight": "softlight", "subtract": "subtract",
    "vividlight": "vividlight", "xor": "xor",
    "softdifference": "softdifference", "geometric": "geometric",
    "harmonic": "harmonic", "bleach": "bleach", "stain": "stain",
    "interpolate": "interpolate", "hardoverlay": "hardoverlay",
}

# BlendMode enum order (blend.h:27-70) for numeric mode options
MODE_ENUM = [
    "normal", "addition", "and", "average", "burn", "darken",
    "difference", "grainextract", "divide", "dodge", "exclusion",
    "hardlight", "lighten", "multiply", "negation", "or", "overlay",
    "phoenix", "pinlight", "reflect", "screen", "softlight", "subtract",
    "vividlight", "xor", "hardmix", "linearlight", "glow", "grainmerge",
    "multiply128", "heat", "freeze", "extremity", "softdifference",
    "geometric", "harmonic", "bleach", "stain", "interpolate",
    "hardoverlay",
]

_I32_MIN = -2147483648


def _cdiv(a, b):
    """C truncating int32 division with masked zero denominators; the
    caller selects away b==0 lanes (every C formula guards them)."""
    if not isinstance(b, torch.Tensor):
        return torch.div(a, b, rounding_mode="trunc")
    safe = torch.where(b == 0, torch.ones_like(b), b)
    return torch.div(a, safe, rounding_mode="trunc")


def _fdiv(a: torch.Tensor, b) -> torch.Tensor:
    """a / b in f32 with b as a tensor on a's device (no reciprocal)."""
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(b, dtype=torch.float32, device=a.device)
    return a / b


def _trunc_store(f: torch.Tensor, depth: int, dtype) -> torch.Tensor:
    """C (PIXEL)(float) store: truncation toward zero, INT32_MIN on
    nan/out-of-range, then the low 8/16 bits."""
    bad = torch.isnan(f) | (f >= 2147483648.0) | (f < -2147483648.0)
    i = torch.where(bad, torch.zeros_like(f), f).to(torch.int32)
    i = torch.where(bad, torch.full_like(i, _I32_MIN), i)
    return (i & ((1 << (8 if depth <= 8 else 16)) - 1)).to(dtype)


def _harmonic_q(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """trunc(2*A*B / (A+B)) in int64 (`2LL*A*B/(A+B)`); the caller
    selects away A == B == 0."""
    d = (a + b).to(torch.int64)
    d = torch.where(d == 0, torch.ones_like(d), d)
    n = 2 * a.to(torch.int64) * b.to(torch.int64)
    return torch.div(n, d, rounding_mode="trunc").to(torch.int32)


_COSF_LUTS = {}


def _cosf_lut(depth):
    """numpy f32 table of glibc cosf((float)(v * M_PI / MAX)) for
    v = 0..MAX — the exact per-pixel cos the C interpolate mode sees
    (argument computed in double, narrowed at the cosf call)."""
    tab = _COSF_LUTS.get(depth)
    if tab is None:
        import ctypes
        import ctypes.util
        libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
        libm.cosf.restype = ctypes.c_float
        libm.cosf.argtypes = [ctypes.c_float]
        maxv = (1 << depth) - 1
        tab = np.fromiter(
            (libm.cosf(np.float32(v * math.pi / maxv))
             for v in range(maxv + 1)),
            dtype=np.float32, count=maxv + 1)
        _COSF_LUTS[depth] = tab
    return tab


def _int_expr(key, a, b, depth):
    """EXPR of blend_modes.c:119-157 on int32 A/B for depth <= 16."""
    maxv = (1 << depth) - 1
    half = 1 << (depth - 1)
    zero = torch.zeros_like(a)

    def clip(x):
        return torch.clamp(x, 0, maxv)

    def multiply(x, aa, bb):                     # MULTIPLY(x, a, b)
        return x * _cdiv(aa * bb, maxv)

    def screen(x, aa, bb):                       # SCREEN(x, a, b)
        return maxv - x * _cdiv((maxv - aa) * (maxv - bb), maxv)

    def burn(aa, bb):                            # BURN(a, b)
        q = _cdiv((maxv - bb) << depth, aa)
        return torch.where(aa == 0, aa, torch.clamp(maxv - q, min=0))

    def dodge(aa, bb):                           # DODGE(a, b)
        q = _cdiv(bb << depth, maxv - aa)
        return torch.where(aa == maxv, aa, torch.clamp(q, max=maxv))

    if key == "addition":
        return torch.clamp(a + b, max=maxv)
    if key == "grainmerge":
        return clip(a + b - half)
    if key == "average":
        return _cdiv(a + b, 2)
    if key == "subtract":
        return torch.clamp(a - b, min=0)
    if key == "multiply":
        return multiply(1, a, b)
    if key == "multiply128":
        # (A-HALF)*B / MDIV + HALF in float32, MDIV = 0.125f*(1<<depth),
        # then CLIP's int conversion truncates (blend_modes.c:66,124)
        v = _fdiv(((a - half) * b).to(torch.float32),
                  0.125 * (1 << depth)) + float(half)
        return clip(v.to(torch.int32))           # in-clip-range after clamp
    if key == "negation":
        return maxv - torch.abs(maxv - a - b)
    if key == "extremity":
        return torch.abs(maxv - a - b)
    if key == "difference":
        return torch.abs(a - b)
    if key == "grainextract":
        return clip(half + a - b)
    if key == "screen":
        return screen(1, a, b)
    if key == "overlay":
        return torch.where(a < half, multiply(2, a, b), screen(2, a, b))
    if key == "hardlight":
        return torch.where(b < half, multiply(2, b, a), screen(2, b, a))
    if key == "hardmix":
        return torch.where(a < (maxv - b), zero, zero + maxv)
    if key == "heat":
        q = _cdiv((maxv - b) * (maxv - b), a)
        return torch.where(a == 0, zero, maxv - torch.clamp(q, max=maxv))
    if key == "freeze":
        q = _cdiv((maxv - a) * (maxv - a), b)
        return torch.where(b == 0, zero, maxv - torch.clamp(q, max=maxv))
    if key == "darken":
        return torch.minimum(a, b)
    if key == "lighten":
        return torch.maximum(a, b)
    if key == "divide":
        return clip(torch.where(b == 0, zero + maxv, _cdiv(maxv * a, b)))
    if key == "dodge":
        return dodge(a, b)
    if key == "burn":
        return burn(a, b)
    if key == "softlight":
        inner = _cdiv(b * _cdiv(a * (maxv - a), maxv), maxv)
        return clip(_cdiv(a * a, maxv) + 2 * inner)
    if key == "exclusion":
        # C precedence: A + B - 2*A*B/MAX == A + B - ((2*A)*B)/MAX,
        # with the 16-bit (2A)*B product wrapping int32 like gcc
        return a + b - _cdiv(2 * a * b, maxv)
    if key == "pinlight":
        return torch.where(b < half, torch.minimum(a, 2 * b),
                           torch.maximum(a, 2 * (b - half)))
    if key == "phoenix":
        return torch.minimum(a, b) - torch.maximum(a, b) + maxv
    if key == "reflect":
        q = _cdiv(a * a, maxv - b)
        return torch.where(b == maxv, b, torch.clamp(q, max=maxv))
    if key == "glow":
        q = _cdiv(b * b, maxv - a)
        return torch.where(a == maxv, a, torch.clamp(q, max=maxv))
    if key == "and":
        return a & b
    if key == "or":
        return a | b
    if key == "xor":
        return a ^ b
    if key == "vividlight":
        return torch.where(a < half, burn(2 * a, b),
                           dodge(2 * (a - half), b))
    if key == "linearlight":
        return clip(torch.where(b < half, b + 2 * a - maxv,
                                b + 2 * (a - half)))
    if key == "softdifference":
        up = torch.where(b == maxv, zero, _cdiv((a - b) * maxv, maxv - b))
        dn = torch.where(b == 0, zero, _cdiv((b - a) * maxv, b))
        return clip(torch.where(a > b, up, dn))
    if key == "geometric":
        # lrintf(sqrtf((unsigned)A * B)): the unsigned product rounded to
        # f32, its correctly rounded f32 sqrt, round-half-even.  The
        # product is exact in f64, and the f64 sqrt of an f32 value
        # rounded to f32 is the f32 sqrt; CUDA's f32 sqrt is not
        # correctly rounded, and moved a 16-bit result by 1
        prod = (a.to(torch.float64) * b.to(torch.float64)).to(torch.float32)
        root = torch.sqrt(prod.to(torch.float64)).to(torch.float32)
        return torch.round(root).to(torch.int32)
    if key == "harmonic":
        return torch.where((a == 0) & (b == 0), zero, _harmonic_q(a, b))
    if key == "bleach":
        return (maxv - b) + (maxv - a) - maxv
    if key == "stain":
        return 2 * maxv - a - b
    if key == "interpolate":
        # lrintf(MAX*(2 - cosf(A*M_PI/MAX) - cosf(B*M_PI/MAX))*0.25f).
        # The cos argument is a double (A*M_PI/MAX) narrowed at the
        # cosf call; a per-pixel-value libm-cosf table gathered with
        # int32 indices reproduces that exactly
        tab = torch.as_tensor(_cosf_lut(depth), device=a.device)
        ca = apply_lut(a, tab)
        cb = apply_lut(b, tab)
        v = float(maxv) * ((2.0 - ca) - cb) * 0.25
        return torch.round(v).to(torch.int32)
    if key == "hardoverlay":
        q1 = _cdiv(maxv * b, 2 * maxv - 2 * a)
        q2 = _cdiv(2 * a * b, maxv)
        s = q1 * (a > half).to(torch.int32) \
            + q2 * (a <= half).to(torch.int32)
        return torch.where(a == maxv, zero + maxv,
                           torch.clamp(s, max=maxv))
    raise ValueError(f"unknown blend mode {key!r}")


def _float_expr(key, a, b):
    """EXPR on float32 A/B (DEPTH 32 macro set, blend_modes.c:72-82)."""
    one = torch.ones_like(a)
    zero = torch.zeros_like(a)
    half = 0.5

    def multiply(x, aa, bb):
        return x * (aa * bb)

    def screen(x, aa, bb):
        return 1.0 - x * ((1.0 - aa) * (1.0 - bb))

    def burn(aa, bb):
        return torch.where(aa <= 0.0, aa, torch.clamp(
            1.0 - (1.0 - bb) / torch.where(aa <= 0.0, one, aa), min=0.0))

    def dodge(aa, bb):
        return torch.where(aa >= 1.0, aa, torch.clamp(
            bb / torch.where(aa >= 1.0, one, 1.0 - aa), max=1.0))

    def bits(x):
        return x.view(torch.int32)

    def unbits(i):
        return i.view(torch.float32)

    if key == "addition":
        return torch.clamp(a + b, max=1.0)
    if key == "grainmerge":
        return a + b - half
    if key == "average":
        return _fdiv(a + b, 2.0)
    if key == "subtract":
        return torch.clamp(a - b, min=0.0)
    if key == "multiply":
        return multiply(1.0, a, b)
    if key == "multiply128":
        return _fdiv((a - half) * b, 0.125) + half
    if key == "negation":
        return 1.0 - torch.abs(1.0 - a - b)
    if key == "extremity":
        return torch.abs(1.0 - a - b)
    if key == "difference":
        return torch.abs(a - b)
    if key == "grainextract":
        return half + a - b
    if key == "screen":
        return screen(1.0, a, b)
    if key == "overlay":
        return torch.where(a < half, multiply(2.0, a, b), screen(2.0, a, b))
    if key == "hardlight":
        return torch.where(b < half, multiply(2.0, b, a), screen(2.0, b, a))
    if key == "hardmix":
        return torch.where(a < (1.0 - b), zero, one)
    if key == "heat":
        q = (1.0 - b) * (1.0 - b) / torch.where(a == 0, one, a)
        return torch.where(a == 0, zero, 1.0 - torch.clamp(q, max=1.0))
    if key == "freeze":
        q = (1.0 - a) * (1.0 - a) / torch.where(b == 0, one, b)
        return torch.where(b == 0, zero, 1.0 - torch.clamp(q, max=1.0))
    if key == "darken":
        return torch.minimum(a, b)
    if key == "lighten":
        return torch.maximum(a, b)
    if key == "divide":
        return torch.where(b == 0, one, a / torch.where(b == 0, one, b))
    if key == "dodge":
        return dodge(a, b)
    if key == "burn":
        return burn(a, b)
    if key == "softlight":
        return a * a + 2.0 * (b * (a * (1.0 - a)))
    if key == "exclusion":
        return a + b - 2.0 * a * b
    if key == "pinlight":
        return torch.where(b < half, torch.minimum(a, 2 * b),
                           torch.maximum(a, 2 * (b - half)))
    if key == "phoenix":
        return torch.minimum(a, b) - torch.maximum(a, b) + 1.0
    if key == "reflect":
        q = a * a / torch.where(b == 1.0, one, 1.0 - b)
        return torch.where(b == 1.0, b, torch.clamp(q, max=1.0))
    if key == "glow":
        q = b * b / torch.where(a == 1.0, one, 1.0 - a)
        return torch.where(a == 1.0, a, torch.clamp(q, max=1.0))
    if key == "and":
        return unbits(bits(a) & bits(b))
    if key == "or":
        return unbits(bits(a) | bits(b))
    if key == "xor":
        return unbits(bits(a) ^ bits(b))
    if key == "vividlight":
        return torch.where(a < half, burn(2 * a, b),
                           dodge(2 * (a - half), b))
    if key == "linearlight":
        return torch.where(b < half, b + 2 * a - 1.0, b + 2 * (a - half))
    if key == "softdifference":
        up = torch.where(b == 1.0, zero,
                         (a - b) / torch.where(b == 1.0, one, 1.0 - b))
        dn = torch.where(b == 0, zero, (b - a) / torch.where(b == 0, one, b))
        return torch.where(a > b, up, dn)
    if key == "geometric":
        return torch.sqrt(torch.clamp(a, min=0.0) * torch.clamp(b, min=0.0))
    if key == "harmonic":
        both = (a == 0) & (b == 0)
        d = torch.where(both, one, a + b)
        return torch.where(both, zero, 2.0 * a * b / d)
    if key == "bleach":
        return (1.0 - b) + (1.0 - a) - 1.0
    if key == "stain":
        return 2.0 - a - b
    if key == "interpolate":
        pi = float(np.float32(math.pi))
        return (2.0 - torch.cos(a * pi) - torch.cos(b * pi)) * 0.25
    if key == "hardoverlay":
        q1 = b / torch.where(a == 1.0, one, 2.0 - 2 * a)
        q2 = 2 * a * b
        s = q1 * (a > half) + q2 * (a <= half)
        return torch.where(a == 1.0, one, torch.clamp(s, max=1.0))
    raise ValueError(f"unknown blend mode {key!r}")


def blend_plane(top: torch.Tensor, bottom: torch.Tensor, mode: str,
                opacity: float, depth: int) -> torch.Tensor:
    """One plane through one blend mode (same dtype out), on the planes'
    device.

    Mirrors vf_blend_init.h's fast-path dispatch: opacity==0 on a
    non-normal mode copies top; normal at opacity 1/0 copies top/bottom;
    everything else runs `dst = top + (EXPR - top) * opacity` with the C
    float store semantics (blend_modes.c:92-117).
    """
    mode = MODE_NAMES.get(mode, mode)   # addition128/difference128 aliases
    if mode == "normal":
        if opacity == 1.0:
            return top
        if opacity == 0.0:
            return bottom
    elif opacity == 0.0:
        return top

    op = float(np.float32(opacity))
    rest = float(np.float32(1.0) - np.float32(opacity))
    if top.dtype.is_floating_point:
        a = top.to(torch.float32)
        b = bottom.to(torch.float32)
        if mode == "normal":
            return (a * op + b * rest).to(top.dtype)
        e = _float_expr(mode, a, b)
        return (a + (e - a) * op).to(top.dtype)

    a = top.to(torch.int32)
    b = bottom.to(torch.int32)
    if mode == "normal":
        v = a.to(torch.float32) * op + b.to(torch.float32) * rest
        return _trunc_store(v, depth, top.dtype)
    e = _int_expr(mode, a, b, depth)
    v = a.to(torch.float32) + (e - a).to(torch.float32) * op
    return _trunc_store(v, depth, top.dtype)
