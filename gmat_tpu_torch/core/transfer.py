"""Transfer characteristics and colour primaries — counterpart of
`gmat_tpu/core/transfer.py`.

The curves zimg applies for vf_zscale (ffmpeg-gpu/libavfilter/
vf_zscale.c:441-470 maps AVColorTransferCharacteristic ->
ZIMG_TRANSFER_*, :400-427 the primaries), as f32 tensor math on the
input's device, and the numpy matrix builders of libavfilter's
colorspace helpers (colorspace.c ff_fill_rgb2xyz_table), copied:

  * ``linearize(x, trc, npl)``    non-linear signal in [0,1] -> linear
                                  light where 1.0 == ``npl`` cd/m2
  * ``delinearize(x, trc, npl)``  the inverse
  * ``gamut_matrix(src, dst)``    3x3 linear-RGB primaries conversion
                                  built via XYZ

SMPTE ST 2084 (PQ) is absolute: the EOTF yields [0, 10000] cd/m2, then
divided by ``npl`` (a 1000-nit highlight lands at 10.0 for npl=100).
ARIB STD-B67 (HLG) is linearized scene-referred (inverse OETF scaled so
the 1000-nit nominal peak lands at 1000/npl), without the BT.2100 OOTF,
as the JAX module does.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# SMPTE ST 2084 (PQ) constants
_PQ_M1 = 2610.0 / 16384.0            # 0.1593017578125
_PQ_M2 = 2523.0 / 4096.0 * 128.0     # 78.84375
_PQ_C1 = 3424.0 / 4096.0             # 0.8359375
_PQ_C2 = 2413.0 / 4096.0 * 32.0      # 18.8515625
_PQ_C3 = 2392.0 / 4096.0 * 32.0      # 18.6875

# ARIB STD-B67 (HLG) constants
_HLG_A = 0.17883277
_HLG_B = 1.0 - 4.0 * _HLG_A          # 0.28466892
_HLG_C = 0.5 - _HLG_A * math.log(4.0 * _HLG_A)   # 0.55991073

# zscale/zimg transfer-name grammar (vf_zscale.c:1035-1046) plus the
# ffmpeg AVColorTransferCharacteristic aliases a stream probe reports
_TRC_ALIASES = {
    "bt709": "709", "709": "709", "601": "709", "bt601": "709",
    "smpte170m": "709", "bt470bg": "gamma28", "gamma28": "gamma28",
    "bt470m": "gamma22", "gamma22": "gamma22",
    "2020_10": "709", "2020_12": "709", "bt2020-10": "709",
    "bt2020-12": "709",
    "linear": "linear",
    "smpte2084": "st2084", "st2084": "st2084", "pq": "st2084",
    "arib-std-b67": "arib-std-b67", "hlg": "arib-std-b67",
    "iec61966-2-1": "srgb", "srgb": "srgb",
    "bt1886": "bt1886",
}

TRANSFERS = tuple(sorted(set(_TRC_ALIASES.values())))


def canon_trc(name: str) -> str:
    key = str(name).strip().lower()
    if key not in _TRC_ALIASES:
        raise ValueError(f"unknown transfer characteristic {name!r} "
                         f"(known: {', '.join(sorted(_TRC_ALIASES))})")
    return _TRC_ALIASES[key]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def linearize(x, trc: str, npl: float = 100.0) -> torch.Tensor:
    """Non-linear signal in [0,1] -> linear light (1.0 == npl cd/m2).

    SDR curves (709/srgb/gamma/bt1886) map [0,1]->[0,1]; ST2084 maps to
    [0, 10000/npl]; HLG to [0, 1000/npl]."""
    trc = canon_trc(trc)
    x = _f32(x)
    if trc == "linear":
        return x
    if trc == "st2084":
        p = torch.pow(torch.clamp(x, min=0.0), 1.0 / _PQ_M2)
        num = torch.clamp(p - _PQ_C1, min=0.0)
        den = _PQ_C2 - _PQ_C3 * p
        return torch.pow(num / den, 1.0 / _PQ_M1) * (10000.0 / npl)
    if trc == "arib-std-b67":
        lo = x * x / 3.0
        hi = (torch.exp((x - _HLG_C) / _HLG_A) + _HLG_B) / 12.0
        return torch.where(x <= 0.5, lo, hi) * (1000.0 / npl)
    if trc == "709":
        # inverse of the Rec.709 OETF (beta=0.018, 4.5 / 1.099)
        return torch.where(x < 4.5 * 0.018, x / 4.5,
                           torch.pow((x + 0.099) / 1.099, 1.0 / 0.45))
    if trc == "srgb":
        return torch.where(x <= 0.04045, x / 12.92,
                           torch.pow((x + 0.055) / 1.055, 2.4))
    gamma = {"bt1886": 2.4, "gamma22": 2.2, "gamma28": 2.8}[trc]
    return torch.pow(torch.clamp(x, min=0.0), gamma)


def delinearize(x, trc: str, npl: float = 100.0) -> torch.Tensor:
    """Linear light (1.0 == npl cd/m2) -> non-linear signal in [0,1]."""
    trc = canon_trc(trc)
    x = _f32(x)
    if trc == "linear":
        return x
    if trc == "st2084":
        y = torch.clamp(x * (npl / 10000.0), min=0.0)
        ym = torch.pow(y, _PQ_M1)
        return torch.pow((_PQ_C1 + _PQ_C2 * ym) / (1.0 + _PQ_C3 * ym),
                         _PQ_M2)
    if trc == "arib-std-b67":
        e = torch.clamp(x * (npl / 1000.0), min=0.0)
        lo = torch.sqrt(3.0 * e)
        hi = _HLG_A * torch.log(torch.clamp(12.0 * e - _HLG_B,
                                            min=1e-7)) + _HLG_C
        return torch.where(e <= 1.0 / 12.0, lo, hi)
    x = torch.clamp(x, min=0.0)
    if trc == "709":
        return torch.where(x < 0.018, x * 4.5,
                           1.099 * torch.pow(x, 0.45) - 0.099)
    if trc == "srgb":
        return torch.where(x <= 0.0031308, x * 12.92,
                           1.055 * torch.pow(x, 1.0 / 2.4) - 0.055)
    gamma = {"bt1886": 2.4, "gamma22": 2.2, "gamma28": 2.8}[trc]
    return torch.pow(x, 1.0 / gamma)


# ---------------------------------------------------------------------------
# Colour primaries (CIE 1931 xy chromaticities + D65 white), the values
# libavutil/csp.c tabulates; names follow zscale's primaries grammar
# (vf_zscale.c:1048-1060).
_PRIMARIES = {
    # name: (rx, ry, gx, gy, bx, by)
    "709": (0.640, 0.330, 0.300, 0.600, 0.150, 0.060),
    "2020": (0.708, 0.292, 0.170, 0.797, 0.131, 0.046),
    "170m": (0.630, 0.340, 0.310, 0.595, 0.155, 0.070),
    "470bg": (0.640, 0.330, 0.290, 0.600, 0.150, 0.060),
    "p3dci": (0.680, 0.320, 0.265, 0.690, 0.150, 0.060),
    "p3d65": (0.680, 0.320, 0.265, 0.690, 0.150, 0.060),
}
_PRIM_ALIASES = {
    "bt709": "709", "709": "709",
    "bt2020": "2020", "2020": "2020",
    "smpte170m": "170m", "170m": "170m", "601": "170m", "bt601": "170m",
    "bt470bg": "470bg", "470bg": "470bg",
    "smpte432": "p3d65", "p3d65": "p3d65", "display-p3": "p3d65",
    "smpte431": "p3dci", "p3dci": "p3dci",
}
_WHITE_D65 = (0.3127, 0.3290)
_WHITE_DCI = (0.3140, 0.3510)

PRIMARIES = tuple(sorted(set(_PRIM_ALIASES.values())))


def canon_primaries(name: str) -> str:
    key = str(name).strip().lower()
    if key not in _PRIM_ALIASES:
        raise ValueError(f"unknown primaries {name!r} "
                         f"(known: {', '.join(sorted(_PRIM_ALIASES))})")
    return _PRIM_ALIASES[key]


def rgb2xyz_matrix(primaries: str) -> np.ndarray:
    """3x3 float64 linear-RGB -> CIE XYZ, built exactly like
    colorspace.c ff_fill_rgb2xyz_table (white row normalised to Y=1)."""
    p = canon_primaries(primaries)
    rx, ry, gx, gy, bx, by = _PRIMARIES[p]
    wx, wy = _WHITE_DCI if p == "p3dci" else _WHITE_D65
    # chromaticity -> unscaled XYZ columns (z = 1 - x - y)
    m = np.array([[rx / ry, gx / gy, bx / by],
                  [1.0, 1.0, 1.0],
                  [(1 - rx - ry) / ry, (1 - gx - gy) / gy,
                   (1 - bx - by) / by]], np.float64)
    w = np.array([wx / wy, 1.0, (1 - wx - wy) / wy], np.float64)
    s = np.linalg.solve(m, w)
    return m * s[None, :]


def gamut_matrix(src: str, dst: str) -> np.ndarray:
    """3x3 float32 linear-RGB src-primaries -> dst-primaries matrix
    (xyz2rgb(dst) @ rgb2xyz(src), the colorspace.c composition)."""
    a = rgb2xyz_matrix(src)
    b = rgb2xyz_matrix(dst)
    return np.linalg.solve(b, a).astype(np.float32)
