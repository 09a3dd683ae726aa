"""Colorspace matrix tables — a numpy-only copy of `gmat_tpu/core/color.py`.

Replicates the exact limited-range matrix construction of the reference
(ffmpeg-gpu/libswscale/cuda/yuv2rgb_cuda.cu:782-849, get_constants /
set_mat_yuv2rgb_cuda / set_mat_rgb2yuv_cuda) so that our kernels produce
swscale-equivalent output within tolerance:

  * yuv->rgb:  rgb = clamp(M @ (y - low, u - mid, v - mid), 0, max)
               with M scaled by max/(white-black)
  * rgb->yuv:  (y,u,v) = M' @ (r,g,b) + (low, mid, mid)
               with M' scaled by (white-black)/max
  * low = 1 << (bits - 4),  mid = 1 << (bits - 1)   [per YUV sample depth]

Matrices are depth-independent ratios (the reference uses 8-bit
black/white/max for all spaces except BT.2020 which uses the 10-in-16-bit
constants); the per-sample offsets depend on the actual YUV bit depth.
"""
from __future__ import annotations

import numpy as np

# Colorspace -> (wr, wb) luma weights, mirroring AVColorSpace handling in the
# reference's get_constants() (yuv2rgb_cuda.cu:783-816).
_KR_KB = {
    "bt709": (0.2126, 0.0722),
    "fcc": (0.30, 0.11),
    "bt601": (0.2990, 0.1140),       # AVCOL_SPC_BT470BG / SMPTE170M / default
    "bt470bg": (0.2990, 0.1140),
    "smpte170m": (0.2990, 0.1140),
    "smpte240m": (0.212, 0.087),
    "bt2020": (0.2627, 0.0593),
}

COLORSPACES = tuple(_KR_KB.keys())


def _constants(cspace: str):
    wr, wb = _KR_KB[cspace]
    if cspace == "bt2020":
        # 10-bit studio swing stored in 16-bit containers (reference: :810-812)
        black, white, maxv = 64 << 6, 940 << 6, (1 << 16) - 1
    else:
        black, white, maxv = 16, 235, 255
    return wr, wb, black, white, maxv


def yuv2rgb_matrix(cspace: str = "bt709") -> np.ndarray:
    """3x3 float32 matrix, rows = R,G,B, columns = (Y-low, U-mid, V-mid)."""
    wr, wb, black, white, maxv = _constants(cspace)
    mat = np.array(
        [
            [1.0, 0.0, (1.0 - wr) / 0.5],
            [1.0, -wb * (1.0 - wb) / 0.5 / (1.0 - wb - wr),
                  -wr * (1.0 - wr) / 0.5 / (1.0 - wb - wr)],
            [1.0, (1.0 - wb) / 0.5, 0.0],
        ],
        dtype=np.float64,
    )
    mat *= 1.0 * maxv / (white - black)
    return mat.astype(np.float32)


def rgb2yuv_matrix(cspace: str = "bt709") -> np.ndarray:
    """3x3 float32 matrix, rows = Y,U,V, columns = R,G,B."""
    wr, wb, black, white, maxv = _constants(cspace)
    mat = np.array(
        [
            [wr, 1.0 - wb - wr, wb],
            [-0.5 * wr / (1.0 - wb), -0.5 * (1.0 - wb - wr) / (1.0 - wb), 0.5],
            [0.5, -0.5 * (1.0 - wb - wr) / (1.0 - wr), -0.5 * wb / (1.0 - wr)],
        ],
        dtype=np.float64,
    )
    mat *= 1.0 * (white - black) / maxv
    return mat.astype(np.float32)


def yuv_offsets(bits: int):
    """(low, mid) offsets for a given YUV sample bit depth.

    Reference: yuv2rgb_for_pixel (yuv2rgb_cuda.cu:71-74):
      low = 1 << (bits - 4), mid = 1 << (bits - 1).
    """
    return 1 << (bits - 4), 1 << (bits - 1)
