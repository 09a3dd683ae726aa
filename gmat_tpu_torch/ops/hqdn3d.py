"""hqdn3d, the high-quality 3D (spatio-temporal) denoiser — counterpart
of `gmat_tpu/ops/hqdn3d.py`.

vf_hqdn3d.c:
  - precalc_coefs (vf_hqdn3d.c:176-191): per-strength int LUT over
    quantized pixel differences; ct[0] doubles as the spatial-enable flag.
  - lowpass (vf_hqdn3d.c:50-55): cur + coef[(prev-cur) >> (8-LUT_BITS)],
    LUT_BITS = 8 at depth 16 else 4.
  - denoise_spatial (vf_hqdn3d.c:80-121): horizontal IIR, vertical IIR
    (uint16-truncated between rows), then the temporal IIR against the
    previous *filtered* frame (uint16 state), in a 16-bit working scale.
  - denoise_temporal (vf_hqdn3d.c:57-77) when the spatial strength is 0.

The JAX op scans whole lines: each step is one lowpass over a full
(N, H) column or (N, W) row, the temporal IIR steps over the batch with
the cross-batch frame state held here.  The port keeps that
vectorization as host loops of W, H and N steps (one index gather into
the coefficient table per step), with the same int32 math and uint16
masking between steps.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..core.frame import FrameBatch


def precalc_coefs(dist25: float, depth: int) -> np.ndarray:
    """int32 coefficient table, size 512<<LUT_BITS, offset 256<<LUT_BITS."""
    lut_bits = 8 if depth == 16 else 4
    n = 256 << lut_bits
    ct = np.zeros(2 * n, np.int32)
    gamma = math.log(0.25) / math.log(1.0 - min(dist25, 252.0) / 255.0
                                      - 0.00001)
    i = np.arange(-n, n, dtype=np.float64)
    f = ((i * (1 << (9 - lut_bits))) + (1 << (8 - lut_bits)) - 1) / 512.0
    simil = np.maximum(0.0, 1.0 - np.abs(f) / 255.0)
    c = np.power(simil, gamma) * 256.0 * f
    ct[:] = np.rint(c).astype(np.int64)     # lrint (ties even, irrelevant)
    ct[0] = 1 if dist25 else 0              # vf_hqdn3d.c:191
    return ct


def _lowpass(prev, cur, coef, shift, offset):
    d = (prev - cur) >> shift               # arithmetic, like C int >>
    return cur + coef[(d + offset).to(torch.int64)]


def _denoise_plane(arr, spatial_ct, temporal_ct, sp, tp, frame_state,
                   depth):
    """One plane (N, H, W) -> (filtered, new_frame_state).

    `sp`/`tp`: the tables as int32 tensors on the plane's device.
    frame_state: (H, W) int32 or None (first call: the first frame's
    LOADed samples, like denoise_depth, vf_hqdn3d.c:133-145)."""
    lut_bits = 8 if depth == 16 else 4
    shift = 8 - lut_bits
    offset = 256 << lut_bits
    n, h, w = arr.shape
    loaded = (arr.to(torch.int32) << (16 - depth)) \
        + (((1 << (16 - depth)) - 1) >> 1)
    if frame_state is None:
        frame_state = loaded[0]

    if spatial_ct[0]:
        # horizontal IIR over x, carrying pixel_ant (N, H): row 0
        # lowpasses its first sample against itself, rows >= 1 keep it raw
        hh = loaded.permute(2, 0, 1).contiguous()       # (W, N, H)
        first = _lowpass(hh[0], hh[0], sp, shift, offset)
        hh[0, :, 0] = first[:, 0]
        for x in range(1, w):
            hh[x] = _lowpass(hh[x - 1], hh[x], sp, shift, offset)
        # vertical IIR over y, carrying line_ant (N, W) uint16-truncated
        vv = hh.permute(2, 1, 0).contiguous()           # (H, N, W)
        for y in range(1, h):
            vv[y] = _lowpass(vv[y - 1] & 0xFFFF, vv[y], sp, shift, offset)
        vv = vv.permute(1, 0, 2)                        # (N, H, W)
    else:
        vv = loaded                                     # denoise_temporal

    # temporal IIR over the batch, carrying frame_ant (H, W) uint16
    tt = torch.empty_like(vv)
    carry = frame_state & 0xFFFF
    for i in range(n):
        tt[i] = _lowpass(carry, vv[i], tp, shift, offset)
        carry = tt[i] & 0xFFFF
    out = (tt >> (16 - depth)).to(arr.dtype)
    return out, carry


class HQDN3D:
    """Stateful per-stream denoiser; one instance per FilterGraph.

    Strength defaults follow init() (vf_hqdn3d.c:196-211): unset values
    derive from the ratios of 4:3:6:4.5."""

    def __init__(self, luma_spatial: float = 0.0,
                 chroma_spatial: float = 0.0,
                 luma_tmp: float = 0.0, chroma_tmp: float = 0.0):
        ls = float(luma_spatial) or 4.0
        cs = float(chroma_spatial) or 3.0 * ls / 4.0
        lt = float(luma_tmp) or 6.0 * ls / 4.0
        ct = float(chroma_tmp) or lt * cs / ls
        for v, nm in ((ls, "luma_spatial"), (cs, "chroma_spatial"),
                      (lt, "luma_tmp"), (ct, "chroma_tmp")):
            if not 0.0 <= v <= 255.0:
                raise ValueError(f"hqdn3d {nm}={v} out of [0, 255]")
        self.strengths = (ls, cs, lt, ct)
        self._coefs: Dict = {}              # (depth, device) -> tables
        self._state: Dict = {}              # plane name -> (H, W) tensor

    def _tables(self, depth, device):
        key = (depth, str(device))
        t = self._coefs.get(key)
        if t is None:
            host = tuple(precalc_coefs(s, depth) for s in self.strengths)
            t = (host, tuple(torch.as_tensor(c, device=device)
                             for c in host))
            self._coefs[key] = t
        return t

    def reset(self):
        self._state.clear()

    def __call__(self, fb: FrameBatch) -> FrameBatch:
        fmt = fb.fmt
        if fmt.is_rgb or fmt.is_float or fmt.name in ("p010", "p016"):
            raise ValueError("hqdn3d operates on planar YUV/gray "
                             "(vf_hqdn3d.c pix_fmts); convert first")
        depth = fmt.bits
        host, dev = self._tables(depth, fb.device)
        planes = {}
        for p in fmt.planes:
            arr = fb.planes[p.name]
            k = (0, 2) if p.name == "y" else (1, 3)
            st = self._state.get(p.name)
            if st is not None and tuple(st.shape) != tuple(arr.shape[1:]):
                st = None                   # dimension change: re-seed
            out, st = _denoise_plane(arr, host[k[0]], host[k[1]],
                                     dev[k[0]], dev[k[1]], st, depth)
            self._state[p.name] = st
            planes[p.name] = out
        return fb.with_planes(planes)
