"""noise, film-grain synthesis (vf_noise.c) — counterpart of
`gmat_tpu/ops/noise.py`.

The host code is the JAX module's, copied: the AVLFG lagged-Fibonacci
PRNG (libavutil/lfg.c:32-48, lfg.h:53-57) with state[8..63] from the
chained MD5 construction and state[0..7] zero, the noise-table
construction (vf_noise.c:70-131: uniform/pattern integer math with C
truncation, the Box-Muller gaussian with the C's mixed float/double
expressions, the RAND_N(6) pattern stutter, and the MAX_RES*3 prev_shift
draws that advance the LFG in every mode), and the per-frame rand_shift
draws for NOISE_TEMPORAL (vf_noise.c:261-271).

The per-pixel apply runs on the plane's device: ff_line_noise_c indexes
noise[shift + i] per MAX_RES-wide chunk (vf_noise.c:205-218), i.e.
dst = clip_u8(src + noise[shift[y & 4095] + (x % 4096)]); only the
(frame, row) shift vectors (N x 4096 ints) go to the device per batch,
and the noise map is one index gather through ops/lut.py.

NOISE_AVERAGED is rejected: the reference's averaged path writes
prev_shift[ix][shift & 3] into a 3-entry array (vf_noise.c:214).
"""
from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

MAX_NOISE = 5120
MAX_SHIFT = 1024
MAX_RES = MAX_NOISE - MAX_SHIFT           # 4096

NOISE_AVERAGED = 8
NOISE_PATTERN = 16
NOISE_TEMPORAL = 4
NOISE_UNIFORM = 2

_PATT = (-1, 0, 1, 0)
_UINT_MAX_F = float(np.float32(0xFFFFFFFF))       # (float)UINT_MAX = 2^32


class LFG:
    """av_lfg exact transcription."""

    def __init__(self, seed: int):
        state = np.zeros(64, np.uint32)       # [0..7] stay zero
        tmp = bytearray(16)
        for i in range(8, 64, 4):
            tmp[0:4] = int(np.uint32(seed)).to_bytes(4, "little")
            tmp[4] = i
            tmp = bytearray(hashlib.md5(bytes(tmp)).digest())
            state[i] = int.from_bytes(tmp[0:4], "little")
            state[i + 1] = int.from_bytes(tmp[4:8], "little")
            state[i + 2] = int.from_bytes(tmp[8:12], "little")
            state[i + 3] = int.from_bytes(tmp[12:16], "little")
        self.state = state
        self.index = 0

    def get(self) -> int:
        s, i = self.state, self.index
        a = np.uint32((int(s[(i - 24) & 63]) + int(s[(i - 55) & 63]))
                      & 0xFFFFFFFF)
        s[i & 63] = a
        self.index = (i + 1) & 0xFFFFFFFF
        return int(a)

    def get_block(self, k: int) -> np.ndarray:
        """k draws, vectorized in lag-24 chunks."""
        out = np.empty(k, np.uint32)
        done = 0
        while done < k:
            step = min(24, k - done)
            for j in range(step):     # the 64-slot ring makes full
                out[done + j] = self.get()   # vectorization fiddly;
            done += step                     # 24-chunks keep it simple
        return out


def _rand_n(lfg: LFG, rng: int) -> int:
    return int(float(rng) * lfg.get() / 4294967296.0)   # UINT_MAX+1.0


def build_noise(strength: int, flags: int, seed: int, comp: int):
    """init_noise (vf_noise.c:70-131): returns (int8 table, LFG) with
    the LFG advanced past the prev_shift draws, ready for rand_shift."""
    lfg = LFG((seed + comp * 31415) & 0xFFFFFFFF)
    noise = np.zeros(MAX_NOISE, np.int8)
    j = 0
    for i in range(MAX_NOISE):
        if flags & NOISE_UNIFORM:
            # (AVERAGED is rejected before table construction)
            if flags & NOISE_PATTERN:
                t = _rand_n(lfg, strength) - _c_div(strength, 2)
                v = int(_c_div(t, 2)
                        + _PATT[j % 4] * strength * 0.25)
            else:
                v = _rand_n(lfg, strength) - _c_div(strength, 2)
        else:
            while True:
                x1 = 2.0 * lfg.get() / _UINT_MAX_F - 1.0
                x2 = 2.0 * lfg.get() / _UINT_MAX_F - 1.0
                w = x1 * x1 + x2 * x2
                if w < 1.0:
                    break
            w = math.sqrt((-2.0 * math.log(w)) / w)
            y1 = x1 * w
            y1 *= strength / math.sqrt(3.0)
            if flags & NOISE_PATTERN:
                y1 /= 2
                y1 += _PATT[j % 4] * strength * 0.35
            y1 = min(max(y1, -128.0), 127.0)
            if flags & NOISE_AVERAGED:
                y1 /= 3.0
            v = int(y1)                       # C trunc toward zero
        noise[i] = v
        if _rand_n(lfg, 6) == 0:
            j -= 1
        j += 1
    # prev_shift pointer draws (vf_noise.c:126-128) advance the LFG in
    # EVERY mode before the per-frame rand_shift draws
    lfg.get_block(MAX_RES * 3)
    return noise, lfg


def _c_div(a: int, b: int) -> int:
    """C integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def apply_noise_plane(plane: torch.Tensor, noise_tab,
                      shifts: np.ndarray) -> torch.Tensor:
    """plane (N, h, w) uint8; noise_tab the int32 table (numpy, or a
    tensor on the plane's device); shifts (N, MAX_RES) int32 rand_shift
    per frame.  dst = clip_u8(src + noise[shift[y & 4095] + (x % 4096)])."""
    from .lut import apply_lut
    n, h, w = plane.shape
    dev = plane.device
    ix = np.arange(h) & (MAX_RES - 1)
    row_shift = torch.as_tensor(np.ascontiguousarray(shifts[:, ix]),
                                dtype=torch.int32, device=dev)   # (N, h)
    xoff = torch.arange(w, dtype=torch.int32, device=dev) % MAX_RES
    idx = row_shift[:, :, None] + xoff[None, None, :]          # (N, h, w)
    nm = apply_lut(idx, noise_tab)
    out = torch.clamp(plane.to(torch.int32) + nm, 0, 255)
    return out.to(plane.dtype)
