"""yadif deinterlacing — counterpart of `gmat_tpu/ops/yadif.py`, the
rebuild of ffmpeg's yadif_cuda.

Reference math: ffmpeg-gpu/libavfilter/vf_yadif_cuda.cu
  * spatial_predictor (edge-directed interpolation, :21-49)
  * temporal_predictor (field-motion clamp, :63-94)
  * yadif_single frame loop + field selection (:96-164)
Frame/parity/pts semantics live in the stream filter
(filters/builtin.YadifFilter, yadif_common.c:27-157).

Every tap is a clamped-shift view of the batched plane (the tex2D clamp
addressing analog): each plane is edge-padded ONCE by the widest shift
(3 columns, 2 rows) and every tap is a slice of that padding, so no tap
allocates.  int32 math identical to the CUDA kernel (all divided sums
are non-negative, so floor division matches C's).  Runs eagerly on the
batch's device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.frame import same_bits

_PAD_Y, _PAD_X = 2, 3          # the widest row and column shifts


def _padded(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W) int32 -> edge-padded (N, H + 4, W + 6)."""
    n, h, w = x.shape
    rows = np.clip(np.arange(-_PAD_Y, h + _PAD_Y), 0, h - 1)
    cols = np.clip(np.arange(-_PAD_X, w + _PAD_X), 0, w - 1)
    dev = x.device
    return x.index_select(1, torch.as_tensor(rows, device=dev)).index_select(
        2, torch.as_tensor(cols, device=dev))


def _tap(xp: torch.Tensor, h: int, w: int, dy: int, dx: int):
    """out[..., y, x] = in[..., clamp(y+dy), clamp(x+dx)] from the padding."""
    return xp[:, _PAD_Y + dy:_PAD_Y + dy + h, _PAD_X + dx:_PAD_X + dx + w]


def yadif_plane(prev: torch.Tensor, cur: torch.Tensor, next_: torch.Tensor,
                parity: int, tff: int,
                skip_spatial_check: bool = False) -> torch.Tensor:
    """Deinterlace one batched plane: (N, H, W) int -> (N, H, W) same dtype.

    Lines with y % 2 == parity are the primary field (copied from cur);
    the other lines are predicted.  parity/tff follow the CUDA kernel
    args (the first output field uses parity = tff ^ 1, the second
    parity = tff)."""
    dt = cur.dtype
    n, h, w = cur.shape
    cur_i = cur.to(torch.int32)
    pc = _padded(cur_i)

    def S(dy, dx):
        return _tap(pc, h, w, dy, dx)

    # ---- spatial predictor: 7 taps above, 7 below (cu:120-137) ----
    a, b, c = S(-1, -3), S(-1, -2), S(-1, -1)
    d, e = S(-1, 0), S(-1, 1)
    f, g = S(-1, 2), S(-1, 3)
    h_, i_, j = S(1, -3), S(1, -2), S(1, -1)
    k, l = S(1, 0), S(1, 1)
    m, n_ = S(1, 2), S(1, 3)

    pred = (d + k) // 2
    score = torch.abs(c - j) + torch.abs(d - k) + torch.abs(e - l)
    s1 = torch.abs(b - k) + torch.abs(c - l) + torch.abs(d - m)
    c1 = s1 < score
    pred = torch.where(c1, (c + l) // 2, pred)
    score = torch.where(c1, s1, score)
    s2 = torch.abs(a - l) + torch.abs(b - m) + torch.abs(c - n_)
    c2 = c1 & (s2 < score)
    pred = torch.where(c2, (b + m) // 2, pred)
    score = torch.where(c2, s2, score)
    s3 = torch.abs(d - i_) + torch.abs(e - j) + torch.abs(f - k)
    c3 = s3 < score
    pred = torch.where(c3, (e + j) // 2, pred)
    score = torch.where(c3, s3, score)
    s4 = torch.abs(e - h_) + torch.abs(f - i_) + torch.abs(g - j)
    c4 = c3 & (s4 < score)
    pred = torch.where(c4, (f + i_) // 2, pred)
    del a, b, c, e, f, g, h_, i_, j, l, m, n_, score, s1, s2, s3, s4

    # ---- temporal predictor (cu:139-161) ----
    is_second = (parity ^ tff) == 0
    pp = _padded(prev.to(torch.int32))
    pn = _padded(next_.to(torch.int32))
    p2, n2 = pp, pn                     # prev2, next2
    p1 = pc if is_second else pp        # prev1
    n1 = pn if is_second else pc        # next1

    def T(xp, dy):
        return _tap(xp, h, w, dy, 0)

    A, B = T(p2, -1), T(p2, 1)
    F, G = d, k                         # cur at rows -1, +1
    D, I = T(p1, 0), T(n1, 0)
    p0 = (T(p1, -2) + T(n1, -2)) // 2
    p1v = F
    p2v = (D + I) // 2
    p3v = G
    p4 = (T(p1, 2) + T(n1, 2)) // 2
    tdiff0 = torch.abs(D - I)
    tdiff1 = (torch.abs(A - F) + torch.abs(B - G)) // 2
    tdiff2 = (torch.abs(T(n2, -1) - F) + torch.abs(G - T(n2, 1))) // 2
    diff = torch.maximum(torch.maximum(tdiff0, tdiff1), tdiff2)
    if not skip_spatial_check:
        maxi = torch.maximum(torch.maximum(p2v - p3v, p2v - p1v),
                             torch.minimum(p0 - p1v, p4 - p3v))
        mini = torch.minimum(torch.minimum(p2v - p3v, p2v - p1v),
                             torch.maximum(p0 - p1v, p4 - p3v))
        diff = torch.maximum(torch.maximum(diff, mini), -maxi)
    pred = torch.clamp(pred, p2v - diff, p2v + diff)

    rows = torch.arange(h, device=cur.device)[None, :, None]
    return torch.where(rows % 2 == parity, cur_i, pred).to(dt)


def deint_batch(ext_planes, tff: int, skip: bool, send_field: bool):
    """One pass over an extended frame sequence.

    ext_planes: plane dict of (M, ...) tensors where frame 0 is the
    previous context and frame M-1 the pending look-ahead; outputs are
    computed for frames 1..M-2 (each has both temporal neighbors).
    send_field=True (mode&1) interleaves both output fields -> 2*(M-2)
    frames, in yadif_common.c return_frame's order: first
    (parity=tff^1), then second (parity=tff)."""
    m = next(iter(ext_planes.values())).shape[0]
    prev = {k: v[: m - 2] for k, v in ext_planes.items()}
    cur = {k: v[1: m - 1] for k, v in ext_planes.items()}
    nxt = {k: v[2:] for k, v in ext_planes.items()}
    first = yadif_frames(prev, cur, nxt, tff ^ 1, tff, skip)
    if not send_field:
        return first
    second = yadif_frames(prev, cur, nxt, tff, tff, skip)
    return {k: interleave(a, second[k]) for k, a in first.items()}


def interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Frames a0, b0, a1, b1, ... (the two fields of each output frame)."""
    return same_bits(lambda x, y: torch.stack([x, y], dim=1), a, b).reshape(
        (a.shape[0] * 2,) + a.shape[1:])


def _fold(x: torch.Tensor) -> torch.Tensor:
    """Packed (N,H,W,C) -> (N*C, H, W): channels folded into the batch."""
    n, h, w, ch = x.shape
    return x.permute(0, 3, 1, 2).reshape(n * ch, h, w)


def _unfold(o: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    n, h, w, ch = like.shape
    return o.reshape(n, ch, h, w).permute(0, 2, 3, 1).contiguous()


def yadif_frames(prev_planes, cur_planes, next_planes, parity: int, tff: int,
                 skip_spatial_check: bool = False):
    """Apply yadif_plane to every plane dict entry (y/u/v or packed rgb)."""
    out = {}
    for name, cur in cur_planes.items():
        prev, next_ = prev_planes[name], next_planes[name]
        if cur.ndim == 4:   # packed (N,H,W,C): fold channels into batch
            o = yadif_plane(_fold(prev), _fold(cur), _fold(next_), parity,
                            tff, skip_spatial_check)
            out[name] = _unfold(o, cur)
        else:
            out[name] = yadif_plane(prev, cur, next_, parity, tff,
                                    skip_spatial_check)
    return out
