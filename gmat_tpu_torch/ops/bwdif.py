"""bwdif deinterlacing — counterpart of `gmat_tpu/ops/bwdif.py`, the
rebuild of ffmpeg's vf_bwdif.

Reference math: ffmpeg-gpu/libavfilter/vf_bwdif.c
  * Weston 3-field coefficients coef_lf/coef_hf/coef_sp (:47-49)
  * FILTER_INTRA (:60-67), FILTER1 (:69-80), SPAT_CHECK (:82-89),
    FILTER_LINE (:91-100), FILTER_EDGE (:102-106), FILTER2 (:108-121)
  * per-row dispatch + boundary mirrors in filter_slice (:215-258):
    rows y<4 or y+5>h use filter_edge (spatial check only when
    !(y<2 || y+3>h)); the row-mirror rules for prefs/mrefs/prefs3/mrefs3
    are row gathers through per-height index maps.
Frame/parity/pts state machine: shared with yadif
(filters/builtin.BwdifFilter), including the FIELD_END rule that the
very first output field and (send_field mode) the final flushed second
field are spatial-only filter_intra frames.

Every tap is a row gather (an index map built once per height, sample
width and device) or a clamped row shift; all three row classes
(line/edge/intra) are computed over the whole plane and selected by a
row mask.  int32 math; C's arithmetic >> on possibly-negative
accumulators is torch's >> on int32.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..core.frame import same_bits
from .yadif import _fold, _unfold, interleave

# BBC PH-2071 (Weston 3-field) coefficients, vf_bwdif.c:47-49
COEF_LF = (4309, 213)
COEF_HF = (5570, 3801, 1016)
COEF_SP = (5077, 981)


@lru_cache(maxsize=64)
def _row_maps(h: int, df: int, device: str):
    """Row index maps of one plane height, as index tensors on `device`.

    The C's mirror guards are in BYTES (df = bytes/sample, filter_slice
    :223), so 16-bit planes mirror one row early at both borders:
      prefs  = y+1 if y+df  < h   else y-1
      mrefs  = y-1 if y > df-1    else y+1
      prefs3 = y+3 if y+3df < h   else y-1   (falls back ONE row up)
      mrefs3 = y-3 if y > 3df-1   else y+1   (ONE row down)
    plus clamped shifts by ±2/±3/±4 and the row-class masks."""
    r = np.arange(h)

    def t(a):
        return torch.as_tensor(a, device=device)

    maps = {"ip1": np.where(r + df < h, r + 1, r - 1),
            "im1": np.where(r > df - 1, r - 1, r + 1),
            "ip3": np.where(r + 3 * df < h, r + 3, r - 1),
            "im3": np.where(r > 3 * df - 1, r - 3, r + 1)}
    # planes too short for the mirrors (16-bit under 7 rows, 8-bit under
    # 4) index outside the plane, where the C reads out of bounds; the
    # JAX op's gather wraps a negative row and fills a row past the end
    # with INT32_MIN, and so do these maps: row h is a fill row (_rows)
    for k, v in maps.items():
        v = np.where(v < 0, v + h, v)
        maps[k] = np.where((v < 0) | (v >= h), h, v)
    for dy in (-4, -3, -2, 2, 3, 4):
        maps[dy] = np.clip(r + dy, 0, h - 1)
    out = {k: t(v) for k, v in maps.items()}
    out["fill"] = any(bool((v >= h).any()) for v in maps.values())
    out["edge"] = t((r < 4) | (r + 5 > h))[None, :, None]
    out["spat"] = t(~((r < 2) | (r + 3 > h)))[None, :, None]
    out["parity"] = t(r % 2)[None, :, None]
    return out


def _maps(x: torch.Tensor, dtype: torch.dtype):
    return _row_maps(x.shape[1], 2 if dtype == torch.uint16 else 1,
                     str(x.device))


def _rows(x: torch.Tensor, mp: dict, key) -> torch.Tensor:
    """Rows of map `key` of an int32 (N, H, W) plane; on planes whose
    maps reach row H, that row is a fill row of INT32_MIN (_row_maps)."""
    if mp["fill"]:
        fill = torch.full_like(x[:, :1], -(1 << 31))
        x = torch.cat([x, fill], dim=1)
    return x.index_select(1, mp[key])


def bwdif_intra_plane(cur: torch.Tensor, parity: int) -> torch.Tensor:
    """filter_intra over a whole plane: spatial-only Weston interpolation
    for every predicted row (vf_bwdif.c:60-67 with the filter_slice
    mirror rules :235-239).  Rows with y%2 == parity are copied."""
    dt = cur.dtype
    clip_max = 65535 if dt == torch.uint16 else 255
    c = cur.to(torch.int32)
    mp = _maps(c, dt)
    interpol = (COEF_SP[0] * (_rows(c, mp, "im1") + _rows(c, mp, "ip1"))
                - COEF_SP[1] * (_rows(c, mp, "im3") + _rows(c, mp, "ip3"))
                ) >> 13
    interpol = torch.clamp(interpol, 0, clip_max)
    return torch.where(mp["parity"] == parity, c, interpol).to(dt)


def bwdif_plane(prev: torch.Tensor, cur: torch.Tensor, next_: torch.Tensor,
                parity: int, tff: int) -> torch.Tensor:
    """One batched plane (N, H, W): filter_line on interior rows,
    filter_edge on y<4 / y+5>h with the C's spat gating, FILTER2 clamp.
    Rows with y%2 == parity are copied from cur."""
    dt = cur.dtype
    clip_max = 65535 if dt == torch.uint16 else 255
    p = prev.to(torch.int32)
    cc = cur.to(torch.int32)
    nx = next_.to(torch.int32)
    mp = _maps(cc, dt)

    # prev2/next2 selection (filter_line_c:146-147): the kernel-arg
    # parity is td->parity ^ td->tff
    kparity = parity ^ tff
    prev2 = p if kparity else cc
    next2 = cc if kparity else nx

    # prefs/mrefs mirror at the frame border; ±2/±3/±4 taps are only
    # read by row classes whose ranges keep them in bounds, so plain
    # clamped shifts are exact there
    c_ = _rows(cc, mp, "im1")
    e_ = _rows(cc, mp, "ip1")
    d_ = (prev2 + next2) >> 1
    td0 = torch.abs(prev2 - next2)
    td1 = (torch.abs(_rows(p, mp, "im1") - c_)
           + torch.abs(_rows(p, mp, "ip1") - e_)) >> 1
    td2 = (torch.abs(_rows(nx, mp, "im1") - c_)
           + torch.abs(_rows(nx, mp, "ip1") - e_)) >> 1
    diff0 = torch.maximum(torch.maximum(td0 >> 1, td1), td2)

    # SPAT_CHECK (:82-89) — ±2 taps, in bounds wherever spat applies
    p2m, p2p = _rows(prev2, mp, -2), _rows(prev2, mp, 2)
    n2m, n2p = _rows(next2, mp, -2), _rows(next2, mp, 2)
    b_ = ((p2m + n2m) >> 1) - c_
    f_ = ((p2p + n2p) >> 1) - e_
    dc = d_ - c_
    de = d_ - e_
    mx = torch.maximum(torch.maximum(de, dc), torch.minimum(b_, f_))
    mn = torch.minimum(torch.minimum(de, dc), torch.maximum(b_, f_))
    diff_spat = torch.maximum(torch.maximum(diff0, mn), -mx)
    del b_, f_, dc, de, mx, mn

    # FILTER_LINE (:91-100) — interior rows only, ±3/±4 in bounds
    c3 = _rows(cc, mp, -3) + _rows(cc, mp, 3)
    hf = ((COEF_HF[0] * (prev2 + next2)
           - COEF_HF[1] * (p2m + n2m + p2p + n2p)
           + COEF_HF[2] * (_rows(prev2, mp, -4) + _rows(next2, mp, -4)
                           + _rows(prev2, mp, 4) + _rows(next2, mp, 4))) >> 2)
    interpol_hf = (hf + COEF_LF[0] * (c_ + e_) - COEF_LF[1] * c3) >> 13
    interpol_sp = (COEF_SP[0] * (c_ + e_) - COEF_SP[1] * c3) >> 13
    interpol_line = torch.where(torch.abs(c_ - e_) > td0,
                                interpol_hf, interpol_sp)
    interpol_edge = (c_ + e_) >> 1
    del hf, interpol_hf, interpol_sp, c3, p2m, p2p, n2m, n2p

    interpol = torch.where(mp["edge"], interpol_edge, interpol_line)
    diff = torch.where(mp["spat"], diff_spat, diff0)

    # FILTER2 (:108-121): clamp into [d-diff, d+diff], saturate
    interpol = torch.clamp(interpol, d_ - diff, d_ + diff)
    interpol = torch.clamp(interpol, 0, clip_max)
    pred = torch.where(diff0 == 0, d_, interpol)
    return torch.where(mp["parity"] == parity, cc, pred).to(dt)


def _apply_frames(fn, plane_dicts, parity, tff):
    """Apply a plane kernel to every plane entry, folding packed (N,H,W,C)
    channels into the batch dim like ops/yadif.yadif_frames."""
    out = {}
    for name in plane_dicts[0]:
        args = [d[name] for d in plane_dicts]
        cur = args[min(1, len(args) - 1)]
        if cur.ndim == 4:
            o = fn(*[_fold(a) for a in args], parity, tff)
            out[name] = _unfold(o, cur)
        else:
            out[name] = fn(*args, parity, tff)
    return out


def _intra_frames(cur_planes, parity):
    return _apply_frames(lambda c, par, _tff: bwdif_intra_plane(c, par),
                         [cur_planes], parity, 0)


def _line_frames(prev_planes, cur_planes, next_planes, parity, tff):
    return _apply_frames(bwdif_plane,
                         [prev_planes, cur_planes, next_planes], parity, tff)


def bwdif_batch(ext_planes, tff: int, send_field: bool,
                intra_first: int = -1, intra_last: int = -1):
    """One pass over an extended frame sequence (same layout as
    ops/yadif.deint_batch): frame 0 is previous context, frame M-1 the
    look-ahead; outputs cover frames 1..M-2.

    intra_first >= 0: that OUTPUT index's FIRST field is spatial-only
    (FIELD_END when cur is the cloned first frame; with deint=interlaced
    it lands on the first frame actually FILTERED, hence an index).
    intra_last >= 0: EOF flush in send_field mode — that OUTPUT index's
    SECOND field is spatial-only (BACK_END -> END promotion)."""
    m = next(iter(ext_planes.values())).shape[0]
    prev = {k: v[: m - 2] for k, v in ext_planes.items()}
    cur = {k: v[1: m - 1] for k, v in ext_planes.items()}
    nxt = {k: v[2:] for k, v in ext_planes.items()}
    first = _line_frames(prev, cur, nxt, tff ^ 1, tff)
    if intra_first >= 0:
        j = intra_first
        head = {k: v[1 + j: 2 + j] for k, v in ext_planes.items()}
        ih = _intra_frames(head, tff ^ 1)
        first = {k: same_bits(lambda *p: torch.cat(p), v[:j], ih[k],
                              v[j + 1:]) for k, v in first.items()}
    if not send_field:
        return first
    second = _line_frames(prev, cur, nxt, tff, tff)
    if intra_last >= 0:
        tgt = {k: v[intra_last + 1: intra_last + 2]
               for k, v in ext_planes.items()}
        it = _intra_frames(tgt, tff)
        second = {k: same_bits(lambda *p: torch.cat(p), v[:intra_last],
                               it[k], v[intra_last + 1:])
                  for k, v in second.items()}
    return {k: interleave(a, second[k]) for k, a in first.items()}
