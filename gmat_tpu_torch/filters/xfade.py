"""vf_xfade.c analog: cross-fade between two video streams.

All 45 named transitions plus the `custom` expression transition are
transcribed from the reference kernels (vf_xfade.c:208-1745) in
vectorized float32 numpy: per-pixel float math in C float order, final
store via C's float->int truncation cast.  libm-backed terms (sinf in
frand, atan2f, powf/logf) use numpy's float32 libm — the same
libm-dependence the C itself has (cf. deband's offset hash).

The stream machine (xfade_activate, :1836-1911) is ported by
XfadeFilter in builtin.py; this module is the pure transition math:
``apply_transition(name, a, b, progress, ctx)`` over channel-first
float32 stacks.

ctx keys: w, h, maxv, black (P,), white (P,), is_rgb, nb_planes,
expr (custom only), frames (custom getpix sources).
"""
from __future__ import annotations

import numpy as np

F = np.float32


def _mix(a, b, m):
    """mix() (:249-252): a*m + b*(1-m), float32."""
    return (a * m + b * (F(1.0) - m)).astype(F)


def _fract(a):
    return (a - np.floor(a)).astype(F)


def _smoothstep(e0, e1, x):
    """smoothstep (:259-266), float32 with av_clipf."""
    t = np.clip((np.asarray(x, F) - F(e0)) / (F(e1) - F(e0)),
                F(0.0), F(1.0)).astype(F)
    return (t * t * (F(3.0) - F(2.0) * t)).astype(F)


def _grid(c):
    x = np.arange(c["w"], dtype=np.int64)
    y = np.arange(c["h"], dtype=np.int64)[:, None]
    return x, y


def _bgvec(c, key):
    return np.asarray(c[key], F)[:, None, None]


# ---- the 45 named transitions ------------------------------------------------

def _t_fade(a, b, p, c):
    return _mix(a, b, F(p))


def _t_wipeleft(a, b, p, c):
    z = int(F(c["w"]) * F(p))
    x, _ = _grid(c)
    return np.where(x > z, b, a)


def _t_wiperight(a, b, p, c):
    z = int(F(c["w"]) * (F(1.0) - F(p)))
    x, _ = _grid(c)
    return np.where(x > z, a, b)


def _t_wipeup(a, b, p, c):
    z = int(F(c["h"]) * F(p))
    _, y = _grid(c)
    return np.where(y > z, b, a)


def _t_wipedown(a, b, p, c):
    z = int(F(c["h"]) * (F(1.0) - F(p)))
    _, y = _grid(c)
    return np.where(y > z, a, b)


def _slide_idx(z, n):
    """zz = zx%n + n*(zx<0) with C trunc %; the zx==-n corner (progress
    exactly 1.0, x==0) would index one past the row in the C (reads
    linesize padding) — clipped to the last valid column here."""
    zx = z + np.arange(n, dtype=np.int64)
    zz = np.fmod(zx, n) + n * (zx < 0)
    zz = np.minimum(zz, n - 1)
    inside = (zx >= 0) & (zx < n)
    return zz, inside


def _t_slideleft(a, b, p, c):
    z = int(-F(p) * F(c["w"]))
    zz, inside = _slide_idx(z, c["w"])
    return np.where(inside, b[:, :, zz], a[:, :, zz])


def _t_slideright(a, b, p, c):
    z = int(F(p) * F(c["w"]))
    zz, inside = _slide_idx(z, c["w"])
    return np.where(inside, b[:, :, zz], a[:, :, zz])


def _t_slideup(a, b, p, c):
    z = int(-F(p) * F(c["h"]))
    zz, inside = _slide_idx(z, c["h"])
    return np.where(inside[None, :, None], b[:, zz, :], a[:, zz, :])


def _t_slidedown(a, b, p, c):
    z = int(F(p) * F(c["h"]))
    zz, inside = _slide_idx(z, c["h"])
    return np.where(inside[None, :, None], b[:, zz, :], a[:, zz, :])


def _t_circlecrop(a, b, p, c):
    w, h = c["w"], c["h"]
    z = np.power(F(2.0) * np.abs(F(p) - F(0.5)), F(3.0)) \
        * np.hypot(F(w // 2), F(h // 2))
    x, y = _grid(c)
    dist = np.hypot((x - w // 2).astype(F), (y - h // 2).astype(F))
    val = b if p < 0.5 else a
    return np.where(z < dist, _bgvec(c, "black"), val)


def _t_rectcrop(a, b, p, c):
    w, h = c["w"], c["h"]
    zh = int(np.abs(F(p) - F(0.5)) * F(h))
    zw = int(np.abs(F(p) - F(0.5)) * F(w))
    x, y = _grid(c)
    inside = (np.abs(x - w // 2) < zw) & (np.abs(y - h // 2) < zh)
    val = b if p < 0.5 else a
    return np.where(inside, val, _bgvec(c, "black"))


def _t_distance(a, b, p, c):
    mx = F(c["maxv"])
    d = ((a / mx - b / mx) ** 2).astype(F).sum(axis=0, dtype=F)
    dist = (np.sqrt(d.astype(F)).astype(F) <= F(p)).astype(F)
    return _mix(_mix(a, b, dist[None]), b, F(p))


def _fade_bg(a, b, p, bg0, bg1):
    phase = F(0.2)
    s1 = _smoothstep(F(1.0) - phase, 1.0, F(p))
    s2 = _smoothstep(phase, 1.0, F(p))
    return _mix(_mix(a, bg0, s1), _mix(bg1, b, s2), F(p))


def _t_fadeblack(a, b, p, c):
    bg = _bgvec(c, "black")
    return _fade_bg(a, b, p, bg, bg)


def _t_fadewhite(a, b, p, c):
    bg = _bgvec(c, "white")
    return _fade_bg(a, b, p, bg, bg)


def _t_radial(a, b, p, c):
    w, h = c["w"], c["h"]
    x, y = _grid(c)
    at = np.arctan2((x - w // 2).astype(F),
                    np.broadcast_to((y - h // 2), (h, w)).astype(F))
    # atan2f minus a double product, narrowed to float (:723)
    smooth = (at.astype(np.float64)
              - np.float64(F(p) - F(0.5)) * (np.pi * 2.5)).astype(F)
    return _mix(b, a, _smoothstep(0.0, 1.0, smooth))


def _smooth_sel(a, b, smooth):
    return _mix(b, a, _smoothstep(0.0, 1.0, smooth))


def _t_smoothleft(a, b, p, c):
    x, _ = _grid(c)
    w = F(c["w"])
    return _smooth_sel(a, b, F(1.0) + x.astype(F) / w - F(p) * F(2.0))


def _t_smoothright(a, b, p, c):
    x, _ = _grid(c)
    w = F(c["w"])
    return _smooth_sel(a, b,
                       F(1.0) + (c["w"] - 1 - x).astype(F) / w
                       - F(p) * F(2.0))


def _t_smoothup(a, b, p, c):
    _, y = _grid(c)
    h = F(c["h"])
    return _smooth_sel(a, b, F(1.0) + y.astype(F) / h - F(p) * F(2.0))


def _t_smoothdown(a, b, p, c):
    _, y = _grid(c)
    h = F(c["h"])
    return _smooth_sel(a, b,
                       F(1.0) + (c["h"] - 1 - y).astype(F) / h
                       - F(p) * F(2.0))


def _t_circleopen(a, b, p, c):
    w, h = c["w"], c["h"]
    z = np.hypot(F(w // 2), F(h // 2))
    pp = (F(p) - F(0.5)) * F(3.0)
    x, y = _grid(c)
    smooth = (np.hypot((x - w // 2).astype(F),
                       (y - h // 2).astype(F)) / z + pp).astype(F)
    return _mix(a, b, _smoothstep(0.0, 1.0, smooth))


def _t_circleclose(a, b, p, c):
    w, h = c["w"], c["h"]
    z = np.hypot(F(w // 2), F(h // 2))
    pp = (F(1.0) - F(p) - F(0.5)) * F(3.0)
    x, y = _grid(c)
    smooth = (np.hypot((x - w // 2).astype(F),
                       (y - h // 2).astype(F)) / z + pp).astype(F)
    return _mix(b, a, _smoothstep(0.0, 1.0, smooth))


def _t_vertopen(a, b, p, c):
    w2 = F(c["w"] // 2)                       # int division (:913)
    x, _ = _grid(c)
    smooth = F(2.0) - np.abs((x.astype(F) - w2) / w2) - F(p) * F(2.0)
    return _smooth_sel(a, b, smooth)


def _t_vertclose(a, b, p, c):
    w2 = F(c["w"] // 2)
    x, _ = _grid(c)
    smooth = F(1.0) + np.abs((x.astype(F) - w2) / w2) - F(p) * F(2.0)
    return _smooth_sel(a, b, smooth)


def _t_horzopen(a, b, p, c):
    h2 = F(c["h"] // 2)
    _, y = _grid(c)
    smooth = F(2.0) - np.abs((y.astype(F) - h2) / h2) - F(p) * F(2.0)
    return _smooth_sel(a, b, smooth)


def _t_horzclose(a, b, p, c):
    h2 = F(c["h"] // 2)
    _, y = _grid(c)
    smooth = F(1.0) + np.abs((y.astype(F) - h2) / h2) - F(p) * F(2.0)
    return _smooth_sel(a, b, smooth)


def _frand(x, y):
    """frand (:1017-1022), float32 sinf hash."""
    r = (np.sin((x.astype(F) * F(12.9898)
                 + y.astype(F) * F(78.233)).astype(F)).astype(F)
         * F(43758.545)).astype(F)
    return (r - np.floor(r)).astype(F)


def _t_dissolve(a, b, p, c):
    x, y = _grid(c)
    smooth = (_frand(np.broadcast_to(x, (c["h"], c["w"])),
                     np.broadcast_to(y, (c["h"], c["w"]))) * F(2.0)
              + F(p) * F(2.0) - F(1.5)).astype(F)
    return np.where(smooth >= F(0.5), a, b)


def _t_pixelize(a, b, p, c):
    w, h = c["w"], c["h"]
    d = min(F(p), F(1.0) - F(p))
    dist = np.ceil(d * F(50.0)).astype(F) / F(50.0)
    sq = (F(2.0) * dist * F(min(w, h))) / F(20.0)
    x, y = _grid(c)
    if dist > 0.0:
        sx = np.minimum((np.floor(x.astype(F) / sq) + F(0.5)) * sq,
                        F(w - 1)).astype(np.int64)
        sy = np.minimum((np.floor(y[:, 0].astype(F) / sq) + F(0.5)) * sq,
                        F(h - 1)).astype(np.int64)
    else:
        sx, sy = x, y[:, 0]
    asub = a[:, sy][:, :, sx]
    bsub = b[:, sy][:, :, sx]
    return _mix(asub, bsub, F(p))


def _diag(a, b, p, c, fx, fy):
    x, y = _grid(c)
    w, h = F(c["w"]), F(c["h"])
    # C groups left-to-right: ((x/w) * y) / h (:1090), NOT
    # (x/w)*(y/h) — a different float32 rounding
    t = ((fx(x, c).astype(F) / w).astype(F)
         * fy(y, c).astype(F)).astype(F)
    smooth = (F(1.0) + (t / h).astype(F) - F(p) * F(2.0)).astype(F)
    return _smooth_sel(a, b, smooth)


def _t_diagtl(a, b, p, c):
    return _diag(a, b, p, c, lambda x, c: x, lambda y, c: y)


def _t_diagtr(a, b, p, c):
    return _diag(a, b, p, c, lambda x, c: c["w"] - 1 - x,
                 lambda y, c: y)


def _t_diagbl(a, b, p, c):
    return _diag(a, b, p, c, lambda x, c: x,
                 lambda y, c: c["h"] - 1 - y)


def _t_diagbr(a, b, p, c):
    return _diag(a, b, p, c, lambda x, c: c["w"] - 1 - x,
                 lambda y, c: c["h"] - 1 - y)


def _slice_sel(a, b, coord, frc, p):
    smooth = _smoothstep(-0.5, 0.0, coord - F(p) * F(1.5))
    ss = np.where(smooth <= _fract(frc), F(0.0), F(1.0))
    return _mix(b, a, ss)


def _t_hlslice(a, b, p, c):
    # hlslice computes fract(10.f * x / w) = (10*x)/w (:1206) while
    # the smoothstep coord is the separate x/w — NOT fract(10*(x/w))
    x, _ = _grid(c)
    w = F(c["w"])
    coord = (x.astype(F) / w).astype(F)
    frc = ((F(10.0) * x.astype(F)).astype(F) / w).astype(F)
    return _slice_sel(a, b, coord, frc, p)


def _t_hrslice(a, b, p, c):
    x, _ = _grid(c)
    xx = ((c["w"] - 1 - x).astype(F) / F(c["w"])).astype(F)
    return _slice_sel(a, b, xx, (F(10.0) * xx).astype(F), p)


def _t_vuslice(a, b, p, c):
    _, y = _grid(c)
    h = F(c["h"])
    coord = (y.astype(F) / h).astype(F)
    frc = ((F(10.0) * y.astype(F)).astype(F) / h).astype(F)
    return _slice_sel(a, b, coord, frc, p)


def _t_vdslice(a, b, p, c):
    _, y = _grid(c)
    yy = ((c["h"] - 1 - y).astype(F) / F(c["h"])).astype(F)
    return _slice_sel(a, b, yy, (F(10.0) * yy).astype(F), p)


def _t_hblur(a, b, p, c):
    """hblur (:1317-1359): a per-row running box average whose float32
    accumulation order is preserved exactly (sequential adds along x,
    vectorized across rows/planes)."""
    w = c["w"]
    prog = F(p) * F(2.0) if p <= 0.5 else (F(1.0) - F(p)) * F(2.0)
    size = 1 + int(F(w // 2) * prog)
    out = np.empty_like(a)
    sum0 = np.zeros(a.shape[:2], F)
    sum1 = np.zeros(a.shape[:2], F)
    for x in range(size):                     # C's priming loop order
        sum0 = (sum0 + a[:, :, x]).astype(F)
        sum1 = (sum1 + b[:, :, x]).astype(F)
    cnt = F(size)
    for x in range(w):
        out[:, :, x] = _mix(sum0 / cnt, sum1 / cnt, F(p))
        if x + size < w:
            # C adds the exact integer difference in ONE float op
            # (:1345) — (sum+a2)-a1 rounds differently past 2^24
            sum0 = (sum0 + (a[:, :, x + size] - a[:, :, x])).astype(F)
            sum1 = (sum1 + (b[:, :, x + size] - b[:, :, x])).astype(F)
        else:
            sum0 = (sum0 - a[:, :, x]).astype(F)
            sum1 = (sum1 - b[:, :, x]).astype(F)
            cnt = cnt - F(1.0)
    return out


def _t_fadegrays(a, b, p, c):
    mid = (c["maxv"] + 1) // 2
    nb = c["nb_planes"]
    if c["is_rgb"]:
        g0 = (a[0].astype(np.int64) + a[1].astype(np.int64)
              + a[2].astype(np.int64)) // 3
        g1 = (b[0].astype(np.int64) + b[1].astype(np.int64)
              + b[2].astype(np.int64)) // 3
        bg0 = np.stack([g0, g0, g0][:nb] if nb < 4
                       else [g0, g0, g0, a[3].astype(np.int64)])
        bg1 = np.stack([g1, g1, g1][:nb] if nb < 4
                       else [g1, g1, g1, b[3].astype(np.int64)])
    else:
        m = np.full_like(a[0], mid, dtype=np.int64)
        l0 = [a[0].astype(np.int64), m, m]
        l1 = [b[0].astype(np.int64), m, m]
        if nb == 4:
            l0.append(a[3].astype(np.int64))
            l1.append(b[3].astype(np.int64))
        bg0 = np.stack(l0[:nb])
        bg1 = np.stack(l1[:nb])
    return _fade_bg(a.astype(F), b.astype(F), p,
                    bg0.astype(F), bg1.astype(F))


def _t_wipetl(a, b, p, c):
    zw = int(F(c["w"]) * F(p))
    zh = int(F(c["h"]) * F(p))
    x, y = _grid(c)
    return np.where((y <= zh) & (x <= zw), a, b)


def _t_wipetr(a, b, p, c):
    zw = int(F(c["w"]) * (F(1.0) - F(p)))
    zh = int(F(c["h"]) * F(p))
    x, y = _grid(c)
    return np.where((y <= zh) & (x > zw), a, b)


def _t_wipebl(a, b, p, c):
    zw = int(F(c["w"]) * F(p))
    zh = int(F(c["h"]) * (F(1.0) - F(p)))
    x, y = _grid(c)
    return np.where((y > zh) & (x <= zw), a, b)


def _t_wipebr(a, b, p, c):
    zw = int(F(c["w"]) * (F(1.0) - F(p)))
    zh = int(F(c["h"]) * (F(1.0) - F(p)))
    x, y = _grid(c)
    return np.where((y > zh) & (x > zw), a, b)


def _t_squeezeh(a, b, p, c):
    """squeezeh (:1546-1578).  progress==0 divides by zero: inf rows
    take B; the exact-center 0/0 NaN row is lrintf(NaN) UB in the C —
    the valid-mask routes it to B deterministically."""
    h = F(c["h"])
    yv = np.arange(c["h"], dtype=np.int64)
    with np.errstate(divide="ignore", invalid="ignore"):
        z = (F(0.5) + (yv.astype(F) / h - F(0.5)) / F(p)).astype(F)
    valid = (z >= F(0.0)) & (z <= F(1.0))
    yy = np.round(np.where(valid, z, 0) * (h - F(1.0))).astype(np.int64)
    return np.where(valid[None, :, None], a[:, yy, :], b)


def _t_squeezev(a, b, p, c):
    """squeezev (:1580-1612); NaN/inf handling as _t_squeezeh."""
    w = F(c["w"])
    xv = np.arange(c["w"], dtype=np.int64)
    with np.errstate(divide="ignore", invalid="ignore"):
        z = (F(0.5) + (xv.astype(F) / w - F(0.5)) / F(p)).astype(F)
    valid = (z >= F(0.0)) & (z <= F(1.0))
    xx = np.round(np.where(valid, z, 0) * (w - F(1.0))).astype(np.int64)
    return np.where(valid[None, None, :], a[:, :, xx], b)


def _t_zoomin(a, b, p, c):
    w, h = F(c["w"]), F(c["h"])
    zf = _smoothstep(0.5, 1.0, F(p))
    x, y = _grid(c)
    u = (F(0.5) + ((x.astype(F) / w).astype(F) - F(0.5)) * zf).astype(F)
    v = (F(0.5) + ((y[:, 0].astype(F) / h).astype(F) - F(0.5))
         * zf).astype(F)
    iu = np.ceil(u * (w - F(1.0))).astype(np.int64)
    iv = np.ceil(v * (h - F(1.0))).astype(np.int64)
    zv = a[:, iv][:, :, iu].astype(F)
    return _mix(zv, b, _smoothstep(0.0, 0.5, F(p)))


def _t_fadefast(a, b, p, c):
    imax = F(1.0) / F(c["maxv"])
    diff = np.abs(a.astype(np.int64) - b.astype(np.int64)).astype(F)
    e = (F(1.0) + np.log((F(1.0) + diff * imax).astype(F))
         .astype(F)).astype(F)
    return _mix(a, b, np.power(F(p), e).astype(F))


def _t_fadeslow(a, b, p, c):
    imax = F(1.0) / F(c["maxv"])
    diff = np.abs(a.astype(np.int64) - b.astype(np.int64)).astype(F)
    e = (F(1.0) + np.log(F(2.0) - diff * imax).astype(F)).astype(F)
    return _mix(a, b, np.power(F(p), e).astype(F))


def _t_custom(a, b, p, c):
    """custom (:208-245): per-pixel av_expr_eval with X/Y/W/H/A/B/
    PLANE/P vars and a0..a3/b0..b3 getpix functions (:1688-1745), the
    same per-pixel scalar evaluation cost as the C."""
    expr = c["expr"]
    w, h = c["w"], c["h"]
    nb = c["nb_planes"]
    out = np.empty_like(a, dtype=np.float64)
    env = {"W": float(w), "H": float(h), "P": float(p)}
    for pl in range(nb):
        env["PLANE"] = float(pl)
        ap = a[pl]
        bp = b[pl]
        for yy in range(h):
            env["Y"] = float(yy)
            for xx in range(w):
                env["X"] = float(xx)
                env["A"] = float(ap[yy, xx])
                env["B"] = float(bp[yy, xx])
                out[pl, yy, xx] = expr(env)
    return out


TRANSITIONS = {
    "fade": _t_fade, "wipeleft": _t_wipeleft, "wiperight": _t_wiperight,
    "wipeup": _t_wipeup, "wipedown": _t_wipedown,
    "slideleft": _t_slideleft, "slideright": _t_slideright,
    "slideup": _t_slideup, "slidedown": _t_slidedown,
    "circlecrop": _t_circlecrop, "rectcrop": _t_rectcrop,
    "distance": _t_distance, "fadeblack": _t_fadeblack,
    "fadewhite": _t_fadewhite, "radial": _t_radial,
    "smoothleft": _t_smoothleft, "smoothright": _t_smoothright,
    "smoothup": _t_smoothup, "smoothdown": _t_smoothdown,
    "circleopen": _t_circleopen, "circleclose": _t_circleclose,
    "vertopen": _t_vertopen, "vertclose": _t_vertclose,
    "horzopen": _t_horzopen, "horzclose": _t_horzclose,
    "dissolve": _t_dissolve, "pixelize": _t_pixelize,
    "diagtl": _t_diagtl, "diagtr": _t_diagtr, "diagbl": _t_diagbl,
    "diagbr": _t_diagbr, "hlslice": _t_hlslice, "hrslice": _t_hrslice,
    "vuslice": _t_vuslice, "vdslice": _t_vdslice, "hblur": _t_hblur,
    "fadegrays": _t_fadegrays, "wipetl": _t_wipetl,
    "wipetr": _t_wipetr, "wipebl": _t_wipebl, "wipebr": _t_wipebr,
    "squeezeh": _t_squeezeh, "squeezev": _t_squeezev,
    "zoomin": _t_zoomin, "fadefast": _t_fadefast,
    "fadeslow": _t_fadeslow, "custom": _t_custom,
}


def apply_transition(name, a, b, progress, ctx):
    """Blend channel-first integer stacks a/b ((P,H,W), same dtype)
    at `progress` (1->0 over the transition); returns the C's
    float->int truncating store."""
    dt = a.dtype
    fa = a.astype(F)
    fb = b.astype(F)
    # integer-domain transitions index the raw arrays; float math uses
    # the f32 casts — pass raw ints where the C reads ints
    fn = TRANSITIONS[name]
    if name in ("fadefast", "fadeslow", "fadegrays"):
        res = fn(a, b, progress, ctx)
    elif name in ("wipeleft", "wiperight", "wipeup", "wipedown",
                  "wipetl", "wipetr", "wipebl", "wipebr", "slideleft",
                  "slideright", "slideup", "slidedown", "circlecrop",
                  "rectcrop", "dissolve", "squeezeh", "squeezev",
                  "custom"):
        res = fn(a, b, progress, ctx)        # pure selection / custom
    else:
        res = fn(fa, fb, progress, ctx)
    return np.trunc(np.asarray(res, np.float64)).astype(dt) \
        if np.issubdtype(np.asarray(res).dtype, np.floating) \
        else np.asarray(res).astype(dt)
