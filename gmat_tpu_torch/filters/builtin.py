"""Built-in filters — counterpart of `gmat_tpu/filters/builtin.py`.

The filters of the reference's GPU layer (doc/FFMPEG-GPU_User_Guide.md:
16-26), their aliases and the per-frame filters of upstream ffmpeg that
GMAT pipelines use, with the JAX package's names, options, defaults and
errors:

  crop / rotate / flip (+hflip/vflip) / smooth   <- *_nvcv filters
  transpose (+transpose_npp), scale (+scale_cuda/scale_npp), pad
  format (+format_cuda), null/copy/hwupload/hwdownload, chromakey
  eq / lut / lutyuv / lutrgb / unsharp
  lut3d / lut1d / colorchannelmixer / colorbalance / curves / exposure /
  colortemperature / monochrome / negate / swapuv / extractplanes
  (+alphaextract) / drawbox / boxblur / gblur / sharpen_npp / delogo
  hue / hqdn3d / deband / noise / vignette      <- stateful per-frame
  yadif (+yadif_cuda) / bwdif                   <- stream filters
  select (+select_cuda/select_gpu) / fps / trim <- keep-mask filters
  setpts / thumbnail (+thumbnail_cuda)          <- stream filters
  tonemap / zscale                              <- filters/hdr.py

Each filter is a factory: FILTERS[name](**options) -> callable.  Pure
filters map FrameBatch -> FrameBatch on the batch's device; keep-mask
filters (`batch_control`) and stream filters (`stream_filter`) keep the
JAX package's host logic and are run by filters/graph.FilterGraph.
Host tables (LUTs, masks, index maps) are built once and kept on the
batch's device.

Every other JAX filter name is in FILTERS too: its factory raises
NotImplementedError naming the ROADMAP.md item that ports it.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch

from ..core import formats as F
from ..core.frame import FrameBatch, same_bits, set_channels
from ..ops import (blur, csc, deband, enhance, geometry, hqdn3d, noise,
                   resize, smooth, vignette)
from ..ops.lut import apply_lut
from . import lut3d as _l3
from .expr import compile_expr, _pow as _c_pow


class FilterError(ValueError):
    pass


def _f_crop(w=0, h=0, x=-1, y=-1):
    w, h, x, y = int(w), int(h), int(x), int(y)
    if w <= 0 or h <= 0:
        raise FilterError("crop requires w>0 and h>0 (crop=w=W:h=H[:x=X:y=Y])")
    return lambda fb: geometry.crop(fb, w, h, x, y)


def _f_rotate(angle=0.0, interp="linear", shift_x=0.0, shift_y=0.0,
              center=0):
    angle, shift_x, shift_y = float(angle), float(shift_x), float(shift_y)
    return lambda fb: geometry.rotate(fb, angle, interp, shift_x, shift_y,
                                      center=bool(int(center)))


def _f_pad(w="0", h="0", x="0", y="0", color="black"):
    """vf_pad analog.  w/h/x/y accept av_expr with the vf_pad variable
    set: iw/ih (+in_w/in_h), ow/oh (+out_w/out_h), a (iw/ih aspect),
    sar/dar (square pixels: sar=1, dar=a), hsub/vsub, and x/y
    cross-references — x is evaluated, then y (with x bound), then x
    again (with y bound), mirroring vf_pad.c:159-174.  Out-of-range x/y
    center the frame; all four round down to the chroma grid."""
    def run(fb):
        sw = max((p.sub_w for p in fb.fmt.planes), default=0)
        sh = max((p.sub_h for p in fb.fmt.planes), default=0)
        aspect = float(fb.width) / float(fb.height)
        env = {"iw": float(fb.width), "ih": float(fb.height),
               "in_w": float(fb.width), "in_h": float(fb.height),
               "a": aspect, "sar": 1.0, "dar": aspect,
               "hsub": float(1 << sw), "vsub": float(1 << sh)}
        # w, then h (w bound), then w again (h bound) — vf_pad.c:128-148
        env.update(ow=0.0, oh=0.0, out_w=0.0, out_h=0.0)
        ow = int(compile_expr(str(w))(env))
        env.update(ow=float(ow), out_w=float(ow))
        oh = int(compile_expr(str(h))(env)) or fb.height
        env.update(oh=float(oh), out_h=float(oh))
        ow = int(compile_expr(str(w))(env)) or fb.width
        env.update(ow=float(ow), out_w=float(ow), x=0.0, y=0.0)
        px = int(compile_expr(str(x))(env))
        env["x"] = float(px)
        py = int(compile_expr(str(y))(env))
        env["y"] = float(py)
        px = int(compile_expr(str(x))(env))   # x may reference y
        return geometry.pad(fb, ow, oh, px, py, color)
    return run


def _f_eq(contrast=1.0, brightness=0.0, saturation=1.0, gamma=1.0,
          gamma_r=1.0, gamma_g=1.0, gamma_b=1.0, gamma_weight=1.0):
    args = tuple(float(v) for v in (contrast, brightness, saturation,
                                    gamma, gamma_r, gamma_g, gamma_b,
                                    gamma_weight))
    return lambda fb: enhance.eq(fb, *args)


# ---- lut / lutyuv / lutrgb (vf_lut.c) --------------------------------------

# AVOption alias storage (vf_lut.c:87-100): c0..c3 share offsets with
# y/u/v and r/g/b/a — whichever option appears LAST in the filter
# string wins, regardless of the filter's family.
_LUT_SLOTS = {"c0": 0, "c1": 1, "c2": 2, "c3": 3,
              "y": 0, "u": 1, "v": 2,
              "r": 0, "g": 1, "b": 2, "a": 3}

_LUT_FUNCS = {
    # vf_lut.c:159-196 funcs1: evaluate against the CURRENT table entry's
    # clipval/minval/maxval (carried in env).  pow is C-semantics _pow.
    "gammaval": (1, 1, lambda env, g:
                 _c_pow((env["clipval"] - env["minval"])
                        / (env["maxval"] - env["minval"]), g)
                 * (env["maxval"] - env["minval"]) + env["minval"]),
    "gammaval709": (1, 1, lambda env, g: _gammaval709(env, g)),
}


def _gammaval709(env, g):
    # vf_lut.c:184-196 — Rec.709 OETF with the filter's min/max range
    mn, mx = env["minval"], env["maxval"]
    level = (env["clipval"] - mn) / (mx - mn)
    level = (4.5 * level if level < 0.018
             else 1.099 * _c_pow(level, 1.0 / g) - 0.099)
    return level * (mx - mn) + mn


_LUT_CACHE: Dict = {}


def _lut_table(expr_text, w, h, mn, mx, clip_max, size, dtype):
    """One component table, vf_lut.c config_props val loop (306-334):
    env vars w/h/val/maxval/minval/negval/clipval, nan result is a hard
    error, result is C-int-truncated then clipped to [0, clip_max]."""
    key = (expr_text, w, h, mn, mx, clip_max, size, dtype)
    hit = _LUT_CACHE.get(key)
    if hit is not None:
        return hit
    e = compile_expr(expr_text, funcs=_LUT_FUNCS)
    out = np.empty(size, dtype)
    env = {"w": float(w), "h": float(h),
           "minval": float(mn), "maxval": float(mx)}
    for val in range(size):
        env["val"] = float(val)
        env["clipval"] = float(min(max(val, mn), mx))
        env["negval"] = float(min(max(mn + mx - val, mn), mx))
        res = e(env)
        if math.isnan(res):
            raise FilterError(f"lut: expression {expr_text!r} evaluates "
                              f"to nan at val={val}")
        # C (int)res: cvttsd2si yields INT_MIN for +/-inf AND any value
        # outside int32 range, so av_clip(...) lands on 0
        if math.isinf(res) or not -2.0**31 <= res < 2.0**31:
            iv = -(1 << 31)
        else:
            iv = int(res)
        out[val] = min(max(iv, 0), clip_max)
    if len(_LUT_CACHE) > 64:
        _LUT_CACHE.clear()
    _LUT_CACHE[key] = out
    return out


def _make_lut_filter(family):
    def build(**kw):
        slots = ["clipval"] * 4         # vf_lut default expression
        for k, v in kw.items():         # kwargs keep source order
            if k not in _LUT_SLOTS:
                raise FilterError(f"lut: unknown option {k!r}")
            slots[_LUT_SLOTS[k]] = str(v)

        def run(fb):
            fmt = fb.fmt
            if fmt.is_float:
                raise FilterError("lut operates on integer formats "
                                  "(vf_lut.c format lists); convert first")
            if fmt.name in ("p010", "p016"):
                raise FilterError("lut: p010/p016 store samples shifted; "
                                  "convert to yuv420p10/16 first")
            depth = fmt.bits
            if fmt.is_rgb:
                if family == "yuv":
                    raise FilterError("lutyuv requires a YUV format")
                order = fmt.channel_order
                dt = fmt.planes[0].dtype
                size = 1 << (np.dtype(dt).itemsize * 8)
                mx = 65535 if depth == 16 else 255   # vf_lut.c:273-281
                color_slot = {"r": 0, "g": 1, "b": 2, "a": 3}
                tab = np.empty((len(order), size), dt)
                for ci, ch in enumerate(order):
                    tab[ci] = _lut_table(slots[color_slot[ch]], fb.width,
                                         fb.height, 0, mx, mx, size, dt)
                return enhance.apply_luts(fb, {"rgb": tab})
            gray = len(fmt.planes) == 1
            if family == "rgb":
                raise FilterError("lutrgb requires an RGB format")
            if family == "yuv" and gray:
                raise FilterError("lutyuv requires chroma planes "
                                  "(vf_lut.c yuv_pix_fmts)")
            sc = 1 << (depth - 8)
            luts = {}
            for p in fmt.planes:
                dt = p.dtype
                size = 1 << (np.dtype(dt).itemsize * 8)
                if gray:                 # vf_lut.c default: full range
                    mn, mx, cmax = 0, 255 * sc, 255 * sc
                    slot = 0
                elif p.name == "y":      # limited range, vf_lut.c:264-272
                    mn, mx, cmax = 16 * sc, 235 * sc, (1 << depth) - 1
                    slot = 0
                else:                    # u / v
                    mn, mx, cmax = 16 * sc, 240 * sc, (1 << depth) - 1
                    slot = 1 if p.name == "u" else 2
                luts[p.name] = _lut_table(slots[slot], fb.width, fb.height,
                                          mn, mx, cmax, size, dt)
            return enhance.apply_luts(fb, luts)
        return run
    return build


def _f_unsharp(luma_msize_x=5, lx=None, luma_msize_y=5, ly=None,
               luma_amount=1.0, la=None, chroma_msize_x=5, cx=None,
               chroma_msize_y=5, cy=None, chroma_amount=0.0, ca=None):
    """vf_unsharp builder with the AVOption short aliases."""
    args = (int(lx if lx is not None else luma_msize_x),
            int(ly if ly is not None else luma_msize_y),
            float(la if la is not None else luma_amount),
            int(cx if cx is not None else chroma_msize_x),
            int(cy if cy is not None else chroma_msize_y),
            float(ca if ca is not None else chroma_amount))
    return lambda fb: enhance.unsharp(fb, *args)


def _f_flip(code=0):
    return lambda fb: geometry.flip(fb, int(code))


def _f_hflip():
    return lambda fb: geometry.flip(fb, 1)


def _f_vflip():
    return lambda fb: geometry.flip(fb, 0)


def _f_transpose(dir=0, passthrough="none", _npp=False):
    """ffmpeg transpose / transpose_npp: 0=cclock_flip (plain transpose),
    1=clock, 2=cclock, 3=clock_flip (anti-diagonal).  Swaps W and H.

    Named dir constants and the passthrough option follow
    vf_transpose_npp.c:428-439: ``passthrough=landscape`` leaves frames
    with w>=h untouched, ``portrait`` leaves w<=h untouched.  The
    transpose_npp alias also enforces the reference's supported formats
    (yuv420p/yuv444p, vf_transpose_npp.c:37-40)."""
    names = {"cclock_flip": 0, "clock": 1, "cclock": 2, "clock_flip": 3}
    d = names.get(str(dir), dir)
    try:
        d = int(d)
    except (TypeError, ValueError):
        raise FilterError(f"transpose: bad dir '{dir}'") from None
    if d not in (0, 1, 2, 3):
        raise FilterError("transpose dir must be 0..3")
    pt_modes = {"none": 0, "0": 0, "landscape": 1, "1": 1,
                "portrait": 2, "2": 2}
    pt = pt_modes.get(str(passthrough))
    if pt is None:
        raise FilterError(f"transpose: bad passthrough '{passthrough}'")
    # flips after the axis swap: clock reverses columns, cclock rows,
    # clock_flip both
    flips = {0: (), 1: (2,), 2: (1,), 3: (1, 2)}[d]

    def run(fb):
        if (pt == 1 and fb.width >= fb.height) or \
           (pt == 2 and fb.width <= fb.height):
            # the reference's passthrough short-circuits BEFORE the
            # format gate
            return fb
        if _npp and fb.format not in ("yuv420p", "yuv444p"):
            raise FilterError("transpose_npp supports yuv420p/yuv444p only "
                              "(vf_transpose_npp.c:37-40 supported_formats)")
        if fb.format == "yuv422p":
            # transposing horizontal-only chroma yields 4:4:0, a layout
            # we don't carry
            raise FilterError("transpose on yuv422p is unsupported; "
                              "insert format=yuv444p (or yuv420p) first")
        # every FrameBatch layout keeps H, W at axes 1, 2 (packed RGB is
        # NHWC), so one swap covers all formats but 4:2:2
        planes = {}
        for name, arr in fb.planes.items():
            t = arr.transpose(1, 2)
            if flips:
                t = geometry.flip_tensor(t, flips)
            planes[name] = t.contiguous()
        return fb.with_planes(planes, width=fb.height, height=fb.width)
    return run


def _f_smooth(type="gaussian", kw=3, kh=3, border_type="constant",
              sigmaX=0.0, sigmaY=0.0):
    kw, kh = int(kw), int(kh)
    if kw <= 0 or kh <= 0 or kw % 2 == 0 or kh % 2 == 0:
        # OpenCV/CV-CUDA reject even/non-positive kernels too
        raise FilterError(f"smooth kernel must be odd and positive, "
                          f"got {kw}x{kh}")
    borders = {"0": "constant", "1": "replicate", "2": "reflect",
               "3": "wrap", "4": "reflect101"}
    border = borders.get(str(border_type), str(border_type))
    return lambda fb: smooth.smooth(fb, type, kw, kh, border,
                                    float(sigmaX), float(sigmaY))


def _f_scale(w=0, h=0, interp="bilinear", antialias=0):
    """scale=W:H with ffmpeg's aspect-preserving placeholders: -1 keeps
    the source aspect ratio, -2 keeps it rounded to even (what the 4:2:0
    encoders need)."""
    w, h = int(w), int(h)
    if w == 0 or h == 0 or (w < 0 and h < 0):
        raise FilterError("scale requires W:H (one may be -1/-2 to "
                          "preserve aspect)")
    interp_map = {"bilinear": "bilinear", "linear": "bilinear",
                  "bicubic": "bicubic", "cubic": "bicubic", "area": "area",
                  "nearest": "nearest", "point": "nearest",
                  "lanczos": "lanczos3"}
    m = interp_map.get(interp)
    if m is None:
        raise FilterError(f"unknown scale interp {interp!r}")

    def dims(fb):
        ww, hh = w, h
        if ww < 0:
            ww = max(round(hh * fb.width / fb.height), 1)
            # ffmpeg: -n means proportional AND divisible by n
            div = max(-w, 2 if fb.fmt.is_yuv else 1)
            ww = max(round(ww / div), 1) * div
        elif hh < 0:
            hh = max(round(ww * fb.height / fb.width), 1)
            div = max(-h, 2 if fb.fmt.is_yuv else 1)
            hh = max(round(hh / div), 1) * div
        return ww, hh

    def run(fb):
        ww, hh = dims(fb)
        return resize.resize(fb, ww, hh, m, antialias=bool(int(antialias)))
    return run


def _f_format(pix_fmt="rgbpf32", norm=0.0, shift=0.0):
    # format_cuda option `pix_fmt` (vf_format_cuda.c:69-72); norm/shift for
    # the nv12_to_rgbpf32_shift variant (format_cuda_kernel.cu:591-607)
    name_map = {"rgbpf32le": "rgbpf32", "rgbapf32le": "rgbapf32",
                "bgrpf32le": "bgrpf32",
                # ffmpeg's planar float RGB names map onto the packed
                # float layout — same samples, one plane
                "gbrpf32": "rgbpf32", "gbrpf32le": "rgbpf32",
                "gbrapf32": "rgbapf32", "gbrapf32le": "rgbapf32"}
    fmt = name_map.get(pix_fmt, pix_fmt)
    target = F.get(fmt)
    kw = {}
    if float(norm) or float(shift):
        if not target.is_rgb:
            raise FilterError(
                "format norm/shift apply to float-RGB targets only "
                "(the nv12_to_rgbpf32_shift variant)")
        if float(norm):
            kw["norm"] = float(norm)
        kw["shift"] = (float(shift),) * 3
    return lambda fb: csc.convert(fb, fmt, **kw)


def _f_null():
    return lambda fb: fb


def _parse_color(color: str):
    """One shared av_parse_color subset for every filter: delegates to
    ops.geometry.parse_color, so pad and chromakey accept identical
    color syntax."""
    try:
        return np.array(geometry.parse_color(color), np.float32)
    except ValueError as e:
        raise FilterError(str(e)) from None


def _f_chromakey(color="00FF00", similarity=0.01, blend=0.0):
    """RGBA output with alpha keyed on CHROMA (U/V) distance like the
    reference (vf_chromakey_cuda: diff = sqrt((du^2+dv^2)/(2*255^2)),
    default similarity 0.01) — luma variations of the keyed color stay
    keyed, unlike an RGB-distance key."""
    key_rgb = _parse_color(str(color))
    # key color -> U/V via the bt601 matrix (ffmpeg RGB_TO_U/V macros)
    from ..core.color import rgb2yuv_matrix
    m = rgb2yuv_matrix("bt601")
    key_u = float(m[1] @ key_rgb + 128.0)
    key_v = float(m[2] @ key_rgb + 128.0)
    sim, bl = float(similarity), float(blend)
    mf = [[float(c) for c in row] for row in m]

    def run(fb):
        rgb_fb = csc.convert(fb, "rgba") if fb.format != "rgba" else fb
        arr = rgb_fb.planes["rgb"].to(torch.float32)
        r, g, b = arr[..., 0], arr[..., 1], arr[..., 2]
        du = mf[1][0] * r + mf[1][1] * g + mf[1][2] * b + 128.0 - key_u
        dv = mf[2][0] * r + mf[2][1] * g + mf[2][2] * b + 128.0 - key_v
        dist = torch.sqrt((du * du + dv * dv) / (255.0 * 255.0 * 2.0))
        if bl > 0:
            alpha = torch.clamp((dist - sim) / bl, 0.0, 1.0) * 255.0
        else:
            alpha = torch.where(dist < sim, 0.0, 255.0)
        out = torch.cat([arr[..., :3], alpha[..., None]], dim=-1)
        return rgb_fb.with_planes({"rgb": out.to(torch.uint8)}, "rgba")
    return run


# ---- stream filters (stateful N->M batch transforms) ----------------------

def _meta_take(meta, idx_or_slice):
    return {key: None if arr is None else arr[idx_or_slice]
            for key, arr in meta.items()}


def _meta_concat(a, b):
    out = {}
    for key in b:
        x, y = a.get(key), b[key]
        if x is None or y is None:
            # inconsistent caller (array one batch, None the next):
            # drop the track rather than emit misaligned metadata
            out[key] = None
        else:
            out[key] = np.concatenate([np.asarray(x), np.asarray(y)])
    return out


def _empty_like(fb: FrameBatch) -> FrameBatch:
    return fb.with_planes({k: v[:0] for k, v in fb.planes.items()})


def _take_frames(planes, idx) -> dict:
    """Frames `idx` (host indices) of every plane, gathered on the
    planes' device."""
    out = {}
    for k, v in planes.items():
        sel = torch.as_tensor(np.asarray(idx, np.int64), device=v.device)
        out[k] = same_bits(lambda p: p[sel], v)
    return out


def _cat_frames(*parts: torch.Tensor) -> torch.Tensor:
    return same_bits(lambda *p: torch.cat(p), *parts)


def _repeat_last(p: torch.Tensor, n: int) -> torch.Tensor:
    """p with its last frame appended n more times."""
    return _cat_frames(p, p[-1:].expand((n,) + tuple(p.shape[1:])))


class YadifFilter:
    """yadif deinterlacer (vf_yadif_cuda analog) — streaming, batched.

    Options mirror ff_yadif_options (yadif_common.c:199+):
      mode:   0 send_frame, 1 send_field (2x fps), 2/3 = nospatial variants
      parity: 0 assume tff, 1 assume bff, -1 auto — with per-frame
              interlace props (the 'interlaced' metadata track, bit0 =
              interlaced, bit1 = tff), auto locks onto the first
              interlaced frame's field order; otherwise tff
      deint:  0 deinterlace all frames (default); 1 only frames flagged
              interlaced (send_frame mode only)

    Temporal state: carries the last two frames across batches; outputs
    lag one frame behind input (the prev/cur/next shift register,
    yadif_common.c:103-111); flush() drains the pending frame at EOF with
    a synthetic next = clone(cur).  pts in send_field mode follow the
    reference's halved output timebase (pts*2 / cur_pts+next_pts);
    send_frame mode keeps source pts.
    """

    stream_filter = True

    def __init__(self, mode=0, parity=-1, deint=0):
        self.mode, self.deint = int(mode), int(deint)
        self.send_field = bool(self.mode & 1)
        self.skip_spatial = bool(self.mode & 2)
        self.fps_mul = 2 if self.send_field else 1
        p = int(parity)
        self._auto_parity = p == -1
        self.tff = 1 if p == -1 else (p ^ 1)
        self._hist = None        # plane dict, last 2 frames (device)
        self._hist_meta = {}     # pts/times/keys/keep tails (numpy)

    def _deint(self, ext):
        from ..ops.yadif import deint_batch
        return deint_batch(ext, self.tff, self.skip_spatial,
                           self.send_field)

    def _outputs(self, fb, ext, ext_meta, count):
        out_planes = self._deint(ext)
        ilace = ext_meta.get("interlaced")
        if self.deint and not self.send_field and ilace is not None:
            # deint=1: progressive frames pass through untouched
            prog = (np.asarray(ilace[1:1 + count]) & 1) == 0
            if prog.any():
                out_planes = {
                    k: same_bits(
                        lambda c, o: torch.where(
                            torch.as_tensor(prog, device=o.device).reshape(
                                (-1,) + (1,) * (o.ndim - 1)), c, o),
                        ext[k][1:1 + count], v)
                    for k, v in out_planes.items()}
        ofb = fb.with_planes(out_planes)
        meta = _meta_take(ext_meta, slice(1, 1 + count))
        if self.send_field:
            pts = ext_meta.get("pts")
            times = ext_meta.get("times")
            out = {}
            if pts is not None:
                p_cur, p_nxt = pts[1:1 + count], pts[2:2 + count]
                out["pts"] = np.stack([2 * p_cur, p_cur + p_nxt],
                                      1).reshape(-1)
            else:
                out["pts"] = None
            if times is not None:
                t_cur, t_nxt = times[1:1 + count], times[2:2 + count]
                out["times"] = np.stack([t_cur, (t_cur + t_nxt) * 0.5],
                                        1).reshape(-1)
            else:
                out["times"] = None
            for key in ("keys", "pos", "keep", "pad"):
                arr = meta.get(key)
                out[key] = None if arr is None else np.repeat(arr, 2)
            meta = out
        return ofb, meta

    def process_batch(self, fb: FrameBatch, meta):
        # ffmpeg chain semantics: only frames that REACH this filter
        # enter the prev/cur/next register — upstream-dropped frames and
        # batch padding are compacted away (output is batching-invariant)
        alive = np.asarray(meta["keep"]).copy()
        pad = meta.get("pad")
        if pad is not None:
            alive &= ~np.asarray(pad)
        idx = np.nonzero(alive)[0]
        v = len(idx)
        if v < fb.batch:
            fb = fb.with_planes(_take_frames(fb.planes, idx))
            meta = _meta_take(meta, idx)
        if v == 0:
            return _empty_like(fb), meta
        if self._auto_parity:
            # parity=-1: lock field order onto the first interlaced frame
            ilace = meta.get("interlaced")
            if ilace is not None:
                flags = np.asarray(ilace)
                hit = np.nonzero(flags & 1)[0]
                if len(hit):
                    self.tff = int((flags[hit[0]] >> 1) & 1)
                    self._auto_parity = False
        # format/dims shell for flush() — an empty view, not a reference
        # pinning the whole batch's device planes
        self._last_fb = _empty_like(fb)
        if self._hist is None:
            # stream start: prev of the first frame is the frame itself
            # (yadif_common.c:107-111 av_frame_clone)
            ext = {k: _cat_frames(p[:1], p) for k, p in fb.planes.items()}
            ext_meta = _meta_concat(_meta_take(meta, slice(0, 1)), meta)
        else:
            ext = {k: _cat_frames(self._hist[k], p)
                   for k, p in fb.planes.items()}
            ext_meta = _meta_concat(self._hist_meta, meta)
        m = v + (1 if self._hist is None else 2)
        count = m - 2
        self._hist = {k: p[-2:] for k, p in ext.items()}
        self._hist_meta = _meta_take(ext_meta, slice(m - 2, m))
        if count <= 0:
            return _empty_like(fb), _meta_take(meta, slice(0, 0))
        return self._outputs(fb, ext, ext_meta, count)

    def flush(self):
        if self._hist is None:
            return None
        # EOF: next = clone(cur) with extrapolated pts
        # (ff_yadif_request_frame, yadif_common.c:178-186)
        ext = {k: _repeat_last(p, 1) for k, p in self._hist.items()}
        ext_meta = dict(self._hist_meta)
        pts = ext_meta.get("pts")
        if pts is not None and len(pts) == 2:
            ext_meta["pts"] = np.concatenate(
                [pts, [2 * pts[-1] - pts[-2]]])
        times = ext_meta.get("times")
        if times is not None and len(times) == 2:
            ext_meta["times"] = np.concatenate(
                [times, [2 * times[-1] - times[-2]]])
        for key in ("keys", "pos", "keep", "pad"):
            arr = ext_meta.get(key)
            if arr is not None and len(arr) == 2:
                ext_meta[key] = np.concatenate([arr, arr[-1:]])
        self._hist = None
        return self._outputs(self._last_fb, ext, ext_meta, 1)


class BwdifFilter(YadifFilter):
    """bwdif deinterlacer (vf_bwdif.c analog) — yadif's streaming state
    machine (prev/cur/next register, auto parity, deint gating) with the BBC Weston 3-field kernel (ops/bwdif.py).

    Options mirror bwdif_options (vf_bwdif.c:366-380): mode send_frame(0)
    / send_field(1, the DEFAULT — unlike yadif), parity tff(0)/bff(1)/
    auto(-1), deint all(0)/interlaced(1); named constants accepted.
    Frames need w>=3 and h>=4 (config_props, vf_bwdif.c:336-339).

    FIELD_END semantics (yadif_common.c:47-48,112): the stream's first
    output field and — in send_field mode — the flushed final frame's
    second field are spatial-only filter_intra interpolations.
    """

    _MODES = {"send_frame": 0, "send_field": 1}
    _PARITIES = {"tff": 0, "bff": 1, "auto": -1}
    _DEINTS = {"all": 0, "interlaced": 1}

    def __init__(self, mode=1, parity=-1, deint=0):
        def named(v, table, what):
            if isinstance(v, str) and not v.lstrip("-").isdigit():
                if v not in table:
                    raise FilterError(f"bwdif: unknown {what} {v!r}")
                return table[v]
            return int(v)

        mode = named(mode, self._MODES, "mode")
        parity = named(parity, self._PARITIES, "parity")
        deint = named(deint, self._DEINTS, "deint")
        if mode not in (0, 1):
            raise FilterError("bwdif: mode must be send_frame(0) or "
                              "send_field(1)")
        super().__init__(mode=mode, parity=parity, deint=deint)
        self._intra_first = True      # stream start = FIELD_END
        self._in_flush = False
        self._run_ilace = None
        self._run_count = 0

    def _outputs(self, fb, ext, ext_meta, count):
        # stash the run's interlaced flags so _deint can keep FIELD_END
        # alive through deint=interlaced progressive passthrough
        self._run_ilace = ext_meta.get("interlaced")
        self._run_count = count
        try:
            return super()._outputs(fb, ext, ext_meta, count)
        finally:
            self._run_ilace = None

    def _deint(self, ext):
        from ..ops.bwdif import bwdif_batch
        intra_first = -1
        if self._intra_first:
            # FIELD_END persists until a frame is actually FILTERED, so
            # with deint=interlaced the spatial-only first field lands on
            # the first interlaced frame, not output index 0
            j = 0
            if self.deint and self._run_ilace is not None:
                fl = np.asarray(self._run_ilace[1:1 + self._run_count])
                filt = np.nonzero((fl.astype(np.int64) & 1) != 0)[0]
                j = int(filt[0]) if filt.size else -1
            if j >= 0:
                intra_first = j
                self._intra_first = False
        intra_last = -1
        if self._in_flush and self.send_field:
            # flush emits exactly one real frame at output index 0
            intra_last = 0
        return bwdif_batch(ext, self.tff, self.send_field,
                           intra_first=intra_first, intra_last=intra_last)

    def process_batch(self, fb: FrameBatch, meta):
        if fb.width < 3 or fb.height < 4:
            raise FilterError("bwdif: video of less than 3 columns or 4 "
                              "lines is not supported (vf_bwdif.c "
                              "config_props)")
        return super().process_batch(fb, meta)

    def flush(self):
        self._in_flush = True
        try:
            return super().flush()
        finally:
            self._in_flush = False


# ---- batch-control filters (select family) --------------------------------

_PICT_CONSTS = {          # AV_PICTURE_TYPE_* values (vf_select var_names)
    "I": 1.0, "P": 2.0, "B": 3.0, "S": 4.0, "SI": 5.0, "SP": 6.0, "BI": 7.0,
    "PICT_TYPE_I": 1.0, "PICT_TYPE_P": 2.0, "PICT_TYPE_B": 3.0,
    "PICT_TYPE_S": 4.0, "PICT_TYPE_SI": 5.0, "PICT_TYPE_SP": 6.0,
    "PICT_TYPE_BI": 7.0,
    "PROGRESSIVE": 0.0, "TOPFIRST": 1.0, "BOTTOMFIRST": 2.0,
}


class SelectFilter:
    """select/select_cuda analog: keep frames where expr evaluates nonzero.

    Vars (vf_select_cuda.c:53-100): n, t, pts, key, scene, selected_n,
    prev_selected_{n,pts,t}, start_pts, start_t, prev_pts, prev_t,
    pict_type (I for keyframes else P, + the I/P/B/... constants),
    interlace_type (PROGRESSIVE), and pos (the packet's byte offset when
    the ingest pipeline provides it, NaN otherwise).  Scene scores are
    computed on the batch's device (ops/scene.py); the expression runs
    per frame on the host.
    """

    batch_control = True

    def __init__(self, expr=None, threshold=None):
        if threshold is not None:
            # FrameSelect/AppSelect-style scene threshold: sugar for
            # gt(scene,T)
            if expr is not None:
                raise FilterError("select: give expr OR threshold, "
                                  "not both")
            expr = f"gt(scene,{float(threshold)})"
        if expr is None:
            expr = "1"
        self.expr = compile_expr(str(expr))
        self.needs_scene = "scene" in str(expr)
        self.n = 0
        self.prev_last = None
        self.prev_mafd = 0.0
        # selection bookkeeping (vf_select var set, vf_select_cuda.c:53-100)
        self.selected_n = 0.0
        self.prev_selected_n = float("nan")
        self.prev_selected_t = float("nan")
        self.prev_selected_pts = float("nan")
        self.start_t = float("nan")
        self.start_pts = float("nan")
        self.prev_t = float("nan")
        self.prev_pts = float("nan")

    def keep_mask(self, fb: FrameBatch, pts=None, times=None, keys=None,
                  pos=None, keep=None):
        """keep: frames already dropped upstream (an earlier select/fps,
        or batch padding) — invisible to this filter, like ffmpeg's
        per-frame chain: n/selected_n/prev_* only advance over frames
        that actually reach it."""
        from ..ops.scene import scene_scores_mafd, score_depth
        n = fb.batch
        if self.needs_scene:
            bits = score_depth(fb.fmt)
            kp = None if keep is None else np.asarray(keep)
            scores = np.zeros(n)
            if kp is not None and not kp.all():
                # scene diffs run between consecutive frames that REACH
                # this filter: gather the alive frames (padded to the
                # batch shape) and scatter the scores back
                alive = np.nonzero(kp)[0]
                if alive.size:
                    idx = np.concatenate(
                        [alive, np.full(n - alive.size, alive[-1], int)])
                    sub = fb.with_planes(_take_frames(fb.planes, idx))
                    s, mafd = scene_scores_mafd(sub, self.prev_last,
                                                self.prev_mafd, bits)
                    s, mafd = s.cpu().numpy(), mafd.cpu().numpy()
                    scores[alive] = s[:alive.size]
                    self.prev_mafd = float(mafd[alive.size - 1])
                    self.prev_last = {k: v[alive.size - 1]
                                      for k, v in sub.planes.items()}
            else:
                s, mafd = scene_scores_mafd(fb, self.prev_last,
                                            self.prev_mafd, bits)
                scores = s.cpu().numpy()
                self.prev_mafd = float(mafd[-1])
                self.prev_last = {k: v[-1] for k, v in fb.planes.items()}
        else:
            scores = np.zeros(n)
        out = np.zeros(n, bool)
        env = dict(_PICT_CONSTS)         # constants built once per batch
        env["interlace_type"] = 0.0
        seen = 0
        for i in range(n):
            if keep is not None and not keep[i]:
                continue
            t = float(times[i]) if times is not None else 0.0
            p = float(pts[i]) if pts is not None else 0.0
            k = float(keys[i]) if keys is not None else 0.0
            if np.isnan(self.start_t):
                self.start_t, self.start_pts = t, p
            env.update(
                n=float(self.n + seen), t=t, pts=p, key=k,
                pict_type=1.0 if k else 2.0,
                pos=(float(pos[i]) if pos is not None and pos[i] >= 0
                     else float("nan")),
                scene=float(scores[i]),
                start_t=self.start_t, start_pts=self.start_pts,
                prev_t=self.prev_t, prev_pts=self.prev_pts,
                selected_n=self.selected_n,
                prev_selected_n=self.prev_selected_n,
                prev_selected_t=self.prev_selected_t,
                prev_selected_pts=self.prev_selected_pts)
            out[i] = self.expr(env) != 0
            if out[i]:
                self.prev_selected_n = float(self.n + seen)
                self.prev_selected_t = t
                self.prev_selected_pts = p
                self.selected_n += 1.0
            self.prev_t, self.prev_pts = t, p
            seen += 1
        self.n += seen
        return out


class FpsFilter:
    """fps=N decimation (keep every round(src_fps/N)-th frame).
    fps_mul reports the rate change so the encoder timestamps the output
    at the decimated rate, not the source rate."""

    batch_control = True

    def __init__(self, fps=30.0, src_fps=30.0):
        self.step = max(float(src_fps) / float(fps), 1.0)
        self.fps_mul = 1.0 / self.step
        self.n = 0
        self.next_emit = 0.0

    def keep_mask(self, fb, pts=None, times=None, keys=None, pos=None,
                  keep=None):
        out = np.zeros(fb.batch, bool)
        for i in range(fb.batch):
            if keep is not None and not keep[i]:
                continue      # dropped upstream: invisible to this filter
            if self.n >= self.next_emit - 1e-9:
                out[i] = True
                self.next_emit += self.step
            self.n += 1
        return out


class TrimFilter:
    """ffmpeg trim (f_trim.c): keep the window [start, end) by seconds,
    pts, or frame index, as trim_filter_frame does: a frame passes the
    start gate when ANY configured start bound admits it, and the end
    gate when ANY configured end bound does; `duration` is its own
    end-gate term measured from the first frame past the start gate;
    once the end gate rejects a frame the filter latches EOF and drops
    everything after.  pts are NOT shifted (pair with
    setpts=PTS-STARTPTS to rebase)."""

    batch_control = True

    def __init__(self, start=None, end=None, start_pts=None, end_pts=None,
                 start_frame=None, end_frame=None, duration=None):
        f = lambda v: None if v is None else float(v)
        self.start, self.end = f(start), f(end)
        self.duration = f(duration)
        self.start_pts = None if start_pts is None else int(start_pts)
        self.end_pts = None if end_pts is None else int(end_pts)
        self.start_frame = None if start_frame is None else int(start_frame)
        self.end_frame = None if end_frame is None else int(end_frame)
        self.n = 0          # frames that reached this filter (alive only)
        self.first_t = None  # f_trim.c first_pts (seconds domain)
        self.eof = False     # f_trim.c s->eof latch

    def keep_mask(self, fb, pts=None, times=None, keys=None, pos=None,
                  keep=None):
        # seconds-domain gates need a times track; without it every
        # `t >= start` term is false and the stream would silently vanish
        if times is None and (self.start is not None or self.end is not None
                              or self.duration is not None):
            raise ValueError(
                "trim: start/end/duration are in seconds and need a times "
                "track; pass times= or use start_pts/end_pts/start_frame/"
                "end_frame")
        out = np.zeros(fb.batch, bool)
        for i in range(fb.batch):
            if keep is not None and not keep[i]:
                continue
            if self.eof:     # EOF latched: drop without counting
                continue
            t = None if times is None else float(times[i])
            p = None if pts is None else int(pts[i])
            idx = self.n
            self.n += 1
            starts = []
            if self.start is not None:
                starts.append(t is not None and t >= self.start - 1e-9)
            if self.start_pts is not None:
                starts.append(p is not None and p >= self.start_pts)
            if self.start_frame is not None:
                starts.append(idx >= self.start_frame)
            if starts and not any(starts):
                continue
            if self.first_t is None and t is not None:
                self.first_t = t
            ends = []
            if self.end is not None:
                ends.append(t is not None and t < self.end - 1e-9)
            if self.end_pts is not None:
                ends.append(p is not None and p < self.end_pts)
            if self.end_frame is not None:
                ends.append(idx < self.end_frame)
            if self.duration is not None:
                ends.append(t is not None and self.first_t is not None
                            and t - self.first_t < self.duration - 1e-9)
            if ends and not any(ends):
                self.eof = True
                continue
            out[i] = True
        return out


_AV_NOPTS = -(1 << 63)          # AV_NOPTS_VALUE (== INT64_MIN)


class SetptsFilter:
    """ffmpeg setpts (setpts.c): rewrite pts via av_expr.  Vars: PTS, N
    (frames that reached this filter), T (seconds), STARTPTS, STARTT,
    PREV_INPTS/PREV_INT/PREV_OUTPTS/PREV_OUTT (NAN before the first
    frame), TB.  Results map through D2TS: NaN -> AV_NOPTS_VALUE, else
    C-cast truncation toward zero (saturating at the int64 range).  The
    times track is recomputed as new_pts*tb so downstream seconds-based
    filters (trim) see the rewritten timeline — tb comes from the tb=
    option or is inferred from the incoming pts/times slope.  Planes are
    untouched: only metadata is rewritten."""

    stream_filter = True

    def __init__(self, expr="PTS", tb=None):
        self.expr = compile_expr(str(expr))
        self.tb = None if tb is None else float(tb)
        self.n = 0
        self.startpts = None        # NAN-equivalent until the first
        self.startt = None          # frame with a real pts
        nan = float("nan")
        self.prev_in = self.prev_out = nan
        self.prev_in_t = self.prev_out_t = nan
        self._tb_est = None
        self._tb_anchor = None      # (pts, t) carried ACROSS batches

    @staticmethod
    def _d2ts(v: float) -> int:
        """internal.h D2TS: NaN -> AV_NOPTS_VALUE, else (int64_t)(d)."""
        if math.isnan(v):
            return _AV_NOPTS
        if v >= float(1 << 63):
            return (1 << 63) - 1
        if v <= float(-(1 << 63)):
            return -(1 << 63)
        return int(v)               # C cast truncates toward zero

    def _infer_tb(self, pts, times, keep):
        """pts->seconds slope from two alive frames; the anchor persists
        across calls so single-frame batches infer tb on the second."""
        prev = self._tb_anchor
        for i in range(len(pts)):
            if keep is not None and not keep[i]:
                continue
            p, t = int(pts[i]), float(times[i])
            if p == _AV_NOPTS or not math.isfinite(t):
                continue
            if prev is not None and p != prev[0]:
                return (t - prev[1]) / (p - prev[0])
            prev = (p, t)
        self._tb_anchor = prev
        return None

    def process_batch(self, fb: FrameBatch, meta):
        pts = meta.get("pts")
        if pts is None:
            return fb, meta
        times = meta.get("times")
        keep = meta.get("keep")
        new_pts = np.array(pts, np.int64, copy=True)
        new_times = (None if times is None
                     else np.array(times, np.float64, copy=True))
        if self.tb is not None:
            self._tb_est = self.tb
        elif self._tb_est is None and times is not None:
            self._tb_est = self._infer_tb(pts, times, keep)
        tb = self._tb_est
        nan = float("nan")
        for i in range(len(new_pts)):
            if keep is not None and not keep[i]:
                continue
            p_i = int(pts[i])
            p = nan if p_i == _AV_NOPTS else float(p_i)
            t = (float(times[i]) if times is not None
                 else (p * tb if tb is not None else nan))
            if self.startpts is None and not math.isnan(p):
                self.startpts = p
                self.startt = t
            env = {"PTS": p, "N": float(self.n), "T": t,
                   "STARTPTS": self.startpts
                   if self.startpts is not None else nan,
                   "STARTT": self.startt
                   if self.startt is not None else nan,
                   "PREV_INPTS": self.prev_in,
                   "PREV_INT": self.prev_in_t,
                   "PREV_OUTPTS": self.prev_out,
                   "PREV_OUTT": self.prev_out_t,
                   "TB": tb if tb is not None else nan}
            out_ts = self._d2ts(float(self.expr(env)))
            self.n += 1
            new_pts[i] = out_ts
            self.prev_in, self.prev_in_t = p, t
            self.prev_out = nan if out_ts == _AV_NOPTS else float(out_ts)
            self.prev_out_t = (self.prev_out * tb if tb is not None
                               else nan)
            if new_times is not None and tb is not None:
                # only rewrite when the scale is known
                new_times[i] = self.prev_out_t
        out = dict(meta)
        out["pts"] = new_pts
        if new_times is not None:
            out["times"] = new_times
        return fb, out

    def flush(self):
        return None


class ThumbnailFilter:
    """thumbnail_cuda analog: pick the most representative frame of every
    window of `n` frames (min histogram distance to the window mean).

    Frames of the open window are buffered on the host (as ffmpeg's
    thumbnail holds n frame refs), so the true window-best frame is
    emitted even when it fell in an earlier batch; flush() emits the best
    frame of the final partial window at EOF.  The emitted batch goes
    back to the device the input came from."""

    stream_filter = True

    def __init__(self, n=100):
        self.window = int(n)
        self._buf = []           # (hist, planes_dict, meta_dict) per frame
        self._last_fb = None

    @staticmethod
    def _hist(planes, i, shift=2, fmt=None):
        """64-bin luma histogram; shift maps the sample depth onto the
        bins (8-bit: >>2; 10-bit lsb: >>4; p010/p016 msb: >>10; floats
        scale 0..1 into the bins).  RGB frames bin true BT.601 luma."""
        if "y" in planes:
            arr = np.asarray(planes["y"][i])
        else:
            rgb = np.asarray(planes["rgb"][i]).astype(np.float32)
            order = fmt.channel_order if fmt is not None else "rgb"
            # channel axis from the ARRAY shape: channels-last, or NCHW
            ax = (-1 if rgb.shape[-1] == len(order)
                  else 0 if rgb.shape[0] == len(order) else -1)
            idx = {c: k for k, c in enumerate(order)}
            r = np.take(rgb, idx["r"], axis=ax)
            g = np.take(rgb, idx["g"], axis=ax)
            b = np.take(rgb, idx["b"], axis=ax)
            y601 = 0.299 * r + 0.587 * g + 0.114 * b
            if fmt is not None and not fmt.is_float:
                y601 = y601 / float((1 << fmt.bits) - 1)
            vals = np.clip(y601 * 63.0, 0, 63).astype(np.int64).reshape(-1)
            return np.bincount(np.minimum(vals, 63),
                               minlength=64).astype(np.float64)
        if arr.dtype.kind == "f":
            vals = np.clip(arr * 63.0, 0, 63).astype(np.int64).reshape(-1)
        else:
            vals = arr.astype(np.int64).reshape(-1) >> shift
        return np.bincount(np.minimum(vals, 63),
                           minlength=64).astype(np.float64)

    def _best(self):
        hs = np.stack([h for h, _, _ in self._buf])
        d = np.abs(hs - hs.mean(0)).sum(1)
        _, planes, m = self._buf[int(np.argmin(d))]
        self._buf = []
        return planes, m

    def _emit(self, picks):
        fb = self._last_fb
        meta = {"pts": None, "times": None, "keys": None, "pos": None,
                "keep": np.ones(len(picks), bool)}
        if not picks:
            return _empty_like(fb), meta
        planes = {k: torch.as_tensor(np.stack([p[k] for p, _ in picks]),
                                     device=fb.device)
                  for k in picks[0][0]}
        for key in ("pts", "times", "keys", "pos"):
            vals = [m.get(key) for _, m in picks]
            if all(v is not None for v in vals):
                meta[key] = np.asarray(vals)
        return fb.with_planes(planes), meta

    def process_batch(self, fb: FrameBatch, meta):
        host = {k: v.cpu().numpy() for k, v in fb.planes.items()}
        self._last_fb = _empty_like(fb)   # shape shell; don't pin planes
        keep = meta["keep"]
        fmt = fb.fmt
        shift = (10 if fmt.name in ("p010", "p016")
                 else max(fmt.bits - 6, 0))
        picks = []
        for i in range(fb.batch):
            if not keep[i]:
                continue
            fm = {key: (None if arr is None else arr[i])
                  for key, arr in meta.items()}
            self._buf.append((self._hist(host, i, shift, fmt),
                              {k: host[k][i] for k in host}, fm))
            if len(self._buf) == self.window:
                picks.append(self._best())
        return self._emit(picks)

    def flush(self):
        if not self._buf or self._last_fb is None:
            return None
        return self._emit([self._best()])


# ---- filters/builtin.py part 2: per-frame colour, blur and denoise -------

def _cached(cache: Dict, key, make):
    """cache[key], made by make() on a miss: the device copies of host
    tables, built once per (key, device)."""
    hit = cache.get(key)
    if hit is None:
        if len(cache) > 32:
            cache.clear()
        hit = cache[key] = make()
    return hit


def _f_lut3d(file=None, interp="tetrahedral"):
    """vf_lut3d builder: .cube/.3dl file or the size-32 identity."""
    if file:
        try:
            lut, scale = _l3.load_lut_file(str(file))
        except OSError as e:
            raise FilterError(f"lut3d: {e}") from None
    else:
        lut, scale = _l3.identity_lut(32)
    mode = str(interp)
    if mode not in _l3.INTERP_MODES:
        raise FilterError(f"lut3d interp must be one of "
                          f"{_l3.INTERP_MODES}, got {mode!r}")
    return lambda fb: _l3.apply_lut3d(fb, lut, scale, mode)


def _f_lut1d(file=None, interp="linear"):
    """vf_lut1d builder: 1D .cube file or the size-32 identity."""
    if file:
        try:
            lut, scale = _l3.load_lut1d_file(str(file))
        except OSError as e:
            raise FilterError(f"lut1d: {e}") from None
    else:
        lut, scale = _l3.identity_lut_1d(32)
    mode = str(interp)
    if mode not in _l3.INTERP_1D_MODES:
        raise FilterError(f"lut1d interp must be one of "
                          f"{_l3.INTERP_1D_MODES}, got {mode!r}")
    return lambda fb: _l3.apply_lut1d(fb, lut, scale, mode)


# ---- colorchannelmixer (vf_colorchannelmixer.c) ----------------------------

def _f_colorchannelmixer(rr=1.0, rg=0.0, rb=0.0, ra=0.0,
                         gr=0.0, gg=1.0, gb=0.0, ga=0.0,
                         br=0.0, bg=0.0, bb=1.0, ba=0.0,
                         ar=0.0, ag=0.0, ab=0.0, aa=1.0,
                         pc="none", pa=0.0):
    """vf_colorchannelmixer: each output channel is a mix of the input
    channels through per-pair integer LUTs lut[out][in][v] =
    lrint(v * coef), summing the rounded terms
    (colorchannelmixer_template.c:197-209), clipped to the depth.
    Integer RGB formats; the alpha row only applies when the format has
    alpha; preserve modes other than `none` are not implemented."""
    coefs = {}
    for name, v in (("rr", rr), ("rg", rg), ("rb", rb), ("ra", ra),
                    ("gr", gr), ("gg", gg), ("gb", gb), ("ga", ga),
                    ("br", br), ("bg", bg), ("bb", bb), ("ba", ba),
                    ("ar", ar), ("ag", ag), ("ab", ab), ("aa", aa)):
        v = float(v)
        if not -2.0 <= v <= 2.0:
            raise FilterError(f"colorchannelmixer {name}={v} outside "
                              "[-2, 2]")
        coefs[name] = v
    if str(pc).lower() not in ("none", "0"):
        raise FilterError("colorchannelmixer: preserve modes beyond "
                          "'none' are not implemented")
    lut_cache: Dict = {}

    def tables(depth, device):
        idx = np.arange(1 << depth, dtype=np.float64)
        return {k: torch.as_tensor(np.rint(idx * c).astype(np.int32),
                                   device=device)
                for k, c in coefs.items() if c != 0.0}

    def run(fb):
        fmt = fb.fmt
        if not fmt.is_rgb or fmt.is_float:
            raise FilterError("colorchannelmixer operates on integer RGB "
                              "frames; convert first")
        depth = fmt.bits
        size = 1 << depth
        order = fmt.channel_order
        have_alpha = "a" in order
        arr = fb.planes["rgb"]
        luts = _cached(lut_cache, (depth, str(arr.device)),
                       lambda: tables(depth, arr.device))
        ins = "rgba" if have_alpha else "rgb"
        chan = {ch: arr[..., order.index(ch)].to(torch.int32) for ch in ins}
        res = {}
        for oc in ins:
            acc = None
            for ic in ins:
                if oc + ic not in luts:
                    continue
                term = apply_lut(chan[ic], luts[oc + ic])
                acc = term if acc is None else acc + term
            if acc is None:
                acc = torch.zeros_like(chan[oc])
            res[oc] = torch.clamp(acc, 0, size - 1)
        return fb.with_planes({"rgb": set_channels(arr, order, res)})
    return run


# ---- colorbalance (vf_colorbalance.c) --------------------------------------

def _f32(v) -> float:
    """v rounded to float32, as the python float a tensor op takes."""
    return float(np.float32(v))


def _f_colorbalance(rs=0.0, gs=0.0, bs=0.0, rm=0.0, gm=0.0, bm=0.0,
                    rh=0.0, gh=0.0, bh=0.0, pl=0):
    """vf_colorbalance: shadow/midtone/highlight shifts per channel,
    optional HSL lightness preservation, in the C kernels' float32 order:
    per-pixel l = max3+min3, get_component's a=4/b=0.333/scale=0.7
    weighting (vf_colorbalance.c:94-108), preservel's RGB->HSL->RGB with
    hfun (:110-151), lrintf output rounding.  Integer RGB formats; alpha
    passes through."""
    prm = {}
    for name, v in (("rs", rs), ("gs", gs), ("bs", bs), ("rm", rm),
                    ("gm", gm), ("bm", bm), ("rh", rh), ("gh", gh),
                    ("bh", bh)):
        v = float(v)
        if not -1.0 <= v <= 1.0:
            raise FilterError(f"colorbalance {name}={v} outside [-1, 1]")
        prm[name] = _f32(v)
    pl = bool(int(pl))
    a, b, scale = 4.0, _f32(0.333), _f32(0.7)

    def get_component(v, l, s, m, h):
        # C's `s *= x * scale` evaluates the RHS first: s * (x*scale)
        s = s * (torch.clamp((b - l) * a + 0.5, 0.0, 1.0) * scale)
        m = m * ((torch.clamp((l - b) * a + 0.5, 0.0, 1.0)
                  * torch.clamp((1.0 - l - b) * a + 0.5, 0.0, 1.0)) * scale)
        h = h * (torch.clamp((l + b - 1.0) * a + 0.5, 0.0, 1.0) * scale)
        return torch.clamp(v + s + m + h, 0.0, 1.0)

    def hfun(n, h, s, l):
        a_ = s * torch.minimum(l, 1.0 - l)
        k = torch.fmod(n + h / 30.0, 12.0)      # Python-style mod, as
        k = torch.where(k < 0, k + 12.0, k)     # jnp.mod
        t = torch.clamp(torch.minimum(k - 3.0, 9.0 - k), max=1.0)
        t = torch.clamp(t, min=-1.0)
        return torch.clamp(l - a_ * t, 0.0, 1.0)

    def preservel(r, g, b_, l):
        mx = torch.maximum(torch.maximum(r, g), b_)
        mn = torch.minimum(torch.minimum(r, g), b_)
        l = l * 0.5
        d = torch.where(mx > mn, mx - mn, 1.0)   # guarded denominator
        h = torch.where(
            (r == g) & (g == b_), 0.0,
            torch.where(mx == r, 60.0 * ((g - b_) / d),
                        torch.where(mx == g, 60.0 * (2.0 + (b_ - r) / d),
                                    60.0 * (4.0 + (r - g) / d))))
        h = torch.where(h < 0.0, h + 360.0, h)
        den = 1.0 - torch.abs(2.0 * l - 1.0)
        s = torch.where((mx == 1.0) | (mn == 0.0), 0.0,
                        (mx - mn) / torch.where(den > 0.0, den, 1.0))
        # the C divides by den == 0 when the INPUT is pure white/black but
        # the adjusted channels aren't at the s-guard extremes: NaN, which
        # lrintf saturates to INT_MIN -> clip 0 (black) on x86
        bad = (den <= 0.0) & ~((mx == 1.0) | (mn == 0.0))
        return tuple(torch.where(bad, 0.0, hfun(n, h, s, l))
                     for n in (0.0, 8.0, 4.0))

    def run(fb):
        fmt = fb.fmt
        if not fmt.is_rgb or fmt.is_float:
            raise FilterError("colorbalance operates on integer RGB "
                              "frames; convert first")
        order = fmt.channel_order
        arr = fb.planes["rgb"]
        maxv = float((1 << fmt.bits) - 1)
        r, g, b_ = (arr[..., order.index(c)].to(torch.float32) / maxv
                    for c in "rgb")
        l = torch.maximum(torch.maximum(r, g), b_) \
            + torch.minimum(torch.minimum(r, g), b_)
        ro = get_component(r, l, prm["rs"], prm["rm"], prm["rh"])
        go = get_component(g, l, prm["gs"], prm["gm"], prm["gh"])
        bo = get_component(b_, l, prm["bs"], prm["bm"], prm["bh"])
        if pl:
            ro, go, bo = preservel(ro, go, bo, l)
        imax = int(maxv)
        new = {ch: torch.clamp(torch.round(v * maxv).to(torch.int32), 0,
                               imax)
               for ch, v in (("r", ro), ("g", go), ("b", bo))}
        return fb.with_planes({"rgb": set_channels(arr, order, new)})
    return run


# ---- curves (vf_curves.c) --------------------------------------------------

# curves_presets[] table, vf_curves.c:115-144
_CURVES_PRESETS = {
    "none": (None, None, None, None),
    "color_negative": ("0.129/1 0.466/0.498 0.725/0",
                       "0.109/1 0.301/0.498 0.517/0",
                       "0.098/1 0.235/0.498 0.423/0", None),
    "cross_process": ("0/0 0.25/0.156 0.501/0.501 0.686/0.745 1/1",
                      "0/0 0.25/0.188 0.38/0.501 0.745/0.815 1/0.815",
                      "0/0 0.231/0.094 0.709/0.874 1/1", None),
    "darker": (None, None, None, "0/0 0.5/0.4 1/1"),
    "increase_contrast": (None, None, None,
                          "0/0 0.149/0.066 0.831/0.905 0.905/0.98 1/1"),
    "lighter": (None, None, None, "0/0 0.4/0.5 1/1"),
    "linear_contrast": (None, None, None,
                        "0/0 0.305/0.286 0.694/0.713 1/1"),
    "medium_contrast": (None, None, None,
                        "0/0 0.286/0.219 0.639/0.643 1/1"),
    "negative": (None, None, None, "0/1 1/0"),
    "strong_contrast": (None, None, None,
                        "0/0 0.301/0.196 0.592/0.6 0.686/0.737 1/1"),
    "vintage": ("0/0.11 0.42/0.51 1/0.95", "0/0 0.50/0.48 1/1",
                "0/0.22 0.49/0.44 1/0.8", None),
}


def _curves_parse_points(s, lut_size):
    """parse_points_str (vf_curves.c:157-199): 'x/y x/y ...' with [0,1]
    range checks and strictly-increasing scaled x."""
    if s is None:
        return []
    scale = lut_size - 1
    pts = []
    for tok in str(s).replace(",", " ").split():
        xy = tok.split("/")
        if len(xy) != 2:
            raise FilterError(f"curves: bad point {tok!r} (use x/y)")
        try:
            x, y = float(xy[0]), float(xy[1])
        except ValueError:
            raise FilterError(f"curves: bad point {tok!r}") from None
        if not (0.0 <= x <= 1.0 and 0.0 <= y <= 1.0):
            raise FilterError(f"curves: point ({x};{y}) outside [0;1]")
        if pts and int(pts[-1][0] * scale) >= int(x * scale):
            raise FilterError(f"curves: points not strictly increasing "
                              f"at {tok!r}")
        pts.append((x, y))
    return pts


def _curves_spline_graph(points, depth):
    """Natural cubic spline LUT — interpolate() (vf_curves.c:219-338)
    with the same tridiagonal solve, segment polynomials, truncating
    CLIP, and constant left/right padding."""
    lut_size = 1 << depth
    scale = lut_size - 1
    cmax = scale

    def clip(v):
        return min(max(int(v), 0), cmax)    # double -> int truncation

    n = len(points)
    if n == 0:
        return np.arange(lut_size, dtype=np.int64)
    y = np.empty(lut_size, np.int64)
    if n == 1:
        y[:] = clip(points[0][1] * scale)
        return y
    xs = [p[0] for p in points]
    ys = [p[1] for p in points]
    h = [xs[i + 1] - xs[i] for i in range(n - 1)]
    r = [0.0] * n
    for i in range(1, n - 1):
        r[i] = 6.0 * ((ys[i + 1] - ys[i]) / h[i]
                      - (ys[i] - ys[i - 1]) / h[i - 1])
    bd = [0.0] * n
    md = [0.0] * n
    ad = [0.0] * n
    md[0] = md[n - 1] = 1.0
    for i in range(1, n - 1):
        bd[i] = h[i - 1]
        md[i] = 2.0 * (h[i - 1] + h[i])
        ad[i] = h[i]
    for i in range(1, n):
        den = md[i] - bd[i] * ad[i - 1]
        k = 1.0 / den if den else 1.0
        ad[i] *= k
        r[i] = (r[i] - bd[i] * r[i - 1]) * k
    for i in range(n - 2, -1, -1):
        r[i] = r[i] - ad[i] * r[i + 1]
    for i in range(int(xs[0] * scale)):
        y[i] = clip(ys[0] * scale)
    for i in range(n - 1):
        a = ys[i]
        b = (ys[i + 1] - ys[i]) / h[i] - h[i] * r[i] / 2.0 \
            - h[i] * (r[i + 1] - r[i]) / 6.0
        c = r[i] / 2.0
        d = (r[i + 1] - r[i]) / (6.0 * h[i])
        x_start = int(xs[i] * scale)
        x_end = int(xs[i + 1] * scale)
        for x in range(x_start, x_end + 1):
            xx = (x - x_start) * 1.0 / scale
            yy = a + b * xx + c * xx * xx + d * xx * xx * xx
            y[x] = clip(yy * scale)
    for i in range(int(xs[-1] * scale), lut_size):
        y[i] = clip(ys[-1] * scale)
    return y


def _f_curves(preset="none", master=None, m=None, red=None, r=None,
              green=None, g=None, blue=None, b=None, all=None):
    """vf_curves: per-channel natural-spline tone curves + master curve
    composition (graph[i] = master[graph[i]], vf_curves.c:666-670);
    `all` seeds every unset channel; presets fill remaining unset ones
    (curves_init).  RGB integer formats; one gather per channel through
    tables kept on the device."""
    preset = str(preset).lower()
    if preset not in _CURVES_PRESETS:
        raise FilterError(f"curves: unknown preset {preset!r}; one of "
                          f"{sorted(_CURVES_PRESETS)}")
    comp = [r if r is not None else red,
            g if g is not None else green,
            b if b is not None else blue,
            m if m is not None else master]
    if all is not None:
        for i in range(3):
            if comp[i] is None:
                comp[i] = all
    pr = _CURVES_PRESETS[preset]
    for i in range(4):
        if comp[i] is None and pr[i] is not None:
            comp[i] = pr[i]
    # bad option strings fail at graph build (syntax, [0,1] range,
    # monotonic x at a huge scale); the depth's own check reruns per
    # format like config_input
    for c in comp:
        _curves_parse_points(c, 1 << 24)
    cache: Dict = {}

    def tables(fmt, device):
        depth = fmt.bits
        dt = fmt.planes[0].dtype
        graphs = [_curves_spline_graph(
            _curves_parse_points(comp[i], 1 << depth), depth)
            for i in range(4)]
        if comp[3] is not None:
            for i in range(3):
                graphs[i] = graphs[3][graphs[i]]
        ident = np.arange(1 << depth, dtype=np.int64)
        slot = {"r": 0, "g": 1, "b": 2}
        out = {}
        for ch in fmt.channel_order:
            tab = (graphs[slot[ch]] if ch in slot else ident).astype(dt)
            if not np.array_equal(tab, ident):
                out[ch] = torch.as_tensor(tab, device=device)
        return out

    def run(fb):
        fmt = fb.fmt
        if not fmt.is_rgb or fmt.is_float:
            raise FilterError("curves operates on integer RGB frames "
                              "(vf_curves.c pix_fmts); convert first")
        arr = fb.planes["rgb"]
        tabs = _cached(cache, (fmt.name, str(arr.device)),
                       lambda: tables(fmt, arr.device))
        order = fmt.channel_order
        new = {ch: apply_lut(arr[..., order.index(ch)], t)
               for ch, t in tabs.items()}
        return fb.with_planes({"rgb": set_channels(arr, order, new)})
    return run


def _f_boxblur(luma_radius=None, lr=None, luma_power=None, lp=None,
               chroma_radius=None, cr=None, chroma_power=None, cp=None,
               alpha_radius=None, ar=None, alpha_power=None, ap=None):
    """vf_boxblur.c analog.  Radius options are av_expr strings over
    w/h/cw/ch/hsub/vsub (ff_boxblur_eval_filter_params, boxblur.c:
    62-107); chroma/alpha default to the luma values (:66-80); powers
    default luma=2, chroma/alpha=-1 (=inherit).  Radii are validated
    per component against its plane dims: 0 <= r and 2r <= min(w,h)
    (CHECK_RADIUS_VAL, boxblur.c:114-124).  Integer planar formats."""
    lum_r = str(lr if lr is not None else
                luma_radius if luma_radius is not None else "2")
    lum_p = int(lp if lp is not None else
                luma_power if luma_power is not None else 2)
    chr_r = cr if cr is not None else chroma_radius
    chr_p = int(cp if cp is not None else
                chroma_power if chroma_power is not None else -1)
    alp_r = ar if ar is not None else alpha_radius
    alp_p = int(ap if ap is not None else
                alpha_power if alpha_power is not None else -1)
    chr_r = lum_r if chr_r is None else str(chr_r)
    alp_r = lum_r if alp_r is None else str(alp_r)
    if chr_p < 0:
        chr_p = lum_p
    if alp_p < 0:
        alp_p = lum_p
    if lum_p < 0:
        raise FilterError("boxblur: luma_power must be >= 0")

    def run(fb):
        fmt = fb.fmt
        if fmt.is_rgb:
            raise FilterError("boxblur supports planar integer YUV/gray "
                              "formats only (vf_boxblur.c query_formats)")
        sw = max((p.sub_w for p in fmt.planes), default=0)
        sh = max((p.sub_h for p in fmt.planes), default=0)
        cw, ch = fb.width >> sw, fb.height >> sh
        env = {"w": float(fb.width), "h": float(fb.height),
               "cw": float(cw), "ch": float(ch),
               "hsub": float(1 << sw), "vsub": float(1 << sh)}
        radii = {}
        for name, expr, (pw, ph) in (("luma", lum_r, (fb.width, fb.height)),
                                     ("chroma", chr_r, (cw, ch)),
                                     ("alpha", alp_r, (fb.width, fb.height))):
            r = int(compile_expr(expr)(env))   # double -> int truncation
            if r < 0 or 2 * r > min(pw, ph):
                raise FilterError(
                    f"boxblur: invalid {name} radius value {r}, must be "
                    f">= 0 and <= {min(pw, ph) // 2}")
            radii[name] = r
        params = {"y": (radii["luma"], lum_p),
                  "u": (radii["chroma"], chr_p),
                  "v": (radii["chroma"], chr_p),
                  "a": (radii["alpha"], alp_p)}
        planes = {}
        for pname, arr in fb.planes.items():
            r, p = params.get(pname, (radii["luma"], lum_p))
            planes[pname] = blur.box_blur_plane(arr, r, p)
        return fb.with_planes(planes)
    return run


def _f_gblur(sigma=0.5, steps=1, planes=0xF, sigmaV=-1.0):
    """vf_gblur.c analog: recursive (IIR) gaussian, `steps` passes,
    per-plane enable bitmask (y=1, u=2, v=4, a=8), independent vertical
    sigma (sigmaV=-1 inherits sigma).  Option ranges follow
    gblur_options (vf_gblur.c:43-49)."""
    sigma = float(sigma)
    steps = int(steps)
    planes = int(planes)
    sigma_v = float(sigmaV)
    if not (0.0 <= sigma <= 1024.0):
        raise FilterError("gblur: sigma out of range [0, 1024]")
    if not (1 <= steps <= 6):
        raise FilterError("gblur: steps out of range [1, 6]")
    if not (0 <= planes <= 0xF):
        raise FilterError("gblur: planes out of range [0, 0xF]")
    if not (-1.0 <= sigma_v <= 1024.0):
        raise FilterError("gblur: sigmaV out of range [-1, 1024]")
    if sigma_v < 0:
        sigma_v = sigma

    def run(fb):
        fmt = fb.fmt
        if sigma == 0:
            return fb
        if fmt.is_rgb:
            # packed uint RGB has no C analog (gblur's pix_fmts carry
            # only planar GBRP); the float lane maps to GBRPF32, whose C
            # plane indices are 0=G, 1=B, 2=R, 3=A
            if not fmt.is_float:
                raise FilterError("gblur supports planar YUV/gray and "
                                  "float RGB (GBRPF32 analog) only")
            plane_of = {"g": 0, "b": 1, "r": 2, "a": 3}
            arr = fb.planes["rgb"]
            n, h, w, chn = arr.shape
            folded = arr.permute(0, 3, 1, 2).reshape(n * chn, h, w)
            o = blur.gblur_plane(folded, sigma, sigma_v, steps, 0.0)
            o = o.reshape(n, chn, h, w).permute(0, 2, 3, 1)
            new = {c: o[..., ci] for ci, c in enumerate(fmt.channel_order)
                   if planes & (1 << plane_of[c])}
            return fb.with_planes({"rgb": set_channels(
                arr, fmt.channel_order, new)})
        maxv = float((1 << fmt.bits) - 1)
        bit_of = {"y": 0, "u": 1, "v": 2, "a": 3}
        out = {}
        for pname, arr in fb.planes.items():
            if planes & (1 << bit_of.get(pname, 0)):
                out[pname] = blur.gblur_plane(arr, sigma, sigma_v, steps,
                                              maxv)
            else:
                out[pname] = arr
        return fb.with_planes(out)
    return run


def _f_sharpen_npp(border_type="replicate"):
    """vf_sharpen_npp.c analog: NPP's fixed 3x3 sharpen
    (nppiFilterSharpenBorder_8u_C1R, vf_sharpen_npp.c:166-168),
    (-1 -1 -1; -1 16 -1; -1 -1 -1)/8 with replicate border, on every
    plane of yuv420p / yuv444p (vf_sharpen_npp.c:36-39).  acc/8 carries
    at most 3 fractional bits, so the f32 quotient is exact and
    round-half-even is exact."""
    if str(border_type) not in ("replicate", str(2)):
        # NPP_BORDER_REPLICATE == 2 is both min and max of the option
        raise FilterError("sharpen_npp: only border_type=replicate "
                          "is supported (as in the reference)")

    def run(fb):
        if fb.format not in ("yuv420p", "yuv444p"):
            raise FilterError("sharpen_npp supports yuv420p/yuv444p only "
                              "(vf_sharpen_npp.c supported_formats)")
        planes = {}
        for name, arr in fb.planes.items():
            c = arr.to(torch.int32)
            _, h, w = c.shape
            dev = c.device
            iy = torch.clamp(torch.arange(-1, h + 1, device=dev), 0, h - 1)
            ix = torch.clamp(torch.arange(-1, w + 1, device=dev), 0, w - 1)
            p = c.index_select(1, iy).index_select(2, ix)   # edge pad
            ring = (p[:, :-2, :-2] + p[:, :-2, 1:-1] + p[:, :-2, 2:]
                    + p[:, 1:-1, :-2] + p[:, 1:-1, 2:]
                    + p[:, 2:, :-2] + p[:, 2:, 1:-1] + p[:, 2:, 2:])
            acc = (16 * c - ring).to(torch.float32) * 0.125
            planes[name] = torch.clamp(torch.round(acc), 0,
                                       255).to(torch.uint8)
        return fb.with_planes(planes)
    return run


# component flag bits shared by negate/extractplanes (vf_negate.c:30-36,
# vf_extractplanes.c:33-39 — identical values in both tables)
_COMP_BITS = {"r": 0x01, "g": 0x02, "b": 0x04, "a": 0x08,
              "y": 0x10, "u": 0x20, "v": 0x40}


def _parse_comp_flags(spec, what: str) -> int:
    """AV_OPT_TYPE_FLAGS subset: int, or '+'/'|'-joined names from
    _COMP_BITS (ffmpeg's flag-option grammar)."""
    s = str(spec).strip()
    try:
        val = int(s, 0)
    except ValueError:
        val = 0
        for tok in s.replace("|", "+").split("+"):
            tok = tok.strip()
            if not tok:
                continue
            if tok not in _COMP_BITS:
                raise FilterError(f"{what}: unknown component '{tok}'")
            val |= _COMP_BITS[tok]
    if not 1 <= val <= 0xFF:
        raise FilterError(f"{what}: component flags out of range")
    return val


def _comp_avail(fmt) -> int:
    """vf_negate.c:341-344 / vf_extractplanes.c:228-231 comp_avail:
    RGB formats expose r/g/b, YUV exposes y (+u/v when chroma planes
    exist), alpha when the format carries one."""
    if fmt.is_rgb:
        avail = _COMP_BITS["r"] | _COMP_BITS["g"] | _COMP_BITS["b"]
        if "a" in (fmt.channel_order or ""):
            avail |= _COMP_BITS["a"]
    else:
        avail = _COMP_BITS["y"]
        if any(p.name in ("u", "uv") for p in fmt.planes):
            avail |= _COMP_BITS["u"] | _COMP_BITS["v"]
    return avail


_NEGATE_FORMATS = ("yuv420p", "yuv422p", "yuv444p", "yuv420p10",
                   "yuv444p10", "yuv420p16", "yuv444p16", "gray8",
                   "gray10", "gray16", "rgb24", "bgr24", "rgba", "bgra",
                   "rgb48", "bgr48", "rgba64", "bgra64")


def _f_negate(components=0x77, negate_alpha=0):
    """vf_negate.c analog: per-component value inversion (max - v).

    For packed RGB the per-CHANNEL mask is built only from `components`
    (config_input vf_negate.c:374-385 — `negate_alpha` never feeds it),
    so ``negate=negate_alpha=1`` on rgba leaves alpha untouched like the
    reference.  Planar formats use the plane mask (default 0x7,
    vf_negate.c:338).  Components are validated against the format only
    when explicitly set (!= the 0x77 default, vf_negate.c:340-346)."""
    req = _parse_comp_flags(components, "negate")
    int(negate_alpha)      # validated; no layout here negates alpha by it

    def run(fb):
        fmt = fb.fmt
        if fb.format not in _NEGATE_FORMATS:
            raise FilterError(f"negate: unsupported format {fb.format}")
        if req != 0x77 and req & ~_comp_avail(fmt):
            raise FilterError("negate: requested components not available")
        maxv = (1 << fmt.bits) - 1
        planes = dict(fb.planes)
        if fmt.is_rgb:
            order = fmt.channel_order
            arr = fb.planes["rgb"]
            new = {ch: maxv - arr[..., i].to(torch.int32)
                   for i, ch in enumerate(order) if req & _COMP_BITS[ch]}
            planes["rgb"] = set_channels(arr, order, new)
        else:
            if req != 0x77:
                mask = {"y": bool(req & 0x10), "u": bool(req & 0x20),
                        "v": bool(req & 0x40)}
            else:
                mask = {"y": True, "u": True, "v": True}
            for name, arr in fb.planes.items():
                if mask.get(name, False):
                    planes[name] = (maxv - arr.to(torch.int32)).to(arr.dtype)
        return fb.with_planes(planes)
    return run


def _f_swapuv():
    """vf_swapuv.c analog: swap the U and V planes (pure relabel)."""
    def run(fb):
        if not all(n in fb.planes for n in ("u", "v")):
            raise FilterError("swapuv needs a 3-plane YUV input")
        planes = dict(fb.planes)
        planes["u"], planes["v"] = planes["v"], planes["u"]
        return fb.with_planes(planes)
    return run


def _f_extractplanes(planes="y"):
    """vf_extractplanes.c analog: one component out as a gray stream
    (gray8/gray10/gray16 keyed on source depth, vf_extractplanes.c:
    150-199).  The graph is a single chain, so exactly one plane may be
    requested per filter instance.  Values are copied verbatim."""
    req = _parse_comp_flags(planes, "extractplanes")
    if bin(req).count("1") != 1:
        raise FilterError("extractplanes: exactly one plane per instance "
                          "in a linear graph (run one graph per plane)")

    def run(fb):
        fmt = fb.fmt
        if fmt.is_float:
            raise FilterError("extractplanes: float RGB unsupported")
        if req & ~_comp_avail(fmt):
            raise FilterError("extractplanes: requested plane not available")
        gray = {8: "gray8", 10: "gray10", 16: "gray16"}.get(fmt.bits)
        if gray is None:
            raise FilterError(f"extractplanes: no gray{fmt.bits} output")
        if fmt.is_rgb:
            ch = {0x01: "r", 0x02: "g", 0x04: "b", 0x08: "a"}[req]
            idx = fmt.channel_order.index(ch)
            out = fb.planes["rgb"][..., idx].contiguous()
            return FrameBatch({"y": out}, gray, fb.width, fb.height,
                              fb.colorspace)
        name = {0x10: "y", 0x20: "u", 0x40: "v"}[req]
        out = fb.planes[name]
        return FrameBatch({"y": out}, gray, out.shape[2], out.shape[1],
                          fb.colorspace)
    return run


def _f_monochrome(cb=0.0, cr=0.0, size=1.0, high=0.0):
    """vf_monochrome.c analog: luma-weighted custom color filter, chroma
    cleared to neutral.  Float32 math transcribed from PROCESS()
    (vf_monochrome.c:69-78): the chroma distance filter
    exp(-clip(((b-u)^2+(r-v)^2)*1/size, 0, 1)), the beta=0.6 envelope
    (:46-59), t = tt + (1-tt)*(1-high), output
    lrintf(((1-t)*y + t*ny*y) * max) clipped to depth; chroma planes set
    to 1<<(depth-1) (clear_slice, :158+)."""
    b0, r0 = float(cb), float(cr)
    sz, hi = float(size), float(high)
    if not -1.0 <= b0 <= 1.0 or not -1.0 <= r0 <= 1.0:
        raise FilterError("monochrome: cb/cr must be in [-1, 1]")
    if not 0.1 <= sz <= 10.0:
        raise FilterError("monochrome: size must be in [0.1, 10]")
    if not 0.0 <= hi <= 1.0:
        raise FilterError("monochrome: high must be in [0, 1]")
    bb = _f32(np.float32(b0) * np.float32(0.5))
    rr = _f32(np.float32(r0) * np.float32(0.5))
    size_i = _f32(np.float32(1.0) / np.float32(sz))
    ihigh = _f32(np.float32(1.0) - np.float32(hi))
    beta = _f32(0.6)
    one_m_beta = _f32(np.float32(1.0) - np.float32(0.6))

    def run(fb):
        fmt = fb.fmt
        if fmt.is_rgb or fb.format in ("gray8", "gray10", "gray16",
                                       "nv12", "p010", "p016"):
            raise FilterError("monochrome supports planar YUV only "
                              "(vf_monochrome.c pixel_fmts)")
        depth = fmt.bits
        maxf = float((1 << depth) - 1)
        imax = _f32(np.float32(1.0) / np.float32(maxf))
        y = fb.planes["y"].to(torch.float32) * imax
        u = fb.planes["u"].to(torch.float32) * imax - 0.5
        v = fb.planes["v"].to(torch.float32) * imax - 0.5
        # chroma sampled at x>>subw, y>>subh: nearest repeat to luma, then
        # crop (odd-dim frames have ceil-sized chroma)
        pu = fmt.plane("u")
        if pu.sub_w or pu.sub_h:
            fy, fx = 1 << pu.sub_h, 1 << pu.sub_w
            u = u.repeat_interleave(fy, 1).repeat_interleave(fx, 2)
            v = v.repeat_interleave(fy, 1).repeat_interleave(fx, 2)
            u = u[:, :y.shape[1], :y.shape[2]]
            v = v[:, :y.shape[1], :y.shape[2]]
        dist = ((bb - u) * (bb - u) + (rr - v) * (rr - v)) * size_i
        ny = torch.exp(-torch.clamp(dist, 0.0, 1.0))
        t_lo = torch.abs(y / beta - 1.0)
        env_lo = 1.0 - t_lo * t_lo
        t_hi = (1.0 - y) / one_m_beta
        env_hi = t_hi * t_hi * (3.0 - 2.0 * t_hi)
        tt = torch.where(y < beta, env_lo, env_hi)
        t = tt + (1.0 - tt) * ihigh
        out = (1.0 - t) * y + t * ny * y
        out_i = torch.clamp(torch.round(out * maxf), 0, (1 << depth) - 1)
        dt = fb.planes["y"].dtype
        half = torch.full(fb.planes["u"].shape, 1 << (depth - 1),
                          dtype=torch.int32, device=fb.device).to(dt)
        return fb.with_planes({"y": out_i.to(dt), "u": half, "v": half})
    return run


def _f_exposure(exposure=0.0, black=0.0):
    """vf_exposure.c analog: float-RGB exposure/black-level correction
    — out = (x - black) * scale with scale = 1/(exp2f(-exposure) -
    black), float32 throughout, no output clamp.  gbrpf32 lane only
    (FILTER_PIXFMTS :123); alpha untouched."""
    exposure = float(exposure)
    black = float(black)
    if not -3.0 <= exposure <= 3.0:
        raise FilterError("exposure: exposure out of [-3, 3]")
    if not -1.0 <= black <= 1.0:
        raise FilterError("exposure: black out of [-1, 1]")
    f32 = np.float32
    scale = float(f32(1.0) / f32(np.exp2(f32(-exposure)) - f32(black)))
    blk = _f32(black)

    def run(fb):
        if not fb.fmt.is_rgb or not fb.fmt.is_float:
            raise FilterError("exposure operates on float RGB "
                              "(gbrpf32) — format=gbrpf32le first")
        arr = fb.planes["rgb"]
        rgb = (arr[..., :3] - blk) * scale
        if arr.shape[-1] == 4:
            rgb = torch.cat([rgb, arr[..., 3:]], dim=-1)
        return fb.with_planes({"rgb": rgb})
    return run


def _kelvin2rgb(k: float) -> np.ndarray:
    """vf_colortemperature.c:56-75, float32 math."""
    f32 = np.float32
    kelvin = f32(k) / f32(100.0)
    rgb = np.zeros(3, np.float32)

    def sat(v):
        return f32(min(max(float(v), 0.0), 1.0))

    if kelvin <= 66.0:
        rgb[0] = 1.0
        rgb[1] = sat(f32(0.39008157876901960784) * f32(np.log(kelvin))
                     - f32(0.63184144378862745098))
    else:
        t = f32(max(float(kelvin) - 60.0, 0.0))
        rgb[0] = sat(f32(1.29293618606274509804)
                     * f32(np.power(t, f32(-0.1332047592))))
        rgb[1] = sat(f32(1.12989086089529411765)
                     * f32(np.power(t, f32(-0.0755148492))))
    if kelvin >= 66.0:
        rgb[2] = 1.0
    elif kelvin <= 19.0:
        rgb[2] = 0.0
    else:
        rgb[2] = sat(f32(0.54320678911019607843)
                     * f32(np.log(kelvin - f32(10.0)))
                     - f32(1.19625408914))
    return rgb


def _f_colortemperature(temperature=6500.0, mix=1.0, pl=0.0):
    """vf_colortemperature.c analog: white-balance toward a Kelvin
    temperature — per-pixel float32 scale by the kelvin2rgb color, mix
    lerp, optional lightness preservation via the (max+min) sum ratio
    (PROCESS :82-101), av_clip_uint8 truncating store.  8-bit packed
    RGB."""
    temperature = float(temperature)
    if not 1000.0 <= temperature <= 40000.0:
        raise FilterError("colortemperature: temperature out of "
                          "[1000, 40000]")
    mix = float(mix)
    pl = float(pl)
    if not 0.0 <= mix <= 1.0 or not 0.0 <= pl <= 1.0:
        raise FilterError("colortemperature: mix/pl out of [0, 1]")
    color = _kelvin2rgb(temperature)
    eps = float(np.finfo(np.float32).eps)
    mix32, pl32 = _f32(mix), _f32(pl)

    def run(fb):
        fmt = fb.fmt
        if not fmt.is_rgb or fmt.is_float or fmt.bits != 8:
            raise FilterError("colortemperature: 8-bit RGB frames "
                              "here (convert first)")
        arr = fb.planes["rgb"]
        x = arr[..., :3].to(torch.float32)
        # the C indexes via rgba_map (:111-113): the kelvin color in the
        # frame's channel order
        order = fmt.channel_order or "rgb"
        cvec = [float(color["rgb".index(c)]) for c in order[:3]]
        n = torch.stack([x[..., i] * cvec[i] for i in range(3)], dim=-1)
        n = x + (n - x) * mix32                        # lerpf
        l0 = (x.amax(dim=-1) + x.amin(dim=-1)) + eps
        l1 = (n.amax(dim=-1) + n.amin(dim=-1)) + eps
        scaled = n * (l0 / l1)[..., None]
        out = n + (scaled - n) * pl32
        out = torch.clamp(out.to(torch.int32), 0, 255).to(arr.dtype)
        if arr.shape[-1] == 4:
            out = torch.cat([out, arr[..., 3:]], dim=-1)
        return fb.with_planes({"rgb": out})
    return run


# ---- drawbox (vf_drawbox.c) ------------------------------------------------

def _parse_color_rgba(color):
    """Shared av_parse_color with alpha (geometry.parse_color_rgba):
    names/hex plus `@A` and #RRGGBBAA alpha bytes."""
    try:
        return geometry.parse_color_rgba(color)
    except ValueError as e:
        raise FilterError(str(e)) from None


_SCALEBITS = 10
_ONE_HALF = 1 << (_SCALEBITS - 1)


def _fix(x):
    return int(x * (1 << _SCALEBITS) + 0.5)


def _rgb_to_yuv_ccir(r, g, b):
    """libavutil/colorspace.h RGB_TO_{Y,U,V}_CCIR integer macros
    (studio-swing color for the box, matching drawbox init)."""
    y = (_fix(0.29900 * 219.0 / 255.0) * r + _fix(0.58700 * 219.0 / 255.0) * g
         + _fix(0.11400 * 219.0 / 255.0) * b
         + (_ONE_HALF + (16 << _SCALEBITS))) >> _SCALEBITS
    u = ((-_fix(0.16874 * 224.0 / 255.0) * r
          - _fix(0.33126 * 224.0 / 255.0) * g
          + _fix(0.50000 * 224.0 / 255.0) * b + _ONE_HALF - 1)
         >> _SCALEBITS) + 128
    v = ((_fix(0.50000 * 224.0 / 255.0) * r - _fix(0.41869 * 224.0 / 255.0) * g
          - _fix(0.08131 * 224.0 / 255.0) * b + _ONE_HALF - 1)
         >> _SCALEBITS) + 128
    return y, u, v


def _f_drawbox(x="0", y="0", width="0", w=None, height="0", h=None,
               color="black", c=None, thickness="3", t=None, replace=0):
    """vf_drawbox analog: a colored (or `invert`) box outline/fill.

    x/y/w/h/t are av_expr with drawbox's variable set (dar/hsub/vsub/
    in_w/iw/in_h/ih/sar/x/y/w/h/t and the per-expression `fill` bound,
    vf_drawbox.c:303-341), evaluated up to 5 rounds for cross-references
    with failures fatal only on the last.  w/h <= 0 take the input size.
    The border predicate is pixel_belongs_to_box (:367-371); `t=fill`
    fills.  YUV blends toward the CCIR studio-swing color with
    double->uint8 truncation (host float64 tables), a translucent color
    re-blending each shared chroma sample once per covered luma pixel
    (:148-152); packed RGB blends per channel in float32, alpha untouched
    unless `replace=1`; `color=invert` inverts luma (YUV) or all three
    channels (RGB).  8-bit formats only.  Masks and tables go to the
    device once per geometry."""
    wexpr = w if w is not None else width
    hexpr = h if h is not None else height
    cstr = str(c if c is not None else color).strip().lower()
    texpr = t if t is not None else thickness
    replace = bool(int(replace))
    invert = cstr == "invert"
    if invert:
        rgba = (0, 0, 0, 255)
    else:
        rgba = _parse_color_rgba(cstr)
    cache: Dict = {}

    def box(fb):
        fmt = fb.fmt
        W, H = fb.width, fb.height
        sw = max((p.sub_w for p in fmt.planes), default=0)
        sh = max((p.sub_h for p in fmt.planes), default=0)
        env = {"dar": float(W) / float(H), "sar": 1.0,
               "hsub": float(sw), "vsub": float(sh),
               "in_w": float(W), "iw": float(W),
               "in_h": float(H), "ih": float(H)}
        nan = float("nan")
        env.update(x=nan, y=nan, w=nan, h=nan, t=nan)
        vals = {}
        for rnd in range(6):            # i <= NUM_EXPR_EVALS (5)
            last = rnd == 5
            for key, expr, mx in (("x", x, W), ("y", y, H),
                                  ("w", wexpr, W - vals.get("x", 0)),
                                  ("h", hexpr, H - vals.get("y", 0)),
                                  ("t", texpr, 2**31 - 1)):
                env["fill"] = float(mx)
                try:
                    res = float(compile_expr(str(expr))(env))
                except ValueError:
                    if last:
                        raise
                    continue
                env[key] = res
                if not math.isnan(res):
                    vals[key] = int(res)
        if len(vals) < 5:
            raise FilterError("drawbox: x/y/w/h/t evaluated to nan")
        bx, by, bt = vals["x"], vals["y"], vals["t"]
        bw = vals["w"] if vals["w"] > 0 else W
        bh = vals["h"] if vals["h"] > 0 else H
        if vals["w"] < 0 or vals["h"] < 0:
            raise FilterError("drawbox: negative box size")
        xs = np.arange(W)
        ys = np.arange(H)
        inbox = ((ys >= max(by, 0)) & (ys < min(by + bh, H)))[:, None] & \
                ((xs >= max(bx, 0)) & (xs < min(bx + bw, W)))[None, :]
        border = ((ys - by < bt) | (by + bh - 1 - ys < bt))[:, None] | \
                 ((xs - bx < bt) | (bx + bw - 1 - xs < bt))[None, :]
        return inbox & border, sw, sh

    def tables(fb):
        """The box mask and blend tables of this geometry, on the
        batch's device (None when the box covers nothing)."""
        mask, sw, sh = box(fb)
        if not mask.any():
            return None
        dev = fb.device
        W, H = fb.width, fb.height
        tab = {"mask": torch.as_tensor(mask, device=dev)[None]}
        if fb.fmt.is_rgb:
            a = np.float32(rgba[3] / 255.0)
            idxf = np.arange(256, dtype=np.float32)
            cv = {"r": rgba[0], "g": rgba[1], "b": rgba[2]}
            tab["rgb"] = {
                ch: torch.as_tensor(((np.float32(1.0) - a) * idxf
                                     + a * np.float32(cv[ch]))
                                    .astype(np.uint8), device=dev)
                for ch in "rgb"}
            return tab
        ycol, ucol, vcol = _rgb_to_yuv_ccir(*rgba[:3])
        alpha = rgba[3] / 255.0
        idx = np.arange(256, dtype=np.float64)

        def lut(col):
            return torch.as_tensor(np.trunc((1.0 - alpha) * idx
                                            + alpha * col).astype(np.uint8),
                                   device=dev)
        tab["y"] = lut(ycol)
        # chroma: one blend PER covered luma pixel on the shared sample —
        # coverage counts drive iterated truncating blends
        counts = mask.astype(np.int32)
        if sw or sh:
            counts = counts.reshape(H >> sh, 1 << sh,
                                    W >> sw, 1 << sw).sum((1, 3))
        steps = 1 if alpha >= 1.0 else int(counts.max())
        tab["steps"] = [torch.as_tensor(counts > i, device=dev)[None]
                        for i in range(steps)]
        tab["u"], tab["v"] = lut(ucol), lut(vcol)
        return tab

    def run(fb):
        fmt = fb.fmt
        if fmt.bits != 8 or fmt.is_float:
            raise FilterError("drawbox supports 8-bit formats "
                              "(vf_drawbox.c pix_fmts)")
        key = (fb.format, fb.width, fb.height, str(fb.device))
        if key not in cache:
            cache[key] = tables(fb)
        tab = cache[key]
        if tab is None:
            return fb
        m = tab["mask"]
        planes = dict(fb.planes)
        if fmt.is_rgb:
            order = fmt.channel_order
            arr = fb.planes["rgb"]
            if invert:
                new = {ch: torch.where(m, 255 - arr[..., order.index(ch)],
                                       arr[..., order.index(ch)])
                       for ch in "rgb"}
                planes["rgb"] = set_channels(arr, order, new)
            elif replace and "a" in order:
                cv = {"r": rgba[0], "g": rgba[1], "b": rgba[2],
                      "a": rgba[3]}
                col = torch.tensor([cv[ch] for ch in order],
                                   dtype=arr.dtype, device=arr.device)
                planes["rgb"] = torch.where(m[..., None], col, arr)
            else:
                new = {}
                for ch in "rgb":
                    src = arr[..., order.index(ch)]
                    new[ch] = torch.where(m, apply_lut(src, tab["rgb"][ch]),
                                          src)
                planes["rgb"] = set_channels(arr, order, new)
        else:
            yarr = fb.planes["y"]
            if invert:
                planes["y"] = torch.where(m, 255 - yarr, yarr)
            else:
                planes["y"] = torch.where(m, apply_lut(yarr, tab["y"]), yarr)
                for name in ("u", "v"):
                    if name not in fb.planes:
                        continue
                    arr = fb.planes[name]
                    for mi in tab["steps"]:
                        arr = torch.where(mi, apply_lut(arr, tab[name]), arr)
                    planes[name] = arr
        return fb.with_planes(planes)
    return run


def _f_delogo(x="-1", y="-1", w="-1", h="-1", show=0):
    """vf_delogo.c analog: interpolate the logo region away from the
    four band-expanded edges (ops/delogo.py has the kernel math).

    x/y/w/h are av_expr options evaluated once with zeroed variables,
    as init() (vf_delogo.c:237-247).  The filter_frame auto-clamp for
    regions touching the frame edge and the band=1 expansion are applied
    per vf_delogo.c:310-332; chroma planes get the rounded-down offsets
    with lost bits injected into the size and band>>min(hsub,vsub)
    (:352-366).  SAR is assumed square (:347-350).  8-bit planar YUV /
    gray only (pix_fmts :230-236)."""
    env = {"n": 0.0, "t": 0.0}
    vals = {}
    for name, expr in (("x", x), ("y", y), ("w", w), ("h", h)):
        try:
            vals[name] = int(float(compile_expr(str(expr))(env)))
        except ValueError as e:
            raise FilterError(f"delogo: bad expression for {name}: {e}")
        if vals[name] == -1:
            raise FilterError(f"delogo: option {name} was not set")
    show = bool(int(show))

    def run(fb):
        from ..ops.delogo import apply_delogo_plane
        fmt = fb.fmt
        if fmt.is_rgb or fmt.is_float or fmt.bits != 8:
            raise FilterError("delogo supports 8-bit planar YUV/gray "
                              "(vf_delogo.c pix_fmts)")
        W, H = fb.width, fb.height
        band = 1
        # config_props check on the init-expanded region (:241-247
        # expansion + :279-289 check): an error, not an auto-clamp
        cx, cy = vals["x"] - band, vals["y"] - band
        cw, ch2 = vals["w"] + 2 * band, vals["h"] + 2 * band
        if (cx + (band - 1) < 0 or cx + cw - (band * 2 - 2) > W
                or cy + (band - 1) < 0
                or cy + ch2 - (band * 2 - 2) > H):
            raise FilterError("delogo: logo area is outside of the frame")
        sx, sy, sw_, sh_ = vals["x"], vals["y"], vals["w"], vals["h"]
        # filter_frame edge auto-clamp (:314-321)
        if sx + (band - 1) <= 0:
            sx = 1 + band
        if sy + (band - 1) <= 0:
            sy = 1 + band
        if sx + sw_ - (band * 2 - 2) > W:
            sw_ = W - sx - (band * 2 - 2)
        if sy + sh_ - (band * 2 - 2) > H:
            sh_ = H - sy - (band * 2 - 2)
        if (sx + (band - 1) < 0 or sx + sw_ - (band * 2 - 2) > W
                or sy + (band - 1) < 0
                or sy + sh_ - (band * 2 - 2) > H):
            raise FilterError("delogo: logo area is outside of the frame")
        sw_ += band * 2
        sh_ += band * 2
        sx -= band
        sy -= band
        out = {}
        for name, plane in fb.planes.items():
            ph, pw = plane.shape[1], plane.shape[2]
            hsub = 1 if name in ("u", "v") and pw < W else 0
            vsub = 1 if name in ("u", "v") and ph < H else 0
            out[name] = apply_delogo_plane(
                plane, pw, ph, 1, 1, sx >> hsub, sy >> vsub,
                (sw_ + (sx & ((1 << hsub) - 1)) + (1 << hsub) - 1)
                >> hsub,
                (sh_ + (sy & ((1 << vsub) - 1)) + (1 << vsub) - 1)
                >> vsub,
                band >> min(hsub, vsub), show)
        return fb.with_planes(out)
    return run


class NoiseFilter:
    """vf_noise.c analog (ops/noise.py): film-grain synthesis with the
    exact AVLFG streams, noise-table math and per-frame temporal
    rand_shift regeneration.  Stateful across batches (the LFG draw
    sequence is stream-order), hence a stream filter.

    Options: all_seed/all_strength|alls/all_flags|allf seed every
    component; c0..c3 variants override (c0_seed, c0s, c0f...).  Flags
    are any of a/p/t/u joined with '+'.  NOISE_AVERAGED ('a') is
    rejected (vf_noise.c:214 writes out of bounds).  8-bit planar
    formats (the query_formats depth check)."""

    stream_filter = True
    _FLAG = {"a": 8, "p": 16, "t": 4, "u": 2}

    def __init__(self, **opts):
        import re as _re
        seeds = [-1] * 5           # index 4 = "all"
        strengths = [0] * 5
        flags = [0] * 5

        def slot(k):
            m = _re.match(r"(all|c[0-3])(_seed|_strength|s|_flags|f)$", k)
            if not m:
                raise FilterError(f"noise: unknown option {k!r}")
            i = 4 if m.group(1) == "all" else int(m.group(1)[1])
            return i, m.group(2)

        for k, v in opts.items():
            i, kind = slot(k)
            if kind == "_seed":
                seeds[i] = int(v)
            elif kind in ("_strength", "s"):
                strengths[i] = int(v)
                if not 0 <= strengths[i] <= 100:
                    raise FilterError("noise: strength out of [0, 100]")
            else:
                fl = 0
                for tok in str(v).split("+"):
                    tok = tok.strip()
                    if tok not in self._FLAG:
                        raise FilterError(f"noise: unknown flag {tok!r}")
                    fl |= self._FLAG[tok]
                flags[i] = fl
        self.params = []
        for c in range(4):
            # init() merge (vf_noise.c:283-292): the seed is ALWAYS
            # all_seed-or-123457; all_strength/all_flags WIN over
            # per-component values when set
            seed = seeds[4] if seeds[4] >= 0 else 123457
            strength = strengths[4] if strengths[4] else strengths[c]
            fl = flags[4] if flags[4] else flags[c]
            if strength and (fl & 8):
                raise FilterError(
                    "noise: averaged mode ('a') is not supported — the "
                    "reference implementation's prev_shift rotation "
                    "writes out of bounds (vf_noise.c:214)")
            self.params.append({"seed": seed, "strength": strength,
                                "flags": fl, "tab": None, "lfg": None,
                                "shift": None})
        for c, p in enumerate(self.params):
            if p["strength"]:
                p["tab"], p["lfg"] = noise.build_noise(
                    p["strength"], p["flags"], p["seed"], c)
        self._dev: Dict = {}

    def process_batch(self, fb, meta):
        fmt = fb.fmt
        if fmt.bits != 8 or fmt.is_float or "rgb" in fb.planes:
            raise FilterError("noise: 8-bit planar formats only")
        n = fb.batch
        order = [nm for nm in ("y", "u", "v", "a") if nm in fb.planes]
        # per-frame rand_shift draws, comps in order per frame like
        # filter_frame (:261-271)
        per_frame = []
        for _f in range(n):
            row = {}
            for c, p in enumerate(self.params):
                if not p["strength"]:
                    continue
                if p["shift"] is None or (p["flags"] & 4):
                    p["shift"] = (p["lfg"].get_block(noise.MAX_RES)
                                  .astype(np.int64)
                                  & (noise.MAX_SHIFT - 1)).astype(np.int32)
                row[c] = p["shift"]
            per_frame.append(row)
        out = {}
        for ci, nm in enumerate(order):
            p = self.params[ci]
            if not p["strength"]:
                out[nm] = fb.planes[nm]
                continue
            tab = _cached(self._dev, (ci, str(fb.device)),
                          lambda: torch.as_tensor(p["tab"].astype(np.int32),
                                                  device=fb.device))
            shifts = np.stack([per_frame[f][ci] for f in range(n)])
            out[nm] = noise.apply_noise_plane(fb.planes[nm], tab, shifts)
        return fb.with_planes(out), meta

    def flush(self):
        return None


class VignetteFilter:
    """vf_vignette.c analog (ops/vignette.py): natural cos^4 lens
    falloff (or its reverse), SAR-aware aspect scaling, per-pixel LCG
    dither with state persisting across frames (jumped in closed form on
    the device; only the per-frame 32-bit seeds go there per batch), and
    the eval=init/frame expression modes (init auto-promotes to frame
    when angle/x0/y0 evaluate NaN, i.e. reference n/t/pts —
    vf_vignette.c:166-169).  8-bit planar YUV / gray."""

    stream_filter = True

    def __init__(self, angle="PI/5", a=None, x0="w/2", y0="h/2", mode=0,
                 eval="init", dither=1, aspect="1"):
        self.angle_expr = str(a if a is not None else angle)
        self.x0_expr, self.y0_expr = str(x0), str(y0)
        modes = {"forward": 0, "backward": 1, "0": 0, "1": 1}
        if str(mode) not in modes:
            raise FilterError(f"vignette: bad mode {mode!r}")
        self.backward = bool(modes[str(mode)])
        if str(eval) not in ("init", "frame"):
            raise FilterError(f"vignette: bad eval mode {eval!r}")
        self.eval_frame = str(eval) == "frame"
        self.do_dither = bool(int(dither))
        asp = str(aspect)
        if "/" in asp:
            num, den = asp.split("/", 1)
            self.aspect = float(num) / float(den)
        else:
            self.aspect = float(asp)
        if self.aspect < 0:
            raise FilterError("vignette: aspect must be >= 0")
        for e in (self.angle_expr, self.x0_expr, self.y0_expr):
            compile_expr(str(e))        # syntax-check at build
        self._dither_state = 0          # uint32_t context field, zeroed
        self._frame_no = 0
        self._dev_fmap: Dict = {}
        self._dev_ac: Dict = {}

    def _env(self, W, H, n=float("nan"), t=float("nan")):
        return {"w": float(W), "h": float(H), "n": n, "t": t,
                "pts": float("nan"), "r": float("nan"),
                "tb": float("nan")}

    def _params(self, W, H, n, t):
        env = self._env(W, H, n, t)
        ang = float(compile_expr(self.angle_expr)(env))
        px0 = float(compile_expr(self.x0_expr)(env))
        py0 = float(compile_expr(self.y0_expr)(env))
        had_nan = any(math.isnan(v) for v in (ang, px0, py0))
        if had_nan and not self.eval_frame:
            self.eval_frame = True      # init -> frame auto-promotion
            return None
        # av_clipf(NaN) returns NaN: the C proceeds with NaN geometry
        if not math.isnan(ang):
            ang = min(max(ang, 0.0), math.pi / 2)
        # sar assumed 1:1 (config_props fallback): yscale = aspect
        return ang, px0, py0, 1.0, self.aspect

    def _jump_tables(self, total, device):
        key = (total, str(device))
        t = self._dev_ac.get(key)
        if t is None:
            A, C = vignette.lcg_jump_tables(total)
            t = (torch.as_tensor(A.astype(np.int64), device=device),
                 torch.as_tensor(C.astype(np.int64), device=device))
            self._dev_ac = {key: t}     # one geometry resident
        return t

    def _fmap(self, W, H, params, device):
        key = (W, H, params, str(device))
        t = self._dev_fmap.get(key)
        if t is None:
            ang, px0, py0, xs, ys = params
            t = torch.as_tensor(vignette.natural_fmap(
                W, H, px0, py0, xs, ys, ang, self.backward), device=device)
            self._dev_fmap = {key: t}   # one parameter set resident
        return t

    def process_batch(self, fb, meta):
        fmt = fb.fmt
        if fmt.bits != 8 or fmt.is_float or "rgb" in fb.planes:
            raise FilterError("vignette: 8-bit planar YUV/gray only")
        W, H = fb.width, fb.height
        dev = fb.device
        names = [nm for nm in ("y", "u", "v", "a") if nm in fb.planes]
        planes = [fb.planes[nm] for nm in names]
        subs, offsets, total = [], [], 0
        for pl in planes:
            ph, pw = pl.shape[1], pl.shape[2]
            subs.append((1 if pw < W else 0, 1 if ph < H else 0))
            offsets.append(total)
            total += ph * pw
        n = fb.batch
        times = meta.get("times")
        A, C = self._jump_tables(total, dev)
        params = None
        if not self.eval_frame:
            params = self._params(W, H, float("nan"), float("nan"))
        if params is not None:
            fmap = self._fmap(W, H, params, dev)
            seeds = np.empty(n, np.int64)
            s = self._dither_state
            for i in range(n):
                seeds[i] = s
                s = vignette.lcg_after(s, total) if self.do_dither else s
            self._dither_state = s
            outs = vignette.apply_vignette(
                planes, fmap, A, C, torch.as_tensor(seeds, device=dev),
                offsets, self.do_dither, subs)
        else:
            # frame mode: per-frame expressions -> per-frame fmap
            outs_per = [[] for _ in planes]
            for i in range(n):
                t = (float(times[i]) if times is not None
                     else float("nan"))
                pr = self._params(W, H, float(self._frame_no + i), t)
                fmap = self._fmap(W, H, pr, dev)
                seed = self._dither_state
                if self.do_dither:
                    self._dither_state = vignette.lcg_after(
                        self._dither_state, total)
                fouts = vignette.apply_vignette(
                    [p[i:i + 1] for p in planes], fmap, A, C,
                    torch.tensor([seed], dtype=torch.int64, device=dev),
                    offsets, self.do_dither, subs)
                for k, o in enumerate(fouts):
                    outs_per[k].append(o)
            outs = [torch.cat(o) for o in outs_per]
        self._frame_no += n
        return fb.with_planes(dict(zip(names, outs))), meta

    def flush(self):
        return None


class DebandFilter:
    """vf_deband.c analog (ops/deband.py has the kernels): per-plane
    thresholds 1thr..4thr in [0.00003, 0.5] (digit-leading AVOption
    names, hence **opts), range/r sampling distance, direction/d in
    [-2pi, 2pi], blur/b average-vs-all-four mode, coupling/c (444/RGB
    only).  thr[p] = (int)(maxval * threshold[p]) like config_input.
    A stream filter, as in the JAX package, whose reference index maps
    are built once per geometry and kept on the device."""

    stream_filter = True

    def __init__(self, **opts):
        thr = [0.02] * 4
        self.rng_ = 16
        self.direction = 2.0 * math.pi
        self.blur = True
        self.coupling = False
        for k, v in opts.items():
            if k in ("1thr", "2thr", "3thr", "4thr"):
                f = float(v)
                if not 0.00003 <= f <= 0.5:
                    raise FilterError(
                        f"deband: {k}={v} out of [3e-05, 0.5]")
                thr[int(k[0]) - 1] = f
            elif k in ("range", "r"):
                self.rng_ = int(v)
            elif k in ("direction", "d"):
                self.direction = float(v)
                if not -2 * math.pi <= self.direction <= 2 * math.pi:
                    raise FilterError(
                        "deband: direction out of [-2pi, 2pi]")
            elif k in ("blur", "b"):
                self.blur = bool(int(v))
            elif k in ("coupling", "c"):
                self.coupling = bool(int(v))
            else:
                raise FilterError(f"deband: unknown option {k!r}")
        self.thr = thr

    def _index(self, W, H, ph, pw, device):
        key = (W, H, self.rng_, self.direction)
        xp, yp = deband.offset_table(W, H, self.rng_, self.direction)
        return deband.reference_index(key, xp, yp, ph, pw, device)

    def process_batch(self, fb, meta):
        fmt = fb.fmt
        if fmt.is_float or fmt.is_rgb and "rgb" in fb.planes:
            raise FilterError("deband operates on planar integer "
                              "YUV/gray frames here")
        W, H = fb.width, fb.height
        order = ["y", "u", "v", "a"]
        names = [nm for nm in order if nm in fb.planes]
        maxv = (1 << fmt.bits) - 1
        thrs = {nm: int(maxv * self.thr[i])
                for i, nm in enumerate(names)}
        if self.coupling:
            shapes = {fb.planes[nm].shape for nm in names}
            if len(shapes) != 1:
                raise FilterError("deband: coupling needs 4:4:4 input "
                                  "(cpix_fmts, vf_deband.c:102-113)")
            index = self._index(W, H, H, W, fb.device)
            outs = deband.deband_coupled([fb.planes[nm] for nm in names],
                                         index, [thrs[nm] for nm in names],
                                         self.blur)
            return fb.with_planes(dict(zip(names, outs))), meta
        out = {}
        for nm in names:
            pl = fb.planes[nm]
            # chroma indexes the LUMA-width table with its own coords
            index = self._index(W, H, pl.shape[1], pl.shape[2], fb.device)
            out[nm] = deband.deband_plane(pl, index, thrs[nm], self.blur)
        return fb.with_planes(out), meta

    def flush(self):
        return None


class Hqdn3dFilter:
    """ffmpeg hqdn3d: spatio-temporal denoise (ops/hqdn3d.py holds the
    math).  A stream filter because the temporal IIR carries the
    previous FILTERED frame across batches; frames an upstream select
    dropped are excluded from both filtering and state (dead lanes pass
    through untouched and are discarded downstream)."""

    stream_filter = True

    def __init__(self, luma_spatial=0, chroma_spatial=0, luma_tmp=0,
                 chroma_tmp=0):
        try:
            self.core = hqdn3d.HQDN3D(
                float(luma_spatial), float(chroma_spatial),
                float(luma_tmp), float(chroma_tmp))
        except ValueError as e:
            raise FilterError(str(e)) from None

    def process_batch(self, fb: FrameBatch, meta):
        keep = meta.get("keep")
        if keep is None or bool(np.all(keep)):
            return self.core(fb), meta
        idx = np.nonzero(keep)[0]
        if len(idx) == 0:
            return fb, meta
        den = self.core(fb.with_planes(_take_frames(fb.planes, idx)))
        sel = torch.as_tensor(idx, dtype=torch.int64, device=fb.device)
        planes = {k: same_bits(lambda p, d: p.index_copy(0, sel, d),
                               fb.planes[k], den.planes[k])
                  for k in fb.planes}
        return fb.with_planes(planes), meta


class HueFilter:
    """ffmpeg hue (vf_hue.c): rotate chroma by a hue angle, scale by
    saturation, shift luma by brightness — each an av_expr re-evaluated
    per frame over n/pts/t/r/tb (vf_hue.c:342-414).

    Chroma math is the reference's exact 16.16 rotation
    (create_chrominance_lut):
        u' = (cos*(u-mid) - sin*(v-mid) + (1<<15) + (mid<<16)) >> 16
    with sin/cos = lrint(sin(hue)*65536*saturation), mid 128/512, clipped
    to uint8/uintp2(10); 10-bit inputs clip to 10 bits first
    (apply_lut10).  Luma applies i + brightness*25.5 (102.4 at 10-bit)
    with double->int truncation through host-built tables kept on the
    device.  Frames are grouped by evaluated (sin, cos, brightness), so a
    constant expression costs one pass per batch."""

    stream_filter = True

    def __init__(self, h=None, s="1", H=None, b="0"):
        self.h_expr = None if h is None else compile_expr(str(h))
        self.H_expr = None if H is None else compile_expr(str(H))
        self.s_expr = compile_expr(str(s))
        self.b_expr = compile_expr(str(b))
        self.n = 0
        self._luma_luts: Dict = {}

    def _params(self, env):
        # HueContext stores hue/saturation/brightness in FLOAT fields:
        # every evaluated double rounds through float32 before the lrint
        # / LUT build (vf_hue.c:66-72)
        f32 = lambda v: float(np.float32(v))
        sat = min(max(f32(self.s_expr(env)), -10.0), 10.0)
        bright = min(max(f32(self.b_expr(env)), -10.0), 10.0)
        if self.H_expr is not None:
            hue = f32(self.H_expr(env))
        elif self.h_expr is not None:
            hue = f32(f32(self.h_expr(env)) * math.pi / 180.0)
        else:
            hue = 0.0
        hs = int(np.rint(math.sin(hue) * 65536.0 * sat))   # lrint
        hc = int(np.rint(math.cos(hue) * 65536.0 * sat))
        return hs, hc, bright

    def _luma_lut(self, bright, bits, device):
        def make():
            if bits > 8:
                i = np.arange(65536, dtype=np.float64)
                lut = np.clip(np.trunc(i + bright * 102.4),
                              0, 1023).astype(np.uint16)
            else:
                i = np.arange(256, dtype=np.float64)
                lut = np.clip(np.trunc(i + bright * 25.5),
                              0, 255).astype(np.uint8)
            return torch.as_tensor(lut, device=device)
        return _cached(self._luma_luts, (bright, bits, str(device)), make)

    def process_batch(self, fb: FrameBatch, meta):
        fmt = fb.fmt
        if fmt.is_rgb or fmt.is_float or fmt.name in ("p010", "p016") or \
                "u" not in fb.planes:
            raise FilterError("hue operates on planar YUV "
                              "(vf_hue.c pix_fmts); convert first")
        pts = meta.get("pts")
        times = meta.get("times")
        keep = meta.get("keep")
        nan = float("nan")
        groups: Dict = {}
        for i in range(fb.batch):
            if keep is not None and not keep[i]:
                continue
            env = {"n": float(self.n), "r": nan, "tb": nan,
                   "pts": nan if pts is None or int(pts[i]) == _AV_NOPTS
                   else float(int(pts[i])),
                   "t": nan if times is None else float(times[i])}
            groups.setdefault(self._params(env), []).append(i)
            self.n += 1
        bits = fmt.bits
        mid = 512 if bits > 8 else 128
        cmax = 1023 if bits > 8 else 255
        planes = dict(fb.planes)
        dt = fb.planes["u"].dtype
        for (hs, hc, bright), idxs in groups.items():
            if hs == 0 and hc == 65536 and bright == 0.0:
                continue                        # exact identity
            msk = np.zeros(fb.batch, bool)
            msk[idxs] = True
            m = torch.as_tensor(msk, device=fb.device)[:, None, None]
            u = fb.planes["u"].to(torch.int32)
            v = fb.planes["v"].to(torch.int32)
            if bits > 8:                        # apply_lut10 input clip
                u = torch.clamp(u, 0, 1023)
                v = torch.clamp(v, 0, 1023)
            ur, vr = u - mid, v - mid
            add = (1 << 15) + (mid << 16)
            nu = torch.clamp((hc * ur - hs * vr + add) >> 16, 0, cmax)
            nv = torch.clamp((hs * ur + hc * vr + add) >> 16, 0, cmax)
            planes["u"] = torch.where(m, nu, planes["u"].to(torch.int32)
                                      ).to(dt)
            planes["v"] = torch.where(m, nv, planes["v"].to(torch.int32)
                                      ).to(dt)
            if bright != 0.0:
                y = planes["y"]
                lut = apply_lut(y, self._luma_lut(bright, bits, fb.device))
                planes["y"] = same_bits(lambda a, b: torch.where(m, a, b),
                                        lut, y)
        return fb.with_planes(planes), meta


# ---- filters of later port slices ------------------------------------------

# every other JAX filter name, with the ROADMAP.md queue 1 item that ports
# it: the parser accepts the name, building the filter raises
_PART_3 = "slice 3, part 3 (the temporal and structural filters)"
_LATER = {
    **{name: _PART_3 for name in (
        "blend", "detelecine", "doubleweave", "fade", "framerate", "il",
        "loop", "psnr", "reverse", "separatefields", "shuffleframes",
        "ssim", "tblend", "telecine", "tpad", "weave", "xfade",
        "zoompan")},
    "tensorrt": "item 6 (in-graph inference, slice 4)",
    "infer": "item 6 (in-graph inference, slice 4)",
    "overlay": "item 7 (stills, slice 5: its still and second-stream "
               "inputs need av/jpeg.py and the PNG decoder)",
    "overlay_cuda": "item 7 (stills, slice 5: its still and second-stream "
                    "inputs need av/jpeg.py and the PNG decoder)",
}


def _later(name: str, item: str) -> Callable:
    def build(**_kw):
        raise NotImplementedError(
            f"filter {name!r} is not ported to gmat_tpu_torch yet: it "
            f"comes with ROADMAP.md queue 1, {item}")
    return build


FILTERS: Dict[str, Callable] = {
    "crop": _f_crop,
    "crop_nvcv": _f_crop,
    "rotate": _f_rotate,
    "rotate_nvcv": _f_rotate,
    "pad": _f_pad,
    "eq": _f_eq,
    "unsharp": _f_unsharp,
    "lut": _make_lut_filter("all"),
    "lutyuv": _make_lut_filter("yuv"),
    "lutrgb": _make_lut_filter("rgb"),
    "trim": TrimFilter,
    "setpts": SetptsFilter,
    "flip": _f_flip,
    "flip_nvcv": _f_flip,
    "hflip": _f_hflip,
    "vflip": _f_vflip,
    "transpose": _f_transpose,
    "transpose_npp": lambda **kw: _f_transpose(_npp=True, **kw),
    "smooth": _f_smooth,
    "smooth_nvcv": _f_smooth,
    "scale": _f_scale,
    "scale_cuda": _f_scale,
    "scale_npp": _f_scale,
    "format": _f_format,
    "format_cuda": _f_format,
    "null": _f_null,
    "copy": _f_null,
    # hwupload/hwdownload are no-ops: batches stay on the card for the
    # whole graph
    "hwupload": _f_null,
    "hwupload_cuda": _f_null,
    "hwdownload": _f_null,
    "chromakey": _f_chromakey,
    "chromakey_cuda": _f_chromakey,
    "yadif": YadifFilter,
    "bwdif": BwdifFilter,
    "yadif_cuda": YadifFilter,
    "select": SelectFilter,
    "select_cuda": SelectFilter,
    "select_gpu": SelectFilter,
    "fps": FpsFilter,
    "thumbnail": ThumbnailFilter,
    "thumbnail_cuda": ThumbnailFilter,
    "lut3d": _f_lut3d,
    "lut1d": _f_lut1d,
    "colorchannelmixer": _f_colorchannelmixer,
    "colorbalance": _f_colorbalance,
    "curves": _f_curves,
    "exposure": _f_exposure,
    "colortemperature": _f_colortemperature,
    "hue": HueFilter,
    "monochrome": _f_monochrome,
    "negate": _f_negate,
    "swapuv": _f_swapuv,
    "extractplanes": _f_extractplanes,
    "alphaextract": lambda: _f_extractplanes(planes="a"),
    "drawbox": _f_drawbox,
    "boxblur": _f_boxblur,
    "gblur": _f_gblur,
    "sharpen_npp": _f_sharpen_npp,
    "hqdn3d": Hqdn3dFilter,
    "deband": DebandFilter,
    "noise": NoiseFilter,
    "vignette": VignetteFilter,
    "delogo": _f_delogo,
    **{name: _later(name, item) for name, item in _LATER.items()},
}

from . import hdr  # noqa: E402,F401 — registers tonemap/zscale into FILTERS
