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
  separatefields / weave / doubleweave / telecine / detelecine / il /
  shuffleframes / reverse / tpad / loop / framerate / fade / zoompan
                                                <- temporal and structural
  blend / tblend / xfade / psnr / ssim          <- two inputs (video=FILE)
  overlay (+overlay_cuda)                       <- video=FILE or a still
  infer (+tensorrt)                             <- filters/infer.py models

Each filter is a factory: FILTERS[name](**options) -> callable.  Pure
filters map FrameBatch -> FrameBatch on the batch's device; keep-mask
filters (`batch_control`) and stream filters (`stream_filter`) keep the
JAX package's host logic and are run by filters/graph.FilterGraph.
Host tables (LUTs, masks, index maps) are built once and kept on the
batch's device.  All 87 JAX filter names are in FILTERS.
"""
from __future__ import annotations

import math
from fractions import Fraction
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


def _compact_alive(fb: FrameBatch, meta):
    """Drop upstream-dropped (keep=False) and batch-pad frames before a
    stream filter consumes the batch — ffmpeg chain semantics: a frame
    dropped by select/fps never reaches the next filter."""
    alive = np.asarray(meta["keep"]).copy()
    if meta.get("pad") is not None:
        alive &= ~np.asarray(meta["pad"])
    idx = np.nonzero(alive)[0]
    if len(idx) < fb.batch:
        fb = fb.with_planes(_take_frames(fb.planes, idx))
        meta = _meta_take(meta, idx)
    return fb, meta


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
        fb, meta = _compact_alive(fb, meta)
        v = fb.batch
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


# ---- filters/builtin.py part 3: temporal and structural filters ----------

def _av_rescale(a: int, b: int, c: int) -> int:
    """av_rescale with AV_ROUND_NEAR_INF (round half away from zero)."""
    if a >= 0:
        return (a * b + c // 2) // c
    return -((-a * b + c // 2) // c)


def _cat_rows(rows) -> dict:
    """Per-frame plane dicts (each (1, ...) or (k, ...)) -> one batch."""
    return {nm: _cat_frames(*[r[nm] for r in rows]) for nm in rows[0]}


def _row_meta(metas, k: int, pts=None, times=None) -> dict:
    """Per-frame meta rows -> one batch's meta: pts (and times, where the
    track exists) replaced, every frame kept, none padding."""
    out = metas[0]
    for m in metas[1:]:
        out = _meta_concat(out, m)
    if pts is not None:
        out["pts"] = np.asarray(pts, np.int64)
    if times is not None and out.get("times") is not None:
        out["times"] = np.asarray(times, np.asarray(out["times"]).dtype)
    out["keep"] = np.ones(k, bool)
    if out.get("pad") is not None:
        out["pad"] = np.zeros(k, bool)
    return out


def _repeat_frames(p: torch.Tensor, k: int) -> torch.Tensor:
    """A (1, ...) plane repeated into k frames."""
    return same_bits(lambda x: x.expand((k,) + tuple(x.shape[1:])).clone(),
                     p)


def _dur_seconds(v) -> float:
    """'Nms', 'Ns' or a bare number of seconds."""
    s = str(v).strip()
    if s.endswith("ms"):
        return float(s[:-2]) / 1000.0
    if s.endswith("s"):
        return float(s[:-1])
    return float(s)


def _frame_rate(v) -> "Fraction":
    f = str(v)
    if "/" in f:
        num, den = f.split("/", 1)
        return Fraction(int(num), int(den))
    return Fraction(f).limit_denominator(100000)


def _link_tb(link, src_fps) -> "Fraction":
    """The link's time base, or 1/src_fps (frame-index pts)."""
    tb = (link or {}).get("time_base")
    if tb:
        return Fraction(int(tb[0]), int(tb[1]))
    return 1 / Fraction(str(src_fps)).limit_denominator(100000)


def _second_stream(path: str, vw: int, vh: int, what: str):
    """Frames of a second input (`video=FILE`), one host plane dict per
    frame: decoding is host work, and each frame goes to the main
    stream's device where it is used."""
    from ..av.ingest import decode_stream
    if (path.lower().endswith((".yuv", ".nv12", ".iyuv", ".raw"))
            and not (vw and vh)):
        raise FilterError(f"headerless raw {what} needs vw=W:vh=H")
    src = decode_stream(path, batch=8, width=vw, height=vh, device="cpu")
    try:
        for bfb, _bpts, bvalid in src:
            host = {k: v.numpy() for k, v in bfb.planes.items()}
            for i in range(int(bvalid)):
                yield {k: host[k][i].copy() for k in host}
    finally:
        src.close()


class SeparateFieldsFilter:
    """vf_separatefields.c analog: split each frame into its two
    fields (half height, double rate).  Field order follows each
    frame's top_field_first flag (meta 'interlaced' bit1): the FIRST
    emitted field is the top rows when tff else the bottom rows
    (extract_field with type=!tff, :58-66).  pts semantics kept: first
    field = 2*pts, second field = pts + next frame's pts, flushed last
    field extrapolates by one step (flush_frame :105-118 with the EOF
    status pts)."""

    stream_filter = True
    fps_mul = 2

    def __init__(self):
        self._second = None      # (planes, meta row, pts, tff)
        self._step = None
        self._geom = None

    @staticmethod
    def _field(planes, tff, first):
        """Rows of the first/second field: first field starts at row 0
        when tff (type=0) else row 1; the second field is the other."""
        start = (0 if tff else 1) if first else (1 if tff else 0)
        return {nm: v[:, start::2] for nm, v in planes.items()}

    def process_batch(self, fb: FrameBatch, meta):
        if fb.height & 1:
            raise FilterError("separatefields: height must be even")
        fb, meta = _compact_alive(fb, meta)
        n = fb.batch
        pts = meta.get("pts")
        pts = (np.asarray(pts, np.int64) if pts is not None
               else np.arange(n, dtype=np.int64))
        il = meta.get("interlaced")
        # AVFrame.top_field_first defaults to 0: unflagged streams
        # separate bottom-field-first (extract_field type = !tff = 1)
        tffs = (((np.asarray(il, np.int64) >> 1) & 1).astype(bool)
                if il is not None else np.zeros(n, bool))
        if self._step is None and n > 1:
            self._step = int(np.median(np.diff(pts)))
        if n:
            self._geom = (fb.format, fb.width, fb.height // 2,
                          fb.colorspace)
        rows, out_pts, src = [], [], []
        # each field carries its SOURCE frame's props; carried second
        # fields index row 0 of [carried row] + batch
        off = 1 if self._second is not None else 0
        ext_meta = (meta if self._second is None
                    else _meta_concat(self._second[1], meta))
        pend = (self._second[0], 0, self._second[2],
                self._second[3]) if self._second is not None else None
        for i in range(n):
            frame = {nm: v[i:i + 1] for nm, v in fb.planes.items()}
            if pend is not None:
                sp, sj, spts, stff = pend
                rows.append(self._field(sp, stff, first=False))
                out_pts.append(spts + int(pts[i]))
                src.append(sj)
            rows.append(self._field(frame, bool(tffs[i]), first=True))
            out_pts.append(2 * int(pts[i]))
            src.append(i + off)
            pend = (frame, i + off, int(pts[i]), bool(tffs[i]))
        if pend is not None:
            sp, sj, spts, stff = pend
            self._second = (sp, _meta_take(ext_meta, slice(sj, sj + 1)),
                            spts, stff)
        if not rows:
            return fb.with_planes({nm: v[:0, ::2]
                                   for nm, v in fb.planes.items()}), \
                _meta_take(meta, slice(0, 0))
        k = len(rows)
        out = _meta_take(ext_meta, np.asarray(src, np.int64))
        out["pts"] = np.asarray(out_pts, np.int64)
        if out.get("interlaced") is not None:
            out["interlaced"] = np.zeros(
                k, np.asarray(meta["interlaced"]).dtype)
        out["keep"] = np.ones(k, bool)
        if out.get("pad") is not None:
            out["pad"] = np.zeros(k, bool)
        fmt, w, h, cs = self._geom
        return FrameBatch(_cat_rows(rows), fmt, w, h, cs), out

    def flush(self):
        if self._second is None or self._geom is None:
            return None
        sp, srow, spts, stff = self._second
        self._second = None
        step = self._step or 1
        planes = {nm: v.contiguous()
                  for nm, v in self._field(sp, stff, first=False).items()}
        fmt, w, h, cs = self._geom
        meta = dict(srow)
        meta["pts"] = np.asarray([spts + spts + step], np.int64)
        if meta.get("interlaced") is not None:
            meta["interlaced"] = np.zeros(
                1, np.asarray(srow["interlaced"]).dtype)
        meta["keep"] = np.ones(1, bool)
        if meta.get("pad") is not None:
            meta["pad"] = np.zeros(1, bool)
        return FrameBatch(planes, fmt, w, h, cs), meta


class WeaveFilter:
    """vf_weave.c analog (weave + doubleweave): interleave successive
    half-height frames into full interlaced frames.  first_field
    top/bottom places the OLDER frame's rows on the first field;
    doubleweave emits per input (overlapping pairs) with the field
    roles alternating by the 0-based input-frame parity (:99-101).
    pts: in/2 for weave (C int trunc), prev's pts for doubleweave;
    outputs are flagged interlaced with tff=!first_field."""

    stream_filter = True

    def __init__(self, first_field="top", double_weave=0):
        ff_map = {"top": 0, "t": 0, "0": 0, "bottom": 1, "b": 1, "1": 1}
        if str(first_field) not in ff_map:
            raise FilterError(f"weave: bad first_field {first_field!r}")
        self.first_field = ff_map[str(first_field)]
        self.double = bool(int(double_weave))
        self.fps_mul = 1 if self.double else 0.5
        self._prev = None          # (planes, pts)
        self._count = 0            # consumed frames

    def _weave_pair(self, prev, cur, index):
        # vf_weave.c:99: weave = double && !(frame_count_out & 1), the
        # 0-BASED index of the frame being processed
        weave = self.double and not (index & 1)
        field1 = self.first_field if weave else (not self.first_field)
        out = {}
        for nm in cur:
            a, b = cur[nm], prev[nm]
            even, odd = (b, a) if field1 else (a, b)
            shape = (a.shape[0], 2 * a.shape[1]) + tuple(a.shape[2:])
            out[nm] = same_bits(
                lambda e, o: torch.stack([e, o], dim=2).reshape(shape),
                even, odd)
        return out

    def process_batch(self, fb: FrameBatch, meta):
        fb, meta = _compact_alive(fb, meta)
        n = fb.batch
        pts = meta.get("pts")
        pts = (np.asarray(pts, np.int64) if pts is not None
               else np.arange(n, dtype=np.int64))
        rows, out_pts, out_il, src = [], [], [], []
        for i in range(n):
            frame = {nm: v[i:i + 1] for nm, v in fb.planes.items()}
            self._count += 1
            if self._prev is None:
                self._prev = (frame, int(pts[i]))
                continue
            prev_planes, prev_pts = self._prev
            rows.append(self._weave_pair(prev_planes, frame,
                                         self._count - 1))
            src.append(i)            # av_frame_copy_props(out, in)
            if self.double:
                out_pts.append(prev_pts)
                self._prev = (frame, int(pts[i]))
            else:
                pv = int(pts[i])
                out_pts.append(abs(pv) // 2 * (1 if pv >= 0 else -1))
                self._prev = None
            out_il.append(1 | ((0 if self.first_field else 1) << 1))
        if not rows:
            empty = {nm: same_bits(lambda x: x.new_zeros(
                         (0, x.shape[1] * 2) + tuple(x.shape[2:])), v)
                     for nm, v in fb.planes.items()}
            return FrameBatch(empty, fb.format, fb.width,
                              fb.height * 2, fb.colorspace), \
                _meta_take(meta, slice(0, 0))
        k = len(rows)
        out = _meta_take(meta, np.asarray(src, np.int64))
        out["pts"] = np.asarray(out_pts, np.int64)
        if out.get("interlaced") is not None:
            out["interlaced"] = np.asarray(
                out_il, np.asarray(meta["interlaced"]).dtype)
        out["keep"] = np.ones(k, bool)
        if out.get("pad") is not None:
            out["pad"] = np.zeros(k, bool)
        return FrameBatch(_cat_rows(rows), fb.format, fb.width,
                          fb.height * 2, fb.colorspace), out

    def flush(self):
        return None


class _TelecineBase:
    """Shared plumbing for telecine/detelecine (vf_telecine.c /
    vf_detelecine.c): pattern parsing, the fps/time-base algebra
    (config_output: fps_out = fps_in / pts_ratio, out_tb = in_tb *
    pts_ratio, ts_unit = 1/(fps_out*out_tb)), output pts = start_time +
    av_rescale(out_index, ts_unit) and the strided field weave."""

    stream_filter = True
    wants_link = True

    _FF = {"top": 0, "t": 0, "0": 0, "bottom": 1, "b": 1, "1": 1}

    def _setup(self, name, first_field, pattern, src_fps, _link,
               num_per_digit):
        if str(first_field) not in self._FF:
            raise FilterError(f"{name}: bad first_field "
                              f"{first_field!r}")
        self.ff = self._FF[str(first_field)]
        self.pattern = str(pattern)
        if not self.pattern or not self.pattern.isdigit():
            raise FilterError(f"{name}: pattern must be a non-empty "
                              "digit string")
        self.digits = [int(c) for c in self.pattern]
        s = sum(self.digits)
        if s == 0:
            raise FilterError(f"{name}: all-zero pattern has no "
                              "output rate")
        # telecine: pts = 2L/sum; detelecine: pts = sum/2L
        if num_per_digit == 2:
            ratio = Fraction(2 * len(self.digits), s)
        else:
            ratio = Fraction(s, 2 * len(self.digits))
        src_tb = _link_tb(_link, src_fps)
        src_f = Fraction(str(src_fps)).limit_denominator(100000)
        self.fps_out = src_f / ratio
        self.out_tb = src_tb * ratio
        self.ts_unit = 1 / (self.fps_out * self.out_tb)
        self.fps_mul = float(1 / ratio)
        self._sec_per_out = float(1 / self.fps_out)
        self.pos = 0
        self.start_time = None
        self._start_t = 0.0
        self.occupied = False
        self._temp = None
        self._out_count = 0       # outlink frame_count_in analog

    @staticmethod
    def _weave(early, late, ff):
        """Rows [ff::2] from `early`, rows [!ff::2] from `late`."""
        def put(lt, er):
            o = lt.clone()
            o[:, ff::2] = er[:, ff::2]
            return o
        return {nm: same_bits(put, late[nm], early[nm]) for nm in early}

    def _start(self, pts, times, i):
        if self.start_time is None:
            self.start_time = int(pts[i])
            self._start_t = float(times[i]) if times is not None else 0.0

    def _emit(self, fb, meta, rows, metas, out_il):
        if not rows:
            return _empty_like(fb), _meta_take(meta, slice(0, 0))
        k = len(rows)
        base = 0 if self.start_time is None else self.start_time
        first = self._out_count - k
        pts = [base + _av_rescale(first + j, self.ts_unit.numerator,
                                  self.ts_unit.denominator)
               for j in range(k)]
        times = [self._start_t + (first + j) * self._sec_per_out
                 for j in range(k)]
        out = _row_meta(metas, k, pts, times)
        if out_il is not None and out.get("interlaced") is not None:
            out["interlaced"] = np.asarray(
                out_il, np.asarray(out["interlaced"]).dtype)
        return fb.with_planes(_cat_rows(rows)), out

    def flush(self):
        return None              # the C drops any buffered half frame


class TelecineFilter(_TelecineBase):
    """vf_telecine.c analog: expand a progressive stream by a telecine
    field pattern (default 23: 24000/1001 film -> 30000/1001).  Each
    pattern digit = fields the frame is displayed: a pending buffered
    field weaves with the new frame's later field (interlaced=1,
    tff=!first_field, :185-203), whole pairs emit the frame as-is
    inheriting its flags (:205-217), an odd trailing field is buffered
    (:219-227).  Output props come from the current input; pts =
    start_time + av_rescale(out_index, ts_unit); a 0 digit drops the
    frame."""

    def __init__(self, first_field="top", pattern="23",
                 src_fps: float = 30.0, _link=None):
        self._setup("telecine", first_field, pattern, src_fps, _link,
                    num_per_digit=2)

    def process_batch(self, fb: FrameBatch, meta):
        fb, meta = _compact_alive(fb, meta)
        n = fb.batch
        pts = meta.get("pts")
        pts = (np.asarray(pts, np.int64) if pts is not None
               else np.arange(n, dtype=np.int64))
        times = meta.get("times")
        il = meta.get("interlaced")
        rows, metas, out_il = [], [], []
        for i in range(n):
            cur = {nm: v[i:i + 1] for nm, v in fb.planes.items()}
            mrow = _meta_take(meta, slice(i, i + 1))
            self._start(pts, times, i)
            length = self.digits[self.pos]
            self.pos += 1
            if self.pos >= len(self.digits):
                self.pos = 0
            if not length:
                continue
            if self.occupied:
                rows.append(self._weave(self._temp, cur, self.ff))
                metas.append(mrow)
                out_il.append(1 | ((0 if self.ff else 1) << 1))
                self._out_count += 1
                length -= 1
                self.occupied = False
            cur_il = int(np.asarray(il)[i]) if il is not None else 0
            while length >= 2:
                rows.append(cur)
                metas.append(mrow)
                out_il.append(cur_il)
                self._out_count += 1
                length -= 2
            if length >= 1:
                self._temp = cur
                self.occupied = True
        return self._emit(fb, meta, rows, metas, out_il)


class DetelecineFilter(_TelecineBase):
    """vf_detelecine.c analog: invert a telecine pattern back to the
    progressive rate.  The filter_frame state machine (:195-305):
    nskip_fields carry-over (>=2 drops the frame, ==1 buffers it), the
    len==1+occupied flush of the buffered frame, the reverse weave
    (earlier field from the NEW pic), the len<=2 re-buffering,
    init_len/pattern_pos precomputation for start_frame (:102-118).
    Output props come from the current input; pts = start_time +
    av_rescale(out_index, ts_unit)."""

    def __init__(self, first_field="top", pattern="23", start_frame=0,
                 src_fps: float = 30.0, _link=None):
        self._setup("detelecine", first_field, pattern, src_fps, _link,
                    num_per_digit=1)
        self.start_frame = int(start_frame)
        if not 0 <= self.start_frame <= 13:
            raise FilterError("detelecine: start_frame out of [0, 13]")
        if self.start_frame >= sum(self.digits):
            raise FilterError("detelecine: start_frame is too big")
        self.nskip = 0
        self.init_len = 0
        if self.start_frame:
            nfields = 0
            for d in self.digits:
                nfields += d
                self.pos += 1
                if nfields >= 2 * self.start_frame:
                    self.init_len = nfields - 2 * self.start_frame
                    break

    def _next_len(self):
        length = 0
        while not length and self.pos < len(self.digits):
            length = self.digits[self.pos]
            self.pos += 1
        if self.pos >= len(self.digits):
            self.pos = 0
        return length

    def process_batch(self, fb: FrameBatch, meta):
        fb, meta = _compact_alive(fb, meta)
        n = fb.batch
        pts = meta.get("pts")
        pts = (np.asarray(pts, np.int64) if pts is not None
               else np.arange(n, dtype=np.int64))
        times = meta.get("times")
        rows, metas = [], []
        for i in range(n):
            cur = {nm: v[i:i + 1] for nm, v in fb.planes.items()}
            mrow = _meta_take(meta, slice(i, i + 1))
            self._start(pts, times, i)
            if self.nskip >= 2:
                self.nskip -= 2
                continue
            if self.nskip >= 1:
                self._temp = cur
                self.occupied = True
                self.nskip -= 1
                continue
            length = self.init_len
            self.init_len = 0
            if not length:
                while not length and self.pos < len(self.digits):
                    length = self.digits[self.pos]
                    self.pos += 1
            # the C's end-of-string pattern_pos reset (:203) runs even
            # when len came from init_len
            if self.pos >= len(self.digits):
                self.pos = 0
            if not length:
                continue
            if length == 1 and self.occupied:
                rows.append(self._temp)        # buffered frame as-is
                metas.append(mrow)
                self._out_count += 1
                self.occupied = False
                length = self._next_len()
            if self.occupied:
                # earlier field from the NEW pic, later from buffered
                rows.append(self._weave(cur, self._temp, self.ff))
                metas.append(mrow)
                self._out_count += 1
                self.occupied = False
                if length <= 2:
                    self._temp = cur
                    self.occupied = True
                length = length - 3 if length >= 3 else 0
            else:
                if length >= 2:
                    rows.append(cur)
                    metas.append(mrow)
                    self._out_count += 1
                    length -= 2
                elif length == 1:
                    rows.append(cur)
                    metas.append(mrow)
                    self._out_count += 1
                    self._temp = cur
                    self.occupied = True
                    length -= 1
            if length == 1 and self.occupied:
                length -= 1
                self.occupied = False
            self.nskip = length
        return self._emit(fb, meta, rows, metas, None)


def _zp_gather(x, ridx, rw, cidx, cw):
    """Bicubic windowed gather with absolute per-output indices (the
    crop origin and size are data): per-tap gathers, f32 multiplies and
    sequential accumulation, the op order of ops/resize._gather_resize."""
    acc = None
    for k in range(4):
        g = same_bits(torch.index_select, x, dim=1,
                      index=ridx[k]).to(torch.float32)
        t = g * rw[k][None, :, None]
        acc = t if acc is None else acc + t
    out = None
    for k in range(4):
        g = torch.index_select(acc, 2, cidx[k])
        t = g * cw[k][None, None, :]
        out = t if out is None else out + t
    return out


_ZP_TAPS: Dict = {}


def _zp_taps(crop_n: int, out_n: int, origin: int, device):
    """(4, out_n) absolute indices + weights for a crop_n-wide window
    at `origin`, replicating _gather_resize's edge clamping, on
    `device` (uploaded once per window)."""
    def make():
        idx0, wts = resize._window_taps(crop_n, out_n, "bicubic")
        idx = np.stack([np.minimum(idx0 + k, crop_n - 1) + origin
                        for k in range(4)]).astype(np.int64)
        return (torch.as_tensor(idx, device=device),
                torch.as_tensor(np.ascontiguousarray(wts.T), device=device))
    return _cached(_ZP_TAPS, (crop_n, out_n, origin, str(device)), make)


class ZoompanFilter:
    """vf_zoompan.c analog: per-input Ken Burns zoom/pan — each input
    frame produces `d` output frames (duration expr, default 90),
    cropping a (in_w/zoom, in_h/zoom) window at the expression-driven
    x/y (clipped to the frame, chroma-aligned down, :160-206) and
    scaling it to the output size `s` (default hd720) at rate `fps`
    (out pts = output index in the 1/fps tb).  The expressions run per
    output frame on the host; the bicubic gathers run on the batch's
    device.

    The full expression-variable surface is kept (in/on/it/ot/time/
    frame/zoom/pzoom/px/py/duration/pduration/a/sar/dar/hsub/vsub);
    state carries across frames like the C (x/y/prev_zoom update from
    the LAST output of each input, prev_nb_frames from its duration).
    The C resamples the crop with swscale BICUBIC; this uses ops/resize's
    bicubic taps, the `scale` filter's envelope."""

    stream_filter = True
    wants_link = True
    _MAX_PER_FRAME = 4096

    def __init__(self, zoom="1", z=None, x="0", y="0", d="90",
                 s="hd720", fps="25", src_fps: float = 30.0,
                 _link=None):
        from .hdr import _VIDEO_SIZE_ABBRS
        self.zoom_expr = compile_expr(str(z if z is not None else zoom))
        self.x_expr = compile_expr(str(x))
        self.y_expr = compile_expr(str(y))
        self.d_expr = compile_expr(str(d))
        size = str(s).strip().lower()
        if size in _VIDEO_SIZE_ABBRS:
            self.out_w, self.out_h = _VIDEO_SIZE_ABBRS[size]
        else:
            try:
                ww, hh = size.replace("x", ":").split(":")
                self.out_w, self.out_h = int(ww), int(hh)
            except ValueError:
                raise FilterError(f"zoompan: bad size {s!r}")
        self.fps = _frame_rate(fps)
        if self.fps <= 0:
            raise FilterError("zoompan: fps must be positive")
        self.src_tb = _link_tb(_link, src_fps)
        self.fps_mul = float(self.fps) / float(src_fps)
        self._x = 0.0
        self._y = 0.0
        self._prev_zoom = 1.0
        self._prev_nb = 0
        self._in_count = 0          # inlink frame_count_out analog
        self._out_count = 0         # outlink frame_count_in analog
        # var_values is a PERSISTENT struct in the C: vars not reset by
        # the consume branch (duration/frame/it/ot) stay stale from the
        # previous frame during the duration eval
        self._env = {k: 0.0 for k in (
            "in_w", "iw", "in_h", "ih", "out_w", "ow", "out_h", "oh",
            "in", "on", "duration", "pduration", "in_time", "it",
            "out_time", "time", "ot", "frame", "zoom", "pzoom", "x", "px",
            "y", "py", "a", "sar", "dar", "hsub", "vsub")}

    def _crop_scale(self, fb, i, cx, cy, w, h):
        fmt = fb.fmt
        out = {}
        for p in fmt.planes:
            arr = fb.planes[p.name][i:i + 1]
            pw = -(-w >> p.sub_w) if p.sub_w else w
            ph = -(-h >> p.sub_h) if p.sub_h else h
            ridx, rw = _zp_taps(ph, self.out_h >> p.sub_h, cy >> p.sub_h,
                                arr.device)
            cidx, cw = _zp_taps(pw, self.out_w >> p.sub_w, cx >> p.sub_w,
                                arr.device)
            yv = _zp_gather(arr, ridx, rw, cidx, cw)
            out[p.name] = torch.clamp(torch.round(yv), 0,
                                      F.clip_value(fmt)).to(arr.dtype)
        return out

    def process_batch(self, fb: FrameBatch, meta):
        fb, meta = _compact_alive(fb, meta)
        fmt = fb.fmt
        if fmt.is_rgb or fmt.is_float:
            raise FilterError("zoompan: planar YUV/gray frames here")
        n = fb.batch
        pts = meta.get("pts")
        pts = (np.asarray(pts, np.int64) if pts is not None
               else np.arange(n, dtype=np.int64))
        hsub = max(p.sub_w for p in fmt.planes)
        vsub = max(p.sub_h for p in fmt.planes)
        in_w, in_h = fb.width, fb.height
        rows, metas, out_pts, out_times = [], [], [], []
        sec_out = float(1 / self.fps)
        env = self._env
        for i in range(n):
            mrow = _meta_take(meta, slice(i, i + 1))
            # the consume branch's explicit re-initialization (:310-330)
            env["in_w"] = env["iw"] = float(in_w)
            env["in_h"] = env["ih"] = float(in_h)
            env["out_w"] = env["ow"] = float(self.out_w)
            env["out_h"] = env["oh"] = float(self.out_h)
            env["in"] = float(self._in_count)     # frame_count_out - 1
            env["on"] = float(self._out_count)
            env["px"], env["py"] = self._x, self._y
            env["x"] = env["y"] = 0.0
            env["pzoom"] = self._prev_zoom
            env["zoom"] = 1.0
            env["pduration"] = float(self._prev_nb)
            env["a"] = in_w / in_h
            env["sar"] = 1.0
            env["dar"] = env["a"] * env["sar"]
            env["hsub"] = float(1 << hsub)
            env["vsub"] = float(1 << vsub)
            self._in_count += 1
            nb = int(self.d_expr(env))
            env["duration"] = float(nb)
            it = float(int(pts[i]) * self.src_tb)
            if max(nb, 1) > self._MAX_PER_FRAME:
                raise FilterError(f"zoompan: duration {nb} exceeds "
                                  f"{self._MAX_PER_FRAME} frames per "
                                  "input")
            zoom = dx = dy = -1.0
            for j in range(max(nb, 1)):   # the C emits at least one frame
                # output_single_frame's per-output vars (:160-175)
                env["px"], env["py"] = self._x, self._y
                env["pzoom"] = self._prev_zoom
                env["pduration"] = float(self._prev_nb)
                env["in_time"] = env["it"] = it
                env["frame"] = float(j)
                env["on"] = float(self._out_count)
                env["out_time"] = env["time"] = env["ot"] = \
                    self._out_count * sec_out
                zoom = min(max(float(self.zoom_expr(env)), 1.0), 10.0)
                env["zoom"] = zoom
                w = int(in_w * (1.0 / zoom))
                h = int(in_h * (1.0 / zoom))
                dx = min(max(float(self.x_expr(env)), 0.0),
                         max(float(in_w - w), 0.0))
                env["x"] = dx
                cx = int(dx) & ~((1 << hsub) - 1)
                dy = min(max(float(self.y_expr(env)), 0.0),
                         max(float(in_h - h), 0.0))
                env["y"] = dy
                cy = int(dy) & ~((1 << vsub) - 1)
                rows.append(self._crop_scale(fb, i, cx, cy, w, h))
                metas.append(mrow)
                out_pts.append(self._out_count)
                out_times.append(self._out_count * sec_out)
                self._out_count += 1
            self._x, self._y = dx, dy
            self._prev_zoom = zoom
            self._prev_nb = nb
        if not rows:
            return _empty_like(fb), _meta_take(meta, slice(0, 0))
        out = _row_meta(metas, len(rows), out_pts, out_times)
        return FrameBatch(_cat_rows(rows), fb.format, self.out_w,
                          self.out_h, fb.colorspace), out

    def flush(self):
        return None


_IL_MODES = {"none": 0, "interleave": 1, "i": 1, "deinterleave": 2,
             "d": 2, "0": 0, "1": 1, "2": 2}


def _il_rowmap(h: int, mode: int, swap: int) -> np.ndarray:
    """vf_il.c interleave() (:110-137) as a row gather map.  The C
    copies only 2*(h>>1) rows — for odd heights the last output row is
    uninitialized buffer memory; here it passes the source row
    through."""
    m = h >> 1
    a, b = int(swap), 1 - int(swap)
    src = np.arange(h)
    ys = np.arange(m)
    if mode == 2:              # deinterleave: halves from the fields
        src[:m] = 2 * ys + a
        src[m:2 * m] = 2 * ys + b
    elif mode == 1:            # interleave: fields from the halves
        src[2 * ys + a] = ys
        src[2 * ys + b] = ys + m
    elif swap:                 # none + swap: pairwise field swap
        src[2 * ys] = 2 * ys + 1
        src[2 * ys + 1] = 2 * ys
    return src


def _f_il(**kw):
    """vf_il.c analog: (de)interleave fields per plane group — luma /
    chroma / alpha modes none|interleave|deinterleave plus per-group
    field swaps, as row gathers on the batch's device.  Output props
    pass through (av_frame_copy_props)."""
    alias = {"l": "luma_mode", "c": "chroma_mode", "a": "alpha_mode",
             "ls": "luma_swap", "cs": "chroma_swap", "as": "alpha_swap"}
    opts = {"luma_mode": "none", "chroma_mode": "none",
            "alpha_mode": "none", "luma_swap": 0, "chroma_swap": 0,
            "alpha_swap": 0}
    for k, v in kw.items():
        k = alias.get(k, k)
        if k not in opts:
            raise FilterError(f"il: unknown option {k!r}")
        opts[k] = v
    modes = {}
    for g in ("luma", "chroma", "alpha"):
        mv = str(opts[f"{g}_mode"])
        if mv not in _IL_MODES:
            raise FilterError(f"il: bad {g}_mode {mv!r}")
        modes[g] = (_IL_MODES[mv], int(opts[f"{g}_swap"]))
    maps: Dict = {}

    def run(fb):
        out = {}
        for p in fb.fmt.planes:
            if p.name in ("y", "rgb"):
                mode, swap = modes["luma"]
            elif p.name == "a":
                mode, swap = modes["alpha"]
            else:
                mode, swap = modes["chroma"]
            arr = fb.planes[p.name]
            if mode == 0 and not swap:
                out[p.name] = arr
                continue
            h = arr.shape[1]
            rows = _cached(maps, (h, mode, swap, str(arr.device)),
                           lambda: torch.as_tensor(_il_rowmap(h, mode, swap),
                                                   device=arr.device))
            out[p.name] = same_bits(torch.index_select, arr, dim=1,
                                    index=rows)
        return fb.with_planes(out)
    return run


class ShuffleFramesFilter:
    """vf_shuffleframes.c analog: reorder frames in groups of
    len(mapping).  mapping "m0|m1|..." (or space-separated), each in
    [-1, N-1]: output slot n emits a clone of input frame m_n carrying
    ITS props but slot n's pts (:96-104); -1 drops the slot.  A partial
    group at EOF is dropped (uninit frees it, :118-124)."""

    stream_filter = True

    def __init__(self, mapping="0"):
        toks = [t for t in str(mapping).replace("|", " ").split()
                if t != ""]
        if not toks:
            raise FilterError("shuffleframes: empty mapping")
        try:
            self.map = [int(t) for t in toks]
        except ValueError:
            raise FilterError(f"shuffleframes: bad mapping {mapping!r}")
        n = len(self.map)
        for m in self.map:
            if not -1 <= m < n:
                raise FilterError(
                    f"shuffleframes: index {m} out of [-1, {n - 1}]")
        self._buf = []            # (planes row, meta row, pts)

    def process_batch(self, fb: FrameBatch, meta):
        fb, meta = _compact_alive(fb, meta)
        n = fb.batch
        pts = meta.get("pts")
        pts = (np.asarray(pts, np.int64) if pts is not None
               else np.arange(n, dtype=np.int64))
        rows, metas, out_pts = [], [], []
        group = len(self.map)
        for i in range(n):
            self._buf.append(({k: v[i:i + 1] for k, v in fb.planes.items()},
                              _meta_take(meta, slice(i, i + 1)),
                              int(pts[i])))
            if len(self._buf) == group:
                for slot, x in enumerate(self.map):
                    if x < 0:
                        continue
                    rows.append(self._buf[x][0])
                    metas.append(self._buf[x][1])
                    out_pts.append(self._buf[slot][2])
                self._buf = []
        if not rows:
            return _empty_like(fb), _meta_take(meta, slice(0, 0))
        # times stay the clone's own (copied props); pts is slot n's
        return (fb.with_planes(_cat_rows(rows)),
                _row_meta(metas, len(rows), out_pts))

    def flush(self):
        self._buf = []            # partial group dropped, like uninit
        return None


class ReverseFilter:
    """f_reverse.c analog: buffer the whole stream on its device, emit
    it reversed at EOF with the ORIGINAL pts sequence reattached in
    forward order (request_frame :103-119).  The C holds every frame in
    memory too; the flush drains in chunks of 64 through the graph's
    list-flush protocol."""

    stream_filter = True
    _FLUSH_CHUNK = 64

    def __init__(self):
        self._batches = []        # (planes dict, meta)
        self._geom = None

    def process_batch(self, fb: FrameBatch, meta):
        fb, meta = _compact_alive(fb, meta)
        if fb.batch:
            self._batches.append((dict(fb.planes), meta))
            self._geom = (fb.format, fb.width, fb.height, fb.colorspace)
        return _empty_like(fb), _meta_take(meta, slice(0, 0))

    def flush(self):
        if not self._batches:
            return None
        fmtname, w, h, cs = self._geom
        fwd_pts, fwd_times = [], []
        have_times = all(m.get("times") is not None
                         for _, m in self._batches)
        rev_rows, rev_metas = [], []
        for planes, m in self._batches:
            n = next(iter(planes.values())).shape[0]
            p = (np.asarray(m["pts"], np.int64) if m.get("pts")
                 is not None else np.arange(n, dtype=np.int64))
            fwd_pts.extend(int(v) for v in p)
            if have_times:
                fwd_times.extend(float(t) for t in m["times"])
            for i in range(n):
                rev_rows.append({k: v[i:i + 1] for k, v in planes.items()})
                rev_metas.append(_meta_take(m, slice(i, i + 1)))
        self._batches = []
        rev_rows.reverse()
        rev_metas.reverse()
        chunks = []
        for lo in range(0, len(rev_rows), self._FLUSH_CHUNK):
            hi = min(lo + self._FLUSH_CHUNK, len(rev_rows))
            out = _row_meta(rev_metas[lo:hi], hi - lo, fwd_pts[lo:hi],
                            fwd_times[lo:hi] if have_times else None)
            chunks.append((FrameBatch(_cat_rows(rev_rows[lo:hi]), fmtname,
                                      w, h, cs), out))
        return chunks


class XfadeFilter:
    """vf_xfade.c analog: cross-fade the main stream into a second
    video (all 45 named transitions + `custom` expr — filters/xfade.py
    holds the transcribed kernels, float32 numpy on the host, as in the
    JAX filter: each blended pair is copied to the host, transitioned
    and put back on the batch's device).

    Stream machine (xfade_activate :1836-1911): main frames before
    first_pts+offset pass through; once reached, one frame from EACH
    input blends per output with progress = clipf(1 - (pts-first-
    offset)/duration, 0, 1) (1 -> 0), out pts/props from the main
    frame; when pts-first-offset exceeds duration the fade is over and
    the SECOND stream passes through while main frames are drained and
    discarded.  duration/offset are AV_TIME_BASE microsecond options
    rescaled to the stream tb (config_output :1782-1785).

    The second input is `video=FILE`, format-converted to the main
    stream's full-res format on the main stream's device; the C's
    444/gray/RGB-only pix_fmts gate is kept — run `format=yuv444p` first
    on subsampled streams.  Post-fade pts are synthesized from the main
    cadence (the C remaps the second stream's own pts, equal for matched
    CFR inputs); a second stream that ends before offset+duration ends
    the output there."""

    stream_filter = True
    wants_link = True
    _FLUSH_CHUNK = 64

    def __init__(self, transition="fade", duration=1.0, offset=0.0,
                 expr="", video="", vw=0, vh=0,
                 src_fps: float = 30.0, _link=None):
        from .xfade import TRANSITIONS
        self.transition = str(transition)
        if self.transition not in TRANSITIONS:
            raise FilterError(
                f"xfade: unknown transition {transition!r}")
        if self.transition == "custom" and not expr:
            raise FilterError("xfade: custom transition needs expr=")
        self._expr = (compile_expr(str(expr), funcs=self._getpix_funcs())
                      if expr else None)
        self.duration_s = _dur_seconds(duration)
        if not 0.0 < self.duration_s <= 60.0:
            raise FilterError("xfade: duration out of (0, 60] seconds")
        self.offset_s = _dur_seconds(offset)
        if not video:
            raise FilterError("xfade needs video=FILE (second input)")
        self.video = str(video)
        self.vw, self.vh = int(vw), int(vh)
        self.tb = _link_tb(_link, src_fps)
        # av_rescale_q(usec, AV_TIME_BASE_Q, tb)
        self.duration_pts = _av_rescale(
            int(round(self.duration_s * 1e6)),
            self.tb.denominator, 1000000 * self.tb.numerator)
        self.offset_pts = _av_rescale(
            int(round(self.offset_s * 1e6)),
            self.tb.denominator, 1000000 * self.tb.numerator)
        self.first_pts = None
        self.pts = None
        self.over = False
        self._b_ended = False
        self._gen = None
        self._n_after = 0
        self._step = None
        self._step_t = 0.0
        self._last_pts = None
        self._last_t = None
        self._time = 0.0
        self._geom = None          # (format, w, h, colorspace)
        self._device = None
        self._cur_ab = None        # custom getpix frames

    # -- custom expr getpix (vf_xfade.c:1688-1745) -------------------------
    def _getpix_funcs(self):
        def mk(nb, plane):
            def f(env, x, y):
                stk = self._cur_ab[nb]
                pl = min(plane, stk.shape[0] - 1)
                xi = int(np.clip(x, 0, stk.shape[2] - 1))
                yi = int(np.clip(y, 0, stk.shape[1] - 1))
                return float(stk[pl, yi, xi])
            return (2, 2, f)
        fs = {}
        for pl in range(4):
            fs[f"a{pl}"] = mk(0, pl)
            fs[f"b{pl}"] = mk(1, pl)
        return fs

    def _next_b(self):
        """One second-input frame as a host stack in the main format."""
        if self._gen is None:
            self._gen = _second_stream(self.video, self.vw, self.vh,
                                       "second video")
        try:
            f = next(self._gen)
        except StopIteration:
            return None
        from ..core.frame import from_numpy_yuv420
        fmtname, w, h, cs = self._geom
        if f["y"].shape != (h, w):
            raise FilterError(
                f"xfade: second input size {f['y'].shape[::-1]} does "
                f"not match the main {w}x{h} (the C errors too)")
        bfb = from_numpy_yuv420(f["y"][None], f["u"][None], f["v"][None],
                                colorspace=cs, device=self._device)
        if bfb.format != fmtname:
            bfb = csc.convert(bfb, fmtname)
        return self._stack(bfb.planes, F.get(fmtname))

    @staticmethod
    def _stack(planes, fmt):
        """Frame 0 of a plane dict as a channel-first host stack."""
        if fmt.is_rgb:
            arr = planes["rgb"][0].cpu().numpy()
            return np.ascontiguousarray(np.transpose(arr, (2, 0, 1)))
        return np.stack([planes[p.name][0].cpu().numpy()
                         for p in fmt.planes])

    def _unstack(self, stk, fmt):
        dev = self._device
        if fmt.is_rgb:
            return {"rgb": torch.as_tensor(np.ascontiguousarray(
                np.transpose(stk, (1, 2, 0))[None]), device=dev)}
        return {p.name: torch.as_tensor(np.ascontiguousarray(stk[i][None]),
                                        device=dev)
                for i, p in enumerate(fmt.planes)}

    @staticmethod
    def _b_meta_row(mrow):
        """Post-fade frames come from the SECOND stream: synthesize
        progressive rows instead of inheriting the drained main frame's
        interlace/keyframe flags."""
        row = dict(mrow)
        for key in ("interlaced", "keys"):
            if row.get(key) is not None:
                row[key] = np.zeros_like(np.asarray(row[key]))
        return row

    def _ctx(self, fmt):
        maxv = (1 << fmt.bits) - 1
        nb = (len(fmt.channel_order or "rgb") if fmt.is_rgb
              else len(fmt.planes))
        chroma = 0 if fmt.is_rgb else maxv // 2
        black = [0, chroma, chroma, maxv][:nb]
        wch = maxv if fmt.is_rgb else maxv // 2
        white = [maxv, wch, wch, maxv][:nb]
        _, w, h, _ = self._geom
        return {"w": w, "h": h, "maxv": maxv, "black": black,
                "white": white, "is_rgb": fmt.is_rgb, "nb_planes": nb,
                "expr": self._expr}

    def process_batch(self, fb: FrameBatch, meta):
        from .xfade import apply_transition
        fmt = fb.fmt
        if fmt.is_float:
            raise FilterError("xfade: 8-16 bit integer formats only")
        if any(p.sub_w or p.sub_h for p in fmt.planes):
            raise FilterError("xfade: full-resolution planes only "
                              "(format=yuv444p first) — vf_xfade.c "
                              "pix_fmts")
        fb, meta = _compact_alive(fb, meta)
        n = fb.batch
        if n:
            self._geom = (fb.format, fb.width, fb.height, fb.colorspace)
            self._device = fb.device
        pts = meta.get("pts")
        pts = (np.asarray(pts, np.int64) if pts is not None
               else np.arange(n, dtype=np.int64))
        times = meta.get("times")
        if self._step is None and n:
            seq = ([self._last_pts] if self._last_pts is not None
                   else []) + pts.tolist()
            if len(seq) > 1:
                self._step = int(np.median(np.diff(seq)))
            if times is not None:
                tq = ([self._last_t] if self._last_t is not None
                      else []) + [float(t) for t in times]
                if len(tq) > 1:
                    self._step_t = float(np.median(np.diff(tq)))
        if n:
            self._last_pts = int(pts[-1])
            if times is not None:
                self._last_t = float(times[-1])
        ctx = self._ctx(fmt)
        rows, metas, out_pts, out_times = [], [], [], []
        for i in range(n):
            mrow = _meta_take(meta, slice(i, i + 1))
            p_i = int(pts[i])
            t_i = float(times[i]) if times is not None else 0.0
            if self.over:
                if self._b_ended:
                    continue
                bstk = self._next_b()
                if bstk is None:
                    self._b_ended = True
                    continue
                self._n_after += 1
                rows.append(self._unstack(bstk, fmt))
                metas.append(self._b_meta_row(mrow))
                out_pts.append((self.pts or 0)
                               + self._n_after * (self._step or 1))
                out_times.append(self._time + self._n_after * self._step_t)
                continue
            if self.first_pts is None:
                self.first_pts = p_i
            self.pts = p_i
            if self.first_pts + self.offset_pts > p_i:
                rows.append({k: v[i:i + 1] for k, v in fb.planes.items()})
                metas.append(mrow)
                out_pts.append(p_i)
                out_times.append(t_i)
                self._time = t_i
                continue
            bstk = self._next_b()
            if bstk is None:
                self.over = True
                self._b_ended = True
                continue
            astk = self._stack({k: v[i:i + 1] for k, v in fb.planes.items()},
                               fmt)
            # progress: float division, av_clipf (xfade_frame :1804)
            delta = p_i - self.first_pts - self.offset_pts
            progress = float(np.clip(
                np.float32(1.0) - (np.float32(delta)
                                   / np.float32(self.duration_pts)),
                np.float32(0.0), np.float32(1.0)))
            self._cur_ab = (astk, bstk)
            blended = apply_transition(self.transition, astk, bstk,
                                       progress, ctx)
            rows.append(self._unstack(blended, fmt))
            metas.append(mrow)
            out_pts.append(p_i)
            out_times.append(t_i)
            self._time = t_i
            if p_i - (self.first_pts + self.offset_pts) > self.duration_pts:
                self.over = True
        if not rows:
            return _empty_like(fb), _meta_take(meta, slice(0, 0))
        fmtname, w, h, cs = self._geom
        return (FrameBatch(_cat_rows(rows), fmtname, w, h, cs),
                _row_meta(metas, len(rows), out_pts, out_times))

    def flush(self):
        # main EOF -> xfade_is_over; the second stream drains through
        # (xfade_activate :1849-1859), in chunks of 64 frames
        if self._b_ended or self._geom is None:
            return None
        fmtname, w, h, cs = self._geom
        fmt = F.get(fmtname)
        chunks = []
        rows, out_pts, out_times = [], [], []

        def cut():
            if not rows:
                return
            k = len(rows)
            meta = {"pts": np.asarray(out_pts, np.int64),
                    "times": np.asarray(out_times, np.float64),
                    "keys": None, "pos": None, "interlaced": None,
                    "keep": np.ones(k, bool), "pad": np.zeros(k, bool)}
            chunks.append((FrameBatch(_cat_rows(rows), fmtname, w, h, cs),
                           meta))
            rows.clear()
            out_pts.clear()
            out_times.clear()

        while True:
            bstk = self._next_b()
            if bstk is None:
                self._b_ended = True
                break
            self._n_after += 1
            rows.append(self._unstack(bstk, fmt))
            out_pts.append((self.pts or 0)
                           + self._n_after * (self._step or 1))
            out_times.append(self._time + self._n_after * self._step_t)
            if len(rows) >= self._FLUSH_CHUNK:
                cut()
        cut()
        return chunks or None


class FramerateFilter:
    """vf_framerate.c analog: up/downsample a progressive stream to a
    target rate by frame cloning + linear blending, with optional SAD
    scene-change gating.

    Kept from the C: the dest_time_base reduction (config_output
    :388-392), work_pts = start_pts + n frame durations, the 128-max
    blend factors with av_rescale NEAR rounding and the separate /256
    interp_start/interp_end window, the (s1*f1 + s2*f2 + 64) >> 7
    integer blend on the batch's device, mafd/diff scene scoring with
    the prev_mafd carry (get_scene_score :65-87; the luma SAD sums in
    int64 on the device and is read back as one scalar per frame pair),
    per-pair score caching, PTS-discontinuity restart, and the flush
    tail (a last work frame inside pts1+delta, or the bare f1 when no
    f0 exists).

    The source time base comes from the stream probe's link state
    (time_base), falling back to frame-index pts at 1/src_fps.  8-bit
    planar YUV here (the C also takes 9-12 bit)."""

    stream_filter = True
    wants_link = True

    _FLAGS = {"scene_change_detect": 1, "scd": 1, "1": 1, "0": 0}

    def __init__(self, fps="50", interp_start=15, interp_end=240,
                 scene=8.2, flags="1", src_fps: float = 30.0,
                 _link=None):
        self.dest_fps = _frame_rate(fps)
        if self.dest_fps <= 0:
            raise FilterError("framerate: fps must be positive")
        self.interp_start = int(interp_start)
        self.interp_end = int(interp_end)
        if not (0 <= self.interp_start <= 255
                and 0 <= self.interp_end <= 255):
            raise FilterError("framerate: interp window out of [0,255]")
        self.scene = float(scene)
        fl = 0
        for tok in str(flags).split("+"):
            if tok not in self._FLAGS:
                raise FilterError(f"framerate: unknown flag {tok!r}")
            fl |= self._FLAGS[tok]
        self.scd = bool(fl & 1)
        self.src_tb = _link_tb(_link, src_fps)
        # dest tb: gcd reduction of config_output :388-392
        stn, std = self.src_tb.numerator, self.src_tb.denominator
        dfn, dfd = self.dest_fps.numerator, self.dest_fps.denominator
        self.dest_tb = Fraction(math.gcd(stn * dfn, std * dfd), std * dfn)
        self.fps_mul = float(self.dest_fps) / float(src_fps)
        # one output frame = this many dest-tb ticks
        self.frame_step = Fraction((1 / self.dest_fps) / self.dest_tb)
        self.f0 = self.f1 = None          # planes dicts of (1, h, w)
        self.pts0 = self.pts1 = 0
        self.delta = 0
        self.start_pts = None
        self.n = 0
        self.prev_mafd = 0.0
        self.score = -1.0
        self._frame_idx = None
        self._names = None
        self._geom = None

    @staticmethod
    def _blend(p1, p2, f1, f2):
        return {k: ((p1[k].to(torch.int32) * f1 + p2[k].to(torch.int32) * f2
                     + 64) >> 7).to(p1[k].dtype) for k in p1}

    def _scene_score(self) -> float:
        """get_scene_score (:65-87): luma SAD -> mafd/diff."""
        a = self.f0["y"].to(torch.int32)
        b = self.f1["y"].to(torch.int32)
        sad = float(torch.sum(torch.abs(a - b)))
        h, w = a.shape[1], a.shape[2]
        mafd = sad * 100.0 / (w * h) / (1 << 8)
        diff = abs(mafd - self.prev_mafd)
        ret = min(max(min(mafd, diff), 0.0), 100.0)
        self.prev_mafd = mafd
        return ret

    def _work_pts(self) -> int:
        v = self.start_pts + self.n * self.frame_step
        return _av_rescale(v.numerator, 1, v.denominator)

    def _emit_work(self, flush: bool):
        """process_work_frame (:156-204) loop; returns (planes, pts)
        rows."""
        outs = []
        while True:
            if self.f1 is None:
                break
            if self.f0 is None and not flush:
                break
            wp = self._work_pts()
            if wp >= self.pts1 and not flush:
                break
            if self.f0 is None:
                outs.append((self.f1, wp))       # flush: bare f1 moves
                self.f1 = None
                self.n += 1
                continue
            if wp >= self.pts1 + self.delta and flush:
                break
            interpolate = _av_rescale(wp - self.pts0, 128, self.delta)
            interpolate8 = _av_rescale(wp - self.pts0, 256, self.delta)
            if interpolate >= 128 or interpolate8 > self.interp_end:
                outs.append((self.f1, wp))
            elif interpolate <= 0 or interpolate8 < self.interp_start:
                outs.append((self.f0, wp))
            else:
                sc = 0.0
                if self.scd:
                    if self.score < 0.0:
                        self.score = self._scene_score()
                    sc = self.score
                if sc < self.scene:
                    f2 = int(interpolate)
                    outs.append((self._blend(self.f0, self.f1, 128 - f2,
                                             f2), wp))
                else:
                    outs.append((self.f1 if interpolate > 64
                                 else self.f0, wp))
            self.n += 1
        return outs

    def _rows_to_batch(self, rows, meta_like):
        planes = {nm: _cat_frames(*[r[0][nm] for r in rows])
                  for nm in self._names}
        pts = np.array([r[1] for r in rows], np.int64)
        k = len(rows)
        meta = {}
        tb = float(self.dest_tb)
        for key, arr in meta_like.items():
            if arr is None:
                meta[key] = None
            elif key == "pts":
                meta[key] = pts
            elif key == "times":
                meta[key] = (pts * tb).astype(np.float64)
            elif key == "keep":
                meta[key] = np.ones(k, bool)
            elif key == "pad":
                meta[key] = np.zeros(k, bool)
            else:
                meta[key] = np.zeros(k, np.asarray(arr).dtype)
        fmt, w, h, cs = self._geom
        return FrameBatch(planes, fmt, w, h, cs), meta

    def process_batch(self, fb: FrameBatch, meta):
        if fb.fmt.bits != 8 or "rgb" in fb.planes:
            raise FilterError("framerate: 8-bit planar YUV only here")
        n = fb.batch
        self._names = list(fb.planes)
        self._geom = (fb.format, fb.width, fb.height, fb.colorspace)
        self._last_meta = {k: (None if v is None else np.asarray(v))
                           for k, v in meta.items()}
        pts_in = meta.get("pts")
        rows = []
        for i in range(n):
            if meta.get("keep") is not None and not meta["keep"][i]:
                continue
            src_pts = (int(np.asarray(pts_in)[i]) if pts_in is not None
                       else None)
            if src_pts is None:
                src_pts = self._frame_idx or 0
            self._frame_idx = src_pts + 1
            # rescale src pts -> dest tb (NEAR rounding)
            r = Fraction(src_pts) * self.src_tb / self.dest_tb
            pts = _av_rescale(r.numerator, 1, r.denominator)
            if self.f1 is not None and pts == self.pts1:
                continue                      # same-PTS frame ignored
            frame = {nm: v[i:i + 1] for nm, v in fb.planes.items()}
            self.f0, self.pts0 = self.f1, self.pts1
            self.f1, self.pts1 = frame, pts
            self.delta = self.pts1 - self.pts0
            self.score = -1.0
            if self.f0 is not None and self.delta < 0:
                self.start_pts = self.pts1
                self.n = 0
                self.f0 = None
            if self.start_pts is None:
                self.start_pts = self.pts1
            rows.extend(self._emit_work(flush=False))
        if not rows:
            return _empty_like(fb), _meta_take(meta, slice(0, 0))
        return self._rows_to_batch(rows, meta)

    def flush(self):
        if self.f1 is None or self._geom is None:
            return None
        rows = self._emit_work(flush=True)
        if not rows:
            return None
        return self._rows_to_batch(rows, self._last_meta)


class TpadFilter:
    """vf_tpad.c analog: temporally pad the stream — `start` frames
    before input (solid color via the CCIR draw conversion, or clones
    of the FIRST frame) and `stop` frames after EOF (color or clones of
    the LAST frame).  start_duration/stop_duration accept seconds or
    'Nms' and convert at the graph frame rate like config_input's
    av_rescale over frame_rate.  pts semantics follow activate(): pads
    step by one frame duration and shift the input's pts by the start
    padding.  stop=-1 (infinite padding) is rejected — unbounded output
    has no meaning in a flush-at-EOF batch graph."""

    stream_filter = True

    def __init__(self, start=0, stop=0, start_mode="add",
                 stop_mode="add", start_duration=0, stop_duration=0,
                 color="black", src_fps: float = 30.0):
        modes = {"add": 0, "clone": 1, "0": 0, "1": 1}
        if str(start_mode) not in modes or str(stop_mode) not in modes:
            raise FilterError("tpad: mode must be add or clone")
        self.start_mode = modes[str(start_mode)]
        self.stop_mode = modes[str(stop_mode)]
        self.pad_start = int(start)
        self.pad_stop = int(stop)
        if self.pad_stop < 0:
            raise FilterError("tpad: stop=-1 (infinite padding) is not "
                              "supported in the batch graph")
        fps = float(src_fps) or 30.0
        self._fps = fps
        if _dur_seconds(start_duration):
            self.pad_start = int(round(_dur_seconds(start_duration) * fps))
        if _dur_seconds(stop_duration):
            self.pad_stop = int(round(_dur_seconds(stop_duration) * fps))
        self.rgba = _parse_color_rgba(str(color).strip().lower())
        self._pts_step = None
        self._pts_step_t = 0.0
        self._started = False
        self._last = None            # (planes dict, meta row) for stop
        self._geom = None            # (format, w, h, colorspace)

    def _color_planes(self, fmt, like, count):
        """ff_draw_color fill (drawutils.c:159-204): double-precision
        conversion at the format's depth — BT.601/SMPTE170M
        limited-range for YUV, identity full-range for RGB
        (ff_draw_init2's UNSPECIFIED defaults), val = trunc(x*max+0.5).
        `like`: a plane dict giving each plane's shape, dtype and
        device."""
        r, g, b, a = (c / 255.0 for c in self.rgba)
        mx = (1 << fmt.bits) - 1
        if fmt.is_rgb:
            if fmt.is_float:
                raise FilterError("tpad: color padding needs an 8-16 "
                                  "bit format (ff_draw_init2 rejects "
                                  "float depths)")
            comp = {"r": r, "g": g, "b": b, "a": a}
            vals = {nm: [int(comp[c] * mx + 0.5)
                         for c in (fmt.channel_order or "rgb")]
                    for nm in like}
        else:
            cr, cg, cb = 0.299, 0.587, 0.114
            y = cr * r + cg * g + cb * b
            bs, rs = 0.5 / (cb - 1.0), 0.5 / (cr - 1.0)
            u = bs * cr * r + bs * cg * g + 0.5 * b
            v = 0.5 * r + rs * cg * g + rs * cb * b
            yuv = {"y": (y * 219 / 255 + 16 / 255),
                   "u": (u * 224 / 255 + 128 / 255),
                   "v": (v * 224 / 255 + 128 / 255), "a": a}
            vals = {nm: int(yuv.get(nm, 0.0) * mx + 0.5) for nm in like}
        out = {}
        for nm, p in like.items():
            c = torch.as_tensor(vals[nm], dtype=torch.int32,
                                device=p.device)
            out[nm] = c.expand((count,) + tuple(p.shape[1:])).to(p.dtype)
        return out

    def process_batch(self, fb: FrameBatch, meta):
        # compact upstream drops / batch padding: the C only ever sees
        # (and clones for stop padding) frames actually delivered
        fb, meta = _compact_alive(fb, meta)
        pts = meta.get("pts")
        times = meta.get("times")
        if self._pts_step is None:
            if pts is not None and len(pts) > 1:
                d = np.diff(np.asarray(pts, np.int64))
                self._pts_step = int(np.median(d)) if len(d) else 1
            else:
                self._pts_step = 1
            self._pts_step_t = (float(np.median(np.diff(times)))
                                if times is not None and len(times) > 1
                                else (1.0 / self._fps
                                      if times is not None else 0.0))
        n = fb.batch
        if n:
            self._geom = (fb.format, fb.width, fb.height, fb.colorspace)
            if self.pad_stop:
                self._last = ({k: v[n - 1:n] for k, v in fb.planes.items()},
                              _meta_take(meta, slice(n - 1, n)))
        out_fb, out_meta = fb, dict(meta)
        if pts is not None and self.pad_start:
            out_meta["pts"] = (np.asarray(pts)
                               + self.pad_start * self._pts_step)
        if times is not None and self.pad_start:
            # keep the seconds track consistent with the shifted pts
            out_meta["times"] = (np.asarray(times)
                                 + self.pad_start * self._pts_step_t)
        if not self._started and n:
            self._started = True
            k = self.pad_start
            if k:
                if self.start_mode == 1:          # clone the FIRST frame
                    pads = {nm: _repeat_frames(v[:1], k)
                            for nm, v in fb.planes.items()}
                else:
                    pads = self._color_planes(fb.fmt, fb.planes, k)
                pad_pts = np.arange(k, dtype=np.int64) * self._pts_step
                pmeta = {}
                for key, arr in out_meta.items():
                    if arr is None:
                        pmeta[key] = None
                    elif key == "pts":
                        pmeta[key] = pad_pts.astype(np.asarray(arr).dtype)
                    elif key == "keep":
                        pmeta[key] = np.ones(k, bool)
                    elif key == "pad":
                        pmeta[key] = np.zeros(k, bool)
                    elif key == "times":
                        pmeta[key] = (np.arange(k) * self._pts_step_t) \
                            .astype(np.asarray(arr).dtype)
                    else:
                        pmeta[key] = np.zeros(k, np.asarray(arr).dtype)
                out_fb = fb.with_planes(
                    {nm: _cat_frames(pads[nm], v)
                     for nm, v in out_fb.planes.items()})
                out_meta = _meta_concat(pmeta, out_meta)
        return out_fb, out_meta

    def flush(self):
        if not self.pad_stop or self._last is None:
            return None              # C: no cached frame -> plain EOF
        k = self.pad_stop
        planes1, meta1 = self._last
        if self.stop_mode == 1:
            planes = {nm: _repeat_frames(v, k) for nm, v in planes1.items()}
        else:
            planes = self._color_planes(F.get(self._geom[0]), planes1, k)
        step = self._pts_step or 1
        last_pts = meta1.get("pts")
        start = (int(np.asarray(last_pts)[0]) + self.pad_start * step
                 + step) if last_pts is not None else 0
        meta = {}
        for key, arr in meta1.items():
            if arr is None:
                meta[key] = None
            elif key == "pts":
                meta[key] = (start + np.arange(k, dtype=np.int64)
                             * step).astype(np.asarray(arr).dtype)
            elif key == "keep":
                meta[key] = np.ones(k, bool)
            elif key == "pad":
                meta[key] = np.zeros(k, bool)
            else:
                meta[key] = np.repeat(np.asarray(arr)[:1], k, axis=0)
        fmt, w, h, cs = self._geom
        return FrameBatch(planes, fmt, w, h, cs), meta


class LoopFilter:
    """f_loop.c video `loop` analog: buffer `size` frames on the batch's
    device and replay them `loop` times in the middle of the stream.

    Kept from the C: the recording gate is frame_count_out >= start
    (:361) where frame_count_out is the POST-increment count, so
    recording starts at input frame index max(0, start-1).  Buffered
    frames pass through with their original pts while recording; each
    replayed clone gets pts += duration - start_pts and carries its
    source frame's props (push_frame :322-350) with duration = last
    recorded pts + one frame duration; after every full cycle duration
    advances to the cycle's end and loop decrements; frames after the
    loop (and before `start`) get pts += duration (:381-383).  EOF
    before the buffer fills truncates size to nb_frames and replays what
    was captured (activate :404-407).

    One frame duration is the inferred median pts step (if the buffer
    fills before any step is observable, the replay is deferred until
    the next frame or EOF reveals one); loop=-1 (infinite) is rejected
    like tpad's stop=-1; total replayed frames are capped."""

    stream_filter = True
    _MAX_CLONES = 16384

    def __init__(self, loop=0, size=0, start=0):
        self.loop = int(loop)
        self.size = int(size)
        self.start = int(start)
        if self.loop < 0:
            raise FilterError("loop: loop=-1 (infinite) is not "
                              "supported in the batch graph")
        if not 0 <= self.size <= 32767:
            raise FilterError("loop: size out of [0, INT16_MAX]")
        if self.start < 0:
            raise FilterError("loop: start must be >= 0")
        if self.loop * self.size > self._MAX_CLONES:
            raise FilterError(f"loop: loop*size exceeds "
                              f"{self._MAX_CLONES} materialized frames")
        self._buf = []            # (planes row, meta row, pts, time)
        self._count = 0           # frame_count_out analog (post-incr)
        self._duration = 0        # accumulated pts shift state
        self._duration_t = 0.0
        self._start_pts = 0
        self._start_t = 0.0
        self._step = None
        self._step_t = 0.0
        self._geom = None
        self._last_pts = None
        self._last_t = None
        self._pending = False     # buffer full before a step was known

    def _infer_step(self, pts, times):
        """Median frame duration, carrying the previous batch's tail so
        single-frame batches still infer one."""
        if self._step is None and len(pts):
            seq = ([self._last_pts] if self._last_pts is not None
                   else []) + list(pts)
            d = np.diff(seq)
            if len(d):
                self._step = int(np.median(d))
            if times is not None:
                tq = ([self._last_t] if self._last_t is not None
                      else []) + [float(t) for t in times]
                if len(tq) > 1:
                    self._step_t = float(np.median(np.diff(tq)))
        if len(pts):
            self._last_pts = int(pts[-1])
            if times is not None:
                self._last_t = float(times[-1])

    def _push_cycles(self, rows, out_pts, out_times, metas):
        """Replay full buffer cycles until loop hits 0 (push_frame)."""
        step, step_t = (self._step or 1), self._step_t
        self._duration = self._buf[-1][2] + step
        self._duration_t = self._buf[-1][3] + step_t
        while self.loop != 0 and self._buf:
            for planes, mrow, bpts, bt in self._buf:
                rows.append(planes)
                metas.append(mrow)
                out_pts.append(bpts + self._duration - self._start_pts)
                out_times.append(bt + self._duration_t - self._start_t)
            self._duration = out_pts[-1] + step
            self._duration_t = out_times[-1] + step_t
            if self.loop > 0:
                self.loop -= 1
        self._pending = False

    def process_batch(self, fb: FrameBatch, meta):
        alive = np.asarray(meta["keep"]).copy()
        if meta.get("pad") is not None:
            alive &= ~np.asarray(meta["pad"])
        n_alive = int(alive.sum())
        raw_pts = meta.get("pts")
        raw_times = meta.get("times")
        apts = (np.asarray(raw_pts, np.int64)[alive]
                if raw_pts is not None
                else np.arange(n_alive, dtype=np.int64))
        atimes = (np.asarray(raw_times, np.float64)[alive]
                  if raw_times is not None else None)
        self._infer_step(apts, atimes)
        if fb.batch:
            self._geom = (fb.format, fb.width, fb.height, fb.colorspace)
        # fast path: no frame in this batch can record and no replay is
        # pending -> passthrough with a uniform pts shift
        if ((self.size == 0 or self.loop == 0 or
             (not self._buf and self._count + n_alive < self.start))
                and not self._pending):
            self._count += n_alive
            out = dict(meta)
            if self._duration and raw_pts is not None:
                out["pts"] = np.asarray(raw_pts) + self._duration
            if self._duration_t and raw_times is not None:
                out["times"] = np.asarray(raw_times) + self._duration_t
            return fb, out
        idx = np.nonzero(alive)[0]
        if len(idx) < fb.batch:
            fb = fb.with_planes(_take_frames(fb.planes, idx))
            meta = _meta_take(meta, idx)
        n = fb.batch
        pts, times = apts, atimes
        rows, out_pts, out_times, metas = [], [], [], []
        if self._pending and n:
            self._push_cycles(rows, out_pts, out_times, metas)
        for i in range(n):
            frame = {nm: v[i:i + 1] for nm, v in fb.planes.items()}
            mrow = _meta_take(meta, slice(i, i + 1))
            t_i = float(times[i]) if times is not None else 0.0
            self._count += 1
            if (self._count >= self.start and self.size > 0
                    and self.loop != 0 and len(self._buf) < self.size):
                if not self._buf:
                    self._start_pts = int(pts[i])
                    self._start_t = t_i
                self._buf.append((frame, mrow, int(pts[i]), t_i))
                rows.append(frame)
                metas.append(mrow)
                out_pts.append(int(pts[i]))
                out_times.append(t_i)
                if len(self._buf) == self.size:
                    if self._step is None:
                        self._pending = True
                    else:
                        self._push_cycles(rows, out_pts, out_times, metas)
            else:
                rows.append(frame)
                metas.append(mrow)
                out_pts.append(int(pts[i]) + self._duration)
                out_times.append(t_i + self._duration_t)
        if not rows:
            return _empty_like(fb), _meta_take(meta, slice(0, 0))
        return self._assemble(rows, out_pts, out_times, metas)

    def _assemble(self, rows, out_pts, out_times, metas):
        fmt, w, h, cs = self._geom
        return (FrameBatch(_cat_rows(rows), fmt, w, h, cs),
                _row_meta(metas, len(rows), out_pts, out_times))

    def flush(self):
        # EOF with a pending (deferred) replay, or before the buffer
        # filled: size truncates to what was captured and the replay
        # happens at EOF (activate :404-415)
        fire = (self._buf and self.loop != 0
                and (self._pending or len(self._buf) < self.size))
        if not fire:
            return None
        self.size = len(self._buf)
        rows, out_pts, out_times, metas = [], [], [], []
        self._push_cycles(rows, out_pts, out_times, metas)
        self._buf = []
        if not rows:
            return None
        return self._assemble(rows, out_pts, out_times, metas)


class FadeFilter:
    """ffmpeg fade (vf_fade.c): fade in/out to black (or a color, or
    alpha-only) with the reference's exact 16.16 fixed-point math.

    Per-frame state machine (vf_fade.c:443-496 filter_frame): WAITING ->
    FADING -> DONE; factor 0..65535, frame-count based
    ((n - start_frame) * (65536//nb_frames)) or time based
    ((t - t0) * 65535 / duration); fade-out inverts.  Pixel math (int32
    on the batch's device):
      luma/black: p = ((p - bl)*factor + (bl<<16) + 32768) >> 16,
                  bl = 16<<(depth-8) on studio-range YUV, 0 on RGB
      chroma:     p = ((p - mid)*factor + ((mid*2+1)<<15)) >> 16
      color fade: clip(((c<<16) + (p - c)*factor + 32768) >> 16) per
                  channel (RGB formats only, like query_formats)
      alpha=1:    only the alpha channel fades (bl = 0)
    The whole batch applies as one where(factor<65535) op with a
    per-frame factor column.  Frame counting skips frames an upstream
    select dropped."""

    stream_filter = True

    def __init__(self, type="in", start_frame=0, nb_frames=25, alpha=0,
                 start_time=0.0, duration=0.0, color="black"):
        t = str(type).lower()
        if t in ("in", "0"):
            self.fade_out = False
        elif t in ("out", "1"):
            self.fade_out = True
        else:
            raise FilterError(f"fade type must be in|out, got {type!r}")
        self.start_frame = int(start_frame)
        self.nb_frames = max(1, int(nb_frames))
        self.alpha = bool(int(alpha))
        self.start_time = float(start_time)
        self.duration = float(duration)
        self.rgba = _parse_color(color if color is not None else "black")
        self.black = tuple(int(v) for v in self.rgba) == (0, 0, 0)
        self.state = 0              # 0 WAITING, 1 FADING, 2 DONE
        self.n = 0                  # alive frames seen (frame_count_out)
        self._t0 = self.start_time  # start_time_pts analog (seconds)

    def _factor(self, idx, t):
        """One frame through the vf_fade state machine; returns 0..65535."""
        factor = 65535
        if self.state == 0:
            factor = 0
            if ((self.start_time == 0.0 or (t is not None
                                            and t >= self.start_time))
                    and idx >= self.start_frame):
                self.state = 1
                # anchor swaps, vf_fade.c:456-464
                if self.start_time == 0.0 and self.start_frame != 0:
                    self._t0 = t if t is not None else 0.0
                if self.start_time != 0.0 and self.start_frame == 0:
                    self.start_frame = idx
        if self.state == 1:
            if self.duration == 0.0:
                factor = (idx - self.start_frame) * (65536 // self.nb_frames)
                if idx > self.start_frame + self.nb_frames:
                    self.state = 2
            else:
                factor = int((t - self._t0) * 65535.0 / self.duration)
                if t > self._t0 + self.duration:
                    self.state = 2
        if self.state == 2:
            factor = 65535
        factor = min(max(factor, 0), 65535)
        return 65535 - factor if self.fade_out else factor

    def process_batch(self, fb: FrameBatch, meta):
        fmt = fb.fmt
        if fmt.is_float or fmt.name in ("p010", "p016", "gray8") or \
                (fmt.is_rgb and fmt.bits > 8):
            raise FilterError(f"fade: unsupported format {fmt.name} "
                              "(vf_fade.c pix_fmts); convert first")
        times = meta.get("times")
        if times is None and (self.start_time or self.duration):
            raise FilterError("fade: start_time/duration are in seconds "
                              "and need a times track")
        if self.alpha and not (fmt.is_rgb and "a" in fmt.channel_order):
            raise FilterError(f"fade alpha=1 needs an alpha channel; "
                              f"{fmt.name} has none (convert first)")
        keep = meta.get("keep")
        factors = np.full(fb.batch, 65535, np.int64)
        for i in range(fb.batch):
            if keep is not None and not keep[i]:
                continue
            t = None if times is None else float(times[i])
            factors[i] = self._factor(self.n, t)
            self.n += 1
        if np.all(factors == 65535):        # steady passthrough, no op
            return fb, meta
        dev = fb.device
        f = torch.as_tensor(factors[:, None, None].astype(np.int32),
                            device=dev)
        live = torch.as_tensor((factors < 65535)[:, None, None], device=dev)
        planes = dict(fb.planes)
        if fmt.is_rgb:
            planes["rgb"] = self._fade_rgb(fb.planes["rgb"],
                                           fmt.channel_order, f, live)
        else:
            depth = fmt.bits
            bl = 16 << (depth - 8)
            bls = (bl << 16) + 32768
            mid = 1 << (depth - 1)
            # vf_fade.c:320 ships the literal 8421367 for 8-bit chroma
            # (the comment's formula gives 8421376); >8-bit uses the
            # formula (vf_fade.c:337-338), whose int `add` wraps at 16 bit
            add = 8421367 if depth == 8 else ((mid << 1) + 1) << 15
            if add >= (1 << 31):
                add -= 1 << 32
            for p in fmt.planes:
                arr = fb.planes[p.name]
                p32 = arr.to(torch.int32)
                if p.name == "y":
                    fad = ((p32 - bl) * f + bls) >> 16
                else:
                    fad = ((p32 - mid) * f + add) >> 16
                planes[p.name] = torch.where(live, fad, p32).to(arr.dtype)
        return fb.with_planes(planes), meta

    def _fade_rgb(self, arr, order, f, live):
        p32 = arr.to(torch.int32)
        fl, lv = f[..., None], live[..., None]
        if self.alpha and "a" in order:
            a = p32[..., order.index("a")]
            fad = (a * f + 32768) >> 16
            return set_channels(arr, order,
                                {"a": torch.where(live, fad, a)})
        if self.black:
            fad = (p32 * fl + 32768) >> 16
            return torch.where(lv, fad, p32).to(arr.dtype)
        cvals = {"r": int(self.rgba[0]), "g": int(self.rgba[1]),
                 "b": int(self.rgba[2]), "a": 255}
        c = torch.as_tensor([cvals[ch] for ch in order], dtype=torch.int32,
                            device=arr.device)
        fad = torch.clamp(((c << 16) + (p32 - c) * fl + 32768) >> 16, 0, 255)
        out = torch.where(lv, fad, p32)
        if "a" in order:                    # alpha untouched (do_alpha=0)
            ai = order.index("a")
            out = set_channels(out, order, {"a": p32[..., ai]})
        return out.to(arr.dtype)


def _f_fade(type="in", t=None, start_frame=None, s=None, nb_frames=None,
            n=None, alpha=0, start_time=None, st=None, duration=None,
            d=None, color=None, c=None):
    """Builder resolving the AVOption short aliases (t/s/n/st/d/c)."""
    return FadeFilter(
        type=t if t is not None else type,
        start_frame=s if s is not None else
        (start_frame if start_frame is not None else 0),
        nb_frames=n if n is not None else
        (nb_frames if nb_frames is not None else 25),
        alpha=alpha,
        start_time=st if st is not None else
        (start_time if start_time is not None else 0.0),
        duration=d if d is not None else
        (duration if duration is not None else 0.0),
        color=c if c is not None else color)


_NANF = float("nan")


class BlendFilter:
    """blend / tblend (vf_blend.c analog) — two-source compositing with
    the full 39-mode family of blend_modes.c (ops/blend.py, on the
    batch's device), per-component modes, opacities, and per-pixel
    expressions.

    blend: the TOP stream is the main graph; the BOTTOM comes from
    ``video=FILE`` (decoded in lockstep; ff_framesync_dualinput_get,
    vf_blend.c:229-243), with framesync eof_action repeat (default) |
    pass | endall when the bottom ends first.  Dims must match
    (config_output EINVAL, vf_blend.c:330-338).

    tblend: TOP = current frame, BOTTOM = previous frame; the first
    frame is consumed without output (tblend_filter_frame,
    vf_blend.c:427-446); earlier select drops never reach the pair
    window.

    Component mapping follows the C plane order: c0/c1/c2 = Y/U/V
    (+c3 = A) for YUV, c0 for gray, and G/B/R(/A) for float RGB (GBRP
    plane order).  ``all_mode`` >= 0 overrides every component's mode;
    ``all_opacity`` < 1 overrides opacities (config_params,
    vf_blend.c:290-297).  Expressions (cN_expr/all_expr) override modes
    per component and are evaluated per pixel on the host with vars
    X/Y/W/H/SW/SH/T/N/A/B/TOP/BOTTOM (vf_blend.c:51) — exact but slow,
    like the reference's av_expr_eval path.

    Integer stores replicate the C float->PIXEL conversion (truncation
    with low-bits wrap — ops/blend._trunc_store)."""

    stream_filter = True

    def __init__(self, tblend=False, video="", vw=0, vh=0,
                 eof_action="repeat", shortest=0, all_mode=-1,
                 all_expr=None, all_opacity=1.0, **kw):
        from ..ops import blend as BL
        self.tblend = bool(tblend)
        self.video = str(video)
        self.vw, self.vh = int(vw), int(vh)
        if self.tblend:
            if self.video:
                raise FilterError("tblend takes no video= (temporal blend)")
        elif not self.video:
            raise FilterError("blend needs video=FILE (the bottom stream)")
        self.eof_action = "endall" if int(shortest) else str(eof_action)
        if self.eof_action not in ("repeat", "pass", "endall"):
            raise FilterError(f"blend eof_action {self.eof_action!r}")

        def parse_mode(v, dflt):
            if v is None:
                return dflt
            s = str(v)
            if s.lstrip("-").isdigit():
                i = int(s)
                if i == -1:
                    return -1
                if not 0 <= i < len(BL.MODE_ENUM):
                    raise FilterError(f"blend mode {i} out of range")
                return BL.MODE_ENUM[i]
            if s not in BL.MODE_NAMES:
                raise FilterError(f"unknown blend mode {s!r}")
            return BL.MODE_NAMES[s]

        amode = parse_mode(all_mode, -1)
        aopa = float(all_opacity)
        if not 0.0 <= aopa <= 1.0:
            raise FilterError("blend all_opacity must be in [0,1]")
        self.params = []
        for i in range(4):
            mode = parse_mode(kw.pop(f"c{i}_mode", None), "normal")
            opa = float(kw.pop(f"c{i}_opacity", 1.0))
            if not 0.0 <= opa <= 1.0:
                raise FilterError(f"blend c{i}_opacity must be in [0,1]")
            expr = kw.pop(f"c{i}_expr", None)
            # config_params: all_mode >= 0 overrides; all_opacity < 1
            # overrides; all_expr fills unset exprs (vf_blend.c:290-303)
            if amode != -1:
                mode = amode
            if aopa < 1.0:
                opa = aopa
            if expr is None and all_expr is not None:
                expr = all_expr
            e = compile_expr(str(expr)) if expr is not None else None
            self.params.append((mode, opa, e))
        if kw:
            raise FilterError(f"blend: unknown options {sorted(kw)}")
        self._gen = None
        self._last_bottom = None   # host plane dict (eof repeat)
        self._ended = False
        self._prev = None          # tblend carried frame (device planes)
        self._prev_meta = None
        self._n = 0                # inlink frame_count_out analog

    def _next_bottom(self):
        if self._gen is None:
            self._gen = _second_stream(self.video, self.vw, self.vh,
                                       "bottom video")
        try:
            f = next(self._gen)
            self._last_bottom = f
            return f
        except StopIteration:
            return None

    @staticmethod
    def _plane_params(fmt):
        """[(plane_key, channel_index_or_None, param_idx)] in C plane
        order: YUV y/u/v(/a) = 0/1/2(/3); float RGB channels in GBRP
        plane order G/B/R/A = 0/1/2/3."""
        if fmt.is_rgb:
            order = fmt.channel_order          # "rgb" / "rgba"
            out = [("rgb", order.index("g"), 0), ("rgb", order.index("b"), 1),
                   ("rgb", order.index("r"), 2)]
            if "a" in order:
                out.append(("rgb", order.index("a"), 3))
            return out
        return [(p.name, None, i) for i, p in enumerate(fmt.planes)]

    @staticmethod
    def _eval_expr(e, top, bottom, depth, is_float, fw, fh, t, n):
        """Per-pixel host evaluation (DEFINE_BLEND_EXPR, vf_blend.c:127-
        160): dst = av_expr_eval(...), int stores truncate/wrap."""
        tnp = top.cpu().numpy()
        bnp = bottom.cpu().numpy()
        h, w = tnp.shape
        out = np.empty_like(tnp)
        env = {"W": float(w), "H": float(h), "SW": w / float(fw),
               "SH": h / float(fh), "T": t, "N": float(n)}
        for yy in range(h):
            env["Y"] = float(yy)
            for xx in range(w):
                env["X"] = float(xx)
                env["A"] = env["TOP"] = float(tnp[yy, xx])
                env["B"] = env["BOTTOM"] = float(bnp[yy, xx])
                v = e(env)
                if is_float:
                    out[yy, xx] = np.float32(v)
                else:
                    # C (PIXEL)(double): cvttsd2si + low bits
                    if not np.isfinite(v) or not (-2**31 <= v < 2**31):
                        i = -2**31
                    else:
                        i = int(v)      # trunc toward zero
                    out[yy, xx] = i & ((1 << (8 if depth <= 8 else 16)) - 1)
        return out

    def _blend_batch(self, fb, bottom_planes, times, n0):
        """Blend full batches plane by plane; bottom_planes are stacked
        tensors on the batch's device matching fb.planes."""
        from ..ops import blend as BL
        fmt = fb.fmt
        depth = fmt.bits
        out = dict(fb.planes)
        for key, chan, pidx in self._plane_params(fmt):
            mode, opa, e = self.params[pidx]
            top = fb.planes[key] if chan is None \
                else fb.planes[key][..., chan]
            bot = bottom_planes[key] if chan is None \
                else bottom_planes[key][..., chan]
            if e is not None:
                frames = []
                for i in range(top.shape[0]):
                    t = float(times[i]) if times is not None else _NANF
                    frames.append(self._eval_expr(
                        e, top[i], bot[i], depth, fmt.is_float,
                        fb.width, fb.height, t, n0 + i))
                res = torch.as_tensor(np.stack(frames), device=fb.device)
            else:
                res = BL.blend_plane(top, bot, mode, opa, depth)
            if chan is None:
                out[key] = res
            else:
                o = out[key].clone()
                o[..., chan] = res
                out[key] = o
        return fb.with_planes(out)

    def process_batch(self, fb: FrameBatch, meta):
        fmt = fb.fmt
        if fmt.is_rgb and not fmt.is_float:
            raise FilterError("blend: packed integer RGB unsupported "
                              "(vf_blend.c pix_fmts — planar YUV/gray/"
                              "float RGB); insert format= first")
        if fb.format in ("nv12", "p010", "p016"):
            raise FilterError(f"blend: {fb.format} unsupported")
        fb, meta = _compact_alive(fb, meta)
        v = fb.batch
        if v == 0:
            return _empty_like(fb), meta
        times = meta.get("times")

        if self.tblend:
            ext = {k: (_cat_frames(self._prev[k], p)
                       if self._prev is not None else p)
                   for k, p in fb.planes.items()}
            m = next(iter(ext.values())).shape[0]
            self._prev = {k: p[-1:] for k, p in ext.items()}
            if m < 2:
                self._n += v
                return _empty_like(fb), _meta_take(meta, slice(0, 0))
            tops = {k: p[1:] for k, p in ext.items()}
            bots = {k: p[:-1] for k, p in ext.items()}
            count = m - 1
            # output props follow the TOP (current) frame: the last
            # `count` frames of this batch
            out_meta = _meta_take(meta, slice(v - count, v))
            first = self._prev_meta is None
            n0 = self._n + (1 if first else 0)
            self._n += v
            self._prev_meta = True
            return (self._blend_batch(fb.with_planes(tops), bots,
                                      out_meta.get("times"), n0), out_meta)

        # dual input: one bottom frame per surviving top frame
        bots, keep_rows, passthru = [], [], []
        for i in range(v):
            f = None if self._ended else self._next_bottom()
            if f is None:
                if self.eof_action == "repeat" and self._last_bottom:
                    f = self._last_bottom
                elif self.eof_action == "pass":
                    passthru.append(i)
                    bots.append(None)
                    keep_rows.append(True)
                    continue
                else:                   # endall
                    self._ended = True
                    keep_rows.append(False)
                    bots.append(None)
                    continue
            bots.append(f)
            keep_rows.append(True)
        n0 = self._n
        self._n += v
        keep_np = np.array(keep_rows, bool)
        if not keep_np.any():
            meta = dict(meta)
            meta["keep"] = np.zeros(v, bool)
            return fb, meta
        if not keep_np.all():
            sel = np.nonzero(keep_np)[0]
            fb = fb.with_planes(_take_frames(fb.planes, sel))
            meta = _meta_take(meta, sel)
            bots = [bots[i] for i in sel]
            times = meta.get("times")
        blend_rows = [i for i in range(len(bots)) if bots[i] is not None]
        if not blend_rows:
            return fb, meta
        bfbs = self._bottom_batch(fb, [bots[i] for i in blend_rows])
        sub = fb if len(blend_rows) == len(bots) else fb.with_planes(
            _take_frames(fb.planes, blend_rows))
        sub_times = None if times is None else \
            np.asarray(times)[blend_rows]
        blended = self._blend_batch(sub, bfbs, sub_times, n0)
        if len(blend_rows) == len(bots):
            return blended, meta
        rows = torch.as_tensor(np.asarray(blend_rows, np.int64),
                               device=fb.device)

        def put(dst, src):
            o = dst.clone()
            o[rows] = src
            return o
        return fb.with_planes({k: same_bits(put, p, blended.planes[k])
                               for k, p in fb.planes.items()}), meta

    def _bottom_batch(self, fb, frames):
        """Stack decoded bottom frames on the batch's device and conform
        them to the main stream's format (format negotiation analog);
        dims must already match (config_output EINVAL,
        vf_blend.c:330-338)."""
        from ..core.frame import from_numpy_yuv420
        ys = np.stack([f["y"] for f in frames])
        us = np.stack([f["u"] for f in frames])
        vs = np.stack([f["v"] for f in frames])
        bh, bw = ys.shape[1], ys.shape[2]
        if (bw, bh) != (fb.width, fb.height):
            raise FilterError(
                f"blend: bottom video {bw}x{bh} does not match the top "
                f"stream {fb.width}x{fb.height} (vf_blend.c config_output)")
        bfb = from_numpy_yuv420(ys, us, vs, colorspace=fb.colorspace,
                                device=fb.device)
        if bfb.format != fb.format:
            bfb = csc.convert(bfb, fb.format)
        return bfb.planes

    def flush(self):
        return None


class MetricFilter:
    """psnr / ssim reference-comparison filters (libavfilter vf_psnr.c /
    vf_ssim.c analogs).  Frames pass through unchanged; every kept frame
    is scored against the matching frame of a reference stream
    (``video=FILE``) with batched f32 reductions on the batch's device
    (ops/metrics.py), the per-frame values read back to the host.

    Options:
      video=FILE      the reference (pristine) stream, frame-locked 1:1
      stats_file=F    per-frame lines (``n:1 psnr_y:.. ssim_all:..``)
      win=8           ssim window (non-overlapping blocks — the fast
                      monitoring variant; ffmpeg slides 8x8 per pixel)

    Summary prints to stderr at EOF like ffmpeg's av_log summary."""

    stream_filter = True

    def __init__(self, kind, video="", stats_file="", vw=0, vh=0, win=8):
        if not video:
            raise FilterError(f"{kind} needs video=FILE (the reference "
                              f"stream: {kind}=video=ref.mp4)")
        self.kind = kind
        self.video = str(video)
        self.vw, self.vh = int(vw), int(vh)
        self.win = int(win)
        self._stats_path = str(stats_file)
        self._stats = None
        self._gen = None
        self._n = 0
        self._sums = {}            # plane -> running metric sum
        self._mse_sums = {}        # plane -> running mse sum (psnr avg)
        self._ref_ended = False

    def _next_ref(self):
        if self._gen is None:
            self._gen = _second_stream(self.video, self.vw, self.vh,
                                       "reference")
        try:
            return next(self._gen)
        except StopIteration:
            return None

    def _scores(self, mains, refs):
        from ..ops import metrics as M
        if self.kind == "psnr":
            return {k: torch.mean((mains[k].to(torch.float32)
                                   - refs[k].to(torch.float32)) ** 2,
                                  dim=tuple(range(1, mains[k].ndim)))
                    for k in mains}
        return {k: M.ssim(mains[k], refs[k], win=self.win) for k in mains}

    def process_batch(self, fb: FrameBatch, meta):
        keep = np.asarray(meta["keep"])
        if fb.format not in ("yuv420p", "yuv422p", "yuv444p", "gray8"):
            raise FilterError(
                f"{self.kind} main format {fb.format} unsupported — "
                "insert format=yuv420p upstream (vf_psnr YUV semantics)")
        idx = np.nonzero(keep)[0]
        if not len(idx) or self._ref_ended:
            return fb, meta
        planes = [p for p in ("y", "u", "v") if p in fb.planes]
        refs = {p: [] for p in planes}
        scored = []
        for i in idx:
            r = self._next_ref()
            if r is None:
                if not self._ref_ended:
                    import sys as _sys
                    print(f"warning: {self.kind} reference stream ended "
                          f"after {self._n + len(scored)} frames; later "
                          "frames are unscored", file=_sys.stderr)
                self._ref_ended = True
                break
            for p in planes:
                if (p not in r
                        or r[p].shape != tuple(fb.planes[p].shape[1:])):
                    raise FilterError(
                        f"{self.kind} reference plane {p!r} "
                        f"{r.get(p) is not None and r[p].shape} != main "
                        f"{tuple(fb.planes[p].shape[1:])} — match the "
                        "reference's size and subsampling")
            scored.append(int(i))
            for p in planes:
                refs[p].append(r[p])
        if not scored:
            return fb, meta
        rows = torch.as_tensor(np.asarray(scored, np.int64),
                               device=fb.device)
        mains = {p: fb.planes[p].index_select(0, rows) for p in planes}
        refd = {p: torch.as_tensor(np.stack(refs[p]), device=fb.device)
                for p in planes}
        out = {k: v.cpu().numpy() for k, v in
               self._scores(mains, refd).items()}
        mv = (1 << fb.fmt.bits) - 1
        self._mv = float(mv)
        # summary weights = per-plane sample counts (ffmpeg's average
        # PSNR weighs MSE by samples: 4:1:1 for 420, equal for 444)
        self._wts = {p: float(np.prod(fb.planes[p].shape[1:]))
                     for p in planes}
        for j in range(len(scored)):
            n = self._n + 1
            vals = {}
            for p in planes:
                if self.kind == "psnr":
                    mse = float(out[p][j])
                    vals[f"mse_{p}"] = mse
                    vals[f"psnr_{p}"] = (10.0 * np.log10(
                        (mv * mv) / max(mse, 1e-10)))
                    self._mse_sums[p] = self._mse_sums.get(p, 0.0) + mse
                else:
                    vals[f"ssim_{p}"] = float(out[p][j])
                    self._sums[p] = self._sums.get(p, 0.0) + float(out[p][j])
            if self._stats_path:
                if self._stats is None:
                    self._stats = open(self._stats_path, "w")
                self._stats.write(
                    f"n:{n} " + " ".join(f"{k}:{v:.4f}"
                                         for k, v in vals.items()) + "\n")
            self._n = n
        return fb, meta

    def flush(self):
        import sys as _sys
        if self._stats is not None:
            self._stats.close()
            self._stats = None
        if self._gen is not None:
            self._gen.close()          # release the reference decoder
            self._gen = None
        if not self._n:
            return None
        planes = sorted(set(list(self._mse_sums) + list(self._sums)),
                        key="yuv".index)
        w = getattr(self, "_wts", {p: 1.0 for p in planes})
        tw = sum(w.values())
        if self.kind == "psnr":
            mv = getattr(self, "_mv", 255.0)
            parts, wmse = [], 0.0
            for p in planes:
                mse = self._mse_sums[p] / self._n
                parts.append(
                    f"{p}:{10.0 * np.log10(mv * mv / max(mse, 1e-10)):.2f}")
                wmse += w[p] * mse
            avg = 10.0 * np.log10(mv * mv / max(wmse / tw, 1e-10))
            print(f"PSNR {' '.join(parts)} average:{avg:.2f} "
                  f"frames:{self._n}", file=_sys.stderr)
        else:
            parts = []
            alls = 0.0
            for p in planes:
                m = self._sums[p] / self._n
                parts.append(f"{p}:{m:.4f}")
                alls += w[p] * m
            print(f"SSIM {' '.join(parts)} All:{alls / tw:.4f} "
                  f"frames:{self._n}", file=_sys.stderr)
        return None


def _f_psnr(video="", stats_file="", vw=0, vh=0):
    """Per-frame PSNR against a reference stream (vf_psnr analog):
    psnr=video=ref.mp4[:stats_file=f.log].  Summary (y/u/v +
    sample-weighted average dB) prints at EOF."""
    return MetricFilter("psnr", video=video, stats_file=stats_file,
                        vw=vw, vh=vh)


def _f_ssim(video="", stats_file="", vw=0, vh=0, win=8):
    """Per-frame SSIM against a reference stream (vf_ssim analog):
    ssim=video=ref.mp4[:stats_file=f.log][:win=8].  Non-overlapping
    win x win blocks (fast monitoring variant); summary at EOF."""
    return MetricFilter("ssim", video=video, stats_file=stats_file,
                        vw=vw, vh=vh, win=win)


# ---- overlay and in-graph inference ---------------------------------------

class OverlayFilter:
    """overlay / overlay_cuda analog with a real second input.

    Mirrors vf_overlay_cuda.c's dual-input framesync design
    (ff_framesync_dualinput_get, :226-245): the main stream flows through
    the graph; the overlay source is either a second *video stream*
    (``video=FILE``, decoded on the host in lockstep, one overlay frame
    per main frame) or a still image (``path=FILE``: .jpg through
    av/jpeg.py, .png with its alpha through the toolkit's decoder; both
    need libav*).  The blend runs on the batch's device in the YUV domain
    on 4:2:0 planes exactly like the reference kernel (ops/overlay.py),
    or on packed RGB when the main stream is RGB at that point.

    Options:
      x, y         position — numbers or per-frame expressions with vars
                   n, t, main_w/mw, main_h/mh, overlay_w/ow, overlay_h/oh
                   (vf_overlay_cuda.c:47-60 var_names), evaluated on the
                   host per frame
      eof_action   repeat (default) | pass | endall — framesync semantics
                   when the overlay stream ends before the main stream
      shortest=1   alias for eof_action=endall

    Raw and Y4M overlay streams carry no alpha plane (the reference's
    NV12-overlay case: opaque); containers decode with alpha, and
    ops/overlay.overlay_yuv420 implements the yuva420p alpha path.
    """

    stream_filter = True

    def __init__(self, path="", video="", x="0", y="0",
                 eof_action="repeat", shortest=0, vw=0, vh=0):
        if bool(path) == bool(video):
            raise FilterError("overlay requires exactly one of path=FILE "
                              "(still) or video=FILE (second stream)")
        self.video = str(video)
        # headerless raw overlay inputs (.yuv/.nv12/...) need their
        # geometry from the caller (vw=W:vh=H)
        self.vw, self.vh = int(vw), int(vh)
        self.eof_action = "endall" if int(shortest) else str(eof_action)
        if self.eof_action not in ("repeat", "pass", "endall"):
            raise FilterError(f"overlay eof_action {self.eof_action!r}")
        self._x = self._pos_expr(x)
        self._y = self._pos_expr(y)
        self._still = None
        self._still_alpha = None
        if path:
            self._still, self._still_alpha = self._load_still(str(path))
        self._still_cache = {}
        self._gen = None
        self._last = None          # last overlay frame (np plane dict)
        self._ended = False
        self._n = 0                # frames seen (expr var n)

    @staticmethod
    def _load_still(path: str):
        """(rgb (h, w, 3) u8, alpha (h, w) u8 or None), even dims."""
        if path.lower().endswith(".png"):
            # PNG watermark with a real alpha channel (the yuva420p
            # overlay case, vf_overlay_cuda.c formats_match)
            from ..av import toolkit as tk
            from ..core.frame import from_numpy_yuv420
            dec = tk.Decoder(codec_id=tk.codec_id("png"))
            with open(path, "rb") as f:
                data = f.read()
            frames = list(dec.decode_alpha(data)) + \
                list(dec.decode_alpha(None))
            dec.close()
            if not frames:
                raise FilterError(f"could not decode png {path!r}")
            yy, uu, vv, aa, _ = frames[0]
            h2, w2 = yy.shape[0] & ~1, yy.shape[1] & ~1
            # swscale converted RGBA->YUVA with unspecified-colorspace
            # defaults (BT.601); invert with the same matrix
            fb = from_numpy_yuv420(yy[None, :h2, :w2],
                                   uu[None, :h2 // 2, :w2 // 2],
                                   vv[None, :h2 // 2, :w2 // 2],
                                   colorspace="bt601", device="cpu")
            img = csc.convert(fb, "rgb24").planes["rgb"][0].numpy()
            return img, aa[:h2, :w2]
        from ..av.jpeg import decode_jpeg_to_rgb
        img = decode_jpeg_to_rgb(path)      # (h, w, 3) uint8
        # even dims so the 4:2:0 conversion is well-defined
        return img[: img.shape[0] & ~1, : img.shape[1] & ~1], None

    @staticmethod
    def _pos_expr(v):
        try:
            return float(v)
        except (TypeError, ValueError):
            return compile_expr(str(v))

    # -- overlay frame sourcing ---------------------------------------------
    def _video_gen(self):
        if self.video.lower().endswith((".y4m", ".yuv", ".nv12", ".iyuv",
                                        ".raw")):
            # raw readers have no alpha: the shared second-input reader
            yield from _second_stream(self.video, self.vw, self.vh,
                                      "overlay video (overlay=video=bg.yuv:"
                                      "vw=640:vh=360)")
            return
        # containers: alpha-aware decode (yuva420p target) so overlays
        # from alpha-carrying codecs (png/qtrle/prores4444) blend properly
        from ..av import toolkit as tk
        dm = tk.Demuxer(self.video)
        dec = tk.Decoder.from_demuxer(dm)
        try:
            def frames():
                for pkt in dm:
                    if pkt.stream == 0:
                        yield from dec.decode_alpha(pkt.data, pkt.pts)
                yield from dec.decode_alpha(None)
            for (y, u, v, a, _p) in frames():
                yield {"y": y, "u": u, "v": v, "a": a}
        finally:
            dm.close()
            dec.close()

    def _next_overlay(self):
        """One overlay frame dict, or None when exhausted (pre-eof_action)."""
        if self._still is not None:
            return {"rgb": self._still}
        if self._gen is None:
            self._gen = self._video_gen()
        try:
            frame = next(self._gen)
            self._last = frame
            return frame
        except StopIteration:
            return None

    def _still_as(self, domain, colorspace="bt709"):
        """Still image in 'rgb' or 'yuv' domain (host planes, converted
        once on the host and cached).  colorspace: the MAIN stream's
        matrix — a bt601 main needs the still encoded with bt601."""
        key = (domain, colorspace)
        if key not in self._still_cache:
            from ..core.frame import from_numpy_rgb
            if domain == "rgb":
                d = {"rgb": self._still}
            else:
                fb = csc.convert(from_numpy_rgb(self._still,
                                                colorspace=colorspace,
                                                device="cpu"), "yuv420p")
                d = {k: v[0].numpy() for k, v in fb.planes.items()}
            if self._still_alpha is not None:
                d = dict(d, a=self._still_alpha)
            self._still_cache[key] = d
        return self._still_cache[key]

    # -- stream protocol ------------------------------------------------------
    def process_batch(self, fb: FrameBatch, meta):
        from ..ops import overlay as ov
        if self._ended:
            return _empty_like(fb), _meta_take(meta, slice(0, 0))
        nb = fb.batch
        keep = np.asarray(meta["keep"]).copy()
        # expression var n counts frames that reach the filter (ffmpeg
        # inlink frame_count): masked/padded frames never arrive
        n_base = self._n
        rgb_main = fb.fmt.is_rgb
        if rgb_main and fb.format not in ("rgb24", "rgba"):
            # the RGB blend assumes packed 8-bit (N,H,W,C)
            raise FilterError(
                f"overlay on RGB mains supports rgb24/rgba (got "
                f"{fb.format}); insert format=rgb24 first")
        if not rgb_main and fb.format not in ("yuv420p", "nv12"):
            raise FilterError(
                f"overlay main format {fb.format} unsupported (yuv420p/"
                "nv12/rgb like vf_overlay_cuda.c formats_match)")
        domain = "rgb" if rgb_main else "yuv"

        frames, blend_on = [], np.zeros(nb, bool)
        cut = None
        for i in range(nb):
            if not keep[i]:
                frames.append(None)
                continue
            if self._still is not None:
                frames.append(self._still_as(domain, fb.colorspace))
                blend_on[i] = True
                continue
            f = self._next_overlay()
            if f is None:                      # overlay stream ended
                if self.eof_action == "repeat" and self._last is not None:
                    f = self._last
                elif self.eof_action == "pass":
                    frames.append(None)
                    continue
                else:                          # endall (or repeat w/o any)
                    keep[i:] = False
                    self._ended = True
                    cut = i
                    break
            frames.append(f)
            blend_on[i] = True
        if cut is not None:
            frames += [None] * (nb - len(frames))

        meta = dict(meta)
        meta["keep"] = keep
        kept_idx = np.cumsum(keep) - 1          # per-frame kept ordinal
        self._n += int(keep.sum())
        if not blend_on.any():
            return fb, meta

        # stack overlay frames; non-blended slots reuse any real frame and
        # are pushed fully off-canvas (position = main size) instead
        ref = next(f for f in frames if f is not None)
        if domain == "yuv" and "rgb" in ref:
            raise FilterError("internal: rgb overlay frame in yuv domain")
        dev = fb.device
        stack = {k: torch.as_tensor(np.stack([(f or ref)[k] for f in frames]),
                                    device=dev)
                 for k in ref}
        alpha = stack.pop("a", None)
        if alpha is not None and int(alpha.min()) == 255:
            alpha = None            # fully opaque: skip the alpha math
        if domain == "rgb" and "rgb" not in ref:
            tmp = FrameBatch({k: stack[k] for k in "yuv"}, "yuv420p",
                             ref["y"].shape[1], ref["y"].shape[0],
                             fb.colorspace)
            stack = {"rgb": csc.convert(tmp, "rgb24").planes["rgb"]}

        ow = ref["rgb"].shape[1] if "rgb" in ref else ref["y"].shape[1]
        oh = ref["rgb"].shape[0] if "rgb" in ref else ref["y"].shape[0]
        times = meta.get("times")
        xs = np.full(nb, fb.width, np.int64)       # off-canvas default
        ys = np.full(nb, fb.height, np.int64)
        static = isinstance(self._x, float) and isinstance(self._y, float)
        if static:
            xs[blend_on] = int(self._x)
            ys[blend_on] = int(self._y)
        else:
            env = {"main_w": float(fb.width), "mw": float(fb.width),
                   "main_h": float(fb.height), "mh": float(fb.height),
                   "overlay_w": float(ow), "ow": float(ow),
                   "overlay_h": float(oh), "oh": float(oh)}
            for i in np.nonzero(blend_on)[0]:
                env["n"] = float(n_base + kept_idx[i])
                env["t"] = float(times[i]) if times is not None else 0.0
                xs[i] = int(self._x if isinstance(self._x, float)
                            else self._x(env))
                ys[i] = int(self._y if isinstance(self._y, float)
                            else self._y(env))

        if domain == "rgb":
            out = ov.overlay_rgb(fb.planes["rgb"], stack["rgb"], alpha,
                                 xs, ys)
            return fb.with_planes({"rgb": out}), meta
        planes = ov.overlay_yuv420(fb.planes, stack, alpha, xs, ys)
        return fb.with_planes(planes), meta

    def flush(self):
        if self._gen is not None:
            self._gen.close()
            self._gen = None
        return None


def _f_overlay(path="", x=0, y=0, video="", eof_action="repeat", shortest=0):
    return OverlayFilter(path=path, video=video, x=x, y=y,
                         eof_action=eof_action, shortest=shortest)


def _f_infer(model="sr2x", weights="", luma_only=0, precision="bf16",
             hidden=0):
    """tensorrt-filter analog: run a PyTorch model in the graph.

    model: 'sr2x' | 'sr3x' | 'denoise' | 'pose' | 'classify' or
    'module:function' for user models.  Mirrors vf_tensorrt's two IO
    modes (vf_tensorrt.c:206-217): 3-channel RGBPF32 in/out, or luma-only
    with chroma passthrough (copy_UV_plane, tensorrt.cpp:562-584).
    """
    from .infer import InferFilter
    return InferFilter(model, weights, luma_only=bool(int(luma_only)),
                       precision=precision, hidden=int(hidden))


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
    "fade": _f_fade,
    "tpad": TpadFilter,
    "loop": LoopFilter,
    "framerate": FramerateFilter,
    "separatefields": SeparateFieldsFilter,
    "telecine": TelecineFilter,
    "detelecine": DetelecineFilter,
    "xfade": XfadeFilter,
    "il": _f_il,
    "shuffleframes": ShuffleFramesFilter,
    "reverse": ReverseFilter,
    "zoompan": ZoompanFilter,
    "blend": BlendFilter,
    "tblend": lambda **kw: BlendFilter(tblend=True, **kw),
    "weave": WeaveFilter,
    "doubleweave": lambda **kw: WeaveFilter(double_weave=1, **kw),
    "psnr": _f_psnr,
    "ssim": _f_ssim,
    "overlay": _f_overlay,
    "overlay_cuda": _f_overlay,
    "tensorrt": _f_infer,
    "infer": _f_infer,
}

from . import hdr  # noqa: E402,F401 — registers tonemap/zscale into FILTERS
