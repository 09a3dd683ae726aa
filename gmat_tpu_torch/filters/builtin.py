"""Built-in filters, part 1 — counterpart of `gmat_tpu/filters/builtin.py`.

The filters of the reference's GPU layer (doc/FFMPEG-GPU_User_Guide.md:
16-26) and their aliases, with the JAX package's names, options, defaults
and errors:

  crop / rotate / flip (+hflip/vflip) / smooth   <- *_nvcv filters
  transpose (+transpose_npp), scale (+scale_cuda/scale_npp), pad
  format (+format_cuda), null/copy/hwupload/hwdownload, chromakey
  eq / lut / lutyuv / lutrgb / unsharp
  yadif (+yadif_cuda) / bwdif                   <- stream filters
  select (+select_cuda/select_gpu) / fps / trim <- keep-mask filters
  setpts / thumbnail (+thumbnail_cuda)          <- stream filters

Each filter is a factory: FILTERS[name](**options) -> callable.  Pure
filters map FrameBatch -> FrameBatch on the batch's device; keep-mask
filters (`batch_control`) and stream filters (`stream_filter`) keep the
JAX package's host logic and are run by filters/graph.FilterGraph.

Every other JAX filter name is in FILTERS too: its factory raises
NotImplementedError naming the ROADMAP.md item that ports it.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch

from ..core import formats as F
from ..core.frame import FrameBatch, same_bits
from ..ops import csc, enhance, geometry, resize, smooth
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


# ---- filters of later port slices ------------------------------------------

# every other JAX filter name, with the ROADMAP.md queue 1 item that ports
# it: the parser accepts the name, building the filter raises
_ITEM_BUILTIN_2 = "item 4 (filters/builtin.py, part 2)"
_LATER = {
    **{name: _ITEM_BUILTIN_2 for name in (
        "alphaextract", "blend", "boxblur", "colorbalance",
        "colorchannelmixer", "colortemperature", "curves", "deband",
        "delogo", "detelecine", "doubleweave", "drawbox", "exposure",
        "extractplanes", "fade", "framerate", "gblur", "hqdn3d", "hue",
        "il", "loop", "lut1d", "lut3d", "monochrome", "negate", "noise",
        "psnr", "reverse", "separatefields", "sharpen_npp",
        "shuffleframes", "ssim", "swapuv", "tblend", "telecine", "tpad",
        "vignette", "weave", "xfade", "zoompan")},
    "tonemap": "item 5 (filters/hdr.py, slice 3)",
    "zscale": "item 5 (filters/hdr.py, slice 3)",
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
    **{name: _later(name, item) for name, item in _LATER.items()},
}
