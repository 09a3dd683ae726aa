"""HDR filters: ``tonemap`` and the ``zscale`` conversion subset —
counterpart of `gmat_tpu/filters/hdr.py`.

  * vf_tonemap.c — the tone-curve filter (math in ops/tonemap.py).
  * vf_zscale.c — the subset every published HDR10->SDR command line
    uses: transfer linearize/delinearize with nominal-peak-luminance
    scaling (t/tin/npl), primaries conversion (p/pin), output matrix/range
    tagging (m/r) and optional resizing, as f32 tensor ops on the batch's
    device.
  * peak auto-derivation mirrors ff_determine_signal_peak
    (colorspace.c:153-175): MaxCLL/100, else max_luminance/100, else 100
    for PQ streams / 10 otherwise.

The graph has no format negotiation: zscale always *outputs* float RGB
(rgbpf32/rgbapf32) and a trailing ``format=`` performs the final
RGB->YUV with the colorspace tag zscale's ``m=`` sets, so the canonical

    zscale=t=linear:npl=100,format=gbrpf32le,tonemap=hable,
    zscale=p=bt709:t=bt709:m=bt709:r=tv,format=yuv420p

parses and runs unchanged.  Per-frame tags (color_trc, primaries, HDR
side data) are graph-build-time link state (FilterGraph.link_state),
which each link-aware filter reads for its input defaults and rewrites
to describe its output.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ..core import transfer as T
from ..core.color import _KR_KB
from ..core.frame import FrameBatch
from ..ops import csc
from ..ops import tonemap as TM
from .builtin import FILTERS, FilterError

# zscale matrix-option grammar (vf_zscale.c:1022-1033) -> colorspace tags
# (core/color.py _KR_KB keys)
_MATRIX_NAMES = {
    "709": "bt709", "bt709": "bt709",
    "170m": "bt601", "smpte170m": "bt601", "601": "bt601",
    "bt601": "bt601", "470bg": "bt470bg", "bt470bg": "bt470bg",
    "2020_ncl": "bt2020", "2020_cl": "bt2020", "bt2020nc": "bt2020",
    "bt2020c": "bt2020", "bt2020": "bt2020", "2020": "bt2020",
}


def _pick(short, long_, what):
    """zscale declares every option twice (short + long alias sharing one
    offset, vf_zscale.c:1004-1093); either is accepted, a contradictory
    pair rejected since kwargs can't reproduce last-one-wins."""
    if short is not None and long_ is not None and short != long_:
        raise FilterError(f"zscale: conflicting {what} options "
                          f"({short!r} vs {long_!r})")
    return short if short is not None else long_


def resolve_peak(link: Optional[Dict], explicit: float = 0.0) -> float:
    """ff_determine_signal_peak (colorspace.c:153-175) over link state."""
    if explicit:
        return float(explicit)
    if link:
        if link.get("max_cll"):
            return float(link["max_cll"]) / 100.0
        if link.get("max_luminance"):
            return float(link["max_luminance"]) / 100.0
        trc = link.get("trc")
        if trc is not None:
            return 100.0 if T.canon_trc(trc) == "st2084" else 10.0
    return 10.0


def _f_tonemap(tonemap="none", param=None, desat=2.0, peak=0.0,
               _link: Optional[Dict] = None):
    """vf_tonemap.c — expects linear-light float RGB input, like the C
    filter's FILTER_PIXFMTS(GBRPF32, GBRAPF32) contract."""
    method = str(tonemap)
    if method not in TM.METHODS:
        raise FilterError(
            f"tonemap: unknown algorithm {method!r} "
            f"(one of {', '.join(TM.METHODS)})")
    p = float("nan") if param is None else float(param)
    p = TM.resolve_param(method, p)
    desat = float(desat)
    pk = resolve_peak(_link, float(peak))
    if _link is not None:
        # ff_update_hdr_metadata (colorspace.c:178-193): rewrite EXISTING
        # side data to the post-tonemap peak (peak * REFERENCE_WHITE)
        if _link.get("max_cll"):
            _link["max_cll"] = pk * 100.0
        if _link.get("max_luminance"):
            _link["max_luminance"] = pk * 100.0

    def run(fb: FrameBatch) -> FrameBatch:
        fmt = fb.fmt
        if not (fmt.is_rgb and fmt.is_float):
            raise FilterError(
                "tonemap expects float RGB input (rgbpf32/rgbapf32 — "
                "GBRPF32 in the reference); insert "
                "zscale=t=linear,format=gbrpf32le first")
        coeffs = None
        if desat > 0:
            kr_kb = _KR_KB.get(fb.colorspace)
            if kr_kb is not None:    # unknown space -> desat disabled
                kr, kb = kr_kb       # (vf_tonemap.c:244-252)
                coeffs = (kr, 1.0 - kr - kb, kb)
        arr = fb.planes["rgb"]
        rgb = TM.tonemap_rgb(arr[..., :3], method, p, desat, pk, coeffs)
        if arr.shape[-1] == 4:       # alpha passes through (c:263-266)
            rgb = torch.cat([rgb, arr[..., 3:]], dim=-1)
        return fb.with_planes({"rgb": rgb})

    return run


_f_tonemap.wants_link = True


# av_parse_video_size abbreviations (libavutil/parseutils.c
# video_size_abbrs, common subset)
_VIDEO_SIZE_ABBRS = {
    "qcif": (176, 144), "cif": (352, 288), "qvga": (320, 240),
    "vga": (640, 480), "svga": (800, 600), "xga": (1024, 768),
    "sxga": (1280, 1024), "wxga": (1366, 768), "wsxga": (1600, 1024),
    "hd480": (852, 480), "hd720": (1280, 720), "hd1080": (1920, 1080),
    "2k": (2048, 1080), "2kdci": (2048, 1080), "4k": (4096, 2160),
    "4kdci": (4096, 2160), "uhd2160": (3840, 2160),
    "uhd4320": (7680, 4320), "ntsc": (720, 480), "pal": (720, 576),
}


def _gamut(x: torch.Tensor, gm) -> torch.Tensor:
    """out[..., d] = sum_c x[..., c] * gm[d, c] as a chain of fused
    multiply-adds in c order, fma(x2, m2, fma(x1, m1, x0 * m0)): the
    order and single roundings of the JAX op's f32 einsum on the CPU
    (XLA's dot).  No matmul, so no TF32 on the card: each fma is a
    float64 multiply (exact for f32 operands) and add, rounded once to
    float32, the same on the card and the CPU."""
    x0, x1, x2 = (x[..., c].to(torch.float64) for c in range(3))
    rows = []
    for d in range(3):
        m0, m1, m2 = (float(v) for v in gm[d])
        acc = (x0 * m0).to(torch.float32).to(torch.float64)
        acc = (x1 * m1 + acc).to(torch.float32).to(torch.float64)
        rows.append((x2 * m2 + acc).to(torch.float32))
    return torch.stack(rows, dim=-1)


def _f_zscale(w="0", h="0", t=None, tin=None, p=None, pin=None, m=None,
              min=None, r=None, rin=None, npl=None, f="bilinear",
              transfer=None, transferin=None, primaries=None,
              primariesin=None, matrix=None, matrixin=None, range=None,
              rangein=None, nominal_peak_luminance=None, filter=None,
              dither="none", d=None, size=None, s=None,
              _link: Optional[Dict] = None):
    t = _pick(t, transfer, "transfer")
    tin = _pick(tin, transferin, "transferin")
    p = _pick(p, primaries, "primaries")
    pin = _pick(pin, primariesin, "primariesin")
    m = _pick(m, matrix, "matrix")
    min_ = _pick(min, matrixin, "matrixin")
    r = _pick(r, range, "range")
    rin = _pick(rin, rangein, "rangein")
    npl = _pick(npl, nominal_peak_luminance, "npl")
    f = _pick(None if f == "bilinear" else f, filter, "filter") or "bilinear"
    size = _pick(s, size, "size")
    if size:
        size = str(size).lower()
        if size in _VIDEO_SIZE_ABBRS:          # av_parse_video_size names
            w, h = _VIDEO_SIZE_ABBRS[size]
        elif "x" in size:
            w, h = size.split("x", 1)
        else:
            raise FilterError(f"zscale: cannot parse size {size!r} "
                              "(WxH or a known abbreviation)")
    dither = _pick(None if dither == "none" else dither, d, "dither")
    if dither not in (None, "none"):
        raise FilterError("zscale: only dither=none is supported (the "
                          "float-RGB output path never quantizes)")
    for name, val in (("r", r), ("rin", rin)):
        if val not in (None, "tv", "limited", "input"):
            raise FilterError(
                f"zscale: {name}={val} unsupported — the YUV lanes are "
                "studio/limited range like the reference kernels "
                "(yuv2rgb_cuda.cu get_constants)")
    w, h = int(w), int(h)
    if w < 0 and h < 0:
        raise FilterError("zscale: w and h cannot both be negative")
    npl_v = 100.0 if npl is None or math.isnan(float(npl)) else float(npl)
    if str(f) in ("spline16", "spline36"):
        raise FilterError(f"zscale: resample filter {f!r} is not "
                          "supported — use bilinear/bicubic/lanczos")
    interp = {"point": "nearest", "bilinear": "bilinear",
              "bicubic": "bicubic", "lanczos": "lanczos3"}.get(str(f))
    if interp is None:
        raise FilterError(f"zscale: unknown resample filter {f!r}")

    # ---- resolve link-state defaults at build time --------------------
    link = _link if _link is not None else {}
    tin_c = T.canon_trc(tin) if tin else (
        T.canon_trc(link["trc"]) if link.get("trc") else None)
    t_c = T.canon_trc(t) if t else None
    pin_c = T.canon_primaries(pin) if pin else (
        T.canon_primaries(link["primaries"]) if link.get("primaries")
        else None)
    p_c = T.canon_primaries(p) if p else None
    if t_c or p_c:
        if tin_c is None:
            raise FilterError(
                "zscale: input transfer unknown — pass tin= (the stream "
                "probe found no color_trc tag to default from)")
        if p_c and pin_c is None:
            raise FilterError(
                "zscale: input primaries unknown — pass pin=")
    m_cs = None
    if m is not None:
        key = str(m).lower()
        if key not in _MATRIX_NAMES:
            raise FilterError(f"zscale: unknown matrix {m!r}")
        m_cs = _MATRIX_NAMES[key]
    min_cs = None
    if min_ is not None:
        key = str(min_).lower()
        if key not in _MATRIX_NAMES:
            raise FilterError(f"zscale: unknown matrixin {min_!r}")
        min_cs = _MATRIX_NAMES[key]

    t_out = t_c if t_c else tin_c           # unspecified out = keep input
    p_out = p_c if p_c else pin_c
    if _link is not None:
        if t_out:
            _link["trc"] = t_out
        if p_out:
            _link["primaries"] = p_out

    gm = None
    if p_c and pin_c and p_c != pin_c:
        gm = T.gamut_matrix(pin_c, p_c)     # applied in linear light

    def run(fb: FrameBatch) -> FrameBatch:
        if min_cs is not None and not fb.fmt.is_rgb:
            fb = FrameBatch(fb.planes, fb.format, fb.width, fb.height,
                            min_cs)
        if not fb.fmt.is_rgb:
            # exact=True keeps full float precision (no snap back to the
            # source integer grid): PQ steepness turns a half-LSB 10-bit
            # snap into ~1% linear-light error
            fb = csc.yuv_to_rgb(fb, "rgbpf32", exact=True)
        elif not fb.fmt.is_float:
            fb = csc.rgb_to_rgb(fb, "rgbpf32", exact=True)
        arr = fb.planes["rgb"]
        alpha = arr[..., 3:] if arr.shape[-1] == 4 else None
        x = arr[..., :3]
        if (t_c and t_c != tin_c) or gm is not None:
            x = T.linearize(x, tin_c, npl_v)
            if gm is not None:
                x = _gamut(x, gm)
            if t_out != "linear":
                x = T.delinearize(x, t_out, npl_v)
        out_fmt = "rgbpf32"
        if alpha is not None:
            x = torch.cat([x, alpha], dim=-1)
            out_fmt = "rgbapf32"
        nfb = FrameBatch({"rgb": x.contiguous()}, out_fmt, fb.width,
                         fb.height, m_cs or fb.colorspace)
        if w != 0 or h != 0:
            from ..ops import resize as R
            ow, oh = w, h
            # ffmpeg scale_eval semantics: 0 keeps the input dim, -1
            # preserves aspect, -N preserves aspect rounded to a
            # multiple of N (ff_scale_adjust_dimensions)
            if ow == 0:
                ow = nfb.width
            if oh == 0:
                oh = nfb.height
            if ow < 0:
                div = max(-w, 1)
                ow = max(round(oh * nfb.width / nfb.height), 1)
                ow = max(round(ow / div), 1) * div
            elif oh < 0:
                div = max(-h, 1)
                oh = max(round(ow * nfb.height / nfb.width), 1)
                oh = max(round(oh / div), 1) * div
            if (ow, oh) != (nfb.width, nfb.height):
                nfb = R.resize(nfb, ow, oh, interp)
        return nfb

    return run


_f_zscale.wants_link = True

# builtin.py imports this module after FILTERS exists
FILTERS["tonemap"] = _f_tonemap
FILTERS["zscale"] = _f_zscale
