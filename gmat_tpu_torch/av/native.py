"""ctypes bindings to the native host runtime (csrc/gmat_av.cpp), the
JPEG entropy coder (csrc/gmat_jpeg.cpp) and the audio biquad loop
(csrc/gmat_dsp.cpp).

A copy of `gmat_tpu/av/native.py` that builds into the port's own
`gmat_tpu_torch/av/_lib/` (listed in .gitignore) from the repo's shared
`csrc/`.  Self-building: if the shared library is missing or stale, it is
compiled with g++ on first `load()` (seconds).  This mirrors how the
reference ships `CFrameExtractor.so`/`CHeif.so` C shims consumed by ctypes
(metrans/python/frame_extractor.py:22-52).  The demux/decode/encode/mux
library links against libav* (FFmpeg); where those are missing,
`load("gmat_av")` raises.  The JPEG coder and the biquad loop need
nothing but the C++ standard library.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG.parent.parent / "csrc"
_LIBDIR = _PKG / "_lib"

_LIBS = {
    "gmat_av": (["gmat_av.cpp"], ["-lavformat", "-lavcodec", "-lavutil",
                                  "-lswscale", "-lswresample"]),
    "gmat_jpeg": (["gmat_jpeg.cpp"], []),
    "gmat_dsp": (["gmat_dsp.cpp"], []),
}


def _build(name: str) -> Path:
    srcs, libs = _LIBS[name]
    out = _LIBDIR / f"lib{name}.so"
    src_paths = [_CSRC / s for s in srcs]
    if out.exists() and all(out.stat().st_mtime >= p.stat().st_mtime
                            for p in src_paths):
        return out
    _LIBDIR.mkdir(exist_ok=True)
    # build beside the target and rename: processes that build at once
    # never load a half-written library
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O2", "-fPIC", "-shared", "-fvisibility=hidden",
           "-std=c++17", "-Wall", "-pthread",
           "-o", str(tmp)] + [str(p) for p in src_paths] + libs
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"building {name} failed:\n{r.stderr}")
    os.replace(tmp, out)
    return out


_cache = {}


def load(name: str = "gmat_av") -> ctypes.CDLL:
    if name not in _cache:
        lib = ctypes.CDLL(str(_build(name)))
        _declare(name, lib)
        _cache[name] = lib
    return _cache[name]


c_ll = ctypes.c_longlong
c_pll = ctypes.POINTER(c_ll)
c_pi = ctypes.POINTER(ctypes.c_int)
c_pu8 = ctypes.POINTER(ctypes.c_ubyte)
c_ppu8 = ctypes.POINTER(c_pu8)


def _declare(name: str, lib: ctypes.CDLL):
    if name == "gmat_av":
        sigs = {
            "gav_last_error": (ctypes.c_char_p, []),
            "gav_demux_open": (ctypes.c_void_p, [ctypes.c_char_p,
                                                 ctypes.c_int]),
            "gav_demux_open_buffer": (ctypes.c_void_p,
                                      [ctypes.c_char_p, c_ll,
                                       ctypes.c_int]),
            "gav_enc_set_roi": (None, [ctypes.c_void_p, c_pi, ctypes.c_int]),
            "gav_dec_set_crop": (None, [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int]),
            "gav_dec_last_frame_info": (None, [ctypes.c_void_p, c_pi, c_pi]),
            "gav_demux_codec_id": (ctypes.c_int, [ctypes.c_void_p]),
            "gav_dec_create_id": (ctypes.c_void_p, [ctypes.c_int, c_pu8,
                                                    ctypes.c_int,
                                                    ctypes.c_int]),
            "gav_dec_receive_a": (ctypes.c_int, [ctypes.c_void_p, c_pu8,
                                                 c_pu8, c_pu8, c_pu8,
                                                 ctypes.c_int, ctypes.c_int,
                                                 c_pll]),
            "gav_dec_has_alpha": (ctypes.c_int, [ctypes.c_void_p]),
            "gav_codec_id_by_name": (ctypes.c_int, [ctypes.c_char_p]),
            "gav_mux_open_id": (ctypes.c_void_p, [ctypes.c_char_p,
                                                  ctypes.c_int, ctypes.c_int,
                                                  ctypes.c_int, ctypes.c_int,
                                                  ctypes.c_int, c_pu8,
                                                  ctypes.c_int]),
            "gav_demux_close": (None, [ctypes.c_void_p]),
            "gav_demux_width": (ctypes.c_int, [ctypes.c_void_p]),
            "gav_demux_height": (ctypes.c_int, [ctypes.c_void_p]),
            "gav_demux_codec": (ctypes.c_int, [ctypes.c_void_p]),
            "gav_demux_fps": (ctypes.c_double, [ctypes.c_void_p]),
            "gav_demux_duration": (ctypes.c_double, [ctypes.c_void_p]),
            "gav_demux_nb_frames": (c_ll, [ctypes.c_void_p]),
            "gav_demux_start_time": (ctypes.c_double,
                                     [ctypes.c_void_p]),
            "gav_demux_timebase": (None, [ctypes.c_void_p, c_pi, c_pi]),
            "gav_demux_colorspace": (ctypes.c_int, [ctypes.c_void_p]),
            "gav_demux_colortrc": (ctypes.c_int, [ctypes.c_void_p]),
            "gav_demux_colorprim": (ctypes.c_int, [ctypes.c_void_p]),
            "gav_demux_hdr": (ctypes.c_int, [ctypes.c_void_p,
                                             ctypes.POINTER(ctypes.c_double),
                                             c_pi]),
            "gav_demux_extradata": (ctypes.c_int, [ctypes.c_void_p, c_ppu8]),
            "gav_demux_read": (ctypes.c_int, [ctypes.c_void_p, c_ppu8, c_pll,
                                              c_pll, c_pi, c_pi, c_pi,
                                              c_pll]),
            "gav_demux_seek": (ctypes.c_int, [ctypes.c_void_p, c_ll]),
            "gav_dec_create": (ctypes.c_void_p, [ctypes.c_int, c_pu8,
                                                 ctypes.c_int, ctypes.c_int]),
            "gav_dec_close": (None, [ctypes.c_void_p]),
            "gav_dec_reset": (None, [ctypes.c_void_p]),
            "gav_dec_send": (ctypes.c_int, [ctypes.c_void_p, c_pu8,
                                            ctypes.c_int, c_ll]),
            "gav_dec_receive": (ctypes.c_int, [ctypes.c_void_p, c_pu8, c_pu8,
                                               c_pu8, ctypes.c_int,
                                               ctypes.c_int, c_pll]),
            "gav_dec_width": (ctypes.c_int, [ctypes.c_void_p]),
            "gav_dec_height": (ctypes.c_int, [ctypes.c_void_p]),
            "gav_dec_peek_dims": (ctypes.c_int, [ctypes.c_void_p, c_pi,
                                                 c_pi]),
            "gav_enc_create": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_int,
                                                 ctypes.c_int, ctypes.c_int,
                                                 ctypes.c_int, c_ll,
                                                 ctypes.c_int, ctypes.c_int,
                                                 ctypes.c_char_p,
                                                 ctypes.c_double, ctypes.c_int,
                                                 ctypes.c_char_p]),
            "gav_enc_close": (None, [ctypes.c_void_p]),
            "gav_enc_extradata": (ctypes.c_int, [ctypes.c_void_p, c_ppu8]),
            "gav_enc_send": (ctypes.c_int, [ctypes.c_void_p, c_pu8, c_pu8,
                                            c_pu8, c_ll, ctypes.c_int]),
            "gav_enc_receive": (ctypes.c_int, [ctypes.c_void_p, c_ppu8, c_pll,
                                               c_pll, c_pi]),
            "gav_mux_open": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_int,
                                               c_pu8, ctypes.c_int]),
            "gav_mux_write": (ctypes.c_int, [ctypes.c_void_p, c_pu8,
                                             ctypes.c_int, c_ll, c_ll,
                                             ctypes.c_int]),
            "gav_mux_close": (ctypes.c_int, [ctypes.c_void_p]),
            "gav_has_encoder": (ctypes.c_int, [ctypes.c_char_p]),
            "gav_avcodec_version": (ctypes.c_uint, []),
            # audio
            "gav_demux_has_audio": (ctypes.c_int, [ctypes.c_void_p]),
            "gav_demux_has_video": (ctypes.c_int, [ctypes.c_void_p]),
            "gav_demux_audio_info": (None, [ctypes.c_void_p, c_pi, c_pi,
                                            c_pi, c_pi, c_pi]),
            "gav_demux_audio_extradata": (ctypes.c_int, [ctypes.c_void_p,
                                                         c_ppu8]),
            "gav_adec_create": (ctypes.c_void_p, [ctypes.c_int, c_pu8,
                                                  ctypes.c_int, ctypes.c_int,
                                                  ctypes.c_int]),
            "gav_adec_close": (None, [ctypes.c_void_p]),
            "gav_adec_send": (ctypes.c_int, [ctypes.c_void_p, c_pu8,
                                             ctypes.c_int, c_ll]),
            "gav_adec_receive": (ctypes.c_int, [ctypes.c_void_p,
                                                ctypes.POINTER(ctypes.c_short),
                                                ctypes.c_int, c_pll,
                                                ctypes.POINTER(ctypes.c_int)]),
            "gav_adec_rate": (ctypes.c_int, [ctypes.c_void_p]),
            "gav_adec_channels": (ctypes.c_int, [ctypes.c_void_p]),
            "gav_aenc_create": (ctypes.c_void_p, [ctypes.c_char_p,
                                                  ctypes.c_int, ctypes.c_int,
                                                  c_ll]),
            "gav_aenc_close": (None, [ctypes.c_void_p]),
            "gav_aenc_frame_size": (ctypes.c_int, [ctypes.c_void_p]),
            "gav_aenc_extradata": (ctypes.c_int, [ctypes.c_void_p, c_ppu8]),
            "gav_aenc_codec_id": (ctypes.c_int, [ctypes.c_void_p]),
            "gav_aenc_send": (ctypes.c_int, [ctypes.c_void_p,
                                             ctypes.POINTER(ctypes.c_short),
                                             ctypes.c_int]),
            "gav_aenc_receive": (ctypes.c_int, [ctypes.c_void_p, c_ppu8,
                                                c_pll, c_pll]),
            "gav_mux_open_av": (ctypes.c_void_p, [ctypes.c_char_p,
                                                  ctypes.c_int, ctypes.c_int,
                                                  ctypes.c_int, ctypes.c_int,
                                                  ctypes.c_int, c_pu8,
                                                  ctypes.c_int, ctypes.c_int,
                                                  ctypes.c_int, ctypes.c_int,
                                                  c_pu8, ctypes.c_int]),
            "gav_mux_write_stream": (ctypes.c_int, [ctypes.c_void_p,
                                                    ctypes.c_int, c_pu8,
                                                    ctypes.c_int, c_ll, c_ll,
                                                    ctypes.c_int]),
            "gav_mux_open_audio": (ctypes.c_void_p, [ctypes.c_char_p,
                                                     ctypes.c_int,
                                                     ctypes.c_int,
                                                     ctypes.c_int, c_pu8,
                                                     ctypes.c_int]),
            # 10-bit lane
            "gav_dec_receive16": (ctypes.c_int, [ctypes.c_void_p,
                                                 ctypes.POINTER(ctypes.c_ushort),
                                                 ctypes.POINTER(ctypes.c_ushort),
                                                 ctypes.POINTER(ctypes.c_ushort),
                                                 ctypes.c_int, ctypes.c_int,
                                                 c_pll]),
            "gav_enc_create10": (ctypes.c_void_p, [ctypes.c_char_p,
                                                   ctypes.c_int, ctypes.c_int,
                                                   ctypes.c_int, ctypes.c_int,
                                                   c_ll, ctypes.c_int,
                                                   ctypes.c_int,
                                                   ctypes.c_char_p,
                                                   ctypes.c_double,
                                                   ctypes.c_int,
                                                   ctypes.c_char_p]),
            "gav_enc_send16": (ctypes.c_int, [ctypes.c_void_p,
                                              ctypes.POINTER(ctypes.c_ushort),
                                              ctypes.POINTER(ctypes.c_ushort),
                                              ctypes.POINTER(ctypes.c_ushort),
                                              c_ll, ctypes.c_int]),
        }
    elif name == "gmat_dsp":
        c_ps16 = ctypes.POINTER(ctypes.c_short)
        c_pd = ctypes.POINTER(ctypes.c_double)
        sigs = {
            "gdsp_biquad_di_s16": (None, [
                c_ps16, c_ps16, ctypes.c_int, c_pd,
                ctypes.c_double, ctypes.c_double, ctypes.c_double,
                ctypes.c_double, ctypes.c_double,
                ctypes.c_double, ctypes.c_int, c_pll]),
        }
    elif name == "gmat_jpeg":
        c_pi16 = ctypes.POINTER(ctypes.c_int16)
        sigs = {
            "gjpeg_last_error": (ctypes.c_char_p, []),
            "gjpeg_encode": (ctypes.c_int, [c_pi16, c_pi16, c_pi16,
                                            ctypes.c_int, ctypes.c_int,
                                            ctypes.c_int, c_pu8, c_pu8,
                                            c_pu8, c_ll]),
            "gjpeg_encode_r": (ctypes.c_int, [c_pi16, c_pi16, c_pi16,
                                              ctypes.c_int, ctypes.c_int,
                                              ctypes.c_int, c_pu8, c_pu8,
                                              c_pu8, c_ll, ctypes.c_int]),
            "gjpeg_encode_ro": (ctypes.c_int, [c_pi16, c_pi16, c_pi16,
                                               ctypes.c_int, ctypes.c_int,
                                               ctypes.c_int, c_pu8, c_pu8,
                                               c_pu8, c_ll, ctypes.c_int,
                                               ctypes.c_int]),
            "gjpeg_encode_progressive": (ctypes.c_int,
                                         [c_pi16, c_pi16, c_pi16,
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, c_pu8, c_pu8,
                                          c_pu8, c_ll]),
            "gjpeg_encode_progressive_r": (ctypes.c_int,
                                           [c_pi16, c_pi16, c_pi16,
                                            ctypes.c_int, ctypes.c_int,
                                            ctypes.c_int, c_pu8, c_pu8,
                                            c_pu8, c_ll, ctypes.c_int]),
            "gjpeg_parse": (ctypes.c_void_p, [c_pu8, c_ll]),
            "gjpeg_decode_coefs_mt": (ctypes.c_int,
                                      [ctypes.c_void_p, c_pi16, c_pi16,
                                       c_pi16, ctypes.c_int]),
            "gjpeg_info": (None, [ctypes.c_void_p, c_pi, c_pi, c_pi]),
            "gjpeg_qtable": (None, [ctypes.c_void_p, ctypes.c_int, c_pu8]),
            "gjpeg_decode_coefs": (ctypes.c_int, [ctypes.c_void_p, c_pi16,
                                                  c_pi16, c_pi16]),
            "gjpeg_free": (None, [ctypes.c_void_p]),
        }
    else:
        sigs = {}
    for fn, (res, args) in sigs.items():
        f = getattr(lib, fn)
        f.restype = res
        f.argtypes = args


def last_error(lib=None) -> str:
    lib = lib or load()
    e = lib.gav_last_error()
    return e.decode() if e else ""
