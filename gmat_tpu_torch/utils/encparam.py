"""Encoder option-string parser — NvEncoderParam compatibility.

Parses the GMAT/metrans encoder option strings (NvCodec/NvEncoderParam.h:
140-158; used in AppMeTrans's <VideoEncParam>, e.g.
"codec=hevc:fps=35:preset=p1:rc=vbr:bitrate=2M:gop=300:bf=2") into kwargs
for av.toolkit.Encoder.  NVENC-isms map to their libx264/x265 analogs:

  preset p1..p7  -> ultrafast..veryslow ladder
  rc constqp     -> CRF from -constqp / -cq
  rc vbr/cbr     -> bitrate (+ maxbitrate as vbv)
  -tune lowlatency -> tune zerolatency
"""
from __future__ import annotations

from typing import Dict, Tuple

_PRESET_MAP = {
    "p1": "ultrafast", "p2": "superfast", "p3": "veryfast", "p4": "faster",
    "p5": "medium", "p6": "slow", "p7": "veryslow",
    "default": "medium", "hq": "slow", "hp": "veryfast",
    "ll": "veryfast", "llhq": "faster", "llhp": "ultrafast",
}

_CODEC_MAP = {"h264": "libx264", "avc": "libx264",
              "hevc": "libx265", "h265": "libx265",
              "mjpeg": "mjpeg", "jpeg": "mjpeg"}


def _size(v: str) -> int:
    v = v.strip().upper()
    mult = 1
    if v.endswith("K"):
        mult, v = 1000, v[:-1]
    elif v.endswith("M"):
        mult, v = 1000000, v[:-1]
    return int(float(v) * mult)


def parse_enc_param(s: str, defaults: Dict = None) -> Dict:
    """Option string -> dict for av.toolkit.Encoder(**kwargs) plus extras
    ("codec_name", "fps")."""
    out = dict(defaults or {})
    out.setdefault("codec_name", "libx264")
    opts = {}
    for tok in filter(None, (t.strip() for t in s.split(":"))):
        if "=" in tok:
            k, v = tok.split("=", 1)
        else:
            k, v = tok, "1"
        opts[k.strip().lower()] = v.strip()

    x264_extra = []
    for k, v in opts.items():
        if k == "codec":
            out["codec_name"] = _CODEC_MAP.get(v.lower(), v)
        elif k == "preset":
            out["preset"] = _PRESET_MAP.get(v.lower(), v)
        elif k == "fps":
            if "/" in v:
                num, den = v.split("/")
                out["fps"] = (int(num), int(den))
            else:
                f = float(v)
                if f == int(f):
                    out["fps"] = (int(f), 1)
                else:   # 29.97 must not truncate to 29 (3.3% drift)
                    out["fps"] = (round(f * 1000), 1000)
        elif k == "gop":
            out["gop"] = int(v)
        elif k == "bf":
            out["bf"] = int(v)
        elif k in ("bitrate", "b"):
            out["bitrate"] = _size(v)
        elif k in ("maxbitrate", "vbvbufsize", "vbvinit"):
            x264_extra.append((k, _size(v)))
        elif k in ("constqp", "cq", "initqp", "crf"):
            out["crf"] = float(v.split(",")[0])
        elif k == "qmin":
            x264_extra.append(("qmin", int(v.split(",")[0])))
        elif k == "qmax":
            x264_extra.append(("qmax", int(v.split(",")[0])))
        elif k == "rc":
            # callers seed defaults with crf=-1.0 (the "unset" CLI
            # placeholder) — treat any negative crf as absent, or
            # rc=constqp silently falls back to the encoder default
            if v.lower() == "constqp" and out.get("crf", -1.0) < 0:
                out["crf"] = 23.0
        elif k in ("tune", "tuning"):
            if v.lower() in ("lowlatency", "ull", "lowdelay"):
                x264_extra.append(("tune", "zerolatency"))
        elif k == "profile":
            # NVENC profile GUID names (baseline/main/high/high444/main10)
            # are already the libx264/x265 -profile strings
            x264_extra.append(("profile", v.lower()))
        elif k == "lookahead":
            # NvEncoderParam.h:152 -lookahead N -> rcParams.lookaheadDepth
            x264_extra.append(("lookahead", int(v)))
        elif k == "aq":
            # NvEncoderParam.h:162-165 -aq N -> enableAQ + aqStrength
            # (NVENC strength 1..15); mapped onto the x264/x265
            # aq-strength scale around its 1.0 default: 1..15 -> 0.5..2.0
            x264_extra.append(("aq", int(v)))
        elif k == "temporalaq":
            # NvEncoderParam.h:158 -temporalaq -> enableTemporalAQ;
            # nearest analogs: x264 mbtree, x265 aq-motion
            x264_extra.append(("temporalaq", 1))
        else:
            raise ValueError(f"unknown encoder option {k!r} in {s!r}")

    hevc = out.get("codec_name") == "libx265"
    extras = []
    x265p = []      # libx265 exposes few AVOptions; route via x265-params
    for k, v in x264_extra:
        if k == "maxbitrate":
            extras.append(f"maxrate={v}")
        elif k == "vbvbufsize":
            extras.append(f"bufsize={v}")
        elif k == "vbvinit":
            # NVENC vbvInitialDelay -> libavcodec rc_initial_buffer_occupancy
            extras.append(f"rc_init_occupancy={v}")
        elif k == "lookahead":
            if hevc:
                x265p.append(f"rc-lookahead={v}")
            else:
                extras.append(f"rc-lookahead={v}")
        elif k == "aq":
            # NVENC aqStrength 0 = autoselect: enable AQ, leave the
            # encoder's default strength (x264/x265 aq-strength 1.0)
            ps = x265p if hevc else extras
            ps.append("aq-mode=1")
            if v != 0:
                strength = 0.5 + (min(max(v, 1), 15) - 1) * 1.5 / 14.0
                ps.append(f"aq-strength={strength:.2f}")
        elif k == "temporalaq":
            if hevc:
                x265p.append("aq-motion=1")
            else:
                extras.append("mbtree=1")
        elif k in ("qmin", "qmax", "tune", "profile"):
            extras.append(f"{k}={v}")
    if x265p:
        extras.append("x265-params=" + ":".join(x265p))
    if extras:
        # MERGE with any opts inherited from `defaults` (layered parses:
        # metrans base params + per-rung suffix) — overwriting would
        # silently drop the base VBV/maxrate/profile settings.  Keys set
        # by this parse win over same-key defaults; x265-params merges at
        # the sub-option level (base rc-lookahead survives a rung's aq).
        prev = out.get("opts", "")
        new_keys = {e.split("=", 1)[0] for e in extras}
        kept = []
        for e in filter(None, prev.split(",")):
            key = e.split("=", 1)[0]
            if key == "x265-params" and "x265-params" in new_keys:
                base_sub = dict(p.split("=", 1) for p in
                                e.split("=", 1)[1].split(":") if "=" in p)
                for i, ne in enumerate(extras):
                    if ne.startswith("x265-params="):
                        new_sub = dict(p.split("=", 1) for p in
                                       ne.split("=", 1)[1].split(":")
                                       if "=" in p)
                        base_sub.update(new_sub)
                        extras[i] = "x265-params=" + ":".join(
                            f"{k}={v}" for k, v in base_sub.items())
                continue
            if key not in new_keys:
                kept.append(e)
        out["opts"] = ",".join(kept + extras)
    return out
