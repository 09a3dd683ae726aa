"""Biquad IIR audio filter family — af_biquads.c analog.

Covers the twelve libavfilter names built from one engine:
equalizer, bass, lowshelf, treble, highshelf, tiltshelf, lowpass,
highpass, bandpass, bandreject, allpass, biquad.

Coefficient construction transcribes config_filter
(af_biquads.c:792-1010): the RBJ-cookbook style formulas per type,
width_type h/q/o/s/k alpha conversion (:807-829), ff_exp10 via
exp2(log2(10)*x), 1-pole bass/treble/lowpass/highpass variants,
allpass order 1/2, the a0 normalization, optional `normalize`
DC-gain factor, the tiltshelf post-divide, and the bypass-on-invalid
frequency/width warning path (:798-803).

The hot loop is the reference's direct-form-I s16 lane rebuilt in C
(csrc/gmat_dsp.cpp, loaded via av/native.py): double state carried
UNCLIPPED across blocks, wet/dry mix, av_clip counting and truncating
int16 stores — bit-exact because it IS the same arithmetic in the
same association order.  transform types other than di (the default)
and precisions other than auto/s16 are rejected: the chain is an s16
pipeline, and each alternate form is a different arithmetic with its
own rounding story.

The per-sample oracle in tests/test_biquads.py re-implements both the
coefficients and the DF1 loop independently in Python doubles; IEEE
semantics make the comparison bit-exact.

A copy of `gmat_tpu/av/biquads.py` for the PyTorch port: host numpy
on interleaved PCM, no device work.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import numpy as np

from . import native

_LOG2_10 = 3.321928094887362347870319429489390175864831393024580612054

NONE, HERTZ, QFACTOR, OCTAVE, SLOPE, KHERTZ = range(6)
_WIDTH_TYPES = {"h": HERTZ, "q": QFACTOR, "o": OCTAVE, "s": SLOPE,
                "k": KHERTZ}

# per-name defaults: (frequency, width, poles_opt, order_opt, csg_opt)
_DEFAULTS = {
    "equalizer": (0.0, 1.0, False, False, False),
    "bass": (100.0, 0.5, True, False, False),
    "lowshelf": (100.0, 0.5, True, False, False),
    "treble": (3000.0, 0.5, True, False, False),
    "highshelf": (3000.0, 0.5, True, False, False),
    "tiltshelf": (3000.0, 0.5, True, False, False),
    "bandpass": (3000.0, 0.5, False, False, True),
    "bandreject": (3000.0, 0.5, False, False, False),
    "lowpass": (500.0, 0.707, True, False, False),
    "highpass": (3000.0, 0.707, True, False, False),
    "allpass": (3000.0, 0.707, False, True, False),
    "biquad": (3000.0, 0.5, False, False, False),
}
BIQUAD_NAMES = tuple(_DEFAULTS)


def _exp10(x: float) -> float:
    """ff_exp10 (libavutil/internal.h): exp2(M_LOG2_10 * x)."""
    return math.exp2(_LOG2_10 * x)


# which named options each filter declares (af_biquads.c:1500-1674);
# gain exists only on the gain-shaped filters, csg only on bandpass...
_GAIN_NAMES = ("equalizer", "bass", "lowshelf", "treble", "highshelf",
               "tiltshelf")
# positional shorthand = FULL option-declaration order per filter table
# (af_biquads.c:1500-1674; aliases share their primary's slot, consts
# are skipped — ffmpeg binds positionals by walking the same order)
_TAIL = ("mix", "channels", "normalize", "transform", "precision",
         "blocksize")
_POSITIONAL = {
    "equalizer": ("frequency", "width_type", "width", "gain") + _TAIL,
    "bass": ("frequency", "width_type", "width", "gain",
             "poles") + _TAIL,
    "lowshelf": ("frequency", "width_type", "width", "gain",
                 "poles") + _TAIL,
    "treble": ("frequency", "width_type", "width", "gain",
               "poles") + _TAIL,
    "highshelf": ("frequency", "width_type", "width", "gain",
                  "poles") + _TAIL,
    "tiltshelf": ("frequency", "width_type", "width", "gain",
                  "poles") + _TAIL,
    "bandpass": ("frequency", "width_type", "width", "csg") + _TAIL,
    "bandreject": ("frequency", "width_type", "width") + _TAIL,
    "lowpass": ("frequency", "width_type", "width", "poles") + _TAIL,
    "highpass": ("frequency", "width_type", "width", "poles") + _TAIL,
    "allpass": ("frequency", "width_type", "width", "mix", "channels",
                "normalize", "order", "transform", "precision"),
    "biquad": ("a0", "a1", "a2", "b0", "b1", "b2") + _TAIL,
}


def parse_biquad_opts(name: str, val: str) -> Dict:
    """Shared option grammar (af_biquads.c:1456-1674)."""
    if name not in _DEFAULTS:
        raise ValueError(f"unknown biquad filter {name!r}")
    _, _, has_poles, has_order, has_csg = _DEFAULTS[name]
    kw: Dict = {}
    alias = {"f": "frequency", "t": "width_type", "w": "width",
             "g": "gain", "m": "mix", "c": "channels", "n": "normalize",
             "p": "poles", "a": "transform", "r": "precision",
             "b": "blocksize", "o": "order"}
    pos = _POSITIONAL[name]
    named_seen = False
    for i, tok in enumerate(str(val).split(":")):
        tok = tok.strip()
        if not tok:
            raise ValueError(f"{name}: empty option value")
        if "=" not in tok:
            # positional shorthand in declaration order, like ffmpeg's
            # av_opt_set_from_string
            if named_seen or i >= len(pos):
                raise ValueError(f"{name}: bad option {tok!r}")
            k, v = pos[i], tok
        else:
            k, v = tok.split("=", 1)
            k = alias.get(k.strip(), k.strip())
            named_seen = True
        if k == "gain" and name not in _GAIN_NAMES:
            raise ValueError(f"{name}: has no gain option "
                             "(af_biquads.c option tables)")
        if name == "biquad" and k in ("frequency", "width",
                                      "width_type", "gain"):
            raise ValueError(f"{name}: has no {k} option")
        if k == "frequency":
            kw[k] = float(v)
            if not 0 <= kw[k] <= 999999:
                raise ValueError(f"{name}: frequency out of range")
        elif k == "width":
            kw[k] = float(v)
            if not 0 <= kw[k] <= 99999:
                raise ValueError(f"{name}: width out of range")
        elif k == "width_type":
            if v not in _WIDTH_TYPES:
                raise ValueError(f"{name}: bad width_type {v!r}")
            kw[k] = v
        elif k == "gain":
            kw[k] = float(v)
            if not -900 <= kw[k] <= 900:
                raise ValueError(f"{name}: gain out of range")
        elif k == "mix":
            kw[k] = float(v)
            if not 0 <= kw[k] <= 1:
                raise ValueError(f"{name}: mix out of range")
        elif k == "channels":
            kw[k] = v
        elif k == "normalize":
            kw[k] = v.strip().lower() in ("1", "true", "on", "yes")
        elif k == "poles" and has_poles:
            kw[k] = int(v)
            if kw[k] not in (1, 2):
                raise ValueError(f"{name}: poles must be 1 or 2")
        elif k == "order" and has_order:
            kw[k] = int(v)
            if kw[k] not in (1, 2):
                raise ValueError(f"{name}: order must be 1 or 2")
        elif k == "csg" and has_csg:
            kw[k] = v.strip().lower() in ("1", "true", "on", "yes")
        elif k == "transform":
            if v != "di":
                raise ValueError(
                    f"{name}: only transform=di (the default) is "
                    "supported — each alternate form is a different "
                    "arithmetic (af_biquads.c:289-663)")
        elif k == "precision":
            if v not in ("auto", "s16"):
                raise ValueError(
                    f"{name}: precision {v!r} unsupported in the s16 "
                    "chain (auto/s16 only)")
        elif k == "blocksize":
            if int(v) != 0:
                raise ValueError(
                    f"{name}: blocksize (reverse two-pass filtering) "
                    "is not supported")
        elif name == "biquad" and k in ("a0", "a1", "a2",
                                        "b0", "b1", "b2"):
            kw[k] = float(v)
        else:
            raise ValueError(f"{name}: unknown option {k!r}")
    return kw


def compute_coeffs(name: str, rate: int, frequency: Optional[float] = None,
                   width_type: str = "q", width: Optional[float] = None,
                   gain: float = 0.0, poles: int = 2, order: int = 2,
                   csg: bool = False, normalize: bool = False,
                   oa0: float = 1.0, oa1: float = 0.0, oa2: float = 0.0,
                   ob0: float = 0.0, ob1: float = 0.0, ob2: float = 0.0):
    """config_filter coefficient math (af_biquads.c:792-1010).
    Returns (b0, b1, b2, a1, a2, bypass)."""
    dfreq, dwidth = _DEFAULTS[name][0], _DEFAULTS[name][1]
    frequency = dfreq if frequency is None else frequency
    width = dwidth if width is None else width
    A = _exp10(gain / 40.0)
    w0 = 2.0 * math.pi * frequency / rate
    K = math.tan(w0 / 2.0)

    bypass = ((w0 > math.pi or w0 <= 0.0) or width <= 0.0) \
        and name != "biquad"
    if bypass:
        return 1.0, 0.0, 0.0, 0.0, 0.0, True

    wt = _WIDTH_TYPES[width_type]
    if wt == HERTZ:
        alpha = math.sin(w0) / (2 * frequency / width)
    elif wt == KHERTZ:
        alpha = math.sin(w0) / (2 * frequency / (width * 1000))
    elif wt == OCTAVE:
        alpha = math.sin(w0) * math.sinh(
            math.log(2.0) / 2 * width * w0 / math.sin(w0))
    elif wt == QFACTOR:
        alpha = math.sin(w0) / (2 * width)
    else:  # SLOPE
        # np.sqrt: a negative radicand (width > 1) is nan like the C's
        # sqrt, not a Python ValueError
        with np.errstate(invalid="ignore"):
            alpha = float(math.sin(w0) / 2 * np.sqrt(
                np.float64((A + 1 / A) * (1 / width - 1) + 2)))
    beta = 2 * math.sqrt(A)

    cw = math.cos(w0)
    if name == "biquad":
        a0, a1, a2 = oa0, oa1, oa2
        b0, b1, b2 = ob0, ob1, ob2
    elif name == "equalizer":
        a0 = 1 + alpha / A
        a1 = -2 * cw
        a2 = 1 - alpha / A
        b0 = 1 + alpha * A
        b1 = -2 * cw
        b2 = 1 - alpha * A
    elif name in ("bass", "lowshelf", "tiltshelf"):
        if name == "bass":
            beta = math.sqrt((A * A + 1) - (A - 1) * (A - 1))
        if poles == 1:
            A1 = _exp10(gain / 20)
            ro = -math.sin(w0 / 2.0 - math.pi / 4) \
                / math.sin(w0 / 2.0 + math.pi / 4)
            n = (A1 + 1) / (A1 - 1) if A1 != 1.0 else 0.0
            alpha1 = 0.0 if A1 == 1.0 else \
                n - math.copysign(1.0, n) * math.sqrt(n * n - 1)
            beta0 = ((1 + A1) + (1 - A1) * alpha1) * 0.5
            beta1 = ((1 - A1) + (1 + A1) * alpha1) * 0.5
            a0 = 1 + ro * alpha1
            a1 = -ro - alpha1
            a2 = 0.0
            b0 = beta0 + ro * beta1
            b1 = -beta1 - ro * beta0
            b2 = 0.0
        else:
            a0 = (A + 1) + (A - 1) * cw + beta * alpha
            a1 = -2 * ((A - 1) + (A + 1) * cw)
            a2 = (A + 1) + (A - 1) * cw - beta * alpha
            b0 = A * ((A + 1) - (A - 1) * cw + beta * alpha)
            b1 = 2 * A * ((A - 1) - (A + 1) * cw)
            b2 = A * ((A + 1) - (A - 1) * cw - beta * alpha)
    elif name in ("treble", "highshelf"):
        if name == "treble":
            beta = math.sqrt((A * A + 1) - (A - 1) * (A - 1))
        if poles == 1:
            A1 = _exp10(gain / 20)
            ro = math.sin(w0 / 2.0 - math.pi / 4) \
                / math.sin(w0 / 2.0 + math.pi / 4)
            n = (A1 + 1) / (A1 - 1) if A1 != 1.0 else 0.0
            alpha1 = 0.0 if A1 == 1.0 else \
                n - math.copysign(1.0, n) * math.sqrt(n * n - 1)
            beta0 = ((1 + A1) + (1 - A1) * alpha1) * 0.5
            beta1 = ((1 - A1) + (1 + A1) * alpha1) * 0.5
            a0 = 1 + ro * alpha1
            a1 = ro + alpha1
            a2 = 0.0
            b0 = beta0 + ro * beta1
            b1 = beta1 + ro * beta0
            b2 = 0.0
        else:
            a0 = (A + 1) - (A - 1) * cw + beta * alpha
            a1 = 2 * ((A - 1) - (A + 1) * cw)
            a2 = (A + 1) - (A - 1) * cw - beta * alpha
            b0 = A * ((A + 1) + (A - 1) * cw + beta * alpha)
            b1 = -2 * A * ((A - 1) + (A + 1) * cw)
            b2 = A * ((A + 1) + (A - 1) * cw - beta * alpha)
    elif name == "bandpass":
        a0 = 1 + alpha
        a1 = -2 * cw
        a2 = 1 - alpha
        if csg:
            b0 = math.sin(w0) / 2
            b1 = 0.0
            b2 = -math.sin(w0) / 2
        else:
            b0 = alpha
            b1 = 0.0
            b2 = -alpha
    elif name == "bandreject":
        a0 = 1 + alpha
        a1 = -2 * cw
        a2 = 1 - alpha
        b0 = 1.0
        b1 = -2 * cw
        b2 = 1.0
    elif name == "lowpass":
        if poles == 1:
            a0 = 1.0
            a1 = -math.exp(-w0)
            a2 = 0.0
            b0 = 1 + a1
            b1 = 0.0
            b2 = 0.0
        else:
            a0 = 1 + alpha
            a1 = -2 * cw
            a2 = 1 - alpha
            b0 = (1 - cw) / 2
            b1 = 1 - cw
            b2 = (1 - cw) / 2
    elif name == "highpass":
        if poles == 1:
            a0 = 1.0
            a1 = -math.exp(-w0)
            a2 = 0.0
            b0 = (1 - a1) / 2
            b1 = -b0
            b2 = 0.0
        else:
            a0 = 1 + alpha
            a1 = -2 * cw
            a2 = 1 - alpha
            b0 = (1 + cw) / 2
            b1 = -(1 + cw)
            b2 = (1 + cw) / 2
    else:  # allpass
        if order == 1:
            a0 = 1.0
            a1 = -(1.0 - K) / (1.0 + K)
            a2 = 0.0
            b0 = a1
            b1 = a0
            b2 = 0.0
        else:
            a0 = 1 + alpha
            a1 = -2 * cw
            a2 = 1 - alpha
            b0 = 1 - alpha
            b1 = -2 * cw
            b2 = 1 + alpha

    # C double division: a0 == 0 (biquad=a0=0) yields inf/nan garbage,
    # never a crash
    with np.errstate(divide="ignore", invalid="ignore"):
        a0f = np.float64(a0)
        a1 = float(np.float64(a1) / a0f)
        a2 = float(np.float64(a2) / a0f)
        b0 = float(np.float64(b0) / a0f)
        b1 = float(np.float64(b1) / a0f)
        b2 = float(np.float64(b2) / a0f)

    if normalize and abs(b0 + b1 + b2) > 1e-6:
        factor = (1.0 + a1 + a2) / (b0 + b1 + b2)
        b0 *= factor
        b1 *= factor
        b2 *= factor

    if name == "tiltshelf":
        b0 /= A
        b1 /= A
        b2 /= A

    return b0, b1, b2, a1, a2, False


class BiquadStream:
    """Streaming s16 biquad over interleaved blocks; per-channel double
    DF1 state, the channels= bypass set like dynaudnorm's."""

    def __init__(self, rate: int, name: str, mix: float = 1.0,
                 channels: str = "all", **opts):
        self.rate = int(rate)
        self.name = name
        self.mix = float(mix)
        self.channels_to_filter = str(channels)
        bq = {k: opts[k] for k in ("a0", "a1", "a2", "b0", "b1", "b2")
              if k in opts}
        co = {k: v for k, v in opts.items() if k not in bq}
        if name == "biquad":
            co.update({"o" + k: v for k, v in bq.items()})
        (self.b0, self.b1, self.b2, self.a1, self.a2,
         self.bypass) = compute_coeffs(name, self.rate, **co)
        self._lib = native.load("gmat_dsp")
        self._state = None
        self._bypassmask = None
        self.clippings = 0

    def _ensure(self, ch: int):
        if self._state is None:
            self._state = np.zeros((ch, 4), np.float64)
            if self.channels_to_filter == "all":
                self._bypassmask = [False] * ch
            else:
                from .audio_filters import _DEFAULT_IDS, _parse_layout
                _, keep = _parse_layout(self.channels_to_filter)
                ids = _DEFAULT_IDS.get(ch, list(range(ch)))
                self._bypassmask = ([False] * ch if keep is None else
                                    [ids[c] not in keep
                                     for c in range(ch)])

    def push(self, block: np.ndarray) -> np.ndarray:
        if block.size == 0 or self.bypass:
            return block
        n, ch = block.shape
        self._ensure(ch)
        out = np.empty_like(block)
        clip = ctypes.c_longlong(self.clippings)
        for c in range(ch):
            col_in = np.ascontiguousarray(block[:, c])
            if self._bypassmask[c]:
                out[:, c] = col_in
                continue
            col_out = np.empty(n, np.int16)
            st = self._state[c]
            self._lib.gdsp_biquad_di_s16(
                col_in.ctypes.data_as(ctypes.POINTER(ctypes.c_short)),
                col_out.ctypes.data_as(ctypes.POINTER(ctypes.c_short)),
                n, st.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                self.b0, self.b1, self.b2, self.a1, self.a2,
                self.mix, 0, ctypes.byref(clip))
            out[:, c] = col_out
        self.clippings = clip.value
        return out

    def flush(self) -> np.ndarray:
        return np.zeros((0, 0), np.int16)
