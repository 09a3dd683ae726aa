"""Audio filters: atempo / volume / aresample / afade / aecho / pan
/ loudnorm (av/loudnorm.py) / dynaudnorm (av/dynaudnorm.py) /
amix (av/amix.py).

Covers the audio filter chain the reference drives through libavfilter
(AppMeTrans options.xml `<AudioFilterDesc>atempo=0.7143</AudioFilterDesc>`,
AppMeTrans.cpp:176-200).  atempo is a WSOLA-style time stretch (same
algorithm family as ffmpeg's af_atempo); afade rebuilds af_afade.c's
20-curve gain family with streaming window semantics; all filters
operate on interleaved s16 numpy blocks.

A copy of `gmat_tpu/av/audio_filters.py` for the PyTorch port: host numpy
on interleaved PCM, no device work.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np


class AtempoStream:
    """Streaming WSOLA time-stretch: push int16 blocks, pull stretched
    blocks, flush() at EOF — the libavfilter-style chunked behavior, so a
    whole track never has to sit in memory.  State is a small carry
    buffer (window + search lookahead); the one-shot `atempo()` below is
    literally push+flush of this class, so both paths are identical."""

    def __init__(self, rate: int, tempo: float = 1.0):
        if not 0.5 <= tempo <= 2.0:
            raise ValueError("atempo factor must be in [0.5, 2.0]")
        self.tempo = float(tempo)
        self.passthrough = abs(tempo - 1.0) < 1e-6
        self.win = max(int(rate * 0.040), 32)           # 40 ms frames
        self.hop_out = self.win // 2
        self.hop_in = int(round(self.hop_out * tempo))
        self.search = self.win // 4
        self._hann = np.hanning(self.win * 2)[self.win:self.win * 2][:, None] \
            .astype(np.float32)
        self._fade_in = np.hanning(self.win * 2)[:self.win][:, None] \
            .astype(np.float32)
        self._buf = None          # f32 carry, buf[0] is absolute idx _base
        self._base = 0
        self._pos = 0             # absolute next-window position
        self._prev_tail = None
        self._done = False

    def push(self, samples: np.ndarray) -> np.ndarray:
        """Feed an (n, ch) int16 block; returns produced output (may be
        empty while the lookahead fills)."""
        if self.passthrough:
            return samples
        x = samples.astype(np.float32)
        # an empty (0, 0)-shaped first block must not seed _buf: the
        # next concatenate would fail on the channel-axis mismatch
        if x.size:
            self._buf = x if self._buf is None \
                else np.concatenate([self._buf, x])
        return self._emit(self._drain())

    def _drain(self) -> List[np.ndarray]:
        out: List[np.ndarray] = []
        if self._buf is None:
            return out
        n = self._base + len(self._buf)
        win, hop_out, search = self.win, self.hop_out, self.search
        while self._pos + win + search < n:
            pos_r = self._pos - self._base
            if self._prev_tail is None:
                seg = self._buf[pos_r:pos_r + win]
            else:
                best_off, best_score = 0, -np.inf
                ref = self._prev_tail[:, 0]
                lo = max(pos_r - search, 0)
                hi = min(pos_r + search, len(self._buf) - win)
                for off in range(lo, hi):
                    cand = self._buf[off:off + len(ref), 0]
                    score = float(np.dot(ref, cand))
                    if score > best_score:
                        best_score, best_off = score, off
                seg = self._buf[best_off:best_off + win]
            if self._prev_tail is not None:
                out.append(seg[:hop_out] * self._fade_in[:hop_out] +
                           self._prev_tail[:hop_out] * self._hann[:hop_out])
            else:
                out.append(seg[:hop_out])
            self._prev_tail = seg[hop_out:].copy()
            self._pos += self.hop_in
        # trim consumed prefix, keeping the search lookbehind window —
        # but never trim before the first processed window (short-input
        # fallback at flush needs the whole signal)
        if self._prev_tail is not None:
            keep_from = max(self._pos - search - self._base, 0)
            if keep_from > 0:
                self._buf = self._buf[keep_from:]
                self._base += keep_from
        return out

    @staticmethod
    def _emit(chunks: List[np.ndarray]) -> np.ndarray:
        chunks = [c for c in chunks if c.size]
        if not chunks:
            return np.zeros((0, 0), np.int16)
        y = np.concatenate(chunks)
        return np.clip(y, -32768, 32767).astype(np.int16)

    def flush(self) -> np.ndarray:
        """End of stream: emit the epilogue (pending tail + uncovered
        end of the signal)."""
        if self.passthrough or self._buf is None or self._done:
            return np.zeros((0, 0), np.int16)
        self._done = True
        n = self._base + len(self._buf)
        out = self._drain()
        if self._prev_tail is None:
            # whole stream was too short to stretch: nearest-resample
            idx = np.clip((np.arange(int(n / self.tempo)) *
                           self.tempo).astype(int), 0, max(n - 1, 0))
            short = np.clip(self._buf, -32768, 32767).astype(np.int16)
            return short[idx] if n else np.zeros((0, 0), np.int16)
        out.append(self._prev_tail)
        if self._pos < n:
            out.append(self._buf[self._pos + self.win - self._base:])
        return self._emit(out)


def atempo(samples: np.ndarray, rate: int, tempo: float = 1.0) -> np.ndarray:
    """Time-stretch without pitch change. samples: (n, ch) int16.

    tempo > 1 speeds up (shorter output), < 1 slows down. Valid 0.5..2.0
    per ffmpeg's constraint (chain twice for more, like ffmpeg).
    One-shot = push + flush of AtempoStream.
    """
    st = AtempoStream(rate, tempo)
    if st.passthrough or samples.shape[0] == 0:
        return samples
    a = st.push(samples)
    b = st.flush()
    parts = [p for p in (a, b) if p.size]
    return np.concatenate(parts) if parts else samples[:0]


_VOLUME_PRECISIONS = ("fixed", "float", "double")


def _parse_volume_opts(val: str) -> Dict:
    """af_volume options (af_volume.c:60-78): positional or named
    volume expression (av_expr: dB suffixes, arithmetic), precision
    fixed/float/double, eval once (the default; 'frame' only matters
    for per-frame vars, which a constant expression doesn't use)."""
    kw: Dict = {}
    named_seen = False
    for i, tok in enumerate(str(val).split(":")):
        tok = tok.strip()
        if not tok:
            continue
        k, _, v = tok.partition("=")
        k = k.strip()
        if _ and k in ("volume", "v"):
            kw["volume"] = v
            named_seen = True
        elif _ and k == "precision":
            if v not in _VOLUME_PRECISIONS:
                raise ValueError(f"volume: bad precision {v!r}")
            kw["precision"] = v
            named_seen = True
        elif _ and k == "eval":
            if v not in ("once", "frame"):
                raise ValueError(f"volume: bad eval mode {v!r}")
            named_seen = True
        elif not _ and not named_seen and i == 0:
            kw["volume"] = tok
        elif not _ and not named_seen and i == 1:
            # positional precision, declaration order like ffmpeg
            if tok not in _VOLUME_PRECISIONS:
                raise ValueError(f"volume: bad precision {tok!r}")
            kw["precision"] = tok
        elif not _ and not named_seen and i == 2:
            if tok not in ("once", "frame"):
                raise ValueError(f"volume: bad eval mode {tok!r}")
        else:
            raise ValueError(f"volume: unknown option {tok!r}")
    return kw


def _volume_value(volume) -> float:
    """Evaluate the volume option like af_volume's av_expr (handles
    '-6dB', '1/2', plain numbers)."""
    if isinstance(volume, str):
        from ..filters.expr import compile_expr
        v = float(compile_expr(volume)({}))
    else:
        v = float(volume)
    if np.isnan(v):
        raise ValueError("volume: invalid value NaN")
    return v


def volume(samples: np.ndarray, rate: int, volume=1.0,
           precision: str = "float") -> np.ndarray:
    """af_volume's three lanes (af_volume.c:136-242):
    - fixed: s16 stays integer — volume_i = (int)(v*256 + 0.5),
      out = av_clip_int16((in*volume_i + 128) >> 8)  (:183-191);
    - float (the DEFAULT): s16 -> f32 (x * 1/32768), f32 multiply,
      back via lrintf(x*32768) clipped — the aresample conversions
      ffmpeg's format negotiation inserts around the FLT-only filter;
    - double: same in f64."""
    vol = _volume_value(volume)
    if precision == "fixed":
        vol_i = int(vol * 256 + 0.5)
        y = (samples.astype(np.int64) * vol_i + 128) >> 8
        return np.clip(y, -32768, 32767).astype(np.int16)
    if precision == "double":
        y = (samples.astype(np.float64) / 32768.0) * vol
        return np.clip(np.rint(y * 32768.0), -32768,
                       32767).astype(np.int16)
    f32 = np.float32
    x = samples.astype(np.float32) * f32(1.0 / 32768.0)
    y = x * f32(vol)
    return np.clip(np.rint(y * f32(32768.0)), -32768,
                   32767).astype(np.int16)


def aresample(samples: np.ndarray, rate: int, out_rate: int) -> Tuple[np.ndarray, int]:
    """Linear-interp resample; returns (samples, new_rate).

    One-shot = push + flush of AresampleStream, so the offline and
    streamed chains produce identical output for the same description
    (the same invariant atempo() keeps)."""
    out_rate = int(out_rate)
    if out_rate == rate or samples.shape[0] < 2:
        return samples, out_rate
    st = AresampleStream(rate, out_rate)
    parts = [p for p in (st.push(samples), st.flush()) if p.size]
    y = np.concatenate(parts) if parts else samples[:0]
    return y, out_rate


_BIQUAD_NAMES = ("equalizer", "bass", "lowshelf", "treble", "highshelf",
                 "tiltshelf", "lowpass", "highpass", "bandpass",
                 "bandreject", "allpass", "biquad")


def parse_audio_filters(desc: str) -> List[Tuple[str, Dict[str, float]]]:
    """'atempo=0.7143,volume=0.5' -> [('atempo', {...}), ...]."""
    chain = []
    for part in filter(None, (p.strip() for p in desc.split(","))):
        if "=" in part:
            name, val = part.split("=", 1)
            if name.strip() == "aresample":
                chain.append((name.strip(), {"out_rate": float(val)}))
            elif name.strip() == "atempo":
                chain.append((name.strip(), {"tempo": float(val)}))
            elif name.strip() == "volume":
                chain.append((name.strip(), _parse_volume_opts(val)))
            elif name.strip() == "afade":
                chain.append((name.strip(), _parse_afade_opts(val)))
            elif name.strip() == "aecho":
                chain.append((name.strip(), _parse_aecho_opts(val)))
            elif name.strip() == "pan":
                chain.append((name.strip(), {"args": val}))
            elif name.strip() == "loudnorm":
                from .loudnorm import parse_loudnorm_opts
                chain.append((name.strip(), parse_loudnorm_opts(val)))
            elif name.strip() == "dynaudnorm":
                from .dynaudnorm import parse_dynaudnorm_opts
                chain.append((name.strip(), parse_dynaudnorm_opts(val)))
            elif name.strip() == "amix":
                from .amix import parse_amix_opts
                chain.append((name.strip(), parse_amix_opts(val)))
            elif name.strip() == "aloop":
                chain.append((name.strip(), _parse_aloop_opts(val)))
            elif name.strip() == "adelay":
                chain.append((name.strip(), _parse_adelay_opts(val)))
            elif name.strip() == "apad":
                chain.append((name.strip(), _parse_apad_opts(val)))
            elif name.strip() == "areverse":
                chain.append((name.strip(), {}))
            elif name.strip() in _BIQUAD_NAMES:
                from .biquads import parse_biquad_opts
                chain.append((name.strip(),
                              parse_biquad_opts(name.strip(), val)))
            else:
                raise ValueError(f"unknown audio filter {name!r}")
        elif part == "afade":
            chain.append(("afade", {}))
        elif part == "aecho":
            chain.append(("aecho", {}))
        elif part == "loudnorm":
            chain.append(("loudnorm", {}))
        elif part == "dynaudnorm":
            chain.append(("dynaudnorm", {}))
        elif part == "aloop":
            chain.append(("aloop", {}))
        elif part == "adelay":
            chain.append(("adelay", {}))
        elif part == "areverse":
            chain.append(("areverse", {}))
        elif part in _BIQUAD_NAMES:
            chain.append((part, {}))
        else:
            raise ValueError(f"audio filter needs a value: {part!r}")
    return chain


_AECHO_ORDER = ("in_gain", "out_gain", "delays", "decays")


def _parse_aecho_opts(val: str) -> Dict:
    """'0.8:0.9:1000|1800:0.3|0.25' positional, or named k=v options."""
    kw: Dict = {}
    positional = True
    for i, tok in enumerate(val.split(":")):
        if "=" in tok:
            k, v = tok.split("=", 1)
            k = k.strip()
            positional = False
        elif positional and i < len(_AECHO_ORDER):
            k, v = _AECHO_ORDER[i], tok
        else:
            raise ValueError(f"aecho: bad option {tok!r}")
        if k in ("in_gain", "out_gain"):
            kw[k] = float(v)
        elif k in ("delays", "decays"):
            kw[k] = v
        else:
            raise ValueError(f"aecho: unknown option {k!r}")
    return kw


_AFADE_ALIASES = {"t": "type", "ss": "start_sample", "ns": "nb_samples",
                  "st": "start_time", "d": "duration", "c": "curve"}


def _parse_afade_opts(val: str) -> Dict:
    """'t=in:ss=0:ns=44100:c=qsin' (or positional 'in:0:44100')."""
    kw: Dict = {}
    order = ("type", "start_sample", "nb_samples")
    positional = True
    for i, tok in enumerate(filter(None, val.split(":"))):
        if "=" in tok:
            k, v = tok.split("=", 1)
            k = _AFADE_ALIASES.get(k.strip(), k.strip())
            positional = False
        elif positional and i < len(order):
            k, v = order[i], tok
        else:
            raise ValueError(f"afade: bad option {tok!r}")
        if k in ("start_sample", "nb_samples"):
            kw[k] = int(v)
        elif k in ("start_time", "duration"):
            kw[k] = float(v)
        elif k in ("type", "curve"):
            kw[k] = v
        else:
            raise ValueError(f"afade: unknown option {k!r}")
    return kw


class AresampleStream:
    """Streaming resampler.  Primary engine: the REAL libswresample
    (av/swr.py) — exactly what af_aresample delegates to
    (af_aresample.c swr_convert_frame), so output matches ffmpeg's
    polyphase resampler, not an approximation.  Falls back to the
    original linear-interp grid (uniform t_k = k*rate/out_rate with a
    1-sample carry) when the library is unavailable."""

    def __init__(self, rate: int, out_rate: int):
        self.rate, self.out_rate = int(rate), int(out_rate)
        self.step = rate / float(out_rate)
        self._t = 0.0             # absolute source index of next output
        self._base = 0
        self._buf = None
        self._swr = None
        self._swr_failed = self.rate == self.out_rate

    def _swr_engine(self, ch: int):
        if self._swr is None and not self._swr_failed:
            try:
                from .swr import SwrStream
                self._swr = SwrStream(self.rate, self.out_rate, ch)
            except Exception:
                self._swr_failed = True
        return self._swr

    def push(self, samples: np.ndarray) -> np.ndarray:
        if self.out_rate == self.rate:
            return samples
        if samples.size and self._buf is None:
            eng = self._swr_engine(samples.shape[1])
            if eng is not None:
                return eng.push(samples)
        elif self._swr is not None:
            return self._swr.push(samples)
        x = samples.astype(np.float32)
        # an empty (0, 0)-shaped first block must not seed _buf: the
        # next concatenate would fail on the channel-axis mismatch
        if x.size:
            self._buf = x if self._buf is None \
                else np.concatenate([self._buf, x])
        return self._produce(last=False)

    def _produce(self, last: bool) -> np.ndarray:
        if self._buf is None or len(self._buf) < 2:
            return np.zeros((0, 0), np.int16)
        n = self._base + len(self._buf)
        limit = (n - 1) if not last else (n - 1) + 1e-9
        k0 = self._t
        count = int(np.floor((limit - k0) / self.step)) + 1 \
            if limit >= k0 else 0
        if count <= 0:
            return np.zeros((0, 0), np.int16)
        src = k0 + np.arange(count) * self.step
        i0 = np.floor(src).astype(np.int64)
        i1 = np.minimum(i0 + 1, n - 1)
        f = (src - i0)[:, None].astype(np.float32)
        r0 = self._buf[i0 - self._base]
        r1 = self._buf[i1 - self._base]
        y = r0 * (1 - f) + r1 * f
        self._t = k0 + count * self.step
        # cap at the buffer length: for step >= 2 the next read position
        # can land past the last buffered sample, and trimming beyond the
        # buffer would silently advance _base past the true consumed
        # count, misregistering every later chunk
        keep = min(max(int(np.floor(self._t)) - self._base, 0),
                   len(self._buf))
        if keep > 0:
            self._buf = self._buf[keep:]
            self._base += keep
        return np.clip(y, -32768, 32767).astype(np.int16)

    def flush(self) -> np.ndarray:
        if self.out_rate == self.rate:
            return np.zeros((0, 0), np.int16)
        if self._swr is not None:
            return self._swr.flush()
        return self._produce(last=True)


class AudioFilterStream:
    """Chunked audio filter chain (the streaming analog of
    apply_audio_filters): push decoded blocks as they arrive, pull
    filtered blocks, flush() at EOF.  `out_rate` reports the chain's
    output sample rate (aresample changes it)."""

    def __init__(self, desc: str, rate: int):
        self.stages = []
        self.out_rate = int(rate)
        for name, kw in parse_audio_filters(desc):
            if name == "aresample":
                st = AresampleStream(self.out_rate, int(kw["out_rate"]))
                self.out_rate = st.out_rate
                self.stages.append(st)
            elif name == "atempo":
                self.stages.append(AtempoStream(self.out_rate, kw["tempo"]))
            elif name == "afade":
                self.stages.append(AfadeStream(self.out_rate, **kw))
            elif name == "aecho":
                self.stages.append(AechoStream(self.out_rate, **kw))
            elif name == "pan":
                self.stages.append(("pan", PanFilter(self.out_rate, **kw)))
            elif name == "loudnorm":
                from .loudnorm import LoudnormStream
                self.stages.append(LoudnormStream(self.out_rate, **kw))
            elif name == "dynaudnorm":
                from .dynaudnorm import DynaudnormStream
                self.stages.append(DynaudnormStream(self.out_rate, **kw))
            elif name == "amix":
                from .amix import AmixStream
                self.stages.append(AmixStream(self.out_rate, **kw))
            elif name == "aloop":
                self.stages.append(AloopStream(self.out_rate, **kw))
            elif name == "adelay":
                self.stages.append(AdelayStream(self.out_rate, **kw))
            elif name == "apad":
                self.stages.append(ApadStream(self.out_rate, **kw))
            elif name == "areverse":
                self.stages.append(AreverseStream(self.out_rate))
            elif name in _BIQUAD_NAMES:
                from .biquads import BiquadStream
                self.stages.append(BiquadStream(self.out_rate, name,
                                                **kw))
            elif name == "volume":
                # resolve the expression ONCE at build: the streaming
                # hot path must not re-run compile_expr per block
                kw = dict(kw)
                kw["volume"] = _volume_value(kw.get("volume", 1.0))
                self.stages.append(("volume", kw))

    def _through(self, block: np.ndarray, start: int) -> np.ndarray:
        for st in self.stages[start:]:
            if block.size == 0:
                break
            if isinstance(st, tuple):
                if st[0] == "pan":
                    block = st[1].process(block)
                else:
                    block = volume(block, 0, **st[1])
            else:
                block = st.push(block)
        return block

    def push(self, block: np.ndarray) -> np.ndarray:
        return self._through(block, 0)

    def flush(self) -> np.ndarray:
        outs = []
        for i, st in enumerate(self.stages):
            if isinstance(st, tuple):
                continue
            tail = st.flush()
            if tail.size:
                tail = self._through(tail, i + 1)
                if tail.size:
                    outs.append(tail)
        return np.concatenate(outs) if outs else np.zeros((0, 0), np.int16)


def apply_audio_filters(samples: np.ndarray, rate: int, desc: str):
    """Run a parsed chain; returns (samples, rate)."""
    for name, kw in parse_audio_filters(desc):
        if name == "aresample":
            samples, rate = aresample(samples, rate, **kw)
        elif name == "atempo":
            samples = atempo(samples, rate, **kw)
        elif name == "afade":
            st = AfadeStream(rate, **kw)
            samples = st.push(samples)
        elif name == "aecho":
            st = AechoStream(rate, **kw)
            parts = [p for p in (st.push(samples), st.flush()) if p.size]
            samples = np.concatenate(parts) if parts else samples[:0]
        elif name == "pan":
            samples = PanFilter(rate, **kw).process(samples)
        elif name == "loudnorm":
            from .loudnorm import LoudnormStream
            st = LoudnormStream(rate, **kw)
            parts = [p for p in (st.push(samples), st.flush()) if p.size]
            samples = np.concatenate(parts) if parts else samples[:0]
        elif name == "dynaudnorm":
            from .dynaudnorm import DynaudnormStream
            st = DynaudnormStream(rate, **kw)
            parts = [p for p in (st.push(samples), st.flush()) if p.size]
            samples = np.concatenate(parts) if parts else samples[:0]
        elif name == "amix":
            from .amix import AmixStream
            st = AmixStream(rate, **kw)
            parts = [p for p in (st.push(samples), st.flush()) if p.size]
            samples = np.concatenate(parts) if parts else samples[:0]
        elif name == "aloop":
            # f_loop's audio semantics depend on the input frame
            # segmentation (see AloopStream); the offline path feeds
            # decoder-typical 1024-sample frames
            st = AloopStream(rate, **kw)
            parts = [st.push(samples[i:i + 1024])
                     for i in range(0, len(samples), 1024)]
            parts.append(st.flush())
            parts = [p for p in parts if p.size]
            samples = np.concatenate(parts) if parts else samples[:0]
        elif name in ("adelay", "apad", "areverse"):
            st = {"adelay": AdelayStream, "apad": ApadStream,
                  "areverse": AreverseStream}[name](rate, **kw)
            parts = [p for p in (st.push(samples), st.flush())
                     if p.size]
            samples = np.concatenate(parts) if parts else samples[:0]
        elif name in _BIQUAD_NAMES:
            from .biquads import BiquadStream
            samples = BiquadStream(rate, name, **kw).push(samples)
        elif name == "volume":
            samples = volume(samples, rate, **kw)
    return samples, rate


# ---- afade (af_afade.c) -----------------------------------------------------

def _afade_gain(curve: str, index: np.ndarray, rng: int) -> np.ndarray:
    """Vectorized fade_gain (af_afade.c:70-146): index may be negative or
    past range (clipped), every curve in double like the C switch."""
    g = np.clip(index.astype(np.float64) / float(rng), 0.0, 1.0)
    if curve == "tri":
        return g
    if curve == "qsin":
        return np.sin(g * np.pi / 2.0)
    if curve == "iqsin":
        return 0.6366197723675814 * np.arcsin(g)
    if curve == "esin":
        return 1.0 - np.cos(np.pi / 4.0 * ((2.0 * g - 1) ** 3 + 1))
    if curve == "hsin":
        return (1.0 - np.cos(g * np.pi)) / 2.0
    if curve == "ihsin":
        return 0.3183098861837907 * np.arccos(1 - 2 * g)
    if curve == "exp":
        return np.exp(-11.512925464970227 * (1 - g))
    if curve == "log":
        with np.errstate(divide="ignore"):
            return np.clip(1 + 0.2 * np.log10(g), 0.0, 1.0)
    if curve == "par":
        return 1 - np.sqrt(1 - g)
    if curve == "ipar":
        return 1 - (1 - g) * (1 - g)
    if curve == "qua":
        return g * g
    if curve == "cub":
        return g ** 3
    if curve == "squ":
        return np.sqrt(g)
    if curve == "cbr":
        return np.cbrt(g)
    if curve == "dese":
        return np.where(g <= 0.5, np.cbrt(2 * g) / 2,
                        1 - np.cbrt(2 * (1 - g)) / 2)
    if curve == "desi":
        return np.where(g <= 0.5, (2 * g) ** 3 / 2,
                        1 - (2 * (1 - g)) ** 3 / 2)
    if curve == "losi":
        a = 1.0 / (1.0 - 0.787) - 1
        A = 1.0 / (1.0 + np.exp(-((g - 0.5) * a * 2.0)))
        B = 1.0 / (1.0 + np.exp(a))
        C = 1.0 / (1.0 + np.exp(-a))
        return (A - B) / (C - B)
    if curve == "sinc":
        with np.errstate(invalid="ignore"):
            return np.where(g >= 1.0, 1.0,
                            np.sin(np.pi * (1.0 - g)) / (np.pi * (1.0 - g)))
    if curve == "isinc":
        with np.errstate(invalid="ignore"):
            return np.where(g <= 0.0, 0.0,
                            1.0 - np.sin(np.pi * g) / (np.pi * g))
    if curve in ("nofade", "none"):
        return np.ones_like(g)
    raise ValueError(f"afade: unknown curve {curve!r}")


_AFADE_CURVES = ("tri", "qsin", "iqsin", "esin", "hsin", "ihsin", "exp",
                 "log", "par", "ipar", "qua", "cub", "squ", "cbr", "dese",
                 "desi", "losi", "sinc", "isinc", "nofade", "none")


class AfadeStream:
    """Streaming afade (af_afade.c filter_frame): gain ramp over an
    absolute sample window; before a fade-in / after a fade-out the
    block is silenced, past a fade-in / before a fade-out it passes
    through untouched.  Sample position counts pushed samples (the
    pts-derived cur_sample of the reference)."""

    def __init__(self, rate: int, type="in", start_sample=0,
                 nb_samples=44100, start_time=None, duration=None,
                 curve="tri"):
        t = str(type).lower()
        if t in ("in", "0"):
            self.out = False
        elif t in ("out", "1"):
            self.out = True
        else:
            raise ValueError(f"afade type must be in|out, got {type!r}")
        self.curve = str(curve).lower()
        if self.curve not in _AFADE_CURVES:
            raise ValueError(f"afade: unknown curve {self.curve!r}")
        rate = int(rate)
        # config_output uses FALSY checks (af_afade.c `if (s->duration)`)
        # — an explicit st=0 / d=0 means unset, ss/ns are kept
        self.start = int(round(float(start_time) * rate)) \
            if start_time else int(start_sample)
        self.range = int(round(float(duration) * rate)) \
            if duration else int(nb_samples)
        self.range = max(1, self.range)
        self._pos = 0

    def push(self, block: np.ndarray) -> np.ndarray:
        n = len(block)
        cur = self._pos
        self._pos += n
        if n == 0:
            return block
        # passthrough regions (af_afade.c:278-280)
        if (not self.out and self.start + self.range < cur) or \
                (self.out and cur + n < self.start):
            return block
        # silence regions (af_afade.c:291-294)
        if (not self.out and cur + n < self.start) or \
                (self.out and self.start + self.range < cur):
            return np.zeros_like(block)
        if not self.out:
            idx = (cur - self.start) + np.arange(n)
        else:
            idx = (self.start + self.range - cur) - np.arange(n)
        gain = _afade_gain(self.curve, idx, self.range)[:, None]
        return (block.astype(np.float64) * gain).astype(block.dtype)

    def flush(self) -> np.ndarray:
        return np.zeros((0, 0), np.int16)


# ---- aecho (af_aecho.c) -----------------------------------------------------

class AechoStream:
    """Streaming echo (af_aecho.c:157-196 ECHO macro, s16 lane): a
    feedforward comb over the raw-input delay ring —
    ``out = out_gain * (in*in_gain + sum_j dbuf[n - lag_j]*decay_j)``
    in double, av_clipd to int16 range, C double->int16 store
    truncation toward zero.  The C writes dbuf[index] AFTER the taps,
    so a 0-sample delay (sub-ms at low rates) reads the value from
    max_samples ago — lag_j = samples_j or max_samples when 0.
    At EOF the C's request_frame pushes max_samples of silence through
    the comb in <=2048-sample frames (af_aecho.c:271-293); flush()
    reproduces that tail."""

    def __init__(self, rate: int, in_gain=0.6, out_gain=0.3,
                 delays="1000", decays="0.5"):
        # the C stores every option as float32 (AV_OPT_TYPE_FLOAT gains,
        # av_sscanf("%f") delay/decay arrays, af_aecho.c:30-55,73-85) and
        # promotes the float VALUES to double in the ECHO taps — the
        # f32 rounding of e.g. 0.7 flips ~0.25% of int16 samples by 1
        self.in_gain = float(np.float32(in_gain))
        self.out_gain = float(np.float32(out_gain))
        if not 0.0 <= self.in_gain <= 1.0:
            raise ValueError("aecho: in_gain out of range [0, 1]")
        if not 0.0 <= self.out_gain <= 1.0:
            raise ValueError("aecho: out_gain out of range [0, 1]")
        self.delay = [float(np.float32(t))
                      for t in str(delays).split("|") if t != ""]
        self.decay = [float(np.float32(t))
                      for t in str(decays).split("|") if t != ""]
        if len(self.delay) != len(self.decay):
            raise ValueError(
                f"aecho: number of delays {len(self.delay)} differs from "
                f"number of decays {len(self.decay)}")
        if not self.delay:
            raise ValueError("aecho: at least one decay & delay must be set")
        for d in self.delay:
            if not 0.0 < d <= 90000.0:
                raise ValueError(
                    f"aecho: delay {d} out of allowed range (0, 90000]")
        for d in self.decay:
            if not 0.0 < d <= 1.0:
                raise ValueError(
                    f"aecho: decay {d} out of allowed range (0, 1]")
        # config_output (af_aecho.c:211): float delay * int rate is a
        # FLOAT product, then double /1000.0, then int truncation
        self.samples = [int(float(np.float32(np.float32(d)
                                             * np.float32(rate)))
                            / 1000.0) for d in self.delay]
        self.max_samples = max(self.samples)
        if self.max_samples <= 0:
            raise ValueError("aecho: nothing to echo - missing delay samples")
        self.lags = [s if s > 0 else self.max_samples for s in self.samples]
        self._hist = None            # (max_samples, ch) float64 raw inputs
        self._ch = 0
        self._flushed = False

    def push(self, block: np.ndarray) -> np.ndarray:
        n = len(block)
        if n == 0:
            return block
        x = block.astype(np.float64)
        self._ch = x.shape[1]
        if self._hist is None:
            self._hist = np.zeros((self.max_samples, self._ch), np.float64)
        ext = np.concatenate([self._hist, x])
        out = x * self.in_gain
        for lag, decay in zip(self.lags, self.decay):
            off = self.max_samples - lag
            out += ext[off:off + n] * decay
        out *= self.out_gain
        self._hist = ext[-self.max_samples:]
        return np.trunc(np.clip(out, -32768.0, 32767.0)).astype(np.int16)

    def flush(self) -> np.ndarray:
        if self._hist is None or self._flushed:
            return np.zeros((0, 0), np.int16)
        self._flushed = True
        outs, remaining = [], self.max_samples
        while remaining > 0:
            nb = min(remaining, 2048)
            outs.append(self.push(np.zeros((nb, self._ch), np.int16)))
            remaining -= nb
        return np.concatenate(outs)


class AloopStream:
    """af_loop analog (f_loop.c:59-258, audio lane): capture `size`
    samples starting at absolute sample position `start` and replay
    them `loop` times, exactly as afilter_frame/push_samples do —
    including the segmentation-dependent quirks of the C:

    - the boundary block crossing `size` is EMITTED truncated to the
      `written` prefix (frame->nb_samples = ret, :162); its tail goes
      to the `left` fifo via write-whole-then-drain, which keeps
      block[n-written:] (:156-160) — and with the activate() scheduler
      that fifo is never drained (arequest_frame's left branch is only
      reachable when aactivate stops calling it), so those samples are
      dropped; we reproduce the drop.
    - capture uses write-then-drain: the first recorded block writes
      its whole prefix then drains (start - ignored_samples) (:145-150),
      so `written` counts from the block START, not from `start`.
    - replay cycles decrement loop per full pass (push_samples
      :119-125); EOF truncates size to what was captured and replays
      at EOF (aactivate :237-241).

    loop=-1 (infinite) is rejected; total replayed samples are capped
    to keep the one-shot emission materializable."""

    _MAX_CLONES = 1 << 26

    def __init__(self, rate: int, loop=0, size=0, start=0):
        self.loop = int(loop)
        self.size = int(size)
        self.start = int(start)
        if self.loop < 0:
            raise ValueError("aloop: loop=-1 (infinite) is not "
                             "supported in the batch pipeline")
        if not 0 <= self.size <= 2**31 - 1:
            raise ValueError("aloop: size out of [0, INT32_MAX]")
        if self.start < 0:
            raise ValueError("aloop: start must be >= 0")
        if self.loop * self.size > self._MAX_CLONES:
            raise ValueError(f"aloop: loop*size exceeds "
                             f"{self._MAX_CLONES} materialized samples")
        self._fifo = []              # captured section blocks
        self._nb = 0                 # samples captured (post-drain)
        self._ignored = 0
        self._ch = 0

    def _cycles(self) -> list:
        # push_samples reads fifo[0:nb_samples] (:119-125) — when the
        # first-block drain overshot (start - ignored > size), the C's
        # av_audio_fifo_drain clamps so the fifo later holds MORE than
        # nb_samples; only the first nb_samples replay
        sect = (np.concatenate(self._fifo) if len(self._fifo) > 1
                else self._fifo[0])
        self._fifo = [sect]
        sect = sect[:max(self._nb, 0)]
        outs = []
        while self.loop != 0 and self._nb > 0:
            outs.append(sect)
            if self.loop > 0:
                self.loop -= 1
        return outs

    def push(self, block: np.ndarray) -> np.ndarray:
        n = len(block)
        if n == 0:
            return block
        self._ch = block.shape[1]
        outs = []
        if (self._ignored + n > self.start and self.size > 0
                and self.loop != 0):
            if self._nb < self.size:
                written = min(n, self.size - self._nb)
                buf = block[:written]
                if not self._nb:
                    drain = max(0, self.start - self._ignored)
                    buf = buf[drain:]
                    self._nb -= drain          # += written - drain below
                self._fifo.append(buf)
                self._nb += written
                outs.append(block[:written])   # truncated passthrough
                # (block[n-written:] would land in `left` and is never
                # drained under activate() — dropped, like the C)
                if self._nb == self.size:
                    outs.extend(self._cycles())
            else:                              # unreachable: cycles
                outs.extend(self._cycles())    # exhaust loop at fill
        else:
            self._ignored += n
            outs.append(block)
        outs = [o for o in outs if len(o)]
        return (np.concatenate(outs) if outs
                else block[:0])

    def flush(self) -> np.ndarray:
        # EOF before the capture filled: size = nb_samples, replay now
        if self._nb > 0 and self.loop != 0 and self._nb < self.size:
            self.size = self._nb
            outs = self._cycles()
            if outs:
                return np.concatenate(outs)
        return np.zeros((0, self._ch or 1), np.int16)


_ALOOP_ORDER = ("loop", "size", "start")


def _parse_aloop_opts(val: str) -> Dict:
    kw: Dict = {}
    positional = True
    for i, tok in enumerate(str(val).split(":")):
        tok = tok.strip()
        if "=" in tok:
            k, v = tok.split("=", 1)
            k = k.strip()
            positional = False
        elif positional and i < len(_ALOOP_ORDER):
            k, v = _ALOOP_ORDER[i], tok
        else:
            raise ValueError(f"aloop: bad option {tok!r}")
        if k not in _ALOOP_ORDER:
            raise ValueError(f"aloop: unknown option {k!r}")
        kw[k] = int(v)
    return kw


def _parse_delay_token(arg: str, rate: int) -> int:
    """parse_delays (af_adelay.c:157-181): 'NS' = N samples; 'Ns' =
    seconds; bare number = milliseconds.  The non-sample forms compute
    delay * rate / div in FLOAT (C float) then truncate to int64."""
    arg = arg.strip()
    m = None
    if arg and arg[-1] == "S":
        try:
            m = int(arg[:-1])
        except ValueError:
            m = None
    if m is not None:
        res = m
    else:
        div = np.float32(1.0 if arg.endswith("s") else 1000.0)
        body = arg[:-1] if arg.endswith("s") else arg
        try:
            delay = np.float32(body)
        except ValueError:
            raise ValueError(f"adelay: invalid delay {arg!r}")
        res = int(np.float32(np.float32(delay * np.float32(rate))
                             / div))
    if res < 0:
        raise ValueError("adelay: delay must be non negative")
    return res


def _parse_adelay_opts(val: str) -> Dict:
    kw: Dict = {}
    for i, tok in enumerate(str(val).split(":")):
        if "=" in tok:
            k, v = tok.split("=", 1)
            k = k.strip()
            if k not in ("delays", "all"):
                raise ValueError(f"adelay: unknown option {k!r}")
            kw[k] = v
        elif i == 0:
            kw["delays"] = tok
        else:
            raise ValueError(f"adelay: bad option {tok!r}")
    return kw


class AdelayStream:
    """af_adelay.c analog (s16 lane): per-channel sample delays.

    Exact semantics kept: the common minimum delay becomes LEADING
    silence emitted before any input (s->padding, :221-234 + activate
    :364-381); per-channel residual delays run as sample rings seeded
    with silence (DELAY :66-93); `all=1` copies the last parsed delay
    to the remaining channels (:209-212); EOF drains max_delay samples
    of silence through the rings (:396-410)."""

    def __init__(self, rate: int, delays="", all=0):
        self.rate = int(rate)
        self.all = int(all)
        self.tokens = [t for t in str(delays).split("|") if t != ""]
        self.passthrough = not self.tokens
        self._parsed = [_parse_delay_token(t, self.rate)
                        for t in self.tokens]
        self._bufs = None
        self._padding = 0
        self.max_delay = 0

    def _setup(self, ch: int):
        d = list(self._parsed[:ch]) + [0] * max(0, ch - len(self._parsed))
        npar = min(len(self._parsed), ch)
        if self.all and npar:
            for j in range(npar, ch):
                d[j] = d[npar - 1]
        self._padding = min(d)
        d = [x - self._padding for x in d]
        self.max_delay = max(d) if d else 0
        self._bufs = [np.zeros(di, np.int16) for di in d]

    def push(self, block: np.ndarray) -> np.ndarray:
        if self.passthrough or block.size == 0:
            return block
        n, ch = block.shape
        if self._bufs is None:
            self._setup(ch)
        outs = []
        if self._padding:
            outs.append(np.zeros((self._padding, ch), np.int16))
            self._padding = 0
        cols = []
        for i in range(ch):
            b = np.concatenate([self._bufs[i], block[:, i]])
            cols.append(b[:n])
            self._bufs[i] = b[n:]
        outs.append(np.stack(cols, 1))
        return np.concatenate(outs) if len(outs) > 1 else outs[0]

    def flush(self) -> np.ndarray:
        if self.passthrough or self._bufs is None or not self.max_delay:
            return np.zeros((0, len(self._bufs or [0])), np.int16)
        cols = []
        for b in self._bufs:
            pad = self.max_delay - len(b)
            cols.append(np.concatenate([b, np.zeros(pad, np.int16)])
                        if pad > 0 else b[:self.max_delay])
        self._bufs = [b[:0] for b in self._bufs]
        self.max_delay = 0
        return np.stack(cols, 1)


def _rescale_near(a: int, b: int, c: int) -> int:
    if a >= 0:
        return (a * b + c // 2) // c
    return -((-a * b + c // 2) // c)


def _parse_apad_opts(val: str) -> Dict:
    order = ("packet_size", "pad_len", "whole_len", "pad_dur",
             "whole_dur")
    kw: Dict = {}
    named = False
    for i, tok in enumerate(str(val).split(":")):
        if "=" in tok:
            k, v = tok.split("=", 1)
            k = k.strip()
            named = True
        elif not named and i < len(order):
            k, v = order[i], tok
        else:
            raise ValueError(f"apad: bad option {tok!r}")
        if k not in order:
            raise ValueError(f"apad: unknown option {k!r}")
        kw[k] = v
    return kw


class ApadStream:
    """af_apad.c analog: append silence at EOF — pad_len samples (or
    pad_dur seconds), or up to a whole_len/whole_dur stream target
    (config_output :config, request_frame :request).  Both unset means
    INFINITE padding in the C (for shortest-stream muxing) — rejected
    in the offline pipeline."""

    def __init__(self, rate: int, packet_size=4096, pad_len=-1,
                 whole_len=-1, pad_dur=-1, whole_dur=-1):
        self.rate = int(rate)
        self.packet_size = int(packet_size)
        self.pad_len = int(pad_len)
        self.whole_len = int(whole_len)

        def dur_us(v):
            s = str(v).strip()
            if s.endswith("ms"):
                return int(round(float(s[:-2]) * 1e3))
            if s.endswith("s"):
                return int(round(float(s[:-1]) * 1e6))
            return int(round(float(s) * 1e6))

        if str(pad_dur) not in ("-1",):
            if dur_us(pad_dur) >= 0:
                self.pad_len = _rescale_near(dur_us(pad_dur),
                                             self.rate, 1000000)
        if str(whole_dur) not in ("-1",):
            if dur_us(whole_dur) >= 0:
                self.whole_len = _rescale_near(dur_us(whole_dur),
                                               self.rate, 1000000)
        if self.pad_len < 0 and self.whole_len < 0:
            raise ValueError("apad: infinite padding (no pad_len/"
                             "whole_len) is not supported offline")
        self.pad_len_left = self.pad_len
        self.whole_len_left = self.whole_len
        self._ch = 1

    def push(self, block: np.ndarray) -> np.ndarray:
        if block.size:
            self._ch = block.shape[1]
            if self.whole_len >= 0:
                self.whole_len_left = max(
                    self.whole_len_left - len(block), 0)
        return block

    def flush(self) -> np.ndarray:
        if self.whole_len >= 0 and self.pad_len < 0:
            self.pad_len_left = self.whole_len_left
        n = max(self.pad_len_left, 0)
        self.pad_len_left = 0
        return np.zeros((n, self._ch), np.int16)


class AreverseStream:
    """f_reverse.c `areverse`: frame order reversed AND each frame's
    samples reversed (reverse_samples_* :152-246) — the whole sample
    stream reversed end-to-end.  Buffers the stream like the C."""

    def __init__(self, rate: int):
        self._parts: List[np.ndarray] = []

    def push(self, block: np.ndarray) -> np.ndarray:
        if block.size:
            self._parts.append(block)
        return block[:0]

    def flush(self) -> np.ndarray:
        if not self._parts:
            return np.zeros((0, 0), np.int16)
        y = np.concatenate(self._parts)[::-1]
        self._parts = []
        return np.ascontiguousarray(y)


# ---- pan (af_pan.c) ---------------------------------------------------------

# AVChannel ids for the names af_pan's parse_channel_name accepts
# (libavutil/channel_layout.h enum AVChannel; %7[A-Z] = upper-case only)
_CHAN_IDS = {
    "FL": 0, "FR": 1, "FC": 2, "LFE": 3, "BL": 4, "BR": 5, "FLC": 6,
    "FRC": 7, "BC": 8, "SL": 9, "SR": 10, "TC": 11, "TFL": 12, "TFC": 13,
    "TFR": 14, "TBL": 15, "TBC": 16, "TBR": 17, "DL": 18, "DR": 19,
    "WL": 20, "WR": 21, "SDL": 22, "SDR": 23, "LFE2": 24,
}

# named layouts (av_channel_layout_from_string subset): name -> channel ids
_LAYOUTS = {
    "mono": [2], "stereo": [0, 1], "2.1": [0, 1, 3], "3.0": [0, 1, 2],
    "3.1": [0, 1, 2, 3], "quad": [0, 1, 4, 5], "4.0": [0, 1, 2, 8],
    "5.0": [0, 1, 2, 4, 5], "5.0(side)": [0, 1, 2, 9, 10],
    "5.1": [0, 1, 2, 3, 4, 5], "5.1(side)": [0, 1, 2, 3, 9, 10],
    "6.1": [0, 1, 2, 3, 8, 9, 10], "7.1": [0, 1, 2, 3, 4, 5, 9, 10],
    "downmix": [18, 19],
}

# av_channel_layout_default(count) = FIRST channel_layout_map entry with
# that count (libavutil/channel_layout.c:173-203,960-968) — what swr sees
# as the input layout when pan feeds it a bare channel count.
_DEFAULT_IDS = {
    1: [2], 2: [0, 1], 3: [0, 1, 3], 4: [0, 1, 2, 8], 5: [0, 1, 2, 4, 5],
    6: [0, 1, 2, 3, 4, 5], 7: [0, 1, 2, 3, 8, 9, 10],
    8: [0, 1, 2, 3, 4, 5, 9, 10],
}


def _lrintf(x):
    """C lrintf(double expr): the argument is converted to float32
    first (round-to-nearest), then rounded half-even to integer."""
    return np.round(np.asarray(x, np.float64).astype(np.float32))


def _parse_layout(text):
    """-> (nb_channels, channel_ids or None).  Supports layout names,
    'Nc' channel counts, 'FL+FR' combos and hex masks — the
    av_channel_layout_from_string subset pan descriptions use."""
    text = text.strip()
    if text in _LAYOUTS:
        ids = _LAYOUTS[text]
        return len(ids), list(ids)
    if text.endswith(("c", "C")) and text[:-1].isdigit():
        return int(text[:-1]), None
    if text.startswith("0x"):
        mask = int(text, 16)
        ids = [i for i in range(64) if mask >> i & 1]
        if ids:
            return len(ids), ids
    if "+" in text or text in _CHAN_IDS:
        ids = []
        for part in text.split("+"):
            if part not in _CHAN_IDS:
                raise ValueError(f"pan: unknown channel {part!r}")
            ids.append(_CHAN_IDS[part])
        return len(ids), ids
    raise ValueError(f"pan: cannot parse channel layout {text!r}")


class PanFilter:
    """af_pan.c rebuild: out-channel gain rows over input channels, with
    the '<' renormalization flag, named (FL/FR/...) or numbered (cN)
    channels, and the pure-gain channel-map fast path.

    Mixing math is libswresample's s16 integer rematrix (the C
    delegates to swr_set_matrix, af_pan.c:337), reproduced from
    rematrix.c/rematrix_template.c and verified bit-exact against the
    real libswresample.so.4 in tests/test_audio_mix.py:

    - ``native_matrix``: per-row error-diffused Q15 quantization
      ``c = lrintf(m*32768 + rem); rem += target - c``
      (rematrix.c:487-497) — drives the 1- and 2-input rows and the
      mix6to2/mix8to2 whole-matrix specials;
    - clip variants (``av_clip_int16``) engage only when some row's
      ``sum |c|`` exceeds 32768 (rematrix.c:500-508);
    - 5.1/5.1(back)->stereo and 7.1->stereo matrices with shared
      FC/LFE coefficients use mix6to2/mix8to2
      (rematrix_template.c:71-116), where BOTH outputs reuse row 0's
      FC/LFE products (the template's ``t``);
    - rows with >=3 inputs otherwise hit the generic fallback
      (rematrix.c:650-656): plain ``matrix32 = lrintf(m*32768)``
      (no diffusion), int32 accumulate, ``(v+16384)>>15``, UNCLIPPED
      low-bits int16 store;
    - a 1-input row whose double gain is exactly 1.0 is copied
      verbatim (swri_rematrix case 1);
    - pure 0/1 matrices skip swr mixing entirely for the channel-map
      path (af_pan.c query_formats are_gains_pure, decided on the
      PARSED table before renumber/renorm)."""

    def __init__(self, rate: int, args: str):
        args = str(args)
        parts = args.split("|")
        if not parts or not parts[0].strip():
            raise ValueError("pan: channel layout not specified")
        self.nb_out, self.out_ids = _parse_layout(parts[0])
        if self.nb_out < 1 or self.nb_out > 64:
            raise ValueError("pan: bad output channel count")
        self.rows = []           # (out_idx, renorm, [(gain, named, ch)])
        used_out = set()
        self._named_in = 0
        self._unnamed_in = 0
        for seg in parts[1:]:
            out_idx, named, rest = self._channel_ref(seg)
            if named:
                if self.out_ids is None or out_idx not in self.out_ids:
                    raise ValueError(
                        f"pan: channel does not exist in the chosen "
                        f"layout: {seg!r}")
                out_idx = self.out_ids.index(out_idx)
            if not 0 <= out_idx < self.nb_out:
                raise ValueError(f"pan: invalid out channel in {seg!r}")
            if out_idx in used_out:
                raise ValueError(
                    f"pan: can not reference out channel {out_idx} twice")
            used_out.add(out_idx)
            rest = rest.lstrip()
            if rest.startswith("="):
                renorm = False
            elif rest.startswith("<"):
                renorm = True
            else:
                raise ValueError(
                    f"pan: syntax error after channel name in {seg!r}")
            terms = self._parse_terms(rest[1:])
            self.rows.append((out_idx, renorm, terms))
        if self._named_in and self._unnamed_in:
            raise ValueError("pan: can not mix named and numbered channels")
        self._need_renumber = bool(self._named_in)
        # are_gains_pure (af_pan.c:214-234): decided on the parsed gain
        # table (duplicate in-channel terms overwrite, like the C's
        # gain[out][in] assignment), BEFORE renumbering or renorm.
        self._pure = True
        for _out, _ren, terms in self.rows:
            row = {}
            for gain, _named, ch in terms:
                row[ch] = gain
            gains = [g for g in row.values() if g != 0.0]
            if any(g != 1.0 for g in gains) or len(gains) > 1:
                self._pure = False
                break

    def _channel_ref(self, text):
        """Leading channel name ('FL', 'c2') -> (id, named, rest)."""
        t = text.lstrip()
        i = 0
        while i < len(t) and "A" <= t[i] <= "Z":
            i += 1
        if 0 < i <= 7 and t[:i] in _CHAN_IDS:
            return _CHAN_IDS[t[:i]], True, t[i:]
        if t[:1] == "c":
            j = 1
            while j < len(t) and t[j].isdigit():
                j += 1
            if j > 1:
                ch = int(t[1:j])
                if 0 <= ch < 64:
                    return ch, False, t[j:]
        raise ValueError(f"pan: expected channel name, got {text!r}")

    def _parse_terms(self, text):
        """'0.5*c0+0.5*FL-0.2*c1' -> [(signed_gain, named, ch_id)]."""
        import re as _re
        terms = []
        rest = text
        sign = 1.0
        while True:
            rest = rest.lstrip()
            m = _re.match(r"[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?", rest)
            gain = 1.0
            if m and m.group(0) not in ("+", "-"):
                gain = float(m.group(0))
                rest = rest[m.end():].lstrip()
                if rest.startswith("*"):
                    rest = rest[1:]
            ch, named, rest = self._channel_ref(rest)
            if named:
                self._named_in += 1
            else:
                self._unnamed_in += 1
            terms.append((sign * gain, named, ch))
            rest = rest.lstrip()
            if not rest:
                return terms
            if rest.startswith("-"):
                sign = -1.0
            elif rest.startswith("+"):
                sign = 1.0
            else:
                raise ValueError(f"pan: syntax error near {rest!r}")
            rest = rest[1:]

    def _matrix(self, nb_in: int, in_ids=None) -> np.ndarray:
        """Dense (nb_out, nb_in) double matrix after the config_props
        renumber (named in-channels -> input indices) and '<' renorm."""
        m = np.zeros((self.nb_out, nb_in), np.float64)
        for out_idx, renorm, terms in self.rows:
            for gain, named, ch in terms:
                if named:
                    ids = in_ids if in_ids is not None \
                        else list(range(nb_in))
                    if ch not in ids:
                        continue      # silently dropped like the C renumber
                    # config_props renumber walks raw ids ASCENDING
                    # (af_pan.c:272-280): position among present ids
                    ch = sorted(ids).index(ch)
                if ch >= nb_in:
                    continue
                m[out_idx, ch] = gain
            if renorm:
                t = np.abs(m[out_idx]).sum()
                if not (-1e-5 < t < 1e-5):
                    m[out_idx] /= t
        return m

    def _mix_to2(self, m, in_ids):
        """get_mix_any_func specials (rematrix_template.c:92-116):
        5.1/5.1(back)->stereo -> mix6to2, 7.1->stereo -> mix8to2.
        Returns (row0 extra taps, row1 extra taps) or None; FC/LFE
        (inputs 2,3) are shared between both outputs via ROW 0's
        coefficients (the template's ``t``)."""
        if self.out_ids != [0, 1]:
            return None
        if (in_ids in ([0, 1, 2, 3, 4, 5], [0, 1, 2, 3, 9, 10])
                and m[0][2] == m[1][2] and m[0][3] == m[1][3]
                and not m[0][1] and not m[0][5]
                and not m[1][0] and not m[1][4]):
            return [0, 4], [1, 5]
        if (in_ids == [0, 1, 2, 3, 4, 5, 9, 10]
                and m[0][2] == m[1][2] and m[0][3] == m[1][3]
                and not m[0][1] and not m[0][5]
                and not m[1][0] and not m[1][4]
                and not m[0][7] and not m[1][6]):
            return [0, 4, 6], [1, 5, 7]
        return None

    def process(self, block: np.ndarray, in_ids=None) -> np.ndarray:
        n, nb_in = block.shape
        if in_ids is None:
            in_ids = _DEFAULT_IDS.get(nb_in)
        m = self._matrix(nb_in, in_ids)
        if self._pure:
            # swr channel mapping: verbatim copies, silence when empty
            out = np.zeros((n, self.nb_out), np.int16)
            for i in range(self.nb_out):
                nz = np.nonzero(m[i])[0]
                if nz.size:
                    out[:, i] = block[:, nz[0]]
            return out
        # native_matrix: per-row error-diffused Q15 (rematrix.c:487-497);
        # note the C's rem update genuinely double-accumulates
        # (rem += target - c where target already includes rem)
        native = np.zeros_like(m)
        for i in range(self.nb_out):
            rem = 0.0
            for j in range(nb_in):
                target = m[i, j] * 32768.0 + rem
                c = float(_lrintf(target))
                native[i, j] = c
                rem += target - c
        nat32 = native.astype(np.int64).astype(np.int32)  # C int store
        clip = int(np.abs(native).sum(axis=1).max(initial=0)) > 32768
        x32 = block.astype(np.int32)

        def R(v):
            # TEMPLATE_REMATRIX_S16: (x+16384)>>15, av_clip_int16 only
            # in the clip variant, int16 low-bits store otherwise
            v = (v + np.int32(16384)) >> np.int32(15)
            if clip:
                v = np.clip(v, -32768, 32767)
            return v.astype(np.int16)

        with np.errstate(over="ignore"):
            special = self._mix_to2(m, in_ids)
            if special is not None:
                t = (x32[:, 2] * nat32[0, 2]
                     + x32[:, 3] * nat32[0, 3]).astype(np.int32)
                cols = []
                for r, taps in enumerate(special):
                    v = t.copy()
                    for j in taps:
                        v += x32[:, j] * nat32[r, j]
                    cols.append(R(v))
                return np.stack(cols, axis=1)
            out = np.zeros((n, self.nb_out), np.int16)
            # >=3-input fallback rows: PLAIN lrintf(m*32768) (matrix32,
            # rematrix.c:561 — no diffusion), always unclipped
            m32 = _lrintf(m * 32768.0).astype(np.int64).astype(np.int32)
            for i in range(self.nb_out):
                nz = np.nonzero(m[i])[0]
                if nz.size == 0:
                    continue
                if nz.size == 1:
                    j = nz[0]
                    if m[i, j] == 1.0:            # swri_rematrix case 1
                        out[:, i] = block[:, j]   # verbatim copy
                    else:
                        out[:, i] = R(x32[:, j] * nat32[i, j])
                elif nz.size == 2:
                    j1, j2 = nz
                    out[:, i] = R(x32[:, j1] * nat32[i, j1]
                                  + x32[:, j2] * nat32[i, j2])
                else:
                    v = np.zeros(n, np.int32)
                    for j in nz:
                        v += x32[:, j] * m32[i, j]
                    out[:, i] = ((v + np.int32(16384))
                                 >> np.int32(15)).astype(np.int16)
        return out
