"""dynaudnorm — Dynamic Audio Normalizer.

Rebuild of the reference's `libavfilter/af_dynaudnorm.c` (951 LoC),
reachable through metrans `<AudioFilterDesc>` / CLI `-af` like the
reference's libavfilter delegation (AvToolkit/AvFilt.h:20-99).

Semantics reproduced from the C:
- 500 ms (option) frames at the chain sample rate, optional overlap
  (sample_advance = lrint(frame_len*(1-overlap))), DBLP math.
- Per-frame local gain: peak/RMS gain erf-bounded by maxgain
  (af_dynaudnorm.c:359-437), channel-coupled or per-channel.
- Three chained gain histories per channel (original -> minimum ->
  gaussian-smoothed with threshold weighting, :439-522) including the
  alt_boundary_mode pre-fill rules; output frames are delayed by
  filter_size frames and amplified with a per-sample linear fade from
  the previous frame's gain (:726-747).
- DC correction (:537-558) and the compress stage with its
  setup_compress_thresh fixed-point iteration (:560-656).
- EOF flush: synthetic boundary frames keep the history pipeline fed
  until every queued frame is emitted; frames still queued once the
  smoothed history runs dry are emitted unfiltered (:799-840).

Known divergence (documented): in overlap=0 mode the C copies
frame_len samples into its scratch window even for the shorter final
frame (reading past the frame's buffer; the copy is dead data there) —
we skip the dead copy.

Tests: tests/test_dynaudnorm.py drives this against a literal
per-frame/per-sample transcription of the C
(tests/oracle_dynaudnorm.py).

A copy of `gmat_tpu/av/dynaudnorm.py` for the PyTorch port: host numpy
on interleaved PCM, no device work.
"""
from __future__ import annotations

import math
from collections import deque
from typing import Dict, Optional

import numpy as np

try:
    from scipy.special import erf as _erf
except ImportError:                                    # pragma: no cover
    _erf = np.vectorize(math.erf)

_DBL_EPSILON = np.finfo(np.float64).eps
_DBL_MAX = np.finfo(np.float64).max
_BOUND_CONST = 0.8862269254527580136490837416705725913987747280611935


def frame_size(rate: int, msec: int) -> int:
    n = int(np.rint(rate * (msec / 1000.0)))
    return n + (n % 2)


_ALIASES = {"f": "framelen", "g": "gausssize", "p": "peak", "m": "maxgain",
            "r": "targetrms", "n": "coupling", "c": "correctdc",
            "b": "altboundary", "s": "compress", "t": "threshold",
            "h": "channels", "o": "overlap"}
_RANGES = {"framelen": (10, 8000), "gausssize": (3, 301),
           "peak": (0.0, 1.0), "maxgain": (1.0, 100.0),
           "targetrms": (0.0, 1.0), "compress": (0.0, 30.0),
           "threshold": (0.0, 1.0), "overlap": (0.0, 1.0)}
_BOOLS = ("coupling", "correctdc", "altboundary")


def parse_dynaudnorm_opts(val: str) -> Dict:
    kw: Dict = {}
    for tok in str(val).split(":"):
        tok = tok.strip()
        if not tok:
            continue
        if "=" not in tok:
            raise ValueError(f"dynaudnorm: bad option {tok!r}")
        k, v = tok.split("=", 1)
        k = _ALIASES.get(k.strip(), k.strip())
        if k in ("framelen", "gausssize"):
            kw[k] = int(v)
        elif k in _RANGES:
            kw[k] = float(v)
        elif k in _BOOLS:
            v = v.strip().lower()
            if v in ("1", "true", "on", "yes"):
                kw[k] = True
            elif v in ("0", "false", "off", "no"):
                kw[k] = False
            else:
                raise ValueError(f"dynaudnorm: bad boolean {tok!r}")
        elif k == "channels":
            kw[k] = v.strip()
        else:
            raise ValueError(f"dynaudnorm: unknown option {k!r}")
        if k in _RANGES and not _RANGES[k][0] <= kw[k] <= _RANGES[k][1]:
            raise ValueError(f"dynaudnorm: {k}={v} out of range "
                             f"{_RANGES[k]}")
    return kw


def _bound(threshold: float, val: float) -> float:
    """Scalar bound() via libm erf (math.erf) — the iterative
    setup_compress_thresh walk amplifies last-ulp differences between
    erf implementations, so the scalar paths must match the C's libm;
    scipy's erf (used only in the vectorized per-sample compress) can
    differ by 1 ulp."""
    return math.erf(_BOUND_CONST * (val / threshold)) * threshold


def _fade_vec(prev: float, nxt: float, n: int) -> np.ndarray:
    """Per-sample fade(prev, next, i, n) (af_dynaudnorm.c:359-365)."""
    step = 1.0 / n
    f0 = 1.0 - step * (np.arange(n) + 1.0)
    return f0 * prev + (1.0 - f0) * nxt


_TWO63 = float(1 << 63)
_INT64_MIN = -(1 << 63)


def _llrint63(x: float) -> int:
    """llrint(x * 2^63) with x86-64 overflow semantics: values at or
    past 2^63 come back as INT64_MIN (cvttsd2si-style saturation) —
    load-bearing for setup_compress_thresh, where it is the ONLY thing
    stopping the walk below 1.0 for thresholds above ~0.79 (verified
    against the compiled reference function)."""
    v = float(np.rint(x * _TWO63))
    if v >= _TWO63 or v < -_TWO63:
        return _INT64_MIN
    return int(v)


def setup_compress_thresh(threshold: float) -> float:
    """af_dynaudnorm.c:560-580 — walks the largest t with
    bound(t, 1.0) <= threshold via halving steps; the llrint-at-2^63
    guard both stops no-op steps AND (via overflow saturation) caps the
    walk just below 1.0."""
    if not (threshold > _DBL_EPSILON and threshold < 1.0 - _DBL_EPSILON):
        return threshold
    current = threshold
    step = 1.0
    while step > _DBL_EPSILON:
        while (_llrint63(current + step) > _llrint63(current)
               and float(_bound(current + step, 1.0)) <= threshold):
            current += step
        step /= 2.0
    return current


class DynaudnormStream:
    """Streaming dynaudnorm over interleaved s16 blocks at `rate`."""

    def __init__(self, rate: int, framelen: int = 500, gausssize: int = 31,
                 peak: float = 0.95, maxgain: float = 10.0,
                 targetrms: float = 0.0, coupling: bool = True,
                 correctdc: bool = False, altboundary: bool = False,
                 compress: float = 0.0, threshold: float = 0.0,
                 channels: str = "all", overlap: float = 0.0):
        for k, v in (("framelen", framelen), ("gausssize", gausssize),
                     ("peak", peak), ("maxgain", maxgain),
                     ("targetrms", targetrms), ("compress", compress),
                     ("threshold", threshold), ("overlap", overlap)):
            lo, hi = _RANGES[k]
            if not lo <= v <= hi:
                raise ValueError(
                    f"dynaudnorm: {k}={v} out of range [{lo}, {hi}]")
        self.rate = int(rate)
        self.filter_size = int(gausssize) | 1      # init(): forced odd
        self.frame_len_msec = int(framelen)
        self.peak_value = float(peak)
        self.max_amplification = float(maxgain)
        self.target_rms = float(targetrms)
        self.channels_coupled = bool(coupling)
        self.dc_correction = bool(correctdc)
        self.alt_boundary_mode = bool(altboundary)
        self.compress_factor = float(compress)
        self.threshold = float(threshold)
        self.channels_to_filter = str(channels)
        self.overlap = float(overlap)
        self.frame_len = frame_size(self.rate, self.frame_len_msec)
        self.sample_advance = max(
            1, int(np.rint(self.frame_len * (1.0 - self.overlap))))
        # gaussian weights (af_dynaudnorm.c:247-271)
        sigma = ((self.filter_size / 2.0 - 1.0) / 3.0) + 1.0 / 3.0
        x = np.arange(self.filter_size) - self.filter_size // 2
        w = (1.0 / (sigma * np.sqrt(2.0 * np.pi))) \
            * np.exp(-(x * x) / (2.0 * sigma * sigma))
        self.weights = w / w.sum()
        self._ch = 0
        self._configured = False
        self._eof = False

    def _configure(self, ch: int):
        self._ch = ch
        self.prev_amp = [1.0] * ch
        self.dc_correction_value = [0.0] * ch
        self.compress_threshold = [0.0] * ch
        self.gain_history_original = [deque() for _ in range(ch)]
        self.gain_history_minimum = [deque() for _ in range(ch)]
        self.gain_history_smoothed = [deque() for _ in range(ch)]
        self.threshold_history = [deque() for _ in range(ch)]
        # the C allocates the analysis window at frame_len*2 samples
        # (config_input: ff_get_audio_buffer(outlink, s->frame_len * 2))
        # and analyzes the WHOLE zero-padded frame in overlap mode, so
        # RMS/stddev denominators see 2*frame_len — load-bearing for
        # targetrms/compress with overlap>0
        self.window = np.zeros((self.frame_len * 2, ch))
        self.queue: deque = deque()
        self._pending = np.zeros((0, ch))
        self._bypass = self._parse_bypass(ch)
        self._configured = True

    def _parse_bypass(self, ch: int):
        """channels= option -> per-channel bypass flags.  'all' filters
        everything; otherwise a layout/channel-name set and channels of
        the (default-layout) input not in it are bypassed."""
        if self.channels_to_filter == "all":
            return [False] * ch
        from .audio_filters import _DEFAULT_IDS, _parse_layout
        _, keep = _parse_layout(self.channels_to_filter)
        ids = _DEFAULT_IDS.get(ch, list(range(ch)))
        if keep is None:
            return [False] * ch
        return [ids[c] not in keep for c in range(ch)]

    # -- per-frame analysis ------------------------------------------------

    @staticmethod
    def _peak_mag(frame: np.ndarray, channel: int) -> float:
        if channel == -1:
            m = np.abs(frame).max(initial=0.0)
        else:
            m = np.abs(frame[:, channel]).max(initial=0.0)
        return max(float(m), _DBL_EPSILON)

    @staticmethod
    def _frame_rms(frame: np.ndarray, channel: int) -> float:
        if channel == -1:
            v = float((frame * frame).sum()) / (frame.shape[0]
                                                * frame.shape[1])
        else:
            v = float((frame[:, channel] ** 2).sum()) / frame.shape[0]
        return max(math.sqrt(v), _DBL_EPSILON)

    def _std_dev(self, frame: np.ndarray, channel: int) -> float:
        if channel == -1:
            v = float((frame * frame).sum()) \
                / (self._ch * frame.shape[0] - 1)
        else:
            v = float((frame[:, channel] ** 2).sum()) \
                / (frame.shape[0] - 1)
        return max(math.sqrt(v), _DBL_EPSILON)

    def _local_gain(self, frame: np.ndarray, channel: int):
        peak = self._peak_mag(frame, channel)
        maximum_gain = self.peak_value / peak
        rms_gain = (self.target_rms / self._frame_rms(frame, channel)
                    if self.target_rms > _DBL_EPSILON else _DBL_MAX)
        return (float(_bound(self.max_amplification,
                             min(maximum_gain, rms_gain))),
                float(peak > self.threshold))

    def _update_gain_history(self, c: int, max_gain: float, thresh: float):
        """af_dynaudnorm.c:469-522."""
        orig = self.gain_history_original[c]
        mini = self.gain_history_minimum[c]
        smoo = self.gain_history_smoothed[c]
        thr = self.threshold_history[c]
        pre = self.filter_size // 2
        if not orig:
            init = max_gain if self.alt_boundary_mode \
                else min(1.0, max_gain)
            self.prev_amp[c] = init
            while len(orig) < pre:
                orig.append(init)
                thr.append(thresh)
        orig.append(max_gain)
        while len(orig) >= self.filter_size:
            if not mini:
                init = orig[0] if self.alt_boundary_mode else 1.0
                inp = pre
                while len(mini) < pre:
                    inp += 1
                    init = min(init, orig[inp])
                    mini.append(init)
            mini.append(min(orig))
            thr.append(thresh)
            orig.popleft()
        while len(mini) >= self.filter_size:
            tq = np.fromiter(thr, float, len(thr))[:self.filter_size]
            q = np.fromiter(mini, float, len(mini))[:self.filter_size]
            tw = tq * self.weights
            tsum = float(tw.sum())
            smoothed = float((tw * q).sum())
            if tsum == 0.0:
                smoothed = 1.0
            smoothed = min(smoothed, orig[0])
            smoo.append(smoothed)
            mini.popleft()
            thr.popleft()

    def _dc_correct(self, frame: np.ndarray):
        n = len(frame)
        first = not self.gain_history_original[0]
        diff = 1.0 / n
        for c in range(self._ch):
            avg = float((frame[:, c] * diff).sum())
            prev = avg if first else self.dc_correction_value[c]
            self.dc_correction_value[c] = avg if first else \
                0.1 * avg + 0.9 * self.dc_correction_value[c]
            if not self._bypass[c]:
                frame[:, c] -= _fade_vec(prev,
                                         self.dc_correction_value[c], n)

    def _compress(self, frame: np.ndarray):
        n = len(frame)
        first = not self.gain_history_original[0]
        if self.channels_coupled:
            std = self._std_dev(frame, -1)
            cur = min(1.0, self.compress_factor * std)
            prev = cur if first else self.compress_threshold[0]
            self.compress_threshold[0] = cur if first else \
                (1.0 / 3.0) * cur + (1.0 - 1.0 / 3.0) \
                * self.compress_threshold[0]
            pa = setup_compress_thresh(prev)
            ca = setup_compress_thresh(self.compress_threshold[0])
            local = _fade_vec(pa, ca, n)
            for c in range(self._ch):
                if self._bypass[c]:
                    continue
                frame[:, c] = np.copysign(
                    _bound_vec(local, np.abs(frame[:, c])), frame[:, c])
        else:
            for c in range(self._ch):
                std = self._std_dev(frame, c)
                cur = setup_compress_thresh(
                    min(1.0, self.compress_factor * std))
                prev = cur if first else self.compress_threshold[c]
                self.compress_threshold[c] = cur if first else \
                    (1.0 / 3.0) * cur + (1.0 - 1.0 / 3.0) \
                    * self.compress_threshold[c]
                pa = setup_compress_thresh(prev)
                ca = setup_compress_thresh(self.compress_threshold[c])
                if self._bypass[c]:
                    continue
                local = _fade_vec(pa, ca, n)
                frame[:, c] = np.copysign(
                    _bound_vec(local, np.abs(frame[:, c])), frame[:, c])

    def _analyze(self, frame: np.ndarray) -> np.ndarray:
        """analyze_frame (af_dynaudnorm.c:658-724); returns the
        (possibly dc/compress-modified) frame to queue."""
        if self.dc_correction or self.compress_factor > _DBL_EPSILON:
            frame = frame.copy()
        if self.dc_correction:
            self._dc_correct(frame)
        if self.compress_factor > _DBL_EPSILON:
            self._compress(frame)
        if self.frame_len != self.sample_advance:
            off = self.frame_len - self.sample_advance
            n = len(frame)
            self.window[:off] = self.window[self.sample_advance:
                                            self.sample_advance + off]
            self.window[off:off + n] = frame
            self.window[off + n:] = 0.0
            analyze = self.window
        else:
            analyze = frame
        if self.channels_coupled:
            g, t = self._local_gain(analyze, -1)
            for c in range(self._ch):
                self._update_gain_history(c, g, t)
        else:
            for c in range(self._ch):
                g, t = self._local_gain(analyze, c)
                self._update_gain_history(c, g, t)
        return frame

    def _amplify(self, frame: np.ndarray) -> np.ndarray:
        out = frame.copy()
        n = len(frame)
        for c in range(self._ch):
            cur = self.gain_history_smoothed[c].popleft()
            if not self._bypass[c]:
                out[:, c] = frame[:, c] * _fade_vec(self.prev_amp[c],
                                                    cur, n)
            self.prev_amp[c] = cur
        return out

    def _filter_frame(self, frame: Optional[np.ndarray]):
        """filter_frame (af_dynaudnorm.c:749-797): emit ready queued
        frames, then analyze/queue the new one."""
        outs = []
        while ((len(self.queue) >= self.filter_size
                or (self._eof and self.queue))
               and self.gain_history_smoothed[0]):
            outs.append(self._amplify(self.queue.popleft()))
        if frame is not None:
            frame = self._analyze(frame)
            if not self._eof:
                self.queue.append(frame)
        return outs

    # -- stream API ---------------------------------------------------------

    def push(self, block: np.ndarray) -> np.ndarray:
        if block.size == 0:
            return np.zeros((0, 0), np.int16)
        if not self._configured:
            self._configure(block.shape[1])
        x = block.astype(np.float64) / 32768.0
        self._pending = np.concatenate([self._pending, x]) \
            if self._pending.size else x
        outs = []
        while len(self._pending) >= self.sample_advance:
            frame = self._pending[:self.sample_advance]
            self._pending = self._pending[self.sample_advance:]
            outs.extend(self._filter_frame(frame))
        return self._to_s16(outs)

    def flush(self) -> np.ndarray:
        if not self._configured or self._eof:
            return np.zeros((0, 0), np.int16)
        outs = []
        if len(self._pending):
            outs.extend(self._filter_frame(self._pending))
            self._pending = self._pending[:0]
        self._eof = True
        # flush (af_dynaudnorm.c:799-840): boundary frames while the
        # smoothed history lasts, then raw passthrough of the remainder
        while self.queue:
            if self.gain_history_smoothed[0]:
                fill = _DBL_EPSILON if self.alt_boundary_mode else (
                    min(self.peak_value, self.target_rms)
                    if self.target_rms > _DBL_EPSILON else self.peak_value)
                syn = np.full((self.sample_advance, self._ch), fill)
                if self.dc_correction:
                    syn[1::2] *= -1.0
                    syn += np.asarray(self.dc_correction_value)
                outs.extend(self._filter_frame(syn))
            else:
                outs.append(self.queue.popleft())
        return self._to_s16(outs)

    def _to_s16(self, outs) -> np.ndarray:
        if not outs:
            return np.zeros((0, self._ch or 0), np.int16)
        y = np.concatenate(outs)
        return np.clip(np.rint(y * 32768.0), -32768,
                       32767).astype(np.int16)

    # raw-double entry points for the oracle tests ---------------------------

    def process_doubles(self, x: np.ndarray) -> np.ndarray:
        """One-shot over float64 (n, ch): frame, filter, flush — used by
        the oracle comparison to avoid s16 quantization."""
        if not self._configured:
            self._configure(x.shape[1])
        outs = []
        pos = 0
        while pos + self.sample_advance <= len(x):
            outs.extend(self._filter_frame(
                x[pos:pos + self.sample_advance]))
            pos += self.sample_advance
        if pos < len(x):
            outs.extend(self._filter_frame(x[pos:]))
        self._eof = True
        while self.queue:
            if self.gain_history_smoothed[0]:
                fill = _DBL_EPSILON if self.alt_boundary_mode else (
                    min(self.peak_value, self.target_rms)
                    if self.target_rms > _DBL_EPSILON else self.peak_value)
                syn = np.full((self.sample_advance, self._ch), fill)
                if self.dc_correction:
                    syn[1::2] *= -1.0
                    syn += np.asarray(self.dc_correction_value)
                outs.extend(self._filter_frame(syn))
            else:
                outs.append(self.queue.popleft())
        return np.concatenate(outs) if outs else x[:0]


def _bound_vec(threshold: np.ndarray, val: np.ndarray) -> np.ndarray:
    return _erf(_BOUND_CONST * (val / threshold)) * threshold
