"""loudnorm — EBU R128 two-state loudness normalizer.

Rebuild of the reference's `libavfilter/af_loudnorm.c` (919 LoC, the
single most common transcode audio filter), driven through metrans XML
`<AudioFilterDesc>` / CLI `-af` exactly like the reference hands it to
libavfilter (AvToolkit/AvFilt.h:20-99).

Semantics reproduced from the C:
- The filter runs on interleaved doubles at a pinned 192 kHz
  (af_loudnorm.c:684-716 query_formats); ffmpeg's graph negotiation
  auto-inserts `aresample` around it.  LoudnormStream does the same via
  the real libswresample (av/swr.py) when the chain rate differs.
- Frame geometry: one 3000 ms FIRST frame, then 100 ms INNER frames,
  and a FINAL drain of the 3 s delay ring at EOF
  (af_loudnorm.c:409-682).
- Dynamic gain: a 30-slot `delta` ring smoothed by a 21-tap sigma-3.5
  gaussian (:133-165), measured each inner frame from the r128 input
  state (shortterm/global/LRA/relative threshold, :542-569).
- True-peak limiter: 10 ms-lookahead attack/sustain/release state
  machine over a 210 ms ring (:167-407), including the quirks — the
  SUSTAIN-state peak scan that passes the full frame length rather
  than the remainder (:322), `attack_length` permanently becoming
  1920 after the first completed attack (:316), and the stale
  `prev_smp` kept by failed peak candidates (:205-206 `continue`
  skipping the :221 update).
- LINEAR mode when all four measured_* options are provided and fit
  (:772-791), and the sub-3 s-input linear fallback (:445-460).

Implementation is segment-vectorized numpy (peak detection as array
predicates + a sparse candidate walk; gain ramps as slice multiplies)
— structurally unlike the C's per-sample loops; tests/test_loudnorm.py
checks it against an independent per-sample transcription of the C.

A copy of `gmat_tpu/av/loudnorm.py` for the PyTorch port: host numpy
on interleaved PCM, no device work.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .ebur128 import DUAL_MONO, EburR128

# limiter states
OUT, ATTACK, SUSTAIN, RELEASE = range(4)
# frame machine
FIRST, INNER, FINAL, LINEAR = range(4)

_RATE = 192000


def frame_size(rate: int, msec: int) -> int:
    """af_loudnorm.c:127-131 (rounded, forced even)."""
    n = int(round(rate * (msec / 1000.0)))
    return n + (n % 2)


def _gaussian_weights() -> np.ndarray:
    sigma = 3.5
    x = np.arange(21) - 10
    w = (1.0 / (sigma * np.sqrt(2.0 * np.pi))) * np.exp(-(x ** 2.0)
                                                        / (2.0 * sigma ** 2))
    return w / w.sum()


_OPT_ALIASES = {
    "i": "I", "lra": "LRA", "tp": "TP",
    "measured_i": "measured_I", "measured_lra": "measured_LRA",
    "measured_tp": "measured_TP",
}
_OPT_RANGES = {
    "I": (-70.0, -5.0), "LRA": (1.0, 50.0), "TP": (-9.0, 0.0),
    "measured_I": (-99.0, 0.0), "measured_LRA": (0.0, 99.0),
    "measured_TP": (-99.0, 99.0), "measured_thresh": (-99.0, 0.0),
    "offset": (-99.0, 99.0),
}


def parse_loudnorm_opts(val: str) -> Dict:
    """'I=-16:TP=-1.5:LRA=11:linear=true' -> kwargs (AVOption table,
    af_loudnorm.c:101-123)."""
    kw: Dict = {}
    for tok in str(val).split(":"):
        tok = tok.strip()
        if not tok:
            continue
        if "=" not in tok:
            raise ValueError(f"loudnorm: bad option {tok!r}")
        k, v = tok.split("=", 1)
        k = k.strip()
        k = _OPT_ALIASES.get(k, k)
        if k in _OPT_RANGES:
            f = float(v)
            lo, hi = _OPT_RANGES[k]
            if not lo <= f <= hi:
                raise ValueError(
                    f"loudnorm: {k}={f} out of range [{lo}, {hi}]")
            kw[k] = f
        elif k in ("linear", "dual_mono"):
            v = v.strip().lower()
            if v in ("1", "true", "on", "yes"):
                kw[k] = True
            elif v in ("0", "false", "off", "no"):
                kw[k] = False
            else:
                raise ValueError(f"loudnorm: bad boolean {tok!r}")
        elif k == "print_format":
            v = v.strip().lower()
            if v not in ("none", "json", "summary"):
                raise ValueError(f"loudnorm: bad print_format {v!r}")
            kw[k] = v
        else:
            raise ValueError(f"loudnorm: unknown option {k!r}")
    return kw


class _Limiter:
    """True-peak limiter over the 210 ms ring (af_loudnorm.c:167-407).

    `buf` is the ring as a (frames, channels) float64 array (the C's
    flat buffer is always channel-aligned); `index`/`env_index` count
    frames."""

    def __init__(self, size_frames: int, channels: int, ceiling: float,
                 attack_length: int, release_length: int):
        self.buf = np.zeros((size_frames, channels))
        self.size = size_frames
        self.ch = channels
        self.ceiling = ceiling
        self.index = 0              # limiter_buf_index (frames)
        self.state = OUT
        self.gain_reduction = [0.0, 0.0]
        self.env_index = 0
        self.env_cnt = 0
        self.peak_index = 0
        self.attack_length = attack_length
        self.release_length = release_length

    # -- peak scan ------------------------------------------------------

    def _detect_peak(self, offset: int, nb_samples: int):
        """(peak_delta, peak_value) or (-1, 0) — af_loudnorm.c:167-228.

        Vectorized: candidate predicate arrays plus a sparse walk that
        reproduces the C's stale-prev_smp quirk (a failed candidate
        `continue`s past the prev_smp refresh, so the NEXT sample in
        that channel still compares against the older value)."""
        if nb_samples <= 0:
            return -1, 0.0
        base = (self.index + offset + 1920) % self.size
        rows = (base + np.arange(nb_samples + 12)) % self.size
        absv = np.abs(self.buf[rows])                 # (nb+12, ch)
        this = absv[:nb_samples]
        nxt = absv[1:nb_samples + 1]
        over = this > self.ceiling
        if not over[1:].any():
            return -1, 0.0
        cand_rows = 1 + np.nonzero(over[1:].any(axis=1))[0]
        frozen: Dict[int, float] = {}      # ch -> stale prev value
        frozen_n: Dict[int, int] = {}      # ch -> n it was frozen at
        for n in cand_rows:
            for c in range(self.ch):
                t = this[n, c]
                if not over[n, c]:
                    continue
                if nxt[n, c] > t:
                    continue
                prev = this[n - 1, c]
                if frozen_n.get(c, -2) == n - 1:
                    prev = frozen[c]
                if prev > t:
                    continue
                # 12-sample forward confirmation (:197-203)
                if (absv[n + 2:n + 12, c] > t).any():
                    # failed candidate: prev_smp NOT refreshed (:205)
                    frozen[c] = prev
                    frozen_n[c] = n
                    continue
                peak_value = float(this[n].max())
                self.peak_index = int(rows[n])
                return int(n), peak_value
        return -1, 0.0

    # -- segment helpers --------------------------------------------------

    def _mul_rows(self, start: int, env: np.ndarray):
        """buf[start:start+len(env)] *= env (ring-wrapped rows)."""
        k = len(env)
        if k <= 0:
            return
        r = (start + np.arange(k)) % self.size
        self.buf[r] *= env[:, None]

    # -- the state machine -------------------------------------------------

    def run(self, nb_samples: int, first_frame: bool) -> np.ndarray:
        """Process/emit `nb_samples` frames from the ring
        (af_loudnorm.c:230-407); returns the (nb, ch) output block."""
        ceiling = self.ceiling
        if first_frame:
            seg = self.buf[:1920]
            mx = float(np.abs(seg).max()) if seg.size else 0.0
            if mx > ceiling:
                self.gain_reduction[1] = ceiling / mx
                self.state = SUSTAIN
                self.buf[:1920] *= self.gain_reduction[1]

        smp_cnt = 0
        while smp_cnt < nb_samples:
            if self.state == OUT:
                peak_delta, peak_value = self._detect_peak(
                    smp_cnt, nb_samples - smp_cnt)
                if peak_delta != -1:
                    self.env_cnt = 0
                    smp_cnt += peak_delta - self.attack_length
                    self.gain_reduction[0] = 1.0
                    self.gain_reduction[1] = ceiling / peak_value
                    self.state = ATTACK
                    ei = self.peak_index - self.attack_length
                    if ei < 0:
                        ei += self.size
                    # (the C adds env_cnt*channels here, always 0, and
                    # wraps with `>` not `>=` — :286-288)
                    if ei > self.size:
                        ei -= self.size
                    self.env_index = ei
                else:
                    smp_cnt = nb_samples

            elif self.state == ATTACK:
                k = min(self.attack_length - self.env_cnt,
                        nb_samples - smp_cnt)
                e = self.env_cnt + np.arange(k)
                g0, g1 = self.gain_reduction
                env = g0 - (e / (self.attack_length - 1)) * (g0 - g1)
                self._mul_rows(self.env_index, env)
                self.env_index = (self.env_index + k) % self.size
                self.env_cnt += k
                smp_cnt += k
                if smp_cnt < nb_samples:      # attack completed mid-frame
                    self.env_cnt = 0
                    self.attack_length = 1920
                    self.state = SUSTAIN

            elif self.state == SUSTAIN:
                # NOTE: the C passes nb_samples, not the remainder (:322)
                peak_delta, peak_value = self._detect_peak(
                    smp_cnt, nb_samples)
                if peak_delta == -1:
                    self.state = RELEASE
                    self.gain_reduction[0] = self.gain_reduction[1]
                    self.gain_reduction[1] = 1.0
                    self.env_cnt = 0
                else:
                    gr = ceiling / peak_value
                    if gr < self.gain_reduction[1]:
                        self.state = ATTACK
                        self.attack_length = max(peak_delta, 2)
                        self.gain_reduction[0] = self.gain_reduction[1]
                        self.gain_reduction[1] = gr
                        self.env_cnt = 0
                    else:
                        k = min(peak_delta, nb_samples - smp_cnt)
                        env = np.full(k, self.gain_reduction[1])
                        self._mul_rows(self.env_index, env)
                        self.env_index = (self.env_index + k) % self.size
                        self.env_cnt = k
                        smp_cnt += k

            elif self.state == RELEASE:
                k = min(self.release_length - self.env_cnt,
                        nb_samples - smp_cnt)
                e = self.env_cnt + np.arange(k)
                g0, g1 = self.gain_reduction
                env = g0 + (e / (self.release_length - 1)) * (g1 - g0)
                self._mul_rows(self.env_index, env)
                self.env_index = (self.env_index + k) % self.size
                self.env_cnt += k
                smp_cnt += k
                if smp_cnt < nb_samples:      # release completed mid-frame
                    self.env_cnt = 0
                    self.state = OUT

        rows = (self.index + np.arange(nb_samples)) % self.size
        out = self.buf[rows].copy()
        over = np.abs(out) > ceiling
        out[over] = ceiling * np.sign(out[over])
        return out

    def write_adv(self, data: np.ndarray):
        """Write `data` rows at the ring cursor and advance it — the
        filter_frame fill loops; true_peak_limiter itself never moves
        limiter_buf_index, so run() reads output at the cursor as-is."""
        k = len(data)
        if k:
            r = (self.index + np.arange(k)) % self.size
            self.buf[r] = data
            self.index = (self.index + k) % self.size


class LoudnormStream:
    """Streaming loudnorm over interleaved s16 blocks at `rate`.

    Dynamic mode internally converts/resamples to 192 kHz doubles via
    libswresample (what ffmpeg's negotiation does) and back; linear
    mode stays at the chain rate (query_formats only pins 192 kHz for
    the dynamic path, af_loudnorm.c:703-713)."""

    def __init__(self, rate: int, I=-24.0, LRA=7.0, TP=-2.0,
                 measured_I=0.0, measured_LRA=0.0, measured_TP=99.0,
                 measured_thresh=-70.0, offset=0.0, linear=True,
                 dual_mono=False, print_format="none",
                 internal_rate: int = 0):
        """`internal_rate` (tests only) overrides the 192 kHz pin so the
        per-sample oracle stays affordable; the C's literal 1920-sample
        lookahead/attack constants are kept literal either way."""
        for k, v in (("I", I), ("LRA", LRA), ("TP", TP),
                     ("measured_I", measured_I),
                     ("measured_LRA", measured_LRA),
                     ("measured_TP", measured_TP),
                     ("measured_thresh", measured_thresh),
                     ("offset", offset)):
            lo, hi = _OPT_RANGES[k]
            if not lo <= float(v) <= hi:
                raise ValueError(
                    f"loudnorm: {k}={v} out of range [{lo}, {hi}]")
        self.rate = int(rate)
        self.target_i = float(I)
        self.target_lra = float(LRA)
        self.target_tp_db = float(TP)
        self.measured_i = float(measured_I)
        self.measured_lra = float(measured_LRA)
        self.measured_tp = float(measured_TP)
        self.measured_thresh = float(measured_thresh)
        self.offset_db = float(offset)
        self.linear_opt = bool(linear)
        self.dual_mono = bool(dual_mono)
        self.print_format = print_format

        # init() linear decision (af_loudnorm.c:772-791)
        self.frame_type = FIRST
        if self.linear_opt:
            off = self.target_i - self.measured_i
            offset_tp = self.measured_tp + off
            if (self.measured_tp != 99 and self.measured_thresh != -70
                    and self.measured_lra != 0 and self.measured_i != 0):
                if (offset_tp <= self.target_tp_db
                        and self.measured_lra <= self.target_lra):
                    self.frame_type = LINEAR
                    self.offset_db = off

        self._proc_rate = (self.rate if self.frame_type == LINEAR
                           else (int(internal_rate) or _RATE))
        self._ch = 0
        self._configured = False
        self._flushed = False
        self._in_swr = self._out_swr = None
        self._pending = None         # float64 @ _proc_rate awaiting framing

    # -- config_input (af_loudnorm.c:718-770) ----------------------------

    def _configure(self, channels: int):
        self._ch = channels
        r = self._proc_rate
        self.r128_in = EburR128(channels, r)
        self.r128_out = EburR128(channels, r)
        if channels == 1 and self.dual_mono:
            self.r128_in.set_channel(0, DUAL_MONO)
            self.r128_out.set_channel(0, DUAL_MONO)
        self.buf_frames = frame_size(r, 3000)
        self.buf = np.zeros((self.buf_frames, channels))
        self.limiter_frames = frame_size(r, 210)
        self.offset = 10.0 ** (self.offset_db / 20.0)
        self.target_tp = 10.0 ** (self.target_tp_db / 20.0)
        self.attack_length = frame_size(r, 10)
        self.release_length = frame_size(r, 100)
        self.lim = _Limiter(self.limiter_frames, channels, self.target_tp,
                            self.attack_length, self.release_length)
        self.buf_index = 0           # frames
        self.prev_buf_index = 0
        self.index = 1
        self.delta = np.zeros(30)
        self.weights = _gaussian_weights()
        self.prev_delta = 0.0
        self.above_threshold = 0
        self.prev_nb_samples = 0
        self.subframe = frame_size(r, 100)
        self._pending = np.zeros((0, channels))
        if self._proc_rate != self.rate:
            from .swr import (AV_SAMPLE_FMT_DBL, AV_SAMPLE_FMT_S16,
                              SwrStream)
            self._in_swr = SwrStream(self.rate, self._proc_rate, channels,
                                     AV_SAMPLE_FMT_S16, AV_SAMPLE_FMT_DBL)
            self._out_swr = SwrStream(self._proc_rate, self.rate, channels,
                                      AV_SAMPLE_FMT_DBL, AV_SAMPLE_FMT_S16)
        self._configured = True

    # -- gaussian gain (af_loudnorm.c:155-165) ----------------------------

    def _gaussian(self, index: int) -> float:
        index = index - 10 if index - 10 > 0 else index + 20
        idx = (index + np.arange(21)) % 30
        return float(self.delta[idx] @ self.weights)

    # -- one 192 kHz double frame through the machine ---------------------

    def _process_frame(self, src: np.ndarray) -> np.ndarray:
        """The filter_frame switch (af_loudnorm.c:409-637); `src` is an
        interleaved float64 frame at the processing rate."""
        ch = self._ch
        n = len(src)
        self.r128_in.add_frames(src)

        if self.frame_type == FIRST and n < frame_size(self._proc_rate,
                                                       3000):
            # sub-3 s input: one-shot linear fallback (:445-460)
            glob = self.r128_in.loudness_global()
            true_peak = max(self.r128_in.sample_peak(c) for c in range(ch))
            off = 10.0 ** ((self.target_i - glob) / 20.0)
            offset_tp = true_peak * off
            self.offset = (off if offset_tp < self.target_tp
                           else self.target_tp - true_peak)
            self.frame_type = LINEAR

        if self.frame_type == FIRST:
            self.buf[:n] = src
            shortterm = self.r128_in.loudness_shortterm()
            if shortterm < self.measured_thresh:
                self.above_threshold = 0
                env_shortterm = (0.0 if shortterm <= -70.0
                                 else self.target_i - self.measured_i)
            else:
                self.above_threshold = 1
                env_shortterm = (0.0 if shortterm <= -70.0
                                 else self.target_i - shortterm)
            self.delta[:] = 10.0 ** (env_shortterm / 20.0)
            self.prev_delta = self.delta[self.index]
            # fill the whole 210 ms ring from buf (cursor wraps to 0);
            # (buf * delta) * offset keeps the C's left association
            # (:491) — precombining the constants is 1 ulp off, enough
            # to flip a `this > ceiling` peak predicate
            self.lim.index = 0
            self.lim.write_adv((self.buf[:self.limiter_frames]
                                * self.delta[self.index]) * self.offset)
            self.buf_index = self.limiter_frames
            dst = self.lim.run(self.subframe, first_frame=True)
            self.r128_out.add_frames(dst)
            self.frame_type = INNER
            return dst

        if self.frame_type == INNER:
            gain = self._gaussian((self.index + 10) % 30)
            gain_next = self._gaussian((self.index + 11) % 30)
            # write input at prev_buf_index; read 3 s-delayed at
            # buf_index into the limiter ring with interpolated gain
            # (the two buf ranges stay 40320-21120 frames apart — no
            # overlap within one <=19200-frame block)
            wr = (self.prev_buf_index + np.arange(n)) % self.buf_frames
            rd = (self.buf_index + np.arange(n)) % self.buf_frames
            ramp = gain + (np.arange(n) / n) * (gain_next - gain)
            # (buf * gain) * offset — the C's association (:519)
            self.lim.write_adv((self.buf[rd] * ramp[:, None])
                               * self.offset)
            self.buf[wr] = src
            self.prev_buf_index = (self.prev_buf_index + n) \
                % self.buf_frames
            self.buf_index = (self.buf_index + n) % self.buf_frames
            # short-frame cursor alignment (:536-537); run() then emits
            # at the cursor without advancing it (like the C)
            self.lim.index = (self.lim.index + (self.subframe - n)) \
                % self.limiter_frames
            dst = self.lim.run(n, first_frame=False)
            self.r128_out.add_frames(dst)

            lra = self.r128_in.loudness_range()
            glob = self.r128_in.loudness_global()
            shortterm = self.r128_in.loudness_shortterm()
            relative_threshold = self.r128_in.relative_threshold()

            if self.above_threshold == 0:
                if shortterm > self.measured_thresh:
                    self.prev_delta *= 1.0058
                if self.r128_out.loudness_shortterm() >= self.target_i:
                    self.above_threshold = 1

            if (shortterm < relative_threshold or shortterm <= -70.0
                    or self.above_threshold == 0):
                self.delta[self.index] = self.prev_delta
            else:
                d = shortterm - glob
                lim = self.target_lra / 2.0
                env_global = d if abs(d) < lim else lim * np.sign(d)
                env_shortterm = self.target_i - shortterm
                self.delta[self.index] = 10.0 ** ((env_global
                                                   + env_shortterm) / 20.0)
            self.prev_delta = self.delta[self.index]
            self.index = (self.index + 1) % 30
            self.prev_nb_samples = n
            del lra
            return dst

        if self.frame_type == FINAL:
            gain = self._gaussian((self.index + 10) % 30)
            self.lim.index = 0
            # (src * gain) * offset, the C's association (:581,:597)
            self.lim.write_adv((src[:self.limiter_frames] * gain)
                               * self.offset)
            src_index = self.limiter_frames
            outs = []
            for _ in range(n // self.subframe):
                # limiter first, refill second (af_loudnorm.c:590-612)
                outs.append(self.lim.run(self.subframe, first_frame=False))
                take = src[src_index:src_index + self.subframe]
                blk = np.zeros((self.subframe, ch))
                if len(take):
                    blk[:len(take)] = (take * gain) * self.offset
                self.lim.write_adv(blk)
                src_index += len(take)
            dst = (np.concatenate(outs) if outs
                   else np.zeros((0, ch)))
            self.r128_out.add_frames(dst)
            return dst

        # LINEAR
        dst = src * self.offset
        self.r128_out.add_frames(dst)
        return dst

    # -- framing + format conversion --------------------------------------

    def _needed(self) -> int:
        return (frame_size(self._proc_rate, 3000) if self.frame_type
                == FIRST else self.subframe)

    def _drain_pending(self, eof: bool) -> np.ndarray:
        outs = []
        while self.frame_type in (FIRST, INNER):
            need = self._needed()
            have = len(self._pending)
            if have >= need:
                frame, self._pending = (self._pending[:need],
                                        self._pending[need:])
            elif eof and have > 0:
                frame, self._pending = self._pending, \
                    np.zeros((0, self._ch))
            else:
                break
            outs.append(self._process_frame(frame))
            eof_short = len(frame) < need
            if eof_short:
                break
        if eof and self.frame_type == INNER:
            # request_frame EOF drain (af_loudnorm.c:639-682)
            nb = (self.buf_frames - self.prev_nb_samples) \
                - (self.subframe - self.prev_nb_samples)
            off = (self.limiter_frames - self.prev_nb_samples) \
                - (self.subframe - self.prev_nb_samples)
            self.buf_index = (self.buf_index - off) % self.buf_frames
            rd = (self.buf_index + np.arange(nb)) % self.buf_frames
            frame = self.buf[rd].copy()
            self.buf_index = (self.buf_index + nb) % self.buf_frames
            self.frame_type = FINAL
            outs.append(self._process_frame(frame))
        if not outs:
            return np.zeros((0, self._ch))
        return np.concatenate(outs)

    @staticmethod
    def _dbl_to_s16(x: np.ndarray) -> np.ndarray:
        return np.clip(np.rint(x * 32768.0), -32768, 32767).astype(np.int16)

    def push(self, block: np.ndarray) -> np.ndarray:
        if block.size == 0:
            return np.zeros((0, 0), np.int16)
        if not self._configured:
            self._configure(block.shape[1])
        if self._in_swr is not None:
            dbl = self._in_swr.push(block)
        else:
            dbl = block.astype(np.float64) / 32768.0
        if self.frame_type == LINEAR:
            out = self._process_frame(dbl)
            if self._out_swr is not None:
                return self._out_swr.push(out)
            return self._dbl_to_s16(out)
        self._pending = np.concatenate([self._pending, dbl]) \
            if self._pending.size else dbl
        out = self._drain_pending(eof=False)
        if self._out_swr is not None:
            return self._out_swr.push(out) if len(out) else \
                np.zeros((0, self._ch), np.int16)
        return self._dbl_to_s16(out)

    def flush(self) -> np.ndarray:
        if not self._configured or self._flushed:
            return np.zeros((0, 0), np.int16)
        self._flushed = True
        if self._in_swr is not None:
            tail = self._in_swr.flush()
            if len(tail):
                self._pending = np.concatenate([self._pending, tail]) \
                    if self._pending.size else tail
        out = self._drain_pending(eof=True)
        if self._out_swr is not None:
            parts = []
            if len(out):
                parts.append(self._out_swr.push(out))
            parts.append(self._out_swr.flush())
            parts = [p for p in parts if len(p)]
            if not parts:
                return np.zeros((0, self._ch), np.int16)
            return np.concatenate(parts)
        return self._dbl_to_s16(out)

    # -- stats (uninit print, af_loudnorm.c:793-880) -----------------------

    def stats(self) -> Optional[Dict[str, float]]:
        if not self._configured:
            return None
        ch = range(self._ch)
        tp_in = max(self.r128_in.sample_peak(c) for c in ch)
        tp_out = max(self.r128_out.sample_peak(c) for c in ch)
        i_out = self.r128_out.loudness_global()
        return {
            "input_i": self.r128_in.loudness_global(),
            "input_tp": 20.0 * np.log10(tp_in) if tp_in > 0 else -np.inf,
            "input_lra": self.r128_in.loudness_range(),
            "input_thresh": self.r128_in.relative_threshold(),
            "output_i": i_out,
            "output_tp": 20.0 * np.log10(tp_out) if tp_out > 0 else -np.inf,
            "output_lra": self.r128_out.loudness_range(),
            "output_thresh": self.r128_out.relative_threshold(),
            "normalization_type": ("linear" if self.frame_type == LINEAR
                                   else "dynamic"),
            "target_offset": self.target_i - i_out,
        }
