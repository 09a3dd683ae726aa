"""EBU R128 loudness measurement (BS.1770) — rebuild of the reference's
`libavfilter/ebur128.c` (itself based on libebur128), the measurement
engine behind `loudnorm`.

Reference parity map:
- K-weighting filter design (head shelf + high-pass combined into one
  4th-order section): ebur128.c:106-154 `ebur128_init_filter`.
- Streaming block logic (400 ms first gating block, then 100 ms hops
  with 75% overlap; 3 s short-term blocks hopping 1 s):
  ebur128.c:460-503 `ebur128_add_frames_planar`.
- Energy histogram (1000 bins of 0.1 LU from -70 LUFS):
  ebur128.c:204-217/373-389.
- Gated loudness / relative threshold: ebur128.c:515-599.
- Loudness range per EBU Tech 3342: ebur128.c:632-707.

Differences from the C (documented, covered by test tolerances):
- The K-weighting IIR runs through scipy.signal.lfilter (direct form
  II transposed) with carried per-channel state instead of the C's
  direct-form-II v-chain; outputs agree to ~1e-13 relative.  The C's
  per-chunk denormal flush of the v state is approximated by zeroing
  the transposed state when all entries drop below DBL_MIN.
- Window energies use numpy pairwise summation instead of the C's
  sequential accumulation (ulp-level differences, absorbed by the
  0.1 LU histogram bins).

A copy of `gmat_tpu/av/ebur128.py` for the PyTorch port: host numpy
on interleaved PCM, no device work.
"""
from __future__ import annotations

import numpy as np

try:
    from scipy.signal import lfilter
except ImportError:                                    # pragma: no cover
    lfilter = None

MODE_M = 1 << 0
MODE_S = (1 << 1) | MODE_M
MODE_I = (1 << 2) | MODE_M
MODE_LRA = (1 << 3) | MODE_S
MODE_SAMPLE_PEAK = (1 << 4) | MODE_M

# channel designations (ebur128.h:40-76)
UNUSED = 0
LEFT = 1
RIGHT = 2
CENTER = 3
LEFT_SURROUND = 4      # itu M+110 -> 1.41 weight
RIGHT_SURROUND = 5     # itu M-110 -> 1.41 weight
DUAL_MONO = 6

_RELATIVE_GATE_FACTOR = 10.0 ** (-10.0 / 10.0)
_MINUS_20DB = 10.0 ** (-20.0 / 10.0)

# static histogram tables (ebur128.c:204-217)
_HIST_ENERGIES = 10.0 ** ((np.arange(1000) / 10.0 - 69.95 + 0.691) / 10.0)
_HIST_BOUNDARIES = np.empty(1001)
_HIST_BOUNDARIES[0] = 10.0 ** ((-70.0 + 0.691) / 10.0)
_HIST_BOUNDARIES[1:] = 10.0 ** ((np.arange(1, 1001) / 10.0 - 70.0 + 0.691)
                                / 10.0)


def _find_histogram_index(energy: float) -> int:
    """ebur128.c:373-389 binary search over the same boundary table."""
    i = int(np.searchsorted(_HIST_BOUNDARIES, energy, side="right")) - 1
    return min(max(i, 0), 999)


def _design_filter(rate: int):
    """K-weighting coefficients (ebur128.c:106-147): a +4 dB head shelf
    at ~1681.97 Hz cascaded with a 38.135 Hz high-pass, combined into
    one biquad-squared (5-tap b, 5-tap a) section."""
    f0 = 1681.974450955533
    G = 3.999843853973347
    Q = 0.7071752369554196

    K = np.tan(np.pi * f0 / rate)
    Vh = 10.0 ** (G / 20.0)
    Vb = Vh ** 0.4996667741545416

    a0 = 1.0 + K / Q + K * K
    pb = [(Vh + Vb * K / Q + K * K) / a0,
          2.0 * (K * K - Vh) / a0,
          (Vh - Vb * K / Q + K * K) / a0]
    pa = [1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / Q + K * K) / a0]
    rb = [1.0, -2.0, 1.0]

    f0 = 38.13547087602444
    Q = 0.5003270373238773
    K = np.tan(np.pi * f0 / rate)
    ra = [1.0,
          2.0 * (K * K - 1.0) / (1.0 + K / Q + K * K),
          (1.0 - K / Q + K * K) / (1.0 + K / Q + K * K)]

    b = np.array([pb[0] * rb[0],
                  pb[0] * rb[1] + pb[1] * rb[0],
                  pb[0] * rb[2] + pb[1] * rb[1] + pb[2] * rb[0],
                  pb[1] * rb[2] + pb[2] * rb[1],
                  pb[2] * rb[2]])
    a = np.array([pa[0] * ra[0],
                  pa[0] * ra[1] + pa[1] * ra[0],
                  pa[0] * ra[2] + pa[1] * ra[1] + pa[2] * ra[0],
                  pa[1] * ra[2] + pa[2] * ra[1],
                  pa[2] * ra[2]])
    return b, a


def default_channel_map(channels: int):
    """ebur128.c:156-202."""
    if channels == 4:
        return [LEFT, RIGHT, LEFT_SURROUND, RIGHT_SURROUND]
    if channels == 5:
        return [LEFT, RIGHT, CENTER, LEFT_SURROUND, RIGHT_SURROUND]
    base = [LEFT, RIGHT, CENTER, UNUSED, LEFT_SURROUND, RIGHT_SURROUND]
    return [base[i] if i < 6 else UNUSED for i in range(channels)]


class EburR128:
    """Streaming R128 state: feed interleaved float64 frames scaled to
    [-1, 1] (the DBL lane of the C's type-macro family)."""

    def __init__(self, channels: int, rate: int, window: int = 0,
                 mode: int = MODE_I | MODE_S | MODE_LRA | MODE_SAMPLE_PEAK):
        if lfilter is None:                            # pragma: no cover
            raise RuntimeError("ebur128 needs scipy.signal.lfilter")
        self.channels = int(channels)
        self.rate = int(rate)
        self.mode = mode
        self.channel_map = default_channel_map(self.channels)
        self.samples_in_100ms = (self.rate + 5) // 10
        if mode & MODE_S == MODE_S:
            window = max(window, 3000)
        elif mode & MODE_M == MODE_M:
            window = max(window, 400)
        else:
            raise ValueError("mode must include M or S")
        frames = self.rate * window // 1000
        if frames % self.samples_in_100ms:
            frames += self.samples_in_100ms - frames % self.samples_in_100ms
        self.audio_data = np.zeros((frames, self.channels))
        self.audio_data_frames = frames
        self.audio_data_index = 0       # in FRAMES (C counts doubles)
        self.needed_frames = self.samples_in_100ms * 4
        self.short_term_frame_counter = 0
        self.block_hist = np.zeros(1000, np.int64)
        self.short_term_hist = np.zeros(1000, np.int64)
        self.sample_peaks = np.zeros(self.channels)
        self._b, self._a = _design_filter(self.rate)
        self._zi = np.zeros((5, 4))     # lfilter state per v-row
        self._DBL_MIN = np.finfo(np.float64).tiny

    def set_channel(self, channel: int, value: int) -> int:
        if channel >= self.channels:
            return 1
        if value == DUAL_MONO and (self.channels != 1 or channel != 0):
            return 1
        self.channel_map[channel] = value
        return 0

    # -- filtering ------------------------------------------------------

    def _filter_chunk(self, x: np.ndarray):
        """K-weight `x` ((n, ch) float64) into the ring at
        audio_data_index (ebur128.c:317-365)."""
        n = len(x)
        if self.mode & MODE_SAMPLE_PEAK == MODE_SAMPLE_PEAK and n:
            peaks = np.abs(x).max(axis=0)
            np.maximum(self.sample_peaks, peaks, out=self.sample_peaks)
        dst = self.audio_data[self.audio_data_index:
                              self.audio_data_index + n]
        for c in range(self.channels):
            ci = self.channel_map[c] - 1
            if ci < 0:
                continue
            if ci == DUAL_MONO - 1:
                ci = 0
            y, zi = lfilter(self._b, self._a, x[:, c], zi=self._zi[ci])
            dst[:, c] = y
            # the C flushes denormal v state between chunks; approximate
            # on the transposed state
            if np.all(np.abs(zi) < self._DBL_MIN):
                zi[:] = 0.0
            self._zi[ci] = zi

    # -- block plumbing (ebur128.c:460-503) -----------------------------

    def add_frames(self, x: np.ndarray):
        """x: (n, channels) float64 interleaved, full-scale +-1."""
        x = np.asarray(x, np.float64)
        src = 0
        frames = len(x)
        while frames > 0:
            if frames >= self.needed_frames:
                take = self.needed_frames
                self._filter_chunk(x[src:src + take])
                src += take
                frames -= take
                self.audio_data_index += take
                if self.mode & MODE_I == MODE_I:
                    e = self._gating_energy(self.samples_in_100ms * 4)
                    if e >= _HIST_BOUNDARIES[0]:
                        self.block_hist[_find_histogram_index(e)] += 1
                if self.mode & MODE_LRA == MODE_LRA:
                    self.short_term_frame_counter += take
                    if (self.short_term_frame_counter
                            == self.samples_in_100ms * 30):
                        e = self._gating_energy(self.samples_in_100ms * 30)
                        if e >= _HIST_BOUNDARIES[0]:
                            self.short_term_hist[
                                _find_histogram_index(e)] += 1
                        self.short_term_frame_counter = \
                            self.samples_in_100ms * 20
                self.needed_frames = self.samples_in_100ms
                if self.audio_data_index == self.audio_data_frames:
                    self.audio_data_index = 0
            else:
                self._filter_chunk(x[src:src + frames])
                self.audio_data_index += frames
                if self.mode & MODE_LRA == MODE_LRA:
                    self.short_term_frame_counter += frames
                self.needed_frames -= frames
                frames = 0

    def _gating_energy(self, frames_per_block: int) -> float:
        """Mean weighted channel energy over the trailing
        `frames_per_block` frames of the ring (ebur128.c:391-443)."""
        idx = self.audio_data_index
        if idx < frames_per_block:
            head = self.audio_data[:idx]
            tail = self.audio_data[self.audio_data_frames
                                   - (frames_per_block - idx):]
            sq = (head * head).sum(axis=0) + (tail * tail).sum(axis=0)
        else:
            win = self.audio_data[idx - frames_per_block:idx]
            sq = (win * win).sum(axis=0)
        total = 0.0
        for c in range(self.channels):
            cm = self.channel_map[c]
            if cm == UNUSED:
                continue
            s = sq[c]
            if cm in (LEFT_SURROUND, RIGHT_SURROUND):
                s *= 1.41
            elif cm == DUAL_MONO:
                s *= 2.0
            total += s
        return total / frames_per_block

    # -- outputs ---------------------------------------------------------

    @staticmethod
    def _energy_to_loudness(energy: float) -> float:
        return 10.0 * np.log10(energy) - 0.691

    def _relative_threshold_energy(self):
        cnt = int(self.block_hist.sum())
        if cnt == 0:
            return 0.0, 0
        rt = float(self.block_hist @ _HIST_ENERGIES) / cnt
        return rt * _RELATIVE_GATE_FACTOR, cnt

    def relative_threshold(self) -> float:
        rt, cnt = self._relative_threshold_energy()
        if cnt == 0:
            return -70.0
        return float(self._energy_to_loudness(rt))

    def loudness_global(self) -> float:
        rt, cnt = self._relative_threshold_energy()
        if cnt == 0:
            return float("-inf")
        if rt < _HIST_BOUNDARIES[0]:
            start = 0
        else:
            start = _find_histogram_index(rt)
            if rt > _HIST_ENERGIES[start]:
                start += 1
        above = int(self.block_hist[start:].sum())
        if above == 0:
            return float("-inf")
        gated = float(self.block_hist[start:] @ _HIST_ENERGIES[start:])
        return float(self._energy_to_loudness(gated / above))

    def loudness_shortterm(self) -> float:
        e = self._gating_energy(self.samples_in_100ms * 30)
        if e <= 0.0:
            return float("-inf")
        return float(self._energy_to_loudness(e))

    def loudness_range(self) -> float:
        """EBU Tech 3342 (ebur128.c:632-707)."""
        hist = self.short_term_hist
        stl_size = int(hist.sum())
        if stl_size == 0:
            return 0.0
        stl_power = float(hist @ _HIST_ENERGIES) / stl_size
        stl_integrated = _MINUS_20DB * stl_power
        if stl_integrated < _HIST_BOUNDARIES[0]:
            index = 0
        else:
            index = _find_histogram_index(stl_integrated)
            if stl_integrated > _HIST_ENERGIES[index]:
                index += 1
        stl_size = int(hist[index:].sum())
        if stl_size == 0:
            return 0.0
        percentile_low = int((stl_size - 1) * 0.1 + 0.5)
        percentile_high = int((stl_size - 1) * 0.95 + 0.5)
        cum = np.cumsum(hist[index:])
        j_low = int(np.searchsorted(cum, percentile_low, side="right"))
        j_high = int(np.searchsorted(cum, percentile_high, side="right"))
        l_en = _HIST_ENERGIES[index + j_low]
        h_en = _HIST_ENERGIES[index + j_high]
        return float(self._energy_to_loudness(h_en)
                     - self._energy_to_loudness(l_en))

    def sample_peak(self, channel: int) -> float:
        return float(self.sample_peaks[channel])
