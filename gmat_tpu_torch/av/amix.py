"""amix — mix N audio inputs into one stream.

Rebuild of the reference's `libavfilter/af_amix.c` (632 LoC): float
accumulation with per-input scale factors, `weights`/`normalize`
options, duration modes (longest/shortest/first), and the
`dropout_transition` volume renormalization ramp that re-balances the
mix as inputs hit EOF (af_amix.c:208-245 calculate_scales).

Output chunking follows the C: each output frame matches the first
input's next queued frame size while input 0 is live, then the minimum
available across the survivors (af_amix.c:297-393 output_frame); the
ramp advances per output chunk with that chunk's sample count.

The chain hosts it like ffmpeg's -filter_complex would: CLI/metrans
`amix=audio=FILE[:duration=..][:weights=..]` decodes the secondary
source up front (resampled to the chain rate through the real
libswresample) and mixes it against the streaming primary input.

A copy of `gmat_tpu/av/amix.py` for the PyTorch port: host numpy
on interleaved PCM, no device work.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

INPUT_ON = 1
INPUT_EOF = 2
_DURATIONS = {"longest": 0, "shortest": 1, "first": 2}


def parse_amix_opts(val: str) -> Dict:
    """'inputs=2:duration=longest:dropout_transition=2:weights=1 0.5:
    normalize=0' (+ our audio=FILE source option)."""
    kw: Dict = {}
    for tok in str(val).split(":"):
        tok = tok.strip()
        if not tok:
            continue
        if "=" not in tok:
            raise ValueError(f"amix: bad option {tok!r}")
        k, v = tok.split("=", 1)
        k = k.strip()
        if k == "inputs":
            kw[k] = int(v)
            if not 1 <= kw[k] <= 32767:
                raise ValueError(f"amix: inputs={v} out of range")
        elif k == "duration":
            if v not in _DURATIONS:
                raise ValueError(f"amix: bad duration {v!r}")
            kw[k] = v
        elif k == "dropout_transition":
            kw[k] = float(v)
            if kw[k] < 0:
                raise ValueError("amix: dropout_transition < 0")
        elif k == "weights":
            kw[k] = v.strip()
        elif k == "normalize":
            v = v.strip().lower()
            if v in ("1", "true", "on", "yes"):
                kw[k] = True
            elif v in ("0", "false", "off", "no"):
                kw[k] = False
            else:
                raise ValueError(f"amix: bad boolean normalize={v!r}")
        elif k == "audio":
            kw[k] = v
        else:
            raise ValueError(f"amix: unknown option {k!r}")
    return kw


def parse_weights(weights_str: str, nb_inputs: int):
    """af_amix.c:516-539: av_strtod tokens (dB/SI/hex postfixes via
    filters/expr.av_strtod), one separator char skipped between tokens,
    last weight repeated for the remaining inputs."""
    from ..filters.expr import av_strtod
    s = str(weights_str)
    weights: List[float] = []
    last, p = 1.0, 0
    i = 0
    while i < nb_inputs:
        last, p = av_strtod(s, p)
        weights.append(last)
        if p < len(s):
            p += 1               # the C's `if (p && *p) p++`
        else:
            break
        i += 1
    while len(weights) < nb_inputs:
        weights.append(last)
    return np.array(weights, np.float32)


class AmixFilter:
    """Pull/push mixer over interleaved float32 blocks (the C's flt
    lane; the s16 chain converts at the edges)."""

    def __init__(self, rate: int, channels: int, inputs: int = 2,
                 duration: str = "longest",
                 dropout_transition: float = 2.0,
                 weights: str = "1 1", normalize: bool = True):
        if duration not in _DURATIONS:
            raise ValueError(f"amix: bad duration {duration!r}")
        self.rate = int(rate)
        self.ch = int(channels)
        self.nb_inputs = int(inputs)
        self.duration_mode = _DURATIONS[duration]
        self.dropout_transition = float(dropout_transition)
        self.normalize = bool(normalize)
        self.weights = parse_weights(weights, self.nb_inputs)
        # weight_sum accumulates in float like the C (af_amix.c:525-538)
        ws = np.float32(0.0)
        for w in self.weights:
            ws = np.float32(ws + np.float32(abs(w)))
        self.weight_sum = ws
        self.fifos: List[np.ndarray] = [
            np.zeros((0, self.ch), np.float32)
            for _ in range(self.nb_inputs)]
        self.state = [INPUT_ON] * self.nb_inputs
        self.frame_sizes: List[int] = []     # frame_list for input 0
        # float scale_norm like the C's float* (config_output :283-284)
        self.scale_norm = [np.float32(self.weight_sum
                                      / np.float32(abs(w)))
                           for w in self.weights]
        self.input_scale = np.zeros(self.nb_inputs, np.float32)
        self._calculate_scales(0)
        self._done = False

    # -- calculate_scales (af_amix.c:208-245), float32 throughout ---------

    def _calculate_scales(self, nb_samples: int):
        f32 = np.float32
        weight_sum = f32(0.0)
        for i in range(self.nb_inputs):
            if self.state[i] & INPUT_ON:
                weight_sum = f32(weight_sum + f32(abs(self.weights[i])))
        for i in range(self.nb_inputs):
            if not (self.state[i] & INPUT_ON):
                continue
            target = f32(weight_sum / f32(abs(self.weights[i])))
            if self.scale_norm[i] > target:
                step = f32(f32(f32(f32(self.weight_sum
                                       / f32(abs(self.weights[i])))
                                   / f32(self.nb_inputs))
                               * f32(nb_samples))
                           / f32(self.dropout_transition * self.rate))
                self.scale_norm[i] = f32(self.scale_norm[i] - step)
                self.scale_norm[i] = max(self.scale_norm[i], target)
        for i in range(self.nb_inputs):
            if self.state[i] & INPUT_ON:
                if not self.normalize:
                    self.input_scale[i] = f32(abs(self.weights[i]))
                else:
                    self.input_scale[i] = f32(
                        f32(1.0 / self.scale_norm[i])
                        * f32(np.sign(self.weights[i])))
            else:
                self.input_scale[i] = 0.0

    # -- input side --------------------------------------------------------

    def push(self, i: int, block: np.ndarray) -> np.ndarray:
        """Feed a float32 (n, ch) frame into input `i`; returns any
        mixed output produced (the C calls output_frame after each
        consumed frame)."""
        if block.ndim != 2 or block.shape[1] != self.ch:
            raise ValueError("amix: channel mismatch")
        x = np.asarray(block, np.float32)
        if i == 0 and len(x):
            self.frame_sizes.append(len(x))
        if len(x):
            self.fifos[i] = np.concatenate([self.fifos[i], x]) \
                if self.fifos[i].size else x
        return self._drain()

    def finish(self, i: int) -> np.ndarray:
        """Mark input `i` EOF (activate's acknowledge path)."""
        if i == 0:
            self.state[0] = 0
        else:
            self.state[i] |= INPUT_EOF
            if len(self.fifos[i]) == 0:
                self.state[i] = 0
        return self._drain()

    # -- output side ---------------------------------------------------------

    def _active_eof(self) -> bool:
        """calc_active_inputs (af_amix.c:415-428)."""
        active = sum(1 for s in self.state if s & INPUT_ON)
        return (active == 0
                or (self.duration_mode == _DURATIONS["first"]
                    and not (self.state[0] & INPUT_ON))
                or (self.duration_mode == _DURATIONS["shortest"]
                    and active != self.nb_inputs))

    def _output_frame(self) -> Optional[np.ndarray]:
        """af_amix.c:297-393; None = nothing to emit right now."""
        if self.state[0] & INPUT_ON:
            nb = self.frame_sizes[0] if self.frame_sizes else 0
            for i in range(1, self.nb_inputs):
                if self.state[i] & INPUT_ON:
                    ns = len(self.fifos[i])
                    if ns < nb:
                        if not (self.state[i] & INPUT_EOF):
                            return None       # wait for more input
                        nb = ns
        else:
            nb = None
            for i in range(1, self.nb_inputs):
                if self.state[i] & INPUT_ON:
                    ns = len(self.fifos[i])
                    nb = ns if nb is None else min(nb, ns)
            if nb is None:
                self._done = True
                return None
        # frame_list_remove_samples
        rem = nb
        while rem > 0 and self.frame_sizes:
            if self.frame_sizes[0] <= rem:
                rem -= self.frame_sizes.pop(0)
            else:
                self.frame_sizes[0] -= rem
                rem = 0
        self._calculate_scales(nb)
        if nb == 0:
            return None
        out = np.zeros((nb, self.ch), np.float32)
        for i in range(self.nb_inputs):
            if self.state[i] & INPUT_ON:
                take = self.fifos[i][:nb]
                self.fifos[i] = self.fifos[i][nb:]
                # vector_fmac_scalar: float32 multiply-accumulate
                out += take * self.input_scale[i]
        return out

    def _drain(self) -> np.ndarray:
        outs = []
        while not self._done:
            # EOF'd inputs whose fifo drained go fully off (activate)
            for i in range(1, self.nb_inputs):
                if (self.state[i] & INPUT_ON) \
                        and (self.state[i] & INPUT_EOF) \
                        and len(self.fifos[i]) == 0:
                    self.state[i] = 0
            if self._active_eof():
                self._done = True
                break
            o = self._output_frame()
            if o is None:
                break
            outs.append(o)
        if not outs:
            return np.zeros((0, self.ch), np.float32)
        return np.concatenate(outs)


def load_audio_source(path: str, rate: int, channels: int) -> np.ndarray:
    """Decode a file's audio track to interleaved s16 at (rate,
    channels) — the secondary-input feeder for `amix=audio=FILE`."""
    from . import toolkit as tk
    dm = tk.Demuxer(path)
    try:
        info = tk.AudioInfo(dm)
        if not info.present:
            raise IOError(f"amix: {path!r} has no audio stream")
        dec = tk.AudioDecoder(info, sample_rate=rate, channels=channels)
        chunks = []
        for pkt in dm:               # Packet.stream: 0 video, 1 audio
            if pkt.stream != 1:
                continue
            for samples, _p in dec.decode(pkt.data, pkt.pts):
                chunks.append(samples)
        for samples, _p in dec.decode(None):
            chunks.append(samples)
        dec.close()
    finally:
        dm.close()
    if not chunks:
        return np.zeros((0, channels), np.int16)
    return np.concatenate(chunks)


class AmixStream:
    """Single-stream chain adapter: mixes the streaming primary input
    (input 0) against secondary sources, s16 in/out.  Sources are
    either pre-decoded (n, ch) int16 arrays or an `audio=FILE[|FILE2]`
    spec decoded lazily at the chain rate / discovered channel count."""

    def __init__(self, rate: int, sources: Optional[List] = None,
                 audio: str = "", **opts):
        self.rate = int(rate)
        self._paths = [p for p in str(audio).split("|") if p] \
            if audio else []
        self._sources = list(sources or [])
        self._opts = dict(opts)
        n_sec = len(self._sources) + len(self._paths)
        if n_sec == 0:
            raise ValueError(
                "amix: this single-stream chain needs secondary "
                "sources — pass audio=FILE (|-separated for several)")
        self._opts.setdefault("inputs", 1 + n_sec)
        if self._opts["inputs"] != 1 + n_sec:
            raise ValueError("amix: inputs= disagrees with provided "
                             "sources")
        self._mix = None
        self._flushed = False

    def _ensure(self, ch: int):
        if self._mix is None:
            srcs = [np.asarray(s, np.int16) for s in self._sources]
            srcs += [load_audio_source(p, self.rate, ch)
                     for p in self._paths]
            self._mix = AmixFilter(self.rate, ch, **self._opts)
            for i, s in enumerate(srcs, start=1):
                if s.shape[1] != ch:
                    raise ValueError("amix: secondary source channel "
                                     "count mismatch")
                self._mix.push(i, s.astype(np.float32) / 32768.0)
                self._mix.finish(i)

    @staticmethod
    def _to_s16(x: np.ndarray) -> np.ndarray:
        return np.clip(np.rint(x * 32768.0), -32768,
                       32767).astype(np.int16)

    def push(self, block: np.ndarray) -> np.ndarray:
        if block.size == 0:
            return np.zeros((0, 0), np.int16)
        self._ensure(block.shape[1])
        out = self._mix.push(0, block.astype(np.float32) / 32768.0)
        return self._to_s16(out)

    def flush(self) -> np.ndarray:
        if self._mix is None or self._flushed:
            return np.zeros((0, 0), np.int16)
        self._flushed = True
        return self._to_s16(self._mix.finish(0))
