"""Streaming libswresample binding (ctypes).

The reference's audio path delegates sample-rate/format conversion to
libswresample (AvToolkit/AvFilt.h:20-99 hosts libavfilter graphs whose
auto-inserted `aresample` is swr; NvCodec audio lanes call swr_convert
directly).  This wrapper is the toolkit's analog: filters that need
a different internal rate (loudnorm's 192 kHz pin) or sample format
convert through the real library, exactly like ffmpeg's graph
negotiation inserts aresample around `loudnorm`.

A copy of `gmat_tpu/av/swr.py` for the PyTorch port: host numpy
on interleaved PCM, no device work.
"""
from __future__ import annotations

import ctypes

import numpy as np

AV_SAMPLE_FMT_S16 = 1
AV_SAMPLE_FMT_DBL = 4

_lib = None


class _AVChannelLayout(ctypes.Structure):
    _fields_ = [("order", ctypes.c_int), ("nb_channels", ctypes.c_int),
                ("u", ctypes.c_uint64), ("opaque", ctypes.c_void_p)]


def _open_first(names):
    last = None
    for n in names:
        try:
            return ctypes.CDLL(n)
        except OSError as e:
            last = e
    raise OSError(f"none of {names} loadable: {last}")


def _load():
    global _lib
    if _lib is None:
        # try the ffmpeg 5/6/7 sonames, then the dev symlink
        swr = _open_first(["libswresample.so.4", "libswresample.so.5",
                           "libswresample.so.3", "libswresample.so"])
        avu = _open_first(["libavutil.so.57", "libavutil.so.58",
                           "libavutil.so.59", "libavutil.so"])
        swr.swr_alloc_set_opts2.restype = ctypes.c_int
        swr.swr_init.restype = ctypes.c_int
        swr.swr_convert.restype = ctypes.c_int
        swr.swr_get_out_samples.restype = ctypes.c_int
        avu.av_channel_layout_default.restype = None
        _lib = (swr, avu)
    return _lib


_FMT = {AV_SAMPLE_FMT_S16: (np.int16, 2), AV_SAMPLE_FMT_DBL: (np.float64, 8)}


class SwrStream:
    """Streaming rate/format converter over interleaved numpy blocks."""

    def __init__(self, in_rate: int, out_rate: int, channels: int,
                 in_fmt: int = AV_SAMPLE_FMT_S16,
                 out_fmt: int = AV_SAMPLE_FMT_S16):
        swr, avu = _load()
        self._swr = swr
        self.channels = int(channels)
        self.in_fmt, self.out_fmt = in_fmt, out_fmt
        self.in_rate, self.out_rate = int(in_rate), int(out_rate)
        in_l, out_l = _AVChannelLayout(), _AVChannelLayout()
        avu.av_channel_layout_default(ctypes.byref(in_l), self.channels)
        avu.av_channel_layout_default(ctypes.byref(out_l), self.channels)
        self._ctx = ctypes.c_void_p()
        rc = swr.swr_alloc_set_opts2(
            ctypes.byref(self._ctx), ctypes.byref(out_l), out_fmt,
            self.out_rate, ctypes.byref(in_l), in_fmt, self.in_rate,
            0, None)
        if rc != 0 or swr.swr_init(self._ctx) < 0:
            raise RuntimeError("swr_init failed")

    def _convert(self, inptr, in_count: int) -> np.ndarray:
        dt, _ = _FMT[self.out_fmt]
        cap = self._swr.swr_get_out_samples(self._ctx, in_count)
        cap = max(int(cap), 0) + 64
        out = np.empty((cap, self.channels), dt)
        optr = ctypes.cast(out.ctypes.data, ctypes.c_void_p)
        got = self._swr.swr_convert(
            self._ctx, ctypes.byref(optr), cap,
            ctypes.byref(inptr) if inptr is not None else None,
            in_count)
        if got < 0:
            raise RuntimeError("swr_convert failed")
        return out[:got]

    def push(self, block: np.ndarray) -> np.ndarray:
        dt, _ = _FMT[self.in_fmt]
        x = np.ascontiguousarray(block, dt)
        if x.size == 0:
            return np.zeros((0, self.channels), _FMT[self.out_fmt][0])
        iptr = ctypes.cast(x.ctypes.data, ctypes.c_void_p)
        return self._convert(iptr, len(x))

    def flush(self) -> np.ndarray:
        """Drain the resampler's internal delay (EOF NULL input)."""
        outs = []
        while True:
            got = self._convert(None, 0)
            if len(got) == 0:
                break
            outs.append(got)
        if not outs:
            return np.zeros((0, self.channels), _FMT[self.out_fmt][0])
        return np.concatenate(outs)

    def __del__(self):
        try:
            if getattr(self, "_ctx", None):
                self._swr.swr_free(ctypes.byref(self._ctx))
        except Exception:
            pass
