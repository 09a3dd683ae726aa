"""AvToolkit — Pythonic wrappers over the native host runtime.

A copy of `gmat_tpu/av/toolkit.py` (host-only: numpy and ctypes), the
rebuild of metrans/include/AvToolkit (Demuxer.h, Muxer.h, AvDec.h, VidEnc)
on top of csrc/gmat_av.cpp, loaded through the port's own `av.native`.
Packet bytes are copied out of the native layer once; frames decode
straight into caller-owned numpy planes.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np

from . import native

CODEC_H264, CODEC_HEVC, CODEC_MJPEG = 0, 1, 2
_CODEC_NAMES = {0: "h264", 1: "hevc", 2: "mjpeg", 99: "other"}


def codec_id(name: str) -> int:
    """Resolve any codec name ("vp9", "png", "prores", ...) to its raw
    AVCodecID for Decoder(codec_id=...)."""
    cid = native.load().gav_codec_id_by_name(name.encode())
    if not cid:
        raise ValueError(f"unknown codec {name!r}")
    return cid


@dataclasses.dataclass
class Packet:
    data: bytes
    pts: int
    dts: int
    key: bool
    nonref: bool      # skippable non-reference frame (smart decode)
    stream: int       # 0 video, 1 audio
    pos: int = -1     # byte offset in the container (-1 = unknown)


class Demuxer:
    """Video/audio packet source (metrans Demuxer.h:16-221 analog).

    Accepts a file path or an in-memory container (bytes/bytearray/
    memoryview) — the memory path uses custom AVIO callbacks like the
    reference's Demuxer(uint8_t* pBuffer, size_t) ctor (Demuxer.h:20-61),
    zero-copy: the buffer is pinned for the demuxer's lifetime."""

    def __init__(self, src, keep_avcc: bool = False):
        """keep_avcc=True skips the mp4->annexb BSF (the reference's
        bKeepAvcc, Demuxer.h:58) so packets stay in container format —
        required when stream-copying back into mp4/mov."""
        self._lib = native.load()
        self._buf = None
        if isinstance(src, (bytes, bytearray, memoryview)):
            self._buf = bytes(src)   # pin (no-copy when already bytes)
            self._h = self._lib.gav_demux_open_buffer(self._buf,
                                                      len(self._buf),
                                                      int(keep_avcc))
            src = f"<memory:{len(self._buf)}B>"
        else:
            self._h = self._lib.gav_demux_open(src.encode(),
                                               int(keep_avcc))
        if not self._h:
            raise IOError(f"demux open {src}: {native.last_error()}")
        self.keep_avcc = bool(keep_avcc)
        self.has_video = bool(self._lib.gav_demux_has_video(self._h))
        self.has_audio = bool(self._lib.gav_demux_has_audio(self._h))
        self.width = self._lib.gav_demux_width(self._h)
        self.height = self._lib.gav_demux_height(self._h)
        self.fps = self._lib.gav_demux_fps(self._h)
        self.duration = self._lib.gav_demux_duration(self._h)
        self.nb_frames = self._lib.gav_demux_nb_frames(self._h)
        self.codec = self._lib.gav_demux_codec(self._h)
        self.codec_id = self._lib.gav_demux_codec_id(self._h)  # raw AVCodecID
        self.codec_name = _CODEC_NAMES.get(self.codec, "other")
        self.colorspace = ("bt601", "bt709", "bt2020")[
            self._lib.gav_demux_colorspace(self._h)]
        num, den = ctypes.c_int(), ctypes.c_int()
        self._lib.gav_demux_timebase(self._h, ctypes.byref(num),
                                     ctypes.byref(den))
        self.time_base = (num.value, den.value)

    # AVColorTransferCharacteristic / AVColorPrimaries enum values
    # (libavutil/pixfmt.h) -> the names core/transfer canonicalizes.
    # Unmapped values (unspecified/reserved) probe as None.
    _TRC_NAMES = {1: "bt709", 4: "gamma22", 5: "gamma28", 6: "smpte170m",
                  8: "linear", 13: "srgb", 14: "2020_10", 15: "2020_12",
                  16: "smpte2084", 18: "arib-std-b67"}
    _PRIM_NAMES = {1: "bt709", 5: "bt470bg", 6: "smpte170m", 9: "bt2020",
                   11: "smpte431", 12: "smpte432"}

    def stream_meta(self) -> dict:
        """HDR-relevant stream tags as FilterGraph link state: trc /
        primaries names plus mastering-display max_luminance (cd/m2) and
        content-light MaxCLL — the inputs ff_determine_signal_peak reads
        (ffmpeg-gpu/libavfilter/colorspace.c:153-175)."""
        meta = {}
        trc = self._TRC_NAMES.get(self._lib.gav_demux_colortrc(self._h))
        if trc:
            meta["trc"] = trc
        prim = self._PRIM_NAMES.get(self._lib.gav_demux_colorprim(self._h))
        if prim:
            meta["primaries"] = prim
        max_lum = ctypes.c_double()
        max_cll = ctypes.c_int()
        found = self._lib.gav_demux_hdr(self._h, ctypes.byref(max_lum),
                                        ctypes.byref(max_cll))
        if found & 1 and max_lum.value > 0:
            meta["max_luminance"] = max_lum.value
        if found & 2 and max_cll.value > 0:
            meta["max_cll"] = max_cll.value
        return meta

    def extradata(self) -> bytes:
        p = native.c_pu8()
        n = self._lib.gav_demux_extradata(self._h, ctypes.byref(p))
        return ctypes.string_at(p, n) if n > 0 else b""

    def read(self) -> Optional[Packet]:
        data = native.c_pu8()
        pts, dts, pos = native.c_ll(), native.c_ll(), native.c_ll()
        key, nonref, stream = (ctypes.c_int(), ctypes.c_int(), ctypes.c_int())
        n = self._lib.gav_demux_read(
            self._h, ctypes.byref(data), ctypes.byref(pts), ctypes.byref(dts),
            ctypes.byref(key), ctypes.byref(nonref), ctypes.byref(stream),
            ctypes.byref(pos))
        if n == 0:
            return None
        if n < 0:
            raise IOError(f"demux read: {native.last_error()}")
        return Packet(ctypes.string_at(data, n), pts.value, dts.value,
                      bool(key.value), bool(nonref.value), stream.value,
                      pos.value)

    @property
    def start_time(self) -> float:
        """First presentation time in seconds (0 when unknown) — TS
        containers start at arbitrary offsets; time targets add this."""
        return float(self._lib.gav_demux_start_time(self._h))

    def seek(self, seconds: float) -> None:
        """Seek to the keyframe at/before `seconds` of MEDIA time (the
        stream's start offset is compensated automatically)."""
        num, den = self.time_base
        ts = int((seconds + self.start_time) * den / num)
        if self._lib.gav_demux_seek(self._h, ts) < 0:
            raise IOError(f"seek: {native.last_error()}")

    def seek_ts(self, ts: int) -> None:
        if self._lib.gav_demux_seek(self._h, ts) < 0:
            raise IOError(f"seek: {native.last_error()}")

    def __iter__(self) -> Iterator[Packet]:
        while True:
            p = self.read()
            if p is None:
                return
            yield p

    def close(self):
        if getattr(self, "_h", None):
            self._lib.gav_demux_close(self._h)
            self._h = None

    __del__ = close
    def __enter__(self): return self
    def __exit__(self, *a): self.close()


class Decoder:
    """Software video decoder -> planar I420 numpy frames (NvDecLite's
    role, NvDecLite.cpp:350-398, via libavcodec)."""

    def __init__(self, codec: int = 0, extradata: bytes = b"",
                 threads: int = 0, width: int = 0, height: int = 0,
                 resize=None, crop=None, codec_id: int = 0):
        """resize=(w, h) / crop=(x, y, w, h): decoder-side crop + early
        downscale (NvDecLite pCropRect/pResizeDim analog, NvDecLite.h:46,
        107-108) — frames shrink on the host, BEFORE the H2D transfer,
        cutting transfer bytes for decode-bound workloads.  Crop is
        applied first (even 4:2:0 coords), then the crop window is scaled
        to the resize target (or emitted 1:1 when resize is omitted)."""
        self._lib = native.load()
        ex = (ctypes.cast(ctypes.create_string_buffer(extradata, len(extradata)),
                          native.c_pu8) if extradata else None)
        if codec_id:
            # raw AVCodecID: any libavcodec decoder (the NvDecLite codec
            # map analog — vp8/vp9/av1/mpeg1/2/4/vc1/prores/png/...)
            self._h = self._lib.gav_dec_create_id(int(codec_id), ex,
                                                  len(extradata), threads)
        else:
            self._h = self._lib.gav_dec_create(codec, ex, len(extradata),
                                               threads)
        if not self._h:
            raise IOError(f"decoder create: {native.last_error()}")
        self.width, self.height = width, height
        self._fixed = False
        if crop is not None:
            cx, cy, cw_, ch_ = (int(c) for c in crop)
            self._lib.gav_dec_set_crop(self._h, cx, cy, cw_, ch_)
            if resize is None:
                resize = (cw_, ch_)
        if resize is not None:
            self.width = int(resize[0]) & ~1
            self.height = int(resize[1]) & ~1
            self._fixed = True

    @classmethod
    def from_demuxer(cls, dm: Demuxer, threads: int = 0, resize=None,
                     crop=None) -> "Decoder":
        if not dm.has_video:
            raise ValueError("source has no video stream (audio-only "
                             "input: use AudioDecoder)")
        if dm.codec == 99:     # beyond the fast enum: raw AVCodecID path
            return cls(0, dm.extradata(), threads, dm.width, dm.height,
                       resize=resize, crop=crop, codec_id=dm.codec_id)
        # annexb streams don't need extradata; keep_avcc packets stay
        # length-prefixed, so the decoder needs the avcC/hvcC config
        extra = dm.extradata() if getattr(dm, "keep_avcc", False) else b""
        return cls(dm.codec, extra, threads, dm.width, dm.height,
                   resize=resize, crop=crop)

    def reset(self) -> None:
        """Re-arm after a drain (decode(None)) so the same decoder can
        take a fresh independent stream (avcodec_flush_buffers)."""
        self._lib.gav_dec_reset(self._h)

    def send(self, data: Optional[bytes], pts: int = -1) -> int:
        """Feed one packet.  Returns 0 (consumed) or 1 (decoder is full
        — EAGAIN: drain frames with receive() and resend)."""
        if data is None:
            r = self._lib.gav_dec_send(self._h, None, 0, 0)
        else:
            buf = (ctypes.c_ubyte * len(data)).from_buffer_copy(data)
            r = self._lib.gav_dec_send(self._h, buf, len(data), pts)
        if r < 0:
            raise IOError(f"dec send: {native.last_error()}")
        return r

    def _sync_dims(self):
        """Peek the NEXT frame's output dims (gav_dec_peek_dims holds the
        frame until the matching receive) so a mid-stream resolution
        change never rescales the transition frame into stale geometry.
        Fixed-geometry decoders (resize=/explicit dims) skip this —
        rescaling into the caller geometry is the feature there."""
        if self._fixed:
            return
        pw, ph = ctypes.c_int(), ctypes.c_int()
        if self._lib.gav_dec_peek_dims(self._h, ctypes.byref(pw),
                                       ctypes.byref(ph)) == 1:
            if pw.value and (pw.value, ph.value) != (self.width,
                                                     self.height):
                self.width, self.height = pw.value, ph.value

    def receive(self) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, int]]:
        """-> (y, u, v, pts) or None (need more input). Raises StopIteration
        at EOF."""
        self._sync_dims()
        if not self.width:
            self.width = self._lib.gav_dec_width(self._h)
            self.height = self._lib.gav_dec_height(self._h)
        w, h = self.width, self.height
        if not w:
            return None
        # chroma buffers use the I420 ceil convention (the C sws path
        # writes ceil(h/2) rows / ceil(w/2) cols for odd targets); the
        # returned planes are floor-sliced to the framework's h>>1 shape
        y = np.empty((h, w), np.uint8)
        u = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
        v = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
        pts = native.c_ll()
        r = self._lib.gav_dec_receive(
            self._h, y.ctypes.data_as(native.c_pu8),
            u.ctypes.data_as(native.c_pu8), v.ctypes.data_as(native.c_pu8),
            w, h, ctypes.byref(pts))
        if r == 0:
            # dimensions may only be known after the first send (skipped
            # when resize/crop fixed the output geometry — the sws path
            # rescales any source dims into it)
            rw = self._lib.gav_dec_width(self._h)
            if rw and rw != w and not self._fixed:
                self.width, self.height = rw, self._lib.gav_dec_height(self._h)
                return self.receive()
            return None
        if r == -2:
            raise StopIteration
        if r < 0:
            raise IOError(f"dec receive: {native.last_error()}")
        il, tf = ctypes.c_int(), ctypes.c_int()
        self._lib.gav_dec_last_frame_info(self._h, ctypes.byref(il),
                                          ctypes.byref(tf))
        self.last_interlaced = bool(il.value)
        self.last_tff = bool(tf.value)
        return y, u[:h // 2, :w // 2], v[:h // 2, :w // 2], pts.value

    def receive_alpha(self):
        """Like receive() but -> (y, u, v, a, pts): full-res alpha plane
        (255 = opaque for alpha-less sources).  For alpha-carrying codecs
        (png/qtrle/prores4444) feeding the overlay second input."""
        self._sync_dims()
        if not self.width:
            self.width = self._lib.gav_dec_width(self._h)
            self.height = self._lib.gav_dec_height(self._h)
        w, h = self.width, self.height
        if not w:
            return None
        y = np.empty((h, w), np.uint8)
        u = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
        v = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
        a = np.empty((h, w), np.uint8)
        pts = native.c_ll()
        r = self._lib.gav_dec_receive_a(
            self._h, y.ctypes.data_as(native.c_pu8),
            u.ctypes.data_as(native.c_pu8), v.ctypes.data_as(native.c_pu8),
            a.ctypes.data_as(native.c_pu8), w, h, ctypes.byref(pts))
        if r == 0:
            rw = self._lib.gav_dec_width(self._h)
            if rw and rw != w and not self._fixed:
                self.width = rw
                self.height = self._lib.gav_dec_height(self._h)
                return self.receive_alpha()
            return None
        if r == -2:
            raise StopIteration
        if r < 0:
            raise IOError(f"dec receive_a: {native.last_error()}")
        return y, u[:h // 2, :w // 2], v[:h // 2, :w // 2], a, pts.value

    def has_alpha(self) -> bool:
        return bool(self._lib.gav_dec_has_alpha(self._h))

    def decode_alpha(self, data: Optional[bytes], pts: int = -1):
        """send + drain: yields (y, u, v, a, pts) tuples."""
        r = self.send(data, pts)
        while True:
            try:
                f = self.receive_alpha()
            except StopIteration:
                f = None
            if f is None:
                if r == 1:             # EAGAIN: resend after draining
                    r = self.send(data, pts)
                    if r == 1:
                        raise IOError("decoder EAGAIN after drain")
                    continue
                return
            yield f

    def decode(self, data: Optional[bytes], pts: int = -1):
        """send + drain: yields (y, u, v, pts) tuples.  An EAGAIN send
        (decoder full, e.g. frame-threaded with several packets queued)
        drains first and resends — the packet is never silently lost."""
        r = self.send(data, pts)
        while True:
            try:
                f = self.receive()
            except StopIteration:
                f = None
            if f is None:
                if r == 1:             # input not consumed yet: resend
                    r = self.send(data, pts)
                    if r == 1:
                        raise IOError("decoder EAGAIN after drain")
                    continue
                return
            yield f

    def receive16(self):
        """Like receive() but 10-bit: lsb-aligned uint16 planes
        ('yuv420p10'); any source depth is normalized to 10-bit."""
        self._sync_dims()
        if not self.width:
            self.width = self._lib.gav_dec_width(self._h)
            self.height = self._lib.gav_dec_height(self._h)
        w, h = self.width, self.height
        if not w:
            return None
        y = np.empty((h, w), np.uint16)
        u = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint16)
        v = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint16)
        pts = native.c_ll()
        pu16 = ctypes.POINTER(ctypes.c_ushort)
        r = self._lib.gav_dec_receive16(
            self._h, y.ctypes.data_as(pu16), u.ctypes.data_as(pu16),
            v.ctypes.data_as(pu16), w, h, ctypes.byref(pts))
        if r == 0:
            rw = self._lib.gav_dec_width(self._h)
            if rw and rw != w and not self._fixed:
                self.width, self.height = rw, self._lib.gav_dec_height(self._h)
                return self.receive16()
            return None
        if r == -2:
            raise StopIteration
        if r < 0:
            raise IOError(f"dec receive16: {native.last_error()}")
        return y, u[:h // 2, :w // 2], v[:h // 2, :w // 2], pts.value

    def decode16(self, data: Optional[bytes], pts: int = -1):
        r = self.send(data, pts)
        while True:
            try:
                f = self.receive16()
            except StopIteration:
                f = None
            if f is None:
                if r == 1:             # EAGAIN: resend after draining
                    r = self.send(data, pts)
                    if r == 1:
                        raise IOError("decoder EAGAIN after drain")
                    continue
                return
            yield f

    def close(self):
        if getattr(self, "_h", None):
            self._lib.gav_dec_close(self._h)
            self._h = None

    __del__ = close


class Encoder:
    """Video encoder (NvEncLite analog, NvEncLite.cpp:27-128): libx264 /
    libx265 / mjpeg with GOP/B-frames/preset/CRF and stillImage mode."""

    def __init__(self, name: str, width: int, height: int,
                 fps: Tuple[int, int] = (30, 1), bitrate: int = 0,
                 gop: int = 0, bf: int = 0, preset: str = "veryfast",
                 crf: float = -1.0, still_image: bool = False,
                 opts: str = "", bits: int = 8):
        self._lib = native.load()
        if not self._lib.gav_has_encoder(name.encode()):
            raise IOError(f"encoder {name} not available in libavcodec")
        create = (self._lib.gav_enc_create10 if bits == 10
                  else self._lib.gav_enc_create)
        self._h = create(
            name.encode(), width, height, fps[0], fps[1], bitrate, gop, bf,
            preset.encode(), crf, int(still_image), opts.encode())
        if not self._h:
            raise IOError(f"encoder create: {native.last_error()}")
        self.width, self.height, self.fps = width, height, fps
        self.name = name
        self.bits = bits
        self._kwargs = dict(fps=fps, bitrate=bitrate, gop=gop, bf=bf,
                            preset=preset, crf=crf, still_image=still_image,
                            opts=opts, bits=bits)

    def reconfigure(self, **changes) -> None:
        """Change encoder parameters mid-stream (NvEncLite::Reconfigure
        analog, NvEncLiteUnbuffered.cpp:288-290).  libavcodec software
        encoders can't live-reconfig, so the encoder is recreated and the
        next frame is forced IDR; drain pending packets before calling."""
        kw = dict(self._kwargs, **changes)
        # create the replacement FIRST: if the new params are invalid the
        # exception leaves the current encoder intact (closing first
        # would leave _h = None and the next encode would pass NULL to C)
        new = Encoder(self.name, self.width, self.height, **kw)
        self._lib.gav_enc_close(self._h)
        self._h, new._h = new._h, None
        self._kwargs = kw
        self.bits = kw["bits"]
        # public attrs must track the new config (a Muxer built from
        # enc.fps after reconfigure(fps=...) would get a stale timebase)
        for k_ in ("fps", "gop", "bf", "preset", "crf"):
            if k_ in kw and hasattr(self, k_):
                setattr(self, k_, kw[k_])
        self._force_next_key = True

    def extradata(self) -> bytes:
        p = native.c_pu8()
        n = self._lib.gav_enc_extradata(self._h, ctypes.byref(p))
        return ctypes.string_at(p, n) if n > 0 else b""

    def _recv_all(self):
        out = []
        while True:
            data = native.c_pu8()
            pts, dts, key = native.c_ll(), native.c_ll(), ctypes.c_int()
            n = self._lib.gav_enc_receive(self._h, ctypes.byref(data),
                                          ctypes.byref(pts), ctypes.byref(dts),
                                          ctypes.byref(key))
            if n <= 0:
                return out, n
            out.append(Packet(ctypes.string_at(data, n), pts.value, dts.value,
                              bool(key.value), False, 0))

    def set_roi(self, regions) -> None:
        """Per-frame QP-offset regions — the qpDeltaMap analog
        (NV_ENC_PIC_PARAMS.qpDeltaMap, AppNvEnc.cpp:92-102) via
        AV_FRAME_DATA_REGIONS_OF_INTEREST.

        regions: iterable of (top, bottom, left, right, qoffset) with
        pixel bounds and qoffset in [-1, +1] (negative = spend more bits /
        better quality, like a negative QP delta).  Applies to every
        subsequent frame until changed; None or [] clears.
        """
        regions = list(regions or [])
        flat = []
        for t, b, l, r_, q in regions:
            qn = int(round(float(q) * 255))
            qn = max(-255, min(255, qn))
            flat += [int(t), int(b), int(l), int(r_), qn, 255]
        arr = (ctypes.c_int * len(flat))(*flat)
        self._lib.gav_enc_set_roi(self._h, arr, len(regions))

    def encode(self, y: np.ndarray, u: np.ndarray, v: np.ndarray,
               pts: int = -1, force_key: bool = False, roi=None):
        """Encode one I420 (or 10-bit u16) frame; returns ready Packets.

        roi: optional region list for this and following frames (see
        set_roi)."""
        if y.shape != (self.height, self.width) or \
                u.shape != (self.height // 2, self.width // 2) or \
                v.shape != (self.height // 2, self.width // 2):
            raise ValueError(
                f"frame planes {y.shape}/{u.shape} don't match encoder "
                f"{self.width}x{self.height}")
        if roi is not None:
            self.set_roi(roi)
        if getattr(self, "_force_next_key", False):
            force_key, self._force_next_key = True, False
        if self.bits == 10:
            pu16 = ctypes.POINTER(ctypes.c_ushort)
            y = np.ascontiguousarray(y, np.uint16)
            u = np.ascontiguousarray(u, np.uint16)
            v = np.ascontiguousarray(v, np.uint16)
            r = self._lib.gav_enc_send16(
                self._h, y.ctypes.data_as(pu16), u.ctypes.data_as(pu16),
                v.ctypes.data_as(pu16), pts, int(force_key))
        else:
            y = np.ascontiguousarray(y, np.uint8)
            u = np.ascontiguousarray(u, np.uint8)
            v = np.ascontiguousarray(v, np.uint8)
            r = self._lib.gav_enc_send(
                self._h, y.ctypes.data_as(native.c_pu8),
                u.ctypes.data_as(native.c_pu8),
                v.ctypes.data_as(native.c_pu8), pts, int(force_key))
        if r < 0:
            raise IOError(f"enc send: {native.last_error()}")
        pkts, n = self._recv_all()
        if n == -1:
            raise IOError(f"enc receive: {native.last_error()}")
        if r == 1:                      # EAGAIN: resend after draining
            more = self.encode(y, u, v, pts, force_key)
            return pkts + more
        return pkts

    def flush(self):
        r = self._lib.gav_enc_send(self._h, None, None, None, 0, 0)
        if r < 0:
            raise IOError(f"enc flush: {native.last_error()}")
        pkts, n = self._recv_all()
        if n == -1:
            raise IOError(f"enc receive: {native.last_error()}")
        return pkts

    def close(self):
        if getattr(self, "_h", None):
            self._lib.gav_enc_close(self._h)
            self._h = None

    __del__ = close


class Muxer:
    """Single-video-stream muxer (LazyMuxer analog, Muxer.h:51-229)."""

    def __init__(self, path: str, width: int, height: int,
                 fps: Tuple[int, int], codec: int = 0,
                 extradata: bytes = b"", codec_id: int = 0):
        """codec: the h264/hevc/mjpeg enum — or pass codec_id for any raw
        AVCodecID (tk.codec_id("vp9") etc.), like the reference Muxer's
        generic AVCodecParameters (Muxer.h:51-90)."""
        self._lib = native.load()
        ex = ((ctypes.c_ubyte * len(extradata)).from_buffer_copy(extradata)
              if extradata else None)
        if codec_id:
            self._h = self._lib.gav_mux_open_id(path.encode(), width, height,
                                                fps[0], fps[1], int(codec_id),
                                                ex, len(extradata))
        else:
            self._h = self._lib.gav_mux_open(path.encode(), width, height,
                                             fps[0], fps[1], codec, ex,
                                             len(extradata))
        if not self._h:
            raise IOError(f"mux open: {native.last_error()}")

    def write(self, pkt: Packet) -> None:
        buf = (ctypes.c_ubyte * len(pkt.data)).from_buffer_copy(pkt.data)
        dts = pkt.dts if pkt.dts is not None else pkt.pts
        if self._lib.gav_mux_write(self._h, buf, len(pkt.data), pkt.pts,
                                   dts, int(pkt.key)) < 0:
            raise IOError(f"mux write: {native.last_error()}")

    def close(self):
        if getattr(self, "_h", None):
            self._lib.gav_mux_close(self._h)
            self._h = None

    __del__ = close
    def __enter__(self): return self
    def __exit__(self, *a): self.close()


CODEC_FOR_ENCODER = {"libx264": CODEC_H264, "libx265": CODEC_HEVC,
                     "mjpeg": CODEC_MJPEG}


def mux_kwargs_for_encoder(name: str) -> dict:
    """Muxer codec kwargs for any encoder name: the enum for the common
    three, a raw AVCodecID for everything else (mpeg2video, libvpx-vp9,
    ...).  Encoder names that prefix a codec name (libx264 -> h264) are
    resolved via the codec descriptor table."""
    if name in CODEC_FOR_ENCODER:
        return {"codec": CODEC_FOR_ENCODER[name]}
    for cand in (name, name.replace("lib", "", 1),
                 name.replace("libvpx-", "", 1)):
        try:
            return {"codec_id": codec_id(cand)}
        except ValueError:
            continue
    raise ValueError(f"cannot derive a mux codec for encoder {name!r}")


# --------------------------------------------------------------- audio
class AudioInfo:
    def __init__(self, dm: "Demuxer"):
        lib = native.load()
        cid, sr, ch = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        tn, td = ctypes.c_int(), ctypes.c_int()
        self.present = bool(lib.gav_demux_has_audio(dm._h))
        if self.present:
            lib.gav_demux_audio_info(dm._h, ctypes.byref(cid),
                                     ctypes.byref(sr), ctypes.byref(ch),
                                     ctypes.byref(tn), ctypes.byref(td))
            self.codec_id = cid.value
            self.sample_rate = sr.value
            self.channels = ch.value
            self.time_base = (tn.value, td.value)
            p = native.c_pu8()
            n = lib.gav_demux_audio_extradata(dm._h, ctypes.byref(p))
            self.extradata = ctypes.string_at(p, n) if n > 0 else b""


class AudioDecoder:
    """Audio decode -> interleaved s16 numpy (AudDec analog, AvDec.h)."""

    def __init__(self, info: AudioInfo, sample_rate: int = 0,
                 channels: int = 0):
        self._lib = native.load()
        ex = ((ctypes.c_ubyte * len(info.extradata))
              .from_buffer_copy(info.extradata) if info.extradata else None)
        self._h = self._lib.gav_adec_create(info.codec_id, ex,
                                            len(info.extradata), sample_rate,
                                            channels)
        if not self._h:
            raise IOError(f"audio decoder: {native.last_error()}")

    @property
    def sample_rate(self):
        return self._lib.gav_adec_rate(self._h)

    @property
    def channels(self):
        return self._lib.gav_adec_channels(self._h)

    def decode(self, data, pts: int = -1):
        """Yields (samples int16 (n, channels), pts)."""
        if data is None:
            r = self._lib.gav_adec_send(self._h, None, 0, 0)
        else:
            buf = (ctypes.c_ubyte * len(data)).from_buffer_copy(data)
            r = self._lib.gav_adec_send(self._h, buf, len(data), pts)
        if r < 0:
            raise IOError(f"adec: {native.last_error()}")
        while True:
            cap = 65536 * 8      # total shorts; C bounds by capacity/ch
            out = np.empty(cap, np.int16)
            p = native.c_ll()
            ch_out = ctypes.c_int(0)
            n = self._lib.gav_adec_receive(
                self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_short)),
                cap, ctypes.byref(p), ctypes.byref(ch_out))
            if n == 0 or n == -2:
                return
            if n < 0:
                raise IOError(f"adec recv: {native.last_error()}")
            ch = max(ch_out.value, 1)
            yield out[: n * ch].reshape(n, ch), p.value

    def close(self):
        if getattr(self, "_h", None):
            self._lib.gav_adec_close(self._h)
            self._h = None

    __del__ = close


class AudioEncoder:
    """s16 interleaved -> AAC/AC3/MP2 packets (AudEnc analog, AudEnc.h)."""

    def __init__(self, name: str = "aac", sample_rate: int = 48000,
                 channels: int = 2, bitrate: int = 128000):
        self._lib = native.load()
        self._h = self._lib.gav_aenc_create(name.encode(), sample_rate,
                                            channels, bitrate)
        if not self._h:
            raise IOError(f"audio encoder {name}: {native.last_error()}")
        self.sample_rate, self.channels = sample_rate, channels

    def extradata(self) -> bytes:
        p = native.c_pu8()
        n = self._lib.gav_aenc_extradata(self._h, ctypes.byref(p))
        return ctypes.string_at(p, n) if n > 0 else b""

    @property
    def codec_id(self):
        return self._lib.gav_aenc_codec_id(self._h)

    @property
    def frame_size(self):
        return self._lib.gav_aenc_frame_size(self._h)

    def _recv_all(self):
        pkts = []
        while True:
            data = native.c_pu8()
            pts, dts = native.c_ll(), native.c_ll()
            n = self._lib.gav_aenc_receive(self._h, ctypes.byref(data),
                                           ctypes.byref(pts),
                                           ctypes.byref(dts))
            if n == -1:
                raise IOError(f"aenc receive: {native.last_error()}")
            if n <= 0:
                return pkts
            pkts.append(Packet(ctypes.string_at(data, n), pts.value,
                               dts.value, True, False, 1))

    def encode(self, samples: np.ndarray):
        """samples: (n, channels) or flat interleaved int16."""
        samples = np.ascontiguousarray(samples, np.int16)
        n = samples.size // self.channels
        r = self._lib.gav_aenc_send(
            self._h, samples.ctypes.data_as(ctypes.POINTER(ctypes.c_short)), n)
        if r < 0:
            raise IOError(f"aenc: {native.last_error()}")
        return self._recv_all()

    def flush(self):
        self._lib.gav_aenc_send(self._h, None, 0)
        return self._recv_all()

    def close(self):
        if getattr(self, "_h", None):
            self._lib.gav_aenc_close(self._h)
            self._h = None

    __del__ = close


class AudioMuxer:
    """Audio-only muxer (the reference Muxer's NULL-video form,
    Muxer.h:51-90; AppMux DemuxAV writes a bare .aac this way).
    pts/dts are in samples (1/sample_rate)."""

    def __init__(self, path: str, acodec_id: int, sample_rate: int,
                 channels: int, extradata: bytes = b""):
        self._lib = native.load()
        ex = ((ctypes.c_ubyte * len(extradata)).from_buffer_copy(extradata)
              if extradata else None)
        self._h = self._lib.gav_mux_open_audio(path.encode(), acodec_id,
                                               sample_rate, channels, ex,
                                               len(extradata))
        if not self._h:
            raise IOError(f"audio mux open: {native.last_error()}")

    def write(self, pkt: Packet) -> None:
        buf = (ctypes.c_ubyte * len(pkt.data)).from_buffer_copy(pkt.data)
        dts = pkt.dts if pkt.dts is not None else pkt.pts
        if self._lib.gav_mux_write_stream(self._h, 1, buf, len(pkt.data),
                                          pkt.pts, dts, int(pkt.key)) < 0:
            raise IOError(f"audio mux write: {native.last_error()}")

    def close(self):
        if getattr(self, "_h", None):
            self._lib.gav_mux_close(self._h)
            self._h = None

    __del__ = close
    def __enter__(self): return self
    def __exit__(self, *a): self.close()


class AvMuxer:
    """Video + optional audio muxer (LazyMuxer analog with both lanes)."""

    def __init__(self, path: str, width: int, height: int, fps, vcodec: int,
                 vextra: bytes = b"", acodec_id: int = 0,
                 sample_rate: int = 0, channels: int = 0,
                 aextra: bytes = b""):
        self._lib = native.load()
        ve = ((ctypes.c_ubyte * len(vextra)).from_buffer_copy(vextra)
              if vextra else None)
        ae = ((ctypes.c_ubyte * len(aextra)).from_buffer_copy(aextra)
              if aextra else None)
        self._h = self._lib.gav_mux_open_av(
            path.encode(), width, height, fps[0], fps[1], vcodec, ve,
            len(vextra), acodec_id, sample_rate, channels, ae, len(aextra))
        if not self._h:
            raise IOError(f"mux open: {native.last_error()}")

    def write_video(self, pkt: Packet):
        self._write(0, pkt)

    def write_audio(self, pkt: Packet):
        self._write(1, pkt)

    def _write(self, stream: int, pkt: Packet):
        buf = (ctypes.c_ubyte * len(pkt.data)).from_buffer_copy(pkt.data)
        dts = pkt.dts if pkt.dts is not None else pkt.pts
        if self._lib.gav_mux_write_stream(self._h, stream, buf,
                                          len(pkt.data), pkt.pts, dts,
                                          int(pkt.key)) < 0:
            raise IOError(f"mux write: {native.last_error()}")

    def close(self):
        if getattr(self, "_h", None):
            self._lib.gav_mux_close(self._h)
            self._h = None

    __del__ = close
