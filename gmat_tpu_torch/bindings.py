"""Compatibility façade mirroring the reference's Python binding surface;
counterpart of `gmat_tpu/bindings.py`.

metrans ships ctypes classes (python/frame_extractor.py, heif_format.py,
swscale.py) over its C shims; users of those APIs find the same verbs
here, returning numpy values or torch tensors.  The device verbs run on
the card unless the constructor is given device="cpu":

    fx = FrameExtractor("in.mp4"); fx.set_frame_interval(30)
    arr = fx.extract_to_buffer()            # next frame, I420 numpy
    x = fx.extract_to_device_buffer()       # fused BGR-planar fp32 on card
    heif = HeifFormat(); blob = heif.encode(y, u, v); y2, u2, v2 = heif.decode(blob)
    rgb = Swscale(w, h).nv12_to_rgbpf32(nv12_bytes)
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class FrameExtractor:
    """python/frame_extractor.py analog (C ABI CFrameExtractor.cpp:6-51).

    Drop-in signatures: positional `src` OR the reference's
    `FrameExtractor(file_path=...)` / `FrameExtractor(buffer=...)`
    keywords (FrameExtractor_InitFromFile / _InitFromBuffer)."""

    def __init__(self, src=None, gpu: int = 0, file_path=None, buffer=None,
                 device="cuda"):
        from .av.extractor import FrameExtractor as _FX
        src = src if src is not None else (file_path or buffer)
        if src is None:
            raise ValueError("file_path or buffer is needed")
        self._fx = _FX(src)
        self._device = device
        self._it = None
        self.width, self.height = self._fx.width, self._fx.height

    def set_frame_interval(self, n: int):
        # the underlying extractor re-reads intervals every packet
        # (SetInterval semantics); resetting the generator here would
        # drop frames already decoded but not yet yielded
        self._fx.set_interval(frames=n)

    def set_time_interval(self, seconds: float):
        self._fx.set_interval(seconds=seconds)

    # reference getter verbs (frame_extractor.py:41-46)
    def get_width(self) -> int:
        return self.width

    def get_height(self) -> int:
        return self.height

    def get_frame_size(self) -> int:
        """Bytes of one I420/NV12 frame (FrameExtractor.h:207-209)."""
        return self.width * self.height * 3 // 2

    def _iter(self):
        if self._it is None:
            self._it = self._fx.frames()
        return self._it

    def extract(self):
        """-> (y, u, v, pts) numpy planes or None at EOF."""
        try:
            return next(self._iter())
        except StopIteration:
            return None

    def extract_to_buffer(self, out=None, stream=0) -> Optional[np.ndarray]:
        """-> contiguous I420 bytes as (H*3/2, W) numpy, like the
        reference's host-buffer path.  Pass `out` (any writable buffer of
        get_frame_size() bytes, e.g. a torch tensor's numpy view) to fill
        in place like the reference's pointer-filling verb."""
        f = self.extract()
        if f is None:
            return None
        y, u, v, _ = f
        h, w = y.shape
        if out is None:
            out = np.empty((h * 3 // 2, w), np.uint8)
        tgt = np.asarray(out).reshape(h * 3 // 2, w)
        tgt[:h] = y
        # chroma planes are contiguous after Y in I420 (h/2 rows of w total)
        tgt[h:] = np.concatenate([u.ravel(), v.ravel()]).reshape(h // 2, w)
        return out

    def extract_to_device_buffer(self, size=None, bgr: bool = True):
        """-> (3, H, W) fp32 planar on the device (the fused
        Nv12ToBgrFloatPlanar output, FrameExtractor.h:222-227)."""
        from .core.frame import from_numpy_yuv420
        from .ops import csc, fused
        f = self.extract()
        if f is None:
            return None
        y, u, v, _ = f
        fb = from_numpy_yuv420(y[None], u[None], v[None],
                               colorspace=self._fx.colorspace,
                               device=self._device)
        if size is not None:
            out = fused.preprocess(fb, size[0], size[1],
                                   "bgrpf32" if bgr else "rgbpf32")
        else:
            out = csc.convert(fb, "bgrpf32" if bgr else "rgbpf32")
        return csc.to_nchw(out)[0]

    def close(self):
        self._fx.close()


class ImageProvider:
    """NvDecoderImageProvider analog (samples/NvDecoderImageProvider.h:
    21-147): sequential decoded frames as packed BGRA/BGRA64/RGB images."""

    def __init__(self, path: str, fmt: str = "bgra", device="cuda"):
        from .av import toolkit as tk
        self._dm = tk.Demuxer(path)
        self._dec = tk.Decoder.from_demuxer(self._dm)
        # the reference's short names map onto the format registry
        self._fmt = {"rgb": "rgb24", "bgr": "bgr24"}.get(fmt, fmt)
        self._gen = self._frames()
        self._device = device
        self.width, self.height = self._dm.width, self._dm.height

    def _frames(self):
        for pkt in self._dm:
            if pkt.stream == 0:
                yield from self._dec.decode(pkt.data, pkt.pts)
        yield from self._dec.decode(None)

    def get_next(self):
        """-> (H, W, C) numpy image in the requested format, or None."""
        from .core.frame import from_numpy_yuv420
        from .ops import csc
        try:
            y, u, v, _ = next(self._gen)
        except StopIteration:
            return None
        fb = from_numpy_yuv420(y[None], u[None], v[None],
                               colorspace=self._dm.colorspace,
                               device=self._device)
        return csc.convert(fb, self._fmt).planes["rgb"][0].cpu().numpy()

    def close(self):
        self._dm.close()
        self._dec.close()


class HeifFormat:
    """python/heif_format.py analog (CHeif.cpp:20-133)."""

    def __init__(self, crf: float = 20.0, lossless: bool = False):
        self.crf, self.lossless = crf, lossless

    def encode(self, y, u, v) -> bytes:
        from .av import heif
        return heif.encode_still(y, u, v, crf=self.crf,
                                 lossless=self.lossless)

    def decode(self, data):
        from .av import heif
        return heif.decode_still(data)


class NvEncLite:
    """Reference heif_format.py NvEncLite (still HEVC encoder behind the
    HEIF writer, CHeif.cpp:31-43).  encode() takes I420 planes and
    returns the HEVC still packet bytes the writer consumes."""

    def __init__(self, width: int, height: int,
                 init_param: str = "-codec hevc -preset p1 -bitrate 4M"):
        if width == 0 or height == 0:
            raise ValueError("width and height cannot be 0")
        from .av import toolkit as tk
        from .utils.encparam import parse_enc_param
        self.w, self.h = width, height
        self._tk = tk
        # the reference's "-codec hevc -preset p1 -bitrate 4M" string
        # maps through NvEncoderParam (utils/encparam) — ignoring it
        # would silently encode at different settings than requested
        self._kw = {"codec_name": "libx265", "crf": 20.0}
        if init_param:
            # "-codec hevc -preset p1 -bitrate 4M" -> the colon form
            # parse_enc_param speaks ("codec=hevc:preset=p1:bitrate=4M")
            toks = init_param.split()
            pairs = ":".join(f"{k.lstrip('-')}={v}"
                             for k, v in zip(toks[::2], toks[1::2]))
            self._kw.update(parse_enc_param(pairs))
        base_opts = "x265-params=log-level=0"
        self._kw["opts"] = (base_opts + "," + self._kw["opts"]
                            if self._kw.get("opts") else base_opts)

    def encode_frame(self, y, u, v) -> bytes:
        # each still is an independent GOP-1 session: flushing drains a
        # libavcodec encoder for good, so a fresh instance per frame
        # keeps repeated encode_frame calls valid (the reference's NVENC
        # still sessions behave the same way, CHeif.cpp:31-43)
        kw = dict(self._kw)
        enc = self._tk.Encoder(kw.pop("codec_name"), self.w, self.h,
                               still_image=True, **kw)
        try:
            pkts = enc.encode(y, u, v, pts=0) + enc.flush()
            return enc.extradata() + b"".join(p.data for p in pkts)
        finally:
            enc.close()

    # the reference's device-frame verb: NV12 wire format in
    def encode_device_frame(self, nv12, vpkt=None) -> bytes:
        arr = np.asarray(nv12, np.uint8).reshape(self.h * 3 // 2, self.w)
        y = arr[:self.h]
        uv = arr[self.h:].reshape(self.h // 2, self.w // 2, 2)
        return self.encode_frame(y, np.ascontiguousarray(uv[..., 0]),
                                 np.ascontiguousarray(uv[..., 1]))

    def close(self):
        pass      # per-frame sessions close themselves in encode_frame


class NvDecLite:
    """Reference heif_format.py NvDecLite: still HEVC decode
    (CHeif.cpp:117-130)."""

    def decode_still(self, pkt_data, pkt_size=None):
        from .av import toolkit as tk
        data = bytes(pkt_data[:pkt_size]
                     if pkt_size is not None else pkt_data)
        dec = tk.Decoder(tk.CODEC_HEVC)
        frames = list(dec.decode(data)) + list(dec.decode(None))
        dec.close()
        if not frames:
            return None
        y, u, v, _ = frames[0]
        return y, u, v

    def close(self):
        pass


class NvHeifWriter:
    """Reference heif_format.py NvHeifWriter: HEVC still packet -> HEIF
    container bytes (NvHeifWriter.cpp writeStillImage)."""

    def write_stillimage(self, pkt: bytes):
        from .av import heif
        wtr = heif.HeifWriter()
        wtr.add_image(bytes(pkt))
        blob = wtr.tobytes()
        img_np = np.frombuffer(blob, np.uint8).copy()
        return img_np, len(blob)


class NvHeifReader:
    """Reference heif_format.py NvHeifReader: HEIF bytes -> HEVC still
    packet (NvHeifReader.cpp readImage)."""

    def __init__(self, img, size=None):
        if img is None:
            raise ValueError("input buffer cannot be empty")
        if isinstance(img, (bytes, bytearray, memoryview)):
            data = bytes(img)
        else:
            data = np.asarray(img, np.uint8).tobytes()
        self._blob = data[:size] if size is not None else data

    def read_image(self):
        from .av import heif
        rdr = heif.HeifReader(self._blob)
        pkt = rdr.read_image().to_annexb()
        return pkt, len(pkt)


class Swscale:
    """python/swscale.py analog (CSwscale.c:9-42): NV12 -> RGBPF32."""

    def __init__(self, width: int, height: int, colorspace: str = "bt709",
                 device="cuda"):
        self.width, self.height, self.colorspace = width, height, colorspace
        self.device = device

    def nv12_to_rgbpf32(self, nv12, norm: float = 1.0):
        """nv12: bytes or (H*3/2, W) array -> (3, H, W) fp32 tensor on the
        device."""
        from .core.frame import to_device, unpack_nv12
        from .ops import csc
        if isinstance(nv12, (bytes, bytearray)):
            nv12 = np.frombuffer(bytes(nv12), np.uint8).reshape(
                self.height * 3 // 2, self.width)
        data = to_device(np.asarray(nv12, np.uint8), self.device)
        fb = unpack_nv12(data[None], self.height, self.width,
                         self.colorspace)
        out = csc.yuv_to_rgb(fb, "rgbpf32", norm=norm)
        return csc.to_nchw(out)[0]


# reference demo scripts import the CUDA-suffixed name (swscale.py:12)
SwscaleCuda = Swscale
