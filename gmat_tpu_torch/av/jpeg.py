"""Host JPEG path: baseline encode/decode via libavcodec mjpeg — a copy
of `gmat_tpu/av/jpeg.py` (numpy and the port's toolkit; needs libav*).

This is the *host* half of the still-image story (used by the overlay
filter and as the oracle for the device DCT codec in ops/dct.py).
JPEG is full-range BT.601, which the device CSC (faithful to GMAT's
limited-range-only kernels, yuv2rgb_cuda.cu:782-849) doesn't cover, so
the JFIF conversion happens here in numpy.  Reference use: the nvjpeg
sample decodes stills to BGR the same way
(metrans/samples/AppNvjpegDec.cpp:24-67).
"""
from __future__ import annotations

import numpy as np

from . import toolkit as tk


def _rgb_to_yuvj420(rgb: np.ndarray):
    """Full-range BT.601 RGB->YUV 4:2:0 (JFIF)."""
    r = rgb[..., 0].astype(np.float32)
    g = rgb[..., 1].astype(np.float32)
    b = rgb[..., 2].astype(np.float32)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    h, w = y.shape

    def sub(c):
        return c.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))

    clip = lambda c: np.clip(np.round(c), 0, 255).astype(np.uint8)
    return clip(y), clip(sub(u)), clip(sub(v))


def _yuvj420_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray):
    h, w = y.shape

    def up(c):
        # odd luma dims: floor-sliced chroma doubles one row/col short —
        # edge-replicate to the luma geometry
        c2 = np.repeat(np.repeat(c, 2, 0), 2, 1)
        while c2.shape[0] < h:
            c2 = np.concatenate([c2, c2[-1:]], 0)
        while c2.shape[1] < w:
            c2 = np.concatenate([c2, c2[:, -1:]], 1)
        return c2[:h, :w]

    yf = y.astype(np.float32)
    uf = up(u).astype(np.float32) - 128.0
    vf = up(v).astype(np.float32) - 128.0
    r = yf + 1.402 * vf
    g = yf - 0.344136 * uf - 0.714136 * vf
    b = yf + 1.772 * uf
    rgb = np.stack([r, g, b], -1)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


def encode_rgb_to_jpeg(rgb: np.ndarray, quality: int = 3) -> bytes:
    """(H,W,3) uint8 -> JPEG bytes (quality = ffmpeg qscale, 2..31, lower
    is better)."""
    h, w = rgb.shape[:2]
    if h % 2 or w % 2:
        rgb = rgb[: h - h % 2, : w - w % 2]
        h, w = rgb.shape[:2]
    y, u, v = _rgb_to_yuvj420(rgb)
    enc = tk.Encoder("mjpeg", w, h, fps=(25, 1), crf=float(quality),
                     still_image=True)
    pkts = enc.encode(y, u, v, pts=0)
    pkts += enc.flush()
    enc.close()
    return b"".join(p.data for p in pkts)


def decode_jpeg_bytes(data: bytes):
    """JPEG bytes -> (y, u, v) full-range I420 planes."""
    dec = tk.Decoder(tk.CODEC_MJPEG)
    frames = list(dec.decode(data, 0))
    frames += list(dec.decode(None))
    dec.close()
    if not frames:
        raise IOError("mjpeg decode produced no frame")
    y, u, v, _ = frames[0]
    return y, u, v


def decode_jpeg_to_rgb(path_or_bytes) -> np.ndarray:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    y, u, v = decode_jpeg_bytes(data)
    return _yuvj420_to_rgb(y, u, v)
