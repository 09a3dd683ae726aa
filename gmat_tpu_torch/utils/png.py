"""Minimal PNG writer/reader — the depth-faithful RGB still sink; a copy
of `gmat_tpu/utils/png.py` (stdlib and numpy only).

The reference CLI can emit 16-bit-per-sample stills from high-depth
pipelines (ffmpeg's png encoder with rgb48be output — the reference
tree carries it at ffmpeg-gpu/libavcodec/pngenc.c:1174-1206 pix_fmts);
our jpeg sink is 8-bit only, so RGB-domain graph outputs used to lose
depth on disk (PARITY "Known gaps").  Pure stdlib (zlib + struct): 8-
or 16-bit, gray or RGB(A), filter type 0, one IDAT on write; the
reader handles all five filters (Sub/Up vectorized — the common
adaptive choices; Average/Paeth are inherently serial per pixel).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(typ: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + typ + payload
            + struct.pack(">I", zlib.crc32(typ + payload) & 0xFFFFFFFF))


_COLOR = {1: 0, 2: 4, 3: 2, 4: 6}      # channels -> PNG color type


def write_png(path_or_file, arr: np.ndarray) -> None:
    """arr: (H, W) or (H, W, C) uint8/uint16, C in {1, 2, 3, 4}.
    uint16 samples are written as 16-bit PNG (big-endian per spec)."""
    a = np.asarray(arr)
    if a.ndim == 2:
        a = a[:, :, None]
    if a.ndim != 3 or a.shape[2] not in _COLOR:
        raise ValueError(f"write_png expects (H,W[,C<=4]), got {a.shape}")
    if a.dtype == np.uint8:
        depth = 8
    elif a.dtype == np.uint16:
        depth = 16
        a = a.astype(">u2")            # network byte order per spec
    else:
        raise ValueError(f"write_png expects uint8/uint16, got {a.dtype}")
    h, w, c = a.shape
    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOR[c], 0, 0, 0)
    raw = a.tobytes()
    stride = w * c * (depth // 8)
    scan = b"".join(b"\x00" + raw[y * stride:(y + 1) * stride]
                    for y in range(h))
    data = (_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(scan, 6))
            + _chunk(b"IEND", b""))
    if hasattr(path_or_file, "write"):
        path_or_file.write(data)
    else:
        with open(path_or_file, "wb") as f:
            f.write(data)


def _unfilter(ftype: int, cur: bytearray, prev: bytes, bpp: int) -> None:
    n = len(cur)
    if ftype == 0:
        return
    if ftype == 1:                      # Sub: per-lane prefix sum
        a = np.frombuffer(bytes(cur), np.uint8)
        out = np.empty_like(a)
        for l in range(bpp):
            lane = a[l::bpp].astype(np.uint32)
            out[l::bpp] = (np.cumsum(lane) & 0xFF).astype(np.uint8)
        cur[:] = out.tobytes()
    elif ftype == 2:                    # Up: one vector add
        a = np.frombuffer(bytes(cur), np.uint8)
        p = np.frombuffer(prev, np.uint8)
        cur[:] = ((a.astype(np.uint16) + p) & 0xFF).astype(
            np.uint8).tobytes()
    elif ftype == 3:                    # Average
        for i in range(n):
            left = cur[i - bpp] if i >= bpp else 0
            cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
    elif ftype == 4:                    # Paeth
        for i in range(n):
            left = cur[i - bpp] if i >= bpp else 0
            ul = prev[i - bpp] if i >= bpp else 0
            p = left + prev[i] - ul
            pa, pb, pc = abs(p - left), abs(p - prev[i]), abs(p - ul)
            pred = left if (pa <= pb and pa <= pc) else \
                (prev[i] if pb <= pc else ul)
            cur[i] = (cur[i] + pred) & 0xFF
    else:
        raise IOError(f"png: unknown filter {ftype}")


def read_png(path_or_bytes) -> np.ndarray:
    """-> (H, W) or (H, W, C) uint8/uint16.  Non-interlaced only."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        d = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            d = f.read()
    if d[:8] != _SIG:
        raise IOError("not a PNG")
    pos, idat, ihdr = 8, b"", None
    while pos + 8 <= len(d):
        ln, typ = struct.unpack(">I4s", d[pos:pos + 8])
        payload = d[pos + 8:pos + 8 + ln]
        if typ == b"IHDR":
            if len(payload) < 13:
                raise IOError("png: truncated IHDR")
            ihdr = struct.unpack(">IIBBBBB", payload[:13])
        elif typ == b"IDAT":
            idat += payload
        elif typ == b"IEND":
            break
        pos += 12 + ln
    if ihdr is None:
        raise IOError("png: no IHDR")
    w, h, depth, color, comp, filt, ilace = ihdr
    if ilace:
        raise IOError("png: interlaced not supported")
    chans = {0: 1, 2: 3, 4: 2, 6: 4}.get(color)
    if chans is None or depth not in (8, 16):
        raise IOError(f"png: unsupported color/depth {color}/{depth}")
    if not (0 < w <= 1 << 24 and 0 < h <= 1 << 24):
        raise IOError(f"png: implausible dimensions {w}x{h}")
    try:
        raw = zlib.decompress(idat)
    except zlib.error as e:              # corrupt/empty IDAT: the
        raise IOError(f"png: bad IDAT ({e})")  # module's error contract
    bpp = max(1, chans * depth // 8)
    stride = w * chans * (depth // 8)
    # header-declared dims must match the decompressed payload: a
    # corrupted IHDR would otherwise index past `raw` (or allocate
    # multi-GB rows) — untrusted input gets a clean error instead
    if len(raw) < h * (stride + 1):
        raise IOError(f"png: IDAT holds {len(raw)} bytes, {w}x{h} needs "
                      f"{h * (stride + 1)} — truncated or corrupt header")
    out = bytearray()
    prev = bytes(stride)
    for y in range(h):
        off = y * (stride + 1)
        cur = bytearray(raw[off + 1:off + 1 + stride])
        _unfilter(raw[off], cur, prev, bpp)
        out += cur
        prev = bytes(cur)
    dt = np.dtype(">u2") if depth == 16 else np.uint8
    a = np.frombuffer(bytes(out), dt).reshape(h, w, chans)
    a = a.astype(np.uint16) if depth == 16 else a
    return a[:, :, 0] if chans == 1 else a
