"""Raw YUV file IO: Y4M (YUV4MPEG2) and headerless NV12/I420 files.

The reference's test fixtures are raw `bunny.nv12` / `bunny.iyuv` dumps
(metrans/Makefile:108-115 data target) and its samples read/write them
directly; Y4M adds the self-describing variant.  Pure Python.
"""
from __future__ import annotations

import os
import re
from typing import Iterator, Optional, Tuple

import numpy as np


class Y4MReader:
    def __init__(self, path: str):
        self.f = open(path, "rb")
        header = self.f.readline().decode("ascii", "replace").strip()
        if not header.startswith("YUV4MPEG2"):
            raise IOError(f"{path}: not a Y4M file")
        self.width = self.height = 0
        self.fps = (30, 1)
        self.colorspace = "420"
        for tok in header.split()[1:]:
            if tok[0] == "W":
                self.width = int(tok[1:])
            elif tok[0] == "H":
                self.height = int(tok[1:])
            elif tok[0] == "F":
                n, d = tok[1:].split(":")
                self.fps = (int(n), int(d))
            elif tok[0] == "C":
                self.colorspace = tok[1:]
        self.bits = 8
        base = self.colorspace
        for depth in (10, 12, 16):
            suffix = f"p{depth}"
            if base.endswith(suffix):
                self.bits = depth
                base = base[:-len(suffix)]
                break
        if base not in ("420", "420jpeg", "420mpeg2", "420paldv"):
            # 422/444 not supported (nothing downstream consumes them)
            raise IOError(f"unsupported Y4M chroma C{self.colorspace}")
        if not (self.width and self.height):
            raise IOError("Y4M missing dimensions")
        if (self.width | self.height) & 1:
            # 4:2:0 frame payload size is ambiguous for odd dims (skip()
            # and frames() would disagree and desynchronize after -ss)
            raise IOError(f"odd Y4M dimensions {self.width}x"
                          f"{self.height} are invalid for C420")

    def _frame_bytes(self) -> int:
        bpp = 1 if self.bits == 8 else 2
        return (self.width * self.height * 3 // 2) * bpp

    def skip(self, n: int) -> int:
        """Skip n frames in O(1) per frame (marker line + one seek each;
        no payload reads).  Returns the number actually skipped."""
        nbytes = self._frame_bytes()
        done = 0
        while done < n:
            line = self.f.readline()
            if not line:
                break
            if not line.startswith(b"FRAME"):
                raise IOError(f"bad Y4M frame marker: {line[:20]!r}")
            self.f.seek(nbytes, 1)
            done += 1
        self._idx = getattr(self, "_idx", 0) + done
        return done

    def frames(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray, int]]:
        w, h = self.width, self.height
        dt = np.uint8 if self.bits == 8 else np.uint16   # y4m is LE = native
        bpp = dt().itemsize
        ysz, csz = w * h, (w // 2) * (h // 2)
        nbytes = (ysz + 2 * csz) * bpp
        i = getattr(self, "_idx", 0)
        while True:
            line = self.f.readline()
            if not line:
                return
            if not line.startswith(b"FRAME"):
                raise IOError(f"bad Y4M frame marker: {line[:20]!r}")
            buf = self.f.read(nbytes)
            if len(buf) < nbytes:
                return
            y = np.frombuffer(buf, dt, ysz).reshape(h, w)
            u = np.frombuffer(buf, dt, csz, ysz * bpp).reshape(h // 2, w // 2)
            v = np.frombuffer(buf, dt, csz,
                              (ysz + csz) * bpp).reshape(h // 2, w // 2)
            yield y, u, v, i
            i += 1

    def close(self):
        self.f.close()


class Y4MWriter:
    def __init__(self, path: str, width: int, height: int,
                 fps: Tuple[int, int] = (30, 1), bits: int = 8):
        if bits not in (8, 10, 12, 16):
            raise ValueError(f"y4m depth must be 8/10/12/16, got {bits}")
        self.bits = bits
        cs = "C420jpeg" if bits == 8 else f"C420p{bits}"
        self.f = open(path, "wb")
        self.f.write(f"YUV4MPEG2 W{width} H{height} "
                     f"F{fps[0]}:{fps[1]} Ip A1:1 {cs}\n".encode())

    def write(self, y: np.ndarray, u: np.ndarray, v: np.ndarray):
        dt = np.uint8 if self.bits == 8 else np.uint16  # y4m LE = native
        self.f.write(b"FRAME\n")
        self.f.write(np.ascontiguousarray(y, dt).tobytes())
        self.f.write(np.ascontiguousarray(u, dt).tobytes())
        self.f.write(np.ascontiguousarray(v, dt).tobytes())

    def close(self):
        self.f.close()


class RawYUVReader:
    """Headerless NV12 / I420 file (dimensions supplied by the caller)."""

    def __init__(self, path: str, width: int, height: int,
                 layout: str = "i420"):
        if layout not in ("i420", "nv12"):
            raise ValueError("layout must be i420 or nv12")
        self.f = open(path, "rb")
        self.width, self.height, self.layout = width, height, layout
        self.frame_size = width * height * 3 // 2

    def skip(self, n: int) -> int:
        """Skip n frames with a single seek (fixed frame size)."""
        end = os.fstat(self.f.fileno()).st_size
        here = self.f.tell()
        n = max(0, min(n, (end - here) // self.frame_size))
        self.f.seek(n * self.frame_size, 1)
        self._idx = getattr(self, "_idx", 0) + n
        return n

    def frames(self):
        w, h = self.width, self.height
        i = getattr(self, "_idx", 0)
        while True:
            buf = self.f.read(self.frame_size)
            if len(buf) < self.frame_size:
                return
            y = np.frombuffer(buf, np.uint8, w * h).reshape(h, w)
            if self.layout == "i420":
                c = (w // 2) * (h // 2)
                u = np.frombuffer(buf, np.uint8, c, w * h).reshape(h // 2, w // 2)
                v = np.frombuffer(buf, np.uint8, c, w * h + c).reshape(h // 2, w // 2)
            else:
                uv = np.frombuffer(buf, np.uint8, w * h // 2, w * h)
                uv = uv.reshape(h // 2, w // 2, 2)
                u, v = uv[..., 0].copy(), uv[..., 1].copy()
            yield y, u, v, i
            i += 1

    def close(self):
        self.f.close()


def write_raw(path: str, frames, layout: str = "i420"):
    with open(path, "wb") as f:
        for (y, u, v) in frames:
            f.write(np.ascontiguousarray(y, np.uint8).tobytes())
            if layout == "i420":
                f.write(np.ascontiguousarray(u, np.uint8).tobytes())
                f.write(np.ascontiguousarray(v, np.uint8).tobytes())
            else:
                uv = np.stack([u, v], -1).reshape(u.shape[0], -1)
                f.write(np.ascontiguousarray(uv, np.uint8).tobytes())
