"""Pixel format registry — a numpy-only copy of `gmat_tpu/core/formats.py`.

The port keeps its own copy so that it never imports the JAX package; the
two are held equal entry by entry in `tests/test_torch_core.py`.

Covers the formats the reference converts between (libswscale/cuda/
yuv2rgb_cuda.cu:862-947, yuv2yuv_cuda.cu, libavutil/pixfmt.h:315-316 for the
GMAT-added RGBPF32/RGBAPF32), expressed as *device-friendly planar batches*:

  - Interleaved/pitched NV12 is a wire format, not a compute format.
    Ingest unpacks every frame into per-plane dense tensors (N, H, W);
    packed RGB lives as (N, H, W, C).
  - 10/16-bit YUV ("P010"/"P016" style, values in the high bits of u16)
    keeps the reference's convention: a 10-bit sample x is stored as x<<6.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class PlaneDesc:
    name: str            # "y" | "u" | "v" | "uv" | "rgb" | ...
    sub_w: int           # width subsample shift (log2)
    sub_h: int           # height subsample shift
    channels: int        # trailing channel dim (1 = none)
    dtype: str           # numpy dtype name


@dataclasses.dataclass(frozen=True)
class PixelFormat:
    name: str
    planes: Tuple[PlaneDesc, ...]
    bits: int            # significant bits per sample
    is_rgb: bool
    channel_order: str = ""   # for packed RGB: "rgb", "bgr", "rgba", ...
    is_float: bool = False
    planar_rgb: bool = False

    @property
    def is_yuv(self) -> bool:
        return not self.is_rgb

    def plane(self, name: str) -> PlaneDesc:
        for p in self.planes:
            if p.name == name:
                return p
        raise KeyError(f"{self.name} has no plane {name!r}")

    def plane_shape(self, name: str, h: int, w: int):
        p = self.plane(name)
        shape = (h >> p.sub_h, w >> p.sub_w)
        if p.channels > 1:
            shape = shape + (p.channels,)
        return shape


def _yuv420(name, dtype, bits):
    return PixelFormat(
        name=name,
        planes=(
            PlaneDesc("y", 0, 0, 1, dtype),
            PlaneDesc("u", 1, 1, 1, dtype),
            PlaneDesc("v", 1, 1, 1, dtype),
        ),
        bits=bits,
        is_rgb=False,
    )


def _yuv422(name, dtype, bits):
    return PixelFormat(
        name=name,
        planes=(
            PlaneDesc("y", 0, 0, 1, dtype),
            PlaneDesc("u", 1, 0, 1, dtype),
            PlaneDesc("v", 1, 0, 1, dtype),
        ),
        bits=bits,
        is_rgb=False,
    )


def _yuv444(name, dtype, bits):
    return PixelFormat(
        name=name,
        planes=(
            PlaneDesc("y", 0, 0, 1, dtype),
            PlaneDesc("u", 0, 0, 1, dtype),
            PlaneDesc("v", 0, 0, 1, dtype),
        ),
        bits=bits,
        is_rgb=False,
    )


def _packed_rgb(name, order, dtype, bits):
    return PixelFormat(
        name=name,
        planes=(PlaneDesc("rgb", 0, 0, len(order), dtype),),
        bits=bits,
        is_rgb=True,
        channel_order=order,
    )


FORMATS = {}


def _register(fmt: PixelFormat) -> PixelFormat:
    FORMATS[fmt.name] = fmt
    return fmt


# --- YUV (planar on device; "nv12"/"p016" name the *wire* layout) ----------
NV12 = _register(_yuv420("nv12", "uint8", 8))
YUV420P = _register(_yuv420("yuv420p", "uint8", 8))
P010 = _register(_yuv420("p010", "uint16", 10))    # samples stored << 6
P016 = _register(_yuv420("p016", "uint16", 16))
YUV420P10 = _register(_yuv420("yuv420p10", "uint16", 10))  # lsb-aligned
YUV420P16 = _register(_yuv420("yuv420p16", "uint16", 16))
YUV422P = _register(_yuv422("yuv422p", "uint8", 8))  # camera/JPEG 4:2:2
YUV444P = _register(_yuv444("yuv444p", "uint8", 8))
YUV444P10 = _register(_yuv444("yuv444p10", "uint16", 10))  # lsb-aligned
YUV444P16 = _register(_yuv444("yuv444p16", "uint16", 16))
GRAY8 = _register(PixelFormat("gray8", (PlaneDesc("y", 0, 0, 1, "uint8"),),
                              8, is_rgb=False))
# lsb-aligned >8-bit gray (AV_PIX_FMT_GRAY10/16LE): the extractplanes
# output formats for 10/16-bit sources (vf_extractplanes.c:150-199)
GRAY10 = _register(PixelFormat("gray10", (PlaneDesc("y", 0, 0, 1, "uint16"),),
                               10, is_rgb=False))
GRAY16 = _register(PixelFormat("gray16", (PlaneDesc("y", 0, 0, 1, "uint16"),),
                               16, is_rgb=False))

# --- RGB --------------------------------------------------------------------
RGB24 = _register(_packed_rgb("rgb24", "rgb", "uint8", 8))
BGR24 = _register(_packed_rgb("bgr24", "bgr", "uint8", 8))
RGBA = _register(_packed_rgb("rgba", "rgba", "uint8", 8))
BGRA = _register(_packed_rgb("bgra", "bgra", "uint8", 8))
RGBA64 = _register(_packed_rgb("rgba64", "rgba", "uint16", 16))
BGRA64 = _register(_packed_rgb("bgra64", "bgra", "uint16", 16))
# rgb48/bgr48: the alpha-less 16-bit pair the user guide names for the
# 10-bit lane ("p010/yuv420p10 <-> rgb48/rgba64",
# doc/FFMPEG-GPU_User_Guide.md:52)
RGB48 = _register(_packed_rgb("rgb48", "rgb", "uint16", 16))
BGR48 = _register(_packed_rgb("bgr48", "bgr", "uint16", 16))

# GMAT-added float 'planar' formats (libavutil/pixfmt.h:315-316).
# NOTE: FrameBatch storage is channels-LAST (h, w, c) like every other
# RGB format here; the NCHW planar wire layout exists only past
# csc.to_nchw (the DL-model handoff).  planar_rgb records the
# reference-format semantic for that conversion, NOT the storage.
RGBPF32 = _register(PixelFormat(
    "rgbpf32", (PlaneDesc("rgb", 0, 0, 3, "float32"),), 32,
    is_rgb=True, channel_order="rgb", is_float=True, planar_rgb=True))
RGBAPF32 = _register(PixelFormat(
    "rgbapf32", (PlaneDesc("rgb", 0, 0, 4, "float32"),), 32,
    is_rgb=True, channel_order="rgba", is_float=True, planar_rgb=True))
BGRPF32 = _register(PixelFormat(
    "bgrpf32", (PlaneDesc("rgb", 0, 0, 3, "float32"),), 32,
    is_rgb=True, channel_order="bgr", is_float=True, planar_rgb=True))


def get(name: str) -> PixelFormat:
    try:
        return FORMATS[name]
    except KeyError:
        raise ValueError(f"unknown pixel format {name!r}; known: {sorted(FORMATS)}")


def max_value(fmt: PixelFormat) -> int:
    """Max code value for integer formats (full container range for P01x)."""
    if fmt.is_float:
        return 1
    container_bits = np.dtype(fmt.planes[0].dtype).itemsize * 8
    return (1 << container_bits) - 1


def clip_value(fmt: PixelFormat) -> int:
    """Max legal sample for clipping after resampling: lsb-aligned
    formats clip at their TRUE bit depth (bicubic/lanczos overshoot on a
    yuv420p10 plane must not leave samples above 1023 that wrap when
    shifted into p010); the msb-aligned wire formats (p010/p016) use the
    full container like the reference's texture kernels."""
    if fmt.is_float:
        return 1
    if fmt.name in ("p010", "p016"):
        return max_value(fmt)
    return (1 << fmt.bits) - 1
