"""FrameBatch — the device-side frame container, as a plain dataclass.

Counterpart of `gmat_tpu/core/frame.py`.  A batch carries dense planes
(N, h, w[, c]) as torch tensors on one device; everything else is plain
metadata.  No pytree protocol is needed: PyTorch runs eagerly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from . import formats as F

TORCH_DTYPES = {"uint8": torch.uint8, "uint16": torch.uint16,
                "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    """Torch dtype for a numpy dtype name of the format registry."""
    return TORCH_DTYPES[np.dtype(name).name]


def same_bits(fn, *planes, **kw) -> torch.Tensor:
    """fn(*planes, **kw) for planes of any dtype.  uint16 has few PyTorch
    kernels (no indexing on CUDA, no flip on the CPU); its int16 view holds
    the same bits, so a data-movement op (gather, cat, stack, flip,
    repeat, where) runs on that view and its result is viewed back."""
    if planes[0].dtype != torch.uint16:
        return fn(*planes, **kw)
    return fn(*(p.view(torch.int16) for p in planes), **kw).view(
        torch.uint16)


def set_channels(arr: torch.Tensor, order: str, new: dict) -> torch.Tensor:
    """A packed (..., C) tensor with the channels named in `new` (name ->
    tensor of any integer or float dtype) replaced, in `arr`'s dtype;
    `order` names arr's channels."""
    chans = [new[ch].to(arr.dtype) if ch in new else arr[..., i]
             for i, ch in enumerate(order)]
    return same_bits(lambda *c: torch.stack(c, dim=-1), *chans)


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """numpy -> tensor on `device`.  A CUDA device without a card raises:
    there is no silent CPU fallback."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run on the host")
    return torch.as_tensor(np.ascontiguousarray(arr), device=dev)


@dataclasses.dataclass
class FrameBatch:
    planes: Dict[str, torch.Tensor]   # name -> (N, h, w[, c]) tensor
    format: str                       # key into formats.FORMATS
    width: int                        # luma width
    height: int                       # luma height
    colorspace: str = "bt709"

    @classmethod
    def from_numpy(cls, planes: Dict[str, np.ndarray], format: str,
                   width: int, height: int, colorspace: str = "bt709",
                   device="cuda") -> "FrameBatch":
        """Build a batch from numpy planes (e.g. a JAX batch's
        `{k: np.asarray(v) for k, v in fb.planes.items()}`)."""
        return cls({k: to_device(v, device) for k, v in planes.items()},
                   format, width, height, colorspace).validate()

    @property
    def fmt(self) -> F.PixelFormat:
        return F.get(self.format)

    @property
    def batch(self) -> int:
        return next(iter(self.planes.values())).shape[0]

    @property
    def device(self) -> torch.device:
        return next(iter(self.planes.values())).device

    def plane(self, name: str) -> torch.Tensor:
        return self.planes[name]

    def validate(self) -> "FrameBatch":
        fmt = self.fmt
        n = self.batch
        for p in fmt.planes:
            arr = self.planes[p.name]
            want = (n,) + fmt.plane_shape(p.name, self.height, self.width)
            if tuple(arr.shape) != want:
                raise ValueError(
                    f"{self.format} plane {p.name}: shape "
                    f"{tuple(arr.shape)} != {want}")
            if torch_dtype(p.dtype) != arr.dtype:
                raise ValueError(
                    f"{self.format} plane {p.name}: dtype {arr.dtype} != "
                    f"{p.dtype}")
        return self

    def with_planes(self, planes: Dict[str, torch.Tensor],
                    fmt: Optional[str] = None, width: Optional[int] = None,
                    height: Optional[int] = None) -> "FrameBatch":
        return FrameBatch(
            planes, fmt or self.format,
            self.width if width is None else width,
            self.height if height is None else height,
            self.colorspace,
        )


def from_numpy_yuv420(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                      fmt: str = "yuv420p", colorspace: str = "bt709",
                      device="cuda") -> FrameBatch:
    if y.ndim == 2:
        y, u, v = y[None], u[None], v[None]
    h, w = y.shape[1], y.shape[2]
    return FrameBatch.from_numpy({"y": y, "u": u, "v": v}, fmt, w, h,
                                 colorspace, device)


def from_numpy_rgb(rgb: np.ndarray, fmt: str = "rgb24",
                   colorspace: str = "bt709", device="cuda") -> FrameBatch:
    if rgb.ndim == 3:
        rgb = rgb[None]
    h, w = rgb.shape[1], rgb.shape[2]
    return FrameBatch.from_numpy({"rgb": rgb}, fmt, w, h, colorspace, device)


def unpack_nv12(data: torch.Tensor, height: int, width: int,
                colorspace: str = "bt709") -> FrameBatch:
    """Wire-format NV12 (N, H*3//2, W) uint8 -> planar FrameBatch (views:
    Y is the top H rows, U/V the even/odd bytes of the interleaved rows)."""
    n = data.shape[0]
    y = data[:, :height, :]
    uv = data[:, height:, :].reshape(n, height // 2, width // 2, 2)
    return FrameBatch({"y": y, "u": uv[..., 0], "v": uv[..., 1]},
                      "nv12", width, height, colorspace)


def pack_nv12(fb: FrameBatch) -> torch.Tensor:
    """Planar FrameBatch -> wire-format NV12 (N, H*3//2, W) uint8."""
    n = fb.batch
    uv = torch.stack([fb.planes["u"], fb.planes["v"]], dim=-1)
    uv = uv.reshape(n, fb.height // 2, fb.width)
    return torch.cat([fb.planes["y"], uv], dim=1)
