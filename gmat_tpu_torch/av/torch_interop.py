"""Extracted frames as model input — counterpart of
`gmat_tpu/av/torch_interop.py`.

metrans hands decoded GPU frames to PyTorch as CUDA tensors
(python/frame_extractor.py:22-52, app_extract.py:5-30).  The port is
PyTorch already, so the frames go straight from `FrameExtractor` through
`ops/fused.preprocess_nchw` on the card: no DLPack hop, and no
`jax_to_torch` / `torch_to_jax` (there is no JAX array on either side).
"""
from __future__ import annotations

import numpy as np

from ..core.frame import from_numpy_yuv420
from ..ops import fused
from .extractor import FrameExtractor


def extract_to_torch(path: str, frame_interval: int = 0, out_size=None,
                     batch: int = 8, device="cuda"):
    """FrameExtractor -> NCHW f32 tensors on `device` (the
    frame_extractor.extract_to_device_buffer analog).

    Yields (tensor, pts) pairs; tensors are (n, 3, H, W) in [0, 1] where
    n == batch except for the final partial batch (n == its real frame
    count).  On the card the batch runs the ladder kernels; on the CPU
    the separate-op path.
    """
    fx = FrameExtractor(path, frame_interval=frame_interval)
    w, h = fx.width, fx.height
    out_w, out_h = out_size or (w, h)
    try:
        while True:
            b = fx.extract_batch(batch)
            if b is None:
                return
            ys, us, vs, pts = b
            valid = ys.shape[0]
            if valid < batch:
                # pad the tail to the steady-state batch shape, as the
                # JAX package does, so every call sees one geometry
                pad = batch - valid
                ys = np.concatenate([ys, np.repeat(ys[-1:], pad, 0)])
                us = np.concatenate([us, np.repeat(us[-1:], pad, 0)])
                vs = np.concatenate([vs, np.repeat(vs[-1:], pad, 0)])
            fb = from_numpy_yuv420(ys, us, vs, colorspace=fx.colorspace,
                                   device=device)
            yield fused.preprocess_nchw(fb, out_w, out_h)[:valid], pts
    finally:
        fx.close()
