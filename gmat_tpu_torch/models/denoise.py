"""DnCNN residual denoiser — counterpart of `gmat_tpu/models/denoise.py`.

A same-size image -> image model for the reference's luma-only IO mode
(vf_tensorrt.c:206-217): a 3x3 conv stack (ReLU between layers) predicts
the noise residual; output = input - residual.  Params:
{"layers": [{"w", "b"}, ...]}.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import conv, generator, he_normal


def init_params(gen: Optional[torch.Generator] = None, channels: int = 1,
                hidden: int = 32, depth: int = 5, dtype=torch.float32,
                device="cuda") -> Dict:
    gen = generator(0) if gen is None else gen
    layers = []
    cin = channels
    for i in range(depth):
        cout = channels if i == depth - 1 else hidden
        layers.append({
            "w": he_normal(gen, (cout, cin, 3, 3), cin * 9, dtype, device),
            "b": torch.zeros(cout, dtype=dtype, device=device)})
        cin = cout
    return {"layers": layers}


def apply(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """x: (N, C, H, W) f32 in [0, 1] -> denoised, same shape."""
    h = x
    last = len(params["layers"]) - 1
    for i, layer in enumerate(params["layers"]):
        h = conv(h, layer["w"], layer["b"], pad=1, relu=i < last)
    return torch.clamp(x - h, 0.0, 1.0)      # residual learning
