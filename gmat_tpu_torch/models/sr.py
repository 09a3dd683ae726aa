"""ESPCN super-resolution — counterpart of `gmat_tpu/models/sr.py`.

conv 5x5 -> conv 3x3 -> conv 3x3 to r^2*C channels -> pixel shuffle
(depth-to-space), NCHW like the RGBPF32 tensors the reference's TensorRT
filter binds (tensorrt.cpp:586-631).  Params are a dict of tensors under
the JAX keys (w1, b1, w2, b2, w3, b3).

The random init draws the JAX shapes and He scales from a
`torch.Generator` (seed 0 by default); `jax.random` draws cannot be
reproduced, so parity with the JAX package goes through
`models.from_jax_params` or a checkpoint.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import conv, generator, he_normal


def init_params(gen: Optional[torch.Generator] = None, scale: int = 2,
                channels: int = 3, hidden: int = 64,
                dtype=torch.float32, device="cuda") -> Dict:
    gen = generator(0) if gen is None else gen
    shapes = {"w1": (hidden, channels, 5, 5),
              "w2": (hidden // 2, hidden, 3, 3),
              "w3": (channels * scale * scale, hidden // 2, 3, 3)}
    params = {}
    for i, (name, shape) in enumerate(shapes.items(), 1):
        params[name] = he_normal(gen, shape, shape[1] * shape[2] * shape[3],
                                 dtype, device)
        params[f"b{i}"] = torch.zeros(shape[0], dtype=dtype, device=device)
    return params


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(N, C*r^2, H, W) -> (N, C, H*r, W*r) depth-to-space (the JAX
    reshape/transpose order is F.pixel_shuffle's)."""
    return F.pixel_shuffle(x, r)


def scale_of(params: Dict, channels: int = 3) -> int:
    """The upscale factor, from the w3 shape."""
    rr = params["w3"].shape[0] // channels
    return int(np.sqrt(rr))


def _forward(params: Dict, x: torch.Tensor) -> torch.Tensor:
    r = scale_of(params, x.shape[1])
    h = conv(x, params["w1"], params["b1"], pad=2, relu=True)
    h = conv(h, params["w2"], params["b2"], pad=1, relu=True)
    h = conv(h, params["w3"], params["b3"], pad=1)
    return pixel_shuffle(h, r)


def apply(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """x: (N, C, H, W) f32 in [0, 1] -> (N, C, H*r, W*r)."""
    return torch.clamp(_forward(params, x), 0.0, 1.0)


def loss_fn(params: Dict, x_lr: torch.Tensor, y_hr: torch.Tensor
            ) -> torch.Tensor:
    """Mean squared error of the UNclipped forward: the inference clip
    would zero the gradient of every saturated pixel."""
    pred = _forward(params, x_lr)
    return torch.mean((pred - y_hr) ** 2)
