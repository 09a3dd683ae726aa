"""The in-graph inference models — counterparts of `gmat_tpu/models/`.

Each model is a dict of tensors under the JAX package's keys (`w1, b1,
...` or lists of layer dicts), so `.npz` checkpoints load by key, and a
plain `apply(params, x)` on NCHW tensors.  The layers keep the JAX
models' numerics: inputs cast to the weight dtype, products accumulated
in f32, the bias (and ReLU) in f32, the result rounded back to the
weight dtype (bf16 params give the bf16 lane).

f32 convolutions never run in TF32: every fp32 layer runs under
`torch.backends.cudnn.flags(allow_tf32=False)` (the global flags are left
alone).  A bf16 layer convolves the bf16 values in f32 (exact products,
f32 sums), adds the f32 bias and rounds once, as XLA does.  On the card
it does so in TF32: a bf16 value has 7 stored mantissa bits and TF32 10,
so TF32's input rounding leaves the operands as they are, and the
tensor cores multiply them exactly and sum in f32.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def exact_f32(tf32: bool = False):
    """cuDNN on, TF32 off (or on, for operands that TF32 holds exactly),
    for the convolutions inside the block."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=tf32):
        yield


def generator(seed: int = 0) -> torch.Generator:
    """The host generator the models draw their random init from."""
    return torch.Generator().manual_seed(seed)


def he_normal(gen: torch.Generator, shape: Sequence[int], fan_in: int,
              dtype=torch.float32, device="cuda", gain: float = 2.0
              ) -> torch.Tensor:
    """N(0, 1) * sqrt(gain / fan_in), drawn on the host from `gen` so the
    same generator gives the same weights on every device."""
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32)
    w = w * np.float32(np.sqrt(gain / fan_in))
    return w.to(device=device, dtype=dtype)


def from_jax_params(tree, device="cuda"):
    """A JAX param pytree handed over as numpy (dicts, lists of layer
    dicts, arrays) -> the same tree of tensors on `device`."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_jax_params(v, device) for v in tree]
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":          # ml_dtypes bf16 from JAX
        return torch.as_tensor(arr.astype(np.float32), device=device).to(
            torch.bfloat16)
    return torch.tensor(arr, device=device)


def cast(tree, dtype):
    """Every float32 tensor of a param tree in `dtype`."""
    if isinstance(tree, dict):
        return {k: cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast(v, dtype) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.float32:
        return tree.to(dtype)
    return tree


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def same_pads(n: int, k: int, stride: int):
    """XLA's "SAME" padding of one axis: (low, high)."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
         stride: int = 1, pad: Optional[int] = None, relu: bool = False
         ) -> torch.Tensor:
    """One layer: x in w's dtype, f32 accumulation, + bias in f32,
    optional ReLU, rounded to w's dtype.  `pad` None is XLA "SAME"."""
    x = x.to(w.dtype)
    kh, kw = w.shape[2], w.shape[3]
    if pad is None:
        ph = same_pads(x.shape[2], kh, stride)
        pw = same_pads(x.shape[3], kw, stride)
    else:
        ph = pw = (pad, pad)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        padding = (ph[0], pw[0])
    else:
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        padding = (0, 0)
    if w.dtype == torch.float32:
        with exact_f32():
            out = F.conv2d(x, w, stride=stride, padding=padding)
    else:   # the bf16 values convolved in f32 (TF32 on the card)
        with exact_f32(tf32=x.is_cuda):
            out = F.conv2d(x.float(), w.float(), stride=stride,
                           padding=padding)
    out = out + b.float()[None, :, None, None]
    if relu:
        out = torch.relu(out)
    return out.to(w.dtype)


def dense_head(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
    """(N, C) f32 @ (C, K) + (K,) in f32, as a 1x1 convolution so that it
    runs under the same no-TF32 flags as the layers."""
    n, c = h.shape
    k = w.shape[1]
    with exact_f32():
        out = F.conv2d(h.float().reshape(n, c, 1, 1),
                       w.float().t().reshape(k, c, 1, 1))
    return out.reshape(n, k) + b.float()
