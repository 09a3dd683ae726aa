"""Exact LUT application — counterpart of `gmat_tpu/ops/lut.py`.

The JAX module turns the lookup into a one-hot matmul on the TPU (its
gather path is slow there); on a GPU and a CPU a table gather is the
fast form, so this is one index gather in the table's dtype on the
indices' device.

Used by every per-channel table filter (eq, lut/lutyuv/lutrgb).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.frame import same_bits


def apply_lut(x: torch.Tensor, lut) -> torch.Tensor:
    """Return lut[x] exactly.  `x`: integer tensor (u8/u16/i32 indices,
    all in range); `lut`: 1-D table (numpy or tensor)."""
    tab = torch.as_tensor(np.ascontiguousarray(lut)
                          if not isinstance(lut, torch.Tensor) else lut,
                          device=x.device)
    idx = x.to(torch.int64)
    return same_bits(lambda t: t[idx], tab)
