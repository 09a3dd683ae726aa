"""3DDFA-style pose / 3DMM regression — counterpart of
`gmat_tpu/models/pose.py`.

Strided 3x3 convs ("SAME", stride 2, ReLU), a global average pool and a
62-wide linear head (doc/3DDFA_filter.md: 120x120 RGB in, 62 3DMM
parameters out).  Params: {"convs": [{"w", "b"}, ...], "head_w",
"head_b"}.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import conv, dense_head, generator, he_normal

N_PARAMS = 62          # 3DMM params (12 pose + 40 shape + 10 expression)
INPUT_SIZE = 120       # doc/3DDFA_filter.md input crop


def init_params(gen: Optional[torch.Generator] = None,
                widths=(16, 32, 64, 128), dtype=torch.float32,
                device="cuda") -> Dict:
    gen = generator(0) if gen is None else gen
    params = {"convs": []}
    cin = 3
    for cout in widths:
        params["convs"].append({
            "w": he_normal(gen, (cout, cin, 3, 3), cin * 9, dtype, device),
            "b": torch.zeros(cout, dtype=dtype, device=device)})
        cin = cout
    params["head_w"] = he_normal(gen, (cin, N_PARAMS), cin, dtype, device,
                                 gain=1.0)
    params["head_b"] = torch.zeros(N_PARAMS, dtype=dtype, device=device)
    return params


def apply(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """x: (N, 3, H, W) f32 -> (N, 62) 3DMM parameters."""
    h = x
    for layer in params["convs"]:
        h = conv(h, layer["w"], layer["b"], stride=2, relu=True)
    h = torch.mean(h.float(), dim=(2, 3))     # global average pool
    return dense_head(h, params["head_w"], params["head_b"])
