"""Small conv classifier — counterpart of `gmat_tpu/models/classify.py`.

decode -> 224x224 RGB NCHW -> content tagging, the vector-output model of
the tensorrt filter's inference pipelines: four strided 3x3 conv blocks
(stride 2, ReLU), a global average pool and a linear head; the logits
land in `InferFilter.last_output`.  Params: {"layers": [{"w", "b"}, ...],
"head_w", "head_b"} (flat head keys, as the npz loader expects).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import conv, dense_head, generator, he_normal


def init_params(gen: Optional[torch.Generator] = None,
                num_classes: int = 1000, widths=(32, 64, 128, 256),
                dtype=torch.float32, device="cuda") -> Dict:
    gen = generator(0) if gen is None else gen
    layers = []
    cin = 3
    for cout in widths:
        layers.append({
            "w": he_normal(gen, (cout, cin, 3, 3), cin * 9, dtype, device),
            "b": torch.zeros(cout, dtype=dtype, device=device)})
        cin = cout
    return {"layers": layers,
            "head_w": he_normal(gen, (cin, num_classes), cin, dtype, device,
                                gain=1.0),
            "head_b": torch.zeros(num_classes, dtype=dtype, device=device)}


def apply(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """x: (N, 3, H, W) f32 in [0, 1] -> (N, num_classes) logits."""
    h = x
    for layer in params["layers"]:
        h = conv(h, layer["w"], layer["b"], stride=2, relu=True)
    h = torch.mean(h.float(), dim=(2, 3))     # global average pool
    return dense_head(h, params["head_w"], params["head_b"])
