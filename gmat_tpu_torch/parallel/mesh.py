"""Device mesh / sharding helpers — the multi-device scale-out layer.

Counterpart of `gmat_tpu/parallel/mesh.py`.  The reference scales by
running N processes with a `-gpu` ordinal (AppSelect.cpp:49-56) and host
threads per session (AppMeTrans.cpp:342-344).  The JAX package lays
frames out as SPMD over one `jax.sharding.Mesh`; the port's idiom is
explicit devices: a `Mesh` is an (n_data, n_model) array of
`torch.device`s, frames are the embarrassingly-parallel "data" axis, and
the orthogonal "model" axis carries tensor-parallel in-graph inference
(`shard_sr_params` + `sr_apply_tp`) when a model outgrows one device.

A device may repeat: the CPU tests lay an (4, 2) mesh over eight `cpu`
entries, and one card can hold a (2, 2) mesh of `cuda:0`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.frame import FrameBatch

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """An (n_data, n_model) grid of devices.  `process_index` says which
    process owns each entry (all 0 for a single-process mesh)."""

    def __init__(self, devices: np.ndarray,
                 process_index: Optional[np.ndarray] = None):
        self.devices = devices
        self.process_index = (np.zeros(devices.shape, np.int64)
                              if process_index is None else process_index)

    @property
    def shape(self) -> Dict[str, int]:
        n_data, n_model = self.devices.shape
        return {DATA_AXIS: n_data, MODEL_AXIS: n_model}

    def row_device(self, row: int) -> torch.device:
        """The device a data row's frames and results live on."""
        return self.devices[row, 0]


def _grid(devices: Sequence, n_data: int, n_model: int) -> np.ndarray:
    grid = np.empty((n_data, n_model), object)
    for i, d in enumerate(devices[:n_data * n_model]):
        grid[i // n_model, i % n_model] = torch.device(d)
    return grid


def local_devices() -> List[torch.device]:
    """Every card of this machine; none is an error (no silent CPU
    fallback: pass `devices` to lay a mesh over the host)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: torch.cuda.is_available() is false; pass "
            "devices=[torch.device('cpu')] * n to lay a mesh on the host")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    devices = list(devices if devices is not None else local_devices())
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data * n_model > len(devices) or n_data < 1:
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs "
                         f"{n_data * n_model} devices, got {len(devices)}")
    return Mesh(_grid(devices, n_data, n_model))


def _split(t: torch.Tensor, n: int) -> List[torch.Tensor]:
    if t.shape[0] % n:
        raise ValueError(f"batch of {t.shape[0]} frames does not split "
                         f"over {n} data rows")
    return list(torch.chunk(t, n, dim=0)) if n > 1 else [t]


def shard_batch(fb: FrameBatch, mesh: Mesh) -> List[FrameBatch]:
    """Split every plane's leading (frame) axis over the data axis: one
    FrameBatch per data row, on that row's device."""
    n = mesh.shape[DATA_AXIS]
    parts = {k: _split(v, n) for k, v in fb.planes.items()}
    return [fb.with_planes({k: p[i].to(mesh.row_device(i), non_blocking=True)
                            for k, p in parts.items()}) for i in range(n)]


def shard_sr_params(params: dict, mesh: Mesh) -> List[List[dict]]:
    """Tensor-parallel layout for the SR model: the hidden dimension is
    split on the model axis where it appears ONCE per tensor — w1/b1 on
    their out-channel axis, w2 on its in-channel axis; w3 and the later
    biases are replicated (w2's out channels are the narrow hidden//2).

    Returns `placed[row][col]`, the parameter dict of mesh entry (row,
    col) on its device: column j holds its slice of w1, b1 and w2; b2, w3
    and b3 live in column 0 only, where `sr_apply_tp` sums the columns'
    partial layer-2 outputs (the all-reduce XLA inserts by itself).
    """
    n_data, n_model = mesh.devices.shape
    hidden = params["w1"].shape[0]
    if hidden % n_model:
        raise ValueError(f"hidden width {hidden} does not split over "
                         f"{n_model} model columns")
    w1 = torch.chunk(params["w1"], n_model, dim=0)
    b1 = torch.chunk(params["b1"], n_model, dim=0)
    w2 = torch.chunk(params["w2"], n_model, dim=1)
    placed = []
    for r in range(n_data):
        row = []
        for c in range(n_model):
            dev = mesh.devices[r, c]
            part = {"w1": w1[c], "b1": b1[c], "w2": w2[c]}
            if c == 0:
                part.update(b2=params["b2"], w3=params["w3"],
                            b3=params["b3"])
            row.append({k: v.detach().to(dev).clone()
                        for k, v in part.items()})
        placed.append(row)
    return placed


def gather_sr_params(placed: List[List[dict]], row: int = 0) -> dict:
    """One data row's tensor-parallel pieces as the unsharded param dict,
    on the row's first device."""
    cols = placed[row]
    dev = cols[0]["w1"].device
    return {"w1": torch.cat([c["w1"].to(dev) for c in cols], 0),
            "b1": torch.cat([c["b1"].to(dev) for c in cols], 0),
            "w2": torch.cat([c["w2"].to(dev) for c in cols], 1),
            "b2": cols[0]["b2"], "w3": cols[0]["w3"], "b3": cols[0]["b3"]}


def sr_forward_tp(cols: List[dict], x: torch.Tensor) -> torch.Tensor:
    """The SR model's unclipped forward over one data row's model columns
    (`shard_sr_params`): each column computes its slice of layer 1 and
    its part of layer 2's sum on its own device; the parts are summed in
    f32 on the row's first device before b2 and the ReLU; layer 3 runs
    there.  `x` lives on the row's first device."""
    from ..models import conv
    from ..models.sr import pixel_shuffle, scale_of

    dev = x.device
    parts = []
    for col in cols:
        xc = x.to(col["w1"].device, non_blocking=True)
        h = conv(xc, col["w1"], col["b1"], pad=2, relu=True)
        zero = torch.zeros(col["w2"].shape[0], device=h.device)
        parts.append(conv(h, col["w2"].float(), zero, pad=1).to(dev))
    # b2 and the ReLU in f32, rounded once to the params' dtype, as
    # `models.conv` ends an unsharded layer
    h = torch.relu(torch.stack(parts).sum(0)
                   + cols[0]["b2"].float()[None, :, None, None])
    h = conv(h.to(cols[0]["w3"].dtype), cols[0]["w3"], cols[0]["b3"], pad=1)
    return pixel_shuffle(h, scale_of(cols[0], x.shape[1]))


def sr_apply_tp(cols: List[dict], x: torch.Tensor) -> torch.Tensor:
    """`models/sr.apply` over one data row's model columns."""
    return torch.clamp(sr_forward_tp(cols, x), 0.0, 1.0)
