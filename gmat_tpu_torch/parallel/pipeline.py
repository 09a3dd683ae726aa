"""Multi-device frame pipeline — data-parallel scale-out over a mesh.

Counterpart of `gmat_tpu/parallel/pipeline.py`.  Where the reference
scales by N processes x `-gpu` ordinals (AppSelect.cpp:49-56) / N
sessions x host threads (AppMeTrans.cpp:342-344), the port splits the
frame batch over the mesh's data axis: every data row runs the same
function on its shard on its own device, with no sync between shards and
no cross-device traffic until the results are gathered (frames are
embarrassingly parallel).  On the card each shard's
`ops/fused.preprocess_nchw` launches the ladder kernel once.  The model
axis carries tensor-parallel inference (`mesh.sr_apply_tp`).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from ..core.frame import FrameBatch
from . import mesh as pm


def _on(device: torch.device):
    """The device context a shard's work is issued under."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _gather(outs, device: torch.device):
    """Shard results (tensors, FrameBatches, or lists or tuples of them,
    such as a rung ladder's batches) joined on `device`."""
    first = outs[0]
    if isinstance(first, (list, tuple)):
        return type(first)(_gather([o[i] for o in outs], device)
                           for i in range(len(first)))
    if isinstance(first, FrameBatch):
        return first.with_planes({k: torch.cat(
            [o.planes[k].to(device, non_blocking=True) for o in outs])
            if len(outs) > 1 else v.to(device)
            for k, v in first.planes.items()})
    if isinstance(first, torch.Tensor):
        return torch.cat([o.to(device, non_blocking=True) for o in outs]) \
            if len(outs) > 1 else first.to(device)
    raise TypeError(f"cannot gather shard results of type "
                    f"{type(first).__name__}")


class ShardedPipeline:
    """Runs `fn(FrameBatch) -> FrameBatch/tensor` (or a list of them)
    data-parallel on a mesh.

    fn must be shape-preserving per frame (each row processes its shard
    independently).  Batches are padded to a multiple of the data-axis
    size by repeating the last frame, split one shard per data row, and
    the results are concatenated on the first row's device.
    """

    def __init__(self, fn: Callable, mesh: Optional[pm.Mesh] = None):
        self.mesh = mesh or pm.make_mesh()
        self.n_data = self.mesh.shape[pm.DATA_AXIS]
        self._fn = fn

    def pad(self, n: int) -> int:
        return (self.n_data - n % self.n_data) % self.n_data

    def shard(self, fb: FrameBatch):
        pad = self.pad(fb.batch)
        if pad:
            fb = fb.with_planes({k: torch.cat([v, v[-1:].expand(
                pad, *v.shape[1:])]) for k, v in fb.planes.items()})
        return pm.shard_batch(fb, self.mesh)

    def __call__(self, fb: FrameBatch):
        outs = []
        for row, part in enumerate(self.shard(fb)):
            with _on(self.mesh.row_device(row)):
                outs.append(self._fn(part))
        return _gather(outs, self.mesh.row_device(0))


def run_sharded(fn: Callable, fb: FrameBatch,
                mesh: Optional[pm.Mesh] = None):
    """One-shot helper: shard -> fn per shard -> joined result, trimmed
    back to the ORIGINAL batch length (shard() pads ragged batches by
    repeating the last frame; a caller aggregating the raw result would
    silently count the phantom frames)."""
    n = fb.batch

    def trim(out):
        if isinstance(out, (list, tuple)):
            return type(out)(trim(o) for o in out)
        if isinstance(out, FrameBatch):
            return out.with_planes({k: v[:n] for k, v in out.planes.items()})
        return out[:n]
    return trim(ShardedPipeline(fn, mesh)(fb))
