"""Data-parallel scaling SHAPE artifact — counterpart of
`tools/scaling_shape.py`.

Runs the fused decode->CSC->scale ladder through
`parallel.pipeline.ShardedPipeline` over (n, 1) meshes, n = 1, 2, 4, 8,
and records the work of one shard's call.  Reference analog: N-session
decode scaling in metrans/AppNvDecPerf.cpp:155-171 (sessions x fps).

The JAX tool reads XLA's compiled per-device cost; the port counts what
one shard's call dispatches: flops with
`torch.utils.flop_counter.FlopCounterMode` (its matmul-class formulas,
plus one flop per output element of each elementwise arithmetic op, as
XLA counts them), bytes with `ByteCounter` (each op's operand and result
bytes; views move none), the counterpart of XLA's "bytes accessed".
Healthy data parallelism halves both per doubling of the mesh; a
pipeline that gathered the whole batch onto one shard before the ladder
would keep them flat.  The absolute numbers are not XLA's; the ratios
are the signal.  The shards take the separate-op path
(`use_kernel="never"`, the JAX tool's "never" path), so the counters see
the real ops and not one opaque kernel launch.

Every shard lies on one device (the card by default, `--device cpu` the
host) and they run one after another, so the median wall time only
checks that the total work stays flat.

    python -m gmat_tpu_torch.tools.scaling_shape [--device cuda|cpu]
        [--out SCALING_torch.json]
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..core.frame import from_numpy_yuv420
from ..ops import fused
from ..parallel import mesh as pmesh
from ..parallel.pipeline import ShardedPipeline

TOTAL_BATCH = 16
SRC_H, SRC_W = 360, 640
OUT = 224
SHARDS = (1, 2, 4, 8)
# the JAX tool's near-linear check: per-shard flops at 8 shards within
# 1.35x of the ideal 1/8
SLACK = 1.35

_aten = torch.ops.aten
ELEMENTWISE = (_aten.add, _aten.sub, _aten.rsub, _aten.mul, _aten.div,
               _aten.neg, _aten.clamp, _aten.round, _aten.maximum,
               _aten.minimum, _aten.where)


def _per_element(*args, out_shape=None, **kwargs) -> int:
    return math.prod(out_shape)


class ByteCounter(TorchDispatchMode):
    """Adds up the bytes of every dispatched op's tensor operands and
    results; a view moves none."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += sum(t.nbytes for t in tree_leaves((args, kwargs,
                                                              out))
                              if isinstance(t, torch.Tensor))
        return out


def ladder(fb):
    return fused.preprocess_nchw(fb, OUT, OUT, use_kernel="never")


def frames(device):
    rng = np.random.default_rng(0)
    y = rng.integers(0, 256, (TOTAL_BATCH, SRC_H, SRC_W)).astype(np.uint8)
    u = rng.integers(0, 256, (TOTAL_BATCH, SRC_H // 2,
                              SRC_W // 2)).astype(np.uint8)
    v = rng.integers(0, 256, (TOTAL_BATCH, SRC_H // 2,
                              SRC_W // 2)).astype(np.uint8)
    return from_numpy_yuv420(y, u, v, device=device)


def measure(fb, n: int, reps: int = 5) -> dict:
    """One row: the largest shard's flops and bytes over an (n, 1) mesh
    of fb's device, and the median wall time of the sharded call."""
    mesh = pmesh.make_mesh(n, 1, devices=[fb.device] * n)
    counts = []

    def counted(shard):
        with FlopCounterMode(display=False, custom_mapping={
                op: _per_element for op in ELEMENTWISE}) as fc, \
                ByteCounter() as bc:
            out = ladder(shard)
        counts.append((fc.get_total_flops(), bc.bytes))
        return out

    ShardedPipeline(counted, mesh)(fb)
    pipe = ShardedPipeline(ladder, mesh)
    sync = (torch.cuda.synchronize if fb.device.type == "cuda"
            else lambda: None)
    pipe(fb)
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        pipe(fb)
        sync()
        times.append(time.perf_counter() - t0)
    return {"devices": n,
            "flops_per_device": float(max(c[0] for c in counts)),
            "bytes_per_device": float(max(c[1] for c in counts)),
            "wall_ms_median": 1e3 * statistics.median(times)}


def run(device="cuda", reps: int = 5) -> dict:
    """The artifact: one row per mesh, with ratios to the 1-shard row."""
    fb = frames(device)
    rows = [measure(fb, n, reps) for n in SHARDS]
    for r in rows:
        r["flops_ratio_vs_1dev"] = (r["flops_per_device"]
                                    / rows[0]["flops_per_device"])
        r["bytes_ratio_vs_1dev"] = (r["bytes_per_device"]
                                    / rows[0]["bytes_per_device"])
    dev = fb.device
    return {
        "case": "scaling_shape",
        "total_batch": TOTAL_BATCH,
        "src": f"{SRC_W}x{SRC_H}",
        "out": f"{OUT}x{OUT}",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "note": ("per-shard flops (FlopCounterMode; one flop per element "
                 "of each elementwise op) and bytes (each op's operands "
                 "and results) are the scaling signal; a row's devices "
                 "are shards of one device that run one after another, "
                 "so wall time only checks that total work is flat"),
        "rows": rows,
    }


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m gmat_tpu_torch.tools.scaling_shape")
    p.add_argument("--device", default="cuda",
                   help="the torch device every shard lies on")
    p.add_argument("--out", default="SCALING_torch.json")
    args = p.parse_args(argv)
    artifact = run(args.device)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(json.dumps(artifact, indent=1))
    r8 = artifact["rows"][-1]["flops_ratio_vs_1dev"]
    if r8 > SLACK / SHARDS[-1]:
        raise SystemExit(f"dp sharding not near-linear: 8-shard ratio {r8}")
    print("OK: 8-shard per-shard flops ratio", r8, "(ideal 0.125)")
    return artifact


if __name__ == "__main__":
    main()
