"""Multi-process scale-out: process group + global mesh + per-process feed.

Counterpart of `gmat_tpu/parallel/distributed.py`, on `torch.distributed`.
The reference scales past one GPU by launching N independent processes
with a `-gpu` ordinal (AppSelect.cpp:49-56) — no cross-process
coordination at all.  Here each process owns its local devices and the
processes cooperate through one process group:

  * init_distributed()       — one call per process: NCCL between cards,
                               gloo on the host, rendezvous at
                               `tcp://coordinator` (or torch's `env://`
                               variables when no address is given).
  * global_mesh()            — data x model mesh over ALL processes'
                               devices, model axis kept process-local so
                               tensor-parallel sums stay inside one
                               process; only the data axis crosses
                               processes.
  * feed_process_local()     — each process places the frames IT decoded
                               on its local data rows, with their offset
                               in the global batch; steady-state ingest
                               moves no frames between processes, like
                               the reference's independent `-gpu`
                               processes.
  * shard_batch_global()     — FrameBatch version of the above.
  * replicate_global()       — broadcast a param tree from rank 0.

Collectives on CUDA tensors go through NCCL; under gloo (the host test
cluster, or several processes sharing one card, which NCCL refuses) they
are staged through host memory, as gloo's CUDA support is partial.

`python -m gmat_tpu_torch.parallel.distributed --selftest-worker ...` is
one process of an N-process cluster running a dp x tp train step of the
SR model, or the sharded ladder (`--workload ladder`);
`dryrun_multihost` launches such a cluster on this machine and checks
that its processes agree.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import sys
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import mesh as pmesh

DATA_AXIS = pmesh.DATA_AXIS
MODEL_AXIS = pmesh.MODEL_AXIS

_LOCAL: List[torch.device] = []     # this process's devices, after init


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_count: Optional[int] = None,
                     platform: Optional[str] = None,
                     timeout: float = 120.0) -> None:
    """Join this process to the cluster.

    platform "cpu": gloo, `local_device_count` host devices (default 1).
    platform "cuda" (the default): `local_device_count` entries over the
    machine's cards (default one per card; a card repeats when more are
    asked for, as in `mesh.make_mesh`), NCCL while the world has no more
    processes than the machine has cards, gloo otherwise (NCCL refuses
    two ranks on one card; gloo stages CUDA tensors through host memory,
    see `all_reduce_sum`).  Every collective
    gives up after `timeout` seconds.  With no coordinator address the
    rendezvous reads torch's `env://` variables (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK).
    """
    if coordinator_address is not None:
        # explicit clusters need the full triple — forwarding Nones into
        # init_process_group fails deep inside it (or waits for peers
        # that never come) instead of at this boundary
        if num_processes is None or process_id is None:
            raise ValueError(
                "coordinator_address given without num_processes/"
                "process_id — explicit (non-TPU-pod) clusters must pass "
                "all three")
    platform = platform or "cuda"
    if platform == "cpu":
        local = [torch.device("cpu")] * (local_device_count or 1)
        backend = "gloo"
    elif platform in ("cuda", "gpu"):
        cards = pmesh.local_devices()
        local = [cards[i % len(cards)]
                 for i in range(local_device_count or len(cards))]
        world = (num_processes if coordinator_address is not None
                 else int(os.environ.get("WORLD_SIZE", "1")))
        backend = "nccl" if world <= torch.cuda.device_count() else "gloo"
        torch.cuda.set_device(local[0])
    else:
        raise ValueError(f"platform must be 'cpu' or 'cuda', got "
                         f"{platform!r}")
    kw = dict(backend=backend,
              timeout=datetime.timedelta(seconds=timeout))
    if coordinator_address is not None:
        kw.update(init_method=f"tcp://{coordinator_address}",
                  world_size=num_processes, rank=process_id)
    dist.init_process_group(**kw)
    _LOCAL[:] = local


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
    _LOCAL.clear()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_devices() -> List[torch.device]:
    """This process's devices: those of init_distributed, else every card
    of the machine."""
    return list(_LOCAL) if _LOCAL else pmesh.local_devices()


def global_mesh(n_model: int = 1,
                devices: Optional[Sequence] = None) -> pmesh.Mesh:
    """Mesh over every device of every process: (data, model).

    `devices` lists (process_index, device) pairs (a bare device belongs
    to this process); by default each process contributes its local
    devices, in process order.  Each model-axis group must live inside
    ONE process: tensor-parallel sums stay in-process, and the data axis,
    which spans processes, carries no steady-state traffic.
    """
    if devices is None:
        devices = [(p, d) for p in range(process_count())
                   for d in local_devices()]
    pairs = [d if isinstance(d, tuple) else (process_index(), d)
             for d in devices]
    if len(pairs) % n_model:
        raise ValueError(f"{len(pairs)} devices not divisible by "
                         f"n_model={n_model}")
    n_data = len(pairs) // n_model
    pids = np.asarray([p for p, _ in pairs], np.int64).reshape(n_data,
                                                               n_model)
    if n_model > 1:
        # validate the ACTUAL layout: an explicit subset/reorder must
        # still keep every model-axis row inside one process
        for row in pids:
            if len(set(row.tolist())) > 1:
                raise ValueError(
                    "model-axis group spans processes "
                    f"{sorted(set(row.tolist()))} — reorder `devices` so "
                    f"each consecutive group of {n_model} is process-local "
                    "(tensor-parallel sums must stay in one process)")
    grid = pmesh._grid([d for _, d in pairs], n_data, n_model)
    return pmesh.Mesh(grid, pids)


def local_rows(mesh: pmesh.Mesh) -> List[int]:
    """The data rows of `mesh` that this process owns."""
    me = process_index()
    return [r for r in range(mesh.devices.shape[0])
            if mesh.process_index[r, 0] == me]


def local_mesh(mesh: pmesh.Mesh) -> pmesh.Mesh:
    """This process's rows of a global mesh, as a mesh of their own."""
    rows = local_rows(mesh)
    return pmesh.Mesh(mesh.devices[rows], mesh.process_index[rows])


def process_batch_size(mesh: pmesh.Mesh, global_batch: int) -> int:
    """Frames THIS process must decode for a `global_batch`-frame step."""
    n = process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} processes")
    return global_batch // n


@dataclasses.dataclass
class ProcessShards:
    """This process's part of a global batch: one shard per local data
    row, on the row's device, with its frames' offset in the global
    batch."""
    shards: list
    rows: List[int]
    starts: List[int]
    global_len: int


def _placement(mesh: pmesh.Mesh, n_local: int):
    rows = local_rows(mesh)
    if not rows:
        raise ValueError(f"process {process_index()} owns no row of "
                         "the mesh")
    if n_local % len(rows):
        raise ValueError(f"{n_local} local frames do not split over "
                         f"{len(rows)} local data rows")
    per = n_local // len(rows)
    return rows, per, [r * per for r in rows], per * mesh.devices.shape[0]


def feed_process_local(mesh: pmesh.Mesh, local) -> ProcessShards:
    """This process's locally decoded frames (numpy or a tensor) -> its
    shards of the global batch over the data axis.

    Every process calls this with its OWN block (equal shapes); nothing
    crosses processes — the multi-process RoundQueue: each process's
    ingest feeds only its local devices.
    """
    t = torch.as_tensor(np.ascontiguousarray(local)) \
        if isinstance(local, np.ndarray) else local
    rows, per, starts, total = _placement(mesh, t.shape[0])
    shards = [t[i * per:(i + 1) * per].to(mesh.row_device(r),
                                          non_blocking=True)
              for i, r in enumerate(rows)]
    return ProcessShards(shards, rows, starts, total)


def shard_batch_global(fb, mesh: pmesh.Mesh) -> ProcessShards:
    """FrameBatch whose planes are this process's local decode output ->
    its shards (FrameBatches) of one global batch over the data axis."""
    rows, per, starts, total = _placement(mesh, fb.batch)
    parts = {k: feed_process_local(mesh, v) for k, v in fb.planes.items()}
    shards = [fb.with_planes({k: p.shards[i] for k, p in parts.items()})
              for i in range(len(rows))]
    return ProcessShards(shards, rows, starts, total)


def _collective(t: torch.Tensor, op) -> torch.Tensor:
    """`op(buffer)` on a collective buffer for `t`: t itself under NCCL or
    for a host tensor, else a host copy (gloo), copied back into t."""
    if not t.is_cuda or dist.get_backend() == "nccl":
        op(t)
        return t
    host = t.detach().cpu()
    op(host)
    t.copy_(host)
    return t


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum `t` over every process of the group, in place (outside a group:
    unchanged)."""
    if dist.is_initialized():
        _collective(t, lambda b: dist.all_reduce(b, dist.ReduceOp.SUM))
    return t


def replicate_global(tree, mesh: Optional[pmesh.Mesh] = None):
    """Rank 0's param tree on every process, on this process's first
    device of `mesh` (or its first local device)."""
    dev = (mesh.row_device(local_rows(mesh)[0]) if mesh is not None
           else local_devices()[0])
    if isinstance(tree, dict):
        return {k: replicate_global(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate_global(v, mesh) for v in tree)
    t = torch.as_tensor(np.asarray(tree)) if not isinstance(
        tree, torch.Tensor) else tree
    t = t.detach().to(dev).clone()
    if dist.is_initialized():
        _collective(t, lambda b: dist.broadcast(b, 0))
    return t


# ---------------------------------------------------------------------------
# Self-test worker: one process of an N-process cluster running the sharded
# ladder or a dp x tp train step of the SR model.  Driven by
# dryrun_multihost and the tests.
# ---------------------------------------------------------------------------

def _local_batch(rng, n, h, w):
    from ..core.frame import FrameBatch
    y = rng.integers(0, 256, (n, h, w)).astype(np.uint8)
    u = rng.integers(0, 256, (n, h // 2, w // 2)).astype(np.uint8)
    v = rng.integers(0, 256, (n, h // 2, w // 2)).astype(np.uint8)
    return FrameBatch({k: torch.from_numpy(a) for k, a in
                       zip("yuv", (y, u, v))}, "yuv420p", w, h, "bt709")


def ladder_workload(args) -> dict:
    """The production shape across processes: each process 'decodes' its
    own frames and feeds them to its local data rows, every row runs the
    ladder on its shard — then every process holds its shards against a
    local unsharded recompute (per-process ingest + sharded ladder ==
    local compute for the embarrassingly-parallel frame axis)."""
    from ..ops import fused

    mesh = global_mesh(n_model=1)
    n_total = mesh.shape[DATA_AXIS] * 2
    n_local = process_batch_size(mesh, n_total)
    h, w, o = args.height, args.width, args.out_size
    rng = np.random.default_rng(1000 + process_index())
    fb = _local_batch(rng, n_local, h, w)
    placed = shard_batch_global(fb, mesh)
    outs = [fused.preprocess_nchw(s, o, o) for s in placed.shards]
    first = mesh.row_device(placed.rows[0])
    ref = fused.preprocess_nchw(fb.with_planes(
        {k: v.to(first) for k, v in fb.planes.items()}), o, o)
    start = placed.starts[0]
    checked = 0
    for lo, block in zip(placed.starts, outs):
        want = ref[lo - start:lo - start + block.shape[0]]
        err = float((block.to(first) - want).abs().max())
        assert err <= 1e-5, (lo, err)
        checked += block.shape[0]
    assert checked == n_local, (checked, n_local)
    return {"workload": "ladder", "frames_checked": checked,
            "global_batch": n_total}


def _load_params(args, device):
    from ..models import from_jax_params, generator, sr
    if args.params:
        with np.load(args.params) as z:
            return from_jax_params({k: z[k] for k in z.files}, device)
    return sr.init_params(generator(0), scale=2, hidden=16, device=device)


def train_workload(args) -> dict:
    """One dp x tp step of the SR model: tensor-parallel forward over each
    data row's model columns, MSE loss of the unclipped output, gradients
    summed over every row of every process and scaled to the global-batch
    mean, then SGD(lr=1e-3) — the step the JAX package takes on the whole
    global batch."""
    from ..models import exact_f32
    from ..ops import fused

    n_global = process_count() * args.devices_per_host
    n_model = 2 if args.devices_per_host % 2 == 0 else 1
    mesh = global_mesh(n_model=n_model)
    assert int(np.prod(list(mesh.shape.values()))) == n_global
    rows = local_rows(mesh)
    params = replicate_global(_load_params(args, local_devices()[0]), mesh)
    placed = pmesh.shard_sr_params(params, local_mesh(mesh))
    pieces = [p for row in placed for col in row for p in col.values()]
    for p in pieces:
        p.requires_grad_(True)
    opt = torch.optim.SGD(pieces, lr=1e-3)

    # per-process ingest: every process synthesizes only ITS frames — the
    # global batch never exists in any single process
    g_batch = n_global * 2 // n_model * n_model
    n_local = process_batch_size(mesh, g_batch)
    h = w = 64
    rng = np.random.default_rng(process_index())
    fb = _local_batch(rng, n_local, h, w)
    target = rng.uniform(0, 1, (n_local, 3, 64, 64)).astype(np.float32)
    frames = shard_batch_global(fb, mesh)
    targets = feed_process_local(mesh, target)

    n_rows = mesh.shape[DATA_AXIS]
    first = mesh.row_device(rows[0])
    local_sum = torch.zeros((), device=first)
    for cols, shard, tgt in zip(placed, frames.shards, targets.shards):
        x = fused.preprocess_nchw(shard, 32, 32)
        pred = pmesh.sr_forward_tp(cols, x)
        local_sum = local_sum + torch.mean((pred - tgt) ** 2).to(first)
    # the global loss is the mean over rows of equal size; the backward
    # convolutions under the layers' flags (TF32 off), as the trainers run
    with exact_f32():
        (local_sum / n_rows).backward()
    # every replica of a piece gets the sum of all rows' gradients
    for c in range(n_model):
        for k in placed[0][c]:
            g = sum(row[c][k].grad.to(first) for row in placed)
            all_reduce_sum(g)
            for row in placed:
                row[c][k].grad.copy_(g)
    opt.step()
    loss = all_reduce_sum(local_sum.detach().clone()) / n_rows
    rec = {"workload": "train", "mesh": dict(mesh.shape),
           "loss": float(loss)}
    if args.out and process_index() == 0:
        tree = pmesh.gather_sr_params(placed, 0)
        np.savez(args.out, **{k: v.detach().cpu().numpy()
                              for k, v in tree.items()})
    return rec


def worker_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="gmat-distributed")
    p.add_argument("--selftest-worker", action="store_true", required=True)
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--devices-per-host", type=int, default=4)
    p.add_argument("--workload", choices=("train", "ladder"),
                   default="train")
    p.add_argument("--platform", choices=("cpu", "cuda"), default="cuda")
    p.add_argument("--timeout", type=float, default=120.0,
                   help="seconds any collective may wait for a peer")
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--width", type=int, default=96)
    p.add_argument("--out-size", type=int, default=32,
                   help="the ladder workload's square output side")
    p.add_argument("--params", default="",
                   help="SR params (.npz under the JAX keys); default the "
                        "port's seeded init")
    p.add_argument("--out", default="",
                   help="rank 0 writes the updated SR params here (.npz)")
    return p.parse_args(argv)


def run_workload(args) -> dict:
    """The workload of `args` in an initialized process group, with the
    process's description."""
    rec = (ladder_workload(args) if args.workload == "ladder"
           else train_workload(args))
    rec.update(process=process_index(), processes=process_count(),
               global_devices=process_count() * len(local_devices()),
               local_devices=len(local_devices()),
               backend=dist.get_backend())
    rec.setdefault("loss", 0.0)
    return rec


def _selftest_worker(args) -> int:
    init_distributed(coordinator_address=args.coordinator,
                     num_processes=args.num_processes,
                     process_id=args.process_id,
                     local_device_count=args.devices_per_host,
                     platform=args.platform,
                     timeout=args.timeout)
    try:
        rec = run_workload(args)
        print(json.dumps(rec), flush=True)
    finally:
        shutdown()
    return 0


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multihost(n_processes: int = 2, devices_per_host: int = 4,
                     timeout: float = 300.0, workload: str = "train",
                     platform: str = "cuda",
                     extra_args: Sequence[str] = ()) -> List[dict]:
    """Multi-process dry run on this machine: n_processes coordinated OS
    processes, each owning devices_per_host devices, run one workload
    with per-process ingest.  Every process must exit 0 within `timeout`
    seconds (a process that fails or hangs stops the whole group), report
    all the devices, and — for the train step — the same loss.  Returns
    each process's record, by rank.  Reference analog: N processes x
    `-gpu` ordinal, AppSelect.cpp:49-56."""
    import subprocess
    import tempfile
    import time
    from pathlib import Path

    port = free_port()
    root = Path(__file__).resolve().parents[2]
    procs, logs = [], []
    for pid in range(n_processes):
        # a file, not a pipe: a chatty worker cannot block on a full pipe
        logs.append(tempfile.TemporaryFile())
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "gmat_tpu_torch.parallel.distributed",
             "--selftest-worker", "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", str(n_processes), "--process-id", str(pid),
             "--devices-per-host", str(devices_per_host),
             "--workload", workload, "--platform", platform,
             "--timeout", str(max(10.0, timeout / 2)), *extra_args],
            cwd=str(root), env=dict(os.environ), stdout=logs[-1],
            stderr=subprocess.STDOUT))
    end = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.poll() not in (None, 0)]
            if failed or time.monotonic() > end:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        rcs = [p.wait() for p in procs]
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read().decode(errors="replace"))
            log.close()
    if any(rc != 0 for rc in rcs):
        why = "timed out" if time.monotonic() > end else "failed"
        raise RuntimeError("multi-process dry run %s (rcs=%s):\n%s"
                           % (why, rcs, "\n---\n".join(outs)))
    recs = []
    for out in outs:
        line = [ln for ln in out.splitlines() if ln.startswith("{")][-1]
        rec = json.loads(line)
        assert rec["global_devices"] == n_processes * devices_per_host, rec
        recs.append(rec)
    losses = {round(r["loss"], 8) for r in recs}
    assert len(losses) == 1, f"processes disagree on the loss: {losses}"
    return recs


def main(argv=None) -> int:
    return _selftest_worker(worker_args(argv))


if __name__ == "__main__":
    sys.exit(main())
