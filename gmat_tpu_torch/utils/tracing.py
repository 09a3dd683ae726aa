"""Tracing/profiling — the NVTX + Nsight analog on PyTorch; counterpart of
`gmat_tpu/utils/tracing.py`.

The reference injects NVTX ranges from Python for Nsight
(metrans/python/app_extract.py:5-8,24-29 'Frame#n' ranges).  Here the same
API maps onto `torch.profiler.record_function` (seen by torch.profiler
traces) and, where the torch build has CUDA, an NVTX range (seen by
Nsight):

    with trace_range(f"Frame#{i}"):
        out = pipeline(batch)

    start_trace("/tmp/gmat_trace"); ... ; stop_trace()   # Chrome trace
"""
from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Iterator, Optional

import torch

_NVTX = torch.version.cuda is not None


@contextlib.contextmanager
def trace_range(name: str) -> Iterator[None]:
    """NVTX push/pop analog (shows up in torch.profiler and Nsight
    timelines)."""
    with torch.profiler.record_function(name):
        if _NVTX:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if _NVTX:
                torch.cuda.nvtx.range_pop()


def annotate_fn(name: str):
    """Decorator version for hot functions."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            with trace_range(name):
                return fn(*a, **kw)
        return wrapped
    return deco


_active: Optional[tuple] = None     # (profiler, logdir)


def start_trace(logdir: str) -> None:
    """Start a torch.profiler trace of the host and, where a card is
    present, its kernels and copies."""
    global _active
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _active = (prof, logdir)


def stop_trace() -> Optional[str]:
    """Stop the trace and write it into the logdir as a Chrome trace
    (chrome://tracing, Perfetto); returns the file's path."""
    global _active
    if _active is None:
        return None
    prof, logdir = _active
    _active = None
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


def _leaves(val) -> list:
    """The leaves of a nested output: tensors and other values inside
    dicts, lists, tuples and batches' planes (None and empty containers
    have none)."""
    if val is None:
        return []
    if isinstance(val, dict):
        return [x for v in val.values() for x in _leaves(v)]
    if isinstance(val, (list, tuple)):
        return [x for v in val for x in _leaves(v)]
    if hasattr(val, "planes"):
        return _leaves(val.planes)
    return [val]


@contextlib.contextmanager
def device_timer(label: str = "", sync=None):
    """Wall-clock a device region — the StopWatch analog (NvCommon.h:209)
    with a device sync.

    Pass a zero-arg callable returning the region's output via `sync`
    (a pre-existing value also works for re-timing it); the timer waits
    for the device that holds the output's first tensor
    (`torch.cuda.synchronize` for a CUDA tensor; CPU work is done when it
    returns).  Without `sync`, or with one whose output holds nothing,
    there is nothing to wait on and 'seconds' measures dispatch time only
    — 'sync_missing' is set so callers can't misread it.
    """
    out = {"label": label, "seconds": None}
    t0 = time.perf_counter()
    try:
        yield out
    finally:
        if sync is not None:
            val = sync() if callable(sync) else sync
            leaves = _leaves(val)
            if leaves:
                dev = next((x.device for x in leaves
                            if isinstance(x, torch.Tensor)), None)
                if dev is not None and dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            else:
                out["sync_missing"] = True
        else:
            out["sync_missing"] = True
        out["seconds"] = time.perf_counter() - t0
