"""Host-thread fan-out sizing shared by the still-image codecs; a copy of
`gmat_tpu/utils/hostpool.py`.

The C entropy codec and the x265/HEVC sessions are GIL-free (ctypes
CDLL), so per-image work parallelizes across host cores — the easy
parallelism the reference gets from fixed-function engines
(AppNvjpegDec.cpp:24-67, AppHeifEnc.cpp:69-95).
"""
from __future__ import annotations

import os


def n_workers(workers: int, n_items: int) -> int:
    """Fan-out width: 0 sizes to the USABLE core count (cgroup/affinity
    aware — os.cpu_count() reports the host's cores even when the
    container is pinned to one), 1 forces the serial path, always
    clamped to the item count."""
    if workers <= 0:
        try:
            workers = len(os.sched_getaffinity(0)) or 1
        except (AttributeError, OSError):
            workers = os.cpu_count() or 1
    return max(1, min(workers, n_items))
