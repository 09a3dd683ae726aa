"""Persistent build cache — the .trtcache analog; counterpart of
`gmat_tpu/utils/compile_cache.py`.

The reference compiles ONNX models once and persists engines as
<model>.trtcache (libavfilter/tensorrt.cpp:198-222,461-496); the JAX
package turns on XLA's persistent compilation cache.  The port's compiled
programs are its CUDA kernels, and `ops/_build.py` already keeps their
library on disk, keyed by a hash of the sources and the nvcc flags, so a
later process loads it instead of running nvcc.  `enable` names that
directory; it adds no second cache.
"""
from __future__ import annotations

import os
from pathlib import Path

from ..ops import _build

DEFAULT_DIR = str(_build.BUILD_DIR)


def enable(cache_dir: str = DEFAULT_DIR, min_compile_time: float = 0.0):
    """Keep this process's kernel builds in `cache_dir` (created here) and
    return it.  Every build is kept, whatever it took: `min_compile_time`
    is accepted for the JAX signature and has nothing to select."""
    os.makedirs(cache_dir, exist_ok=True)
    _build.BUILD_DIR = Path(cache_dir)
    return cache_dir
