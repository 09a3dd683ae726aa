"""gmat_tpu_torch — the PyTorch/CUDA port of gmat_tpu for NVIDIA Hopper.

Mirrors `gmat_tpu`'s layout (`core/`, `ops/`, `av/`, `utils/`, `apps/`)
and function names.  Plain device work is PyTorch; the fused preprocess
ladder and the ABR rung ladder run on hand-written CUDA kernels (`csrc/`),
built with nvcc at first use.  Entry points that create tensors take
`device="cuda"` by default; ops run on the device their inputs live on.
Imports neither jax nor gmat_tpu.
"""

__version__ = "0.1.0"

from .core.frame import FrameBatch, pack_nv12, unpack_nv12  # noqa: F401
from .core import formats  # noqa: F401
