"""Build the port's CUDA kernels at first use and load them with ctypes.

`library()` compiles `gmat_tpu_torch/csrc/*.cu` with nvcc into one shared
library with a plain C interface, under `gmat_tpu_torch/build/` (listed in
.gitignore), keyed by a hash of the sources and flags, and loads it.  Only
a call that needs a kernel gets here: importing the package never needs
nvcc.  nvcc is looked up on PATH, then in $CUDA_HOME/bin, then in
/usr/local/cuda/bin; if it is in none of them, the build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# what the last build in this process did: seconds, library path, ptxas log
BUILD_INFO: dict = {}

_lib = None
_lock = threading.Lock()


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or in "
                       "/usr/local/cuda/bin: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(so: Path) -> None:
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    BUILD_INFO.update(seconds=time.perf_counter() - t0,
                      ptxas=(proc.stdout + proc.stderr).strip())


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            so = BUILD_DIR / f"libgmat_kernels_{_digest()}.so"
            if not so.exists():
                _compile(so)
            lib = ctypes.CDLL(str(so))
            for name in ("gmat_ladder_i8", "gmat_ladder_bf16_u8",
                         "gmat_ladder_bf16_u16"):
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            lib.gmat_ladder_args_size.argtypes = []
            lib.gmat_ladder_args_size.restype = ctypes.c_size_t
            lib.gmat_cuda_error_string.argtypes = [ctypes.c_int]
            lib.gmat_cuda_error_string.restype = ctypes.c_char_p
            BUILD_INFO["library"] = str(so)
            _lib = lib
    return _lib


def error_string(err: int) -> str:
    return library().gmat_cuda_error_string(err).decode()
