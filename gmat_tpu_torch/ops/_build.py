"""Build the port's CUDA kernels at first use and load them with ctypes.

`library()` compiles `gmat_tpu_torch/csrc/*.cu` with nvcc (one process per
source, all started together) and links them into one shared library with
a plain C interface, under `gmat_tpu_torch/build/` (listed in .gitignore),
keyed by a hash of the sources and flags, and loads it; nvcc's ptxas
report (registers, shared memory, spills) is kept beside it.  Only
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# entry points of the library: launchers take (args struct, stream)
_LAUNCHERS = ("gmat_ladder_i8", "gmat_ladder_bf16_u8", "gmat_ladder_bf16_u16",
              "gmat_ladder_nv12", "gmat_ladder_nv12_i8", "gmat_ladder_p010",
              "gmat_rungs_i8", "gmat_rungs_bf16")
_SIZES = ("gmat_ladder_args_size", "gmat_wire_args_size",
          "gmat_rungs_args_size")

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


def _run(cmds: list) -> str:
    """Run the commands side by side and return their output once all have
    ended; raise if any failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    outs = [(cmd, p.communicate()[0], p.returncode) for cmd, p in procs]
    for cmd, out, rc in outs:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")
    return "".join(out for _cmd, out, _rc in outs)


def _compile(so: Path) -> None:
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [so.with_name(f"{so.stem}.{src.stem}.{tag}.o") for src in SOURCES]
    tmp = so.with_name(f"{so.name}.{tag}")
    t0 = time.perf_counter()
    try:
        log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(SOURCES, objs)])
        log += _run([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                      *map(str, objs)]])
        so.with_suffix(".ptxas.txt").write_text(log.strip())
        os.replace(tmp, so)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    BUILD_INFO["seconds"] = time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            so = BUILD_DIR / f"libgmat_kernels_{_digest()}.so"
            if not so.exists():
                _compile(so)
            lib = ctypes.CDLL(str(so))
            for name in _LAUNCHERS:
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            for name in _SIZES:
                getattr(lib, name).argtypes = []
                getattr(lib, name).restype = ctypes.c_size_t
            lib.gmat_cuda_error_string.argtypes = [ctypes.c_int]
            lib.gmat_cuda_error_string.restype = ctypes.c_char_p
            BUILD_INFO["library"] = str(so)
            report = so.with_suffix(".ptxas.txt")
            BUILD_INFO["ptxas"] = (report.read_text() if report.exists()
                                   else "")
            _lib = lib
    return _lib


def error_string(err: int) -> str:
    return library().gmat_cuda_error_string(err).decode()
