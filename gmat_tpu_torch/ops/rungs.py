"""Multi-rung ABR ladder on hand-written Hopper kernels — counterpart of
`gmat_tpu/ops/pallas_kernels.py:837-1215` (its host half, and kernels K4
and K5).

    4:2:0 u8 source (N, H, W) + 2x(N, H/2, W/2) -> for every rung
    (out_w, out_h): (N, oh, ow) + 2x(N, oh/2, ow/2) u8, one launch

Kernels (`gmat_tpu_torch/csrc/rungs.cu`, built at first use by `_build`):
  * `rungs_i8`   replaces K4-int8 `_rungs_kernel_i8` (int8 row stage) and
    K5 `_rungs_kernel_i8_chunked`: the CUDA kernel walks any width, so 4K
    sources need no column-chunked variant.  The TPU's dispatch by VMEM
    size (`rungs_fit_vmem`, `_pick_rungs_chunks`, and the ValueError for a
    bf16 ladder over the budget) has no counterpart here: `fused_rungs`
    sends every frame size to the kernel, and `fused_rungs_fits` answers
    what the port can take.
  * `rungs_bf16` replaces K4-bf16 `_rungs_kernel` (bf16 row stage).

One launch covers every rung and all three planes (up to `MAX_RUNGS`
rungs; a longer ladder takes one launch per `MAX_RUNGS` rungs, each
counted).  Each kernel has a plain PyTorch version here
(`_rungs_i8_plain`, `_rungs_bf16_plain`) that repeats its numerics with
tensor ops on any device.  The wrapper takes it only for CPU tensors, or
when the caller passes `reference=True` (the counterpart of the JAX
`interpret=True`); a CUDA tensor launches the kernel or raises.
`LAUNCHES` counts the kernel launches per kernel name.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import _build
from .ladder import _Band, _band_operands, _i8_quant_error_lsb, \
    _row_col_operands, _rowcol_i8_plain, _tensors
from .resize import f32_matmul, resample_matrix

LAUNCHES = {"rungs_i8": 0, "rungs_bf16": 0}

MAX_RUNGS = 8          # rungs per launch: the size of RungsArgs.rung


@lru_cache(maxsize=256)
def _rung_i8_ok(h: int, ch: int, oh: int, method: str) -> bool:
    """fused_rungs auto gate: measured quantization error of the actual
    row matrices (luma h->oh, chroma ch->oh//2) — no method shortcut."""
    return (_i8_quant_error_lsb(resample_matrix(h, oh, method)) <= 2.0
            and _i8_quant_error_lsb(
                resample_matrix(ch, oh // 2, method)) <= 2.0)


def _validate(sizes, method: str, quant: str) -> tuple:
    if method not in ("bilinear", "nearest"):
        raise ValueError(f"fused_rungs: method must be bilinear|nearest, "
                         f"got {method!r}")
    if quant not in ("auto", "i8", "bf16"):
        raise ValueError(f"fused_rungs: quant must be auto|i8|bf16, "
                         f"got {quant!r}")
    sizes = tuple((int(ow), int(oh)) for ow, oh in sizes)
    for ow, oh in sizes:
        if (ow | oh) & 1:
            raise ValueError(f"rung size {ow}x{oh} must be even (4:2:0)")
    return sizes


def resolve_quant(h: int, ch: int, sizes, method: str, quant: str) -> str:
    """The row stage `fused_rungs` runs: "auto" takes int8 while tap
    quantization holds tolerance on every rung's row matrices."""
    if quant != "auto":
        return quant
    return ("i8" if all(_rung_i8_ok(h, ch, oh, method) for _ow, oh in sizes)
            else "bf16")


def fused_rungs_fits(h: int, w: int, sizes) -> bool:
    """Can fused_rungs take this geometry?  The kernels walk any frame
    size, so every ladder of even, positive rung sizes fits (the TPU's
    answer depends on its VMEM budget)."""
    return h > 0 and w > 0 and all(
        ow > 0 and oh > 0 and not (int(ow) | int(oh)) & 1 for ow, oh in sizes)


# ---------------------------------------------- rung operands (numpy, host)

@lru_cache(maxsize=64)
def _rung_operands(kind: str, geom: tuple) -> list:
    """Per rung, the operands kernel `kind` ("i8" or "bf16") reads for one
    geometry (h, w, ch, cw, sizes, method), as numpy — computed as the JAX
    builders compute them (`_build_rungs`, `_build_rungs_i8_chunked`).
    Chroma rungs resample the chroma plane (ch -> oh//2, cw -> ow//2); u
    and v share them."""
    h, w, ch, cw, sizes, method = geom
    return [_row_col_operands(kind, resample_matrix(h, oh, method),
                              resample_matrix(ch, oh // 2, method),
                              resample_matrix(w, ow, method).T,
                              resample_matrix(cw, ow // 2, method).T)
            for ow, oh in sizes]


# ------------------------------------------------------- plain versions

@lru_cache(maxsize=32)
def _plain_operands(kind: str, geom: tuple, device: str) -> list:
    return [_tensors(ops, device) for ops in _rung_operands(kind, geom)]


def _to_u8(o: torch.Tensor) -> torch.Tensor:
    # torch.round is round-half-to-even, as jnp.round
    return torch.clamp(torch.round(o), 0.0, 255.0).to(torch.uint8)


def _plane_i8(x, ah_q, aw, off, inv_s):
    # the ladder's int8 row and column stages (the offset goes on once,
    # after the whole column sum), then round and clip
    return _to_u8(_rowcol_i8_plain(x, ah_q, aw, off, inv_s))


def _plane_bf16(x, ah, aw):
    # u8 samples are exact in bf16; one f32 row sum over all rows (no
    # 512-row chunks, unlike the ladder's K2), rounded to bf16
    t = f32_matmul(ah, x.to(torch.float32))
    return _to_u8(f32_matmul(t.to(torch.bfloat16).to(torch.float32), aw))


def _rungs_i8_plain(y, u, v, rungs: list) -> list:
    """Plain PyTorch version of the `rungs_i8` kernel (K4-int8, K5)."""
    return [(_plane_i8(y, r["ahy"], r["awy"], r["offy"], r["inv_sy"]),
             _plane_i8(u, r["ahc"], r["awc"], r["offc"], r["inv_sc"]),
             _plane_i8(v, r["ahc"], r["awc"], r["offc"], r["inv_sc"]))
            for r in rungs]


def _rungs_bf16_plain(y, u, v, rungs: list) -> list:
    """Plain PyTorch version of the `rungs_bf16` kernel (K4-bf16)."""
    return [(_plane_bf16(y, r["ahy"], r["awy"]),
             _plane_bf16(u, r["ahc"], r["awc"]),
             _plane_bf16(v, r["ahc"], r["awc"])) for r in rungs]


_PLAIN = {"i8": _rungs_i8_plain, "bf16": _rungs_bf16_plain}


# ------------------------------------------------------- kernel launches

@lru_cache(maxsize=32)
def _kernel_operands(kind: str, geom: tuple, device: str) -> list:
    """Band-form operands per rung, uploaded once per (geometry, device)."""
    return [_band_operands(kind, m, device)
            for m in _rung_operands(kind, geom)]


class _Rung(ctypes.Structure):
    """Mirror of `struct Rung` in csrc/rungs.cu."""
    _fields_ = ([(k, ctypes.c_void_p) for k in ("y", "u", "v")]
                + [(k, _Band) for k in ("row_y", "col_y", "row_c", "col_c")]
                + [(k, ctypes.c_void_p) for k in ("off_y", "off_c")]
                + [(k, ctypes.c_int32) for k in ("out_h", "out_w")]
                + [("inv_sy", ctypes.c_float), ("inv_sc", ctypes.c_float)])


class _RungsArgs(ctypes.Structure):
    """Mirror of `struct RungsArgs` in csrc/rungs.cu."""
    _fields_ = ([(k, ctypes.c_void_p) for k in ("y", "u", "v")]
                + [(k, ctypes.c_int32) for k in ("n", "h", "w", "ch", "cw",
                                                  "n_rungs")]
                + [("rung", _Rung * MAX_RUNGS)])


def _rungs_args(y, u, v, outs: list, ops: list) -> _RungsArgs:
    """Kernel arguments for up to MAX_RUNGS rungs: source pointers and
    shapes, and per rung its output pointers, band operands and scales."""
    def band(r, name):
        lo, n, packed = r[name]
        return _Band(lo.data_ptr(), n.data_ptr(), packed.data_ptr(),
                     packed.shape[1])

    args = _RungsArgs(y.data_ptr(), u.data_ptr(), v.data_ptr(), y.shape[0],
                      y.shape[1], y.shape[2], u.shape[1], u.shape[2],
                      len(outs))
    for slot, (r, (yo, uo, vo)) in enumerate(zip(ops, outs)):
        args.rung[slot] = _Rung(
            yo.data_ptr(), uo.data_ptr(), vo.data_ptr(),
            band(r, "row_y"), band(r, "col_y"), band(r, "row_c"),
            band(r, "col_c"),
            *(r[k].data_ptr() if k in r else None for k in ("off_y", "off_c")),
            yo.shape[1], yo.shape[2], r.get("inv_sy", 1.0),
            r.get("inv_sc", 1.0))
    return args


_ENTRIES = {"i8": ("rungs_i8", "gmat_rungs_i8"),
            "bf16": ("rungs_bf16", "gmat_rungs_bf16")}


def _launch(kind: str, y, u, v, geom: tuple) -> list:
    """Launch kernel `kind` on CUDA planes; raises on what it does not take."""
    name, entry = _ENTRIES[kind]
    if y.device.type != "cuda":
        raise ValueError(f"the {name} kernel takes CUDA tensors, got "
                         f"{y.device}")
    for t in (y, u, v):
        if t.device != y.device or t.dtype != torch.uint8:
            raise ValueError(f"the {name} kernel takes u8 planes on one "
                             f"device, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"the {name} kernel takes contiguous planes")
    if not 0 < y.shape[0] <= 65535:
        raise ValueError(f"batch {y.shape[0]} outside 1..65535")
    lib = _build.library()
    if lib.gmat_rungs_args_size() != ctypes.sizeof(_RungsArgs):
        raise RuntimeError("_RungsArgs does not match RungsArgs in "
                           "csrc/rungs.cu")
    ops = _kernel_operands(kind, geom, str(y.device))
    n, sizes = y.shape[0], geom[4]
    outs = [tuple(torch.empty(shape, dtype=torch.uint8, device=y.device)
                  for shape in ((n, oh, ow), (n, oh // 2, ow // 2),
                                (n, oh // 2, ow // 2)))
            for ow, oh in sizes]
    for lo in range(0, len(sizes), MAX_RUNGS):
        args = _rungs_args(y, u, v, outs[lo:lo + MAX_RUNGS],
                           ops[lo:lo + MAX_RUNGS])
        with torch.cuda.device(y.device):
            err = getattr(lib, entry)(ctypes.byref(args),
                                      torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name} launch failed: "
                               f"{_build.error_string(err)}")
        LAUNCHES[name] += 1
    return outs


# ------------------------------------------------------------ public API

def fused_rungs(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, sizes,
                method: str = "bilinear", quant: str = "auto",
                reference: bool = False) -> list:
    """One fused pass: YUV420 u8 batch -> every ABR rung's YUV420 planes.

    sizes: sequence of (out_w, out_h), all even.  Returns a list of
    (y, u, v) u8 tuples, one per rung: (N, oh, ow), (N, oh/2, ow/2) x2.

    quant: "auto" takes the int8 row stage while tap quantization holds
    tolerance (`_rung_i8_ok`); "i8"/"bf16" force a kernel.  int8 rows hold
    <= 3 u8-LSB of the exact resize on pure noise, bf16 <= 1.
    """
    sizes = _validate(sizes, method, quant)
    if y.dim() != 3 or u.dim() != 3 or u.shape != v.shape \
            or u.shape[0] != y.shape[0]:
        raise ValueError(f"planes must be (N,H,W) with equal chroma shapes, "
                         f"got {tuple(y.shape)}, {tuple(u.shape)}, "
                         f"{tuple(v.shape)}")
    n, h, w = y.shape
    ch, cw = u.shape[1], u.shape[2]
    kind = resolve_quant(h, ch, sizes, method, quant)
    geom = (h, w, ch, cw, sizes, method)
    if reference or y.device.type == "cpu":
        return _PLAIN[kind](y, u, v, _plain_operands(kind, geom,
                                                     str(y.device)))
    return _launch(kind, y, u, v, geom)
