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

import numpy as np
import torch

from . import _build
from .ladder import _band, _i8_quant_error_lsb, _row_col_operands, \
    _rowcol_i8_plain, _tensors
from .resize import f32_matmul, resample_matrix

LAUNCHES = {"rungs_i8": 0, "rungs_bf16": 0}

MAX_RUNGS = 8          # rungs per launch: RungsArgs holds 2 * MAX_RUNGS planes


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
    """Can fused_rungs take this geometry?  The kernels walk any frame up
    to MAX_SIDE samples a side (a tile record packs its source window in
    16 bits), so every ladder of even, positive rung sizes from such a
    frame fits (the TPU's answer depends on its VMEM budget)."""
    return 0 < h <= MAX_SIDE and 0 < w <= MAX_SIDE and all(
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
#
# The kernel (csrc/rungs.cu) runs one block per output tile, a th x tw
# block of one plane of one rung of one frame.  Per plane the host pads
# every band to two taps (a zero weight adds an exact zero), picks the
# tile, and uploads once per geometry a record per tile (its tile row and
# column and the source window it reads) and the band operands of every
# tile row and tile column as 16-byte-aligned records.

KOUT = 4                 # column stage: outputs per thread item (kOut)
GROUP = 16               # row stage: source columns per thread item (kGroup)
TILE = (32, 256)         # output rows x columns a plane's tile starts from
SMEM_BUDGET = 40 * 1024  # shared memory the tile choice keeps a block under
MAX_SIDE = 65535         # source samples a side: a window packs in 16 bits


def _band2(mat: np.ndarray) -> tuple:
    """(count, n_in) matrix -> first-tap index, the first index past the
    window (at least one tap), and (count, 2) weights."""
    lo, n, packed = _band(np.ascontiguousarray(mat))
    if packed.shape[1] > 2:
        raise ValueError(f"rung bands have at most 2 taps, got "
                         f"{packed.shape[1]}")
    w = np.zeros((mat.shape[0], 2), packed.dtype)
    w[:, :packed.shape[1]] = packed
    return lo, lo + np.maximum(n, 1), w


def _windows(lo: np.ndarray, hi: np.ndarray, t: int) -> np.ndarray:
    """(tiles, 2) source windows [lo, hi) of consecutive tiles of t
    outputs."""
    starts = np.arange(0, lo.size, t)
    return np.stack([np.minimum.reduceat(lo, starts),
                     np.maximum.reduceat(hi, starts)], axis=1)


def tvals_bytes(planes: int, th: int, tpitch: int) -> int:
    """A block's row-stage values, its shared memory (`tvals_bytes` in
    csrc/rungs.cu)."""
    return planes * th * tpitch * 2


def launch_smem(ops: list) -> int:
    """Dynamic shared memory of a launch over these rungs' operands."""
    return max(r[k]["tvals"] for r in ops for k in "yc")


def _tiling(rlo, rhi, clo, chi, planes: int) -> dict:
    """The tile of one plane: TILE, halved (columns down to 32, then rows,
    then columns) until its row-stage values fit SMEM_BUDGET; with the
    source windows and the row-stage pitch the kernel uses (the window's
    columns and the one after it, which a padded tap may read)."""
    th, tw = TILE
    while True:
        rwin, cwin = _windows(rlo, rhi, th), _windows(clo, chi, tw)
        nc = int((cwin[:, 1] - cwin[:, 0]).max())
        tpitch = (nc + GROUP) // GROUP * GROUP
        tvals = tvals_bytes(planes, th, tpitch)
        if tvals <= SMEM_BUDGET or (th, tw) == (1, KOUT):
            return dict(th=th, tw=tw, tpitch=tpitch, tvals=tvals, rwin=rwin,
                        cwin=cwin)
        if tw > 32:
            tw //= 2
        elif th > 1:
            th //= 2
        else:
            tw //= 2


def _bits(x: np.ndarray) -> np.ndarray:
    """int32 words of weights: int8 values as they are, others as f32
    bits."""
    if np.issubdtype(x.dtype, np.integer):
        return x.astype(np.int32)
    return np.ascontiguousarray(x, np.float32).view(np.int32)


def _records(lo, w, extra, t: int, win: np.ndarray) -> np.ndarray:
    """(tiles, k, t) int32 records of a band cut into tiles of t outputs:
    first taps, the two weights and `extra` columns (int32 words), padded
    past the last output with the last tile's window start and zeros."""
    pad = len(win) * t - lo.size
    cols = [np.concatenate([lo, np.full(pad, win[-1, 0])]).astype(np.int32)]
    for x in (w[:, 0], w[:, 1], *extra):
        cols.append(np.concatenate([_bits(x), np.zeros(pad, np.int32)]))
    return np.stack(cols).reshape(len(cols), len(win), t).transpose(1, 0, 2)


def _plane_operands(kind: str, ah, aw, off, planes: int, device) -> dict:
    """Kernel operands of one rung plane (luma, or the u/v pair): its
    tiling, tile records, and row and column records."""
    rlo, rhi, rw = _band2(ah)
    clo, chi, cw = _band2(aw.T)
    t = _tiling(rlo, rhi, clo, chi, planes)
    rwin, cwin = t.pop("rwin"), t.pop("cwin")
    if max(int(rwin.max()), int(cwin.max())) > MAX_SIDE:
        raise ValueError(f"rung planes are at most {MAX_SIDE} samples a side")
    ty, tx = np.meshgrid(np.arange(len(rwin)), np.arange(len(cwin)),
                         indexing="ij")
    span = [(win[:, 0] | (win[:, 1] - win[:, 0]) << 16).astype(np.uint32)
            .view(np.int32) for win in (rwin, cwin)]
    tiles = np.stack([ty.ravel(), tx.ravel(), span[0][ty.ravel()],
                      span[1][tx.ravel()]], axis=1).astype(np.int32)
    rows = _records(rlo, rw, (off if kind == "i8" else
                              np.zeros(rlo.size, np.float32),), t["th"], rwin)
    cols = _records(clo, cw, (), t["tw"], cwin)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)
    return dict(t, out_h=ah.shape[0], out_w=aw.shape[1],
                tiles_y=len(rwin), tiles_x=len(cwin), rows=dev(rows),
                cols=dev(cols), tiles=dev(tiles))


@lru_cache(maxsize=32)
def _kernel_operands(kind: str, geom: tuple, device: str) -> list:
    """Per rung, the operands of its luma plane ("y") and of its chroma
    pair ("c"), uploaded once per (kind, geometry, device)."""
    dev = torch.device(device)
    out = []
    for m in _rung_operands(kind, geom):
        r = {}
        for key, planes in (("y", 1), ("c", 2)):
            r[key] = _plane_operands(kind, m["ah" + key], m["aw" + key],
                                     m.get("off" + key), planes, dev)
            r[key]["inv_s"] = m.get("inv_s" + key, 1.0)
        out.append(r)
    return out


class _RungPlane(ctypes.Structure):
    """Mirror of `struct RungPlane` in csrc/rungs.cu."""
    _fields_ = ([("out", ctypes.c_void_p * 2)]
                + [(k, ctypes.c_void_p) for k in ("rows", "cols", "tiles")]
                + [(k, ctypes.c_int32) for k in ("out_h", "out_w", "th", "tw",
                                                  "tpitch")]
                + [("inv_s", ctypes.c_float)])


class _RungsArgs(ctypes.Structure):
    """Mirror of `struct RungsArgs` in csrc/rungs.cu."""
    _fields_ = ([(k, ctypes.c_void_p) for k in ("y", "u", "v")]
                + [(k, ctypes.c_int32) for k in ("n", "h", "w", "ch", "cw",
                                                  "n_rungs")]
                + [("tile0", ctypes.c_int32 * (2 * MAX_RUNGS + 1)),
                   ("plane", _RungPlane * (2 * MAX_RUNGS))])


def _plane_arg(ops: dict) -> _RungPlane:
    return _RungPlane(
        (ctypes.c_void_p * 2)(),
        *(ops[k].data_ptr() for k in ("rows", "cols", "tiles")),
        *(ops[k] for k in ("out_h", "out_w", "th", "tw", "tpitch")),
        ops["inv_s"])


def _args_template(h: int, w: int, ch: int, cw: int, ops: list) -> _RungsArgs:
    """Kernel arguments for up to MAX_RUNGS rungs with every operand and
    the tile counts in place; the planes, batch size and outputs are
    patched in per call (`_patch`)."""
    args = _RungsArgs(None, None, None, 0, h, w, ch, cw, len(ops))
    tiles = 0
    for slot, r in enumerate(ops):
        for k, key in enumerate("yc"):
            args.tile0[2 * slot + k] = tiles
            args.plane[2 * slot + k] = _plane_arg(r[key])
            tiles += r[key]["tiles_x"] * r[key]["tiles_y"]
    args.tile0[2 * len(ops)] = tiles
    return args


def _patch(args: _RungsArgs, y, u, v, outs: list) -> _RungsArgs:
    args.y, args.u, args.v, args.n = (y.data_ptr(), u.data_ptr(),
                                      v.data_ptr(), y.shape[0])
    plane = args.plane
    for slot, (yo, uo, vo) in enumerate(outs):
        plane[2 * slot].out[0] = yo.data_ptr()
        out = plane[2 * slot + 1].out
        out[0], out[1] = uo.data_ptr(), vo.data_ptr()
    return args


def _rungs_args(y, u, v, outs: list, ops: list) -> _RungsArgs:
    """Kernel arguments for up to MAX_RUNGS rungs: source pointers and
    shapes, and per rung plane its outputs, operands and tiling."""
    return _patch(_args_template(y.shape[1], y.shape[2], u.shape[1],
                                 u.shape[2], ops), y, u, v, outs)


@lru_cache(maxsize=32)
def _prepared(kind: str, geom: tuple, device: str) -> tuple:
    """The operands of one geometry and its argument templates, one per
    launch of MAX_RUNGS rungs (kept together: the templates hold the
    operands' device pointers)."""
    ops = _kernel_operands(kind, geom, device)
    h, w, ch, cw = geom[:4]
    return ops, [_args_template(h, w, ch, cw, ops[lo:lo + MAX_RUNGS])
                 for lo in range(0, len(ops), MAX_RUNGS)]


_ENTRIES = {"i8": ("rungs_i8", "gmat_rungs_i8"),
            "bf16": ("rungs_bf16", "gmat_rungs_bf16")}


@lru_cache(maxsize=4)
def _checked(lib) -> ctypes.CDLL:
    """The kernel library, once its RungsArgs is known to match ours."""
    if lib.gmat_rungs_args_size() != ctypes.sizeof(_RungsArgs):
        raise RuntimeError("_RungsArgs does not match RungsArgs in "
                           "csrc/rungs.cu")
    return lib


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
    fn = getattr(_checked(_build.library()), entry)
    _ops, templates = _prepared(kind, geom, str(y.device))
    n, sizes, dev = y.shape[0], geom[4], y.device
    outs = [(torch.empty((n, oh, ow), dtype=torch.uint8, device=dev),
             torch.empty((n, oh // 2, ow // 2), dtype=torch.uint8, device=dev),
             torch.empty((n, oh // 2, ow // 2), dtype=torch.uint8, device=dev))
            for ow, oh in sizes]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for k, tmpl in enumerate(templates):
            args = _patch(_RungsArgs.from_buffer_copy(tmpl), y, u, v,
                          outs[k * MAX_RUNGS:(k + 1) * MAX_RUNGS])
            err = fn(ctypes.byref(args), stream)
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
