#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA Hopper card.

    python3 chip_smoke.py          # from the repo root; needs one CUDA device

Builds the ladder kernels (gmat_tpu_torch/csrc/ladder.cu) with nvcc, runs
`preprocess_nchw` on a 64 x 1080p yuv420p batch -> (64, 3, 224, 224) f32,
and holds every kernel against its plain PyTorch version on the card:

  device       card name, compute capability, power limit, kernel build
  main_path    K1 (ladder_i8) through preprocess_nchw, quality gate vs the
               exact path, a crop + smooth + flip case
  ladder_bf16  K2 (ladder_bf16): use_kernel="bf16", yuv420p10, yuv444p
  ladder_wide  K3 (ladder_i8 at 8K) and a 5760x3240 frame
  timing       CUDA-event medians: kernel, plain version, separate-op path

Each phase prints one JSON line.  Then come the card's name and power
limit (nvidia-smi), the kernels line, and last
{"ok": true, "device": {...}}.  Any failed check raises: the script then
exits non-zero and prints no result line.  Launch counters are zeroed
just before each phase drives its path and read just after; launches made
to compare or time a kernel are not counted.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
N, H, W, OUT = 64, 1080, 1920, 224
HBM_BYTES_PER_S = 3.35e12             # H100 SXM, published
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12}
LSB_I8, LSB_BF16, LSB_GATE = 0.01, 1.0, 1.5   # u8 LSBs
JAX = "gmat_tpu/ops/pallas_kernels.py"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def lsb(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest difference in u8 LSBs (outputs are normalized to [0, 1])."""
    return float((a - b).abs().max()) * 255.0


def zero_counts(ladder) -> None:
    for k in ladder.LAUNCHES:
        ladder.LAUNCHES[k] = 0


class Planes:
    """Random planes made on the card from one seeded generator."""

    def __init__(self, seed: int):
        self.gen = torch.Generator(device="cuda").manual_seed(seed)

    def __call__(self, n, h, w, ch, cw, hi=256, dtype=torch.uint8):
        def one(shape):
            return torch.randint(0, hi, shape, generator=self.gen,
                                 device="cuda", dtype=torch.int32).to(dtype)
        return one((n, h, w)), one((n, ch, cw)), one((n, ch, cw))


def smooth_content(h: int, w: int):
    """bench.py's quality-gate frame: gradients, not noise."""
    sy = np.tile(np.linspace(20, 230, w, dtype=np.float32), (h, 1))
    sy = (sy + np.linspace(0, 20, h, dtype=np.float32)[:, None]).astype(np.uint8)
    su = np.tile(np.linspace(50, 200, w // 2, dtype=np.float32),
                 (h // 2, 1)).astype(np.uint8)
    sv = np.tile(np.linspace(200, 60, w // 2, dtype=np.float32),
                 (h // 2, 1)).astype(np.uint8)
    return sy[None], su[None], sv[None]


def event_ms(fn, calls: int = 10, reps: int = 7):
    """Median over `reps` of the mean device time of `calls` calls of
    fn(i) (CUDA events), every run, and the median host time to issue a
    call (no synchronisation inside the loop)."""
    for i in range(2):
        fn(i)
    torch.cuda.synchronize()
    times, host = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for i in range(calls):
            fn(i)
        host.append((time.perf_counter() - t0) * 1e3 / calls)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times), times, statistics.median(host)


def raw_launcher(ladder, kind, y, u, v, geom, c):
    """Launch the kernel from prebuilt arguments (no per-call host work),
    so that event time is device time.  Not counted in LAUNCHES."""
    from gmat_tpu_torch.ops import _build
    ops = ladder._kernel_operands(kind, geom, str(y.device))
    out = torch.empty((y.shape[0], 3, geom[4], geom[5]), device=y.device)
    args = ladder._ladder_args(y, u, v, out, ops, c)
    entry = getattr(_build.library(), ladder._ENTRIES[(kind, y.dtype)][1])
    stream = torch.cuda.current_stream().cuda_stream

    def go():
        err = entry(ctypes.byref(args), stream)
        check(err == 0, f"{kind} launch: {_build.error_string(err)}")
        return out
    return go


def bound(ladder, kind, geom, n, itemsize):
    """Least time for the work this geometry needs on an H100 SXM: bytes of
    the 32-byte sectors holding input samples with a nonzero weight (each
    read once), the band operands and the f32 output, over the memory
    rate; nonzero multiply-adds over the peak rate for their type."""
    h, w, ch, cw, oh, ow = geom[:6]
    m = ladder._ladder_matrices(kind, geom)
    bytes_in = ops_row = ops_col = 0
    for ah, aw, pw, planes in ((m["ahy"], m["awy"], w, 1),
                               (m["ahc"], m["awc"], cw, 2)):
        rows = np.flatnonzero((ah != 0).any(axis=0))
        cols = np.flatnonzero((aw != 0).any(axis=1))
        addr = rows[:, None] * (pw * itemsize) + cols[None, :] * itemsize
        bytes_in += planes * np.unique(addr // 32).size * 32
        ops_row += planes * 2 * int((ah != 0).sum()) * cols.size
        ops_col += planes * 2 * int((aw != 0).sum()) * oh
    ops_bytes = sum(t.numel() * t.element_size()
                    for v in ladder._kernel_operands(kind, geom, "cuda:0").values()
                    for t in (v if isinstance(v, tuple) else (v,))
                    if isinstance(t, torch.Tensor))
    total = n * bytes_in + ops_bytes + n * 3 * oh * ow * 4
    row_peak = PEAK_OPS["int8"] if kind == "i8" else PEAK_OPS["bf16"]
    t_bytes = total / HBM_BYTES_PER_S * 1e3
    t_ops = (n * ops_row / row_peak + n * ops_col / PEAK_OPS["bf16"]) * 1e3
    dense = n * (h * w + 2 * ch * cw) * itemsize + n * 3 * oh * ow * 4
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(total), "ops": int(n * (ops_row + ops_col)),
            "dense_bytes": int(dense)}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script needs one CUDA device")
    from gmat_tpu_torch.core.frame import FrameBatch
    from gmat_tpu_torch.ops import _build, fused, ladder

    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------------- device
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    check(cap == (9, 0), f"compute capability {cap}, want (9, 0)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.library()
    emit("device", name=name, capability=list(cap), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_s=time.perf_counter() - t0,
         ptxas=_build.BUILD_INFO.get("ptxas", ""))

    make = Planes(SEED)
    bufs = [FrameBatch(dict(zip("yuv", make(N, H, W, H // 2, W // 2))),
                       "yuv420p", W, H).validate() for _ in range(2)]
    yuv0 = tuple(bufs[0].planes[k] for k in "yuv")

    # ------------------------------------------------- main path (K1)
    zero_counts(ladder)
    out = fused.preprocess_nchw(bufs[0], OUT, OUT)
    torch.cuda.synchronize()
    main_counts = dict(ladder.LAUNCHES)
    check(tuple(out.shape) == (N, 3, OUT, OUT) and out.dtype == torch.float32,
          f"main path gave {tuple(out.shape)} {out.dtype}")
    check(bool(torch.isfinite(out).all()), "main path output not finite")
    check(main_counts == {"ladder_i8": 1, "ladder_bf16": 0},
          f"main path launches {main_counts}")
    ref = ladder.fused_ladder_i8(*yuv0, OUT, OUT, reference=True)
    err_k1 = lsb(out, ref)
    check(err_k1 <= LSB_I8, f"ladder_i8 vs plain: {err_k1} LSB")

    sm = tuple(torch.as_tensor(p, device="cuda") for p in smooth_content(H, W))
    fb_s = FrameBatch(dict(zip("yuv", sm)), "yuv420p", W, H)
    gate = lsb(fused.preprocess_nchw(fb_s, OUT, OUT),
               fused.preprocess_nchw(fb_s, OUT, OUT, exact=True))
    check(gate <= LSB_GATE, f"quality gate: {gate} LSB vs exact")

    fusions = dict(crop_box=(240, 0, 1440, 1080),
                   smooth=(3, 3, 0.0, 0.0, "replicate"), flip_code=1)
    zero_counts(ladder)
    got = fused.preprocess_nchw(bufs[0], OUT, OUT, **fusions)
    torch.cuda.synchronize()
    fused_counts = dict(ladder.LAUNCHES)
    check(sum(fused_counts.values()) == 1, f"fused case {fused_counts}")
    want = fused.preprocess_nchw(bufs[0], OUT, OUT, use_kernel="reference",
                                 **fusions)
    err_fused = lsb(got, want)
    tol = LSB_I8 if fused_counts["ladder_i8"] else LSB_BF16
    check(err_fused <= tol, f"crop+smooth+flip vs plain: {err_fused} LSB")
    emit("main_path", shape=list(out.shape), launches=main_counts,
         max_lsb_vs_plain=err_k1, quality_gate_lsb=gate,
         fused_case_launches=fused_counts, fused_case_max_lsb=err_fused)

    # ------------------------------------------------------ K2 (bf16)
    p10 = make(N, H, W, H // 2, W // 2, hi=1024, dtype=torch.uint16)
    fb10 = FrameBatch(dict(zip("yuv", p10)), "yuv420p10", W, H).validate()
    p444 = make(N, H, W, H, W)
    fb444 = FrameBatch(dict(zip("yuv", p444)), "yuv444p", W, H).validate()
    zero_counts(ladder)
    k2_u8 = fused.preprocess_nchw(bufs[0], OUT, OUT, use_kernel="bf16")
    k2_10 = fused.preprocess_nchw(fb10, OUT, OUT)
    k2_444 = fused.preprocess_nchw(fb444, OUT, OUT)
    torch.cuda.synchronize()
    bf16_counts = dict(ladder.LAUNCHES)
    check(bf16_counts == {"ladder_i8": 0, "ladder_bf16": 3},
          f"bf16 phase launches {bf16_counts}")
    errs_k2 = {
        "u8": lsb(k2_u8, ladder.fused_ladder(*yuv0, OUT, OUT,
                                             reference=True)),
        "yuv420p10": lsb(k2_10, fused.preprocess_nchw(
            fb10, OUT, OUT, use_kernel="reference")),
        "yuv444p": lsb(k2_444, fused.preprocess_nchw(
            fb444, OUT, OUT, use_kernel="reference")),
    }
    for lane, e in errs_k2.items():
        check(e <= LSB_BF16, f"ladder_bf16 {lane} vs plain: {e} LSB")
    for t in (k2_u8, k2_10, k2_444):
        check(bool(torch.isfinite(t).all()), "bf16 output not finite")
    emit("ladder_bf16", launches=bf16_counts, max_lsb_vs_plain=errs_k2)

    # ---------------------------------------------- K3 (8K) and 5760
    n8 = 8
    p8k = make(n8, 4320, 7680, 2160, 3840)
    p57 = make(1, 3240, 5760, 1620, 2880)
    zero_counts(ladder)
    k3 = ladder.fused_ladder_i8(*p8k, OUT, OUT)
    k57 = ladder.fused_ladder_i8(*p57, 32, 32)
    torch.cuda.synchronize()
    wide_counts = dict(ladder.LAUNCHES)
    check(wide_counts == {"ladder_i8": 2, "ladder_bf16": 0},
          f"wide phase launches {wide_counts}")
    err_k3 = lsb(k3, ladder.fused_ladder_i8(*p8k, OUT, OUT, reference=True))
    err_57 = lsb(k57, ladder.fused_ladder_i8(*p57, 32, 32, reference=True))
    check(err_k3 <= LSB_I8 and err_57 <= LSB_I8,
          f"wide vs plain: 8K {err_k3}, 5760x3240 {err_57} LSB")
    emit("ladder_wide", launches=wide_counts, max_lsb_vs_plain_8k=err_k3,
         max_lsb_vs_plain_5760x3240=err_57, shape_8k=list(k3.shape))

    # ---------------------------------------------------------- timing
    geom = (H, W, H // 2, W // 2, OUT, OUT, "bilinear", None, None, None)
    c8 = ladder._epilogue("bt709", 8, 255.0, (0.0, 0.0, 0.0))
    c10 = ladder._epilogue("bt709", 10, 1023.0, (0.0, 0.0, 0.0))
    yuv1 = tuple(bufs[1].planes[k] for k in "yuv")
    p10b = make(N, H, W, H // 2, W // 2, hi=1024, dtype=torch.uint16)
    p8kb = make(n8, 4320, 7680, 2160, 3840)
    geom8k = (4320, 7680, 2160, 3840, OUT, OUT, "bilinear", None, None,
              None)
    cases = {   # name: (kind, geometry, constants, two input buffers)
        "ladder_i8": ("i8", geom, c8, (yuv0, yuv1)),
        "ladder_bf16": ("bf16", geom, c8, (yuv0, yuv1)),
        "ladder_bf16_u16": ("bf16", geom, c10, (p10, p10b)),
        "ladder_i8_8k": ("i8", geom8k, c8, (p8k, p8kb)),
    }
    timing = {}
    for case, (kind, g, c, pair) in cases.items():
        go = [raw_launcher(ladder, kind, *p, g, c) for p in pair]
        ms, runs, host_ms = event_ms(lambda i: go[i % 2]())
        pops = [ladder._plain_operands(kind, g, "cuda:0")]
        plain_ms, _, _ = event_ms(
            lambda i: ladder._PLAIN[kind](*pair[i % 2], pops[0], c),
            calls=2, reps=5)
        n = pair[0][0].shape[0]
        b = bound(ladder, kind, g, n, pair[0][0].element_size())
        timing[case] = {"ms": ms, "runs_ms": runs, "host_ms": host_ms,
                        "plain_ms": plain_ms,
                        "frames": n, "frames_per_s": n / ms * 1e3,
                        "launches_per_batch": 1,
                        "bound_share": b["bound_ms"] / ms, **b}
    e2e_ms, e2e_runs, e2e_host = event_ms(
        lambda i: fused.preprocess_nchw(bufs[i % 2], OUT, OUT))
    sep_ms, _, _ = event_ms(
        lambda i: fused.preprocess_nchw(bufs[i % 2], OUT, OUT,
                                        use_kernel="never"),
        calls=2, reps=5)
    emit("timing", kernels=timing,
         preprocess_nchw={"ms": e2e_ms, "runs_ms": e2e_runs,
                          "host_ms": e2e_host,
                          "frames_per_s": N / e2e_ms * 1e3},
         separate_op_path={"ms": sep_ms, "frames_per_s": N / sep_ms * 1e3},
         nvidia_smi=smi)

    # --------------------------------------------------------- summary
    def row(name, case, replaces, jax_fn, launches, err):
        t = timing[case]
        return {"name": name, "route": "cuda",
                "source": "gmat_tpu_torch/csrc/ladder.cu",
                "replaces": f"{JAX}:{replaces}", "jax": f"{JAX}:{jax_fn}",
                "launches": launches, "max_abs_err": err / 255.0,
                "max_lsb": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": None}

    k2 = row("ladder_bf16", "ladder_bf16", 123, "_ladder_kernel",
             bf16_counts["ladder_bf16"], max(errs_k2.values()))
    k2.update(ms_u16=timing["ladder_bf16_u16"]["ms"],
              plain_ms_u16=timing["ladder_bf16_u16"]["plain_ms"],
              bound_ms_u16=timing["ladder_bf16_u16"]["bound_ms"])
    kernels = [
        row("ladder_i8", "ladder_i8", 455, "_ladder_kernel_i8",
            main_counts["ladder_i8"], err_k1),
        k2,
        row("ladder_i8 (K3 at 8K)", "ladder_i8_8k", 1230,
            "_ladder_kernel_i8_chunked", wide_counts["ladder_i8"],
            max(err_k3, err_57)),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
