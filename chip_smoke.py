#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA Hopper card.

    python3 chip_smoke.py          # from the repo root; needs one CUDA device

Builds the kernels (gmat_tpu_torch/csrc/ladder.cu and rungs.cu) with
nvcc, runs the port's two main paths at full size -- `preprocess_nchw` on a
64 x 1080p yuv420p batch -> (64, 3, 224, 224) f32, and the ABR ladder: a
96-frame 1080p Y4M file -> `decode_stream` -> `metrans.ladder_step` ->
rung planes on the host -- and holds every kernel against its plain
PyTorch version on the card:

  device           card name, compute capability, power limit, kernel build
  main_path        K1 (ladder_i8) through preprocess_nchw, quality gate vs
                   the exact path, a crop + smooth + flip case
  ladder_bf16      K2 (ladder_bf16): use_kernel="bf16", yuv420p10, yuv444p
  ladder_wide      K3 (ladder_i8 at 8K) and a 5760x3240 frame
  abr_ladder       K4 through the ABR path on the 1080p ladder 720p/540p/360p,
                   where the int8 tap gate picks the bf16 rows (rungs_bf16);
                   rung files written and read back as Y4M
  abr_ladder_i8    the same path on 720p/360p, where it picks int8 (rungs_i8)
  rungs_bf16       bf16 rows forced on the first batch, both ladders
  rungs_i8_forced  int8 rows forced on the 720p/540p/360p ladder
  rungs_wide       K5 (rungs_i8 at 8 x 4K) and a nearest-neighbour ladder
  metrans_session  run_session with libx264 rungs, where libavcodec exists
  timing           CUDA-event medians: kernel, plain version, library call,
                   separate-op path

Each phase prints one JSON line.  Then come the card's name and power
limit (nvidia-smi), the kernels line, and last
{"ok": true, "device": {...}}.  Any failed check raises: the script then
exits non-zero and prints no result line.  Launch counters are zeroed
just before each phase drives its path and read just after; launches made
to compare or time a kernel are not counted.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
N, H, W, OUT = 64, 1080, 1920, 224
HBM_BYTES_PER_S = 3.35e12             # H100 SXM, published
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12}
LSB_I8, LSB_BF16, LSB_GATE = 0.01, 1.0, 1.5   # u8 LSBs
JAX = "gmat_tpu/ops/pallas_kernels.py"
# ABR ladder: perf.py:319's ladder for a 1080p source, and its 720p/360p
# subset (every row tap quantizes within the int8 gate); 4K as in
# test_pallas.py:390-394
ABR_FRAMES, ABR_BATCH = 96, 32
LADDER_1080 = ((1280, 720), (960, 540), (640, 360))
LADDER_1080_I8 = ((1280, 720), (640, 360))
LADDER_4K = ((1920, 1080), (1280, 720), (960, 540))
# rung kernels (u8 outputs, in LSBs): against the plain version 1 (a sum
# in another order could cross a .5; 0 expected), against the exact
# resize 3 for int8 rows and 1 for bf16 (test_pallas.py:268-294)
LSB_RUNG_PLAIN = 1
LSB_RUNG_EXACT = {"i8": 3, "bf16": 1}
AV_LIBS = ("avformat", "avcodec", "avutil", "swscale", "swresample")


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


def write_y4m_source(path: str, n: int, h: int, w: int, seed: int) -> None:
    """A 4:2:0 u8 Y4M file: gradients plus noise, from one seed."""
    from gmat_tpu_torch.av.rawvideo import Y4MWriter
    rng = np.random.default_rng(seed)
    ramp_y = np.add.outer(np.linspace(16, 176, h), np.linspace(0, 50, w))
    ramp_c = np.add.outer(np.linspace(80, 150, h // 2),
                          np.linspace(-30, 30, w // 2))
    ramps = [r.astype(np.int16) for r in (ramp_y, ramp_c, 240 - ramp_c)]
    wr = Y4MWriter(path, w, h, (30, 1))
    try:
        for i in range(n):
            wr.write(*(np.clip(r + (i % 8) + rng.integers(
                -24, 25, r.shape, dtype=np.int16), 0, 255).astype(np.uint8)
                for r in ramps))
    finally:
        wr.close()


def rung_lsb(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int32) - b.to(torch.int32)).abs().max())


def rung_errors(rungs, planes, outs, sizes, quant, method="bilinear"):
    """Largest difference, in u8 LSBs over every plane of every rung, of
    `outs` from the plain version and from the exact per-plane resize
    rounded to u8."""
    from gmat_tpu_torch.ops.resize import resize_plane
    want = rungs.fused_rungs(*planes, sizes, method=method, quant=quant,
                             reference=True)
    plain = exact = 0
    for (ow, oh), got, ref in zip(sizes, outs, want):
        for g, r, src, shape in zip(got, ref, planes,
                                    ((oh, ow), (oh // 2, ow // 2),
                                     (oh // 2, ow // 2))):
            check(tuple(g.shape) == (src.shape[0], *shape)
                  and g.dtype == torch.uint8 and g.is_contiguous(),
                  f"rung plane {tuple(g.shape)} {g.dtype}, want {shape} u8")
            plain = max(plain, rung_lsb(g, r))
            exact = max(exact, rung_lsb(g, torch.clamp(torch.round(
                resize_plane(src, *shape, method)), 0, 255)))
    return plain, exact


def abr_ladder(phase, rungs, path, sizes, tmp):
    """The ABR main path once: the Y4M file -> decode_stream ->
    metrans.ladder_step per batch -> rung planes on the host, timed from
    the first read to the last copy; then every rung against its plain
    version and the exact resize, and the rung files written as Y4M and
    read back."""
    from gmat_tpu_torch.apps import metrans
    from gmat_tpu_torch.av.ingest import decode_stream
    from gmat_tpu_torch.av.rawvideo import Y4MReader, Y4MWriter
    quant = rungs.resolve_quant(H, H // 2, sizes, "bilinear", "auto")
    zero_counts(rungs)
    t0 = time.perf_counter()
    batches = []
    for fb, _pts, valid in decode_stream(path, batch=ABR_BATCH):
        outs = metrans.ladder_step(fb, sizes)
        host = [{k: rb.planes[k].cpu() for k in "yuv"} for rb in outs]
        batches.append((fb, outs, host, int(valid)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(rungs.LAUNCHES)
    frames = sum(b[3] for b in batches)
    check(frames == ABR_FRAMES, f"{phase}: {frames} frames decoded")
    want = {"rungs_i8": 0, "rungs_bf16": 0}
    want[f"rungs_{quant}"] = len(batches)
    check(counts == want, f"{phase} launches {counts}, want {want}")
    plain = exact = 0
    for fb, outs, _host, _valid in batches:
        check(all(rb.device.type == "cuda" and rb.format == "yuv420p"
                  for rb in outs), f"{phase}: rung batches off the card")
        p, e = rung_errors(rungs, tuple(fb.planes[k] for k in "yuv"),
                           [tuple(rb.planes[k] for k in "yuv")
                            for rb in outs], sizes, quant)
        plain, exact = max(plain, p), max(exact, e)
    check(plain <= LSB_RUNG_PLAIN, f"{phase} vs plain: {plain} LSB")
    check(exact <= LSB_RUNG_EXACT[quant], f"{phase} vs exact: {exact} LSB")
    read_back = {}
    for r, (ow, oh) in enumerate(sizes):
        out = os.path.join(tmp, f"{phase}_{ow}x{oh}.y4m")
        wr = Y4MWriter(out, ow, oh, (30, 1))
        for _fb, _outs, host, valid in batches:
            for j in range(valid):
                wr.write(*(host[r][k][j].numpy() for k in "yuv"))
        wr.close()
        rd = Y4MReader(out)
        got = list(rd.frames())
        rd.close()
        check(len(got) == ABR_FRAMES and all(
            f[0].shape == (oh, ow) and f[1].shape == (oh // 2, ow // 2)
            for f in got), f"{phase}: {out} read back {len(got)} frames")
        _fb, _outs, host, valid = batches[-1]
        check(np.array_equal(got[-1][2], host[r]["v"][valid - 1].numpy()),
              f"{phase}: {out} last frame differs from the rung")
        read_back[f"{ow}x{oh}"] = len(got)
    emit(phase, source=[ABR_FRAMES, H, W], batch=ABR_BATCH,
         rungs=[f"{ow}x{oh}" for ow, oh in sizes], quant=quant,
         launches=counts, max_lsb_vs_plain=plain, max_lsb_vs_exact=exact,
         y4m_read_back=read_back, wall_s=wall,
         source_frames_per_s=frames / wall)
    return {"quant": quant, "counts": counts, "plain": plain,
            "batches": batches}


def rung_launcher(rungs, kind, y, u, v, geom):
    """Launch a rung kernel from prebuilt arguments (no per-call host
    work), so that event time is device time.  Not counted in LAUNCHES."""
    from gmat_tpu_torch.ops import _build
    sizes = geom[4]
    check(len(sizes) <= rungs.MAX_RUNGS, "one launch per ladder")
    ops = rungs._kernel_operands(kind, geom, str(y.device))
    outs = [tuple(torch.empty(s, dtype=torch.uint8, device=y.device)
                  for s in ((y.shape[0], oh, ow),
                            (y.shape[0], oh // 2, ow // 2),
                            (y.shape[0], oh // 2, ow // 2)))
            for ow, oh in sizes]
    args = rungs._rungs_args(y, u, v, outs, ops)
    entry = getattr(_build.library(), rungs._ENTRIES[kind][1])
    stream = torch.cuda.current_stream().cuda_stream

    def go():
        err = entry(ctypes.byref(args), stream)
        check(err == 0, f"rungs_{kind} launch: {_build.error_string(err)}")
        return outs
    return go


def rung_bound(rungs, kind, geom, n):
    """Least time for one rung batch on an H100 SXM: bytes of the 32-byte
    sectors holding source samples with a nonzero weight in any rung (each
    read once for all rungs), the band operands and the u8 outputs, over
    the memory rate; nonzero multiply-adds (row stage on the input columns
    each rung needs, then column stage) over the peak rate for their
    type."""
    h, w, ch, cw, sizes = geom[:5]
    mats = rungs._rung_operands(kind, geom)
    bytes_in = ops_row = ops_col = 0
    for key, ph, pw, planes in (("y", h, w, 1), ("c", ch, cw, 2)):
        touched = np.zeros((ph, pw), bool)
        for m in mats:
            ah, aw = m["ah" + key], m["aw" + key]
            rows = np.flatnonzero((ah != 0).any(axis=0))
            cols = np.flatnonzero((aw != 0).any(axis=1))
            touched[np.ix_(rows, cols)] = True
            ops_row += planes * 2 * int((ah != 0).sum()) * cols.size
            ops_col += planes * 2 * int((aw != 0).sum()) * ah.shape[0]
        addr = np.flatnonzero(touched)          # one byte per sample
        bytes_in += planes * np.unique(addr // 32).size * 32
    ops_bytes = sum(t.numel() * t.element_size()
                    for r in rungs._kernel_operands(kind, geom, "cuda:0")
                    for v in r.values()
                    for t in (v if isinstance(v, tuple) else (v,))
                    if isinstance(t, torch.Tensor))
    out_bytes = n * sum(oh * ow + 2 * (oh // 2) * (ow // 2)
                        for ow, oh in sizes)
    total = n * bytes_in + ops_bytes + out_bytes
    row_peak = PEAK_OPS["int8"] if kind == "i8" else PEAK_OPS["bf16"]
    t_bytes = total / HBM_BYTES_PER_S * 1e3
    t_ops = (n * ops_row / row_peak + n * ops_col / PEAK_OPS["bf16"]) * 1e3
    dense = n * (h * w + 2 * ch * cw) + out_bytes
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(total), "ops": int(n * (ops_row + ops_col)),
            "dense_bytes": int(dense)}


def interpolate_rungs(y, u, v, sizes):
    """The library call for the same function: one bilinear
    F.interpolate per plane and rung (the half-pixel, edge-clamped
    resample of resample_matrix, in exact f32), rounded to u8."""
    import torch.nn.functional as F
    outs = []
    for ow, oh in sizes:
        outs.append(tuple(
            torch.clamp(torch.round(F.interpolate(
                p.float()[:, None], size=s, mode="bilinear",
                align_corners=False)[:, 0]), 0, 255).to(torch.uint8)
            for p, s in ((y, (oh, ow)), (u, (oh // 2, ow // 2)),
                         (v, (oh // 2, ow // 2)))))
    return outs


def metrans_session(path, tmp):
    """run_session on the Y4M source with libx264 rungs, where the host
    runtime can be built (libav* present); otherwise say why not."""
    found = {lib: ctypes.util.find_library(lib) for lib in AV_LIBS}
    arch = subprocess.run(["g++", "-print-multiarch"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    headers = any(os.path.exists(os.path.join(d, "libavcodec", "avcodec.h"))
                  for d in ("/usr/include", f"/usr/include/{arch}",
                            "/usr/local/include"))
    print(json.dumps({"phase": "metrans_session_precondition",
                      "find_library": found, "libavcodec_headers": headers}),
          flush=True)
    if not (all(found.values()) and headers):
        emit("metrans_session", run=False,
             why="no libavcodec on this machine")
        return None
    from gmat_tpu_torch.apps import metrans
    from gmat_tpu_torch.av import toolkit as tk
    opts = metrans.Options(
        input_file=path, video_enc_param="codec=h264:preset=p1:constqp=28",
        rungs=[metrans.Rung(ow, oh, out_file=os.path.join(
            tmp, f"session_{ow}x{oh}_#.mp4")) for ow, oh in LADDER_1080])
    res = metrans.run_session(0, opts, batch=ABR_BATCH)
    check(res["frames_in"] == ABR_FRAMES
          and res["frames_out"] == ABR_FRAMES * len(LADDER_1080),
          f"metrans_session: {res}")
    counted = {}
    for r in opts.rungs:
        dm = tk.Demuxer(r.out_file.replace("#", "0"))
        dec = tk.Decoder.from_demuxer(dm)
        n = 0
        for pkt in dm:
            if pkt.stream == 0:
                n += sum(1 for _ in dec.decode(pkt.data, pkt.pts))
        n += sum(1 for _ in dec.decode(None))
        dims = (dm.width, dm.height)
        dm.close()
        dec.close()
        check(n == ABR_FRAMES and dims == (r.width, r.height),
              f"metrans_session: {r.out_file} has {n} frames at {dims}")
        counted[f"{r.width}x{r.height}"] = n
    emit("metrans_session", run=True, result=res, frames_per_file=counted)
    return res


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script needs one CUDA device")
    from gmat_tpu_torch.core.frame import FrameBatch
    from gmat_tpu_torch.ops import _build, fused, ladder, rungs

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
    del p57, k3, k57

    # ------------------------------------ ABR ladder (K4) and K5 (4K)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        src = os.path.join(tmp, "source_1080p.y4m")
        t0 = time.perf_counter()
        write_y4m_source(src, ABR_FRAMES, H, W, SEED)
        emit("abr_source", path_bytes=os.path.getsize(src),
             frames=ABR_FRAMES, write_s=time.perf_counter() - t0)
        abr = abr_ladder("abr_ladder", rungs, src, LADDER_1080, tmp)
        check(abr["quant"] == "bf16", "the 960x540 rung's 2:1 taps should "
              "send the 1080p ladder to bf16 rows, as the JAX gate does")
        abr_i8 = abr_ladder("abr_ladder_i8", rungs, src, LADDER_1080_I8,
                            tmp)
        check(abr_i8["quant"] == "i8", "720p/360p should take int8 rows")
        rung_src = [tuple(b[0].planes[k] for k in "yuv")
                    for b in abr["batches"][:2]]
        for b in abr["batches"] + abr_i8["batches"]:
            b[1].clear()
            b[2].clear()
        abr_i8_counts, abr_i8_plain = abr_i8["counts"], abr_i8["plain"]
        del abr_i8

        # each row stage forced on the first batch: bf16 on both ladders,
        # int8 on the one whose 960x540 rung the gate keeps off int8
        forced = {}
        for phase, quant, ladders in (
                ("rungs_bf16", "bf16", (LADDER_1080, LADDER_1080_I8)),
                ("rungs_i8_forced", "i8", (LADDER_1080,))):
            zero_counts(rungs)
            outs = [rungs.fused_rungs(*rung_src[0], sizes, quant=quant)
                    for sizes in ladders]
            torch.cuda.synchronize()
            counts = dict(rungs.LAUNCHES)
            want = {"rungs_i8": 0, "rungs_bf16": 0}
            want[f"rungs_{quant}"] = len(ladders)
            check(counts == want, f"{phase} launches {counts}")
            errs = [rung_errors(rungs, rung_src[0], o, sizes, quant)
                    for o, sizes in zip(outs, ladders)]
            plain, exact = max(e[0] for e in errs), max(e[1] for e in errs)
            check(plain <= LSB_RUNG_PLAIN and exact <= LSB_RUNG_EXACT[quant],
                  f"{phase}: {plain} LSB vs plain, {exact} vs exact")
            forced[quant] = plain
            emit(phase, ladders=[[f"{ow}x{oh}" for ow, oh in sizes]
                                 for sizes in ladders],
                 launches=counts, max_lsb_vs_plain=plain,
                 max_lsb_vs_exact=exact)
            del outs

        # K5: int8 rungs of 8 x 4K (one launch), and nearest at 720p
        n4k = 8
        p4k = make(n4k, 2160, 3840, 1080, 1920)
        zero_counts(rungs)
        k5 = rungs.fused_rungs(*p4k, LADDER_4K, quant="i8")
        torch.cuda.synchronize()
        k5_counts = dict(rungs.LAUNCHES)
        check(k5_counts == {"rungs_i8": 1, "rungs_bf16": 0},
              f"4K launches {k5_counts}")
        err_k5, exact_k5 = rung_errors(rungs, p4k, k5, LADDER_4K, "i8")
        near_sizes = ((640, 360), (320, 180))
        p720 = make(4, 720, 1280, 360, 640)
        zero_counts(rungs)
        near = rungs.fused_rungs(*p720, near_sizes, method="nearest")
        torch.cuda.synchronize()
        near_counts = dict(rungs.LAUNCHES)
        check(near_counts == {"rungs_i8": 1, "rungs_bf16": 0},
              f"nearest launches {near_counts}")
        err_near, exact_near = rung_errors(rungs, p720, near, near_sizes,
                                           "i8", method="nearest")
        check(err_k5 <= LSB_RUNG_PLAIN and err_near <= LSB_RUNG_PLAIN
              and exact_k5 <= LSB_RUNG_EXACT["i8"] and exact_near == 0,
              f"wide rungs: 4K {err_k5}/{exact_k5}, nearest "
              f"{err_near}/{exact_near} LSB vs plain/exact")
        emit("rungs_wide", source_4k=[n4k, 2160, 3840],
             rungs_4k=[f"{ow}x{oh}" for ow, oh in LADDER_4K],
             launches_4k=k5_counts, max_lsb_vs_plain_4k=err_k5,
             max_lsb_vs_exact_4k=exact_k5, launches_nearest=near_counts,
             max_lsb_vs_plain_nearest=err_near,
             max_lsb_vs_exact_nearest=exact_near)
        del k5, near, p720

        metrans_session(src, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

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
    p4kb = make(n4k, 2160, 3840, 1080, 1920)
    geom_r = (H, W, H // 2, W // 2, LADDER_1080, "bilinear")
    geom_4k = (2160, 3840, 1080, 1920, LADDER_4K, "bilinear")
    rung_cases = {   # name: (kind, geometry, two input buffers)
        "rungs_i8": ("i8", geom_r, rung_src),
        "rungs_bf16": ("bf16", geom_r, rung_src),
        "rungs_i8_4k": ("i8", geom_4k, (p4k, p4kb)),
    }
    for case, (kind, g, pair) in rung_cases.items():
        sizes = g[4]
        go = [rung_launcher(rungs, kind, *p, g) for p in pair]
        ms, runs, host_ms = event_ms(lambda i: go[i % 2]())
        _, _, wrapper_host_ms = event_ms(
            lambda i: rungs.fused_rungs(*pair[i % 2], sizes, quant=kind))
        pops = rungs._plain_operands(kind, g, "cuda:0")
        plain_ms, _, _ = event_ms(
            lambda i: rungs._PLAIN[kind](*pair[i % 2], pops),
            calls=2, reps=5)
        library_ms, _, _ = event_ms(
            lambda i: interpolate_rungs(*pair[i % 2], sizes),
            calls=2, reps=5)
        lib_lsb = max(rung_lsb(a, b) for ra, rb in zip(
            interpolate_rungs(*pair[0], sizes), go[0]()) for a, b in zip(ra, rb))
        n = pair[0][0].shape[0]
        b = rung_bound(rungs, kind, g, n)
        timing[case] = {"ms": ms, "runs_ms": runs, "host_ms": host_ms,
                        "wrapper_host_ms": wrapper_host_ms,
                        "plain_ms": plain_ms, "library_ms": library_ms,
                        "library_max_lsb_vs_kernel": lib_lsb,
                        "frames": n, "frames_per_s": n / ms * 1e3,
                        "rungs": [f"{ow}x{oh}" for ow, oh in sizes],
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
    def row(name, case, replaces, jax_fn, launches, err, source="ladder.cu",
            abs_err=None):
        t = timing[case]
        return {"name": name, "route": "cuda",
                "source": f"gmat_tpu_torch/csrc/{source}",
                "replaces": f"{JAX}:{replaces}", "jax": f"{JAX}:{jax_fn}",
                "launches": launches,
                "max_abs_err": err / 255.0 if abs_err is None else abs_err,
                "max_lsb": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t.get("library_ms")}

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
        # u8 outputs: the error is in u8 codes
        row("rungs_i8", "rungs_i8", 876, "_rungs_kernel_i8",
            abr_i8_counts["rungs_i8"], max(abr_i8_plain, forced["i8"]),
            "rungs.cu", max(abr_i8_plain, forced["i8"])),
        row("rungs_bf16", "rungs_bf16", 845, "_rungs_kernel",
            abr["counts"]["rungs_bf16"], max(abr["plain"], forced["bf16"]),
            "rungs.cu", max(abr["plain"], forced["bf16"])),
        row("rungs_i8 (K5 at 4K)", "rungs_i8_4k", 907,
            "_rungs_kernel_i8_chunked", k5_counts["rungs_i8"], err_k5,
            "rungs.cu", err_k5),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
