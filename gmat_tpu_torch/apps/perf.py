"""Perf harnesses — counterpart of `gmat_tpu/apps/perf.py`, the rebuilds of
the metrans perf apps (SURVEY §2.2 M14/M15), on the card.

    python -m gmat_tpu_torch.apps.perf decode  -i in.mp4 [-threads N]
        <- AppNvDecPerf (samples/AppNvDecPerf.cpp:27-171: packets preloaded,
           decode loop timed)
    python -m gmat_tpu_torch.apps.perf encode  [-codec libx264] [-frames N]
        <- AppNvEncPerf (samples/AppNvEncPerf.cpp:208-222)
    python -m gmat_tpu_torch.apps.perf extract -i in.mp4 [-interval N]
        <- AppExtractPerf fast-vs-normal cases (app/AppExtractPerf.cpp:
           100-140,226-240)
    python -m gmat_tpu_torch.apps.perf heif    [-frames N]
        <- AppHeifEnc/AppHeifDec fps loops (samples/AppHeifEnc.cpp:69-95)
    python -m gmat_tpu_torch.apps.perf jpeg    [-frames N]
        <- nvjpeg-path analog: device DCT + native entropy codec
    python -m gmat_tpu_torch.apps.perf ladder  [-frames N]
        <- the device transform ladder end-to-end
    python -m gmat_tpu_torch.apps.perf pipeline -i in.y4m
        <- sustained decode->device->fused-ladder throughput (the
           AppMeTrans-style live rate, host decode overlapped with the card)

Each prints a one-line JSON result with the JAX harness's field names.
The device cases run on the card unless `main(argv, device="cpu")` asks
for the host (the tests): on the card `ladder` and `ladder10` run the
bf16 ladder kernel (`ops/ladder.fused_ladder`, `fused_ladder_u16`),
`rungs` and `graph` the rung kernels (`ops/rungs.fused_rungs`),
`sustained` the int8 ladder kernel (`fused_ladder_i8`), and `infer` and
`pipeline` reach it through `ops/fused.preprocess_nchw`; on the host each
takes the separate-op path, as the JAX harness does off the TPU.  Device
time is read from CUDA events after a `torch.cuda.synchronize`: eager
PyTorch has none of the loop hoisting that the JAX harness's
loop-length timing cancels.  The batch sizes are the JAX harness's TPU
sizes on the card and its CPU sizes on the host.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def _synth(n, w, h, seed=0):
    rng = np.random.default_rng(seed)
    ys, us, vs = [], [], []
    for i in range(n):
        base = np.add.outer(np.linspace(20, 200, h), np.linspace(0, 50, w))
        ys.append(((base + i * 3) % 220 + 16).astype(np.uint8))
        us.append(np.full((h // 2, w // 2), 100 + i % 40, np.uint8))
        vs.append(np.full((h // 2, w // 2), 140 - i % 30, np.uint8))
    return ys, us, vs


def _dev(args) -> torch.device:
    from ..av.ingest import _device
    return _device(args.device)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _seconds(fn, iters: int, dev: torch.device) -> float:
    """Seconds for `iters` calls of fn: CUDA events around the calls on
    the card (after a synchronize), the host clock elsewhere."""
    _sync(dev)
    if dev.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return time.perf_counter() - t0


def _planes(dev, n, h, w, hi=256, dtype=np.uint8, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.integers(0, hi, s).astype(dtype))
                 .to(dev) for s in ((n, h, w), (n, h // 2, w // 2),
                                    (n, h // 2, w // 2)))


def perf_decode(args):
    from ..av import toolkit as tk
    dm = tk.Demuxer(args.input)
    pkts = [p for p in dm if p.stream == 0]       # preload, like the ref
    dec = tk.Decoder.from_demuxer(dm, args.threads)
    t0 = time.perf_counter()
    count = 0
    for p in pkts:
        count += sum(1 for _ in dec.decode(p.data, p.pts))
    count += sum(1 for _ in dec.decode(None))
    dt = time.perf_counter() - t0
    dm.close(); dec.close()
    return {"case": "decode", "frames": count, "fps": round(count / dt, 1),
            "threads": args.threads}


def perf_encode(args):
    from ..av import toolkit as tk
    w, h = args.width, args.height
    ys, us, vs = _synth(min(args.frames, 60), w, h)
    enc = tk.Encoder(args.codec, w, h, fps=(30, 1), preset="ultrafast",
                     crf=25.0, opts="x265-params=log-level=0"
                     if args.codec == "libx265" else "")
    t0 = time.perf_counter()
    npkts = 0
    for i in range(args.frames):
        k = i % len(ys)
        npkts += len(enc.encode(ys[k], us[k], vs[k], pts=i))
    npkts += len(enc.flush())
    dt = time.perf_counter() - t0
    enc.close()
    return {"case": "encode", "codec": args.codec, "frames": args.frames,
            "fps": round(args.frames / dt, 1)}


def perf_extract(args):
    from ..av.extractor import FrameExtractor
    out = {"case": "extract", "interval": args.interval}
    for fast in (True, False):
        fx = FrameExtractor(args.input,
                            frame_interval=args.interval if fast else 0)
        t0 = time.perf_counter()
        n = sum(1 for _ in fx.frames())
        dt = time.perf_counter() - t0
        key = "fast" if fast else "normal"
        out[key] = {"frames": n, "seconds": round(dt, 3),
                    "decoded": fx.n_decoded,
                    "skipped": fx.n_skipped_seek + fx.n_skipped_nonref}
        fx.close()
    out["speedup"] = round(out["normal"]["seconds"] /
                           max(out["fast"]["seconds"], 1e-9), 2)
    return out


def perf_heif(args):
    """HEIF still encode/decode fps (AppHeifEnc.cpp:69-95 analog).
    -workers N fans images out across host threads (one x265/HEVC
    session per worker — scales ~linearly with cores)."""
    from ..av import heif
    w, h = args.width, args.height
    ys, us, vs = _synth(1, w, h)
    frames = [(ys[0], us[0], vs[0])] * args.frames
    t0 = time.perf_counter()
    blobs = heif.encode_stills(frames, crf=22.0, workers=args.workers)
    enc_dt = time.perf_counter() - t0
    t0 = time.perf_counter()
    heif.decode_stills(blobs, workers=args.workers)
    dec_dt = time.perf_counter() - t0
    return {"case": "heif", "reps": args.frames, "workers": args.workers,
            "encode_fps": round(args.frames / enc_dt, 1),
            "decode_fps": round(args.frames / dec_dt, 1),
            "bytes": len(blobs[0])}


def _synth_batch(args, n):
    from ..core.frame import from_numpy_yuv420
    ys, us, vs = _synth(n, args.width, args.height)
    return from_numpy_yuv420(np.stack(ys), np.stack(us), np.stack(vs),
                             device=_dev(args))


def perf_jpeg(args):
    from ..av import jpeg_tpu
    dev = _dev(args)
    n = min(args.frames, 32)
    fb = _synth_batch(args, n)
    wk = args.workers
    datas = jpeg_tpu.encode_batch(fb, 90, workers=wk)     # warm up
    t0 = time.perf_counter()
    reps = max(args.frames // n, 1)
    for _ in range(reps):
        datas = jpeg_tpu.encode_batch(fb, 90, workers=wk)
    enc_dt = time.perf_counter() - t0
    jpeg_tpu.decode_batch(datas, workers=wk, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        jpeg_tpu.decode_batch(datas, workers=wk, device=dev)
    _sync(dev)       # the device dequant/IDCT runs asynchronously
    dec_dt = time.perf_counter() - t0
    return {"case": "jpeg", "images": n * reps, "workers": wk,
            "encode_fps": round(n * reps / enc_dt, 1),
            "decode_fps": round(n * reps / dec_dt, 1)}


def perf_mjpeg(args):
    """-c:v mjpeg_tpu video lane: device DCT/quant + range expansion,
    host entropy coding, packets into a real MJPEG container."""
    import tempfile

    from ..av import jpeg_tpu, toolkit as tk
    w, h = args.width, args.height
    n = min(args.frames, 32)
    fb = _synth_batch(args, n)
    wk = args.workers
    jpeg_tpu.encode_batch(fb, 90, workers=wk, expand_range=True)  # warm
    reps = max(args.frames // n, 1)
    with tempfile.TemporaryDirectory() as td:
        mux = tk.Muxer(td + "/out.mov", w, h, (30, 1),
                       **tk.mux_kwargs_for_encoder("mjpeg"))
        t0 = time.perf_counter()
        k = 0
        for _ in range(reps):
            for d in jpeg_tpu.encode_batch(fb, 90, workers=wk,
                                           expand_range=True):
                mux.write(tk.Packet(d, k, k, True, False, 0))
                k += 1
        dt = time.perf_counter() - t0
        mux.close()
    return {"case": "mjpeg", "frames": k, "workers": wk,
            "encode_fps": round(k / dt, 1)}


def perf_mjpegdec(args):
    """MJPEG decode lanes head-to-head: libavcodec software decode vs
    the device lane (host entropy fan-out + one batched dequant/IDCT on
    the card — the NVDEC-analog decode path)."""
    import tempfile

    from ..av import jpeg_tpu, toolkit as tk
    from ..av.ingest import decode_stream
    dev = _dev(args)
    w, h = args.width, args.height
    n = min(args.frames, 32)
    fb = _synth_batch(args, n)
    wk = args.workers
    with tempfile.TemporaryDirectory() as td:
        path = td + "/in.mov"
        mux = tk.Muxer(path, w, h, (30, 1),
                       **tk.mux_kwargs_for_encoder("mjpeg"))
        k = 0
        reps = max(args.frames // n, 1)
        for _ in range(reps):
            for d in jpeg_tpu.encode_batch(fb, 90, workers=wk):
                mux.write(tk.Packet(d, k, k, True, False, 0))
                k += 1
        mux.close()

        def drain(stream):
            cnt = 0
            for (_b, _pts, valid) in stream:
                cnt += valid
            _sync(dev)
            return cnt

        def drain_dev():
            return drain(jpeg_tpu.decode_stream_tpu(
                path, batch=min(16, n), workers=wk, device=dev))

        def drain_sw():
            return drain(decode_stream(path, batch=min(16, n),
                                       threads=args.threads, device=dev))

        drain_dev()                                  # warm up
        t0 = time.perf_counter()
        n_dev = drain_dev()
        dt_dev = time.perf_counter() - t0
        t0 = time.perf_counter()
        n_sw = drain_sw()
        dt_sw = time.perf_counter() - t0
    return {"case": "mjpegdec", "frames": n_dev, "workers": wk,
            "tpu_lane_fps": round(n_dev / dt_dev, 1),
            "avcodec_fps": round(n_sw / dt_sw, 1),
            "speedup": round(dt_sw / dt_dev, 2)}


def perf_ladder(args):
    from ..core.frame import FrameBatch
    from ..ops import fused
    from ..ops.ladder import fused_ladder
    dev = _dev(args)
    n, h, w = 64, args.height, args.width
    y, u, v = _planes(dev, n, h, w)
    if dev.type == "cuda":
        def fn():
            return fused_ladder(y, u, v, 224, 224)
    else:
        fb = FrameBatch({"y": y, "u": u, "v": v}, "yuv420p", w, h, "bt709")

        def fn():
            return fused.preprocess_nchw(fb, 224, 224)
    fn()
    iters = 20
    dt = _seconds(fn, iters, dev)
    return {"case": "ladder", "platform": dev.type,
            "fps": round(n * iters / dt, 1),
            "note": "per-call incl dispatch, CUDA events on the card"}


def perf_ladder10(args):
    """10-bit (P010) fused ladder rate — the ScaleP016/P016ToBgr* lane."""
    from ..core.frame import FrameBatch
    from ..ops import fused
    from ..ops.ladder import fused_ladder_u16
    dev = _dev(args)
    n, h, w = 32, args.height, args.width
    y, u, v = _planes(dev, n, h, w, hi=1024, dtype=np.uint16)
    if dev.type == "cuda":
        def fn():
            return fused_ladder_u16(y, u, v, 224, 224, 10)
    else:
        fb = FrameBatch({"y": y, "u": u, "v": v}, "yuv420p10", w, h,
                        "bt709")

        def fn():
            return fused.preprocess_nchw(fb, 224, 224, norm=1023.0,
                                         use_kernel="never")
    fn()
    iters = 20
    dt = _seconds(fn, iters, dev)
    return {"case": "ladder10", "platform": dev.type,
            "fps": round(n * iters / dt, 1),
            "note": "per-call incl dispatch, CUDA events on the card"}


def perf_rungs(args):
    """Multi-rung ABR kernel rate (AppMeTrans ScaleNv12-per-rung lane):
    all rungs' YUV planes from one fused pass, i8 vs bf16 rows on the
    card; one separate resize per rung on the host (`fps_xla`, the JAX
    harness's name for that path)."""
    from ..core.frame import FrameBatch
    from ..ops import resize as rsz
    from ..ops.rungs import fused_rungs
    dev = _dev(args)
    n, h, w = 32, args.height, args.width
    sizes = ((1280, 720), (960, 540), (640, 360)) if w >= 1920 else \
            ((w // 2, h // 2), (w // 4, h // 4))
    y, u, v = _planes(dev, n, h, w)
    out = {"case": "rungs", "platform": dev.type,
           "rungs": ["%dx%d" % s for s in sizes]}

    def rate(fn):
        fn()
        iters = 20
        return round(n * iters / _seconds(fn, iters, dev), 1)

    if dev.type == "cuda":
        for q in ("i8", "bf16"):
            out["fps_" + q] = rate(
                lambda q=q: fused_rungs(y, u, v, sizes, quant=q))
    else:
        fb = FrameBatch({"y": y, "u": u, "v": v}, "yuv420p", w, h, "bt709")
        out["fps_xla"] = rate(lambda: [rsz.resize(fb, ow, oh)
                                       for ow, oh in sizes])
    out["note"] = "per-call incl dispatch, CUDA events on the card"
    return out


def perf_infer(args):
    """In-graph inference rate (BASELINE config #4): the fused ladder
    feeding the bundled ESPCN SR model — the tensorrt-filter pipeline
    (scale_npp + format_cuda + tensorrt) with the frames staying on the
    card."""
    from ..core.frame import FrameBatch
    from ..filters.infer import InferFilter
    from ..ops import fused
    dev = _dev(args)
    n, h, w = (32 if dev.type == "cuda" else 4), args.height, args.width
    y, u, v = _planes(dev, n, h, w)
    filt = InferFilter(model="sr2x")
    fb = FrameBatch({"y": y, "u": u, "v": v}, "yuv420p", w, h, "bt709")

    def prog():
        return filt._run(fused.preprocess_nchw(fb, 224, 224))
    prog()
    iters = 10
    dt = _seconds(prog, iters, dev)
    return {"case": "infer", "platform": dev.type, "model": "sr2x",
            "in": f"{w}x{h}", "net_input": "224x224",
            "fps": round(n * iters / dt, 1)}


def perf_pipeline(args):
    """Sustained decode -> device -> fused-ladder throughput.

    -procs 1 (default): single-process decode (a Y4M needs no libav*).
    -procs N: N decode worker processes ship I420 planes over
    shared-memory rings into ONE consumer that batches, copies to the
    card from pinned buffers and runs the ladder — the RoundQueue fan-in
    at process scale (av/shm_ring.py; reference RoundQueue.h:5-63,
    AppMeTrans.cpp:165-226).  Aggregate decode scales ~procs x up to the
    host core count."""
    from ..ops import fused
    dev = _dev(args)
    t0 = time.perf_counter()
    total = 0
    procs = max(args.procs, 1)
    if procs > 1:
        from ..av.shm_ring import decode_stream_multiproc
        q = decode_stream_multiproc(args.input, procs=procs, batch=32,
                                    threads=args.threads or 1, device=dev)
    else:
        from ..av.ingest import decode_stream
        q = decode_stream(args.input, batch=32, threads=args.threads,
                          device=dev)
    try:
        for fb, pts, valid in q:
            fused.preprocess_nchw(fb, 224, 224)      # asynchronous launch
            total += int(valid)
    finally:
        q.close()
    _sync(dev)
    dt = time.perf_counter() - t0
    return {"case": "pipeline", "procs": procs, "frames": total,
            "fps": round(total / dt, 1),
            "note": "bound by host decode and the H2D copy; the ladder "
                    "kernel alone is timed by perf ladder/sustained"}


def _sustained_card(dev, host, h, w):
    """h2d-only, ladder-only and pipelined seconds per batch on the card:
    each batch is copied from pinned memory on a side stream into one of
    two device buffers allocated up front, while the int8 ladder kernel
    consumes the other buffer on the current stream."""
    from ..ops.ladder import fused_ladder_i8
    side = torch.cuda.Stream(dev)
    cur = torch.cuda.current_stream(dev)
    pinned = [tuple(torch.from_numpy(b[k]).pin_memory()
                    for k in ("y", "u", "v")) for b in host]
    dst = [tuple(torch.empty_like(t, device=dev) for t in b) for b in pinned]
    read = [None, None]     # the current stream's last read of dst[k]

    def h2d(k):
        with torch.cuda.stream(side):
            if read[k] is not None:     # the ladder is done with dst[k]
                side.wait_event(read[k])
            for d, s in zip(dst[k], pinned[k]):
                d.copy_(s, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(side)
        return k, ev

    def ladder(bufs):
        return fused_ladder_i8(*bufs, 224, 224)

    def consume(item):
        k, ev = item
        cur.wait_event(ev)
        out = ladder(dst[k])
        read[k] = torch.cuda.Event()
        read[k].record(cur)
        return out

    for k in range(2):                                # warm up
        consume(h2d(k))
    torch.cuda.synchronize(dev)
    reps = 20

    def timed(body):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        body()
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) / reps

    t_h2d = timed(lambda: [h2d(i % 2) for i in range(reps)])
    t_ladder = timed(lambda: [ladder(dst[i % 2]) for i in range(reps)])

    def pipelined():
        nxt = h2d(0)
        for i in range(reps):
            item, nxt = nxt, h2d((i + 1) % 2)
            consume(item)
    t_pipe = timed(pipelined)
    return t_h2d, t_ladder, t_pipe


def _sustained_host(dev, host, h, w):
    """The same three times on the host: a copy stands for the H2D, and a
    producer thread prepares batch k+1 while the ladder consumes k."""
    import concurrent.futures as cf

    from ..core.frame import FrameBatch
    from ..ops import fused

    def h2d(b):
        return tuple(torch.from_numpy(b[k].copy()) for k in ("y", "u", "v"))

    def ladder(bufs):
        y, u, v = bufs
        return fused.preprocess_nchw(FrameBatch(
            {"y": y, "u": u, "v": v}, "yuv420p", w, h, "bt709"), 224, 224)

    resident = [h2d(b) for b in host]
    ladder(resident[0])
    reps = 6
    t0 = time.perf_counter()
    for i in range(reps):
        h2d(host[i % 2])
    t_h2d = (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    for i in range(reps):
        ladder(resident[i % 2])
    t_ladder = (time.perf_counter() - t0) / reps
    with cf.ThreadPoolExecutor(1) as pool:
        nxt = pool.submit(h2d, host[0])
        t0 = time.perf_counter()
        for i in range(reps):
            cur = nxt.result()
            nxt = pool.submit(h2d, host[(i + 1) % 2])
            ladder(cur)
        nxt.result()
        t_pipe = (time.perf_counter() - t0) / reps
    return t_h2d, t_ladder, t_pipe


def perf_sustained(args):
    """Steady-state H2D + ladder overlap proof (the RoundQueue/pinned-
    staging analog, TransDataConverter.h:26-56): pre-decoded host frames
    -> batch k+1 uploads while the ladder consumes batch k.  Reports
    h2d-only, ladder-only, and pipelined per-batch times; overlap works
    when pipeline ~= max(h2d, ladder), not their sum."""
    dev = _dev(args)
    on_card = dev.type == "cuda"
    n, h, w = (8 if on_card else 4), args.height, args.width
    rng = np.random.default_rng(0)
    host = [{"y": rng.integers(0, 256, (n, h, w)).astype(np.uint8),
             "u": rng.integers(0, 256, (n, h // 2, w // 2)).astype(np.uint8),
             "v": rng.integers(0, 256, (n, h // 2, w // 2)).astype(np.uint8)}
            for _ in range(2)]
    t_h2d, t_ladder, t_pipe = (_sustained_card if on_card
                               else _sustained_host)(dev, host, h, w)
    serial = t_h2d + t_ladder
    return {"case": "sustained", "platform": dev.type, "batch": n,
            "h2d_ms_per_batch": round(t_h2d * 1e3, 2),
            "ladder_ms_per_batch": round(t_ladder * 1e3, 2),
            "pipelined_ms_per_batch": round(t_pipe * 1e3, 2),
            "serial_ms_per_batch": round(serial * 1e3, 2),
            "overlap_efficiency": round(serial / max(t_pipe, 1e-9), 3),
            "sustained_fps": round(n / t_pipe, 1),
            "note": "overlap works when pipelined ~= max(h2d, ladder); "
                    "on the card h2d is a pinned copy on a side stream"}


def _ingest_worker(path, threads, conn):
    """Child process: decode the whole clip, report (frames, seconds)."""
    import time as _t
    from ..av import toolkit as tk
    t0 = _t.perf_counter()
    dm = tk.Demuxer(path)
    dec = tk.Decoder.from_demuxer(dm, threads)
    count = 0
    for pkt in dm:
        if pkt.stream == 0:
            count += sum(1 for _ in dec.decode(pkt.data))
    count += sum(1 for _ in dec.decode(None))
    dm.close(); dec.close()
    conn.send((count, _t.perf_counter() - t0))
    conn.close()


def perf_ingest(args):
    """Host decode fan-out scaling (the AppNvDecScan / AppNvDecPerf
    N-thread census analog, AppNvDecPerf.cpp:155-171): M worker processes
    each full-decode the clip; reports per-M aggregate fps.  On an M-core
    host aggregate fps scales ~linearly until cores saturate (libav decode
    is CPU-bound and each worker is its own process, so no GIL/alloc
    contention)."""
    import multiprocessing as mp

    if not args.input:
        raise SystemExit("ingest needs -i clip")
    ctx = mp.get_context("spawn")
    rows = []
    max_procs = args.procs or 4
    for procs in (1, 2, 4):
        if procs > max_procs:
            break
        conns, workers = [], []
        t0 = time.perf_counter()
        for _ in range(procs):
            pa, ch = ctx.Pipe(False)
            w_ = ctx.Process(target=_ingest_worker,
                             args=(args.input, args.threads, ch))
            w_.start()
            # close OUR copy of the child end: a worker dying before
            # send() must surface as EOFError on recv, not a hang
            ch.close()
            conns.append(pa)
            workers.append(w_)
        results = [c.recv() for c in conns]
        for w_ in workers:
            w_.join()
        wall = time.perf_counter() - t0
        frames = sum(r[0] for r in results)
        # decode-only aggregate excludes process spawn/import time, which
        # dominates wall on short clips
        decode_fps = sum(r[0] / max(r[1], 1e-9) for r in results)
        rows.append({"procs": procs, "frames": frames,
                     "wall_s": round(wall, 2),
                     "aggregate_fps": round(frames / wall, 1),
                     "aggregate_decode_fps": round(decode_fps, 1)})
    base = rows[0]["aggregate_decode_fps"]
    return {"case": "ingest", "host_cores": os.cpu_count(),
            "rows": rows,
            "scaling_vs_1proc": [round(r["aggregate_decode_fps"] / base, 2)
                                 for r in rows],
            "note": "expect ~procs x scaling up to core count; flat on a "
                    "1-core host proves zero fan-out overhead"}


def _default_clip(args, frames=90, w=1280, h=720):
    """Synthesize (and cache) a clip so `perf saturation` runs with no
    args — the artifact stays reproducible from one command."""
    import tempfile
    if args.input:
        return args.input
    path = os.path.join(tempfile.gettempdir(),
                        f"gmat_perf_{w}x{h}_{frames}.mp4")
    if os.path.exists(path) and os.path.getsize(path) > 0:
        return path
    from ..av import toolkit as tk
    ys, us, vs = _synth(frames, w, h)
    enc = tk.Encoder("libx264", w, h, fps=(30, 1), preset="ultrafast",
                     crf=28.0, gop=30)
    pkts = []
    for i in range(frames):
        pkts += enc.encode(ys[i], us[i], vs[i], pts=i)
    pkts += enc.flush()
    # write-then-rename: an interrupt mid-mux must not leave a truncated
    # cache file that poisons every later run's numbers.  The tmp name
    # must still END in .mp4 — libavformat guesses the muxer from the
    # extension
    tmp = path + f".tmp{os.getpid()}.mp4"
    mux = tk.Muxer(tmp, w, h, (30, 1), tk.CODEC_H264, enc.extradata())
    try:
        for pk in pkts:
            mux.write(pk)
        mux.close(); enc.close()
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def perf_saturation(args):
    """ONE artifact for the 'saturating host-decode ingest' claim:
    decode-bound fps/core, shm-ring fan-in scaling, and the end-to-end
    rate onto the device ladder, in a single JSON blob.  Reference shape:
    AppNvDecPerf.cpp:155-171 N-way census."""
    import multiprocessing as mp

    from ..av.shm_ring import decode_stream_multiproc
    from ..ops import fused
    dev = _dev(args)
    clip = _default_clip(args)

    # 1) decode-bound fps per core (isolated worker process, no device)
    ctx = mp.get_context("spawn")
    pa, ch = ctx.Pipe(False)
    w_ = ctx.Process(target=_ingest_worker, args=(clip, args.threads, ch))
    w_.start(); ch.close()
    frames, secs = pa.recv()
    w_.join()
    decode_fps_core = round(frames / max(secs, 1e-9), 1)

    # 2) shm-ring fan-in scaling (aggregate decode->consumer frames/s,
    #    batches staged on the device, no device compute: isolates the
    #    transport)
    fan_rows = []
    max_procs = args.procs or 2
    for procs in (1, 2, 4):
        if procs > max_procs:
            break
        t0 = time.perf_counter()
        n, t_first, n_first = 0, None, 0
        for fb, pts, valid in decode_stream_multiproc(
                clip, procs=procs, batch=16, threads=args.threads or 1,
                device=dev):
            if t_first is None:
                t_first, n_first = time.perf_counter(), int(valid)
            n += int(valid)
        t_end = time.perf_counter()
        row = {"procs": procs, "frames": n,
               "fanin_fps": round(n / (t_end - t0), 1)}
        # steady-state rate: excludes worker spawn + import, which
        # dominates short clips
        if t_first is not None and n > n_first and t_end > t_first:
            row["fanin_fps_steady"] = round((n - n_first)
                                            / (t_end - t_first), 1)
        fan_rows.append(row)

    # 3) end-to-end: decode -> shm ring -> device ladder
    t0 = time.perf_counter()
    total = 0
    for fb, pts, valid in decode_stream_multiproc(
            clip, procs=min(2, max_procs), batch=16,
            threads=args.threads or 1, device=dev):
        fused.preprocess_nchw(fb, 224, 224)
        total += int(valid)
    _sync(dev)
    e2e_fps = round(total / (time.perf_counter() - t0), 1)

    key = ("fanin_fps_steady" if all("fanin_fps_steady" in r
                                     for r in fan_rows) else "fanin_fps")
    base = fan_rows[0][key]
    return {"case": "saturation", "clip": os.path.basename(clip),
            "host_cores": os.cpu_count(),
            "decode_fps_per_core": decode_fps_core,
            "shm_ring_fanin": fan_rows,
            "fanin_scaling_vs_1proc": [round(r[key] / base, 2)
                                       for r in fan_rows],
            "e2e_ladder_fps": e2e_fps,
            "note": "ingest saturates when e2e ~= cores*decode_fps_per_"
                    "core; fan-in flat on one core proves zero transport "
                    "overhead"}


def perf_graph(args):
    """Filter-heavy rung graphs (the reference's per-res-filter scenario,
    VidFiltEx.h:33-46): the multi-rung ladder with 0 / 1 / 3 per-rung
    filters attached, run as metrans run_session applies them:
    FilterGraph.process on each rung's FrameBatch after the rung pass
    (the rung kernel on the card, one resize per rung on the host).
    Eager calls have no hoisting to cancel, so each row is an absolute
    time over `reps` batches."""
    from ..core.frame import FrameBatch
    from ..filters.graph import FilterGraph
    from ..ops import resize as rsz
    from ..ops.rungs import fused_rungs

    dev = _dev(args)
    on_card = dev.type == "cuda"
    n, h, w = (32 if on_card else 2), args.height, args.width
    bufs = [_planes(dev, n, h, w, seed=s) for s in (0, 1)]
    rungs = ((1280, 720), (640, 360))

    # eq (LUT contrast/brightness) + lutyuv (per-channel expression LUT)
    # + unsharp (band matmuls) — all YUV-native like the rung graphs
    # metrans attaches
    descs = {
        0: "",
        1: "eq=contrast=1.2:brightness=0.05",
        3: "eq=contrast=1.2:brightness=0.05,"
           "lutyuv=y=gammaval(0.9):u=val:v=val,unsharp=5:5:0.8",
    }

    def make(desc):
        graphs = [FilterGraph(desc, 30.0) if desc else None
                  for _ in rungs]

        def rung_outs(yy, uu, vv):
            if on_card:
                return fused_rungs(yy, uu, vv, rungs)
            fb = FrameBatch({"y": yy, "u": uu, "v": vv}, "yuv420p",
                            w, h, "bt709")
            outs = []
            for ow, oh in rungs:
                rb = rsz.resize(fb, ow, oh)
                outs.append((rb.planes["y"], rb.planes["u"],
                             rb.planes["v"]))
            return outs

        def step(i):
            for (ow, oh), g2, (ry, ru, rv) in zip(
                    rungs, graphs, rung_outs(*bufs[i % 2])):
                rb = FrameBatch({"y": ry, "u": ru, "v": rv},
                                "yuv420p", ow, oh, "bt709")
                if g2 is not None:
                    g2.process(rb)
        return step

    reps = 12 if on_card else 3
    rows = {}
    for k, desc in descs.items():
        step = make(desc)
        step(0)                                      # warm up
        count = iter(range(reps))
        dt = _seconds(lambda: step(next(count)), reps, dev)
        rows[str(k)] = {"fps": round(n * reps / dt, 1),
                        "timing": "absolute",
                        "desc": desc or "(bare ladder)"}
    base = rows["0"]["fps"]
    return {"case": "graph", "platform": dev.type, "batch": n,
            "src": f"{w}x{h}", "rungs": ["%dx%d" % r for r in rungs],
            "per_filters": rows,
            "rel_fps_vs_bare": {k: round(r["fps"] / base, 3)
                                for k, r in rows.items()},
            "note": "per-rung FilterGraph applied after the rung pass, "
                    "the metrans run_session path; fps = source frames "
                    "through ALL rungs+filters"}


CASES = {"decode": perf_decode, "encode": perf_encode,
         "extract": perf_extract, "heif": perf_heif, "jpeg": perf_jpeg,
         "mjpeg": perf_mjpeg, "mjpegdec": perf_mjpegdec,
         "ladder": perf_ladder, "ladder10": perf_ladder10,
         "rungs": perf_rungs, "infer": perf_infer,
         "pipeline": perf_pipeline, "graph": perf_graph,
         "sustained": perf_sustained, "ingest": perf_ingest,
         "saturation": perf_saturation}


def main(argv=None, device="cuda"):
    """gmat-perf: one case, one JSON line on stdout.  The device cases
    run on `device` (the card unless the caller asks for "cpu")."""
    from ..utils.compile_cache import enable as _enable_cache
    _enable_cache()     # reuse the kernel build across runs
    p = argparse.ArgumentParser(prog="gmat-perf")
    p.add_argument("case", choices=list(CASES))
    p.add_argument("-i", "--input", default="")
    p.add_argument("-codec", default="libx264")
    p.add_argument("-frames", type=int, default=100)
    p.add_argument("-interval", type=int, default=30)
    p.add_argument("-threads", type=int, default=0)
    p.add_argument("-width", type=int, default=1920)
    p.add_argument("-height", type=int, default=1080)
    p.add_argument("-workers", type=int, default=0,
                   help="still-image entropy/codec fan-out threads "
                        "(0 = host core count) for jpeg/heif cases")
    p.add_argument("-procs", type=int, default=0,
                   help="worker processes: ingest fan-out cap (default 4) "
                        "/ pipeline shm-ring decode workers (default 1)")
    args = p.parse_args(argv)
    args.device = device
    print(json.dumps(CASES[args.case](args)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
