"""AppMeTrans — 1->N ABR transcoding ladder, on the card.

Counterpart of `gmat_tpu/apps/metrans.py`, the port of
metrans/app/AppMeTrans (AppMeTrans.cpp:303-365, Options.h:12-72,
options.xml): XML-config-driven sessions, each decoding one input and
fanning out to N resolutions with encoder params and muxed files.

Execution model:
  * reference: decode thread -> RoundQueue ring -> N encoder threads each
    doing CUDA ScaleNv12 + NVENC (AppMeTrans.cpp:71-124)
  * here: `decode_stream` stages each decoded batch on the card; the
    device work of a batch is one `filtered_step`: the session's common
    filter graph (VideoFilterDesc), then one `ladder_step` for ALL rungs —
    on CUDA planes one launch of the rung kernel (`ops/rungs.fused_rungs`)
    that writes every rung's YUV planes, elsewhere one `ops/resize.resize`
    per rung — then each rung's own filter graph; host libx264/x265
    encoders run on worker threads fed by bounded queues (they release
    the GIL, overlapping encode with device work and decode).

Config: XML with the reference's tags (InputFile, Session, FpsLimit,
VideoEncParam, VideoFilterDesc, Resolutions/Resolution{Width,Height,
VideoFilterDesc,VideoEncParamSuffix,OutputFormat,OutputFile}).  '#' in
OutputFile is the session index, like the reference.  AudioFilterDesc
comes with the audio lane in slice 6 and ProcDecode with the
shared-memory ring in slice 7: until then each raises
NotImplementedError.
"""
from __future__ import annotations

import argparse
import dataclasses
import queue
import sys
import threading
import xml.etree.ElementTree as ET
from typing import List, Optional

import numpy as np
import torch

from ..core.frame import FrameBatch
from ..ops import csc, resize as rsz
from ..ops.rungs import fused_rungs, fused_rungs_fits


@dataclasses.dataclass
class Rung:
    width: int
    height: int
    filter_desc: str = ""
    enc_suffix: str = ""
    out_format: str = "mp4"
    out_file: str = "out_#.mp4"


@dataclasses.dataclass
class Options:
    input_file: str = ""
    sessions: int = 1
    fps_limit: int = 0
    video_enc_param: str = ""
    video_filter_desc: str = ""
    audio_codec: str = ""          # "aac" | "ac3" | "mp2" | "" (drop audio)
    audio_bitrate: int = 0
    audio_sample_rate: int = 0
    audio_filter_desc: str = ""    # e.g. "atempo=0.7143,volume=0.8"
    proc_decode: bool = False      # decode in a worker PROCESS per session
    rungs: List[Rung] = dataclasses.field(default_factory=list)

    @classmethod
    def load_xml(cls, path: str) -> "Options":
        root = ET.parse(path).getroot()

        def get(tag, default=""):
            el = root.find(tag)
            return el.text.strip() if el is not None and el.text else default

        o = cls(
            input_file=get("InputFile"),
            sessions=int(get("Session", "1") or 1),
            fps_limit=int(get("FpsLimit", "0") or 0),
            video_enc_param=get("VideoEncParam"),
            video_filter_desc=get("VideoFilterDesc"),
            audio_codec=get("AudioCodec"),
            audio_bitrate=int(get("AudioBitRate", "0") or 0),
            audio_sample_rate=int(get("AudioSampleRate", "0") or 0),
            audio_filter_desc=get("AudioFilterDesc"),
            proc_decode=get("ProcDecode", "0").strip() in ("1", "true"),
        )
        res = root.find("Resolutions")
        if res is not None:
            for r in res.findall("Resolution"):
                def g(tag, default=""):
                    el = r.find(tag)
                    return (el.text or default).strip() if el is not None and el.text else default
                o.rungs.append(Rung(
                    width=int(g("Width", "0") or 0),
                    height=int(g("Height", "0") or 0),
                    filter_desc=g("VideoFilterDesc"),
                    enc_suffix=g("VideoEncParamSuffix"),
                    out_format=g("OutputFormat", "mp4"),
                    out_file=g("OutputFile", "out_#.mp4"),
                ))
        return o


_NO_AUDIO_FILTERS = ("AudioFilterDesc needs the audio filters "
                     "(av/audio_filters), which the port gains in slice 6")


def _unported(opts: Options) -> None:
    """Raise for the options whose modules come in later slices."""
    if opts.audio_filter_desc:
        raise NotImplementedError(_NO_AUDIO_FILTERS)
    if opts.proc_decode:
        raise NotImplementedError(
            "ProcDecode needs the shared-memory decode ring (av/shm_ring), "
            "which the port gains in slice 7")


class EncoderWorker(threading.Thread):
    """Host encode+mux worker: consumes (y, u, v) I420 frames from a
    bounded queue (the RoundQueue consumer analog)."""

    def __init__(self, name, path, w, h, fps, enc_kwargs, depth=8,
                 audio=None):
        """audio: optional (codec_id, sample_rate, channels, extradata,
        packets) to interleave into the same container (the reference's
        audio lane, AppMeTrans.cpp:176-200)."""
        super().__init__(daemon=True, name=name)
        from ..av import toolkit as tk
        kw = dict(enc_kwargs)
        codec_name = kw.pop("codec_name", "libx264")
        fps_t = kw.pop("fps", fps)
        self.enc = tk.Encoder(codec_name, w, h, fps=fps_t, **kw)
        mux_kw = tk.mux_kwargs_for_encoder(codec_name)
        # AvMuxer: the enum directly, or a raw AVCodecID negated
        # (enum values 0-2 collide with AVCodecID 1/2 = mpeg1/mpeg2)
        vcodec = mux_kw.get("codec")
        if vcodec is None:
            vcodec = -mux_kw["codec_id"]
        if audio:
            acid, arate, ach, aextra, apkts = audio
            self.mux = tk.AvMuxer(path, w, h, fps_t, vcodec,
                                  self.enc.extradata(), acid, arate, ach,
                                  aextra)
            self.audio_pkts = apkts
            self.audio_rate = arate
            self.fps_t = fps_t
        else:
            self.audio_pkts = None    # makes _write_video's guard real
            self.mux = tk.Muxer(path, w, h, fps_t,
                                extradata=self.enc.extradata(), **mux_kw)
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.count = 0
        self.error: Optional[BaseException] = None

    def _write_video(self, pkt):
        if self.audio_pkts is not None and hasattr(self.mux, "write_video"):
            self.mux.write_video(pkt)
        else:
            self.mux.write(pkt)

    def run(self):
        try:
            # audio is PACED by video time instead of written up front:
            # dumping the whole track first bloats the muxer's
            # interleave queue and produces an all-audio-first layout
            apkts = self.audio_pkts or []
            ai = 0

            def pump_audio(upto_sec):
                nonlocal ai
                rate = max(getattr(self, "audio_rate", 1), 1)
                while ai < len(apkts) and \
                        apkts[ai].pts / rate <= upto_sec:
                    self.mux.write_audio(apkts[ai])
                    ai += 1

            n = 0
            while True:
                item = self.q.get()
                if item is None:
                    break
                y, u, v = item
                if apkts:
                    fn, fd = self.fps_t
                    pump_audio((n + 1) * fd / max(fn, 1))
                for pkt in self.enc.encode(y, u, v, pts=n):
                    self._write_video(pkt)
                n += 1
                self.count = n
            for pkt in self.enc.flush():
                self._write_video(pkt)
            pump_audio(float("inf"))      # tail past the video duration
            self.mux.close()
            self.enc.close()
        except BaseException as e:
            self.error = e

    def put(self, frame):
        while True:
            if self.error:
                raise self.error
            try:
                self.q.put(frame, timeout=0.5)
                return
            except queue.Full:
                continue

    def finish(self):
        while True:
            if not self.is_alive():
                return          # worker already died (error set)
            try:
                self.q.put(None, timeout=0.5)
                return
            except queue.Full:
                continue


def transcode_audio(opts: Options):
    """Decode the input's audio lane and re-encode it once per session
    (shared across rungs).  Returns the AvMuxer audio tuple or None."""
    from ..av import toolkit as tk

    if opts.audio_filter_desc:
        raise NotImplementedError(_NO_AUDIO_FILTERS)
    dm = tk.Demuxer(opts.input_file)
    info = tk.AudioInfo(dm)
    if not info.present:
        dm.close()
        return None
    rate = opts.audio_sample_rate or info.sample_rate
    ch = min(info.channels, 2) or 2
    # decoder downmixes to the encoder's channel count (>2ch sources)
    dec = enc = None
    try:
        dec = tk.AudioDecoder(info, sample_rate=rate, channels=ch)
        enc = tk.AudioEncoder(opts.audio_codec, rate, ch,
                              opts.audio_bitrate or 128000)
        pkts = []
        for pkt in dm:
            if pkt.stream != 1:
                continue
            for (chunk, _pts) in dec.decode(pkt.data, pkt.pts):
                if chunk.size:
                    pkts.extend(enc.encode(chunk))
        for (chunk, _pts) in dec.decode(None):
            if chunk.size:
                pkts.extend(enc.encode(chunk))
        pkts += enc.flush()
        return (enc.codec_id, rate, enc.channels, enc.extradata(), pkts)
    finally:   # native handles must not leak on a bad codec/stream
        dm.close()
        if dec is not None:
            dec.close()
        if enc is not None:
            enc.close()


def fused_ok(fb: FrameBatch, rung_sizes) -> bool:
    """Whether `ladder_step` takes the fused rung kernel for this batch:
    yuv420p planes on the card and a ladder of two or more even rungs
    (the JAX app asks the same of a TPU backend)."""
    return (fb.device.type == "cuda" and fb.format == "yuv420p"
            and len(rung_sizes) > 1
            and all((ow | oh) % 2 == 0 for ow, oh in rung_sizes)
            and fused_rungs_fits(fb.height, fb.width, rung_sizes))


def ladder_step(fb: FrameBatch, rung_sizes) -> List[FrameBatch]:
    """The per-batch device step: one decoded batch -> one batch per rung
    (out_w, out_h), on the batch's device.

    Where `fused_ok`, ONE kernel launch reads the source planes and writes
    every rung's YUV planes (vs ScaleNv12 per rung in the reference's
    EncodeVideoProc consumers); otherwise each rung is one resize."""
    if fused_ok(fb, rung_sizes):
        outs = fused_rungs(fb.planes["y"], fb.planes["u"], fb.planes["v"],
                           rung_sizes)
        return [FrameBatch({"y": yy, "u": uu, "v": vv}, "yuv420p", ow, oh,
                           fb.colorspace)
                for (ow, oh), (yy, uu, vv) in zip(rung_sizes, outs)]
    return [rsz.resize(fb, ow, oh) for ow, oh in rung_sizes]


def _for_encoder(rb: FrameBatch) -> FrameBatch:
    """A rung that a filter left in another format, back in the
    encoder's yuv420p."""
    if rb.fmt.is_rgb or rb.format != "yuv420p":
        return csc.convert(rb, "yuv420p")
    return rb


def rung_step(fb: FrameBatch, keep: np.ndarray, pts, meta, rung_sizes,
              rung_graphs=None) -> list:
    """`ladder_step` on a batch, then each rung's filter graph: one
    (FrameBatch, keep mask) per rung, on the batch's device.

    `keep` is the batch's mask after the common graph; a rung graph sees
    it (so stream filters skip dropped frames) with `pts` and the
    per-frame `meta` (times/keys/pos/interlaced).  A rung that a filter
    left in another format is converted back to yuv420p for the encoder;
    a rung with nothing kept is (None, its mask)."""
    rung_graphs = rung_graphs or [None] * len(rung_sizes)
    if fb.batch == 0:
        return [(None, np.zeros(0, bool)) for _ in rung_sizes]
    outs = []
    for g, rb in zip(rung_graphs, ladder_step(fb, rung_sizes)):
        rkeep = keep
        if g is not None:
            rb, rkeep = g.process(rb, pts=pts, keep=keep, **(meta or {}))
        outs.append((_for_encoder(rb) if rkeep.any() else None, rkeep))
    return outs


def filtered_step(fb: FrameBatch, pts, valid: int, rung_sizes,
                  common_graph=None, rung_graphs=None, src_meta=None,
                  tb_sec: float = 1.0 / 30.0):
    """The per-batch device work of a session, on the batch's device: the
    common filter graph, `ladder_step` on what it returns, then each
    rung's graph (`rung_step`).  Returns one (FrameBatch or None, keep
    mask) per rung.

    A common graph may drop, delay or re-time frames (select, yadif
    send_field): the rungs then see its output pts, and the times
    recomputed from them (`tb_sec` seconds per pts unit)."""
    if common_graph is not None:
        fb, keep = common_graph.process(fb, pts=pts, valid=valid,
                                        **(src_meta or {}))
        if common_graph.out_pts is not None:
            pts = common_graph.out_pts
        rmeta = {"times": pts * tb_sec} if pts is not None else None
    else:
        keep = np.ones(fb.batch, bool)
        keep[valid:] = False
        rmeta = src_meta
    return rung_step(fb, keep, pts, rmeta, rung_sizes, rung_graphs)


def _push_rung(w_: EncoderWorker, out: FrameBatch, keep: np.ndarray):
    idx = np.nonzero(keep)[0]
    if len(idx) == 0:
        return      # skip the D2H transfer when nothing survived
    planes = out.planes
    if len(idx) < out.batch:
        # sparse keep: gather kept frames ON DEVICE first (a full batch
        # is ~48MB of transfer per rung otherwise)
        sel = torch.as_tensor(idx, device=out.device)
        planes = {k: v.index_select(0, sel) for k, v in planes.items()}
    host = {k: v.cpu().numpy() for k, v in planes.items()}
    for j in range(len(idx)):
        w_.put((host["y"][j], host["u"][j], host["v"][j]))


def run_session(session_idx: int, opts: Options, batch: int = 16,
                frames_limit: int = 0, quiet: bool = True,
                device="cuda") -> dict:
    from ..av.ingest import decode_stream
    from ..filters.graph import FilterGraph
    from ..utils.encparam import parse_enc_param
    from ..utils.stopwatch import FpsLimiter, FpsMeter, StopWatch

    _unported(opts)
    watch = StopWatch()
    src = decode_stream(opts.input_file, batch=batch, device=device)
    src_fps = getattr(src, "fps", 0.0) or 30.0
    try:
        # pts timebase in seconds: container inputs use the stream
        # timebase, raw inputs stamp frame indices (1/fps)
        tb_sec = 1.0 / src_fps
        if not opts.input_file.lower().endswith(
                (".y4m", ".yuv", ".nv12", ".iyuv", ".raw")):
            from ..av import toolkit as tk
            dmp = tk.Demuxer(opts.input_file)
            tb_sec = dmp.time_base[0] / max(dmp.time_base[1], 1)
            dmp.close()
        common_graph = (FilterGraph(opts.video_filter_desc, src_fps)
                        if opts.video_filter_desc else None)
        # rung graphs consume the COMMON graph's output rate (a common
        # yadif=1 doubles it; a rung fps=N must decimate against that)
        rung_fps = src_fps * getattr(common_graph, "fps_mul", 1)
        rung_graphs = [FilterGraph(r.filter_desc, rung_fps)
                       if r.filter_desc else None for r in opts.rungs]
        base_kwargs = parse_enc_param(opts.video_enc_param) \
            if opts.video_enc_param else {"codec_name": "libx264"}
        base_kwargs.setdefault("preset", "ultrafast")
        # default to the SOURCE rate (a 60fps input stamped 30fps would
        # play half speed and desync from the audio lane); explicit fps=
        # wins
        base_kwargs.setdefault("fps", (round(src_fps * 1000), 1000))
        audio = transcode_audio(opts) if opts.audio_codec else None
        # validate EVERY rung's output before starting any worker: raising
        # mid-loop would leak already-started workers blocked on q.get()
        if opts.sessions > 1:
            for r in opts.rungs:
                if "#" not in r.out_file:
                    raise ValueError(
                        f"rung output {r.out_file!r} has no '#' placeholder: "
                        f"{opts.sessions} sessions would write the same file "
                        "concurrently")
    except BaseException:
        src.close()
        raise
    workers = []
    for i, r in enumerate(opts.rungs):
        kw = dict(base_kwargs)
        if r.enc_suffix:
            kw = parse_enc_param(r.enc_suffix, kw)
        path = r.out_file.replace("#", str(session_idx))
        fps = kw["fps"]
        # filters that change the frame rate (yadif send_field, fps)
        mul = getattr(common_graph, "fps_mul", 1) * \
            getattr(rung_graphs[i], "fps_mul", 1)
        if mul != 1:
            # keep the rate RATIONAL: fps filters give float multipliers
            # (1/step) and the encoder takes ints — scale by 1000
            fps = (int(round(fps[0] * mul * 1000)), int(fps[1] * 1000))
        kw["fps"] = fps       # EncoderWorker prefers kw['fps']
        workers.append(EncoderWorker(f"enc{i}", path, r.width, r.height,
                                     fps, kw, audio=audio))
        workers[-1].start()

    limiter = FpsLimiter(opts.fps_limit)
    meter = FpsMeter(f"session{session_idx}", quiet=quiet)
    rung_sizes = tuple((r.width, r.height) for r in opts.rungs)
    n_in = 0

    def push(outs):
        for w_, (out, keep) in zip(workers, outs):
            if out is not None:
                _push_rung(w_, out, keep)

    try:
        for fb, pts, valid in src:
            src_meta = dict(times=pts * tb_sec,
                            keys=getattr(src, "last_keys", None),
                            pos=getattr(src, "last_pos", None),
                            interlaced=getattr(src, "last_interlaced", None))
            push(filtered_step(fb, pts, valid, rung_sizes, common_graph,
                               rung_graphs, src_meta, tb_sec))
            n_in += int(valid)
            meter.add(int(valid))
            limiter.tick(int(valid))
            if frames_limit and n_in >= frames_limit:
                break
        # end of stream: drain the stateful filters of the common graph
        # (through the ladder and the rung graphs), then the rung graphs
        if common_graph is not None:
            for fb, keep, meta in common_graph.flush():
                fpts = meta.get("pts")
                push(rung_step(fb, keep, fpts, {"times": fpts * tb_sec}
                               if fpts is not None else None, rung_sizes,
                               rung_graphs))
        for w_, g in zip(workers, rung_graphs):
            for out, rkeep, _meta in (g.flush() if g is not None else ()):
                if rkeep.any():
                    _push_rung(w_, _for_encoder(out), rkeep)
    finally:
        # the -frames early break (and any error) must stop the prefetch
        # producer thread and release the demuxer/decoder handles
        src.close()
        for w_ in workers:
            w_.finish()
    for w_ in workers:
        w_.join()
        if w_.error:
            raise w_.error
    dt = watch.stop()
    return {"session": session_idx, "frames_in": n_in,
            "frames_out": sum(w_.count for w_ in workers),
            "seconds": dt, "fps": n_in / dt if dt else 0.0}


def main(argv=None):
    p = argparse.ArgumentParser(prog="gmat-metrans",
                                description="1->N ABR transcode ladder")
    p.add_argument("-c", "--config", help="options.xml (reference format)")
    p.add_argument("-i", "--input", help="input file (overrides config)")
    p.add_argument("-r", "--rung", action="append", default=[],
                   help="WxH[:out.mp4][:encsuffix] (repeatable)")
    p.add_argument("-enc-param", default="")
    p.add_argument("-sessions", type=int, default=0)
    p.add_argument("-proc-decode", action="store_true",
                   help="decode in a worker process per session "
                        "(XML tag <ProcDecode>1; not ported yet)")
    p.add_argument("-frames", type=int, default=0)
    p.add_argument("-batch", type=int, default=16)
    p.add_argument("-stats", action="store_true")
    args = p.parse_args(argv)

    opts = Options.load_xml(args.config) if args.config else Options()
    if args.input:
        opts.input_file = args.input
    if args.enc_param:
        opts.video_enc_param = args.enc_param
    if args.sessions:
        opts.sessions = args.sessions
    if args.proc_decode:
        opts.proc_decode = True
    for spec in args.rung:
        parts = spec.split(":")
        w, h = parts[0].lower().split("x")
        r = Rung(int(w), int(h))
        if len(parts) > 1:
            r.out_file = parts[1]
        if len(parts) > 2:
            r.enc_suffix = ":".join(parts[2:])
        opts.rungs.append(r)
    if not opts.rungs:
        p.error("no output rungs (use -r WxH:out.mp4 or a config)")
    if not opts.input_file:
        p.error("no input")

    results = []
    errors = []
    threads = []

    def run_one(s):
        try:
            results.append(run_session(s, opts, args.batch, args.frames,
                                       quiet=not args.stats))
        except Exception as e:   # surfaced after join: no silent rc=0
            errors.append((s, e))

    for s in range(opts.sessions):
        if opts.sessions == 1:
            run_one(s)
        else:
            t = threading.Thread(target=run_one, args=(s,))
            t.start()
            threads.append(t)
    for t in threads:
        t.join()
    for s, e in errors:
        print(f"session {s} FAILED: {e}", file=sys.stderr)
    if errors:
        return 1
    for r in sorted(results, key=lambda r: r["session"]):
        print(f"session {r['session']}: {r['frames_in']} frames -> "
              f"{r['frames_out']} encoded in {r['seconds']:.2f}s "
              f"({r['fps']:.1f} fps)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
