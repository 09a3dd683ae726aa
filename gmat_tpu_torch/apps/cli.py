"""gmat CLI — the ffmpeg-like entry point, on the card; counterpart of
`gmat_tpu/apps/cli.py`.

Mirrors the reference's CLI pipelines (doc/FFMPEG-GPU_User_Guide.md:16-26,
doc/Tensorrt_Filter.md:26):

  python -m gmat_tpu_torch.apps.cli -i in.mp4 \
      -vf "scale=1280:720,format=rgbpf32le,tensorrt=sr2x,format=nv12" \
      -c:v libx264 -b:v 3M -o out.mp4

The hwaccel/hwupload plumbing of the CUDA version is automatic: the
ingest pipeline (`av/ingest.decode_stream`) stages each decoded batch on
the card, the filter graph runs eagerly on the batch's device, outputs
come back to the host for encode.  `main(argv, device="cpu")` runs the
whole pipeline on the host.

Outputs: .mp4/.mkv/.mov (mux), 'null' (benchmark, no output), .y4m,
pattern with %d -> JPEG / PNG / HEIC still sequence.
"""
from __future__ import annotations

import argparse
import re
import sys

import numpy as np
import torch


def still_pattern(output: str):
    """(has_explicit_pattern, safe_pattern) for a still-sequence output.

    Recognizes ffmpeg-style %d / %0Nd patterns (escaping every OTHER
    literal % so `pattern % n` can't crash), else derives base_%d.ext.
    Shared with gmat-extract."""
    m = re.search(r"%0?\d*d", output)
    if m:
        pre = output[:m.start()].replace("%", "%%")
        post = output[m.end():].replace("%", "%%")
        return True, pre + m.group(0) + post
    base, dot, ext = output.rpartition(".")
    return False, (base.replace("%", "%%") + "_%d" + dot
                   + ext.replace("%", "%%"))


def build_parser():
    p = argparse.ArgumentParser(
        prog="gmat", description="GMAT video pipeline on the card")
    p.add_argument("-i", "--input", required=True, help="input video file")
    p.add_argument("-vf", "--filter", dest="vf", default="null",
                   help="filter graph (ffmpeg -vf syntax)")
    p.add_argument("-o", "--output", default="null",
                   help="output file (.mp4/.mkv), 'null', or pattern%%d.jpg")
    p.add_argument("-c:v", "--vcodec", dest="vcodec", default="libx264",
                   help="libx264|libx265|mjpeg|mjpeg_tpu (mjpeg_tpu: "
                        "batched DCT/quant on the device, host entropy "
                        "coding — the NVENC-analog device-assisted lane)")
    p.add_argument("-q:v", "--qscale", dest="qv", type=float, default=0,
                   help="mjpeg_tpu quality: 1-31 = ffmpeg qscale "
                        "(lower better), 32-100 = JPEG quality directly")
    p.add_argument("-c:a", "--acodec", dest="acodec", default="",
                   help="audio codec (aac|ac3|mp2); empty drops audio")
    p.add_argument("-af", dest="af", default="",
                   help="audio filter chain (atempo/volume/aresample/afade/aecho/pan/loudnorm/aloop/adelay/apad/areverse), "
                        "requires -c:a")
    p.add_argument("-b:a", dest="abitrate", default="128K")
    p.add_argument("-b:v", "--bitrate", dest="bitrate", default="0")
    p.add_argument("-crf", type=float, default=-1.0)
    p.add_argument("-preset", default="veryfast")
    p.add_argument("-g", "--gop", type=int, default=0)
    p.add_argument("-bf", type=int, default=0)
    p.add_argument("-enc-param", default="",
                   help="NvEncoderParam-style option string "
                        "(codec=hevc:preset=p4:bitrate=2M...)")
    p.add_argument("-frames", "-vframes", type=int, default=0,
                   help="stop after N frames")
    p.add_argument("-ss", type=float, default=0.0,
                   help="seek to position (seconds) before decoding")
    p.add_argument("-t", type=float, default=0.0,
                   help="stop after this many seconds of output")
    p.add_argument("-s", "--size", default="",
                   help="WxH for headerless raw input (.yuv/.nv12)")
    p.add_argument("-batch", type=int, default=32,
                   help="frames per device batch")
    p.add_argument("-stats", action="store_true", help="print fps meter")
    p.add_argument("-pad-batch", dest="pad_batch", action="store_true",
                   help="accepted and ignored: the filters run eagerly, "
                        "so survivor batches of any size need no "
                        "recompiled program (the JAX CLI pads them back "
                        "to the nominal size)")
    p.add_argument("-threads", type=int, default=0, help="decoder threads")
    p.add_argument("-bits", type=int, default=8, choices=(8, 10, 16),
                   help="ingest depth: 10 = P010 lane (compressed or "
                        "C420p10 y4m), 16 = C420p16 y4m")
    p.add_argument("-resize", default="",
                   help="decoder-side downscale WxH before upload (the "
                        "cuvid -resize analog; containers only)")
    p.add_argument("-crop", default="",
                   help="decoder-side crop TOPxBOTTOMxLEFTxRIGHT (the "
                        "cuvid -crop analog; containers only)")
    p.add_argument("-list-filters", action="store_true",
                   help="print available filters and their options "
                        "(ffmpeg -h filter=NAME analog)")
    p.add_argument("-hwaccel", default="",
                   help="'tpu' routes MJPEG input decode through the "
                        "device JPEG lane (batched entropy fan-out + one "
                        "dequant/IDCT pass on the device — the NVDEC "
                        "analog); "
                        "other values (cuda/auto/...) are accepted as "
                        "no-ops for reference command-line parity")
    return p


def filter_help(name: str) -> int:
    """ffmpeg `-h filter=NAME`: the one filter's options + docstring."""
    import inspect

    from ..filters.builtin import FILTERS
    from ..filters.graph import POSITIONAL
    f = FILTERS.get(name)
    if f is None:
        print(f"unknown filter {name!r} (see -list-filters)")
        return 1
    print(f"Filter {name}")
    doc = inspect.getdoc(f)
    if doc:
        print("  " + "\n  ".join(doc.splitlines()))
    try:
        params = [p for p in inspect.signature(f).parameters.values()
                  if p.name != "self"]
    except (TypeError, ValueError):
        params = []
    if params:
        print("  options:")
        for p in params:
            d = ("" if p.default is inspect.Parameter.empty
                 else f" (default {p.default!r})")
            print(f"    {p.name}{d}")
    posn = POSITIONAL.get(name)
    if posn:
        print(f"  positional order: {':'.join(posn)}")
    return 0


def list_filters():
    """ffmpeg `-h filter=NAME` analog: one line per filter with its
    option names (factory signature / positional order)."""
    import inspect

    from ..filters.builtin import FILTERS
    from ..filters.graph import POSITIONAL
    seen = {}
    for name in sorted(FILTERS):
        f = FILTERS[name]
        if id(f) in seen:
            print(f"{name:16s} alias of {seen[id(f)]}")
            continue
        seen[id(f)] = name
        try:
            params = [p for p in inspect.signature(f).parameters.values()
                      if p.name != "self"]
            opts = ", ".join(
                p.name if p.default is inspect.Parameter.empty
                else f"{p.name}={p.default!r}" for p in params)
        except (TypeError, ValueError):
            opts = ""
        posn = POSITIONAL.get(name)
        extra = f"   positional: {':'.join(posn)}" if posn else ""
        print(f"{name:16s} {opts}{extra}")


# ffmpeg flags that are no-ops here (accepted so reference doc command
# lines paste in unmodified): hw plumbing is automatic, -y has no
# interactive prompt to skip, A/V sync is pts-driven.  -hwaccel is NOT
# in this set anymore: `-hwaccel tpu` explicitly engages the device
# JPEG decode lane for MJPEG inputs (other values stay no-ops so
# reference command lines keep their behavior)
_FFMPEG_NOOP_VALUED = {"-hwaccel_output_format", "-vsync",
                       "-fps_mode", "-loglevel"}
_FFMPEG_NOOP_FLAGS = {"-y", "-n", "-hide_banner", "-nostdin", "-an", "-sn"}

# -pix_fmt is SEMANTIC in ffmpeg (unlike the plumbing flags above): map
# the depths we speak onto the -bits lane, warn loudly about the rest
# instead of silently emitting a different format than the user asked for
_PIX_FMT_BITS = {"yuv420p": 8, "nv12": 8,
                 "yuv420p10le": 10, "yuv420p10": 10, "p010le": 10,
                 "yuv420p16le": 16, "yuv420p16": 16, "p016le": 16}


def _strip_ffmpeg_noops(argv):
    out, i = [], 0
    while i < len(argv):
        a = argv[i]
        if a in _FFMPEG_NOOP_VALUED and i + 1 < len(argv):
            i += 2
            continue
        if a == "-pix_fmt" and i + 1 < len(argv):
            fmt = argv[i + 1]
            bits = _PIX_FMT_BITS.get(fmt)
            if bits is None:
                print(f"warning: -pix_fmt {fmt} is not supported on the "
                      "CLI output lane; emitting the default format "
                      "(supported: "
                      f"{', '.join(sorted(_PIX_FMT_BITS))})",
                      file=sys.stderr)
            elif bits != 8 and "-bits" not in argv and "-bits" not in out:
                out += ["-bits", str(bits)]   # explicit -bits wins
            i += 2
            continue
        if a in _FFMPEG_NOOP_FLAGS:
            i += 1
            continue
        out.append(a)
        i += 1
    return out


def _host(fb):
    """A batch's planes as host numpy arrays."""
    return {k: v.cpu().numpy() for k, v in fb.planes.items()}


def main(argv=None, device="cuda"):
    """Run the CLI; `device` is where the batches and the graph live (the
    card unless the caller asks for "cpu")."""
    if argv is None:
        argv = sys.argv[1:]
    argv = _strip_ffmpeg_noops(list(argv))
    if "-list-filters" in argv:
        list_filters()
        return 0
    if "-h" in argv:
        # ffmpeg -h filter=NAME (FFMPEG-GPU_User_Guide.md:24-26)
        i = argv.index("-h")
        if i + 1 < len(argv) and argv[i + 1].startswith("filter="):
            return filter_help(argv[i + 1].split("=", 1)[1])
    args = build_parser().parse_args(argv)
    if args.af and (not args.acodec or args.acodec == "copy"):
        # ffmpeg: "Filtering and streamcopy cannot be used together"
        print("gmat: -af requires a transcoding -c:a (aac|ac3|mp2), "
              "not copy/absent", file=sys.stderr)
        return 2

    from ..utils.compile_cache import enable as _enable_cache
    _enable_cache()   # .trtcache analog: reuse the kernel build across runs

    from ..av import toolkit as tk
    from ..av.ingest import decode_stream
    from ..filters.graph import FilterGraph
    from ..ops import csc
    from ..utils.encparam import _size, parse_enc_param
    from ..utils.stopwatch import FpsMeter, StopWatch

    raw_w = raw_h = 0
    if args.size:
        raw_w, raw_h = (int(x) for x in args.size.lower().split("x"))
    dec_resize = dec_crop = None
    if args.resize:
        rw, rh = (int(x) for x in args.resize.lower().split("x"))
        dec_resize = (rw, rh)
    is_raw_input = args.input.lower().endswith(
        (".y4m", ".yuv", ".nv12", ".iyuv", ".raw"))
    if (args.resize or args.crop) and is_raw_input:
        print("gmat: -resize/-crop apply to compressed containers only; "
              "ignored for raw input", file=sys.stderr)
        dec_resize = dec_crop = None
    if is_raw_input:
        src_fps = 30.0
        if args.input.lower().endswith(".y4m"):
            from ..av.rawvideo import Y4MReader
            rd = Y4MReader(args.input)
            # F0:0 is Y4M's 'unknown rate': fall back like the
            # compressed lane does
            src_fps = (rd.fps[0] / max(rd.fps[1], 1)) or 30.0
            rd.close()
        tb_sec = 1.0 / src_fps          # raw pts are frame indices
    probe_codec = -1
    stream_meta = {}
    if not is_raw_input:
        dm_probe = tk.Demuxer(args.input)
        src_fps = dm_probe.fps or 30.0
        tb_sec = dm_probe.time_base[0] / dm_probe.time_base[1]
        probe_codec = dm_probe.codec_id
        # HDR link state (trc/primaries + mdcv/clli peaks) — seeds
        # zscale/tonemap defaults like AVFilterLink propagation
        stream_meta = dm_probe.stream_meta()
        stream_meta["time_base"] = dm_probe.time_base
        if (dm_probe.codec_name == "hevc"
                and not (stream_meta.get("max_luminance")
                         or stream_meta.get("max_cll"))):
            # HDR10 static metadata usually rides SEI, not container
            # boxes — parse the first access unit with our HevcParser
            # (the frame-side-data path ff_determine_signal_peak reads)
            pkt = dm_probe.read()
            if pkt is not None:
                from ..av import hevc as _hevc
                md = _hevc.stream_hdr_metadata([pkt.data])
                if "mastering_display" in md:
                    stream_meta["max_luminance"] = \
                        md["mastering_display"].max_nits
                if "content_light_level" in md:
                    cll = md["content_light_level"].max_cll
                    if cll:
                        stream_meta["max_cll"] = cll
        if args.crop:
            # cuvid-style TOPxBOTTOMxLEFTxRIGHT -> (x, y, w, h)
            t_, b_, l_, r_ = (int(x) for x in args.crop.lower().split("x"))
            dec_crop = (l_, t_, dm_probe.width - l_ - r_,
                        dm_probe.height - t_ - b_)
        dm_probe.close()

    graph = FilterGraph(args.vf, src_fps=src_fps, stream_meta=stream_meta)
    # yadif send_field (mode&1) doubles the output frame rate
    fps_tuple = (round(src_fps * graph.fps_mul * 1000), 1000)
    meter = FpsMeter("gmat", quiet=not args.stats)
    watch = StopWatch()

    enc = mux = None
    jpeg_pattern = None
    out_count = 0
    enc_kwargs = {}
    y4m_writer = None
    if args.output == "null":
        sink = "null"
    elif args.output.endswith(".y4m"):
        sink = "y4m"
    elif re.search(r"%0?\d*d", args.output) or args.output.endswith(
            (".jpg", ".jpeg", ".png", ".heic")):
        # .png is the depth-faithful still sink: 16-bit samples for
        # high-depth/float RGB graph outputs (ffmpeg png/rgb48be analog);
        # .jpg stays the 8-bit lane; .heic writes HEVC stills (the
        # NvHeifWriter app lane — crf from -crf, default 22)
        sink = ("png" if args.output.endswith(".png")
                else "heic" if args.output.endswith(".heic") else "jpeg")
        jpeg_pattern = still_pattern(args.output)[1]
    else:
        sink = "mux"
        enc_kwargs = dict(codec_name=args.vcodec, preset=args.preset,
                          crf=args.crf, gop=args.gop, bf=args.bf,
                          bitrate=_size(args.bitrate), fps=fps_tuple)
        if args.enc_param and args.vcodec != "mjpeg_tpu":
            # mjpeg_tpu reads its own knobs (optimize=) from the raw
            # string; host-encoder options don't apply to that lane
            enc_kwargs = parse_enc_param(args.enc_param, enc_kwargs)

    def ensure_encoder(w, h):
        nonlocal enc, mux
        if enc is not None:
            return
        name = enc_kwargs.pop("codec_name")
        fps = enc_kwargs.pop("fps")
        enc = tk.Encoder(name, w, h, fps=fps, **enc_kwargs)
        mux_kw = tk.mux_kwargs_for_encoder(name)
        audio = None
        if args.acodec == "copy":
            # ffmpeg -c:a copy: pass source audio packets through verbatim
            dm_a = tk.Demuxer(args.input)
            info = tk.AudioInfo(dm_a)
            if info.present:
                tn, td = info.time_base
                sr = info.sample_rate
                pkts = []
                AV_NOPTS = -(1 << 63)
                for p_ in dm_a:
                    if p_.stream == 1:
                        # rescale source-tb pts to the muxer's
                        # 1/sample_rate; NOPTS propagates unscaled (the
                        # native layer hands the sentinel through)
                        pts = (p_.pts if p_.pts == AV_NOPTS
                               else p_.pts * tn * sr // td)
                        dts = (p_.dts if p_.dts == AV_NOPTS
                               else p_.dts * tn * sr // td)
                        pkts.append(tk.Packet(p_.data, pts, dts, p_.key,
                                              False, 1))
                audio = (info.codec_id, sr, info.channels, info.extradata,
                         pkts)
            dm_a.close()
        elif args.acodec:
            from .metrans import Options, transcode_audio
            o = Options(input_file=args.input, audio_codec=args.acodec,
                        audio_bitrate=_size(args.abitrate),
                        audio_filter_desc=args.af)
            audio = transcode_audio(o)
        if audio:
            # AvMuxer: the enum directly, or a raw AVCodecID negated
            # (enum values 0-2 collide with AVCodecID 1/2 = mpeg1/mpeg2)
            vcodec = mux_kw.get("codec")
            if vcodec is None:
                vcodec = -mux_kw["codec_id"]
            mux = tk.AvMuxer(args.output, w, h, fps, vcodec,
                             enc.extradata(), audio[0], audio[1], audio[2],
                             audio[3])
            for p in audio[4]:
                mux.write_audio(p)
            mux.write = mux.write_video
        else:
            mux = tk.Muxer(args.output, w, h, fps,
                           extradata=enc.extradata(), **mux_kw)

    def emit_yuv(fb_host, keep_idx):
        nonlocal out_count
        for i in keep_idx:
            y, u, v = fb_host["y"][i], fb_host["u"][i], fb_host["v"][i]
            ensure_encoder(y.shape[1], y.shape[0])
            for pkt in enc.encode(y, u, v, pts=out_count):
                mux.write(pkt)
            out_count += 1

    def emit_mjpeg_tpu(out_fb, keep_idx):
        """-c:v mjpeg_tpu: the device-assisted video encoder — the whole
        batch's DCT/quant runs on its device in one pass
        (limited->full JFIF range expansion fused in), the native entropy
        coder emits standards-compliant MJPEG packets straight into the
        muxer.  The NVENC-analog lane: device does the transform math,
        host does the bitstream."""
        nonlocal out_count, mux
        from ..av import jpeg_tpu
        from ..core.frame import FrameBatch
        if not len(keep_idx):
            return
        if out_fb.format not in ("yuv420p", "yuv422p", "yuv444p", "gray8"):
            out_fb = csc.convert(out_fb, "yuv420p")
        if mux is None:
            if args.acodec:
                raise SystemExit("mjpeg_tpu is a video-only lane "
                                 "(drop -c:a)")
            mux = tk.Muxer(args.output, out_fb.width, out_fb.height,
                           fps_tuple, **tk.mux_kwargs_for_encoder("mjpeg"))
        planes = out_fb.planes
        if len(keep_idx) != out_fb.batch:
            idx = torch.as_tensor(np.asarray(keep_idx), device=out_fb.device)
            planes = {k: v[idx] for k, v in planes.items()}
        sub = FrameBatch(planes, out_fb.format, out_fb.width,
                         out_fb.height, out_fb.colorspace)
        qv = args.qv
        if qv <= 0:
            q = 90
        elif qv <= 31:
            # ffmpeg mjpeg qscale -> IJG scale percent -> JPEG quality
            s = 6.25 * qv
            q = int(round((200 - s) / 2 if s <= 100 else 5000.0 / s))
        else:
            q = int(round(min(qv, 100)))
        # "-enc-param optimize=1": per-image optimal Huffman tables
        # (2-pass; ~5-15% smaller packets, any decoder reads them).
        # Proper key=value parsing — a substring match would trip on
        # any future knob containing 'optimize'
        kvs = dict(kv.split("=", 1) if "=" in kv else (kv, "1")
                   for kv in (args.enc_param or "").split(":") if kv)
        opt = kvs.get("optimize", "0").lower() not in ("0", "", "false")
        for d_ in jpeg_tpu.encode_batch(sub, quality=max(1, q),
                                        workers=args.threads,
                                        expand_range=True, optimize=opt):
            mux.write(tk.Packet(d_, out_count, out_count, True, False, 0))
            out_count += 1

    def emit_jpeg(rgb_host, keep_idx):
        nonlocal out_count
        from ..av.jpeg import encode_rgb_to_jpeg
        # ffmpeg image2 semantics: -q:v is the mjpeg qscale (2..31,
        # lower = better); values >31 are direct JPEG quality mapped
        # back to a qscale; 0 keeps the encoder default
        q = 3
        if 0 < args.qv <= 31:
            q = int(round(args.qv))
        elif args.qv > 31:
            s = 5000.0 / args.qv if args.qv < 50 else 200 - 2 * args.qv
            q = max(2, min(31, int(round(s / 6.25))))
        for i in keep_idx:
            path = jpeg_pattern % out_count
            with open(path, "wb") as f:
                f.write(encode_rgb_to_jpeg(rgb_host[i], quality=q))
            out_count += 1

    def emit_png(rgb_host, keep_idx):
        nonlocal out_count
        from ..utils.png import write_png
        for i in keep_idx:
            path = jpeg_pattern % out_count
            write_png(path, rgb_host[i])
            out_count += 1

    def emit_heic(fb_host, keep_idx):
        nonlocal out_count
        from ..av import heif
        crf = args.crf if args.crf >= 0 else 22.0
        for i in keep_idx:
            path = jpeg_pattern % out_count
            blob = heif.encode_still(fb_host["y"][i], fb_host["u"][i],
                                     fb_host["v"][i], crf=crf)
            with open(path, "wb") as f:
                f.write(blob)
            out_count += 1

    def emit_y4m(fb_host, keep_idx, bits=8):
        nonlocal out_count, y4m_writer
        from ..av.rawvideo import Y4MWriter
        for i in keep_idx:
            y = fb_host["y"][i]
            if y4m_writer is None:
                y4m_writer = Y4MWriter(args.output, y.shape[1], y.shape[0],
                                       fps_tuple, bits=bits)
            y4m_writer.write(y, fb_host["u"][i], fb_host["v"][i])
            out_count += 1

    sink_dims = [None]     # (w, h) the mux/y4m sink locked on first emit

    def conform_dims(out_fb, keep_idx):
        """mux/y4m sinks have a fixed geometry: a mid-stream resolution
        change (ingest now forwards them instead of dropping) is scaled
        back to the established output size, like ffmpeg's auto-inserted
        scaler — every frame survives, the file stays valid."""
        if not len(keep_idx):
            return out_fb
        if sink_dims[0] is None:
            sink_dims[0] = (out_fb.width, out_fb.height)
            return out_fb
        w0, h0 = sink_dims[0]
        if (out_fb.width, out_fb.height) != (w0, h0):
            from ..ops.resize import resize as resize_fb
            print(f"warning: mid-stream resolution change "
                  f"{out_fb.width}x{out_fb.height} -> conforming to the "
                  f"established output {w0}x{h0}", file=sys.stderr)
            out_fb = resize_fb(out_fb, w0, h0)
        return out_fb

    def emit_batch(out_fb, keep_idx):
        if sink in ("mux", "y4m"):
            out_fb = conform_dims(out_fb, keep_idx)
        if sink == "mux" and args.vcodec == "mjpeg_tpu":
            emit_mjpeg_tpu(out_fb, keep_idx)
        elif sink == "mux":
            # 10-bit pipelines encode main10 when the codec supports it
            # (the NvEncLite 10-bit lane); everything else lands on 8-bit
            want10 = (out_fb.format == "yuv420p10"
                      and args.vcodec == "libx265")
            if want10:
                enc_kwargs.setdefault("bits", 10)
            elif out_fb.format != "yuv420p":
                out_fb = csc.convert(out_fb, "yuv420p")
            emit_yuv(_host(out_fb), keep_idx)
        elif sink == "y4m":
            # keep high-depth pipelines high-depth on disk (C420p10/16)
            if out_fb.format not in ("yuv420p", "yuv420p10", "yuv420p16"):
                out_fb = csc.convert(out_fb, "yuv420p")
            emit_y4m(_host(out_fb), keep_idx, bits=out_fb.fmt.bits)
        elif sink == "jpeg":
            rgb_fb = out_fb if out_fb.format == "rgb24" else csc.convert(
                out_fb, "rgb24")
            emit_jpeg(rgb_fb.planes["rgb"].cpu().numpy(), keep_idx)
        elif sink == "heic":
            if out_fb.format != "yuv420p":
                out_fb = csc.convert(out_fb, "yuv420p")
            emit_heic(_host(out_fb), keep_idx)
        elif sink == "png":
            # depth-faithful: >8-bit and float pipelines land as 16-bit
            # PNG samples instead of quantizing to 8
            deep = out_fb.fmt.bits > 8 or out_fb.fmt.is_float
            target = "rgb48" if deep else "rgb24"
            rgb_fb = out_fb if out_fb.format == target else csc.convert(
                out_fb, target)
            emit_png(rgb_fb.planes["rgb"].cpu().numpy(), keep_idx)
        elif out_fb.batch and out_fb.device.type == "cuda":
            # null sink: wait for the batch's device work, so that the fps
            # meter counts finished frames
            torch.cuda.synchronize(out_fb.device)

    done = 0
    t_first = None      # first decoded frame's time: -t measures output
    # DURATION from here, not absolute stream time (TS containers start
    # at arbitrary offsets)
    src = None
    if args.hwaccel.lower() in ("tpu", "mjpeg_tpu"):
        # explicit device decode: batched entropy fan-out + one
        # dequant/IDCT pass on the device (the NVDEC-analog lane; MJPEG
        # only)
        from ..av import jpeg_tpu
        if probe_codec == tk.codec_id("mjpeg") and args.bits == 8:
            if dec_resize or dec_crop:
                print("gmat: -resize/-crop don't apply to the device "
                      "decode lane; ignored", file=sys.stderr)
            src = jpeg_tpu.decode_stream_tpu(
                args.input, batch=args.batch, workers=args.threads,
                seek=args.ss, device=device)
        else:
            print("gmat: -hwaccel tpu supports 8-bit MJPEG inputs only; "
                  "falling back to software decode", file=sys.stderr)
    elif args.hwaccel and args.hwaccel.lower() not in ("none", "cuda",
                                                       "auto", "nvdec",
                                                       "cuvid"):
        print(f"gmat: unknown -hwaccel {args.hwaccel!r} ignored",
              file=sys.stderr)
    if src is None:
        src = decode_stream(args.input, batch=args.batch,
                            threads=args.threads, seek=args.ss,
                            width=raw_w, height=raw_h, resize=dec_resize,
                            crop=dec_crop, bits=args.bits, device=device)
    for fb, pts, valid in src:
        times = pts * tb_sec
        out_fb, keep = graph.process(
            fb, pts=pts, times=times,
            keys=getattr(src, "last_keys", None),
            pos=getattr(src, "last_pos", None),
            interlaced=getattr(src, "last_interlaced", None),
            valid=valid)
        if args.t > 0 and valid > 0 and t_first is None:
            t_first = float(times[0])
        if args.t > 0 and graph.out_times is not None:
            keep = keep & (graph.out_times < ((t_first or 0.0) + args.t))
        keep_idx = np.nonzero(keep)[0]
        if args.frames and done + len(keep_idx) > args.frames:
            keep_idx = keep_idx[: args.frames - done]
        emit_batch(out_fb, keep_idx)
        done += len(keep_idx)
        meter.add(int(valid))
        if args.frames and done >= args.frames:
            src.close()
            break
        if args.t > 0 and valid > 0 and \
                times[valid - 1] >= (t_first or 0.0) + args.t:
            src.close()
            break

    # drain stateful filters (yadif pending frame, thumbnail open window)
    for out_fb, keep, meta in graph.flush():
        if args.t > 0 and meta.get("times") is not None:
            # the -t cutoff applies to flushed frames too (a yadif
            # pending frame past the limit must not sneak out)
            keep = keep & (np.asarray(meta["times"])
                           < ((t_first or 0.0) + args.t))
        keep_idx = np.nonzero(keep)[0]
        if args.frames and done + len(keep_idx) > args.frames:
            keep_idx = keep_idx[: args.frames - done]
        emit_batch(out_fb, keep_idx)
        done += len(keep_idx)

    if enc is not None:
        for pkt in enc.flush():
            mux.write(pkt)
        mux.close()
        enc.close()
    elif mux is not None:          # mjpeg_tpu lane: no host encoder
        mux.close()
    if y4m_writer is not None:
        y4m_writer.close()
    dt = watch.stop()
    print(f"gmat: {meter.count} frames in, {done} frames out, "
          f"{dt:.2f}s, {meter.count / dt:.1f} fps", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
