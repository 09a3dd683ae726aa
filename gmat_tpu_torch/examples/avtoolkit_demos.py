"""AvToolkit API demos — the metrans samples rebuilt on gmat_tpu_torch;
counterpart of `examples/avtoolkit_demos.py`.

Each function mirrors one reference sample (metrans/samples/*.cpp):

    mux        AppMux.cpp        demux to elementary, A/V split, remux,
                                 mux elementary streams back together
    vid_dec    AppVidDec.cpp     container -> raw I420 file
    vid_enc    AppVidEnc.cpp     raw I420 file -> elementary H.264
    vid_filt   AppVidFilt.cpp    raw I420 -> filter graph -> raw I420
    vid_trans  AppVidTrans.cpp   decode -> filter -> encode -> container
    aud_dec    AppAudDec.cpp     container audio -> raw PCM s16
    aud_enc    AppAudEnc.cpp     raw PCM -> bare .aac
    aud_filt   AppAudFilt.cpp    PCM -> atempo/volume chain -> PCM
    aud_trans  AppAudTrans.cpp   audio decode -> filter -> encode -> .m4a
    av_trans   AppAvTrans.cpp    full A/V transcode with filters on both

    python -m gmat_tpu_torch.examples.avtoolkit_demos [demo ...]
        [--workdir DIR]            (default: all demos)

Every demo takes the work directory and the torch device its frames go
to: vid_filt, vid_trans and av_trans filter on it (the card unless the
caller asks for "cpu"); the codec and audio demos run on the host.  The
codecs need the libav*-linked host runtime (`av/native.py`).  Fixtures
are generated on the fly in the work directory.
"""
import argparse
import os
import sys
import tempfile

import numpy as np

from ..av import toolkit as tk
from ..av.audio_filters import AudioFilterStream

RATE, CH = 48000, 2
W, H, FPS, NFRAMES = 320, 180, 30, 60


# ------------------------------------------------------------- fixtures
def _frames(n=NFRAMES, w=W, h=H):
    base = np.add.outer(np.linspace(16, 200, h), np.linspace(0, 35, w))
    for i in range(n):
        y = ((base + i * 3) % 210 + 16).astype(np.uint8)
        u = np.full((h // 2, w // 2), 100 + i % 40, np.uint8)
        v = np.full((h // 2, w // 2), 150 - i % 30, np.uint8)
        yield y, u, v


def _pcm(seconds=2.0):
    t = np.arange(int(RATE * seconds)) / RATE
    sig = (np.sin(2 * np.pi * 440 * t) * 8000).astype(np.int16)
    return np.stack([sig] * CH, 1)


def make_av_clip(path):
    """Video gradient + 440 Hz AAC stereo — the bunny.mp4 stand-in."""
    enc = tk.Encoder("libx264", W, H, fps=(FPS, 1), gop=FPS, crf=26.0)
    vpkts = []
    for i, (y, u, v) in enumerate(_frames()):
        vpkts += enc.encode(y, u, v, pts=i)
    vpkts += enc.flush()
    aenc = tk.AudioEncoder("aac", RATE, CH, 96000)
    # the encoder's internal FIFO handles frame-size chunking
    apkts = aenc.encode(_pcm(NFRAMES / FPS)) + aenc.flush()
    mux = tk.AvMuxer(path, W, H, (FPS, 1), tk.CODEC_H264, enc.extradata(),
                     aenc.codec_id, RATE, CH, aenc.extradata())
    for p in vpkts:
        mux.write_video(p)
    for p in apkts:
        mux.write_audio(p)
    mux.close()
    enc.close()
    aenc.close()
    return path


def make_raw_i420(path, n=30):
    with open(path, "wb") as f:
        for y, u, v in _frames(n):
            f.write(y.tobytes() + u.tobytes() + v.tobytes())
    return path


# ----------------------------------------------------------- the demos
def demo_mux(wd, device="cuda"):
    """AppMux.cpp: DemuxV + DemuxAV + Remux + Mux."""
    src = make_av_clip(os.path.join(wd, "bunny.mp4"))

    # DemuxV: video packets (annexb via the demuxer's BSF) -> .h264
    h264 = os.path.join(wd, "bunny.h264")
    with tk.Demuxer(src) as dm, open(h264, "wb") as f:
        for p in dm:
            if p.stream == 0:
                f.write(p.data)

    # DemuxAV: A/V split -> elementary .h264 + bare .aac (audio-only Muxer)
    aac = os.path.join(wd, "bunny.aac")
    with tk.Demuxer(src) as dm:
        ai = tk.AudioInfo(dm)
        with tk.AudioMuxer(aac, ai.codec_id, ai.sample_rate, ai.channels,
                           ai.extradata) as am:
            for p in dm:
                if p.stream == 1:
                    am.write(p)

    # Remux: stream-copy both lanes into another container.  Like the
    # reference ("We have to keep AVCC format here", AppMux.cpp Remux()),
    # mp4-family targets need keep_avcc=True so packets stay in container
    # format; annexb targets (.ts) take the default.
    ts = os.path.join(wd, "remux.mp4")
    with tk.Demuxer(src, keep_avcc=True) as dm:
        ai = tk.AudioInfo(dm)
        tbn, tbd = dm.time_base
        # AvMuxer video pts are in frame units (1/fps); pass the source
        # timebase as "fps" so copied pts go through unchanged
        mx = tk.AvMuxer(ts, dm.width, dm.height, (tbd, tbn), tk.CODEC_H264,
                        dm.extradata(), ai.codec_id, ai.sample_rate,
                        ai.channels, ai.extradata)
        atbn, atbd = ai.time_base
        for p in dm:
            if p.stream == 0:
                mx.write_video(p)
            else:
                # the muxer's audio pts are SAMPLES (1/sample_rate):
                # rescale from the source audio timebase
                pts = p.pts * atbn * ai.sample_rate // atbd
                dts = p.dts * atbn * ai.sample_rate // atbd
                mx.write_audio(tk.Packet(p.data, pts, dts, p.key, False, 1))
        mx.close()

    # Mux: elementary .h264 + .aac back into one file, synthesizing video
    # pts from the frame counter like the reference (AppMux.cpp Mux())
    out = os.path.join(wd, "mux.ts")
    with tk.Demuxer(h264) as vdm, tk.Demuxer(aac) as adm:
        ai = tk.AudioInfo(adm)
        atbn, atbd = adm.time_base
        mx = tk.AvMuxer(out, vdm.width, vdm.height, (FPS, 1), tk.CODEC_H264,
                        b"", ai.codec_id, ai.sample_rate, ai.channels,
                        ai.extradata)
        vi = 0
        for p in vdm:
            if p.stream != 0:
                continue
            p.pts = p.dts = vi          # elementary h264 has no timestamps
            vi += 1
            mx.write_video(p)
        for p in adm:
            if p.stream != 1:
                continue
            # rescale audio pts to sample units for AvMuxer
            p.pts = p.dts = int(p.pts * atbn * ai.sample_rate / atbd)
            mx.write_audio(p)
        mx.close()

    # verify all four outputs open and carry streams
    for f, want_v, want_a in ((h264, True, False), (aac, False, True),
                              (ts, True, True), (out, True, True)):
        with tk.Demuxer(f) as dm:
            if (dm.has_video, dm.has_audio) != (want_v, want_a):
                raise RuntimeError(f"{f}: streams video={dm.has_video} "
                                   f"audio={dm.has_audio}")
    print(f"mux: wrote {os.path.basename(h264)}, {os.path.basename(aac)}, "
          f"remux.mp4, mux.ts")


def demo_vid_dec(wd, device="cuda"):
    """AppVidDec.cpp: container -> raw I420."""
    src = make_av_clip(os.path.join(wd, "vd_in.mp4"))
    out = os.path.join(wd, "vd_out.iyuv")
    n = 0
    with tk.Demuxer(src) as dm, open(out, "wb") as f:
        dec = tk.Decoder.from_demuxer(dm)
        for p in dm:
            if p.stream != 0:
                continue
            for y, u, v, _ in dec.decode(p.data, p.pts):
                f.write(y.tobytes() + u.tobytes() + v.tobytes())
                n += 1
        for y, u, v, _ in dec.decode(None):
            f.write(y.tobytes() + u.tobytes() + v.tobytes())
            n += 1
        dec.close()
    if n != NFRAMES:
        raise RuntimeError(f"decoded {n} frames, want {NFRAMES}")
    print(f"vid_dec: {n} frames -> {os.path.basename(out)}")


def demo_vid_enc(wd, device="cuda"):
    """AppVidEnc.cpp: raw I420 -> elementary H.264."""
    raw = make_raw_i420(os.path.join(wd, "ve_in.iyuv"))
    out = os.path.join(wd, "ve_out.h264")
    fsz = W * H * 3 // 2
    enc = tk.Encoder("libx264", W, H, fps=(FPS, 1), gop=FPS, crf=26.0)
    n = 0
    with open(raw, "rb") as fi, open(out, "wb") as fo:
        i = 0
        while True:
            buf = fi.read(fsz)
            if len(buf) < fsz:
                break
            y = np.frombuffer(buf[:W * H], np.uint8).reshape(H, W)
            u = np.frombuffer(buf[W * H:W * H * 5 // 4], np.uint8).reshape(
                H // 2, W // 2)
            v = np.frombuffer(buf[W * H * 5 // 4:], np.uint8).reshape(
                H // 2, W // 2)
            for p in enc.encode(y, u, v, pts=i):
                fo.write(p.data)
                n += 1
            i += 1
        for p in enc.flush():
            fo.write(p.data)
            n += 1
    enc.close()
    if not n:
        raise RuntimeError("the encoder gave no packets")
    print(f"vid_enc: {n} packets -> {os.path.basename(out)}")


def demo_vid_filt(wd, device="cuda"):
    """AppVidFilt.cpp: raw I420 -> 'scale=160:90,hflip' -> raw I420, the
    graph on `device`."""
    from ..core.frame import FrameBatch
    from ..filters.graph import FilterGraph
    raw = make_raw_i420(os.path.join(wd, "vf_in.iyuv"), n=12)
    out = os.path.join(wd, "vf_out.iyuv")
    graph = FilterGraph("scale=160:90,hflip")
    fsz = W * H * 3 // 2
    n = 0
    with open(raw, "rb") as fi, open(out, "wb") as fo:
        while True:
            # writable, so that the planes become tensors without a copy
            buf = bytearray(fi.read(fsz))
            if len(buf) < fsz:
                break
            y = np.frombuffer(buf[:W * H], np.uint8).reshape(1, H, W)
            u = np.frombuffer(buf[W * H:W * H * 5 // 4],
                              np.uint8).reshape(1, H // 2, W // 2)
            v = np.frombuffer(buf[W * H * 5 // 4:],
                              np.uint8).reshape(1, H // 2, W // 2)
            fb = FrameBatch.from_numpy({"y": y, "u": u, "v": v}, "yuv420p",
                                       W, H, "bt709", device)
            ofb, _keep = graph.process(fb)
            for pl in ("y", "u", "v"):
                fo.write(ofb.planes[pl][0].cpu().numpy().astype(
                    np.uint8).tobytes())
            n += 1
    if n != 12:
        raise RuntimeError(f"filtered {n} frames, want 12")
    print(f"vid_filt: {n} frames scaled+flipped -> {os.path.basename(out)}")


def demo_vid_trans(wd, device="cuda"):
    """AppVidTrans.cpp: decode -> scale -> re-encode -> container."""
    from ..apps.cli import main as gmat
    src = make_av_clip(os.path.join(wd, "vt_in.mp4"))
    out = os.path.join(wd, "vt_out.mp4")
    rc = gmat(["-i", src, "-vf", "scale=160:90", "-o", out,
               "-crf", "28", "-batch", "8"], device=device)
    if rc != 0:
        raise RuntimeError(f"gmat exited {rc}")
    with tk.Demuxer(out) as dm:
        if (dm.width, dm.height) != (160, 90):
            raise RuntimeError(f"{out}: {dm.width}x{dm.height}")
    print(f"vid_trans: {os.path.basename(src)} -> 160x90 "
          f"{os.path.basename(out)}")


def demo_aud_dec(wd, device="cuda"):
    """AppAudDec.cpp: container audio -> raw PCM s16."""
    src = make_av_clip(os.path.join(wd, "ad_in.mp4"))
    out = os.path.join(wd, "ad_out.pcm")
    tot = 0
    with tk.Demuxer(src) as dm, open(out, "wb") as f:
        adec = tk.AudioDecoder(tk.AudioInfo(dm))
        for p in dm:
            if p.stream != 1:
                continue
            for s, _ in adec.decode(p.data, p.pts):
                f.write(s.tobytes())
                tot += len(s)
        for s, _ in adec.decode(None):
            f.write(s.tobytes())
            tot += len(s)
        adec.close()
    if tot <= RATE:  # at least a second
        raise RuntimeError(f"decoded {tot} samples")
    print(f"aud_dec: {tot} samples -> {os.path.basename(out)}")


def demo_aud_enc(wd, device="cuda"):
    """AppAudEnc.cpp: PCM -> bare .aac."""
    out = os.path.join(wd, "ae_out.aac")
    aenc = tk.AudioEncoder("aac", RATE, CH, 96000)
    pkts = aenc.encode(_pcm(1.0)) + aenc.flush()
    with tk.AudioMuxer(out, aenc.codec_id, RATE, CH,
                       aenc.extradata()) as am:
        for p in pkts:
            am.write(p)
    aenc.close()
    with tk.Demuxer(out) as dm:
        if not dm.has_audio or dm.has_video:
            raise RuntimeError(f"{out}: not audio-only")
    print(f"aud_enc: {len(pkts)} packets -> {os.path.basename(out)}")


def demo_aud_filt(wd, device="cuda"):
    """AppAudFilt.cpp: PCM -> atempo=1.25,volume=0.5 -> PCM."""
    stream = AudioFilterStream("atempo=1.25,volume=0.5", RATE)
    samples = _pcm(1.0)
    out_chunks = []
    for off in range(0, len(samples), 4096):
        out_chunks.append(stream.push(samples[off:off + 4096]))
    out_chunks.append(stream.flush())
    got = np.concatenate([c for c in out_chunks if len(c)])
    # 1.25x tempo shortens ~20%, volume halves amplitude
    if not (0.7 < len(got) / len(samples) < 0.9
            and np.abs(got).max() < np.abs(samples).max() * 0.7):
        raise RuntimeError(f"atempo/volume gave {len(got)} samples, peak "
                           f"{np.abs(got).max()}")
    print(f"aud_filt: {len(samples)} -> {len(got)} samples "
          f"(atempo=1.25, volume=0.5)")


def demo_aud_trans(wd, device="cuda"):
    """AppAudTrans.cpp: audio decode -> filter -> encode -> .m4a."""
    src = make_av_clip(os.path.join(wd, "at_in.mp4"))
    out = os.path.join(wd, "at_out.m4a")
    with tk.Demuxer(src) as dm:
        info = tk.AudioInfo(dm)
        rate, ch = info.sample_rate, min(info.channels, 2)
        adec = tk.AudioDecoder(info, sample_rate=rate, channels=ch)
        stream = AudioFilterStream("volume=0.8", rate)
        aenc = tk.AudioEncoder("aac", rate, ch, 96000)
        pkts = []

        def feed(chunk):
            if len(chunk):
                # the encoder's internal FIFO handles frame-size chunking
                pkts.extend(aenc.encode(chunk))

        for p in dm:
            if p.stream != 1:
                continue
            for s, _ in adec.decode(p.data, p.pts):
                feed(stream.push(s))
        for s, _ in adec.decode(None):
            feed(stream.push(s))
        feed(stream.flush())
        pkts += aenc.flush()
        with tk.AudioMuxer(out, aenc.codec_id, aenc.sample_rate,
                           aenc.channels, aenc.extradata()) as am:
            for p in pkts:
                am.write(p)
        aenc.close()
        adec.close()
    with tk.Demuxer(out) as dm2:
        if not dm2.has_audio or dm2.has_video:
            raise RuntimeError(f"{out}: not audio-only")
    print(f"aud_trans: filtered audio -> {os.path.basename(out)}")


def demo_av_trans(wd, device="cuda"):
    """AppAvTrans.cpp: full A/V transcode, filters on both lanes."""
    from ..apps.cli import main as gmat
    src = make_av_clip(os.path.join(wd, "avt_in.mp4"))
    out = os.path.join(wd, "avt_out.mp4")
    rc = gmat(["-i", src, "-vf", "scale=160:90,hflip", "-o", out,
               "-crf", "28", "-batch", "8", "-c:a", "aac",
               "-af", "volume=0.8"], device=device)
    if rc != 0:
        raise RuntimeError(f"gmat exited {rc}")
    with tk.Demuxer(out) as dm:
        if dm.width != 160 or not dm.has_audio:
            raise RuntimeError(f"{out}: width {dm.width}, audio "
                               f"{dm.has_audio}")
    print(f"av_trans: A/V transcode with filters -> "
          f"{os.path.basename(out)}")


DEMOS = {
    "mux": demo_mux,
    "vid_dec": demo_vid_dec,
    "vid_enc": demo_vid_enc,
    "vid_filt": demo_vid_filt,
    "vid_trans": demo_vid_trans,
    "aud_dec": demo_aud_dec,
    "aud_enc": demo_aud_enc,
    "aud_filt": demo_aud_filt,
    "aud_trans": demo_aud_trans,
    "av_trans": demo_av_trans,
}


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser(
        prog="python -m gmat_tpu_torch.examples.avtoolkit_demos",
        description=__doc__)
    ap.add_argument("demos", nargs="*", choices=[[], *DEMOS],
                    help="which demos to run (default: all)")
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "gmat_demos"))
    args = ap.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    for name in (args.demos or DEMOS):
        DEMOS[name](args.workdir, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
