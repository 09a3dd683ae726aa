"""Stream scan / census apps; a copy of `gmat_tpu/apps/scan.py` on the
port's `av/toolkit` and `av/hevc` (host-only: no device work).

    python -m gmat_tpu_torch.apps.scan census DIR [-fast] [-threads N]
        <- AppNvDecScan (metrans/app/AppNvDecScan.cpp:27-69,130-149):
           decode census over a directory, fast mode skips non-ref frames.
    python -m gmat_tpu_torch.apps.scan hevc FILE
        <- AppHevcParse (app/AppHevcParse.cpp:141-210): RPS analysis, which
           frames can be skipped because the next frame never references
           them.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time


def scan_one(path: str, fast: bool) -> dict:
    from ..av import toolkit as tk
    dm = dec = None
    try:
        dm = tk.Demuxer(path)
        dec = tk.Decoder.from_demuxer(dm)
    except (IOError, ValueError) as e:   # ValueError: audio-only inputs
        if dm is not None:
            dm.close()
        return {"file": os.path.basename(path), "error": str(e)[:80]}
    frames = skipped = 0
    t0 = time.perf_counter()
    try:
        for pkt in dm:
            if pkt.stream != 0:
                continue
            if fast and pkt.nonref:
                skipped += 1
                continue
            frames += sum(1 for _ in dec.decode(pkt.data, pkt.pts))
        frames += sum(1 for _ in dec.decode(None))
    except IOError as e:
        return {"file": os.path.basename(path), "error": str(e)[:80]}
    finally:
        dm.close(); dec.close()
    dt = time.perf_counter() - t0
    return {"file": os.path.basename(path), "codec": dm.codec_name,
            "size": f"{dm.width}x{dm.height}", "frames": frames,
            "skipped": skipped, "fps": round(frames / dt, 1) if dt else 0}


def census(args) -> int:
    files = sorted(
        os.path.join(args.path, f) for f in os.listdir(args.path)
        if f.lower().endswith((".mp4", ".mkv", ".mov", ".264", ".265",
                               ".h264", ".hevc", ".avi", ".webm")))
    results = []
    lock = threading.Lock()

    def worker(sub):
        for p in sub:
            try:
                r = scan_one(p, args.fast)
            except Exception as e:      # one corrupt file must not
                # silently kill the thread's whole chunk (the census
                # would exit 0 with an incomplete summary)
                r = {"file": os.path.basename(p),
                     "error": f"{type(e).__name__}: {e}"[:80]}
            with lock:
                results.append(r)

    nthreads = max(args.threads, 1)
    chunks = [files[i::nthreads] for i in range(nthreads)]
    threads = [threading.Thread(target=worker, args=(c,)) for c in chunks]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for r in sorted(results, key=lambda r: r["file"]):
        print(json.dumps(r))
    total = sum(r.get("frames", 0) for r in results)
    print(json.dumps({"total_files": len(files), "total_frames": total}))
    return 0


def hevc_rps(args) -> int:
    from ..av import hevc, toolkit as tk
    dm = tk.Demuxer(args.path)
    if dm.codec_name != "hevc":
        print("not an HEVC stream", file=sys.stderr)
        return 1
    packets = [p.data for p in dm if p.stream == 0]
    dm.close()
    slices = hevc.parse_stream_slices(packets)
    pocs = hevc.derive_pocs(slices)
    res = hevc.analyze_skippable(packets, slices=slices)
    nskip = sum(1 for _, s in res if s)
    # display_index: rank of each decode-order picture by full POC
    # (8.3.1) — correct across open-GOP boundaries and poc_lsb wrap,
    # where the raw lsb the old report printed misorders.  POC resets at
    # each IDR/BLA, so ranking runs per coded video sequence.
    disp = [0] * len(pocs)
    seg = []
    base = 0

    def flush_seg():
        nonlocal base
        for rank, i in enumerate(sorted(seg, key=lambda i: (pocs[i], i))):
            disp[i] = base + rank
        base += len(seg)

    for i, sl in enumerate(slices):
        if seg and (sl.is_idr or sl.nal_type_ in hevc._NAL_BLA):
            flush_seg()
            seg = []
        seg.append(i)
    if seg:
        flush_seg()
    for i, (_lsb, s) in enumerate(res):
        print(("Skip " if s else "Decode ") + str(pocs[i])
              + f"  display_index={disp[i]}")
    summary = {"total": len(res), "skippable": nskip,
               "ratio": round(nskip / max(len(res), 1), 3)}
    # static HDR metadata riding SEI NALs (mastering display colour
    # volume + content light level — HevcParser SEI sections analog)
    nals = [n for pk in packets for n in hevc.split_annexb(pk)]
    hdr = hevc.stream_hdr_metadata(packets, nals=nals)
    md = hdr.get("mastering_display")
    if md is not None:
        summary["mastering_display"] = {
            "primaries_gbr": [list(p) for p in md.primaries],
            "white_point": list(md.white_point),
            "max_nits": md.max_nits, "min_nits": md.min_nits}
    cll = hdr.get("content_light_level")
    if cll is not None:
        summary["content_light_level"] = {"max_cll": cll.max_cll,
                                          "max_fall": cll.max_fall}
    if hdr["recovery_points"]:
        summary["recovery_points"] = hdr["recovery_points"]
    # pic_timing / buffering_period census (needs the SPS VUI HRD
    # context — HevcParserImpl.cpp:203-205 analog)
    ti = hevc.stream_timing_info(packets, nals=nals)
    vui = ti.get("vui")
    if vui is not None and (ti["pic_timings"] or ti["buffering_periods"]):
        hrd = vui.hrd
        if hrd is not None:
            summary["hrd"] = {
                "nal_hrd": hrd.nal_hrd, "vcl_hrd": hrd.vcl_hrd,
                "au_cpb_removal_delay_len": hrd.au_cpb_removal_delay_len,
                "dpb_output_delay_len": hrd.dpb_output_delay_len}
        pts = ti["pic_timings"]
        if pts:
            summary["pic_timing"] = {
                "count": len(pts),
                "pic_structs": sorted({p.pic_struct_name for p in pts
                                       if p.pic_struct_name}),
                "cpb_removal_delays": [p.au_cpb_removal_delay
                                       for p in pts[:8]],
                "dpb_output_delays": [p.pic_dpb_output_delay
                                      for p in pts[:8]]}
        bps = ti["buffering_periods"]
        if bps:
            summary["buffering_period"] = {
                "count": len(bps),
                "initial_cpb_removal_delay":
                    list(bps[0].initial_cpb_removal_delay)}
    print(json.dumps(summary))
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="gmat-scan")
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("census")
    c.add_argument("path")
    c.add_argument("-fast", action="store_true",
                   help="skip non-reference frames (smart scan)")
    c.add_argument("-threads", type=int, default=2)
    h = sub.add_parser("hevc")
    h.add_argument("path")
    args = p.parse_args(argv)
    return census(args) if args.cmd == "census" else hevc_rps(args)


if __name__ == "__main__":
    sys.exit(main())
