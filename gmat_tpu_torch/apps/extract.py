"""gmat-extract — AppExtract / AppSelect analog; counterpart of
`gmat_tpu/apps/extract.py`.

    python -m gmat_tpu_torch.apps.extract -i in.mp4 -interval 30 -o out.y4m
    python -m gmat_tpu_torch.apps.extract -i in.mp4 -time-interval 2 -o o.y4m
    python -m gmat_tpu_torch.apps.extract -i in.mp4 -scene 0.4 -o cuts.y4m

Mirrors metrans/app/AppExtract.cpp:26-72 (-i -o -interval flags) and
AppSelect.cpp (scene threshold 0.4).  Output is raw .y4m.  JPEG stills
(.jpg, or a %d pattern) need the JPEG codec, which is ported with the
stills slice (`av/jpeg_tpu.py`, ROADMAP.md queue 1, slice 5): until then
such an output raises NotImplementedError before anything is decoded.
Scene scores run on the card; `main(argv, device="cpu")` scores on the
host.
"""
from __future__ import annotations

import argparse
import re
import sys
import time

from ..av.extractor import FrameExtractor, FrameSelect
from ..av.rawvideo import Y4MWriter


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser(prog="gmat-extract")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", default="frame_%d.jpg",
                   help="pattern with %%d, or out.y4m")
    p.add_argument("-interval", type=int, default=0,
                   help="extract every Nth frame (smart GOP seek)")
    p.add_argument("-time-interval", type=float, default=0.0)
    p.add_argument("-scene", type=float, default=0.0,
                   help="scene-cut threshold instead of intervals")
    p.add_argument("-frames", type=int, default=0)
    p.add_argument("-quality", type=int, default=92)
    args = p.parse_args(argv)

    # resolve the output BEFORE decoding anything, as the JAX app does
    out_lower = args.output.lower()
    if not out_lower.endswith(".y4m"):
        if not (out_lower.endswith((".jpg", ".jpeg"))
                or re.search(r"%0?\d*d", args.output)):
            raise SystemExit(
                f"gmat-extract: unsupported output {args.output!r} "
                "(use .y4m, .jpg, or a %d pattern)")
        raise NotImplementedError(
            f"gmat-extract: JPEG output {args.output!r} needs the JPEG "
            "codec, ported with the stills slice (av/jpeg_tpu.py, ROADMAP.md "
            "queue 1, slice 5); write .y4m until then")

    t0 = time.perf_counter()
    if args.scene > 0:
        src = FrameSelect(args.input, threshold=args.scene, device=device)
        frames = ((y, u, v, pts) for (y, u, v, pts, score) in src.frames())
    else:
        src = FrameExtractor(args.input, frame_interval=args.interval,
                             time_interval=args.time_interval)
        frames = src.frames()

    n = 0
    y4m = None
    try:
        for (y, u, v, pts) in frames:
            if y4m is None:
                fps = getattr(src.dm, "fps", 0.0) or 30.0
                y4m = Y4MWriter(args.output, y.shape[1], y.shape[0],
                                (round(fps * 1000), 1000))
            y4m.write(y, u, v)
            n += 1
            if args.frames and n >= args.frames:
                break
    finally:
        if y4m is not None:
            y4m.close()
        src.close()
    dt = time.perf_counter() - t0
    stats = ""
    if hasattr(src, "n_decoded"):
        stats = (f", decoded {src.n_decoded}, skipped "
                 f"{src.n_skipped_seek + src.n_skipped_nonref}")
    print(f"extracted {n} frames in {dt:.2f}s{stats}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
