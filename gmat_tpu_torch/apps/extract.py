"""gmat-extract — AppExtract / AppSelect analog; counterpart of
`gmat_tpu/apps/extract.py`.

    python -m gmat_tpu_torch.apps.extract -i in.mp4 -interval 30 -o f_%d.jpg
    python -m gmat_tpu_torch.apps.extract -i in.mp4 -time-interval 2 -o o.y4m
    python -m gmat_tpu_torch.apps.extract -i in.mp4 -scene 0.4 -o cut_%d.jpg

Mirrors metrans/app/AppExtract.cpp:26-72 (-i -o -interval flags) and
AppSelect.cpp (scene threshold 0.4); outputs JPEG stills (av/jpeg_tpu:
the coefficients on the device, Huffman coding on the host) or raw
.y4m.  Scene scores and the JPEG coefficients run on the card;
`main(argv, device="cpu")` runs both on the host.
"""
from __future__ import annotations

import argparse
import sys
import time

from ..av import jpeg_tpu
from ..av.extractor import FrameExtractor, FrameSelect
from ..av.rawvideo import Y4MWriter
from ..core.frame import from_numpy_yuv420
from .cli import still_pattern


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
    is_y4m = out_lower.endswith(".y4m")
    pattern = None
    if not is_y4m:
        if not (out_lower.endswith((".jpg", ".jpeg"))
                or still_pattern(args.output)[0]):
            raise SystemExit(
                f"gmat-extract: unsupported output {args.output!r} "
                "(use .y4m, .jpg, or a %d pattern)")
        pattern = still_pattern(args.output)[1]

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
            if is_y4m:
                if y4m is None:
                    fps = getattr(src.dm, "fps", 0.0) or 30.0
                    y4m = Y4MWriter(args.output, y.shape[1], y.shape[0],
                                    (round(fps * 1000), 1000))
                y4m.write(y, u, v)
            else:
                fb = from_numpy_yuv420(y[None], u[None], v[None],
                                       colorspace=src.colorspace,
                                       device=device)
                # expand_range: decoded video is limited-range; JFIF is
                # full range (ffmpeg's auto yuvj420p scaler behavior)
                data = jpeg_tpu.encode_batch(fb, args.quality,
                                             expand_range=True)[0]
                with open(pattern % n, "wb") as f:
                    f.write(data)
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
