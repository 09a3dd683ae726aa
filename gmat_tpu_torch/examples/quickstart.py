"""Quickstart: the three ways to use gmat_tpu_torch — counterpart of
`examples/quickstart.py`.

    python -m gmat_tpu_torch.examples.quickstart [--workdir DIR]

Generates its own test clip (libx264 through the libav*-linked host
runtime) and writes everything under the work directory.  The frames go
to the card unless `main(argv, device="cpu")` asks for the host.
"""
import argparse
import os
import sys
import tempfile

import numpy as np


def make_clip(path, n=90, w=640, h=360):
    from ..av import toolkit as tk
    enc = tk.Encoder("libx264", w, h, fps=(30, 1), gop=30, crf=22.0)
    pkts = []
    base = np.add.outer(np.linspace(16, 200, h), np.linspace(0, 35, w))
    for i in range(n):
        y = ((base + i * 3) % 210 + 16).astype(np.uint8)
        u = np.full((h // 2, w // 2), 100 + i % 40, np.uint8)
        v = np.full((h // 2, w // 2), 150 - i % 30, np.uint8)
        pkts += enc.encode(y, u, v, pts=i)
    pkts += enc.flush()
    mux = tk.Muxer(path, w, h, (30, 1), tk.CODEC_H264, enc.extradata())
    for p in pkts:
        mux.write(p)
    mux.close()
    enc.close()


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser(
        prog="python -m gmat_tpu_torch.examples.quickstart")
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "gmat_quickstart"))
    wd = ap.parse_args(argv).workdir
    os.makedirs(wd, exist_ok=True)
    clip = os.path.join(wd, "quickstart.mp4")
    make_clip(clip)

    # 1. Library: stream batches through the fused preprocess ladder
    from ..av.ingest import decode_stream
    from ..ops import fused
    total = 0
    for fb, pts, valid in decode_stream(clip, batch=32, device=device):
        x = fused.preprocess_nchw(fb, 224, 224)   # (N,3,224,224) fp32 [0,1]
        x = x[:int(valid)]   # the tail batch pads by repeating the last
        total += int(valid)  # frame — slice before feeding a model
    print(f"1) preprocessed {total} frames -> model-ready tensors")

    # 2. Smart extraction: every 30th frame with GOP seek + non-ref skip
    from ..av.extractor import FrameExtractor
    fx = FrameExtractor(clip, frame_interval=30)
    frames = list(fx.frames())
    print(f"2) smart-extracted {len(frames)} frames "
          f"(decoded {fx.n_decoded}/{90}, skipped "
          f"{fx.n_skipped_seek + fx.n_skipped_nonref})")
    fx.close()

    # 3. CLI, programmatically: filter graph + SR model + transcode
    from ..apps.cli import main as gmat
    out = os.path.join(wd, "quickstart_out.mp4")
    rc = gmat(["-i", clip,
               "-vf", "crop=320:240,format=rgbpf32le,tensorrt=sr2x,format=nv12",
               "-o", out, "-crf", "23", "-frames", "30", "-batch", "16"],
              device=device)
    print(f"3) CLI transcode with in-graph SR: rc={rc} -> {out}")

    # 4. Bundled pretrained ESPCN x2: save a visibly upscaled frame
    from .. import models
    from ..filters.infer import InferFilter
    from ..models import sr
    from ..utils.png import write_png
    for fb, pts, valid in decode_stream(clip, batch=1, device=device):
        lr = fused.preprocess_nchw(fb, 320, 180)      # (1,3,180,320)
        break
    filt = InferFilter(model="sr2x", precision="fp32")
    hr = sr.apply(models.to_device(filt.params, lr.device), lr)  # (1,3,360,640)

    def to_png(path, x):
        img = (np.clip(x[0].cpu().numpy(), 0, 1) * 255).astype(np.uint8)
        write_png(path, img.transpose(1, 2, 0))

    lr_png = os.path.join(wd, "quickstart_lr.png")
    sr_png = os.path.join(wd, "quickstart_sr2x.png")
    to_png(lr_png, lr)
    to_png(sr_png, hr)
    print(f"4) pretrained SR x2: {lr_png} -> {sr_png}")

    # 5. HEIF with the phone-HEIC surface: rotation applied on decode,
    # Exif + alpha + thumbnail items, HDR static metadata
    from ..av import heif
    y8 = (np.clip(lr[0, 0].cpu().numpy() * 255, 0, 255)).astype(np.uint8)
    h2, w2 = y8.shape
    u8 = np.full(((h2 + 1) // 2, (w2 + 1) // 2), 110, np.uint8)
    v8 = np.full_like(u8, 140)
    alpha = np.zeros_like(y8)
    alpha[h2 // 4: 3 * h2 // 4, w2 // 4: 3 * w2 // 4] = 255
    blob = heif.encode_still(
        y8, u8, v8, crf=20.0, rotation=90, exif=b"II*\x00\x08\0\0\0",
        alpha=alpha, thumbnail=True, colr="bt709",
        content_light=(1000, 400))
    yd, ud, vd, ad = heif.decode_still(blob, with_alpha=True)
    info = heif.HeifReader(blob).color_info()
    heic = os.path.join(wd, "quickstart.heic")
    with open(heic, "wb") as f:
        f.write(blob)
    print(f"5) HEIC {w2}x{h2} -> displayed {yd.shape[1]}x{yd.shape[0]} "
          f"(irot applied), alpha={ad is not None}, "
          f"thumb={heif.decode_thumbnail(blob) is not None}, "
          f"colr={info.get('colr')} -> {heic}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
