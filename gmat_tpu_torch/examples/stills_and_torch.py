"""Still-image codecs + tensors for PyTorch models — counterpart of
`examples/stills_and_torch.py`.

    python -m gmat_tpu_torch.examples.stills_and_torch [--workdir DIR]

The JPEG batch codec runs its DCT on the card (the host runtime's
entropy coder needs only g++); HEIF and the extracted clip need the
libav*-linked host runtime (`av/native.py`).  The frames go to the card
unless `main(argv, device="cpu")` asks for the host.
"""
import argparse
import os
import sys
import tempfile

import numpy as np

H, W = 360, 640


def planes():
    """One 640x360 gradient frame as numpy Y, U, V planes."""
    y = np.add.outer(np.linspace(20, 220, H),
                     np.linspace(0, 30, W)).astype(np.uint8)
    u = np.full((H // 2, W // 2), 96, np.uint8)
    v = np.full((H // 2, W // 2), 160, np.uint8)
    return y, u, v


def jpeg_part(fb, y) -> dict:
    """JPEG: batch DCT/quant on the batch's device + native Huffman
    coding, and back; the decoded luma's mean error against `y`."""
    from ..av import jpeg_tpu
    blobs = jpeg_tpu.encode_batch(fb, quality=90)
    back = jpeg_tpu.decode_batch(blobs, device=fb.device)
    err = float(np.abs(back.planes["y"][0].cpu().numpy().astype(int)
                       - y).mean())
    print(f"JPEG batch: {len(blobs)} x {len(blobs[0])} bytes, "
          f"decode mean err {err:.2f}")
    return {"images": len(blobs), "bytes": len(blobs[0]), "mean_err": err}


def heif_part(y, u, v) -> dict:
    """HEIF still + sequence (pure-Python ISOBMFF + x265)."""
    from ..av import heif
    still = heif.encode_still(y, u, v, crf=20.0)
    seq = heif.encode_sequence([(y, u, v)] * 4, fps=30)
    print(f"HEIF: still {len(still)} bytes, 4-frame sequence {len(seq)} bytes")
    y2, _, _ = heif.decode_still(still)
    err = float(np.abs(y2.astype(int) - y).mean())
    print(f"HEIF decode mean err {err:.2f}")
    return {"still": len(still), "sequence": len(seq), "mean_err": err}


def tensor_part(fb):
    """The model-ready tensor: `preprocess_nchw` gives a torch tensor on
    the batch's device already (the JAX example converts with DLPack)."""
    from ..ops import fused
    t = fused.preprocess_nchw(fb, 224, 224)
    print(f"torch tensor: {tuple(t.shape)} {t.dtype} on {t.device}")
    return t


def extract_part(wd, device="cuda"):
    """A clip's every 30th frame straight into NCHW tensors on `device`
    (`av/torch_interop.extract_to_torch`)."""
    from ..av.torch_interop import extract_to_torch
    from .quickstart import make_clip
    clip = os.path.join(wd, "stills_clip.mp4")
    make_clip(clip, n=60)
    shapes = [tuple(t.shape) for t, _ in extract_to_torch(
        clip, frame_interval=30, out_size=(224, 224), device=device)]
    print(f"extract_to_torch: {len(shapes)} batches {shapes} on {device}")
    return shapes


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser(
        prog="python -m gmat_tpu_torch.examples.stills_and_torch")
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "gmat_stills"))
    wd = ap.parse_args(argv).workdir
    os.makedirs(wd, exist_ok=True)
    from ..core.frame import from_numpy_yuv420
    y, u, v = planes()
    fb = from_numpy_yuv420(np.stack([y] * 8), np.stack([u] * 8),
                           np.stack([v] * 8), device=device)
    jpeg_part(fb, y)
    heif_part(y, u, v)
    tensor_part(fb)
    extract_part(wd, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
