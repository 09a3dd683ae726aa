"""JPEG still codec: the DCT and quantization of a whole batch on the
card, Huffman coding on the host — counterpart of
`gmat_tpu/av/jpeg_tpu.py`.

The nvjpeg replacement (BASELINE config #5; reference use:
metrans/samples/AppNvjpegDec.cpp:24-67 nvjpegDecode into device BGR):
a batch of frames is transformed on its device in one pass of tensor
ops (ops/dct.py), then each frame's quantized int16 zigzag coefficients
go to the host and are entropy-coded to standards-compliant JFIF bytes
by csrc/gmat_jpeg.cpp (built into the port's own av/_lib by
`av.native`), and vice versa for decode: entropy decode on the host,
dequantization and IDCT of the whole batch on the device given by
`device=` (the card unless the caller asks for the CPU).  libavcodec's
mjpeg codec doubles as the interop oracle in tests.

Colorspace note: JFIF implies BT.601.  encode_batch writes the samples
as-is (like most encoders); callers holding bt709 content should either
convert first or pass the matching colorspace to decode_batch for a
faithful self-round-trip.
"""
from __future__ import annotations

import ctypes
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.frame import FrameBatch, to_device
from ..ops import dct
from ..utils.hostpool import n_workers as _n_workers
from . import native

SUBSAMP_420, SUBSAMP_444, SUBSAMP_GRAY, SUBSAMP_422 = 0, 1, 2, 3

# First-attempt encode buffer heuristic (bytes/pixel). Legal worst-case
# content can exceed it; encode_one retries once with the analytic
# 4 B/coefficient bound when the native encoder reports overflow.
_CAP_BPP = 6


def _pad_to_size(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Edge-pad (N, h, w) up to an exact (th, tw) target."""
    h, w = x.shape[-2], x.shape[-1]
    if th > h:
        x = torch.cat([x, x[..., -1:, :].expand(*x.shape[:-2], th - h,
                                                 x.shape[-1])], dim=-2)
    if tw > w:
        x = torch.cat([x, x[..., -1:].expand(*x.shape[:-1], tw - w)],
                      dim=-1)
    return x


def _pad_to(x: torch.Tensor, mult_h: int, mult_w: int) -> torch.Tensor:
    h, w = x.shape[-2], x.shape[-1]
    return _pad_to_size(x, -(-h // mult_h) * mult_h, -(-w // mult_w) * mult_w)


# the JAX program's f32 constants (Python's f64 quotient rounded to f32)
_Y_GAIN, _C_GAIN = np.float32(255.0 / 219.0), np.float32(255.0 / 224.0)


def _expand_full(x: torch.Tensor, luma: bool) -> torch.Tensor:
    """Limited (MPEG) -> full (JFIF) range.  Y: (y-16)*255/219;
    C: (c-128)*255/224 + 128, the multiply-add fused as XLA's CPU
    compiler fuses it (one rounding)."""
    x = x.to(torch.float32)
    if luma:
        x = (x - 16.0) * float(_Y_GAIN)
    else:
        x = dct.fma(x - 128.0, float(_C_GAIN), torch.full_like(x, 128.0))
    return torch.clamp(x, 0.0, 255.0)


# coefficient wire layout: (N, bh, bw, 64) int16 in ZIGZAG scan order —
# the permutation runs on the device, so the host entropy coder touches
# purely sequential memory (csrc/gmat_jpeg.cpp ABI)
def _encode_coefs(planes, tables, expand: bool):
    """(plane, table) pairs of one batch -> int16 zigzag coefficients on
    the planes' device."""
    out = []
    for i, (x, q) in enumerate(zip(planes, tables)):
        if expand:
            x = _expand_full(x, i == 0)
        out.append(dct.to_zigzag(dct.encode_plane(x, dct.qtable(q,
                                                                x.device))))
    return out


def coefficients(fb: FrameBatch, quality: int = 90,
                 expand_range: bool = False):
    """The device half of encode_batch: (subsamp, qy, qc, coefs), coefs
    the int16 zigzag coefficients of each plane, (N, bh, bw, 64) on the
    batch's device (one tensor for gray8)."""
    qy, qc = dct.quality_tables(quality)
    tables = (qy, qc, qc)
    expand = bool(expand_range)
    if fb.format in ("yuv420p", "nv12", "yuv422p"):
        subsamp = SUBSAMP_420 if fb.format != "yuv422p" else SUBSAMP_422
        y = _pad_to(fb.planes["y"], 16 if subsamp == SUBSAMP_420 else 8, 16)
        # chroma must cover the MCU grid implied by the padded luma
        # (ceil(h/16) x ceil(w/16) blocks of 8 at 4:2:0): for h or w == 1
        # mod 16 a bare pad-to-8 is one block row/col short and the
        # entropy coder would read past the coefficient buffers
        th = y.shape[-2] // 2 if subsamp == SUBSAMP_420 else y.shape[-2]
        tw = y.shape[-1] // 2
        coefs = _encode_coefs(
            (y, _pad_to_size(fb.planes["u"], th, tw),
             _pad_to_size(fb.planes["v"], th, tw)), tables, expand)
    elif fb.format == "yuv444p":
        subsamp = SUBSAMP_444
        coefs = _encode_coefs([_pad_to(fb.planes[k], 8, 8) for k in "yuv"],
                              tables, expand)
    elif fb.format == "gray8":
        subsamp = SUBSAMP_GRAY
        coefs = _encode_coefs([_pad_to(fb.planes["y"], 8, 8)], tables,
                              expand)
    else:
        raise ValueError(
            "encode_batch expects yuv420p/nv12/yuv422p/yuv444p/gray8")
    return subsamp, qy, qc, coefs


def pixels(coefs, tables):
    """The device half of decode_batch: int16 zigzag coefficient batches
    and their (N, 1, 1, 8, 8) f32 tables, all on one device -> u8
    planes there (dequantization, IDCT, level shift)."""
    return [dct.decode_plane(dct.from_zigzag(c), q)
            for c, q in zip(coefs, tables)]


def encode_batch(fb: FrameBatch, quality: int = 90,
                 workers: int = 0, restart_mcus: int = 0,
                 expand_range: bool = False,
                 optimize: bool = False,
                 progressive: bool = False) -> List[bytes]:
    """FrameBatch -> list of JPEG byte strings (the full batch's DCT on
    its device in one pass, `coefficients`; per-frame entropy coding in
    native code, fanned out over `workers` host threads — see
    `entropy_encode`).

    restart_mcus > 0 writes DRI + RSTn markers every that many MCUs —
    independently decodable segments (the nvjpeg-style parallel unit;
    costs a few bytes per segment).

    expand_range=True scales limited (MPEG) range samples to JFIF full
    range in the same device pass (what ffmpeg's auto-inserted
    yuv420p -> yuvj420p scaler does for its mjpeg encoder).

    optimize=True runs a 2-pass encode with per-image optimal Huffman
    tables (libjpeg optimize_coding analog, beyond nvjpeg's fixed
    tables): typically 4-12% smaller files, decodable everywhere.

    progressive=True writes SOF2 multi-scan streams (T.81 Annex G
    spectral selection + successive approximation, the libjpeg
    simple-progression script) with per-scan optimal Huffman tables —
    typically the smallest files; decodable by libjpeg/PIL/avcodec and
    our own progressive decoder.  Composes with restart_mcus (per-scan
    DRI/RSTn — intervals count MCUs in the interleaved DC scan and
    blocks in non-interleaved scans, the T.81 convention).  Beyond
    nvjpeg (baseline-only encode).

    Supports yuv420p/nv12 (4:2:0), yuv422p, yuv444p, and gray8; the
    coefficients are computed on the batch's device."""
    if not 0 <= int(restart_mcus) <= 65535:
        raise ValueError("restart_mcus must be 0..65535 (16-bit DRI "
                         f"field), got {restart_mcus}")
    subsamp, qy, qc, coefs = coefficients(fb, quality, expand_range)
    planes = [np.ascontiguousarray(c.cpu().numpy(), np.int16) for c in coefs]
    return entropy_encode(planes, fb.width, fb.height, subsamp, qy, qc,
                          workers, restart_mcus, optimize, progressive)


def entropy_encode(planes, w: int, h: int, subsamp: int, qy, qc,
                   workers: int = 0, restart_mcus: int = 0,
                   optimize: bool = False,
                   progressive: bool = False) -> List[bytes]:
    """The host half of encode_batch: host int16 zigzag coefficients (one
    array per plane, (N, bh, bw, 64)) -> JFIF bytes per frame, fanned out
    over `workers` threads into the GIL-free native coder."""
    if subsamp == SUBSAMP_GRAY:
        planes = [planes[0]] * 3   # u/v pointers unused for grayscale
    n_frames = planes[0].shape[0]
    lib = native.load("gmat_jpeg")
    p16 = ctypes.POINTER(ctypes.c_int16)
    qyp = qy.ctypes.data_as(native.c_pu8)
    qcp = qc.ctypes.data_as(native.c_pu8)
    cap = w * h * _CAP_BPP + (1 << 16)

    def _call(i, buf, capn):
        if progressive:
            return lib.gjpeg_encode_progressive_r(
                planes[0][i].ctypes.data_as(p16),
                planes[1][i].ctypes.data_as(p16),
                planes[2][i].ctypes.data_as(p16), w, h, subsamp,
                qyp, qcp, buf.ctypes.data_as(native.c_pu8), capn,
                int(restart_mcus))
        return lib.gjpeg_encode_ro(
            planes[0][i].ctypes.data_as(p16),
            planes[1][i].ctypes.data_as(p16),
            planes[2][i].ctypes.data_as(p16), w, h, subsamp,
            qyp, qcp, buf.ctypes.data_as(native.c_pu8), capn,
            int(restart_mcus), int(bool(optimize)))

    def encode_one(i, buf):
        n = _call(i, buf, cap)
        if n == -1 and b"capacity" in lib.gjpeg_last_error():
            # Retry ONLY on a real capacity overflow ("encode needs N
            # bytes, capacity M") — a -1 from parameter validation (bad
            # dims/subsamp) would re-fail identically and the big-buffer
            # allocation would be pure waste.
            # Legal worst-case content (4:4:4 near quality 100) can beat
            # the 6 B/px heuristic: retry once with the analytic bound of
            # 4 B/coefficient (covers max magnitude bits + 0xFF stuffing).
            ncoef = planes[0][i].size if subsamp == 2 else (
                planes[0][i].size + planes[1][i].size + planes[2][i].size)
            big = int(ncoef) * 4 + (1 << 16)
            if big > cap:
                bbuf = np.empty(big, np.uint8)
                n = _call(i, bbuf, big)
                if n >= 0:
                    return bbuf[:n].tobytes()
        if n < 0:
            raise IOError("jpeg encode failed: "
                          + lib.gjpeg_last_error().decode())
        return buf[:n].tobytes()

    nw = _n_workers(workers, n_frames)
    if nw == 1:
        buf = np.empty(cap, np.uint8)
        return [encode_one(i, buf) for i in range(n_frames)]
    bufs = [np.empty(cap, np.uint8) for _ in range(nw)]
    out: List[bytes] = [b""] * n_frames
    with ThreadPoolExecutor(nw) as pool:
        def run(k):
            for i in range(k, n_frames, nw):
                out[i] = encode_one(i, bufs[k])
        list(pool.map(run, range(nw)))    # list() re-raises worker errors
    return out


def decode_batch(datas: Sequence[bytes], colorspace: str = "bt601",
                 workers: int = 0, segment_threads: int = 0,
                 device="cuda") -> FrameBatch:
    """JPEG byte strings (same dims/subsampling) -> YUV420 FrameBatch on
    `device`.  Entropy decode on host (fanned out over `workers` threads
    — see _n_workers), dequant+IDCT of the whole batch on the device.

    segment_threads > 0 additionally parallelizes WITHIN each image
    across restart intervals (streams carrying DRI/RSTn — e.g. our
    encode_batch(restart_mcus=) output or camera JPEGs); streams
    without restarts decode sequentially as before."""
    w, h, subsamp, coefs, tables = entropy_decode(datas, workers,
                                                  segment_threads)
    planes = pixels([to_device(c, device) for c in coefs],
                    [to_device(q, device) for q in tables])
    y = planes[0][:, :h, :w]
    if subsamp == SUBSAMP_GRAY:
        return FrameBatch({"y": y}, "gray8", w, h, colorspace)
    u, v = planes[1], planes[2]
    if subsamp == SUBSAMP_444:
        return FrameBatch({"y": y, "u": u[:, :h, :w], "v": v[:, :h, :w]},
                          "yuv444p", w, h, colorspace)
    if subsamp == SUBSAMP_422:
        # odd JPEG widths crop to even so the half-width chroma plane is
        # consistent with the luma plane
        w2 = w & ~1
        return FrameBatch({"y": y[:, :, :w2], "u": u[:, :h, : w2 // 2],
                           "v": v[:, :h, : w2 // 2]},
                          "yuv422p", w2, h, colorspace)
    # yuv420p planes must be consistent: odd JPEG dims crop to even
    w2, h2 = w & ~1, h & ~1
    y = y[:, :h2, :w2]
    u = u[:, : h2 // 2, : w2 // 2]
    v = v[:, : h2 // 2, : w2 // 2]
    return FrameBatch({"y": y, "u": u, "v": v}, "yuv420p", w2, h2,
                      colorspace)


def entropy_decode(datas: Sequence[bytes], workers: int = 0,
                   segment_threads: int = 0):
    """The host half of decode_batch: JPEG byte strings of one size and
    subsampling -> (w, h, subsamp, coefs, tables), coefs the host int16
    zigzag coefficients per plane (one array for gray8), tables their
    per-image (N, 1, 1, 8, 8) f32 quantization tables."""
    if not datas:
        raise ValueError("decode_batch: no JPEGs given")
    lib = native.load("gmat_jpeg")
    p16 = ctypes.POINTER(ctypes.c_int16)

    def decode_one(data: bytes):
        qy = np.empty(64, np.uint8)
        qc = np.empty(64, np.uint8)
        buf = np.frombuffer(data, np.uint8)
        hnd = lib.gjpeg_parse(buf.ctypes.data_as(native.c_pu8), len(data))
        if not hnd:
            raise IOError(f"jpeg parse: "
                          f"{lib.gjpeg_last_error().decode()}")
        wi, hi, ss = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        lib.gjpeg_info(hnd, ctypes.byref(wi), ctypes.byref(hi),
                       ctypes.byref(ss))
        w, h, subsamp = wi.value, hi.value, ss.value
        lib.gjpeg_qtable(hnd, 0, qy.ctypes.data_as(native.c_pu8))
        lib.gjpeg_qtable(hnd, 1, qc.ctypes.data_as(native.c_pu8))
        if subsamp == SUBSAMP_420:
            mcux, mcuy = (w + 15) // 16, (h + 15) // 16
            yb, cb = (mcuy * 2, mcux * 2), (mcuy, mcux)
        elif subsamp == SUBSAMP_422:
            mcux, mcuy = (w + 15) // 16, (h + 7) // 8
            yb, cb = (mcuy, mcux * 2), (mcuy, mcux)
        elif subsamp == SUBSAMP_GRAY:
            yb = ((h + 7) // 8, (w + 7) // 8)
            cb = (1, 1)     # native gray path never touches u/v
        else:
            yb = cb = ((h + 7) // 8, (w + 7) // 8)
        yc = np.zeros(yb + (64,), np.int16)
        uc = np.zeros(cb + (64,), np.int16)
        vc = np.zeros(cb + (64,), np.int16)
        if segment_threads > 0:
            r = lib.gjpeg_decode_coefs_mt(hnd, yc.ctypes.data_as(p16),
                                          uc.ctypes.data_as(p16),
                                          vc.ctypes.data_as(p16),
                                          int(segment_threads))
        else:
            r = lib.gjpeg_decode_coefs(hnd, yc.ctypes.data_as(p16),
                                       uc.ctypes.data_as(p16),
                                       vc.ctypes.data_as(p16))
        lib.gjpeg_free(hnd)
        if r < 0:
            raise IOError(f"jpeg scan: {lib.gjpeg_last_error().decode()}")
        return w, h, subsamp, qy, qc, yc, uc, vc

    nw = _n_workers(workers, len(datas))
    if nw == 1:
        results = [decode_one(d) for d in datas]
    else:
        with ThreadPoolExecutor(nw) as pool:
            results = list(pool.map(decode_one, datas))

    w, h, subsamp = results[0][:3]
    for r in results[1:]:
        if r[2] != subsamp:
            raise ValueError("mixed subsampling in decode_batch")
        if r[:2] != (w, h):
            raise ValueError("mixed dimensions in decode_batch")

    # per-image quant tables broadcast as (N,1,1,8,8) through
    # decode_plane's coefs * q, so mixed-quality batches take the same
    # pass as uniform ones
    def _q88s(qs):
        out = np.zeros((len(qs), 1, 1, 8, 8), np.float32)
        for i, q in enumerate(qs):
            out[i, 0, 0].flat[:] = q
        return out

    qyf = _q88s([r[3] for r in results])
    qcf = _q88s([r[4] for r in results])
    n_planes = 1 if subsamp == SUBSAMP_GRAY else 3
    coefs = [np.stack([r[5 + p] for r in results]) for p in range(n_planes)]
    return w, h, subsamp, coefs, [qyf, qcf, qcf][:n_planes]


def insert_exif(jpeg: bytes, exif: bytes) -> bytes:
    """Splice an Exif APP1 segment (\"Exif\\0\\0\" + TIFF stream) right
    after SOI/APP0 of a JPEG produced by encode_batch.  Decoders skip
    unknown APPn segments, so the image payload is untouched."""
    seg = b"Exif\x00\x00" + bytes(exif)
    if len(seg) + 2 > 0xFFFF:
        raise ValueError("Exif payload exceeds the 64KB APP1 segment")
    app1 = b"\xff\xe1" + struct.pack(">H", len(seg) + 2) + seg
    # after the APP0 segment when present (read its real length —
    # JFIF thumbnails / JFXX make it longer than 16), else after SOI
    at = 2
    if jpeg[2:4] == b"\xff\xe0" and len(jpeg) >= 6:
        at = 4 + struct.unpack(">H", jpeg[4:6])[0]
        if at > len(jpeg):
            raise ValueError("truncated APP0 segment")
    return jpeg[:at] + app1 + jpeg[at:]


def exif_from_jpeg(jpeg: bytes) -> Optional[bytes]:
    """The TIFF stream of the first Exif APP1 segment, or None."""
    i = 2
    n = len(jpeg)
    while i + 4 <= n and jpeg[i] == 0xFF:
        m = jpeg[i + 1]
        if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:
            i += 2
            continue
        if m in (0xDA, 0xD9):
            break                     # entropy data / end: no more APPn
        ln = struct.unpack(">H", jpeg[i + 2:i + 4])[0]
        if ln < 2 or i + 2 + ln > n:
            break
        if m == 0xE1 and jpeg[i + 4:i + 10] == b"Exif\x00\x00":
            return jpeg[i + 10:i + 2 + ln]
        i += 2 + ln
    return None


class MjpegTpuStream:
    """MJPEG video track -> device FrameBatches via the JPEG lane.

    The decode counterpart of the `-c:v mjpeg_tpu` encoder and the
    NVDEC-analog decode path (reference: cuvid MJPEG decode,
    NvDecLite.h:112-126 codec map): packets demux on host, each batch's
    entropy data fans out over `workers` threads into the GIL-free
    native decoder, and one dequant+IDCT pass reconstructs the whole
    batch on `device` (the card unless the caller asks for the CPU).

    A producer thread keeps `depth` decoded batches ahead (entropy
    decode overlaps device compute).  Iterating yields
    (FrameBatch, pts int64 array, valid_count); the tail batch is
    padded by repeating its last packet so every batch has the same
    shape (valid marks the real frames).
    """

    _SENTINEL = object()

    def __init__(self, path_or_bytes, batch: int = 16, depth: int = 2,
                 workers: int = 0, segment_threads: int = 0,
                 colorspace: str = "bt601", seek: float = 0.0,
                 device="cuda"):
        import queue as _queue
        import threading

        from . import toolkit as tk
        dm = tk.Demuxer(path_or_bytes)
        if dm.codec_id != tk.codec_id("mjpeg"):
            dm.close()
            raise ValueError("MjpegTpuStream needs an MJPEG video track "
                             f"(codec id {dm.codec_id}); use "
                             "ingest.decode_stream for other codecs")
        if seek > 0:
            dm.seek(seek)
        self.fps = dm.fps or 30.0
        self.width, self.height = dm.width, dm.height
        self.batch = batch
        self.error = None
        self._finished = False
        self._q: "_queue.Queue" = _queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()

        def produce():
            try:
                datas, pts, keys, poss = [], [], [], []

                def flush():
                    valid = len(datas)
                    while len(datas) < batch:      # one batch shape
                        datas.append(datas[-1])
                        pts.append(pts[-1])
                        keys.append(False)
                        poss.append(-1)
                    fb = decode_batch(datas, colorspace=colorspace,
                                      workers=workers,
                                      segment_threads=segment_threads,
                                      device=device)
                    item = (fb, np.asarray(pts, np.int64), valid,
                            np.asarray(keys, bool),
                            np.asarray(poss, np.int64))
                    datas.clear()
                    pts.clear()
                    keys.clear()
                    poss.clear()
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.1)
                            return
                        except _queue.Full:
                            continue

                for pkt in dm:
                    if self._stop.is_set():
                        return
                    if pkt.stream != 0:
                        continue
                    datas.append(pkt.data)
                    pts.append(pkt.pts)
                    keys.append(bool(pkt.key))
                    poss.append(int(getattr(pkt, "pos", -1)))
                    if len(datas) == batch:
                        flush()
                if datas and not self._stop.is_set():
                    flush()
            except BaseException as e:
                self.error = e
            finally:
                dm.close()
                while True:
                    try:
                        self._q.put(self._SENTINEL, timeout=0.1)
                        break
                    except _queue.Full:
                        if self._stop.is_set():
                            break

        self._thread = threading.Thread(target=produce, daemon=True)
        self._thread.start()

    def close(self):
        self._stop.set()
        self._finished = True
        while True:
            try:
                self._q.get_nowait()
            except Exception:
                break
        self._thread.join(timeout=5.0)

    def __iter__(self):
        while True:
            if self._finished and self._q.empty():
                # the one sentinel was already consumed (prior full
                # iteration or close()): end cleanly, don't block
                if self.error:
                    raise self.error
                return
            item = self._q.get()
            if item is self._SENTINEL:
                self._finished = True
                if self.error:
                    raise self.error
                return
            fb, pts, valid, keys, poss = item
            # the ingest metadata protocol (PrefetchQueue-compatible):
            # select expressions read key/pos; MJPEG is all-intra
            self.last_keys = keys
            self.last_pos = poss
            self.last_interlaced = np.zeros(len(keys), np.int8)
            yield fb, pts, valid


def decode_stream_tpu(path_or_bytes, batch: int = 16, depth: int = 2,
                      workers: int = 0, segment_threads: int = 0,
                      colorspace: str = "bt601",
                      seek: float = 0.0, device="cuda") -> MjpegTpuStream:
    """Convenience ctor for MjpegTpuStream (mirrors ingest.decode_stream's
    shape: iterate (FrameBatch, pts, valid); .fps/.width/.height attrs)."""
    return MjpegTpuStream(path_or_bytes, batch=batch, depth=depth,
                          workers=workers, segment_threads=segment_threads,
                          colorspace=colorspace, seek=seek, device=device)
