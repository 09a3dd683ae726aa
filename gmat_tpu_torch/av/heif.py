"""HEIF still-image / collection container — NvHeifWriter/Reader rebuild;
a copy of `gmat_tpu/av/heif.py` on the port's `av/hevc`, `av/toolkit`
(libx265 / libavcodec through `gmat_tpu_torch/av/_lib`) and
`utils/hostpool`.

Pure-Python ISOBMFF on top of our libx265 still-image encoder and HEVC
decoder, replacing the reference's Nokia-heif-backed writer/reader
(metrans/include/NvCodec/NvHeifWriter.h:77-100, NvHeifReader.h:55-72):

  * HeifWriter.write_still      <- NvHeifWriter::writeStillImage
        (NAL scan/split NvHeifWriter.cpp:81-155, feedDecoderConfig /
         feedMediaData / addImage / setPrimaryItem :211-253)
  * HeifWriter.write_collection <- the image-collection flavor of
        addImageToSequence/writeSequence (:272-469); a track-based 'msf1'
        sequence is planned (tracked in PARITY.md)
  * HeifReader.read_image / read_all <- NvHeifReader::readImage (:74-158)

Layout written: ftyp('heic') + meta(hdlr/pitm/iloc/iinf/iprp{ipco:
hvcC+ispe, ipma}) + mdat, length-prefixed NALs (lengthSize 4).
"""
from __future__ import annotations

import dataclasses
import io
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from . import hevc
from . import toolkit as tk


def _box(typ: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + typ + payload


def _full(typ: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(typ, struct.pack(">I", (version << 24) | flags) + payload)


def _annexb_to_length_prefixed(nals: List[bytes]) -> bytes:
    return b"".join(struct.pack(">I", len(n)) + n for n in nals)


def _lp_to_annexb(data: bytes, lsz: int) -> bytes:
    """Length-prefixed NAL stream -> annexb (shared by items and
    sequence samples so bounds handling can't diverge)."""
    out = b""
    i = 0
    while i + lsz <= len(data):
        ln = int.from_bytes(data[i:i + lsz], "big")
        out += b"\x00\x00\x00\x01" + data[i + lsz:i + lsz + ln]
        i += lsz + ln
    return out


@dataclasses.dataclass
class _WItem:
    """One item being written: coded payload + metadata boxes."""
    item_type: bytes                    # b"hvc1", b"Exif", ...
    data: bytes
    props: List[Tuple[bytes, bytes, bool]]   # (4cc, payload, essential)
    hvcc: bytes = b""
    width: int = 0
    height: int = 0
    hidden: bool = False
    refs: List[Tuple[bytes, List[int]]] = dataclasses.field(
        default_factory=list)           # (reftype, [to_item_ids])


# ISO 23008-12 transformative properties; the MIAF application order is
# clap -> irot -> imir, and that is the order the writer associates them
ALPHA_AUX_TYPE = b"urn:mpeg:hevc:2015:auxid:1"

# CICP (primaries, transfer, matrix, full_range) presets for 'colr' nclx
COLR_PRESETS = {
    "bt709": (1, 1, 1, 0),
    "bt601": (6, 6, 6, 0),
    "bt2020": (9, 14, 9, 0),
    "pq": (9, 16, 9, 0),        # BT.2100 PQ (HDR10)
    "hlg": (9, 18, 9, 0),       # BT.2100 HLG
    "srgb": (1, 13, 0, 1),
}


def _color_props(colr, mastering_display,
                 content_light) -> List[Tuple[bytes, bytes, bool]]:
    """'colr' (nclx) / 'mdcv' / 'clli' property payloads — the colour +
    static-HDR boxes (SMPTE ST 2086 / CTA-861.3 layouts, byte-identical
    to the matching HEVC SEI bodies)."""
    props: List[Tuple[bytes, bytes, bool]] = []
    if colr is not None:
        if isinstance(colr, str):
            try:
                colr = COLR_PRESETS[colr]
            except KeyError:
                raise ValueError(f"unknown colr preset {colr!r} "
                                 f"(known: {sorted(COLR_PRESETS)})")
        if len(colr) == 2 and colr[0] == "prof":
            # restricted ICC profile form
            props.append((b"colr", b"prof" + bytes(colr[1]), False))
        else:
            p, t, m, fr = (int(v) for v in colr)
            props.append((b"colr", b"nclx" + struct.pack(
                ">HHHB", p, t, m, 0x80 if fr else 0), False))
    if mastering_display is not None:
        (gx, gy), (bx, by), (rx, ry), (wx, wy), mx, mn = mastering_display
        props.append((b"mdcv", struct.pack(
            ">6H2H2I", gx, gy, bx, by, rx, ry, wx, wy, int(mx), int(mn)),
            False))
    if content_light is not None:
        cll, fall = content_light
        props.append((b"clli", struct.pack(">HH", int(cll), int(fall)),
                      False))
    return props


def _transform_props(rotation: int, mirror: Optional[int],
                     clean_aperture) -> List[Tuple[bytes, bytes, bool]]:
    props: List[Tuple[bytes, bytes, bool]] = []
    if clean_aperture is not None:
        ca = tuple(int(v) for v in clean_aperture)
        if len(ca) == 4:                 # (w, h, x_off, y_off) shorthand
            ca = (ca[0], 1, ca[1], 1, ca[2], 1, ca[3], 1)
        if len(ca) != 8:
            raise ValueError("clean_aperture: (w,h,x,y) or 8 num/den ints")
        props.append((b"clap", struct.pack(">8i", *ca), True))
    if rotation % 360:
        if rotation % 90:
            raise ValueError("rotation must be a multiple of 90 (CCW)")
        props.append((b"irot", bytes([(rotation // 90) & 3]), True))
    if mirror is not None:
        if mirror not in (0, 1):
            raise ValueError("mirror: 0 = vertical axis (left-right), "
                             "1 = horizontal axis (top-bottom)")
        props.append((b"imir", bytes([mirror & 1]), True))
    return props


def _parse_still_annexb(annexb: bytes):
    """annexb IDR access unit -> (hvcC record, lp media, w, h); the NAL
    scan mirrors NvHeifWriter.cpp:81-155."""
    nals = hevc.split_annexb(annexb)
    vps = sps = pps = None
    media = []
    for n in nals:
        t = hevc.nal_type(n)
        if t == hevc.NAL_VPS:
            vps = n
        elif t == hevc.NAL_SPS:
            sps = n
        elif t == hevc.NAL_PPS:
            pps = n
        elif hevc.is_vcl(t) or t == 39:    # slices + prefix SEI
            media.append(n)
    if not (vps and sps and pps and media):
        raise ValueError("still image needs VPS/SPS/PPS/IDR NALs "
                         "(encode with still_image=True)")
    s = hevc.parse_sps(sps)
    rec = hevc.build_hvcc(vps, sps, pps)
    return rec, _annexb_to_length_prefixed(media), s.width, s.height


class HeifWriter:
    """Write HEVC still images into .heic files (in memory or to disk).

    Beyond the reference's plain-item writer, items can carry the
    ISO 23008-12 transformative properties (irot/imir/clap), Exif
    metadata items (cdsc-linked) and alpha auxiliary images
    (auxC + auxl) — the boxes real phone HEICs use."""

    def __init__(self):
        self._items: List[_WItem] = []
        self.primary_override: Optional[int] = None

    def add_image(self, annexb: bytes, rotation: int = 0,
                  mirror: Optional[int] = None,
                  clean_aperture=None, colr=None,
                  mastering_display=None, content_light=None) -> int:
        """Add one still image from an annexb HEVC IDR access unit.
        rotation (CCW degrees, multiple of 90), mirror (0 = left-right,
        1 = top-bottom) and clean_aperture ((w,h,x,y) or the full 8
        num/den ints) attach transformative properties.

        colr: (primaries, transfer, matrix, full_range) CICP ints or a
        preset name ('bt709'/'bt601'/'bt2020'/'pq'/'hlg') -> 'colr'
        nclx; mastering_display: 24-byte SEI-layout tuple
        ((gx,gy),(bx,by),(rx,ry),(wx,wy),max_lum,min_lum) -> 'mdcv';
        content_light: (max_cll, max_fall) -> 'clli' — the HDR static
        metadata boxes phone HEICs / MIAF carry.  A 'pixi' (8,8,8) is
        always written (MIAF requirement).  Returns the 1-based id."""
        rec, data, w, h = _parse_still_annexb(annexb)
        base = [(b"hvcC", rec, True),
                (b"ispe", struct.pack(">III", 0, w, h), False),
                (b"pixi", struct.pack(">IB3B", 0, 3, 8, 8, 8), False)]
        base += _color_props(colr, mastering_display, content_light)
        self._items.append(_WItem(
            b"hvc1", data, base + _transform_props(rotation, mirror,
                                                   clean_aperture),
            hvcc=rec, width=w, height=h))
        return len(self._items)

    def add_exif(self, exif: bytes, to_item: Optional[int] = None) -> int:
        """Attach an Exif metadata item (ExifDataBlock with tiff-header
        offset 0) describing `to_item` (default: the last image)."""
        if to_item is None:
            to_item = self._last_image_id()
        self._items.append(_WItem(
            b"Exif", struct.pack(">I", 0) + bytes(exif), [],
            refs=[(b"cdsc", [to_item])]))
        return len(self._items)

    def add_alpha(self, annexb: bytes, to_item: Optional[int] = None) -> int:
        """Attach an alpha-plane auxiliary image (HEVC-coded; the alpha
        samples ride the luma plane) for `to_item`: auxC essential
        property + an auxl reference, infe hidden."""
        if to_item is None:
            to_item = self._last_image_id()
        rec, data, w, h = _parse_still_annexb(annexb)
        props = [(b"hvcC", rec, True),
                 (b"ispe", struct.pack(">III", 0, w, h), False),
                 (b"auxC", struct.pack(">I", 0) + ALPHA_AUX_TYPE + b"\0",
                  True)]
        self._items.append(_WItem(
            b"hvc1", data, props, hvcc=rec, width=w, height=h,
            hidden=True, refs=[(b"auxl", [to_item])]))
        return len(self._items)

    def add_grid(self, tile_annexbs: List[bytes], rows: int, cols: int,
                 out_w: int, out_h: int, rotation: int = 0,
                 mirror: Optional[int] = None, clean_aperture=None,
                 colr=None, mastering_display=None,
                 content_light=None) -> int:
        """Tile HEVC stills (row-major, uniform coded size) into a
        'grid' derived image (ISO 23008-12 6.6.2.3 — the phone-HEIC
        large-still layout): tiles become hidden items, the grid item
        carries the descriptor + dimg references and becomes the
        primary.  Transform/colour properties attach to the GRID item
        (applied to the assembled canvas on decode)."""
        if len(tile_annexbs) != rows * cols:
            raise ValueError(f"need {rows * cols} tiles, got "
                             f"{len(tile_annexbs)}")
        if len(tile_annexbs) > 62:
            raise ValueError("grid limited to 62 tiles (7-bit ipma "
                             "indices)")
        tile_ids = []
        for ab in tile_annexbs:
            rec, data, tw, th = _parse_still_annexb(ab)
            self._items.append(_WItem(
                b"hvc1", data,
                [(b"hvcC", rec, True),
                 (b"ispe", struct.pack(">III", 0, tw, th), False)],
                hvcc=rec, width=tw, height=th, hidden=True))
            tile_ids.append(len(self._items))
        big = out_w > 0xFFFF or out_h > 0xFFFF
        payload = bytes([0, 1 if big else 0, rows - 1, cols - 1]) + (
            struct.pack(">II", out_w, out_h) if big
            else struct.pack(">HH", out_w, out_h))
        props = ([(b"ispe", struct.pack(">III", 0, out_w, out_h), False)]
                 + _transform_props(rotation, mirror, clean_aperture)
                 + _color_props(colr, mastering_display, content_light))
        self._items.append(_WItem(b"grid", payload, props, width=out_w,
                                  height=out_h,
                                  refs=[(b"dimg", tile_ids)]))
        gid = len(self._items)
        if self.primary_override is None:
            self.primary_override = gid
        return gid

    def add_thumbnail(self, annexb: bytes,
                      to_item: Optional[int] = None) -> int:
        """Attach a thumbnail image (its own HEVC still + a 'thmb'
        reference to the master — the phone-HEIC layout)."""
        if to_item is None:
            to_item = self._last_image_id()
        rec, data, w, h = _parse_still_annexb(annexb)
        props = [(b"hvcC", rec, True),
                 (b"ispe", struct.pack(">III", 0, w, h), False),
                 (b"pixi", struct.pack(">IB3B", 0, 3, 8, 8, 8), False)]
        self._items.append(_WItem(
            b"hvc1", data, props, hvcc=rec, width=w, height=h,
            refs=[(b"thmb", [to_item])]))
        return len(self._items)

    def _last_image_id(self) -> int:
        for i in range(len(self._items), 0, -1):
            it = self._items[i - 1]
            # visible presentations: plain stills AND grid items (their
            # tiles are hidden; exif/alpha/thumbnails attach to the grid)
            if it.item_type in (b"hvc1", b"grid") and not it.hidden:
                return i
        raise ValueError("no image item to attach to")

    # -- serialization -------------------------------------------------------
    def _meta(self, mdat_offsets: List[int]) -> bytes:
        n = len(self._items)
        hdlr = _full(b"hdlr", 0, 0,
                     b"\0\0\0\0" + b"pict" + b"\0" * 12 + b"gmat\0")
        primary = self.primary_override or next(
            (i for i, it in enumerate(self._items, start=1)
             if it.item_type == b"hvc1" and not it.hidden), 1)
        pitm = _full(b"pitm", 0, 0, struct.pack(">H", primary))
        iloc_items = b""
        for i, (it, off) in enumerate(zip(self._items, mdat_offsets),
                                      start=1):
            iloc_items += struct.pack(">HHH", i, 0, 1)
            iloc_items += struct.pack(">II", off, len(it.data))
        iloc = _full(b"iloc", 0, 0,
                     struct.pack(">BBH", 0x44, 0x00, n) + iloc_items)
        infes = b""
        for i, it in enumerate(self._items, start=1):
            infes += _full(b"infe", 2, 1 if it.hidden else 0,
                           struct.pack(">HH", i, 0) + it.item_type + b"\0")
        iinf = _full(b"iinf", 0, 0, struct.pack(">H", n) + infes)
        refs = b""
        for i, it in enumerate(self._items, start=1):
            for (rtyp, to_ids) in it.refs:
                refs += _box(rtyp, struct.pack(">HH", i, len(to_ids)) +
                             b"".join(struct.pack(">H", t) for t in to_ids))
        iref = _full(b"iref", 0, 0, refs) if refs else b""
        props = b""
        assoc_entries = b""
        pidx = 0
        for i, it in enumerate(self._items, start=1):
            if not it.props:
                continue
            assoc_entries += struct.pack(">HB", i, len(it.props))
            for (t, payload, essential) in it.props:
                # FullBox properties (ispe/auxC) carry their 4-byte
                # version+flags prefix inside the stored payload
                props += _box(t, payload)
                pidx += 1
                assoc_entries += bytes([(0x80 if essential else 0) | pidx])
        ipco = _box(b"ipco", props)
        ipma = _full(b"ipma", 0, 0,
                     struct.pack(">I", sum(1 for it in self._items
                                           if it.props)) + assoc_entries)
        iprp = _box(b"iprp", ipco + ipma)
        return _box(b"meta", b"\0\0\0\0" + hdlr + pitm + iloc + iinf
                    + iref + iprp)

    def tobytes(self) -> bytes:
        if not self._items:
            raise ValueError("no images added")
        if sum(len(it.props) for it in self._items) > 127:
            # ipma property indices are 7-bit here
            raise ValueError("too many property associations (127 max); "
                             "use HeifSequenceWriter for long sequences")
        ftyp = _box(b"ftyp", b"heic" + struct.pack(">I", 0) + b"mif1heic")
        # two-pass: meta size depends only on item count, offsets on sizes
        probe = self._meta([0] * len(self._items))
        base = len(ftyp) + len(probe) + 8     # + mdat header
        offsets = []
        off = base
        for it in self._items:
            offsets.append(off)
            off += len(it.data)
        meta = self._meta(offsets)
        assert len(meta) == len(probe)
        mdat = _box(b"mdat", b"".join(it.data for it in self._items))
        return ftyp + meta + mdat

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.tobytes())


def _iter_boxes(data: bytes, start: int = 0, end: Optional[int] = None):
    end = len(data) if end is None else end
    i = start
    while i + 8 <= end:
        size = struct.unpack(">I", data[i:i + 4])[0]
        typ = data[i + 4:i + 8]
        if size == 1:
            if i + 16 > end:
                raise IOError("truncated 64-bit box header")
            size = struct.unpack(">Q", data[i + 8:i + 16])[0]
            if size < 16:    # a zero/short largesize would loop forever
                raise IOError(f"malformed 64-bit box size {size}")
            yield typ, i + 16, i + size
        else:
            if size == 0:
                size = end - i
            elif size < 8:
                raise IOError(f"malformed box size {size}")
            yield typ, i + 8, i + size
        i += size


@dataclasses.dataclass
class HeifItem:
    item_id: int
    width: int
    height: int
    hvcc: bytes
    data: bytes
    # transformative properties in association (application) order:
    # ("clap", (8 num/den ints)) / ("irot", ccw_quarter_turns) /
    # ("imir", axis: 0 left-right, 1 top-bottom)
    transforms: List[tuple] = dataclasses.field(default_factory=list)

    def to_annexb(self) -> bytes:
        nals, lsz = hevc.parse_hvcc(self.hvcc)
        out = b"".join(b"\x00\x00\x00\x01" + n for n in nals)
        return out + _lp_to_annexb(self.data, lsz)


class HeifReader:
    """Parse .heic files written by us (and simple single-layer heics)."""

    def __init__(self, path_or_bytes):
        if isinstance(path_or_bytes, (bytes, bytearray)):
            self.data = bytes(path_or_bytes)
        else:
            with open(path_or_bytes, "rb") as f:
                self.data = f.read()
        self.items: List[HeifItem] = []
        self.primary = 1
        self.item_types = {}       # item id -> 4cc (b'hvc1', b'grid', ...)
        self.refs = {}             # reftype 4cc -> {from id: [to ids]}
        self.item_props = {}       # item id -> [(4cc, payload, essential)]
        self._parse()

    @property
    def dimg(self):
        """derived item id -> [source item ids] (grid tiles etc.)."""
        return self.refs.get(b"dimg", {})

    def _parse(self):
        d = self.data
        meta_span = None
        for typ, s, e in _iter_boxes(d):
            if typ == b"meta":
                meta_span = (s + 4, e)
        if meta_span is None:
            raise IOError("no meta box (not a HEIF still?)")
        locs = {}
        props: List[Tuple[bytes, bytes]] = []
        assoc = {}
        methods = {}          # item id -> iloc construction_method
        idat_span = None      # meta-level item data box
        for typ, s, e in _iter_boxes(d, *meta_span):
            if typ == b"idat":
                idat_span = (s, e)
            if typ == b"pitm":
                if d[s] == 0:        # version 0: 16-bit item id
                    self.primary = struct.unpack(">H", d[s + 4:s + 6])[0]
                else:
                    self.primary = struct.unpack(">I", d[s + 4:s + 8])[0]
            elif typ == b"iloc":
                version = d[s]       # full box: version(8) + flags(24)
                body = d[s + 4:e]
                off_sz = body[0] >> 4
                len_sz = body[0] & 15
                base_sz = body[1] >> 4
                # v1/v2: low nibble of byte 1 is index_size — an
                # extent_index precedes each offset and must be skipped
                idx_sz = body[1] & 15 if version >= 1 else 0
                idx = 2
                if version < 2:
                    count = struct.unpack(">H", body[idx:idx + 2])[0]; idx += 2
                else:
                    count = struct.unpack(">I", body[idx:idx + 4])[0]; idx += 4
                for _ in range(count):
                    if version < 2:  # v2: 32-bit item ids
                        iid = struct.unpack(">H", body[idx:idx + 2])[0]; idx += 2
                    else:
                        iid = struct.unpack(">I", body[idx:idx + 4])[0]; idx += 4
                    if version in (1, 2):
                        # construction_method: 0 file offsets, 1 idat-
                        # relative offsets (2 = item refs, unsupported)
                        methods[iid] = struct.unpack(
                            ">H", body[idx:idx + 2])[0] & 0xF
                        idx += 2
                    idx += 2           # data_reference_index
                    base = int.from_bytes(body[idx:idx + base_sz], "big"); idx += base_sz
                    n_ext = struct.unpack(">H", body[idx:idx + 2])[0]; idx += 2
                    extents = []
                    for _ in range(n_ext):
                        idx += idx_sz          # extent_index (unused)
                        off = int.from_bytes(body[idx:idx + off_sz], "big"); idx += off_sz
                        ln = int.from_bytes(body[idx:idx + len_sz], "big"); idx += len_sz
                        extents.append((base + off, ln))
                    locs[iid] = extents
            elif typ == b"iinf":
                ver = d[s]
                idx = s + 4
                if ver == 0:
                    idx += 2
                else:
                    idx += 4
                for t2, s2, e2 in _iter_boxes(d, idx, e):
                    if t2 != b"infe":
                        continue
                    iver = d[s2]
                    if iver >= 2:
                        iid = struct.unpack(">H", d[s2 + 4:s2 + 6])[0] \
                            if iver == 2 else struct.unpack(
                                ">I", d[s2 + 4:s2 + 8])[0]
                        toff = s2 + (8 if iver == 2 else 10)
                        self.item_types[iid] = d[toff:toff + 4]
            elif typ == b"iref":
                ver = d[s]
                idsz = 2 if ver == 0 else 4
                fmt = ">H" if ver == 0 else ">I"
                for t2, s2, e2 in _iter_boxes(d, s + 4, e):
                    if s2 + idsz + 2 > e2:
                        continue
                    from_id = struct.unpack(fmt, d[s2:s2 + idsz])[0]
                    cnt = struct.unpack(">H",
                                        d[s2 + idsz:s2 + idsz + 2])[0]
                    refs = []
                    off = s2 + idsz + 2
                    for _ in range(min(cnt, max(0, (e2 - off) // idsz))):
                        refs.append(struct.unpack(
                            fmt, d[off:off + idsz])[0])
                        off += idsz
                    self.refs.setdefault(t2, {})[from_id] = refs
            elif typ == b"iprp":
                for t2, s2, e2 in _iter_boxes(d, s, e):
                    if t2 == b"ipco":
                        for t3, s3, e3 in _iter_boxes(d, s2, e2):
                            props.append((t3, d[s3:e3]))
                    elif t2 == b"ipma":
                        ver, wide = d[s2], d[s2 + 3] & 1
                        body = d[s2 + 4:e2]
                        count = struct.unpack(">I", body[0:4])[0]
                        idx = 4
                        for _ in range(count):
                            if ver < 1:      # v1+: 32-bit item ids
                                iid = struct.unpack(
                                    ">H", body[idx:idx + 2])[0]
                                idx += 2
                            else:
                                iid = struct.unpack(
                                    ">I", body[idx:idx + 4])[0]
                                idx += 4
                            nass = body[idx]
                            idx += 1
                            plist = []
                            for _ in range(nass):
                                if wide:     # flags&1: 15-bit indices
                                    raw = struct.unpack(
                                        ">H", body[idx:idx + 2])[0]
                                    plist.append((raw & 0x7FFF,
                                                  bool(raw & 0x8000)))
                                    idx += 2
                                else:
                                    plist.append((body[idx] & 0x7F,
                                                  bool(body[idx] & 0x80)))
                                    idx += 1
                            assoc[iid] = plist
        for iid, extents in sorted(locs.items()):
            method = methods.get(iid, 0)
            if method == 1:
                # idat-stored payload: offsets are relative to the meta
                # box's item-data box (end clamped to the buffer — a
                # truncated idat must raise, not read short)
                if idat_span is None:
                    raise IOError(f"item {iid} uses idat storage but the "
                                  "meta box has no idat")
                base0, limit = idat_span[0], min(idat_span[1], len(d))
            elif method != 0:
                # item-reference construction (2): skip this ITEM only —
                # a method-0 primary must stay readable
                continue
            else:
                base0, limit = 0, len(d)
            for o, ln in extents:
                if base0 + o + ln > limit:
                    raise IOError(
                        f"item {iid} extent [{o}:{o + ln}] is beyond the "
                        f"{limit - base0}-byte data region — truncated?")
            data = b"".join(d[base0 + o:base0 + o + ln]
                            for o, ln in extents)
            hvcc = b""
            w = h = 0
            plist = []
            transforms = []
            for pi, ess in assoc.get(iid, []):
                if not 1 <= pi <= len(props):
                    continue
                t, payload = props[pi - 1]
                plist.append((t, payload, ess))
                if t == b"hvcC":
                    hvcc = payload
                elif t == b"ispe":
                    w, h = struct.unpack(">II", payload[4:12])
                elif t == b"irot" and payload:
                    transforms.append(("irot", payload[-1] & 3))
                elif t == b"imir" and payload:
                    transforms.append(("imir", payload[-1] & 1))
                elif t == b"clap" and len(payload) >= 32:
                    transforms.append(
                        ("clap", struct.unpack(">8i", payload[:32])))
            self.item_props[iid] = plist
            self.items.append(HeifItem(iid, w, h, hvcc, data,
                                       transforms=transforms))

    def read_image(self, index: Optional[int] = None) -> HeifItem:
        if index is None:
            for it in self.items:
                if it.item_id == self.primary:
                    return it
            # dangling pitm: fall back to the first DECODABLE
            # presentation (items[0] could be an Exif/metadata item)
            for it in self.items:
                t = self.item_types.get(it.item_id, b"hvc1")
                if t == b"grid" or (t == b"hvc1" and it.hvcc):
                    return it
            raise IOError("no decodable image item (dangling pitm and "
                          "no hvc1/grid items)")
        return self.items[index]

    def exif(self, item_id: Optional[int] = None) -> Optional[bytes]:
        """TIFF-stream Exif payload of the Exif item describing
        `item_id` (default: the primary image), or None."""
        if item_id is None:
            item_id = self.primary
        for it in self.items:
            if (self.item_types.get(it.item_id) == b"Exif"
                    and item_id in self.refs.get(b"cdsc", {})
                    .get(it.item_id, [])):
                if len(it.data) < 4:
                    raise IOError("Exif item payload too short")
                off = struct.unpack(">I", it.data[:4])[0]
                if 4 + off > len(it.data):
                    raise IOError(f"Exif tiff-header offset {off} beyond "
                                  f"the {len(it.data)}-byte payload")
                return it.data[4 + off:]
        return None

    def alpha_item(self, item_id: Optional[int] = None) \
            -> Optional[HeifItem]:
        """The alpha auxiliary image (auxC alpha urn + auxl ref) for
        `item_id` (default: primary), or None."""
        if item_id is None:
            item_id = self.primary
        for it in self.items:
            if item_id not in self.refs.get(b"auxl", {}) \
                    .get(it.item_id, []):
                continue
            for (t, payload, _e) in self.item_props.get(it.item_id, []):
                if t == b"auxC":
                    urn = payload[4:].split(b"\0")[0]
                    if urn == ALPHA_AUX_TYPE or b"alpha" in urn:
                        return it
        return None

    def aux_item_ids(self):
        """Item ids that are auxiliary images (auxl sources) — hidden
        planes, not standalone presentations."""
        return set(self.refs.get(b"auxl", {}).keys())

    def thumbnail_item(self, item_id: Optional[int] = None) \
            -> Optional[HeifItem]:
        """The thumbnail image ('thmb' reference) for `item_id`
        (default: primary), or None."""
        if item_id is None:
            item_id = self.primary
        for it in self.items:
            if item_id in self.refs.get(b"thmb", {}).get(it.item_id, []):
                return it
        return None

    def color_info(self, item_id: Optional[int] = None) -> dict:
        """Colour / HDR properties of an item: any of 'colr' (CICP
        tuple or ('prof', icc_bytes)), 'pixi' (bits per channel),
        'mastering_display' (hevc.MasteringDisplay), and
        'content_light_level' (hevc.ContentLightLevel)."""
        if item_id is None:
            item_id = self.primary
        out: dict = {}
        for (t, payload, _e) in self.item_props.get(item_id, []):
            _collect_color_box(t, payload, out)
        return out


def _collect_color_box(t: bytes, payload: bytes, out: dict) -> None:
    """Accumulate one colr/pixi/mdcv/clli box into `out` (shared by the
    still-item property walk and the sequence sample-entry walk)."""
    if t == b"colr" and len(payload) >= 4:
        kind = payload[:4]
        if kind == b"nclx" and len(payload) >= 11:
            p, tr, m = struct.unpack(">HHH", payload[4:10])
            out["colr"] = (p, tr, m, 1 if payload[10] & 0x80 else 0)
        elif kind in (b"prof", b"rICC"):
            out["colr"] = ("prof", payload[4:])
    elif t == b"pixi" and len(payload) >= 5:
        n = payload[4]
        out["pixi"] = tuple(payload[5:5 + n])
    elif t == b"mdcv" and len(payload) >= 24:
        out["mastering_display"] = hevc.parse_mastering_display(payload)
    elif t == b"clli" and len(payload) >= 4:
        out["content_light_level"] = \
            hevc.parse_content_light_level(payload)


def apply_transforms(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                     transforms) -> tuple:
    """Apply HEIF transformative properties to I420 planes in the given
    (association) order — MIAF order is clap -> irot -> imir.

    clap offsets are the clean-aperture center relative to the image
    center (ISOBMFF 12.1.4); fractional values round to the nearest
    luma sample and chroma crops keep the I420 ceil convention."""
    for (kind, arg) in transforms:
        if kind == "irot":
            k = arg & 3                    # CCW quarter turns
            if k:
                y = np.rot90(y, k)
                u = np.rot90(u, k)
                v = np.rot90(v, k)
        elif kind == "imir":
            ax = 1 if arg == 0 else 0      # 0: vertical axis = left-right
            y, u, v = (np.flip(y, ax), np.flip(u, ax), np.flip(v, ax))
        elif kind == "clap":
            wn, wd, hn, hd, hon, hod, von, vod = arg
            if min(wd, hd, hod, vod) <= 0:
                raise IOError("clap: non-positive denominator")
            H, W = y.shape
            cw = int(round(wn / wd))
            ch = int(round(hn / hd))
            # horiz_off = clean-aperture center minus image center
            x0 = int(round(hon / hod + (W - cw) / 2))
            y0 = int(round(von / vod + (H - ch) / 2))
            if not (0 <= x0 and 0 <= y0 and x0 + cw <= W
                    and y0 + ch <= H and cw > 0 and ch > 0):
                raise IOError(f"clap region {cw}x{ch}+{x0}+{y0} outside "
                              f"the {W}x{H} image")
            y = y[y0:y0 + ch, x0:x0 + cw]
            # chroma keeps the I420 ceil-size convention for the CROPPED
            # dims: exactly ceil(ch/2) x ceil(cw/2) samples from the
            # floored origin (an odd offset's floor-start/ceil-end slice
            # would span one extra row/col)
            cy0, cx0 = y0 // 2, x0 // 2
            u = u[cy0:cy0 + (ch + 1) // 2, cx0:cx0 + (cw + 1) // 2]
            v = v[cy0:cy0 + (ch + 1) // 2, cx0:cx0 + (cw + 1) // 2]
    return np.ascontiguousarray(y), np.ascontiguousarray(u), \
        np.ascontiguousarray(v)


# ---- high-level codec API (CHeif.cpp:20-133 analog) ------------------------

def encode_still(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                 crf: float = 20.0, lossless: bool = False,
                 rotation: int = 0, mirror: Optional[int] = None,
                 clean_aperture=None, exif: Optional[bytes] = None,
                 alpha: Optional[np.ndarray] = None, colr=None,
                 mastering_display=None, content_light=None,
                 thumbnail=None) -> bytes:
    """One I420 frame -> .heic bytes (libx265 stillImage mode; the NVENC
    stillImage config analog, NvEncLiteUnbuffered.cpp:75-77).

    rotation/mirror/clean_aperture write irot/imir/clap transformative
    properties (applied by readers at display); exif attaches an Exif
    metadata item; alpha (HxW u8 plane) attaches an HEVC-coded alpha
    auxiliary image; thumbnail=True (longest edge 256) or (w, h)
    attaches a 'thmb'-linked thumbnail item — the property/metadata
    boxes the reference's Nokia heif backend provides around
    NvHeifWriter."""
    wtr = HeifWriter()
    iid = wtr.add_image(_encode_one_annexb(y, u, v, crf, lossless),
                        rotation=rotation, mirror=mirror,
                        clean_aperture=clean_aperture, colr=colr,
                        mastering_display=mastering_display,
                        content_light=content_light)
    if thumbnail:
        if thumbnail is True:
            # longest edge 256, aspect kept, even dims (420 thumbnail)
            s = 256 / max(y.shape)
            tw = max(2, int(y.shape[1] * min(s, 1.0)) & ~1)
            th = max(2, int(y.shape[0] * min(s, 1.0)) & ~1)
        else:
            tw, th = (int(thumbnail[0]) & ~1, int(thumbnail[1]) & ~1)
        ty, tu, tv = (_nearest_scale(p, th_, tw_) for p, th_, tw_ in
                      ((y, th, tw), (u, (th + 1) // 2, (tw + 1) // 2),
                       (v, (th + 1) // 2, (tw + 1) // 2)))
        wtr.add_thumbnail(_encode_one_annexb(ty, tu, tv, crf), iid)
    if exif is not None:
        wtr.add_exif(exif, iid)
    if alpha is not None:
        if alpha.shape != y.shape:
            raise ValueError(f"alpha plane {alpha.shape} must match the "
                             f"luma plane {y.shape}")
        neutral = np.full(((y.shape[0] + 1) // 2, (y.shape[1] + 1) // 2),
                          128, np.uint8)
        wtr.add_alpha(_encode_one_annexb(np.ascontiguousarray(alpha),
                                         neutral, neutral, crf, lossless),
                      iid)
    return wtr.tobytes()


def _encode_one_annexb(y, u, v, crf: float, lossless: bool = False) -> bytes:
    h, w = y.shape
    opts = "x265-params=log-level=0" + (":lossless=1" if lossless else "")
    enc = tk.Encoder("libx265", w, h, fps=(25, 1), crf=crf,
                     still_image=True, opts=opts)
    pkts = enc.encode(y, u, v, pts=0) + enc.flush()
    annexb = enc.extradata() + b"".join(p.data for p in pkts)
    enc.close()
    return annexb


from ..utils.hostpool import n_workers as _still_workers  # noqa: E402


def encode_collection(frames, crf: float = 20.0,
                      workers: int = 0) -> bytes:
    """[(y,u,v), ...] -> multi-item .heic (burst/collection).

    Items are independent HEVC stills, so they encode in parallel across
    `workers` host threads (one x265 session per item; libav calls
    release the GIL) — the host-side analog of the reference's
    fixed-function NVENC still throughput (AppHeifEnc.cpp:69-95).
    Item order in the container is preserved."""
    frames = list(frames)
    wtr = HeifWriter()
    nw = _still_workers(workers, len(frames))
    if nw <= 1:
        for (y, u, v) in frames:
            wtr.add_image(_encode_one_annexb(y, u, v, crf))
    else:
        with ThreadPoolExecutor(nw) as pool:
            for annexb in pool.map(
                    lambda f: _encode_one_annexb(*f, crf), frames):
                wtr.add_image(annexb)
    return wtr.tobytes()


def encode_stills(frames, crf: float = 20.0, lossless: bool = False,
                  workers: int = 0) -> List[bytes]:
    """[(y,u,v), ...] -> one single-image .heic blob per frame, encoded
    in parallel (per-image x265 session per worker thread)."""
    frames = list(frames)
    nw = _still_workers(workers, len(frames))

    def one(f):
        wtr = HeifWriter()
        wtr.add_image(_encode_one_annexb(*f, crf, lossless))
        return wtr.tobytes()

    if nw <= 1:
        return [one(f) for f in frames]
    with ThreadPoolExecutor(nw) as pool:
        return list(pool.map(one, frames))


def decode_stills(blobs, workers: int = 0) -> List[tuple]:
    """[.heic bytes, ...] -> [(y,u,v), ...], one decoder per worker
    thread (parallel across images; HEVC decode releases the GIL)."""
    blobs = list(blobs)
    nw = _still_workers(workers, len(blobs))
    if nw <= 1:
        return [decode_still(b) for b in blobs]
    with ThreadPoolExecutor(nw) as pool:
        return list(pool.map(decode_still, blobs))


def _nearest_scale(p: np.ndarray, th: int, tw: int) -> np.ndarray:
    """Host-side nearest-sample downscale for thumbnail generation
    (quality is uncritical at thumbnail sizes; keeps heif.py jax-free —
    callers wanting filtered scaling pass their own planes through
    ops.resize first)."""
    h, w = p.shape
    ri = np.minimum((np.arange(th) * h) // th, h - 1)
    ci = np.minimum((np.arange(tw) * w) // tw, w - 1)
    return np.ascontiguousarray(p[np.ix_(ri, ci)])


def decode_thumbnail(data, index: Optional[int] = None):
    """.heic bytes/path -> the thumbnail's (y, u, v) planes, or None if
    the file carries no 'thmb' item for that image."""
    rdr = HeifReader(data)
    item = rdr.read_image(index)
    t = rdr.thumbnail_item(item.item_id)
    if t is None:
        return None
    yuv = _decode_item(rdr, t)
    # a thumbnail with no properties of its own inherits only the
    # master's scale-invariant transforms — clap geometry is in
    # master-pixel coordinates and cannot apply to the smaller plane
    tr = t.transforms or [tf for tf in item.transforms
                          if tf[0] != "clap"]
    return apply_transforms(*yuv, tr) if tr else yuv


def _decode_item(rdr: "HeifReader", item: HeifItem, workers: int = 0):
    """Decode any presentation item: grid-coded items assemble their
    canvas (phone HEICs store alpha planes and thumbnails as grids
    too), plain hvc1 items decode directly."""
    if rdr.item_types.get(item.item_id) == b"grid":
        return _decode_grid(rdr, item, workers=workers)
    return _decode_hvc1(item)


def _decode_hvc1(item: HeifItem):
    dec = tk.Decoder(tk.CODEC_HEVC, width=item.width, height=item.height)
    frames = list(dec.decode(item.to_annexb(), 0)) + list(dec.decode(None))
    dec.close()
    if not frames:
        raise IOError("HEVC still decode produced no frame")
    y, u, v, _ = frames[0]
    return y, u, v


def decode_still(data, index: Optional[int] = None, apply: bool = True,
                 with_alpha: bool = False, workers: int = 0):
    """.heic bytes/path -> (y, u, v) I420 planes.

    Handles plain hvc1 items AND 'grid' derived items (tiled large
    stills — the layout phone HEICs use for >4K images): tiles decode
    individually and assemble onto the output canvas.

    apply=True applies the item's transformative properties
    (clap/irot/imir) the way a compliant viewer displays it; False
    returns the coded geometry.  with_alpha=True returns (y, u, v,
    alpha-or-None), decoding the alpha auxiliary image if present
    (same transforms applied)."""
    rdr = HeifReader(data)
    item = rdr.read_image(index)
    yuv = _decode_item(rdr, item, workers=workers)
    if apply and item.transforms:
        yuv = apply_transforms(*yuv, item.transforms)
    if not with_alpha:
        return yuv
    a_item = rdr.alpha_item(item.item_id)
    alpha = None
    if a_item is not None:
        a = _decode_item(rdr, a_item, workers=workers)
        # the alpha plane follows its own transforms when authored with
        # any, else tracks the master image's
        tr = a_item.transforms or item.transforms
        if apply and tr:
            a = apply_transforms(*a, tr)
        alpha = a[0]
    return (*yuv, alpha)


def _parse_grid_payload(payload: bytes):
    """ImageGrid (ISO 23008-12 6.6.2.3.2): rows/cols and output dims."""
    if len(payload) < 8:
        raise IOError("grid item payload too short")
    flags = payload[1]
    rows = payload[2] + 1
    cols = payload[3] + 1
    if flags & 1:
        if len(payload) < 12:
            raise IOError("grid item payload too short (32-bit dims)")
        w, h = struct.unpack(">II", payload[4:12])
    else:
        w, h = struct.unpack(">HH", payload[4:8])
    return rows, cols, w, h


def _decode_grid(rdr: "HeifReader", grid: HeifItem, workers: int = 0):
    rows, cols, out_w, out_h = _parse_grid_payload(grid.data)
    tile_ids = rdr.dimg.get(grid.item_id)
    if not tile_ids or len(tile_ids) != rows * cols:
        raise IOError(f"grid {grid.item_id}: expected {rows * cols} dimg "
                      f"tile refs, found {tile_ids}")
    by_id = {it.item_id: it for it in rdr.items}
    tiles = []
    for tid in tile_ids:
        t = by_id.get(tid)
        if t is None:
            raise IOError(f"grid tile {tid} missing")
        tiles.append(t)
    nw = _still_workers(workers, len(tiles))
    if nw <= 1:
        # sequential: reuse ONE decoder across same-geometry tiles
        dec = None
        dims = None
        decoded = []
        for t in tiles:
            if dec is None or (t.width, t.height) != dims:
                if dec is not None:
                    dec.close()
                dec = tk.Decoder(tk.CODEC_HEVC, width=t.width,
                                 height=t.height)
                dims = (t.width, t.height)
            frames = (list(dec.decode(t.to_annexb(), 0))
                      + list(dec.decode(None)))
            dec.reset()
            if not frames:
                raise IOError(f"grid tile {t.item_id} decoded no frame")
            decoded.append(frames[0][:3])
        if dec is not None:
            dec.close()
    else:
        # parallel: ONE HEVC session per worker thread, reused across
        # that worker's tiles via reset() (decode releases the GIL) —
        # the big-still analog of encode_still_grid(workers=); a
        # session per TILE would pay 62 avcodec open/closes per image
        import threading
        tls = threading.local()
        sessions = []
        slock = threading.Lock()

        def one(t):
            dec = getattr(tls, "dec", None)
            if dec is None or getattr(tls, "dims", None) != (t.width,
                                                            t.height):
                if dec is not None:
                    dec.close()
                    with slock:
                        sessions.remove(dec)
                dec = tk.Decoder(tk.CODEC_HEVC, width=t.width,
                                 height=t.height)
                tls.dec, tls.dims = dec, (t.width, t.height)
                with slock:
                    sessions.append(dec)
            frames = (list(dec.decode(t.to_annexb(), 0))
                      + list(dec.decode(None)))
            dec.reset()
            if not frames:
                raise IOError(f"grid tile {t.item_id} decoded no frame")
            return frames[0][:3]

        try:
            with ThreadPoolExecutor(nw) as pool:
                decoded = list(pool.map(one, tiles))
        finally:
            for dec in sessions:
                dec.close()
    canvas = None
    for k, (ty, tu, tv) in enumerate(decoded):
        th, tw = ty.shape
        if canvas is None:
            if rows * th * cols * tw > (1 << 31):
                raise IOError(f"grid canvas {rows * th}x{cols * tw} "
                              "implausibly large")
            canvas = (np.zeros((rows * th, cols * tw), np.uint8),
                      np.zeros((rows * th // 2, cols * tw // 2), np.uint8),
                      np.zeros((rows * th // 2, cols * tw // 2), np.uint8))
        elif (th, tw) != (canvas[0].shape[0] // rows,
                          canvas[0].shape[1] // cols):
            raise IOError(f"grid tile {tiles[k].item_id}: decoded "
                          f"{tw}x{th} does not match the grid's uniform "
                          "tile size")
        r, c = divmod(k, cols)
        canvas[0][r * th:(r + 1) * th, c * tw:(c + 1) * tw] = ty
        canvas[1][r * th // 2:(r * th + th) // 2,
                  c * tw // 2:(c * tw + tw) // 2] = tu
        canvas[2][r * th // 2:(r * th + th) // 2,
                  c * tw // 2:(c * tw + tw) // 2] = tv
    if out_h > canvas[0].shape[0] or out_w > canvas[0].shape[1]:
        raise IOError(f"grid declares {out_w}x{out_h} but tiles only "
                      f"cover {canvas[0].shape[1]}x{canvas[0].shape[0]}")
    # spec: the reconstructed image is the canvas cropped to the grid's
    # declared output size (top-left anchored); chroma keeps the I420
    # ceil convention for odd outputs
    return (canvas[0][:out_h, :out_w],
            canvas[1][:(out_h + 1) // 2, :(out_w + 1) // 2],
            canvas[2][:(out_h + 1) // 2, :(out_w + 1) // 2])


def write_grid(tile_annexbs: List[bytes], rows: int, cols: int,
               out_w: int, out_h: int, **grid_props) -> bytes:
    """One-shot grid file: HeifWriter.add_grid + serialize (kept for
    API compatibility; compose grids with exif/alpha/thumbnail items
    through HeifWriter directly)."""
    w = HeifWriter()
    w.add_grid(tile_annexbs, rows, cols, out_w, out_h, **grid_props)
    return w.tobytes()


def encode_still_grid(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                      tile: int = 512, crf: float = 20.0,
                      workers: int = 0, **grid_props) -> bytes:
    """Large I420 still -> tiled 'grid' .heic: edge tiles are padded to
    the uniform coded tile size (the declared output dims crop them
    back), tiles encode in parallel across host threads."""
    h, w = y.shape
    tile = int(tile) & ~1
    if tile < 64:
        raise ValueError("tile must be >= 64 (and even)")
    rows = (h + tile - 1) // tile
    cols = (w + tile - 1) // tile
    if rows * cols > 62:
        raise ValueError(f"{rows}x{cols} tiles exceed the 62-tile grid "
                         "limit; use a larger tile size")

    def tile_planes(r, c):
        y0, x0 = r * tile, c * tile
        ty = np.zeros((tile, tile), np.uint8)
        tu = np.full((tile // 2, tile // 2), 128, np.uint8)
        tv = np.full((tile // 2, tile // 2), 128, np.uint8)
        sy = y[y0:y0 + tile, x0:x0 + tile]
        ty[: sy.shape[0], : sy.shape[1]] = sy
        su = u[y0 // 2:(y0 + tile) // 2, x0 // 2:(x0 + tile) // 2]
        sv = v[y0 // 2:(y0 + tile) // 2, x0 // 2:(x0 + tile) // 2]
        tu[: su.shape[0], : su.shape[1]] = su
        tv[: sv.shape[0], : sv.shape[1]] = sv
        # edge-pad the remainder so tile borders don't ring
        if sy.shape[0] < tile:
            ty[sy.shape[0]:] = ty[sy.shape[0] - 1]
            tu[su.shape[0]:] = tu[max(su.shape[0] - 1, 0)]
            tv[sv.shape[0]:] = tv[max(sv.shape[0] - 1, 0)]
        if sy.shape[1] < tile:
            ty[:, sy.shape[1]:] = ty[:, sy.shape[1] - 1:sy.shape[1]]
            tu[:, su.shape[1]:] = tu[:, max(su.shape[1] - 1, 0):][:, :1]
            tv[:, sv.shape[1]:] = tv[:, max(sv.shape[1] - 1, 0):][:, :1]
        return ty, tu, tv

    coords = [(r, c) for r in range(rows) for c in range(cols)]
    nw = _still_workers(workers, len(coords))
    if nw <= 1:
        abs_ = [_encode_one_annexb(*tile_planes(r, c), crf)
                for (r, c) in coords]
    else:
        with ThreadPoolExecutor(nw) as pool:
            abs_ = list(pool.map(
                lambda rc: _encode_one_annexb(*tile_planes(*rc), crf),
                coords))
    return write_grid(abs_, rows, cols, w, h, **grid_props)


def decode_all(data):
    """Decode every item, parsing the container ONCE and reusing one
    decoder across same-geometry items (a 63-item burst would otherwise
    re-parse the blob and build a decoder per item)."""
    rdr = HeifReader(data)
    out = []
    dec = None
    dims = None
    skip_ids = rdr.aux_item_ids() | set(rdr.refs.get(b"thmb", {}))
    for tiles in rdr.refs.get(b"dimg", {}).values():
        skip_ids |= set(tiles)         # grid tiles: parts, not pictures
    for item in rdr.items:
        ityp = rdr.item_types.get(item.item_id, b"hvc1")
        if ityp == b"grid":
            out.append(_decode_grid(rdr, item))   # assembled canvas
            continue
        if ityp != b"hvc1":
            continue               # metadata items are not AUs
        if item.item_id in skip_ids:
            continue   # alpha/thumbnail/tile items are not presentations
        if dec is None or (item.width, item.height) != dims:
            if dec is not None:
                dec.close()
            dec = tk.Decoder(tk.CODEC_HEVC, width=item.width,
                             height=item.height)
            dims = (item.width, item.height)
        frames = (list(dec.decode(item.to_annexb(), 0)) +
                  list(dec.decode(None)))
        dec.reset()      # exit draining so the next item can decode
        if not frames:
            raise IOError("HEVC still decode produced no frame")
        y, u, v, _ = frames[0]
        out.append((y, u, v))
    if dec is not None:
        dec.close()
    return out


# ======================================================== image sequences
# Track-based HEIF sequence ('msf1'), the NvHeifWriter::writeSequence /
# readVideoFrame analog (NvHeifWriter.cpp:272-469, NvHeifReader.cpp:119).


def _u32(v): return struct.pack(">I", v)
def _u16(v): return struct.pack(">H", v)


def _hvc1_sample_entry(w: int, h: int, hvcc: bytes,
                       extra_boxes: bytes = b"") -> bytes:
    e = bytearray()
    e += b"\0" * 6 + _u16(1)                  # reserved + data_ref_index
    e += b"\0" * 16                           # predefined/reserved
    e += _u16(w) + _u16(h)
    e += _u32(0x00480000) + _u32(0x00480000)  # 72 dpi
    e += _u32(0)
    e += _u16(1)                              # frame_count
    e += b"\0" * 32                           # compressor name
    e += _u16(0x18) + struct.pack(">h", -1)
    e += _box(b"hvcC", hvcc)
    e += extra_boxes                          # colr/mdcv/clli children
    return _box(b"hvc1", bytes(e))


class HeifSequenceWriter:
    """HEVC access units -> 'msf1' HEIF image sequence (one video track,
    handler 'pict')."""

    def __init__(self, fps: int = 30, presentation_delay: int = 0,
                 colr=None, mastering_display=None, content_light=None):
        self.fps = fps
        # >0 delays the whole presentation by that many media ticks via a
        # leading empty edit (elst media_time == -1), the multi-entry form
        # players use for A/V start-offset alignment
        self.presentation_delay = int(presentation_delay)
        # colour + static-HDR boxes ride the hvc1 sample entry (the mov
        # convention; same payloads as the still writer's properties)
        self.color_boxes = b"".join(
            _box(t, payload) for (t, payload, _e) in
            _color_props(colr, mastering_display, content_light))
        self.samples: List[bytes] = []
        self.sync: List[int] = []
        self.pts: List[Optional[int]] = []   # composition time (ticks)
        self.dts: List[Optional[int]] = []   # decode time (ticks)
        self.hvcc = b""
        self.width = self.height = 0

    def add_frame(self, annexb: bytes, pts: Optional[int] = None,
                  dts: Optional[int] = None) -> None:
        nals = hevc.split_annexb(annexb)
        ps = {hevc.nal_type(n): n for n in nals
              if hevc.nal_type(n) in (32, 33, 34)}
        # keep VCL + SEI (prefix 39 / suffix 40 — HDR metadata, recovery
        # points) in the sample, like the still writer does
        media = [n for n in nals
                 if hevc.is_vcl(hevc.nal_type(n))
                 or hevc.nal_type(n) in (39, 40)]
        if not self.hvcc and len(ps) == 3:
            self.hvcc = hevc.build_hvcc(ps[32], ps[33], ps[34])
            s = hevc.parse_sps(ps[33])
            self.width, self.height = s.width, s.height
        if not any(hevc.is_vcl(hevc.nal_type(n)) for n in media):
            return
        if any(hevc.is_irap(hevc.nal_type(n)) for n in media):
            self.sync.append(len(self.samples) + 1)    # 1-based
        self.samples.append(_annexb_to_length_prefixed(media))
        self.pts.append(pts)
        self.dts.append(dts if dts is not None else pts)

    def _timing(self):
        """Per-sample (durations, composition offsets, total duration).

        Samples arrive in DECODE order (the encoder's output order).
        With pts/dts given, stts durations come from dts deltas and ctts
        offsets are pts - dts — the display-order metadata a B-frame
        stream needs (reference: NvHeifWriter.cpp:272-469 writes real
        sequence timing via Nokia heif).  Without timestamps every
        sample lasts 1 tick and no ctts is emitted (the bf=0 fast path).
        """
        n = len(self.samples)
        if not any(p is not None for p in self.pts):
            return [1] * n, None, n
        if any(p is None for p in self.pts):
            raise ValueError("mixed timed/untimed samples")
        dts = list(self.dts)
        if any(b <= a for a, b in zip(dts, dts[1:])):
            raise ValueError("samples must be added in decode (dts) order")
        durs = [b - a for a, b in zip(dts, dts[1:])]
        durs.append(durs[-1] if durs else 1)
        offs = [p - d for p, d in zip(self.pts, dts)]
        if all(o == offs[0] for o in offs) and offs[0] == 0:
            offs = None           # no reordering: ctts is pure noise
        return durs, offs, sum(durs)

    @staticmethod
    def _runlen(values):
        """ISO-BMFF (count, value) run-length pairs."""
        runs = []
        for v in values:
            if runs and runs[-1][1] == v:
                runs[-1][0] += 1
            else:
                runs.append([1, v])
        return runs

    def tobytes(self) -> bytes:
        if not self.samples or not self.hvcc:
            raise ValueError("no frames / missing parameter sets")
        n = len(self.samples)
        timescale = self.fps
        durs, offs, dur = self._timing()
        # movie/track duration is the PRESENTATION length — the sum of
        # edit durations (ISO 14496-12 8.3.2), so a leading empty edit
        # extends it; media duration (mdhd) stays `dur`
        pres_dur = dur + max(self.presentation_delay, 0)
        ftyp = _box(b"ftyp", b"msf1" + _u32(0) + b"msf1hevciso8")
        mvhd = _full(b"mvhd", 0, 0,
                     _u32(0) * 2 + _u32(timescale) + _u32(pres_dur) +
                     _u32(0x00010000) + _u16(0x0100) + _u16(0) + _u32(0) * 2 +
                     _u32(0x00010000) + _u32(0) * 2 + _u32(0) + _u32(0x00010000) +
                     _u32(0) * 2 + _u32(0) + _u32(0x40000000) +
                     _u32(0) * 6 + _u32(2))
        tkhd = _full(b"tkhd", 0, 7,
                     _u32(0) * 2 + _u32(1) + _u32(0) + _u32(pres_dur) +
                     _u32(0) * 2 + _u16(0) * 2 + _u16(0) + _u16(0) +
                     _u32(0x00010000) + _u32(0) * 2 + _u32(0) +
                     _u32(0x00010000) + _u32(0) * 2 + _u32(0) +
                     _u32(0x40000000) +
                     _u32(self.width << 16) + _u32(self.height << 16))
        mdhd = _full(b"mdhd", 0, 0,
                     _u32(0) * 2 + _u32(timescale) + _u32(dur) +
                     _u16(0x55C4) + _u16(0))
        hdlr = _full(b"hdlr", 0, 0,
                     b"\0\0\0\0" + b"pict" + b"\0" * 12 + b"gmat seq\0")
        stsd = _full(b"stsd", 0, 0,
                     _u32(1) + _hvc1_sample_entry(self.width, self.height,
                                                  self.hvcc,
                                                  self.color_boxes))
        sruns = self._runlen(durs)
        stts = _full(b"stts", 0, 0, _u32(len(sruns)) +
                     b"".join(_u32(c) + _u32(v) for c, v in sruns))
        ctts = b""
        if offs is not None:
            cruns = self._runlen(offs)
            # version 1 carries signed offsets; all-non-negative streams
            # (the conformant case) get version 0 for maximum readers
            ver = 1 if any(o < 0 for o in offs) else 0
            pack = (lambda v: struct.pack(">i", v)) if ver else _u32
            ctts = _full(b"ctts", ver, 0, _u32(len(cruns)) +
                         b"".join(_u32(c) + pack(v) for c, v in cruns))
        stsc = _full(b"stsc", 0, 0, _u32(1) + _u32(1) + _u32(n) + _u32(1))
        stsz = _full(b"stsz", 0, 0, _u32(0) + _u32(n) +
                     b"".join(_u32(len(s)) for s in self.samples))
        stss = _full(b"stss", 0, 0, _u32(len(self.sync)) +
                     b"".join(_u32(i) for i in self.sync))
        # B-frame reordering delays the first composition time past 0; a
        # compliant writer shifts presentation back with an edit list so
        # playback starts at t=0 (what libavformat/players expect).  A
        # requested presentation_delay additionally prepends an empty edit
        # (media_time == -1) — the standard multi-entry elst form.  Movie
        # and media timescales are identical here (both self.fps), so
        # empty-edit durations need no rescale.
        edts = b""
        cts0 = 0
        if offs is not None:
            from itertools import accumulate
            dts_pre = list(accumulate([0] + durs[:-1]))   # O(n), not O(n^2)
            cts0 = min(d_ + o for d_, o in zip(dts_pre, offs))
        if cts0 > 0 or self.presentation_delay > 0:
            entries = []
            if self.presentation_delay > 0:
                entries.append(_u32(self.presentation_delay) +
                               struct.pack(">i", -1) + _u16(1) + _u16(0))
            entries.append(_u32(dur) + _u32(cts0) + _u16(1) + _u16(0))
            edts = _box(b"edts", _full(
                b"elst", 0, 0, _u32(len(entries)) + b"".join(entries)))
        vmhd = _full(b"vmhd", 0, 1, _u16(0) + _u16(0) * 3)
        dinf = _box(b"dinf", _full(b"dref", 0, 0,
                                   _u32(1) + _full(b"url ", 0, 1, b"")))
        # stco needs the mdat offset: two-pass like the still writer
        def build(stco_off):
            stco = _full(b"stco", 0, 0, _u32(1) + _u32(stco_off))
            stbl = _box(b"stbl",
                        stsd + stts + ctts + stsc + stsz + stco + stss)
            minf = _box(b"minf", vmhd + dinf + stbl)
            mdia = _box(b"mdia", mdhd + hdlr + minf)
            trak = _box(b"trak", tkhd + edts + mdia)
            return _box(b"moov", mvhd + trak)
        probe = build(0)
        mdat_payload = b"".join(self.samples)
        offset = len(ftyp) + len(probe) + 8
        moov = build(offset)
        assert len(moov) == len(probe)
        return ftyp + moov + _box(b"mdat", mdat_payload)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.tobytes())


class HeifSequenceReader:
    """Parse our 'msf1' sequences back into annexb access units."""

    def __init__(self, path_or_bytes):
        if isinstance(path_or_bytes, (bytes, bytearray)):
            d = bytes(path_or_bytes)
        else:
            with open(path_or_bytes, "rb") as f:
                d = f.read()
        self.data = d
        self.hvcc = b""
        self.width = self.height = 0
        self.color_info = {}       # colr/mdcv/clli from the sample entry
        sizes, chunk_off = [], 0
        stts_runs, ctts_runs = [], []
        # (segment_duration[movie ts], media_time[media ts], rate) per
        # elst entry, in file order
        self.edits: List[tuple] = []
        movie_timescale = media_timescale = 0
        moov_span = None
        for typ, s, e in _iter_boxes(d):
            if typ == b"moov":
                moov_span = (s, e)
        if moov_span is None:
            raise IOError("no moov box (not a HEIF sequence)")

        def walk(s, e):
            nonlocal sizes, chunk_off
            nonlocal movie_timescale, media_timescale
            for typ, s2, e2 in _iter_boxes(d, s, e):
                if typ in (b"trak", b"mdia", b"minf", b"stbl", b"edts"):
                    walk(s2, e2)
                elif typ == b"mvhd":
                    ver = d[s2]
                    off = s2 + (4 + 16 if ver == 1 else 4 + 8)
                    movie_timescale = struct.unpack(
                        ">I", d[off:off + 4])[0]
                elif typ == b"mdhd":
                    ver = d[s2]
                    off = s2 + (4 + 16 if ver == 1 else 4 + 8)
                    media_timescale = struct.unpack(
                        ">I", d[off:off + 4])[0]
                elif typ == b"elst":
                    ver = d[s2]
                    cnt = struct.unpack(">I", d[s2 + 4:s2 + 8])[0]
                    esz = 20 if ver == 1 else 12
                    p = s2 + 8
                    for _ in range(min(cnt, max(0, (e2 - p) // esz))):
                        if ver == 1:
                            sd, mt = struct.unpack(">Qq", d[p:p + 16])
                            ri, rf = struct.unpack(">hH", d[p + 16:p + 20])
                        else:
                            sd, mt = struct.unpack(">Ii", d[p:p + 8])
                            ri, rf = struct.unpack(">hH", d[p + 8:p + 12])
                        self.edits.append((sd, mt, ri + rf / 65536.0))
                        p += esz
                elif typ == b"stsd":
                    entry = d[s2 + 8:e2]
                    if entry[4:8] == b"hvc1":
                        self.width = struct.unpack(">H", entry[8 + 24:8 + 26])[0]
                        self.height = struct.unpack(">H", entry[8 + 26:8 + 28])[0]
                        # children follow the 8-byte entry header + the
                        # 78-byte VisualSampleEntry body
                        for t3, s3, e3 in _iter_boxes(d, s2 + 8 + 8 + 78, e2):
                            if t3 == b"hvcC":
                                self.hvcc = d[s3:e3]
                            else:
                                _collect_color_box(t3, d[s3:e3],
                                                   self.color_info)
                elif typ == b"stsz":
                    body = d[s2 + 4:e2]
                    cnt = struct.unpack(">I", body[4:8])[0]
                    sizes = [struct.unpack(">I", body[8 + 4 * i:12 + 4 * i])[0]
                             for i in range(cnt)]
                elif typ == b"stco":
                    chunk_off = struct.unpack(">I", d[s2 + 8:s2 + 12])[0]
                elif typ == b"stts":
                    cnt = struct.unpack(">I", d[s2 + 4:s2 + 8])[0]
                    for i in range(cnt):
                        c, v = struct.unpack(
                            ">II", d[s2 + 8 + 8 * i:s2 + 16 + 8 * i])
                        stts_runs.append((c, v))
                elif typ == b"ctts":
                    ver = d[s2]
                    cnt = struct.unpack(">I", d[s2 + 4:s2 + 8])[0]
                    fmt = ">Ii" if ver == 1 else ">II"
                    for i in range(cnt):
                        c, v = struct.unpack(
                            fmt, d[s2 + 8 + 8 * i:s2 + 16 + 8 * i])
                        ctts_runs.append((c, v))
        walk(*moov_span)
        if not sizes or not self.hvcc:
            raise IOError("missing sample table / hvcC")
        self.frames: List[bytes] = []
        off = chunk_off
        for sz in sizes:
            if off + sz > len(d):
                raise IOError(f"sample [{off}:{off + sz}] is beyond the "
                              f"{len(d)}-byte buffer — truncated sequence?")
            self.frames.append(d[off:off + sz])
            off += sz
        # per-sample timing: dts from stts run-lengths, composition
        # (display) time = dts + ctts offset; without ctts pts == dts
        n = len(self.frames)
        durs: List[int] = []
        for c, v in stts_runs:
            durs += [v] * c
        durs = (durs + [1] * n)[:n]
        self.sample_dts = [0] * n
        for i in range(1, n):
            self.sample_dts[i] = self.sample_dts[i - 1] + durs[i - 1]
        offs: List[int] = []
        for c, v in ctts_runs:
            offs += [v] * c
        offs = (offs + [0] * n)[:n]
        # Edit list -> presentation mapping (ISO 14496-12 8.6.6).
        # Leading empty edits (media_time == -1, duration in MOVIE
        # timescale) delay the presentation.  Each media edit presents
        # the media span starting at its media_time, with `rate` media
        # units elapsing per presentation unit — so a sample at media
        # composition time m presents at
        #   pres_start + (m - media_time) / rate
        # through the FIRST edit whose media span contains m (rate 0 =
        # dwell: the span pins to pres_start).  Samples before the
        # first entry point or past the last span extrapolate from the
        # nearest edit, which reduces to the classic uniform shift for
        # the common single-media-edit form.
        mts = media_timescale or 1
        mvs = movie_timescale or mts
        raw_pts = [d_ + o for d_, o in zip(self.sample_dts, offs)]
        segs = []          # (media_start, media_end|None, rate, pres0)
        pres = 0
        for sd, mt, rate in self.edits:
            sd_media = round(sd * mts / mvs)
            if mt < 0:                    # empty edit
                pres += sd_media
                continue
            end = mt + round(sd_media * rate) if sd else None
            segs.append((mt, end, rate, pres))
            pres += sd_media
        if not segs:
            # empty-edit-only list: the accumulated delay still applies
            self.sample_pts = [p + pres for p in raw_pts]
        else:
            def present(m):
                seg = None
                for s in segs:
                    if m >= s[0] and (s[1] is None or m < s[1]):
                        seg = s
                        break
                if seg is None:
                    before = [s for s in segs if m >= s[0]]
                    seg = before[-1] if before else segs[0]
                ms, _me, rate, p0 = seg
                if rate == 0:
                    return p0             # dwell
                return p0 + round((m - ms) / rate)
            self.sample_pts = [present(m) for m in raw_pts]

    def display_order(self) -> List[int]:
        """Sample indices sorted by composition time — the order a
        compliant player presents them (decode-order list + ctts)."""
        return sorted(range(len(self.frames)),
                      key=lambda i: self.sample_pts[i])

    def frame_annexb(self, i: int) -> bytes:
        nals, lsz = hevc.parse_hvcc(self.hvcc)
        out = b""
        if i == 0:
            out = b"".join(b"\x00\x00\x00\x01" + n for n in nals)
        return out + _lp_to_annexb(self.frames[i], lsz)


def encode_sequence(frames, fps: int = 30, crf: float = 22.0,
                    gop: int = 30, bf: int = 0,
                    presentation_delay: int = 0, **color_kwargs) -> bytes:
    """[(y,u,v), ...] -> inter-coded HEIF image sequence bytes.

    bf>0 enables B-frames: samples land in the container in decode
    order with real stts/ctts timing (composition offsets from the
    encoder's pts/dts), so compliant players present display order —
    the NvHeifWriter sequence-timing behavior (NvHeifWriter.cpp:272-469).
    presentation_delay>0 (media ticks) prepends an empty edit-list
    entry delaying playback — the multi-entry elst form.
    """
    first = frames[0][0]
    h, w = first.shape
    enc = tk.Encoder("libx265", w, h, fps=(fps, 1), gop=gop, crf=crf,
                     bf=bf, opts="x265-params=log-level=0")
    wtr = HeifSequenceWriter(fps, presentation_delay=presentation_delay,
                             **color_kwargs)
    pending = []
    for i, (y, u, v) in enumerate(frames):
        pending += enc.encode(y, u, v, pts=i)
    pending += enc.flush()
    extra = enc.extradata()
    enc.close()
    for i, p in enumerate(pending):
        wtr.add_frame((extra if i == 0 else b"") + p.data,
                      pts=p.pts, dts=p.dts)
    return wtr.tobytes()


def decode_sequence(data, display_order: bool = True) -> list:
    """HEIF sequence bytes/path -> [(y, u, v), ...].

    display_order=True (default) presents frames by composition time
    (ctts applied on read); False returns raw decoder output order.
    """
    rdr = HeifSequenceReader(data)
    dec = tk.Decoder(tk.CODEC_HEVC, width=rdr.width, height=rdr.height)
    out = []
    for i in range(len(rdr.frames)):
        out += [(y, u, v, p) for (y, u, v, p) in
                dec.decode(rdr.frame_annexb(i), rdr.sample_pts[i])]
    out += [(y, u, v, p) for (y, u, v, p) in dec.decode(None)]
    dec.close()
    if display_order:
        out.sort(key=lambda t: t[3])
    return [(y, u, v) for (y, u, v, _) in out]
