"""HEVC bitstream parser subset — rebuild of metrans HevcParser (M8); a
copy of `gmat_tpu/av/hevc.py` (pure Python, no framework).

Covers what the toolkit needs from the reference's ~4.7k-LoC parser
(metrans/include/HevcParser/*):
  * annexb NAL splitting (NvHeifWriter.cpp:81-155 start-code scan)
  * NAL type classification incl. sub-layer non-reference detection
  * SPS parsing: profile_tier_level, chroma format, dimensions, bit depth
    (enough to build an hvcC record and to reason about streams)
  * slice-header first_slice flag / slice type

Pure Python; packets are small and this runs once per stream setup.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

NAL_TRAIL_N, NAL_TRAIL_R = 0, 1
NAL_IDR_W_RADL, NAL_IDR_N_LP, NAL_CRA = 19, 20, 21
NAL_VPS, NAL_SPS, NAL_PPS = 32, 33, 34


def split_annexb(data: bytes) -> List[bytes]:
    """Split an annexb stream into NAL payloads (no start codes)."""
    out = []
    i = 0
    n = len(data)
    start = -1
    while i + 3 <= n:
        if data[i] == 0 and data[i + 1] == 0 and data[i + 2] == 1:
            if start >= 0:
                end = i
                # strip ALL trailing zeros: the 4-byte start code's
                # leading zero plus any trailing_zero_8bits padding (a
                # real payload never ends in raw 0x00 — rbsp stops with
                # the 0x80.. stop-bit byte and cabac_zero_words are
                # emulation-escaped)
                while end > start and data[end - 1] == 0:
                    end -= 1
                if end > start:  # never emit empty payloads (truncated
                    out.append(data[start:end])    # or doubled codes)
            i += 3
            start = i
        else:
            i += 1
    if start >= 0 and n > start:
        end = n
        while end > start + 2 and data[end - 1] == 0:
            end -= 1             # tail padding after the last NAL
        out.append(data[start:end])
    return out


def nal_type(nal: bytes) -> int:
    return (nal[0] >> 1) & 0x3F


def is_vcl(t: int) -> bool:
    return t <= 31


def is_idr(t: int) -> bool:
    return t in (NAL_IDR_W_RADL, NAL_IDR_N_LP)


def is_irap(t: int) -> bool:
    return 16 <= t <= 23


def is_sublayer_nonref(t: int) -> bool:
    """TRAIL_N/TSA_N/STSA_N/RADL_N/RASL_N... — even VCL types <= 14."""
    return t <= 14 and t % 2 == 0


class BitReader:
    """RBSP bit reader (removes emulation-prevention bytes)."""

    def __init__(self, nal: bytes, skip_header: int = 2):
        rbsp = bytearray()
        i = skip_header
        while i < len(nal):
            if i + 2 < len(nal) and nal[i] == 0 and nal[i + 1] == 0 and nal[i + 2] == 3:
                rbsp += nal[i:i + 2]
                i += 3
            else:
                rbsp.append(nal[i])
                i += 1
        self.data = bytes(rbsp)
        self.pos = 0

    def u(self, n: int) -> int:
        if (self.pos + n + 7) >> 3 > len(self.data):
            # diagnosable error for truncated NALs (a bare IndexError
            # would escape the parser's ValueError conventions)
            raise ValueError(f"truncated NAL: need {n} bits at "
                             f"{self.pos}/{len(self.data) * 8}")
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 31:
                raise ValueError("bad exp-golomb")
        return (1 << zeros) - 1 + (self.u(zeros) if zeros else 0)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k % 2 else -(k // 2)


@dataclasses.dataclass
class Sps:
    width: int
    height: int
    chroma_format_idc: int
    bit_depth_luma: int
    bit_depth_chroma: int
    general_profile_space: int
    general_tier_flag: int
    general_profile_idc: int
    general_profile_compat: int       # 32 bits
    general_constraint_bits: bytes    # 6 bytes
    general_level_idc: int
    max_sub_layers: int
    temporal_id_nesting: int
    raw: bytes = b""


def parse_sps(nal: bytes) -> Sps:
    r = BitReader(nal)
    r.u(4)                                  # sps_video_parameter_set_id
    max_sub_layers = r.u(3) + 1
    nesting = r.u(1)
    # profile_tier_level(1, max_sub_layers-1)
    space = r.u(2); tier = r.u(1); profile = r.u(5)
    compat = r.u(32)
    constraint = bytes(r.u(8) for _ in range(6))
    level = r.u(8)
    sub_present = [(r.u(1), r.u(1)) for _ in range(max_sub_layers - 1)]
    if max_sub_layers > 1:
        for _ in range(max_sub_layers - 1, 8):
            r.u(2)
        for pp, lp in sub_present:
            if pp:
                r.u(2 + 1 + 5 + 32 + 48)
            if lp:
                r.u(8)
    r.ue()                                  # sps_seq_parameter_set_id
    chroma = r.ue()
    if chroma == 3:
        r.u(1)
    width = r.ue()
    height = r.ue()
    if r.u(1):                              # conformance_window_flag
        left, right, top, bottom = r.ue(), r.ue(), r.ue(), r.ue()
        sub_w = 2 if chroma in (1, 2) else 1
        sub_h = 2 if chroma == 1 else 1
        width -= (left + right) * sub_w
        height -= (top + bottom) * sub_h
    bd_luma = r.ue() + 8
    bd_chroma = r.ue() + 8
    return Sps(width, height, chroma, bd_luma, bd_chroma, space, tier,
               profile, compat, constraint, level, max_sub_layers, nesting,
               raw=nal)


def first_slice_in_pic(nal: bytes) -> bool:
    t = nal_type(nal)
    if not is_vcl(t):
        return False
    return bool(nal[2] & 0x80)      # first_slice_segment_in_pic_flag


def classify_stream(data: bytes) -> List[Tuple[int, bytes]]:
    """annexb bytes -> [(nal_type, payload), ...]"""
    return [(nal_type(n), n) for n in split_annexb(data) if n]


def build_hvcc(vps: bytes, sps_nal: bytes, pps: bytes,
               length_size: int = 4) -> bytes:
    """HEVCDecoderConfigurationRecord (ISO 14496-15 §8.3.3.1) from
    parameter set NALs — what NvHeifWriter feeds via feedDecoderConfig
    (NvHeifWriter.cpp:211-224)."""
    sps = parse_sps(sps_nal)
    rec = bytearray()
    rec.append(1)                                         # configurationVersion
    rec.append((sps.general_profile_space << 6) |
               (sps.general_tier_flag << 5) | sps.general_profile_idc)
    rec += sps.general_profile_compat.to_bytes(4, "big")
    rec += sps.general_constraint_bits
    rec.append(sps.general_level_idc)
    rec += (0xF000).to_bytes(2, "big")                    # min_spatial_segmentation
    rec.append(0xFC)                                      # parallelismType
    rec.append(0xFC | (sps.chroma_format_idc & 3))
    rec.append(0xF8 | ((sps.bit_depth_luma - 8) & 7))
    rec.append(0xF8 | ((sps.bit_depth_chroma - 8) & 7))
    rec += (0).to_bytes(2, "big")                         # avgFrameRate
    rec.append((0 << 6) | ((sps.temporal_id_nesting & 1) << 2) |
               ((length_size - 1) & 3))
    arrays = [(NAL_VPS, vps), (NAL_SPS, sps_nal), (NAL_PPS, pps)]
    rec.append(len(arrays))
    for t, nal in arrays:
        rec.append(0x80 | t)                              # array_completeness=1
        rec += (1).to_bytes(2, "big")
        rec += len(nal).to_bytes(2, "big")
        rec += nal
    return bytes(rec)


def parse_hvcc(rec: bytes) -> Tuple[List[bytes], int]:
    """hvcC record -> (parameter set NALs, nal length size)."""
    if len(rec) < 23:
        raise ValueError(f"hvcC record too short ({len(rec)} bytes)")
    length_size = (rec[21] & 3) + 1
    n_arrays = rec[22]
    nals = []
    i = 23
    for _ in range(n_arrays):
        i += 1
        count = int.from_bytes(rec[i:i + 2], "big"); i += 2
        for _ in range(count):
            ln = int.from_bytes(rec[i:i + 2], "big"); i += 2
            if i + ln > len(rec):
                raise ValueError("hvcC record truncated mid-NAL")
            nals.append(rec[i:i + ln]); i += ln
    return nals, length_size


# ===================================================================== RPS
# Short-term reference picture set parsing + the AppHevcParse analysis
# (metrans/app/AppHevcParse.cpp:141-210): frame N-1 is skippable when frame
# N's ref pic set does not contain N-1's POC.


@dataclasses.dataclass
class StRps:
    s0_deltas: list          # abs(DeltaPocS0[i]) - 1 (negative refs)
    s1_deltas: list          # DeltaPocS1[i] - 1 (positive refs)
    used0: list
    used1: list

    @property
    def num_delta_pocs(self):
        return len(self.s0_deltas) + len(self.s1_deltas)


def _parse_st_rps(r: "BitReader", idx: int, rps_list: list,
                  num_rps: Optional[int] = None) -> StRps:
    """st_ref_pic_set(idx) per H.265 7.3.7 incl. inter-set prediction.

    num_rps = num_short_term_ref_pic_sets from the SPS; delta_idx_minus1
    is only present for the slice-header set (idx == num_rps, 7.3.7) —
    never for SPS-level sets.
    """
    if num_rps is None:
        num_rps = len(rps_list)          # slice-level call convention
    inter_pred = r.u(1) if idx != 0 else 0
    if inter_pred:
        delta_idx = (r.ue() + 1) if idx == num_rps else 1
        if delta_idx > idx:      # spec: RefRpsIdx must be >= 0; Python
            raise ValueError(    # negative indexing would silently wrap
                f"st_ref_pic_set delta_idx {delta_idx} > stRpsIdx {idx}")
        ref = rps_list[idx - delta_idx]
        sign = r.u(1)
        abs_delta = r.ue() + 1
        delta_rps = -abs_delta if sign else abs_delta
        # build DeltaPoc lists of the reference set
        ref_deltas = ([-(d + 1) for d in ref.s0_deltas] +
                      [(d + 1) for d in ref.s1_deltas])
        use, used_by = [], []
        for j in range(ref.num_delta_pocs + 1):
            u = r.u(1)
            used_by.append(u)
            use.append(1 if u else r.u(1))
        s0, s1, u0, u1 = [], [], [], []
        # spec derivation (7-59..7-71), simplified for the common layout
        for j in range(len(ref.s1_deltas) - 1, -1, -1):
            dpoc = ref_deltas[len(ref.s0_deltas) + j] + delta_rps
            if dpoc < 0 and use[len(ref.s0_deltas) + j]:
                s0.append(-dpoc - 1)
                u0.append(used_by[len(ref.s0_deltas) + j])
        if delta_rps < 0 and use[ref.num_delta_pocs]:
            s0.append(-delta_rps - 1)
            u0.append(used_by[ref.num_delta_pocs])
        for j in range(len(ref.s0_deltas)):
            dpoc = ref_deltas[j] + delta_rps
            if dpoc < 0 and use[j]:
                s0.append(-dpoc - 1)
                u0.append(used_by[j])
        for j in range(len(ref.s0_deltas) - 1, -1, -1):
            dpoc = ref_deltas[j] + delta_rps
            if dpoc > 0 and use[j]:
                s1.append(dpoc - 1)
                u1.append(used_by[j])
        if delta_rps > 0 and use[ref.num_delta_pocs]:
            s1.append(delta_rps - 1)
            u1.append(used_by[ref.num_delta_pocs])
        for j in range(len(ref.s1_deltas)):
            dpoc = ref_deltas[len(ref.s0_deltas) + j] + delta_rps
            if dpoc > 0 and use[len(ref.s0_deltas) + j]:
                s1.append(dpoc - 1)
                u1.append(used_by[len(ref.s0_deltas) + j])
        return StRps(s0, s1, u0, u1)
    n_neg = r.ue()
    n_pos = r.ue()
    s0, u0, s1, u1 = [], [], [], []
    acc = 0
    for _ in range(n_neg):
        acc += r.ue() + 1                    # cumulative coding (7-67/7-69)
        s0.append(acc - 1)                   # store abs(DeltaPoc)-1
        u0.append(r.u(1))
    acc = 0
    for _ in range(n_pos):
        acc += r.ue() + 1
        s1.append(acc - 1)
        u1.append(r.u(1))
    return StRps(s0, s1, u0, u1)


def _skip_scaling_list(r: "BitReader"):
    # 7.3.4: matrixId steps by 3 for sizeId 3 but still runs to 6
    # (iterations 0 and 3 — TWO 32x32 lists, not one)
    for size_id in range(4):
        m = 0
        while m < 6:
            if not r.u(1):                       # pred_mode_flag
                r.ue()                           # pred_matrix_id_delta
            else:
                ncoef = min(64, 1 << (4 + (size_id << 1)))
                if size_id > 1:
                    r.se()                       # dc coef
                for _ in range(ncoef):
                    r.se()
            m += 1 if size_id != 3 else 3        # matrixId inc step


@dataclasses.dataclass
class SpsFull:
    sps: "Sps"
    log2_max_poc_lsb: int
    rps_list: list
    sps_id: int
    separate_colour_plane: bool = False
    pic_size_in_ctbs: int = 1          # PicSizeInCtbsY (slice addresses)
    lt_present: bool = False           # long_term_ref_pics_present_flag
    lt_poc_lsb_sps: tuple = ()         # lt_ref_pic_poc_lsb_sps[i]
    vui: Optional["Vui"] = None        # E.2.1 (pic_timing SEI context)


@dataclasses.dataclass
class Hrd:
    """E.2.2 hrd_parameters — the subset pic_timing/buffering_period SEIs
    need (HevcParserImpl.cpp HRD context, Hevc.h:110)."""
    nal_hrd: bool = False
    vcl_hrd: bool = False
    sub_pic_hrd: bool = False
    tick_divisor: int = 2                       # tick_divisor_minus2 + 2
    du_cpb_removal_delay_len: int = 24          # *_increment_length_minus1+1
    sub_pic_cpb_in_pic_timing: bool = False
    dpb_output_delay_du_len: int = 24
    bit_rate_scale: int = 0
    cpb_size_scale: int = 0
    initial_cpb_removal_delay_len: int = 24     # *_length_minus1 + 1
    au_cpb_removal_delay_len: int = 24
    dpb_output_delay_len: int = 24
    cpb_cnt: tuple = (1,)                       # per sub-layer

    @property
    def cpb_dpb_delays_present(self) -> bool:
        return self.nal_hrd or self.vcl_hrd


@dataclasses.dataclass
class Vui:
    """E.2.1 vui_parameters — timing/field flags + HRD."""
    field_seq: bool = False
    frame_field_info_present: bool = False
    num_units_in_tick: int = 0
    time_scale: int = 0
    hrd: Optional[Hrd] = None


def _parse_sub_layer_hrd(r: "BitReader", cpb_cnt: int, sub_pic: bool):
    for _ in range(cpb_cnt):
        r.ue(); r.ue()                          # bit_rate / cpb_size value
        if sub_pic:
            r.ue(); r.ue()                      # *_du values
        r.u(1)                                  # cbr_flag


def parse_hrd(r: "BitReader", max_sub_layers: int,
              common_inf: bool = True) -> Hrd:
    """E.2.2 hrd_parameters(commonInfPresentFlag, maxNumSubLayersMinus1)."""
    h = Hrd()
    if common_inf:
        h.nal_hrd = bool(r.u(1))
        h.vcl_hrd = bool(r.u(1))
        if h.nal_hrd or h.vcl_hrd:
            h.sub_pic_hrd = bool(r.u(1))
            if h.sub_pic_hrd:
                h.tick_divisor = r.u(8) + 2
                h.du_cpb_removal_delay_len = r.u(5) + 1
                h.sub_pic_cpb_in_pic_timing = bool(r.u(1))
                h.dpb_output_delay_du_len = r.u(5) + 1
            h.bit_rate_scale = r.u(4)
            h.cpb_size_scale = r.u(4)
            if h.sub_pic_hrd:
                r.u(4)                          # cpb_size_du_scale
            h.initial_cpb_removal_delay_len = r.u(5) + 1
            h.au_cpb_removal_delay_len = r.u(5) + 1
            h.dpb_output_delay_len = r.u(5) + 1
    cpb_cnts = []
    for _ in range(max_sub_layers):
        fixed_general = r.u(1)
        fixed_within = r.u(1) if not fixed_general else 1
        low_delay = 0
        if fixed_within:
            r.ue()                              # elemental_duration_in_tc
        else:
            low_delay = r.u(1)
        cpb = 1 if low_delay else r.ue() + 1
        cpb_cnts.append(cpb)
        if h.nal_hrd:
            _parse_sub_layer_hrd(r, cpb, h.sub_pic_hrd)
        if h.vcl_hrd:
            _parse_sub_layer_hrd(r, cpb, h.sub_pic_hrd)
    h.cpb_cnt = tuple(cpb_cnts)
    return h


def parse_vui(r: "BitReader", max_sub_layers: int) -> Vui:
    """E.2.1 vui_parameters (after vui_parameters_present_flag)."""
    v = Vui()
    if r.u(1):                                  # aspect_ratio_info_present
        if r.u(8) == 255:                       # EXTENDED_SAR
            r.u(32)
    if r.u(1):                                  # overscan_info_present
        r.u(1)
    if r.u(1):                                  # video_signal_type_present
        r.u(4)                                  # video_format + full_range
        if r.u(1):                              # colour_description_present
            r.u(24)
    if r.u(1):                                  # chroma_loc_info_present
        r.ue(); r.ue()
    r.u(1)                                      # neutral_chroma_indication
    v.field_seq = bool(r.u(1))
    v.frame_field_info_present = bool(r.u(1))
    if r.u(1):                                  # default_display_window
        r.ue(); r.ue(); r.ue(); r.ue()
    if r.u(1):                                  # vui_timing_info_present
        v.num_units_in_tick = r.u(32)
        v.time_scale = r.u(32)
        if r.u(1):                              # poc_proportional_to_timing
            r.ue()
        if r.u(1):                              # vui_hrd_parameters_present
            v.hrd = parse_hrd(r, max_sub_layers)
    # bitstream_restriction fields follow; nothing downstream needs them
    return v


def parse_sps_full(nal: bytes) -> SpsFull:
    """SPS parse continued far enough to get the RPS list, the CTB count
    (slice_segment_address width) and the long-term ref sets (7.3.2.2 —
    the HevcParserImpl.cpp SPS section)."""
    r = BitReader(nal)
    r.u(4)
    max_sub_layers = r.u(3) + 1
    r.u(1)
    r.u(2 + 1 + 5)
    r.u(32)
    r.u(48)
    r.u(8)
    sub_present = [(r.u(1), r.u(1)) for _ in range(max_sub_layers - 1)]
    if max_sub_layers > 1:
        for _ in range(max_sub_layers - 1, 8):
            r.u(2)
        for pp, lp in sub_present:
            if pp:
                r.u(88)
            if lp:
                r.u(8)
    sps_id = r.ue()
    chroma = r.ue()
    sep_colour = bool(r.u(1)) if chroma == 3 else False
    w = r.ue(); h = r.ue()                        # pre-crop pic sizes
    if r.u(1):
        r.ue(); r.ue(); r.ue(); r.ue()
    r.ue(); r.ue()                                # bit depths
    log2_max_poc = r.ue() + 4
    sub_ordering = r.u(1)
    n = max_sub_layers if sub_ordering else 1
    for _ in range(n):
        r.ue(); r.ue(); r.ue()
    log2_min_cb = r.ue() + 3
    log2_diff_cb = r.ue()
    r.ue(); r.ue()                                # transform block sizes
    r.ue(); r.ue()                                # transform hierarchy
    if r.u(1):                                    # scaling_list_enabled
        if r.u(1):
            _skip_scaling_list(r)
    r.u(1); r.u(1)                                # amp, sao
    if r.u(1):                                    # pcm_enabled
        r.u(4); r.u(4); r.ue(); r.ue(); r.u(1)
    num_rps = r.ue()
    rps_list = []
    for i in range(num_rps):
        rps_list.append(_parse_st_rps(r, i, rps_list, num_rps))
    lt_present = bool(r.u(1))
    lt_lsb = []
    if lt_present:
        for _ in range(r.ue()):                   # num_long_term_ref_pics_sps
            lt_lsb.append(r.u(log2_max_poc))
            r.u(1)                                # used_by_curr_pic_lt_sps
    ctb_log2 = log2_min_cb + log2_diff_cb
    ctb = 1 << ctb_log2
    pic_size_in_ctbs = ((w + ctb - 1) // ctb) * ((h + ctb - 1) // ctb)
    vui = None
    try:
        r.u(1)                                    # sps_temporal_mvp_enabled
        r.u(1)                                    # strong_intra_smoothing
        if r.u(1):                                # vui_parameters_present
            vui = parse_vui(r, max_sub_layers)
    except ValueError:
        vui = None      # truncated tail: VUI context simply unavailable
    sps = parse_sps(nal)
    return SpsFull(sps, log2_max_poc, rps_list, sps_id, sep_colour,
                   pic_size_in_ctbs, lt_present, tuple(lt_lsb), vui)


@dataclasses.dataclass
class Pps:
    pps_id: int
    sps_id: int
    dependent_slices: bool
    output_flag_present: bool
    num_extra_slice_header_bits: int
    # remaining header fields (HevcParserImpl.cpp PPS section); parsed so
    # non-default PPSes are fully decoded, though only the five above gate
    # the slice-header subset we read
    sign_data_hiding: bool = False
    cabac_init_present: bool = False
    num_ref_idx_l0_default: int = 1
    num_ref_idx_l1_default: int = 1
    init_qp: int = 26
    constrained_intra_pred: bool = False
    transform_skip: bool = False
    cu_qp_delta_enabled: bool = False
    cu_qp_delta_depth: int = 0
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    slice_chroma_qp_offsets_present: bool = False
    weighted_pred: bool = False
    weighted_bipred: bool = False
    transquant_bypass: bool = False
    tiles_enabled: bool = False
    entropy_coding_sync: bool = False


def parse_pps(nal: bytes) -> Pps:
    r = BitReader(nal)
    pps_id = r.ue()
    sps_id = r.ue()
    dep = r.u(1)
    out = r.u(1)
    extra = r.u(3)
    sign = r.u(1)
    cabac = r.u(1)
    nr0 = r.ue() + 1
    nr1 = r.ue() + 1
    init_qp = r.se() + 26
    cip = r.u(1)
    tskip = r.u(1)
    cuqp = r.u(1)
    cuqp_depth = r.ue() if cuqp else 0
    cb_off = r.se()
    cr_off = r.se()
    sl_chroma = r.u(1)
    wp = r.u(1)
    wbp = r.u(1)
    tqb = r.u(1)
    tiles = r.u(1)
    wpp = r.u(1)
    return Pps(pps_id, sps_id, bool(dep), bool(out), extra, bool(sign),
               bool(cabac), nr0, nr1, init_qp, bool(cip), bool(tskip),
               bool(cuqp), cuqp_depth, cb_off, cr_off, bool(sl_chroma),
               bool(wp), bool(wbp), bool(tqb), bool(tiles), bool(wpp))


@dataclasses.dataclass
class Vps:
    """Video parameter set (7.3.2.1) — the HevcParserImpl.cpp VPS
    section.  Carries the stream-level PTL and DPB sizing the SPS may
    inherit; timing info yields the container-independent frame rate."""
    vps_id: int
    max_layers: int
    max_sub_layers: int
    temporal_id_nesting: bool
    general_profile_idc: int
    general_tier_flag: int
    general_level_idc: int
    max_dec_pic_buffering: tuple     # per sub-layer, minus1 NOT applied
    num_reorder_pics: tuple
    max_latency_increase: tuple
    fps: float = 0.0                 # 0 = no vps timing info


def parse_vps(nal: bytes) -> Vps:
    r = BitReader(nal)
    vps_id = r.u(4)
    r.u(2)                                        # base_layer internal/avail
    max_layers = r.u(6) + 1
    max_sub_layers = r.u(3) + 1
    nesting = bool(r.u(1))
    r.u(16)                                       # reserved 0xffff
    # profile_tier_level(1, max_sub_layers - 1)
    r.u(2)                                        # profile_space
    tier = r.u(1)
    profile_idc = r.u(5)
    r.u(32)                                       # compat flags
    r.u(48)                                       # constraint bits
    level_idc = r.u(8)
    sub_present = [(r.u(1), r.u(1)) for _ in range(max_sub_layers - 1)]
    if max_sub_layers > 1:
        for _ in range(max_sub_layers - 1, 8):
            r.u(2)
        for pp, lp in sub_present:
            if pp:
                r.u(88)
            if lp:
                r.u(8)
    sub_ordering = r.u(1)
    start = 0 if sub_ordering else max_sub_layers - 1
    dpb, reorder, latency = [], [], []
    for _ in range(start, max_sub_layers):
        dpb.append(r.ue() + 1)
        reorder.append(r.ue())
        latency.append(r.ue())
    if not sub_ordering:                          # replicate to all layers
        dpb *= max_sub_layers
        reorder *= max_sub_layers
        latency *= max_sub_layers
    max_layer_id = r.u(6)
    num_layer_sets = r.ue() + 1
    for _ in range(1, num_layer_sets):
        for _ in range(max_layer_id + 1):
            r.u(1)                                # layer_id_included_flag
    fps = 0.0
    if r.u(1):                                    # vps_timing_info_present
        num_units = r.u(32)
        time_scale = r.u(32)
        if num_units:
            fps = time_scale / num_units
    return Vps(vps_id, max_layers, max_sub_layers, nesting, profile_idc,
               tier, level_idc, tuple(dpb[:max_sub_layers]),
               tuple(reorder[:max_sub_layers]),
               tuple(latency[:max_sub_layers]), fps)


@dataclasses.dataclass
class SliceRps:
    poc_lsb: int
    ref_pocs: set            # POCs (lsb arithmetic) this slice references
    is_idr: bool
    nal_type_: int
    temporal_id: int = 0
    log2_max_poc_lsb: int = 8    # from the slice's SPS (POC derivation)


def parse_slice_rps(nal: bytes, spsf, pps) -> Optional[SliceRps]:
    """Slice-segment header up to (and incl.) the reference picture sets
    (7.3.6.1 — the HevcParserImpl.cpp slice-header section).

    `spsf`/`pps` may be single parsed sets or {id: set} dicts; with dicts
    the slice's own slice_pic_parameter_set_id selects the PPS and its
    pps_seq_parameter_set_id selects the SPS (multi-parameter-set streams).
    Returns None for dependent slice segments (they inherit the previous
    independent segment's header and start no new picture).
    """
    t = nal_type(nal)
    if not is_vcl(t):
        return None
    r = BitReader(nal)
    first = r.u(1)
    if is_irap(t):
        r.u(1)                                    # no_output_of_prior_pics
    pps_id = r.ue()                               # slice_pic_parameter_set_id
    if isinstance(pps, dict):
        pps = pps.get(pps_id)
        if pps is None:
            return None
    if isinstance(spsf, dict):
        spsf = spsf.get(pps.sps_id)
        if spsf is None:
            return None
    dependent = False
    if not first:
        if pps.dependent_slices:
            dependent = bool(r.u(1))
        # slice_segment_address: u(ceil(log2(PicSizeInCtbsY)))
        nbits = max(1, (spsf.pic_size_in_ctbs - 1).bit_length())
        r.u(nbits)
    if dependent:
        return None
    r.u(pps.num_extra_slice_header_bits)          # slice_reserved_flag[i]
    r.ue()                                        # slice_type
    if pps.output_flag_present:
        r.u(1)                                    # pic_output_flag
    if spsf.separate_colour_plane:
        r.u(2)                                    # colour_plane_id
    tid = (nal[1] & 0x07) - 1
    if is_idr(t):
        return SliceRps(0, set(), True, t, tid, spsf.log2_max_poc_lsb)
    poc_lsb = r.u(spsf.log2_max_poc_lsb)
    rps = None
    if r.u(1):                                    # short_term_ref_pic_set_sps_flag
        nbits = max(1, (len(spsf.rps_list) - 1).bit_length())
        idx = r.u(nbits) if len(spsf.rps_list) > 1 else 0
        if idx < len(spsf.rps_list):
            rps = spsf.rps_list[idx]
    else:
        rps = _parse_st_rps(r, len(spsf.rps_list), spsf.rps_list)
    refs = set()
    max_poc = 1 << spsf.log2_max_poc_lsb
    if rps:
        # POC-lsb arithmetic wraps modulo 2^log2_max_poc_lsb (8.3.1) —
        # without the wrap, references across a wraparound boundary are
        # missed and referenced frames get marked skippable
        for d in rps.s0_deltas:
            refs.add((poc_lsb - (d + 1)) % max_poc)
        for d in rps.s1_deltas:
            refs.add((poc_lsb + (d + 1)) % max_poc)
    if getattr(spsf, "lt_present", False):
        # long-term entries reference pictures by POC lsb directly; a frame
        # held as LTR must not be marked skippable
        num_lt_sps = 0
        if len(spsf.lt_poc_lsb_sps) > 0:
            num_lt_sps = r.ue()
        num_lt_pics = r.ue()
        for i in range(num_lt_sps + num_lt_pics):
            if i < num_lt_sps:
                if len(spsf.lt_poc_lsb_sps) > 1:
                    nb = max(1, (len(spsf.lt_poc_lsb_sps) - 1).bit_length())
                    idx = r.u(nb)
                else:
                    idx = 0
                if idx < len(spsf.lt_poc_lsb_sps):
                    refs.add(spsf.lt_poc_lsb_sps[idx])
            else:
                refs.add(r.u(spsf.log2_max_poc_lsb))
                r.u(1)                            # used_by_curr_pic_lt_flag
            if r.u(1):                            # delta_poc_msb_present
                r.ue()                            # delta_poc_msb_cycle_lt
    return SliceRps(poc_lsb, refs, False, t, tid, spsf.log2_max_poc_lsb)


def parse_stream_slices(packets) -> list:
    """[SliceRps, ...] in decode order — one per picture (dependent
    segments skipped), parameter sets tracked by id across the stream."""
    sps_map: dict = {}                 # sps_id -> SpsFull
    pps_map: dict = {}                 # pps_id -> Pps
    slices = []
    for data in packets:
        sl = None
        for n in split_annexb(data):
            t = nal_type(n)
            try:
                if t == NAL_SPS:
                    s = parse_sps_full(n)
                    sps_map[s.sps_id] = s
                elif t == NAL_PPS:
                    p = parse_pps(n)
                    pps_map[p.pps_id] = p
                elif is_vcl(t) and sl is None and sps_map and pps_map:
                    sl = parse_slice_rps(n, sps_map, pps_map)
            except ValueError:
                # truncated/garbage NAL (file cut mid-GOP): skip it —
                # it produces no decodable picture either
                continue
        if sl is not None:
            slices.append(sl)
    return slices


_NAL_BLA = (16, 17, 18)                # BLA_W_LP, BLA_W_RADL, BLA_N_LP
_NAL_RASL_RADL = (6, 7, 8, 9)          # RADL_N/R, RASL_N/R


def derive_pocs(slices) -> list:
    """Full PicOrderCntVal per picture, decode order (8.3.1 — the
    HevcParserImpl.cpp POC derivation the slice-RPS subset lacked).

    MSB extension tracks prevTid0Pic (TemporalId 0, not RASL/RADL/
    sub-layer-non-ref); IDR resets to 0, BLA and stream-initial CRA
    reset the MSB.  Sorting decode-order pictures by the returned POC
    yields display order across open-GOP boundaries.
    """
    pocs = []
    prev_tid0_poc = 0
    first = True
    for sl in slices:
        max_lsb = 1 << sl.log2_max_poc_lsb
        t = sl.nal_type_
        if sl.is_idr:
            poc = 0
        elif t in _NAL_BLA or (t == NAL_CRA and first):
            poc = sl.poc_lsb           # NoRaslOutputFlag: msb = 0
        else:
            prev_lsb = prev_tid0_poc % max_lsb
            prev_msb = prev_tid0_poc - prev_lsb
            if (sl.poc_lsb < prev_lsb
                    and prev_lsb - sl.poc_lsb >= max_lsb // 2):
                msb = prev_msb + max_lsb
            elif (sl.poc_lsb > prev_lsb
                    and sl.poc_lsb - prev_lsb > max_lsb // 2):
                msb = prev_msb - max_lsb
            else:
                msb = prev_msb
            poc = msb + sl.poc_lsb
        pocs.append(poc)
        if (sl.temporal_id == 0 and t not in _NAL_RASL_RADL
                and not is_sublayer_nonref(t)):
            prev_tid0_poc = poc
        first = False
    return pocs


def compute_pocs(packets) -> list:
    """Annexb packets -> full POC per picture, decode order."""
    return derive_pocs(parse_stream_slices(packets))


def analyze_skippable(packets, slices=None) -> list:
    """AppHevcParse's analysis over annexb HEVC packets.

    Returns [(poc_lsb, skippable_bool), ...] in decode order: packet i is
    skippable when packet i+1's reference picture set does not contain
    packet i's POC (AppHevcParse.cpp:186-196).  The last frame is never
    marked skippable (nothing follows to prove it unused).

    slices: pre-parsed parse_stream_slices(packets) result, so callers
    that already hold it (scan.py derives POCs too) skip the second
    full-bitstream parse.
    """
    if slices is None:
        slices = parse_stream_slices(packets)
    out = []
    for i, sl in enumerate(slices):
        if i + 1 < len(slices):
            # an IDR successor has an empty RPS, so the predecessor is
            # skippable — exactly the reference's GetRefPicSet(...)
            # .find() == end() behavior at closed-GOP boundaries
            nxt = slices[i + 1]
            skippable = sl.poc_lsb not in nxt.ref_pocs
        else:
            skippable = False
        out.append((sl.poc_lsb, skippable))
    return out


# ------------------------------------------------------------------ SEI
# D.2/D.3 supplemental enhancement information (the reference parser's
# Hevc.h SEI structs; HevcParserImpl.cpp SEI sections): HDR static
# metadata, recovery points, and — with the SPS VUI/HRD context parsed
# above — pic_timing and buffering_period.

NAL_SEI_PREFIX, NAL_SEI_SUFFIX = 39, 40

SEI_BUFFERING_PERIOD = 0
SEI_PIC_TIMING = 1
SEI_RECOVERY_POINT = 6
SEI_MASTERING_DISPLAY = 137
SEI_CONTENT_LIGHT_LEVEL = 144

# Table D-1 pic_struct interpretation
PIC_STRUCT_NAMES = (
    "frame", "top", "bottom", "top_bottom", "bottom_top",
    "top_bottom_top", "bottom_top_bottom", "frame_doubling",
    "frame_tripling", "top_paired_prev_bottom", "bottom_paired_prev_top",
    "top_paired_next_bottom", "bottom_paired_next_top")


@dataclasses.dataclass
class SeiMessage:
    payload_type: int
    payload: bytes          # raw payload bytes (emulation removed)


def parse_sei(nal: bytes) -> List[SeiMessage]:
    """One SEI NAL -> its messages (ff-escaped type/size coding)."""
    d = BitReader(nal).data          # RBSP (emulation bytes stripped)
    out: List[SeiMessage] = []
    i = 0
    while i < len(d):
        # rbsp trailing: a 0x80 stop-bit byte with nothing but zero
        # padding after it.  0x80 is ALSO SEI payload type 128
        # (structure_of_pictures_info), so only the true tail stops
        if d[i] == 0x80 and not any(d[i + 1:]):
            break
        pt = 0
        while i < len(d) and d[i] == 0xFF:
            pt += 255
            i += 1
        if i >= len(d):
            break
        pt += d[i]
        i += 1
        sz = 0
        while i < len(d) and d[i] == 0xFF:
            sz += 255
            i += 1
        if i >= len(d):
            break
        sz += d[i]
        i += 1
        if i + sz > len(d):
            break                    # truncated message: keep what parsed
        out.append(SeiMessage(pt, d[i:i + sz]))
        i += sz
    return out


@dataclasses.dataclass
class MasteringDisplay:
    """D.3.28 mastering display colour volume (HDR10 static metadata).
    Primaries are GBR-ordered (x, y) in 0.00002 units; luminance in
    0.0001 cd/m^2 units — the `nits` properties convert."""
    primaries: Tuple[Tuple[int, int], ...]   # ((gx,gy),(bx,by),(rx,ry))
    white_point: Tuple[int, int]
    max_luminance: int
    min_luminance: int

    @property
    def max_nits(self) -> float:
        return self.max_luminance / 10000.0

    @property
    def min_nits(self) -> float:
        return self.min_luminance / 10000.0


def parse_mastering_display(payload: bytes) -> MasteringDisplay:
    if len(payload) < 24:
        raise ValueError(f"mastering-display SEI needs 24 bytes, got "
                         f"{len(payload)}")
    import struct as _s
    vals = _s.unpack(">6H2H2I", payload[:24])
    return MasteringDisplay(
        primaries=((vals[0], vals[1]), (vals[2], vals[3]),
                   (vals[4], vals[5])),
        white_point=(vals[6], vals[7]),
        max_luminance=vals[8], min_luminance=vals[9])


@dataclasses.dataclass
class ContentLightLevel:
    """D.3.35 content light level info: MaxCLL / MaxFALL in cd/m^2."""
    max_cll: int
    max_fall: int


def parse_content_light_level(payload: bytes) -> ContentLightLevel:
    if len(payload) < 4:
        raise ValueError("content-light-level SEI needs 4 bytes")
    return ContentLightLevel((payload[0] << 8) | payload[1],
                             (payload[2] << 8) | payload[3])


@dataclasses.dataclass
class RecoveryPoint:
    """D.3.8: gradual-refresh entry point for mid-stream tune-in."""
    recovery_poc_cnt: int
    exact_match: bool
    broken_link: bool


def parse_recovery_point(payload: bytes) -> RecoveryPoint:
    # payload bytes are already RBSP (emulation removed by parse_sei):
    # read bits raw — BitReader would re-strip 00 00 03 sequences
    pos = 0

    def u(n):
        nonlocal pos
        v = 0
        for _ in range(n):
            if pos >> 3 >= len(payload):
                raise ValueError("truncated recovery-point SEI")
            v = (v << 1) | ((payload[pos >> 3] >> (7 - (pos & 7))) & 1)
            pos += 1
        return v

    def se():
        zeros = 0
        while u(1) == 0:
            zeros += 1
            if zeros > 31:
                raise ValueError("bad exp-golomb")
        k = (1 << zeros) - 1 + (u(zeros) if zeros else 0)
        return (k + 1) // 2 if k % 2 else -(k // 2)

    return RecoveryPoint(se(), bool(u(1)), bool(u(1)))


class _RawBits:
    """Bit reader over an already-RBSP payload (parse_sei strips
    emulation bytes; BitReader would re-strip 00 00 03 sequences)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def u(self, n: int) -> int:
        if self.pos + n > len(self.data) * 8:
            raise ValueError("truncated SEI payload")
        v = 0
        for _ in range(n):
            v = (v << 1) | ((self.data[self.pos >> 3]
                             >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 31:
                raise ValueError("bad exp-golomb in SEI")
        return (1 << zeros) - 1 + (self.u(zeros) if zeros else 0)


@dataclasses.dataclass
class PicTiming:
    """D.2.3 pic_timing — pic_struct / scan type + the CPB/DPB delays
    (HevcParserImpl.cpp:203-205 processes these with HRD context)."""
    pic_struct: Optional[int] = None            # Table D-1
    source_scan_type: Optional[int] = None      # 0 interlaced 1 progressive
    duplicate_flag: Optional[bool] = None
    au_cpb_removal_delay: Optional[int] = None  # *_minus1 + 1
    pic_dpb_output_delay: Optional[int] = None
    pic_dpb_output_du_delay: Optional[int] = None

    @property
    def pic_struct_name(self) -> Optional[str]:
        if self.pic_struct is None:
            return None
        if 0 <= self.pic_struct < len(PIC_STRUCT_NAMES):
            return PIC_STRUCT_NAMES[self.pic_struct]
        return f"reserved({self.pic_struct})"


def parse_pic_timing(payload: bytes, vui: "Vui") -> PicTiming:
    """pic_timing SEI needs the active SPS's VUI for field widths and
    presence flags (why the reference parser keeps HRD context around,
    Hevc.h:110)."""
    r = _RawBits(payload)
    pt = PicTiming()
    if vui.frame_field_info_present:
        pt.pic_struct = r.u(4)
        pt.source_scan_type = r.u(2)
        pt.duplicate_flag = bool(r.u(1))
    hrd = vui.hrd
    if hrd is not None and hrd.cpb_dpb_delays_present:
        pt.au_cpb_removal_delay = r.u(hrd.au_cpb_removal_delay_len) + 1
        pt.pic_dpb_output_delay = r.u(hrd.dpb_output_delay_len)
        if hrd.sub_pic_hrd:
            pt.pic_dpb_output_du_delay = r.u(hrd.dpb_output_delay_du_len)
        # du_common / num_decoding_units fields follow when
        # sub_pic_cpb_in_pic_timing — nothing downstream reads them
    return pt


@dataclasses.dataclass
class BufferingPeriod:
    """D.2.2 buffering_period — initial CPB removal delays (layer 0)."""
    sps_id: int = 0
    irap_cpb_params_present: bool = False
    cpb_delay_offset: int = 0
    dpb_delay_offset: int = 0
    concatenation: bool = False
    au_cpb_removal_delay_delta: int = 1         # *_minus1 + 1
    initial_cpb_removal_delay: tuple = ()       # nal then vcl, per CPB
    initial_cpb_removal_offset: tuple = ()


def parse_buffering_period(payload: bytes, vui: "Vui") -> BufferingPeriod:
    r = _RawBits(payload)
    bp = BufferingPeriod()
    bp.sps_id = r.ue()
    hrd = vui.hrd
    if hrd is None:
        return bp
    if not hrd.sub_pic_hrd:
        bp.irap_cpb_params_present = bool(r.u(1))
    if bp.irap_cpb_params_present:
        bp.cpb_delay_offset = r.u(hrd.au_cpb_removal_delay_len)
        bp.dpb_delay_offset = r.u(hrd.dpb_output_delay_len)
    bp.concatenation = bool(r.u(1))
    bp.au_cpb_removal_delay_delta = r.u(hrd.au_cpb_removal_delay_len) + 1
    delays, offsets = [], []
    cpb = hrd.cpb_cnt[0] if hrd.cpb_cnt else 1
    for present in (hrd.nal_hrd, hrd.vcl_hrd):
        if not present:
            continue
        for _ in range(cpb):
            delays.append(r.u(hrd.initial_cpb_removal_delay_len))
            offsets.append(r.u(hrd.initial_cpb_removal_delay_len))
            # D.2.2: the alt delay/offset pair is present when
            # sub_pic_hrd OR irap_cpb_params_present (IRAP-aligned HRD)
            if hrd.sub_pic_hrd or bp.irap_cpb_params_present:
                r.u(2 * hrd.initial_cpb_removal_delay_len)
    bp.initial_cpb_removal_delay = tuple(delays)
    bp.initial_cpb_removal_offset = tuple(offsets)
    return bp


def iter_nals(packets, nals=None):
    """Flatten annexb packets to NAL payloads; pass a pre-split `nals`
    list to share one split across the stream_* census walkers."""
    if nals is not None:
        return nals
    return (nal for pkt in packets for nal in split_annexb(pkt))


def stream_timing_info(packets, nals=None) -> dict:
    """Annexb packets -> pic_timing/buffering_period census: HRD summary
    from the first SPS VUI, per-AU pic_struct + CPB/DPB delays (the
    pic_timing lane of the reference parser, HevcParserImpl.cpp:203-205)."""
    out: dict = {"pic_timings": [], "buffering_periods": []}
    vui = None
    for nal in iter_nals(packets, nals):
            t = nal_type(nal)
            if t == NAL_SPS and vui is None:
                try:
                    vui = parse_sps_full(nal).vui
                except ValueError:
                    continue
                if vui is not None:
                    out["vui"] = vui
            elif t in (NAL_SEI_PREFIX, NAL_SEI_SUFFIX) and vui is not None:
                for m in parse_sei(nal):
                    try:
                        if m.payload_type == SEI_PIC_TIMING:
                            out["pic_timings"].append(
                                parse_pic_timing(m.payload, vui))
                        elif m.payload_type == SEI_BUFFERING_PERIOD:
                            out["buffering_periods"].append(
                                parse_buffering_period(m.payload, vui))
                    except ValueError:
                        continue         # malformed message: skip it
    return out


def stream_hdr_metadata(packets, nals=None) -> dict:
    """Annexb packets -> {'mastering_display': MasteringDisplay,
    'content_light_level': ContentLightLevel, 'recovery_points': int}
    for whatever static HDR metadata the stream carries (first
    occurrence wins, like players apply it)."""
    out: dict = {"recovery_points": 0}
    for nal in iter_nals(packets, nals):
            if nal_type(nal) not in (NAL_SEI_PREFIX, NAL_SEI_SUFFIX):
                continue
            for m in parse_sei(nal):
                try:
                    if (m.payload_type == SEI_MASTERING_DISPLAY
                            and "mastering_display" not in out):
                        out["mastering_display"] = \
                            parse_mastering_display(m.payload)
                    elif (m.payload_type == SEI_CONTENT_LIGHT_LEVEL
                            and "content_light_level" not in out):
                        out["content_light_level"] = \
                            parse_content_light_level(m.payload)
                    elif m.payload_type == SEI_RECOVERY_POINT:
                        out["recovery_points"] += 1
                except ValueError:
                    continue             # malformed message: skip it
    return out
