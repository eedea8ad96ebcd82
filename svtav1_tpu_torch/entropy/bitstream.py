"""OBU assembly: uncompressed headers + bitstream packaging (AV1 spec 5.x).

Covers the round-1 profile: profile 0, 8-bit 4:2:0, single tile, key frames,
loop filter / CDEF / restoration disabled, TX_MODE_LARGEST.
Behavioral reference: Source/Lib/Codec/packetization_process.c:784
(svt_aom_encode_sps_av1) and entropy_coding.c:3768
(svt_aom_write_frame_header_av1).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..constants.av1 import ObuType


class BitWriter:
    """MSB-first bit writer for uncompressed OBU headers (spec f(n))."""

    def __init__(self) -> None:
        self.bits: list[int] = []

    def f(self, value: int, n: int) -> "BitWriter":
        assert 0 <= value < (1 << n), (value, n)
        for i in range(n - 1, -1, -1):
            self.bits.append((value >> i) & 1)
        return self

    def trailing_bits(self) -> "BitWriter":
        """trailing_bits(): a 1 then 0s to a byte boundary (spec 5.3.4)."""
        self.bits.append(1)
        while len(self.bits) % 8:
            self.bits.append(0)
        return self

    def byte_alignment(self) -> "BitWriter":
        while len(self.bits) % 8:
            self.bits.append(0)
        return self

    def bytes(self) -> bytes:
        assert len(self.bits) % 8 == 0, "unaligned header"
        out = bytearray()
        for i in range(0, len(self.bits), 8):
            b = 0
            for j in range(8):
                b = (b << 1) | self.bits[i + j]
            out.append(b)
        return bytes(out)


class BitReader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def f(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def byte_alignment(self) -> None:
        self.pos = (self.pos + 7) & ~7


def leb128(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def read_leb128(data: bytes, pos: int) -> tuple[int, int]:
    v = 0
    for i in range(8):
        b = data[pos + i]
        v |= (b & 0x7F) << (7 * i)
        if not (b & 0x80):
            return v, pos + i + 1
    raise ValueError("leb128 too long")


def tu_frame_type(tu: bytes) -> int | None:
    """frame_type of the TU's frame OBU (0 key, 1 inter), read from its
    uncompressed header (show_existing_frame f(1), then frame_type f(2));
    None when the TU holds no frame OBU."""
    pos = 0
    while pos < len(tu):
        obu_type = (tu[pos] >> 3) & 0xF
        size, pos = read_leb128(tu, pos + 1)
        if obu_type == int(ObuType.OBU_FRAME):
            return (tu[pos] >> 5) & 3
        pos += size
    return None


def obu(obu_type: int, payload: bytes) -> bytes:
    """Wrap payload: obu_header (has_size_field=1) + leb128 size + payload."""
    header = BitWriter()
    header.f(0, 1)  # obu_forbidden_bit
    header.f(int(obu_type), 4)
    header.f(0, 1)  # obu_extension_flag
    header.f(1, 1)  # obu_has_size_field
    header.f(0, 1)  # obu_reserved_1bit
    return header.bytes() + leb128(len(payload)) + payload


@dataclass
class SequenceConfig:
    width: int
    height: int
    bd: int = 8
    seq_level_idx: int = 8  # level 4.0
    enable_cdef: bool = False
    enable_restoration: bool = False
    enable_superres: bool = False
    enable_filter_intra: bool = False
    enable_intra_edge_filter: bool = False
    enable_order_hint: bool = True
    order_hint_bits: int = 7
    film_grain_params_present: bool = False


def sequence_header_obu(cfg: SequenceConfig) -> bytes:
    w = BitWriter()
    w.f(0, 3)  # seq_profile
    w.f(0, 1)  # still_picture
    w.f(0, 1)  # reduced_still_picture_header
    w.f(0, 1)  # timing_info_present_flag
    w.f(0, 1)  # initial_display_delay_present_flag
    w.f(0, 5)  # operating_points_cnt_minus_1
    w.f(0, 12)  # operating_point_idc[0]
    w.f(cfg.seq_level_idx, 5)
    if cfg.seq_level_idx > 7:
        w.f(0, 1)  # seq_tier[0]
    wbits = max((cfg.width - 1).bit_length(), 1)
    hbits = max((cfg.height - 1).bit_length(), 1)
    w.f(wbits - 1, 4)
    w.f(hbits - 1, 4)
    w.f(cfg.width - 1, wbits)
    w.f(cfg.height - 1, hbits)
    w.f(0, 1)  # frame_id_numbers_present_flag
    w.f(0, 1)  # use_128x128_superblock
    w.f(int(cfg.enable_filter_intra), 1)
    w.f(int(cfg.enable_intra_edge_filter), 1)
    w.f(0, 1)  # enable_interintra_compound
    w.f(0, 1)  # enable_masked_compound
    w.f(0, 1)  # enable_warped_motion
    w.f(0, 1)  # enable_dual_filter
    w.f(int(cfg.enable_order_hint), 1)
    if cfg.enable_order_hint:
        w.f(0, 1)  # enable_jnt_comp
        w.f(0, 1)  # enable_ref_frame_mvs
    w.f(0, 1)  # seq_choose_screen_content_tools
    w.f(0, 1)  # seq_force_screen_content_tools = 0
    if cfg.enable_order_hint:
        w.f(cfg.order_hint_bits - 1, 3)
    w.f(int(cfg.enable_superres), 1)
    w.f(int(cfg.enable_cdef), 1)
    w.f(int(cfg.enable_restoration), 1)
    # color_config
    w.f(int(cfg.bd > 8), 1)  # high_bitdepth
    w.f(0, 1)  # mono_chrome
    w.f(0, 1)  # color_description_present_flag
    w.f(0, 1)  # color_range
    w.f(0, 2)  # chroma_sample_position (4:2:0 implied by profile 0)
    w.f(0, 1)  # separate_uv_delta_q
    w.f(int(cfg.film_grain_params_present), 1)
    w.trailing_bits()
    return obu(ObuType.OBU_SEQUENCE_HEADER, w.bytes())


@dataclass
class FrameConfig:
    qindex: int
    disable_cdf_update: bool = False
    show_frame: bool = True
    error_resilient: bool = False
    tile_cols_log2: int = 0
    tile_rows_log2: int = 0
    # inter-frame fields (spec uncompressed_header)
    frame_type: int = 0  # KEY_FRAME
    order_hint: int = 0
    refresh_frame_flags: int = 0xFF
    ref_frame_idx: tuple = (0,) * 7  # DPB slot per LAST..ALTREF
    # CDF lifecycle: which ref's saved frame context seeds this frame's CDFs
    # (7 = PRIMARY_REF_NONE -> defaults), and whether the end-of-frame
    # adapted CDFs become the stored context for refreshed slots
    # (disable_frame_end_update_cdf inverted; spec 5.9.2 / 6.8.2)
    primary_ref_frame: int = 7
    frame_end_update_cdf: bool = False
    interp_filter: int = 0  # REGULAR (non-switchable)
    # global motion (TRANSLATION subset, codec/gm.py): per-ref-id (row8,
    # col8); prev_gm_mvs = the primary ref's saved params (PrevGmParams)
    gm_mvs: tuple | None = None
    prev_gm_mvs: tuple | None = None
    lf_levels: tuple = (0, 0, 0, 0)
    lf_sharpness: int = 0
    # CDEF (coded only when seq enable_cdef): one strength set (cdef_bits=0)
    cdef_damping: int = 3
    cdef_y: tuple = ((0, 0),)  # (pri, sec) pairs; len == 1 << cdef_bits
    cdef_uv: tuple = ((0, 0),)
    # loop restoration (coded when seq enable_restoration): internal
    # RESTORE_* per plane + unit-size shifts (spec 5.9.20 lr_params)
    lr_types: tuple = (0, 0, 0)
    lr_unit_shift: int = 0
    lr_uv_shift: int = 1
    # compound prediction availability (spec reference_select)
    reference_select: int = 0
    skip_mode_allowed: bool = False  # derive via skip_mode_allowed()
    # film grain (coded when seq film_grain_params_present; spec 5.9.30)
    film_grain: object = None  # filters.film_grain.FilmGrainParams | None


def get_relative_dist(a: int, b: int, order_hint_bits: int) -> int:
    """spec get_relative_dist: signed wraparound order-hint difference."""
    diff = a - b
    m = 1 << (order_hint_bits - 1)
    return (diff & (m - 1)) - (diff & m)


def skip_mode_allowed(order_hint: int, order_hint_bits: int, ref_hints) -> bool:
    """spec 5.9.22 skip_mode_params derivation (without the frame pair):
    ref_hints = 7 order hints per LAST..ALTREF ref position. True when a
    nearest fwd/bwd pair (or two distinct forward refs) exists."""
    fwd_i = bwd_i = -1
    fwd_h = bwd_h = 0
    for i in range(7):
        h = ref_hints[i]
        d = get_relative_dist(h, order_hint, order_hint_bits)
        if d < 0:
            if fwd_i < 0 or get_relative_dist(h, fwd_h, order_hint_bits) > 0:
                fwd_i, fwd_h = i, h
        elif d > 0:
            if bwd_i < 0 or get_relative_dist(h, bwd_h, order_hint_bits) < 0:
                bwd_i, bwd_h = i, h
    if fwd_i < 0:
        return False
    if bwd_i >= 0:
        return True
    sec_i, sec_h = -1, 0
    for i in range(7):
        h = ref_hints[i]
        if get_relative_dist(h, fwd_h, order_hint_bits) < 0:
            if sec_i < 0 or get_relative_dist(h, sec_h, order_hint_bits) > 0:
                sec_i, sec_h = i, h
    return sec_i >= 0


def frame_header_bits(seq: SequenceConfig, fr: FrameConfig) -> BitWriter:
    """Uncompressed frame header for KEY and (single-ref profile) INTER
    frames (not byte-aligned; caller decides trailing_bits for
    OBU_FRAME_HEADER vs byte_alignment for OBU_FRAME)."""
    w = BitWriter()
    is_intra = fr.frame_type in (0, 2)
    w.f(0, 1)  # show_existing_frame
    w.f(fr.frame_type, 2)
    w.f(int(fr.show_frame), 1)
    if not fr.show_frame:
        w.f(1, 1)  # showable_frame
    if not (fr.frame_type == 3 or (fr.frame_type == 0 and fr.show_frame)):
        w.f(int(fr.error_resilient), 1)
    # (shown KEY frames: error_resilient_mode implied 1, no bit)
    w.f(int(fr.disable_cdf_update), 1)
    # allow_screen_content_tools = 0 (seq_force_screen_content_tools == 0)
    w.f(0, 1)  # frame_size_override_flag
    if seq.enable_order_hint:
        w.f(fr.order_hint & ((1 << seq.order_hint_bits) - 1), seq.order_hint_bits)
    if not is_intra and not fr.error_resilient:
        w.f(fr.primary_ref_frame, 3)  # 7 = PRIMARY_REF_NONE (fresh CDFs)
    if not (fr.frame_type == 0 and fr.show_frame):
        w.f(fr.refresh_frame_flags, 8)
    if is_intra:
        # frame_size(): override=0 -> max dims; superres disabled -> no bits
        w.f(0, 1)  # render_and_frame_size_different
        # allow_intrabc: requires allow_screen_content_tools -> absent
    else:
        if seq.enable_order_hint:
            w.f(0, 1)  # frame_refs_short_signaling
        for i in range(7):
            w.f(fr.ref_frame_idx[i], 3)
        w.f(0, 1)  # render_and_frame_size_different (frame_size + render_size)
        w.f(0, 1)  # allow_high_precision_mv
        w.f(0, 1)  # is_filter_switchable
        w.f(fr.interp_filter, 2)
        w.f(0, 1)  # is_motion_mode_switchable
        # use_ref_frame_mvs: absent (seq enable_ref_frame_mvs = 0)
    if not fr.disable_cdf_update:
        w.f(0 if fr.frame_end_update_cdf else 1, 1)  # disable_frame_end_update_cdf
    # tile_info() — uniform spacing; min log2 == 0 up to 4096-wide frames.
    # Increment bits exist only while below the max (spec tile_info): no
    # stop bit when the frame has a single SB column/row or log2 == max.
    import math

    sb_cols = (seq.width + 63) // 64
    sb_rows = (seq.height + 63) // 64
    max_tcl = int(math.ceil(math.log2(sb_cols))) if sb_cols > 1 else 0
    max_trl = int(math.ceil(math.log2(sb_rows))) if sb_rows > 1 else 0
    w.f(1, 1)  # uniform_tile_spacing_flag
    for _ in range(fr.tile_cols_log2):
        w.f(1, 1)
    if fr.tile_cols_log2 < max_tcl:
        w.f(0, 1)  # increment_tile_cols_log2 stop
    for _ in range(fr.tile_rows_log2):
        w.f(1, 1)
    if fr.tile_rows_log2 < max_trl:
        w.f(0, 1)  # increment_tile_rows_log2 stop
    if fr.tile_cols_log2 or fr.tile_rows_log2:
        w.f(0, fr.tile_cols_log2 + fr.tile_rows_log2)  # context_update_tile_id
        w.f(3, 2)  # tile_size_bytes_minus_1 -> 4-byte LE tile sizes
    # quantization_params()
    w.f(fr.qindex, 8)  # base_q_idx
    w.f(0, 1)  # delta_q_y_dc coded flag
    w.f(0, 1)  # delta_q_u_dc
    w.f(0, 1)  # delta_q_u_ac
    w.f(0, 1)  # using_qmatrix
    w.f(0, 1)  # segmentation_enabled
    if fr.qindex > 0:
        w.f(0, 1)  # delta_q_present
    # loop_filter_params (CodedLossless false)
    w.f(fr.lf_levels[0], 6)  # loop_filter_level[0]
    w.f(fr.lf_levels[1], 6)  # loop_filter_level[1]
    if fr.lf_levels[0] or fr.lf_levels[1]:
        w.f(fr.lf_levels[2], 6)  # loop_filter_level_u
        w.f(fr.lf_levels[3], 6)  # loop_filter_level_v
    w.f(fr.lf_sharpness, 3)  # loop_filter_sharpness
    w.f(0, 1)  # loop_filter_delta_enabled
    if seq.enable_cdef:
        # cdef_params (spec 5.9.19); cdef_bits = log2(len(strength sets))
        cdef_bits = max(len(fr.cdef_y) - 1, 0).bit_length()
        w.f(fr.cdef_damping - 3, 2)
        w.f(cdef_bits, 2)
        for (ypri, ysec), (upri, usec) in zip(fr.cdef_y, fr.cdef_uv):
            # sec strength 3 is uncodable (decoder maps coded 3 -> 4, spec
            # 5.9.19 cdef_sec_damping); 4 codes as 3. Reject 3 outright.
            assert ysec != 3 and usec != 3, "cdef sec strength 3 is not codable"
            w.f(ypri, 4)
            w.f(3 if ysec == 4 else ysec, 2)
            w.f(upri, 4)
            w.f(3 if usec == 4 else usec, 2)
    if seq.enable_restoration:
        # lr_params (spec 5.9.20): coded lr_type per plane via Remap_Lr_Type
        # inverse (internal NONE/WIENER/SGR/SWITCHABLE -> coded 0/2/3/1)
        coded_of = {0: 0, 1: 2, 2: 3, 3: 1}
        uses_lr = any(fr.lr_types)
        uses_chroma_lr = any(fr.lr_types[1:])
        for plane in range(3):
            w.f(coded_of[fr.lr_types[plane]], 2)
        if uses_lr:
            w.f(int(fr.lr_unit_shift > 0), 1)  # (64x64 SB sequence)
            if fr.lr_unit_shift:
                w.f(fr.lr_unit_shift - 1, 1)
            if uses_chroma_lr:  # 4:2:0: subsampling x & y
                w.f(fr.lr_uv_shift, 1)
    w.f(0, 1)  # tx_mode_select = 0 -> TX_MODE_LARGEST
    if not is_intra:
        w.f(int(fr.reference_select), 1)  # reference_select
        # skip_mode_params: skipModeAllowed requires enable_skip_mode
        # (seq enable_order_hint path) AND reference_select with a valid
        # fwd/bwd pair -> our seq codes enable_skip_mode below; when
        # reference_select the decoder derives skipModeAllowed from ref
        # order hints. We keep skip_mode_present = 0 when allowed.
        if fr.reference_select and fr.skip_mode_allowed:
            w.f(0, 1)  # skip_mode_present = 0
        # allow_warped_motion: absent (seq enable_warped_motion = 0)
    w.f(0, 1)  # reduced_tx_set
    if not is_intra:
        from ..codec.gm import write_global_motion_params

        # allow_high_precision_mv is coded 0 above -> low-precision params
        write_global_motion_params(w, fr.gm_mvs, fr.prev_gm_mvs, allow_hp=False)
    if seq.film_grain_params_present:
        # show_frame or showable_frame always holds for our streams (hidden
        # frames are coded showable); spec 5.9.30 film_grain_params
        from ..filters.film_grain import FilmGrainParams, write_params

        write_params(w, fr.film_grain or FilmGrainParams(apply_grain=0),
                     is_inter=not is_intra)
    return w


def frame_obu(seq: SequenceConfig, fr: FrameConfig, tile_payloads) -> bytes:
    """OBU_FRAME = frame_header + byte_alignment + tile_group.

    tile_payloads: bytes (single tile) or list of per-tile bytes in raster
    tile order (all but the last prefixed with a 4-byte LE size)."""
    if isinstance(tile_payloads, (bytes, bytearray)):
        tile_payloads = [tile_payloads]
    w = frame_header_bits(seq, fr)
    ntiles = len(tile_payloads)
    # spec 5.10.1 frame_obu: frame_header_obu, byte_alignment, THEN
    # tile_group_obu — whose tile_start_and_end_present_flag (must be 0 for
    # OBU_FRAME) is followed by its own byte_alignment (5.11.1)
    w.byte_alignment()
    if ntiles > 1:
        w.f(0, 1)  # tile_start_and_end_present_flag (OBU_FRAME: full group)
        w.byte_alignment()
    body = bytearray(w.bytes())
    for i, tp in enumerate(tile_payloads):
        if i < ntiles - 1:
            body += int(len(tp) - 1).to_bytes(4, "little")  # tile_size_minus_1
        body += tp
    return obu(ObuType.OBU_FRAME, bytes(body))


def show_existing_frame_obu(map_idx: int) -> bytes:
    """Frame header OBU that displays an already-decoded DPB frame
    (spec 5.9.2 show_existing_frame; non-key frames: header ends there)."""
    w = BitWriter()
    w.f(1, 1)  # show_existing_frame
    w.f(map_idx, 3)  # frame_to_show_map_idx
    w.trailing_bits()
    return obu(ObuType.OBU_FRAME_HEADER, w.bytes())


def temporal_delimiter_obu() -> bytes:
    return obu(ObuType.OBU_TEMPORAL_DELIMITER, b"")


# ------------------------------------------------------------ metadata OBUs
# spec 5.8.1 metadata_obu; reference Source/Lib/Globals/metadata_handle.c
# (CLL / mastering display / ITU-T T.35 attached to key-frame TUs)

METADATA_ITUT_T35 = 4
METADATA_HDR_CLL = 1
METADATA_HDR_MDCV = 2


def metadata_obu(metadata_type: int, payload: bytes) -> bytes:
    """OBU_METADATA: leb128 metadata_type + type payload + trailing bits."""
    return obu(ObuType.OBU_METADATA, leb128(metadata_type) + payload + b"\x80")


def content_light_obu(max_cll: int, max_fall: int) -> bytes:
    """HDR CLL (spec 6.7.3 metadata_hdr_cll): two 16-bit values."""
    w = BitWriter()
    w.f(max_cll, 16)
    w.f(max_fall, 16)
    return metadata_obu(METADATA_HDR_CLL, w.bytes())


def mastering_display_obu(primaries, white_point, max_luminance: float,
                          min_luminance: float) -> bytes:
    """HDR MDCV (spec 6.7.4): primaries/white point in 0.16 fixed chromaticity,
    luminance in 24.8 / 18.14 fixed (values given in cd/m^2).

    primaries: ((rx, ry), (gx, gy), (bx, by)) CIE chromaticities in [0, 1]."""
    w = BitWriter()
    for (x, y) in primaries:
        w.f(int(round(x * 65536)) & 0xFFFF, 16)
        w.f(int(round(y * 65536)) & 0xFFFF, 16)
    w.f(int(round(white_point[0] * 65536)) & 0xFFFF, 16)
    w.f(int(round(white_point[1] * 65536)) & 0xFFFF, 16)
    w.f(int(round(max_luminance * 256)) & 0xFFFFFFFF, 32)
    w.f(int(round(min_luminance * 16384)) & 0xFFFFFFFF, 32)
    return metadata_obu(METADATA_HDR_MDCV, w.bytes())


def itut_t35_obu(country_code: int, payload: bytes) -> bytes:
    """ITU-T T.35 user data (spec 6.7.2)."""
    w = BitWriter()
    w.f(country_code, 8)
    return metadata_obu(METADATA_ITUT_T35, w.bytes() + payload)
