"""Conformance-oracle decoder for the streams this encoder emits.

Full spec-order parse of the OBU layer, sequence header, key/inter frame
headers, DPB maintenance, then TileCodec.decode for the tile payload.
Mirrors the reference's e2e test strategy (test/e2e_test/RefDecoder + recon
compare): every encoded stream must decode here with recon bit-identical to
the encoder's own recon.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..codec.tile_codec import FrameParams, TileCodec
from ..constants.av1 import ObuType
from ..constants.cdf import FrameContext
from ..entropy.bitstream import BitReader, read_leb128


@dataclass
class SeqInfo:
    width: int
    height: int
    bd: int
    enable_order_hint: bool = False
    order_hint_bits: int = 7
    enable_cdef: bool = False
    enable_filter_intra: bool = False
    enable_restoration: bool = False
    enable_ref_frame_mvs: bool = False  # parsed; use must be off per frame
    enable_intra_edge_filter: bool = False
    seq_force_screen_content_tools: int = 0  # 0/1 fixed, 2 = per-frame bit
    seq_force_integer_mv: int = 2
    enable_superres: bool = False
    film_grain_params_present: bool = False


def _expect(r, nbits: int, want: int, what: str) -> None:
    """Read a field the port's streams always code as `want` and check it
    with an explicit raise: under python -O an assert, and a read inside
    it, would vanish and the reader would lose its place."""
    got = r.f(nbits)
    if got != want:
        raise ValueError(f"unsupported stream: {what} = {got}")

def parse_sequence_header(payload: bytes) -> SeqInfo:
    r = BitReader(payload)
    _expect(r, 3, 0, "profile 0 only")
    r.f(1)  # still_picture
    _expect(r, 1, 0, "reduced_still_picture_header unsupported")
    _expect(r, 1, 0, "timing_info")
    r.f(1)  # initial_display_delay
    _expect(r, 5, 0, "operating points cnt")
    r.f(12)
    lvl = r.f(5)
    if lvl > 7:
        r.f(1)
    wbits = r.f(4) + 1
    hbits = r.f(4) + 1
    w = r.f(wbits) + 1
    h = r.f(hbits) + 1
    _expect(r, 1, 0, "frame_id_numbers")
    _expect(r, 1, 0, "use_128x128_superblock")
    enable_filter_intra = bool(r.f(1))
    enable_intra_edge_filter = bool(r.f(1))
    r.f(4)  # interintra, masked, warped, dual_filter
    enable_order_hint = bool(r.f(1))
    order_hint_bits = 7
    enable_ref_frame_mvs = False
    if enable_order_hint:
        r.f(1)  # enable_jnt_comp (frame header must still pick single-ref)
        enable_ref_frame_mvs = bool(r.f(1))
    if r.f(1):  # seq_choose_screen_content_tools
        seq_force_sct = 2  # SELECT_SCREEN_CONTENT_TOOLS (per-frame bit)
    else:
        seq_force_sct = r.f(1)
    seq_force_imv = 2  # SELECT_INTEGER_MV
    if seq_force_sct > 0:
        if r.f(1) == 0:  # seq_choose_integer_mv
            seq_force_imv = r.f(1)
    if enable_order_hint:
        order_hint_bits = r.f(3) + 1
    enable_superres = bool(r.f(1))
    enable_cdef = bool(r.f(1))
    enable_restoration = bool(r.f(1))
    high_bd = r.f(1)
    _expect(r, 1, 0, "mono_chrome")
    _expect(r, 1, 0, "color_description_present")
    r.f(1)  # color_range
    r.f(2)  # chroma_sample_position
    _expect(r, 1, 0, "separate_uv_delta_q")
    film_grain_present = bool(r.f(1))
    return SeqInfo(width=w, height=h, bd=10 if high_bd else 8,
                   film_grain_params_present=film_grain_present,
                   enable_order_hint=enable_order_hint, order_hint_bits=order_hint_bits,
                   enable_cdef=enable_cdef, enable_filter_intra=enable_filter_intra,
                   enable_restoration=enable_restoration,
                   enable_ref_frame_mvs=enable_ref_frame_mvs,
                   enable_intra_edge_filter=enable_intra_edge_filter,
                   seq_force_screen_content_tools=seq_force_sct,
                   seq_force_integer_mv=seq_force_imv,
                   enable_superres=enable_superres)


@dataclass
class FrameInfo:
    qindex: int
    disable_cdf_update: bool
    header_bytes: int  # size of frame header portion (byte aligned)
    tile_cols_log2: int = 0
    tile_rows_log2: int = 0
    frame_type: int = 0
    show_frame: bool = True
    order_hint: int = 0
    refresh_frame_flags: int = 0xFF
    ref_frame_idx: tuple = (0,) * 7
    interp_filter: int = 0
    lf_levels: tuple = (0, 0, 0, 0)
    lf_sharpness: int = 0
    cdef_damping: int = 3
    cdef_y: tuple = ((0, 0),)
    cdef_uv: tuple = ((0, 0),)
    primary_ref_frame: int = 7
    frame_end_update_cdf: bool = False
    lr_types: tuple = (0, 0, 0)
    lr_unit_shift: int = 0
    lr_uv_shift: int = 1
    tx_mode: int = 0
    reduced_tx_set: int = 0
    film_grain: object = None  # FilmGrainParams | None
    reference_select: int = 0
    gm_mvs: tuple = ((0, 0),) * 8  # TRANSLATION global MV per ref id


def parse_frame_header(payload: bytes, seq: SeqInfo, slot_hints=None,
                       slot_gms=None) -> FrameInfo:
    """slot_hints: per-DPB-slot order hints (None -> zeros), needed for the
    spec 5.9.22 skipModeAllowed derivation when reference_select is set.
    slot_gms: per-DPB-slot saved global motion lists (PrevGmParams source
    when primary_ref_frame != PRIMARY_REF_NONE; spec load_previous)."""
    r = BitReader(payload)
    _expect(r, 1, 0, "show_existing_frame")
    frame_type = r.f(2)
    assert frame_type in (0, 1), "KEY/INTER only"
    is_intra = frame_type == 0
    show_frame = r.f(1)
    if not show_frame:
        _expect(r, 1, 1, "showable_frame")
    if not (frame_type == 3 or (frame_type == 0 and show_frame)):
        _expect(r, 1, 0, "error_resilient_mode")
    disable_cdf_update = r.f(1)
    allow_sct = (r.f(1) if seq.seq_force_screen_content_tools == 2
                 else seq.seq_force_screen_content_tools)
    if allow_sct and seq.seq_force_integer_mv == 2:
        r.f(1)  # force_integer_mv (intra frames force it to 1 anyway)
    _expect(r, 1, 0, "frame_size_override")
    order_hint = r.f(seq.order_hint_bits) if seq.enable_order_hint else 0
    primary_ref = 7
    if not is_intra:
        primary_ref = r.f(3)  # 7 = PRIMARY_REF_NONE
    refresh = 0xFF
    if not (frame_type == 0 and show_frame):
        refresh = r.f(8)
    ref_frame_idx = (0,) * 7
    interp_filter = 0
    if is_intra:
        if seq.enable_superres:
            _expect(r, 1, 0, "use_superres: superres scaling unsupported")
        _expect(r, 1, 0, "render_and_frame_size_different")
        if allow_sct:
            _expect(r, 1, 0, "allow_intrabc: intrabc unsupported")
    else:
        if seq.enable_order_hint:
            _expect(r, 1, 0, "frame_refs_short_signaling")
        ref_frame_idx = tuple(r.f(3) for _ in range(7))
        _expect(r, 1, 0, "render_and_frame_size_different")
        _expect(r, 1, 0, "allow_high_precision_mv")
        _expect(r, 1, 0, "is_filter_switchable")
        interp_filter = r.f(2)
        _expect(r, 1, 0, "is_motion_mode_switchable")
        if seq.enable_ref_frame_mvs:
            _expect(r, 1, 0, "use_ref_frame_mvs: MFMV unsupported")
    frame_end_update_cdf = False
    if not disable_cdf_update:
        frame_end_update_cdf = r.f(1) == 0  # disable_frame_end_update_cdf
    _expect(r, 1, 1, "uniform_tile_spacing")
    sb_cols = (seq.width + 63) // 64
    sb_rows = (seq.height + 63) // 64
    max_tcl = max(int(np.ceil(np.log2(sb_cols))), 0) if sb_cols > 1 else 0
    max_trl = max(int(np.ceil(np.log2(sb_rows))), 0) if sb_rows > 1 else 0
    tcl = 0
    while tcl < max_tcl and r.f(1) == 1:
        tcl += 1
    trl = 0
    while trl < max_trl and r.f(1) == 1:
        trl += 1
    if tcl or trl:
        r.f(tcl + trl)  # context_update_tile_id
        tsb = r.f(2) + 1
        assert tsb == 4, tsb
    qindex = r.f(8)
    _expect(r, 1, 0, "delta_q_y_dc")
    _expect(r, 1, 0, "delta_q_u_dc")
    _expect(r, 1, 0, "delta_q_u_ac")
    _expect(r, 1, 0, "using_qmatrix")
    _expect(r, 1, 0, "segmentation_enabled")
    if qindex > 0:
        _expect(r, 1, 0, "delta_q_present")
    lf0, lf1 = r.f(6), r.f(6)
    lfu = lfv = 0
    if lf0 or lf1:
        lfu, lfv = r.f(6), r.f(6)
    lf_sharpness = r.f(3)
    _expect(r, 1, 0, "lf delta enabled")
    cdef_damping, cdef_y, cdef_uv = 3, ((0, 0),), ((0, 0),)
    if seq.enable_cdef:
        cdef_damping = r.f(2) + 3
        cdef_bits = r.f(2)
        ys, uvs = [], []
        for _ in range(1 << cdef_bits):
            yp = r.f(4)
            ysec = r.f(2)
            up = r.f(4)
            usec = r.f(2)
            ys.append((yp, ysec + (ysec == 3)))
            uvs.append((up, usec + (usec == 3)))
        cdef_y, cdef_uv = tuple(ys), tuple(uvs)
    lr_types, lr_unit_shift, lr_uv_shift = (0, 0, 0), 0, 1
    if seq.enable_restoration:
        from ..filters.restoration import REMAP_LR_TYPE

        lr_types = tuple(REMAP_LR_TYPE[r.f(2)] for _ in range(3))
        if any(lr_types):
            lr_unit_shift = r.f(1)
            if lr_unit_shift:
                lr_unit_shift += r.f(1)
            if any(lr_types[1:]):
                lr_uv_shift = r.f(1)
    tx_mode = r.f(1)  # tx_mode_select: 0 LARGEST, 1 SELECT
    reference_select = 0
    if not is_intra:
        reference_select = r.f(1)
        if reference_select:
            from ..entropy.bitstream import skip_mode_allowed

            hints = [0] * 7
            if slot_hints is not None:
                hints = [slot_hints[ref_frame_idx[i]] for i in range(7)]
            if skip_mode_allowed(order_hint, seq.order_hint_bits, hints):
                _expect(r, 1, 0, "skip_mode_present: skip_mode unsupported")
    reduced_tx_set = r.f(1)
    gm_mvs = [(0, 0)] * 8
    if not is_intra:
        from ..codec.gm import read_global_motion_params

        prev_gm = None
        if primary_ref != 7 and slot_gms is not None:
            prev_gm = slot_gms[ref_frame_idx[primary_ref]]
        gm_mvs = read_global_motion_params(r, prev_gm, allow_hp=False)
    film_grain = None
    if seq.film_grain_params_present and (show_frame or True):
        # hidden frames in our streams are always showable -> params present
        from ..filters.film_grain import parse_params

        film_grain = parse_params(r, is_inter=not is_intra)
        if not film_grain.apply_grain:
            film_grain = None
    # spec 5.10.1: the frame header byte-aligns BEFORE the tile group; the
    # tile group's tile_start_and_end_present_flag then re-aligns (5.11.1)
    r.byte_alignment()
    if tcl or trl:
        _expect(r, 1, 0, "tile_start_and_end_present_flag")
        r.byte_alignment()
    return FrameInfo(qindex=qindex, disable_cdf_update=bool(disable_cdf_update),
                     header_bytes=r.pos // 8, tile_cols_log2=tcl, tile_rows_log2=trl,
                     frame_type=frame_type, show_frame=bool(show_frame), order_hint=order_hint,
                     refresh_frame_flags=refresh, ref_frame_idx=ref_frame_idx,
                     interp_filter=interp_filter, lf_levels=(lf0, lf1, lfu, lfv),
                     lf_sharpness=lf_sharpness, cdef_damping=cdef_damping,
                     cdef_y=cdef_y, cdef_uv=cdef_uv, primary_ref_frame=primary_ref,
                     frame_end_update_cdf=frame_end_update_cdf, lr_types=lr_types,
                     gm_mvs=tuple(tuple(m) for m in gm_mvs),
                     lr_unit_shift=lr_unit_shift, lr_uv_shift=lr_uv_shift,
                     tx_mode=tx_mode, reduced_tx_set=reduced_tx_set,
                     reference_select=reference_select, film_grain=film_grain)


def _obus(data: bytes):
    """(obu_type, payload) of each OBU of a temporal unit."""
    pos = 0
    while pos < len(data):
        header = data[pos]
        assert (header & 0x80) == 0 and (header >> 1) & 1  # forbidden bit, has_size
        size, pos = read_leb128(data, pos + 1)
        yield (header >> 3) & 0xF, data[pos : pos + size]
        pos += size


def frame_headers(tus) -> list:
    """The FrameInfo of every coded frame of a stream's temporal units, in
    coding order, parsed without decoding the tiles: the slots' order
    hints and global motion follow refresh_frame_flags, as in
    Decoder._decode_frame."""
    seq, hints, gms, out = None, [0] * 8, [[(0, 0)] * 8] * 8, []
    for tu in tus:
        for obu_type, payload in _obus(tu):
            if obu_type == int(ObuType.OBU_SEQUENCE_HEADER):
                seq = parse_sequence_header(payload)
            elif obu_type == int(ObuType.OBU_FRAME):
                fi = parse_frame_header(payload, seq, slot_hints=hints, slot_gms=gms)
                out.append(fi)
                for slot in range(8):
                    if (fi.refresh_frame_flags >> slot) & 1:
                        hints[slot], gms[slot] = fi.order_hint, fi.gm_mvs
    return out


@dataclass
class Decoder:
    """Stateful decoder: sequence header + 8-slot DPB across temporal units."""

    seq: SeqInfo | None = None
    dpb: list = field(default_factory=lambda: [None] * 8)
    # per-slot saved frame contexts (CDF state; spec reference frame update)
    cdf_slots: list = field(default_factory=lambda: [None] * 8)

    def decode_tu(self, data: bytes):
        """Decode one TU -> (y, u, v, recon_planes).

        (y, u, v) is the frame DISPLAYED by this TU (None for hidden frames);
        recon_planes is the recon of the frame DECODED by this TU (None for
        show_existing_frame TUs)."""
        out = (None, None, None, None)
        for obu_type, payload in _obus(data):
            if obu_type == int(ObuType.OBU_SEQUENCE_HEADER):
                self.seq = parse_sequence_header(payload)
            elif obu_type == int(ObuType.OBU_FRAME):
                out = self._decode_frame(payload)
            elif obu_type == int(ObuType.OBU_FRAME_HEADER):
                r = BitReader(payload)
                if r.f(1) == 1:  # show_existing_frame
                    slot = r.f(3)
                    entry = self.dpb[slot]
                    assert entry is not None
                    out = self._display(entry["planes"], entry.get("grain")) + (None,)
                else:
                    raise NotImplementedError("standalone frame headers unsupported")
        return out

    def _decode_frame(self, payload: bytes):
        seq = self.seq
        assert seq is not None
        slot_hints = [e["order_hint"] if e is not None else 0 for e in self.dpb]
        slot_gms = [e.get("gm", [(0, 0)] * 8) if e is not None else [(0, 0)] * 8
                    for e in self.dpb]
        fi = parse_frame_header(payload, seq, slot_hints=slot_hints,
                                slot_gms=slot_gms)
        tile_data = payload[fi.header_bytes :]
        is_intra = fi.frame_type == 0

        # resolve DPB references for LAST..ALTREF
        refs = None
        ref_hints = [0] * 8
        if not is_intra:
            refs = {}
            for ref in range(1, 8):
                slot = fi.ref_frame_idx[ref - 1]
                entry = self.dpb[slot]
                assert entry is not None, f"ref slot {slot} empty"
                refs[ref] = entry["planes"]
                ref_hints[ref] = entry["order_hint"]

        params = FrameParams(width=seq.width, height=seq.height, qindex=fi.qindex, bd=seq.bd,
                             disable_cdf_update=fi.disable_cdf_update,
                             tile_cols_log2=fi.tile_cols_log2, tile_rows_log2=fi.tile_rows_log2,
                             frame_is_intra=is_intra, order_hint=fi.order_hint,
                             order_hint_bits=seq.order_hint_bits,
                             interp_filter=fi.interp_filter, ref_hints=tuple(ref_hints),
                             lf_levels=fi.lf_levels, lf_sharpness=fi.lf_sharpness,
                             enable_filter_intra=seq.enable_filter_intra,
                             lr_types=fi.lr_types, lr_unit_shift=fi.lr_unit_shift,
                             lr_uv_shift=fi.lr_uv_shift, tx_mode=fi.tx_mode,
                             reduced_tx_set=fi.reduced_tx_set,
                             reference_select=fi.reference_select,
                             gm_mvs=fi.gm_mvs,
                             enable_intra_edge_filter=seq.enable_intra_edge_filter)
        lr_out = None
        if params.lr_active:
            from ..filters import restoration as lr_mod

            lr_out = []
            for plane in range(3):
                sub = 1 if plane else 0
                usize = params.lr_unit_size(plane)
                nr = lr_mod.count_units(usize, (seq.height + sub) >> sub)
                nc = lr_mod.count_units(usize, (seq.width + sub) >> sub)
                lr_out.append([[lr_mod.UnitInfo() for _ in range(nc)] for _ in range(nr)])
        tiles = params.tiles()
        aw, ah = params.aligned_width, params.aligned_height
        recon = [np.zeros((ah, aw), np.int32), np.zeros((ah >> 1, aw >> 1), np.int32),
                 np.zeros((ah >> 1, aw >> 1), np.int32)]
        from ..codec.mvp import MiState

        mi = MiState(params.mi_rows, params.mi_cols)
        # frame-initial CDF state: primary ref's saved context or defaults
        # (spec 7.20 init; load_cdfs / setup_past_independence)
        if is_intra or fi.primary_ref_frame == 7:
            fc_init = FrameContext(fi.qindex)
        else:
            saved = self.cdf_slots[fi.ref_frame_idx[fi.primary_ref_frame]]
            assert saved is not None, "primary ref has no saved frame context"
            fc_init = saved
        fc0 = fc_init.clone()  # tile 0 adapts this copy in place
        off = 0
        for i, tile in enumerate(tiles):
            if i < len(tiles) - 1:
                tsz = int.from_bytes(tile_data[off : off + 4], "little") + 1
                off += 4
            else:
                tsz = len(tile_data) - off
            fc_t = fc0 if i == 0 else fc_init.clone()
            tc = TileCodec(params, fc_t, tile=tile, refs=refs, mi=mi)
            tc.decode(tile_data[off : off + tsz], recon, lr_out=lr_out)
            off += tsz
        # saved context for refreshed slots: tile context_update_tile_id's
        # (0 for our streams) end state, or the frame-initial state when
        # disable_frame_end_update_cdf (spec decode_frame_wrapup)
        saved_ctx = (fc0 if (fi.frame_end_update_cdf and not fi.disable_cdf_update)
                     else fc_init)
        # The adopted context restarts its adaptation counters, exactly as
        # the encoder does when storing (spec frame-end context adoption /
        # av1_reset_cdf_symbol_counters). Without this, adaptation *rates*
        # diverge on the first frame that inherits this context and the
        # parse desyncs. reset_counters is idempotent, so re-resetting a
        # context that was already stored reset (fc_init aliasing a slot)
        # is safe.
        saved_ctx.reset_counters()

        if any(fi.lf_levels):
            from ..filters import dlf

            dlf.loop_filter_frame(recon, mi, fi.qindex, seq.bd, is_intra,
                                  levels=fi.lf_levels, sharpness=fi.lf_sharpness,
                                  disp_dims=(seq.width, seq.height))
        # LR boundary rows come from the deblocked (pre-CDEF) frame
        deblock = [pl.copy() for pl in recon] if params.lr_active else None
        if self.seq.enable_cdef and (any(fi.cdef_y[0]) or any(fi.cdef_uv[0])):
            from ..filters import cdef as cdef_mod

            cdef_mod.cdef_frame(recon, mi, fi.cdef_y[0][0], fi.cdef_y[0][1],
                                fi.cdef_uv[0][0], fi.cdef_uv[0][1], fi.cdef_damping, bd=seq.bd)
        if params.lr_active:
            from ..filters import restoration as lr_mod

            for plane in range(3):
                if fi.lr_types[plane] == lr_mod.RESTORE_NONE:
                    continue
                sub = 1 if plane else 0
                recon[plane] = lr_mod.apply_lr_plane(
                    recon[plane], deblock[plane], lr_out[plane],
                    params.lr_unit_size(plane), (seq.width + sub) >> sub,
                    (seq.height + sub) >> sub, sub, seq.bd, plane > 0)

        # DPB update (spec reference frame update process). Re-pad the
        # alignment margin from the display edge so MC never reads decoded
        # padding (mirrors the encoder; see replicate_display_edges).
        from ..pipeline.encoder import replicate_display_edges

        replicate_display_edges(recon, seq.width, seq.height)
        # film grain: resolve load-from-ref params, store with the DPB entry
        grain = fi.film_grain
        if grain is not None and not grain.update_grain:
            src = self.dpb[grain.film_grain_params_ref_idx]
            assert src is not None and src.get("grain") is not None
            from dataclasses import replace

            grain = replace(src["grain"], grain_seed=grain.grain_seed)
        entry = {"planes": recon, "order_hint": fi.order_hint, "grain": grain,
                 "gm": fi.gm_mvs}
        for slot in range(8):
            if (fi.refresh_frame_flags >> slot) & 1:
                self.dpb[slot] = entry
                self.cdf_slots[slot] = saved_ctx

        w, h = seq.width, seq.height
        if not fi.show_frame:
            return (None, None, None, recon)
        return self._display(recon, grain) + (recon,)

    def _display(self, recon, grain):
        """Crop + film grain synthesis (output path only; refs stay clean)."""
        w, h = self.seq.width, self.seq.height
        shown = (recon[0][:h, :w], recon[1][: h >> 1, : w >> 1], recon[2][: h >> 1, : w >> 1])
        if grain is None:
            return shown
        from ..filters.film_grain import apply_grain

        out = apply_grain(tuple(np.ascontiguousarray(p) for p in shown), grain, self.seq.bd)
        return tuple(p.astype(np.int32) for p in out)


def decode_temporal_unit(data: bytes):
    """One-shot decode of a self-contained TU (key frame)."""
    return Decoder().decode_tu(data)
