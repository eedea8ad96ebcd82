"""Tile encode/decode: partition tree walk, mode info, residual coding.

Implements the AV1 tile-group payload for intra (key) frames with the
feature set: square partitions 8x8..64x64 (SPLIT/NONE), all non-directional
intra modes, TX_MODE_LARGEST (one txb per block/plane), 4:2:0.

Encoder and decoder share every context-derivation helper so the bitstream
writer, rate estimation, and the in-repo conformance decoder cannot drift
apart. Behavioral reference: Source/Lib/Codec/entropy_coding.c
(encode_partition_av1 :1005, av1_get_skip_context :1064,
svt_aom_get_kf_y_mode_ctx :1085, svt_aom_get_txb_ctx :313,
partition_context_lookup definitions.h:1574).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..constants.av1 import (BLOCK_H, BLOCK_W, MAX_TXSIZE_RECT, SIZE_GROUP, TX_H, TX_W, BlockSize, InterMode,
                             Partition, PredMode, RefFrame, TxSize, TxType)
from ..constants.cdf import FrameContext
from ..entropy.range_coder import RangeDecoder, RangeEncoder, update_cdf
from ..ops import convolve as conv_ops
from ..ops import intra as intra_ops
from ..ops import quantize as quant_ops
from ..ops import transforms as txfm_ops
from . import txb as txb_mod
from .mv import MvCoder
from .mvp import MiState, TileBounds, find_mv_stack

PARTITION_PLOFFSET = 4
UV_CFL_PRED = 13  # uv_mode symbol beyond PAETH (spec UV_CFL_PRED)
INTRA_MODE_CONTEXT = np.array([0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0], np.int32)
# partition_context_lookup[bsize] -> (above, left)  (definitions.h:1574)
PARTITION_CTX_LOOKUP = np.array(
    [[31, 31], [31, 30], [30, 31], [30, 30], [30, 28], [28, 30], [28, 28], [28, 24], [24, 28], [24, 24],
     [24, 16], [16, 24], [16, 16], [16, 0], [0, 16], [0, 0], [31, 28], [28, 31], [30, 24], [24, 30], [28, 16], [16, 28]],
    np.int32,
)
SKIP_CONTEXTS_2D = np.array(
    [[1, 2, 2, 2, 3], [1, 4, 4, 4, 5], [1, 4, 4, 4, 5], [1, 4, 4, 4, 5], [1, 4, 4, 4, 6]], np.int32
)
# ext-tx signaling (definitions.h:1777-1831, cabac_context_model.h av1_ext_tx_ind)
EXT_TX_SET_DCTONLY, EXT_TX_SET_DCT_IDTX, EXT_TX_SET_DTT4_IDTX, EXT_TX_SET_DTT4_IDTX_1DDCT = 0, 1, 2, 3
EXT_TX_SET_DTT9_IDTX_1DDCT, EXT_TX_SET_ALL16 = 4, 5
AV1_NUM_EXT_TX_SET = [1, 2, 5, 7, 12, 16]
AV1_EXT_TX_IND = np.array(
    [[0] * 16,
     [1] + [0] * 15,
     [1, 3, 4, 2] + [0] * 12,
     [1, 5, 6, 4, 0, 0, 0, 0, 0, 0, 2, 3, 0, 0, 0, 0],
     [3, 4, 5, 8, 6, 7, 9, 10, 11, 0, 1, 2, 0, 0, 0, 0],
     [7, 8, 9, 12, 10, 11, 13, 14, 15, 0, 1, 2, 3, 4, 5, 6]],
    np.int32,
)
AV1_EXT_TX_INV = np.array(
    [[0] * 16,
     [9] + [0] * 15,
     [9, 0, 3, 1, 2] + [0] * 11,
     [9, 0, 10, 11, 3, 1, 2] + [0] * 9,
     [9, 10, 11, 0, 1, 2, 4, 5, 3, 6, 7, 8, 0, 0, 0, 0],
     [9, 10, 11, 12, 13, 14, 15, 0, 1, 2, 4, 5, 3, 6, 7, 8]],
    np.int32,
)
EXT_TX_SET_INDEX_INTRA = {EXT_TX_SET_DCTONLY: 0, EXT_TX_SET_DTT4_IDTX_1DDCT: 1, EXT_TX_SET_DTT4_IDTX: 2}
EXT_TX_SET_INDEX_INTER = {EXT_TX_SET_DCTONLY: 0, EXT_TX_SET_ALL16: 1, EXT_TX_SET_DTT9_IDTX_1DDCT: 2,
                          EXT_TX_SET_DCT_IDTX: 3}
AV1_EXT_TX_USED = np.array(
    [[1] + [0] * 15,
     [1, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0],
     [1, 1, 1, 1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0],
     [1, 1, 1, 1, 0, 0, 0, 0, 0, 1, 1, 1, 0, 0, 0, 0],
     [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0],
     [1] * 16],
    np.int32,
)
# filter-intra mode -> intra dir used for tx-type CDF indexing (spec
# Filter_Intra_Mode_To_Intra_Dir)
FI_MODE_TO_DIR = np.array([int(PredMode.DC_PRED), int(PredMode.V_PRED), int(PredMode.H_PRED),
                           int(PredMode.D157_PRED), int(PredMode.DC_PRED)], np.int32)

# intra mode -> default transform type (spec Mode_To_Txfm, common_utils.h:67)
MODE_TO_TXFM = np.array(
    [int(TxType.DCT_DCT), int(TxType.ADST_DCT), int(TxType.DCT_ADST), int(TxType.DCT_DCT),
     int(TxType.ADST_ADST), int(TxType.ADST_DCT), int(TxType.DCT_ADST), int(TxType.DCT_ADST),
     int(TxType.ADST_DCT), int(TxType.ADST_ADST), int(TxType.ADST_DCT), int(TxType.DCT_ADST),
     int(TxType.ADST_ADST)],
    np.int32,
)


def chroma_tx_type(uv_mode: int, tx_size: int, reduced: int = 0) -> int:
    """Chroma intra tx type is derived, not signaled (spec compute_tx_type)."""
    derived = int(MODE_TO_TXFM[uv_mode])
    set_type = ext_tx_set_type_intra(tx_size, reduced)
    if not AV1_EXT_TX_USED[set_type][derived]:
        return int(TxType.DCT_DCT)
    return derived

# square bsize per mi-size-log2: 8x8 -> log 1
SQUARE_BSIZE = {8: BlockSize.BLOCK_8X8, 16: BlockSize.BLOCK_16X16, 32: BlockSize.BLOCK_32X32, 64: BlockSize.BLOCK_64X64}


def ext_tx_set_type_intra(tx_size: int, reduced: int = 0) -> int:
    from ..constants.av1 import TX_SIZE_SQR, TX_SIZE_SQR_UP

    if int(TX_SIZE_SQR_UP[tx_size]) >= int(TxSize.TX_32X32):
        return EXT_TX_SET_DCTONLY
    if reduced:
        return EXT_TX_SET_DTT4_IDTX_1DDCT
    if int(TX_SIZE_SQR[tx_size]) == int(TxSize.TX_16X16):
        return EXT_TX_SET_DTT4_IDTX
    return EXT_TX_SET_DTT4_IDTX_1DDCT


def ext_tx_set_type_inter(tx_size: int, reduced: int = 0) -> int:
    """spec get_ext_tx_set_type, is_inter=1."""
    from ..constants.av1 import TX_SIZE_SQR, TX_SIZE_SQR_UP

    squp = int(TX_SIZE_SQR_UP[tx_size])
    if squp > int(TxSize.TX_32X32):
        return EXT_TX_SET_DCTONLY
    if squp == int(TxSize.TX_32X32) or reduced:
        return EXT_TX_SET_DCT_IDTX
    if int(TX_SIZE_SQR[tx_size]) == int(TxSize.TX_16X16):
        return EXT_TX_SET_DTT9_IDTX_1DDCT
    return EXT_TX_SET_ALL16


def chroma_tx_type_inter(luma_tx_type: int, chroma_tx_size: int, reduced: int = 0) -> int:
    """Inter chroma derives its tx type from the co-located luma txb, gated
    by membership in the chroma tx size's inter set (spec compute_tx_type)."""
    set_type = ext_tx_set_type_inter(chroma_tx_size, reduced)
    if not AV1_EXT_TX_USED[set_type][luma_tx_type]:
        return int(TxType.DCT_DCT)
    return int(luma_tx_type)


def max_uv_txsize(luma_bsize: int) -> int:
    """Chroma tx size for 4:2:0 given the luma block size (spec
    Max_Tx_Size_Rect of the subsampled plane bsize, clamped to 32)."""
    w = max(int(BLOCK_W[luma_bsize]) // 2, 4)
    h = max(int(BLOCK_H[luma_bsize]) // 2, 4)
    w, h = min(w, 32), min(h, 32)
    return int({(4, 4): TxSize.TX_4X4, (8, 8): TxSize.TX_8X8,
                (16, 16): TxSize.TX_16X16, (32, 32): TxSize.TX_32X32,
                (4, 8): TxSize.TX_4X8, (8, 4): TxSize.TX_8X4,
                (8, 16): TxSize.TX_8X16, (16, 8): TxSize.TX_16X8,
                (16, 32): TxSize.TX_16X32, (32, 16): TxSize.TX_32X16,
                (4, 16): TxSize.TX_4X16, (16, 4): TxSize.TX_16X4,
                (8, 32): TxSize.TX_8X32, (32, 8): TxSize.TX_32X8}[(w, h)])


@dataclass
class FrameParams:
    width: int
    height: int
    qindex: int
    bd: int = 8
    sb_size: int = 64
    disable_cdf_update: bool = False
    tile_cols_log2: int = 0
    tile_rows_log2: int = 0
    # inter-frame state (spec uncompressed_header); intra defaults
    frame_is_intra: bool = True
    order_hint: int = 0
    order_hint_bits: int = 7
    allow_high_precision_mv: bool = False
    interp_filter: int = 0  # REGULAR (frame-level, non-switchable)
    ref_hints: tuple = (0,) * 8  # order hints per ref-frame id 1..7 (idx 0 unused)
    lf_levels: tuple = (0, 0, 0, 0)  # loop filter levels (y_v, y_h, u, v)
    lf_sharpness: int = 0
    enable_filter_intra: bool = False  # seq-level flag (adds block syntax)
    # loop restoration (spec lr_params): internal RESTORE_* type per plane,
    # luma unit size 64 << lr_unit_shift, chroma unit >> lr_uv_shift
    lr_types: tuple = (0, 0, 0)
    lr_unit_shift: int = 0
    lr_uv_shift: int = 1
    # compound prediction availability (spec reference_select): when 1,
    # every inter block signals single-vs-compound (comp_inter symbol)
    reference_select: int = 0
    # global motion (TRANSLATION subset): (row8, col8) per ref-frame id
    # 1..7 (index 0 unused); all-zero = identity (codec/gm.py).  enable_gm
    # is the encoder-side config gate (static jit key: one decide program
    # variant per config, not per frame's gm value)
    gm_mvs: tuple = ((0, 0),) * 8
    enable_gm: int = 0
    # tx signaling (spec read_tx_mode): 0 = TX_MODE_LARGEST (our encoder),
    # 1 = TX_MODE_SELECT (per-block tx depth; decode-side support for
    # reference-encoded streams)
    tx_mode: int = 0
    reduced_tx_set: int = 0
    # sequence flag: directional predictions filter/upsample their edges
    # (spec 7.11.2.4); our encoder signals 0, reference streams signal 1
    enable_intra_edge_filter: bool = False
    # encoder-side knobs (not bitstream syntax)
    enable_rdoq: bool = True  # batched level/eob optimization in commit
    # preset speed features (enc_mode_config.c analog, honest scale):
    # candidate counts + search depths the device programs specialize on
    sf_nmodes_inter: int = 7   # intra candidate modes in inter frames
    sf_nmodes_key: int = 13    # intra candidate modes in key frames
    sf_tx_ntypes: int = 4      # luma tx-type search set size (1 = DCT only)
    sf_fast_subpel: int = 0    # 1 = exhaustive 5x5 subpel lattice (25 MCs)
    sf_cdef_fast: int = 0      # 1 = reduced CDEF strength ladder
    sf_dlf_search: int = 0     # 1 = frame-level DLF level search

    @property
    def lr_active(self) -> bool:
        return any(self.lr_types)

    def lr_unit_size(self, plane: int) -> int:
        size = 64 << self.lr_unit_shift
        return size >> self.lr_uv_shift if plane else size

    def sign_bias(self):
        """RefFrameSignBias per ref id (spec: ref hint after current frame)."""
        import numpy as _np

        bias = _np.zeros(8, _np.int32)
        if self.frame_is_intra:
            return bias
        m = 1 << (self.order_hint_bits - 1)
        for ref in range(1, 8):
            diff = (self.ref_hints[ref] - self.order_hint)
            diff = (diff & (m - 1)) - (diff & m)
            bias[ref] = int(diff > 0)
        return bias

    @property
    def mi_cols(self) -> int:
        return 2 * ((self.width + 7) >> 3)

    @property
    def mi_rows(self) -> int:
        return 2 * ((self.height + 7) >> 3)

    @property
    def aligned_width(self) -> int:
        return self.mi_cols * 4

    @property
    def aligned_height(self) -> int:
        return self.mi_rows * 4

    @property
    def sb_cols(self) -> int:
        return (self.mi_cols * 4 + self.sb_size - 1) // self.sb_size

    @property
    def sb_rows(self) -> int:
        return (self.mi_rows * 4 + self.sb_size - 1) // self.sb_size

    def tiles(self) -> list:
        """Uniform tile grid (spec 5.9.15): list of
        (sb_row0, sb_row1, sb_col0, sb_col1) in raster tile order."""
        tcl, trl = self.tile_cols_log2, self.tile_rows_log2
        tw = (self.sb_cols + (1 << tcl) - 1) >> tcl
        th = (self.sb_rows + (1 << trl) - 1) >> trl
        out = []
        for tr in range(1 << trl):
            r0 = tr * th
            if r0 >= self.sb_rows:
                break
            r1 = min(r0 + th, self.sb_rows)
            for tc in range(1 << tcl):
                c0 = tc * tw
                if c0 >= self.sb_cols:
                    break
                out.append((r0, r1, c0, min(c0 + tw, self.sb_cols)))
        return out


@dataclass
class BlockDecision:
    """Mode-decision output for one coded block (encoder side)."""

    y_mode: int = int(PredMode.DC_PRED)  # full YMode range (intra + inter modes)
    uv_mode: int = int(PredMode.DC_PRED)
    skip: int = 0
    levels_y: np.ndarray | None = None  # adjusted-size quantized levels
    levels_u: np.ndarray | None = None
    levels_v: np.ndarray | None = None
    tx_type: int = int(TxType.DCT_DCT)
    tx_size_y: int = -1  # -1 = MAX_TXSIZE_RECT (TX_MODE_LARGEST); else SELECT
    angle_delta_y: int = 0
    angle_delta_uv: int = 0
    # CfL (decode-side): signed alpha indices, 0 = inactive channel
    cfl_alpha_u: int = 0
    cfl_alpha_v: int = 0
    # inter fields
    ref_frame: int = int(RefFrame.INTRA_FRAME)  # 0 = intra block
    ref_frame1: int = int(RefFrame.NONE)  # second ref (compound) or NONE
    mv: tuple = (0, 0)  # (row, col) 1/8 pel
    mv1: tuple = (0, 0)  # second ref's MV (compound)
    ref_mv_idx: int = 0
    # filter-intra (recursive intra; DC-mode blocks <= 32x32)
    use_filter_intra: int = 0
    filter_intra_mode: int = 0

    @property
    def is_inter(self) -> bool:
        return self.ref_frame >= int(RefFrame.LAST_FRAME)


def is_directional(mode: int) -> bool:
    return int(PredMode.V_PRED) <= mode <= int(PredMode.D67_PRED)


@dataclass
class Plan:
    """Encoder decisions for one tile: partition map + per-block decisions.

    Device MD fills `grids` (whole block-grids as arrays — no per-block
    objects); scalar paths fill `blocks`. `materialize()` expands grids into
    `blocks` for consumers that need per-block dicts (Python walk, decoder
    tests)."""

    partitions: dict = field(default_factory=dict)  # (mi_row, mi_col, bsize) -> Partition
    blocks: dict = field(default_factory=dict)  # (mi_row, mi_col, bsize) -> BlockDecision
    grids: list = field(default_factory=list)  # dicts: y0,x0,n,bsize,modes,skip,ly,lu,lv
    leaves: set = field(default_factory=set)  # all leaf keys (blocks + grid cells)
    # loop restoration: per-plane 2D [unit_row][unit_col] of
    # filters.restoration.UnitInfo (None when LR inactive)
    lr_units: list = None

    def materialize(self) -> None:
        from ..pipeline.intra_md import MODES as _MODES

        for g in self.grids:
            R, C = g["modes"].shape
            n = g["n"]
            for r in range(R):
                for c in range(C):
                    key = ((g["y0"] + r * n) // 4, (g["x0"] + c * n) // 4, g["bsize"])
                    if key in self.blocks:
                        continue
                    sk = int(g["skip"][r, c])
                    self.blocks[key] = BlockDecision(
                        y_mode=_MODES[int(g["modes"][r, c])], uv_mode=int(PredMode.DC_PRED),
                        skip=sk, tx_type=int(TxType.DCT_DCT),
                        levels_y=None if sk else np.asarray(g["ly"][r, c], np.int32),
                        levels_u=None if sk else np.asarray(g["lu"][r, c], np.int32),
                        levels_v=None if sk else np.asarray(g["lv"][r, c], np.int32))


class TileCodec:
    """Walks the tile in coding order, maintaining all symbol contexts.

    Encode: `encode(plan) -> bytes` (no recon — mode decision already did it).
    Decode: `decode(data) -> recon planes` (the conformance path).
    """

    def __init__(self, params: FrameParams, fc: FrameContext, tile=None, refs=None, mi=None):
        self.p = params
        self.fc = fc
        # tile bounds in SB units (defaults: whole frame)
        sb = tile if tile is not None else (0, params.sb_rows, 0, params.sb_cols)
        self.mi_row0, self.mi_row1 = sb[0] * 16, min(sb[1] * 16, params.mi_rows)
        self.mi_col0, self.mi_col1 = sb[2] * 16, min(sb[3] * 16, params.mi_cols)
        self.sb_range = sb
        mc, mr = params.mi_cols, params.mi_rows
        self.above_part = np.zeros(mc, np.uint8)
        self.left_part = np.zeros(mr, np.uint8)
        self.mode_grid = np.full((mr, mc), int(PredMode.DC_PRED), np.int32)
        self.uv_mode_grid = np.full((mr, mc), int(PredMode.DC_PRED), np.int32)
        self.mode_valid = np.zeros((mr, mc), bool)
        self.skip_grid = np.zeros((mr, mc), np.int32)
        # per-mi effective tx width/height (TX_MODE_SELECT ctx; spec
        # above/left txfm context). Init value unused (ctx checks have_*).
        self.above_txfm = np.full(mc, 64, np.int32)
        self.left_txfm = np.full(mr, 64, np.int32)
        # per-plane entropy ctx (cul_level bytes) per 4x4 unit
        self.above_ctx = [np.zeros(mc, np.int32), np.zeros((mc + 1) >> 1, np.int32), np.zeros((mc + 1) >> 1, np.int32)]
        self.left_ctx = [np.zeros(mr, np.int32), np.zeros((mr + 1) >> 1, np.int32), np.zeros((mr + 1) >> 1, np.int32)]
        self.update = not params.disable_cdf_update
        # inter-frame state: per-mi mode info + refs for decoder-side MC.
        # `mi` may be a frame-shared MiState (decoder: loop filter needs the
        # whole-frame grid across tiles)
        self.mi = mi if mi is not None else MiState(mr, mc)
        self.tile_bounds = TileBounds(self.mi_row0, self.mi_row1, self.mi_col0, self.mi_col1)
        self.refs = refs  # dict ref_frame_id -> [y, u, v] recon planes
        self.sbias = params.sign_bias()
        self.mv_coder = MvCoder(fc, update=self.update, allow_hp=params.allow_high_precision_mv)
        # loop restoration: per-tile ref-chained predictors (spec decode_tile
        # resets RefLrWiener / RefSgrXqd to the mid values)
        from ..filters import restoration as _lr

        self._lr_ref_w = [[list(_lr.WIENER_TAPS_MID), list(_lr.WIENER_TAPS_MID)]
                          for _ in range(3)]
        self._lr_ref_x = [list(_lr.SGRPROJ_XQD_MID) for _ in range(3)]

    # ------------------------------------------------------------------ utils

    def _sym_w(self, enc, cdf, s, n):
        enc.encode_symbol_n(s, cdf, n)
        if self.update:
            update_cdf(cdf, s, n)

    def _sym_r(self, dec, cdf, n):
        s = dec.decode_symbol_n(cdf, n)
        if self.update:
            update_cdf(cdf, s, n)
        return s

    # ------------------------------------------------------- loop restoration
    # spec 5.11.57 read_lr / 5.9.x subexp coding; write twins mirror exactly

    @staticmethod
    def _quniform_w(enc, n, v):
        if n <= 1:
            return
        l = max((n - 1).bit_length(), 1)
        m = (1 << l) - n
        if v < m:
            enc.encode_literal(v, l - 1)
        else:
            enc.encode_literal(m + ((v - m) >> 1), l - 1)
            enc.encode_literal((v - m) & 1, 1)

    @staticmethod
    def _quniform_r(dec, n):
        if n <= 1:
            return 0
        l = max((n - 1).bit_length(), 1)
        m = (1 << l) - n
        v = dec.decode_literal(l - 1) if l > 1 else 0
        if v < m:
            return v
        return (v << 1) - m + dec.decode_literal(1)

    def _subexp_w(self, enc, mx, k, u):
        i = 0
        mk = 0
        while True:
            b2 = k + i - 1 if i else k
            a = 1 << b2
            if mx <= mk + 3 * a:
                self._quniform_w(enc, mx - mk, u - mk)
                return
            more = int(u >= mk + a)
            enc.encode_literal(more, 1)
            if not more:
                enc.encode_literal(u - mk, b2)
                return
            i += 1
            mk += a

    def _subexp_r(self, dec, mx, k):
        i = 0
        mk = 0
        while True:
            b2 = k + i - 1 if i else k
            a = 1 << b2
            if mx <= mk + 3 * a:
                return self._quniform_r(dec, mx - mk) + mk
            if not dec.decode_literal(1):
                return dec.decode_literal(b2) + mk
            i += 1
            mk += a

    @staticmethod
    def _recenter(r, v):
        if v > 2 * r:
            return v
        if v >= r:
            return (v - r) * 2
        return (r - v) * 2 - 1

    @staticmethod
    def _inv_recenter(r, v):
        if v > 2 * r:
            return v
        if v & 1:
            return r - ((v + 1) >> 1)  # odd = below-ref offsets
        return r + (v >> 1)

    def _signed_subexp_w(self, enc, low, high, k, ref, v):
        mx = high - low
        r = ref - low
        x = v - low
        u = (self._recenter(r, x) if (r << 1) <= mx
             else self._recenter(mx - 1 - r, mx - 1 - x))
        self._subexp_w(enc, mx, k, u)

    def _signed_subexp_r(self, dec, low, high, k, ref):
        mx = high - low
        r = ref - low
        u = self._subexp_r(dec, mx, k)
        x = (self._inv_recenter(r, u) if (r << 1) <= mx
             else mx - 1 - self._inv_recenter(mx - 1 - r, u))
        return x + low

    def _code_lr(self, enc, dec, plan, mi_row, mi_col):
        """Code the restoration units whose first superblock is this SB
        (spec read_lr; runs before decode_partition at each SB)."""
        from ..filters import restoration as lr

        p = self.p
        fc = self.fc
        for plane in range(3):
            ftype = p.lr_types[plane]
            if ftype == lr.RESTORE_NONE:
                continue
            sub = 1 if plane else 0
            usize = p.lr_unit_size(plane)
            ph = (p.height + sub) >> sub
            pw = (p.width + sub) >> sub
            unit_rows = lr.count_units(usize, ph)
            unit_cols = lr.count_units(usize, pw)
            num = 4 >> sub  # MI_SIZE >> subsampling (no superres)
            ur0 = (mi_row * num + usize - 1) // usize
            ur1 = min(unit_rows, ((mi_row + 16) * num + usize - 1) // usize)
            uc0 = (mi_col * num + usize - 1) // usize
            uc1 = min(unit_cols, ((mi_col + 16) * num + usize - 1) // usize)
            for ur in range(ur0, ur1):
                for uc in range(uc0, uc1):
                    self._code_lr_unit(enc, dec, plan, plane, ftype, ur, uc)

    def _code_lr_unit(self, enc, dec, plan, plane, ftype, ur, uc):
        from ..filters import restoration as lr

        fc = self.fc
        chroma = plane > 0
        if dec is not None:
            info = lr.UnitInfo()
            if ftype == lr.RESTORE_SWITCHABLE:
                info.rtype = self._sym_r(dec, fc["switchable_restore"], 3)
            elif ftype == lr.RESTORE_WIENER:
                info.rtype = lr.RESTORE_WIENER if self._sym_r(
                    dec, fc["wiener_restore"], 2) else lr.RESTORE_NONE
            else:
                info.rtype = lr.RESTORE_SGRPROJ if self._sym_r(
                    dec, fc["sgrproj_restore"], 2) else lr.RESTORE_NONE
            if info.rtype == lr.RESTORE_WIENER:
                taps = []
                for ps in range(2):
                    row = [0, 0, 0]
                    for j in range(1 if chroma else 0, 3):
                        v = self._signed_subexp_r(
                            dec, lr.WIENER_TAPS_MIN[j], lr.WIENER_TAPS_MAX[j] + 1,
                            lr.WIENER_TAPS_K[j], self._lr_ref_w[plane][ps][j])
                        row[j] = v
                        self._lr_ref_w[plane][ps][j] = v
                    taps.append(tuple(row))
                info.wiener = tuple(taps)
            elif info.rtype == lr.RESTORE_SGRPROJ:
                ep = dec.decode_literal(lr.SGRPROJ_PARAMS_BITS)
                r0, _, r1, _ = lr.SGR_PARAMS[ep]
                xqd = [0, 0]
                for i, rad in ((0, r0), (1, r1)):
                    if rad:
                        v = self._signed_subexp_r(
                            dec, lr.SGRPROJ_XQD_MIN[i], lr.SGRPROJ_XQD_MAX[i] + 1,
                            lr.SGRPROJ_PRJ_SUBEXP_K, self._lr_ref_x[plane][i])
                    else:
                        v = 0
                        if i == 1:
                            v = max(lr.SGRPROJ_XQD_MIN[1],
                                    min(lr.SGRPROJ_XQD_MAX[1],
                                        (1 << lr.SGRPROJ_PRJ_BITS) - self._lr_ref_x[plane][0]))
                    xqd[i] = v
                    self._lr_ref_x[plane][i] = v
                info.sgr_ep = ep
                info.sgr_xqd = tuple(xqd)
            self._lr_out[plane][ur][uc] = info
            return
        # encode
        info = plan.lr_units[plane][ur][uc]
        if ftype == lr.RESTORE_SWITCHABLE:
            self._sym_w(enc, fc["switchable_restore"], info.rtype, 3)
        elif ftype == lr.RESTORE_WIENER:
            self._sym_w(enc, fc["wiener_restore"],
                        int(info.rtype == lr.RESTORE_WIENER), 2)
        else:
            self._sym_w(enc, fc["sgrproj_restore"],
                        int(info.rtype == lr.RESTORE_SGRPROJ), 2)
        if info.rtype == lr.RESTORE_WIENER:
            for ps in range(2):
                for j in range(1 if chroma else 0, 3):
                    v = int(info.wiener[ps][j])
                    self._signed_subexp_w(
                        enc, lr.WIENER_TAPS_MIN[j], lr.WIENER_TAPS_MAX[j] + 1,
                        lr.WIENER_TAPS_K[j], self._lr_ref_w[plane][ps][j], v)
                    self._lr_ref_w[plane][ps][j] = v
        elif info.rtype == lr.RESTORE_SGRPROJ:
            enc.encode_literal(info.sgr_ep, lr.SGRPROJ_PARAMS_BITS)
            r0, _, r1, _ = lr.SGR_PARAMS[info.sgr_ep]
            for i, rad in ((0, r0), (1, r1)):
                v = int(info.sgr_xqd[i])
                if rad:
                    self._signed_subexp_w(
                        enc, lr.SGRPROJ_XQD_MIN[i], lr.SGRPROJ_XQD_MAX[i] + 1,
                        lr.SGRPROJ_PRJ_SUBEXP_K, self._lr_ref_x[plane][i], v)
                self._lr_ref_x[plane][i] = v

    def _partition_ctx(self, mi_row, mi_col, bsize):
        above = (int(self.above_part[mi_col]) >> (int(np.log2(BLOCK_W[bsize] // 8)))) & 1
        left = (int(self.left_part[mi_row]) >> (int(np.log2(BLOCK_W[bsize] // 8)))) & 1
        bsl = int(np.log2(BLOCK_W[bsize] // 8))
        return (left * 2 + above) + bsl * PARTITION_PLOFFSET

    def _update_partition_ctx(self, mi_row, mi_col, subsize, bsize):
        bw = int(BLOCK_W[bsize]) // 4
        bh = int(BLOCK_H[bsize]) // 4
        self.above_part[mi_col : mi_col + bw] = PARTITION_CTX_LOOKUP[subsize][0]
        self.left_part[mi_row : mi_row + bh] = PARTITION_CTX_LOOKUP[subsize][1]

    def _skip_ctx(self, mi_row, mi_col):
        above = int(self.skip_grid[mi_row - 1, mi_col]) if mi_row > self.mi_row0 and self.mode_valid[mi_row - 1, mi_col] else 0
        left = int(self.skip_grid[mi_row, mi_col - 1]) if mi_col > self.mi_col0 and self.mode_valid[mi_row, mi_col - 1] else 0
        return above + left

    # ------------------------------------------------- TX_MODE_SELECT (read)
    # spec 5.11.16 read_tx_size / Split_Tx_Size; behavioral reference
    # entropy_coding.c set_txfm_ctx + get_tx_size_context

    # Split_Tx_Size (spec): indexed by TxSize 0..18
    SPLIT_TX_SIZE = (0, 0, 1, 2, 3, 0, 0, 1, 1, 2, 2, 3, 3, 5, 6, 7, 8, 9, 10)

    def _read_tx_size(self, dec, mi_row, mi_col, bsize, allow_select):
        fc = self.fc
        max_tx = int(MAX_TXSIZE_RECT[bsize])
        if not allow_select or int(BLOCK_W[bsize]) * int(BLOCK_H[bsize]) <= 16:
            return max_tx
        # category / max depth: steps from the max rect tx down to 4x4,
        # capped at MAX_TX_DEPTH=2 (libaom bsize_to_tx_size_cat / _max_depth)
        steps, t = 0, max_tx
        while t != int(TxSize.TX_4X4):
            steps += 1
            t = self.SPLIT_TX_SIZE[t]
        cat = min(steps - 1, 3)
        max_depth = min(steps, 2)
        mw, mh = int(TX_W[max_tx]), int(TX_H[max_tx])
        ha, hl = mi_row > self.mi_row0, mi_col > self.mi_col0
        a = int(self.above_txfm[mi_col] >= mw) if ha else 0
        l = int(self.left_txfm[mi_row] >= mh) if hl else 0
        ctx = (a + l) if (ha and hl) else (a if ha else l)
        depth = self._sym_r(dec, fc["tx_size"][cat][ctx], max_depth + 1)
        tx = max_tx
        for _ in range(depth):
            tx = self.SPLIT_TX_SIZE[tx]
        return tx

    def _set_txfm_ctx(self, mi_row, mi_col, bsize, tx_size):
        bw4, bh4 = int(BLOCK_W[bsize]) // 4, int(BLOCK_H[bsize]) // 4
        self.above_txfm[mi_col : mi_col + bw4] = int(TX_W[tx_size])
        self.left_txfm[mi_row : mi_row + bh4] = int(TX_H[tx_size])

    def _kf_y_ctx(self, mi_row, mi_col):
        above_mode = int(self.mode_grid[mi_row - 1, mi_col]) if mi_row > self.mi_row0 and self.mode_valid[mi_row - 1, mi_col] else int(PredMode.DC_PRED)
        left_mode = int(self.mode_grid[mi_row, mi_col - 1]) if mi_col > self.mi_col0 and self.mode_valid[mi_row, mi_col - 1] else int(PredMode.DC_PRED)
        return int(INTRA_MODE_CONTEXT[above_mode]), int(INTRA_MODE_CONTEXT[left_mode])

    def _txb_ctx(self, plane, plane_x4, plane_y4, tx_size, plane_bsize_equal):
        """(txb_skip_ctx, dc_sign_ctx). plane_x4/y4 in plane 4x4 units."""
        adj = txb_mod.adjusted_tx_size(tx_size)
        w4 = int(TX_W[tx_size]) // 4
        h4 = int(TX_H[tx_size]) // 4
        a = self.above_ctx[plane][plane_x4 : plane_x4 + w4]
        l = self.left_ctx[plane][plane_y4 : plane_y4 + h4]
        # dc sign ctx
        signs = {0: 0, 1: -1, 2: 1}
        dc_sum = sum(signs[(int(v) >> txb_mod.COEFF_CONTEXT_BITS) & 3] for v in a)
        dc_sum += sum(signs[(int(v) >> txb_mod.COEFF_CONTEXT_BITS) & 3] for v in l)
        dc_sign_ctx = 0 if dc_sum == 0 else (1 if dc_sum < 0 else 2)
        if plane == 0:
            if plane_bsize_equal:
                txb_skip_ctx = 0
            else:
                top = 0
                for v in a:
                    top |= int(v)
                top &= txb_mod.COEFF_CONTEXT_MASK
                left = 0
                for v in l:
                    left |= int(v)
                left &= txb_mod.COEFF_CONTEXT_MASK
                mx = min(top | left, 4)
                mn = min(min(top, left), 4)
                txb_skip_ctx = int(SKIP_CONTEXTS_2D[mn][mx])
        else:
            ctx_base = int(any(int(v) != 0 for v in a)) + int(any(int(v) != 0 for v in l))
            # chroma: plane_bsize vs tx size area (our chroma tx always fills
            # the chroma block -> offset 7)
            txb_skip_ctx = ctx_base + 7
        return txb_skip_ctx, dc_sign_ctx

    def _set_txb_ctx(self, plane, plane_x4, plane_y4, tx_size, cul_level):
        w4 = int(TX_W[tx_size]) // 4
        h4 = int(TX_H[tx_size]) // 4
        self.above_ctx[plane][plane_x4 : plane_x4 + w4] = cul_level
        self.left_ctx[plane][plane_y4 : plane_y4 + h4] = cul_level

    def _has_chroma(self, mi_row, mi_col, bsize):
        """spec HasChroma for 4:2:0: sub-8x8 blocks reference chroma only
        when they cover the bottom-right of their 8x8 unit."""
        bw4, bh4 = int(BLOCK_W[bsize]) // 4, int(BLOCK_H[bsize]) // 4
        ok_r = (mi_row & 1) or not (bh4 & 1)
        ok_c = (mi_col & 1) or not (bw4 & 1)
        return bool(ok_r and ok_c)

    # --------------------------------------------------------------- encoding

    def encode(self, plan: Plan, use_native: bool = True) -> bytes:
        enc = None
        if use_native and not self.p.enable_filter_intra:
            from ..entropy import native

            if native.available():
                from . import tile_walk_native

                return tile_walk_native.encode_tile_native(self.p, self.fc, plan, self.sb_range)
        if enc is None:
            enc = RangeEncoder()
        plan.materialize()
        r0, r1, c0, c1 = self.sb_range
        for sb_row in range(r0, r1):
            for sb_col in range(c0, c1):
                if self.p.lr_active:
                    self._code_lr(enc, None, plan, sb_row * 16, sb_col * 16)
                self._code_partition(enc, None, plan, sb_row * 16, sb_col * 16, int(BlockSize.BLOCK_64X64))
        return enc.done()

    def decode(self, data: bytes, recon: list, lr_out=None) -> None:
        """recon: [y (H, W), u, v] int32 planes (aligned dims), filled in place.
        lr_out: per-plane 2D unit grids filled with parsed UnitInfo when the
        frame header signals restoration."""
        dec = RangeDecoder(data)
        self._recon = recon
        self._lr_out = lr_out
        r0, r1, c0, c1 = self.sb_range
        for sb_row in range(r0, r1):
            for sb_col in range(c0, c1):
                if self.p.lr_active:
                    self._code_lr(None, dec, None, sb_row * 16, sb_col * 16)
                self._code_partition(None, dec, None, sb_row * 16, sb_col * 16, int(BlockSize.BLOCK_64X64))

    # ------------------------------------------------------------- partitions

    def _code_partition(self, enc, dec, plan, mi_row, mi_col, bsize):
        p = self.p
        if mi_row >= p.mi_rows or mi_col >= p.mi_cols:
            return
        bw4 = int(BLOCK_W[bsize]) // 4
        half = bw4 // 2
        has_rows = (mi_row + half) < p.mi_rows
        has_cols = (mi_col + half) < p.mi_cols
        ctx = self._partition_ctx(mi_row, mi_col, bsize)
        nsyms = 10 if bsize not in (int(BlockSize.BLOCK_8X8), int(BlockSize.BLOCK_128X128)) else (4 if bsize == int(BlockSize.BLOCK_8X8) else 8)

        if bsize == int(BlockSize.BLOCK_8X8):
            # frame dims are multiples of 8 in this profile -> always in bounds
            assert has_rows and has_cols, "8x8 partial blocks need mi-granular frames"
            if enc is not None:
                part = int(plan.partitions.get((mi_row, mi_col, bsize), Partition.PARTITION_NONE))
                self._sym_w(enc, self.fc["partition"][ctx], part, 4)
            else:
                part = self._sym_r(dec, self.fc["partition"][ctx], 4)
            assert enc is None or part == int(Partition.PARTITION_NONE), \
                "the encoder emits 8x8 minimum blocks"
        elif has_rows and has_cols:
            if enc is not None:
                part = int(plan.partitions[(mi_row, mi_col, bsize)])
                self._sym_w(enc, self.fc["partition"][ctx], part, nsyms)
            else:
                part = self._sym_r(dec, self.fc["partition"][ctx], nsyms)
        elif has_cols:  # bottom edge: SPLIT or HORZ
            part = self._bool_partition(enc, dec, plan, mi_row, mi_col, bsize, ctx, vert_alike=False)
        elif has_rows:  # right edge: SPLIT or VERT
            part = self._bool_partition(enc, dec, plan, mi_row, mi_col, bsize, ctx, vert_alike=True)
        else:
            part = int(Partition.PARTITION_SPLIT)

        from ..constants.av1 import PARTITION_SUBSIZE

        P = Partition
        B = BlockSize
        sq = B(bsize)
        if part == int(P.PARTITION_NONE):
            self._code_block(enc, dec, plan, mi_row, mi_col, bsize, part)
            self._update_partition_ctx(mi_row, mi_col, bsize, bsize)
        elif part == int(P.PARTITION_SPLIT):
            sub = int(PARTITION_SUBSIZE[P.PARTITION_SPLIT][sq])
            if bsize == int(B.BLOCK_8X8):  # 4x4 leaves: no further syntax
                for dy in (0, 1):
                    for dx in (0, 1):
                        self._code_block(enc, dec, plan, mi_row + dy, mi_col + dx, sub, part)
                self._update_partition_ctx(mi_row, mi_col, sub, bsize)
            else:
                for dy in (0, half):
                    for dx in (0, half):
                        self._code_partition(enc, dec, plan, mi_row + dy, mi_col + dx, sub)
        elif part == int(P.PARTITION_HORZ):
            sub = int(PARTITION_SUBSIZE[P.PARTITION_HORZ][sq])
            self._code_block(enc, dec, plan, mi_row, mi_col, sub, part)
            if has_rows:
                self._code_block(enc, dec, plan, mi_row + half, mi_col, sub, part)
            self._update_partition_ctx(mi_row, mi_col, sub, bsize)
        elif part == int(P.PARTITION_VERT):
            sub = int(PARTITION_SUBSIZE[P.PARTITION_VERT][sq])
            self._code_block(enc, dec, plan, mi_row, mi_col, sub, part)
            if has_cols:
                self._code_block(enc, dec, plan, mi_row, mi_col + half, sub, part)
            self._update_partition_ctx(mi_row, mi_col, sub, bsize)
        elif part in (int(P.PARTITION_HORZ_A), int(P.PARTITION_HORZ_B),
                      int(P.PARTITION_VERT_A), int(P.PARTITION_VERT_B)):
            sq2 = int(PARTITION_SUBSIZE[P.PARTITION_SPLIT][sq])
            subh = int(PARTITION_SUBSIZE[P.PARTITION_HORZ][sq])
            subv = int(PARTITION_SUBSIZE[P.PARTITION_VERT][sq])
            if part == int(P.PARTITION_HORZ_A):
                self._code_block(enc, dec, plan, mi_row, mi_col, sq2, part)
                self._code_block(enc, dec, plan, mi_row, mi_col + half, sq2, part)
                self._code_block(enc, dec, plan, mi_row + half, mi_col, subh, part)
                self._update_partition_ctx(mi_row, mi_col, sq2, subh)
                self._update_partition_ctx(mi_row + half, mi_col, subh, subh)
            elif part == int(P.PARTITION_HORZ_B):
                self._code_block(enc, dec, plan, mi_row, mi_col, subh, part)
                self._code_block(enc, dec, plan, mi_row + half, mi_col, sq2, part)
                self._code_block(enc, dec, plan, mi_row + half, mi_col + half, sq2, part)
                self._update_partition_ctx(mi_row, mi_col, subh, subh)
                self._update_partition_ctx(mi_row + half, mi_col, sq2, subh)
            elif part == int(P.PARTITION_VERT_A):
                self._code_block(enc, dec, plan, mi_row, mi_col, sq2, part)
                self._code_block(enc, dec, plan, mi_row + half, mi_col, sq2, part)
                self._code_block(enc, dec, plan, mi_row, mi_col + half, subv, part)
                self._update_partition_ctx(mi_row, mi_col, sq2, subv)
                self._update_partition_ctx(mi_row, mi_col + half, subv, subv)
            else:  # VERT_B
                self._code_block(enc, dec, plan, mi_row, mi_col, subv, part)
                self._code_block(enc, dec, plan, mi_row, mi_col + half, sq2, part)
                self._code_block(enc, dec, plan, mi_row + half, mi_col + half, sq2, part)
                self._update_partition_ctx(mi_row, mi_col, subv, subv)
                self._update_partition_ctx(mi_row, mi_col + half, sq2, subv)
        elif part in (int(P.PARTITION_HORZ_4), int(P.PARTITION_VERT_4)):
            qbs = half // 2
            if part == int(P.PARTITION_HORZ_4):
                sub = {int(B.BLOCK_16X16): int(B.BLOCK_16X4),
                       int(B.BLOCK_32X32): int(B.BLOCK_32X8),
                       int(B.BLOCK_64X64): int(B.BLOCK_64X16)}[bsize]
                for i in range(4):
                    r = mi_row + i * qbs
                    if i > 0 and r >= p.mi_rows:
                        break
                    self._code_block(enc, dec, plan, r, mi_col, sub, part)
            else:
                sub = {int(B.BLOCK_16X16): int(B.BLOCK_4X16),
                       int(B.BLOCK_32X32): int(B.BLOCK_8X32),
                       int(B.BLOCK_64X64): int(B.BLOCK_16X64)}[bsize]
                for i in range(4):
                    c = mi_col + i * qbs
                    if i > 0 and c >= p.mi_cols:
                        break
                    self._code_block(enc, dec, plan, mi_row, c, sub, part)
            self._update_partition_ctx(mi_row, mi_col, sub, bsize)
        else:
            raise NotImplementedError(f"partition {part} unsupported")

    def _bool_partition(self, enc, dec, plan, mi_row, mi_col, bsize, ctx, vert_alike):
        """Boundary partitions: derive a 2-symbol CDF from the partition CDF
        (spec split_or_horz / split_or_vert; libaom partition_gather_*_alike).

        vert_alike=False = bottom edge (split_or_horz): the SPLIT probability
        sums the partitions whose TOP half contains a vertical edge.
        vert_alike=True = right edge (split_or_vert): partitions whose LEFT
        half contains a horizontal edge. (The r1-r3 builds had these two sets
        swapped — self-consistent in-repo but non-conformant; caught by the
        libaom cross-decode oracle.)"""
        incdf = self.fc["partition"][ctx]
        P = Partition
        members = [P.PARTITION_HORZ, P.PARTITION_SPLIT, P.PARTITION_HORZ_A, P.PARTITION_HORZ_B, P.PARTITION_VERT_A] if vert_alike else \
                  [P.PARTITION_VERT, P.PARTITION_SPLIT, P.PARTITION_HORZ_A, P.PARTITION_VERT_A, P.PARTITION_VERT_B]
        if bsize != int(BlockSize.BLOCK_128X128):
            members.append(P.PARTITION_HORZ_4 if vert_alike else P.PARTITION_VERT_4)

        def element_prob(k):
            prev = 32768 if k == 0 else int(incdf[k - 1])
            return prev - int(incdf[k])

        p0 = 32768 - sum(element_prob(int(m)) for m in members)
        gathered = np.array([32768 - p0, 0, 0], np.int32)
        if enc is not None:
            part = int(plan.partitions[(mi_row, mi_col, bsize)])
            self._sym_w(enc, gathered, int(part == int(P.PARTITION_SPLIT)), 2)
            return part
        else:
            is_split = self._sym_r(dec, gathered, 2)
            return int(P.PARTITION_SPLIT) if is_split else int(P.PARTITION_VERT if vert_alike else P.PARTITION_HORZ)

    # ------------------------------------------------------------------ block

    def _code_block(self, enc, dec, plan, mi_row, mi_col, bsize, partition=0):
        p = self.p
        fc = self.fc
        bw4, bh4 = int(BLOCK_W[bsize]) // 4, int(BLOCK_H[bsize]) // 4
        key = (mi_row, mi_col, bsize)
        d = plan.blocks[key] if enc is not None else BlockDecision()
        d._partition = partition  # containing-node partition (tr/bl tables)

        # --- skip
        sctx = self._skip_ctx(mi_row, mi_col)
        if enc is not None:
            self._sym_w(enc, fc["skip"][sctx], d.skip, 2)
        else:
            d.skip = self._sym_r(dec, fc["skip"][sctx], 2)

        if p.frame_is_intra:
            self._code_intra_modes(enc, dec, d, mi_row, mi_col, bsize, key_frame=True)
        else:
            # --- is_inter (spec read_is_inter)
            ictx = self._intra_inter_ctx(mi_row, mi_col)
            if enc is not None:
                self._sym_w(enc, fc["intra_inter"][ictx], int(d.is_inter), 2)
                is_inter = d.is_inter
            else:
                is_inter = bool(self._sym_r(dec, fc["intra_inter"][ictx], 2))
            if is_inter:
                self._code_inter_info(enc, dec, d, mi_row, mi_col, bsize)
            else:
                d.ref_frame = int(RefFrame.INTRA_FRAME)
                self._code_intra_modes(enc, dec, d, mi_row, mi_col, bsize, key_frame=False)

        # TX_MODE_SELECT: per-block luma tx size (decode-side; our encoder
        # emits TX_MODE_LARGEST streams). spec read_block_tx_size, intra only
        # (inter SELECT uses the var-tx recursion — not supported).
        tx_size_y = int(MAX_TXSIZE_RECT[bsize])
        if p.tx_mode == 1:
            assert not d.is_inter, "var-tx (inter TX_MODE_SELECT) unsupported"
            if dec is not None:
                tx_size_y = self._read_tx_size(dec, mi_row, mi_col, bsize,
                                               allow_select=not d.skip)
            self._set_txfm_ctx(mi_row, mi_col, bsize, tx_size_y)
        d.tx_size_y = tx_size_y

        # update mode/skip grids + per-mi mode info
        self.mode_grid[mi_row : mi_row + bh4, mi_col : mi_col + bw4] = d.y_mode
        self.uv_mode_grid[mi_row : mi_row + bh4, mi_col : mi_col + bw4] = d.uv_mode
        self.mode_valid[mi_row : mi_row + bh4, mi_col : mi_col + bw4] = True
        self.skip_grid[mi_row : mi_row + bh4, mi_col : mi_col + bw4] = d.skip
        self.mi.set_block(mi_row, mi_col, bsize, d.y_mode, d.ref_frame, int(d.ref_frame1),
                          (int(d.mv[0]), int(d.mv[1])),
                          mv1=(int(d.mv1[0]), int(d.mv1[1])), skip=d.skip)

        # --- residual
        if d.skip:
            # skip resets entropy contexts to zero over the block
            self._set_block_ctx_zero(mi_row, mi_col, bsize)
            if dec is not None:
                self._reconstruct(dec_levels=None, d=d, mi_row=mi_row, mi_col=mi_col, bsize=bsize)
            return

        tx_size_y = d.tx_size_y if d.tx_size_y >= 0 else int(MAX_TXSIZE_RECT[bsize])
        tx_size_uv = int(max_uv_txsize(bsize))
        has_chroma = self._has_chroma(mi_row, mi_col, bsize)
        levels = {}
        for plane, tx_size, lv in ((0, tx_size_y, d.levels_y), (1, tx_size_uv, d.levels_u), (2, tx_size_uv, d.levels_v)):
            if plane > 0 and not has_chroma:
                continue
            ss = 0 if plane == 0 else 1
            px4 = mi_col >> ss
            py4 = mi_row >> ss
            plane_type = int(plane > 0)
            if plane == 0 and dec is not None and tx_size != int(MAX_TXSIZE_RECT[bsize]):
                # TX_MODE_SELECT sub-block luma txbs (decode-only): raster
                # loop, per-txb contexts and tx type (spec residual())
                tw4, th4 = int(TX_W[tx_size]) // 4, int(TX_H[tx_size]) // 4
                txbs = []
                for toff_y in range(0, bh4, th4):
                    for toff_x in range(0, bw4, tw4):
                        tctx, dctx = self._txb_ctx(0, px4 + toff_x, py4 + toff_y,
                                                   tx_size, plane_bsize_equal=False)
                        lv2, cul = self._code_txb(None, dec, d, 0, 0, tx_size,
                                                  tctx, dctx, None, None)
                        self._set_txb_ctx(0, px4 + toff_x, py4 + toff_y, tx_size, cul)
                        txbs.append((toff_y, toff_x,
                                     int(getattr(self, "_eff_luma_tx", d.tx_type)), lv2))
                levels[0] = txbs
                continue
            tctx, dctx = self._txb_ctx(plane, px4, py4, tx_size, plane_bsize_equal=True)
            if enc is not None:
                adj = txb_mod.adjusted_tx_size(tx_size)
                lv2 = lv if lv is not None else np.zeros((int(TX_H[adj]), int(TX_W[adj])), np.int32)
                # tx type signaling for luma before eob (intra sets for < 32)
                eob_nonzero = np.any(lv2 != 0)
                cul = self._code_txb(enc, None, d, plane, plane_type, tx_size, tctx, dctx, lv2, eob_nonzero)
            else:
                lv2, cul = self._code_txb(None, dec, d, plane, plane_type, tx_size, tctx, dctx, None, None)
                levels[plane] = lv2
            self._set_txb_ctx(plane, px4, py4, tx_size, cul)
        if dec is not None:
            self._reconstruct(dec_levels=levels, d=d, mi_row=mi_row, mi_col=mi_col, bsize=bsize)

    def _code_intra_modes(self, enc, dec, d, mi_row, mi_col, bsize, key_frame: bool):
        """Y mode (+angle), UV mode (+angle). Key frames use the neighbor-
        conditioned kf_y_mode CDF, inter frames the size-group y_mode CDF."""
        fc = self.fc
        if key_frame:
            actx, lctx = self._kf_y_ctx(mi_row, mi_col)
            ycdf, nsy = fc["kf_y_mode"][actx][lctx], 13
        else:
            ycdf, nsy = fc["y_mode"][int(SIZE_GROUP[bsize])], 13
        if enc is not None:
            self._sym_w(enc, ycdf, d.y_mode, nsy)
        else:
            d.y_mode = self._sym_r(dec, ycdf, nsy)

        use_angle_delta = int(BLOCK_W[bsize]) >= 8 and int(BLOCK_H[bsize]) >= 8
        if is_directional(d.y_mode) and use_angle_delta:
            adcdf = fc["angle_delta"][d.y_mode - int(PredMode.V_PRED)]
            if enc is not None:
                self._sym_w(enc, adcdf, d.angle_delta_y + 3, 7)
            else:
                d.angle_delta_y = self._sym_r(dec, adcdf, 7) - 3

        if self._has_chroma(mi_row, mi_col, bsize):
            cfl_allowed = int(BLOCK_W[bsize]) <= 32 and int(BLOCK_H[bsize]) <= 32
            nsyms = 14 if cfl_allowed else 13
            if enc is not None:
                self._sym_w(enc, fc["uv_mode"][int(cfl_allowed)][d.y_mode], d.uv_mode, nsyms)
            else:
                d.uv_mode = self._sym_r(dec, fc["uv_mode"][int(cfl_allowed)][d.y_mode], nsyms)
            if d.uv_mode == UV_CFL_PRED:
                assert dec is not None, "the encoder does not emit CfL"
                # spec read_cfl_alphas: joint sign + per-channel alpha index
                js = self._sym_r(dec, fc["cfl_sign"], 8)
                sign_u, sign_v = (js + 1) // 3, (js + 1) % 3
                idx_u = idx_v = 0
                if sign_u != 0:
                    idx_u = self._sym_r(dec, fc["cfl_alpha"][js + 1 - 3], 16) + 1
                if sign_v != 0:
                    ctx_v = sign_v * 3 + sign_u - 3
                    idx_v = self._sym_r(dec, fc["cfl_alpha"][ctx_v], 16) + 1
                d.cfl_alpha_u = idx_u * (1 if sign_u == 2 else -1)
                d.cfl_alpha_v = idx_v * (1 if sign_v == 2 else -1)
            elif is_directional(d.uv_mode) and use_angle_delta:
                adcdf = fc["angle_delta"][d.uv_mode - int(PredMode.V_PRED)]
                if enc is not None:
                    self._sym_w(enc, adcdf, d.angle_delta_uv + 3, 7)
                else:
                    d.angle_delta_uv = self._sym_r(dec, adcdf, 7) - 3

        # filter_intra_mode_info (spec 5.11.8): DC blocks <= 32x32
        if (self.p.enable_filter_intra and d.y_mode == int(PredMode.DC_PRED)
                and int(BLOCK_W[bsize]) <= 32 and int(BLOCK_H[bsize]) <= 32):
            if enc is not None:
                self._sym_w(enc, fc["filter_intra"][bsize], d.use_filter_intra, 2)
                if d.use_filter_intra:
                    self._sym_w(enc, fc["filter_intra_mode"], d.filter_intra_mode, 5)
            else:
                d.use_filter_intra = self._sym_r(dec, fc["filter_intra"][bsize], 2)
                if d.use_filter_intra:
                    d.filter_intra_mode = self._sym_r(dec, fc["filter_intra_mode"], 5)

    # -------------------------------------------------------------- inter info

    def _intra_inter_ctx(self, mi_row, mi_col):
        """entropy_coding.c svt_av1_get_intra_inter_context."""
        has_above = mi_row > self.mi_row0
        has_left = mi_col > self.mi_col0
        a_intra = has_above and int(self.mi.ref0[mi_row - 1, mi_col]) == int(RefFrame.INTRA_FRAME)
        l_intra = has_left and int(self.mi.ref0[mi_row, mi_col - 1]) == int(RefFrame.INTRA_FRAME)
        if has_above and has_left:
            return 3 if (a_intra and l_intra) else int(a_intra or l_intra)
        if has_above or has_left:
            return 2 * int(a_intra if has_above else l_intra)
        return 0

    def _neighbor_ref_counts(self, mi_row, mi_col):
        """entropy_coding.c svt_aom_collect_neighbors_ref_counts_new."""
        c = np.zeros(8, np.int64)
        for r, col, avail in ((mi_row - 1, mi_col, mi_row > self.mi_row0),
                              (mi_row, mi_col - 1, mi_col > self.mi_col0)):
            if not avail:
                continue
            r0, r1 = int(self.mi.ref0[r, col]), int(self.mi.ref1[r, col])
            if r0 >= int(RefFrame.LAST_FRAME):
                c[r0] += 1
                if r1 >= int(RefFrame.LAST_FRAME):
                    c[r1] += 1
        return c

    @staticmethod
    def _ref_ctx(a, b):
        return 1 if a == b else (0 if a < b else 2)

    def _code_ref_frames(self, enc, dec, d, counts):
        """Single-reference tree (spec read_ref_frames, SINGLE_REFERENCE mode;
        reference write_ref_frames entropy_coding.c:2107)."""
        fc = self.fc
        c = counts
        R = RefFrame

        def rw(which_bit, ctx, bit):
            cdf = fc["single_ref"][ctx][which_bit]
            if enc is not None:
                self._sym_w(enc, cdf, bit, 2)
                return bit
            return self._sym_r(dec, cdf, 2)

        ref = d.ref_frame
        p1 = self._ref_ctx(c[1] + c[2] + c[3] + c[4], c[5] + c[6] + c[7])
        bit0 = rw(0, p1, int(ref >= int(R.BWDREF_FRAME)))
        if bit0:
            p2 = self._ref_ctx(c[5] + c[6], c[7])
            if rw(1, p2, int(ref == int(R.ALTREF_FRAME))):
                ref = int(R.ALTREF_FRAME)
            else:
                p6 = self._ref_ctx(c[5], c[6])
                ref = int(R.ALTREF2_FRAME) if rw(5, p6, int(ref == int(R.ALTREF2_FRAME))) else int(R.BWDREF_FRAME)
        else:
            p3 = self._ref_ctx(c[1] + c[2], c[3] + c[4])
            if rw(2, p3, int(ref in (int(R.LAST3_FRAME), int(R.GOLDEN_FRAME)))):
                p5 = self._ref_ctx(c[3], c[4])
                ref = int(R.GOLDEN_FRAME) if rw(4, p5, int(ref == int(R.GOLDEN_FRAME))) else int(R.LAST3_FRAME)
            else:
                p4 = self._ref_ctx(c[1], c[2])
                ref = int(R.LAST2_FRAME) if rw(3, p4, int(ref == int(R.LAST2_FRAME))) else int(R.LAST_FRAME)
        if dec is not None:
            d.ref_frame = ref

    # ------------------------------------------------ compound ref signaling

    def _nb_info(self, r, c):
        """(is_inter, has_second_ref, ref0_backward, uni_comp) of a coded
        neighbor cell (libaom MB_MODE_INFO predicates on our mi grids)."""
        r0 = int(self.mi.ref0[r, c])
        r1 = int(self.mi.ref1[r, c])
        is_inter = r0 >= int(RefFrame.LAST_FRAME)
        has2 = r1 >= int(RefFrame.LAST_FRAME)
        bwd0 = r0 >= int(RefFrame.BWDREF_FRAME)
        bwd1 = r1 >= int(RefFrame.BWDREF_FRAME)
        uni = has2 and not (bwd0 ^ bwd1)
        return is_inter, has2, bwd0, uni, r0, r1

    def _reference_mode_ctx(self, mi_row, mi_col):
        """libaom av1_get_reference_mode_context (comp_inter symbol ctx)."""
        has_a = mi_row > self.mi_row0
        has_l = mi_col > self.mi_col0
        A = self._nb_info(mi_row - 1, mi_col) if has_a else None
        L = self._nb_info(mi_row, mi_col - 1) if has_l else None
        if A is not None and L is not None:
            if not A[1] and not L[1]:
                return int(A[2]) ^ int(L[2])
            if not A[1]:
                return 2 + int(A[2] or not A[0])
            if not L[1]:
                return 2 + int(L[2] or not L[0])
            return 4
        E = A if A is not None else L
        if E is not None:
            return 3 if E[1] else int(E[2])
        return 1

    def _comp_ref_type_ctx(self, mi_row, mi_col):
        """libaom av1_get_comp_reference_type_context."""
        R = RefFrame
        has_a = mi_row > self.mi_row0
        has_l = mi_col > self.mi_col0
        A = self._nb_info(mi_row - 1, mi_col) if has_a else None
        L = self._nb_info(mi_row, mi_col - 1) if has_l else None
        if A is not None and L is not None:
            a_intra, l_intra = not A[0], not L[0]
            if a_intra and l_intra:
                return 2
            if a_intra or l_intra:
                E = L if a_intra else A
                return 2 if not E[1] else 1 + 2 * int(E[3])
            a_sg, l_sg = not A[1], not L[1]
            if a_sg and l_sg:
                return 1 + 2 * int(not (A[2] ^ L[2]))
            if a_sg or l_sg:
                uni = L[3] if a_sg else A[3]
                if not uni:
                    return 1
                return 3 + int(not (A[2] ^ L[2]))
            if not A[3] and not L[3]:
                return 0
            if not A[3] or not L[3]:
                return 2
            return 3 + int((A[4] == int(R.BWDREF_FRAME)) == (L[4] == int(R.BWDREF_FRAME)))
        E = A if A is not None else L
        if E is None:
            return 2
        if not E[0]:
            return 2
        return (4 * int(E[3])) if E[1] else 2

    def _code_comp_ref_frames(self, enc, dec, d, counts, mi_row, mi_col):
        """BIDIR compound reference pair (spec read_ref_frames COMPOUND
        branch; libaom write_ref_frames comp side with count-based ctxs)."""
        fc = self.fc
        R = RefFrame
        c = counts
        tctx = self._comp_ref_type_ctx(mi_row, mi_col)
        if enc is not None:
            self._sym_w(enc, fc["comp_ref_type"][tctx], 1, 2)  # BIDIR_COMP
        else:
            rtype = self._sym_r(dec, fc["comp_ref_type"][tctx], 2)
            if rtype != 1:
                raise NotImplementedError("unidirectional compound")

        def rw(table, which_bit, ctx, bit):
            cdf = fc[table][ctx][which_bit]
            if enc is not None:
                self._sym_w(enc, cdf, bit, 2)
                return bit
            return self._sym_r(dec, cdf, 2)

        ref0, ref1 = d.ref_frame, d.ref_frame1
        p0 = self._ref_ctx(c[1] + c[2], c[3] + c[4])
        bit0 = rw("comp_ref", 0, p0, int(ref0 in (int(R.LAST3_FRAME), int(R.GOLDEN_FRAME))))
        if bit0:
            p2 = self._ref_ctx(c[3], c[4])
            ref0 = int(R.GOLDEN_FRAME) if rw("comp_ref", 2, p2, int(ref0 == int(R.GOLDEN_FRAME))) \
                else int(R.LAST3_FRAME)
        else:
            p1 = self._ref_ctx(c[1], c[2])
            ref0 = int(R.LAST2_FRAME) if rw("comp_ref", 1, p1, int(ref0 == int(R.LAST2_FRAME))) \
                else int(R.LAST_FRAME)
        pb = self._ref_ctx(c[5] + c[6], c[7])
        bitb = rw("comp_bwdref", 0, pb, int(ref1 == int(R.ALTREF_FRAME)))
        if bitb:
            ref1 = int(R.ALTREF_FRAME)
        else:
            pb1 = self._ref_ctx(c[5], c[6])
            ref1 = int(R.ALTREF2_FRAME) if rw("comp_bwdref", 1, pb1, int(ref1 == int(R.ALTREF2_FRAME))) \
                else int(R.BWDREF_FRAME)
        if dec is not None:
            d.ref_frame, d.ref_frame1 = ref0, ref1

    # Compound_Mode_Ctx_Map (spec read_inter_compound_mode)
    _COMP_MODE_CTX_MAP = ((0, 1, 1, 1, 1), (1, 2, 3, 4, 4), (4, 4, 5, 6, 7))

    def _code_comp_mode_mv(self, enc, dec, d, stack):
        """Compound inter mode + DRL + MV pair. The encoder emits NEW_NEWMV
        (searched MVs) and downgrades to NEAREST_NEARESTMV when the pair
        equals stack entry 0 (pure rate win — the prediction is identical);
        the decoder additionally parses NEAR_NEARMV / GLOBAL_GLOBALMV."""
        fc = self.fc
        M = InterMode
        ctx = self._COMP_MODE_CTX_MAP[stack.ref_mv_ctx >> 1][min(stack.new_mv_ctx, 4)]
        if enc is not None:
            mode = d.y_mode
            if (mode == int(M.NEW_NEWMV)
                    and tuple(d.mv) == stack.pred_mv(0, 0)
                    and tuple(d.mv1) == stack.pred_mv(0, 1)):
                mode = int(M.NEAREST_NEARESTMV)
                d.y_mode = mode
                d.ref_mv_idx = 0
            self._sym_w(enc, fc["inter_compound_mode"][ctx],
                        mode - int(M.NEAREST_NEARESTMV), 8)
        else:
            mode = int(M.NEAREST_NEARESTMV) + self._sym_r(
                dec, fc["inter_compound_mode"][ctx], 8)
            d.y_mode = mode
        ref_mv_idx = self._code_drl(enc, dec, d, stack, mode)
        if dec is not None:
            d.ref_mv_idx = ref_mv_idx
        if mode == int(M.NEW_NEWMV):
            for which in (0, 1):
                pred = stack.pred_mv(ref_mv_idx, which)
                if enc is not None:
                    self.mv_coder.write_mv(enc, d.mv if which == 0 else d.mv1, pred)
                elif which == 0:
                    d.mv = self.mv_coder.read_mv(dec, pred)
                else:
                    d.mv1 = self.mv_coder.read_mv(dec, pred)
        elif mode == int(M.NEAREST_NEARESTMV):
            d.mv, d.mv1 = stack.pred_mv(0, 0), stack.pred_mv(0, 1)
        elif mode == int(M.NEAR_NEARMV):
            d.mv, d.mv1 = stack.pred_mv(ref_mv_idx, 0), stack.pred_mv(ref_mv_idx, 1)
        elif mode == int(M.GLOBAL_GLOBALMV):
            d.mv = tuple(self.p.gm_mvs[d.ref_frame])
            d.mv1 = tuple(self.p.gm_mvs[d.ref_frame1])
        else:
            raise NotImplementedError(f"mixed compound mode {mode}")

    def _code_drl(self, enc, dec, d, stack, mode):
        """spec read_drl_idx; returns RefMvIdx."""
        from ..constants.av1 import has_newmv as _has_newmv

        fc = self.fc
        M = InterMode
        ref_mv_idx = 0
        if mode == int(M.NEWMV) or _has_newmv(mode):
            rng = range(0, 2)
        elif mode in (int(M.NEARMV), int(M.NEAR_NEARMV)):
            ref_mv_idx = 1
            rng = range(1, 3)
        else:
            return 0
        for idx in rng:
            if stack.count > idx + 1:
                cdf = fc["drl"][stack.drl_ctx(idx)]
                if enc is not None:
                    bit = int(d.ref_mv_idx != idx)
                    self._sym_w(enc, cdf, bit, 2)
                else:
                    bit = self._sym_r(dec, cdf, 2)
                if not bit:
                    ref_mv_idx = idx
                    break
                ref_mv_idx = idx + 1
        return ref_mv_idx

    def _code_inter_info(self, enc, dec, d, mi_row, mi_col, bsize):
        """Ref frame + inter mode + drl + MV (spec inter_block_mode_info).
        Must run BEFORE the mi grid is updated for this block."""
        fc = self.fc
        M = InterMode
        counts = self._neighbor_ref_counts(mi_row, mi_col)
        # single vs compound (spec read_ref_frames with reference_select)
        is_comp = False
        if self.p.reference_select:
            rctx = self._reference_mode_ctx(mi_row, mi_col)
            if enc is not None:
                is_comp = d.ref_frame1 > int(RefFrame.INTRA_FRAME)
                self._sym_w(enc, fc["comp_inter"][rctx], int(is_comp), 2)
            else:
                is_comp = bool(self._sym_r(dec, fc["comp_inter"][rctx], 2))
        if is_comp:
            self._code_comp_ref_frames(enc, dec, d, counts, mi_row, mi_col)
            stack = find_mv_stack(self.mi, self.tile_bounds, mi_row, mi_col, bsize,
                                  d.ref_frame, self.sbias, ref_frame1=d.ref_frame1,
                                  gm_mv=self.p.gm_mvs[d.ref_frame],
                                  gm_mv1=self.p.gm_mvs[d.ref_frame1])
            self._code_comp_mode_mv(enc, dec, d, stack)
            return
        if dec is not None:
            d.ref_frame1 = int(RefFrame.NONE)
        self._code_ref_frames(enc, dec, d, counts)
        stack = find_mv_stack(self.mi, self.tile_bounds, mi_row, mi_col, bsize, d.ref_frame,
                              self.sbias, gm_mv=self.p.gm_mvs[d.ref_frame])

        if enc is not None:
            mode = d.y_mode
            # NEWMV whose searched MV equals the top stack entry codes as
            # NEARESTMV (no MV payload — pure rate win, same prediction)
            if mode == int(M.NEWMV) and tuple(d.mv) == stack.pred_mv(0):
                mode = int(M.NEARESTMV)
                d.y_mode = mode
                d.ref_mv_idx = 0
            self._sym_w(enc, fc["newmv"][stack.new_mv_ctx], int(mode != int(M.NEWMV)), 2)
            if mode != int(M.NEWMV):
                self._sym_w(enc, fc["zeromv"][stack.zero_mv_ctx], int(mode != int(M.GLOBALMV)), 2)
                if mode != int(M.GLOBALMV):
                    self._sym_w(enc, fc["refmv"][stack.ref_mv_ctx], int(mode != int(M.NEARESTMV)), 2)
        else:
            if self._sym_r(dec, fc["newmv"][stack.new_mv_ctx], 2) == 0:
                mode = int(M.NEWMV)
            elif self._sym_r(dec, fc["zeromv"][stack.zero_mv_ctx], 2) == 0:
                mode = int(M.GLOBALMV)
            else:
                mode = int(M.NEARESTMV) if self._sym_r(dec, fc["refmv"][stack.ref_mv_ctx], 2) == 0 \
                    else int(M.NEARMV)
            d.y_mode = mode

        ref_mv_idx = self._code_drl(enc, dec, d, stack, mode)
        if dec is not None:
            d.ref_mv_idx = ref_mv_idx

        if mode == int(M.NEWMV):
            pred = stack.pred_mv(ref_mv_idx)
            if enc is not None:
                self.mv_coder.write_mv(enc, d.mv, pred)
            else:
                d.mv = self.mv_coder.read_mv(dec, pred)
        elif mode == int(M.NEARESTMV):
            d.mv = (int(stack.mvs[0][0]), int(stack.mvs[0][1]))
        elif mode == int(M.NEARMV):
            d.mv = (int(stack.mvs[ref_mv_idx][0]), int(stack.mvs[ref_mv_idx][1]))
        else:  # GLOBALMV: the frame's global MV for this ref (identity -> 0)
            d.mv = tuple(self.p.gm_mvs[d.ref_frame])

    def _code_txb(self, enc, dec, d, plane, plane_type, tx_size, tctx, dctx, lv2, eob_nonzero):
        """Wrap txb read/write with the luma tx-type signal in spec order:
        all_zero first, then tx type, then eob/levels. We re-implement the
        txb_skip symbol here so tx_type lands between it and the eob."""
        fc = self.fc
        if enc is not None:
            # txb writer handles txb_skip itself; tx type must come right
            # after txb_skip and before eob -> emulate by splitting
            cul = self._write_txb_with_txtype(enc, d, plane, plane_type, tx_size, tctx, dctx, lv2)
            return cul
        else:
            return self._read_txb_with_txtype(dec, d, plane, plane_type, tx_size, tctx, dctx)

    def _txtype_signal_info(self, tx_size, is_inter: bool = False):
        red = int(self.p.reduced_tx_set)
        set_type = (ext_tx_set_type_inter(tx_size, red) if is_inter
                    else ext_tx_set_type_intra(tx_size, red))
        nsym = AV1_NUM_EXT_TX_SET[set_type]
        if nsym <= 1 or self.p.qindex == 0:
            return None
        eset = (EXT_TX_SET_INDEX_INTER if is_inter else EXT_TX_SET_INDEX_INTRA)[set_type]
        from ..constants.av1 import TX_SIZE_SQR

        return set_type, eset, int(TX_SIZE_SQR[tx_size]), nsym

    def _chroma_tx_type(self, d, tx_size):
        red = int(self.p.reduced_tx_set)
        if d.is_inter:
            return chroma_tx_type_inter(getattr(self, "_eff_luma_tx", int(d.tx_type)),
                                        tx_size, red)
        # CfL derives its tx type as DC (spec get_uv_mode: UV_CFL -> DC)
        uvm = int(PredMode.DC_PRED) if d.uv_mode == UV_CFL_PRED else d.uv_mode
        return chroma_tx_type(uvm, tx_size, red)

    def _write_txb_with_txtype(self, enc, d, plane, plane_type, tx_size, tctx, dctx, lv2):
        fc = self.fc
        # spec order: txb_skip, then (luma) transform_type, then eob/levels.
        eob_zero = not np.any(lv2 != 0)
        txs_ctx = txb_mod.get_txsize_entropy_ctx(tx_size)
        self._sym_w(enc, fc["txb_skip"][txs_ctx][tctx], int(eob_zero), 2)
        if plane == 0:
            # effective luma tx type as the decoder will see it (DCT when eob=0)
            self._eff_luma_tx = int(TxType.DCT_DCT) if eob_zero else int(d.tx_type)
        if eob_zero:
            return 0
        if plane == 0:
            info = self._txtype_signal_info(tx_size, d.is_inter)
            if info is not None:
                set_type, eset, sqr, nsym = info
                sym = int(AV1_EXT_TX_IND[set_type][d.tx_type])
                if d.is_inter:
                    self._sym_w(enc, fc["inter_ext_tx"][eset][sqr], sym, nsym)
                else:
                    idir = int(FI_MODE_TO_DIR[d.filter_intra_mode]) if d.use_filter_intra else d.y_mode
                    self._sym_w(enc, fc["intra_ext_tx"][eset][sqr][idir], sym, nsym)
            tx_type = d.tx_type
        else:
            tx_type = self._chroma_tx_type(d, tx_size)
        return txb_mod.write_coeffs_txb_body(enc, fc, lv2, tx_size, tx_type, plane_type, dctx, self.update)

    def _read_txb_with_txtype(self, dec, d, plane, plane_type, tx_size, tctx, dctx):
        fc = self.fc
        txs_ctx = txb_mod.get_txsize_entropy_ctx(tx_size)
        all_zero = self._sym_r(dec, fc["txb_skip"][txs_ctx][tctx], 2)
        adj = txb_mod.adjusted_tx_size(tx_size)
        if plane == 0:
            self._eff_luma_tx = int(TxType.DCT_DCT)
        if all_zero:
            return np.zeros((int(TX_H[adj]), int(TX_W[adj])), np.int32), 0
        if plane == 0:
            d.tx_type = int(TxType.DCT_DCT)
            info = self._txtype_signal_info(tx_size, d.is_inter)
            if info is not None:
                set_type, eset, sqr, nsym = info
                if d.is_inter:
                    sym = self._sym_r(dec, fc["inter_ext_tx"][eset][sqr], nsym)
                else:
                    idir = int(FI_MODE_TO_DIR[d.filter_intra_mode]) if d.use_filter_intra else d.y_mode
                    sym = self._sym_r(dec, fc["intra_ext_tx"][eset][sqr][idir], nsym)
                d.tx_type = int(AV1_EXT_TX_INV[set_type][sym])
            self._eff_luma_tx = int(d.tx_type)
            tx_type = d.tx_type
        else:
            tx_type = self._chroma_tx_type(d, tx_size)
        return txb_mod.read_coeffs_txb_body(dec, fc, tx_size, tx_type, plane_type, dctx, self.update)

    def _set_block_ctx_zero(self, mi_row, mi_col, bsize):
        bw4, bh4 = int(BLOCK_W[bsize]) // 4, int(BLOCK_H[bsize]) // 4
        self.above_ctx[0][mi_col : mi_col + bw4] = 0
        self.left_ctx[0][mi_row : mi_row + bh4] = 0
        if not self._has_chroma(mi_row, mi_col, bsize):
            return
        for pl in (1, 2):
            self.above_ctx[pl][mi_col >> 1 : (mi_col >> 1) + max(bw4 >> 1, 1)] = 0
            self.left_ctx[pl][mi_row >> 1 : (mi_row >> 1) + max(bh4 >> 1, 1)] = 0

    # ------------------------------------------------------------------ recon

    def _filt_type(self, mi_row, mi_col, plane):
        """get_filt_type: 1 when the above or left neighbor block is a
        smooth intra mode (intra_prediction.c:128-144)."""
        smooth = (int(PredMode.SMOOTH_PRED), int(PredMode.SMOOTH_V_PRED),
                  int(PredMode.SMOOTH_H_PRED))
        grid = self.uv_mode_grid if plane else self.mode_grid

        def sm(r, c):
            return bool(self.mode_valid[r, c]) and int(grid[r, c]) in smooth

        ab = sm(mi_row - 1, mi_col) if mi_row > self.mi_row0 else False
        le = sm(mi_row, mi_col - 1) if mi_col > self.mi_col0 else False
        return 1 if (ab or le) else 0

    def _recon_intra_plane_txbs(self, d, mi_row, mi_col, bsize, plane, tx_size,
                                txbs):
        """Normative per-txb intra recon (TX_MODE_SELECT and/or intra edge
        filter): spec residual() -> predict_intra + reconstruct per txb in
        raster order. `txbs` = [(toff_y4, toff_x4, tx_type, levels|None)]."""
        p = self.p
        ss = 0 if plane == 0 else 1
        rec = self._recon[plane]
        bw4, bh4 = int(BLOCK_W[bsize]) // 4, int(BLOCK_H[bsize]) // 4
        pw4, ph4 = max(bw4 >> ss, 1), max(bh4 >> ss, 1)
        tw, th = int(TX_W[tx_size]), int(TX_H[tx_size])
        tw4, th4 = tw // 4, th // 4
        # plane-mi position (rounds sub-8x8 chroma to its covering 8x8 unit)
        cm_row, cm_col = mi_row >> ss, mi_col >> ss
        px0, py0 = cm_col * 4, cm_row * 4
        frame_w = (p.mi_cols * 4) >> ss
        frame_h = (p.mi_rows * 4) >> ss
        mode = d.y_mode if plane == 0 else d.uv_mode
        if plane > 0 and mode == UV_CFL_PRED:
            mode = int(PredMode.DC_PRED)
        delta = d.angle_delta_y if plane == 0 else d.angle_delta_uv
        filt_type = self._filt_type(mi_row, mi_col, plane)
        fi = d.filter_intra_mode if (plane == 0 and d.use_filter_intra) else None
        for (ty, tx, tx_type, lv2) in txbs:
            px, py = px0 + tx * 4, py0 + ty * 4
            have_top = ty > 0 or cm_row > (self.mi_row0 >> ss)
            have_left = tx > 0 or cm_col > (self.mi_col0 >> ss)
            xr = frame_w - (px + tw)
            yd = frame_h - (py + th)
            right_av = ((cm_col + tx + tw4) << ss) < self.mi_col1
            bottom_av = yd > 0 and ((cm_row + ty + th4) << ss) < self.mi_row1
            part = int(getattr(d, "_partition", 0))
            tr = intra_ops.intra_has_top_right(bsize, mi_row, mi_col, have_top,
                                               right_av, part, txw4=tw4,
                                               row_off=ty, col_off=tx, ss_x=ss)
            bl = intra_ops.intra_has_bottom_left(bsize, mi_row, mi_col, bottom_av,
                                                 have_left, part, txh4=th4,
                                                 row_off=ty, col_off=tx, ss_y=ss)
            n_top = min(tw, xr + tw) if have_top else 0
            n_tr = max(min(tw, xr), 0) if tr else 0
            n_left = min(th, yd + th) if have_left else 0
            n_bl = max(min(th, yd), 0) if bl else 0
            pred = intra_ops.predict_unit_normative(
                rec, px, py, tw, th, p.bd, int(mode), int(delta),
                n_top, n_tr, n_left, n_bl, filt_type,
                bool(p.enable_intra_edge_filter), fi_mode=fi)
            if plane > 0 and d.uv_mode == UV_CFL_PRED:
                alpha = d.cfl_alpha_u if plane == 1 else d.cfl_alpha_v
                pred = intra_ops.cfl_apply(pred, self._recon[0], px, py, tw, th,
                                           alpha, p.bd)
            if lv2 is None or not np.any(lv2):
                rec[py : py + th, px : px + tw] = pred
                continue
            full = np.zeros((min(th, 64), min(tw, 64)), np.int32)
            full[: lv2.shape[0], : lv2.shape[1]] = lv2
            dqc = quant_ops.dequantize_np(full, p.qindex, full.shape[1],
                                          full.shape[0], p.bd)
            rec[py : py + th, px : px + tw] = txfm_ops.inv_txfm2d_add_np(
                dqc[None], pred[None], int(tx_type), p.bd)[0]

    def _reconstruct(self, dec_levels, d, mi_row, mi_col, bsize):
        """Decoder-side prediction + dequant + inverse transform + recon."""
        p = self.p
        x, y = mi_col * 4, mi_row * 4
        bw, bh = int(BLOCK_W[bsize]), int(BLOCK_H[bsize])
        tx_size_y = d.tx_size_y if d.tx_size_y >= 0 else int(MAX_TXSIZE_RECT[bsize])
        tx_size_uv = int(max_uv_txsize(bsize))
        if (p.tx_mode == 1 or p.enable_intra_edge_filter) and not d.is_inter:
            # normative per-txb path (reference-encoded streams)
            for plane in range(3):
                if plane and not self._has_chroma(mi_row, mi_col, bsize):
                    continue
                tx_size = tx_size_y if plane == 0 else tx_size_uv
                if plane == 0:
                    if dec_levels is not None and isinstance(dec_levels.get(0), list):
                        txbs = dec_levels[0]
                    else:
                        lv = None if (d.skip or dec_levels is None) else dec_levels.get(0)
                        txbs = [(0, 0, int(d.tx_type), lv)]
                else:
                    lv = None if (d.skip or dec_levels is None) else dec_levels.get(plane)
                    txbs = [(0, 0, self._chroma_tx_type(d, tx_size), lv)]
                self._recon_intra_plane_txbs(d, mi_row, mi_col, bsize, plane,
                                             tx_size, txbs)
            return
        for plane in range(3):
            ss = 0 if plane == 0 else 1
            px, py = x >> ss, y >> ss
            pw, ph = bw >> ss, bh >> ss
            tx_size = tx_size_y if plane == 0 else tx_size_uv
            mode = d.y_mode if plane == 0 else d.uv_mode
            rec = self._recon[plane]
            if d.is_inter:
                refp = self.refs[d.ref_frame][plane]
                mvy, mvx = int(d.mv[0]), int(d.mv[1])
                if ss == 0:
                    mvy, mvx = mvy * 2, mvx * 2  # 1/8 luma pel -> 1/16 units
                if d.ref_frame1 >= int(RefFrame.LAST_FRAME):
                    # compound average: both refs at CONV_BUF precision
                    mvy1, mvx1 = int(d.mv1[0]), int(d.mv1[1])
                    if ss == 0:
                        mvy1, mvx1 = mvy1 * 2, mvx1 * 2
                    c0 = conv_ops.convolve_2d_scalar_compound(
                        refp, px, py, pw, ph, mvx, mvy, which=p.interp_filter, bd=p.bd)
                    c1 = conv_ops.convolve_2d_scalar_compound(
                        self.refs[d.ref_frame1][plane], px, py, pw, ph, mvx1, mvy1,
                        which=p.interp_filter, bd=p.bd)
                    pred = conv_ops.compound_average(c0, c1, p.bd).astype(np.int32)
                else:
                    pred = conv_ops.convolve_2d_scalar(refp, px, py, pw, ph, mvx, mvy,
                                                       which=p.interp_filter, bd=p.bd)
            elif plane == 0 and d.use_filter_intra:
                ha = py > ((self.mi_row0 * 4) >> ss)
                hl = px > ((self.mi_col0 * 4) >> ss)
                above, left, topleft = intra_ops.build_edges(rec, px, py, pw, ph, p.bd, ha, hl)
                pred = intra_ops.filter_intra_pred(above, left, int(topleft),
                                                   d.filter_intra_mode, pw, ph, p.bd)
            else:
                ha = py > ((self.mi_row0 * 4) >> ss)
                hl = px > ((self.mi_col0 * 4) >> ss)
                angle = 0
                if is_directional(mode):
                    delta = d.angle_delta_y if plane == 0 else d.angle_delta_uv
                    angle = intra_ops.MODE_ANGLE[mode] + delta * 3
                if angle and angle != 90 and angle != 180:
                    bw4, bh4 = int(BLOCK_W[bsize]) // 4, int(BLOCK_H[bsize]) // 4
                    right_av = (mi_col + bw4) < self.mi_col1
                    xr = ((p.mi_cols * 4 - (x + int(BLOCK_W[bsize]))) >> ss)
                    yd = ((p.mi_rows * 4 - (y + int(BLOCK_H[bsize]))) >> ss)
                    bottom_av = yd > 0 and (mi_row + bh4) < self.mi_row1
                    has_tr = intra_ops.intra_has_top_right(bsize, mi_row, mi_col, ha, right_av)
                    has_bl = intra_ops.intra_has_bottom_left(bsize, mi_row, mi_col, bottom_av, hl)
                    n_tr = min(pw, xr) if has_tr else 0
                    n_bl = min(ph, yd) if has_bl else 0
                    ae, le, topleft = intra_ops.build_edges_ext(rec, px, py, pw, ph, p.bd, ha, hl, n_tr, n_bl)
                    pred = intra_ops.dr_pred(ae[None], le[None], np.array([topleft]), angle, pw, ph)[0]
                else:
                    if angle:  # pure V/H (delta 0)
                        mode = int(PredMode.V_PRED) if angle == 90 else int(PredMode.H_PRED)
                    above, left, topleft = intra_ops.build_edges(rec, px, py, pw, ph, p.bd, ha, hl)
                    pred = intra_ops.predict(mode, above[None], left[None], np.array([topleft]), ha, hl, p.bd)[0]
            if d.skip or dec_levels is None:
                rec[py : py + ph, px : px + pw] = pred
                continue
            lv = dec_levels[plane]
            tx_type = d.tx_type if plane == 0 else self._chroma_tx_type(d, tx_size)
            # expand adjusted levels to full tx size
            full = np.zeros((min(ph, 64), min(pw, 64)), np.int32)
            full[: lv.shape[0], : lv.shape[1]] = lv
            dqc = quant_ops.dequantize_np(full, p.qindex, full.shape[1], full.shape[0], p.bd)
            recon = txfm_ops.inv_txfm2d_add_np(dqc[None], pred[None], tx_type, p.bd)[0]
            rec[py : py + ph, px : px + pw] = recon


# int-indexed partition subsize for the two partitions we emit
PARTITION_SUBSIZE_INT = {
    int(Partition.PARTITION_NONE): {int(b): int(b) for b in
                                    (BlockSize.BLOCK_8X8, BlockSize.BLOCK_16X16, BlockSize.BLOCK_32X32, BlockSize.BLOCK_64X64)},
    int(Partition.PARTITION_SPLIT): {int(BlockSize.BLOCK_16X16): int(BlockSize.BLOCK_8X8),
                                     int(BlockSize.BLOCK_32X32): int(BlockSize.BLOCK_16X16),
                                     int(BlockSize.BLOCK_64X64): int(BlockSize.BLOCK_32X32)},
}
