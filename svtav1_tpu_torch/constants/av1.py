"""AV1 normative enumerations and block geometry.

These mirror the AV1 specification (and hence the reference encoder's
Source/API/EbSvtAv1Enc.h + Source/Lib/Codec/block_structures.h), but are
re-derived from the spec: sizes, transform sizes/types, prediction modes.
"""
from __future__ import annotations

import enum

import numpy as np

# ---------------------------------------------------------------------------
# Block sizes (spec 6.10.4). Order is normative (used by CDF context tables).
# ---------------------------------------------------------------------------


class BlockSize(enum.IntEnum):
    BLOCK_4X4 = 0
    BLOCK_4X8 = 1
    BLOCK_8X4 = 2
    BLOCK_8X8 = 3
    BLOCK_8X16 = 4
    BLOCK_16X8 = 5
    BLOCK_16X16 = 6
    BLOCK_16X32 = 7
    BLOCK_32X16 = 8
    BLOCK_32X32 = 9
    BLOCK_32X64 = 10
    BLOCK_64X32 = 11
    BLOCK_64X64 = 12
    BLOCK_64X128 = 13
    BLOCK_128X64 = 14
    BLOCK_128X128 = 15
    BLOCK_4X16 = 16
    BLOCK_16X4 = 17
    BLOCK_8X32 = 18
    BLOCK_32X8 = 19
    BLOCK_16X64 = 20
    BLOCK_64X16 = 21


BLOCK_SIZES_ALL = 22

# width / height in pixels per BlockSize
BLOCK_W = np.array([4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 32, 64, 64, 64, 128, 128, 4, 16, 8, 32, 16, 64], np.int32)
BLOCK_H = np.array([4, 8, 4, 8, 16, 8, 16, 32, 16, 32, 64, 32, 64, 128, 64, 128, 16, 4, 32, 8, 64, 16], np.int32)


# ---------------------------------------------------------------------------
# Transform sizes (spec 6.10.17) — order normative.
# ---------------------------------------------------------------------------


class TxSize(enum.IntEnum):
    TX_4X4 = 0
    TX_8X8 = 1
    TX_16X16 = 2
    TX_32X32 = 3
    TX_64X64 = 4
    TX_4X8 = 5
    TX_8X4 = 6
    TX_8X16 = 7
    TX_16X8 = 8
    TX_16X32 = 9
    TX_32X16 = 10
    TX_32X64 = 11
    TX_64X32 = 12
    TX_4X16 = 13
    TX_16X4 = 14
    TX_8X32 = 15
    TX_32X8 = 16
    TX_16X64 = 17
    TX_64X16 = 18


TX_SIZES_ALL = 19
TX_SIZES = 5  # square only

TX_W = np.array([4, 8, 16, 32, 64, 4, 8, 8, 16, 16, 32, 32, 64, 4, 16, 8, 32, 16, 64], np.int32)
TX_H = np.array([4, 8, 16, 32, 64, 8, 4, 16, 8, 32, 16, 64, 32, 16, 4, 32, 8, 64, 16], np.int32)

# tx_size -> square tx size class used by coeff CDF indexing (spec get_txsize_entropy_ctx:
# min(mi_size wide/high classes)): txsize_sqr_up_map clamped to TX_32X32 for CDFs.
TX_SIZE_SQR = np.array([0, 1, 2, 3, 4, 0, 0, 1, 1, 2, 2, 3, 3, 0, 0, 1, 1, 2, 2], np.int32)
TX_SIZE_SQR_UP = np.array([0, 1, 2, 3, 4, 1, 1, 2, 2, 3, 3, 4, 4, 2, 2, 3, 3, 4, 4], np.int32)


class TxType(enum.IntEnum):
    DCT_DCT = 0
    ADST_DCT = 1
    DCT_ADST = 2
    ADST_ADST = 3
    FLIPADST_DCT = 4
    DCT_FLIPADST = 5
    FLIPADST_FLIPADST = 6
    ADST_FLIPADST = 7
    FLIPADST_ADST = 8
    IDTX = 9
    V_DCT = 10
    H_DCT = 11
    V_ADST = 12
    H_ADST = 13
    V_FLIPADST = 14
    H_FLIPADST = 15


TX_TYPES = 16

# 1-D transform kinds per 2-D type: (vertical, horizontal)
class Tx1D(enum.IntEnum):
    DCT = 0
    ADST = 1
    FLIPADST = 2
    IDT = 3


TX_TYPE_1D = {
    TxType.DCT_DCT: (Tx1D.DCT, Tx1D.DCT),
    TxType.ADST_DCT: (Tx1D.ADST, Tx1D.DCT),
    TxType.DCT_ADST: (Tx1D.DCT, Tx1D.ADST),
    TxType.ADST_ADST: (Tx1D.ADST, Tx1D.ADST),
    TxType.FLIPADST_DCT: (Tx1D.FLIPADST, Tx1D.DCT),
    TxType.DCT_FLIPADST: (Tx1D.DCT, Tx1D.FLIPADST),
    TxType.FLIPADST_FLIPADST: (Tx1D.FLIPADST, Tx1D.FLIPADST),
    TxType.ADST_FLIPADST: (Tx1D.ADST, Tx1D.FLIPADST),
    TxType.FLIPADST_ADST: (Tx1D.FLIPADST, Tx1D.ADST),
    TxType.IDTX: (Tx1D.IDT, Tx1D.IDT),
    TxType.V_DCT: (Tx1D.DCT, Tx1D.IDT),
    TxType.H_DCT: (Tx1D.IDT, Tx1D.DCT),
    TxType.V_ADST: (Tx1D.ADST, Tx1D.IDT),
    TxType.H_ADST: (Tx1D.IDT, Tx1D.ADST),
    TxType.V_FLIPADST: (Tx1D.FLIPADST, Tx1D.IDT),
    TxType.H_FLIPADST: (Tx1D.IDT, Tx1D.FLIPADST),
}

# TX classes for coeff coding contexts (spec tx_type -> TX_CLASS)
TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT = 0, 1, 2
TX_TYPE_CLASS = np.array(
    [TX_CLASS_2D] * 10 + [TX_CLASS_VERT, TX_CLASS_HORIZ, TX_CLASS_VERT, TX_CLASS_HORIZ, TX_CLASS_VERT, TX_CLASS_HORIZ],
    np.int32,
)


# ---------------------------------------------------------------------------
# Prediction modes (spec 6.10.18)
# ---------------------------------------------------------------------------


class PredMode(enum.IntEnum):
    DC_PRED = 0
    V_PRED = 1
    H_PRED = 2
    D45_PRED = 3
    D135_PRED = 4
    D113_PRED = 5
    D157_PRED = 6
    D203_PRED = 7
    D67_PRED = 8
    SMOOTH_PRED = 9
    SMOOTH_V_PRED = 10
    SMOOTH_H_PRED = 11
    PAETH_PRED = 12


INTRA_MODES = 13


class InterMode(enum.IntEnum):
    """Inter Y modes continue the PredMode numbering (spec 6.10.18)."""

    NEARESTMV = 13
    NEARMV = 14
    GLOBALMV = 15
    NEWMV = 16
    NEAREST_NEARESTMV = 17
    NEAR_NEARMV = 18
    NEAREST_NEWMV = 19
    NEW_NEARESTMV = 20
    NEAR_NEWMV = 21
    NEW_NEARMV = 22
    GLOBAL_GLOBALMV = 23
    NEW_NEWMV = 24


def has_newmv(mode: int) -> bool:
    """Modes that carry a NEWMV component (svt_aom_have_newmv_in_inter_mode)."""
    M = InterMode
    return mode in (M.NEWMV, M.NEW_NEWMV, M.NEAREST_NEWMV, M.NEW_NEARESTMV, M.NEAR_NEWMV, M.NEW_NEARMV)


def is_inter_mode(mode: int) -> bool:
    return mode >= int(InterMode.NEARESTMV)


class RefFrame(enum.IntEnum):
    NONE = -1
    INTRA_FRAME = 0
    LAST_FRAME = 1
    LAST2_FRAME = 2
    LAST3_FRAME = 3
    GOLDEN_FRAME = 4
    BWDREF_FRAME = 5
    ALTREF2_FRAME = 6
    ALTREF_FRAME = 7


FWD_REFS = (RefFrame.LAST_FRAME, RefFrame.LAST2_FRAME, RefFrame.LAST3_FRAME, RefFrame.GOLDEN_FRAME)
BWD_REFS = (RefFrame.BWDREF_FRAME, RefFrame.ALTREF2_FRAME, RefFrame.ALTREF_FRAME)


class MvJoint(enum.IntEnum):
    ZERO = 0
    HNZVZ = 1  # col != 0, row == 0
    HZVNZ = 2  # row != 0, col == 0
    HNZVNZ = 3


# block size -> intra y-mode cdf group (spec Size_Group)
SIZE_GROUP = np.array([0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 1, 1, 2, 2, 3, 3], np.int32)
UV_INTRA_MODES_CFL_NOT_ALLOWED = 13
UV_INTRA_MODES_CFL_ALLOWED = 14  # + UV_CFL_PRED
UV_CFL_PRED = 13

DIRECTIONAL_MODES = (
    PredMode.V_PRED,
    PredMode.H_PRED,
    PredMode.D45_PRED,
    PredMode.D135_PRED,
    PredMode.D113_PRED,
    PredMode.D157_PRED,
    PredMode.D203_PRED,
    PredMode.D67_PRED,
)

# base angles for directional modes (spec 8.,  mode -> angle in degrees)
MODE_TO_ANGLE = {
    PredMode.V_PRED: 90,
    PredMode.H_PRED: 180,
    PredMode.D45_PRED: 45,
    PredMode.D135_PRED: 135,
    PredMode.D113_PRED: 113,
    PredMode.D157_PRED: 157,
    PredMode.D203_PRED: 203,
    PredMode.D67_PRED: 67,
}


# ---------------------------------------------------------------------------
# Partitions (spec 6.10.4)
# ---------------------------------------------------------------------------


class Partition(enum.IntEnum):
    PARTITION_NONE = 0
    PARTITION_HORZ = 1
    PARTITION_VERT = 2
    PARTITION_SPLIT = 3
    PARTITION_HORZ_A = 4
    PARTITION_HORZ_B = 5
    PARTITION_VERT_A = 6
    PARTITION_VERT_B = 7
    PARTITION_HORZ_4 = 8
    PARTITION_VERT_4 = 9


EXT_PARTITION_TYPES = 10

# Subsize table: partition_subsize[partition][bsize] for square bsize (spec 5.11.4 Partition_Subsize)
# Only square parents can be partitioned. -1 = invalid.
_B = BlockSize
PARTITION_SUBSIZE = {
    Partition.PARTITION_NONE: {_B.BLOCK_8X8: _B.BLOCK_8X8, _B.BLOCK_16X16: _B.BLOCK_16X16,
                               _B.BLOCK_32X32: _B.BLOCK_32X32, _B.BLOCK_64X64: _B.BLOCK_64X64,
                               _B.BLOCK_128X128: _B.BLOCK_128X128, _B.BLOCK_4X4: _B.BLOCK_4X4},
    Partition.PARTITION_SPLIT: {_B.BLOCK_8X8: _B.BLOCK_4X4, _B.BLOCK_16X16: _B.BLOCK_8X8,
                                _B.BLOCK_32X32: _B.BLOCK_16X16, _B.BLOCK_64X64: _B.BLOCK_32X32,
                                _B.BLOCK_128X128: _B.BLOCK_64X64},
    Partition.PARTITION_HORZ: {_B.BLOCK_8X8: _B.BLOCK_8X4, _B.BLOCK_16X16: _B.BLOCK_16X8,
                               _B.BLOCK_32X32: _B.BLOCK_32X16, _B.BLOCK_64X64: _B.BLOCK_64X32,
                               _B.BLOCK_128X128: _B.BLOCK_128X64},
    Partition.PARTITION_VERT: {_B.BLOCK_8X8: _B.BLOCK_4X8, _B.BLOCK_16X16: _B.BLOCK_8X16,
                               _B.BLOCK_32X32: _B.BLOCK_16X32, _B.BLOCK_64X64: _B.BLOCK_32X64,
                               _B.BLOCK_128X128: _B.BLOCK_64X128},
}

# max square tx size for a block size (tx_mode TX_MODE_LARGEST), capped at 64
def max_txsize_lookup(bsize: int) -> int:
    w, h = int(BLOCK_W[bsize]), int(BLOCK_H[bsize])
    s = min(min(w, h), 64)
    return {4: TxSize.TX_4X4, 8: TxSize.TX_8X8, 16: TxSize.TX_16X16, 32: TxSize.TX_32X32, 64: TxSize.TX_64X64}[s]


# Full max_txsize_rect lookup (largest rect tx fitting the block, spec Max_Tx_Size_Rect)
MAX_TXSIZE_RECT = np.array(
    [
        TxSize.TX_4X4, TxSize.TX_4X8, TxSize.TX_8X4, TxSize.TX_8X8, TxSize.TX_8X16, TxSize.TX_16X8,
        TxSize.TX_16X16, TxSize.TX_16X32, TxSize.TX_32X16, TxSize.TX_32X32, TxSize.TX_32X64,
        TxSize.TX_64X32, TxSize.TX_64X64, TxSize.TX_64X64, TxSize.TX_64X64, TxSize.TX_64X64,
        TxSize.TX_4X16, TxSize.TX_16X4, TxSize.TX_8X32, TxSize.TX_32X8, TxSize.TX_16X64, TxSize.TX_64X16,
    ],
    np.int32,
)


# ---------------------------------------------------------------------------
# Frame / OBU level enums
# ---------------------------------------------------------------------------


class FrameType(enum.IntEnum):
    KEY_FRAME = 0
    INTER_FRAME = 1
    INTRA_ONLY_FRAME = 2
    SWITCH_FRAME = 3


class ObuType(enum.IntEnum):
    OBU_SEQUENCE_HEADER = 1
    OBU_TEMPORAL_DELIMITER = 2
    OBU_FRAME_HEADER = 3
    OBU_TILE_GROUP = 4
    OBU_METADATA = 5
    OBU_FRAME = 6
    OBU_REDUNDANT_FRAME_HEADER = 7
    OBU_TILE_LIST = 8
    OBU_PADDING = 15


MI_SIZE = 4  # mode-info unit in pixels
SB_SIZE_64 = 64
MAX_TILE_COLS = 64
MAX_TILE_ROWS = 64

NUM_REF_FRAMES = 8
REFS_PER_FRAME = 7
PRIMARY_REF_NONE = 7

# Quantizer
QINDEX_RANGE = 256
MINQ = 0
MAXQ = 255
