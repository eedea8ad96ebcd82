"""Transform-block coefficient coding (AV1 spec 5.11.39 / 8.3.2).

Symbol order and context derivation follow the spec; behavioral reference:
Source/Lib/Codec/entropy_coding.c:482 av1_write_coeffs_txb_1d,
common_utils.h:104 get_br_ctx, coefficients.h:2884 get_nz_mag /
get_nz_map_ctx_from_stats, C_DEFAULT/encode_txb_ref_c.c.

Provides both the encoder path (write_coeffs_txb) and the decoder path
(read_coeffs_txb) over the same context helpers, so encoder rate estimation,
bitstream writing, and the in-repo conformance decoder share one definition.
"""
from __future__ import annotations

import functools
import os

import numpy as np

from ..constants.av1 import (TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT, TX_H, TX_SIZE_SQR, TX_SIZE_SQR_UP, TX_TYPE_CLASS, TX_W,
                             TxSize)
from ..entropy.range_coder import RangeDecoder, RangeEncoder, update_cdf

_DATA = os.path.join(os.path.dirname(__file__), "..", "constants", "data")

NUM_BASE_LEVELS = 2
COEFF_BASE_RANGE = 12
BR_CDF_SIZE = 4
COEFF_CONTEXT_BITS = 6
COEFF_CONTEXT_MASK = 63

# eob class tables (spec; common_utils.h:23-24)
EOB_GROUP_START = np.array([0, 1, 2, 3, 5, 9, 17, 33, 65, 129, 257, 513], np.int32)
EOB_OFFSET_BITS = np.array([0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9], np.int32)

NZ_MAP_CTX_OFFSET_1D = np.array([0, 5] + [10] * 30, np.int32)

# adjusted tx size for coefficient coding (spec Adjusted_Tx_Size)
ADJUSTED_TX_SIZE = {
    TxSize.TX_64X64: TxSize.TX_32X32,
    TxSize.TX_32X64: TxSize.TX_32X32,
    TxSize.TX_64X32: TxSize.TX_32X32,
    TxSize.TX_16X64: TxSize.TX_16X32,
    TxSize.TX_64X16: TxSize.TX_32X16,
}


def adjusted_tx_size(tx_size: int) -> int:
    return int(ADJUSTED_TX_SIZE.get(TxSize(tx_size), TxSize(tx_size)))


@functools.lru_cache(maxsize=None)
def _scan_data() -> dict:
    with np.load(os.path.join(_DATA, "scans.npz")) as z:
        return {k: z[k].copy() for k in z.files}


@functools.lru_cache(maxsize=None)
def get_scan(tx_size: int, tx_type: int) -> np.ndarray:
    """Scan order (scan index -> raster pos in the adjusted txb)."""
    d = _scan_data()
    names = d["__order_names__"]  # (19*16, 2) of (scan, iscan) table names
    row = names[int(tx_size) * 16 + int(tx_type)]
    return d[str(row[0])]


@functools.lru_cache(maxsize=None)
def nz_map_ctx_offset_2d(tx_size: int) -> np.ndarray:
    """Base-level context offsets for TX_CLASS_2D, computed by the spec rule
    (generator documented at reference coefficients.h:2922-2932)."""
    adj = adjusted_tx_size(tx_size)
    w, h = int(TX_W[adj]), int(TX_H[adj])
    # the offset table is built for the *coding* tx size but indexed by
    # coefficient position in the adjusted block
    tw, th = int(TX_W[tx_size]), int(TX_H[tx_size])
    out = np.zeros((h, w), np.int32)
    for r in range(h):
        for c in range(w):
            if tw < th and r < 2:
                v = 11
            elif tw > th and c < 2:
                v = 16
            elif r + c < 2:
                v = 1
            elif r + c < 4:
                v = 6
            else:
                v = 21
            out[r, c] = v
    return out.reshape(-1)


def get_txsize_entropy_ctx(tx_size: int) -> int:
    return (int(TX_SIZE_SQR[tx_size]) + int(TX_SIZE_SQR_UP[tx_size]) + 1) >> 1


def get_eob_pos_token(eob: int) -> tuple[int, int]:
    """eob (1-based) -> (eob_pt, eob_extra)."""
    t = int(np.searchsorted(EOB_GROUP_START, eob, side="right")) - 1
    return t, eob - int(EOB_GROUP_START[t])


def eob_multi_size(tx_size: int) -> int:
    """log2(adjusted w*h) - 4 selecting the eob_flag cdf family."""
    adj = adjusted_tx_size(tx_size)
    area = int(TX_W[adj]) * int(TX_H[adj])
    return int(np.log2(area)) - 4


def _padded_levels(levels2d: np.ndarray) -> np.ndarray:
    """(h, w) abs levels -> zero-padded (h+4, w+4) uint8 buffer (clip 127)."""
    h, w = levels2d.shape
    buf = np.zeros((h + 4, w + 4), np.uint8)
    buf[:h, :w] = np.minimum(levels2d, 127).astype(np.uint8)
    return buf


def get_nz_mag(padded: np.ndarray, row: int, col: int, tx_class: int) -> int:
    c3 = lambda v: min(int(v), 3)
    mag = c3(padded[row, col + 1]) + c3(padded[row + 1, col])
    if tx_class == TX_CLASS_2D:
        mag += c3(padded[row + 1, col + 1]) + c3(padded[row, col + 2]) + c3(padded[row + 2, col])
    elif tx_class == TX_CLASS_VERT:
        mag += c3(padded[row + 2, col]) + c3(padded[row + 3, col]) + c3(padded[row + 4, col])
    else:
        mag += c3(padded[row, col + 2]) + c3(padded[row, col + 3]) + c3(padded[row, col + 4])
    return mag


def get_base_ctx(padded: np.ndarray, pos: int, bwl: int, tx_size: int, tx_class: int) -> int:
    if (tx_class | pos) == 0:
        return 0
    row, col = pos >> bwl, pos & ((1 << bwl) - 1)
    mag = get_nz_mag(padded, row, col, tx_class)
    ctx = min((mag + 1) >> 1, 4)
    if tx_class == TX_CLASS_2D:
        return ctx + int(nz_map_ctx_offset_2d(tx_size)[pos])
    if tx_class == TX_CLASS_HORIZ:
        return ctx + int(NZ_MAP_CTX_OFFSET_1D[col])
    return ctx + int(NZ_MAP_CTX_OFFSET_1D[row])


def get_base_eob_ctx(scan_idx: int, bwl: int, height: int) -> int:
    if scan_idx == 0:
        return 0
    if scan_idx <= (height << bwl) // 8:
        return 1
    if scan_idx <= (height << bwl) // 4:
        return 2
    return 3


def get_br_ctx(padded: np.ndarray, pos: int, bwl: int, tx_class: int) -> int:
    row, col = pos >> bwl, pos & ((1 << bwl) - 1)
    mag = int(padded[row, col + 1]) + int(padded[row + 1, col])
    if tx_class == TX_CLASS_2D:
        mag += int(padded[row + 1, col + 1])
    elif tx_class == TX_CLASS_VERT:
        mag += int(padded[row + 2, col])
    else:
        mag += int(padded[row, col + 2])
    mag = min((mag + 1) >> 1, 6)
    if pos == 0:
        return mag
    if tx_class == TX_CLASS_2D:
        if row < 2 and col < 2:
            return mag + 7
    elif tx_class == TX_CLASS_HORIZ:
        if col == 0:
            return mag + 7
    else:
        if row == 0:
            return mag + 7
    return mag + 14


def _write_golomb(enc: RangeEncoder, level: int) -> None:
    """Exp-Golomb, raw bits (reference entropy_coding.c write_golomb)."""
    x = level + 1
    length = x.bit_length()
    for _ in range(length - 1):
        enc.encode_bool_q15(0, 16384)
    for i in range(length - 1, -1, -1):
        enc.encode_bool_q15((x >> i) & 1, 16384)


def _read_golomb(dec: RangeDecoder) -> int:
    length = 0
    while dec.decode_bool_q15(16384) == 0:
        length += 1
        if length > 31:
            break
    x = 1
    for _ in range(length):
        x = (x << 1) | dec.decode_bool_q15(16384)
    return x - 1


def _eob_flag_cdf(fc, tx_size: int):
    return fc[f"eob_flag_{16 << eob_multi_size(tx_size)}"]


def write_coeffs_txb(enc: RangeEncoder, fc, coeffs: np.ndarray, tx_size: int, tx_type: int,
                     plane_type: int, txb_skip_ctx: int, dc_sign_ctx: int,
                     update: bool = True) -> int:
    """Write one full txb (txb_skip + body). `coeffs` is the (h, w) level
    array of the ADJUSTED tx size (64-dims already cropped to 32). Returns
    cul_level. Callers needing tx_type between txb_skip and the eob (spec
    order) write txb_skip themselves and call write_coeffs_txb_body."""
    txs_ctx = get_txsize_entropy_ctx(tx_size)
    eob_zero = not np.any(coeffs != 0)
    enc.encode_symbol_n(int(eob_zero), fc["txb_skip"][txs_ctx][txb_skip_ctx], 2)
    if update:
        update_cdf(fc["txb_skip"][txs_ctx][txb_skip_ctx], int(eob_zero), 2)
    if eob_zero:
        return 0
    return write_coeffs_txb_body(enc, fc, coeffs, tx_size, tx_type, plane_type, dc_sign_ctx, update)


def write_coeffs_txb_body(enc: RangeEncoder, fc, coeffs: np.ndarray, tx_size: int, tx_type: int,
                          plane_type: int, dc_sign_ctx: int, update: bool = True) -> int:
    """Everything after txb_skip (eob, levels, signs). Requires eob > 0."""
    if hasattr(enc, "write_txb_body"):  # native C fast path (byte-exact twin)
        adj = adjusted_tx_size(tx_size)
        tx_class = int(TX_TYPE_CLASS[tx_type])
        txs_ctx = get_txsize_entropy_ctx(tx_size)
        scan = get_scan(tx_size, tx_type)
        ems = eob_multi_size(tx_size)
        off2d = nz_map_ctx_offset_2d(tx_size) if tx_class == TX_CLASS_2D else None
        return enc.write_txb_body(
            coeffs, scan, tx_class, dc_sign_ctx, update,
            _eob_flag_cdf(fc, tx_size)[plane_type][0 if tx_class == TX_CLASS_2D else 1], ems + 5,
            fc["eob_extra"][txs_ctx][plane_type],
            fc["coeff_base_eob"][txs_ctx][plane_type],
            fc["coeff_base"][txs_ctx][plane_type],
            fc["coeff_br"][min(txs_ctx, int(TxSize.TX_32X32))][plane_type],
            fc["dc_sign"][plane_type][dc_sign_ctx], off2d)
    adj = adjusted_tx_size(tx_size)
    h, w = int(TX_H[adj]), int(TX_W[adj])
    assert coeffs.shape == (h, w), (coeffs.shape, h, w)
    bwl = int(np.log2(w))
    tx_class = int(TX_TYPE_CLASS[tx_type])
    txs_ctx = get_txsize_entropy_ctx(tx_size)
    scan = get_scan(tx_size, tx_type)
    flat = coeffs.reshape(-1)
    scanned = flat[scan]
    nz = np.nonzero(scanned)[0]
    eob = int(nz[-1]) + 1 if nz.size else 0
    assert eob > 0

    def sym(cdf, s, n):
        enc.encode_symbol_n(s, cdf, n)
        if update:
            update_cdf(cdf, s, n)

    levels = np.abs(flat.reshape(h, w))
    padded = _padded_levels(levels)

    eob_pt, eob_extra = get_eob_pos_token(eob)
    eob_multi_ctx = 0 if tx_class == TX_CLASS_2D else 1
    ecdf = _eob_flag_cdf(fc, tx_size)[plane_type][eob_multi_ctx]
    sym(ecdf, eob_pt - 1, eob_multi_size(tx_size) + 5)

    offset_bits = int(EOB_OFFSET_BITS[eob_pt])
    if offset_bits > 0:
        bit = (eob_extra >> (offset_bits - 1)) & 1
        sym(fc["eob_extra"][txs_ctx][plane_type][eob_pt], bit, 2)
        for i in range(1, offset_bits):
            enc.encode_bool_q15((eob_extra >> (offset_bits - 1 - i)) & 1, 16384)

    for c in range(eob - 1, -1, -1):
        pos = int(scan[c])
        level = int(levels.reshape(-1)[pos])
        if c == eob - 1:
            ctx = get_base_eob_ctx(c, bwl, h)
            sym(fc["coeff_base_eob"][txs_ctx][plane_type][ctx], min(level, 3) - 1, 3)
        else:
            ctx = get_base_ctx(padded, pos, bwl, tx_size, tx_class)
            sym(fc["coeff_base"][txs_ctx][plane_type][ctx], min(level, 3), 4)
        if level > NUM_BASE_LEVELS:
            base_range = level - 1 - NUM_BASE_LEVELS
            br_ctx = get_br_ctx(padded, pos, bwl, tx_class)
            brcdf = fc["coeff_br"][min(txs_ctx, int(TxSize.TX_32X32))][plane_type][br_ctx]
            for idx in range(0, COEFF_BASE_RANGE, BR_CDF_SIZE - 1):
                k = min(base_range - idx, BR_CDF_SIZE - 1)
                sym(brcdf, k, BR_CDF_SIZE)
                if k < BR_CDF_SIZE - 1:
                    break

    # signs + golomb remainders, forward scan
    cul_level = 0
    for c in range(eob):
        pos = int(scan[c])
        v = int(flat[pos])
        level = abs(v)
        cul_level += level
        if level:
            sign = 1 if v < 0 else 0
            if c == 0:
                sym(fc["dc_sign"][plane_type][dc_sign_ctx], sign, 2)
            else:
                enc.encode_bool_q15(sign, 16384)
            if level > COEFF_BASE_RANGE + NUM_BASE_LEVELS:
                _write_golomb(enc, level - COEFF_BASE_RANGE - 1 - NUM_BASE_LEVELS)

    cul_level = min(COEFF_CONTEXT_MASK, cul_level)
    dc = int(flat[0])
    if dc < 0:
        cul_level |= 1 << COEFF_CONTEXT_BITS
    elif dc > 0:
        cul_level += 2 << COEFF_CONTEXT_BITS
    return cul_level


def read_coeffs_txb(dec: RangeDecoder, fc, tx_size: int, tx_type: int, plane_type: int,
                    txb_skip_ctx: int, dc_sign_ctx: int, update: bool = True) -> tuple[np.ndarray, int]:
    """Decode one full txb -> ((h, w) levels of adjusted size, cul_level)."""
    adj = adjusted_tx_size(tx_size)
    h, w = int(TX_H[adj]), int(TX_W[adj])
    txs_ctx = get_txsize_entropy_ctx(tx_size)
    cdf = fc["txb_skip"][txs_ctx][txb_skip_ctx]
    all_zero = dec.decode_symbol_n(cdf, 2)
    if update:
        update_cdf(cdf, all_zero, 2)
    if all_zero:
        return np.zeros((h, w), np.int32), 0
    return read_coeffs_txb_body(dec, fc, tx_size, tx_type, plane_type, dc_sign_ctx, update)


def read_coeffs_txb_body(dec: RangeDecoder, fc, tx_size: int, tx_type: int, plane_type: int,
                         dc_sign_ctx: int, update: bool = True) -> tuple[np.ndarray, int]:
    """Decode a txb body (after a txb_skip==0). Returns (levels, cul_level)."""
    adj = adjusted_tx_size(tx_size)
    h, w = int(TX_H[adj]), int(TX_W[adj])
    bwl = int(np.log2(w))
    tx_class = int(TX_TYPE_CLASS[tx_type])
    txs_ctx = get_txsize_entropy_ctx(tx_size)
    scan = get_scan(tx_size, tx_type)
    out = np.zeros((h, w), np.int32)

    def sym(cdf, n):
        s = dec.decode_symbol_n(cdf, n)
        if update:
            update_cdf(cdf, s, n)
        return s

    eob_multi_ctx = 0 if tx_class == TX_CLASS_2D else 1
    eob_pt = sym(_eob_flag_cdf(fc, tx_size)[plane_type][eob_multi_ctx], eob_multi_size(tx_size) + 5) + 1
    eob = int(EOB_GROUP_START[eob_pt])
    offset_bits = int(EOB_OFFSET_BITS[eob_pt])
    if offset_bits > 0:
        extra = sym(fc["eob_extra"][txs_ctx][plane_type][eob_pt], 2) << (offset_bits - 1)
        for i in range(1, offset_bits):
            extra |= dec.decode_bool_q15(16384) << (offset_bits - 1 - i)
        eob += extra

    levels = np.zeros((h, w), np.int32)
    padded = np.zeros((h + 4, w + 4), np.uint8)
    flatlev = levels.reshape(-1)
    for c in range(eob - 1, -1, -1):
        pos = int(scan[c])
        if c == eob - 1:
            ctx = get_base_eob_ctx(c, bwl, h)
            level = sym(fc["coeff_base_eob"][txs_ctx][plane_type][ctx], 3) + 1
        else:
            ctx = get_base_ctx(padded, pos, bwl, tx_size, tx_class)
            level = sym(fc["coeff_base"][txs_ctx][plane_type][ctx], 4)
        if level > NUM_BASE_LEVELS:
            br_ctx = get_br_ctx(padded, pos, bwl, tx_class)
            brcdf = fc["coeff_br"][min(txs_ctx, int(TxSize.TX_32X32))][plane_type][br_ctx]
            for idx in range(0, COEFF_BASE_RANGE, BR_CDF_SIZE - 1):
                k = sym(brcdf, BR_CDF_SIZE)
                level += k
                if k < BR_CDF_SIZE - 1:
                    break
        flatlev[pos] = level
        padded[pos >> bwl, (pos & ((1 << bwl) - 1))] = min(level, 127)

    cul_level = 0
    flat = out.reshape(-1)
    for c in range(eob):
        pos = int(scan[c])
        level = int(flatlev[pos])
        if level:
            if c == 0:
                sign = sym(fc["dc_sign"][plane_type][dc_sign_ctx], 2)
            else:
                sign = dec.decode_bool_q15(16384)
            if level > COEFF_BASE_RANGE + NUM_BASE_LEVELS:
                level += _read_golomb(dec)
            cul_level += level
            flat[pos] = -level if sign else level
    cul_level = min(COEFF_CONTEXT_MASK, cul_level)
    dc = int(flat[0])
    if dc < 0:
        cul_level |= 1 << COEFF_CONTEXT_BITS
    elif dc > 0:
        cul_level += 2 << COEFF_CONTEXT_BITS
    return out, cul_level
