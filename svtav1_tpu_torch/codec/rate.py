"""Rate estimation: exact CDF-based bit costs for mode decision.

Instead of the reference's precomputed per-symbol LUTs
(md_rate_estimation.c svt_aom_estimate_coefficients_rate), we run the real
symbol writers against a `BitCounter` — a duck-typed range-coder stand-in
that accumulates -log2(p) per symbol. This reuses write_coeffs_txb_body /
MvCoder verbatim, so estimated bits track the true coder by construction
(up to CDF adaptation drift, which MD ignores just like the reference's
per-SB snapshot approximation, enc_dec_process.c:3330).
"""
from __future__ import annotations

import numpy as np

from ..constants.av1 import TX_H, TX_W
from . import txb as txb_mod

# cost in bits for a symbol of probability p/32768, p = 1..32768
_COST = np.zeros(32769, np.float32)
_COST[1:] = -np.log2(np.arange(1, 32769, dtype=np.float64) / 32768.0)


EC_PROB_SHIFT = 6
EC_MIN_PROB = 4


class BitCounter:
    """Range-coder stand-in: accumulates information content in bits using
    the od_ec coder's EFFECTIVE probabilities (probabilities are used at
    reduced precision with a per-symbol minimum slice — entropy computed
    from the nominal CDF underestimates real cost by ~5%)."""

    __slots__ = ("bits",)

    def __init__(self) -> None:
        self.bits = 0.0

    def encode_symbol_n(self, symbol: int, icdf, nsyms: int) -> None:
        N = nsyms - 1
        fh = int(icdf[symbol]) if symbol < N else 0
        if symbol > 0:
            fl = int(icdf[symbol - 1])
            p = (((fl >> EC_PROB_SHIFT) - (fh >> EC_PROB_SHIFT)) << EC_PROB_SHIFT) + EC_MIN_PROB
        else:
            p = 32768 - ((fh >> EC_PROB_SHIFT) << EC_PROB_SHIFT) - EC_MIN_PROB * N
        self.bits += float(_COST[min(max(p, 1), 32768)])

    def encode_bool_q15(self, bit: int, f: int) -> None:
        if bit:
            p = ((f >> EC_PROB_SHIFT) << EC_PROB_SHIFT) + EC_MIN_PROB
        else:
            p = 32768 - ((f >> EC_PROB_SHIFT) << EC_PROB_SHIFT) - EC_MIN_PROB
        self.bits += float(_COST[min(max(p, 1), 32768)])


def txb_bits_exact(fc, levels: np.ndarray, tx_size: int, tx_type: int, plane_type: int,
                   txb_skip_ctx: int = 0, dc_sign_ctx: int = 0) -> float:
    """Reference path: run the real txb writer against a BitCounter."""
    bc = BitCounter()
    txs_ctx = txb_mod.get_txsize_entropy_ctx(tx_size)
    eob_zero = not np.any(levels != 0)
    bc.encode_symbol_n(int(eob_zero), fc["txb_skip"][txs_ctx][txb_skip_ctx], 2)
    if not eob_zero:
        adj = txb_mod.adjusted_tx_size(tx_size)
        lv = levels[: int(TX_H[adj]), : int(TX_W[adj])]
        txb_mod.write_coeffs_txb_body(bc, fc, np.ascontiguousarray(lv), tx_size, tx_type,
                                      plane_type, dc_sign_ctx, update=False)
    return bc.bits


def cdf_cost_table(icdf: np.ndarray, nsyms: int) -> np.ndarray:
    """(..., >=nsyms) ICDF arrays -> (..., nsyms) per-symbol cost in bits,
    using the coder's effective probabilities (see BitCounter)."""
    icdf = np.asarray(icdf, np.int64)[..., :nsyms]
    fh_r = (icdf >> EC_PROB_SHIFT) << EC_PROB_SHIFT
    fl_r = np.concatenate([np.full(icdf.shape[:-1] + (1,), 32768, np.int64), fh_r[..., :-1]], axis=-1)
    N = nsyms - 1
    p = fl_r - fh_r + EC_MIN_PROB
    p0 = 32768 - fh_r[..., 0] - EC_MIN_PROB * N
    p = np.concatenate([p0[..., None], p[..., 1:]], axis=-1)
    return _COST[np.clip(p, 1, 32768)]


# lazily-built per-FrameContext LUTs, keyed by id(fc) (frames are short-lived)
_LUT_CACHE: dict = {}


def _luts(fc):
    key = id(fc)
    lut = _LUT_CACHE.get(key)
    if lut is not None and lut["fc"] is fc:
        return lut
    lut = {"fc": fc}
    lut["base"] = cdf_cost_table(fc["coeff_base"], 4)  # (txs, pt, 42, 4)
    lut["base_eob"] = cdf_cost_table(fc["coeff_base_eob"], 3)
    br = cdf_cost_table(fc["coeff_br"], 4)  # (txs, pt, 21, 4)
    # cumulative cost of the br round loop for base_range = 0..12
    br_total = np.zeros(br.shape[:-1] + (13,), np.float32)
    for r in range(13):
        cost = np.zeros(br.shape[:-1], np.float32)
        rem = r
        for _ in range(4):
            k = min(rem, 3)
            cost += br[..., k]
            if k < 3:
                break
            rem -= 3
            if rem < 0:
                break
        br_total[..., r] = cost
    # base_range == 12 ends the loop after 4 full symbols (no terminator)
    lut["br"] = br_total
    lut["txb_skip"] = cdf_cost_table(fc["txb_skip"], 2)
    lut["dc_sign"] = cdf_cost_table(fc["dc_sign"], 2)
    lut["eob_extra"] = cdf_cost_table(fc["eob_extra"], 2)
    lut["eob_flags"] = {n: cdf_cost_table(fc[f"eob_flag_{n}"], int(np.log2(n)) + 1)
                        for n in (16, 32, 64, 128, 256, 512, 1024)}
    _LUT_CACHE.clear()  # keep a single entry: frames are processed one at a time
    _LUT_CACHE[key] = lut
    return lut


def _base_ctx_map(levels: np.ndarray, tx_size: int, tx_class: int) -> np.ndarray:
    """Vectorized get_base_ctx over all positions -> (h*w,) int."""
    h, w = levels.shape
    P = np.zeros((h + 4, w + 4), np.int32)
    P[:h, :w] = np.minimum(levels, 127)
    M = np.minimum(P, 3)
    mag = M[0:h, 1 : w + 1] + M[1 : h + 1, 0:w]
    if tx_class == txb_mod.TX_CLASS_2D:
        mag = mag + M[1 : h + 1, 1 : w + 1] + M[0:h, 2 : w + 2] + M[2 : h + 2, 0:w]
    elif tx_class == txb_mod.TX_CLASS_VERT:
        mag = mag + M[2 : h + 2, 0:w] + M[3 : h + 3, 0:w] + M[4 : h + 4, 0:w]
    else:
        mag = mag + M[0:h, 2 : w + 2] + M[0:h, 3 : w + 3] + M[0:h, 4 : w + 4]
    ctx = np.minimum((mag + 1) >> 1, 4)
    if tx_class == txb_mod.TX_CLASS_2D:
        ctx = ctx.reshape(-1) + txb_mod.nz_map_ctx_offset_2d(tx_size)
        ctx[0] = 0
        return ctx
    if tx_class == txb_mod.TX_CLASS_HORIZ:
        off = txb_mod.NZ_MAP_CTX_OFFSET_1D[np.arange(w)][None, :]
    else:
        off = txb_mod.NZ_MAP_CTX_OFFSET_1D[np.arange(h)][:, None]
    return (ctx + off).reshape(-1)


def _br_ctx_map(levels: np.ndarray, tx_class: int) -> np.ndarray:
    """Vectorized get_br_ctx over all positions -> (h*w,) int."""
    h, w = levels.shape
    P = np.zeros((h + 4, w + 4), np.int32)
    P[:h, :w] = np.minimum(levels, 127)
    mag = P[0:h, 1 : w + 1] + P[1 : h + 1, 0:w]
    if tx_class == txb_mod.TX_CLASS_2D:
        mag = mag + P[1 : h + 1, 1 : w + 1]
    elif tx_class == txb_mod.TX_CLASS_VERT:
        mag = mag + P[2 : h + 2, 0:w]
    else:
        mag = mag + P[0:h, 2 : w + 2]
    mag = np.minimum((mag + 1) >> 1, 6)
    rows = np.arange(h)[:, None]
    cols = np.arange(w)[None, :]
    if tx_class == txb_mod.TX_CLASS_2D:
        grp = np.where((rows < 2) & (cols < 2), 7, 14)
    elif tx_class == txb_mod.TX_CLASS_HORIZ:
        grp = np.where(cols == 0, 7, 14) + np.zeros((h, w), np.int32)
    else:
        grp = np.where(rows == 0, 7, 14) + np.zeros((h, w), np.int32)
    ctx = mag + grp
    ctx = ctx.reshape(-1)
    ctx[0] = int(mag.reshape(-1)[0])  # pos 0: no group offset
    return ctx


def txb_bits(fc, levels: np.ndarray, tx_size: int, tx_type: int, plane_type: int,
             txb_skip_ctx: int = 0, dc_sign_ctx: int = 0) -> float:
    """Vectorized bit estimate for one transform block — the batched analog
    of the reference's encodetxb level/context-map kernels
    (ASM_AVX2/encodetxb_avx2.c) + md_rate_estimation LUTs."""
    from ..constants.av1 import TX_TYPE_CLASS, TxSize

    lut = _luts(fc)
    txs_ctx = txb_mod.get_txsize_entropy_ctx(tx_size)
    adj = txb_mod.adjusted_tx_size(tx_size)
    h, w = int(TX_H[adj]), int(TX_W[adj])
    lv = np.asarray(levels[:h, :w])
    flat = lv.reshape(-1)
    scan = txb_mod.get_scan(tx_size, tx_type)
    scanned = flat[scan]
    nzi = np.nonzero(scanned)[0]
    if nzi.size == 0:
        return float(lut["txb_skip"][txs_ctx, txb_skip_ctx, 1])
    eob = int(nzi[-1]) + 1
    bits = float(lut["txb_skip"][txs_ctx, txb_skip_ctx, 0])

    tx_class = int(TX_TYPE_CLASS[tx_type])
    absl = np.abs(lv)
    bwl = int(np.log2(w))

    # eob token + extra bits
    eob_pt, eob_extra = txb_mod.get_eob_pos_token(eob)
    emc = 0 if tx_class == txb_mod.TX_CLASS_2D else 1
    n = 16 << txb_mod.eob_multi_size(tx_size)
    bits += float(lut["eob_flags"][n][plane_type, emc, eob_pt - 1])
    offset_bits = int(txb_mod.EOB_OFFSET_BITS[eob_pt])
    if offset_bits > 0:
        bit = (eob_extra >> (offset_bits - 1)) & 1
        bits += float(lut["eob_extra"][txs_ctx, plane_type, eob_pt, bit])
        bits += offset_bits - 1  # raw bits

    # base symbols: positions scan[0..eob-2] use ctx map; scan[eob-1] base_eob
    lv_scan = np.abs(scanned[:eob]).astype(np.int64)
    syms = np.minimum(lv_scan, 3)
    if eob > 1:
        ctx_map = _base_ctx_map(absl, tx_size, tx_class)
        ctxs = ctx_map[scan[: eob - 1]]
        bits += float(lut["base"][txs_ctx, plane_type][ctxs, syms[: eob - 1]].sum())
    ectx = txb_mod.get_base_eob_ctx(eob - 1, bwl, h)
    bits += float(lut["base_eob"][txs_ctx, plane_type, ectx, syms[eob - 1] - 1])

    # br rounds for levels > 2
    big = np.nonzero(lv_scan > 2)[0]
    if big.size:
        br_ctx_map = _br_ctx_map(absl, tx_class)
        brc = br_ctx_map[scan[big]]
        base_range = np.minimum(lv_scan[big] - 3, 12)
        bits += float(lut["br"][min(txs_ctx, int(TxSize.TX_32X32)), plane_type][brc, base_range].sum())
        # golomb remainders for levels > 14
        gl = lv_scan[big]
        gmask = gl > 14
        if np.any(gmask):
            x = gl[gmask] - 15 + 1
            lens = np.floor(np.log2(x)).astype(np.int64) + 1
            bits += float((2 * lens - 1).sum())

    # signs: dc via cdf when dc nonzero, the rest one raw bit each
    nnz = int(nzi.size)
    if lv_scan[0] != 0:
        dc = int(flat[0])
        bits += float(lut["dc_sign"][plane_type, dc_sign_ctx, int(dc < 0)])
        bits += nnz - 1
    else:
        bits += nnz
    return bits


def mv_bits(fc, mv, pred, allow_hp: bool = False) -> float:
    """Bits for a NEWMV difference via the real MV coder."""
    from .mv import MvCoder

    bc = BitCounter()
    MvCoder(fc, update=False, allow_hp=allow_hp).write_mv(bc, mv, pred)
    return bc.bits


def symbol_bits(fc_table, symbol: int, nsyms: int) -> float:
    bc = BitCounter()
    bc.encode_symbol_n(symbol, fc_table, nsyms)
    return bc.bits


def single_ref_bits(fc, ref: int) -> float:
    """Single-reference tree bits (write_ref_frames twin, entropy_coding.c:2107)
    at neutral neighbor-count contexts (1 == balanced)."""
    from ..constants.av1 import RefFrame as R

    b = symbol_bits(fc["single_ref"][1][0], int(ref >= int(R.BWDREF_FRAME)), 2)
    if ref >= int(R.BWDREF_FRAME):
        b += symbol_bits(fc["single_ref"][1][1], int(ref == int(R.ALTREF_FRAME)), 2)
        if ref != int(R.ALTREF_FRAME):
            b += symbol_bits(fc["single_ref"][1][5], int(ref == int(R.ALTREF2_FRAME)), 2)
    else:
        l3g = int(ref in (int(R.LAST3_FRAME), int(R.GOLDEN_FRAME)))
        b += symbol_bits(fc["single_ref"][1][2], l3g, 2)
        if l3g:
            b += symbol_bits(fc["single_ref"][1][4], int(ref == int(R.GOLDEN_FRAME)), 2)
        else:
            b += symbol_bits(fc["single_ref"][1][3], int(ref == int(R.LAST2_FRAME)), 2)
    return b


def txtype_signal_bits(fc, tx_size: int, tx_type: int, is_inter: bool,
                       y_mode: int = 0) -> float:
    """Luma transform-type symbol bits (the signal between txb_skip and eob;
    entropy_coding.c av1_write_tx_type twin). 0 when the set has one entry."""
    from ..codec.tile_codec import (AV1_EXT_TX_IND, AV1_NUM_EXT_TX_SET,
                                    EXT_TX_SET_INDEX_INTER, EXT_TX_SET_INDEX_INTRA,
                                    ext_tx_set_type_inter, ext_tx_set_type_intra)
    from ..constants.av1 import TX_SIZE_SQR

    set_type = (ext_tx_set_type_inter(tx_size) if is_inter
                else ext_tx_set_type_intra(tx_size))
    nsym = int(AV1_NUM_EXT_TX_SET[set_type])
    if nsym <= 1:
        return 0.0
    sym = int(AV1_EXT_TX_IND[set_type][tx_type])
    sqr = int(TX_SIZE_SQR[tx_size])
    if is_inter:
        eset = EXT_TX_SET_INDEX_INTER[set_type]
        return symbol_bits(fc["inter_ext_tx"][eset][sqr], sym, nsym)
    eset = EXT_TX_SET_INDEX_INTRA[set_type]
    return symbol_bits(fc["intra_ext_tx"][eset][sqr][int(y_mode)], sym, nsym)


def partition_bits(fc, size: int, split: bool) -> float:
    """Square partition symbol bits at above/left ctx 0 (the device DP's
    approximation, device_decide.partition_dp)."""
    from ..constants.av1 import Partition

    bsl = int(np.log2(size // 8))
    ctx = bsl * 4  # PARTITION_PLOFFSET
    sym = int(Partition.PARTITION_SPLIT) if split else int(Partition.PARTITION_NONE)
    return symbol_bits(fc["partition"][ctx], sym, 10)
