"""Loop restoration (Wiener + self-guided projection) — normative apply +
per-unit encoder search.

Behavioral reference: Source/Lib/Codec/restoration.c (filter-frame flow,
stripe boundary rules, selfguided math) and restoration_pick.c (per-unit
Wiener/SGR search). The TPU-first re-formulation avoids the reference's
save/restore boundary-buffer dance entirely: every 64-row processing stripe
builds its extended source by a pure gather rule — rows inside the stripe
come from the CDEF output, rows outside (clamped to stripe±2 then frame)
come from the deblocked (pre-CDEF) frame — which is exactly the semantics
the reference implements with setup/restore_processing_stripe_boundary.

All arithmetic is integer and bit-exact with the spec (7.17).
"""
from __future__ import annotations

import numpy as np

# restoration types (spec)
RESTORE_NONE = 0
RESTORE_WIENER = 1
RESTORE_SGRPROJ = 2
RESTORE_SWITCHABLE = 3
# coded lr_type value <-> internal type (spec Remap_Lr_Type)
REMAP_LR_TYPE = (RESTORE_NONE, RESTORE_SWITCHABLE, RESTORE_WIENER, RESTORE_SGRPROJ)

FILTER_BITS = 7
WIENER_ROUND0 = 3  # 8/10-bit
WIENER_TAPS_MID = (3, -7, 15)
WIENER_TAPS_MIN = (-5, -23, -17)
WIENER_TAPS_MAX = (10, 8, 46)
WIENER_TAPS_K = (1, 2, 3)

SGRPROJ_PARAMS_BITS = 4
SGRPROJ_PRJ_BITS = 7
SGRPROJ_RST_BITS = 4
SGRPROJ_SGR_BITS = 8
SGRPROJ_SGR = 1 << SGRPROJ_SGR_BITS
SGRPROJ_MTABLE_BITS = 20
SGRPROJ_RECIP_BITS = 12
SGRPROJ_XQD_MIN = (-96, -32)
SGRPROJ_XQD_MAX = (31, 95)
SGRPROJ_XQD_MID = (-32, 31)
SGRPROJ_PRJ_SUBEXP_K = 4

UNIT_OFFSET = 8  # RESTORATION_UNIT_OFFSET (luma rows)
STRIPE_SIZE = 64  # RESTORATION_PROC_UNIT_SIZE (luma rows)

# (r0, e0, r1, e1) per sgr set (spec Sgr_Params)
SGR_PARAMS = (
    (2, 12, 1, 4), (2, 15, 1, 6), (2, 18, 1, 8), (2, 21, 1, 9),
    (2, 24, 1, 10), (2, 29, 1, 11), (2, 36, 1, 12), (2, 45, 1, 13),
    (2, 56, 1, 14), (2, 68, 1, 15), (0, 0, 1, 5), (0, 0, 1, 8),
    (0, 0, 1, 11), (0, 0, 1, 14), (2, 30, 0, 0), (2, 75, 0, 0),
)


def _sgr_s(r: int, e: int) -> int:
    """Sgr strength: round(2^20 / (n^2 e)) (restoration.c GenSgrprojVtable)."""
    n = (2 * r + 1) ** 2
    n2e = n * n * e
    return ((1 << SGRPROJ_MTABLE_BITS) + n2e // 2) // n2e


# x/(x+1) in Q8 with 0 -> 1 (restoration.c svt_aom_eb_x_by_xplus1)
X_BY_XPLUS1 = np.array(
    [1] + [(256 * x + (x + 1) // 2) // (x + 1) for x in range(1, 255)] + [256],
    np.int64)
# round(2^12 / n) for n = 1..25 (svt_aom_eb_one_by_x)
ONE_BY_X = np.array([(4096 + n // 2) // n for n in range(1, 26)], np.int64)


def _round2(x, n):
    return (x + (1 << (n - 1))) >> n if n > 0 else x


def count_units(size: int, dim: int) -> int:
    """Units along one axis (restoration.c count_units_in_tile)."""
    return max((dim + (size >> 1)) // size, 1)


def unit_extents(size: int, dim: int) -> list:
    """[(start, end)] per unit along one axis: last unit absorbs a remainder
    smaller than size*3/2 (foreach_rest_unit_in_tile)."""
    ext = size * 3 // 2
    out = []
    x0 = 0
    while x0 < dim:
        rem = dim - x0
        w = rem if rem < ext else size
        out.append((x0, x0 + w))
        x0 += w
    return out


def row_extents(size: int, dim: int, voff: int) -> list:
    """Vertical unit extents, shifted up by the stripe offset."""
    out = []
    for (y0, y1) in unit_extents(size, dim):
        v0 = max(0, y0 - voff)
        v1 = y1 - voff if y1 < dim else dim
        out.append((v0, v1))
    return out


# --------------------------------------------------------------------- apply

def _stripe_ext(cdef: np.ndarray, deblock: np.ndarray, vs: int, ve: int,
                h0: int, h1: int) -> np.ndarray:
    """Extended source rows [vs-3, ve+3) x cols [h0-3, h1+3) for one stripe
    chunk: in-stripe rows from the CDEF frame, boundary rows from the
    deblocked frame per the stripe rule (setup_processing_stripe_boundary /
    spec get_source_sample)."""
    H, W = cdef.shape
    ys = np.arange(vs - 3, ve + 3)
    ys = np.clip(ys, vs - 2, ve + 1)  # 2 ctx rows each side, 3rd duplicates
    ys = np.clip(ys, 0, H - 1)
    use_db = (ys < vs) | (ys >= ve)
    xs = np.clip(np.arange(h0 - 3, h1 + 3), 0, W - 1)
    rows_c = cdef[ys][:, xs]
    rows_d = deblock[ys][:, xs]
    return np.where(use_db[:, None], rows_d, rows_c).astype(np.int64)


def stripe_chunks(v0: int, v1: int, H: int, ss_y: int) -> list:
    """[(vs, ve)] stripe chunks covering unit rows [v0, v1)."""
    sh = STRIPE_SIZE >> ss_y
    off = UNIT_OFFSET >> ss_y
    out = []
    vs = v0
    while vs < v1:
        # nominal stripe containing vs: stripe k spans [k*sh - off, (k+1)*sh - off)
        k = (vs + off) // sh
        ve = min((k + 1) * sh - off, v1)
        out.append((vs, ve))
        vs = ve
    return out


def wiener_taps7(taps3, chroma: bool = False) -> np.ndarray:
    """3 coded taps -> 7-tap kernel with implicit center (the convolve adds
    the +128 source term separately, mirroring wiener_convolve_add_src)."""
    t0, t1, t2 = (0 if chroma else int(taps3[0])), int(taps3[1]), int(taps3[2])
    return np.array([t0, t1, t2, -2 * (t0 + t1 + t2), t2, t1, t0], np.int64)


def wiener_filter_chunk(ext: np.ndarray, hf: np.ndarray, vf: np.ndarray,
                        bd: int) -> np.ndarray:
    """Normative two-pass Wiener on an extended (h+6, w+6) buffer
    (convolve.c svt_av1_wiener_convolve_add_src_c, integer-exact)."""
    r0, r1 = WIENER_ROUND0, 2 * FILTER_BITS - WIENER_ROUND0
    h6, w6 = ext.shape
    w = w6 - 6
    # horizontal: all h+6 rows
    acc = np.zeros((h6, w), np.int64)
    for k in range(7):
        acc += ext[:, k : k + w] * hf[k]
    acc += (ext[:, 3 : 3 + w] << FILTER_BITS) + (1 << (bd + FILTER_BITS - 1))
    lim = 1 << (bd + 1 + FILTER_BITS - r0)
    im = np.clip(_round2(acc, r0), 0, lim - 1)
    # vertical
    h = h6 - 6
    acc = np.zeros((h, w), np.int64)
    for k in range(7):
        acc += im[k : k + h] * vf[k]
    acc += (im[3 : 3 + h] << FILTER_BITS) - (1 << (bd + r1 - 1))
    return np.clip(_round2(acc, r1), 0, (1 << bd) - 1)


def _boxsum(x: np.ndarray, r: int) -> np.ndarray:
    """(2r+1)^2 box sums; x padded by >= r on each side. Output matches x's
    shape minus 2r (valid region)."""
    c = np.cumsum(np.cumsum(x, axis=0), axis=1)
    c = np.pad(c, ((1, 0), (1, 0)))
    n = 2 * r + 1
    return (c[n:, n:] - c[:-n, n:] - c[n:, :-n] + c[:-n, :-n])


def sgr_flt(ext: np.ndarray, ep: int, pass_idx: int, bd: int) -> np.ndarray:
    """One self-guided pass over an extended (h+6, w+6) buffer -> (h, w)
    flt in Q(SGRPROJ_RST_BITS) (restoration.c selfguided_restoration_*)."""
    r = SGR_PARAMS[ep][pass_idx * 2]
    e = SGR_PARAMS[ep][pass_idx * 2 + 1]
    assert r > 0
    s = _sgr_s(r, e)
    h = ext.shape[0] - 6
    w = ext.shape[1] - 6
    n = (2 * r + 1) ** 2
    # A/B over rows/cols [-1, h] x [-1, w]; ext offset: pixel (i,j) -> ext[i+3, j+3]
    # window sums centered at (i,j) need ext[i+3-r : i+3+r+1, ...]
    sub = ext[2 - r : 2 - r + (h + 2) + 2 * r, 2 - r : 2 - r + (w + 2) + 2 * r]
    B = _boxsum(sub, r)  # (h+2, w+2) at rows -1..h
    A = _boxsum(sub * sub, r)
    a = _round2(A, 2 * (bd - 8))
    b = _round2(B, bd - 8)
    p = np.maximum(a * n - b * b, 0)
    z = _round2(p * s, SGRPROJ_MTABLE_BITS)
    A2 = X_BY_XPLUS1[np.minimum(z, 255)]
    B2 = _round2((SGRPROJ_SGR - A2) * B * ONE_BY_X[n - 1], SGRPROJ_RECIP_BITS)
    src = ext[3 : 3 + h, 3 : 3 + w]
    out = np.zeros((h, w), np.int64)
    if pass_idx == 0:
        # pass 0 (r==2): A/B valid on odd grid rows (-1, 1, 3, ...);
        # even output rows blend rows above/below (weights 6/5, shift nb=5),
        # odd rows use their own row (weights 6/5, nb=4)
        ev = np.arange(0, h, 2)
        od = np.arange(1, h, 2)
        Ai = lambda rr, cc: A2[rr + 1][:, cc + 1]  # (row,col) -> index shift
        Bi = lambda rr, cc: B2[rr + 1][:, cc + 1]
        cols = np.arange(w)
        for rows, own, nb in ((ev, False, 5), (od, True, 4)):
            if not len(rows):
                continue
            if own:
                aa = Ai(rows, cols) * 6 + (Ai(rows, cols - 1) + Ai(rows, cols + 1)) * 5
                bb = Bi(rows, cols) * 6 + (Bi(rows, cols - 1) + Bi(rows, cols + 1)) * 5
            else:
                aa = (Ai(rows - 1, cols) + Ai(rows + 1, cols)) * 6 + \
                     (Ai(rows - 1, cols - 1) + Ai(rows - 1, cols + 1) +
                      Ai(rows + 1, cols - 1) + Ai(rows + 1, cols + 1)) * 5
                bb = (Bi(rows - 1, cols) + Bi(rows + 1, cols)) * 6 + \
                     (Bi(rows - 1, cols - 1) + Bi(rows - 1, cols + 1) +
                      Bi(rows + 1, cols - 1) + Bi(rows + 1, cols + 1)) * 5
            v = aa * src[rows] + bb
            out[rows] = _round2(v, SGRPROJ_SGR_BITS + nb - SGRPROJ_RST_BITS)
    else:
        # pass 1 (r==1): full-density cross weights 4 / 3, nb=5
        Ac = A2[1 : 1 + h, 1 : 1 + w]
        Bc = B2[1 : 1 + h, 1 : 1 + w]
        aa = (Ac + A2[1 : 1 + h, 0:w] + A2[1 : 1 + h, 2 : 2 + w] +
              A2[0:h, 1 : 1 + w] + A2[2 : 2 + h, 1 : 1 + w]) * 4 + \
             (A2[0:h, 0:w] + A2[0:h, 2 : 2 + w] +
              A2[2 : 2 + h, 0:w] + A2[2 : 2 + h, 2 : 2 + w]) * 3
        bb = (Bc + B2[1 : 1 + h, 0:w] + B2[1 : 1 + h, 2 : 2 + w] +
              B2[0:h, 1 : 1 + w] + B2[2 : 2 + h, 1 : 1 + w]) * 4 + \
             (B2[0:h, 0:w] + B2[0:h, 2 : 2 + w] +
              B2[2 : 2 + h, 0:w] + B2[2 : 2 + h, 2 : 2 + w]) * 3
        v = aa * src + bb
        out = _round2(v, SGRPROJ_SGR_BITS + 5 - SGRPROJ_RST_BITS)
    return out


def decode_xq(xqd, ep: int):
    """(xqd0, xqd1) coded values -> effective (xq0, xq1) (svt_decode_xq)."""
    r0, _, r1, _ = SGR_PARAMS[ep]
    if r0 == 0:
        return 0, (1 << SGRPROJ_PRJ_BITS) - xqd[1]
    if r1 == 0:
        return xqd[0], 0
    return xqd[0], (1 << SGRPROJ_PRJ_BITS) - xqd[0] - xqd[1]


def sgr_filter_chunk(ext: np.ndarray, ep: int, xqd, bd: int) -> np.ndarray:
    """Normative self-guided apply on an extended buffer
    (svt_apply_selfguided_restoration_c)."""
    r0, _, r1, _ = SGR_PARAMS[ep]
    h, w = ext.shape[0] - 6, ext.shape[1] - 6
    src = ext[3 : 3 + h, 3 : 3 + w]
    u = src << SGRPROJ_RST_BITS
    v = u.astype(np.int64) << SGRPROJ_PRJ_BITS
    xq0, xq1 = decode_xq(xqd, ep)
    if r0 > 0:
        v = v + xq0 * (sgr_flt(ext, ep, 0, bd) - u)
    if r1 > 0:
        v = v + xq1 * (sgr_flt(ext, ep, 1, bd) - u)
    out = _round2(v, SGRPROJ_PRJ_BITS + SGRPROJ_RST_BITS)
    return np.clip(out, 0, (1 << bd) - 1)


class UnitInfo:
    """Per-unit restoration decision."""

    __slots__ = ("rtype", "wiener", "sgr_ep", "sgr_xqd")

    def __init__(self, rtype=RESTORE_NONE, wiener=None, sgr_ep=0, sgr_xqd=(0, 0)):
        self.rtype = rtype
        # wiener: ((v0,v1,v2),(h0,h1,h2)) coded taps (vert pass first, spec)
        self.wiener = wiener
        self.sgr_ep = sgr_ep
        self.sgr_xqd = tuple(sgr_xqd)


def apply_unit(cdef: np.ndarray, deblock: np.ndarray, out: np.ndarray,
               info: UnitInfo, v0: int, v1: int, h0: int, h1: int,
               ss_y: int, bd: int, chroma: bool) -> None:
    """Filter one restoration unit stripe-by-stripe into `out`."""
    H = cdef.shape[0]
    if info.rtype == RESTORE_NONE:
        out[v0:v1, h0:h1] = cdef[v0:v1, h0:h1]
        return
    for (vs, ve) in stripe_chunks(v0, v1, H, ss_y):
        ext = _stripe_ext(cdef, deblock, vs, ve, h0, h1)
        if info.rtype == RESTORE_WIENER:
            vf = wiener_taps7(info.wiener[0], chroma)
            hf = wiener_taps7(info.wiener[1], chroma)
            out[vs:ve, h0:h1] = wiener_filter_chunk(ext, hf, vf, bd)
        else:
            out[vs:ve, h0:h1] = sgr_filter_chunk(ext, info.sgr_ep, info.sgr_xqd, bd)


def apply_lr_plane(cdef: np.ndarray, deblock: np.ndarray, units, unit_size: int,
                   W: int, H: int, ss_y: int, bd: int, chroma: bool) -> np.ndarray:
    """Apply per-unit restoration over a plane (crop dims W x H); pixels
    outside the crop (alignment padding) pass through."""
    out = cdef.copy()
    rows = row_extents(unit_size, H, UNIT_OFFSET >> ss_y)
    cols = unit_extents(unit_size, W)
    # restrict source reads to the crop (the reference filters the cropped
    # frame with edge extension)
    cdef_c = cdef[:H, :W]
    db_c = deblock[:H, :W]
    sub = np.zeros((H, W), cdef.dtype)
    for ui, (v0, v1) in enumerate(rows):
        for uj, (h0, h1) in enumerate(cols):
            apply_unit(cdef_c, db_c, sub, units[ui][uj], v0, v1, h0, h1,
                       ss_y, bd, chroma)
    out[:H, :W] = sub
    return out


# --------------------------------------------------------------------- search

def _solve_wiener_taps(dgd: np.ndarray, src: np.ndarray, chroma: bool) -> tuple:
    """Separable 7x7 (5x5 chroma) Wiener solve: exact windowed stats +
    alternating vert/horz least squares, then symmetric quantization to the
    coded tap grid (restoration_pick.c av1_compute_stats +
    wiener_decompose_sep_sym + finalize_sym_filter, fresh formulation)."""
    wn = 5 if chroma else 7
    off = wn // 2
    h, w = src.shape
    if h <= 2 * off or w <= 2 * off:
        return None
    # D: (wn*wn, npix) window matrix of dgd, y: target src
    ih, iw = h - 2 * off, w - 2 * off
    D = np.empty((wn * wn, ih * iw), np.float64)
    for i in range(wn):
        for j in range(wn):
            D[i * wn + j] = dgd[i : i + ih, j : j + iw].ravel()
    y = src[off : off + ih, off : off + iw].astype(np.float64).ravel()
    Hm = D @ D.T
    Mv = D @ y
    a = np.zeros(wn)
    b = np.zeros(wn)
    a[:] = b[:] = 1.0 / wn
    for _ in range(10):
        # solve vertical given horizontal
        K = Hm.reshape(wn, wn, wn, wn)
        Av = np.einsum("j,l,ijkl->ik", b, b, K)
        rv = Mv.reshape(wn, wn) @ b
        try:
            a = np.linalg.solve(Av + 1e-6 * np.eye(wn), rv)
        except np.linalg.LinAlgError:
            return None
        s = a.sum()
        if abs(s) < 1e-9:
            return None
        a /= s
        Ah = np.einsum("i,k,ijkl->jl", a, a, K)
        rh = a @ Mv.reshape(wn, wn)
        try:
            b = np.linalg.solve(Ah + 1e-6 * np.eye(wn), rh)
        except np.linalg.LinAlgError:
            return None
        s = b.sum()
        if abs(s) < 1e-9:
            return None
        b /= s

    def quantize(f):
        # symmetrize, scale to Q7, clamp to coded ranges
        f7 = np.zeros(7)
        f7[3 - off : 4 + off] = f
        f7 = (f7 + f7[::-1]) / 2
        taps = []
        for i in range(3):
            t = int(np.round(f7[i] * (1 << FILTER_BITS)))
            t = max(WIENER_TAPS_MIN[i], min(WIENER_TAPS_MAX[i], t))
            taps.append(t)
        if chroma:
            taps[0] = 0
        return tuple(taps)

    return (quantize(a), quantize(b))


def _sse(a: np.ndarray, b: np.ndarray) -> float:
    d = a.astype(np.int64) - b.astype(np.int64)
    return float((d * d).sum())


def _solve_sgr_xqd(ext: np.ndarray, src: np.ndarray, ep: int, bd: int) -> tuple:
    """Least-squares projection coefficients for one sgr set
    (restoration_pick.c svt_aom_get_proj_subspace analog)."""
    r0, _, r1, _ = SGR_PARAMS[ep]
    h, w = src.shape
    dgd = ext[3 : 3 + h, 3 : 3 + w]
    u = (dgd << SGRPROJ_RST_BITS).astype(np.float64)
    t = (src.astype(np.float64) * (1 << SGRPROJ_RST_BITS)) - u
    f0 = (sgr_flt(ext, ep, 0, bd) - u) if r0 > 0 else np.zeros_like(u)
    f1 = (sgr_flt(ext, ep, 1, bd) - u) if r1 > 0 else np.zeros_like(u)
    A = np.array([[np.sum(f0 * f0), np.sum(f0 * f1)],
                  [np.sum(f0 * f1), np.sum(f1 * f1)]])
    bvec = np.array([np.sum(f0 * t), np.sum(f1 * t)])
    xq = [0.0, 0.0]
    if r0 > 0 and r1 > 0:
        det = A[0, 0] * A[1, 1] - A[0, 1] * A[1, 0]
        if abs(det) > 1e-9:
            xq[0] = (A[1, 1] * bvec[0] - A[0, 1] * bvec[1]) / det
            xq[1] = (A[0, 0] * bvec[1] - A[1, 0] * bvec[0]) / det
    elif r0 > 0:
        xq[0] = bvec[0] / max(A[0, 0], 1e-9)
    elif r1 > 0:
        xq[1] = bvec[1] / max(A[1, 1], 1e-9)
    x0 = int(np.round(xq[0] * (1 << SGRPROJ_PRJ_BITS)))
    x1 = int(np.round(xq[1] * (1 << SGRPROJ_PRJ_BITS)))
    # encode_xq inverse (restoration_pick.c svt_aom_encode_xq)
    if r0 == 0:
        xqd0 = 0
        xqd1 = max(SGRPROJ_XQD_MIN[1], min(SGRPROJ_XQD_MAX[1],
                                           (1 << SGRPROJ_PRJ_BITS) - x1))
    elif r1 == 0:
        xqd0 = max(SGRPROJ_XQD_MIN[0], min(SGRPROJ_XQD_MAX[0], x0))
        xqd1 = max(SGRPROJ_XQD_MIN[1], min(SGRPROJ_XQD_MAX[1],
                                           (1 << SGRPROJ_PRJ_BITS) - xqd0))
    else:
        xqd0 = max(SGRPROJ_XQD_MIN[0], min(SGRPROJ_XQD_MAX[0], x0))
        xqd1 = max(SGRPROJ_XQD_MIN[1], min(SGRPROJ_XQD_MAX[1],
                                           (1 << SGRPROJ_PRJ_BITS) - xqd0 - x1))
    return (xqd0, xqd1)


# subexp bit-length helpers (write-side costs; see codec/tile_codec.py for
# the coding twins)
def _subexp_bits(mx: int, k: int, v: int) -> int:
    i = 0
    mk = 0
    bits = 0
    while True:
        b2 = k + i - 1 if i else k
        a = 1 << b2
        if mx <= mk + 3 * a:
            n = mx - mk
            l = max((n - 1).bit_length(), 1)
            m = (1 << l) - n
            return bits + (l - 1 if (v - mk) < m else l)
        if v < mk + a:
            return bits + 1 + b2
        bits += 1
        i += 1
        mk += a


def _recenter(r: int, v: int) -> int:
    if v > 2 * r:
        return v
    if v >= r:
        return (v - r) * 2
    return (r - v) * 2 - 1


def signed_subexp_bits(low: int, high: int, k: int, ref: int, v: int) -> int:
    mx = high - low
    r = ref - low
    x = v - low
    if (r << 1) <= mx:
        u = _recenter(r, x)
    else:
        u = _recenter(mx - 1 - r, mx - 1 - x)
    return _subexp_bits(mx, k, u)


SGR_EP_SEARCH = tuple(range(16))


def search_plane(src: np.ndarray, cdef: np.ndarray, deblock: np.ndarray,
                 unit_size: int, W: int, H: int, ss_y: int, bd: int,
                 chroma: bool, lam: float, fc=None) -> tuple:
    """Per-unit NONE/WIENER/SGR search + frame-type RDO for one plane.
    Returns (frame_rtype, units 2D list of UnitInfo)."""
    rows = row_extents(unit_size, H, UNIT_OFFSET >> ss_y)
    cols = unit_extents(unit_size, W)
    src_c, cdef_c, db_c = src[:H, :W], cdef[:H, :W], deblock[:H, :W]
    cand = []  # per unit: dict rtype -> (sse, info)
    for (v0, v1) in rows:
        rrow = []
        for (h0, h1) in cols:
            tgt = src_c[v0:v1, h0:h1]
            entry = {}
            entry[RESTORE_NONE] = (_sse(cdef_c[v0:v1, h0:h1], tgt),
                                   UnitInfo(RESTORE_NONE))
            # Wiener: solve on the full unit (stats from cdef output), then
            # exact SSE via the normative stripe apply
            taps = _solve_wiener_taps(cdef_c[v0:v1, h0:h1].astype(np.float64),
                                      tgt.astype(np.float64), chroma)
            if taps is not None:
                info = UnitInfo(RESTORE_WIENER, wiener=taps)
                outw = np.zeros_like(cdef_c)
                apply_unit(cdef_c, db_c, outw, info, v0, v1, h0, h1, ss_y, bd, chroma)
                entry[RESTORE_WIENER] = (_sse(outw[v0:v1, h0:h1], tgt), info)
            # SGR: search ep on the unit's (first-stripe-extended) source;
            # exact SSE via normative apply
            best = None
            for ep in SGR_EP_SEARCH:
                ext = _stripe_ext(cdef_c, db_c, v0, v1, h0, h1)
                # NOTE: xqd solved on the whole unit treated as one stripe
                # (approximation); SSE below uses the true striped apply
                xqd = _solve_sgr_xqd(ext, tgt, ep, bd)
                info = UnitInfo(RESTORE_SGRPROJ, sgr_ep=ep, sgr_xqd=xqd)
                outs = np.zeros_like(cdef_c)
                apply_unit(cdef_c, db_c, outs, info, v0, v1, h0, h1, ss_y, bd, chroma)
                sse = _sse(outs[v0:v1, h0:h1], tgt)
                if best is None or sse < best[0]:
                    best = (sse, info)
            entry[RESTORE_SGRPROJ] = best
            rrow.append(entry)
        cand.append(rrow)

    # frame-type decision: NONE / all-WIENER-flagged / all-SGR-flagged /
    # SWITCHABLE, with sequential ref-chained bit costs (enc twin of read_lr)
    def plan_for(ftype):
        bits = 0.0
        sse = 0.0
        units = []
        ref_w = [list(WIENER_TAPS_MID), list(WIENER_TAPS_MID)]
        ref_x = list(SGRPROJ_XQD_MID)
        for rrow in cand:
            urow = []
            for entry in rrow:
                opts = []
                if ftype == RESTORE_NONE:
                    opts = [RESTORE_NONE]
                elif ftype == RESTORE_WIENER:
                    opts = [RESTORE_NONE, RESTORE_WIENER]
                elif ftype == RESTORE_SGRPROJ:
                    opts = [RESTORE_NONE, RESTORE_SGRPROJ]
                else:
                    opts = [RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ]
                best = None
                for rt in opts:
                    if rt not in entry:
                        continue
                    s, info = entry[rt]
                    b = 1.0  # restore flag / switchable symbol (approx 1-3 bits)
                    if ftype == RESTORE_SWITCHABLE:
                        b = 2.0
                    if rt == RESTORE_WIENER:
                        for p in range(2):
                            for j in range(1 if chroma else 0, 3):
                                b += signed_subexp_bits(
                                    WIENER_TAPS_MIN[j], WIENER_TAPS_MAX[j] + 1,
                                    WIENER_TAPS_K[j], ref_w[p][j], info.wiener[p][j])
                    elif rt == RESTORE_SGRPROJ:
                        b += SGRPROJ_PARAMS_BITS
                        r0, _, r1, _ = SGR_PARAMS[info.sgr_ep]
                        if r0:
                            b += signed_subexp_bits(SGRPROJ_XQD_MIN[0], SGRPROJ_XQD_MAX[0] + 1,
                                                    SGRPROJ_PRJ_SUBEXP_K, ref_x[0], info.sgr_xqd[0])
                        if r1:
                            b += signed_subexp_bits(SGRPROJ_XQD_MIN[1], SGRPROJ_XQD_MAX[1] + 1,
                                                    SGRPROJ_PRJ_SUBEXP_K, ref_x[1], info.sgr_xqd[1])
                    cost = s + lam * b
                    if best is None or cost < best[0]:
                        best = (cost, s, b, rt, info)
                _, s, b, rt, info = best
                sse += s
                bits += b
                if rt == RESTORE_WIENER:
                    for p in range(2):
                        ref_w[p] = list(info.wiener[p])
                elif rt == RESTORE_SGRPROJ:
                    r0, _, r1, _ = SGR_PARAMS[info.sgr_ep]
                    if r0:
                        ref_x[0] = info.sgr_xqd[0]
                    if r1:
                        ref_x[1] = info.sgr_xqd[1]
                urow.append(info)
            units.append(urow)
        return sse + lam * bits, units

    best_t = None
    for ftype in (RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE):
        cost, units = plan_for(ftype)
        if best_t is None or cost < best_t[0]:
            best_t = (cost, ftype, units)
    return best_t[1], best_t[2]
