/*
 * Native AV1 range encoder + transform-block coefficient writer.
 *
 * Mirrors the Python behavioral reference (entropy/range_coder.py,
 * codec/txb.py) byte-for-byte; parity is enforced by tests
 * (tests/test_native_entropy.py). This is the production host-side coder
 * consuming device-computed levels (reference analog:
 * Source/Lib/Codec/bitstream_unit.c od_ec + entropy_coding.c
 * av1_write_coeffs_txb_1d).
 *
 * CDF layout matches the numpy tables: int32, length nsyms+1, inverse-CDF
 * Q15 with trailing adaptation counter. Adaptation happens in place so
 * Python-side and C-side symbol writes share one context state.
 *
 * Build: gcc -O3 -shared -fPIC entropy.c -o libsvtav1_entropy.so
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define EC_PROB_SHIFT 6
#define EC_MIN_PROB 4

typedef struct {
    uint32_t low;
    uint32_t rng;
    int cnt;
    uint16_t *pre;
    size_t n, cap;
} Ec;

static void ec_grow(Ec *e, size_t need) {
    if (e->n + need > e->cap) {
        e->cap = (e->cap * 2 > e->n + need) ? e->cap * 2 : (e->n + need + 4096);
        e->pre = (uint16_t *)realloc(e->pre, e->cap * sizeof(uint16_t));
    }
}

Ec *ec_create(void) {
    Ec *e = (Ec *)calloc(1, sizeof(Ec));
    e->low = 0;
    e->rng = 0x8000;
    e->cnt = -9;
    e->cap = 1 << 16;
    e->pre = (uint16_t *)malloc(e->cap * sizeof(uint16_t));
    e->n = 0;
    return e;
}

void ec_free(Ec *e) {
    if (e) {
        free(e->pre);
        free(e);
    }
}

static int ilog_nz(uint32_t v) { /* bit length */
    int r = 0;
    while (v) {
        r++;
        v >>= 1;
    }
    return r;
}

static void ec_normalize(Ec *e, uint32_t low, uint32_t rng) {
    int d = 16 - ilog_nz(rng);
    int c = e->cnt;
    int s = c + d;
    if (s >= 0) {
        ec_grow(e, 2);
        c += 16;
        uint32_t m = ((uint32_t)1 << c) - 1;
        if (s >= 8) {
            e->pre[e->n++] = (uint16_t)(low >> c);
            low &= m;
            c -= 8;
            m >>= 8;
        }
        e->pre[e->n++] = (uint16_t)(low >> c);
        s = c + d - 24;
        low &= m;
    }
    e->low = low << d;
    e->rng = rng << d;
    e->cnt = s;
}

void ec_encode_symbol(Ec *e, int32_t *icdf, int nsyms, int sym, int update) {
    uint32_t low = e->low;
    uint32_t r = e->rng;
    int N = nsyms - 1;
    uint32_t fh = (sym < N) ? (uint32_t)icdf[sym] : 0u;
    uint32_t u, v;
    if (sym > 0) {
        uint32_t fl = (uint32_t)icdf[sym - 1];
        u = (((r >> 8) * (fl >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) + EC_MIN_PROB * (N - (sym - 1));
        v = (((r >> 8) * (fh >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) + EC_MIN_PROB * (N - sym);
        low += r - u;
        r = u - v;
    } else {
        v = (((r >> 8) * (fh >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) + EC_MIN_PROB * (N - sym);
        r -= v;
    }
    ec_normalize(e, low, r);
    if (update) {
        int count = icdf[nsyms];
        int n2 = nsyms, speed = 0;
        while (n2 > 1) {
            speed++;
            n2 >>= 1;
        } /* floor(log2(nsyms)) */
        if (speed > 2)
            speed = 2;
        int rate = 3 + (count > 15) + (count > 31) + speed;
        int32_t tmp = 32768;
        for (int i = 0; i < nsyms - 1; i++) {
            if (i == sym)
                tmp = 0;
            int32_t cur = icdf[i];
            icdf[i] = (tmp < cur) ? cur - ((cur - tmp) >> rate) : cur + ((tmp - cur) >> rate);
        }
        if (count < 32)
            icdf[nsyms] = count + 1;
    }
}

void ec_encode_bool(Ec *e, int bit, int f_q15) {
    int32_t icdf[3] = {f_q15, 0, 0};
    ec_encode_symbol(e, icdf, 2, bit, 0);
}

void ec_encode_literal(Ec *e, uint32_t val, int nbits) {
    for (int i = nbits - 1; i >= 0; i--) ec_encode_bool(e, (val >> i) & 1, 16384);
}

int64_t ec_done(Ec *e, uint8_t *out, int64_t cap) {
    uint32_t low = e->low;
    int c = e->cnt;
    int s = 10 + c;
    uint32_t m = 0x3FFF;
    uint64_t ee = ((uint64_t)low + m) & ~(uint64_t)m;
    ee |= m + 1;
    size_t n = e->n;
    uint16_t *tmp = (uint16_t *)malloc((n + 8) * sizeof(uint16_t));
    memcpy(tmp, e->pre, n * sizeof(uint16_t));
    if (s > 0) {
        uint64_t mask = (((uint64_t)1 << (c + 16)) - 1);
        do {
            tmp[n++] = (uint16_t)(ee >> (c + 16));
            ee &= mask;
            s -= 8;
            c -= 8;
            mask >>= 8;
        } while (s > 0);
    }
    if ((int64_t)n > cap) {
        free(tmp);
        return -1;
    }
    uint32_t carry = 0;
    for (int64_t i = (int64_t)n - 1; i >= 0; i--) {
        uint32_t vv = tmp[i] + carry;
        out[i] = (uint8_t)vv;
        carry = vv >> 8;
    }
    free(tmp);
    return (int64_t)n;
}

/* ------------------------------------------------------------------------ */
/* coefficient coding (codec/txb.py twin)                                   */
/* ------------------------------------------------------------------------ */

#define TX_CLASS_2D 0
#define TX_CLASS_HORIZ 1
#define TX_CLASS_VERT 2
#define NUM_BASE_LEVELS 2
#define COEFF_BASE_RANGE 12
#define BR_CDF_SIZE 4

static const int16_t eob_group_start[12] = {0, 1, 2, 3, 5, 9, 17, 33, 65, 129, 257, 513};
static const int16_t eob_offset_bits[12] = {0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9};
static const int32_t nz_map_ctx_offset_1d[32] = {0, 5, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10,
                                                 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10};

static inline int c3(int v) { return v < 3 ? v : 3; }

static int get_base_ctx(const uint8_t *pad, int stride, int pos, int bwl, int tx_class,
                        const int32_t *off2d) {
    if ((tx_class | pos) == 0)
        return 0;
    int row = pos >> bwl, col = pos & ((1 << bwl) - 1);
    const uint8_t *p = pad + row * stride + col;
    int mag = c3(p[1]) + c3(p[stride]);
    if (tx_class == TX_CLASS_2D)
        mag += c3(p[stride + 1]) + c3(p[2]) + c3(p[2 * stride]);
    else if (tx_class == TX_CLASS_VERT)
        mag += c3(p[2 * stride]) + c3(p[3 * stride]) + c3(p[4 * stride]);
    else
        mag += c3(p[2]) + c3(p[3]) + c3(p[4]);
    int ctx = (mag + 1) >> 1;
    if (ctx > 4)
        ctx = 4;
    if (tx_class == TX_CLASS_2D)
        return ctx + off2d[pos];
    return ctx + nz_map_ctx_offset_1d[tx_class == TX_CLASS_HORIZ ? col : row];
}

static int get_br_ctx(const uint8_t *pad, int stride, int pos, int bwl, int tx_class) {
    int row = pos >> bwl, col = pos & ((1 << bwl) - 1);
    const uint8_t *p = pad + row * stride + col;
    int mag = p[1] + p[stride];
    if (tx_class == TX_CLASS_2D)
        mag += p[stride + 1];
    else if (tx_class == TX_CLASS_VERT)
        mag += p[2 * stride];
    else
        mag += p[2];
    mag = (mag + 1) >> 1;
    if (mag > 6)
        mag = 6;
    if (pos == 0)
        return mag;
    if ((tx_class == TX_CLASS_2D && row < 2 && col < 2) || (tx_class == TX_CLASS_HORIZ && col == 0) ||
        (tx_class == TX_CLASS_VERT && row == 0))
        return mag + 7;
    return mag + 14;
}

static void write_golomb(Ec *e, int level) {
    int x = level + 1;
    int len = ilog_nz((uint32_t)x);
    for (int i = 0; i < len - 1; i++) ec_encode_bool(e, 0, 16384);
    for (int i = len - 1; i >= 0; i--) ec_encode_bool(e, (x >> i) & 1, 16384);
}

/* Write everything after txb_skip for one txb. Returns cul_level. */
int32_t ec_write_txb_body(Ec *e, const int32_t *coeffs, int w, int h, const int32_t *scan,
                          int tx_class, int txs_ctx_unused, int plane_type_unused, int dc_sign_ctx,
                          int update, int32_t *eob_cdf, int eob_nsyms, int32_t *eob_extra_cdf,
                          int32_t *base_eob_cdf, int32_t *base_cdf, int32_t *br_cdf,
                          int32_t *dc_sign_cdf_row, const int32_t *off2d) {
    (void)txs_ctx_unused;
    (void)plane_type_unused;
    int bwl = 0;
    while ((1 << bwl) < w) bwl++;
    int npix = w * h;
    int eob = 0;
    for (int i = npix - 1; i >= 0; i--) {
        if (coeffs[scan[i]]) {
            eob = i + 1;
            break;
        }
    }
    /* caller guarantees eob > 0 */
    int stride = w + 4;
    uint8_t *pad = (uint8_t *)calloc((size_t)(h + 4) * stride, 1);
    for (int r = 0; r < h; r++)
        for (int cdx = 0; cdx < w; cdx++) {
            int32_t v = coeffs[r * w + cdx];
            if (v < 0)
                v = -v;
            pad[r * stride + cdx] = v > 127 ? 127 : (uint8_t)v;
        }

    /* eob_pt */
    int eob_pt = 0;
    for (int t = 11; t >= 0; t--) {
        if (eob >= eob_group_start[t]) {
            eob_pt = t;
            break;
        }
    }
    int eob_extra = eob - eob_group_start[eob_pt];
    ec_encode_symbol(e, eob_cdf, eob_nsyms, eob_pt - 1, update);
    int ob = eob_offset_bits[eob_pt];
    if (ob > 0) {
        int bit = (eob_extra >> (ob - 1)) & 1;
        ec_encode_symbol(e, eob_extra_cdf + eob_pt * 3, 2, bit, update);
        for (int i = 1; i < ob; i++) ec_encode_bool(e, (eob_extra >> (ob - 1 - i)) & 1, 16384);
    }

    for (int ci = eob - 1; ci >= 0; ci--) {
        int pos = scan[ci];
        int32_t v = coeffs[pos];
        int level = v < 0 ? -v : v;
        if (ci == eob - 1) {
            int ctx;
            if (ci == 0)
                ctx = 0;
            else if (ci <= npix / 8)
                ctx = 1;
            else if (ci <= npix / 4)
                ctx = 2;
            else
                ctx = 3;
            int s = (level < 3 ? level : 3) - 1;
            ec_encode_symbol(e, base_eob_cdf + ctx * 4, 3, s, update);
        } else {
            int ctx = get_base_ctx(pad, stride, pos, bwl, tx_class, off2d);
            int s = level < 3 ? level : 3;
            ec_encode_symbol(e, base_cdf + ctx * 5, 4, s, update);
        }
        if (level > NUM_BASE_LEVELS) {
            int base_range = level - 1 - NUM_BASE_LEVELS;
            int brc = get_br_ctx(pad, stride, pos, bwl, tx_class);
            for (int idx = 0; idx < COEFF_BASE_RANGE; idx += BR_CDF_SIZE - 1) {
                int k = base_range - idx;
                if (k > BR_CDF_SIZE - 1)
                    k = BR_CDF_SIZE - 1;
                ec_encode_symbol(e, br_cdf + brc * 5, BR_CDF_SIZE, k, update);
                if (k < BR_CDF_SIZE - 1)
                    break;
            }
        }
    }

    int32_t cul_level = 0;
    for (int ci = 0; ci < eob; ci++) {
        int pos = scan[ci];
        int32_t v = coeffs[pos];
        int level = v < 0 ? -v : v;
        cul_level += level;
        if (level) {
            int sign = v < 0;
            if (ci == 0)
                ec_encode_symbol(e, dc_sign_cdf_row, 2, sign, update);
            else
                ec_encode_bool(e, sign, 16384);
            if (level > COEFF_BASE_RANGE + NUM_BASE_LEVELS)
                write_golomb(e, level - COEFF_BASE_RANGE - 1 - NUM_BASE_LEVELS);
        }
    }
    free(pad);
    if (cul_level > 63)
        cul_level = 63;
    int32_t dc = coeffs[0];
    if (dc < 0)
        cul_level |= 1 << 6;
    else if (dc > 0)
        cul_level += 2 << 6;
    return cul_level;
}

/* ------------------------------------------------------------------------ */
/* whole-tile symbol walk (codec/tile_codec.py twin, encode side)           */
/*                                                                          */
/* Python flattens the partition tree + block decisions into an op stream   */
/* (int32 rows); this walker maintains every context (partition/mode/skip   */
/* grids, per-plane entropy ctx) and writes all symbols, calling the txb    */
/* body above. Byte-exact with the Python walk (tests).                     */
/* ------------------------------------------------------------------------ */

#define OP_COLS 24
/* op columns */
enum {
    OPC_KIND = 0, /* 0 = partition node, 1 = block */
    OPC_MI_ROW,
    OPC_MI_COL,
    OPC_BW4, /* block width in mi units (4px) */
    OPC_PART_OR_YMODE,
    OPC_UV_MODE,
    OPC_SKIP,
    OPC_ANGLE_Y, /* symbol (delta+3), -1 if not coded */
    OPC_ANGLE_UV,
    OPC_TXSIG_NSYM, /* luma ext-tx: nsyms (0 = none) */
    OPC_TXSIG_SYM,  /* luma ext-tx symbol */
    OPC_TXSIG_ESET, /* intra_ext_tx [eset][sqr][ymode] */
    OPC_TXSIG_SQR,
    OPC_LVL_Y, /* offsets into levels buffer, -1 = absent */
    OPC_LVL_U,
    OPC_LVL_V,
    OPC_REF,      /* ref_frame (0 = intra block) */
    OPC_MVY,      /* 1/8-pel MV (decoder-derived for NEAREST/NEAR/GLOBAL) */
    OPC_MVX,
    OPC_REFMVIDX,
    OPC_SIZEGROUP,/* y_mode size-group cdf index (inter frames) */
    OPC_REF2,     /* second ref (compound), <= 0 = single */
    OPC_MV2Y,     /* compound second-ref MV */
    OPC_MV2X,
};

typedef struct {
    /* cdf table base pointers (int32, layout [..][nsyms+1]) */
    int32_t *partition;   /* [20][11] */
    int32_t *skip;        /* [3][3] */
    int32_t *kf_y;        /* [5][5][14] */
    int32_t *uv_mode;     /* [2][13][15] */
    int32_t *angle;       /* [8][8] */
    int32_t *intra_ext_tx;/* [3][4][13][8] */
    int32_t *txb_skip;    /* [5][13][3] */
    int32_t *eob_flag[7]; /* 16..1024: [2][2][n+1] with n=5..11 */
    int32_t *eob_extra;   /* [5][2][22][3] */
    int32_t *base_eob;    /* [5][2][4][4] */
    int32_t *base;        /* [5][2][42][5] */
    int32_t *br;          /* [5][2][21][5] */
    int32_t *dc_sign;     /* [2][3][3] */
    /* inter syntax (entropy_coding.c write_modes_b inter path) */
    int32_t *y_mode;      /* [4][14] size-group intra mode (inter frames) */
    int32_t *intra_inter; /* [4][3] */
    int32_t *single_ref;  /* [3][6][3] */
    int32_t *newmv;       /* [6][3] */
    int32_t *zeromv;      /* [2][3] */
    int32_t *refmv;       /* [6][3] */
    int32_t *drl;         /* [3][3] */
    int32_t *inter_ext_tx;/* [4][4][17] */
    /* compound syntax (write_ref_frames comp side + inter_compound_mode) */
    int32_t *comp_inter;   /* [5][3] */
    int32_t *comp_ref_type;/* [5][3] */
    int32_t *comp_ref;     /* [3][3][3] */
    int32_t *comp_bwdref;  /* [3][2][3] */
    int32_t *comp_mode;    /* [8][9] inter_compound_mode */
    /* loop-restoration unit syntax (spec 5.11.57 read_lr write twin) */
    int32_t *wiener_restore;     /* [3] */
    int32_t *sgrproj_restore;    /* [3] */
    int32_t *switchable_restore; /* [4] */
    int32_t *nmv_joints;  /* [5] */
    int32_t *nmv_sign;    /* [2][3] */
    int32_t *nmv_classes; /* [2][12] */
    int32_t *nmv_class0;  /* [2][3] */
    int32_t *nmv_bits;    /* [2][10][3] */
    int32_t *nmv_class0_fp;/* [2][2][5] */
    int32_t *nmv_fp;      /* [2][5] */
    int32_t *nmv_class0_hp;/* [2][3] */
    int32_t *nmv_hp;      /* [2][3] */
    /* geometry tables */
    int32_t *scans;       /* concatenated scans */
    int32_t *scan_off;    /* [19*16] offsets into scans */
    int32_t *off2d;       /* concatenated 2d ctx offsets */
    int32_t *off2d_off;   /* [19] offsets */
    int32_t mi_rows, mi_cols;
    int32_t mi_row0, mi_row1, mi_col0, mi_col1; /* tile bounds */
    int32_t qindex_positive;
    int32_t update;
    int32_t frame_is_intra;
    int32_t reference_select; /* frame header flag: compound available */
    int32_t sign_bias[8]; /* RefFrameSignBias per ref id (0 unused) */
    int32_t gm_mv[8][2];  /* TRANSLATION global MV (row8, col8) per ref id */
} TileParams;

/* partition_context_lookup (definitions.h:1574) indexed by sq size log2-3 (8..64) */
static const uint8_t part_ctx_above[4] = {30, 28, 24, 16};
static const uint8_t part_ctx_left[4] = {30, 28, 24, 16};
static const uint8_t intra_mode_ctx[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};
static const uint8_t skip_ctx_2d[5][5] = {
    {1, 2, 2, 2, 3}, {1, 4, 4, 4, 5}, {1, 4, 4, 4, 5}, {1, 4, 4, 4, 5}, {1, 4, 4, 4, 6}};
/* tx sizes per (square) block mi-width-log2: 8px->TX_8X8(1)... */
static const int32_t luma_txsize_by_log2[4] = {1, 2, 3, 4};   /* TX_8X8..TX_64X64 */
static const int32_t uv_txsize_by_log2[4] = {0, 1, 2, 3};     /* TX_4X4..TX_32X32 */
static const int32_t txw_by_txsize[5] = {4, 8, 16, 32, 64};
/* txs entropy ctx = (sqr + sqr_up + 1) >> 1 for square sizes = identity */
static const int32_t tx_class_of[16] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 1, 2, 1, 2, 1};
/* Mode_To_Txfm (chroma derived tx type) */
static const int32_t mode_to_txfm[13] = {0, 1, 2, 0, 3, 1, 2, 2, 1, 3, 1, 2, 3};

typedef struct {
    uint8_t *above_part; /* [mi_cols] */
    uint8_t *left_part;  /* [mi_rows] */
    int8_t *mode_grid;   /* [mi_rows*mi_cols], -1 invalid; intra OR inter mode */
    uint8_t *skip_grid;
    int32_t *above_ctx[3];
    int32_t *left_ctx[3];
    /* inter mi state (codec/mvp.MiState analog) */
    int8_t *ref_grid;    /* [mi_rows*mi_cols] ref0 (0 = intra) */
    int8_t *bsize_grid;  /* [mi_rows*mi_cols] bw4 of covering block */
    int32_t *mv_grid;    /* [mi_rows*mi_cols*2] (row, col) 1/8 pel */
    int8_t *ref1_grid;   /* [mi_rows*mi_cols] second ref (-1/0 = none) */
    int32_t *mv1_grid;   /* [mi_rows*mi_cols*2] second-ref MV */
} TileState;

/* ---------------------------------------------------------------- MVP stack
 * C twin of codec/mvp.find_mv_stack (spec 7.10.2, single-ref spatial-only,
 * SQUARE blocks). Must stay bit-exact with the Python reference — enforced
 * by tests/test_native_entropy.py inter tile-walk parity. */

#define MAX_REF_MV_STACK 8
#define MAX_MV_REF_CAND 2
#define REF_CAT_LEVEL 640
#define MV_BORDER (16 << 3)
#define MVREF_ROWS 3
#define NEWMV_MODE 16 /* InterMode.NEWMV */

/* svt_aom_have_newmv_in_inter_mode: NEWMV + the *_NEWMV compound modes */
static int has_newmv_mode(int mode) {
    return mode == 16 || (mode >= 19 && mode <= 22) || mode == 24;
}

typedef struct {
    int32_t mvs[MAX_REF_MV_STACK][2];
    int32_t mvs1[MAX_REF_MV_STACK][2]; /* compound second-ref MVs */
    int64_t weights[MAX_REF_MV_STACK];
    int count;
    int mode_context;
} MvStackC;

typedef struct {
    TileParams *tp;
    TileState *st;
    int mi_row, mi_col, n4; /* square: n4_w == n4_h == n4 */
    int ref_frame, ref_frame1; /* ref_frame1 > 0 -> compound pair stack */
    int count, newmv, row_match, col_match, processed_rows, processed_cols;
    int max_row_offset, max_col_offset;
    MvStackC *out;
} MvScan;

static int mvp_inside(MvScan *s, int r, int c) {
    TileParams *tp = s->tp;
    return !(r < tp->mi_row0 || c < tp->mi_col0 || r >= tp->mi_row1 || c >= tp->mi_col1);
}

static void mvp_add(MvScan *s, int r, int c, int64_t weight, int count_newmv, int is_row) {
    TileState *st = s->st;
    int idx = r * s->tp->mi_cols + c;
    int ref0 = st->ref_grid[idx];
    if (ref0 <= 0) return; /* intra or unset */
    MvStackC *o = s->out;
    if (s->ref_frame1 > 0) {
        /* compound: candidates coded with exactly this ref PAIR */
        if (ref0 != s->ref_frame || st->ref1_grid[idx] != s->ref_frame1) return;
        int32_t mr = st->mv_grid[idx * 2], mc = st->mv_grid[idx * 2 + 1];
        int32_t m1r = st->mv1_grid[idx * 2], m1c = st->mv1_grid[idx * 2 + 1];
        int i = 0;
        for (; i < s->count; i++)
            if (o->mvs[i][0] == mr && o->mvs[i][1] == mc &&
                o->mvs1[i][0] == m1r && o->mvs1[i][1] == m1c) break;
        if (i < s->count) {
            o->weights[i] += weight;
        } else if (s->count < MAX_REF_MV_STACK) {
            o->mvs[s->count][0] = mr; o->mvs[s->count][1] = mc;
            o->mvs1[s->count][0] = m1r; o->mvs1[s->count][1] = m1c;
            o->weights[s->count] = weight;
            s->count++;
        }
        if (count_newmv && has_newmv_mode(st->mode_grid[idx])) s->newmv++;
        if (is_row) s->row_match++; else s->col_match++;
        return;
    }
    for (int which = 0; which < 2; which++) {
        int refv = which == 0 ? ref0 : st->ref1_grid[idx];
        if (refv != s->ref_frame) continue;
        const int32_t *mvsrc = which == 0 ? st->mv_grid : st->mv1_grid;
        int32_t mr = mvsrc[idx * 2], mc = mvsrc[idx * 2 + 1];
        int i = 0;
        for (; i < s->count; i++)
            if (o->mvs[i][0] == mr && o->mvs[i][1] == mc) break;
        if (i < s->count) {
            o->weights[i] += weight;
        } else if (s->count < MAX_REF_MV_STACK) {
            o->mvs[s->count][0] = mr;
            o->mvs[s->count][1] = mc;
            o->weights[s->count] = weight;
            s->count++;
        }
        if (count_newmv && has_newmv_mode(st->mode_grid[idx])) s->newmv++;
        if (is_row) s->row_match++; else s->col_match++;
    }
}

static void mvp_scan_row(MvScan *s, int row_offset, int count_newmv) {
    int n4 = s->n4;
    int end_mi = n4;
    if (s->tp->mi_cols - s->mi_col < end_mi) end_mi = s->tp->mi_cols - s->mi_col;
    if (end_mi > 16) end_mi = 16;
    int col_off = 0;
    if (row_offset < -1 || row_offset > 1) {
        col_off = 1;
        if ((s->mi_col & 1) && n4 < 2) col_off -= 1;
    }
    int use_step_16 = n4 >= 16;
    int i = 0;
    while (i < end_mi) {
        int r = s->mi_row + row_offset, c = s->mi_col + col_off + i;
        if (!mvp_inside(s, r, c)) break;
        int cw4 = s->st->bsize_grid[r * s->tp->mi_cols + c];
        if (cw4 < 1) cw4 = 1; /* uncoded cell == BLOCK_4X4 in the python grids */
        int length = n4 < cw4 ? n4 : cw4;
        if (use_step_16) { if (length < 4) length = 4; }
        else if (row_offset < -1 || row_offset > 1) { if (length < 2) length = 2; }
        int64_t weight = 2;
        if (n4 >= 2 && n4 <= cw4) {
            int inc = -s->max_row_offset + row_offset + 1;
            if (cw4 < inc) inc = cw4; /* square: block height mi == cw4 */
            if (inc > weight) weight = inc;
            s->processed_rows = inc - row_offset - 1;
        }
        mvp_add(s, r, c, weight * length, count_newmv, 1);
        i += length;
    }
}

static void mvp_scan_col(MvScan *s, int col_offset, int count_newmv) {
    int n4 = s->n4;
    int end_mi = n4;
    if (s->tp->mi_rows - s->mi_row < end_mi) end_mi = s->tp->mi_rows - s->mi_row;
    if (end_mi > 16) end_mi = 16;
    int row_off = 0;
    if (col_offset < -1 || col_offset > 1) {
        row_off = 1;
        if ((s->mi_row & 1) && n4 < 2) row_off -= 1;
    }
    int use_step_16 = n4 >= 16;
    int i = 0;
    while (i < end_mi) {
        int r = s->mi_row + row_off + i, c = s->mi_col + col_offset;
        if (!mvp_inside(s, r, c)) break;
        int ch4 = s->st->bsize_grid[r * s->tp->mi_cols + c];
        if (ch4 < 1) ch4 = 1;
        int length = n4 < ch4 ? n4 : ch4;
        if (use_step_16) { if (length < 4) length = 4; }
        else if (col_offset < -1 || col_offset > 1) { if (length < 2) length = 2; }
        int64_t weight = 2;
        if (n4 >= 2 && n4 <= ch4) {
            int inc = -s->max_col_offset + col_offset + 1;
            if (ch4 < inc) inc = ch4;
            if (inc > weight) weight = inc;
            s->processed_cols = inc - col_offset - 1;
        }
        mvp_add(s, r, c, weight * length, count_newmv, 0);
        i += length;
    }
}

static int mvp_has_top_right(int mi_row, int mi_col, int n4) {
    int bs = n4;
    if (bs > 16) return 0;
    int mask_row = mi_row & 15, mask_col = mi_col & 15;
    int has_tr = !((mask_row & bs) && (mask_col & bs));
    int b = bs;
    while (b < 16) {
        if (mask_col & b) {
            if ((mask_col & (2 * b)) && (mask_row & (2 * b))) { has_tr = 0; break; }
        } else break;
        b <<= 1;
    }
    return has_tr;
}

static int32_t clamp32(int32_t v, int32_t lo, int32_t hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

static void find_mv_stack_c(TileParams *tp, TileState *st, int mi_row, int mi_col,
                            int n4, int ref_frame, int ref_frame1, MvStackC *out) {
    MvScan s = {0};
    s.tp = tp; s.st = st; s.mi_row = mi_row; s.mi_col = mi_col; s.n4 = n4;
    s.ref_frame = ref_frame; s.ref_frame1 = ref_frame1; s.out = out;
    memset(out, 0, sizeof(*out));
    int up_avail = mi_row > tp->mi_row0;
    int left_avail = mi_col > tp->mi_col0;
    int row_adj = (n4 < 2 && (mi_row & 1)) ? 1 : 0;
    int col_adj = (n4 < 2 && (mi_col & 1)) ? 1 : 0;
    if (up_avail) {
        int mro = -(MVREF_ROWS << 1) + row_adj;
        if (n4 < 2) mro = -(2 << 1) + row_adj;
        s.max_row_offset = clamp32(mro, tp->mi_row0 - mi_row, tp->mi_row1 - mi_row - 1);
    }
    if (left_avail) {
        int mco = -(MVREF_ROWS << 1) + col_adj;
        if (n4 < 2) mco = -(2 << 1) + col_adj;
        s.max_col_offset = clamp32(mco, tp->mi_col0 - mi_col, tp->mi_col1 - mi_col - 1);
    }
    int abs_mro = s.max_row_offset < 0 ? -s.max_row_offset : s.max_row_offset;
    int abs_mco = s.max_col_offset < 0 ? -s.max_col_offset : s.max_col_offset;
    if (abs_mro >= 1) mvp_scan_row(&s, -1, 1);
    if (abs_mco >= 1) mvp_scan_col(&s, -1, 1);
    if (mvp_has_top_right(mi_row, mi_col, n4) && mvp_inside(&s, mi_row - 1, mi_col + n4))
        mvp_add(&s, mi_row - 1, mi_col + n4, 4, 1, 1);

    int nearest_match = (s.row_match > 0) + (s.col_match > 0);
    int newmv_count = s.newmv;
    for (int i = 0; i < s.count; i++) out->weights[i] += REF_CAT_LEVEL;

    if (mvp_inside(&s, mi_row - 1, mi_col - 1))
        mvp_add(&s, mi_row - 1, mi_col - 1, 4, 0, 1);
    for (int idx = 2; idx <= MVREF_ROWS; idx++) {
        int row_offset = -(idx << 1) + 1 + row_adj;
        int col_offset = -(idx << 1) + 1 + col_adj;
        int aro = row_offset < 0 ? -row_offset : row_offset;
        int aco = col_offset < 0 ? -col_offset : col_offset;
        if (aro <= abs_mro && aro > s.processed_rows) mvp_scan_row(&s, row_offset, 0);
        if (aco <= abs_mco && aco > s.processed_cols) mvp_scan_col(&s, col_offset, 0);
    }

    int ref_match = (s.row_match > 0) + (s.col_match > 0);
    int mode_context = 0;
    if (nearest_match == 0) {
        if (ref_match >= 1) mode_context |= 1;
        if (ref_match == 1) mode_context |= 1 << 4;
        else if (ref_match >= 2) mode_context |= 2 << 4;
    } else if (nearest_match == 1) {
        mode_context |= newmv_count > 0 ? 2 : 3;
        if (ref_match == 1) mode_context |= 3 << 4;
        else if (ref_match >= 2) mode_context |= 4 << 4;
    } else {
        mode_context |= newmv_count >= 1 ? 4 : 5;
        mode_context |= 5 << 4;
    }
    out->mode_context = mode_context;

    /* stable bubble sort by weight desc (exact reference order) */
    int length = s.count;
    while (length > 0) {
        int nr_len = 0;
        for (int i = 1; i < length; i++)
            if (out->weights[i - 1] < out->weights[i]) {
                int32_t t0 = out->mvs[i - 1][0], t1 = out->mvs[i - 1][1];
                int32_t u0 = out->mvs1[i - 1][0], u1 = out->mvs1[i - 1][1];
                int64_t tw = out->weights[i - 1];
                out->mvs[i - 1][0] = out->mvs[i][0]; out->mvs[i - 1][1] = out->mvs[i][1];
                out->mvs1[i - 1][0] = out->mvs1[i][0]; out->mvs1[i - 1][1] = out->mvs1[i][1];
                out->weights[i - 1] = out->weights[i];
                out->mvs[i][0] = t0; out->mvs[i][1] = t1;
                out->mvs1[i][0] = u0; out->mvs1[i][1] = u1;
                out->weights[i] = tw;
                nr_len = i;
            }
        length = nr_len;
    }

    if (ref_frame1 > 0 && s.count < MAX_MV_REF_CAND) {
        /* compound short-stack fill (setup_ref_mv_list rf[1] > NONE):
         * ROW-1/COL-1 sweeps collect per-component exact-ref (ref_id) and
         * sign-adjusted other-ref (ref_diff) lists; combined pairs + the
         * identity-GM zero pad the stack to exactly 2 entries. */
        int32_t ref_id[2][2][2], ref_diff[2][2][2];
        int ref_id_count[2] = {0, 0}, ref_diff_count[2] = {0, 0};
        int mi_width = n4, mi_height = n4;
        if (tp->mi_cols - mi_col < mi_width) mi_width = tp->mi_cols - mi_col;
        if (tp->mi_rows - mi_row < mi_height) mi_height = tp->mi_rows - mi_row;
        if (mi_width > 16) mi_width = 16;
        if (mi_height > 16) mi_height = 16;
        int mi_sz = mi_width < mi_height ? mi_width : mi_height;
        int rfp[2] = {ref_frame, ref_frame1};
        for (int pass = 0; pass < 2; pass++) {
            int avail = pass == 0 ? abs_mro : abs_mco;
            int i = 0;
            while (avail >= 1 && i < mi_sz) {
                int r = pass == 0 ? mi_row - 1 : mi_row + i;
                int c = pass == 0 ? mi_col + i : mi_col - 1;
                int idx = r * tp->mi_cols + c;
                for (int which = 0; which < 2; which++) {
                    int can_rf = which == 0 ? st->ref_grid[idx] : st->ref1_grid[idx];
                    const int32_t *mvsrc = which == 0 ? st->mv_grid : st->mv1_grid;
                    for (int ci = 0; ci < 2; ci++) {
                        if (can_rf == rfp[ci] && ref_id_count[ci] < 2) {
                            ref_id[ci][ref_id_count[ci]][0] = mvsrc[idx * 2];
                            ref_id[ci][ref_id_count[ci]][1] = mvsrc[idx * 2 + 1];
                            ref_id_count[ci]++;
                        } else if (can_rf > 0 && ref_diff_count[ci] < 2) {
                            int32_t mr = mvsrc[idx * 2], mc2 = mvsrc[idx * 2 + 1];
                            if (tp->sign_bias[can_rf] != tp->sign_bias[rfp[ci]]) {
                                mr = -mr; mc2 = -mc2;
                            }
                            ref_diff[ci][ref_diff_count[ci]][0] = mr;
                            ref_diff[ci][ref_diff_count[ci]][1] = mc2;
                            ref_diff_count[ci]++;
                        }
                    }
                }
                int step = st->bsize_grid[idx] < 1 ? 1 : st->bsize_grid[idx];
                i += step;
            }
        }
        int32_t comp_list[MAX_MV_REF_CAND][2][2];
        for (int ci = 0; ci < 2; ci++) {
            int comp_idx = 0;
            for (int li = 0; li < ref_id_count[ci] && comp_idx < MAX_MV_REF_CAND; li++, comp_idx++) {
                comp_list[comp_idx][ci][0] = ref_id[ci][li][0];
                comp_list[comp_idx][ci][1] = ref_id[ci][li][1];
            }
            for (int li = 0; li < ref_diff_count[ci] && comp_idx < MAX_MV_REF_CAND; li++, comp_idx++) {
                comp_list[comp_idx][ci][0] = ref_diff[ci][li][0];
                comp_list[comp_idx][ci][1] = ref_diff[ci][li][1];
            }
            for (; comp_idx < MAX_MV_REF_CAND; comp_idx++) {
                /* global-MV pad (spec GlobalMvs; identity -> zero) */
                comp_list[comp_idx][ci][0] = tp->gm_mv[rfp[ci]][0];
                comp_list[comp_idx][ci][1] = tp->gm_mv[rfp[ci]][1];
            }
        }
        if (s.count) {
            if (comp_list[0][0][0] == out->mvs[0][0] && comp_list[0][0][1] == out->mvs[0][1] &&
                comp_list[0][1][0] == out->mvs1[0][0] && comp_list[0][1][1] == out->mvs1[0][1]) {
                out->mvs[1][0] = comp_list[1][0][0]; out->mvs[1][1] = comp_list[1][0][1];
                out->mvs1[1][0] = comp_list[1][1][0]; out->mvs1[1][1] = comp_list[1][1][1];
            } else {
                out->mvs[1][0] = comp_list[0][0][0]; out->mvs[1][1] = comp_list[0][0][1];
                out->mvs1[1][0] = comp_list[0][1][0]; out->mvs1[1][1] = comp_list[0][1][1];
            }
            out->weights[1] = 2;
            s.count = 2;
        } else {
            for (int idx = 0; idx < MAX_MV_REF_CAND; idx++) {
                out->mvs[idx][0] = comp_list[idx][0][0]; out->mvs[idx][1] = comp_list[idx][0][1];
                out->mvs1[idx][0] = comp_list[idx][1][0]; out->mvs1[idx][1] = comp_list[idx][1][1];
                out->weights[idx] = 2;
            }
            s.count = 2;
        }
    }

    /* light re-scan (ROW-1 / COL-1) when short: accepts ANY inter neighbor,
     * flipping MVs whose ref sign-bias differs (codec/mvp.py light_add;
     * spec 7.10.2 extended search) */
    if (ref_frame1 <= 0 && s.count < MAX_MV_REF_CAND) {
        int mi_width = n4, mi_height = n4;
        if (tp->mi_cols - mi_col < mi_width) mi_width = tp->mi_cols - mi_col;
        if (tp->mi_rows - mi_row < mi_height) mi_height = tp->mi_rows - mi_row;
        if (mi_width > 16) mi_width = 16;
        if (mi_height > 16) mi_height = 16;
        int mi_sz = mi_width < mi_height ? mi_width : mi_height;
        for (int pass = 0; pass < 2; pass++) {
            int avail = pass == 0 ? abs_mro : abs_mco;
            int i = 0;
            while (avail >= 1 && i < mi_sz && s.count < MAX_MV_REF_CAND) {
                int r = pass == 0 ? mi_row - 1 : mi_row + i;
                int c = pass == 0 ? mi_col + i : mi_col - 1;
                int idx = r * tp->mi_cols + c;
                for (int which = 0; which < 2; which++) {
                    int rv = which == 0 ? st->ref_grid[idx] : st->ref1_grid[idx];
                    if (rv <= 0) continue;
                    const int32_t *mvsrc = which == 0 ? st->mv_grid : st->mv1_grid;
                    int32_t mr = mvsrc[idx * 2], mc = mvsrc[idx * 2 + 1];
                    if (tp->sign_bias[rv] != tp->sign_bias[ref_frame]) { mr = -mr; mc = -mc; }
                    int j = 0;
                    for (; j < s.count; j++)
                        if (out->mvs[j][0] == mr && out->mvs[j][1] == mc) break;
                    if (j == s.count) {
                        out->mvs[s.count][0] = mr; out->mvs[s.count][1] = mc;
                        out->weights[s.count] = 2;
                        s.count++;
                    }
                }
                i += st->bsize_grid[idx] < 1 ? 1 : st->bsize_grid[idx];
            }
        }
        /* tail fill with the ref's global MV, clamped to the block's legal
         * window (codec/mvp.py _clamp_stack_mv twin); count unchanged */
        int32_t gb = n4 * 32 + MV_BORDER;
        int32_t g0 = clamp32(tp->gm_mv[ref_frame][0], -(mi_row * 32) - gb,
                             (tp->mi_rows - n4 - mi_row) * 32 + gb);
        int32_t g1 = clamp32(tp->gm_mv[ref_frame][1], -(mi_col * 32) - gb,
                             (tp->mi_cols - n4 - mi_col) * 32 + gb);
        for (int k = s.count; k < MAX_MV_REF_CAND; k++) {
            out->mvs[k][0] = g0; out->mvs[k][1] = g1;
        }
    }

    /* clamp to the frame-relative legal window */
    int32_t bw8 = n4 * 4 * 8, bh8 = bw8;
    int32_t to_left = -(mi_col * 32);
    int32_t to_right = (tp->mi_cols - n4 - mi_col) * 32;
    int32_t to_top = -(mi_row * 32);
    int32_t to_bottom = (tp->mi_rows - n4 - mi_row) * 32;
    for (int i = 0; i < s.count; i++) {
        out->mvs[i][1] = clamp32(out->mvs[i][1], to_left - bw8 - MV_BORDER, to_right + bw8 + MV_BORDER);
        out->mvs[i][0] = clamp32(out->mvs[i][0], to_top - bh8 - MV_BORDER, to_bottom + bh8 + MV_BORDER);
        if (ref_frame1 > 0) {
            out->mvs1[i][1] = clamp32(out->mvs1[i][1], to_left - bw8 - MV_BORDER, to_right + bw8 + MV_BORDER);
            out->mvs1[i][0] = clamp32(out->mvs1[i][0], to_top - bh8 - MV_BORDER, to_bottom + bh8 + MV_BORDER);
        }
    }
    out->count = s.count;
}

/* ---------------- compound reference-mode / ref-type contexts (libaom
 * av1_get_reference_mode_context / av1_get_comp_reference_type_context) */

typedef struct { int is_inter, has2, bwd0, uni, ref0; } NbInfo;

static NbInfo nb_info(TileState *st, TileParams *tp, int r, int c) {
    int idx = r * tp->mi_cols + c;
    NbInfo n;
    int r0 = st->ref_grid[idx], r1 = st->ref1_grid[idx];
    n.is_inter = r0 >= 1;
    n.has2 = r1 >= 1;
    n.bwd0 = r0 >= 5;
    n.uni = n.has2 && !((r0 >= 5) ^ (r1 >= 5));
    n.ref0 = r0;
    return n;
}

static int reference_mode_ctx(TileState *st, TileParams *tp, int mi_row, int mi_col) {
    int has_a = mi_row > tp->mi_row0, has_l = mi_col > tp->mi_col0;
    if (has_a && has_l) {
        NbInfo A = nb_info(st, tp, mi_row - 1, mi_col);
        NbInfo L = nb_info(st, tp, mi_row, mi_col - 1);
        if (!A.has2 && !L.has2) return A.bwd0 ^ L.bwd0;
        if (!A.has2) return 2 + (A.bwd0 || !A.is_inter);
        if (!L.has2) return 2 + (L.bwd0 || !L.is_inter);
        return 4;
    }
    if (has_a || has_l) {
        NbInfo E = nb_info(st, tp, has_a ? mi_row - 1 : mi_row, has_a ? mi_col : mi_col - 1);
        return E.has2 ? 3 : E.bwd0;
    }
    return 1;
}

static int comp_ref_type_ctx(TileState *st, TileParams *tp, int mi_row, int mi_col) {
    int has_a = mi_row > tp->mi_row0, has_l = mi_col > tp->mi_col0;
    if (has_a && has_l) {
        NbInfo A = nb_info(st, tp, mi_row - 1, mi_col);
        NbInfo L = nb_info(st, tp, mi_row, mi_col - 1);
        int a_intra = !A.is_inter, l_intra = !L.is_inter;
        if (a_intra && l_intra) return 2;
        if (a_intra || l_intra) {
            NbInfo E = a_intra ? L : A;
            return E.has2 ? 1 + 2 * E.uni : 2;
        }
        int a_sg = !A.has2, l_sg = !L.has2;
        if (a_sg && l_sg) return 1 + 2 * !(A.bwd0 ^ L.bwd0);
        if (a_sg || l_sg) {
            int uni = a_sg ? L.uni : A.uni;
            if (!uni) return 1;
            return 3 + !(A.bwd0 ^ L.bwd0);
        }
        if (!A.uni && !L.uni) return 0;
        if (!A.uni || !L.uni) return 2;
        return 3 + ((A.ref0 == 5) == (L.ref0 == 5));
    }
    if (has_a || has_l) {
        NbInfo E = nb_info(st, tp, has_a ? mi_row - 1 : mi_row, has_a ? mi_col : mi_col - 1);
        if (!E.is_inter) return 2;
        return E.has2 ? 4 * E.uni : 2;
    }
    return 2;
}

static int drl_ctx_of(MvStackC *stk, int idx) {
    if (stk->weights[idx] >= REF_CAT_LEVEL && stk->weights[idx + 1] >= REF_CAT_LEVEL) return 0;
    if (stk->weights[idx] >= REF_CAT_LEVEL && stk->weights[idx + 1] < REF_CAT_LEVEL) return 1;
    return 2;
}

/* NMV component writer — C twin of codec/mv.MvCoder._write_component
 * (allow_hp = 0, force_int = 0: fr always written, hp never). */
static void write_mv_component_c(Ec *e, TileParams *tp, int comp, int32_t v, int update) {
    int sign = v < 0;
    int32_t mag = sign ? -v : v;
    int32_t z = mag - 1;
    int mv_class = 0;
    int32_t offset = z;
    if (z >= 16) {
        int32_t t = z >> 3;
        int bl = 0;
        while (t) { bl++; t >>= 1; }
        mv_class = bl - 1;
        if (mv_class > 10) mv_class = 10;
        offset = z - (2 << (mv_class + 2));
    }
    int d = offset >> 3, fr = (offset >> 1) & 3;
    ec_encode_symbol(e, tp->nmv_sign + comp * 3, 2, sign, update);
    ec_encode_symbol(e, tp->nmv_classes + comp * 12, 11, mv_class, update);
    if (mv_class == 0) {
        ec_encode_symbol(e, tp->nmv_class0 + comp * 3, 2, d, update);
    } else {
        for (int i = 0; i < mv_class; i++)
            ec_encode_symbol(e, tp->nmv_bits + (comp * 10 + i) * 3, 2, (d >> i) & 1, update);
    }
    int32_t *fpc = mv_class == 0 ? tp->nmv_class0_fp + (comp * 2 + d) * 5
                                 : tp->nmv_fp + comp * 5;
    ec_encode_symbol(e, fpc, 4, fr, update);
}

static void write_mv_c(Ec *e, TileParams *tp, int32_t mvr, int32_t mvc,
                       int32_t pr, int32_t pc, int update) {
    int32_t dr = mvr - pr, dc = mvc - pc;
    int joint = (dc != 0 ? 1 : 0) | (dr != 0 ? 2 : 0);
    ec_encode_symbol(e, tp->nmv_joints, 4, joint, update);
    if (dr != 0) write_mv_component_c(e, tp, 0, dr, update);
    if (dc != 0) write_mv_component_c(e, tp, 1, dc, update);
}

static int32_t cdf_elem_prob(const int32_t *cdf, int k) {
    int32_t prev = k == 0 ? 32768 : cdf[k - 1];
    return prev - cdf[k];
}

static void write_partition_c(Ec *e, TileParams *tp, TileState *st, int mi_row, int mi_col,
                              int bw4, int part) {
    int bsl = 0;
    while ((2 << bsl) < bw4) bsl++; /* bw4=2 -> 0 ... bw4=16 -> 3 */
    int above = (st->above_part[mi_col] >> bsl) & 1;
    int left = (st->left_part[mi_row] >> bsl) & 1;
    int ctx = (left * 2 + above) + bsl * 4;
    int half = bw4 >> 1;
    int has_rows = (mi_row + half) < tp->mi_rows;
    int has_cols = (mi_col + half) < tp->mi_cols;
    int32_t *cdf = tp->partition + ctx * 11;
    if (bw4 == 2) { /* 8x8: 4-ary */
        ec_encode_symbol(e, cdf, 4, part, tp->update);
    } else if (has_rows && has_cols) {
        ec_encode_symbol(e, cdf, 10, part, tp->update);
    } else if (!has_rows && !has_cols) {
        /* forced split, no symbol */
    } else {
        /* gathered bool: split-alike probability (spec split_or_horz /
           split_or_vert; the sets are the partitions whose VISIBLE half
           contains a split edge — right edge sums HORZ-ish, bottom edge
           sums VERT-ish). */
        int32_t p0 = 32768;
        if (has_rows) { /* right edge: split_or_vert (horz-alike set) */
            p0 -= cdf_elem_prob(cdf, 1);  /* HORZ */
            p0 -= cdf_elem_prob(cdf, 3);  /* SPLIT */
            p0 -= cdf_elem_prob(cdf, 4);  /* HORZ_A */
            p0 -= cdf_elem_prob(cdf, 5);  /* HORZ_B */
            p0 -= cdf_elem_prob(cdf, 6);  /* VERT_A */
            p0 -= cdf_elem_prob(cdf, 8);  /* HORZ_4 */
        } else { /* bottom edge: split_or_horz (vert-alike set) */
            p0 -= cdf_elem_prob(cdf, 2);  /* VERT */
            p0 -= cdf_elem_prob(cdf, 3);  /* SPLIT */
            p0 -= cdf_elem_prob(cdf, 4);  /* HORZ_A */
            p0 -= cdf_elem_prob(cdf, 6);  /* VERT_A */
            p0 -= cdf_elem_prob(cdf, 7);  /* VERT_B */
            p0 -= cdf_elem_prob(cdf, 9);  /* VERT_4 */
        }
        int32_t g[3] = {32768 - p0, 0, 0};
        ec_encode_symbol(e, g, 2, part == 3, 0);
    }
    if (part == 0) { /* NONE: update ctx over the block */
        int idx = 0;
        while ((8 << idx) < bw4 * 4) idx++;
        for (int i = 0; i < bw4; i++) st->above_part[mi_col + i] = part_ctx_above[idx];
        for (int i = 0; i < bw4; i++) st->left_part[mi_row + i] = part_ctx_left[idx];
    }
}

static void set_entropy_ctx(TileState *st, int plane, int px4, int py4, int w4, int h4, int32_t v) {
    for (int i = 0; i < w4; i++) st->above_ctx[plane][px4 + i] = v;
    for (int i = 0; i < h4; i++) st->left_ctx[plane][py4 + i] = v;
}

static void txb_ctx_of(TileState *st, int plane, int px4, int py4, int w4, int h4, int luma_whole,
                       int *skip_ctx, int *dc_ctx) {
    int32_t *a = st->above_ctx[plane] + px4;
    int32_t *l = st->left_ctx[plane] + py4;
    int dc_sum = 0;
    for (int i = 0; i < w4; i++) {
        int s = (a[i] >> 6) & 3;
        dc_sum += s == 1 ? -1 : (s == 2 ? 1 : 0);
    }
    for (int i = 0; i < h4; i++) {
        int s = (l[i] >> 6) & 3;
        dc_sum += s == 1 ? -1 : (s == 2 ? 1 : 0);
    }
    *dc_ctx = dc_sum == 0 ? 0 : (dc_sum < 0 ? 1 : 2);
    if (plane == 0) {
        *skip_ctx = 0; /* whole-block tx: plane bsize == tx bsize */
        (void)luma_whole;
    } else {
        int any_a = 0, any_l = 0;
        for (int i = 0; i < w4; i++) any_a |= a[i] != 0;
        for (int i = 0; i < h4; i++) any_l |= l[i] != 0;
        *skip_ctx = (any_a != 0) + (any_l != 0) + 7;
    }
}

/* ---------------- loop-restoration unit writers (tile_codec._code_lr_unit
 * twins: spec 5.9.x quniform / subexp / recentering + the LR cdfs) */

static void ec_quniform(Ec *e, int n, int v) {
    if (n <= 1) return;
    int l = 1, t = n - 1;
    while (t > 1) { l++; t >>= 1; } /* bit_length(n-1), n>=2 -> l>=1 */
    if (l < 1) l = 1;
    int m = (1 << l) - n;
    if (v < m) {
        ec_encode_literal(e, v, l - 1);
    } else {
        ec_encode_literal(e, m + ((v - m) >> 1), l - 1);
        ec_encode_literal(e, (v - m) & 1, 1);
    }
}

static void ec_subexp(Ec *e, int mx, int k, int u) {
    int i = 0, mk = 0;
    for (;;) {
        int b2 = i ? k + i - 1 : k;
        int a = 1 << b2;
        if (mx <= mk + 3 * a) {
            ec_quniform(e, mx - mk, u - mk);
            return;
        }
        int more = u >= mk + a;
        ec_encode_literal(e, more, 1);
        if (!more) {
            ec_encode_literal(e, u - mk, b2);
            return;
        }
        i++;
        mk += a;
    }
}

static int lr_recenter(int r, int v) {
    if (v > 2 * r) return v;
    if (v >= r) return (v - r) * 2;
    return (r - v) * 2 - 1;
}

static void ec_signed_subexp(Ec *e, int low, int high, int k, int ref, int v) {
    int mx = high - low;
    int r = ref - low;
    int x = v - low;
    int u = (r << 1) <= mx ? lr_recenter(r, x) : lr_recenter(mx - 1 - r, mx - 1 - x);
    ec_subexp(e, mx, k, u);
}

static const int wiener_min[3] = {-5, -23, -17};
static const int wiener_max[3] = {10, 8, 46};
static const int wiener_k[3] = {1, 2, 3};
static const int sgr_xqd_min[2] = {-96, -32};
static const int sgr_xqd_max[2] = {31, 95};
/* SGR_PARAMS radii per ep: (r0, r1) */
static const int sgr_r0[16] = {2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 0, 0, 0, 0, 2, 2};
static const int sgr_r1[16] = {1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0};

typedef struct {
    int ref_w[3][2][3]; /* per plane, per pass, taps j0..j2 */
    int ref_x[3][2];
} LrState;

static void lr_state_init(LrState *s) {
    for (int p = 0; p < 3; p++) {
        for (int ps = 0; ps < 2; ps++) {
            s->ref_w[p][ps][0] = 3; s->ref_w[p][ps][1] = -7; s->ref_w[p][ps][2] = 15;
        }
        s->ref_x[p][0] = -32; s->ref_x[p][1] = 31;
    }
}

static void write_lr_unit(Ec *e, TileParams *tp, LrState *ls, const int32_t *op) {
    int plane = op[1], ftype = op[2], rtype = op[3];
    int chroma = plane > 0;
    if (ftype == 3) { /* RESTORE_SWITCHABLE */
        ec_encode_symbol(e, tp->switchable_restore, 3, rtype, tp->update);
    } else if (ftype == 1) { /* RESTORE_WIENER */
        ec_encode_symbol(e, tp->wiener_restore, 2, rtype == 1, tp->update);
    } else { /* RESTORE_SGRPROJ */
        ec_encode_symbol(e, tp->sgrproj_restore, 2, rtype == 2, tp->update);
    }
    if (rtype == 1) { /* WIENER */
        for (int ps = 0; ps < 2; ps++)
            for (int j = chroma ? 1 : 0; j < 3; j++) {
                int v = op[4 + ps * 3 + j];
                ec_signed_subexp(e, wiener_min[j], wiener_max[j] + 1, wiener_k[j],
                                 ls->ref_w[plane][ps][j], v);
                ls->ref_w[plane][ps][j] = v;
            }
    } else if (rtype == 2) { /* SGRPROJ */
        int ep = op[10];
        ec_encode_literal(e, ep, 4); /* SGRPROJ_PARAMS_BITS */
        int rad[2] = {sgr_r0[ep], sgr_r1[ep]};
        for (int i = 0; i < 2; i++) {
            int v = op[11 + i];
            if (rad[i])
                ec_signed_subexp(e, sgr_xqd_min[i], sgr_xqd_max[i] + 1, 4,
                                 ls->ref_x[plane][i], v);
            ls->ref_x[plane][i] = v;
        }
    }
}

int64_t ec_encode_tile_ops(Ec *e, TileParams *tp, const int32_t *ops, int64_t n_ops,
                           const int32_t *levels, TileState *st) {
    LrState lrs;
    lr_state_init(&lrs);
    for (int64_t i = 0; i < n_ops; i++) {
        const int32_t *op = ops + i * OP_COLS;
        int mi_row = op[OPC_MI_ROW], mi_col = op[OPC_MI_COL], bw4 = op[OPC_BW4];
        if (op[OPC_KIND] == 2) { /* loop-restoration unit */
            write_lr_unit(e, tp, &lrs, op);
            continue;
        }
        if (op[OPC_KIND] == 0) {
            write_partition_c(e, tp, st, mi_row, mi_col, bw4, op[OPC_PART_OR_YMODE]);
            continue;
        }
        int y_mode = op[OPC_PART_OR_YMODE], uv_mode = op[OPC_UV_MODE], skip = op[OPC_SKIP];
        /* skip symbol */
        int above_sk = 0, left_sk = 0;
        if (mi_row > tp->mi_row0 && st->mode_grid[(mi_row - 1) * tp->mi_cols + mi_col] >= 0)
            above_sk = st->skip_grid[(mi_row - 1) * tp->mi_cols + mi_col];
        if (mi_col > tp->mi_col0 && st->mode_grid[mi_row * tp->mi_cols + mi_col - 1] >= 0)
            left_sk = st->skip_grid[mi_row * tp->mi_cols + mi_col - 1];
        ec_encode_symbol(e, tp->skip + (above_sk + left_sk) * 3, 2, skip, tp->update);
        int ref_frame = op[OPC_REF];
        int32_t mvr = op[OPC_MVY], mvc = op[OPC_MVX];
        if (tp->frame_is_intra) {
            /* kf y mode */
            int am = 0, lm = 0;
            if (mi_row > tp->mi_row0 && st->mode_grid[(mi_row - 1) * tp->mi_cols + mi_col] >= 0)
                am = intra_mode_ctx[st->mode_grid[(mi_row - 1) * tp->mi_cols + mi_col]];
            if (mi_col > tp->mi_col0 && st->mode_grid[mi_row * tp->mi_cols + mi_col - 1] >= 0)
                lm = intra_mode_ctx[st->mode_grid[mi_row * tp->mi_cols + mi_col - 1]];
            ec_encode_symbol(e, tp->kf_y + (am * 5 + lm) * 14, 13, y_mode, tp->update);
            if (op[OPC_ANGLE_Y] >= 0)
                ec_encode_symbol(e, tp->angle + (y_mode - 1) * 8, 7, op[OPC_ANGLE_Y], tp->update);
        } else {
            /* is_inter flag (tile_codec._intra_inter_ctx) */
            int has_above = mi_row > tp->mi_row0, has_left = mi_col > tp->mi_col0;
            int a_intra = has_above && st->ref_grid[(mi_row - 1) * tp->mi_cols + mi_col] == 0;
            int l_intra = has_left && st->ref_grid[mi_row * tp->mi_cols + mi_col - 1] == 0;
            int ictx;
            if (has_above && has_left) ictx = (a_intra && l_intra) ? 3 : (a_intra || l_intra);
            else if (has_above || has_left) ictx = 2 * (has_above ? a_intra : l_intra);
            else ictx = 0;
            int is_inter = ref_frame >= 1;
            ec_encode_symbol(e, tp->intra_inter + ictx * 3, 2, is_inter, tp->update);
            if (is_inter) {
                int ref2 = op[OPC_REF2];
                int is_comp = tp->reference_select && ref2 >= 1;
                int32_t mv1r = op[OPC_MV2Y], mv1c = op[OPC_MV2X];
                /* neighbor ref counts (both refs of each coded neighbor —
                 * tile_codec._neighbor_ref_counts) */
                int64_t cnt[8] = {0};
                if (has_above) {
                    int gi = (mi_row - 1) * tp->mi_cols + mi_col;
                    int rr = st->ref_grid[gi];
                    if (rr >= 1) {
                        cnt[rr]++;
                        int r1 = st->ref1_grid[gi];
                        if (r1 >= 1) cnt[r1]++;
                    }
                }
                if (has_left) {
                    int gi = mi_row * tp->mi_cols + mi_col - 1;
                    int rr = st->ref_grid[gi];
                    if (rr >= 1) {
                        cnt[rr]++;
                        int r1 = st->ref1_grid[gi];
                        if (r1 >= 1) cnt[r1]++;
                    }
                }
#define REFCTX(a, b) ((a) == (b) ? 1 : ((a) < (b) ? 0 : 2))
                if (tp->reference_select) {
                    int rmctx = reference_mode_ctx(st, tp, mi_row, mi_col);
                    ec_encode_symbol(e, tp->comp_inter + rmctx * 3, 2, is_comp, tp->update);
                }
                if (is_comp) {
                    /* BIDIR compound pair (write_ref_frames comp side) */
                    int tctx = comp_ref_type_ctx(st, tp, mi_row, mi_col);
                    ec_encode_symbol(e, tp->comp_ref_type + tctx * 3, 2, 1, tp->update);
                    int p0 = REFCTX(cnt[1] + cnt[2], cnt[3] + cnt[4]);
                    int bit0 = ref_frame == 3 || ref_frame == 4;
                    ec_encode_symbol(e, tp->comp_ref + (p0 * 3 + 0) * 3, 2, bit0, tp->update);
                    if (bit0) {
                        int p2 = REFCTX(cnt[3], cnt[4]);
                        ec_encode_symbol(e, tp->comp_ref + (p2 * 3 + 2) * 3, 2,
                                         ref_frame == 4, tp->update);
                    } else {
                        int p1 = REFCTX(cnt[1], cnt[2]);
                        ec_encode_symbol(e, tp->comp_ref + (p1 * 3 + 1) * 3, 2,
                                         ref_frame == 2, tp->update);
                    }
                    int pb = REFCTX(cnt[5] + cnt[6], cnt[7]);
                    int bitb = ref2 == 7;
                    ec_encode_symbol(e, tp->comp_bwdref + (pb * 2 + 0) * 3, 2, bitb, tp->update);
                    if (!bitb) {
                        int pb1 = REFCTX(cnt[5], cnt[6]);
                        ec_encode_symbol(e, tp->comp_bwdref + (pb1 * 2 + 1) * 3, 2,
                                         ref2 == 6, tp->update);
                    }
                    MvStackC stk;
                    find_mv_stack_c(tp, st, mi_row, mi_col, bw4, ref_frame, ref2, &stk);
                    int mode = y_mode; /* NEW_NEWMV = 24 from the op stream */
                    int ref_mv_idx = op[OPC_REFMVIDX];
                    if (mode == 24 && mvr == stk.mvs[0][0] && mvc == stk.mvs[0][1] &&
                        mv1r == stk.mvs1[0][0] && mv1c == stk.mvs1[0][1]) {
                        mode = 17; /* NEAREST_NEARESTMV downgrade */
                        ref_mv_idx = 0;
                        y_mode = mode;
                    }
                    /* Compound_Mode_Ctx_Map (spec read_inter_compound_mode) */
                    static const int cmap[3][5] = {
                        {0, 1, 1, 1, 1}, {1, 2, 3, 4, 4}, {4, 4, 5, 6, 7}};
                    int refmv_ctx = (stk.mode_context >> 4) & 15;
                    int newmv_ctx = stk.mode_context & 7;
                    int cctx = cmap[refmv_ctx >> 1][newmv_ctx < 4 ? newmv_ctx : 4];
                    ec_encode_symbol(e, tp->comp_mode + cctx * 9, 8, mode - 17, tp->update);
                    if (has_newmv_mode(mode)) {
                        for (int idx = 0; idx < 2; idx++) {
                            if (stk.count > idx + 1) {
                                int bit = ref_mv_idx != idx;
                                ec_encode_symbol(e, tp->drl + drl_ctx_of(&stk, idx) * 3, 2,
                                                 bit, tp->update);
                                if (!bit) break;
                            }
                        }
                    } else if (mode == 18) { /* NEAR_NEARMV */
                        for (int idx = 1; idx < 3; idx++) {
                            if (stk.count > idx + 1) {
                                int bit = ref_mv_idx != idx;
                                ec_encode_symbol(e, tp->drl + drl_ctx_of(&stk, idx) * 3, 2,
                                                 bit, tp->update);
                                if (!bit) break;
                            }
                        }
                    }
                    if (mode == 24) { /* NEW_NEWMV: both MVs */
                        write_mv_c(e, tp, mvr, mvc, stk.mvs[ref_mv_idx][0],
                                   stk.mvs[ref_mv_idx][1], tp->update);
                        write_mv_c(e, tp, mv1r, mv1c, stk.mvs1[ref_mv_idx][0],
                                   stk.mvs1[ref_mv_idx][1], tp->update);
                    }
                    goto comp_done;
                }
                {
                int p1 = REFCTX(cnt[1] + cnt[2] + cnt[3] + cnt[4], cnt[5] + cnt[6] + cnt[7]);
                int bit0 = ref_frame >= 5;
                ec_encode_symbol(e, tp->single_ref + (p1 * 6 + 0) * 3, 2, bit0, tp->update);
                if (bit0) {
                    int p2 = REFCTX(cnt[5] + cnt[6], cnt[7]);
                    int b = ref_frame == 7;
                    ec_encode_symbol(e, tp->single_ref + (p2 * 6 + 1) * 3, 2, b, tp->update);
                    if (!b) {
                        int p6 = REFCTX(cnt[5], cnt[6]);
                        ec_encode_symbol(e, tp->single_ref + (p6 * 6 + 5) * 3, 2,
                                         ref_frame == 6, tp->update);
                    }
                } else {
                    int p3 = REFCTX(cnt[1] + cnt[2], cnt[3] + cnt[4]);
                    int b = ref_frame == 3 || ref_frame == 4;
                    ec_encode_symbol(e, tp->single_ref + (p3 * 6 + 2) * 3, 2, b, tp->update);
                    if (b) {
                        int p5 = REFCTX(cnt[3], cnt[4]);
                        ec_encode_symbol(e, tp->single_ref + (p5 * 6 + 4) * 3, 2,
                                         ref_frame == 4, tp->update);
                    } else {
                        int p4 = REFCTX(cnt[1], cnt[2]);
                        ec_encode_symbol(e, tp->single_ref + (p4 * 6 + 3) * 3, 2,
                                         ref_frame == 2, tp->update);
                    }
                }
                /* MVP stack + mode flags + drl + mv */
                MvStackC stk;
                find_mv_stack_c(tp, st, mi_row, mi_col, bw4, ref_frame, 0, &stk);
                int mode = y_mode; /* InterMode: 13 NEAREST, 14 NEAR, 15 GLOBAL, 16 NEW */
                int ref_mv_idx = op[OPC_REFMVIDX];
                if (mode == 16 && mvr == stk.mvs[0][0] && mvc == stk.mvs[0][1]) {
                    mode = 13; /* NEARESTMV downgrade: same MV, no payload */
                    ref_mv_idx = 0;
                    y_mode = mode;
                }
                ec_encode_symbol(e, tp->newmv + (stk.mode_context & 7) * 3, 2,
                                 mode != 16, tp->update);
                if (mode != 16) {
                    ec_encode_symbol(e, tp->zeromv + ((stk.mode_context >> 3) & 1) * 3, 2,
                                     mode != 15, tp->update);
                    if (mode != 15)
                        ec_encode_symbol(e, tp->refmv + ((stk.mode_context >> 4) & 15) * 3, 2,
                                         mode != 13, tp->update);
                }
                /* drl (tile_codec._code_drl) */
                if (mode == 16) {
                    for (int idx = 0; idx < 2; idx++) {
                        if (stk.count > idx + 1) {
                            int bit = ref_mv_idx != idx;
                            ec_encode_symbol(e, tp->drl + drl_ctx_of(&stk, idx) * 3, 2,
                                             bit, tp->update);
                            if (!bit) break;
                        }
                    }
                } else if (mode == 14) {
                    for (int idx = 1; idx < 3; idx++) {
                        if (stk.count > idx + 1) {
                            int bit = ref_mv_idx != idx;
                            ec_encode_symbol(e, tp->drl + drl_ctx_of(&stk, idx) * 3, 2,
                                             bit, tp->update);
                            if (!bit) break;
                        }
                    }
                }
                if (mode == 16)
                    write_mv_c(e, tp, mvr, mvc, stk.mvs[ref_mv_idx][0],
                               stk.mvs[ref_mv_idx][1], tp->update);
                }
#undef REFCTX
            comp_done:;
            } else {
                /* intra in inter frame: size-group y_mode cdf */
                ec_encode_symbol(e, tp->y_mode + op[OPC_SIZEGROUP] * 14, 13, y_mode, tp->update);
                if (op[OPC_ANGLE_Y] >= 0)
                    ec_encode_symbol(e, tp->angle + (y_mode - 1) * 8, 7, op[OPC_ANGLE_Y], tp->update);
            }
        }
        int is_inter_blk = ref_frame >= 1;
        if (!is_inter_blk) {
            /* uv mode (intra blocks only) */
            int cfl_allowed = bw4 <= 8;
            ec_encode_symbol(e, tp->uv_mode + (cfl_allowed * 13 + y_mode) * 15,
                             cfl_allowed ? 14 : 13, uv_mode, tp->update);
            if (op[OPC_ANGLE_UV] >= 0)
                ec_encode_symbol(e, tp->angle + (uv_mode - 1) * 8, 7, op[OPC_ANGLE_UV], tp->update);
        }
        /* mode/skip/ref/mv grids */
        int ref2_blk = (tp->reference_select && op[OPC_REF2] >= 1) ? op[OPC_REF2] : 0;
        for (int r = 0; r < bw4; r++)
            for (int c = 0; c < bw4; c++) {
                int gi = (mi_row + r) * tp->mi_cols + mi_col + c;
                st->mode_grid[gi] = (int8_t)y_mode;
                st->skip_grid[gi] = (uint8_t)skip;
                st->ref_grid[gi] = (int8_t)(is_inter_blk ? ref_frame : 0);
                st->bsize_grid[gi] = (int8_t)bw4;
                st->mv_grid[gi * 2] = mvr;
                st->mv_grid[gi * 2 + 1] = mvc;
                st->ref1_grid[gi] = (int8_t)(is_inter_blk ? ref2_blk : 0);
                st->mv1_grid[gi * 2] = ref2_blk ? op[OPC_MV2Y] : 0;
                st->mv1_grid[gi * 2 + 1] = ref2_blk ? op[OPC_MV2X] : 0;
            }
        if (skip) {
            set_entropy_ctx(st, 0, mi_col, mi_row, bw4, bw4, 0);
            int c4 = bw4 >> 1 ? bw4 >> 1 : 1;
            set_entropy_ctx(st, 1, mi_col >> 1, mi_row >> 1, c4, c4, 0);
            set_entropy_ctx(st, 2, mi_col >> 1, mi_row >> 1, c4, c4, 0);
            continue;
        }
        /* residual: luma then chroma */
        int lg = 0;
        while ((2 << lg) < bw4) lg++;
        int tx_y = luma_txsize_by_log2[lg];
        int tx_uv = uv_txsize_by_log2[lg];
        for (int plane = 0; plane < 3; plane++) {
            int tx_size = plane == 0 ? tx_y : tx_uv;
            int pl = plane > 0;
            int px4 = plane == 0 ? mi_col : mi_col >> 1;
            int py4 = plane == 0 ? mi_row : mi_row >> 1;
            int tw4 = txw_by_txsize[tx_size] >> 2;
            if (tw4 < 1) tw4 = 1;
            /* adjusted (coded) size: 64 -> 32 */
            int adj = tx_size == 4 ? 3 : tx_size;
            int aw = txw_by_txsize[adj];
            int sctx, dctx;
            txb_ctx_of(st, plane, px4, py4, tw4, tw4, 1, &sctx, &dctx);
            int txs_ctx = tx_size; /* square sizes: entropy ctx == tx_size */
            int32_t lvl_off = op[OPC_LVL_Y + plane];
            const int32_t *coeffs = lvl_off >= 0 ? levels + lvl_off : NULL;
            int eob_zero = 1;
            if (coeffs) {
                for (int k = 0; k < aw * aw; k++)
                    if (coeffs[k]) {
                        eob_zero = 0;
                        break;
                    }
            }
            ec_encode_symbol(e, tp->txb_skip + (txs_ctx * 13 + sctx) * 3, 2, eob_zero, tp->update);
            if (eob_zero) {
                set_entropy_ctx(st, plane, px4, py4, tw4, tw4, 0);
                continue;
            }
            int tx_type = 0;
            if (plane == 0) {
                if (op[OPC_TXSIG_NSYM] > 1 && tp->qindex_positive) {
                    int32_t *cdf = is_inter_blk
                        ? tp->inter_ext_tx + (op[OPC_TXSIG_ESET] * 4 + op[OPC_TXSIG_SQR]) * 17
                        : tp->intra_ext_tx +
                          ((op[OPC_TXSIG_ESET] * 4 + op[OPC_TXSIG_SQR]) * 13 + y_mode) * 8;
                    ec_encode_symbol(e, cdf, op[OPC_TXSIG_NSYM], op[OPC_TXSIG_SYM], tp->update);
                }
                tx_type = 0; /* DCT (the only luma type we emit) */
            } else {
                /* intra: Mode_To_Txfm[uv mode]; inter: derived from the
                 * effective luma type — all emitted luma types are 2-D
                 * class, whose chroma scan/ctx equal DCT's */
                tx_type = is_inter_blk ? 0 : mode_to_txfm[uv_mode];
                if (tx_size >= 3) /* 32x32 chroma: DCT only */
                    tx_type = 0;
            }
            int tx_class = tx_class_of[tx_type];
            int ems = 0; /* eob multi size = log2(aw*aw) - 4 */
            {
                int area = aw * aw, t = 16;
                while (t < area) {
                    t <<= 1;
                    ems++;
                }
            }
            const int32_t *scan = tp->scans + tp->scan_off[tx_size * 16 + tx_type];
            const int32_t *off2d = tx_class == 0 ? tp->off2d + tp->off2d_off[tx_size] : NULL;
            int eob_nsyms = ems + 5;
            int eob_multi_ctx = tx_class == 0 ? 0 : 1;
            int32_t *eob_cdf = tp->eob_flag[ems] + (pl * 2 + eob_multi_ctx) * (eob_nsyms + 1);
            int32_t *eob_extra = tp->eob_extra + (txs_ctx * 2 + pl) * 22 * 3;
            int32_t *base_eob = tp->base_eob + (txs_ctx * 2 + pl) * 4 * 4;
            int32_t *base = tp->base + (txs_ctx * 2 + pl) * 42 * 5;
            int br_txs = txs_ctx < 3 ? txs_ctx : 3;
            int32_t *br = tp->br + (br_txs * 2 + pl) * 21 * 5;
            int32_t *dcs = tp->dc_sign + (pl * 3 + dctx) * 3;
            int32_t cul = ec_write_txb_body(e, coeffs, aw, aw, scan, tx_class, 0, 0, dctx,
                                            tp->update, eob_cdf, eob_nsyms, eob_extra, base_eob,
                                            base, br, dcs, off2d);
            set_entropy_ctx(st, plane, px4, py4, tw4, tw4, cul);
        }
    }
    return 0;
}
