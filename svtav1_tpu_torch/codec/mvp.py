"""Motion vector prediction: the AV1 ref-MV stack (spec 7.10.2).

Single-reference, spatial-only (use_ref_frame_mvs = 0) build of the
candidate stack + mode context, shared by encoder mode decision, the
bitstream writer, and the conformance decoder so they cannot drift.

Behavioral reference: Source/Lib/Codec/adaptive_mv_pred.c
(setup_ref_mv_list :637, add_ref_mv_candidate :56, scan_row_mbmi :123,
scan_col_mbmi :182, scan_blk_mbmi :240, has_top_right :266,
sort_mvp_table :438, scan_row_col_light :457) — re-expressed on dense
per-mi numpy grids instead of mi pointer arrays.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants.av1 import BLOCK_H, BLOCK_W, BlockSize, RefFrame, has_newmv

MAX_REF_MV_STACK_SIZE = 8
MAX_MV_REF_CANDIDATES = 2
REF_CAT_LEVEL = 640
MV_BORDER = 16 << 3  # 128 (1/8-pel units)
MVREF_ROWS = 3
MVREF_COLS = 3
REFMV_OFFSET = 4
GLOBALMV_OFFSET = 3
NEWMV_CTX_MASK = (1 << GLOBALMV_OFFSET) - 1
GLOBALMV_CTX_MASK = (1 << (REFMV_OFFSET - GLOBALMV_OFFSET)) - 1
REFMV_CTX_MASK = (1 << (8 - REFMV_OFFSET)) - 1


class MiState:
    """Dense per-mi-unit mode info for one frame (the decoder's MI grid).

    Every coded block broadcasts its info over its mi footprint; the MVP
    scans then read any covered position directly."""

    def __init__(self, mi_rows: int, mi_cols: int):
        self.mi_rows, self.mi_cols = mi_rows, mi_cols
        self.bsize = np.full((mi_rows, mi_cols), int(BlockSize.BLOCK_64X64), np.int32)
        self.mode = np.zeros((mi_rows, mi_cols), np.int32)
        self.ref0 = np.full((mi_rows, mi_cols), int(RefFrame.INTRA_FRAME), np.int32)
        self.ref1 = np.full((mi_rows, mi_cols), int(RefFrame.NONE), np.int32)
        self.mv0 = np.zeros((mi_rows, mi_cols, 2), np.int32)  # (row, col) 1/8 pel
        self.mv1 = np.zeros((mi_rows, mi_cols, 2), np.int32)
        self.skip = np.zeros((mi_rows, mi_cols), np.int32)
        # mi offset of each unit within its block (loop-filter edge detection)
        self.off_x = np.zeros((mi_rows, mi_cols), np.int32)
        self.off_y = np.zeros((mi_rows, mi_cols), np.int32)

    _FIELDS = ("bsize", "mode", "ref0", "ref1", "mv0", "mv1", "skip", "off_x", "off_y")

    def set_block(self, mi_row, mi_col, bsize, mode, ref0, ref1, mv0, mv1=(0, 0), skip=0):
        h4 = int(BLOCK_H[bsize]) // 4
        w4 = int(BLOCK_W[bsize]) // 4
        r, c = mi_row, mi_col
        self.bsize[r : r + h4, c : c + w4] = bsize
        self.mode[r : r + h4, c : c + w4] = mode
        self.ref0[r : r + h4, c : c + w4] = ref0
        self.ref1[r : r + h4, c : c + w4] = ref1
        self.mv0[r : r + h4, c : c + w4] = mv0
        self.mv1[r : r + h4, c : c + w4] = mv1
        self.skip[r : r + h4, c : c + w4] = skip
        # numpy slices clip at the grid edge; match the ramp extents to that
        wc = min(w4, self.mi_cols - c)
        hc = min(h4, self.mi_rows - r)
        self.off_x[r : r + h4, c : c + w4] = np.arange(wc)[None, :]
        self.off_y[r : r + h4, c : c + w4] = np.arange(hc)[:, None]

    def snapshot(self) -> dict:
        return {k: getattr(self, k).copy() for k in self._FIELDS}

    def restore(self, snap: dict) -> None:
        for k, v in snap.items():
            getattr(self, k)[:] = v


@dataclass
class TileBounds:
    mi_row_start: int
    mi_row_end: int
    mi_col_start: int
    mi_col_end: int


def lower_mv_precision(mv, allow_hp: bool = False, force_int: bool = False):
    """spec lower_mv_precision: strip the 1/8-pel bit (or fraction)."""
    r, c = int(mv[0]), int(mv[1])
    out = []
    for v in (r, c):
        if force_int:
            v = (v + 3 if v > 0 else v - 3) // 8 * 8 if v % 8 else v
        elif not allow_hp and (v & 1):
            v += -1 if v > 0 else 1
        out.append(v)
    return out[0], out[1]


def _clamp(v, lo, hi):
    return lo if v < lo else (hi if v > hi else v)


@dataclass
class MvStack:
    mvs: np.ndarray  # (MAX_REF_MV_STACK_SIZE, 2)
    weights: np.ndarray  # (MAX_REF_MV_STACK_SIZE,)
    count: int
    mode_context: int
    # compound stacks carry the second ref's MV per entry (spec comp_mv)
    mvs1: np.ndarray | None = None

    @property
    def new_mv_ctx(self) -> int:
        return self.mode_context & NEWMV_CTX_MASK

    @property
    def zero_mv_ctx(self) -> int:
        return (self.mode_context >> GLOBALMV_OFFSET) & GLOBALMV_CTX_MASK

    @property
    def ref_mv_ctx(self) -> int:
        return (self.mode_context >> REFMV_OFFSET) & REFMV_CTX_MASK

    def drl_ctx(self, idx: int) -> int:
        """adaptive_mv_pred.c av1_drl_ctx analog (weights already sorted)."""
        if self.weights[idx] >= REF_CAT_LEVEL and self.weights[idx + 1] >= REF_CAT_LEVEL:
            return 0
        if self.weights[idx] >= REF_CAT_LEVEL and self.weights[idx + 1] < REF_CAT_LEVEL:
            return 1
        return 2

    def pred_mv(self, ref_mv_idx: int, which: int = 0):
        """NEWMV predictor: stack entry (gm-filled tail included); which=1
        selects the compound entry's second-ref MV."""
        src = self.mvs1 if which else self.mvs
        return int(src[ref_mv_idx][0]), int(src[ref_mv_idx][1])


def _clamp_stack_mv(mv, mi, mi_row: int, mi_col: int, n4_w: int, n4_h: int):
    """Clamp one MV to the stack's frame-relative legal window (spec
    7.10.2.14 formula, as applied to the post-sort stack entries)."""
    bw8, bh8 = n4_w * 32, n4_h * 32
    row = _clamp(int(mv[0]), -(mi_row * 32) - bh8 - MV_BORDER,
                 (mi.mi_rows - n4_h - mi_row) * 32 + bh8 + MV_BORDER)
    col = _clamp(int(mv[1]), -(mi_col * 32) - bw8 - MV_BORDER,
                 (mi.mi_cols - n4_w - mi_col) * 32 + bw8 + MV_BORDER)
    return (row, col)


def _is_sec_rect(mi_row: int, mi_col: int, n4_w: int, n4_h: int) -> bool:
    if n4_w < n4_h and (mi_col & (n4_h - 1)):
        return True
    if n4_w > n4_h and (mi_row & (n4_w - 1)):
        return True
    return False


def _has_top_right(mi_row: int, mi_col: int, n4_w: int, n4_h: int, sb_mi: int = 16) -> bool:
    bs = max(n4_w, n4_h)
    if bs > 16:  # > 64x64
        return False
    if n4_w > n4_h and _is_sec_rect(mi_row, mi_col, n4_w, n4_h):
        return False
    if n4_w < n4_h and not _is_sec_rect(mi_row, mi_col, n4_w, n4_h):
        return True
    mask_row = mi_row & (sb_mi - 1)
    mask_col = mi_col & (sb_mi - 1)
    has_tr = not ((mask_row & bs) and (mask_col & bs))
    b = bs
    while b < sb_mi:
        if mask_col & b:
            if (mask_col & (2 * b)) and (mask_row & (2 * b)):
                has_tr = False
                break
        else:
            break
        b <<= 1
    # PARTITION_VERT_A special case skipped: this profile never emits it
    return has_tr


def find_mv_stack(mi: MiState, tile: TileBounds, mi_row: int, mi_col: int, bsize: int,
                  ref_frame: int, sign_bias=None, ref_frame1: int | None = None,
                  gm_mv=(0, 0), gm_mv1=(0, 0)) -> MvStack:
    """Build the MV candidate stack + mode context.

    Single-reference when ref_frame1 is None; COMPOUND (spec 7.10.2 with
    rf[1] > NONE — adaptive_mv_pred.c setup_ref_mv_list compound branches)
    when ref_frame1 names the second reference: candidates are MV *pairs*
    from neighbors coded with exactly (ref_frame, ref_frame1), and the
    short-stack fill uses the compound combination lists instead of the
    single-ref light rescan.

    sign_bias: per-ref-frame array of 0/1 (all zeros for low-delay)."""
    if sign_bias is None:
        sign_bias = np.zeros(8, np.int32)
    is_comp = ref_frame1 is not None and ref_frame1 > int(RefFrame.INTRA_FRAME)
    n4_w = int(BLOCK_W[bsize]) // 4
    n4_h = int(BLOCK_H[bsize]) // 4
    up_avail = mi_row > tile.mi_row_start
    left_avail = mi_col > tile.mi_col_start

    stack = np.zeros((MAX_REF_MV_STACK_SIZE, 2), np.int64)
    stack1 = np.zeros((MAX_REF_MV_STACK_SIZE, 2), np.int64)
    weights = np.zeros(MAX_REF_MV_STACK_SIZE, np.int64)
    state = {"count": 0, "newmv": 0, "row_match": 0, "col_match": 0,
             "processed_rows": 0, "processed_cols": 0}

    def is_inside(r, c):
        return not (r < tile.mi_row_start or c < tile.mi_col_start or
                    r >= tile.mi_row_end or c >= tile.mi_col_end)

    def add_candidate(r, c, weight, count_newmv, match_key):
        if int(mi.ref0[r, c]) <= int(RefFrame.INTRA_FRAME):
            return
        if is_comp:
            if int(mi.ref0[r, c]) != ref_frame or int(mi.ref1[r, c]) != ref_frame1:
                return
            cand = (int(mi.mv0[r, c][0]), int(mi.mv0[r, c][1]))
            cand1 = (int(mi.mv1[r, c][0]), int(mi.mv1[r, c][1]))
            idx = state["count"]
            for i in range(state["count"]):
                if (int(stack[i][0]) == cand[0] and int(stack[i][1]) == cand[1]
                        and int(stack1[i][0]) == cand1[0] and int(stack1[i][1]) == cand1[1]):
                    idx = i
                    break
            if idx < state["count"]:
                weights[idx] += weight
            elif state["count"] < MAX_REF_MV_STACK_SIZE:
                stack[state["count"]] = cand
                stack1[state["count"]] = cand1
                weights[state["count"]] = weight
                state["count"] += 1
            if count_newmv and has_newmv(int(mi.mode[r, c])):
                state["newmv"] += 1
            state[match_key] += 1
            return
        for which, refv, mvv in ((0, mi.ref0[r, c], mi.mv0[r, c]), (1, mi.ref1[r, c], mi.mv1[r, c])):
            if int(refv) != ref_frame:
                continue
            cand = (int(mvv[0]), int(mvv[1]))
            idx = state["count"]
            for i in range(state["count"]):
                if int(stack[i][0]) == cand[0] and int(stack[i][1]) == cand[1]:
                    idx = i
                    break
            if idx < state["count"]:
                weights[idx] += weight
            elif state["count"] < MAX_REF_MV_STACK_SIZE:
                stack[state["count"]] = cand
                weights[state["count"]] = weight
                state["count"] += 1
            if count_newmv and has_newmv(int(mi.mode[r, c])):
                state["newmv"] += 1
            state[match_key] += 1

    row_adj = int(n4_h < 2 and (mi_row & 1))
    col_adj = int(n4_w < 2 and (mi_col & 1))
    max_row_offset = 0
    max_col_offset = 0
    if up_avail:
        max_row_offset = -(MVREF_ROWS << 1) + row_adj
        if n4_h < 2:
            max_row_offset = -(2 << 1) + row_adj
        max_row_offset = _clamp(max_row_offset, tile.mi_row_start - mi_row, tile.mi_row_end - mi_row - 1)
    if left_avail:
        max_col_offset = -(MVREF_COLS << 1) + col_adj
        if n4_w < 2:
            max_col_offset = -(2 << 1) + col_adj
        max_col_offset = _clamp(max_col_offset, tile.mi_col_start - mi_col, tile.mi_col_end - mi_col - 1)

    def scan_row(row_offset, count_newmv):
        end_mi = min(n4_w, mi.mi_cols - mi_col, 16)
        col_off = 0
        if abs(row_offset) > 1:
            col_off = 1
            if (mi_col & 1) and n4_w < 2:
                col_off -= 1
        use_step_16 = n4_w >= 16
        i = 0
        while i < end_mi:
            r = mi_row + row_offset
            c = mi_col + col_off + i
            if not is_inside(r, c):
                break
            cand_bsize = int(mi.bsize[r, c])
            cw4 = int(BLOCK_W[cand_bsize]) // 4
            length = min(n4_w, cw4)
            if use_step_16:
                length = max(4, length)
            elif abs(row_offset) > 1:
                length = max(2, length)
            weight = 2
            if n4_w >= 2 and n4_w <= cw4:
                inc = min(-max_row_offset + row_offset + 1, int(BLOCK_H[cand_bsize]) // 4)
                weight = max(weight, inc)
                state["processed_rows"] = inc - row_offset - 1
            add_candidate(r, c, weight * length, count_newmv, "row_match")
            i += length

    def scan_col(col_offset, count_newmv):
        end_mi = min(n4_h, mi.mi_rows - mi_row, 16)
        row_off = 0
        if abs(col_offset) > 1:
            row_off = 1
            if (mi_row & 1) and n4_h < 2:
                row_off -= 1
        use_step_16 = n4_h >= 16
        i = 0
        while i < end_mi:
            r = mi_row + row_off + i
            c = mi_col + col_offset
            if not is_inside(r, c):
                break
            cand_bsize = int(mi.bsize[r, c])
            ch4 = int(BLOCK_H[cand_bsize]) // 4
            length = min(n4_h, ch4)
            if use_step_16:
                length = max(4, length)
            elif abs(col_offset) > 1:
                length = max(2, length)
            weight = 2
            if n4_h >= 2 and n4_h <= ch4:
                inc = min(-max_col_offset + col_offset + 1, int(BLOCK_W[cand_bsize]) // 4)
                weight = max(weight, inc)
                state["processed_cols"] = inc - col_offset - 1
            add_candidate(r, c, weight * length, count_newmv, "col_match")
            i += length

    def scan_point(row_offset, col_offset, count_newmv, match_key):
        r, c = mi_row + row_offset, mi_col + col_offset
        if is_inside(r, c):
            add_candidate(r, c, 2 * 2, count_newmv, match_key)  # weight 2 * len(8x8 in mi)=2

    # nearest scans (ROW-1, COL-1, TOP-RIGHT)
    if abs(max_row_offset) >= 1:
        scan_row(-1, True)
    if abs(max_col_offset) >= 1:
        scan_col(-1, True)
    if _has_top_right(mi_row, mi_col, n4_w, n4_h):
        scan_point(-1, n4_w, True, "row_match")

    nearest_match = int(state["row_match"] > 0) + int(state["col_match"] > 0)
    newmv_count = state["newmv"]
    for i in range(state["count"]):
        weights[i] += REF_CAT_LEVEL

    # (temporal MVP skipped: use_ref_frame_mvs = 0 in this profile)

    # outer scans: TOP-LEFT point, then rows/cols at -3, -5
    scan_point(-1, -1, False, "row_match")
    for idx in range(2, MVREF_ROWS + 1):
        row_offset = -(idx << 1) + 1 + row_adj
        col_offset = -(idx << 1) + 1 + col_adj
        if abs(row_offset) <= abs(max_row_offset) and abs(row_offset) > state["processed_rows"]:
            scan_row(row_offset, False)
        if abs(col_offset) <= abs(max_col_offset) and abs(col_offset) > state["processed_cols"]:
            scan_col(col_offset, False)

    # mode context from (nearest_match, ref_match, newmv counters)
    ref_match = int(state["row_match"] > 0) + int(state["col_match"] > 0)
    mode_context = 0
    if nearest_match == 0:
        if ref_match >= 1:
            mode_context |= 1
        if ref_match == 1:
            mode_context |= 1 << REFMV_OFFSET
        elif ref_match >= 2:
            mode_context |= 2 << REFMV_OFFSET
    elif nearest_match == 1:
        mode_context |= 2 if newmv_count > 0 else 3
        if ref_match == 1:
            mode_context |= 3 << REFMV_OFFSET
        elif ref_match >= 2:
            mode_context |= 4 << REFMV_OFFSET
    else:
        mode_context |= 4 if newmv_count >= 1 else 5
        mode_context |= 5 << REFMV_OFFSET

    # stable sort by weight, descending (bubble, exact reference order)
    n = state["count"]
    length = n
    while length > 0:
        nr_len = 0
        for i in range(1, length):
            if weights[i - 1] < weights[i]:
                stack[[i - 1, i]] = stack[[i, i - 1]]
                stack1[[i - 1, i]] = stack1[[i, i - 1]]
                weights[[i - 1, i]] = weights[[i, i - 1]]
                nr_len = i
        length = nr_len

    if is_comp and n < MAX_MV_REF_CANDIDATES:
        # compound short-stack fill (setup_ref_mv_list rf[1] > NONE branch):
        # ROW-1/COL-1 sweeps collect per-component exact-ref and
        # sign-adjusted other-ref MV lists, combined into candidate pairs;
        # global-MV (identity -> zero) pads the tails
        mi_width = min(16, n4_w, mi.mi_cols - mi_col)
        mi_height = min(16, n4_h, mi.mi_rows - mi_row)
        mi_sz = min(mi_width, mi_height)
        rf = (ref_frame, ref_frame1)
        ref_id = [[], []]
        ref_diff = [[], []]

        def process_comp(r, c):
            for refv, mvv in ((mi.ref0[r, c], mi.mv0[r, c]), (mi.ref1[r, c], mi.mv1[r, c])):
                can_rf = int(refv)
                for cmp_idx in range(2):
                    if can_rf == rf[cmp_idx] and len(ref_id[cmp_idx]) < 2:
                        ref_id[cmp_idx].append((int(mvv[0]), int(mvv[1])))
                    elif can_rf > int(RefFrame.INTRA_FRAME) and len(ref_diff[cmp_idx]) < 2:
                        mr, mc = int(mvv[0]), int(mvv[1])
                        if sign_bias[can_rf] != sign_bias[rf[cmp_idx]]:
                            mr, mc = -mr, -mc
                        ref_diff[cmp_idx].append((mr, mc))

        i = 0
        while abs(max_row_offset) >= 1 and i < mi_sz:
            r, c = mi_row - 1, mi_col + i
            process_comp(r, c)
            i += max(int(BLOCK_W[int(mi.bsize[r, c])]) // 4, 1)
        i = 0
        while abs(max_col_offset) >= 1 and i < mi_sz:
            r, c = mi_row + i, mi_col - 1
            process_comp(r, c)
            i += max(int(BLOCK_H[int(mi.bsize[r, c])]) // 4, 1)

        comp_list = [[(0, 0), (0, 0)] for _ in range(MAX_MV_REF_CANDIDATES)]
        for cmp_idx in range(2):
            comp_idx = 0
            for v in ref_id[cmp_idx]:
                if comp_idx >= MAX_MV_REF_CANDIDATES:
                    break
                comp_list[comp_idx][cmp_idx] = v
                comp_idx += 1
            for v in ref_diff[cmp_idx]:
                if comp_idx >= MAX_MV_REF_CANDIDATES:
                    break
                comp_list[comp_idx][cmp_idx] = v
                comp_idx += 1
            while comp_idx < MAX_MV_REF_CANDIDATES:
                # global-MV pad (spec 7.10.2 GlobalMvs; identity -> zero)
                comp_list[comp_idx][cmp_idx] = tuple(gm_mv if cmp_idx == 0 else gm_mv1)
                comp_idx += 1
        if state["count"]:
            if (comp_list[0][0] == (int(stack[0][0]), int(stack[0][1]))
                    and comp_list[0][1] == (int(stack1[0][0]), int(stack1[0][1]))):
                stack[1], stack1[1] = comp_list[1][0], comp_list[1][1]
            else:
                stack[1], stack1[1] = comp_list[0][0], comp_list[0][1]
            weights[1] = 2
            state["count"] = 2
        else:
            for idx in range(MAX_MV_REF_CANDIDATES):
                stack[idx], stack1[idx] = comp_list[idx][0], comp_list[idx][1]
                weights[idx] = 2
            state["count"] = 2

    # light re-scan of ROW-1 / COL-1 if the table is short (single-ref path)
    if not is_comp and n < MAX_MV_REF_CANDIDATES:
        mi_width = min(16, n4_w, mi.mi_cols - mi_col)
        mi_height = min(16, n4_h, mi.mi_rows - mi_row)
        mi_sz = min(mi_width, mi_height)

        def light_add(r, c):
            for refv, mvv in ((mi.ref0[r, c], mi.mv0[r, c]), (mi.ref1[r, c], mi.mv1[r, c])):
                if int(refv) > int(RefFrame.INTRA_FRAME):
                    mvr, mvc = int(mvv[0]), int(mvv[1])
                    if sign_bias[int(refv)] != sign_bias[ref_frame]:
                        mvr, mvc = -mvr, -mvc
                    for i in range(state["count"]):
                        if int(stack[i][0]) == mvr and int(stack[i][1]) == mvc:
                            break
                    else:
                        stack[state["count"]] = (mvr, mvc)
                        weights[state["count"]] = 2
                        state["count"] += 1

        i = 0
        while abs(max_row_offset) >= 1 and i < mi_sz and state["count"] < MAX_MV_REF_CANDIDATES:
            r, c = mi_row - 1, mi_col + i
            light_add(r, c)
            i += int(BLOCK_W[int(mi.bsize[r, c])]) // 4
        i = 0
        while abs(max_col_offset) >= 1 and i < mi_sz and state["count"] < MAX_MV_REF_CANDIDATES:
            r, c = mi_row + i, mi_col - 1
            light_add(r, c)
            i += int(BLOCK_H[int(mi.bsize[r, c])]) // 4
        # tail fill with the global MV, clamped to the block's legal window
        # (libaom av1_find_mv_refs clamps mv_ref_list fills); count unchanged
        for i in range(state["count"], MAX_MV_REF_CANDIDATES):
            stack[i] = _clamp_stack_mv(gm_mv, mi, mi_row, mi_col, n4_w, n4_h)

    # clamp stack MVs to the frame-relative legal window
    bw8 = n4_w * 4 * 8
    bh8 = n4_h * 4 * 8
    to_left = -(mi_col * 32)
    to_right = (mi.mi_cols - n4_w - mi_col) * 32
    to_top = -(mi_row * 32)
    to_bottom = (mi.mi_rows - n4_h - mi_row) * 32
    for i in range(state["count"]):
        stack[i][1] = _clamp(int(stack[i][1]), to_left - bw8 - MV_BORDER, to_right + bw8 + MV_BORDER)
        stack[i][0] = _clamp(int(stack[i][0]), to_top - bh8 - MV_BORDER, to_bottom + bh8 + MV_BORDER)
        if is_comp:
            stack1[i][1] = _clamp(int(stack1[i][1]), to_left - bw8 - MV_BORDER, to_right + bw8 + MV_BORDER)
            stack1[i][0] = _clamp(int(stack1[i][0]), to_top - bh8 - MV_BORDER, to_bottom + bh8 + MV_BORDER)

    return MvStack(mvs=stack, weights=weights, count=state["count"],
                   mode_context=mode_context, mvs1=stack1 if is_comp else None)
