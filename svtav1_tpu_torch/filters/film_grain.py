"""AV1 film grain: parameter syntax, synthesis, and source noise modelling.

Output-side post-process (spec 7.18.3): grain is synthesized from coded
parameters and added to *display* frames only — reference buffers stay
clean, so the encoder's prediction loop is untouched. That makes this a
host/numpy component by design: it runs once per shown frame on the
decode/display side, never inside the jitted encode programs.

Pieces:
  * ``FilmGrainParams``               — the coded parameter set
  * ``write_params`` / ``parse_params`` — uncompressed-header syntax
    (spec 5.9.30; reference behavior: entropy_coding.c:3054
    write_film_grain_params)
  * ``synthesize_noise`` / ``apply_grain`` — normative synthesis
    (spec 7.18.3; reference behavior: grainSynthesis.c — 73x82 luma /
    38x44 chroma AR templates, per-32x32-block offsets, 2px/1px overlap
    blending).  Reformulated here stripe-wise: each 32-row stripe is
    assembled with left-edge blends, then consecutive stripes are blended
    over their 2-row (luma) / 1-row (chroma) seams — arithmetic-identical
    to the reference's streaming col/line-buffer walk but vectorizable.
  * ``estimate_params``               — flat-block source noise model →
    scaling points + lag-1 AR fit (reference analog: noise_model.c).
  * ``synthetic_params``              — closed-form table from a 1..50
    strength knob (SvtAv1EncApp ``--film-grain`` analog).
  * ``load_fgs_table`` / ``save_fgs_table`` — aomenc "filmgrn1" film
    grain table files (the Mod's --fgs-table feature).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

_DATA = os.path.join(os.path.dirname(__file__), "..", "constants", "data")
_GAUSS = np.load(os.path.join(_DATA, "gaussian_sequence.npz"))["gaussian_sequence"].astype(np.int32)

GAUSS_BITS = 11


@dataclass
class FilmGrainParams:
    apply_grain: int = 1
    grain_seed: int = 7391
    update_grain: int = 1          # 0 -> re-use params from film_grain_params_ref_idx
    film_grain_params_ref_idx: int = 0
    y_points: tuple = ()           # ((value, scaling), ...) value strictly increasing, <=14
    cb_points: tuple = ()          # <=10
    cr_points: tuple = ()
    chroma_scaling_from_luma: int = 0
    scaling_shift: int = 8         # 8..11
    ar_coeff_lag: int = 0          # 0..3
    ar_coeffs_y: tuple = ()        # 2*lag*(lag+1) values in [-128, 127]
    ar_coeffs_cb: tuple = ()       # + 1 luma cross term when y_points non-empty
    ar_coeffs_cr: tuple = ()
    ar_coeff_shift: int = 6        # 6..9
    grain_scale_shift: int = 0     # 0..3
    cb_mult: int = 128
    cb_luma_mult: int = 192
    cb_offset: int = 256
    cr_mult: int = 128
    cr_luma_mult: int = 192
    cr_offset: int = 256
    overlap_flag: int = 1
    clip_to_restricted_range: int = 0

    def key(self):
        """Hashable identity for the synthesis cache."""
        return (self.grain_seed, self.y_points, self.cb_points, self.cr_points,
                self.chroma_scaling_from_luma, self.scaling_shift, self.ar_coeff_lag,
                self.ar_coeffs_y, self.ar_coeffs_cb, self.ar_coeffs_cr,
                self.ar_coeff_shift, self.grain_scale_shift,
                self.cb_mult, self.cb_luma_mult, self.cb_offset,
                self.cr_mult, self.cr_luma_mult, self.cr_offset,
                self.overlap_flag, self.clip_to_restricted_range)


# ------------------------------------------------------------------ syntax

def write_params(w, p: FilmGrainParams, is_inter: bool) -> None:
    """film_grain_params() syntax, spec 5.9.30 (write side).

    Caller gates on film_grain_params_present && (show || showable)."""
    w.f(p.apply_grain, 1)
    if not p.apply_grain:
        return
    w.f(p.grain_seed, 16)
    if is_inter:
        w.f(p.update_grain, 1)
        if not p.update_grain:
            w.f(p.film_grain_params_ref_idx, 3)
            return
    w.f(len(p.y_points), 4)
    for v, s in p.y_points:
        w.f(v, 8)
        w.f(s, 8)
    w.f(p.chroma_scaling_from_luma, 1)  # mono_chrome never set here
    # 4:2:0: cb/cr point counts are coded unless csfl or num_y_points == 0
    if not (p.chroma_scaling_from_luma or len(p.y_points) == 0):
        w.f(len(p.cb_points), 4)
        for v, s in p.cb_points:
            w.f(v, 8)
            w.f(s, 8)
        w.f(len(p.cr_points), 4)
        for v, s in p.cr_points:
            w.f(v, 8)
            w.f(s, 8)
    w.f(p.scaling_shift - 8, 2)
    w.f(p.ar_coeff_lag, 2)
    npos = 2 * p.ar_coeff_lag * (p.ar_coeff_lag + 1)
    nposc = npos + (1 if p.y_points else 0)
    if p.y_points:
        assert len(p.ar_coeffs_y) == npos
        for c in p.ar_coeffs_y:
            w.f(c + 128, 8)
    if p.cb_points or p.chroma_scaling_from_luma:
        assert len(p.ar_coeffs_cb) == nposc
        for c in p.ar_coeffs_cb:
            w.f(c + 128, 8)
    if p.cr_points or p.chroma_scaling_from_luma:
        assert len(p.ar_coeffs_cr) == nposc
        for c in p.ar_coeffs_cr:
            w.f(c + 128, 8)
    w.f(p.ar_coeff_shift - 6, 2)
    w.f(p.grain_scale_shift, 2)
    if p.cb_points:
        w.f(p.cb_mult, 8)
        w.f(p.cb_luma_mult, 8)
        w.f(p.cb_offset, 9)
    if p.cr_points:
        w.f(p.cr_mult, 8)
        w.f(p.cr_luma_mult, 8)
        w.f(p.cr_offset, 9)
    w.f(p.overlap_flag, 1)
    w.f(p.clip_to_restricted_range, 1)


def parse_params(r, is_inter: bool) -> FilmGrainParams:
    """film_grain_params() syntax, spec 5.9.30 (read side, 4:2:0)."""
    apply_grain = r.f(1)
    if not apply_grain:
        return FilmGrainParams(apply_grain=0)
    seed = r.f(16)
    if is_inter:
        update = r.f(1)
        if not update:
            ref_idx = r.f(3)
            return FilmGrainParams(apply_grain=1, grain_seed=seed, update_grain=0,
                                   film_grain_params_ref_idx=ref_idx)
    ny = r.f(4)
    y_points = tuple((r.f(8), r.f(8)) for _ in range(ny))
    csfl = r.f(1)
    if csfl or ny == 0:
        cb_points = cr_points = ()
    else:
        cb_points = tuple((r.f(8), r.f(8)) for _ in range(r.f(4)))
        cr_points = tuple((r.f(8), r.f(8)) for _ in range(r.f(4)))
    scaling_shift = r.f(2) + 8
    lag = r.f(2)
    npos = 2 * lag * (lag + 1)
    nposc = npos + (1 if ny else 0)
    ar_y = tuple(r.f(8) - 128 for _ in range(npos)) if ny else ()
    ar_cb = tuple(r.f(8) - 128 for _ in range(nposc)) if (cb_points or csfl) else ()
    ar_cr = tuple(r.f(8) - 128 for _ in range(nposc)) if (cr_points or csfl) else ()
    ar_coeff_shift = r.f(2) + 6
    grain_scale_shift = r.f(2)
    cb_mult, cb_luma_mult, cb_offset = 128, 192, 256  # unused-field defaults
    if cb_points:
        cb_mult, cb_luma_mult, cb_offset = r.f(8), r.f(8), r.f(9)
    cr_mult, cr_luma_mult, cr_offset = 128, 192, 256
    if cr_points:
        cr_mult, cr_luma_mult, cr_offset = r.f(8), r.f(8), r.f(9)
    overlap = r.f(1)
    clip = r.f(1)
    return FilmGrainParams(apply_grain=1, grain_seed=seed, update_grain=1,
                           y_points=y_points, cb_points=cb_points, cr_points=cr_points,
                           chroma_scaling_from_luma=csfl, scaling_shift=scaling_shift,
                           ar_coeff_lag=lag, ar_coeffs_y=ar_y, ar_coeffs_cb=ar_cb,
                           ar_coeffs_cr=ar_cr, ar_coeff_shift=ar_coeff_shift,
                           grain_scale_shift=grain_scale_shift,
                           cb_mult=cb_mult, cb_luma_mult=cb_luma_mult, cb_offset=cb_offset,
                           cr_mult=cr_mult, cr_luma_mult=cr_luma_mult, cr_offset=cr_offset,
                           overlap_flag=overlap, clip_to_restricted_range=clip)


# --------------------------------------------------------------- synthesis

class _Lfsr:
    """16-bit film grain LFSR (spec get_random_number)."""

    __slots__ = ("reg",)

    def __init__(self, reg: int):
        self.reg = reg & 0xFFFF

    def seed_block_row(self, luma_row: int, seed: int) -> None:
        r = seed & 0xFFFF
        r ^= ((luma_row * 37 + 178) & 255) << 8
        r ^= (luma_row * 173 + 105) & 255
        self.reg = r

    def bits(self, n: int) -> int:
        r = self.reg
        bit = ((r >> 0) ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1
        r = (r >> 1) | (bit << 15)
        self.reg = r
        return (r >> (16 - n)) & ((1 << n) - 1)


def _ar_positions(lag: int):
    pos = []
    for dr in range(-lag, 1):
        for dc in range(-lag, lag + 1):
            if dr == 0 and dc == 0:
                break
            pos.append((dr, dc))
    return pos


def _gen_template(rng: _Lfsr, rows: int, cols: int, gauss_shift: int,
                  lag: int, coeffs, ar_shift: int, gmin: int, gmax: int,
                  luma_tpl=None, npos_luma: int = 0) -> np.ndarray:
    """Gaussian fill + AR filter for one grain template (spec 7.18.3.2/3)."""
    draws = np.fromiter((rng.bits(GAUSS_BITS) for _ in range(rows * cols)),
                        np.int32, rows * cols)
    g = ((_GAUSS[draws] + ((1 << gauss_shift) >> 1)) >> gauss_shift)
    t = g.reshape(rows, cols).astype(np.int64)
    pos = _ar_positions(lag)
    coeffs = list(coeffs)
    rnd = 1 << (ar_shift - 1)
    # sequential AR filter: top/left pad is 3 regardless of lag
    for i in range(3, rows):
        for j in range(3, cols - 3):
            s = 0
            for (dr, dc), c in zip(pos, coeffs[: len(pos)]):
                s += c * t[i + dr, j + dc]
            if npos_luma and luma_tpl is not None:
                # chroma: averaged co-located luma grain as the last tap
                ly, lx = ((i - 3) << 1) + 3, ((j - 3) << 1) + 3
                av = (int(luma_tpl[ly, lx]) + int(luma_tpl[ly, lx + 1])
                      + int(luma_tpl[ly + 1, lx]) + int(luma_tpl[ly + 1, lx + 1]) + 2) >> 2
                s += coeffs[len(pos)] * av
            t[i, j] = min(max(int(t[i, j]) + ((s + rnd) >> ar_shift), gmin), gmax)
    return t.astype(np.int32)


@lru_cache(maxsize=8)
def _templates(key, bd: int):
    """LumaGrain 73x82 + CbGrain/CrGrain 38x44 for a param set (4:2:0)."""
    p = _params_from_key(key)
    gauss_shift = 12 - bd + p.grain_scale_shift
    center = 128 << (bd - 8)
    gmin, gmax = -center, (256 << (bd - 8)) - 1 - center
    lag = p.ar_coeff_lag
    rng = _Lfsr(p.grain_seed)
    if p.y_points:
        luma = _gen_template(rng, 73, 82, gauss_shift, lag, p.ar_coeffs_y,
                             p.ar_coeff_shift, gmin, gmax)
    else:
        luma = np.zeros((73, 82), np.int32)
    ncross = 1 if p.y_points else 0
    if p.cb_points or p.chroma_scaling_from_luma:
        rng.seed_block_row(7, p.grain_seed)  # == seed ^ 0xb524 (spec)
        cb = _gen_template(rng, 38, 44, gauss_shift, lag, p.ar_coeffs_cb,
                           p.ar_coeff_shift, gmin, gmax, luma, ncross)
    else:
        cb = np.zeros((38, 44), np.int32)
    if p.cr_points or p.chroma_scaling_from_luma:
        rng.seed_block_row(11, p.grain_seed)  # == seed ^ 0x49d8 (spec)
        cr = _gen_template(rng, 38, 44, gauss_shift, lag, p.ar_coeffs_cr,
                           p.ar_coeff_shift, gmin, gmax, luma, ncross)
    else:
        cr = np.zeros((38, 44), np.int32)
    return luma, cb, cr


def _params_from_key(key) -> FilmGrainParams:
    (seed, yp, cbp, crp, csfl, sshift, lag, ary, arcb, arcr, arshift, gss,
     cbm, cblm, cbo, crm, crlm, cro, ov, clip) = key
    return FilmGrainParams(grain_seed=seed, y_points=yp, cb_points=cbp, cr_points=crp,
                           chroma_scaling_from_luma=csfl, scaling_shift=sshift,
                           ar_coeff_lag=lag, ar_coeffs_y=ary, ar_coeffs_cb=arcb,
                           ar_coeffs_cr=arcr, ar_coeff_shift=arshift, grain_scale_shift=gss,
                           cb_mult=cbm, cb_luma_mult=cblm, cb_offset=cbo,
                           cr_mult=crm, cr_luma_mult=crlm, cr_offset=cro,
                           overlap_flag=ov, clip_to_restricted_range=clip)


def _blend(a, b, wa, wb, gmin, gmax):
    return np.clip((wa * a.astype(np.int64) + wb * b.astype(np.int64) + 16) >> 5,
                   gmin, gmax).astype(np.int32)


def synthesize_noise(p: FilmGrainParams, width: int, height: int, bd: int):
    """Full-frame grain noise planes (int32), 4:2:0.

    Stripe-wise restatement of the reference's per-block walk
    (grainSynthesis.c svt_av1_add_film_grain_run): per 32-row stripe, one
    8-bit rand per 32-wide block picks the template window; within a
    stripe, each block's left 2 luma cols (1 chroma col) blend 27/17
    (23/22) against the previous block's overhang; consecutive stripes
    blend over a 2-row luma (1-row chroma) seam with the same weights."""
    luma_t, cb_t, cr_t = _templates(p.key(), bd)
    center = 128 << (bd - 8)
    gmin, gmax = -center, (256 << (bd - 8)) - 1 - center
    ov = p.overlap_flag
    rng = _Lfsr(p.grain_seed)

    wc, hc = width // 2, height // 2
    nby = (height + 31) // 32
    nbx = (width + 31) // 32
    noise_y = np.zeros((height, width), np.int32)
    noise_cb = np.zeros((hc, wc), np.int32)
    noise_cr = np.zeros((hc, wc), np.int32)

    prev_sy = prev_scb = prev_scr = None
    for by in range(nby):
        y0 = 32 * by
        lim_y = min(34, height - y0)          # luma stripe rows incl. 2 overlap
        lim_c = min(17, (height - y0) // 2)   # chroma stripe rows incl. 1 overlap
        # per-stripe reseed keyed by the 32-row stripe INDEX (libaom-verified;
        # spec 7.18.3.5 lumaNum)
        rng.seed_block_row(by, p.grain_seed)
        s_y = np.zeros((lim_y, nbx * 32 + 2), np.int32)
        s_cb = np.zeros((lim_c, nbx * 16 + 1), np.int32)
        s_cr = np.zeros((lim_c, nbx * 16 + 1), np.int32)
        for bx in range(nbx):
            r8 = rng.bits(8)
            off_x, off_y = (r8 >> 4) & 15, r8 & 15
            ly, lx = 9 + 2 * off_y, 9 + 2 * off_x
            cy, cx = 6 + off_y, 6 + off_x
            wy = luma_t[ly : ly + lim_y, lx : lx + 34]
            wcb = cb_t[cy : cy + lim_c, cx : cx + 17]
            wcr = cr_t[cy : cy + lim_c, cx : cx + 17]
            x0, xc = 32 * bx, 16 * bx
            if ov and bx:
                s_y[:, x0] = _blend(s_y[:, x0], wy[:, 0], 27, 17, gmin, gmax)
                s_y[:, x0 + 1] = _blend(s_y[:, x0 + 1], wy[:, 1], 17, 27, gmin, gmax)
                s_cb[:, xc] = _blend(s_cb[:, xc], wcb[:, 0], 23, 22, gmin, gmax)
                s_cr[:, xc] = _blend(s_cr[:, xc], wcr[:, 0], 23, 22, gmin, gmax)
                s_y[:, x0 + 2 : x0 + 34] = wy[:, 2:]
                s_cb[:, xc + 1 : xc + 17] = wcb[:, 1:]
                s_cr[:, xc + 1 : xc + 17] = wcr[:, 1:]
            else:
                s_y[:, x0 : x0 + 34] = wy
                s_cb[:, xc : xc + 17] = wcb
                s_cr[:, xc : xc + 17] = wcr
        s_y = s_y[:, :width]
        s_cb = s_cb[:, :wc]
        s_cr = s_cr[:, :wc]
        out_rows = min(32, height - y0)
        out_rows_c = min(16, hc - 16 * by)
        if ov and by:
            noise_y[y0] = _blend(prev_sy[32], s_y[0], 27, 17, gmin, gmax)
            if out_rows > 1:
                noise_y[y0 + 1] = _blend(prev_sy[33], s_y[1], 17, 27, gmin, gmax)
            noise_cb[16 * by] = _blend(prev_scb[16], s_cb[0], 23, 22, gmin, gmax)
            noise_cr[16 * by] = _blend(prev_scr[16], s_cr[0], 23, 22, gmin, gmax)
            noise_y[y0 + 2 : y0 + out_rows] = s_y[2:out_rows]
            noise_cb[16 * by + 1 : 16 * by + out_rows_c] = s_cb[1:out_rows_c]
            noise_cr[16 * by + 1 : 16 * by + out_rows_c] = s_cr[1:out_rows_c]
        else:
            noise_y[y0 : y0 + out_rows] = s_y[:out_rows]
            noise_cb[16 * by : 16 * by + out_rows_c] = s_cb[:out_rows_c]
            noise_cr[16 * by : 16 * by + out_rows_c] = s_cr[:out_rows_c]
        prev_sy, prev_scb, prev_scr = s_y, s_cb, s_cr
    return noise_y, noise_cb, noise_cr


def _scaling_lut(points) -> np.ndarray:
    """256-entry piecewise-linear scaling LUT (spec 7.18.3.4)."""
    lut = np.zeros(256, np.int32)
    if not points:
        return lut
    pts = list(points)
    lut[: pts[0][0]] = pts[0][1]
    for (x0, v0), (x1, v1) in zip(pts, pts[1:]):
        dx = x1 - x0
        delta = (v1 - v0) * ((65536 + (dx >> 1)) // dx)
        xs = np.arange(dx, dtype=np.int64)
        lut[x0:x1] = v0 + ((xs * delta + 32768) >> 16)
    lut[pts[-1][0] :] = pts[-1][1]
    return lut


def _scale_lut(lut: np.ndarray, index: np.ndarray, bd: int) -> np.ndarray:
    """LUT sample with sub-entry interpolation for bd > 8 (spec scale_lut)."""
    if bd == 8:
        return lut[index]
    shift = bd - 8
    x = index >> shift
    frac = index & ((1 << shift) - 1)
    lo = lut[x]
    hi = lut[np.minimum(x + 1, 255)]
    interp = lo + (((hi - lo) * frac + (1 << (shift - 1))) >> shift)
    return np.where(x == 255, lo, interp)


def apply_grain(planes, p: FilmGrainParams, bd: int):
    """Add synthesized grain to (y, u, v) display planes (spec 7.18.3.5)."""
    if not p.apply_grain:
        return planes
    y, u, v = (pl.astype(np.int32) for pl in planes)
    height, width = y.shape
    ny, ncb, ncr = synthesize_noise(p, width, height, bd)
    lut_y = _scaling_lut(p.y_points)
    if p.chroma_scaling_from_luma:
        lut_cb = lut_cr = lut_y
    else:
        lut_cb = _scaling_lut(p.cb_points)
        lut_cr = _scaling_lut(p.cr_points)
    rnd = 1 << (p.scaling_shift - 1)
    if p.clip_to_restricted_range:
        min_l, max_l = 16 << (bd - 8), 235 << (bd - 8)
        min_c, max_c = 16 << (bd - 8), 240 << (bd - 8)
    else:
        min_l = min_c = 0
        max_l = max_c = (256 << (bd - 8)) - 1

    out_y = y
    if p.y_points:
        scale = _scale_lut(lut_y, y, bd).astype(np.int64)
        out_y = np.clip(y + ((scale * ny + rnd) >> p.scaling_shift), min_l, max_l)

    # chroma: x-averaged co-located luma drives the scaling index
    avg_luma = (y[::2, 0::2] + y[::2, 1::2] + 1) >> 1
    cmax = (256 << (bd - 8)) - 1

    def _chroma(c, noise, lut, mult, luma_mult, offset):
        if p.chroma_scaling_from_luma:
            m, lm, off = 0, 64, 0
        elif bd == 8:
            m, lm, off = mult - 128, luma_mult - 128, offset - 256
        else:
            m, lm = mult - 128, luma_mult - 128
            off = (offset << (bd - 8)) - (1 << bd)
        idx = np.clip(((avg_luma * lm + m * c) >> 6) + off, 0, cmax)
        scale = _scale_lut(lut, idx, bd).astype(np.int64)
        return np.clip(c + ((scale * noise + rnd) >> p.scaling_shift), min_c, max_c)

    out_u, out_v = u, v
    if p.cb_points or p.chroma_scaling_from_luma:
        out_u = _chroma(u, ncb, lut_cb, p.cb_mult, p.cb_luma_mult, p.cb_offset)
    if p.cr_points or p.chroma_scaling_from_luma:
        out_v = _chroma(v, ncr, lut_cr, p.cr_mult, p.cr_luma_mult, p.cr_offset)
    dt = np.uint8 if bd == 8 else np.uint16
    return out_y.astype(dt), out_u.astype(dt), out_v.astype(dt)


# ------------------------------------------------------- parameter sources

def synthetic_params(strength: int, seed: int = 7391) -> FilmGrainParams:
    """Closed-form grain table from a 1..50 strength knob (SvtAv1EncApp
    ``--film-grain`` analog; shape mirrors Config/ExampleFilmGrainTable.tbl:
    a gently rising 14-point luma curve, lag-0 white grain)."""
    strength = max(1, min(50, int(strength)))
    xs = [0, 20, 39, 59, 78, 98, 118, 137, 157, 177, 196, 216, 235, 255]
    base = 2.0 + strength * 0.55
    ys = [max(0, min(255, round(base * (0.8 + 0.2 * (i > 0))))) for i in range(len(xs))]
    y_points = tuple(zip(xs, ys))
    cstrength = max(0, round(base * 0.35))
    cpts = tuple((x, cstrength) for x in (0, 128, 255)) if cstrength else ()
    return FilmGrainParams(grain_seed=seed, y_points=y_points,
                           cb_points=cpts, cr_points=cpts,
                           ar_coeff_lag=0,
                           ar_coeffs_cb=(0,) if cpts else (),
                           ar_coeffs_cr=(0,) if cpts else (),
                           scaling_shift=8, ar_coeff_shift=6)


def estimate_params(planes, bd: int = 8, seed: int = 7391,
                    strength_scale: float = 1.0) -> FilmGrainParams | None:
    """Source noise model: flat-block residual statistics -> scaling points,
    plus a lag-1 AR fit (reference analog: noise_model.c
    svt_aom_noise_model_update / svt_av1_add_film_grain params extraction,
    re-done as a vectorized numpy estimator).

    Returns None when the source is clean (no measurable grain)."""
    y = planes[0].astype(np.float64)
    H, W = y.shape
    scale = float(1 << (bd - 8))
    # residual against a separable [1 2 1]/4 smooth — cheap high-pass
    k = np.array([1.0, 2.0, 1.0]) / 4.0
    sm = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, y)
    sm = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, sm)
    resid = y - sm
    B = 16
    hb, wb = H // B, W // B
    if hb == 0 or wb == 0:
        return None
    rb = resid[: hb * B, : wb * B].reshape(hb, B, wb, B)
    yb = y[: hb * B, : wb * B].reshape(hb, B, wb, B)
    # robust whole-frame noise estimate: the [1 2 1]^2 high-pass passes
    # 0.80 of white noise's std (measured), MAD for structure robustness
    sigma0 = 1.4826 * np.median(np.abs(resid)) / 0.80
    # flatness: block gradient of the smoothed image near the noise floor
    # (pure noise contributes 0.49*sigma to this metric — measured)
    gx = np.abs(np.diff(sm[: hb * B, : wb * B], axis=1))
    gy = np.abs(np.diff(sm[: hb * B, : wb * B], axis=0))
    gmap = np.zeros((hb * B, wb * B))
    gmap[:, :-1] += gx
    gmap[:-1, :] += gy
    gb = gmap.reshape(hb, B, wb, B).mean(axis=(1, 3))
    flat = gb < 0.49 * sigma0 * 1.35 + 0.5 * scale
    if flat.sum() < 8:
        return None
    # per-block noise std, corrected for the high-pass attenuation
    sig = np.sqrt((rb ** 2).mean(axis=(1, 3)))[flat] / 0.80
    mean = yb.mean(axis=(1, 3))[flat] / scale                   # 0..255 domain
    # intensity-binned std -> scaling points (scaling units: std * 4 in the
    # 8-bit grain domain given scaling_shift=8, grain std ~= 64/4 per unit)
    xs = [0, 32, 64, 96, 128, 160, 192, 224, 255]
    pts = []
    for x in xs:
        m = np.abs(mean - x) < 24
        if m.sum() >= 2:
            s = float(np.median(sig[m])) / scale
            pts.append((x, int(np.clip(round(s * 4.0 * strength_scale * 1.3), 0, 255))))
    if len(pts) < 2 or max(v for _, v in pts) == 0:
        return None
    # lag-1 AR fit on the residual of flat blocks (left + top neighbors)
    fy, fx = np.where(flat)
    num_l = num_t = den_l = den_t = 0.0
    for byy, bxx in zip(fy[:32], fx[:32]):
        blk = rb[byy, :, bxx, :]
        num_l += (blk[:, 1:] * blk[:, :-1]).sum()
        den_l += (blk[:, :-1] ** 2).sum()
        num_t += (blk[1:, :] * blk[:-1, :]).sum()
        den_t += (blk[:-1, :] ** 2).sum()
    rho_l = num_l / max(den_l, 1e-9)
    rho_t = num_t / max(den_t, 1e-9)
    # lag-1 positions: (-1,-1), (-1,0), (-1,1), (0,-1)
    c_t = int(np.clip(round(rho_t * 0.7 * 64), -128, 127))
    c_l = int(np.clip(round(rho_l * 0.7 * 64), -128, 127))
    ar_y = (0, c_t, 0, c_l)
    csc = max(1, int(round(max(v for _, v in pts) * 0.4)))
    return FilmGrainParams(grain_seed=seed, y_points=tuple(pts),
                           cb_points=((0, csc), (255, csc)),
                           cr_points=((0, csc), (255, csc)),
                           ar_coeff_lag=1, ar_coeffs_y=ar_y,
                           ar_coeffs_cb=ar_y + (0,), ar_coeffs_cr=ar_y + (0,),
                           scaling_shift=8, ar_coeff_shift=6)


# -------------------------------------------------- aomenc fgs table files

def load_fgs_table(path: str):
    """Parse an aomenc/SvtAv1EncApp film grain table ("filmgrn1" format):
    per segment `E <start_ts> <end_ts> <apply> <seed> <update>` followed by
    p/sY/sCb/sCr/cY/cCb/cCr parameter lines.  Returns [(start, end, params)]."""
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    if not lines or lines[0] != "filmgrn1":
        raise ValueError(f"{path}: not a filmgrn1 film grain table")
    segs = []
    i = 1
    while i < len(lines):
        tok = lines[i].split()
        assert tok[0] == "E", lines[i]
        start, end, apply_g, seed, update = (int(t) for t in tok[1:6])
        vals = {}
        i += 1
        while i < len(lines) and not lines[i].startswith("E "):
            t = lines[i].split()
            vals[t[0]] = [int(x) for x in t[1:]]
            i += 1
        pv = vals.get("p", [0, 6, 0, 8, 1, 1, 0, 128, 192, 256, 128, 192, 256])
        (lag, arshift, gss, sshift, csfl, overlap, clip) = pv[:7]
        cbm, cblm, cbo, crm, crlm, cro = (pv[7:13] + [128, 192, 256, 128, 192, 256])[:6]

        def pts(key):
            v = vals.get(key, [0])
            n = v[0]
            return tuple((v[1 + 2 * k], v[2 + 2 * k]) for k in range(n))

        y_points, cb_points, cr_points = pts("sY"), pts("sCb"), pts("sCr")
        npos = 2 * lag * (lag + 1)
        nposc = npos + (1 if y_points else 0)
        ar_y = tuple(vals.get("cY", [])[:npos]) if y_points else ()
        ar_cb = tuple(vals.get("cCb", [])[:nposc]) if (cb_points or csfl) else ()
        ar_cr = tuple(vals.get("cCr", [])[:nposc]) if (cr_points or csfl) else ()
        segs.append((start, end, FilmGrainParams(
            apply_grain=apply_g, grain_seed=seed, update_grain=update,
            y_points=y_points, cb_points=cb_points, cr_points=cr_points,
            chroma_scaling_from_luma=csfl, scaling_shift=sshift,
            ar_coeff_lag=lag, ar_coeffs_y=ar_y, ar_coeffs_cb=ar_cb, ar_coeffs_cr=ar_cr,
            ar_coeff_shift=arshift, grain_scale_shift=gss,
            cb_mult=cbm, cb_luma_mult=cblm, cb_offset=cbo,
            cr_mult=crm, cr_luma_mult=crlm, cr_offset=cro,
            overlap_flag=overlap, clip_to_restricted_range=clip)))
    return segs


def save_fgs_table(path: str, segs) -> None:
    with open(path, "w") as f:
        f.write("filmgrn1\n")
        for start, end, p in segs:
            f.write(f"E {start} {end} {p.apply_grain} {p.grain_seed} {p.update_grain}\n")
            f.write(f"\tp {p.ar_coeff_lag} {p.ar_coeff_shift} {p.grain_scale_shift} "
                    f"{p.scaling_shift} {p.chroma_scaling_from_luma} {p.overlap_flag} "
                    f"{p.clip_to_restricted_range} {p.cb_mult} {p.cb_luma_mult} "
                    f"{p.cb_offset} {p.cr_mult} {p.cr_luma_mult} {p.cr_offset}\n")
            for key, pts in (("sY", p.y_points), ("sCb", p.cb_points), ("sCr", p.cr_points)):
                f.write(f"\t{key} {len(pts)} " + " ".join(f"{v} {s}" for v, s in pts) + "\n")
            for key, cs in (("cY", p.ar_coeffs_y), ("cCb", p.ar_coeffs_cb), ("cCr", p.ar_coeffs_cr)):
                f.write(f"\t{key} " + " ".join(str(c) for c in cs) + "\n")


def select_params(segs, order_hint: int) -> FilmGrainParams | None:
    """Pick the table segment covering a frame (timestamps = frame numbers)."""
    for start, end, p in segs:
        if start <= order_hint < end:
            return p
    return None
