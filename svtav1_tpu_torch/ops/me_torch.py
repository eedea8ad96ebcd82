"""Motion estimation and motion compensation (PyTorch), ported from
svtav1_tpu's ops/me_jax.py, around five CUDA kernels with a plain PyTorch
version beside each:

- K8 `me_sad` (`csrc/me.cu`): the full-pel search of a frame against one
  reference, `me_fullpel_frame`, in two launches: the ME pyramid (the 2x2
  decimations to 1/2 and 1/4 resolution, of the source and the reference
  together or of the reference alone when the caller built the source's
  once with `me_pyramid`), then one CTA per 64x64 superblock for the L2
  search (16x16 at +-16 on the quarter-resolution plane), the L1 (32x32)
  and L0 (64x64) refinements at +-2, the 8x8 SAD maps of the SB's 64 leaves
  around two centres (the SB winner and zero), their quadtree sums, each
  size's biased argmin and the two-centre merge. The reference may be wider
  than the source (a tile's halo-cropped reference, `ref_off_x`). The plain
  version, `me_fullpel_frame_plain`, is the composition of
  `decimate2_plain`, `search_centered_plain`, `leaf_maps_plain` and the
  argmin glue.
- K9 `subpel_pred` (`csrc/subpel.cu`): the subpel search on the 25-point
  ({-4..4}) or 49-point ({-6..6}) 1/8-pel lattice from one (n+8)^2 patch per
  block, with the winner's normative prediction.
- K10 `mc_lanes` (`csrc/mc.cu`): normative separable subpel MC with a
  per-lane phase, from one plane or a (NREF, H, W) stack by ref index;
  `mc_lanes_planes` runs the same lanes on up to three planes of one shape
  (U and V, or TPL's reference pair) in one launch.
- K11 `mc_compound` (`csrc/mc.cu`): compound-average MC on K10's lanes
  and strips, the two conv-buf (offset-carrying, COMPOUND_ROUND1)
  predictions of a lane from two references of the stack and the normative
  average, in one launch; `mc_lanes_compound_planes` runs the same lanes on
  up to three planes of one shape (U and V) in one launch.
- K14 `subpel_refine` (`csrc/subpel.cu`): the TPL's two-step 9-point
  subpel refinement by SAD on K9's lanes, from one (n+8)^2 patch per block.

MVs are (row, col); the searches work in full pels and return 1/8 pel, MC
takes 1/16 pel of the plane it reads. Each wrapper launches its kernel for
CUDA tensors (or raises) and takes the plain version only for CPU tensors.
The plain versions use int32 arithmetic like the reference, and floor
negative positions with `>>` and phases with `& 15` as it does.

Planes on the card are uint8 at 8 bits and int16 at 10 bits
(`plane_dtype`), as the reference stacks them. K8, K9, K10 and K11 each
have a 16-bit form, built from the same source and counted under its own
name (`me_sad16`, `subpel_pred16`, `mc_lanes16`, `mc_compound16`), and so
does K14 (`subpel_refine16`); the wrapper picks it by `bd`. A plane of
another dtype raises, and a uint8 plane above 8 bits raises on the CPU too:
no wrapper casts.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from .convolve import (COMPOUND_ROUND1, FILTER_BITS, ROUND0, ROUND1, filter_for_dim,
                       filter_kernels)

SIZES = (8, 16, 32, 64)
# K8 modes (csrc/me.cu me_sad_launch)
_ME_PYRAMID, _ME_FRAME = 0, 1


@functools.lru_cache(maxsize=None)
def _ftab(which: int, device: str) -> torch.Tensor:
    """(16, 8) int32 subpel kernels of filter `which` on `device`."""
    return torch.as_tensor(filter_kernels(which), dtype=torch.int32, device=device)


def _i32(x) -> torch.Tensor:
    return x.to(torch.int32).contiguous()


_PLANE_DTYPES = {8: (torch.uint8, np.uint8), 10: (torch.int16, np.int16)}


def plane_dtype(bd: int) -> torch.dtype:
    """The dtype of a sample plane on the card: uint8 at 8 bits, int16 at 10."""
    if bd not in _PLANE_DTYPES:
        raise ValueError(f"bit depth {bd}: the kernels take 8- or 10-bit planes")
    return _PLANE_DTYPES[bd][0]


def plane_np_dtype(bd: int):
    """The numpy dtype of plane_dtype(bd), for planes made on the host."""
    plane_dtype(bd)
    return _PLANE_DTYPES[bd][1]


def _kname(name: str, bd: int) -> str:
    """The kernel of `name` for planes of depth bd: the 16-bit form above 8."""
    plane_dtype(bd)
    return name if bd == 8 else kernels.FORM16[name]


def check_plane(p, name: str, bd: int) -> None:
    """A sample plane for a kernel at depth bd: on the card exactly
    plane_dtype(bd), contiguous; on the CPU any integer dtype, except uint8
    above 8 bits, which cannot hold the samples."""
    if p.device.type == "cpu":
        plane_dtype(bd)
        if bd != 8 and p.dtype == torch.uint8:
            raise ValueError(f"{name}: a uint8 plane cannot hold {bd}-bit samples")
        return
    kernels.check(p, name, plane_dtype(bd))


# ---------------------------------------------------------------------------
# plain versions (written from me_jax.py)
# ---------------------------------------------------------------------------


def decimate2_plain(p):
    """2x2-average decimation (..., H, W) -> (..., H//2, W//2) (decimate2_j)."""
    h, w = p.shape[-2] & ~1, p.shape[-1] & ~1
    q = p[..., :h, :w]
    return (q[..., 0::2, 0::2] + q[..., 0::2, 1::2] + q[..., 1::2, 0::2]
            + q[..., 1::2, 1::2] + 2) >> 2


def gather_windows(plane, ys, xs, wh: int, ww: int):
    """(B,) top-left coords -> (B, wh, ww) windows of a (H, W) plane, each
    coordinate clamped to the plane (the spec's reference-sample clamp)."""
    H, W = plane.shape[-2:]
    dev = plane.device
    iy = (ys[:, None] + torch.arange(wh, device=dev)[None, :]).clamp(0, H - 1)
    ix = (xs[:, None] + torch.arange(ww, device=dev)[None, :]).clamp(0, W - 1)
    return plane[iy[:, :, None].long(), ix[:, None, :].long()]


def sad_maps(src_blocks, windows, n: int, r: int):
    """src (B, n, n), windows (B, n+2r, n+2r) -> SAD maps (B, D, D) int32,
    D = 2r+1; map[dy, dx] = SAD at displacement (dy-r, dx-r)."""
    D = 2 * r + 1
    dev = windows.device
    iy = torch.arange(D, device=dev)[:, None] + torch.arange(n, device=dev)[None, :]  # (D, n)
    pat = windows[:, iy[:, None, :, None], iy[None, :, None, :]]  # (B, D, D, n, n)
    diff = (pat.to(torch.int32) - src_blocks[:, None, None].to(torch.int32)).abs()
    return diff.sum(dim=(-2, -1)).to(torch.int32)


def _argmin2d(maps, r: int):
    """(B, D, D) -> (B, 2) int32 displacement (row, col) in [-r, r]; the
    first minimum in row-major order."""
    D = 2 * r + 1
    best = torch.argmin(maps.reshape(maps.shape[0], D * D), dim=1).to(torch.int32)
    return torch.stack([torch.div(best, D, rounding_mode="floor") - r, best % D - r], dim=1)


def _bias(r: int, scale: int, device):
    d = torch.arange(-r, r + 1, device=device).abs()
    return ((d[:, None] + d[None, :]) * scale).to(torch.int32)


def search_centered_plain(src, ref, ys, xs, centers, n: int, r: int, scale: int,
                          ref_off_x: int = 0):
    """Full search of the (n, n) blocks of `src` at (ys, xs) against `ref`
    in a clamped (n+2r)^2 window around each full-pel centre, plus the
    integer distance bias; returns the refined centres (B, 2)
    (_search_centered). Source column x sits at column x + ref_off_x of
    `ref`, whose own dims clamp the window."""
    src_b = gather_windows(src, ys, xs, n, n)
    win = gather_windows(ref, ys + centers[:, 0] - r, xs + ref_off_x + centers[:, 1] - r,
                         n + 2 * r, n + 2 * r)
    maps = sad_maps(src_b, win, n, r) + _bias(r, scale, src.device)[None]
    return (centers + _argmin2d(maps, r)).to(torch.int32)


def _leaf_src(src, sb_rows: int, sb_cols: int):
    """(sb_rows*64, sb_cols*64) plane -> (B_sb*64, 8, 8) leaves, SB-major
    and raster inside each SB."""
    return src[: sb_rows * 64, : sb_cols * 64].reshape(sb_rows, 8, 8, sb_cols, 8, 8) \
        .permute(0, 3, 1, 4, 2, 5).reshape(sb_rows * sb_cols * 64, 8, 8)


def leaf_maps_plain(src, ref, centers, sb_cols: int, r: int, ref_off_x: int = 0):
    """8x8 SAD maps of every SB leaf around each SB's full-pel centre:
    centers (K, B_sb, 2) -> (K, B_sb*64, D, D) int32. The window of a leaf
    is read with coordinates clamped to `ref`'s dims (the reference's
    edge-padded plane at centre zero, its gathered SB window at the MV
    centre); source column x sits at column x + ref_off_x of `ref`."""
    K, B = centers.shape[:2]
    sb_rows = B // sb_cols
    dev = src.device
    src8 = _leaf_src(src, sb_rows, sb_cols)
    sbr = torch.arange(sb_rows, device=dev).repeat_interleave(sb_cols)
    sbc = torch.arange(sb_cols, device=dev).repeat(sb_rows)
    li = torch.arange(8, device=dev).repeat_interleave(8)
    lj = torch.arange(8, device=dev).repeat(8)
    out = []
    for k in range(K):
        c = centers[k]
        ys = ((sbr * 64 + c[:, 0] - r)[:, None] + 8 * li[None, :]).reshape(-1)
        xs = ((sbc * 64 + ref_off_x + c[:, 1] - r)[:, None] + 8 * lj[None, :]).reshape(-1)
        out.append(sad_maps(src8, gather_windows(ref, ys, xs, 8 + 2 * r, 8 + 2 * r), 8, r))
    return torch.stack(out)


def mc_lanes_plain(ref, ys, xs, mv_q16_y, mv_q16_x, n_h: int, n_w: int, which: int, bd: int,
                   ref_idx=None, conv_buf: bool = False):
    """Plain PyTorch version of K10; same arguments and result as mc_lanes.
    conv_buf=True returns the compound path's offset-carrying intermediate
    (rounded by COMPOUND_ROUND1), to be blended by compound_average_plain."""
    dev = ys.device
    fy0 = ys.to(torch.int32) * 16 + mv_q16_y.to(torch.int32)
    fx0 = xs.to(torch.int32) * 16 + mv_q16_x.to(torch.int32)
    iy, sy = fy0 >> 4, fy0 & 15
    ix, sx = fx0 >> 4, fx0 & 15
    H, W = ref.shape[-2:]
    gy = (iy[:, None] - 3 + torch.arange(n_h + 7, device=dev)[None, :]).clamp(0, H - 1).long()
    gx = (ix[:, None] - 3 + torch.arange(n_w + 7, device=dev)[None, :]).clamp(0, W - 1).long()
    if ref.dim() == 2:
        patch = ref[gy[:, :, None], gx[:, None, :]].to(torch.int32)
    else:
        ri = ref_idx.long().clamp(0, ref.shape[0] - 1)
        patch = ref[ri[:, None, None], gy[:, :, None], gx[:, None, :]].to(torch.int32)
    fxk = _ftab(filter_for_dim(which, n_w), str(dev))[sx.long()]  # (B, 8)
    fyk = _ftab(filter_for_dim(which, n_h), str(dev))[sy.long()]
    offset_bits = bd + 2 * FILTER_BITS - ROUND0
    acc = torch.full((patch.shape[0], n_h + 7, n_w), 1 << (bd + FILTER_BITS - 1),
                     dtype=torch.int32, device=dev)
    for k in range(8):
        acc = acc + fxk[:, k, None, None] * patch[:, :, k : k + n_w]
    im = (acc + (1 << (ROUND0 - 1))) >> ROUND0
    acc = torch.full((patch.shape[0], n_h, n_w), 1 << offset_bits, dtype=torch.int32, device=dev)
    for k in range(8):
        acc = acc + fyk[:, k, None, None] * im[:, k : k + n_h, :]
    if conv_buf:
        return (acc + (1 << (COMPOUND_ROUND1 - 1))) >> COMPOUND_ROUND1
    res = ((acc + (1 << (ROUND1 - 1))) >> ROUND1) \
        - ((1 << (offset_bits - ROUND1)) + (1 << (offset_bits - ROUND1 - 1)))
    assert 2 * FILTER_BITS - ROUND0 - ROUND1 == 0  # no third rounding for 8/10-bit
    return res.clamp(0, (1 << bd) - 1).to(torch.int32)


def mc_lanes_planes_plain(refs, ys, xs, mv_q16_y, mv_q16_x, n_h: int, n_w: int, which: int,
                          bd: int, ref_idx=None):
    """Plain PyTorch version of K10 on several planes; same arguments and
    result as mc_lanes_planes: mc_lanes_plain once per plane."""
    return torch.stack([mc_lanes_plain(r, ys, xs, mv_q16_y, mv_q16_x, n_h, n_w, which, bd,
                                       ref_idx) for r in refs])


def compound_average_plain(conv0, conv1, bd: int):
    """The normative average blend of two conv-buf intermediates
    (compound_average_j)."""
    offset_bits = bd + 2 * FILTER_BITS - ROUND0
    tmp = ((conv0 + conv1) >> 1) - ((1 << (offset_bits - COMPOUND_ROUND1))
                                     + (1 << (offset_bits - COMPOUND_ROUND1 - 1)))
    round_bits = 2 * FILTER_BITS - ROUND0 - COMPOUND_ROUND1
    return ((tmp + (1 << (round_bits - 1))) >> round_bits).clamp(0, (1 << bd) - 1) \
        .to(torch.int32)


def mc_compound_plain(refs, ys, xs, mv0y, mv0x, mv1y, mv1x, n_h: int, n_w: int, which: int,
                      bd: int, ref0_idx, ref1_idx):
    """Plain PyTorch version of K11; same arguments and result as
    mc_lanes_compound."""
    c0 = mc_lanes_plain(refs, ys, xs, mv0y, mv0x, n_h, n_w, which, bd, ref0_idx, conv_buf=True)
    c1 = mc_lanes_plain(refs, ys, xs, mv1y, mv1x, n_h, n_w, which, bd, ref1_idx, conv_buf=True)
    return compound_average_plain(c0, c1, bd)


def mc_compound_planes_plain(refs, ys, xs, mv0y, mv0x, mv1y, mv1x, n_h: int, n_w: int,
                             which: int, bd: int, ref0_idx, ref1_idx):
    """Plain PyTorch version of K11 on several planes; same arguments and
    result as mc_lanes_compound_planes: mc_compound_plain once per plane."""
    return torch.stack([mc_compound_plain(r, ys, xs, mv0y, mv0x, mv1y, mv1x, n_h, n_w, which, bd,
                                          ref0_idx, ref1_idx) for r in refs])


def extract_patches(ref, ys, xs, h: int, w: int):
    """(B,) top-left plane coords -> (B, h, w) int32 patches with the spec's
    edge replication (per-index clamp)."""
    return gather_windows(ref, ys, xs, h, w).to(torch.int32)


def _mc_patch_static(patch, idy: int, idx: int, sy: int, sx: int, n: int, which: int, bd: int):
    """Normative 8-tap MC from a shared (B, n+8, n+8) patch at a static
    integer shift (idy, idx in {-1, 0} relative to the patch's full-pel
    origin) and static subpel phase (sy, sx in 0..15); equal to mc_lanes at
    the same absolute MV."""
    taps = filter_kernels(filter_for_dim(which, n))
    fx, fy = taps[sx], taps[sy]
    offset_bits = bd + 2 * FILTER_BITS - ROUND0
    r0, c0 = 1 + idy, 1 + idx  # patch rows [-4 .. n+3] -> tap base iy-3
    sub = patch[:, r0 : r0 + n + 7, c0 : c0 + n + 7]
    acc = torch.full((sub.shape[0], n + 7, n), 1 << (bd + FILTER_BITS - 1), dtype=torch.int32,
                     device=patch.device)
    for k in range(8):
        if fx[k]:
            acc = acc + int(fx[k]) * sub[:, :, k : k + n]
    im = (acc + (1 << (ROUND0 - 1))) >> ROUND0
    acc = torch.full((sub.shape[0], n, n), 1 << offset_bits, dtype=torch.int32, device=patch.device)
    for k in range(8):
        if fy[k]:
            acc = acc + int(fy[k]) * im[:, k : k + n, :]
    res = ((acc + (1 << (ROUND1 - 1))) >> ROUND1) \
        - ((1 << (offset_bits - ROUND1)) + (1 << (offset_bits - ROUND1 - 1)))
    return res.clamp(0, (1 << bd) - 1)


def _lattice(fast: bool) -> tuple:
    return (-4, -2, 0, 2, 4) if fast else (-6, -4, -2, 0, 2, 4, 6)


def subpel_pred_plain(src_b, ref, ys, xs, mv_fp, which: int, bd: int, fast: bool = False):
    """Plain PyTorch version of K9; same arguments and results as
    subpel_pred_lanes."""
    B, n = src_b.shape[0], src_b.shape[-1]
    dev = src_b.device
    patch = extract_patches(ref, ys + mv_fp[:, 0] - 4, xs + mv_fp[:, 1] - 4, n + 8, n + 8)
    lat = _lattice(fast)
    preds, sads = {}, {}
    for dy8 in lat:
        for dx8 in lat:
            fy0, fx0 = 2 * dy8, 2 * dx8  # 1/16 pel
            p = _mc_patch_static(patch, fy0 >> 4, fx0 >> 4, fy0 & 15, fx0 & 15, n, which, bd)
            preds[(dy8, dx8)] = p
            sads[(dy8, dx8)] = (p - src_b).abs().sum(dim=(-2, -1))
    bi = torch.arange(B, device=dev)
    if fast:
        # exhaustive: the first minimum in (dy, dx) raster order
        keys = [(dy, dx) for dy in lat for dx in lat]
        kbest = torch.argmin(torch.stack([sads[k] for k in keys]), dim=0)
        best_d = torch.tensor(keys, dtype=torch.int32, device=dev)[kbest]
        best_pred = torch.stack([preds[k] for k in keys])[kbest, bi]
        return (mv_fp * 8 + best_d).to(torch.int32), best_pred.to(torch.int32)
    # step 1: the half-pel 9 points (first minimum); step 2: the quarter-pel
    # points around its winner, each taken only if strictly better
    step1 = [(dy, dx) for dy in (-4, 0, 4) for dx in (-4, 0, 4)]
    sads1 = torch.stack([sads[d] for d in step1])
    k1 = torch.argmin(sads1, dim=0)
    d1 = torch.tensor(step1, dtype=torch.int32, device=dev)[k1]
    best_sad = sads1.min(dim=0).values
    keys = [(dy, dx) for dy in lat for dx in lat]
    sall = torch.stack([sads[k] for k in keys])  # (49, B)
    pall = torch.stack([preds[k] for k in keys])
    L = len(lat)

    def lat_index(d):
        return (d[:, 0] + 6) // 2 * L + (d[:, 1] + 6) // 2

    best_d = d1
    for o2 in [(dy, dx) for dy in (-2, 0, 2) for dx in (-2, 0, 2)]:
        if o2 == (0, 0):
            continue
        cand = d1 + torch.tensor(o2, dtype=torch.int32, device=dev)
        sad_o = sall[lat_index(cand).long(), bi]
        take = sad_o < best_sad
        best_sad = torch.where(take, sad_o, best_sad)
        best_d = torch.where(take[:, None], cand, best_d)
    best_pred = pall[lat_index(best_d).long(), bi]
    return (mv_fp * 8 + best_d).to(torch.int32), best_pred.to(torch.int32)


_REFINE_OFFS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def subpel_refine_plain(src_b, ref, ys, xs, mv_fp, which: int, bd: int):
    """Plain PyTorch version of K14; same arguments and result as
    subpel_refine_lanes (written from me_jax.subpel_refine_lanes: the nine
    candidates of a step are lanes of one MC call)."""
    B, n = src_b.shape[0], src_b.shape[-1]
    dev = src_b.device
    mv = mv_fp.to(torch.int32) * 8
    ys9, xs9 = ys.repeat(9), xs.repeat(9)
    offs = torch.tensor(_REFINE_OFFS, dtype=torch.int32, device=dev)
    bi = torch.arange(B, device=dev)
    for step in (4, 2):
        cand = (mv[None] + offs[:, None] * step).reshape(9 * B, 2)
        pred = mc_lanes_plain(ref, ys9, xs9, cand[:, 0] * 2, cand[:, 1] * 2, n, n, which, bd)
        sads = (pred.reshape(9, B, n, n) - src_b[None]).abs().sum(dim=(-2, -1))
        mv = cand.reshape(9, B, 2)[torch.argmin(sads, dim=0), bi]  # the first minimum
    return mv.to(torch.int32)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _grid_dims(plane, sb_rows: int, sb_cols: int) -> tuple:
    """The dims a plane is read at: edge-padded up to the SB grid."""
    return max(plane.shape[0], 64 * sb_rows), max(plane.shape[1], 64 * sb_cols)


def edge_pad(plane, H: int, W: int):
    """(h, w) -> (H, W), H >= h and W >= w, with the last row and column
    replicated."""
    h, w = plane.shape
    if (h, w) == (H, W):
        return plane
    dev = plane.device
    iy = torch.arange(H, device=dev).clamp(max=h - 1)
    ix = torch.arange(W, device=dev).clamp(max=w - 1)
    return plane[iy[:, None], ix[None, :]].contiguous()


def me_fullpel_frame_plain(src_y, ref_y, sb_rows: int, sb_cols: int, l2_radius: int = 16,
                           leaf_radius: int = 4, ref_off_x: int = 0, src_pyr=None):
    """Plain PyTorch version of K8; same arguments and results as
    me_fullpel_frame (any device; planes of any integer type)."""
    dev = src_y.device
    B = sb_rows * sb_cols
    src_y = edge_pad(src_y, *_grid_dims(src_y, sb_rows, sb_cols)).to(torch.int32)
    ref_y = edge_pad(ref_y, *_grid_dims(ref_y, sb_rows, sb_cols)).to(torch.int32)
    if src_pyr is None:
        src1 = decimate2_plain(src_y)
        src2 = decimate2_plain(src1)
    else:
        src1, src2 = (p.to(torch.int32) for p in src_pyr)
    ref1 = decimate2_plain(ref_y)
    ref2 = decimate2_plain(ref1)
    rr = torch.arange(sb_rows, device=dev, dtype=torch.int32).repeat_interleave(sb_cols)
    cc = torch.arange(sb_cols, device=dev, dtype=torch.int32).repeat(sb_rows)
    # L2 (1/4 res): 16x16 blocks, exhaustive +-l2_radius; L1, L0: +-2 refines
    zero = torch.zeros((B, 2), dtype=torch.int32, device=dev)
    mv = search_centered_plain(src2, ref2, rr * 16, cc * 16, zero, 16, l2_radius, 1,
                               ref_off_x // 4)
    mv = search_centered_plain(src1, ref1, rr * 32, cc * 32, mv * 2, 32, 2, 2, ref_off_x // 2)
    mv_sb = search_centered_plain(src_y, ref_y, rr * 64, cc * 64, mv * 2, 64, 2, 4, ref_off_x)

    # 8x8 SAD maps around two centres per SB (the pyramid winner and zero
    # MV), summed up the quadtree: each size argmins its own map
    r = leaf_radius
    D = 2 * r + 1
    centers = (mv_sb, zero)
    maps = leaf_maps_plain(src_y, ref_y, torch.stack(centers), sb_cols, r, ref_off_x) \
        .reshape(2, sb_rows, sb_cols, 8, 8, D, D)
    maps = [maps[0], maps[1]]
    out = {}
    for n in SIZES:
        k = 8 // (n // 8)  # blocks per SB side at this size
        bias = _bias(r, (n * n) // 16, dev)[None, None, None, None]
        best_val = best_mv = None
        for m, c in zip(maps, centers):
            mm = (m + bias).reshape(-1, D, D)
            off = _argmin2d(mm, r)
            val = mm.reshape(-1, D * D).min(dim=1).values
            mvn = c.repeat_interleave(k * k, dim=0) + off
            if best_val is None:
                best_val, best_mv = val, mvn
            else:  # the MV centre wins ties
                take = val < best_val
                best_val = torch.where(take, val, best_val)
                best_mv = torch.where(take[:, None], mvn, best_mv)
        out[n] = best_mv.reshape(sb_rows, sb_cols, k, k, 2).permute(0, 2, 1, 3, 4) \
            .reshape(sb_rows * k, sb_cols * k, 2).to(torch.int32)
        if n < 64:  # sum 2x2 children -> parent maps
            maps = [m[:, :, 0::2, 0::2] + m[:, :, 0::2, 1::2] + m[:, :, 1::2, 0::2]
                    + m[:, :, 1::2, 1::2] for m in maps]
    return out, mv_sb


def _me_launch(mode: int, planes, out, dims, bd: int, ref_off_x: int = 0, sb: tuple = (0, 0),
               radii: tuple = (0, 0)) -> None:
    """planes: src0, src1, src2, ref0, ref1, ref2 (plane_dtype(bd) or None);
    dims: (hs, ws, Hs, Ws, hr, wr, Hr, Wr), the planes' own and padded dims."""
    ptrs = [p.data_ptr() if p is not None else None for p in planes]
    kernels.launch(_kname("me_sad", bd), mode, *ptrs, out.data_ptr() if out is not None else None,
                   *dims, ref_off_x, *sb, *radii, kernels.stream_ptr(planes[3]))


def _check_me_plane(p, name: str, bd: int) -> None:
    check_plane(p, name, bd)
    if p.dim() != 2:
        raise ValueError(f"me_fullpel_frame: {name} must be one (H, W) plane")


def _levels(H: int, W: int, device, bd: int):
    """Empty levels 1 and 2 of a plane read at (H, W), in plane_dtype(bd)."""
    H1, W1 = H >> 1, W >> 1
    dt = plane_dtype(bd)
    return (torch.empty((H1, W1), dtype=dt, device=device),
            torch.empty((H1 >> 1, W1 >> 1), dtype=dt, device=device))


def me_pyramid(src_y, sb_rows: int, sb_cols: int, bd: int = 8):
    """The source's ME pyramid (levels 1 and 2 of the plane edge-padded to
    the SB grid), for the `src_pyr` of me_fullpel_frame calls that share the
    source: one K8 launch (mode 0) on the card, plane_dtype(bd) there, int32
    on the CPU."""
    _check_me_plane(src_y, "src_y", bd)
    Hs, Ws = _grid_dims(src_y, sb_rows, sb_cols)
    if src_y.device.type == "cpu":
        l1 = decimate2_plain(edge_pad(src_y, Hs, Ws).to(torch.int32))
        return l1, decimate2_plain(l1)
    l1, l2 = _levels(Hs, Ws, src_y.device, bd)
    h, w = src_y.shape
    _me_launch(_ME_PYRAMID, (None, None, None, src_y, l1, l2), None, (0, 0, 0, 0, h, w, Hs, Ws),
               bd)
    return l1, l2


def me_fullpel_frame(src_y, ref_y, sb_rows: int, sb_cols: int, l2_radius: int = 16,
                     leaf_radius: int = 4, ref_off_x: int = 0, src_pyr=None, bd: int = 8):
    """Full-pel per-size ME of one frame against one reference (K8): src_y
    (H, W) and ref_y (Hr, Wr) planes of depth bd (plane_dtype(bd) on the
    card), each read as if edge-padded to at least the (64 sb_rows, 64
    sb_cols) SB grid. ref_off_x, a multiple of 4, is the column of ref_y
    that source column 0 sits at (a tile's reference cropped with a halo is
    wider than the tile); every reference read clamps to ref_y's own dims.
    src_pyr: the source's me_pyramid, when several references share the
    source. Returns ({n: (R_n, C_n, 2) int32 full-pel MVs} for n in SIZES,
    SB MVs (B_sb, 2)). On the card: two K8 launches (the pyramid, the frame
    search; `me_sad16` at 10 bits), and the radii must be the defaults."""
    if ref_off_x % 4:
        raise ValueError(f"me_fullpel_frame: ref_off_x {ref_off_x} is not a multiple of 4")
    _check_me_plane(src_y, "src_y", bd)
    _check_me_plane(ref_y, "ref_y", bd)
    if src_y.device.type == "cpu":
        return me_fullpel_frame_plain(src_y, ref_y, sb_rows, sb_cols, l2_radius, leaf_radius,
                                      ref_off_x, src_pyr)
    if (l2_radius, leaf_radius) != (16, 4):
        raise ValueError("me_fullpel_frame: the kernel searches l2_radius=16, leaf_radius=4")
    dims, src_pyr, ref_pyr = _pyramids(src_y, ref_y, sb_rows, sb_cols, bd, src_pyr)
    return _frame_search(src_y, ref_y, src_pyr, ref_pyr, dims, sb_rows, sb_cols, bd, ref_off_x)


def _pyramids(src_y, ref_y, sb_rows: int, sb_cols: int, bd: int, src_pyr=None):
    """K8's first launch: the reference's pyramid, and the source's unless
    given (the planes checked by the caller). Returns (dims, src_pyr,
    ref_pyr)."""
    Hs, Ws = _grid_dims(src_y, sb_rows, sb_cols)
    Hr, Wr = _grid_dims(ref_y, sb_rows, sb_cols)
    dims = (*src_y.shape, Hs, Ws, *ref_y.shape, Hr, Wr)
    ref_pyr = _levels(Hr, Wr, ref_y.device, bd)
    if src_pyr is None:
        src_pyr = _levels(Hs, Ws, src_y.device, bd)
        _me_launch(_ME_PYRAMID, (src_y, *src_pyr, ref_y, *ref_pyr), None, dims, bd)
    else:
        for p, want in zip(src_pyr, ((Hs >> 1, Ws >> 1), (Hs >> 2, Ws >> 2))):
            kernels.check(p, "src_pyr", plane_dtype(bd), want)
        _me_launch(_ME_PYRAMID, (None, None, None, ref_y, *ref_pyr), None, dims, bd)
    return dims, src_pyr, ref_pyr


def _frame_search(src_y, ref_y, src_pyr, ref_pyr, dims, sb_rows: int, sb_cols: int, bd: int,
                  ref_off_x: int = 0):
    """K8's second launch, the search of every SB; the results of
    me_fullpel_frame as views of one buffer."""
    B = sb_rows * sb_cols
    buf = torch.empty(2 * 86 * B, dtype=torch.int32, device=src_y.device)
    _me_launch(_ME_FRAME, (src_y, *src_pyr, ref_y, *ref_pyr), buf, dims, bd, ref_off_x,
               (sb_rows, sb_cols), (16, 4))
    out, o = {}, 0
    for n in SIZES:  # size-major regions, raster over each size's block grid
        k = 64 // n
        out[n] = buf[o : o + 2 * B * k * k].view(sb_rows * k, sb_cols * k, 2)
        o += 2 * B * k * k
    return out, buf[o:].view(B, 2)


MC_WIDTHS = (4, 8, 16, 32, 64)  # K10's lane widths


def mc_lanes(ref, ys, xs, mv_q16_y, mv_q16_x, n_h: int, n_w: int, which: int, bd: int,
             ref_idx=None):
    """Batched normative subpel MC with per-lane phases (K10).

    ref: (H, W) plane or (NREF, H, W) stack with ref_idx (B,) given;
    plane_dtype(bd) on the card. ys/xs (B,) block top-left in plane coords;
    MVs in 1/16 pel of this plane. Returns (B, n_h, n_w) int32 predictions;
    dims <= 4 use the 4-tap filter variant (spec 7.11.3.4). On the card
    n_w is one of MC_WIDTHS."""
    return mc_lanes_planes([ref], ys, xs, mv_q16_y, mv_q16_x, n_h, n_w, which, bd, ref_idx)[0]


def mc_lanes_planes(refs, ys, xs, mv_q16_y, mv_q16_x, n_h: int, n_w: int, which: int, bd: int,
                    ref_idx=None):
    """K10 on up to three planes of one shape and dtype (`refs`, each an (H,
    W) plane or an (NREF, H, W) stack) that share the lanes: positions, MVs,
    ref indices and dimensions, as mc_lanes takes them. One launch; returns
    (P, B, n_h, n_w) int32, equal to P calls of mc_lanes."""
    for r in refs:
        check_plane(r, "ref", bd)
    if ys.device.type == "cpu":
        return mc_lanes_planes_plain(refs, ys, xs, mv_q16_y, mv_q16_x, n_h, n_w, which, bd,
                                     ref_idx)
    ref = refs[0]
    if not 1 <= len(refs) <= 3 or any(r.shape != ref.shape for r in refs):
        raise ValueError("mc_lanes_planes: 1 to 3 planes of one shape")
    if n_w not in MC_WIDTHS or n_h < 1:
        raise ValueError(f"mc_lanes: lanes {MC_WIDTHS} samples wide, got {n_w}")
    B = ys.shape[0]
    nref = 1 if ref.dim() == 2 else ref.shape[0]
    if ref.dim() == 3 and ref_idx is None:
        raise ValueError("mc_lanes: a reference stack needs ref_idx")
    args = [_i32(a) for a in (ys, xs, mv_q16_y, mv_q16_x)]
    ri = _i32(ref_idx) if ref_idx is not None else None
    out = torch.empty((len(refs), B, n_h, n_w), dtype=torch.int32, device=ys.device)
    if B == 0:
        return out
    dev = str(ys.device)
    planes = [r.data_ptr() for r in refs] + [None] * (3 - len(refs))
    kernels.launch(_kname("mc_lanes", bd), *planes, *[a.data_ptr() for a in args],
                   ri.data_ptr() if ri is not None else None,
                   _ftab(filter_for_dim(which, n_w), dev).data_ptr(),
                   _ftab(filter_for_dim(which, n_h), dev).data_ptr(), out.data_ptr(), len(refs),
                   B, nref, ref.shape[-2], ref.shape[-1], n_h, n_w, bd, kernels.stream_ptr(out))
    return out


def subpel_pred_lanes(src_b, ref, ys, xs, mv_fp, which: int, bd: int, fast: bool = False):
    """Subpel search with the winner's prediction (K9).

    src_b (B, n, n) int32 source blocks at (ys, xs) of the (H, W) reference
    plane `ref` (plane_dtype(bd) on the card), mv_fp (B, 2) full-pel MVs.
    Every point of the 1/8-pel lattice around mv_fp ({-4..4}^2 step 2 when
    fast, else {-6..6}^2) is MC'd from one (n+8)^2 patch per block; fast
    takes the first SAD minimum in (dy, dx) raster order, otherwise the
    half-pel step (9 points) and then the quarter-pel step around its
    winner (strictly better only). Returns (mv8 (B, 2) int32 = mv_fp*8 + d,
    pred (B, n, n) int32), pred equal to mc_lanes at mv8."""
    check_plane(ref, "ref", bd)
    if src_b.device.type == "cpu":
        return subpel_pred_plain(src_b, ref, ys, xs, mv_fp, which, bd, fast)
    kernels.check(src_b, "src_b", torch.int32)
    B, n = src_b.shape[0], src_b.shape[-1]
    if n not in SIZES:
        raise ValueError("subpel_pred_lanes: 8x8, 16x16, 32x32 or 64x64 blocks")
    ys, xs, mv_fp = _i32(ys), _i32(xs), _i32(mv_fp)
    mv8 = torch.empty((B, 2), dtype=torch.int32, device=src_b.device)
    pred = torch.empty((B, n, n), dtype=torch.int32, device=src_b.device)
    if B == 0:
        return mv8, pred
    kernels.launch(_kname("subpel_pred", bd), src_b.data_ptr(), ref.data_ptr(), ys.data_ptr(),
                   xs.data_ptr(),
                   mv_fp.data_ptr(), _ftab(which, str(src_b.device)).data_ptr(), mv8.data_ptr(),
                   pred.data_ptr(), B, ref.shape[-2], ref.shape[-1], n, bd, int(bool(fast)),
                   kernels.stream_ptr(pred))
    return mv8, pred


def subpel_refine_lanes(src_b, ref, ys, xs, mv_fp, which: int, bd: int):
    """Two-step (half, then quarter pel) 9-point refinement by SAD (K14),
    the TPL's subpel step.

    src_b (B, n, n) int32 source blocks at (ys, xs) of the (H, W) reference
    plane `ref` (plane_dtype(bd) on the card; `subpel_refine16` at 10
    bits), mv_fp (B, 2) full-pel MVs. Each step MCs the nine candidates
    around the current MV (offsets dy major, dx minor, from (-1, -1) to
    (1, 1), times 4 then 2 eighth-pels) and takes the first SAD minimum, so
    a corner that ties the centre wins. Returns (B, 2) int32 1/8-pel MVs."""
    check_plane(ref, "ref", bd)
    if src_b.device.type == "cpu":
        return subpel_refine_plain(src_b, ref, ys, xs, mv_fp, which, bd)
    kernels.check(src_b, "src_b", torch.int32)
    B, n = src_b.shape[0], src_b.shape[-1]
    if n not in SIZES:
        raise ValueError("subpel_refine_lanes: 8x8, 16x16, 32x32 or 64x64 blocks")
    ys, xs, mv_fp = _i32(ys), _i32(xs), _i32(mv_fp)
    mv8 = torch.empty((B, 2), dtype=torch.int32, device=src_b.device)
    if B == 0:
        return mv8
    kernels.launch(_kname("subpel_refine", bd), src_b.data_ptr(), ref.data_ptr(), ys.data_ptr(),
                   xs.data_ptr(), mv_fp.data_ptr(),
                   _ftab(filter_for_dim(which, n), str(src_b.device)).data_ptr(), mv8.data_ptr(),
                   B, ref.shape[-2], ref.shape[-1], n, bd, kernels.stream_ptr(mv8))
    return mv8


def mc_lanes_compound(refs, ys, xs, mv0y, mv0x, mv1y, mv1x, n_h: int, n_w: int, which: int,
                      bd: int, ref0_idx, ref1_idx):
    """Batched compound-average MC (K11): the conv-buf predictions of every
    lane from refs[ref0_idx] at mv0 and refs[ref1_idx] at mv1, blended by the
    normative average. refs: (NREF, H, W) stack (plane_dtype(bd) on the
    card); ys/xs (B,) block top-left in plane coords; MVs in 1/16 pel of
    this plane. Returns (B, n_h, n_w) int32; dims <= 4 use the 4-tap filter
    variant. On the card n_w is one of MC_WIDTHS."""
    return mc_lanes_compound_planes([refs], ys, xs, mv0y, mv0x, mv1y, mv1x, n_h, n_w, which, bd,
                                    ref0_idx, ref1_idx)[0]


def mc_lanes_compound_planes(refs, ys, xs, mv0y, mv0x, mv1y, mv1x, n_h: int, n_w: int,
                             which: int, bd: int, ref0_idx, ref1_idx):
    """K11 on up to three (NREF, H, W) stacks of one shape and dtype (`refs`,
    the U and V of the references) that share the lanes: positions, MVs, ref
    indices and dimensions, as mc_lanes_compound takes them. One launch;
    returns (P, B, n_h, n_w) int32, equal to P calls of mc_lanes_compound."""
    for r in refs:
        check_plane(r, "refs", bd)
    if ys.device.type == "cpu":
        return mc_compound_planes_plain(refs, ys, xs, mv0y, mv0x, mv1y, mv1x, n_h, n_w, which,
                                        bd, ref0_idx, ref1_idx)
    ref = refs[0]
    if not 1 <= len(refs) <= 3 or any(r.shape != ref.shape for r in refs):
        raise ValueError("mc_lanes_compound_planes: 1 to 3 stacks of one shape")
    if ref.dim() != 3:
        raise ValueError("mc_lanes_compound: a (NREF, H, W) reference stack")
    if n_w not in MC_WIDTHS or n_h < 1:
        raise ValueError(f"mc_lanes_compound: lanes {MC_WIDTHS} samples wide, got {n_w}")
    B = ys.shape[0]
    args = [_i32(a) for a in (ys, xs, mv0y, mv0x, mv1y, mv1x, ref0_idx, ref1_idx)]
    out = torch.empty((len(refs), B, n_h, n_w), dtype=torch.int32, device=ys.device)
    if B == 0:
        return out
    dev = str(ys.device)
    planes = [r.data_ptr() for r in refs] + [None] * (3 - len(refs))
    kernels.launch(_kname("mc_compound", bd), *planes, *[a.data_ptr() for a in args],
                   _ftab(filter_for_dim(which, n_w), dev).data_ptr(),
                   _ftab(filter_for_dim(which, n_h), dev).data_ptr(), out.data_ptr(), len(refs),
                   B, ref.shape[0], ref.shape[-2], ref.shape[-1], n_h, n_w, bd,
                   kernels.stream_ptr(out))
    return out
