"""Where the time of an encode goes on the card: key frames, the P frames
of a low-delay GOP, or the B frames of a random-access GOP.

Key frames (--keyint 1, the default): encodes one warm frame, then N frames
of the synthetic clip through Encoder(device="cuda") at a preset (default
medium, with DLF, CDEF and RDOQ on) twice. GOP (--keyint N > 1): encodes a
2-frame warm GOP, then, on fresh encoders, the key frame of an N-frame GOP
untimed and its N-1 P frames (send_frame + flush) measured, twice; with
--minigop 2, 4 or 8 those frames are hierarchical-B mini-GoPs, and with
--enable-tf the key frame's MCTF and encode (which wait for its future
neighbours) and the anchors' MCTF fall inside the measurement too. The two
measured runs are untraced, for the wall time, and under torch.profiler, for
the device time. Prints one JSON line: wall seconds per frame (untraced and
traced: their difference is the tracing cost), the device's busy share (the
device-side kernel and copy time of the traced frames, one stream, over the
untraced wall time), device milliseconds per frame of the busiest device
functions and of every kernel of the port (its template instances
summed), host seconds per frame of each pipeline stage (utils.profiler,
untraced; for inter frames tf, gm, decide, partition_dp, commit/device
with its commit/phase_a and commit/phase_b parts, filter, entropy_walk, and the
transfers), per stage (tf, decide, commit, filter) the launches of each kernel
and the sum of their bounds (the least time the card could take for each
launch's work, from its arguments), and the card's name and power limit.

Run on a GPU machine from the repository root:
    python -m svtav1_tpu_torch.utils.profile_keyframes --preset medium --frames 2
    python -m svtav1_tpu_torch.utils.profile_keyframes --preset fast --no-cdef
    python -m svtav1_tpu_torch.utils.profile_keyframes --keyint 6
    python -m svtav1_tpu_torch.utils.profile_keyframes --keyint 17 --minigop 8 --enable-tf
    python -m svtav1_tpu_torch.utils.profile_keyframes --keyint 16 --bd 10
    python -m svtav1_tpu_torch.utils.profile_keyframes --keyint 17 --minigop 8 --enable-tf \
        --rc crf --lookahead 16
--rc crf codes the GOP under CRF: TPL over lookahead windows (stage tpl, on
K1, K8, K10, K14, K15) sets each frame's qindex, inside the measurement.
    python -m svtav1_tpu_torch.utils.profile_keyframes --frames 8 --intra-batch 8
codes the N key frames as batches of --intra-batch frames (send_frame +
flush: one decide, one K16 launch and one filter pass per batch), after a
warm run of the same frames.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT32_OPS_PER_S = 33.5e12  # half the 67 TFLOP/s float32 rate (64 INT32 lanes/SM/clock)


def k2_ops(n: int, L: int, n_vadst: int, n_hadst: int, forward: bool = True,
           inverse: bool = True) -> int:
    """int32 operations of K2 on L n x n lanes of which n_vadst take the
    vertical and n_hadst the horizontal ADST (the others the DCT): 5 per
    stage output of each 1-D network that runs (two products, a sum, the
    rounding and the shift; a size without an ADST table, ADST4 or n > 16,
    counts as its DCT), and 20 per coefficient for the residual and the
    quantizer, and 20 more for the dequantizer, the add and the SSE."""
    from ..ops import transforms as T
    from ..ops import transforms_torch as TT

    tabs = TT.tables_for(n, "cpu")

    def stages(kind: str, cos_bit: int) -> int:
        key = (f"{kind}{n}", cos_bit)
        return len(tabs.stages[key if key in tabs.stages else (f"{kind[0]}dct{n}", cos_bit)])

    per = 0  # stage passes summed over the lanes: columns, then rows
    for nadst, cb in ((n_vadst, tabs.cb_col), (n_hadst, tabs.cb_row)):
        if forward:
            per += (L - nadst) * stages("fdct", cb) + nadst * stages("fadst", cb)
        if inverse:
            per += ((L - nadst) * stages("idct", T.INV_COS_BIT)
                    + nadst * stages("iadst", T.INV_COS_BIT))
    return 5 * n * n * per + 20 * n * n * L * (int(forward) + int(inverse))


def launch_bound(name: str, args: tuple, extra=None) -> tuple[float, float]:
    """(bytes, int32 operations) of one kernel launch from its C arguments
    (kernels.ARGTYPES order): each input read once, each output written
    once, and the arithmetic per element that chip_smoke.py also counts.
    `extra`, what lives on the card: for K2 (lanes with the vertical ADST,
    lanes with the horizontal ADST) of the launch, for K7 the unmasked
    cells. The 16-bit forms of K8-K14 (`me_sad16`, ...) read 2-byte samples
    where their 8-bit forms read one."""
    from ..kernels import FORM16

    sz = 1
    if name in FORM16.values():
        name, sz = name[:-2], 2
    if name == "intra_pred":
        B, n, nmodes, one = args[9], args[10], args[12], args[5] is not None
        out = B * (1 if one else nmodes) * n * n
        return B * (2 * n + 1) * 4 + 2 * B + 4 * B * one + out * 4, out * 10
    if name == "txfm_quant_recon":
        coeff, recon, sse, stage, L, rep, n = args[5:12]
        adj = min(n, 32)
        ops = k2_ops(n, L, *extra, forward=stage != 2, inverse=stage != 1)
        if stage == 1:
            return 2 * L * n * n * 4 + 2 * L * adj * adj * 4 + 2 * L, ops
        if stage == 2:
            return L * adj * adj * 4 + 2 * L * n * n * 4 + 2 * L, ops
        return ((L // rep + L) * n * n * 4 + L * adj * adj * 4 + (L * n * n * 4 if recon else 0)
                + (8 * L if sse else 0) + 2 * L), ops
    if name in ("txb_rate", "rdoq"):
        B, h, w = args[4:7] if name == "txb_rate" else args[6:9]
        return ((B * h * w * 4 + 4 * B, B * h * w * 30) if name == "txb_rate"
                else (3 * B * h * w * 4, B * h * w * 80))
    if name == "dlf_edges":  # each distinct plane and map read once, each job's planes written
        ptrs, (J, F, H, W) = list(args[0]), args[2:6]
        jobs = [ptrs[4 * j : 4 * j + 4] for j in range(J)]
        maps = F * (H // 4) * (W // 4 - 1) * 4 + F * (W // 4) * (H // 4 - 1) * 4
        return (len({jb[0] for jb in jobs}) * F * H * W * 4 + J * F * H * W * 4
                + len({(jb[1], jb[2]) for jb in jobs}) * maps), 0
    if name == "cdef_dir":
        F, H, W = args[3:6]
        cells = F * (H // 8) * (W // 8)
        return F * H * W * 4 + 2 * cells * 4, cells * (64 * 8 + 15 * 8 * 3)
    if name == "cdef_search":
        K, F, H, W = args[8:12]
        return cdef_search_work(F, H, W, K, extra)
    if name == "cdef_apply":
        K, F, H, W = args[13:17]
        return cdef_apply_work(F, H, W, K, extra)
    if name == "me_sad":
        mode, src0, (hs, ws, Hs, Ws, hr, wr, Hr, Wr, _ox, sbr, sbc) = args[0], args[1], args[8:19]
        if mode == 0:  # the pyramid of the reference, and of the source unless given
            planes = [(hr, wr, Hr, Wr)] + ([(hs, ws, Hs, Ws)] if src0 is not None else [])
            return (sum(h * w + me_levels(H, W) for h, w, H, W in planes) * sz,
                    sum(me_levels(H, W) for _h, _w, H, W in planes) * 5)
        return me_frame_work(hs, ws, Hs, Ws, hr, wr, Hr, Wr, sbr, sbc, sz)
    if name == "subpel_pred":
        B, n, fast = args[8], args[11], args[13]
        L = 5 if fast else 7
        return B * n * n * (8 + sz) + 16 * B, B * (L * (n + 8) * n * 16 + L * L * n * n * 19)
    if name == "mc_lanes":  # P planes: the lanes' positions, MVs and ref indices read once
        P, B, nh, nw = args[11], args[12], args[16], args[17]
        return (B * 20 + P * B * nh * nw * (4 + sz),
                P * B * ((nh + 7) * nw * 16 + nh * nw * 20))
    if name == "mc_compound":  # P planes: the lanes' positions, MVs and ref indices read once
        P, B, nh, nw = args[14], args[15], args[19], args[20]
        return (B * 32 + P * B * nh * nw * (4 + 2 * sz),
                P * B * (2 * ((nh + 7) * nw * 16 + nh * nw * 18) + nh * nw * 6))
    if name == "tf_filter":  # Y, U, V: the centre in its dtype, K int32 predictions, output
        K, R, C = args[8:11]
        samples = R * C * 384
        return samples * (sz + 4 * K + 4) + 4, K * samples * 20
    if name == "tf_noise":  # the luma, the two sums and h2
        H, W = args[4:6]
        return H * W * sz + 20, H * W * 20
    if name == "subpel_refine":
        B, H, W, n = args[7:11]
        return H * W * sz + B * n * n * 4 + B * 24, B * 2 * (3 * (n + 8) * n * 16 + 9 * n * n * 19)
    if name == "tpl_cost":
        recon, mode, L, rep, n = args[4:9]
        return ((L // rep + L) * n * n * 4 + (4 if mode == 0 else 8) * L
                + (L * n * n * 4 if recon else 0)), tpl_cost_ops(L, n, bool(recon))
    raise ValueError(name)


CDEF_TAP_OPS = 36    # per filtered sample: 12 tap differences and the max and min over them
CDEF_CAND_OPS = 108  # per sample and candidate: 12 constrained taps (9 each), sum, clamp, error


def cdef_search_work(F: int, H: int, W: int, K: int, cells_on: int) -> tuple:
    """(bytes, int32 operations) of K7's search on F (H, W) luma planes
    with `cells_on` unmasked 8x8 cells: the cells' mask, direction and
    variance read (9 bytes a cell), the plane and the source read on the
    unmasked cells only, the (K, F) int64 sums written; per unmasked sample
    the tap work once and the per-candidate work K times."""
    cells = F * (H // 8) * (W // 8)
    samples = 64 * cells_on
    return (cells * 9 + 2 * samples * 4 + K * F * 8,
            samples * (CDEF_TAP_OPS + K * CDEF_CAND_OPS))


def cdef_apply_work(F: int, H: int, W: int, K: int, cells_on: int) -> tuple:
    """(bytes, int32 operations) of K7's apply: the three planes read and
    written (a masked-out cell is copied), the cells' mask, direction and
    variance and the (K, F) sums read, the (F, 4) strengths written; per
    unmasked luma and chroma sample the tap work and one candidate's."""
    cells = F * (H // 8) * (W // 8)
    return (2 * F * H * W * 3 // 2 * 4 + cells * 9 + K * F * 8 + F * 16,
            (64 + 2 * 16) * cells_on * (CDEF_TAP_OPS + CDEF_CAND_OPS))


def me_levels(H: int, W: int) -> int:
    """Samples of the ME pyramid's levels 1 and 2 of an (H, W) plane."""
    return (H >> 1) * (W >> 1) + (H >> 2) * (W >> 2)


def me_frame_diffs(sb_rows: int, sb_cols: int) -> int:
    """Absolute differences of K8's frame search: per SB the L2 search
    (33 x 33 displacements of 16x16), the L1 and L0 refinements (25 of 32x32
    and of 64x64) and the two centres' leaf maps (64 leaves x 81 x 64)."""
    return sb_rows * sb_cols * (33 * 33 * 256 + 25 * 1024 + 25 * 4096 + 2 * 64 * 81 * 64)


def me_frame_work(hs, ws, Hs, Ws, hr, wr, Hr, Wr, sb_rows: int, sb_cols: int,
                  sample_bytes: int = 1) -> tuple:
    """(bytes, int32 operations) of K8's frame search: the planes and
    pyramid levels (uint8, or int16 at 10 bits: sample_bytes 2) read once,
    the MVs written (85 blocks and the SB MV per SB), and 3 operations per
    absolute difference (a subtraction, the absolute value, the sum), the
    sum of the three searches' and the leaf maps' counts of the launches it
    replaces."""
    B = sb_rows * sb_cols
    nbytes = ((hs * ws + hr * wr + me_levels(Hs, Ws) + me_levels(Hr, Wr)) * sample_bytes
              + 86 * B * 8)
    return nbytes, 3 * me_frame_diffs(sb_rows, sb_cols)


def dct_stages(n: int, inverse: bool) -> int:
    """Stages of one DCT_DCT block's 1-D passes of size n: the forward
    column and row networks, and the two inverse passes when `inverse`."""
    from ..ops import transforms as T
    from ..ops import transforms_torch as TT

    tabs = TT.tables_for(n, "cpu")
    keys = [(f"fdct{n}", tabs.cb_col), (f"fdct{n}", tabs.cb_row)]
    keys += [(f"idct{n}", T.INV_COS_BIT)] * (2 if inverse else 0)
    return sum(len(tabs.stages[k]) for k in keys)


def tpl_cost_ops(L: int, n: int, recon: bool) -> int:
    """int32 operations of K15 on L n x n lanes: its DCT networks (5 per
    stage output: two products, a sum, the rounding and the shift) and 20
    per coefficient for the residual, the quantizer and the sums."""
    return L * (dct_stages(n, recon) * n * n * 5 + 20 * n * n)


def bound_ms(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3


SMS = 132  # H100 SXM streaming multiprocessors


def commit_wave_work(table, tx_ntypes: int, rdoq: bool, handoff_ms: float | None = None) -> dict:
    """The work of K16 on a phase-B task table (pipeline.wavefront): `bytes`,
    what K16 itself moves per task (its code, mode and tx read, the source
    block and the edges read, the levels and the recon written, and the
    frontier cells written: the bottom row, the right column and one corner
    per 8x8 luma cell; the prediction, coefficients and levels between
    steps stay in shared memory), `ops`, the int32 operations of the K1,
    K2 and K5 work of its lanes (launch_bound's counts), `bound_ms`, and
    `depth`, the tasks on the longest path of the predecessor graph. With
    `handoff_ms` (one ready flag handed between two CTAs, measured),
    `chain_ms`: the longest path with each task on it at one SM's share of
    the int32 rate and each edge one handoff."""
    import numpy as np

    from ..pipeline import wavefront
    from ..pipeline.device_decide import SIZES

    si, pl, _lane = table.decode()
    task_ops = np.zeros(len(table.tasks))
    nbytes = 0
    for s, n in enumerate(SIZES):
        for chroma in (False, True):
            sel = (si == s) & ((pl > 0) == chroma)
            L = int(sel.sum())
            if not L:
                continue
            m = n // 2 if chroma else n
            adj = min(m, 32)
            n8 = n // 8
            ntypes = (4 if m <= 16 else 1) if chroma else (tx_ntypes if n <= 16 else 1)
            tx = table.tx[sel]
            va = np.isin(tx, (1, 2)) & (ntypes > 1)
            ha = np.isin(tx, (1, 3)) & (ntypes > 1)
            nbytes += L * (3 * 4 + m * m * 4 + (2 * m + 1) * 4 + adj * adj * 4 + m * m * 4
                           + (2 * m + n8 * n8) * 4)
            # each task's operations: K2's count for its own DCT/ADST pair
            per = {(a, b): m * m * 10 + k2_ops(m, 1, a, b) + (adj * adj * 80 if rdoq else 0)
                   for a in (0, 1) for b in (0, 1)}
            task_ops[sel] = [per[(int(a), int(b))] for a, b in zip(va, ha)]
    ops = int(task_ops.sum())
    out = dict(bytes=nbytes, ops=ops, bound_ms=bound_ms(nbytes, ops),
               depth=int(wavefront.chain_length(table)))
    if handoff_ms is not None:
        out["chain_ms"] = wavefront.chain_length(table, task_ops / (INT32_OPS_PER_S / SMS) * 1e3,
                                                 handoff_ms)
    return out


def count_launches(fn, default: str = "other"):
    """Run fn() with every kernel launch recorded against the pipeline stage
    (decide, commit, filter, tf or tpl) it belongs to, and a launch outside
    them against `default`. Returns {stage: {kernel: [launches, summed bound
    ms]}}."""
    from .. import kernels
    from ..ops import tf_torch
    from ..ops import transforms_torch as TT
    from ..filters import cdef_torch
    from ..pipeline import device_commit, device_decide, inter_device, tpl, wavefront

    current = [default]
    out: dict = {}
    real_launch = kernels.launch
    real_k2 = TT._launch
    real_k16 = wavefront.commit_wave
    real_search, real_apply = cdef_torch.cdef_search, cdef_torch.cdef_apply
    extra = [None]  # what a launch's bound needs from the card (a sync: untimed run)
    k16_bound = [0.0]

    def k2_launch(stage, src, pred, v_adst, h_adst, *rest):
        # the launch's DCT/ADST split
        extra[0] = (int(v_adst.sum()), int(h_adst.sum()))
        real_k2(stage, src, pred, v_adst, h_adst, *rest)

    def search(plane, dirs, var, mask, *rest):  # K7: the unmasked cells
        extra[0] = int(mask.sum())
        return real_search(plane, dirs, var, mask, *rest)

    def apply(planes, dirs, var, mask, *rest):
        extra[0] = int(mask.sum())
        return real_apply(planes, dirs, var, mask, *rest)

    def k16(src, maps, lanes, table, dq_dc, dq_ac, bd, tx_ntypes, lam, rdoq_qctx, **kw):
        # K16's bound, from the task table
        k16_bound[0] = commit_wave_work(table, tx_ntypes, rdoq_qctx is not None)["bound_ms"]
        return real_k16(src, maps, lanes, table, dq_dc, dq_ac, bd, tx_ntypes, lam, rdoq_qctx,
                        **kw)

    def launch(name, *args):
        real_launch(name, *args)
        rec = out.setdefault(current[0], {}).setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += (k16_bound[0] if name == "commit_wave"
                   else bound_ms(*launch_bound(name, args, extra[0])))

    def staged(stage, f):
        def run(*a, **k):
            current[0] = stage
            try:
                return f(*a, **k)
            finally:
                current[0] = default
        return run

    saved = [(device_decide, "decide_intra_frames"), (inter_device, "_run_decide"),
             (device_commit, "commit_regions"), (device_commit, "_filter_device"),
             (tf_torch, "filter_planes"), (tpl, "tpl_window")]
    originals = [getattr(m, a) for m, a in saved]
    kernels.launch = launch
    TT._launch = k2_launch
    cdef_torch.cdef_search, cdef_torch.cdef_apply = search, apply
    wavefront.commit_wave = k16
    for (m, a), f, stage in zip(saved, originals,
                                ("decide", "decide", "commit", "filter", "tf", "tpl")):
        setattr(m, a, staged(stage, f))
    try:
        fn()
    finally:
        kernels.launch = real_launch
        TT._launch = real_k2
        cdef_torch.cdef_search, cdef_torch.cdef_apply = real_search, real_apply
        wavefront.commit_wave = real_k16
        for (m, a), f in zip(saved, originals):
            setattr(m, a, f)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--qindex", type=int, default=120)
    ap.add_argument("--preset", choices=("fast", "medium", "slow"), default="medium")
    ap.add_argument("--no-cdef", action="store_true", help="encode with CDEF off")
    ap.add_argument("--keyint", type=int, default=1,
                    help="1: key frames; N > 1: the inter frames of an N-frame GOP")
    ap.add_argument("--minigop", type=int, choices=(1, 2, 4, 8), default=1,
                    help="1: low-delay P frames; 2, 4, 8: hierarchical-B mini-GoPs")
    ap.add_argument("--enable-tf", action="store_true",
                    help="MCTF of the key frame and the mini-GoP anchors")
    ap.add_argument("--bd", type=int, choices=(8, 10), default=8,
                    help="bit depth: 10 encodes the 10-bit clip (the 8-bit one << 2 plus "
                         "seeded low bits) on int16 planes")
    ap.add_argument("--rc", choices=("cqp", "crf"), default="cqp",
                    help="rate control: crf runs TPL over lookahead windows (needs --keyint > 1)")
    ap.add_argument("--lookahead", type=int, default=16, help="CRF's TPL window in frames")
    ap.add_argument("--intra-batch", type=int, default=1,
                    help="key frames (--keyint 1): code them in batches of this many frames")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..pipeline.encoder import Encoder, EncoderConfig
    from . import profiler
    from .testclip import make_frames

    gop = args.keyint > 1
    batched = not gop and args.intra_batch > 1
    n = args.keyint - 1 if gop else args.frames
    frames = make_frames(args.width, args.height, n + 1, seed=args.seed, bd=args.bd)

    def encoder():
        return Encoder(EncoderConfig(args.width, args.height, qindex=args.qindex,
                                     keyint=args.keyint, minigop=args.minigop,
                                     enable_tf=args.enable_tf, preset=args.preset,
                                     enable_cdef=not args.no_cdef, bd=args.bd, rc_mode=args.rc,
                                     lookahead=args.lookahead, intra_batch=args.intra_batch),
                       device="cuda")

    enc = encoder()
    if gop:  # a short warm GOP (with minigop > 1 a key frame and a 2-frame mini-GoP)
        for f in frames[: 2 if args.minigop == 1 else 3]:
            enc.send_frame(*f)
        enc.flush()
    elif batched:  # the measured frames' batches, warm
        for f in frames[1:]:
            enc.send_frame(*f)
        enc.flush()
    else:
        enc.encode_frame(*frames[0])
    torch.cuda.synchronize()

    def prepare() -> None:
        """Before each measured run of a GOP: a fresh encoder and its key
        frame, outside the measurement."""
        nonlocal enc
        if gop:
            enc = encoder()
            enc.send_frame(*frames[0])
            torch.cuda.synchronize()

    def encode_all() -> float:
        """Wall seconds of the n measured frames: the P frames of the GOP,
        or n more key frames."""
        t0 = time.perf_counter()
        for f in frames[1:]:
            enc.send_frame(*f) if gop or batched else enc.encode_frame(*f)
        if gop or batched:
            enc.flush()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    prepare()
    profiler.reset()
    wall = encode_all()
    stages = {k: v / n for k, v in profiler.report().items()}
    waves = profiler.counts().get("commit/waves", 0) / n
    prepare()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_wall = encode_all()
    dev_us = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue  # CPU ops also carry their kernels' device time
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        dev_us[ev.key[:80]] = dev_us.get(ev.key[:80], 0.0) + us
    busy_s = sum(dev_us.values()) / 1e6
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:12]
    family_us = {}  # a kernel's template instances summed: txq_lines_kernel<8>, <16>, ...
    for k, us in dev_us.items():
        m = re.search(r"(\w+_kernel)\b", k)
        if m:
            family_us[m.group(1)] = family_us.get(m.group(1), 0.0) + us
    prepare()
    launches = count_launches(encode_all)
    bounds = {st: dict(kernels={k: dict(launches=v[0] / n, bound_ms=v[1] / n)
                                for k, v in ks.items()},
                       bound_ms_per_frame=sum(v[1] for v in ks.values()) / n)
              for st, ks in launches.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(dict(
        size=[args.width, args.height], bd=args.bd, preset=args.preset, cdef=not args.no_cdef,
        keyint=args.keyint, minigop=args.minigop, enable_tf=args.enable_tf, rc=args.rc,
        lookahead=args.lookahead if args.rc == "crf" else None, frames=n,
        intra_batch=args.intra_batch if batched else 1,
        measured=("key frames" if not gop else "P frames" if args.minigop == 1 else "B frames")
        + (" (and the key frame's MCTF and encode)" if gop and args.enable_tf
           else " (and the key frame's encode)" if gop and args.rc == "crf" else ""),
        waves_per_frame=waves,
        wall_s_per_frame=wall / n,
        traced_wall_s_per_frame=traced_wall / n, device_busy_s_per_frame=busy_s / n,
        device_busy_share=(busy_s / wall) if busy_s else "not measured",
        device_ms_per_frame_by_kernel={k: v / 1e3 / n for k, v in top},
        device_ms_per_frame_by_port_kernel={k: v / 1e3 / n for k, v in
                                            sorted(family_us.items(), key=lambda kv: -kv[1])},
        host_stage_s_per_frame=stages, stage_kernel_bounds_per_frame=bounds,
        card=smi)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
