#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (svtav1_tpu_torch) on one GPU.

Phases, each fatal on failure:
  1. build the CUDA kernels from svtav1_tpu_torch/csrc with nvcc (sm_90a),
     one nvcc per source, all started together;
  2. run each kernel and its plain PyTorch version on the card at the
     shapes its path gives it and hold them equal (K3: rtol 1e-5, atol 1e-3
     bits; all others exact, K5 counting its differing lanes and K12 its
     differing samples; K13's decay h2 also against the host's float32;
     K9's prediction also against K10 at the MVs it returns; K9 also at
     the MCTF shape, n = 16 on the 49-point lattice;
     K1 at the key frame's decide shape, a P frame's four luma sizes and
     their U+V lanes, the TPL probe, the commit waves' lanes and tails of
     1, 7 and 33 lanes at every size, with and without `mode`, at 8 and 10
     bits;
     K11 at every block size of the commit, 8x8 to 64x64 luma lanes and
     their U and V lanes in one launch (the planes form); K14 and K15 at
     the TPL shapes of a 1088x1920 frame (K15 mode 0 on the probe's 40,800
     lanes and on 8,160, mode 1 with the recon on 8,160), K15 at qindex
     120 and 255, both
     also on the 10-bit clip (K14's 16-bit form `subpel_refine16`, K15 at
     bd=10); K8 as
     its pyramid launch, its frame-search launch and the whole
     me_fullpel_frame, every size and the SB MVs, on the decide's uint8
     1080x1920 planes (510 SBs) and with a reference wider than the
     source at the 1920x1024 tile GOP's tile shape, 1024x960 against
     1024x1216 with ref_off_x=128, with the device work items of one call
     (torch.profiler); K2 also at the decide's 16x16 shape, K3 also on
     16x16 luma and the decide's chroma sizes; K6 on the clip's 1080p
     luma, a 1080p plane of extreme cells, both as a batch of two frames
     and the luma at a pointer 4 bytes off 16-byte alignment (its scalar
     loads), at 8 and 10 bits; K7's search and apply on
     the clip's noisy 1080p planes with 80% and 20% of the cells unmasked;
     K4 on a 1080p luma plane at three levels in one launch, on its U and V
     in one launch, and on adversarial tiles (all 64x64 blocks, all 8x8,
     flat blocks that fire the 14-tap flat2, noise); K10 on the commit's
     luma lanes, on U and V in one launch, at the decide's chroma sizes and
     on three planes, and the decide's GLOBALMV lanes as four launches
     against one), and time both (`device_ms`: a CUDA graph of 20 launches); K8's and K9's bounds count their operations at the
     rates of VABSDIFF4, IDP.2A and IDP.4A measured first (`packed_rates`
     line); then at 10 bits, on the 10-bit clip (the clip << 2 plus seeded
     low bits) as int16 planes at the same shapes: the 16-bit forms of K8
     (`me_sad16`, its operations at the better of the int32 count and the
     measured rate of the scalar VABSDIFF, one per absolute difference), K9
     (`subpel_pred16`, also at the MCTF shape), K10 (`mc_lanes16`) and K11
     (`mc_compound16`, as K11), K12 and K13 (`tf_filter16`,
     `tf_noise16`, as at 8 bits), and K1-K7 once each at bd=10 (K1 with
     lanes that have neither neighbour: DC 512), all exact;
  3. conformance: encode a CIF key frame on the card at the fast preset
     without CDEF and one at the default medium preset, a 3-frame CIF GOP
     (a key frame and 2 P frames, keyint=6) at medium, and CIF
     random-access GOPs with MCTF at medium (keyint=16; minigop=8, 9
     frames; minigop=4, 5 frames); decode every TU with the port's decoder
     (recon bit-identical); encode the same clips with device="cpu" (in
     worker processes, while the card encodes) and report the share of
     bytes that match; then run the CLI in-process on
     the minigop-4 clip written as a y4m (--keyint 16 --minigop 4
     --enable-tf --verify): it must exit 0 and its IVF must hold the
     library run's TUs; the rate-control clips go the same way: a 9-frame
     CRF random-access GOP (minigop=4, MCTF, lookahead=8), 8-frame
     low-delay GOPs (keyint=8) with CBR, VBR and two-pass VBR at 300 kbps,
     and a scene cut spliced at frame 4 with keyint=1000, which must be
     coded as a key frame; at 10 bits, the 3-frame CIF low-delay GOP and
     the 5-frame CIF random-access GOP with MCTF, their bytes against the
     CPU's too; then 5 CIF key frames in batches of 4, a CIF mini-GoP of 4
     with loop restoration and a CIF low-delay GOP with film grain, their
     bytes against the CPU's as the others';
  4. the paths: 1 warm + 1 timed 1920x1080 key frame at the fast preset
     without CDEF (K1-K4 launched), 1 warm + 2 timed key frames at the
     medium preset (K1-K7 launched), then the clip's first 8 frames as key
     frames in one batch (intra_batch=8: K16 launched once) and one by one,
     three runs each in turns after a warm run of each, every TU and recon
     equal, frames/s, stage seconds, launches and peak device memory, at 8
     and at 10 bits; then the main path, the bench's clip:
     16 frames of 1920x1080 with keyint=16 (a key frame and 15 low-delay P
     frames) at the medium preset with DLF, RDOQ, CDEF and global motion on,
     through send_frame + flush on a fresh Encoder after a 2-frame warm
     run, with every kernel K1-K10 launched and the first two TUs (the key
     frame and the first P frame) decoded bit-exactly; then the
     random-access path: 17 frames of the clip with keyint=32, minigop=8 and
     MCTF (a key frame and two 8-frame hierarchical-B mini-GoPs; frames 0,
     8 and 16 filtered) through send_frame + flush on a fresh Encoder after
     a 3-frame warm run, with every kernel K1-K13 launched and the first
     three TUs (the key frame, the hidden anchor 8, frame 4) decoded
     bit-exactly; then the CRF path: the same 17 frames with CRF (TPL over
     16-frame lookahead windows: 41 TPL frames), with every kernel K1-K16
     launched, each frame's qindex and each window's r0 printed, and one
     16-frame TPL window timed alone with its launches and kernel bounds;
     then one-pass VBR at 1000 kbps on the 16-frame low-delay GOP (every
     inter frame finished before the next starts), its achieved bitrate
     printed, and after it film grain on the main path's first 4 frames
     (the recon equal to the run without grain, the decoder's output the
     recon plus the signalled grain) and loop restoration on its key frame
     and first P frame and on the 10-bit clip's key frame (the restoration
     types from the frame headers, the stages' seconds, bytes and Y-PSNR
     beside the frames without restoration; the filters K4, K6 and K7
     launched); the 10-bit low-delay GOP (16 frames) and the 10-bit
     random-access GOP with MCTF (17 frames) on the 10-bit clip, their
     Y-PSNR at peak 1023, every 16-bit form launched and no 8-bit form of
     K8-K13 (and the 8-bit paths no 16-bit form), their first TUs decoded
     with the others; after the CRF path, the same CRF GOP on the 10-bit
     clip (K8-K14's 16-bit forms and K15 launched, no 8-bit form
     of them; qindex, r0, bytes, Y-PSNR at peak 1023, the `tpl` stage's ms
     per frame and frames/s beside the 8-bit CRF GOP's); launch counts
     are reset just before each path and read just after; the 1080p clip
     is made once; after the paths, the first TUs of each (and one medium
     key frame) are decoded, one worker process per
     sequence; K16 commit_wave runs on every path (each commit's phase B
     in one launch), and its inputs are copied from seven launches of the
     paths: the fast key frame's (no RDOQ), the medium key frame's, a P
     frame's of the low-delay GOP, a B frame's of the random-access GOP
     (one with compound lanes), the key frame's and a P frame's of the
     10-bit GOP, and the 8-frame batch's of the batched all-intra path; on
     each
     schedule K16 and the wave loop of
     K1, K2 and K5 run from the same state and must give the same levels,
     recon, frontier maps and skip map; both phase-B times of this call
     (the wrapper, and the launch alone), the waves, the dependency depth,
     K16's grid, one flag handoff between two CTAs and the chain bound
     (`commit_wave` lines); then the decide capture: every K2
     and K3 launch of the decide and commit phase A of a 1080p medium key
     frame and the first P frame of the main path (a fresh encoder, 2
     frames), and the P frame's K9 launches and K8 calls (each
     me_fullpel_frame, two launches), each replayed on a copy of its
     inputs through the kernel and its plain version (K3 within the
     tolerance above, the others exact) and timed, its bound from its
     arguments: per frame the launches, summed ms and bounds of each
     kernel, and per distinct launch shape (`decide_capture` lines); the
     same again on the 10-bit GOP's first two frames (the 16-bit forms of
     K8 and K9, K2 and K3 at bd=10);
  5. tiles: a 256x64 GOP (a key frame and 2 P frames in two tile columns)
     through parallel.tiles' encoders on the card and with the plain
     versions on the CPU, byte for byte, decoded bit-exactly, at 8 and at
     10 bits; the 8-tile
     1080p medium key frame through the Encoder (1 warm + 1 timed frame)
     beside phase 4's one-tile one (frames/s, bytes, Y-PSNR); the tile
     encoders in two 960-column tiles, filters off, on a 1920x1080 key
     frame and on a key frame and 2 P frames at 1920x1024 (the tallest
     1920-wide size whose tiles are whole superblocks, as the inter tile
     decide needs; also at 10 bits, only the 16-bit forms of K8-K10
     launched): the decide's ms per frame, each frame's seconds,
     launches and summed bounds per stage; every tile stream is decoded
     after the paths, and also by libaom where the host has it (the
     number of TUs it checked is printed, 0 without libaom);
  6. host mode decision (`mode_decision="numpy"`, filter-intra on): a
     3-frame CIF low-delay GOP at medium through the Encoder on the card
     while worker processes encode it with the plain versions on the CPU
     (bytes equal) and the 10-bit and restoration CIF key frames on the
     card (decoded there); the GOP's TUs decoded bit-exactly, with the
     blocks coded with filter-intra counted (more than 0); every frame
     launches K4, K6 and K7 and no other kernel; per frame the launches
     and the `host_md`, `filter` and `entropy_walk` seconds, and the host
     MD seconds scaled to a 1080p frame beside the card's name and power
     limit. CIF, not 1080p: a host-MD CIF key frame takes 30-40 s on the
     host, a 1080p one 20.45 times as many pixels;
  7. phase 2's records again in short, each phase's seconds, the card's
     name and power limit, the kernel table, and last the device line.

Run: python3 chip_smoke.py   (needs one CUDA card, nvcc and gcc; exits
non-zero without a card or outside the repository).
     python3 chip_smoke.py --baseline-lib OTHER/build/libsvtav1_torch_kernels.so
also times phase 2's K1, K2, K3, K5, K7, K8 and K9 cases (8-bit), K4's, K6's,
K10's, K11's, K12's, K13's, K14's and K15's at 8 and 10 bits, K16 on the
captured 8-bit schedules and every captured 8-bit K2, K3, K8 and K9 launch
through a kernel library built from another checkout with the same C entry
points (the parent commit's, after its own chip_smoke.py run built it), on
the same inputs, and holds its results equal too (`baseline_ms`,
`baseline_device_ms`).
"""
import contextlib
import functools
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# H100 SXM runs 64 INT32 lanes per SM per clock, half its 128 FP32 lanes:
# half of the 67 TFLOP/s float32 rate (multiply-add counted as two ops)
INT32_OPS_PER_S = 33.5e12
FAST = dict(qindex=120, keyint=1, preset="fast", enable_cdef=False)
MEDIUM = dict(qindex=120, keyint=1, preset="medium")  # DLF, CDEF and RDOQ on
GOP = dict(qindex=120, keyint=16, preset="medium")  # the bench's 1080p clip (bench.py:92-139)
# random access: hierarchical-B mini-GoPs of 8 with compound prediction and MCTF
RA = dict(qindex=120, keyint=32, minigop=8, enable_tf=True, preset="medium")
KERNEL_SOURCES = {  # name -> (source, the TPU-side function it replaces)
    "intra_pred": ("svtav1_tpu_torch/csrc/intra_pred.cu", "svtav1_tpu/pipeline/intra_device.py:31"),
    "txfm_quant_recon": ("svtav1_tpu_torch/csrc/txfm_quant_recon.cu",
                         "svtav1_tpu/ops/transforms_jax.py:136"),
    "txb_rate": ("svtav1_tpu_torch/csrc/txb_rate.cu", "svtav1_tpu/codec/rate_jax.py:57"),
    "dlf_edges": ("svtav1_tpu_torch/csrc/dlf_edges.cu", "svtav1_tpu/filters/dlf_jax.py:64"),
    "rdoq": ("svtav1_tpu_torch/csrc/rdoq.cu", "svtav1_tpu/codec/rate_jax.py:220"),
    "cdef_dir": ("svtav1_tpu_torch/csrc/cdef.cu", "svtav1_tpu/filters/cdef_jax.py:26"),
    "cdef_search": ("svtav1_tpu_torch/csrc/cdef.cu", "svtav1_tpu/filters/cdef_jax.py:166"),
    "cdef_apply": ("svtav1_tpu_torch/csrc/cdef.cu", "svtav1_tpu/filters/cdef_jax.py:203"),
    "me_sad": ("svtav1_tpu_torch/csrc/me.cu", "svtav1_tpu/ops/me_jax.py:86"),
    "subpel_pred": ("svtav1_tpu_torch/csrc/subpel.cu", "svtav1_tpu/ops/me_jax.py:300"),
    "mc_lanes": ("svtav1_tpu_torch/csrc/mc.cu", "svtav1_tpu/ops/me_jax.py:183"),
    "mc_compound": ("svtav1_tpu_torch/csrc/mc.cu", "svtav1_tpu/ops/me_jax.py:248"),
    "tf_filter": ("svtav1_tpu_torch/csrc/tf.cu", "svtav1_tpu/ops/tf_jax.py:71"),
    "tf_noise": ("svtav1_tpu_torch/csrc/tf.cu", "svtav1_tpu/ops/tf_jax.py:30"),
    "subpel_refine": ("svtav1_tpu_torch/csrc/subpel.cu", "svtav1_tpu/ops/me_jax.py:373"),
    "tpl_cost": ("svtav1_tpu_torch/csrc/txfm_quant_recon.cu", "svtav1_tpu/pipeline/tpl.py:56"),
    "commit_wave": ("svtav1_tpu_torch/csrc/commit.cu", "svtav1_tpu/pipeline/device_commit.py:542"),
    # the 16-bit forms of K8-K14, on the int16 planes of 10-bit encodes
    "me_sad16": ("svtav1_tpu_torch/csrc/me.cu", "svtav1_tpu/ops/me_jax.py:86"),
    "subpel_pred16": ("svtav1_tpu_torch/csrc/subpel.cu", "svtav1_tpu/ops/me_jax.py:300"),
    "mc_lanes16": ("svtav1_tpu_torch/csrc/mc.cu", "svtav1_tpu/ops/me_jax.py:183"),
    "mc_compound16": ("svtav1_tpu_torch/csrc/mc.cu", "svtav1_tpu/ops/me_jax.py:248"),
    "subpel_refine16": ("svtav1_tpu_torch/csrc/subpel.cu", "svtav1_tpu/ops/me_jax.py:373"),
    "tf_filter16": ("svtav1_tpu_torch/csrc/tf.cu", "svtav1_tpu/ops/tf_jax.py:71"),
    "tf_noise16": ("svtav1_tpu_torch/csrc/tf.cu", "svtav1_tpu/ops/tf_jax.py:30"),
}
LD_KERNELS = tuple(KERNEL_SOURCES)[:11] + ("commit_wave",)  # K1-K10, K16: low-delay GOP
RA_ONLY = ("mc_compound", "tf_filter", "tf_noise")  # K11-K13: the random-access GOP
CRF_ONLY = ("subpel_refine", "tpl_cost")  # K14-K15: the CRF GOP's TPL
# the kernels with a 16-bit form -> that form, as kernels.FORM16 derives them
_FORM16 = {k: k + "16" for k in KERNEL_SOURCES if k + "16" in KERNEL_SOURCES}
TEN_BIT = tuple(_FORM16.values())
LD10_KERNELS = tuple(_FORM16.get(k, k) for k in LD_KERNELS)  # the low-delay GOP at 10 bits
RA10_ONLY = ("mc_compound16", "tf_filter16", "tf_noise16")  # K11-K13 at 10 bits
RA10_KERNELS = LD10_KERNELS + RA10_ONLY
CRF10_ONLY = ("subpel_refine16", "tpl_cost")  # K14's 16-bit form and K15: the 10-bit CRF GOP
# CRF: TPL over lookahead windows sets each frame's qindex (random access, MCTF)
CRF = dict(qindex=120, keyint=32, minigop=8, rc_mode="crf", lookahead=16, enable_tf=True,
           preset="medium")
# one-pass VBR on the low-delay GOP (CQP at qindex 120 gives about 945 kbps on the clip)
VBR = dict(qindex=120, keyint=16, rc_mode="vbr", target_kbps=1000.0, fps=30.0, preset="medium")
# tiles: 8 uniform tiles of a 1080p key frame (columns of 8, 8, 8 and 6 SBs, rows of 9 and 8)
TILES = dict(MEDIUM, tile_cols_log2=2, tile_rows_log2=1)
MESH_TILES = 2  # parallel.tiles at full width: two 960-column tiles
CHECKS = []  # phase 2's records, [kernel, shape, max_abs_err, ms, plain_ms, bound_ms]
PATHS = {}  # label -> the 1080p key-frame paths' fps, bytes and Y-PSNR
# key frames code no inter lane: K5 runs inside K16 there
KEY_KERNELS = ("intra_pred", "txfm_quant_recon", "txb_rate", "dlf_edges", "cdef_dir",
               "cdef_search", "cdef_apply", "commit_wave")
FAST_KERNELS = ("intra_pred", "txfm_quant_recon", "txb_rate", "dlf_edges", "commit_wave")
K16_CAPTURED = {}  # schedule -> the inputs of one K16 launch of a path (wavefront.commit_wave)


def log(msg):
    print(msg, flush=True)


@functools.lru_cache(maxsize=2)
def _clip_1080p(bd):
    from svtav1_tpu_torch.utils.testclip import make_frames

    return make_frames(1920, 1080, 17, seed=0, bd=bd)


def clip_1080p(n, bd=8):
    """The first n (at most 17) frames of the bench's synthetic 1920x1080
    clip (utils/testclip.make_frames, seed 0), made once; at 10 bits the
    8-bit clip << 2 plus seeded low bits."""
    return _clip_1080p(bd)[:n]


def y_psnr_db(rec_y, src_y, bd=8):
    """Y-PSNR of a recon against its source, peak 2^bd - 1."""
    import numpy as np

    H, W = src_y.shape
    d = rec_y[:H, :W].astype(np.float64) - src_y
    return 10 * np.log10(float((1 << bd) - 1) ** 2 / max(float((d * d).mean()), 1e-12))


def timed_ms(fn, reps):
    """Median ms of `reps` runs, CUDA events around each."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def device_ms(fn, reps=20):
    """Device ms per call: `reps` calls captured in one CUDA graph and the
    graph replayed between CUDA events (median of 3), so that no host time
    sits between the launches."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def bound(nbytes, ops):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


RATES = {}  # lane instructions per second of the packed instructions (packed_rates)


def packed_rates(torch):
    """Lane instructions per second of VABSDIFF4.U8.ACC (K8's SAD step),
    IDP.2A and IDP.4A (K9's two passes), IMAD, VABSDIFF2 with its sum
    (K8's 10-bit SAD step, compiled as the card implements it) and the
    scalar VABSDIFF with its sum (one absolute difference) on this card:
    packed_rate_launch, 8 independent chains per thread, 132 x 16 CTAs of
    256 threads, 4,096 steps (median of 3 CUDA-event timings)."""
    from svtav1_tpu_torch import kernels

    lib = kernels.lib()
    blocks, iters = 132 * 16, 4096
    out = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")
    res = {}
    for which, name in enumerate(("vabsdiff4", "idp2a", "idp4a", "imad", "vabsdiff2",
                                  "vabsdiff")):
        def run(which=which):
            err = lib.packed_rate_launch(which, blocks, iters, out.data_ptr(),
                                         kernels.stream_ptr(out))
            if err:
                raise SystemExit(f"packed_rate_launch {name}: cudaError {err}")
        res[name] = blocks * 256 * iters * 8 / (timed_ms(run, 3) * 1e-3)
    return res


def k9_packed_ops_ms(B, n, L, bd=8):
    """K9's operations' least time at the measured packed rates: per block,
    two IDP.4A (10 bits: four IDP.2A) per horizontal intermediate sample of
    the L column phases over n + 8 rows, and four IDP.2A and one absolute
    difference with its sum (VABSDIFF, at the VABSDIFF4 rate) per predicted
    sample of the L x L lattice."""
    horizontal = (2 / RATES["idp4a"]) if bd == 8 else (4 / RATES["idp2a"])
    return B * (L * (n + 8) * n * horizontal + 4 * L * L * n * n / RATES["idp2a"]
                + L * L * n * n / RATES["vabsdiff4"]) * 1e3


def me_frame_ops_ms(diffs, bd):
    """(least ms, VABSDIFF2-rate ms) of the frame search's `diffs` absolute
    differences: at 8 bits four per VABSDIFF4 at its measured rate; at 10
    bits the better of the int32 count (3 operations each) and one scalar
    VABSDIFF each at its measured rate. The second number, the same
    differences two per VABSDIFF2 as the 16-bit form runs them, is a
    diagnostic (None at 8 bits)."""
    if bd == 8:
        return diffs / 4 / RATES["vabsdiff4"] * 1e3, None
    return (min(3 * diffs / INT32_OPS_PER_S, diffs / RATES["vabsdiff"]) * 1e3,
            diffs / 2 / RATES["vabsdiff2"] * 1e3)


def k14_packed_ops_ms(B, n, bd):
    """K14's operations' least time at the measured packed rates: two steps,
    each K9's work (k9_packed_ops_ms) on 3 column phases and a 3 x 3
    lattice."""
    return 2 * k9_packed_ops_ms(B, n, 3, bd)


def packed_bound_ms(name, args):
    """A K8, K9, K11 or K14 launch's bound (its C arguments) with the
    operations at the measured packed rates: K9's as k9_packed_ops_ms, K11's
    as k11_packed_ops_ms, K14's as k14_packed_ops_ms, the frame search's
    absolute differences as me_frame_ops_ms, K8's pyramid as counted."""
    from svtav1_tpu_torch.utils.profile_keyframes import bound_ms, launch_bound, me_frame_diffs

    nbytes, ops = launch_bound(name, args)
    if name in ("subpel_pred", "subpel_pred16"):
        B, n, fast = args[8], args[11], args[13]
        return max(nbytes / HBM_BYTES_PER_S * 1e3,
                   k9_packed_ops_ms(B, n, 5 if fast else 7, 10 if name.endswith("16") else 8))
    if name in ("subpel_refine", "subpel_refine16"):
        B, n, bd = args[7], args[10], args[11]
        return max(nbytes / HBM_BYTES_PER_S * 1e3, k14_packed_ops_ms(B, n, bd))
    if name in ("mc_compound", "mc_compound16"):
        P, B, nh, nw, bd = args[14], args[15], args[19], args[20], args[21]
        return max(nbytes / HBM_BYTES_PER_S * 1e3, k11_packed_ops_ms(P, B, nh, nw, bd))
    if args[0] == 1:  # the frame search
        ops_ms, _ = me_frame_ops_ms(me_frame_diffs(args[17], args[18]),
                                    10 if name == "me_sad16" else 8)
        return max(nbytes / HBM_BYTES_PER_S * 1e3, ops_ms)
    return bound_ms(nbytes, ops)


def k9_same(assert_equal, mv, pred):
    """K9's check of another library's (MV, prediction) against this one's."""
    def same(out):
        assert_equal("subpel_pred (baseline)", out[0], mv)
        assert_equal("subpel_pred (baseline)", out[1], pred)
    return same


def device_launches(torch, fn):
    """Device work items of any kind (kernels, copies, sets) of one call of
    fn, counted by torch.profiler; None when three traces in a row saw no
    device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back without its device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
        if n:
            return n
    return None


def check_me_frame(torch, record, assert_equal, src8, ref8, sbr, sbc, ox, main=False, bd=8):
    """K8 on one frame against one reference (uint8 planes, or at bd=10 the
    int16 planes of its 16-bit form, `me_sad16`): the source pyramid (one
    launch), the frame search alone (one launch, from the pyramids) and the
    whole me_fullpel_frame with a shared source pyramid (two launches), each
    held exactly against its plain version (every size and the SB MVs) and
    timed; the frame search's bound with its operations as me_frame_ops_ms
    (`bound_ms`; the int32 count's as `int32_bound_ms`, at 10 bits the
    VABSDIFF2 rate's as `vabsdiff2_ops_ms`); the device work items of one call of the kernel path
    and of the plain version (torch.profiler); at 8 bits with
    --baseline-lib, the parent's K8 on the same inputs (its entry point is
    this one's). Returns the MVs by size."""
    from svtav1_tpu_torch import kernels
    from svtav1_tpu_torch.ops import me_torch
    from svtav1_tpu_torch.utils.profile_keyframes import me_frame_diffs, me_frame_work, me_levels

    name = "me_sad" if bd == 8 else "me_sad16"
    sz = 1 if bd == 8 else 2
    shape = [*src8.shape, f"{sbr}x{sbc} SBs"] + ([] if bd == 8 else ["10-bit"])
    if ox:
        shape.append(f"ref {ref8.shape[0]}x{ref8.shape[1]}, ref_off_x {ox}")
    Hs, Ws = me_torch._grid_dims(src8, sbr, sbc)
    Hr, Wr = me_torch._grid_dims(ref8, sbr, sbc)

    def times(fn, same, reps=20):
        """device_ms, and the parent's kernel at 8 bits (kernel_times)."""
        return kernel_times(fn, same, reps) if bd == 8 else dict(device_ms=device_ms(fn, reps))

    def pyramid():
        return me_torch.me_pyramid(src8, sbr, sbc, bd)

    def pyramid_plain():
        l1 = me_torch.decimate2_plain(me_torch.edge_pad(src8, Hs, Ws).to(torch.int32))
        return l1, me_torch.decimate2_plain(l1)

    pyr = pyramid()
    want_pyr = pyramid_plain()
    err = max(assert_equal(name, a.to(torch.int32), b) for a, b in zip(pyr, want_pyr))

    def same_pyr(out):
        for a, b in zip(out, want_pyr):
            assert_equal(name + " (baseline)", a.to(torch.int32), b)

    record(name, shape + ["pyramid, source"], err, timed_ms(pyramid, 20),
           timed_ms(pyramid_plain, 5), nbytes=(src8.numel() + me_levels(Hs, Ws)) * sz,
           ops=me_levels(Hs, Ws) * 5, **times(pyramid, same_pyr))

    def call():
        return me_torch.me_fullpel_frame(src8, ref8, sbr, sbc, ref_off_x=ox, src_pyr=pyr, bd=bd)

    def plain():
        return me_torch.me_fullpel_frame_plain(src8, ref8, sbr, sbc, ref_off_x=ox)

    before = kernels.launches[name]
    got, got_sb = call()
    launches = kernels.launches[name] - before
    want, want_sb = plain()
    err = assert_equal(name, got_sb, want_sb)
    for n in me_torch.SIZES:
        err = max(err, assert_equal(name, got[n], want[n]))
    dims, _src_pyr, ref_pyr = me_torch._pyramids(src8, ref8, sbr, sbc, bd, pyr)

    def same_mvs(out):
        assert_equal(name + " (baseline)", out[1], want_sb)
        for n in me_torch.SIZES:
            assert_equal(name + " (baseline)", out[0][n], want[n])

    def frame():
        return me_torch._frame_search(src8, ref8, pyr, ref_pyr, dims, sbr, sbc, bd, ox)

    f_mvs, f_sb = frame()
    assert_equal(name, f_sb, want_sb)
    nbytes, ops = me_frame_work(*dims, sbr, sbc, sz)
    diffs = me_frame_diffs(sbr, sbc)
    packed, vabsdiff2_ms = me_frame_ops_ms(diffs, bd)
    diag = {} if vabsdiff2_ms is None else dict(vabsdiff2_ops_ms=vabsdiff2_ms)
    plain_ms = timed_ms(plain, 3)
    record(name, shape + ["frame search"], err, timed_ms(frame, 20), plain_ms, nbytes, ops,
           main=main, abs_differences=diffs, packed_ops_ms=packed, **diag,
           **times(frame, same_mvs))
    ref_bytes = (ref8.numel() + me_levels(Hr, Wr)) * sz
    record(name, shape + ["me_fullpel_frame"], err, timed_ms(call, 20), plain_ms,
           nbytes + ref_bytes, ops + me_levels(Hr, Wr) * 5, device_ms=device_ms(call),
           me_sad_launches=launches, device_launches=device_launches(torch, call),
           plain_device_launches=device_launches(torch, plain))
    return got


def k3_close(name, a, b):
    """K3's bits against the plain version's: rtol 1e-5, atol 1e-3 bits (the
    float32 sums run in another order). Returns the max abs error."""
    import torch

    torch.cuda.synchronize()
    diff = (a - b).abs()
    err = float(diff.max().item()) if diff.numel() else 0.0
    if not bool((diff <= 1e-3 + 1e-5 * b.abs()).all()):
        raise SystemExit(f"{name}: kernel disagrees with its plain version (max err {err})")
    return err


BASELINE = []  # [the ctypes handle of --baseline-lib] when the option is given


def load_baseline(path):
    """A kernel library built from another checkout (the parent commit's
    build/libsvtav1_torch_kernels.so) with the same C entry points, bound as
    kernels.lib() binds its own: K1-K16 are also timed through it, on the
    same inputs, and must give the same results."""
    import ctypes

    from svtav1_tpu_torch import kernels

    handle = ctypes.CDLL(os.path.abspath(path))
    for fn, argtypes in kernels.ARGTYPES.items():
        f = getattr(handle, fn, None)
        if f is not None:
            f.argtypes = argtypes
            f.restype = ctypes.c_int
    BASELINE.append(handle)


@contextlib.contextmanager
def baseline_kernels():
    """Route kernels.launch to the baseline library inside the block."""
    from svtav1_tpu_torch import kernels

    kernels.lib()
    saved = kernels._lib
    kernels._lib = BASELINE[0]
    try:
        yield
    finally:
        kernels._lib = saved


def kernel_times(fn, same, reps, baseline=True):
    """A kernel's extra times: `device_ms` (device_ms()), and with
    --baseline-lib (unless `baseline` is false), after `same` holds the
    baseline library's result against this checkout's, `baseline_ms`
    (timed_ms(), as `ms`) and `baseline_device_ms` through it."""
    out = dict(device_ms=device_ms(fn, reps))
    if BASELINE and baseline:
        with baseline_kernels():
            same(fn())
            out.update(baseline_ms=timed_ms(fn, reps), baseline_device_ms=device_ms(fn, reps))
    return out


def check_kernels(torch, dev):
    """Phase 2. Returns {kernel: dict(max_abs_err, ms, plain_ms, bound_ms, bound_by)}."""
    import numpy as np

    from svtav1_tpu_torch import kernels
    from svtav1_tpu_torch.codec import rate_torch
    from svtav1_tpu_torch.codec.tile_codec import max_uv_txsize
    from svtav1_tpu_torch.constants.av1 import MAX_TXSIZE_RECT, TxSize, TxType
    from svtav1_tpu_torch.constants.cdf import get_q_ctx
    from svtav1_tpu_torch.filters import cdef_torch, dlf_torch
    from svtav1_tpu_torch.ops import quantize as quant_ops
    from svtav1_tpu_torch.ops import transforms_torch as TT
    from svtav1_tpu_torch.pipeline import intra_device
    from svtav1_tpu_torch.pipeline.device_decide import BSIZE_BY_N, fc_for_qctx
    from svtav1_tpu_torch.pipeline.intra_md import rd_lambda
    from svtav1_tpu_torch.utils.profile_keyframes import k2_ops

    g = np.random.default_rng(1)
    res = {}

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dtype).to(dev)

    def edges(B, n, bd=8):
        above = t(g.integers(0, 1 << bd, (B, n)))
        left = t(g.integers(0, 1 << bd, (B, n)))
        tl = t(g.integers(0, 1 << bd, B))
        ha = t(g.random(B) < 0.9, torch.bool)
        hl = t(g.random(B) < 0.9, torch.bool)
        return above, left, tl, ha, hl

    def record(name, shape, err, ms, plain_ms, nbytes, ops, main=False, packed_ops_ms=None,
               **extra):
        """packed_ops_ms: the operations' least time at the measured rates of
        the instructions the card has for them (K8, K9; `ops_rate`
        "measured"); it replaces the int32 count's, which stays as
        int32_bound_ms."""
        b_ms, b_by = bound(nbytes, ops)
        if packed_ops_ms is not None:
            extra.update(int32_bound_ms=b_ms, ops_rate="measured")
            b_ms, b_by = max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                             (packed_ops_ms, "operations"))
        log(json.dumps(dict(check=name, shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by, **extra)))
        CHECKS.append([name, shape, err, round(ms, 4), round(plain_ms, 3), round(b_ms, 4)])
        if main:
            res[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        elif name in res:
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)

    def assert_equal(name, a, b):
        torch.cuda.synchronize()
        err = int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) if a.numel() else 0
        if not torch.equal(a, b):
            raise SystemExit(f"{name}: kernel disagrees with its plain version (max err {err})")
        return err

    # ---- K1 intra_pred at the shapes of the 1080p paths: the key frame's
    # decide (8x8, 13 modes), a P frame's four luma sizes (7 modes) and their
    # U+V lanes (one mode each), the TPL probe (40,800 16x16 lanes of its 5
    # modes), the commit waves' lanes; tails of 1, 7 and 33 lanes at every
    # size, with and without `mode`, at 8 and 10 bits (checked, not timed).
    # Device time and, with --baseline-lib, the parent's kernel on the same
    # inputs (kernel_times).
    def k1_case(label, B, n, nmodes, modes=None, main=False, bd=8, timed=True):
        e = edges(B, n, bd)
        mode = None if modes is None else t(np.resize(np.asarray(modes), B))
        kw = dict(mode=mode, nmodes=nmodes, bd=bd)
        got = intra_device.predict(*e, n, **kw)
        err = assert_equal("intra_pred", got, intra_device.predict_plain(*e, n, **kw))
        if not timed:
            return
        out = B * (1 if mode is not None else nmodes) * n * n
        record("intra_pred", [B, nmodes if mode is None else 1, n, n, label], err,
               timed_ms(lambda: intra_device.predict(*e, n, **kw), 20),
               timed_ms(lambda: intra_device.predict_plain(*e, n, **kw), 3),
               nbytes=B * (2 * n + 1) * 4 + 2 * B + (4 * B if mode is not None else 0) + out * 4,
               ops=out * 10, main=main,
               **kernel_times(lambda: intra_device.predict(*e, n, **kw),
                              lambda o: assert_equal("intra_pred (baseline)", o, got), 20))

    R8, C8 = 135, 240  # the 1080p frame's 8x8 grid
    B = R8 * C8
    k1_case("key frame decide", B, 8, 13, main=True)
    for n, (R, C) in ((8, (R8, C8)), (16, (68, 120)), (32, (34, 60)), (64, (17, 30))):
        k1_case("P frame decide, luma", R * C, n, 7)
        k1_case("P frame decide, U+V", 2 * R * C, n // 2, 7,
                modes=np.tile(g.integers(0, 7, R * C), 2))
    k1_case("TPL probe", 5 * 8160, 16, 13, modes=(0, 1, 2, 3, 9))
    for n, lanes in ((8, R8), (4, 2 * R8), (32, 34), (16, 2 * 34), (64, 17)):  # wave lanes
        k1_case("commit wave", lanes, n, 13, modes=g.integers(0, 13, lanes))
    for bd in (8, 10):
        for n in (4, 8, 16, 32, 64):
            for lanes in (1, 7, 33):
                k1_case("tail", lanes, n, 13, bd=bd, timed=False)
                k1_case("tail", lanes, n, 13, modes=g.integers(0, 13, lanes), bd=bd,
                        timed=False)

    # ---- K2 txfm_quant_recon: decide n=8 x 13 modes (SSE), n=64, commit
    q = 120
    dq = (quant_ops.dc_q(q, 8), quant_ops.ac_q(q, 8))

    def k2_ops_of(n, L, va, ha, forward=True, inverse=True):
        """K2's operations on L lanes with these per-lane ADST flags: each
        lane runs the DCT or ADST networks that its flags pick."""
        return k2_ops(n, L, int(va.sum().item()), int(ha.sum().item()), forward, inverse)

    def k2_case(n, L, rep, flags, want_recon, want_sse, main=False, reps=20, rng=g):
        """One K2 shape: kernel == plain, both timed; returns the levels."""
        src = t(rng.integers(0, 256, (L // rep, n, n)))
        pred = (src.repeat_interleave(rep, 0) + t(rng.integers(-30, 31, (L, n, n)))) \
            .clamp(0, 255).to(torch.int32).contiguous()
        if flags == "dct":
            va, ha = TT.tx_flags(int(TxType.DCT_DCT), L, dev)
        else:
            va, ha = t(rng.random(L) < 0.5, torch.bool), t(rng.random(L) < 0.5, torch.bool)
        args = (src, pred, va, ha, dq[0], dq[1], 8)
        kw = dict(rep=rep, want_recon=want_recon, want_sse=want_sse)
        out_k = TT.txfm_quant_recon(*args, **kw)
        out_p = TT.txfm_quant_recon_plain(*args, **kw)
        err = 0
        for a, b in zip(out_k, out_p):
            if a is not None:
                err = max(err, assert_equal("txfm_quant_recon", a, b))
        adj = min(n, 32)
        nbytes = (L // rep + L) * n * n * 4 + L * adj * adj * 4 + \
            (L * n * n * 4 if want_recon else 0) + (8 * L if want_sse else 0) + 2 * L

        def same(out_b):
            for a, b in zip(out_b, out_p):
                if a is not None:
                    assert_equal("txfm_quant_recon (baseline)", a, b)

        record("txfm_quant_recon", [L, n, n, rep, flags], err,
               timed_ms(lambda: TT.txfm_quant_recon(*args, **kw), reps),
               timed_ms(lambda: TT.txfm_quant_recon_plain(*args, **kw), 3), nbytes,
               k2_ops_of(n, L, va, ha), main=main,
               **kernel_times(lambda: TT.txfm_quant_recon(*args, **kw), same, reps))
        return out_k[0]

    lv8 = k2_case(8, B * 13, 13, "dct", False, True, main=True)
    k2_case(64, 16 * 30 * 13, 13, "dct", False, True)
    lv32 = k2_case(32, 33 * 60 * 13, 13, "dct", False, True)
    # decide n=16 (its own generator: the cases after it keep their inputs)
    lv16 = k2_case(16, 67 * 120 * 13, 13, "dct", False, True, rng=np.random.default_rng(16))
    k2_case(8, B, 1, "sel", False, True)           # decide tx search, one type
    k2_case(8, R8, 1, "sel", True, False)          # commit luma wave, RDOQ off
    k2_case(4, 2 * R8, 1, "sel", True, False)      # commit chroma wave (ADST4)
    k2_case(64, 17, 1, "dct", True, False)         # 64x64 luma wave

    # K2's halves around RDOQ on real residuals: the clip's 1080p luma in
    # n x n blocks against their rounded means (the forward half feeds K5)
    (y_clip, u_clip, v_clip), = clip_1080p(1)
    fc = fc_for_qctx(get_q_ctx(q))
    lam = float(np.float32(rd_lambda(q, 8)))

    def clip_blocks(plane, n, lanes):
        H, W = plane.shape
        R, C = H // n, W // n
        b = plane[: R * n, : C * n].astype(np.int32).reshape(R, n, C, n).transpose(0, 2, 1, 3) \
            .reshape(-1, n, n)[:lanes]
        pred = np.broadcast_to(b.mean(axis=(1, 2), keepdims=True).round().astype(np.int32), b.shape)
        return t(b), t(pred)

    halves = {}
    for n, lanes, flags, main in ((8, B, "sel", True), (8, R8, "sel", False),
                                  (4, 2 * R8, "sel", False), (32, 34, "dct", False),
                                  (64, 17, "dct", False)):
        src, pred = clip_blocks(u_clip if n == 4 else y_clip, n, lanes)
        L = src.shape[0]
        va = t(g.random(L) < 0.5, torch.bool) if flags == "sel" else TT.tx_flags(0, L, dev)[0]
        ha = t(g.random(L) < 0.5, torch.bool) if flags == "sel" else TT.tx_flags(0, L, dev)[1]
        args = (src, pred, va, ha, dq[0], dq[1], 8)
        lk, ck = TT.txfm_quant(*args)
        lp, cp = TT.txfm_quant_plain(*args)
        err = max(assert_equal("txfm_quant_recon", lk, lp), assert_equal("txfm_quant_recon", ck, cp))
        adj = min(n, 32)
        record("txfm_quant_recon", [L, n, n, "forward half", flags], err,
               timed_ms(lambda: TT.txfm_quant(*args), 20),
               timed_ms(lambda: TT.txfm_quant_plain(*args), 3),
               2 * L * n * n * 4 + 2 * L * adj * adj * 4 + 2 * L,
               k2_ops_of(n, L, va, ha, inverse=False),
               **kernel_times(lambda: TT.txfm_quant(*args),
                              lambda o: [assert_equal("txfm_quant_recon (baseline)", a, b)
                                         for a, b in zip(o, (lp, cp))], 20))
        inv = (lk, pred, va, ha, dq[0], dq[1], 8)
        rp = TT.recon_from_levels_plain(*inv)
        err = assert_equal("txfm_quant_recon", TT.recon_from_levels(*inv), rp)
        record("txfm_quant_recon", [L, n, n, "inverse half", flags], err,
               timed_ms(lambda: TT.recon_from_levels(*inv), 20),
               timed_ms(lambda: TT.recon_from_levels_plain(*inv), 3),
               L * adj * adj * 4 + 2 * L * n * n * 4 + 2 * L,
               k2_ops_of(n, L, va, ha, forward=False),
               **kernel_times(lambda: TT.recon_from_levels(*inv),
                              lambda o: assert_equal("txfm_quant_recon (baseline)", o, rp), 20))
        halves[(n, L)] = (lk, ck, main)

    # ---- K3 txb_rate on real levels: 8x8 (decide n=8), 32x32 and 16x16
    # luma; the decide's chroma sizes (u and v lanes of n/2) on K2's levels
    def k3_case(lv, tabs, label, main=False):
        a = rate_torch.txb_bits(lv, tabs)
        b = rate_torch.txb_bits_plain(lv, tabs)
        err = k3_close("txb_rate", a, b)
        L, nn = lv.shape[0], lv.shape[1] * lv.shape[2]
        record("txb_rate", [L, lv.shape[1], lv.shape[2]] + label, err,
               timed_ms(lambda: rate_torch.txb_bits(lv, tabs), 20),
               timed_ms(lambda: rate_torch.txb_bits_plain(lv, tabs), 3),
               nbytes=L * nn * 4 + L * 4, ops=L * nn * 30, main=main,
               **kernel_times(lambda: rate_torch.txb_bits(lv, tabs),
                              lambda o: k3_close("txb_rate (baseline)", o, b), 20))

    for n, lv, main in ((8, lv8, True), (32, lv32, False), (16, lv16, False)):
        tx = int(MAX_TXSIZE_RECT[BSIZE_BY_N[n]])
        k3_case(lv, rate_torch.make_txb_bits_fn(fc, tx, int(TxType.DCT_DCT), 0, device=dev), [],
                main)
    # K3's threads per transform block against each other (txb_rate_launch
    # takes 16 up to 8x8, 32 above, and at 32x32 256 below 1.5 blocks per
    # resident warp) on the decide's 8x8 and 32x32 levels, at the launch
    # sizes of the main path's launches
    sweep = {}
    for n, lv_all, sizes, groups in ((8, lv8, (32400, lv8.shape[0]), (16, 32)),
                                     (32, lv32, (480, 960, 1440, 3360, 6240, 13860,
                                                 lv32.shape[0]), (32, 256))):
        tabs_n = rate_torch.make_txb_bits_fn(fc, int(MAX_TXSIZE_RECT[BSIZE_BY_N[n]]),
                                             int(TxType.DCT_DCT), 0, device=dev)
        for nb in sizes:
            lk = lv_all[:nb]
            ref = rate_torch.txb_bits_plain(lk, tabs_n)
            for gt in groups:
                o = torch.empty(nb, dtype=torch.float32, device=dev)

                def k3_group(lk=lk, o=o, gt=gt, n=n, tabs_n=tabs_n):
                    err = kernels.lib().txb_rate_launch_group(
                        lk.data_ptr(), tabs_n.flut.data_ptr(), tabs_n.ilut.data_ptr(),
                        o.data_ptr(), lk.shape[0], n, n, n.bit_length() - 1, tabs_n.tx_class, gt,
                        kernels.stream_ptr(lk))
                    if err:
                        raise SystemExit(f"txb_rate_launch_group failed: cudaError {err}")
                    return o

                k3_close("txb_rate (group sweep)", k3_group(), ref)
                sweep.setdefault(f"{n}x{n}", {}).setdefault(nb, {})[gt] = device_ms(k3_group)
    log(json.dumps(dict(check="txb_rate", threads_per_block_sweep_device_ms=sweep)))

    g_uv = np.random.default_rng(8)
    for n, blocks in ((8, B), (16, 67 * 120), (32, 33 * 60), (64, 16 * 30)):
        m = n // 2
        src = t(g_uv.integers(0, 256, (2 * blocks, m, m)))
        pred = (src + t(g_uv.integers(-20, 21, src.shape))).clamp(0, 255).to(torch.int32)
        lv = TT.txfm_quant_recon(src, pred, *TT.tx_flags(0, 2 * blocks, dev), dq[0], dq[1], 8,
                                 want_recon=False)[0]
        tx_uv = int(max_uv_txsize(BSIZE_BY_N[n]))
        k3_case(lv, rate_torch.make_txb_bits_fn(fc, tx_uv, int(TxType.DCT_DCT), 1, 7, 0,
                                                device=dev), ["chroma"])

    # ---- K4 dlf_edges: a 1080p luma plane at three levels in one launch,
    # its U and V in one launch, and the adversarial tiles
    sm = g.choice([8, 16, 32, 64], (1, R8, C8), p=[0.5, 0.3, 0.15, 0.05]).astype(np.int32)
    base = g.integers(60, 190, (1, R8 + 1, C8 + 1))
    plane = np.repeat(np.repeat(base, 8, 1), 8, 2)[:, :1080, :1920] + g.integers(-2, 3, (1, 1080, 1920))
    check_deblock(torch, t, record, assert_equal, sm, np.clip(plane, 0, 255), 8)

    # ---- K5 rdoq: a 1080p frame's 8x8 luma txbs, and the commit's waves
    txs = {8: TxSize.TX_8X8, 4: TxSize.TX_4X4, 32: TxSize.TX_32X32, 64: TxSize.TX_64X64}
    for (n, L), (lk, ck, main) in halves.items():
        plane_type = 1 if n == 4 else 0
        rt = rate_torch.make_rdoq_fn(fc, int(txs[n]), plane_type, txb_skip_ctx=7 if plane_type else 0,
                                     device=dev)
        args = (lk, ck, dq[0], dq[1], lam, rt)
        a = rate_torch.rdoq(*args)
        b = rate_torch.rdoq_plain(*args)
        torch.cuda.synchronize()
        differing = int((a != b).reshape(L, -1).any(dim=1).sum().item())
        err = int((a - b).abs().max().item())
        if differing:
            raise SystemExit(f"rdoq: {differing} of {L} lanes differ from the plain version")
        nn = lk.shape[1] * lk.shape[2]
        record("rdoq", [L, lk.shape[1], lk.shape[2], "chroma" if plane_type else "luma"], err,
               timed_ms(lambda: rate_torch.rdoq(*args), 20),
               timed_ms(lambda: rate_torch.rdoq_plain(*args), 3),
               nbytes=3 * L * nn * 4, ops=L * nn * 80, main=main, differing_lanes=differing,
               changed_levels=int((a != lk).sum().item()),
               **kernel_times(lambda: rate_torch.rdoq(*args),
                              lambda got: assert_equal("rdoq (baseline)", got, a), 20))

    # ---- K6 cdef_dir on the clip's 1080p luma (32,400 cells) and its other
    # cases; K7 cdef_filter: the 7-candidate luma search and the applies
    yp = t(y_clip.astype(np.int32)[None])
    dirs, var = check_cdef_dir(torch, t, record, assert_equal, yp, 8)
    check_cdef(torch, g, t, record, assert_equal, yp, t(u_clip.astype(np.int32)[None]),
               t(v_clip.astype(np.int32)[None]), dirs, var)

    check_motion(torch, dev, g, t, record, assert_equal)
    check_random_access(torch, dev, g, t, record, assert_equal)
    check_tpl(torch, dev, g, t, record, assert_equal)
    check_tiles(torch, dev, g, t, record, assert_equal)
    check_10bit(torch, dev, g, t, record, assert_equal)
    return res


LF_LADDER = (9, 18, 29)  # the nonzero luma candidates around level 18 (_lf_candidates(18))


def check_deblock(torch, t, record, assert_equal, sm, plane, bd):
    """Phase 2 for K4 at bd: the (1, 1080, 1920) luma plane `plane` (size
    map sm) at LF_LADDER's three levels in one launch (the luma search's
    launch), its 540x960 U and V (U's maps from sm, V's from sm coarsened to
    16x16 cells; levels 18 and 12) in one launch, and adversarial tiles at
    1080p: a size map of all 64s (every edge 14-tap, on the tiles' borders)
    and of all 8s on the plane, flat 64x64 blocks 10 levels apart (the
    14-tap filters' flat2: offsets -6 and 5 change), and uniform noise.
    Each against the plain version, exactly; `device_ms` a CUDA graph of 20
    launches; with --baseline-lib the parent's K4 on the same jobs
    (kernel_times)."""
    import numpy as np

    from svtav1_tpu_torch.filters import dlf_torch
    from svtav1_tpu_torch.utils.profile_keyframes import launch_bound

    g = np.random.default_rng(4 + bd)  # the adversarial planes
    R8, C8 = sm.shape[1:]
    tag = [] if bd == 8 else ["10-bit"]

    def maps(smap, pl):
        return [t(dlf_torch.flen_maps_from_sizes(smap, pl, tr, (C8 * 8, R8 * 8)))
                for tr in (False, True)]

    def lims(lvl):
        return dlf_torch._limits(lvl, 0)

    def case(label, jobs, main=False, **extra):
        got = dlf_torch.deblock(jobs, bd)
        want = dlf_torch.deblock_plain(jobs, bd)
        err = assert_equal("dlf_edges", got, want)

        def same(out):
            for a, b in zip(out, got):
                assert_equal("dlf_edges (baseline)", a, b)

        timed = kernel_times(lambda: dlf_torch.deblock(jobs, bd), same, 20)
        ptrs = [v for pl, fv, fh, _a, _b in jobs
                for v in (pl.data_ptr(), fv.data_ptr(), fh.data_ptr(), 0)]
        nbytes, _ = launch_bound("dlf_edges", (ptrs, None, len(jobs), *jobs[0][0].shape))
        on = sum(int((fv > 0).sum().item() + (fh > 0).sum().item()) for _p, fv, fh, _a, _b in jobs)
        F, H, W = jobs[0][0].shape
        record("dlf_edges", [len(jobs), F, H, W, label, *tag], err,
               timed_ms(lambda: dlf_torch.deblock(jobs, bd), 20),
               timed_ms(lambda: dlf_torch.deblock_plain(jobs, bd), 2),
               nbytes=nbytes, ops=on * 4 * 150, main=main, launches=1,
               changed_samples=sum(int((a != jb[0]).sum().item()) for a, jb in zip(got, jobs)),
               **timed, **extra)
        return got

    y = t(plane)
    fy = maps(sm, 0)
    case("luma, 3 levels", [(y, *fy, lims(lv), lims(lv)) for lv in LF_LADDER], main=bd == 8)
    # U and V: the planes at half size, V's maps from another size map
    sm_v = np.ascontiguousarray(np.repeat(np.repeat(sm[:, ::2, ::2], 2, 1), 2, 2)[:, :R8, :C8])
    u = t(plane[:, ::2, ::2])
    v = t(plane[:, 1::2, 1::2])
    case("U and V", [(u, *maps(sm, 1), lims(18), lims(18)), (v, *maps(sm_v, 2), lims(12), lims(12))])
    hi = (1 << bd) - 1
    for label, smap, pl, levels in (
            ("all 64x64, 14-tap edges on the tile borders", np.full_like(sm, 64), plane, LF_LADDER),
            ("all 8x8", np.full_like(sm, 8), plane, LF_LADDER),
            ("flat 64x64 blocks (flat2)", np.full_like(sm, 64),
             np.repeat(np.repeat(100 + 10 * g.integers(0, 2, (1, R8 // 8 + 1, C8 // 8 + 1)), 64,
                                 1), 64, 2)[:, :1080, :1920] << (bd - 8), (40, 63)),
            ("uniform noise", sm, g.integers(0, hi + 1, plane.shape), (63,))):
        x = t(pl)
        fm = maps(smap, 0)
        jobs = [(x, *fm, lims(lv), lims(lv)) for lv in levels]
        extra = {}
        if "flat2" in label:  # the vertical pass alone changes offsets -6 and 5 of the edges
            one = dlf_torch.deblock([(x, fm[0], fm[1], lims(levels[0]), None)], bd)[0]
            cols = np.arange(64, 1920, 64)
            extra["flat2_samples"] = int((one[:, :, cols - 6] != x[:, :, cols - 6]).sum().item()
                                         + (one[:, :, cols + 5] != x[:, :, cols + 5]).sum().item())
            if not extra["flat2_samples"]:
                raise SystemExit("dlf_edges: the flat planes did not fire flat2")
        case(label, jobs, **extra)


def check_cdef_dir(torch, t, record, assert_equal, y, bd):
    """K6 cdef_dir at bd (coeff_shift bd - 8) against find_dir_plain, every
    cell exact: the clip's 1080p luma `y` ((1, 1080, 1920) int32), a 1080p
    plane of extreme cells (`testclip.cdef_extreme_plane`: flat, checkered,
    striped and stepped cells of 0 and 2^bd - 1), both as one batch of
    F = 2, and the luma at a data pointer 4 bytes off 16-byte alignment (the
    kernel's scalar loads). Each case timed (`ms` one call, `device_ms` a
    CUDA graph of 20 launches, which finds the plane in L2) and, with
    --baseline-lib, the parent's K6 on the same inputs, held equal; the
    luma also with the plane read cold (`cold_device_ms`: the graph's
    launches take 8 copies in turn, 66 MB, more than L2 holds) and beside a
    launch on one cell (`one_cell_device_ms`: the fixed cost of a launch in
    a graph). Returns the luma's (dirs, var)."""
    from svtav1_tpu_torch.filters import cdef_torch
    from svtav1_tpu_torch.utils.testclip import cdef_extreme_plane

    cs, tag = bd - 8, [] if bd == 8 else ["10-bit"]
    _, H, W = y.shape
    extremes = t(cdef_extreme_plane(1, H, W, bd, seed=bd))
    spare = torch.empty(y.numel() + 4, dtype=torch.int32, device=y.device)
    unaligned = spare[1 : 1 + y.numel()].view_as(y)
    unaligned.copy_(y)
    if unaligned.data_ptr() % 16 != 4:
        raise SystemExit(f"cdef_dir: the unaligned case's pointer is {unaligned.data_ptr() % 16} "
                         "bytes off 16-byte alignment, not 4")
    luma = None
    for label, plane in (("clip luma", y), ("extreme cells", extremes),
                         ("clip luma and extreme cells, F = 2", torch.cat([y, extremes])),
                         ("clip luma, pointer 4 bytes off 16-byte alignment", unaligned)):
        got, want = cdef_torch.find_dir(plane, cs), cdef_torch.find_dir_plain(plane, cs)
        err = max(assert_equal("cdef_dir", a, b) for a, b in zip(got, want))
        if label == "extreme cells" and len(torch.unique(got[0])) != 8:
            raise SystemExit("cdef_dir: the extreme cells do not reach every direction")

        def same(o, want=want):
            for a, b in zip(o, want):
                assert_equal("cdef_dir (baseline)", a, b)

        F, R, C = got[0].shape
        extra = kernel_times(lambda: cdef_torch.find_dir(plane, cs), same, 20)
        if luma is None:  # the first case is the clip's luma
            luma = got
            copies, turn = [y.clone() for _ in range(8)], itertools.count()
            cell = y[:, :8, :8].contiguous()

            def cold():
                return cdef_torch.find_dir(copies[next(turn) % 8], cs)

            extra.update(cold_device_ms=device_ms(cold),
                         one_cell_device_ms=device_ms(lambda: cdef_torch.find_dir(cell, cs)))
            if BASELINE:
                with baseline_kernels():
                    extra.update(baseline_cold_device_ms=device_ms(cold))
        record("cdef_dir", [F, R, C, label] + tag, err,
               timed_ms(lambda: cdef_torch.find_dir(plane, cs), 20),
               timed_ms(lambda: cdef_torch.find_dir_plain(plane, cs), 3),
               nbytes=plane.numel() * 4 + 2 * F * R * C * 4, ops=F * R * C * (64 * 8 + 15 * 8 * 3),
               main=bd == 8 and plane is y, **extra)
    return luma


def check_cdef(torch, g, t, record, assert_equal, yp, up, vp, dirs, var):
    """Phase 2 for K7 on the clip's 1080p planes with noise (the filter's
    input) and two non-skip maps: 80% of the cells (a key frame) and 20%
    (a P frame of the main path): the 7-candidate search (per-candidate
    SSE) and the three-plane apply against their plain versions, both
    timed (ms, device_ms) and bound by what these inputs need (the unmasked
    cells only). With --baseline-lib, the parent's K7 (the same entry
    points) on the same inputs must give the same sums and planes
    (`baseline_ms`, `baseline_device_ms`)."""
    from svtav1_tpu_torch.filters import cdef_torch
    from svtav1_tpu_torch.filters.cdef import SEARCH_CANDIDATES
    from svtav1_tpu_torch.utils.profile_keyframes import cdef_apply_work, cdef_search_work

    ladder = SEARCH_CANDIDATES
    K, (F, H, W) = len(ladder), yp.shape
    planes = [(p + t(g.integers(-3, 4, p.shape))).clamp(0, 255).to(torch.int32).contiguous()
              for p in (yp, up, vp)]
    for frac, label, main in ((0.8, "80% of the cells", True), (0.2, "20% of the cells", False)):
        mask = t(g.random((F, H // 8, W // 8)) < frac, torch.bool)
        on = int(mask.sum().item())
        search = (planes[0], dirs, var, mask, yp, ladder, 6)
        sse = cdef_torch.cdef_search(*search)
        err = assert_equal("cdef_search", sse, cdef_torch.cdef_search_plain(*search))
        extra = kernel_times(lambda: cdef_torch.cdef_search(*search),
                             lambda o: assert_equal("cdef_search (baseline)", o, sse), 20)
        apply = (planes, dirs, var, mask, sse, ladder, 6)
        out, st = cdef_torch.cdef_apply(*apply)
        want, want_st = cdef_torch.cdef_apply_plain(*apply)
        err_a = max([assert_equal("cdef_apply", st, want_st)]
                    + [assert_equal("cdef_apply", a, b) for a, b in zip(out, want)])

        def same_apply(o):
            assert_equal("cdef_apply (baseline)", o[1], st)
            for a, b in zip(o[0], out):
                assert_equal("cdef_apply (baseline)", a, b)

        extra_a = kernel_times(lambda: cdef_torch.cdef_apply(*apply), same_apply, 20)
        record("cdef_search", [K, F, H, W, "luma search (SSE), " + label], err,
               timed_ms(lambda: cdef_torch.cdef_search(*search), 20),
               timed_ms(lambda: cdef_torch.cdef_search_plain(*search), 3),
               *cdef_search_work(F, H, W, K, on), main=main, cells_on=on, **extra)
        record("cdef_apply", [F, H, W, "Y, U and V, " + label], err_a,
               timed_ms(lambda: cdef_torch.cdef_apply(*apply), 20),
               timed_ms(lambda: cdef_torch.cdef_apply_plain(*apply), 3),
               *cdef_apply_work(F, H, W, K, on), main=main, cells_on=on, **extra_a)


def check_motion(torch, dev, g, t, record, assert_equal):
    """Phase 2 for K8 me_sad, K9 subpel_pred and K10 mc_lanes at the shapes
    of a 1080p P frame: the decide's uint8 1080x1920 planes on its 17 x 30
    SB grid (510 SBs, read as if padded to 1088 rows), the subpel grids of
    8/16/32/64 blocks, the commit's 32,400 8x8 luma and 4x4 chroma lanes
    from a 2-reference stack. All exact."""
    import numpy as np

    from svtav1_tpu_torch.ops import me_torch

    (y0, u0, v0), (y1, _u1, _v1) = clip_1080p(2)
    sbr, sbc = 17, 30
    RATES.update(packed_rates(torch))
    log(json.dumps(dict(phase="packed_rates", lane_instructions_per_s=RATES)))
    ref8, src8 = t(y0, torch.uint8), t(y1, torch.uint8)
    mvs = check_me_frame(torch, record, assert_equal, src8, ref8, sbr, sbc, 0, main=True)
    g.integers(-3, 4, (sbr * sbc, 2))  # the draw of earlier runs: later cases keep their inputs

    # ---- K9 subpel_pred: every size of the 1080p grid (25-point lattice),
    # and the 49-point lattice at n = 8; the prediction equals K10's MC
    ref_y = ref8
    src_y = t(y1)
    for n, fast, main in ((8, True, True), (16, True, False), (32, True, False),
                          (64, True, False), (8, False, False)):
        R, C = 1080 // n, 1920 // n
        B = R * C
        ys = torch.arange(R, device=dev, dtype=torch.int32).repeat_interleave(C) * n
        xs = torch.arange(C, device=dev, dtype=torch.int32).repeat(R) * n
        fp = mvs[n][:R, :C].reshape(B, 2).contiguous()
        srcb = src_y[: R * n, : C * n].reshape(R, n, C, n).permute(0, 2, 1, 3) \
            .reshape(B, n, n).contiguous()
        args = (srcb, ref_y, ys, xs, fp, 0, 8, fast)
        mk, pk = me_torch.subpel_pred_lanes(*args)
        mp, pp = me_torch.subpel_pred_plain(*args)
        err = max(assert_equal("subpel_pred", mk, mp), assert_equal("subpel_pred", pk, pp))
        assert_equal("subpel_pred", pk, me_torch.mc_lanes(ref_y, ys, xs, mk[:, 0] * 2,
                                                          mk[:, 1] * 2, n, n, 0, 8))
        L = 5 if fast else 7
        record("subpel_pred", [B, n, n, f"{L * L} points"], err,
               timed_ms(lambda: me_torch.subpel_pred_lanes(*args), 20),
               timed_ms(lambda: me_torch.subpel_pred_plain(*args), 3),
               nbytes=B * n * n * (4 + 1 + 4) + 16 * B,
               ops=B * (L * (n + 8) * n * 16 + L * L * n * n * 19), main=main,
               packed_ops_ms=k9_packed_ops_ms(B, n, L),
               **kernel_times(lambda: me_torch.subpel_pred_lanes(*args),
                              k9_same(assert_equal, mk, pk), 20))

    # ---- K10 mc_lanes: the commit's 32,400 luma 8x8 lanes and U+V 4x4 lanes
    # from 2-reference stacks, MVs reaching past every edge; the decide's
    # chroma sizes, three planes, the GLOBALMV lanes
    stacks = [t(np.stack(pair), torch.uint8) for pair in ((y0, y1), (u0, _u1), (v0, _v1))]
    draws = [[t(g.integers(*span, R * C)) for span in ((-24 * 16, 24 * 16),) * 2 + ((0, 2),)]
             for R, C in ((135, 240), (135, 240))]  # the luma and the chroma lanes' MVs, refs
    check_mc(torch, dev, t, record, assert_equal, stacks, draws, 8)


def k10_packed_ops_ms(P, B, nh, nw, bd=8):
    """K10's operations' least time at the measured packed rates: per plane
    and lane, two IDP.4A (10 bits: four IDP.2A) per horizontal intermediate
    sample of its n_h + 7 rows, and four IDP.2A per output sample."""
    horizontal = (2 / RATES["idp4a"]) if bd == 8 else (4 / RATES["idp2a"])
    return P * B * ((nh + 7) * nw * horizontal + 4 * nh * nw / RATES["idp2a"]) * 1e3


def k11_packed_ops_ms(P, B, nh, nw, bd=8):
    """K11's operations' least time at the measured packed rates: two K10
    passes (k10_packed_ops_ms) and the blend's 6 int32 operations a sample."""
    return (2 * k10_packed_ops_ms(P, B, nh, nw, bd)
            + P * B * nh * nw * 6 / INT32_OPS_PER_S * 1e3)


def check_compound(torch, dev, g, t, record, assert_equal, clip, bd):
    """Phase 2 for K11 (`mc_compound`; `mc_compound16` on the int16 planes
    at bd=10) at every size of the commit's compound lanes over a 1080p
    frame: 8x8 to 64x64 luma lanes and their U and V lanes (4x4 to 32x32)
    in one launch of the planes form, from 3-reference stacks of the clip
    with MVs past every edge and random ref indices. Each exact against its
    plain version; timed (`device_ms`, a CUDA graph; with --baseline-lib the
    parent's kernel on the same inputs, a launch per plane); its bound with
    the operations at the measured packed rates (k11_packed_ops_ms; the
    int32 count as int32_bound_ms)."""
    import numpy as np

    from svtav1_tpu_torch.ops import me_torch
    from svtav1_tpu_torch.utils.profile_keyframes import launch_bound

    name, tag = ("mc_compound", []) if bd == 8 else ("mc_compound16", ["10-bit"])
    dt = me_torch.plane_dtype(bd)
    for n in (8, 16, 32, 64):
        for pl, (nb, plane_h, plane_w) in enumerate(((n, 1080, 1920), (n // 2, 540, 960))):
            stacks = [t(np.stack([clip[i][p] for i in (1, 0, 3)]).astype(np.int32), dt)
                      for p in ((0,) if pl == 0 else (1, 2))]
            R, C = plane_h // nb, plane_w // nb
            B = R * C
            ys = torch.arange(R, device=dev, dtype=torch.int32).repeat_interleave(C) * nb
            xs = torch.arange(C, device=dev, dtype=torch.int32).repeat(R) * nb
            mv = [t(g.integers(-24 * 16, 24 * 16, B)) for _ in range(4)]
            r0, r1 = t(g.integers(0, 3, B)), t(g.integers(0, 3, B))
            args = (stacks, ys, xs, *mv, nb, nb, 0, bd, r0, r1)

            def call(args=args):
                return me_torch.mc_lanes_compound_planes(*args)

            got = call()
            err = assert_equal(name, got, me_torch.mc_compound_planes_plain(*args))
            P = len(stacks)
            c_args = [None] * 23
            c_args[14], c_args[15], c_args[19], c_args[20] = P, B, nb, nb
            nbytes, ops = launch_bound(name, c_args)
            reps = 20 if n == 8 else 5
            record(name, [P, B, nb, nb, "luma" if pl == 0 else "U and V", "3 refs", *tag], err,
                   timed_ms(call, reps),
                   timed_ms(lambda: me_torch.mc_compound_planes_plain(*args), 3 if n == 8 else 2),
                   nbytes=nbytes, ops=ops, main=n == 8 and pl == 0,
                   packed_ops_ms=k11_packed_ops_ms(P, B, nb, nb, bd), launches=1,
                   **kernel_times(call, lambda o: assert_equal(name + " (baseline)", o, got),
                                  reps))


GLOBALMV = {}  # the decide's GLOBALMV lanes: four K10 launches against one (check_mc)


def check_mc(torch, dev, t, record, assert_equal, stacks, draws, bd):
    """Phase 2 for K10 at bd on the 1080p clip's 2-reference stacks
    (`stacks`: Y, U, V): the commit's 32,400 8x8 luma lanes (one plane) and
    4x4 chroma lanes on U and V (two planes; `draws`: each case's MVs in 1/16
    pel and ref indices), the decide's chroma lanes of its 16x16, 32x32 and
    64x64 blocks (8x8, 16x16, 32x32 on U and V at the winners' MVs), the 4x4
    lanes on three planes, and at 8 bits the decide's GLOBALMV lanes of the
    four sizes as four launches against one 8x8 launch whose blocks the
    sizes take (the view copies into the candidates' buffer counted in
    both). Each against the plain version, exactly; `device_ms` a CUDA
    graph of 20 launches; with --baseline-lib the parent's K10 on the same
    inputs (kernel_times)."""
    import numpy as np

    from svtav1_tpu_torch.ops import me_torch
    from svtav1_tpu_torch.pipeline import inter_device
    from svtav1_tpu_torch.utils.profile_keyframes import launch_bound

    name = "mc_lanes" if bd == 8 else "mc_lanes16"
    tag = [] if bd == 8 else ["10-bit"]
    g = np.random.default_rng(10 + bd)  # the cases the parent's run did not have

    def grid(R, C, n):
        return (torch.arange(R, device=dev, dtype=torch.int32).repeat_interleave(C) * n,
                torch.arange(C, device=dev, dtype=torch.int32).repeat(R) * n)

    def case(label, refs, n, mvy, mvx, ri, main=False):
        R, C = refs[0].shape[-2] // n, refs[0].shape[-1] // n
        B = R * C
        ys, xs = grid(R, C, n)
        args = (refs, ys, xs, mvy[:B], mvx[:B], n, n, 0, bd, ri[:B])
        got = me_torch.mc_lanes_planes(*args)
        err = assert_equal(name, got, me_torch.mc_lanes_planes_plain(*args))
        timed = kernel_times(lambda: me_torch.mc_lanes_planes(*args),
                             lambda o: assert_equal(name + " (baseline)", o, got), 20)
        P = len(refs)
        c_args = [None] * 20
        c_args[11], c_args[12], c_args[16], c_args[17] = P, B, n, n
        nbytes, ops = launch_bound(name, c_args)
        record(name, [P, B, n, n, label, "2 refs", *tag], err,
               timed_ms(lambda: me_torch.mc_lanes_planes(*args), 20),
               timed_ms(lambda: me_torch.mc_lanes_planes_plain(*args), 3), nbytes=nbytes,
               ops=ops, main=main, packed_ops_ms=k10_packed_ops_ms(P, B, n, n, bd), launches=1,
               **timed)

    case("commit luma", stacks[:1], 8, *draws[0], main=True)
    case("commit U and V", stacks[1:], 4, *draws[1])
    for nc in (8, 16, 32):  # the decide's chroma of its 16x16 to 64x64 blocks
        B = (540 // nc) * (960 // nc)
        mv = [t(g.integers(-24 * 16, 24 * 16, B)) for _ in range(2)]
        case("decide U and V", stacks[1:], nc, *mv, t(g.integers(0, 2, B)))
    third = stacks[1].flip(0).contiguous()
    case("three planes", [*stacks[1:], third], 4, *draws[1])
    if bd != 8:
        return

    # the decide's GLOBALMV lanes: K10 per size (n = 8 .. 64 over the frame,
    # the global MV on reference 0), or globalmv_lanes8's one launch
    gm8 = t(np.array([-13, 22]))
    layout = [(n, 1080 // n, 1920 // n) for n in (8, 16, 32, 64)]
    bufs = {n: torch.empty((R * C, 3, n, n), dtype=torch.int32, device=dev) for n, R, C in layout}
    lanes = {n: (*grid(R, C, n), (gm8 * 2).expand(R * C, 2).contiguous(),
                 torch.zeros(R * C, dtype=torch.int32, device=dev)) for n, R, C in layout}

    def four():
        for n, R, C in layout:
            ys, xs, mv, zero = lanes[n]
            bufs[n][:, 2].copy_(me_torch.mc_lanes(stacks[0], ys, xs, mv[:, 0], mv[:, 1], n, n, 0,
                                                  8, ref_idx=zero))

    def one():
        g8 = inter_device.globalmv_lanes8(stacks[0], gm8, 135, 240, 0, 8)
        for n, R, C in layout:
            bufs[n][:, 2].view(R, C, n // 8, 8, n // 8, 8).copy_(
                inter_device._lanes8_blocks(g8, n, R, C))

    four()
    want = {n: b[:, 2].clone() for n, b in bufs.items()}
    one()
    err = max(assert_equal("mc_lanes (GLOBALMV)", bufs[n][:, 2], want[n]) for n in want)
    GLOBALMV.update(four_launches_device_ms=device_ms(four), one_launch_device_ms=device_ms(one),
                    max_abs_err=err)
    GLOBALMV["one_launch_faster"] = GLOBALMV["one_launch_device_ms"] < GLOBALMV[
        "four_launches_device_ms"]
    log(json.dumps(dict(check="mc_lanes GLOBALMV", **GLOBALMV)))


def check_random_access(torch, dev, g, t, record, assert_equal):
    """Phase 2 for K11 mc_compound (check_compound), K12 tf_filter, K13
    tf_noise (check_mctf) and K9 at the MCTF shape: one MCTF call at 1080p
    (1088x1920 luma, 544x960 chroma, K = 5 neighbours; the 49-point subpel
    search of the 16x16 blocks). All exact."""
    from svtav1_tpu_torch.ops import me_torch

    clip = clip_1080p(6)
    check_compound(torch, dev, g, t, record, assert_equal, clip, 8)

    # ---- one MCTF call: centre frame 2, neighbours 0, 1, 3, 4, 5
    H, W = 1088, 1920
    planes = [[me_torch.edge_pad(t(f[pl], torch.uint8), H >> (pl > 0), W >> (pl > 0))
               for pl in range(3)] for f in clip]
    check_mctf(torch, record, assert_equal, planes, 8)
    cy = planes[2][0].to(torch.int32).contiguous()
    # K9 at the MCTF shape: 16x16 blocks, 49-point lattice, from the
    # full-pel MVs of the ME against neighbour 3
    R, C = H // 16, W // 16
    B = R * C
    ref_y = planes[3][0]
    fp = me_torch.me_fullpel_frame(planes[2][0], ref_y, H // 64, W // 64)[0][16]
    fp = fp.reshape(B, 2).contiguous()
    ys = torch.arange(R, device=dev, dtype=torch.int32).repeat_interleave(C) * 16
    xs = torch.arange(C, device=dev, dtype=torch.int32).repeat(R) * 16
    srcb = cy.reshape(R, 16, C, 16).permute(0, 2, 1, 3).reshape(B, 16, 16).contiguous()
    args = (srcb, ref_y, ys, xs, fp, 0, 8, False)
    mk, pk = me_torch.subpel_pred_lanes(*args)
    mp, pp = me_torch.subpel_pred_plain(*args)
    err = max(assert_equal("subpel_pred", mk, mp), assert_equal("subpel_pred", pk, pp))
    record("subpel_pred", [B, 16, 16, "49 points", "MCTF"], err,
           timed_ms(lambda: me_torch.subpel_pred_lanes(*args), 20),
           timed_ms(lambda: me_torch.subpel_pred_plain(*args), 3),
           nbytes=B * 16 * 16 * 9 + 16 * B, ops=B * (7 * 24 * 16 * 16 + 49 * 16 * 16 * 19),
           packed_ops_ms=k9_packed_ops_ms(B, 16, 7),
           **kernel_times(lambda: me_torch.subpel_pred_lanes(*args),
                          k9_same(assert_equal, mk, pk), 20))


def k12_weight_shares(torch, center, preds_y, preds_uv, h2):
    """Where K12's weights of one call come from, as shares of every sample
    and neighbour: `zero`, window sums s at or past the cut where the
    weight rounds to 0; `table`, s below min(TF_TABLE, cut); `computed`,
    the rest (the expression per sample). Plain tensor ops on the card."""
    from svtav1_tpu_torch.ops import tf_torch

    H, W = center[0].shape
    R, C = H // 16, W // 16
    stacks = ([tf_torch._blocks_to_plane(p, R, C, 16) for p in preds_y],
              [tf_torch._blocks_to_plane(p[0], R, C, 8) for p in preds_uv],
              [tf_torch._blocks_to_plane(p[1], R, C, 8) for p in preds_uv])
    total = zero = table = 0
    for c, preds in zip(center, stacks):
        c = c.to(torch.int32)
        for p in preds:
            s = tf_torch._box5_sum((p - c) * (p - c))
            d = s.to(torch.float32) / torch.full_like(s, 25, dtype=torch.float32)
            z = -d / torch.full_like(d, float(h2)) <= -104.0
            total += s.numel()
            zero += int(z.sum().item())
            table += int(((s < tf_torch.TF_TABLE) & ~z).sum().item())
    return dict(zero=zero / total, table=table / total, computed=(total - zero - table) / total)


def check_mctf(torch, record, assert_equal, planes, bd):
    """K13 and K12 on one MCTF call of the clip (centre frame 2, neighbours
    0, 1, 3, 4, 5; uint8 planes at 8 bits, int16 at 10: `tf_noise16`,
    `tf_filter16`), each exact against its plain version on the card: K13's
    sums, and its decay h2 also against the host's float32; K12's one
    three-plane launch on the filter's own block-layout predictions, and
    `filter_planes` run again under torch.cuda.set_sync_debug_mode("error")
    (no host synchronisation from K13 to K12) with the same planes. Device
    time and, with --baseline-lib, the parent's K12 and K13 on the same
    inputs, held equal (kernel_times); the bound with the plane dtype (the
    int32 count as `int32_bytes_bound_ms`), where K12's weights came from
    (k12_weight_shares); K12 also with a table of 256 entries, its weights
    computed per sample (`per_sample_weights_device_ms`)."""
    import ctypes

    import numpy as np

    from svtav1_tpu_torch import kernels
    from svtav1_tpu_torch.ops import tf_torch

    sz, tag = (1, []) if bd == 8 else (2, ["10-bit"])
    noise, filt = ("tf_noise", "tf_filter") if bd == 8 else ("tf_noise16", "tf_filter16")
    center, neighbours = planes[2], [planes[i] for i in (0, 1, 3, 4, 5)]
    y = center[0]
    H, W = y.shape

    # ---- K13: the sums, and the decay at qindex 120
    a, b = tf_torch.noise_sums(y, bd), tf_torch.noise_sums_plain(y, bd)
    err = max(assert_equal(noise, a[0], b[0]), assert_equal(noise, a[1], b[1]))
    h2 = tf_torch.noise_decay(y, 120, bd)
    err = max(err, assert_equal(noise + " (h2)", h2, tf_torch.noise_decay_plain(y, 120, bd)))
    host = tf_torch.tf_decay(max(tf_torch.estimate_noise(y, bd), np.float32(0.5 * (1 << (bd - 8)))),
                             np.float32(tf_torch.tf_strength(120, bd)))
    if np.float32(h2.item()) != host:
        raise SystemExit(f"{noise}: h2 {h2.item()} on the card, {host} on the host")

    def same_noise(got):  # the sums and h2 of noise_decay's launch
        for o, w in zip((got[0][0], got[0][1], got[1]), (b[0], b[1], h2)):
            assert_equal(noise + " (baseline)", o, w)

    extra = kernel_times(lambda: tf_torch._noise(y, bd, 120), same_noise, 20)
    record(noise, [H, W, "sums and h2"] + tag, err,
           timed_ms(lambda: tf_torch.noise_decay(y, 120, bd), 20),
           timed_ms(lambda: tf_torch.noise_decay_plain(y, 120, bd), 5),
           nbytes=H * W * sz + 20, ops=H * W * 20, main=True, flat_samples=int(a[1].item()),
           h2=h2.item(), int32_bytes_bound_ms=bound(H * W * 4 + 16, H * W * 20)[0], **extra)

    # ---- K12 on the compensated neighbours of the whole filter (K8-K10 on the card)
    captured = []
    real = tf_torch.tf_filter_planes
    tf_torch.tf_filter_planes = lambda c, py, puv, h, bd=8: captured.append((c, py, puv, h)) or \
        real(c, py, puv, h, bd)
    try:
        out = tf_torch.filter_planes(center, neighbours, 120, bd)
    finally:
        tf_torch.tf_filter_planes = real
    (c, py, puv, h2c), = captured
    assert_equal(noise + " (h2 of filter_planes)", h2c, h2)
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = tf_torch.filter_planes(center, neighbours, 120, bd)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = tf_torch.tf_filter_planes_plain(c, py, puv, h2c, bd)
    differing = sum(int((o != w).sum().item()) for o, w in zip(out, want))
    changed = sum(int((o != p.to(torch.int32)).sum().item()) for o, p in zip(out, c))
    err = max(assert_equal(filt, o, w) for o, w in zip(out, want))
    for o, w in zip(again, out):
        assert_equal(filt + " (filter_planes under the sync check)", o, w)
    K, samples = len(py), H * W * 3 // 2

    def k12():
        return tf_torch.tf_filter_planes(c, py, puv, h2c, bd)

    def same_planes(got):
        for o, w in zip(got, want):
            assert_equal(filt + " (baseline)", o, w)

    extra = kernel_times(k12, same_planes, 20)
    # the same launch with a table of 256 entries, the least it takes: nearly every weight
    # computed per sample (the FP64 exp and the two divisions), exact all the same
    work = tf_torch._scratch(str(y.device))
    ptrs = [p.data_ptr() for p in py] + [p.data_ptr() for p in puv]
    ptr_arr = (ctypes.c_longlong * len(ptrs))(*ptrs)
    per_sample = torch.empty(samples, dtype=torch.int32, device=y.device)

    def k12_per_sample():
        kernels.launch(filt, *(p.data_ptr() for p in c), ptr_arr, per_sample.data_ptr(),
                       h2c.data_ptr(), work["table"].data_ptr(), work["filter"].data_ptr(), K,
                       H // 16, W // 16, bd, 256, torch.cuda.current_stream().cuda_stream)

    k12_per_sample()
    n = H * W
    for o, w in zip((per_sample[:n], per_sample[n : n + n // 4], per_sample[n + n // 4 :]), want):
        assert_equal(filt + " (weights per sample)", o.view_as(w), w)
    extra.update(per_sample_weights_device_ms=device_ms(k12_per_sample))
    record(filt, [K, H, W, "Y+U+V"] + tag, err, timed_ms(k12, 20),
           timed_ms(lambda: tf_torch.tf_filter_planes_plain(c, py, puv, h2c, bd), 3),
           nbytes=samples * (sz + 4 * K + 4) + 4, ops=K * samples * 20, main=True,
           differing_samples=differing, changed_samples=changed,
           int32_bytes_bound_ms=bound((K + 2) * samples * 4, K * samples * 20)[0],
           weight_shares=k12_weight_shares(torch, c, py, puv, h2c), **extra)


def check_tpl(torch, dev, g, t, record, assert_equal):
    """Phase 2 for K14 subpel_refine and K15 tpl_cost at the TPL shapes of a
    1080p frame (1088x1920, 8,160 16x16 blocks), at 8 bits and on the 10-bit
    clip's int16 planes (K14's 16-bit form `subpel_refine16`, K15 at
    bd=10): K14 from the full-pel MVs of the frame's 16x16 ME and from MVs
    spread to +-64 px, so that windows cross every edge; K15 mode 0 on the
    intra probe's 5 x 8,160 lanes (the five lanes of a block share its
    source) and on 8,160 lanes (a reference's inter cost), and mode 1 with
    the recon on 8,160 lanes, at qindex 120 and 255. All exact. K14 and K15
    also by device time (a CUDA graph) and through --baseline-lib, at both
    depths; K14's bound at the measured packed rates, as K9's
    (k14_packed_ops_ms)."""
    import numpy as np

    from svtav1_tpu_torch.ops import me_torch
    from svtav1_tpu_torch.ops import quantize as quant_ops
    from svtav1_tpu_torch.ops import transforms_torch as TT
    from svtav1_tpu_torch.utils.profile_keyframes import tpl_cost_ops

    H, W, n = 1088, 1920, 16
    R, C = H // n, W // n
    B = R * C
    ys = torch.arange(R, device=dev, dtype=torch.int32).repeat_interleave(C) * n
    xs = torch.arange(C, device=dev, dtype=torch.int32).repeat(R) * n
    for bd in (8, 10):
        (y0, _u0, _v0), (y1, _u1, _v1) = clip_1080p(2, bd)
        dt, maxv = me_torch.plane_dtype(bd), (1 << bd) - 1
        k14, tag = ("subpel_refine", []) if bd == 8 else ("subpel_refine16", ["10-bit"])
        ref = me_torch.edge_pad(t(np.asarray(y0, np.int32), dt), H, W)
        src_p = me_torch.edge_pad(t(np.asarray(y1, np.int32), dt), H, W)
        src = src_p.to(torch.int32)
        srcb = src.reshape(R, n, C, n).permute(0, 2, 1, 3).reshape(B, n, n).contiguous()
        fp_me = me_torch.me_fullpel_frame(src_p, ref, H // 64, W // 64, bd=bd)[0][16] \
            .reshape(B, 2).contiguous()
        for fp, label in ((fp_me, "ME MVs"), (t(g.integers(-64, 65, (B, 2))), "MVs +-64 px")):
            args = (srcb, ref, ys, xs, fp, 0, bd)
            mv = me_torch.subpel_refine_lanes(*args)
            err = assert_equal(k14, mv, me_torch.subpel_refine_plain(*args))
            main = label == "ME MVs"

            def call():
                return me_torch.subpel_refine_lanes(*args)

            extra = (kernel_times(call, lambda out: assert_equal(k14 + " (baseline)", out, mv), 20)
                     if main else {})
            record(k14, [B, n, n, "2 x 9 points", label, *tag], err, timed_ms(call, 20),
                   timed_ms(lambda: me_torch.subpel_refine_plain(*args), 3),
                   nbytes=H * W * ref.element_size() + B * n * n * 4 + B * 24,
                   ops=B * 2 * (3 * (n + 8) * n * 16 + 9 * n * n * 19), main=main,
                   packed_ops_ms=k14_packed_ops_ms(B, n, bd), **extra)
        noise5 = t(g.integers(-24, 25, (5 * B, n, n))) << (bd - 8)
        noise1 = t(g.integers(-64, 65, (B, n, n))) << (bd - 8)
        pred5 = (srcb.repeat_interleave(5, 0) + noise5).clamp(0, maxv).to(torch.int32) \
            .contiguous()
        pred1 = (srcb + noise1).clamp(0, maxv).to(torch.int32).contiguous()
        for q in (120, 255):
            dq = (quant_ops.dc_q(q, bd), quant_ops.ac_q(q, bd))
            for L, rep, pred in ((5 * B, 5, pred5), (B, 1, pred1)):  # the probe; per reference
                a0 = (srcb, pred, 0, dq[0], dq[1], bd, rep)
                satd = TT.tpl_cost(*a0)
                err = assert_equal("tpl_cost", satd, TT.tpl_cost_plain(*a0))
                record("tpl_cost", [L, n, n, "mode 0", f"rep {rep}", f"qindex {q}", *tag], err,
                       timed_ms(lambda: TT.tpl_cost(*a0), 20),
                       timed_ms(lambda: TT.tpl_cost_plain(*a0), 3),
                       nbytes=(L // rep + L) * n * n * 4 + 4 * L, ops=tpl_cost_ops(L, n, False),
                       main=q == 120 and bd == 8 and rep == 5,
                       **kernel_times(lambda: TT.tpl_cost(*a0),
                                      lambda o: assert_equal("tpl_cost (baseline)", o, satd), 20))
            a1 = (srcb, pred1, 1, dq[0], dq[1], bd, 1, True)
            ek, rk = TT.tpl_cost(*a1)
            ep, rp = TT.tpl_cost_plain(*a1)
            err = max(assert_equal("tpl_cost", ek, ep), assert_equal("tpl_cost", rk, rp))

            def same1(o):
                assert_equal("tpl_cost (baseline)", o[0], ek)
                assert_equal("tpl_cost (baseline)", o[1], rk)

            record("tpl_cost", [B, n, n, "mode 1", "recon", f"qindex {q}", *tag], err,
                   timed_ms(lambda: TT.tpl_cost(*a1), 20),
                   timed_ms(lambda: TT.tpl_cost_plain(*a1), 3),
                   nbytes=3 * B * n * n * 4 + 8 * B, ops=tpl_cost_ops(B, n, True),
                   lanes_err_at_or_above_2_24=int((ek >= 1 << 24).sum().item()),
                   largest_err=int(ek.max().item()),
                   **kernel_times(lambda: TT.tpl_cost(*a1), same1, 20))


def check_tiles(torch, dev, g, t, record, assert_equal):
    """Phase 2 for K8 with a reference wider than the source: the second
    tile of the 1920x1024 mesh GOP, a 1024x960 source against its
    1024x1216 halo-cropped reference (ref_off_x=128): the pyramid, the frame
    search and the whole full-pel search, exact."""
    import numpy as np

    from svtav1_tpu_torch.parallel.tiles import HALO

    (y0, _u0, _v0), (y1, _u1, _v1) = clip_1080p(2)
    H, W, x0 = 1024, 960, 960
    cols = (np.arange(-HALO, W + HALO) + x0).clip(0, 1919)
    ref = t(y0[:H][:, cols], torch.uint8)
    src = t(y1[:H, x0 : x0 + W], torch.uint8)
    check_me_frame(torch, record, assert_equal, src, ref, H // 64, W // 64, HALO)


def check_10bit(torch, dev, g, t, record, assert_equal):
    """Phase 2 at 10 bits, on the 10-bit clip (the 8-bit clip << 2 plus
    seeded low bits, int16 planes as the encoder keeps them) at the shapes
    of the 8-bit rows: the 16-bit forms of K8 (the decide's 1080x1920 planes,
    510 SBs), K9 (every size, both lattices, and the MCTF shape), K10 (the
    commit's 8x8 luma and 4x4 chroma lanes, 2 references) and K11
    (check_compound); K1-K7, K12 and K13 once at bd=10 (K1 with
    lanes that have neither neighbour: DC is 512), each against its plain
    version, exactly. K16 runs at 10 bits in commit_wave ("P10")."""
    import numpy as np

    from svtav1_tpu_torch.codec import rate_torch
    from svtav1_tpu_torch.constants.av1 import TxSize, TxType
    from svtav1_tpu_torch.constants.cdf import get_q_ctx
    from svtav1_tpu_torch.filters import cdef_torch, dlf_torch
    from svtav1_tpu_torch.filters.cdef import SEARCH_CANDIDATES
    from svtav1_tpu_torch.ops import me_torch, tf_torch
    from svtav1_tpu_torch.ops import quantize as quant_ops
    from svtav1_tpu_torch.ops import transforms_torch as TT
    from svtav1_tpu_torch.pipeline import intra_device
    from svtav1_tpu_torch.pipeline.device_decide import fc_for_qctx
    from svtav1_tpu_torch.pipeline.intra_md import rd_lambda
    from svtav1_tpu_torch.utils.profile_keyframes import (cdef_apply_work, cdef_search_work,
                                                          k2_ops, launch_bound)

    clip = clip_1080p(6, bd=10)
    (y0, u0, v0), (y1, u1, _v1) = clip[:2]
    i16 = torch.int16

    def t16(a):  # the clip's uint16 samples as an int16 card plane
        return t(np.asarray(a, np.int32), i16)

    sbr, sbc = 17, 30
    ref_y, src16 = t16(y0), t16(y1)
    mvs = check_me_frame(torch, record, assert_equal, src16, ref_y, sbr, sbc, 0, main=True,
                         bd=10)

    def grid(R, C, n):
        return (torch.arange(R, device=dev, dtype=torch.int32).repeat_interleave(C) * n,
                torch.arange(C, device=dev, dtype=torch.int32).repeat(R) * n)

    def bound_of(name, fn):
        """The bound of the launches fn makes (profile_keyframes.launch_bound
        of their C arguments)."""
        from svtav1_tpu_torch import kernels

        seen, real = [], kernels.launch
        kernels.launch = lambda nm, *a: seen.append((nm, a)) or real(nm, *a)
        try:
            fn()
        finally:
            kernels.launch = real
        nbytes = sum(launch_bound(nm, a)[0] for nm, a in seen if nm == name)
        ops = sum(launch_bound(nm, a)[1] for nm, a in seen if nm == name)
        return nbytes, ops

    # ---- K9 subpel_pred16: every size (25 points), 8x8 on 49 points
    src_y = t(y1.astype(np.int32))
    for n, fast, main in ((8, True, True), (16, True, False), (32, True, False),
                          (64, True, False), (8, False, False)):
        R, C = 1080 // n, 1920 // n
        B = R * C
        ys, xs = grid(R, C, n)
        fp = mvs[n][:R, :C].reshape(B, 2).contiguous()
        srcb = src_y[: R * n, : C * n].reshape(R, n, C, n).permute(0, 2, 1, 3) \
            .reshape(B, n, n).contiguous()
        args = (srcb, ref_y, ys, xs, fp, 0, 10, fast)
        mk, pk = me_torch.subpel_pred_lanes(*args)
        mp, pp = me_torch.subpel_pred_plain(*args)
        err = max(assert_equal("subpel_pred16", mk, mp), assert_equal("subpel_pred16", pk, pp))
        assert_equal("subpel_pred16", pk, me_torch.mc_lanes(ref_y, ys, xs, mk[:, 0] * 2,
                                                            mk[:, 1] * 2, n, n, 0, 10))
        L = 5 if fast else 7
        record("subpel_pred16", [B, n, n, f"{L * L} points", "10-bit"], err,
               timed_ms(lambda: me_torch.subpel_pred_lanes(*args), 20),
               timed_ms(lambda: me_torch.subpel_pred_plain(*args), 3),
               *bound_of("subpel_pred16", lambda: me_torch.subpel_pred_lanes(*args)), main=main,
               packed_ops_ms=k9_packed_ops_ms(B, n, L, 10),
               device_ms=device_ms(lambda: me_torch.subpel_pred_lanes(*args)))

    # ---- K10 mc_lanes16 (check_mc) and K11 mc_compound16 from int16 stacks, MVs
    # past every edge
    def lanes(n, plane_h, plane_w, nmv):
        R, C = plane_h // n, plane_w // n
        B = R * C
        ys, xs = grid(R, C, n)
        return B, ys, xs, [t(g.integers(-24 * 16, 24 * 16, B)) for _ in range(nmv)]

    stacks = [t16(np.stack([clip[0][pl], clip[1][pl]])) for pl in range(3)]
    draws = []
    for n, plane_h, plane_w in ((8, 1080, 1920), (4, 540, 960)):
        _B, _ys, _xs, mv = lanes(n, plane_h, plane_w, 2)
        draws.append([*mv, t(g.integers(0, 2, _B))])
    check_mc(torch, dev, t, record, assert_equal, stacks, draws, 10)
    check_compound(torch, dev, g, t, record, assert_equal, clip, 10)

    # ---- one MCTF call at 10 bits: K13 and K12 (check_mctf), K9 at the MCTF shape
    H, W = 1088, 1920
    planes = [[me_torch.edge_pad(t16(f[pl]), H >> (pl > 0), W >> (pl > 0)) for pl in range(3)]
              for f in clip]
    check_mctf(torch, record, assert_equal, planes, 10)
    cy = planes[2][0].to(torch.int32).contiguous()
    R, C = H // 16, W // 16
    B = R * C
    fp = me_torch.me_fullpel_frame(planes[2][0], planes[3][0], H // 64, W // 64, bd=10)[0][16]
    ys, xs = grid(R, C, 16)
    srcb = cy.reshape(R, 16, C, 16).permute(0, 2, 1, 3).reshape(B, 16, 16).contiguous()
    args = (srcb, planes[3][0], ys, xs, fp.reshape(B, 2).contiguous(), 0, 10, False)
    mk, pk = me_torch.subpel_pred_lanes(*args)
    mp, pp = me_torch.subpel_pred_plain(*args)
    err = max(assert_equal("subpel_pred16", mk, mp), assert_equal("subpel_pred16", pk, pp))
    record("subpel_pred16", [B, 16, 16, "49 points", "MCTF", "10-bit"], err,
           timed_ms(lambda: me_torch.subpel_pred_lanes(*args), 20),
           timed_ms(lambda: me_torch.subpel_pred_plain(*args), 3),
           *bound_of("subpel_pred16", lambda: me_torch.subpel_pred_lanes(*args)),
           packed_ops_ms=k9_packed_ops_ms(B, 16, 7, 10),
           device_ms=device_ms(lambda: me_torch.subpel_pred_lanes(*args)))

    # ---- K1 at 10 bits: the decide's 8x8 grid, all 13 modes; a tenth of
    # the lanes without a neighbour
    R8, C8 = 135, 240
    B = R8 * C8
    e = (t(g.integers(0, 1024, (B, 8))), t(g.integers(0, 1024, (B, 8))),
         t(g.integers(0, 1024, B)), t(g.random(B) < 0.7, torch.bool),
         t(g.random(B) < 0.7, torch.bool))
    k1 = intra_device.predict(*e, 8, bd=10)
    err = assert_equal("intra_pred", k1, intra_device.predict_plain(*e, 8, bd=10))
    none = ~(e[3] | e[4])
    assert_equal("intra_pred (DC, no neighbour)", k1[none, 0],
                 torch.full_like(k1[none, 0], 512))
    record("intra_pred", [B, 13, 8, 8, "10-bit"], err,
           timed_ms(lambda: intra_device.predict(*e, 8, bd=10), 20),
           timed_ms(lambda: intra_device.predict_plain(*e, 8, bd=10), 5),
           nbytes=B * (2 * 8 + 1) * 4 + 2 * B + B * 13 * 64 * 4, ops=B * 13 * 64 * 10,
           lanes_without_neighbour=int(none.sum().item()))

    # ---- K2, K3 and K5 at 10 bits: the clip's luma in 8x8 blocks against
    # their rounded means, both halves and the fused form, the levels' bits
    # and RDOQ
    q = 120
    dq = (quant_ops.dc_q(q, 10), quant_ops.ac_q(q, 10))
    b8 = y1.astype(np.int32).reshape(R8, 8, C8, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
    src = t(b8)
    pred = t(np.broadcast_to(b8.mean(axis=(1, 2), keepdims=True).round().astype(np.int32),
                             b8.shape))
    va, ha = t(g.random(B) < 0.5, torch.bool), t(g.random(B) < 0.5, torch.bool)
    args = (src, pred, va, ha, dq[0], dq[1], 10)
    kw = dict(want_recon=True, want_sse=True)
    out_k, out_p = TT.txfm_quant_recon(*args, **kw), TT.txfm_quant_recon_plain(*args, **kw)
    err = max(assert_equal("txfm_quant_recon", a, b) for a, b in zip(out_k, out_p)
              if a is not None)
    nva, nha = int(va.sum().item()), int(ha.sum().item())
    record("txfm_quant_recon", [B, 8, 8, 1, "sel", "recon", "sse", "10-bit"], err,
           timed_ms(lambda: TT.txfm_quant_recon(*args, **kw), 20),
           timed_ms(lambda: TT.txfm_quant_recon_plain(*args, **kw), 3),
           nbytes=3 * B * 64 * 4 + B * 64 * 4 + 8 * B + 2 * B, ops=k2_ops(8, B, nva, nha))
    lk, ck = TT.txfm_quant(*args)
    lp, cp = TT.txfm_quant_plain(*args)
    err = max(assert_equal("txfm_quant_recon", lk, lp), assert_equal("txfm_quant_recon", ck, cp))
    rp = TT.recon_from_levels_plain(lk, pred, va, ha, dq[0], dq[1], 10)
    err = max(err, assert_equal("txfm_quant_recon",
                                TT.recon_from_levels(lk, pred, va, ha, dq[0], dq[1], 10), rp))
    record("txfm_quant_recon", [B, 8, 8, "forward and inverse halves", "sel", "10-bit"], err,
           timed_ms(lambda: TT.txfm_quant(*args), 20),
           timed_ms(lambda: TT.txfm_quant_plain(*args), 3),
           nbytes=2 * B * 64 * 4 + 2 * B * 64 * 4 + 2 * B,
           ops=k2_ops(8, B, nva, nha, inverse=False))
    fc = fc_for_qctx(get_q_ctx(q))
    tabs = rate_torch.make_txb_bits_fn(fc, int(TxSize.TX_8X8), int(TxType.DCT_DCT), 0,
                                       device=dev)
    a, b = rate_torch.txb_bits(out_k[0], tabs), rate_torch.txb_bits_plain(out_k[0], tabs)
    err = k3_close("txb_rate", a, b)
    record("txb_rate", [B, 8, 8, "10-bit"], err,
           timed_ms(lambda: rate_torch.txb_bits(out_k[0], tabs), 20),
           timed_ms(lambda: rate_torch.txb_bits_plain(out_k[0], tabs), 3),
           nbytes=B * 64 * 4 + B * 4, ops=B * 64 * 30)
    lam = float(np.float32(rd_lambda(q, 10)))
    rt = rate_torch.make_rdoq_fn(fc, int(TxSize.TX_8X8), 0, txb_skip_ctx=0, device=dev)
    rargs = (lk, ck, dq[0], dq[1], lam, rt)
    a, b = rate_torch.rdoq(*rargs), rate_torch.rdoq_plain(*rargs)
    torch.cuda.synchronize()
    differing = int((a != b).reshape(B, -1).any(dim=1).sum().item())
    if differing:
        raise SystemExit(f"rdoq at 10 bits: {differing} of {B} lanes differ from the plain "
                         "version")
    record("rdoq", [B, 8, 8, "luma", "10-bit"], int((a - b).abs().max().item()),
           timed_ms(lambda: rate_torch.rdoq(*rargs), 20),
           timed_ms(lambda: rate_torch.rdoq_plain(*rargs), 3), nbytes=3 * B * 64 * 4,
           ops=B * 64 * 80, changed_levels=int((a != lk).sum().item()))

    # ---- K4 at 10 bits: a 10-bit 1080p luma plane of flat blocks, as at 8 bits
    sm = g.choice([8, 16, 32, 64], (1, R8, C8), p=[0.5, 0.3, 0.15, 0.05]).astype(np.int32)
    base = g.integers(240, 760, (1, R8 + 1, C8 + 1))
    plane = np.repeat(np.repeat(base, 8, 1), 8, 2)[:, :1080, :1920] \
        + g.integers(-8, 9, (1, 1080, 1920))
    check_deblock(torch, t, record, assert_equal, sm, np.clip(plane, 0, 1023), 10)

    # ---- K6 and K7 at 10 bits (coeff_shift 2) on the clip's noisy planes
    yp = t(y0.astype(np.int32)[None])
    dirs, var = check_cdef_dir(torch, t, record, assert_equal, yp, 10)
    noisy = [(t(p.astype(np.int32)[None]) + t(g.integers(-12, 13, (1, *p.shape))))
             .clamp(0, 1023).to(torch.int32).contiguous() for p in (y0, u0, v0)]
    mask = t(g.random((1, R8, C8)) < 0.8, torch.bool)
    on = int(mask.sum().item())
    ladder = SEARCH_CANDIDATES
    search = (noisy[0], dirs, var, mask, yp, ladder, 6, 2)
    sse = cdef_torch.cdef_search(*search)
    err = assert_equal("cdef_search", sse, cdef_torch.cdef_search_plain(*search))
    record("cdef_search", [len(ladder), 1, 1080, 1920, "luma search (SSE)", "10-bit"], err,
           timed_ms(lambda: cdef_torch.cdef_search(*search), 20),
           timed_ms(lambda: cdef_torch.cdef_search_plain(*search), 3),
           *cdef_search_work(1, 1080, 1920, len(ladder), on), cells_on=on)
    apply = (noisy, dirs, var, mask, sse, ladder, 6, 2)
    out, st = cdef_torch.cdef_apply(*apply)
    want, want_st = cdef_torch.cdef_apply_plain(*apply)
    err = max([assert_equal("cdef_apply", st, want_st)]
              + [assert_equal("cdef_apply", a, b) for a, b in zip(out, want)])
    record("cdef_apply", [1, 1080, 1920, "Y, U and V", "10-bit"], err,
           timed_ms(lambda: cdef_torch.cdef_apply(*apply), 20),
           timed_ms(lambda: cdef_torch.cdef_apply_plain(*apply), 3),
           *cdef_apply_work(1, 1080, 1920, len(ladder), on), cells_on=on)


def encode_clip(cfg, frames, device):
    """[(tu, recon)] of a clip through Encoder.send_frame + flush."""
    from svtav1_tpu_torch.pipeline.encoder import Encoder, EncoderConfig

    h, w = frames[0][0].shape
    enc = Encoder(EncoderConfig(w, h, **cfg), device=device)
    pkts = []
    for f in frames:
        pkts += enc.send_frame(*f)
    pkts += enc.flush()
    return [(p.tu, p.recon) for p in pkts]


DECODES = []  # [(label, [(tu, recon)], libaom, grains)] of the 1080p paths, decoded after them


def decode_later(label, pairs, libaom=False, grains=None):
    """Queue a 1080p path's first TUs for decode_queued: the paths' timings
    stay free of the decoder, and the sequences decode side by side; with
    libaom the tile streams also go through libaom; with grains (the film
    grain parameters the encoder signalled for each TU) the decoder's
    output must be the recon plus that grain."""
    DECODES.append((label, pairs, libaom, grains))


def decode_task(label, pairs, libaom, grains):
    """decode_all (and aom_check) in a worker process: (error message or
    None, seconds, TUs libaom checked or None)."""
    t0 = time.perf_counter()
    try:
        decode_all(label, pairs, grains)
        checked = aom_check(label, pairs) if libaom else None
    except (SystemExit, AssertionError) as err:  # a pool worker must not exit
        return f"{label}: {err}", time.perf_counter() - t0, None
    return None, time.perf_counter() - t0, checked


def decode_queued():
    """Decode every queued sequence, one worker process each, after the
    timed paths; fails on the first recon that differs."""
    import multiprocessing

    procs = max(1, min(len(DECODES), os.cpu_count() or 1))
    with multiprocessing.get_context("spawn").Pool(procs) as pool:
        results = pool.starmap(decode_task, DECODES)
    for (label, pairs, libaom, grains), (err, secs, checked) in zip(DECODES, results):
        if err:
            raise SystemExit(err)
        rec = dict(phase="decode", path=label, tus=len(pairs), seconds=secs,
                   decode_bit_exact=True)
        if libaom:
            rec["libaom_checked_tus"] = checked
        if grains:
            rec["output_recon_plus_grain"] = True
        log(json.dumps(rec))


def aom_check(label, pairs) -> int:
    """libaom's decode of a stream against the encoder's recon (display
    crop); returns the TUs it checked, 0 where the host has no libaom."""
    from svtav1_tpu_torch.utils import aomdec

    h, w = pairs[0][1][0].shape
    shown = [[pl[: h >> (i > 0), : w >> (i > 0)] for i, pl in enumerate(rec)] for _, rec in pairs]
    checked = aomdec.verify_tus([tu for tu, _ in pairs], shown)
    log(json.dumps(dict(libaom=label, checked_tus=checked, tus=len(pairs),
                        libaom_on_host=aomdec.available())))
    return checked


def decode_all(label, pairs, grains=None):
    """Decode the TUs in order with one decoder; each recon must equal the
    encoder's bit for bit (a show-existing TU, recon None, decodes none).
    With grains (one film grain parameter set per TU), each TU's output must
    be its recon's displayed part plus that grain (film_grain.apply_grain)
    and differ from the recon."""
    import numpy as np

    from svtav1_tpu_torch.decode.decoder import Decoder
    from svtav1_tpu_torch.filters.film_grain import apply_grain

    dec = Decoder()
    for i, (tu, rec) in enumerate(pairs):
        *out, drec = dec.decode_tu(tu)
        if rec is None or drec is None:
            if rec is not None or drec is not None:
                raise SystemExit(f"{label} TU {i}: a frame TU and a show-existing TU disagree")
            continue
        for p in range(3):
            if not np.array_equal(drec[p], rec[p]):
                raise SystemExit(f"{label} frame {i} plane {p}: decoder recon differs from the "
                                 "encoder's")
        if grains is not None:
            h, w = out[0].shape
            shown = [np.ascontiguousarray(pl[: h >> (p > 0), : w >> (p > 0)])
                     for p, pl in enumerate(rec)]
            want = apply_grain(tuple(shown), grains[i], dec.seq.bd)
            if not all(np.array_equal(a, b) for a, b in zip(out, want)):
                raise SystemExit(f"{label} frame {i}: the decoder's output is not the recon "
                                 "plus the signalled grain")
            if all(np.array_equal(a, b) for a, b in zip(out, shown)):
                raise SystemExit(f"{label} frame {i}: the grain changed no sample")


def cif_clips():
    """[(label, config, frames)] of phase 3, 352x288: a key frame at each
    preset, a 3-frame low-delay GOP, random-access GOPs with MCTF (a
    mini-GoP of 8, 9 frames; of 4, 5 frames); then rate control: CRF
    random access with MCTF, CBR, VBR and two-pass VBR low-delay GOPs, and
    a scene cut spliced at frame 4 of a 1000-frame key interval; then at 10
    bits (the clip << 2 plus seeded low bits) the 3-frame low-delay GOP and
    the 5-frame random-access GOP with MCTF; then 5 key frames in batches of
    4 (a partial last batch), a 5-frame mini-GoP of 4 with loop
    restoration, and a 3-frame low-delay GOP with film grain."""
    from svtav1_tpu_torch.pipeline.firstpass import FirstPassCollector
    from svtav1_tpu_torch.utils.testclip import make_frames

    ra = dict(RA, keyint=16, minigop=4)
    ld = dict(GOP, keyint=8, target_kbps=300.0, fps=30.0)
    frames = make_frames(352, 288, 8, seed=0)
    col = FirstPassCollector()
    for y, _u, _v in frames:
        col.send_frame(y)
    cut = frames[:4] + [(255 - y, v, u) for y, u, v in make_frames(352, 288, 4, seed=4)]
    return [("fast", FAST, make_frames(352, 288, 1, seed=0)),
            ("medium", MEDIUM, make_frames(352, 288, 1, seed=0)),
            ("medium GOP", dict(GOP, keyint=6), make_frames(352, 288, 3, seed=0)),
            ("medium random access minigop 8", dict(RA, keyint=16),
             make_frames(352, 288, 9, seed=0)),
            ("medium random access", ra, make_frames(352, 288, 5, seed=0)),
            ("CRF random access", dict(ra, rc_mode="crf", lookahead=8),
             make_frames(352, 288, 9, seed=0)),
            ("CBR low delay", dict(ld, rc_mode="cbr"), frames),
            ("VBR low delay", dict(ld, rc_mode="vbr"), frames),
            ("2-pass VBR low delay", dict(ld, rc_mode="vbr", stats_in=col.records), frames),
            ("scene cut", dict(GOP, keyint=1000, scene_cut=True), cut),
            ("10-bit medium GOP", dict(GOP, keyint=6, bd=10),
             make_frames(352, 288, 3, seed=0, bd=10)),
            ("10-bit medium random access", dict(ra, bd=10),
             make_frames(352, 288, 5, seed=0, bd=10)),
            ("batched all-intra", dict(MEDIUM, intra_batch=4), make_frames(352, 288, 5, seed=0)),
            ("restoration random access", dict(GOP, minigop=4, enable_restoration=True),
             make_frames(352, 288, 5, seed=0)),
            ("film grain", dict(GOP, keyint=6, film_grain=10), make_frames(352, 288, 3, seed=0))]


CPU_WORKERS = 2  # phase 3's CPU encodes: processes side by side, the cores split among them


def cpu_tus(clip, threads):
    """(TUs, seconds) of one phase-3 clip encoded with the plain versions on
    the CPU, in a worker process."""
    import torch

    torch.set_num_threads(threads)
    _label, cfg, frames = clip
    t0 = time.perf_counter()
    return [tu for tu, _ in encode_clip(cfg, frames, "cpu")], time.perf_counter() - t0


def conformance(torch):
    """Phase 3: each CIF clip encoded on the card, every TU decoded
    bit-exactly, and its bytes compared with the plain versions' on the
    CPU; the scene cut coded as a key frame at frame 4 only; the CLI on the
    minigop-4 random-access clip. The CPU encodes run meanwhile in
    CPU_WORKERS processes, the longest clips first: the plain versions
    gain little from more than four threads, so two clips side by side on
    four threads each finish sooner than one after another on eight."""
    import multiprocessing

    from svtav1_tpu_torch.entropy.bitstream import tu_frame_type

    clips = cif_clips()
    order = sorted(range(len(clips)), key=lambda i: -len(clips[i][2]))
    threads = max(1, (os.cpu_count() or 1) // CPU_WORKERS)
    card = {}
    with multiprocessing.get_context("spawn").Pool(CPU_WORKERS) as pool:
        cpu_runs = pool.starmap_async(cpu_tus, [(clips[i], threads) for i in order], chunksize=1)
        for label, cfg, frames in clips:
            t0 = time.perf_counter()
            pairs = encode_clip(cfg, frames, "cuda")
            torch.cuda.synchronize()
            card[label] = pairs, time.perf_counter() - t0
            decode_all(f"CIF {label}", pairs)
        t0 = time.perf_counter()
        cpu = dict(zip((clips[i][0] for i in order), cpu_runs.get(timeout=900)))
        cpu_wait_s = time.perf_counter() - t0
    for label, cfg, frames in clips:
        (pairs, card_s), (cpu_tu, cpu_s) = card[label], cpu[label]
        same = sum(len(a) for (a, _), b in zip(pairs, cpu_tu) if a == b)
        total = sum(len(a) for a, _ in pairs)
        log(json.dumps(dict(phase="conformance", preset=label,
                            config={k: v for k, v in cfg.items() if k != "stats_in"},
                            size=frames[0][0].shape[::-1], frames=len(frames), tus=len(pairs),
                            decode_bit_exact=True, bytes_cuda=total,
                            bytes_cpu=sum(len(b) for b in cpu_tu),
                            identical_tu_byte_share=same / total,
                            encode_s=dict(cuda=card_s, cpu=cpu_s))))
        if cfg.get("bd", 8) != 8 and same != total:
            raise SystemExit(f"CIF {label}: the card's bytes differ from the CPU's")
    log(json.dumps(dict(phase="conformance", cpu_workers=CPU_WORKERS, threads_per_worker=threads,
                        cpu_encode_s=sum(c[1] for c in cpu.values()), wait_for_cpu_s=cpu_wait_s)))
    types = [tu_frame_type(tu) for tu, _ in card["scene cut"][0]]
    if types != [0, 1, 1, 1, 0, 1, 1, 1]:
        raise SystemExit(f"scene cut: frame types {types}, not a key frame at frame 4 only")
    run_cli(clips[4][2], [tu for tu, _ in card["medium random access"][0]])


def run_cli(frames, want_tus):
    """Phase 3: the CLI in-process on the random-access clip (written as a
    y4m into a temporary directory) with --verify: exit code 0, and the IVF
    holds the library run's TUs."""
    import tempfile

    from svtav1_tpu_torch import app
    from svtav1_tpu_torch.io.ivf import read_ivf
    from svtav1_tpu_torch.io.y4m import write_y4m

    h, w = frames[0][0].shape
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        src, out = os.path.join(tmp, "clip.y4m"), os.path.join(tmp, "clip.ivf")
        write_y4m(src, frames, w, h)
        t0 = time.perf_counter()
        rc = app.main(["-i", src, "-b", out, "--keyint", "16", "--minigop", "4", "--enable-tf",
                       "--verify"])
        secs = time.perf_counter() - t0
        if rc != 0:
            raise SystemExit(f"the CLI exited {rc}")
        tus = read_ivf(out)[0]
    if tus != want_tus:
        raise SystemExit("the CLI's IVF differs from the library run's TUs")
    log(json.dumps(dict(phase="cli", size=[w, h], frames=len(frames), tus=len(tus), exit_code=rc,
                        seconds=secs, verify=True, tus_equal_library=True)))


def run_path(torch, label, cfg, n_timed, required, decode, libaom=False):
    """Phase 4: 1080p key frames through Encoder(device='cuda'): launch
    counts set to 0 just before the path and read just after it."""
    import numpy as np

    from svtav1_tpu_torch import kernels
    from svtav1_tpu_torch.pipeline.encoder import Encoder, EncoderConfig
    from svtav1_tpu_torch.utils import profiler

    W, H, N = 1920, 1080, n_timed
    frames = clip_1080p(N + 1)
    enc = Encoder(EncoderConfig(W, H, **cfg), device="cuda")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    first_tu, first_rec = enc.encode_frame(*frames[0])  # warm frame
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    profiler.reset()
    t0 = time.perf_counter()
    out = [enc.encode_frame(*f) for f in frames[1:]]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(kernels.launches)
    stages = profiler.report()
    waves = profiler.counts().get("commit/waves", 0) / N
    missing = [k for k in required if launches[k] <= 0]
    if missing:
        raise SystemExit(f"{label} path never launched: {missing}")
    psnr = []
    for (tu, rec), (y, _u, _v) in zip(out, frames[1:]):
        if not all(np.isfinite(p).all() for p in rec):
            raise SystemExit("non-finite recon")
        d = rec[0][:H, :W].astype(np.float64) - y
        mse = float((d * d).mean())
        psnr.append(10 * np.log10(255.0 ** 2 / max(mse, 1e-10)))
    if decode:
        decode_later(f"1080p {label}", [(first_tu, first_rec)], libaom)
    PATHS[label] = dict(fps=N / secs, bytes_per_frame=sum(len(tu) for tu, _ in out) / N,
                        y_psnr=sum(psnr) / N)
    log(json.dumps(dict(phase="path", preset=label, config=cfg, size=[W, H], frames_timed=N,
                        warm_frame_s=warm_s, fps=N / secs, seconds=secs,
                        bytes_per_frame=PATHS[label]["bytes_per_frame"],
                        y_psnr=sum(psnr) / N, waves_per_frame=waves,
                        launches_per_frame={k: v / (N + 1) for k, v in launches.items()},
                        stage_seconds=stages)))
    return launches


def forms_check(label, launches, bd):
    """A path launches only the forms of K8-K14 of its bit depth."""
    wrong = [k for k in (TEN_BIT if bd == 8 else tuple(_FORM16)) if launches[k]]
    if wrong:
        raise SystemExit(f"{label} launched {wrong}, kernels of the other bit depth")


def run_gop(torch, bd=8):
    """Phase 4, the main path: the bench's 16-frame 1080p clip with
    keyint=16 (a key frame, then 15 low-delay P frames) at medium through
    send_frame + flush on a fresh Encoder, after a 2-frame warm run on
    another. Launch counts set to 0 just before the timed run, read just
    after; the first two TUs are decoded bit-exactly. bd=10: the same GOP
    on the 10-bit clip (the 16-bit forms of K8-K10; Y-PSNR peak 1023)."""
    import numpy as np

    from svtav1_tpu_torch import kernels
    from svtav1_tpu_torch.pipeline.encoder import Encoder, EncoderConfig
    from svtav1_tpu_torch.utils import profiler

    W, H, N = 1920, 1080, 16
    cfg = GOP if bd == 8 else dict(GOP, bd=bd)
    label = "1080p GOP" if bd == 8 else "1080p 10-bit GOP"
    frames = clip_1080p(N, bd)
    t0 = time.perf_counter()
    warm = Encoder(EncoderConfig(W, H, **cfg), device="cuda")
    for f in frames[:2]:
        warm.send_frame(*f)
    warm.flush()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    del warm
    enc = Encoder(EncoderConfig(W, H, **cfg), device="cuda")
    torch.cuda.synchronize()
    kernels.reset_launches()
    profiler.reset()
    t0 = time.perf_counter()
    pkts = []
    key_waves = 0
    for i, f in enumerate(frames):
        pkts += enc.send_frame(*f)
        if i == 0:
            key_waves = profiler.counts().get("commit/waves", 0)
    pkts += enc.flush()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(kernels.launches)
    stages = profiler.report()
    counts = profiler.counts()
    missing = [k for k in (LD_KERNELS if bd == 8 else LD10_KERNELS) if launches[k] <= 0]
    if missing:
        raise SystemExit(f"{label} never launched: {missing}")
    forms_check(label, launches, bd)
    if [p.disp_idx for p in pkts] != list(range(N)):
        raise SystemExit(f"packets out of order: {[p.disp_idx for p in pkts]}")
    psnr = []
    for p in pkts:
        if p.recon[0].shape != (H, W) or not all(np.isfinite(pl).all() for pl in p.recon):
            raise SystemExit(f"frame {p.disp_idx}: recon of the wrong shape or not finite")
        psnr.append(y_psnr_db(p.recon[0], frames[p.disp_idx][0], bd))
    decode_later(label, [(p.tu, p.recon) for p in pkts[:2]])
    log(json.dumps(dict(phase="path", preset="medium GOP", config=cfg, size=[W, H], frames=N,
                        warm_2_frames_s=warm_s, fps=N / secs, seconds=secs,
                        bytes_per_frame=sum(len(p.tu) for p in pkts) / N,
                        bytes_key=len(pkts[0].tu),
                        bytes_per_p_frame=sum(len(p.tu) for p in pkts[1:]) / (N - 1),
                        y_psnr=float(np.mean(psnr)), key_waves=key_waves,
                        p_waves_per_frame=(counts.get("commit/waves", 0) - key_waves) / (N - 1),
                        launches_per_frame={k: v / N for k, v in launches.items()},
                        stage_seconds=stages)))
    return launches


def run_random_access(torch, bd=8):
    """Phase 4, the random-access path: 17 frames of the bench's clip with
    keyint=32, minigop=8 and MCTF at medium (a key frame and two 8-frame
    hierarchical-B mini-GoPs; MCTF on frames 0, 8 and 16) through
    send_frame + flush on a fresh Encoder, after a 3-frame warm run on
    another. Launch counts set to 0 just before the timed run, read just
    after; the first three TUs (the key frame, the hidden anchor 8 and
    frame 4, which has compound candidates) are decoded bit-exactly; Y-PSNR
    over the shown frames in display order (a show-existing TU shows the
    recon of its frame). bd=10: the same GOP on the 10-bit clip (the
    16-bit forms of K8-K13; Y-PSNR peak 1023)."""
    import numpy as np

    from svtav1_tpu_torch import kernels
    from svtav1_tpu_torch.pipeline.encoder import Encoder, EncoderConfig
    from svtav1_tpu_torch.utils import profiler

    W, H, N = 1920, 1080, 17
    cfg = RA if bd == 8 else dict(RA, bd=bd)
    label = "1080p random access" if bd == 8 else "1080p 10-bit random access"
    frames = clip_1080p(N, bd)
    t0 = time.perf_counter()
    warm = Encoder(EncoderConfig(W, H, **cfg), device="cuda")
    for f in frames[:3]:
        warm.send_frame(*f)
    warm.flush()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    del warm
    enc = Encoder(EncoderConfig(W, H, **cfg), device="cuda")
    torch.cuda.synchronize()
    kernels.reset_launches()
    profiler.reset()
    t0 = time.perf_counter()
    pkts = []
    for f in frames:
        pkts += enc.send_frame(*f)
    pkts += enc.flush()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(kernels.launches)
    stages = profiler.report()
    counts = profiler.counts()
    required = ([k for k in KERNEL_SOURCES if k not in CRF_ONLY + TEN_BIT] if bd == 8
                else RA10_KERNELS)
    missing = [k for k in required if launches[k] <= 0]
    if missing:
        raise SystemExit(f"{label} never launched: {missing}")
    forms_check(label, launches, bd)
    coded = [p.disp_idx for p in pkts if p.disp_idx is not None]
    shown = [p.shown_disp_idx for p in pkts if p.shown_disp_idx is not None]
    if sorted(coded) != list(range(N)) or shown != list(range(N)):
        raise SystemExit(f"coding order {coded} / display order {shown} is not a GOP of {N}")
    if coded[:3] != [0, 8, 4]:
        raise SystemExit(f"coding order starts {coded[:3]}, not the key, anchor 8 and frame 4")
    recon_of = {p.disp_idx: p.recon for p in pkts if p.recon is not None}
    psnr = []
    for d in shown:
        rec = recon_of[d]
        if rec[0].shape != (H, W) or not all(np.isfinite(pl).all() for pl in rec):
            raise SystemExit(f"frame {d}: recon of the wrong shape or not finite")
        psnr.append(y_psnr_db(rec[0], frames[d][0], bd))
    decode_later(label, [(p.tu, p.recon) for p in pkts[:3]])
    b_frames = [p for p in pkts if p.disp_idx not in (None, 0)]
    log(json.dumps(dict(phase="path", preset="medium random access", config=cfg, size=[W, H],
                        frames=N, tus=len(pkts), warm_3_frames_s=warm_s, fps=N / secs,
                        seconds=secs, bytes_per_frame=sum(len(p.tu) for p in pkts) / N,
                        bytes_key=len(pkts[0].tu),
                        bytes_per_b_frame=sum(len(p.tu) for p in b_frames) / len(b_frames),
                        bytes_show_existing=sum(len(p.tu) for p in pkts if p.disp_idx is None),
                        y_psnr=float(np.mean(psnr)), tf_calls=counts.get("tf", 0),
                        waves=counts.get("commit/waves", 0),
                        launches_per_frame={k: v / N for k, v in launches.items()},
                        stage_seconds=stages)))
    return launches


def record_qindex(enc) -> dict:
    """{display idx: qindex} of the frames `enc` codes, read from each
    frame's setup."""
    qindex = {}
    real_setup = enc._frame_setup

    def frame_setup(disp_idx, *a, **k):
        out = real_setup(disp_idx, *a, **k)
        qindex[disp_idx] = out["p"].qindex
        return out

    enc._frame_setup = frame_setup
    return qindex


def run_crf(torch, bd=8):
    """Phase 4, the CRF path: 17 frames of the bench's clip with CRF (TPL
    over 16-frame lookahead windows), keyint=32, minigop=8 and MCTF at
    medium through send_frame + flush on a fresh Encoder, after a 3-frame
    warm run on another: TPL runs over windows of 16, 16 and 9 frames (41
    TPL frames of 1088x1920). Launch counts set to 0 just before the timed
    run and read just after: every kernel K1-K16 must launch. The first
    three TUs are decoded bit-exactly; each frame's qindex and each
    window's r0 are printed, and the `tpl` stage's ms per frame. Then one
    16-frame TPL window alone, its launches and summed kernel bounds counted
    per TPL frame (also with K8 and K14 at the measured packed rates).
    bd=10: the same GOP on the 10-bit clip (the 16-bit forms of K8-K14, no
    8-bit form of them; Y-PSNR peak 1023)."""
    import numpy as np

    from svtav1_tpu_torch import kernels
    from svtav1_tpu_torch.pipeline import tpl
    from svtav1_tpu_torch.pipeline.encoder import Encoder, EncoderConfig, pad_to_aligned
    from svtav1_tpu_torch.utils import profiler
    from svtav1_tpu_torch.utils.profile_keyframes import bound_ms, count_launches, launch_bound

    W, H, N = 1920, 1080, 17
    cfg = CRF if bd == 8 else dict(CRF, bd=bd)
    label = "1080p CRF" if bd == 8 else "1080p 10-bit CRF"
    frames = clip_1080p(N, bd)
    t0 = time.perf_counter()
    warm = Encoder(EncoderConfig(W, H, **cfg), device="cuda")
    for f in frames[:3]:
        warm.send_frame(*f)
    warm.flush()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    del warm
    enc = Encoder(EncoderConfig(W, H, **cfg), device="cuda")
    qindex, r0 = record_qindex(enc), []
    real_r0 = enc._tpl_r0

    def tpl_r0(lumas):
        out = real_r0(lumas)
        r0.append([float(x) for x in out])
        return out

    enc._tpl_r0 = tpl_r0
    torch.cuda.synchronize()
    kernels.reset_launches()
    profiler.reset()
    t0 = time.perf_counter()
    pkts = []
    for f in frames:
        pkts += enc.send_frame(*f)
    pkts += enc.flush()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(kernels.launches)
    stages = profiler.report()
    counts = profiler.counts()
    required = ([k for k in KERNEL_SOURCES if k not in TEN_BIT] if bd == 8 else
                RA10_KERNELS + CRF10_ONLY)
    missing = [k for k in required if launches[k] <= 0]
    if missing:
        raise SystemExit(f"{label} path never launched: {missing}")
    forms_check(label, launches, bd)
    coded = [p.disp_idx for p in pkts if p.disp_idx is not None]
    shown = [p.shown_disp_idx for p in pkts if p.shown_disp_idx is not None]
    if sorted(coded) != list(range(N)) or shown != list(range(N)):
        raise SystemExit(f"coding order {coded} / display order {shown} is not a GOP of {N}")
    if [len(w) for w in r0] != [16, 16, 9] or not all(0 < x <= 1 for w in r0 for x in w):
        raise SystemExit(f"TPL windows {[len(w) for w in r0]} or r0 out of (0, 1]: {r0}")
    recon_of = {p.disp_idx: p.recon for p in pkts if p.recon is not None}
    psnr = []
    for d in shown:
        rec = recon_of[d]
        if rec[0].shape != (H, W) or not all(np.isfinite(pl).all() for pl in rec):
            raise SystemExit(f"frame {d}: recon of the wrong shape or not finite")
        psnr.append(y_psnr_db(rec[0], frames[d][0], bd))
    decode_later(label, [(p.tu, p.recon) for p in pkts[:3]])
    tpl_s = stages.get("tpl")
    PATHS[label] = dict(fps=N / secs, bytes_per_frame=sum(len(p.tu) for p in pkts) / N,
                        y_psnr=float(np.mean(psnr)), qindex=[qindex[d] for d in range(N)],
                        tpl_ms_per_frame=tpl_s and tpl_s / N * 1e3)
    log(json.dumps(dict(phase="path", preset="medium CRF random access", config=cfg, size=[W, H],
                        frames=N, tus=len(pkts), warm_3_frames_s=warm_s, fps=N / secs,
                        seconds=secs, bytes_per_frame=sum(len(p.tu) for p in pkts) / N,
                        bytes_key=len(pkts[0].tu), y_psnr=float(np.mean(psnr)),
                        qindex_by_frame=[qindex[d] for d in range(N)], r0_by_window=r0,
                        tpl_frames=sum(len(w) for w in r0), tpl_s=tpl_s,
                        tpl_ms_per_frame=tpl_s and tpl_s / N * 1e3,
                        tf_calls=counts.get("tf", 0),
                        launches_per_frame={k: v / N for k, v in launches.items()},
                        stage_seconds=stages)))
    # one 16-frame TPL window alone: wall time, launches and bounds per TPL frame
    lumas = [pad_to_aligned(f[0].astype(np.int32), W, 1088) for f in frames[:16]]
    box, seen = {}, []

    def window():
        real = kernels.launch  # count_launches's: K8's and K14's arguments, for packed bounds
        kernels.launch = lambda nm, *a: seen.append((nm, a)) or real(nm, *a)
        try:
            t1 = time.perf_counter()
            box["r0"] = tpl.synthesize(tpl.tpl_window(lumas, 120, bd, minigop=8, device="cuda"))
            torch.cuda.synchronize()
            box["s"] = time.perf_counter() - t1
        finally:
            kernels.launch = real

    by_stage = count_launches(window)["tpl"]
    counted = sum(v[1] for v in by_stage.values())
    # K8 and K14 at the measured packed rates in place of their int32 counts
    packed = counted + sum(packed_bound_ms(nm, a) - bound_ms(*launch_bound(nm, a))
                         for nm, a in seen if nm.startswith(("me_sad", "subpel_refine")))
    log(json.dumps(dict(phase="tpl window", bd=bd, size=[1920, 1088], frames=16, seconds=box["s"],
                        ms_per_tpl_frame=box["s"] / 16 * 1e3,
                        launches_per_tpl_frame={k: v[0] / 16 for k, v in by_stage.items()},
                        bound_ms_per_tpl_frame=counted / 16,
                        packed_bound_ms_per_tpl_frame=packed / 16,
                        r0=[float(x) for x in box["r0"]])))
    return launches


def run_vbr(torch):
    """Phase 4, one-pass VBR on the low-delay GOP: the bench's 16-frame clip
    with keyint=16 at 1000 kbps and 30 frames/s (CQP at qindex 120 gives
    about 945 kbps), every inter frame coded synchronously, after a 2-frame
    warm run. Prints the achieved bitrate against the target, fps and each
    frame's qindex; the first two TUs are decoded bit-exactly."""
    import numpy as np

    from svtav1_tpu_torch.pipeline.encoder import Encoder, EncoderConfig
    from svtav1_tpu_torch.utils import profiler

    W, H, N = 1920, 1080, 16
    frames = clip_1080p(N)
    warm = Encoder(EncoderConfig(W, H, **VBR), device="cuda")
    for f in frames[:2]:
        warm.send_frame(*f)
    warm.flush()
    del warm
    enc = Encoder(EncoderConfig(W, H, **VBR), device="cuda")
    qindex = record_qindex(enc)
    torch.cuda.synchronize()
    profiler.reset()
    t0 = time.perf_counter()
    pkts = []
    for f in frames:
        pkts += enc.send_frame(*f)
    pkts += enc.flush()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if [p.disp_idx for p in pkts] != list(range(N)):
        raise SystemExit(f"VBR packets out of order: {[p.disp_idx for p in pkts]}")
    psnr = []
    for p in pkts:
        d = p.recon[0][:H, :W].astype(np.float64) - frames[p.disp_idx][0]
        psnr.append(10 * np.log10(255.0 ** 2 / max(float((d * d).mean()), 1e-12)))
    decode_later("1080p VBR", [(p.tu, p.recon) for p in pkts[:2]])
    nbytes = sum(len(p.tu) for p in pkts)
    log(json.dumps(dict(phase="path", preset="medium VBR low delay", config=VBR, size=[W, H],
                        frames=N, fps=N / secs, seconds=secs, target_kbps=VBR["target_kbps"],
                        achieved_kbps=nbytes * 8 / (N / VBR["fps"]) / 1e3,
                        bytes_per_frame=nbytes / N, y_psnr=float(np.mean(psnr)),
                        qindex_by_frame=[qindex[d] for d in range(N)],
                        stage_seconds=profiler.report())))


BATCH = 8  # the batched all-intra path: frames per batch, one batch


def run_intra_batch(torch, bd=8):
    """Phase 4, all-intra batched: the bench clip's first 8 frames at
    keyint=1, medium, coded as one batch (intra_batch=8: one decide, one K16
    launch and one filter pass for the 8 frames) and one by one
    (intra_batch=1), each run on a fresh Encoder: a warm run of each, then
    three runs of each in turns. Every run's TUs and recon must equal the
    first unbatched run's. Per mode: frames/s, stage seconds, waves,
    launches and torch.cuda.max_memory_allocated (launch counts set to 0
    just before each run and read just after). The first TUs are queued for
    the 1080p decodes."""
    import numpy as np

    from svtav1_tpu_torch import kernels
    from svtav1_tpu_torch.pipeline.encoder import Encoder, EncoderConfig
    from svtav1_tpu_torch.utils import profiler

    W, H = 1920, 1080
    frames = clip_1080p(BATCH, bd)
    cfg = dict(MEDIUM, bd=bd)
    label = "1080p all-intra batched" if bd == 8 else "1080p 10-bit all-intra batched"

    def run(batch):
        enc = Encoder(EncoderConfig(W, H, intra_batch=batch, **cfg), device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        profiler.reset()
        kernels.reset_launches()
        t0 = time.perf_counter()
        pkts = []
        for f in frames:
            pkts += enc.send_frame(*f)
        pkts += enc.flush()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return pkts, dict(fps=BATCH / secs, stage_seconds=profiler.report(),
                          waves=profiler.counts().get("commit/waves", 0),
                          launches={k: v for k, v in kernels.launches.items() if v},
                          max_memory_allocated=torch.cuda.max_memory_allocated())

    run(BATCH)
    want, _ = run(1)
    runs = {1: [], BATCH: []}
    for _ in range(3):
        for batch in (1, BATCH):
            pkts, rec = run(batch)
            if [p.disp_idx for p in pkts] != list(range(BATCH)):
                raise SystemExit(f"{label}: packets out of order")
            for a, b in zip(pkts, want):
                if a.tu != b.tu or not all(np.array_equal(x, y) for x, y in zip(a.recon,
                                                                                b.recon)):
                    raise SystemExit(f"{label}: intra_batch={batch} frame {a.disp_idx} differs "
                                     "from the unbatched encode")
            runs[batch].append(rec)
    last = runs[BATCH][-1]
    missing = [k for k in KEY_KERNELS if last["launches"].get(k, 0) <= 0]
    if missing:
        raise SystemExit(f"{label} never launched: {missing}")
    if last["launches"]["commit_wave"] != 1:
        raise SystemExit(f"{label}: K16 launched {last['launches']['commit_wave']} times for "
                         "one batch")
    decode_later(label, [(p.tu, p.recon) for p in want[: 2 if bd == 8 else 1]])
    fps = {str(b): [r["fps"] for r in runs[b]] for b in runs}
    log(json.dumps(dict(phase="path", preset=label, config=dict(cfg, intra_batch=BATCH),
                        size=[W, H], frames=BATCH, runs_in_turns=3, fps_by_batch=fps,
                        median_fps={b: statistics.median(v) for b, v in fps.items()},
                        bytes_per_frame=sum(len(p.tu) for p in want) / BATCH,
                        y_psnr=float(np.mean([y_psnr_db(p.recon[0], frames[p.disp_idx][0], bd)
                                              for p in want])),
                        tus_equal_unbatched=True, waves=last["waves"],
                        waves_unbatched=runs[1][-1]["waves"],
                        launches_per_batch=last["launches"],
                        launches_unbatched_per_frame={k: v / BATCH for k, v in
                                                      runs[1][-1]["launches"].items()},
                        max_memory_allocated={str(b): runs[b][-1]["max_memory_allocated"]
                                              for b in runs},
                        stage_seconds={str(b): runs[b][-1]["stage_seconds"] for b in runs})))


def run_restoration(torch):
    """Phase 4, loop restoration at 1080p (the synchronous route: the decide,
    the commit, deblocking and CDEF on the card, then the restoration
    search, the plan walk and the restoration filter on the host): the
    main path's key frame and first P frame at 8 bits and the 10-bit clip's
    key frame, each beside the same frames without restoration. Per frame
    and plane the restoration types, read from the TUs' frame headers; the
    stages' seconds, bytes and Y-PSNR. Launch counts set to 0 just before
    and read just after each restoration run: the commit's kernels and the
    filters K4, K6 and K7 run. The TUs are queued for the 1080p decodes."""
    from svtav1_tpu_torch import kernels
    from svtav1_tpu_torch.decode.decoder import frame_headers
    from svtav1_tpu_torch.utils import profiler

    W, H = 1920, 1080
    for bd, n in ((8, 2), (10, 1)):
        frames = clip_1080p(n, bd)
        cfg = dict(GOP, bd=bd)
        plain = encode_clip(cfg, frames, "cuda")
        torch.cuda.synchronize()
        profiler.reset()
        kernels.reset_launches()
        t0 = time.perf_counter()
        pairs = encode_clip(dict(cfg, enable_restoration=True), frames, "cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.launches.items() if v}
        # the P frame adds phase A's K5 and the decide's K8-K10
        required = KEY_KERNELS + (("rdoq", "me_sad", "subpel_pred", "mc_lanes") if n > 1 else ())
        missing = [k for k in required if k not in launches]
        label = "1080p restoration" if bd == 8 else "1080p 10-bit restoration"
        if missing:
            raise SystemExit(f"{label}: never launched {missing}")
        stages = profiler.report()

        def psnr(ps):
            return [y_psnr_db(rec[0], f[0], bd) for (_, rec), f in zip(ps, frames)]

        decode_later(label, pairs)
        log(json.dumps(dict(phase="path", preset=label, config=dict(cfg, enable_restoration=True),
                            size=[W, H], frames=n, seconds=secs,
                            lr_types=[list(fi.lr_types) for fi in frame_headers(
                                [tu for tu, _ in pairs])],
                            bytes=[len(tu) for tu, _ in pairs],
                            bytes_no_restoration=[len(tu) for tu, _ in plain],
                            y_psnr=psnr(pairs), y_psnr_no_restoration=psnr(plain),
                            restoration_stage_seconds={
                                k: stages.get(k, 0.0) for k in ("filter", "lr_search",
                                                                "lr_apply", "entropy_walk")},
                            launches=launches, stage_seconds=stages)))


def run_film_grain(torch):
    """Phase 4, film grain at 1080p: the main path's first 4 frames (a key
    frame and 3 P frames) with film_grain=10 (the grain estimated from the
    first source frame); the recon must equal the run without grain. The
    first two TUs are queued for the 1080p decodes with the grain the
    encoder signalled: the decoder's output must be the recon plus that
    grain."""
    import numpy as np

    from svtav1_tpu_torch import kernels
    from svtav1_tpu_torch.pipeline.encoder import Encoder, EncoderConfig

    W, H, N = 1920, 1080, 4
    frames = clip_1080p(N)
    plain = encode_clip(GOP, frames, "cuda")
    enc = Encoder(EncoderConfig(W, H, film_grain=10, **GOP), device="cuda")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    pkts = []
    for f in frames:
        pkts += enc.send_frame(*f)
    pkts += enc.flush()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    missing = [k for k in LD_KERNELS if kernels.launches[k] <= 0]
    if missing:
        raise SystemExit(f"1080p film grain never launched: {missing}")
    for p, (_, rec) in zip(pkts, plain):
        if not all(np.array_equal(a, b) for a, b in zip(p.recon, rec)):
            raise SystemExit(f"1080p film grain: frame {p.disp_idx}'s recon differs from the "
                             "encode without grain")
    grains = [enc._grain_for(p.disp_idx) for p in pkts]
    decode_later("1080p film grain", [(p.tu, p.recon) for p in pkts[:2]], grains=grains[:2])
    g = grains[0]
    log(json.dumps(dict(phase="path", preset="1080p film grain", config=dict(GOP, film_grain=10),
                        size=[W, H], frames=N, fps=N / secs,
                        bytes=[len(p.tu) for p in pkts],
                        bytes_no_grain=[len(tu) for tu, _ in plain],
                        recon_equal_without_grain=True,
                        grain=dict(y_points=len(g.y_points), cb_points=len(g.cb_points),
                                   cr_points=len(g.cr_points), ar_coeff_lag=g.ar_coeff_lag,
                                   scaling_shift=g.scaling_shift,
                                   seeds=[x.grain_seed for x in grains]))))


# the host mode decision (the reference's default route) with filter-intra, low delay
HOST_MD = dict(qindex=120, keyint=16, preset="medium", mode_decision="numpy",
               enable_filter_intra=True)
HOST_MD_SIZE = (352, 288)  # CIF: a host-MD 1080p key frame takes minutes on the host
HOST_MD_KERNELS = ("dlf_edges", "cdef_dir", "cdef_search", "cdef_apply")  # K4, K6, K7


def host_md_clips():
    """[(label, config, frames)] of the host mode-decision phase at CIF: a
    3-frame low-delay GOP (a key frame and 2 P frames), a 10-bit key frame
    and a key frame with loop restoration."""
    from svtav1_tpu_torch.utils.testclip import make_frames

    w, h = HOST_MD_SIZE
    return [("CIF host MD GOP", HOST_MD, make_frames(w, h, 3, seed=0)),
            ("CIF host MD 10-bit key frame", dict(HOST_MD, bd=10),
             make_frames(w, h, 1, seed=0, bd=10)),
            ("CIF host MD restoration key frame", dict(HOST_MD, enable_restoration=True),
             make_frames(w, h, 1, seed=0))]


def filter_intra_decode(label, pairs) -> int:
    """decode_all of a stream, and the luma blocks the decoder predicted
    with filter-intra."""
    from unittest import mock

    from svtav1_tpu_torch.ops import intra as intra_ops

    count = [0]
    real = intra_ops.filter_intra_pred

    def spy(*args, **kw):
        count[0] += 1
        return real(*args, **kw)

    with mock.patch.object(intra_ops, "filter_intra_pred", spy):
        decode_all(label, pairs)
    return count[0]


def host_md_encode(clip, device, threads=None, decode=False):
    """One host-route clip through Encoder.send_frame on `device`, frame by
    frame (each send_frame returns its frame's TU on this route): launch
    counts set to 0 just before the first frame and read after each; per
    frame the stage seconds and launches. With decode, the TUs are decoded
    here (filter_intra_decode). In a worker process the errors come back
    as a message."""
    import torch

    from svtav1_tpu_torch import kernels
    from svtav1_tpu_torch.pipeline.encoder import Encoder, EncoderConfig
    from svtav1_tpu_torch.utils import profiler

    label, cfg, frames = clip
    try:
        if threads:
            torch.set_num_threads(threads)
        h, w = frames[0][0].shape
        enc = Encoder(EncoderConfig(w, h, **cfg), device=device)
        profiler.reset()
        kernels.reset_launches()
        pairs, per_frame = [], []
        t0 = time.perf_counter()
        for f in frames:
            s0, l0, t1 = profiler.report(), dict(kernels.launches), time.perf_counter()
            pkts = enc.send_frame(*f)
            if device != "cpu":
                torch.cuda.synchronize()
            s1 = profiler.report()
            pairs += [(p.tu, p.recon) for p in pkts]
            per_frame.append(dict(
                seconds=time.perf_counter() - t1,
                stages={k: round(s1[k] - s0.get(k, 0.0), 4) for k in s1
                        if s1[k] != s0.get(k, 0.0)},
                launches={k: v - l0[k] for k, v in kernels.launches.items() if v != l0[k]}))
        pairs += [(p.tu, p.recon) for p in enc.flush()]
        secs = time.perf_counter() - t0
        out = dict(tus=[tu for tu, _ in pairs], frames=per_frame, seconds=secs)
        if decode:
            out["filter_intra_blocks"] = filter_intra_decode(label, pairs)
        else:
            out["pairs"] = pairs
        return out
    except (SystemExit, Exception) as err:  # a pool worker must not exit
        return dict(error=f"{label} on {device}: {err!r}")


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode:
        raise SystemExit(f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def run_host_md(torch):
    """The host mode-decision phase (mode_decision="numpy", filter-intra,
    CIF): the 3-frame GOP on the card in this process while worker
    processes encode it with the plain versions on the CPU and the 10-bit
    and restoration key frames on the card (each decoding its own TUs).
    The GOP's TUs must equal the CPU's byte for byte and decode to the
    recon; it must code filter-intra blocks; every frame launches K4, K6
    and K7, and no other kernel (the host decides and reconstructs). Per
    frame the host_md, filter and entropy_walk seconds and the launches,
    and the host MD time scaled to a 1080p frame by its pixels beside the
    card's name and power limit."""
    import multiprocessing

    import numpy as np

    clips = host_md_clips()
    gop = clips[0]
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(len(clips)) as pool:
        cpu_run = pool.apply_async(host_md_encode, (gop, "cpu", 2))
        keys = [pool.apply_async(host_md_encode, (c, "cuda", 1, True)) for c in clips[1:]]
        card = host_md_encode(gop, "cuda")
        if "error" in card:
            raise SystemExit(card["error"])
        card_s = time.perf_counter() - t0
        fi_blocks = filter_intra_decode(gop[0], card["pairs"])
        runs = [cpu_run.get(timeout=900)] + [k.get(timeout=900) for k in keys]
    for r in runs:
        if "error" in r:
            raise SystemExit(r["error"])
    cpu, key_runs = runs[0], runs[1:]
    if card["tus"] != cpu["tus"]:
        raise SystemExit(f"{gop[0]}: the card's TUs differ from the CPU's")
    if fi_blocks <= 0:
        raise SystemExit(f"{gop[0]}: no block coded with filter-intra")
    for (label, _cfg, _f), r in zip(clips, [card] + key_runs):
        for i, fr in enumerate(r["frames"]):
            missing = [k for k in HOST_MD_KERNELS if fr["launches"].get(k, 0) <= 0]
            other = [k for k in fr["launches"] if k not in HOST_MD_KERNELS]
            if missing or other:
                raise SystemExit(f"{label} frame {i}: K4, K6 and K7 not all launched "
                                 f"({missing} missing) or other kernels launched ({other})")
    w, h = HOST_MD_SIZE
    scale = 1920 * 1080 / (w * h)
    md = [fr["stages"].get("host_md", 0.0) for fr in card["frames"]]
    for (label, cfg, frames), r in zip(clips, [card] + key_runs):
        bd = cfg.get("bd", 8)
        rec = dict(phase="path", preset=label, config=cfg, size=[w, h], frames=len(frames),
                   tus=len(r["tus"]), bytes=[len(tu) for tu in r["tus"]], seconds=r["seconds"],
                   decode_bit_exact=True,
                   filter_intra_blocks=fi_blocks if r is card else r["filter_intra_blocks"],
                   launches_per_frame=[fr["launches"] for fr in r["frames"]],
                   stage_seconds_per_frame=[
                       {k: v for k, v in fr["stages"].items()
                        if k in ("host_md", "filter", "entropy_walk", "lr_search", "lr_apply")}
                       for fr in r["frames"]])
        if r is card:
            rec.update(tus_equal_cpu=True, encode_s=dict(cuda=card_s, cpu=cpu["seconds"]),
                       y_psnr=float(np.mean([y_psnr_db(rc[0], f[0], bd)
                                             for (_, rc), f in zip(card["pairs"], frames)])))
        log(json.dumps(rec))
    log(json.dumps(dict(phase="host MD at 1080p, extrapolated", card=smi_line(),
                        cif_host_md_s=dict(key=md[0], p=float(np.mean(md[1:]))),
                        pixels_ratio=scale,
                        host_md_1080p_s=dict(key=md[0] * scale,
                                             p=float(np.mean(md[1:])) * scale))))


def mesh_frames(w, h, n, bd=8):
    """n frames of the synthetic clip at w x h (at 10 bits the 10-bit clip),
    each after the first with a patch of new content near the right edge,
    so that the P frames code intra blocks among the inter ones
    (tests/test_torch_tiles.py's GOP)."""
    import numpy as np

    from svtav1_tpu_torch.utils.testclip import make_frames

    frames = [[np.asarray(pl, np.int32) for pl in f] for f in make_frames(w, h, n, bd=bd)]
    yy, xx = np.mgrid[0:40, 0:40]
    for d in range(1, n):
        x = w - 106 + 8 * d
        patch = 128 + 60 * np.sin((xx + yy * d) / 3.0)
        frames[d][0][12:52, x : x + 40] = patch * (1 << (bd - 8))
    return frames


def mesh_encode(frames, device, qindex=120, bd=8):
    """A key frame and P frames (LAST: the previous frame's recon) through
    parallel.tiles' two encoders in MESH_TILES tile columns at depth bd, the
    in-loop filters off (the caller's choice): ([(tu, recon)], seconds per
    frame)."""
    from svtav1_tpu_torch.codec.tile_codec import FrameParams
    from svtav1_tpu_torch.constants.av1 import RefFrame
    from svtav1_tpu_torch.entropy.bitstream import (FrameConfig, SequenceConfig, frame_obu,
                                                    sequence_header_obu, temporal_delimiter_obu)
    from svtav1_tpu_torch.parallel import tiles

    h, w = frames[0][0].shape
    log2 = MESH_TILES.bit_length() - 1
    seq = SequenceConfig(width=w, height=h, bd=bd, enable_cdef=False)
    last = int(RefFrame.LAST_FRAME)
    out, secs = [], []
    for d, src in enumerate(frames):
        t0 = time.perf_counter()
        if d == 0:
            p = FrameParams(width=w, height=h, qindex=qindex, bd=bd, frame_is_intra=True,
                            tile_cols_log2=log2)
            pay, rec, p = tiles.encode_intra_frame_mesh(src, p, MESH_TILES, device=device)
            fr = FrameConfig(qindex=qindex, disable_cdf_update=False, show_frame=True,
                             tile_cols_log2=log2, frame_type=0, order_hint=0)
            tu = temporal_delimiter_obu() + sequence_header_obu(seq) + frame_obu(seq, fr, pay)
        else:
            hints = [0] * 8
            hints[last] = d - 1
            p = FrameParams(width=w, height=h, qindex=qindex, bd=bd, frame_is_intra=False,
                            order_hint=d, ref_hints=tuple(hints), tile_cols_log2=log2)
            pay, rec, p, _mi = tiles.encode_inter_frame_mesh(src, p, {last: out[-1][1]},
                                                             MESH_TILES, device=device)
            fr = FrameConfig(qindex=qindex, disable_cdf_update=False, show_frame=True,
                             tile_cols_log2=log2, frame_type=1, order_hint=d,
                             refresh_frame_flags=1, ref_frame_idx=(0,) * 7)
            tu = temporal_delimiter_obu() + frame_obu(seq, fr, pay)
        secs.append(time.perf_counter() - t0)
        out.append((tu, rec))
    return out, secs


class DecideTimer:
    """Times every run of the tile decide (parallel.tiles' _mesh_decide_fn
    and _mesh_inter_fn programs) on the card, a synchronize on each side."""

    NAMES = ("_mesh_decide_fn", "_mesh_inter_fn")

    def __init__(self, torch):
        self.torch = torch
        self.ms = []

    def __enter__(self):
        from svtav1_tpu_torch.parallel import tiles

        self.saved = {n: getattr(tiles, n) for n in self.NAMES}
        for name, build in self.saved.items():
            setattr(tiles, name, self._wrap(build))
        return self

    def __exit__(self, *exc):
        from svtav1_tpu_torch.parallel import tiles

        for name, build in self.saved.items():
            setattr(tiles, name, build)

    def _wrap(self, build):
        def wrapped(*args):
            run, *rest = build(*args)

            def timed(*a):
                self.torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = run(*a)
                self.torch.cuda.synchronize()
                self.ms.append((time.perf_counter() - t0) * 1e3)
                return out

            return (timed, *rest)

        return wrapped


def y_psnr(pairs, frames, bd=8):
    import numpy as np

    out = []
    for (_tu, rec), f in zip(pairs, frames):
        h, w = f[0].shape
        if rec[0].shape != (h, w) or not all(np.isfinite(pl).all() for pl in rec):
            raise SystemExit("tile recon of the wrong shape or not finite")
        out.append(y_psnr_db(rec[0], f[0], bd))
    return float(np.mean(out))


def run_mesh(torch, label, frames, required, bd=8):
    """A 1080p-wide mesh clip on the card at depth bd: a warm run, a timed
    run (the decide's ms per frame on the card, the frames' wall seconds;
    launch counts set to 0 just before it and read just after; only the
    forms of K8-K10 of its depth), and a counted run (each launch's bound,
    summed per stage: the commit's, and every other launch, the decide's).
    The timed run's first TUs are queued for the decoders."""
    from svtav1_tpu_torch import kernels
    from svtav1_tpu_torch.utils import profiler
    from svtav1_tpu_torch.utils.profile_keyframes import count_launches

    n = len(frames)
    mesh_encode(frames, "cuda", bd=bd)
    torch.cuda.synchronize()
    kernels.reset_launches()
    profiler.reset()
    with DecideTimer(torch) as timer:
        pairs, secs = mesh_encode(frames, "cuda", bd=bd)
    launches = dict(kernels.launches)
    waves = profiler.counts().get("commit/waves", 0)
    missing = [k for k in required if launches[k] <= 0]
    if missing:
        raise SystemExit(f"{label} never launched: {missing}")
    forms_check(label, launches, bd)
    counted = count_launches(lambda: mesh_encode(frames, "cuda", bd=bd), default="decide")
    bounds = {st: dict(launches_per_frame=sum(v[0] for v in ks.values()) / n,
                       bound_ms_per_frame=sum(v[1] for v in ks.values()) / n,
                       kernels={k: v[0] / n for k, v in ks.items()})
              for st, ks in counted.items()}
    decode_later(f"{label}", pairs, libaom=True)
    h, w = frames[0][0].shape
    log(json.dumps(dict(phase="tiles", path=label, bd=bd, size=[w, h], tiles=MESH_TILES, frames=n,
                        decide_ms=timer.ms, frame_s=secs, waves=waves,
                        bytes=[len(tu) for tu, _ in pairs],
                        y_psnr=y_psnr(pairs, frames, bd), stages=bounds,
                        launches_per_frame={k: v / n for k, v in launches.items() if v})))


def run_tiles(torch):
    """The tiles phase: the 256x64 mesh GOP (a key frame and 2 P frames in
    two tiles) on the card and with the plain versions on the CPU, byte for
    byte, decoded by both decoders; the 8-tile 1080p medium key frame
    through the Encoder beside the one-tile one of phase 4; the two-column
    mesh at full width, a 1920x1080 key frame and a 1920x1024 key frame
    with 2 P frames (the tallest 1920-wide size whose tile heights are
    whole superblocks, as the inter mesh needs). The 256x64 GOP and the
    1920x1024 GOP also at 10 bits, on the 10-bit clip."""
    import numpy as np

    for bd in (8, 10):
        label = "256x64 mesh GOP" if bd == 8 else "256x64 10-bit mesh GOP"
        small = mesh_frames(256, 64, 3, bd)
        card, _ = mesh_encode(small, "cuda", bd=bd)
        cpu, _ = mesh_encode(small, "cpu", bd=bd)
        if [tu for tu, _ in card] != [tu for tu, _ in cpu]:
            raise SystemExit(f"{label}: the card's TUs differ from the plain versions'")
        decode_all(label, card)
        checked = aom_check(label, card)
        log(json.dumps(dict(phase="tiles", path=label, bd=bd, tiles=MESH_TILES,
                            bytes=[len(tu) for tu, _ in card], tus_equal_cpu=True,
                            decode_bit_exact=True, libaom_checked_tus=checked,
                            y_psnr=y_psnr(card, small, bd))))

    run_path(torch, "medium, 8 tiles", TILES, 1, KEY_KERNELS, True, libaom=True)
    one, eight = PATHS["medium"], PATHS["medium, 8 tiles"]
    log(json.dumps(dict(phase="tiles", path="1080p medium key frame, 8 tiles against 1",
                        fps=[eight["fps"], one["fps"]],
                        bytes_per_frame=[eight["bytes_per_frame"], one["bytes_per_frame"]],
                        y_psnr=[eight["y_psnr"], one["y_psnr"]])))

    intra = ("intra_pred", "txfm_quant_recon", "txb_rate", "commit_wave")
    run_mesh(torch, "1920x1080 mesh key frame", clip_1080p(1), intra)
    for bd in (8, 10):
        gop = [[np.asarray(pl[: 1024 >> (i > 0)], np.int32) for i, pl in enumerate(f)]
               for f in clip_1080p(3, bd)]
        inter = ("rdoq", "me_sad", "subpel_pred", "mc_lanes")
        if bd == 10:
            inter = tuple(_FORM16.get(k, k) for k in inter)
        run_mesh(torch, "1920x1024 mesh GOP" if bd == 8 else "1920x1024 10-bit mesh GOP", gop,
                 intra + inter, bd)


class K16Capture:
    """Stands in for pipeline.wavefront.commit_wave during phase 4: for each
    schedule that `expect` names, the inputs of the first K16 launch that
    fits it (a commit without inter lanes for "fast", "key" and "key10",
    with inter lanes for "P" and "P10"; for "B" the first with compound
    lanes, or else the phase's last with inter lanes; for "batch8" a batch
    of key frames in one launch) are copied before it
    runs: the frontier maps and the lanes' level and recon slots (the rest
    is only read)."""

    def __init__(self):
        from svtav1_tpu_torch.pipeline import wavefront

        self.slots = wavefront.KEYS_LV + wavefront.KEYS_REC
        self.real = wavefront.commit_wave
        self.want = []
        wavefront.commit_wave = self

    def expect(self, *labels):
        self.want = list(labels)

    def state(self, cap):
        """A fresh copy of a captured launch's maps and lanes."""
        return ([[m.clone() for m in ms] for ms in cap["maps"]],
                {n: {k: (v.clone() if k in self.slots else v) for k, v in L.items()}
                 for n, L in cap["lanes"].items()})

    def __call__(self, src, maps, lanes, table, *args, **kw):
        inter = src[0].is_cuda and any(L["NI"] for L in lanes.values())
        for label in self.want if src[0].is_cuda else ():
            # "batch8": a batch of key frames, the others one frame each
            if (inter == (label in ("P", "B", "P10"))
                    and label.startswith("batch") == (src[0].shape[0] > 1)):
                cap = dict(src=src, maps=maps, lanes=lanes, table=table, args=args)
                cap["maps"], cap["lanes"] = self.state(cap)
                K16_CAPTURED[label] = cap
                if label != "B" or any(len(L["cmp"]) for L in lanes.values()):
                    self.want.remove(label)
                break
        return self.real(src, maps, lanes, table, *args, **kw)


def queued_ms(fn, reps):
    """Device ms per call of `reps` calls queued back to back between two
    CUDA events (median of 3), for launches long enough that the host
    enqueues the next before the card ends the last."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def k16_launches(torch, src, maps, lanes, table, args):
    """(this checkout's K16, the parent's K16 or None): functions that
    launch the kernel alone on descriptors uploaded once (the parent's
    entry point is this one's, from the --baseline-lib library)."""
    import numpy as np

    from svtav1_tpu_torch import kernels
    from svtav1_tpu_torch.pipeline import wavefront

    dq_dc, dq_ac, bd, tx_ntypes, lam, rdoq_qctx = args
    dev = src[0].device
    F, H, W = src[0].shape
    R8, C8 = H // 8, W // 8
    T = len(table.tasks)
    stream = kernels.stream_ptr(src[0])
    fd = wavefront._frame_desc(src, maps, lanes, tx_ntypes, rdoq_qctx, str(dev))
    parts = [fd, table.tasks, table.owner.ravel(), np.zeros(T + 1, np.int32)]
    blob = torch.as_tensor(np.concatenate([a.view(np.uint8) for a in parts]), device=dev)
    offs = [int(o) for o in np.cumsum([0] + [a.nbytes for a in parts[:-1]])]
    grid = wavefront.grid_of(table.max_n, T, 0)
    rdoq = int(rdoq_qctx is not None)

    def through(lib, label):
        def run():
            err = lib.commit_wave_launch(*(blob.data_ptr() + o for o in offs), T, F, R8, C8,
                                         dq_dc, dq_ac, bd, rdoq, float(lam), table.max_n, grid,
                                         stream)
            if err:
                raise SystemExit(f"{label}: cudaError {err}")
        return run

    return (through(kernels.lib(), "commit_wave"),
            through(BASELINE[0], "the parent's commit_wave") if BASELINE else None)


def check_commit_wave(torch, capture):
    """K16 against its plain version, the wave loop that launches K1, K2 and
    K5 per wave and size, on the 1080p schedules captured in phase 4: a
    fast key frame (no RDOQ: K2 fused), a medium key frame, a P frame of
    the low-delay GOP, a B frame of the random-access GOP and a P frame of
    the 10-bit low-delay GOP's key frame and first P frame ("key10",
    "P10", bd=10: the key frame's top-left task has neither neighbour, the
    DC of 1 << (bd - 1)). Levels,
    recon, frontier maps and skip map must be exact. Both phase-B times of
    this call (`ms`, the wrapper with its upload; `device_ms`, the launch
    alone), with --baseline-lib the parent's K16 on the same inputs of the
    8-bit schedules (equal results, `baseline_device_ms`), the waves and the dependency depth,
    one flag handoff between two CTAs (`handoff_ms`, median of 3) and the
    chain bound. Launch counts are restored after."""
    import numpy as np

    from svtav1_tpu_torch import kernels
    from svtav1_tpu_torch.pipeline import wavefront
    from svtav1_tpu_torch.utils.profile_keyframes import commit_wave_work

    saved = dict(kernels.launches)
    dev = torch.device("cuda", 0)
    handoff = statistics.median(wavefront.handoff_ms(dev) for _ in range(3))
    out = {}
    for label in ("fast", "key", "P", "B", "key10", "P10", "batch8"):
        cap = K16_CAPTURED.get(label)
        if cap is None:
            raise SystemExit(f"commit_wave: no {label} schedule reached K16 in phase 4")
        src, table, args = cap["src"], cap["table"], cap["args"]
        pm, pl = capture.state(cap)
        t_plain = time.perf_counter()
        wavefront.commit_wave_plain(src, pm, pl, table, *args)
        torch.cuda.synchronize()
        t_plain = (time.perf_counter() - t_plain) * 1e3

        def same(km, kl, name):
            """Max error against the wave loop's state; exits where unequal."""
            torch.cuda.synchronize()
            err = 0
            pairs = [(a, b) for ka, kb in zip(km, pm) for a, b in zip(ka, kb)]
            for n in kl:
                pairs += [(kl[n][k], pl[n][k]) for k in capture.slots]
                skip_k, skip_p = ((L["ly"].abs().sum((1, 2)) + L["lu"].abs().sum((1, 2))
                                   + L["lv"].abs().sum((1, 2))) == 0 for L in (kl[n], pl[n]))
                pairs.append((skip_k, skip_p))
            for a, b in pairs:
                if a.numel():
                    err = max(err, int((a.to(torch.int64) - b.to(torch.int64)).abs().max()))
                if not torch.equal(a, b):
                    raise SystemExit(f"{name} disagrees with the wave loop on the {label} "
                                     f"schedule (max err {err})")
            return err

        km, kl = capture.state(cap)
        capture.real(src, km, kl, table, *args)
        err = same(km, kl, "commit_wave")
        lm, ll = capture.state(cap)  # the launches alone, on a state of their own
        new, parent = k16_launches(torch, src, lm, ll, table, args)
        if args[2] != 8:  # the parent's K16 predates the DC of 1 << (bd - 1)
            parent = None
        if parent is not None:
            parent()
            err = max(err, same(lm, ll, "the parent's commit_wave"))
        km, kl = capture.state(cap)
        ms = timed_ms(lambda: capture.real(src, km, kl, table, *args), 5)
        # the wave loop over a batch of 8 key frames takes seconds: timed once
        plain_ms = (t_plain if label == "batch8" else
                    timed_ms(lambda: wavefront.commit_wave_plain(src, pm, pl, table, *args), 2))
        extra = dict(device_ms=queued_ms(new, 10))
        if parent is not None:
            extra["baseline_device_ms"] = queued_ms(parent, 10)
        work = commit_wave_work(table, args[3], args[5] is not None, handoff)
        b_ms, b_by = bound(work["bytes"], work["ops"])
        out[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                          handoff_ms=handoff, chain_ms=work["chain_ms"],
                          latency_bound_ms=max(b_ms, work["chain_ms"]), **extra)
        log(json.dumps(dict(phase="commit_wave", schedule=label, frames=int(src[0].shape[0]),
                            waves=len(table.waves),
                            depth=work["depth"], tasks=len(table.tasks),
                            edges=len(wavefront.predecessors(table)[1]),
                            max_tasks=table.max_tasks,
                            max_n=table.max_n, grid=wavefront.grid_of(table.max_n,
                                                                      len(table.tasks), 0),
                            rdoq=args[5] is not None, bytes=work["bytes"], ops=work["ops"],
                            tasks_by_size={str(n): int(np.sum(table.decode()[0] == i))
                                           for i, n in enumerate((8, 16, 32, 64))},
                            **out[label])))
    kernels.launches.clear()
    kernels.launches.update(saved)
    return out


class TxqCapture:
    """Copies the inputs of every K2 launch (transforms_torch._launch), K3
    launch (rate_torch.txb_bits), K9 launch (me_torch.subpel_pred_lanes) and
    K8 call (me_torch.me_pyramid, one launch; me_torch.me_fullpel_frame, two
    launches) made inside a frame's
    decide (device_decide.decide_intra_frames, inter_device._run_decide) or
    commit (device_commit.commit_regions: phase A; phase B is K16), keyed
    "key" or "P" by the frame. Used as a context manager around an encode."""

    def __init__(self):
        from svtav1_tpu_torch.codec import rate_torch
        from svtav1_tpu_torch.ops import me_torch
        from svtav1_tpu_torch.ops import transforms_torch as TT
        from svtav1_tpu_torch.pipeline import device_commit, device_decide, inter_device

        self.calls = {"key": [], "P": []}
        self.label = None
        self.patches = [(TT, "_launch", self._k2), (rate_torch, "txb_bits", self._k3),
                        (me_torch, "subpel_pred_lanes", self._k9),
                        (me_torch, "me_fullpel_frame", self._k8),
                        (me_torch, "me_pyramid", self._k8_pyramid)]
        for mod, name, stage, at in ((device_decide, "decide_intra_frames", "decide", 1),
                                     (inter_device, "_run_decide", "decide", 2),
                                     (device_commit, "commit_regions", "commit", 1)):
            self.patches.append((mod, name, self._staged(mod, name, stage, at)))
        self.real = {(m, a): getattr(m, a) for m, a, _ in self.patches}

    def __enter__(self):
        for m, a, f in self.patches:
            setattr(m, a, f)
        return self

    def __exit__(self, *exc):
        for m, a, _ in self.patches:
            setattr(m, a, self.real[(m, a)])

    def _staged(self, mod, name, stage, params_at):
        """mod.name with the frame's label set while it runs (its FrameParams
        is positional argument `params_at`)."""
        def run(*a, **k):
            self.label = ("key" if a[params_at].frame_is_intra else "P", stage)
            try:
                return self.real[(mod, name)](*a, **k)
            finally:
                self.label = None
        return run

    def _k2(self, stage, src, pred, va, ha, levels, coeff, recon, sse, *rest):
        from svtav1_tpu_torch.ops import transforms_torch as TT

        if self.label is not None:
            self.calls[self.label[0]].append(dict(
                kernel="txfm_quant_recon", stage=self.label[1], k2_stage=stage,
                src=None if src is None else src.clone(), pred=pred.clone(), va=va.clone(),
                ha=ha.clone(), lv_in=levels.clone() if stage == 2 else None,
                coeff=coeff is not None, recon=recon is not None, sse=sse is not None,
                rest=rest))
        self.real[(TT, "_launch")](stage, src, pred, va, ha, levels, coeff, recon, sse, *rest)

    def _k9(self, src_b, ref, ys, xs, mv_fp, which, bd, fast=False):
        from svtav1_tpu_torch.ops import me_torch

        if self.label is not None:
            self.calls[self.label[0]].append(dict(
                kernel="subpel_pred", stage=self.label[1],
                args=tuple(a.clone() for a in (src_b, ref, ys, xs, mv_fp)) + (which, bd, fast)))
        return self.real[(me_torch, "subpel_pred_lanes")](src_b, ref, ys, xs, mv_fp, which, bd,
                                                          fast=fast)

    def _k8(self, src_y, ref_y, sb_rows, sb_cols, **kw):
        from svtav1_tpu_torch.ops import me_torch

        if self.label is not None:
            pyr = kw.get("src_pyr")
            self.calls[self.label[0]].append(dict(
                kernel="me_sad", stage=self.label[1], args=(src_y.clone(), ref_y.clone(), sb_rows,
                                                           sb_cols),
                kw=dict(kw, src_pyr=None if pyr is None else tuple(p.clone() for p in pyr))))
        return self.real[(me_torch, "me_fullpel_frame")](src_y, ref_y, sb_rows, sb_cols, **kw)

    def _k8_pyramid(self, src_y, sb_rows, sb_cols, bd=8):
        from svtav1_tpu_torch.ops import me_torch

        if self.label is not None:
            self.calls[self.label[0]].append(dict(kernel="me_sad", stage=self.label[1],
                                                  pyramid=True,
                                                  args=(src_y.clone(), sb_rows, sb_cols, bd)))
        return self.real[(me_torch, "me_pyramid")](src_y, sb_rows, sb_cols, bd)

    def _k3(self, levels, tabs):
        from svtav1_tpu_torch.codec import rate_torch

        if self.label is not None:
            self.calls[self.label[0]].append(dict(kernel="txb_rate", stage=self.label[1],
                                                  levels=levels.clone(), tabs=tabs))
        return self.real[(rate_torch, "txb_bits")](levels, tabs)


def replay_k2(torch, c):
    """One captured K2 launch: (run(): the kernel's outputs, plain(): the
    plain version's, the same slots)."""
    from svtav1_tpu_torch.ops import transforms_torch as TT

    pred, src, va, ha = c["pred"], c["src"], c["va"], c["ha"]
    dq_dc, dq_ac, bd, rep = c["rest"]
    L, n = pred.shape[0], pred.shape[-1]
    adj, dev, i32 = min(n, 32), pred.device, torch.int32
    stage = c["k2_stage"]

    def run():
        lv = c["lv_in"] if stage == 2 else torch.empty((L, adj, adj), dtype=i32, device=dev)
        co = torch.empty((L, adj, adj), dtype=i32, device=dev) if c["coeff"] else None
        rec = torch.empty((L, n, n), dtype=i32, device=dev) if c["recon"] else None
        sse = torch.empty((L,), dtype=torch.int64, device=dev) if c["sse"] else None
        TT._launch(stage, src, pred, va, ha, lv, co, rec, sse, dq_dc, dq_ac, bd, rep)
        return [None if stage == 2 else lv, co, rec, sse]

    def plain():
        args = (va, ha, dq_dc, dq_ac, bd)
        if stage == 0:
            lv, rec, sse = TT.txfm_quant_recon_plain(src, pred, *args, rep=rep, want_sse=c["sse"])
            return [lv, None, rec if c["recon"] else None, sse]
        if stage == 1:
            lv, co = TT.txfm_quant_plain(src, pred, *args)
            return [lv, co if c["coeff"] else None, None, None]
        return [None, None, TT.recon_from_levels_plain(c["lv_in"], pred, *args), None]

    return run, plain


def check_captured(torch, bd=8):
    """K2, K3, K9 and K8 at every launch of the decide and commit phase A of
    a 1080p medium key frame and the first P frame of the main path (a fresh
    keyint=16 encoder, 2 frames; at bd=10 of the 10-bit GOP, on the 16-bit
    forms of K8 and K9): each launch (K8: the source's pyramid and
    each me_fullpel_frame call, its two launches) replayed on its own inputs
    through the kernel
    and its plain version (K3 within rtol 1e-5, atol 1e-3 bits; the others
    exact; K9's prediction also equal to K10 at its MV) and timed on the
    device (device_ms: no host time), its bound from its arguments; with
    --baseline-lib K2, K3, K8 and K9 also through the baseline library
    (`baseline_ms`, device time); K8's bounds and K9's also at the packed
    rates (`packed_bound_ms`; the baseline at 8 bits only, the parent
    having no 16-bit forms). One line per frame: launches, summed ms,
    bounds and ms - bound per kernel,
    and per distinct launch shape [shape, launches, ms, bound_ms,
    baseline_ms]. Launch counts are restored after."""
    from svtav1_tpu_torch import kernels
    from svtav1_tpu_torch.codec import rate_torch
    from svtav1_tpu_torch.ops import me_torch
    from svtav1_tpu_torch.pipeline.encoder import Encoder, EncoderConfig
    from svtav1_tpu_torch.utils.profile_keyframes import bound_ms, launch_bound

    saved = dict(kernels.launches)
    enc = Encoder(EncoderConfig(1920, 1080, bd=bd, **GOP), device="cuda")
    with TxqCapture() as cap:
        for f in clip_1080p(2, bd):
            enc.send_frame(*f)
        enc.flush()
    torch.cuda.synchronize()
    del enc
    real_launch = kernels.launch
    recorded = []

    def launch(name, *args):  # the C arguments of the replayed launches, for their bounds
        recorded.append((name, args))
        real_launch(name, *args)

    out = {}
    for label, calls in cap.calls.items():
        if not calls:
            raise SystemExit(f"decide capture: no K2 or K3 launch on the {label} frame")
        sums, shapes = {}, {}
        for c in calls:
            name, adst, extra = c["kernel"], None, {}
            if name == "txfm_quant_recon":
                run, plain = replay_k2(torch, c)
                L, n = c["pred"].shape[0], c["pred"].shape[-1]
                adst = (int(c["va"].sum()), int(c["ha"].sum()))
                shape = [c["stage"], "K2", c["k2_stage"], L, n, c["rest"][3],
                         "recon" if c["recon"] else "", "sse" if c["sse"] else "", *adst]

                def same(a, ref):
                    for x, y in zip(a, ref):
                        if x is not None:
                            assert_equal_cuda(torch, "txfm_quant_recon (captured)", x, y)
            elif name == "txb_rate":
                lv, tabs = c["levels"], c["tabs"]

                def run(lv=lv, tabs=tabs):
                    return rate_torch.txb_bits(lv, tabs)

                def plain(lv=lv, tabs=tabs):
                    return rate_torch.txb_bits_plain(lv, tabs)

                shape = [c["stage"], "K3", *lv.shape, tabs.tx_class]

                def same(a, ref):
                    k3_close("txb_rate (captured)", a, ref)
            elif name == "subpel_pred":
                args = c["args"]

                def run(args=args):
                    return me_torch.subpel_pred_lanes(*args[:7], fast=args[7])

                def plain(args=args):
                    return me_torch.subpel_pred_plain(*args[:7], fast=args[7])

                src_b = args[0]
                shape = [c["stage"], "K9", src_b.shape[0], src_b.shape[-1],
                         (5 if args[7] else 7) ** 2]

                def same(a, ref):
                    for x, y in zip(a, ref):
                        assert_equal_cuda(torch, "subpel_pred (captured)", x, y)
            elif c.get("pyramid"):  # me_sad: the source's pyramid, one launch
                args = c["args"]

                def run(args=args):
                    return me_torch.me_pyramid(*args)

                def plain(args=args):
                    src_y, sbr, sbc, _bd = args
                    H, W = me_torch._grid_dims(src_y, sbr, sbc)
                    l1 = me_torch.decimate2_plain(me_torch.edge_pad(src_y, H, W).to(torch.int32))
                    return l1, me_torch.decimate2_plain(l1)

                shape = [c["stage"], "K8", *args[0].shape, "pyramid, source"]

                def same(a, ref):
                    for x, y in zip(a, ref):
                        assert_equal_cuda(torch, "me_sad (captured)", x.to(torch.int32), y)
            else:  # me_sad: a whole me_fullpel_frame call
                args, kw = c["args"], c["kw"]

                def run(args=args, kw=kw):
                    return me_torch.me_fullpel_frame(*args, **kw)

                def plain(args=args, kw=kw):
                    return me_torch.me_fullpel_frame_plain(
                        *args, **{k: v for k, v in kw.items() if k != "bd"})

                shape = [c["stage"], "K8", *args[0].shape, f"{args[2]}x{args[3]} SBs"]

                def same(a, ref):
                    assert_equal_cuda(torch, "me_sad (captured)", a[1], ref[1])
                    for n in me_torch.SIZES:
                        assert_equal_cuda(torch, "me_sad (captured)", a[0][n], ref[0][n])
            ref = plain()
            recorded.clear()
            kernels.launch = launch
            try:
                got = run()
            finally:
                kernels.launch = real_launch
            same(got, ref)
            if name == "subpel_pred":  # the prediction is K10's MC at the MV
                mv, ys, xs, n = got[0], args[2], args[3], args[0].shape[-1]
                assert_equal_cuda(torch, "subpel_pred (captured) against mc_lanes", got[1],
                                  me_torch.mc_lanes(args[1], ys, xs, mv[:, 0] * 2, mv[:, 1] * 2,
                                                    n, n, args[5], args[6]))
            b_ms = sum(bound_ms(*launch_bound(nm, a, adst)) for nm, a in recorded)
            if name in ("subpel_pred", "me_sad"):  # at the measured packed rates, as phase 2
                extra["packed_bound_ms"] = sum(packed_bound_ms(nm, a) for nm, a in recorded)
            if name == "me_sad" and not c.get("pyramid"):
                extra["calls"] = 1
            t = kernel_times(run, lambda a: same(a, ref), 10, baseline=bd == 8)
            ms, base = t["device_ms"], t.get("baseline_device_ms", 0.0)
            rec = sums.setdefault(name, dict(launches=0, ms=0.0, bound_ms=0.0, baseline_ms=0.0))
            row = shapes.setdefault(json.dumps(shape), [0, 0.0, 0.0, 0.0])
            for k, v in (("launches", len(recorded)), ("ms", ms), ("bound_ms", b_ms),
                         ("baseline_ms", base), *extra.items()):
                rec[k] = rec.get(k, 0) + v
            for i, v in enumerate((len(recorded), ms, b_ms, base)):
                row[i] += v
        for name, rec in sums.items():
            rec["ms_minus_bound"] = rec["ms"] - rec["bound_ms"]
            if not BASELINE or bd != 8:
                del rec["baseline_ms"]
        out[label] = sums
        log(json.dumps(dict(phase="decide_capture", frame=label, bd=bd, kernels=sums,
                            shapes=[[json.loads(k)] + v for k, v in shapes.items()])))
    kernels.launches.clear()
    kernels.launches.update(saved)
    return out


def assert_equal_cuda(torch, name, a, b):
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        err = int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0
        raise SystemExit(f"{name}: kernel disagrees with its plain version (max err {err})")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: the port's smoke run needs one GPU", file=sys.stderr)
        return 2
    try:
        from svtav1_tpu_torch import kernels
    except ImportError as err:
        print(f"svtav1_tpu_torch not found next to chip_smoke.py: {err}", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if args and (len(args) != 2 or args[0] != "--baseline-lib"):
        print("usage: chip_smoke.py [--baseline-lib PATH]", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    seconds = {}
    t0 = time.perf_counter()
    kernels.lib()
    seconds["build"] = time.perf_counter() - t0
    if args:
        load_baseline(args[1])
    # per kernel entry: registers, spill store and load bytes, static shared bytes
    log(json.dumps(dict(phase="build", seconds=seconds["build"],
                        nvcc_seconds=kernels.build_seconds, library=kernels.LIB,
                        ptxas=kernels.ptxas_report())))

    def phase(name, fn, *args):
        t1 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t1
        return out

    capture = K16Capture()
    checks = phase("kernels", check_kernels, torch, dev)
    phase("conformance", conformance, torch)
    capture.expect("fast")
    phase("fast", run_path, torch, "fast", FAST, 1, FAST_KERNELS, False)
    capture.expect("key")
    phase("medium", run_path, torch, "medium", MEDIUM, 2, KEY_KERNELS, True)
    capture.expect("batch8")
    phase("all-intra batched", run_intra_batch, torch)
    capture.expect()
    phase("10-bit all-intra batched", run_intra_batch, torch, 10)
    capture.expect("P")
    launches = phase("low-delay GOP", run_gop, torch)
    capture.expect("B")
    ra_launches = phase("random-access GOP", run_random_access, torch)
    capture.expect("key10", "P10")
    ld10_launches = phase("10-bit low-delay GOP", run_gop, torch, 10)
    capture.expect()
    ra10_launches = phase("10-bit random-access GOP", run_random_access, torch, 10)
    k16 = phase("commit_wave", check_commit_wave, torch, capture)
    checks["commit_wave"] = k16["P"]
    phase("decide capture", check_captured, torch)
    phase("10-bit decide capture", check_captured, torch, 10)
    crf_launches = phase("CRF GOP", run_crf, torch)
    crf10_launches = phase("10-bit CRF GOP", run_crf, torch, 10)
    log(json.dumps(dict(phase="CRF GOP, 10 bits against 8",
                        **{k: [PATHS["1080p 10-bit CRF"][k], PATHS["1080p CRF"][k]]
                           for k in PATHS["1080p CRF"]})))
    phase("VBR GOP", run_vbr, torch)
    phase("film grain", run_film_grain, torch)
    phase("restoration", run_restoration, torch)
    phase("tiles", run_tiles, torch)
    phase("host mode decision", run_host_md, torch)
    phase("1080p decodes", decode_queued)

    smi = smi_line()
    # phase 2 again in short, so that the end of the output holds every number
    log(json.dumps({"phase2": CHECKS, "globalmv": GLOBALMV}))
    log(json.dumps(dict(phase="done", seconds=time.perf_counter() - t_start,
                        phase_seconds=seconds)))
    log(smi)
    table = []
    for name, (src, repl) in KERNEL_SOURCES.items():
        c = checks[name]
        used, path = ((crf_launches, "1080p CRF random-access GOP") if name in CRF_ONLY else
                      (crf10_launches, "1080p 10-bit CRF random-access GOP")
                      if name == "subpel_refine16" else
                      (ra_launches, "1080p random-access GOP") if name in RA_ONLY else
                      (ra10_launches, "1080p 10-bit random-access GOP")
                      if name in RA10_ONLY else
                      (ld10_launches, "1080p 10-bit low-delay GOP") if name in TEN_BIT else
                      (launches, "1080p low-delay GOP"))
        row = dict(name=name, route="cuda", source=src, replaces=repl,
                   launches=used[name], path=path,
                   max_abs_err=c["max_abs_err"], ms=c["ms"], plain_ms=c["plain_ms"],
                   bound_ms=c["bound_ms"], bound_by=c["bound_by"], library_ms=None)
        if name == "commit_wave":  # timed on a P frame's schedule of the main path
            row.update(schedule="1080p P frame", chain_ms=c["chain_ms"],
                       latency_bound_ms=c["latency_bound_ms"], device_ms=c["device_ms"])
        table.append(row)
    log(json.dumps({"kernels": table}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
