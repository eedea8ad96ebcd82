#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (svtav1_tpu_torch) on one GPU.

Phases, each fatal on failure:
  1. build the CUDA kernels from svtav1_tpu_torch/csrc with nvcc (sm_90a);
  2. run each kernel and its plain PyTorch version on the card at the main
     path's shapes and hold them equal (K3: rtol 1e-5, atol 1e-3 bits);
  3. conformance: encode 2 CIF key frames on the card, decode them with the
     port's decoder (recon bit-identical); encode the same clip with
     device="cpu" and report the share of bytes that match;
  4. the main path: 1 warm + 4 timed 1920x1080 key frames through
     Encoder(device="cuda") in the slice configuration, with every kernel's
     launch count > 0, and the first TU decoded bit-exactly;
  5. the card's name and power limit, the kernel table, and last the
     device line.

Run: python3 chip_smoke.py   (needs one CUDA card, nvcc and gcc; exits
non-zero without a card or outside the repository).
"""
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
SLICE = dict(qindex=120, keyint=1, preset="fast", enable_cdef=False)


def log(msg):
    print(msg, flush=True)


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


def bound(nbytes, ops):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def check_kernels(torch, dev):
    """Phase 2. Returns {kernel: dict(max_abs_err, ms, plain_ms, bound_ms, bound_by)}."""
    import numpy as np

    from svtav1_tpu_torch.codec import rate_torch
    from svtav1_tpu_torch.constants.av1 import MAX_TXSIZE_RECT, TxType
    from svtav1_tpu_torch.filters import dlf_torch
    from svtav1_tpu_torch.ops import quantize as quant_ops
    from svtav1_tpu_torch.ops import transforms_torch as TT
    from svtav1_tpu_torch.pipeline import intra_device
    from svtav1_tpu_torch.pipeline.device_decide import BSIZE_BY_N, fc_for_qctx
    from svtav1_tpu_torch.constants.cdf import get_q_ctx

    g = np.random.default_rng(1)
    res = {}

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dtype).to(dev)

    def edges(B, n):
        above = t(g.integers(0, 256, (B, n)))
        left = t(g.integers(0, 256, (B, n)))
        tl = t(g.integers(0, 256, B))
        ha = t(g.random(B) < 0.9, torch.bool)
        hl = t(g.random(B) < 0.9, torch.bool)
        return above, left, tl, ha, hl

    def record(name, shape, err, ms, plain_ms, nbytes, ops, main=False):
        b_ms, b_by = bound(nbytes, ops)
        log(json.dumps(dict(check=name, shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by)))
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

    # ---- K1 intra_pred: decide n=8 over 1080p (all 7 modes), commit waves
    R8, C8 = 135, 240
    B = R8 * C8
    e = edges(B, 8)
    k = intra_device.predict(*e, 8)
    pl = intra_device.predict_plain(*e, 8)
    err = assert_equal("intra_pred", k, pl)
    record("intra_pred", [B, 7, 8, 8], err,
           timed_ms(lambda: intra_device.predict(*e, 8), 20),
           timed_ms(lambda: intra_device.predict_plain(*e, 8), 5),
           nbytes=B * (2 * 8 + 1) * 4 + 2 * B + B * 7 * 64 * 4, ops=B * 7 * 64 * 8, main=True)
    for n, lanes in ((8, R8), (4, 2 * R8), (32, 34), (16, 2 * 34)):  # luma/chroma wave lanes
        e = edges(lanes, n)
        mode = t(g.integers(0, 7, lanes))
        err = assert_equal("intra_pred", intra_device.predict(*e, n, mode=mode),
                           intra_device.predict_plain(*e, n, mode=mode))
        record("intra_pred", [lanes, n, n], err,
               timed_ms(lambda: intra_device.predict(*e, n, mode=mode), 20),
               timed_ms(lambda: intra_device.predict_plain(*e, n, mode=mode), 3),
               lanes * (2 * n + 2) * 4 + lanes * n * n * 4, lanes * n * n * 8)

    # ---- K2 txfm_quant_recon: decide n=8 x 7 modes (SSE), n=64 x 7, commit
    q = 120
    dq = (quant_ops.dc_q(q, 8), quant_ops.ac_q(q, 8))

    def k2_case(n, L, rep, flags, want_recon, want_sse, main=False, reps=20):
        """One K2 shape: kernel == plain, both timed; returns the levels."""
        src = t(g.integers(0, 256, (L // rep, n, n)))
        pred = (src.repeat_interleave(rep, 0) + t(g.integers(-30, 31, (L, n, n)))).clamp(0, 255) \
            .to(torch.int32).contiguous()
        if flags == "dct":
            va, ha = TT.tx_flags(int(TxType.DCT_DCT), L, dev)
        else:
            va, ha = t(g.random(L) < 0.5, torch.bool), t(g.random(L) < 0.5, torch.bool)
        args = (src, pred, va, ha, dq[0], dq[1], 8)
        kw = dict(rep=rep, want_recon=want_recon, want_sse=want_sse)
        out_k = TT.txfm_quant_recon(*args, **kw)
        out_p = TT.txfm_quant_recon_plain(*args, **kw)
        err = 0
        for a, b in zip(out_k, out_p):
            if a is not None:
                err = max(err, assert_equal("txfm_quant_recon", a, b))
        tabs = TT.tables_for(n, dev)
        nst = sum(len(v) for v in tabs.stages.values()) / max(len(tabs.stages), 1)
        ops = L * (4 * nst * n * n * 5 + 40 * n * n)
        adj = min(n, 32)
        nbytes = (L // rep + L) * n * n * 4 + L * adj * adj * 4 + \
            (L * n * n * 4 if want_recon else 0) + (8 * L if want_sse else 0) + 2 * L
        record("txfm_quant_recon", [L, n, n, rep, flags], err,
               timed_ms(lambda: TT.txfm_quant_recon(*args, **kw), reps),
               timed_ms(lambda: TT.txfm_quant_recon_plain(*args, **kw), 3), nbytes, ops, main=main)
        return out_k[0]

    lv8 = k2_case(8, B * 7, 7, "dct", False, True, main=True)
    k2_case(64, 16 * 30 * 7, 7, "dct", False, True)
    lv32 = k2_case(32, 33 * 60 * 7, 7, "dct", False, True)
    k2_case(8, R8, 1, "dct", True, False)          # commit luma wave
    k2_case(4, 2 * R8, 1, "sel", True, False)      # commit chroma wave (ADST4)
    k2_case(16, 2 * 60, 1, "sel", True, False)     # chroma of 32x32 blocks
    k2_case(64, 17, 1, "dct", True, False)         # 64x64 luma wave

    # ---- K3 txb_rate on real levels: 8x8 (decide n=8) and 32x32
    fc = fc_for_qctx(get_q_ctx(q))
    for n, lv, main in ((8, lv8, True), (32, lv32, False)):
        tx = int(MAX_TXSIZE_RECT[BSIZE_BY_N[n]])
        tabs = rate_torch.make_txb_bits_fn(fc, tx, int(TxType.DCT_DCT), 0, device=dev)
        a = rate_torch.txb_bits(lv, tabs)
        b = rate_torch.txb_bits_plain(lv, tabs)
        torch.cuda.synchronize()
        diff = (a - b).abs()
        err = float(diff.max().item())
        if not bool((diff <= 1e-3 + 1e-5 * b.abs()).all()):
            raise SystemExit(f"txb_rate: kernel disagrees with its plain version (max err {err})")
        L, nn = lv.shape[0], lv.shape[1] * lv.shape[2]
        record("txb_rate", [L, lv.shape[1], lv.shape[2]], err,
               timed_ms(lambda: rate_torch.txb_bits(lv, tabs), 20),
               timed_ms(lambda: rate_torch.txb_bits_plain(lv, tabs), 3),
               nbytes=L * nn * 4 + L * 4, ops=L * nn * 30, main=main)

    # ---- K4 dlf_edges: a full 1080p luma plane, both passes
    sm = g.choice([8, 16, 32, 64], (1, R8, C8), p=[0.5, 0.3, 0.15, 0.05]).astype(np.int32)
    base = g.integers(60, 190, (1, R8 + 1, C8 + 1))
    plane = np.repeat(np.repeat(base, 8, 1), 8, 2)[:, :1080, :1920] + g.integers(-2, 3, (1, 1080, 1920))
    pl = t(np.clip(plane, 0, 255))
    lim, blim, thr = dlf_torch._limits(18, 0)
    for tr in (False, True):
        flen = t(dlf_torch.flen_maps_from_sizes(sm, 0, tr))
        x = pl.transpose(1, 2) if tr else pl
        a = dlf_torch.filter_vertical_edges(x, flen, lim, blim, thr, 8)
        b = dlf_torch.filter_vertical_edges_plain(x, flen, lim, blim, thr, 8)
        err = assert_equal("dlf_edges", a, b)
        edges_on = int((flen > 0).sum().item()) * 4
        record("dlf_edges", [1, 1080, 1920, "horizontal" if tr else "vertical"], err,
               timed_ms(lambda: dlf_torch.filter_vertical_edges(x, flen, lim, blim, thr, 8), 20),
               timed_ms(lambda: dlf_torch.filter_vertical_edges_plain(x, flen, lim, blim, thr, 8), 3),
               nbytes=2 * pl.numel() * 4 + flen.numel() * 4, ops=edges_on * 150, main=not tr)
    return res


def conformance(torch):
    """Phase 3: CIF on the card, decoded bit-exactly; byte match vs CPU."""
    import numpy as np

    from svtav1_tpu_torch.decode.decoder import Decoder
    from svtav1_tpu_torch.pipeline.encoder import Encoder, EncoderConfig
    from svtav1_tpu_torch.utils.testclip import make_frames

    frames = make_frames(352, 288, 2, seed=0)
    tus = {}
    for dev in ("cuda", "cpu"):
        enc = Encoder(EncoderConfig(352, 288, **SLICE), device=dev)
        tus[dev] = [enc.encode_frame(*f) for f in frames]
    torch.cuda.synchronize()
    dec = Decoder()
    for i, (tu, rec) in enumerate(tus["cuda"]):
        _, _, _, drec = dec.decode_tu(tu)
        for p in range(3):
            if not np.array_equal(drec[p], rec[p]):
                raise SystemExit(f"CIF frame {i} plane {p}: decoder recon differs from the encoder's")
    same = sum(len(a) for (a, _), (b, _) in zip(tus["cuda"], tus["cpu"]) if a == b)
    total = sum(len(a) for a, _ in tus["cuda"])
    log(json.dumps(dict(phase="conformance", size=[352, 288], frames=len(frames),
                        decode_bit_exact=True, bytes_cuda=[len(a) for a, _ in tus["cuda"]],
                        bytes_cpu=[len(a) for a, _ in tus["cpu"]],
                        identical_tu_byte_share=same / total)))


def main_path(torch):
    """Phase 4: 1080p key frames through Encoder(device='cuda')."""
    import numpy as np

    from svtav1_tpu_torch import kernels
    from svtav1_tpu_torch.decode.decoder import Decoder
    from svtav1_tpu_torch.pipeline.encoder import Encoder, EncoderConfig
    from svtav1_tpu_torch.utils import profiler
    from svtav1_tpu_torch.utils.testclip import make_frames

    W, H, N = 1920, 1080, 4
    frames = make_frames(W, H, N + 1, seed=0)
    kernels.reset_launches()
    enc = Encoder(EncoderConfig(W, H, **SLICE), device="cuda")
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
    waves = profiler.counts().get("commit/wave", 0) / N
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise SystemExit(f"main path never launched: {missing}")
    psnr = []
    for (tu, rec), (y, _u, _v) in zip(out, frames[1:]):
        d = rec[0][:H, :W].astype(np.float64) - y
        mse = float((d * d).mean())
        psnr.append(10 * np.log10(255.0 ** 2 / max(mse, 1e-10)))
        if not all(np.isfinite(p).all() for p in rec):
            raise SystemExit("non-finite recon")
    t1 = time.perf_counter()
    _, _, _, drec = Decoder().decode_tu(first_tu)
    dec_s = time.perf_counter() - t1
    for p in range(3):
        if not np.array_equal(drec[p], first_rec[p]):
            raise SystemExit(f"1080p plane {p}: decoder recon differs from the encoder's")
    log(json.dumps(dict(phase="main_path", size=[W, H], frames_timed=N, warm_frame_s=warm_s,
                        fps=N / secs, seconds=secs,
                        bytes_per_frame=sum(len(tu) for tu, _ in out) / N,
                        y_psnr=sum(psnr) / N, waves_per_frame=waves,
                        launches=launches,
                        launches_per_frame={k: v / (N + 1) for k, v in launches.items()},
                        stage_seconds=stages, decode_1080p_s=dec_s, decode_bit_exact=True)))
    return launches


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
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    kernels.lib()
    log(json.dumps(dict(phase="build", seconds=time.perf_counter() - t0,
                        nvcc_seconds=kernels.build_seconds, library=kernels.LIB)))

    checks = check_kernels(torch, dev)
    conformance(torch)
    launches = main_path(torch)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode:
        raise SystemExit(f"nvidia-smi failed: {smi.stderr}")
    log(smi.stdout.strip().splitlines()[0])
    meta = {
        "intra_pred": ("svtav1_tpu_torch/csrc/intra_pred.cu", "svtav1_tpu/pipeline/intra_device.py:31"),
        "txfm_quant_recon": ("svtav1_tpu_torch/csrc/txfm_quant_recon.cu",
                             "svtav1_tpu/ops/transforms_jax.py:136"),
        "txb_rate": ("svtav1_tpu_torch/csrc/txb_rate.cu", "svtav1_tpu/codec/rate_jax.py:57"),
        "dlf_edges": ("svtav1_tpu_torch/csrc/dlf_edges.cu", "svtav1_tpu/filters/dlf_jax.py:64"),
    }
    table = []
    for name, (src, repl) in meta.items():
        c = checks[name]
        table.append(dict(name=name, route="cuda", source=src, replaces=repl,
                          launches=launches[name], max_abs_err=c["max_abs_err"], ms=c["ms"],
                          plain_ms=c["plain_ms"], bound_ms=c["bound_ms"], bound_by=c["bound_by"],
                          library_ms=None))
    log(json.dumps({"kernels": table}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
