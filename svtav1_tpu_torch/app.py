"""Command-line encoder of the PyTorch port, the counterpart of svtav1_tpu's
app.py (itself the analog of the reference's Source/App SvtAv1EncApp).

Usage: python -m svtav1_tpu_torch.app -i input.y4m -b output.ivf [-q 120]
       [-n N] [--md jax|numpy] [--keyint K] [--minigop 1|2|4|8] [--enable-tf]
       [--preset P] [--rc cqp|cbr|vbr|crf] [--tbr KBPS] [--lookahead N] [--scd]
       [--pass 1|2 --stats FILE] [--recon recon.y4m] [--verify]
       [--device cuda|cpu] [-c config.cfg]

The flags are the reference CLI's, with two differences: `--md` defaults
to `jax`, the device route, where the reference's defaults to `numpy`,
the host mode decision (both values mean what they mean there), and
`--device` picks the device (CUDA by default; `cpu` runs the kernels'
plain PyTorch versions). `--verify` decodes every TU with the port's decoder and requires its recon
to equal the encoder's. `--pass 1 --stats FILE` runs the first-pass
analysis only and writes its stats; `--pass 2 --stats FILE` (with
`--rc vbr --tbr KBPS`) encodes with them.
"""
from __future__ import annotations

import argparse
import re
import sys
import time

import numpy as np

from .decode.decoder import Decoder
from .io.ivf import write_ivf
from .io.y4m import read_y4m, write_y4m
from .kernels import resolve_device
from .pipeline.encoder import Encoder, EncoderConfig
from .pipeline.firstpass import FirstPassCollector, read_stats
from .utils import metrics


def _parse_mastering(s: str):
    """Reference --mastering-display format:
    G(x,y)B(x,y)R(x,y)WP(x,y)L(max,min) (app_config.c token)."""
    m = re.match(r"G\(([^)]+)\)B\(([^)]+)\)R\(([^)]+)\)WP\(([^)]+)\)L\(([^)]+)\)", s)
    if not m:
        raise ValueError(f"bad mastering-display string: {s}")
    g, b, r, wp, lum = (tuple(float(v) for v in grp.split(",")) for grp in m.groups())
    return ((r, g, b), wp, lum[0], lum[1])


def _expand_config_file(argv):
    """-c/--config FILE: 'key: value' or 'key = value' lines become --key
    value tokens before the command line (the command line overrides the
    file, as in the reference app's read_config_file)."""
    out = []
    i = 0
    argv = list(argv)
    while i < len(argv):
        if argv[i] in ("-c", "--config") and i + 1 < len(argv):
            cfg_tokens = []
            with open(argv[i + 1]) as f:
                for line in f:
                    line = line.split("#")[0].strip()
                    if not line:
                        continue
                    for sep in (":", "="):
                        if sep in line:
                            k, v = line.split(sep, 1)
                            break
                    else:
                        k, v = line, ""
                    k = k.strip().lstrip("-")
                    cfg_tokens += [f"--{k}"] + ([v.strip()] if v.strip() else [])
            out = cfg_tokens + out
            i += 2
            continue
        out.append(argv[i])
        i += 1
    return out


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="svtav1-tpu-torch",
                                 description="AV1 encoder on PyTorch and CUDA")
    ap.add_argument("-i", "--input", required=True, help="input .y4m")
    ap.add_argument("-b", "--output", required=True, help="output .ivf")
    ap.add_argument("-q", "--qindex", type=int, default=120, help="base_q_idx (0-255)")
    ap.add_argument("-n", "--frames", type=int, default=None, help="max frames")
    ap.add_argument("--recon", default=None, help="write decoder-checked recon .y4m")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs the plain PyTorch versions)")
    ap.add_argument("--md", default="jax", choices=["jax", "numpy"],
                    help="mode decision: jax = the device route, numpy = the host route")
    ap.add_argument("--keyint", type=int, default=1, help="key frame interval (1 = all-intra)")
    ap.add_argument("--minigop", type=int, default=1, choices=[1, 2, 4, 8],
                    help="mini-GoP size (1 = low-delay, >1 = hierarchical-B)")
    ap.add_argument("--rc", default="cqp", choices=["cqp", "cbr", "crf", "vbr"],
                    help="rate control mode (crf = TPL r0 q assignment, vbr = bits/MB model)")
    ap.add_argument("--enable-tf", action="store_true",
                    help="MCTF temporal filtering of key frames and mini-GoP anchors")
    ap.add_argument("--enable-restoration", action="store_true",
                    help="loop restoration (Wiener/SGR per-unit RDO)")
    ap.add_argument("--no-rdoq", action="store_true", help="disable device RDOQ")
    ap.add_argument("--tile-columns", type=int, default=0, help="log2 tile columns")
    ap.add_argument("--tile-rows", type=int, default=0, help="log2 tile rows")
    ap.add_argument("--tbr", type=float, default=0.0, help="CBR/VBR target bitrate (kbit/s)")
    ap.add_argument("--lookahead", type=int, default=16, help="CRF TPL window (frames)")
    ap.add_argument("--scd", action="store_true", help="scene change detection (adaptive keys)")
    ap.add_argument("--intra-batch", type=int, default=1,
                    help="device all-intra frame batch (keyint 1, cqp)")
    ap.add_argument("--verify", action="store_true",
                    help="decode each frame and verify recon match")
    ap.add_argument("--preset", default="medium", choices=["fast", "medium", "slow"],
                    help="speed/quality preset")
    ap.add_argument("--pass", dest="enc_pass", type=int, default=0, choices=[0, 1, 2],
                    help="multi-pass: 1 = collect stats, 2 = encode with stats")
    ap.add_argument("--stats", default=None, help="first-pass stats file")
    ap.add_argument("--film-grain", type=int, default=0, metavar="N",
                    help="film grain synthesis level 1..50 (0 = off)")
    ap.add_argument("--fgs-table", default=None, metavar="FILE",
                    help="explicit aomenc 'filmgrn1' film grain table")
    ap.add_argument("--content-light", default=None,
                    help="HDR CLL metadata: max_cll,max_fall")
    ap.add_argument("--mastering-display", default=None,
                    help="HDR MDCV metadata: G(x,y)B(x,y)R(x,y)WP(x,y)L(max,min)")
    return ap


def main(argv=None) -> int:
    argv = _expand_config_file(sys.argv[1:] if argv is None else argv)
    ap = _parser()
    args = ap.parse_args(argv)
    if not 1 <= args.qindex <= 255:
        # qindex 0 is CodedLossless: the spec then omits lf/cdef/tx_mode
        # syntax (5.9.11/5.9.14/5.9.19) which this writer emits unconditionally
        ap.error(f"--qindex must be in [1, 255], got {args.qindex}")
    if args.enc_pass and not args.stats:
        ap.error(f"--pass {args.enc_pass} needs --stats FILE")
    try:
        device = resolve_device(args.device)
    except RuntimeError:
        print("error: svtav1_tpu_torch.app needs CUDA and finds no CUDA device; --device cpu "
              "runs the plain PyTorch versions of the kernels", file=sys.stderr)
        return 2
    try:
        frames, w, h, fps, bd = read_y4m(args.input, args.frames)
    except (OSError, ValueError) as e:
        print(f"error reading {args.input}: {e}", file=sys.stderr)
        return 1
    if not frames:
        print("no frames read", file=sys.stderr)
        return 1
    if args.enc_pass == 1:
        # pass 1: the analysis only (the reference short-circuits EncDec)
        col = FirstPassCollector()
        for (y, _u, _v) in frames:
            col.send_frame(y)
        col.write_stats(args.stats)
        print(f"pass 1: wrote {len(frames)} frame stats to {args.stats}")
        return 0
    stats_in = read_stats(args.stats) if args.enc_pass == 2 else None
    cll = tuple(int(v) for v in args.content_light.split(",")) if args.content_light else None
    mdcv = _parse_mastering(args.mastering_display) if args.mastering_display else None
    enc = Encoder(EncoderConfig(width=w, height=h, qindex=args.qindex, mode_decision=args.md,
                                keyint=args.keyint, minigop=args.minigop, bd=bd, rc_mode=args.rc,
                                target_kbps=args.tbr, fps=fps[0] / max(fps[1], 1),
                                lookahead=args.lookahead, stats_in=stats_in,
                                scene_cut=args.scd, intra_batch=args.intra_batch,
                                enable_tf=args.enable_tf,
                                enable_restoration=args.enable_restoration,
                                enable_rdoq=not args.no_rdoq, tile_cols_log2=args.tile_columns,
                                tile_rows_log2=args.tile_rows, preset=args.preset,
                                film_grain=args.film_grain, film_grain_table=args.fgs_table,
                                content_light=cll, mastering_display=mdcv), device=device)
    check = args.verify or args.recon
    dec = Decoder()
    tus, recons = [], []
    total_psnr = 0.0
    n_shown = 0

    def handle(pkt):
        nonlocal total_psnr, n_shown
        tus.append(pkt.tu)
        if not check:
            label = (f"coded {pkt.disp_idx}" if pkt.disp_idx is not None
                     else f"show {pkt.shown_disp_idx}")
            print(f"{label}: {len(pkt.tu)} bytes")
            return
        dy, du, dv, drecon = dec.decode_tu(pkt.tu)
        if pkt.recon is not None:
            for pl in range(3):
                if not np.array_equal(pkt.recon[pl], drecon[pl]):
                    raise RuntimeError(f"frame {pkt.disp_idx} plane {pl}: the decoder's recon "
                                       "differs from the encoder's")
        if dy is not None:
            if pkt.shown_disp_idx != n_shown:
                raise RuntimeError(f"TU shows frame {pkt.shown_disp_idx}, expected {n_shown}")
            y = frames[n_shown][0]
            dt = np.uint8 if bd == 8 else np.uint16
            recons.append((dy.astype(dt), du.astype(dt), dv.astype(dt)))
            psnr = metrics.psnr(y, dy, bd)
            ssim = metrics.ssim(y, dy, bd)
            total_psnr += psnr
            n_shown += 1
            print(f"frame {n_shown - 1}: {len(pkt.tu)} bytes, Y-PSNR {psnr:.2f} dB, "
                  f"SSIM {ssim:.4f}")

    t0 = time.time()
    for (y, u, v) in frames:
        for pkt in enc.send_frame(y, u, v):
            handle(pkt)
    for pkt in enc.flush():
        handle(pkt)
    dt = time.time() - t0
    write_ivf(args.output, tus, w, h, fps)
    if args.recon:
        write_y4m(args.recon, recons, w, h, fps, bd=bd)
    kb = sum(len(t) for t in tus) / 1000.0
    nf = len(frames)
    print(f"encoded {nf} frames ({len(tus)} TUs) {w}x{h} on {device} in {dt:.2f}s "
          f"({nf / dt:.2f} fps), {kb:.1f} kB", end="")
    if check:
        print(f", avg Y-PSNR {total_psnr / nf:.2f} dB", end="")
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
