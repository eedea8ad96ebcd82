"""Frames per second of the port's 1080p paths, run after run: the bench's
1920x1080 clip (utils/testclip.make_frames, seed 0) through send_frame +
flush on a fresh Encoder(device="cuda") per run, after a warm run of the
same configuration. The paths (`--path`, one or more, comma-separated):

    gop   16 frames, keyint=16, medium (a key frame, then 15 low-delay P
          frames: the main path; the default)
    key   16 key frames, medium (DLF, CDEF and RDOQ on)
    fast  16 key frames, fast, CDEF off
    vbr   the gop path under one-pass VBR at 1000 kbps
    crf   17 frames of random access (keyint=32, minigop=8, MCTF) under CRF
          with 16-frame lookahead windows
    gop10 the gop path at 10 bits (the 10-bit clip: the 8-bit clip << 2
          plus seeded low bits; int16 planes on the card)
    ra10  17 frames of random access (keyint=32, minigop=8, MCTF) at 10 bits

Prints one JSON line per path: each run's frames/s, the median and
quartiles, the bytes per frame and the Y-PSNR (equal in every run, or it
exits 1), each host stage's median seconds per run (utils/profiler.py),
and the card's name and power limit.

Host-bound runs vary a lot between calls, so compare two checkouts only in
one call, in turns. The script imports the package from the path, so it
times another checkout's package when run from there:
    python -m svtav1_tpu_torch.utils.gop_fps --runs 5 --path gop,key
    cd OTHER && PYTHONPATH=. python PATH/TO/svtav1_tpu_torch/utils/gop_fps.py --runs 5
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

MEDIUM = dict(qindex=120, preset="medium")
PATHS = {  # name -> (EncoderConfig arguments, frames)
    "gop": (dict(MEDIUM, keyint=16), 16),
    "key": (dict(MEDIUM, keyint=1), 16),
    "fast": (dict(qindex=120, keyint=1, preset="fast", enable_cdef=False), 16),
    "vbr": (dict(MEDIUM, keyint=16, rc_mode="vbr", target_kbps=1000.0, fps=30.0), 16),
    "crf": (dict(MEDIUM, keyint=32, minigop=8, rc_mode="crf", lookahead=16, enable_tf=True), 17),
    "gop10": (dict(MEDIUM, keyint=16, bd=10), 16),
    "ra10": (dict(MEDIUM, keyint=32, minigop=8, enable_tf=True, bd=10), 17),
}


def quartiles(xs) -> list:
    """[first quartile, median, third quartile] (statistics.quantiles,
    inclusive method)."""
    q = statistics.quantiles(xs, n=4, method="inclusive")
    return [q[0], statistics.median(xs), q[2]]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--path", default="gop",
                    help=f"comma-separated, of {', '.join(PATHS)}")
    args = ap.parse_args()
    names = args.path.split(",")
    unknown = [p for p in names if p not in PATHS]
    if unknown or args.runs < 2:
        ap.error(f"unknown paths {unknown}" if unknown else "--runs must be at least 2")

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from svtav1_tpu_torch.pipeline.encoder import Encoder, EncoderConfig
    from svtav1_tpu_torch.utils import profiler
    from svtav1_tpu_torch.utils.testclip import make_frames

    W, H = 1920, 1080
    n_max = max(PATHS[p][1] for p in names)
    clips = {bd: make_frames(W, H, n_max, seed=0, bd=bd)
             for bd in {PATHS[p][0].get("bd", 8) for p in names}}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()

    def encode(cfg, frames):
        enc = Encoder(EncoderConfig(W, H, **cfg), device="cuda")
        torch.cuda.synchronize()
        profiler.reset()
        t0 = time.perf_counter()
        pkts = []
        for f in frames:
            pkts += enc.send_frame(*f)
        pkts += enc.flush()
        torch.cuda.synchronize()
        return pkts, time.perf_counter() - t0, profiler.report()

    ok = True
    for name in names:
        cfg, n = PATHS[name]
        frames = clips[cfg.get("bd", 8)][:n]
        peak = float((1 << cfg.get("bd", 8)) - 1)
        encode(cfg, frames[: 3 if cfg.get("minigop", 1) > 1 else 2])
        fps, results, stages = [], set(), []
        for _ in range(args.runs):
            pkts, secs, st = encode(cfg, frames)
            fps.append(n / secs)
            stages.append(st)
            shown = [p for p in pkts if p.disp_idx is not None]
            psnr = [10 * np.log10(peak ** 2 / max(float(np.mean(
                (p.recon[0][:H, :W].astype(np.float64) - frames[p.disp_idx][0]) ** 2)), 1e-12))
                for p in shown]
            results.add((sum(len(p.tu) for p in pkts) / n, float(np.mean(psnr))))
        (bytes_per_frame, y_psnr), = results if len(results) == 1 else [(None, None)]
        ok &= len(results) == 1
        keys = sorted({k for st in stages for k in st})
        print(json.dumps(dict(path=name, fps=fps, median_fps=statistics.median(fps),
                              quartiles_fps=quartiles(fps), bytes_per_frame=bytes_per_frame,
                              y_psnr=y_psnr,
                              stage_median_s={k: statistics.median(st.get(k, 0.0) for st in stages)
                                              for k in keys},
                              card=smi)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
