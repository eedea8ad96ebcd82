"""Frames per second of the port's main path, run after run: the bench's
16-frame 1920x1080 clip (utils/testclip.make_frames, seed 0) with
keyint=16 at the medium preset (a key frame, then 15 low-delay P frames),
through send_frame + flush on a fresh Encoder(device="cuda") per run, after
a 2-frame warm run. Prints one JSON line: each run's frames/s, the median,
the bytes per frame and the Y-PSNR (equal in every run, or it exits 1), and
the card's name and power limit.

Host-bound runs vary a lot between calls, so compare two checkouts only in
one call, in turns. The script imports the package from the path, so it
times another checkout's package when run from there:
    python -m svtav1_tpu_torch.utils.gop_fps --runs 5
    cd OTHER && PYTHONPATH=. python PATH/TO/svtav1_tpu_torch/utils/gop_fps.py --runs 5
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from svtav1_tpu_torch.pipeline.encoder import Encoder, EncoderConfig
    from svtav1_tpu_torch.utils.testclip import make_frames

    W, H, N = 1920, 1080, 16
    frames = make_frames(W, H, N, seed=0)

    def encode(frames):
        enc = Encoder(EncoderConfig(W, H, qindex=120, keyint=16, preset="medium"), device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pkts = []
        for f in frames:
            pkts += enc.send_frame(*f)
        pkts += enc.flush()
        torch.cuda.synchronize()
        return pkts, time.perf_counter() - t0

    encode(frames[:2])
    fps, results = [], set()
    for _ in range(args.runs):
        pkts, secs = encode(frames)
        fps.append(N / secs)
        psnr = [10 * np.log10(255.0 ** 2 / max(float(np.mean(
            (p.recon[0][:H, :W].astype(np.float64) - frames[p.disp_idx][0]) ** 2)), 1e-12))
            for p in pkts]
        results.add((sum(len(p.tu) for p in pkts) / N, float(np.mean(psnr))))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    (bytes_per_frame, y_psnr), = results if len(results) == 1 else [(None, None)]
    print(json.dumps(dict(fps=fps, median_fps=statistics.median(fps),
                          bytes_per_frame=bytes_per_frame, y_psnr=y_psnr, card=smi)))
    return 0 if len(results) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
