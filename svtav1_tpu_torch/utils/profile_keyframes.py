"""Where the time of a key-frame encode goes on the card.

Encodes one warm frame, then N frames of the synthetic clip through
Encoder(device="cuda") in the slice configuration twice: untraced, for the
wall time, and under torch.profiler, for the device time. Prints one JSON
line: wall seconds per frame (untraced and traced: their difference is the
tracing cost), the device's busy share (the device-side kernel and copy
time of the traced frames, one stream, over the untraced wall time),
device milliseconds per frame of the busiest device functions, host seconds
per pipeline stage (utils.profiler, untraced), and the card's name and
power limit.

Run on a GPU machine from the repository root:
    python -m svtav1_tpu_torch.utils.profile_keyframes --width 1920 --height 1080 --frames 2
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--qindex", type=int, default=120)
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

    frames = make_frames(args.width, args.height, args.frames + 1, seed=args.seed)
    enc = Encoder(EncoderConfig(args.width, args.height, qindex=args.qindex, keyint=1,
                                preset="fast", enable_cdef=False), device="cuda")
    enc.encode_frame(*frames[0])
    torch.cuda.synchronize()
    n = args.frames

    def encode_all() -> float:
        t0 = time.perf_counter()
        for f in frames[1:]:
            enc.encode_frame(*f)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    profiler.reset()
    wall = encode_all()
    stages = {k: v / n for k, v in profiler.report().items()}
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(dict(
        size=[args.width, args.height], frames=n, wall_s_per_frame=wall / n,
        traced_wall_s_per_frame=traced_wall / n, device_busy_s_per_frame=busy_s / n,
        device_busy_share=(busy_s / wall) if busy_s else "not measured",
        device_ms_per_frame_by_kernel={k: v / 1e3 / n for k, v in top},
        host_stage_s_per_frame=stages,
        card=smi)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
