"""Y4M reader/writer (4:2:0, 8 or 10 bit) — app analog of reference
Source/App/app_input_y4m.c."""
from __future__ import annotations

import numpy as np


def read_y4m(path: str, max_frames: int | None = None):
    """-> (frames, width, height, fps, bd). frames = list of (y, u, v)
    uint8 (bd=8) or uint16 (bd=10) arrays."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"\n"):
            header += f.read(1)
        fields = header.decode().strip().split()
        assert fields[0] == "YUV4MPEG2"
        w = h = 0
        fps = (30, 1)
        bd = 8
        for tok in fields[1:]:
            if tok[0] == "W":
                w = int(tok[1:])
            elif tok[0] == "H":
                h = int(tok[1:])
            elif tok[0] == "F":
                num, den = tok[1:].split(":")
                fps = (int(num), int(den))
            elif tok[0] == "C":
                c = tok[1:]
                if not c.startswith("420"):
                    raise ValueError(f"only 4:2:0 supported, got {tok}")
                if c.endswith("p10"):
                    bd = 10
                elif c.endswith("p12"):
                    raise ValueError("12-bit unsupported in this profile")
        dtype = np.uint16 if bd > 8 else np.uint8
        bps = 2 if bd > 8 else 1
        frames = []
        while max_frames is None or len(frames) < max_frames:
            line = f.readline()
            if not line or not line.startswith(b"FRAME"):
                break
            y = np.frombuffer(f.read(w * h * bps), dtype).reshape(h, w)
            u = np.frombuffer(f.read(w * h // 4 * bps), dtype).reshape(h // 2, w // 2)
            v = np.frombuffer(f.read(w * h // 4 * bps), dtype).reshape(h // 2, w // 2)
            if y.size < w * h:
                break
            frames.append((y.copy(), u.copy(), v.copy()))
        return frames, w, h, fps, bd


def write_y4m(path: str, frames, w: int, h: int, fps=(30, 1), bd: int = 8) -> None:
    colorspace = "C420jpeg" if bd == 8 else "C420p10"
    dtype = np.uint8 if bd == 8 else np.uint16
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F{fps[0]}:{fps[1]} Ip A0:0 {colorspace}\n".encode())
        for y, u, v in frames:
            f.write(b"FRAME\n")
            f.write(np.asarray(y, dtype).tobytes())
            f.write(np.asarray(u, dtype).tobytes())
            f.write(np.asarray(v, dtype).tobytes())
