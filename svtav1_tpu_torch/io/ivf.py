"""IVF container for AV1 (app analog of reference Source/App/app_output_ivf.c)."""
from __future__ import annotations

import struct


def write_ivf(path: str, frames: list[bytes], w: int, h: int, fps=(30, 1)) -> None:
    with open(path, "wb") as f:
        f.write(b"DKIF")
        f.write(struct.pack("<HH4sHHIII", 0, 32, b"AV01", w, h, fps[0], fps[1], len(frames)))
        f.write(b"\x00" * 4)
        for i, data in enumerate(frames):
            f.write(struct.pack("<IQ", len(data), i))
            f.write(data)


def read_ivf(path: str):
    with open(path, "rb") as f:
        magic = f.read(4)
        assert magic == b"DKIF", magic
        hdr = f.read(24)
        _, hdrlen, fourcc, w, h, num, den, nframes = struct.unpack("<HH4sHHIII", hdr)
        f.read(hdrlen - 28)  # remainder of the fixed header (unused field)
        frames = []
        while True:
            fh = f.read(12)
            if len(fh) < 12:
                break
            size, _pts = struct.unpack("<IQ", fh)
            frames.append(f.read(size))
        return frames, w, h, (num, den)
