"""MV difference coding (AV1 spec 5.11.31-34 read_mv / read_mv_component).

Encoder/decoder pair over the NmvContext CDF family, used for NEWMV.
Behavioral reference: Source/Lib/Codec/entropy_coding.c encode_mv_component
and the spec decode process. MVs are (row, col) in 1/8-pel units; with
allow_high_precision_mv = 0 the hp bit is inferred = 1 and all coded
components are even.
"""
from __future__ import annotations

from ..constants.av1 import MvJoint
from ..entropy.range_coder import update_cdf

CLASS0_SIZE = 2
MV_MAX_CLASS = 10


def _get_mv_class(z: int) -> tuple[int, int]:
    """mag-1 -> (class, offset)."""
    if z < 16:
        return 0, z
    c = min((z >> 3).bit_length() - 1, MV_MAX_CLASS)
    return c, z - (CLASS0_SIZE << (c + 2))


class MvCoder:
    def __init__(self, fc, update: bool = True, allow_hp: bool = False, force_int: bool = False):
        self.fc = fc
        self.update = update
        self.allow_hp = allow_hp
        self.force_int = force_int

    def _w(self, enc, cdf, s, n):
        enc.encode_symbol_n(s, cdf, n)
        if self.update:
            update_cdf(cdf, s, n)

    def _r(self, dec, cdf, n):
        s = dec.decode_symbol_n(cdf, n)
        if self.update:
            update_cdf(cdf, s, n)
        return s

    # ------------------------------------------------------------------ write

    def write_mv(self, enc, mv, pred) -> None:
        fc = self.fc
        dr = int(mv[0]) - int(pred[0])
        dc = int(mv[1]) - int(pred[1])
        joint = (int(dc != 0)) | (int(dr != 0) << 1)
        self._w(enc, fc["nmv_joints"], joint, 4)
        if dr != 0:
            self._write_component(enc, 0, dr)
        if dc != 0:
            self._write_component(enc, 1, dc)

    def _write_component(self, enc, comp: int, v: int) -> None:
        fc = self.fc
        sign = int(v < 0)
        mag = -v if sign else v
        mv_class, offset = _get_mv_class(mag - 1)
        d = offset >> 3
        fr = (offset >> 1) & 3
        hp = offset & 1
        self._w(enc, fc["nmv_sign"][comp], sign, 2)
        self._w(enc, fc["nmv_classes"][comp], mv_class, 11)
        if mv_class == 0:
            self._w(enc, fc["nmv_class0"][comp], d, 2)
        else:
            for i in range(mv_class):
                self._w(enc, fc["nmv_bits"][comp][i], (d >> i) & 1, 2)
        if not self.force_int:
            cdf = fc["nmv_class0_fp"][comp][d] if mv_class == 0 else fc["nmv_fp"][comp]
            self._w(enc, cdf, fr, 4)
        if self.allow_hp:
            cdf = fc["nmv_class0_hp"][comp] if mv_class == 0 else fc["nmv_hp"][comp]
            self._w(enc, cdf, hp, 2)

    # ------------------------------------------------------------------- read

    def read_mv(self, dec, pred) -> tuple[int, int]:
        fc = self.fc
        joint = self._r(dec, fc["nmv_joints"], 4)
        dr = self._read_component(dec, 0) if joint in (int(MvJoint.HZVNZ), int(MvJoint.HNZVNZ)) else 0
        dc = self._read_component(dec, 1) if joint in (int(MvJoint.HNZVZ), int(MvJoint.HNZVNZ)) else 0
        return int(pred[0]) + dr, int(pred[1]) + dc

    def _read_component(self, dec, comp: int) -> int:
        fc = self.fc
        sign = self._r(dec, fc["nmv_sign"][comp], 2)
        mv_class = self._r(dec, fc["nmv_classes"][comp], 11)
        if mv_class == 0:
            d = self._r(dec, fc["nmv_class0"][comp], 2)
        else:
            d = 0
            for i in range(mv_class):
                d |= self._r(dec, fc["nmv_bits"][comp][i], 2) << i
        if self.force_int:
            fr = 3
        else:
            cdf = fc["nmv_class0_fp"][comp][d] if mv_class == 0 else fc["nmv_fp"][comp]
            fr = self._r(dec, cdf, 4)
        if self.allow_hp:
            cdf = fc["nmv_class0_hp"][comp] if mv_class == 0 else fc["nmv_hp"][comp]
            hp = self._r(dec, cdf, 2)
        else:
            hp = 1
        if mv_class == 0:
            mag = ((d << 3) | (fr << 1) | hp) + 1
        else:
            mag = (CLASS0_SIZE << (mv_class + 2)) + ((d << 3) | (fr << 1) | hp) + 1
        return -mag if sign else mag
