"""AV1 multi-symbol range (entropy) coder — Daala od_ec algorithm.

Implements the AV1-conformant boolean/multisymbol arithmetic coder:
  * `RangeEncoder` — encoder equivalent in behavior to the reference's
    Source/Lib/Codec/bitstream_unit.c:268-305 (svt_od_ec_encode_bool_q15 /
    svt_od_ec_encode_cdf_q15 / svt_od_ec_enc_done), re-implemented from the
    published Daala entropy-coder algorithm (AV1 spec sec. 8.2).
  * `RangeDecoder` — the matching decoder (AV1 spec 8.2.2-8.2.6 semantics),
    used as the in-repo conformance oracle for bitstream tests.
  * `update_cdf` — the normative CDF adaptation rule (AV1 spec 8.3.2).

CDF representation: "inverse CDF" arrays of length nsyms+1 in Q15 —
icdf[k] = 32768 - cdf[k] for k < nsyms-1, icdf[nsyms-1] = 0, icdf[nsyms] =
adaptation counter. This matches the layout in constants/data/default_cdfs.npz.

This Python implementation is the behavioral reference; the production coder
is the C++ implementation in entropy/native (same algorithm, same tests).
"""
from __future__ import annotations

import numpy as np

EC_PROB_SHIFT = 6
EC_MIN_PROB = 4
WINDOW = 32  # decoder window bits


class RangeEncoder:
    """Daala-style range encoder producing AV1-conformant arithmetic bitstreams."""

    def __init__(self) -> None:
        self.low = 0  # 32-bit window
        self.rng = 0x8000
        self.cnt = -9
        self.precarry: list[int] = []  # uint16 values; >255 encodes a carry

    # -- core interval update ------------------------------------------------

    def _normalize(self, low: int, rng: int) -> None:
        assert 0 < rng <= 65535
        d = 16 - rng.bit_length()
        c = self.cnt
        s = c + d
        if s >= 0:
            c += 16
            m = (1 << c) - 1
            if s >= 8:
                self.precarry.append((low >> c) & 0xFFFF)
                low &= m
                c -= 8
                m >>= 8
            self.precarry.append((low >> c) & 0xFFFF)
            s = c + d - 24
            low &= m
        self.low = (low << d) & 0xFFFFFFFF
        self.rng = rng << d
        self.cnt = s

    def encode_symbol(self, symbol: int, icdf) -> None:
        """Encode `symbol` with inverse-CDF `icdf` (len >= nsyms, trailing
        counter ignored). nsyms inferred from first zero entry."""
        # nsyms-1 = index of first 0 in icdf
        n = 0
        while icdf[n] != 0:
            n += 1
        self.encode_symbol_n(symbol, icdf, n + 1)

    def encode_symbol_n(self, symbol: int, icdf, nsyms: int) -> None:
        low = self.low
        r = self.rng
        N = nsyms - 1
        assert 0 <= symbol <= N
        fh = int(icdf[symbol]) if symbol < N else 0
        if symbol > 0:
            fl = int(icdf[symbol - 1])
            u = (((r >> 8) * (fl >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) + EC_MIN_PROB * (N - (symbol - 1))
            v = (((r >> 8) * (fh >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) + EC_MIN_PROB * (N - symbol)
            low += r - u
            r = u - v
        else:
            v = (((r >> 8) * (fh >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) + EC_MIN_PROB * (N - symbol)
            r -= v
        self._normalize(low, r)

    def encode_bool_q15(self, bit: int, f: int) -> None:
        """Encode one bool; f = Q15 probability that bit == 0."""
        self.encode_symbol_n(bit, (f, 0), 2)

    def encode_literal(self, value: int, nbits: int) -> None:
        """Raw bits, MSB first, p=1/2 each (spec: L(n))."""
        for i in range(nbits - 1, -1, -1):
            self.encode_bool_q15((value >> i) & 1, 16384)

    def done(self) -> bytes:
        """Flush: minimum bits such that any suffix decodes correctly."""
        low = self.low
        c = self.cnt
        s = 10 + c
        m = 0x3FFF
        e = ((low + m) & ~m) | (m + 1)
        pre = list(self.precarry)
        if s > 0:
            n = (1 << (c + 16)) - 1
            while True:
                pre.append((e >> (c + 16)) & 0xFFFF)
                e &= n
                s -= 8
                c -= 8
                n >>= 8
                if s <= 0:
                    break
        # carry propagation
        out = bytearray(len(pre))
        carry = 0
        for i in range(len(pre) - 1, -1, -1):
            v = pre[i] + carry
            out[i] = v & 0xFF
            carry = v >> 8
        assert carry == 0, "carry out of the front of the stream"
        return bytes(out)


LOTS_OF_BITS = 0x4000


class RangeDecoder:
    """Daala-style range decoder (AV1 spec 8.2 symbol decoding semantics)."""

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.bptr = 0
        self.dif = (1 << (WINDOW - 1)) - 1
        self.rng = 0x8000
        self.cnt = -15
        self._refill()

    def _refill(self) -> None:
        s = WINDOW - 9 - (self.cnt + 15)
        while s >= 0 and self.bptr < len(self.data):
            self.dif ^= self.data[self.bptr] << s
            self.cnt += 8
            s -= 8
            self.bptr += 1
        if self.bptr >= len(self.data):
            self.cnt = LOTS_OF_BITS
        assert self.dif < (1 << WINDOW)

    def _normalize(self, dif: int, rng: int, ret: int) -> int:
        assert rng <= 65535
        d = 16 - rng.bit_length()
        self.cnt -= d
        self.dif = (((dif + 1) << d) - 1) & ((1 << WINDOW) - 1)
        self.rng = rng << d
        if self.cnt < 0:
            self._refill()
        return ret

    def decode_symbol(self, icdf) -> int:
        n = 0
        while icdf[n] != 0:
            n += 1
        return self.decode_symbol_n(icdf, n + 1)

    def decode_symbol_n(self, icdf, nsyms: int) -> int:
        dif = self.dif
        r = self.rng
        N = nsyms - 1
        c = dif >> (WINDOW - 16)
        v = r
        ret = -1
        while True:
            ret += 1
            u = v
            fh = int(icdf[ret]) if ret < N else 0
            v = (((r >> 8) * (fh >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) + EC_MIN_PROB * (N - ret)
            if not (c < v):
                break
        assert v < u <= r
        r = u - v
        dif -= v << (WINDOW - 16)
        return self._normalize(dif, r, ret)

    def decode_bool_q15(self, f: int) -> int:
        return self.decode_symbol_n((f, 0), 2)

    def decode_literal(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            v = (v << 1) | self.decode_bool_q15(16384)
        return v


def update_cdf(icdf: np.ndarray, symbol: int, nsyms: int) -> None:
    """Normative CDF adaptation (AV1 spec 8.3.2), in-place on the icdf array
    (length nsyms+1; last element is the update counter)."""
    count = int(icdf[nsyms])
    speed = min(nsyms.bit_length() - 1, 2)  # Min(FloorLog2(N), 2)
    rate = 3 + (count > 15) + (count > 31) + speed
    tmp = 32768
    for i in range(nsyms - 1):
        if i == symbol:
            tmp = 0
        cur = int(icdf[i])
        if tmp < cur:
            icdf[i] = cur - ((cur - tmp) >> rate)
        else:
            icdf[i] = cur + ((tmp - cur) >> rate)
    if count < 32:
        icdf[nsyms] = count + 1
