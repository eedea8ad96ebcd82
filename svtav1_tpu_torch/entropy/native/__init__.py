"""ctypes bindings for the native range encoder (entropy.c).

Compiles the shared library on first use (cached next to the source);
falls back to the pure-Python coder if no C compiler is available.
`NativeRangeEncoder` is byte-exact with entropy.range_coder.RangeEncoder
(tests/test_native_entropy.py enforces parity).
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(__file__)
_SO = os.path.join(_DIR, "libsvtav1_entropy.so")
_SRC = os.path.join(_DIR, "entropy.c")

_lib = None


def _build() -> bool:
    try:
        src_mtime = os.path.getmtime(_SRC)
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < src_mtime:
            # pid-unique tmp: concurrent builders (pytest-xdist workers)
            # must not write the same intermediate; os.replace is atomic
            tmp = f"{_SO}.{os.getpid()}.tmp"
            subprocess.run(["gcc", "-O3", "-shared", "-fPIC", _SRC, "-o", tmp],
                           check=True, capture_output=True)
            os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    if not _build():
        return None
    lib = ctypes.CDLL(_SO)
    lib.ec_create.restype = ctypes.c_void_p
    lib.ec_free.argtypes = [ctypes.c_void_p]
    lib.ec_encode_symbol.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.ec_encode_bool.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.ec_encode_literal.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int]
    lib.ec_done.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.ec_done.restype = ctypes.c_int64
    lib.ec_write_txb_body.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                                          ctypes.c_void_p] + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
    lib.ec_write_txb_body.restype = ctypes.c_int32
    _lib = lib
    return lib


def available() -> bool:
    return get_lib() is not None


def _ptr(arr: np.ndarray):
    assert arr.dtype == np.int32 and arr.flags["C_CONTIGUOUS"], (arr.dtype, arr.flags)
    return arr.ctypes.data_as(ctypes.c_void_p)


class NativeRangeEncoder:
    """Drop-in replacement for entropy.range_coder.RangeEncoder backed by C."""

    def __init__(self) -> None:
        self._lib = get_lib()
        assert self._lib is not None, "native entropy library unavailable"
        self._ec = self._lib.ec_create()

    def encode_symbol_n(self, symbol: int, icdf, nsyms: int) -> None:
        # icdf must be an int32 numpy array slice (contiguous); no update here
        # (callers that adapt use encode_symbol_update)
        a = np.ascontiguousarray(icdf[: nsyms + 1], np.int32)
        self._lib.ec_encode_symbol(self._ec, _ptr(a), nsyms, symbol, 0)

    def encode_symbol_update(self, symbol: int, icdf: np.ndarray, nsyms: int, update: bool) -> None:
        """Encode + (optionally) adapt icdf in place. icdf must be a
        C-contiguous int32 view of the frame-context table row."""
        self._lib.ec_encode_symbol(self._ec, _ptr(icdf), nsyms, symbol, int(update))

    def encode_bool_q15(self, bit: int, f: int) -> None:
        self._lib.ec_encode_bool(self._ec, bit, f)

    def encode_literal(self, value: int, nbits: int) -> None:
        self._lib.ec_encode_literal(self._ec, value, nbits)

    def write_txb_body(self, coeffs: np.ndarray, scan: np.ndarray, tx_class: int,
                       dc_sign_ctx: int, update: bool, eob_cdf: np.ndarray, eob_nsyms: int,
                       eob_extra_cdf: np.ndarray, base_eob_cdf: np.ndarray, base_cdf: np.ndarray,
                       br_cdf: np.ndarray, dc_sign_cdf_row: np.ndarray, off2d) -> int:
        h, w = coeffs.shape
        c = np.ascontiguousarray(coeffs, np.int32)
        off = _ptr(off2d) if off2d is not None else None
        return self._lib.ec_write_txb_body(
            self._ec, _ptr(c), w, h, _ptr(scan), tx_class, 0, 0, dc_sign_ctx, int(update),
            _ptr(eob_cdf), eob_nsyms, _ptr(eob_extra_cdf), _ptr(base_eob_cdf), _ptr(base_cdf),
            _ptr(br_cdf), _ptr(dc_sign_cdf_row), off)

    def done(self) -> bytes:
        cap = 1 << 24
        buf = (ctypes.c_uint8 * cap)()
        n = self._lib.ec_done(self._ec, buf, cap)
        assert n >= 0
        return bytes(buf[:n])

    def __del__(self):
        try:
            self._lib.ec_free(self._ec)
        except Exception:
            pass
