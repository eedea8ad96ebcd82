"""Independent conformance oracle: decode AV1 with the system libaom
decoder (a ctypes binding of `libaom.so.3`, copied from svtav1_tpu's
utils/aomdec.py so that the port stands alone).

The repository's decoder and encoder share context helpers, so a spec
misreading common to both would decode "bit-exactly" and still be wrong;
libaom is a decoder written by others. This module decodes whole frames and
`verify_tus` compares them bit for bit with the encoder's recon. Where the
host has no libaom, `verify_tus` checks nothing and returns 0, so every
caller prints the count it returns. Reference analog: test/e2e_test/
RefDecoder (SVT verifies its streams against an independent decoder the
same way).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np

AOM_CODEC_OK = 0
AOM_IMG_FMT_I420 = 0x102
AOM_IMG_FMT_I42016 = 0x102 | 0x800


class _AomImage(ctypes.Structure):
    # aom_image_t, libaom 3.x (aom/aom_image.h)
    _fields_ = [
        ("fmt", ctypes.c_int),
        ("cp", ctypes.c_int),
        ("tc", ctypes.c_int),
        ("mc", ctypes.c_int),
        ("monochrome", ctypes.c_int),
        ("csp", ctypes.c_int),
        ("range", ctypes.c_int),
        ("w", ctypes.c_uint),
        ("h", ctypes.c_uint),
        ("bit_depth", ctypes.c_uint),
        ("d_w", ctypes.c_uint),
        ("d_h", ctypes.c_uint),
        ("r_w", ctypes.c_uint),
        ("r_h", ctypes.c_uint),
        ("x_chroma_shift", ctypes.c_uint),
        ("y_chroma_shift", ctypes.c_uint),
        ("planes", ctypes.POINTER(ctypes.c_ubyte) * 3),
        ("stride", ctypes.c_int * 3),
        ("bps", ctypes.c_int),
        ("temporal_id", ctypes.c_int),
        ("spatial_id", ctypes.c_int),
        ("user_priv", ctypes.c_void_p),
        ("img_data", ctypes.POINTER(ctypes.c_ubyte)),
        ("img_data_owner", ctypes.c_int),
        ("self_allocd", ctypes.c_int),
        ("metadata", ctypes.c_void_p),
        ("fb_priv", ctypes.c_void_p),
    ]


@functools.lru_cache(maxsize=1)
def _lib():
    for name in ("libaom.so.3", "libaom.so", ctypes.util.find_library("aom")):
        if not name:
            continue
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    return None


def available() -> bool:
    lib = _lib()
    return lib is not None and hasattr(lib, "aom_codec_av1_dx")


def verify_tus(tus, expected_shown) -> int:
    """Decode a list of TU byte strings through libaom and assert each shown
    frame equals the expected (y, u, v) int planes bit-exactly (display
    crop, display order). Returns the number of frames checked; 0 when
    libaom is unavailable (callers treat that as skip — the in-repo decoder
    comparison still runs). Reference analog: test/e2e_test/RefDecoder.h:30
    ("reference tool of conformance")."""
    if not available():
        return 0
    dec = AomDecoder()
    shown = []
    for tu in tus:
        shown.extend(dec.decode(tu))
    assert len(shown) == len(expected_shown), \
        f"libaom produced {len(shown)} frames, expected {len(expected_shown)}"
    for d, ((y, u, v), exp) in enumerate(zip(shown, expected_shown)):
        for pl, (got, want) in enumerate(zip((y, u, v), exp)):
            want = np.asarray(want, np.int32)
            got = got[: want.shape[0], : want.shape[1]]
            assert np.array_equal(got, want), \
                f"libaom mismatch frame {d} plane {pl}"
    return len(shown)


class AomDecoder:
    """Minimal stateful AV1 decoder over libaom's C API."""

    _CTX_BYTES = 256  # generous opaque aom_codec_ctx_t buffer

    def __init__(self):
        lib = _lib()
        assert lib is not None, "libaom not present"
        self._lib = lib
        lib.aom_codec_av1_dx.restype = ctypes.c_void_p
        iface = lib.aom_codec_av1_dx()
        self._ctx = ctypes.create_string_buffer(self._CTX_BYTES)
        # probe the dec ABI version (AOM_DECODER_ABI_VERSION is a macro mix)
        err = -1
        for ver in range(0, 40):
            err = lib.aom_codec_dec_init_ver(self._ctx, ctypes.c_void_p(iface),
                                             None, 0, ver)
            if err == AOM_CODEC_OK:
                break
        assert err == AOM_CODEC_OK, f"aom dec init failed ({err})"

    def decode(self, obu_bytes: bytes) -> list:
        """Decode one temporal unit -> list of (y, u, v) int32 planes
        (cropped to display size)."""
        lib = self._lib
        buf = (ctypes.c_ubyte * len(obu_bytes)).from_buffer_copy(obu_bytes)
        err = lib.aom_codec_decode(self._ctx, buf, len(obu_bytes), None)
        assert err == AOM_CODEC_OK, f"aom_codec_decode failed ({err})"
        out = []
        it = ctypes.c_void_p(None)
        lib.aom_codec_get_frame.restype = ctypes.POINTER(_AomImage)
        while True:
            img_p = lib.aom_codec_get_frame(self._ctx, ctypes.byref(it))
            if not img_p:
                break
            img = img_p.contents
            hbd = bool(img.fmt & 0x800)
            planes = []
            for pl in range(3):
                ss = 0 if pl == 0 else 1
                w = (img.d_w + ss) >> ss
                h = (img.d_h + ss) >> ss
                stride = img.stride[pl]
                nbytes = stride * ((h - 1) if h else 0) + w * (2 if hbd else 1)
                raw = ctypes.cast(img.planes[pl],
                                  ctypes.POINTER(ctypes.c_ubyte * nbytes)).contents
                arr = np.frombuffer(raw, np.uint16 if hbd else np.uint8)
                arr = np.lib.stride_tricks.as_strided(
                    arr, (h, w), (stride, 2 if hbd else 1))
                planes.append(arr.astype(np.int32))
            out.append(tuple(planes))
        return out
