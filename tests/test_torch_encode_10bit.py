"""The port's 10-bit encodes on the CPU (the plain versions of the kernels;
planes int16 on the device, as the reference stacks them).

- The reference's own 10-bit device clip (tests/test_10bit.py's `_clip10`:
  96x64, 4 frames, keyint=4, qindex 100, seed 7) through svtav1_tpu's
  Encoder(mode_decision="jax", bd=10) and the port: identical TUs and
  recon, decoded bit-exactly by the port's decoder and by libaom. The
  reference runs under two spec rules the port keeps (ROADMAP queue 3):
  DC with neither neighbour is 1 << (bd - 1), not 128, and a frame whose
  luma deblocking level is 0 keeps its chroma unfiltered. Its jitted
  programs are traced inside those rules; no other tier-1 test traces the
  reference's 10-bit pipeline at this size, so no earlier trace of the
  worker is reused (the comparison would fail if one were).
- Port-only clips, held by the port's decoder and libaom: random access
  with MCTF, the DC rule's clip, a two-tile key frame and two-pass VBR.
- A uint8 reference at 10 bits, and the 10-bit settings still outside the
  port, raise (the latter naming their ROADMAP items).
"""
from unittest import mock

import numpy as np
import pytest
import torch

from svtav1_tpu.pipeline import encoder as ref_enc
from svtav1_tpu_torch.codec.mvp import MiState
from svtav1_tpu_torch.constants.av1 import PredMode
from svtav1_tpu_torch.decode.decoder import Decoder
from svtav1_tpu_torch.ops import me_torch
from svtav1_tpu_torch.pipeline import encoder as port_enc
from svtav1_tpu_torch.pipeline.firstpass import FirstPassCollector
from svtav1_tpu_torch.utils.testclip import make_frames
from torch_encode_parity import (check_libaom, displayed, encode_all, gop_decodes,
                                 packets_decode, reference_with_spec_rules)


def _clip10(w, h, n, seed=7):
    """tests/test_10bit.py's 10-bit clip (random samples in 0..1023)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 1024, (h + 8 * n, w + 8 * n), np.int32)
    out = []
    for t in range(n):
        y = base[t : t + h, 2 * t : 2 * t + w].astype(np.int32)
        u = (base[t : t + h : 2, 2 * t : 2 * t + w : 2] // 2 + 256).astype(np.int32)
        v = (base[t : t + h : 2, 2 * t : 2 * t + w : 2] // 3 + 320).astype(np.int32)
        out.append((y, u, v))
    return out


def test_reference_10bit_clip_matches_jax_and_decodes():
    w, h = 96, 64
    cfg = dict(qindex=100, keyint=4, bd=10)
    ref = ref_enc.Encoder(ref_enc.EncoderConfig(width=w, height=h, mode_decision="jax", **cfg))
    port = port_enc.Encoder(port_enc.EncoderConfig(w, h, **cfg), device="cpu")
    dec = Decoder()
    tus, shown = [], []
    with reference_with_spec_rules(10) as level0:
        for f, (y, u, v) in enumerate(_clip10(w, h, 4)):
            want_tu, want_rec = ref.encode_frame(y, u, v)
            tu, rec = port.encode_frame(y, u, v)
            for i in range(3):
                np.testing.assert_array_equal(rec[i], np.asarray(want_rec[i]),
                                              err_msg=f"frame {f} plane {i}")
            assert tu == want_tu, f"frame {f}: {len(tu)} vs {len(want_tu)} bytes"
            dy, du, dv, drec = dec.decode_tu(tu)
            for i in range(3):
                np.testing.assert_array_equal(drec[i], rec[i], err_msg=f"decode {f} plane {i}")
            assert int(dy.max()) > 255
            tus.append(tu)
            shown.append(displayed(rec, w, h))
    assert level0[0] > 0  # the clip meets the level-0 rule (random samples)
    check_libaom(tus, shown)


def test_random_access_with_mctf_decodes():
    """A key frame and a mini-GoP of 4 with MCTF at 10 bits (64x64)."""
    w = h = 64
    frames = make_frames(w, h, 5, seed=3, bd=10)
    port = port_enc.Encoder(port_enc.EncoderConfig(w, h, qindex=120, keyint=32, minigop=4,
                                                   enable_tf=True, bd=10), device="cpu")
    pkts = encode_all(port, frames)
    assert sorted(p.disp_idx for p in pkts if p.disp_idx is not None) == list(range(5))
    gop_decodes(pkts, w, h)


def test_dc_with_no_neighbour_decodes():
    """A dark, nearly flat 64x64 10-bit frame: its top-left block codes DC
    with neither neighbour, predicted 512 (1 << (bd - 1)) as the decoders
    predict it. The block's mode is read back as the port's decoder parses
    it; libaom decodes the frame to the port's recon."""
    rng = np.random.default_rng(5)
    w = h = 64
    y = (40 + rng.integers(0, 3, (h, w))).astype(np.int32)
    u = (60 + rng.integers(0, 2, (h // 2, w // 2))).astype(np.int32)
    v = (50 + rng.integers(0, 2, (h // 2, w // 2))).astype(np.int32)
    port = port_enc.Encoder(port_enc.EncoderConfig(w, h, keyint=1, bd=10), device="cpu")
    tu, rec = port.encode_frame(y, u, v)
    parsed = []
    real = MiState.set_block

    def spy(self, mi_row, mi_col, bsize, mode, *a, **kw):
        parsed.append((mi_row, mi_col, mode))
        return real(self, mi_row, mi_col, bsize, mode, *a, **kw)

    with mock.patch.object(MiState, "set_block", spy):
        _, _, _, drec = Decoder().decode_tu(tu)
    assert parsed[0] == (0, 0, int(PredMode.DC_PRED))
    for i in range(3):
        np.testing.assert_array_equal(drec[i], rec[i], err_msg=f"plane {i}")
    check_libaom([tu], [displayed(rec, w, h)])


def test_two_tile_key_frame_and_two_pass_vbr_decode():
    """Port-only, 128x96 at 10 bits: a key frame in two tile columns, and a
    4-frame low-delay GOP with two-pass VBR from the first pass's stats."""
    w, h = 128, 96
    frames = make_frames(w, h, 4, seed=1, bd=10)
    tiles = port_enc.Encoder(port_enc.EncoderConfig(w, h, keyint=1, tile_cols_log2=1, bd=10),
                             device="cpu")
    pkts = encode_all(tiles, frames[:1])
    packets_decode(pkts, frames[:1])
    col = FirstPassCollector()
    for y, _u, _v in frames:
        col.send_frame(y)
    vbr = port_enc.Encoder(port_enc.EncoderConfig(w, h, keyint=8, rc_mode="vbr",
                                                  target_kbps=300.0, stats_in=col.records,
                                                  bd=10), device="cpu")
    pkts = encode_all(vbr, frames)
    assert len({len(p.tu) for p in pkts}) > 1
    packets_decode(pkts, frames)


def _refine_with_uint8_reference():
    z = torch.zeros((1, 16, 16), dtype=torch.int32)
    i = torch.zeros(1, dtype=torch.int32)
    me_torch.subpel_refine_lanes(z, torch.zeros((64, 64), dtype=torch.uint8), i, i,
                                 torch.zeros((1, 2), dtype=torch.int32), 0, 10)


@pytest.mark.parametrize("call, exc, match", [
    (_refine_with_uint8_reference, ValueError, "uint8 plane cannot hold 10-bit"),
], ids=["uint8_reference"])
def test_10bit_settings_outside_the_port_raise(call, exc, match):
    """CRF (10-bit TPL, K14's 16-bit form) and the tile encoders run at 10
    bits; a uint8 reference cannot hold 10-bit samples, so K14's wrapper
    refuses one."""
    with pytest.raises(exc, match=match):
        call()


@pytest.mark.parametrize("override", [dict(enable_restoration=True), dict(film_grain=10)],
                         ids=["restoration", "film_grain"])
def test_10bit_settings_encode(override):
    """Restoration and film grain at 10 bits: a key frame and a P frame
    that the port's decoder reproduces (with grain: the recon plus the
    grain), and libaom too."""
    frames = make_frames(64, 64, 2, seed=5, bd=10)
    enc = port_enc.Encoder(port_enc.EncoderConfig(64, 64, keyint=16, bd=10, **override),
                           device="cpu")
    gop_decodes(encode_all(enc, frames), 64, 64, grain="film_grain" in override)
