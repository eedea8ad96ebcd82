"""Rate control in the port against svtav1_tpu's device path
(Encoder(mode_decision="jax")) on the CPU: one-pass CBR and VBR, two-pass
VBR with first-pass stats, and scene cuts, on low-delay GOPs at 128x96.
The streams must be identical TU for TU, the recon too, and the port's
decoder must reproduce every recon. Under these controllers each inter
frame is finished before the next one starts. Last, the targets that CBR
and VBR need."""
import numpy as np
import pytest
from torch_encode_parity import gop_matches_jax_and_decodes

from svtav1_tpu.pipeline import firstpass as ref_firstpass
from svtav1_tpu_torch.decode.decoder import Decoder
from svtav1_tpu_torch.entropy.bitstream import tu_frame_type
from svtav1_tpu_torch.pipeline import device_commit, firstpass
from svtav1_tpu_torch.pipeline import encoder as port_enc
from svtav1_tpu_torch.utils.testclip import make_frames

W, H = 128, 96
LD = dict(qindex=120, keyint=8, fps=30.0)
# Targets whose frames cross qindex buckets (the decide's and the rate
# tables' qctx: CBR 108-129, VBR 11-56 at 300 kbps) and where no frame's
# DLF search picks luma level 0: there the reference deblocks the chroma
# that the spec leaves unfiltered and the port does not (ROADMAP queue 3;
# tests/test_torch_encode_random_access.py holds such a frame to the
# decoder). CBR at 300 kbps picks level 0 in frames 2 and 5.
TARGET_KBPS = {"cbr": 20.0, "vbr": 300.0}


@pytest.mark.parametrize("rc_mode", ["cbr", "vbr"])
def test_one_pass_rate_control_matches_jax_and_decodes(rc_mode):
    got = gop_matches_jax_and_decodes(
        W, H, dict(LD, rc_mode=rc_mode, target_kbps=TARGET_KBPS[rc_mode]), 6)
    assert len({len(p.tu) for p in got}) > 1


def test_cbr_at_300_kbps_decodes(monkeypatch):
    """CBR at 300 kbps, port only: the DLF search of some P frames picks
    luma level 0, so their headers code no chroma level and a decoder
    filters no plane; the port leaves that chroma unfiltered too (the
    reference deblocks it, ROADMAP queue 3), and every TU decodes to the
    encoder's recon."""
    picks = []
    real = device_commit._filter_device

    def spy(*args, **kw):
        out = real(*args, **kw)
        picks.append(kw["lf_search"][int(out[1][0, 4])])
        return out

    monkeypatch.setattr(device_commit, "_filter_device", spy)
    enc = port_enc.Encoder(port_enc.EncoderConfig(W, H, rc_mode="cbr", target_kbps=300.0, **LD),
                           device="cpu")
    pkts = [p for f in make_frames(W, H, 6) for p in enc.send_frame(*f)] + enc.flush()
    assert 0 in picks, picks
    assert [p.disp_idx for p in pkts] == list(range(6))
    dec = Decoder()
    for p in pkts:
        _, _, _, drec = dec.decode_tu(p.tu)
        for i in range(3):
            np.testing.assert_array_equal(drec[i], p.recon[i],
                                          err_msg=f"frame {p.disp_idx} plane {i}")


def test_two_pass_vbr_matches_jax_and_decodes():
    """First-pass stats equal the reference collector's records, then the
    second pass's stream equals the reference's."""
    clip = make_frames(W, H, 6)
    col, ref_col = firstpass.FirstPassCollector(), ref_firstpass.FirstPassCollector()
    for y, _u, _v in clip:
        col.send_frame(y)
        ref_col.send_frame(y)
    assert col.records == ref_col.records
    gop_matches_jax_and_decodes(W, H, dict(LD, rc_mode="vbr", target_kbps=300.0,
                                           stats_in=col.records), 6, clip)


def test_scene_cut_codes_a_key_frame_at_the_cut():
    """Two different scenes spliced at frame 3 with keyint=1000: frame 3 is
    coded as a key frame (frame_type 0 in its frame header), with TUs
    identical to the reference's."""
    a, b = make_frames(W, H, 3, seed=0), make_frames(W, H, 3, seed=4)
    clip = a + [(255 - y, v, u) for y, u, v in b]
    got = gop_matches_jax_and_decodes(W, H, dict(qindex=120, keyint=1000, scene_cut=True), 6,
                                      clip)
    assert [tu_frame_type(p.tu) for p in got] == [0, 1, 1, 0, 1, 1]


@pytest.mark.parametrize("rc_mode", ["cbr", "vbr"])
def test_rate_control_needs_a_target(rc_mode):
    with pytest.raises(ValueError, match=f"{rc_mode} needs target_kbps"):
        port_enc.Encoder(port_enc.EncoderConfig(W, H, rc_mode=rc_mode, **LD), device="cpu")
    with pytest.raises(ValueError, match="unknown rc_mode"):
        port_enc.Encoder(port_enc.EncoderConfig(W, H, rc_mode="abr", **LD), device="cpu")
