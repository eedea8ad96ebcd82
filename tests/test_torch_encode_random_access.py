"""The port's random-access GOPs end to end on the CPU (plain versions of
the kernels) against the JAX package's device path: a key frame and a
4-frame hierarchical-B mini-GoP (keyint=8, minigop=4: the hidden anchor 4,
then 2, 1 and 3 with LAST, GOLDEN and ALTREF references, compound
NEW_NEWMV candidates, show-existing TUs) at the default medium preset give
identical recon in coding order, identical TUs where a TU codes no
compound block (the compound-mode context map differs, ROADMAP queue 3),
the port's decoder reproduces every recon and displays every frame, and
libaom decodes the port's TUs to the shown frames. With MCTF the key frame and the
anchor are temporally filtered first (at qindex 100 one sample of the
filtered anchor lies exactly on a rounding half, test_torch_tf.py). All
random-access encodes sit in this file, so that their JAX programs compile
once in one worker; 122x90 has the aligned size 128x96 and reuses the
commit programs. Last, the random-access settings the Encoder refuses."""
import numpy as np
import pytest

from svtav1_tpu_torch.decode.decoder import Decoder
from svtav1_tpu_torch.pipeline import device_commit
from svtav1_tpu_torch.pipeline import encoder as port_enc
from svtav1_tpu_torch.utils.testclip import make_frames
from torch_encode_parity import check_libaom, displayed, gop_matches_jax_and_decodes

RA = dict(qindex=100, keyint=8, minigop=4, preset="medium")


@pytest.mark.parametrize("size, enable_tf", [((128, 96), False), ((128, 96), True),
                                             ((122, 90), False)])
def test_random_access_gop_matches_jax_and_decodes(size, enable_tf):
    gop_matches_jax_and_decodes(*size, dict(RA, enable_tf=enable_tf), 5)


def test_eight_frame_minigop_matches_jax_and_decodes():
    """A key frame and one 8-frame mini-GoP (keyint=16, minigop=8): three
    B layers (4; 2, 6; 1, 3, 5, 7), the second half predicting from the
    middle frame 4 and the anchor 8, with the DPB and the GM source cache
    pruned across the mini-GoP. At qindex 120 no frame's DLF search picks
    level 0 (see the next test)."""
    gop_matches_jax_and_decodes(128, 96, dict(RA, qindex=120, keyint=16, minigop=8), 9)


def test_deblocking_level_zero_frame_decodes(monkeypatch):
    """The same mini-GoP at qindex 100, port only: the DLF search of frame
    5 picks luma level 0, so its header codes no chroma level and a decoder
    filters no plane. The port then leaves the chroma unfiltered too, and
    every TU decodes to the encoder's recon, in the port's decoder and in
    libaom; the reference filters that chroma and its stream does not
    (ROADMAP queue 3). The mini-GoP's B frames code compound blocks, whose
    mode symbols need the spec's context map to decode in libaom."""
    picks = []
    real = device_commit._filter_device

    def spy(*args, **kw):
        out = real(*args, **kw)
        picks.append(kw["lf_search"][int(out[1][0, 4])])
        return out

    monkeypatch.setattr(device_commit, "_filter_device", spy)
    w, h = 128, 96
    enc = port_enc.Encoder(port_enc.EncoderConfig(w, h, **dict(RA, keyint=16, minigop=8)),
                           device="cpu")
    pkts = [p for f in make_frames(w, h, 9) for p in enc.send_frame(*f)] + enc.flush()
    assert 0 in picks[1:], picks
    dec = Decoder()
    recon_of, shown = {}, []
    for p in pkts:
        _, _, _, drec = dec.decode_tu(p.tu)
        if p.recon is not None:
            for i in range(3):
                np.testing.assert_array_equal(drec[i], p.recon[i],
                                              err_msg=f"frame {p.disp_idx} plane {i}")
            recon_of[p.disp_idx] = p.recon
        if p.shown_disp_idx is not None:
            shown.append(displayed(recon_of[p.shown_disp_idx], w, h))
    check_libaom([p.tu for p in pkts], shown)


@pytest.mark.parametrize("minigop", [3, 16])
def test_minigop_must_be_dyadic(minigop):
    with pytest.raises(ValueError, match="dyadic mini-GoPs of 1, 2, 4 or 8"):
        port_enc.Encoder(port_enc.EncoderConfig(64, 64, keyint=16, minigop=minigop),
                         device="cpu")


def test_encode_frame_refuses_random_access():
    """encode_frame codes one low-delay frame at a time; a mini-GoP's
    packets come out of send_frame and flush."""
    enc = port_enc.Encoder(port_enc.EncoderConfig(64, 64, **RA), device="cpu")
    plane = np.full((64, 64), 100, np.uint8)
    chroma = np.full((32, 32), 128, np.uint8)
    with pytest.raises(ValueError, match="low-delay"):
        enc.encode_frame(plane, chroma, chroma)
