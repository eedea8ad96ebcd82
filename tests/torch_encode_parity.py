"""Shared check of the port's key-frame encodes against the JAX package's
device path (svtav1_tpu's Encoder(mode_decision="jax")) on the CPU."""
import numpy as np
import torch

from svtav1_tpu.pipeline import encoder as ref_enc
from svtav1_tpu_torch.decode.decoder import Decoder
from svtav1_tpu_torch.pipeline import encoder as port_enc
from svtav1_tpu_torch.utils import aomdec
from svtav1_tpu_torch.utils.testclip import make_frames
from tools.make_test_video import make_frames as ref_make_frames

# The suite runs in several worker processes on a few cores, and every
# worker imports this module while it collects the tests. PyTorch's
# intra-op thread pool (one thread per core in every process) would
# oversubscribe the cores and spin; the port's plain versions run at test
# sizes, where one thread per process is faster.
torch.set_num_threads(1)


def matches_jax_and_decodes(w: int, h: int, cfg: dict) -> None:
    """Two frames of the synthetic clip through both encoders in `cfg`:
    identical TUs and recon, and the port's decoder reproduces the recon."""
    frames = make_frames(w, h, 2)
    for a, b in zip(frames, ref_make_frames(w, h, 2)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    ref = ref_enc.Encoder(ref_enc.EncoderConfig(w, h, mode_decision="jax", **cfg))
    port = port_enc.Encoder(port_enc.EncoderConfig(w, h, **cfg), device="cpu")
    dec = Decoder()
    for f, (y, u, v) in enumerate(frames):
        want_tu, want_rec = ref.encode_frame(y, u, v)
        tu, rec = port.encode_frame(y, u, v)
        for i in range(3):
            np.testing.assert_array_equal(rec[i], want_rec[i], err_msg=f"frame {f} plane {i}")
        assert tu == want_tu, f"frame {f}: {len(tu)} vs {len(want_tu)} bytes"
        dy, du, dv, drec = dec.decode_tu(tu)
        for i in range(3):
            np.testing.assert_array_equal(drec[i], rec[i], err_msg=f"decode frame {f} plane {i}")
        assert dy.shape == (h, w)


def gop_matches_jax_and_decodes(w: int, h: int, cfg: dict, frames: int, clip=None) -> list:
    """`frames` frames of the synthetic clip, or of `clip` when given (a key
    frame, then P frames when cfg["keyint"] > 1, or hierarchical-B
    mini-GoPs when cfg["minigop"] > 1) through both encoders with
    send_frame + flush: identical TUs and recon in coding order,
    show-existing TUs included, every frame shown once in display order;
    and the port's decoder, fed the TUs in order, reproduces every recon
    and displays each frame's recon. Returns the port's packets."""
    if clip is None:
        clip = make_frames(w, h, frames)
    ref = ref_enc.Encoder(ref_enc.EncoderConfig(w, h, mode_decision="jax", **cfg))
    port = port_enc.Encoder(port_enc.EncoderConfig(w, h, **cfg), device="cpu")
    want, got = [], []
    for y, u, v in clip:
        want += ref.send_frame(y, u, v)
        got += port.send_frame(y, u, v)
    want += ref.flush()
    got += port.flush()
    order = [(p.disp_idx, p.shown_disp_idx) for p in got]
    assert order == [(p.disp_idx, p.shown_disp_idx) for p in want]
    assert sorted(d for d, _ in order if d is not None) == list(range(frames))
    assert [s for _, s in order if s is not None] == list(range(frames))
    dec = Decoder()
    recon_of = {}
    for f, (a, b) in enumerate(zip(got, want)):
        assert a.tu == b.tu, f"TU {f}: {len(a.tu)} vs {len(b.tu)} bytes"
        dy, _, _, drec = dec.decode_tu(a.tu)
        if b.recon is None:
            assert a.recon is None and drec is None, f"TU {f}"
        else:
            for i in range(3):
                np.testing.assert_array_equal(a.recon[i], b.recon[i], err_msg=f"TU {f} plane {i}")
                np.testing.assert_array_equal(drec[i], a.recon[i], err_msg=f"decode TU {f} plane {i}")
            recon_of[a.disp_idx] = a.recon
        if a.shown_disp_idx is not None:
            np.testing.assert_array_equal(dy, recon_of[a.shown_disp_idx][0][:h, :w],
                                          err_msg=f"TU {f} shows frame {a.shown_disp_idx}")
    return got


def check_libaom(tus, shown) -> None:
    """libaom decodes the TUs to the shown planes bit for bit, where the
    host has it (it checks nothing otherwise): the count is printed."""
    checked = aomdec.verify_tus(tus, shown)
    print(f"libaom checked {checked} of {len(tus)} TUs"
          + ("" if aomdec.available() else " (libaom is not on this host)"))
    assert checked in (0, len(tus))


def encode_all(enc, frames) -> list:
    """The packets of `frames` through enc.send_frame + flush."""
    pkts = []
    for y, u, v in frames:
        pkts += enc.send_frame(y, u, v)
    return pkts + enc.flush()


def packets_decode(pkts, frames) -> None:
    """The port's decoder, and libaom where the host has it, reproduce
    every packet's recon; the shown planes have the frames' dims."""
    dec = Decoder()
    shown = []
    for f, pkt in enumerate(pkts):
        dy, du, dv, drec = dec.decode_tu(pkt.tu)
        for i in range(3):
            np.testing.assert_array_equal(drec[i], pkt.recon[i], err_msg=f"frame {f} plane {i}")
        assert dy.shape == frames[f][0].shape
        shown.append((dy, du, dv))
    check_libaom([p.tu for p in pkts], shown)
