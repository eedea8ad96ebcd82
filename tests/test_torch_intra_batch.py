"""All-intra batching through the port's Encoder on the CPU, port only (the
JAX package compiles nothing here): with `intra_batch` frames queued and
coded as one batch (one decide, one commit, one filter pass over the
batch), every TU and recon equals the unbatched encode's, at 8 bits with
the filters on and off, at 10 bits, in two tiles, and with a partial last
batch; elsewhere `intra_batch` is ignored, as the reference ignores it.
Every stream decodes to its recon in the port's decoder and in libaom.

The reference holds its batched encode equal to its unbatched one
(tests/test_intra_batch.py), and the port's unbatched key frames equal the
reference's (test_torch_encode_intra.py, test_torch_encode_medium.py)."""
import numpy as np
import pytest

from svtav1_tpu_torch.pipeline import encoder as port_enc
from svtav1_tpu_torch.utils.testclip import make_frames
from torch_encode_parity import encode_all, gop_decodes

W, H = 128, 96
KEY = dict(qindex=120, keyint=1, preset="medium")


def _encode(cfg, frames, w=W, h=H):
    enc = port_enc.Encoder(port_enc.EncoderConfig(w, h, **cfg), device="cpu")
    return enc, encode_all(enc, frames)


def _same_packets(got, want):
    assert [(p.disp_idx, p.shown_disp_idx) for p in got] == [
        (p.disp_idx, p.shown_disp_idx) for p in want]
    for f, (a, b) in enumerate(zip(got, want)):
        assert a.tu == b.tu, f"TU {f}: {len(a.tu)} vs {len(b.tu)} bytes"
        for i in range(3):
            np.testing.assert_array_equal(a.recon[i], b.recon[i], err_msg=f"TU {f} plane {i}")


@pytest.mark.parametrize("cfg, bd", [
    (KEY, 8),
    (dict(KEY, enable_dlf=False, enable_cdef=False), 8),
    (dict(KEY, bd=10), 10),
], ids=["filters", "no_filters", "10bit"])
def test_batched_equals_unbatched(cfg, bd):
    frames = make_frames(W, H, 3, seed=2, bd=bd)
    enc, got = _encode(dict(cfg, intra_batch=3), frames)
    assert enc._batching
    _, want = _encode(cfg, frames)
    _same_packets(got, want)
    gop_decodes(got, W, H)


def test_partial_last_batch():
    """5 frames in batches of 2: the last frame is coded by flush, and the
    5 packets come in display order; encode_frame, which returns one
    frame's packet, refuses a batching encoder."""
    frames = make_frames(64, 64, 5, seed=5)
    enc = port_enc.Encoder(port_enc.EncoderConfig(64, 64, intra_batch=2, **KEY), device="cpu")
    with pytest.raises(ValueError, match="no intra batching"):
        enc.encode_frame(*frames[0])
    got, counts = [], []
    for f in frames:
        out = enc.send_frame(*f)
        counts.append(len(out))
        got += out
    assert counts == [0, 2, 0, 2, 0]
    last = enc.flush()
    assert [p.disp_idx for p in last] == [4]
    got += last
    assert [p.disp_idx for p in got] == list(range(5))
    _, want = _encode(KEY, frames, 64, 64)
    _same_packets(got, want)
    gop_decodes(got, 64, 64)


def test_two_tiles_batched():
    """Two tile columns at keyint=1 batch too: each tile region is decided
    and committed for the whole batch."""
    cfg = dict(KEY, tile_cols_log2=1)
    frames = make_frames(W, H, 2, seed=6)
    enc, got = _encode(dict(cfg, intra_batch=2), frames)
    assert enc._batching
    _, want = _encode(cfg, frames)
    _same_packets(got, want)
    gop_decodes(got, W, H)


@pytest.mark.parametrize("cfg", [
    dict(KEY, keyint=16),
    dict(KEY, rc_mode="cbr", target_kbps=300.0),
], ids=["keyint16", "cbr"])
def test_intra_batch_ignored(cfg):
    """With key frames every 16 frames, or under CBR, frames are not
    batched: the stream is the one without intra_batch."""
    frames = make_frames(64, 64, 3, seed=7)
    enc, got = _encode(dict(cfg, intra_batch=4), frames, 64, 64)
    assert not enc._batching
    _, want = _encode(cfg, frames, 64, 64)
    _same_packets(got, want)
    gop_decodes(got, 64, 64)
