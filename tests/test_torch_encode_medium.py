"""The port's key frames at the default medium preset end to end on the CPU
(plain versions of the kernels) against the JAX package's device path: 13
intra modes, the luma tx-type search, RDOQ, the DLF level search and the
7-candidate CDEF search. Identical TUs and recon, and the port's decoder
and libaom reproduce the recon (the reference with the spec's deblocking
rule at the display edge, torch_encode_parity); a 202x122 clip whose
display edge once decoded otherwise in libaom; slow codes key frames like
medium."""
import numpy as np
import pytest

from svtav1_tpu_torch.pipeline import encoder as port_enc
from svtav1_tpu_torch.utils.testclip import make_frames
from torch_encode_parity import encode_all, matches_jax_and_decodes, packets_decode

MEDIUM = dict(qindex=120, keyint=1, preset="medium")


@pytest.mark.parametrize("size", [(128, 96), (202, 122)])
def test_medium_matches_jax_and_decodes(size):
    matches_jax_and_decodes(*size, MEDIUM)


def test_display_edge_deblocking_decodes_in_libaom():
    """202x122 key frames of the clip with seed 3, port only: deblocking
    leaves the edge segments outside the displayed frame unfiltered (spec
    7.14.2), so CDEF in the last 8x8 column and row reads the samples that
    libaom reads (the luma at (112, 200) of frame 0 once differed), and
    both decoders reproduce the recon."""
    frames = make_frames(202, 122, 2, seed=3)
    enc = port_enc.Encoder(port_enc.EncoderConfig(202, 122, **MEDIUM), device="cpu")
    packets_decode(encode_all(enc, frames), frames)


def test_slow_codes_key_frames_like_medium():
    """slow differs from medium only in inter-frame speed features."""
    w, h = 96, 64
    frames = make_frames(w, h, 1, seed=5)
    tus = {}
    for preset in ("medium", "slow"):
        enc = port_enc.Encoder(port_enc.EncoderConfig(w, h, **dict(MEDIUM, preset=preset)),
                               device="cpu")
        tus[preset] = [enc.encode_frame(*f)[0] for f in frames]
    assert tus["slow"] == tus["medium"]


@pytest.mark.parametrize("size", [(128, 96), (192, 120), (352, 288), (1920, 1080)])
def test_mode_penalty_covers_the_decoders_edge_rule(size):
    """Wherever the decoder predicts D45/D67 (D203) from real top-right
    (bottom-left) pixels, the decide's penalty grid forbids the mode: the
    commit predicts directional modes from replicated edges."""
    from svtav1_tpu_torch.codec.tile_codec import FrameParams
    from svtav1_tpu_torch.ops.intra import intra_has_bottom_left, intra_has_top_right
    from svtav1_tpu_torch.pipeline.device_decide import BSIZE_BY_N, _penalty_grid_np

    w, h = size
    p = FrameParams(width=w, height=h, qindex=120, frame_is_intra=True)
    aw, ah = p.aligned_width, p.aligned_height
    mi_end = (min(ah // 4, p.mi_rows), min(aw // 4, p.mi_cols))
    for n in (8, 16, 32, 64):
        R, C, n4 = ah // n, aw // n, n // 4
        pen = _penalty_grid_np(p, 0, 0, R, C, n, (0, 0), mi_end)
        for r in range(R):
            mi_row = r * n // 4
            bottom_av = p.mi_rows * 4 - (r * n + n) > 0 and mi_row + n4 < mi_end[0]
            for c in range(C):
                mi_col = c * n // 4
                if intra_has_top_right(BSIZE_BY_N[n], mi_row, mi_col, r > 0, mi_col + n4 < mi_end[1]):
                    assert pen[r, c, 7] > 0 and pen[r, c, 12] > 0, (n, r, c)
                if intra_has_bottom_left(BSIZE_BY_N[n], mi_row, mi_col, bottom_av, c > 0):
                    assert pen[r, c, 11] > 0, (n, r, c)


def test_medium_decodes_where_the_reference_grid_misses():
    """At 192x120 the JAX package's penalty grid lets the decide pick D67
    where the decoder reads real top-right pixels, and its stream decodes to
    another recon; the port's stream decodes to its own recon."""
    from svtav1_tpu_torch.decode.decoder import Decoder

    w, h = 192, 120
    (y, u, v), = make_frames(w, h, 1, seed=0)
    enc = port_enc.Encoder(port_enc.EncoderConfig(w, h, **MEDIUM), device="cpu")
    tu, rec = enc.encode_frame(y, u, v)
    _, _, _, drec = Decoder().decode_tu(tu)
    for i in range(3):
        np.testing.assert_array_equal(drec[i], rec[i])
