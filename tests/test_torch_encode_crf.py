"""CRF in the port against svtav1_tpu's device path
(Encoder(mode_decision="jax")) on the CPU at 128x96: TPL over lookahead
windows in coding order sets each frame's qindex, on a random-access GOP
with MCTF and on a low-delay GOP. The streams must be identical TU for TU,
the recon too, and the port's decoder must reproduce every recon."""
import pytest
from torch_encode_parity import gop_matches_jax_and_decodes


@pytest.mark.parametrize("cfg, frames", [
    (dict(keyint=16, minigop=4, lookahead=8, enable_tf=True), 9),
    (dict(keyint=16, minigop=1, lookahead=4), 6),
], ids=["random_access_mctf", "low_delay"])
def test_crf_gop_matches_jax_and_decodes(cfg, frames):
    got = gop_matches_jax_and_decodes(128, 96, dict(cfg, qindex=120, rc_mode="crf"), frames)
    assert len(got) >= frames
