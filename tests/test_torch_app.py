"""The port's CLI (python -m svtav1_tpu_torch.app) on the CPU: a y4m clip
in, an IVF out whose TUs are the library encoder's, every TU decoded and
checked with --verify; the HDR metadata OBUs of key-frame TUs are the JAX
encoder's bytes; and flags whose settings are not in the port yet raise
NotImplementedError naming their ROADMAP item."""
import numpy as np
import pytest

from svtav1_tpu.pipeline import encoder as ref_enc
from svtav1_tpu_torch import app
from svtav1_tpu_torch.io.ivf import read_ivf
from svtav1_tpu_torch.io.y4m import write_y4m
from svtav1_tpu_torch.pipeline import encoder as port_enc
from svtav1_tpu_torch.utils.testclip import make_frames

HDR = dict(content_light=(1000, 400),
           mastering_display=(((0.708, 0.292), (0.17, 0.797), (0.131, 0.046)),
                              (0.3127, 0.329), 1000.0, 0.0001),
           itut_t35=b"\x00\x3c\x01\x02")


def test_cli_random_access_verifies_and_writes_the_library_tus(tmp_path, capsys):
    w = h = 64
    frames = make_frames(w, h, 3, seed=8)
    src, out = tmp_path / "in.y4m", tmp_path / "out.ivf"
    write_y4m(str(src), frames, w, h)
    rc = app.main(["-i", str(src), "-b", str(out), "--device", "cpu", "--keyint", "3",
                   "--minigop", "2", "--verify", "--content-light", "1000,400"])
    assert rc == 0
    assert "avg Y-PSNR" in capsys.readouterr().out
    tus, iw, ih, _fps = read_ivf(str(out))
    assert (iw, ih) == (w, h)
    enc = port_enc.Encoder(port_enc.EncoderConfig(w, h, keyint=3, minigop=2,
                                                  content_light=(1000, 400)), device="cpu")
    pkts = [p for f in frames for p in enc.send_frame(*f)] + enc.flush()
    assert tus == [p.tu for p in pkts]
    # key, hidden anchor 2, frame 1 and the show-existing TU of frame 2
    assert [(p.disp_idx, p.shown_disp_idx) for p in pkts] == [(0, 0), (2, None), (1, 1),
                                                             (None, 2)]


def test_metadata_obus_match_the_jax_encoder():
    """Constructing the JAX package's Encoder compiles nothing."""
    ref = ref_enc.Encoder(ref_enc.EncoderConfig(64, 64, mode_decision="jax", **HDR))
    port = port_enc.Encoder(port_enc.EncoderConfig(64, 64, **HDR), device="cpu")
    assert port._metadata_obus() == ref._metadata_obus()
    assert len(port._metadata_obus()) > 0


@pytest.mark.parametrize("flags, item", [
    (["--rc", "crf"], "rate control"),
    (["--pass", "1"], "rate control"),
    (["--stats", "pass1.stat"], "rate control"),
    (["--tbr", "500"], "rate control"),
    (["--lookahead", "32"], "rate control"),
    (["--enable-restoration"], "restoration"),
    (["--tile-columns", "1"], "tiles"),
    (["--scd"], "scene cuts"),
    (["--intra-batch", "2"], "intra batching"),
    (["--film-grain", "10"], "film grain"),
    (["--fgs-table", "grain.tbl"], "film grain"),
])
def test_flags_outside_the_port_raise(tmp_path, flags, item):
    src = tmp_path / "in.y4m"
    write_y4m(str(src), make_frames(16, 16, 1), 16, 16)
    with pytest.raises(NotImplementedError, match=item):
        app.main(["-i", str(src), "-b", str(tmp_path / "out.ivf"), "--device", "cpu", *flags])
    assert not (tmp_path / "out.ivf").exists()
