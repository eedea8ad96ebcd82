"""The port's CLI (python -m svtav1_tpu_torch.app) on the CPU: a y4m clip
in, an IVF out whose TUs are the library encoder's, every TU decoded and
checked with --verify (CQP random access, CRF, two-pass VBR); the first
pass's stats file and the HDR metadata OBUs of key-frame TUs are the JAX
package's bytes; --md numpy writes the library's TUs of the host mode
decision; --enable-restoration, --intra-batch, --film-grain and
--fgs-table encode streams that the port's decoder and libaom decode; and
tiles with inter frames, which the reference refuses too, raise its
ValueError."""
import numpy as np
import pytest

from svtav1_tpu import app as ref_app
from svtav1_tpu.pipeline import encoder as ref_enc
from svtav1_tpu_torch import app
from svtav1_tpu_torch.pipeline import firstpass
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


def test_cli_10bit_y4m_verifies_and_writes_a_10bit_recon(tmp_path, capsys):
    """A 10-bit y4m (C420p10) in: the IVF holds the library's 10-bit TUs,
    --verify decodes them, and --recon writes the decoded frames at 10 bits."""
    from svtav1_tpu_torch.io.y4m import read_y4m

    w = h = 64
    frames = make_frames(w, h, 3, seed=8, bd=10)
    src, out, rec = tmp_path / "in.y4m", tmp_path / "out.ivf", tmp_path / "rec.y4m"
    write_y4m(str(src), frames, w, h, bd=10)
    rc = app.main(["-i", str(src), "-b", str(out), "--device", "cpu", "--keyint", "3",
                   "--verify", "--recon", str(rec)])
    assert rc == 0
    assert "avg Y-PSNR" in capsys.readouterr().out
    assert read_ivf(str(out))[0] == _library_tus(frames, w, h, keyint=3, bd=10)
    got, rw, rh, _fps, rbd = read_y4m(str(rec))
    assert (rw, rh, rbd, len(got)) == (w, h, 10, 3)
    assert int(got[0][0].max()) > 255


def _library_tus(frames, w, h, **cfg):
    enc = port_enc.Encoder(port_enc.EncoderConfig(w, h, **cfg), device="cpu")
    return [p.tu for f in frames for p in enc.send_frame(*f)] + [p.tu for p in enc.flush()]


def test_cli_crf_verifies_and_writes_the_library_tus(tmp_path, capsys):
    w = h = 64
    frames = make_frames(w, h, 6, seed=8)
    src, out = tmp_path / "in.y4m", tmp_path / "out.ivf"
    write_y4m(str(src), frames, w, h)
    rc = app.main(["-i", str(src), "-b", str(out), "--device", "cpu", "--rc", "crf",
                   "--lookahead", "8", "--minigop", "4", "--keyint", "16", "--verify"])
    assert rc == 0
    assert "avg Y-PSNR" in capsys.readouterr().out
    assert read_ivf(str(out))[0] == _library_tus(frames, w, h, rc_mode="crf", lookahead=8,
                                                 minigop=4, keyint=16)


def test_cli_two_pass_stats_match_the_jax_app_and_second_pass_verifies(tmp_path):
    """--pass 1 writes the same stats file as the JAX package's app; --pass 2
    --rc vbr encodes with those stats, as the library does with stats_in."""
    w = h = 64
    frames = make_frames(w, h, 5, seed=9)
    src = tmp_path / "in.y4m"
    write_y4m(str(src), frames, w, h)
    stats, ref_stats = tmp_path / "pass1.stat", tmp_path / "ref_pass1.stat"
    assert app.main(["-i", str(src), "-b", str(tmp_path / "p1.ivf"), "--device", "cpu",
                     "--pass", "1", "--stats", str(stats)]) == 0
    assert ref_app.main(["-i", str(src), "-b", str(tmp_path / "r1.ivf"), "--pass", "1",
                         "--stats", str(ref_stats)]) == 0
    assert stats.read_bytes() == ref_stats.read_bytes()
    out = tmp_path / "out.ivf"
    assert app.main(["-i", str(src), "-b", str(out), "--device", "cpu", "--pass", "2",
                     "--rc", "vbr", "--tbr", "300", "--keyint", "5", "--stats", str(stats),
                     "--verify"]) == 0
    assert read_ivf(str(out))[0] == _library_tus(
        frames, w, h, rc_mode="vbr", target_kbps=300.0, keyint=5,
        stats_in=firstpass.read_stats(str(stats)))


def test_cli_host_mode_decision_writes_the_library_tus(tmp_path, capsys):
    """--md numpy: the IVF holds the library's TUs of the host route
    (mode_decision="numpy"), not the device route's, and --verify decodes
    them."""
    w = h = 64
    frames = make_frames(w, h, 2, seed=9)
    src, out = tmp_path / "in.y4m", tmp_path / "out.ivf"
    write_y4m(str(src), frames, w, h)
    assert app.main(["-i", str(src), "-b", str(out), "--device", "cpu", "--keyint", "2",
                     "--md", "numpy", "--verify"]) == 0
    assert "avg Y-PSNR" in capsys.readouterr().out
    tus = read_ivf(str(out))[0]
    assert tus == _library_tus(frames, w, h, keyint=2, mode_decision="numpy")
    assert tus != _library_tus(frames, w, h, keyint=2)


def test_metadata_obus_match_the_jax_encoder():
    """Constructing the JAX package's Encoder compiles nothing."""
    ref = ref_enc.Encoder(ref_enc.EncoderConfig(64, 64, mode_decision="jax", **HDR))
    port = port_enc.Encoder(port_enc.EncoderConfig(64, 64, **HDR), device="cpu")
    assert port._metadata_obus() == ref._metadata_obus()
    assert len(port._metadata_obus()) > 0


# settings the reference refuses too raise its ValueError, not the port's
# NotImplementedError
REFUSED = {"tiles": (ValueError, "inter frames are single-tile")}


@pytest.mark.parametrize("flags, item", [
    (["--keyint", "8", "--tile-columns", "1"], "tiles"),
])
def test_flags_outside_the_port_raise(tmp_path, flags, item):
    src = tmp_path / "in.y4m"
    write_y4m(str(src), make_frames(16, 16, 1), 16, 16)
    exc, match = REFUSED.get(item, (NotImplementedError, item))
    with pytest.raises(exc, match=match):
        app.main(["-i", str(src), "-b", str(tmp_path / "out.ivf"), "--device", "cpu", *flags])
    assert not (tmp_path / "out.ivf").exists()


@pytest.mark.parametrize("flags", [
    ["--keyint", "4", "--enable-restoration"],
    ["--intra-batch", "2"],
    ["--keyint", "4", "--film-grain", "10"],
    ["--keyint", "4", "--fgs-table", "grain.tbl"],
], ids=["restoration", "intra_batch", "film_grain", "fgs_table"])
def test_flags_encode(tmp_path, flags):
    """Each flag encodes a 3-frame clip with --verify (the encoder's recon
    against the port's decoder; three frames in batches of 2 leave a
    partial batch); the IVF decodes, in the port's decoder and in libaom,
    to three shown frames (with grain: the recon plus the grain). The
    grain table is one the test writes."""
    from svtav1_tpu_torch.decode.decoder import Decoder
    from svtav1_tpu_torch.filters import film_grain as fg
    from torch_encode_parity import check_libaom

    w = h = 64
    src, out = tmp_path / "in.y4m", tmp_path / "out.ivf"
    write_y4m(str(src), make_frames(w, h, 3, seed=9), w, h)
    if "--fgs-table" in flags:
        flags = flags[:-1] + [str(tmp_path / flags[-1])]
        fg.save_fgs_table(flags[-1], [(0, 9999999, fg.synthetic_params(20))])
    assert app.main(["-i", str(src), "-b", str(out), "--device", "cpu", "--verify",
                     *flags]) == 0
    tus = read_ivf(str(out))[0]
    dec = Decoder()
    shown = [d[:3] for d in map(dec.decode_tu, tus) if d[0] is not None]
    assert len(shown) == 3 and all(y.shape == (h, w) for y, _, _ in shown)
    check_libaom(tus, shown)
