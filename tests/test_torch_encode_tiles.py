"""Multi-tile key frames through the port's Encoder and CLI on the CPU,
port only: uniform tiles (tile_cols_log2, tile_rows_log2) in all-intra
streams decode to the encoder's recon in the port's decoder and, where the
host has it, in libaom; the Encoder and the CLI refuse tiles with inter
frames, as the reference does. The 2x2-tile parity case against
svtav1_tpu's Encoder sits in test_torch_tiles.py, whose reference mesh
compiles the per-tile commit programs it reuses."""
import pytest

from svtav1_tpu_torch.decode.decoder import Decoder
from svtav1_tpu_torch.pipeline import encoder as port_enc
from svtav1_tpu_torch.utils.testclip import make_frames
from torch_encode_parity import encode_all, packets_decode

W, H = 256, 128
KEY = dict(qindex=120, keyint=1, preset="medium")


@pytest.mark.parametrize("cols_log2, rows_log2", [(1, 0), (0, 1)])
def test_tile_columns_or_rows_decode(cols_log2, rows_log2):
    """Two tile columns, or two tile rows: both decoders reproduce the
    recon, and the tiles' payloads differ from the one-tile stream's."""
    frames = make_frames(W, H, 1)
    cfg = dict(KEY, tile_cols_log2=cols_log2, tile_rows_log2=rows_log2)
    enc = port_enc.Encoder(port_enc.EncoderConfig(W, H, **cfg), device="cpu")
    pkts = encode_all(enc, frames)
    packets_decode(pkts, frames)
    one = encode_all(port_enc.Encoder(port_enc.EncoderConfig(W, H, **KEY), device="cpu"), frames)
    assert pkts[0].tu != one[0].tu


def test_tiles_refused_on_inter_frames():
    for cfg in (dict(keyint=16, tile_cols_log2=1), dict(keyint=16, minigop=4, tile_rows_log2=1)):
        with pytest.raises(ValueError, match="inter frames are single-tile"):
            port_enc.Encoder(port_enc.EncoderConfig(W, H, **cfg), device="cpu")


def test_cli_tile_columns(tmp_path, capsys):
    """The CLI at --keyint 1 --tile-columns 1 writes an IVF whose TUs the
    port's decoder reproduces (--verify checks every frame's recon)."""
    from svtav1_tpu_torch import app
    from svtav1_tpu_torch.io.ivf import read_ivf
    from svtav1_tpu_torch.io.y4m import write_y4m

    frames = make_frames(W, 64, 2)
    src, out = tmp_path / "in.y4m", tmp_path / "out.ivf"
    write_y4m(str(src), frames, W, 64)
    rc = app.main(["-i", str(src), "-b", str(out), "--keyint", "1", "--tile-columns", "1",
                   "--preset", "fast", "--device", "cpu", "--verify"])
    assert rc == 0
    assert "avg Y-PSNR" in capsys.readouterr().out
    tus = read_ivf(str(out))[0]
    assert len(tus) == 2
    dec = Decoder()
    for tu in tus:
        dy = dec.decode_tu(tu)[0]
        assert dy.shape == (64, W)
    with pytest.raises(ValueError, match="inter frames are single-tile"):
        app.main(["-i", str(src), "-b", str(tmp_path / "gop.ivf"), "--keyint", "8",
                  "--tile-columns", "1", "--device", "cpu"])
