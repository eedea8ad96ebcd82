"""The port's key frames at the fast preset end to end on the CPU (plain
versions of the kernels) against the JAX package's device path.

Two frames of the synthetic clip through svtav1_tpu's
Encoder(mode_decision="jax") and svtav1_tpu_torch's Encoder(device="cpu"),
all-intra, fast preset with CDEF off and on (the medium preset is in
test_torch_encode_medium.py): the temporal units must be byte-identical and
the recon identical, and the port's stream must decode with the port's own
decoder to the same recon.
"""
import numpy as np
import pytest

from svtav1_tpu_torch.decode.decoder import Decoder
from svtav1_tpu_torch.pipeline import encoder as port_enc
from svtav1_tpu_torch.utils.testclip import make_frames
from torch_encode_parity import encode_all, gop_decodes, matches_jax_and_decodes

SLICE = dict(qindex=120, keyint=1, preset="fast", enable_cdef=False)


@pytest.mark.parametrize("size", [(128, 96), (202, 122)])
def test_slice_matches_jax_and_decodes(size):
    matches_jax_and_decodes(*size, SLICE)


@pytest.mark.parametrize("size", [(128, 96), (202, 122)])
def test_fast_with_cdef_matches_jax_and_decodes(size):
    """CDEF with the fast preset's 4-candidate strength ladder."""
    matches_jax_and_decodes(*size, dict(SLICE, enable_cdef=True))


def test_slice_without_deblocking_decodes():
    w, h = 64, 64
    (y, u, v), = make_frames(w, h, 1, seed=3)
    port = port_enc.Encoder(port_enc.EncoderConfig(w, h, enable_dlf=False, **SLICE), device="cpu")
    tu, rec = port.encode_frame(y, u, v)
    _, _, _, drec = Decoder().decode_tu(tu)
    for i in range(3):
        np.testing.assert_array_equal(drec[i], rec[i])


@pytest.mark.parametrize("override, item", [
    (dict(enable_filter_intra=True), "filter-intra"),
    (dict(tile_cols_log2=1, keyint=16), "tiles"),
    (dict(tile_cols_log2=1, mode_decision="numpy"), "tiles on the host route"),
])
def test_settings_outside_the_slice_raise(override, item):
    """The settings the reference refuses raise its ValueError: filter-intra
    on the device route (it exists only on the host route,
    mode_decision="numpy"), tiles with inter frames, and tiles on the host
    route."""
    cfg = port_enc.EncoderConfig(64, 64, **{**SLICE, **override})
    match = {"filter-intra": "filter-intra uses the numpy mode-decision path",
             "tiles": "inter frames are single-tile",
             "tiles on the host route": "multi-tile encoding requires the jax"}[item]
    with pytest.raises(ValueError, match=match):
        port_enc.Encoder(cfg, device="cpu")


@pytest.mark.parametrize("override", [
    dict(enable_restoration=True), dict(film_grain=10), dict(intra_batch=2),
], ids=["restoration", "film_grain", "intra_batch"])
def test_settings_encode(override):
    """Restoration, film grain and intra batching encode key frames that
    the port's decoder reproduces (with grain: the recon plus the grain),
    and libaom too."""
    frames = make_frames(64, 64, 2, seed=3)
    enc = port_enc.Encoder(port_enc.EncoderConfig(64, 64, **{**SLICE, **override}), device="cpu")
    gop_decodes(encode_all(enc, frames), 64, 64, grain="film_grain" in override)


def test_plan_walk_matches_native_array_walk():
    """The commit's BlockDecision plan (the path taken without the native
    walker), coded by TileCodec, gives the payload of the array-plan walk."""
    from svtav1_tpu_torch.codec.tile_codec import FrameParams, TileCodec
    from svtav1_tpu_torch.constants.cdf import FrameContext
    from svtav1_tpu_torch.pipeline import device_commit

    w, h = 96, 64
    (y, u, v), = make_frames(w, h, 1, seed=7)
    p = FrameParams(width=w, height=h, qindex=120, frame_is_intra=True, enable_rdoq=False,
                    **port_enc.PRESETS["fast"])
    src = [port_enc.pad_to_aligned(np.asarray(x, np.int32), *s)
           for x, s in ((y, (w, h)), (u, (w // 2, h // 2)), (v, (w // 2, h // 2)))]
    fc = FrameContext(p.qindex)
    _, rec_a, _, pay_a = device_commit.encode_intra_frames([src], p, "cpu", apply_filters=True,
                                                           walk_fcs=[fc])[0]
    plan, rec_b, _, pay_b = device_commit.encode_intra_frames([src], p, "cpu", apply_filters=True,
                                                              use_arrays=False)[0]
    assert pay_b is None and len(plan.blocks) > 0
    assert TileCodec(p, FrameContext(p.qindex), tile=p.tiles()[0]).encode(plan) == pay_a[0]
    for a, b in zip(rec_a, rec_b):
        np.testing.assert_array_equal(a, b)
