"""Loop restoration and film grain through the port's Encoder on the CPU,
port only (their GOPs against the JAX package are in
test_torch_encode_inter.py): restoration on a 10-bit key frame and P frame
and in a mini-GoP of 4, film grain at 10 bits and from an aomenc table,
every stream decoded by the port's decoder and by libaom; the restoration
route's commit of a P frame (inter_commit_restoration) with its filters off
against the pipelined path's commit before its filters; and the restoration
route's device filters against the reference's host DLF and CDEF."""
from dataclasses import replace

import numpy as np
import pytest

from svtav1_tpu_torch.pipeline import encoder as port_enc
from svtav1_tpu_torch.pipeline import inter_device
from svtav1_tpu_torch.utils.testclip import make_frames
from torch_encode_parity import encode_all, gop_decodes, lr_types_of, mi_from_plan, noisy_frames

GOP = dict(qindex=120, keyint=4, preset="medium")
W, H = 128, 96


def _p_frame(bd=8):
    """An encoder that has coded the key frame of a 2-frame clip, the P
    frame's setup and padded source, and a function that starts its decide."""
    frames = noisy_frames(W, H, 2, bd=bd)
    enc = port_enc.Encoder(port_enc.EncoderConfig(W, H, bd=bd, **GOP), device="cpu")
    enc.send_frame(*frames[0])
    setup = enc._frame_setup(1, False, 0, 0, None)
    p = setup["p"]
    refs_dev, ref_ids = enc._stack_refs(setup["refs"])
    src = enc._pad(*frames[1])

    def start(params=p):
        return inter_device.inter_start_decide(src, params, refs_dev, p.interp_filter, ref_ids)

    return p, src, start


def test_raw_commit_equals_pipelined_commit_before_filters():
    """The restoration route's inter frame (inter_commit_restoration) on a P
    frame with the filters off: its recon equals the pipelined path's recon
    with the filters off, and its plan, walked by TileCodec, codes the
    pipelined path's payload."""
    from svtav1_tpu_torch.codec.tile_codec import TileCodec
    from svtav1_tpu_torch.constants.cdf import FrameContext

    p, _, start = _p_frame()
    plan, raw, filt = inter_device.inter_commit_restoration(
        start(replace(p, lf_levels=(0, 0, 0, 0))), enable_cdef=False)
    pend = inter_device.inter_start_commit(start(), enable_dlf=False, enable_cdef=False)
    _, rec, filt_p, payloads = inter_device.inter_finish(pend, FrameContext(p.qindex))
    assert filt_p["lf_levels"] == (0, 0, 0, 0) and filt_p["cdef"][:4] == (0, 0, 0, 0)
    assert filt["cdef"][:4] == (0, 0, 0, 0)
    for a, b, c in zip(raw, rec, filt["deblocked"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, b)
    assert any(d.is_inter for d in plan.blocks.values())
    assert TileCodec(p, FrameContext(p.qindex), tile=p.tiles()[0]).encode(plan) == payloads[0]


@pytest.mark.parametrize("frame, bd", [("key", 8), ("key", 10), ("P", 8)])
def test_restoration_filters_match_host_route(frame, bd):
    """The restoration route's filters on the device
    (device_commit.restoration_filters: K4 at the frame's levels, then K6
    and K7 with the host search's units) equal the reference's host route
    on the same raw recon: filters/dlf.loop_filter_frame, the deblocked
    copy, filters/cdef.search_strengths and cdef_frame on the plan's mi
    grid. The search must pick a CDEF strength."""
    from svtav1_tpu_torch.filters import cdef, dlf
    from svtav1_tpu_torch.pipeline import device_commit

    if frame == "key":
        enc = port_enc.Encoder(port_enc.EncoderConfig(W, H, bd=bd, **GOP), device="cpu")
        p = enc._frame_setup(0, True, 0, None, None)["p"]
        src = enc._pad(*noisy_frames(W, H, 1, bd=bd)[0])
        plan, raw, _, _ = device_commit.encode_intra_frames([src], p, "cpu", use_arrays=False)[0]
        _, recon, filt, _ = device_commit.encode_intra_frames([src], p, "cpu",
                                                              restoration=True)[0]
    else:
        p, src, start = _p_frame(bd)
        plan, raw, _ = inter_device.inter_commit_restoration(
            start(replace(p, lf_levels=(0, 0, 0, 0))), enable_cdef=False)
        _, recon, filt = inter_device.inter_commit_restoration(start())
    assert any(p.lf_levels)
    mi = mi_from_plan(plan, p)
    dlf.loop_filter_frame(raw, mi, p.qindex, bd, frame == "key", levels=p.lf_levels,
                          sharpness=p.lf_sharpness, disp_dims=(W, H))
    for a, b in zip(filt["deblocked"], raw):
        np.testing.assert_array_equal(a, b)
    want = cdef.search_strengths(raw, src, mi, p.qindex, bd)
    assert filt["lf_levels"] == p.lf_levels and filt["cdef"] == want and any(want[:4]), want
    cdef.cdef_frame(raw, mi, *want, bd=bd)
    for a, b in zip(recon, raw):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cfg, n", [
    (dict(GOP, bd=10), 2),
    (dict(GOP, keyint=8, minigop=4), 5),
], ids=["10bit", "minigop4"])
def test_restoration_port_streams_decode(cfg, n):
    """Restoration on a 10-bit key frame and P frame, and in a mini-GoP of 4
    (hidden anchor, B frames without compound, show-existing TUs), on the
    noisy clip: both decoders reproduce the recon, and some plane codes a
    restoration filter."""
    frames = noisy_frames(W, H, n, bd=cfg.get("bd", 8))
    enc = port_enc.Encoder(port_enc.EncoderConfig(W, H, enable_restoration=True, **cfg),
                           device="cpu")
    pkts = encode_all(enc, frames)
    gop_decodes(pkts, W, H)
    assert any(any(t) for t in lr_types_of([p.tu for p in pkts]))


@pytest.mark.parametrize("grain", ["10bit", "table"])
def test_film_grain_port_streams_decode(grain, tmp_path):
    """Film grain at 10 bits from the estimate, and from an aomenc table the
    test writes: both decoders add the same grain to the recon."""
    from svtav1_tpu_torch.filters import film_grain as fg

    cfg, bd = dict(GOP, keyint=2, film_grain=10), 8
    if grain == "10bit":
        bd = 10
        cfg["bd"] = 10
    else:
        path = tmp_path / "grain.tbl"
        fg.save_fgs_table(str(path), [(0, 9999999, fg.FilmGrainParams(
            grain_seed=10956, y_points=((0, 24), (128, 32), (255, 24)),
            cb_points=((0, 10), (255, 10)), cr_points=((0, 10), (255, 10)),
            ar_coeff_lag=1, ar_coeffs_y=(12, 24, -8, 30),
            ar_coeffs_cb=(6, 12, -4, 15, 20), ar_coeffs_cr=(6, 12, -4, 15, -20)))])
        cfg = dict(GOP, keyint=2, film_grain_table=str(path))
    frames = make_frames(64, 64, 2, seed=4, bd=bd)
    pkts = encode_all(port_enc.Encoder(port_enc.EncoderConfig(64, 64, **cfg), device="cpu"),
                      frames)
    gop_decodes(pkts, 64, 64, grain=True)
    plain = encode_all(port_enc.Encoder(port_enc.EncoderConfig(
        64, 64, **{k: v for k, v in cfg.items() if not k.startswith("film_grain")}),
        device="cpu"), frames)
    for a, b in zip(pkts, plain):
        for i in range(3):
            np.testing.assert_array_equal(a.recon[i], b.recon[i])
