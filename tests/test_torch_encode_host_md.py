"""The host mode-decision route (mode_decision="numpy", the reference's
default) through the port's Encoder on the CPU, against the JAX package's
Encoder on the same route: the host mode decision (pipeline/intra_md.py,
pipeline/inter_md.py, with filter-intra), then DLF at the by-q levels and
CDEF at the host search's strengths, which the port runs on its device
kernels' plain versions over the host plan (device_commit.plan_filters)
where the reference runs filters/dlf.py and filters/cdef.py. The route
compiles no JAX program. Every TU must equal the reference's, every recon
too, and the port's decoder and libaom decode every TU to the recon."""
from unittest import mock

import numpy as np
import pytest

from svtav1_tpu_torch.decode.decoder import Decoder
from svtav1_tpu_torch.ops import intra as intra_ops
from svtav1_tpu_torch.pipeline import encoder as port_enc
from svtav1_tpu_torch.utils.testclip import make_frames
from torch_encode_parity import (gop_matches_jax_and_decodes, lr_types_of, mi_from_plan,
                                 noisy_frames)

HOST = dict(mode_decision="numpy", qindex=120, keyint=16)


def gradient_frames(n: int, w: int = 64, h: int = 64) -> list:
    """tests/test_filter_intra.py's clip: a luma gradient plus noise, flat
    chroma; its key frames code filter-intra blocks."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:h, 0:w]
    return [((80 + xx * 0.9 + yy * 0.5 + rng.normal(0, 3, (h, w))).clip(0, 255).astype(np.int32),
             np.full((h // 2, w // 2), 110, np.int32), np.full((h // 2, w // 2), 140, np.int32))
            for _ in range(n)]


def filter_intra_blocks(tus) -> int:
    """The luma blocks that the port's decoder predicts with filter-intra
    over a stream's TUs."""
    count = [0]
    real = intra_ops.filter_intra_pred

    def spy(*args, **kw):
        count[0] += 1
        return real(*args, **kw)

    dec = Decoder()
    with mock.patch.object(intra_ops, "filter_intra_pred", spy):
        for tu in tus:
            dec.decode_tu(tu)
    return count[0]


CLIPS = {
    "filter_intra": (64, 64, dict(HOST, qindex=40, keyint=2, enable_filter_intra=True),
                     lambda: gradient_frames(3)),
    "low_delay": (128, 96, HOST, lambda: make_frames(128, 96, 3)),
    "random_access": (64, 64, dict(HOST, minigop=2), lambda: make_frames(64, 64, 3)),
    "10bit": (64, 64, dict(HOST, bd=10), lambda: make_frames(64, 64, 2, bd=10)),
    # seed 1: queue 3 entry 3 holds the default seed's key frame apart on
    # the device route
    "restoration": (64, 64, dict(HOST, enable_restoration=True),
                    lambda: noisy_frames(64, 64, 2, seed=1)),
}


@pytest.mark.parametrize("name", CLIPS)
def test_host_route_matches_reference_and_decodes(name):
    """The clip through both encoders on the host route: equal TUs and
    recon in coding order, decoded by the port's decoder and libaom. The
    filter-intra clip codes filter-intra blocks; the restoration clip codes
    a restoration filter."""
    w, h, cfg, clip = CLIPS[name]
    frames = clip()
    pkts = gop_matches_jax_and_decodes(w, h, cfg, len(frames), clip=frames)
    tus = [p.tu for p in pkts]
    if name == "filter_intra":
        assert filter_intra_blocks(tus) > 0
    if name == "restoration":
        assert any(any(t) for t in lr_types_of(tus))


@pytest.mark.parametrize("frame, bd", [("key", 8), ("P", 8), ("key", 10)])
def test_plan_filters_match_host_filters(frame, bd):
    """device_commit.plan_filters on a host mode decision's plan equals the
    reference host route's filters on the plan's mi grid
    (filters/dlf.loop_filter_frame at the by-q levels, the deblocked copy,
    cdef.search_strengths and cdef_frame). The DLF edge maps built from the
    plan's leaf sizes equal the host's from the mi grid, skip and
    reference terms included, for every plane and pass: the host mode
    decision codes only the largest transform of each square block."""
    from svtav1_tpu_torch.filters import cdef, dlf
    from svtav1_tpu_torch.pipeline import device_commit, inter_md, intra_md

    w = h = 64
    if frame == "key":  # a split frame whose CDEF search picks a strength
        frames, q = noisy_frames(w, h, 1, seed=1, bd=bd), 80
    else:  # the gradient clip with its left half static: skip inter blocks
        g = gradient_frames(2)
        y1 = g[1][0].copy()
        y1[:, : w // 2] = g[0][0][:, : w // 2]
        frames, q = [g[0], (y1, *g[0][1:])], 40
    enc = port_enc.Encoder(port_enc.EncoderConfig(w, h, bd=bd, enable_filter_intra=True,
                                                  **dict(HOST, qindex=q, keyint=4)), device="cpu")
    if frame == "key":
        p = enc._frame_setup(0, True, 0, None, None)["p"]
        src = enc._pad(*frames[0])
        plan, raw = intra_md.encode_intra_frame(src, p)
    else:
        enc.send_frame(*frames[0])
        setup = enc._frame_setup(1, False, 0, 0, None)
        p = setup["p"]
        src = enc._pad(*frames[1])
        refs = {r: [pl.numpy().astype(np.int32) for pl in planes]
                for r, planes in setup["refs"].items()}
        plan, raw = inter_md.encode_inter_frame(src, p, refs)
        assert any(d.is_inter and d.skip for d in plan.blocks.values())
    assert any(p.lf_levels) and len(plan.blocks) > 1
    recon, filt = device_commit.plan_filters(plan, [pl.copy() for pl in raw], src[0], p, "cpu",
                                             True, deblocked=True)
    mi = mi_from_plan(plan, p)
    leaves = [(r, c, int(dlf.BLOCK_W[b])) for r, c, b in plan.blocks]
    flens = device_commit.flen_maps([leaves], p, "cpu")
    for plane in range(3):
        pl = raw[plane]
        ss = 1 if plane else 0
        cw, ch = (w + ss) >> ss, (h + ss) >> ss
        for tr, (m, pw, ph, dw, dh) in enumerate(((mi, pl.shape[1], pl.shape[0], cw, ch),
                                                  (dlf._transposed_mi(mi), pl.shape[0],
                                                   pl.shape[1], ch, cw))):
            want = dlf._edge_maps_vertical(m, plane, pw, ph, 1)
            want[dlf.offscreen(*want.shape, dw, dh)] = 0
            np.testing.assert_array_equal(flens[2 * plane + tr][0].numpy(), want,
                                          err_msg=f"plane {plane} pass {tr}")
    dlf.loop_filter_frame(raw, mi, p.qindex, bd, frame == "key", levels=p.lf_levels,
                          sharpness=p.lf_sharpness, disp_dims=(w, h))
    for a, b in zip(filt["deblocked"], raw):
        np.testing.assert_array_equal(a, b)
    want = cdef.search_strengths(raw, src, mi, p.qindex, bd)
    assert filt["lf_levels"] == p.lf_levels and filt["cdef"] == want and any(want[:4]), want
    cdef.cdef_frame(raw, mi, *want, bd=bd)
    for a, b in zip(recon, raw):
        np.testing.assert_array_equal(a, b)
