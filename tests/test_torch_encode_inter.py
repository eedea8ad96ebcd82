"""The port's low-delay P frames end to end on the CPU (plain versions of
the kernels) against the JAX package's device path: a key frame and three P
frames of the synthetic clip at the default medium preset with keyint=4
(LAST and GOLDEN references, global motion, CDF inheritance, the pipelined
three-phase frames) give identical TUs and recon at 128x96 and at 122x90
(not a multiple of 8: mi-alignment padding, display-edge replication in the
device DPB, clamped MC at the display edge; its aligned size is 128x96, so
the JAX package's commit programs compiled for the first case serve it
too), and the port's decoder reproduces the recon. One P frame's decide outputs are compared directly:
integers exact, costs to float32 summation order.

The same GOP with loop restoration (the synchronous route: the port's
device deblocking and CDEF against the reference's host ones, then the
restoration search on the host) and with film grain gives identical TUs
and recon too; it reuses the reference's programs of the first case. The port-only cases of both settings are in
test_torch_restoration_grain.py."""
import jax
import numpy as np
import pytest
import torch

from svtav1_tpu.pipeline import device_decide as ref_decide
from svtav1_tpu.pipeline import inter_device as ref_inter
from svtav1_tpu_torch.codec.tile_codec import FrameParams
from svtav1_tpu_torch.pipeline import device_decide, inter_device
from svtav1_tpu_torch.pipeline import encoder as port_enc
from svtav1_tpu_torch.utils.testclip import make_frames
from torch_encode_parity import gop_matches_jax_and_decodes, lr_types_of, noisy_frames

GOP = dict(qindex=120, keyint=4, preset="medium")
W, H = 128, 96


@pytest.mark.parametrize("size", [(W, H), (122, 90)])
def test_gop_matches_jax_and_decodes(size):
    gop_matches_jax_and_decodes(*size, GOP, 4)


def test_restoration_gop_matches_jax_and_decodes():
    """Loop restoration, the port's device filters against the reference's
    host DLF and CDEF, on the noisy clip (the synthetic clip's frames all
    code RESTORE_NONE at qindex 120): some plane of some frame codes
    another restoration type. Seed 1: with the noisy clip's default seed
    the key frame's decide parts from the reference's with or without
    restoration (the directional-mode penalty grid, ROADMAP queue 3 entry
    3)."""
    pkts = gop_matches_jax_and_decodes(W, H, dict(GOP, enable_restoration=True), 4,
                                       clip=noisy_frames(W, H, 4, seed=1))
    types = lr_types_of([p.tu for p in pkts])
    assert len(types) == 4 and any(any(t) for t in types), types


def test_film_grain_gop_matches_jax_and_decodes():
    """Film grain parameters estimated from the first source frame: the
    decoders' output is the recon plus the grain (gop_matches_jax_and_decodes
    holds libaom's output to the port decoder's)."""
    gop_matches_jax_and_decodes(W, H, dict(GOP, film_grain=10), 4)


def test_p_frame_decide_matches_jax():
    """Frame 2 of the clip against frames 1 (LAST) and 0 (GOLDEN) with a
    non-zero global MV (the GLOBALMV lane goes through MC): the same
    program the encode above compiled (same dims, qindex and speed
    features)."""
    frames = make_frames(W, H, 3, seed=4)
    src = frames[2]
    refs = [frames[1], frames[0]]
    p = FrameParams(width=W, height=H, qindex=120, frame_is_intra=False, enable_gm=1,
                    enable_rdoq=True, **port_enc.PRESETS["medium"])
    gm = [(0, 0)] * 8
    gm[1] = (6, -10)
    p.gm_mvs = tuple(gm)
    stack = [np.stack([np.asarray(r[pl], np.uint8) for r in refs]) for pl in range(3)]
    want = ref_inter.decide_inter_frame(
        ref_decide.put_frames([list(src)], 8), tuple(jax.device_put(s) for s in stack), p,
        p.interp_filter, ref_ids=(1, 4))
    got = inter_device.decide_inter_frame(
        device_decide.put_frames([list(src)], 8, "cpu"),
        tuple(torch.from_numpy(s) for s in stack), p, p.interp_filter, ref_ids=(1, 4))
    assert sorted(got) == sorted(want)
    inter_blocks = 0
    for n in want:
        for key in want[n]:
            if key == "cost":
                np.testing.assert_allclose(got[n][key], want[n][key], rtol=1e-5, err_msg=f"n={n}")
            else:
                np.testing.assert_array_equal(got[n][key], want[n][key], err_msg=f"n={n} {key}")
        inter_blocks += int(want[n]["is_inter"].sum())
    assert inter_blocks > 0


def test_p_frame_plan_walk_matches_native_array_walk():
    """A P frame's commit as a BlockDecision plan (the path taken without
    the native walker), coded by TileCodec, gives the payload and recon of
    the array-plan walk; blocks at the frame's global MV code as GLOBALMV,
    the others as NEWMV."""
    from svtav1_tpu_torch.codec import array_plan
    from svtav1_tpu_torch.codec.tile_codec import Plan, TileCodec
    from svtav1_tpu_torch.codec.tile_walk_native import run_tile_ops
    from svtav1_tpu_torch.constants.av1 import InterMode
    from svtav1_tpu_torch.constants.cdf import FrameContext
    from svtav1_tpu_torch.pipeline import device_commit
    from svtav1_tpu_torch.pipeline.intra_md import rd_lambda

    frames = make_frames(96, 64, 2, seed=6)
    enc = port_enc.Encoder(port_enc.EncoderConfig(96, 64, **GOP), device="cpu")
    enc.send_frame(*frames[0])
    setup = enc._frame_setup(1, False, 0, 0, None)
    p = setup["p"]
    gm = [(0, 0)] * 8
    gm[1] = (2, -4)
    p.gm_mvs = tuple(gm)
    refs_dev, ref_ids = enc._stack_refs(setup["refs"])
    src_dev = device_decide.put_frames([enc._pad(*frames[1])], 8, "cpu")
    dec = inter_device.decide_inter_frame(src_dev, refs_dev, p, p.interp_filter, ref_ids)
    region = (0, 0, p.aligned_width, p.aligned_height)
    partitions, leaves, tree = device_decide.partition_dp(
        dec, p, FrameContext(p.qindex), float(rd_lambda(p.qindex, 8)), region)
    # after the decide, make the first inter leaf's MV the frame's global MV,
    # so that the commit codes the blocks at that MV as GLOBALMV
    mi_row, mi_col, n = next(lf for lf in leaves
                             if dec[lf[2]]["is_inter"][lf[0] * 4 // lf[2], lf[1] * 4 // lf[2]])
    r, c = mi_row * 4 // n, mi_col * 4 // n
    gm[1] = (int(dec[n]["mvy"][r, c]), int(dec[n]["mvx"][r, c]))
    p.gm_mvs = tuple(gm)
    commit = dict(refs_dev=refs_dev, ref_ids=ref_ids, which=p.interp_filter)
    plan = Plan()
    rec_a = device_commit.commit_regions(src_dev, p, [leaves], [dec], [plan], region, **commit)
    *rec_b, aux = device_commit.commit_regions(src_dev, p, [leaves], [dec], [Plan()], region,
                                               array_out=True, **commit)
    modes = {d.y_mode for d in plan.blocks.values()}
    assert {int(InterMode.NEWMV), int(InterMode.GLOBALMV)} <= modes
    tile = p.tiles()[0]
    ops, _ = array_plan.build_tile_ops(p, tree, aux["sched"], aux["level_base"], 0, region, tile,
                                       aux["ref_ids"], device_decide.TX_SEARCH,
                                       device_decide.MODES)
    plan.partitions.update(partitions)
    assert (TileCodec(p, FrameContext(p.qindex), tile=tile).encode(plan)
            == run_tile_ops(p, FrameContext(p.qindex), ops, aux["levels_i32"], tile))
    for a, b in zip(rec_a, rec_b):
        assert torch.equal(a, b)

