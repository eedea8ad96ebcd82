"""The TPL of the port against svtav1_tpu's on the same numpy inputs, at 8
and 10 bits: K14's plain version (subpel_refine) against
me_jax.subpel_refine_lanes, K15's plain version (tpl_cost) against the cost
expressions of svtav1_tpu/pipeline/tpl.py, the whole dispenser window
(tpl_window, its recon too) and the synthesizer, the CRF q rules, and a
10-bit CRF GOP of the port's Encoder whose windows' r0 and frames' qindex
the reference's TPL and q rules reproduce. All integer results must be
equal; the float32 cost grids too. At 10 bits the reference runs under the
port's DC rule (torch_encode_parity.reference_with_spec_rules: its TPL
probe predicts DC with neither neighbour as 512, not 128); no other test
of a worker traces the reference's 10-bit TPL at 128x64."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svtav1_tpu.constants.av1 import TxType
from svtav1_tpu.ops import me_jax
from svtav1_tpu.ops import quantize as ref_quant
from svtav1_tpu.ops import transforms_jax as TJ
from svtav1_tpu.pipeline import tpl as ref_tpl
from svtav1_tpu_torch.ops import me_torch
from svtav1_tpu_torch.ops import transforms_torch as TT
from svtav1_tpu_torch.pipeline import encoder as port_enc
from svtav1_tpu_torch.pipeline import tpl
from svtav1_tpu_torch.utils.testclip import make_frames
from torch_encode_parity import encode_all, gop_decodes, reference_with_spec_rules


def _textured(h: int, w: int, seed: int):
    """A smooth random texture (int32), so SADs vary smoothly with the MV."""
    g = np.random.default_rng(seed)
    big = np.kron(g.integers(0, 256, (h // 4 + 2, w // 4 + 2)), np.ones((4, 4)))
    k = np.ones(5) / 5
    big = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, big)
    big = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, big)
    return np.clip(big[:h, :w], 0, 255).astype(np.int32)


def _moving_lumas(w: int, h: int, n: int, bd: int = 8):
    return [y.astype(np.int32) for y, _u, _v in make_frames(w, h, n, seed=2, bd=bd)]


def _record_recons(mp, module, name: str) -> list:
    """Wrap module.name (it makes the dispenser step, run) with the
    MonkeyPatch `mp` so that every run's TPL recon plane is appended to the
    returned list."""
    recons = []
    build = getattr(module, name)

    def wrapped(*args):
        run = build(*args)

        def run_and_record(*a):
            out = run(*a)
            rec = out[-1]
            recons.append(rec.cpu().numpy() if isinstance(rec, torch.Tensor) else np.asarray(rec))
            return out

        return run_and_record

    mp.setattr(module, name, wrapped)
    return recons


@pytest.mark.parametrize("minigop, bd", [pytest.param(1, 8, id="1"), pytest.param(4, 8, id="4"),
                                         pytest.param(4, 10, id="4-bd10")])
def test_tpl_window_matches_jax(minigop, bd):
    """The dispenser over a 5-frame window of the moving clip at 128x64,
    in the low-delay chain and in a mini-GoP of 4 (at 10 bits too, the
    reference under the port's DC rule): every grid equal (the seed frame's
    MVs excepted: no reference, read by nothing), every frame's TPL recon
    equal (int16 at 10 bits, as the reference returns it), and the
    synthesizer's r0 within rtol 1e-12. At 10 bits the top-left block of
    every frame is flat at 512, so that DC with neither neighbour (512 under
    the rule, 128 in the reference without it) predicts it exactly."""
    frames = _moving_lumas(128, 64, 5, bd)
    if bd == 10:
        for y in frames:
            y[:16, :16] = 512
    with pytest.MonkeyPatch.context() as mp, reference_with_spec_rules(bd):
        want_rec = _record_recons(mp, ref_tpl, "_tpl_frame_jit")
        got_rec = _record_recons(mp, tpl, "_tpl_frame")
        want = ref_tpl.tpl_window(frames, 120, bd, minigop=minigop)
        got = tpl.tpl_window(frames, 120, bd, minigop=minigop, device="cpu")
    assert len(got_rec) == len(want_rec) == 5
    for t, (a, b) in enumerate(zip(got_rec, want_rec)):
        assert a.dtype == b.dtype == (np.uint8 if bd == 8 else np.int16), t
        np.testing.assert_array_equal(a, b, err_msg=f"recon {t}")
    print(f"bd {bd} minigop {minigop}: largest recrf {max(s['recrf'].max() for s in got)}")
    assert [s["_sched"] for s in got] == [s["_sched"] for s in want]
    for t, (a, b) in enumerate(zip(got, want)):
        assert (a["ref0"], a["ref1"]) == (b["ref0"], b["ref1"]), t
        for k in ("intra_cost", "inter_cost", "srcrf", "recrf", "ref_pick", "mv"):
            if k == "mv" and a["ref0"] < 0 and a["ref1"] < 0:
                continue
            assert a[k].dtype == b[k].dtype, (t, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"frame {t} {k}")
        assert (a["ref_pick"] >= 0).any() or t == 0  # inter blocks exist
        assert bd == 8 or a["intra_cost"][0, 0] == 0  # the DC rule's block
    np.testing.assert_allclose(tpl.synthesize(got), ref_tpl.synthesize(want), rtol=1e-12)


def test_crf_10bit_gop_matches_the_reference_q_and_decodes():
    """Port only: a 10-bit CRF random-access GOP (a key frame and a
    mini-GoP of 4) of the moving clip at 128x64 through the Encoder. Every
    TPL window it runs (spied on Encoder._tpl_r0) gives the r0 that
    svtav1_tpu's tpl_window and synthesize give on the same lumas, and every
    frame's qindex is the reference's crf_qindex of that r0. Every TU
    decodes with the port's decoder and libaom to the encoder's recon."""
    w, h, bd, cq = 128, 64, 10, 120
    frames = make_frames(w, h, 5, seed=2, bd=bd)
    cfg = port_enc.EncoderConfig(w, h, qindex=cq, keyint=16, minigop=4, lookahead=8,
                                 rc_mode="crf", bd=bd)
    windows, qs = [], []
    real_r0, real_q = port_enc.Encoder._tpl_r0, tpl.crf_qindex

    def spy_r0(self, lumas):
        r0 = real_r0(self, lumas)
        windows.append(([np.array(y) for y in lumas], r0))
        return r0

    def spy_q(*args):
        qs.append((args, real_q(*args)))
        return qs[-1][1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_enc.Encoder, "_tpl_r0", spy_r0)
        mp.setattr(tpl, "crf_qindex", spy_q)
        pkts = encode_all(port_enc.Encoder(cfg, device="cpu"), frames)
    assert len(windows) == 2 and len(qs) == 5  # the key's window, the mini-GoP's
    want_r0 = []
    with reference_with_spec_rules(bd):
        for lumas, r0 in windows:
            want = ref_tpl.synthesize(ref_tpl.tpl_window(lumas, cq, bd, minigop=4))
            np.testing.assert_allclose(r0, want, rtol=1e-12)
            want_r0 += list(want)
    for args, q in qs:
        assert args[0] == cq and args[-1] == bd
        assert args[1] in want_r0 or args[1] == 1.0, args  # 1.0: a frame outside the window
        assert ref_tpl.crf_qindex(*args) == q, args
    print("r0 per window:", [list(np.round(r0, 4)) for _l, r0 in windows],
          "qindex per frame:", [q for _a, q in qs])
    assert len({q for _a, q in qs}) > 1
    gop_decodes(pkts, w, h)


def _refine_both(src_b, ref, ys, xs, mv_fp, bd: int = 8):
    """me_jax's refinement on int32 planes and the port's through its
    wrapper, the reference plane as the card holds it (uint8 or int16)."""
    want = me_jax.subpel_refine_lanes(jnp.asarray(src_b), jnp.asarray(ref), jnp.asarray(ys),
                                      jnp.asarray(xs), jnp.asarray(mv_fp), 0, bd)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (src_b, ref, ys, xs, mv_fp)]
    t[1] = t[1].to(me_torch.plane_dtype(bd))
    got = me_torch.subpel_refine_lanes(*t, 0, bd)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("where, bd", [pytest.param("interior", 8, id="interior"),
                                       pytest.param("edges", 8, id="edges"),
                                       pytest.param("interior", 10, id="interior-bd10"),
                                       pytest.param("edges", 10, id="edges-bd10")])
def test_subpel_refine_matches_jax(where, bd):
    """K14's plain version on 16x16 lanes of a textured plane moved by a
    subpel amount: interior full-pel MVs, and MVs that put the window across
    every edge of the plane (clamped reads); at 10 bits on int16 planes of
    the texture << 2 plus low bits."""
    h, w, n = 96, 128, 16
    g = np.random.default_rng(5 if where == "interior" else 6)
    tex = _textured(h + 8, w + 8, seed=3)
    maxv = (1 << bd) - 1
    if bd == 10:
        tex = tex * 4 + g.integers(0, 4, tex.shape).astype(np.int32)
    ref = tex[4 : 4 + h, 4 : 4 + w]
    R, C = h // n, w // n
    ys = np.repeat(np.arange(R), C).astype(np.int32) * n
    xs = np.tile(np.arange(C), R).astype(np.int32) * n
    # the source: the texture shifted by a fraction of a pel (bilinear) plus noise
    fy, fx = 0.4, -0.6
    t = tex.astype(np.float64)
    sh = ((1 - fy) * (1 - fx) * t[4:4 + h, 4:4 + w] + fy * (1 - fx) * t[5:5 + h, 4:4 + w]
          + (1 - fy) * fx * t[4:4 + h, 3:3 + w] + fy * fx * t[5:5 + h, 3:3 + w])
    src = np.clip(np.round(sh) + g.integers(-2, 3, sh.shape), 0, maxv).astype(np.int32)
    src_b = src.reshape(R, n, C, n).transpose(0, 2, 1, 3).reshape(-1, n, n)
    if where == "interior":
        mv_fp = g.integers(-2, 3, (R * C, 2)).astype(np.int32)
    else:
        mv_fp = g.integers(-40, 41, (R * C, 2)).astype(np.int32)
    got, want = _refine_both(src_b, ref, ys, xs, mv_fp, bd)
    np.testing.assert_array_equal(got, want)
    assert len({tuple(v) for v in (got - mv_fp * 8)}) > 3  # the search moved


def _ref_costs(srcb, pred, qindex: int, bd: int = 8):
    """The reference's TPL cost expressions (pipeline/tpl.py:82-83, :115-123)."""
    dct = int(TxType.DCT_DCT)
    co = TJ.fwd_txfm2d_j(jnp.asarray(srcb - pred), dct, bd)
    satd = jnp.sum(jnp.abs(co), axis=(-2, -1)) >> 2
    dq = (ref_quant.dc_q(qindex, bd), ref_quant.ac_q(qindex, bd))
    ls = ref_quant.tx_scale(16, 16)
    lv = jnp.clip(TJ.quantize_j(co, dq[0], dq[1], ls), -32767, 32767)
    dqc = TJ.dequantize_j(lv, dq[0], dq[1], ls, bd)
    err = jnp.sum(((co - dqc) >> 2).astype(jnp.float32) ** 2, axis=(-2, -1))
    rec = TJ.inv_txfm2d_add_j(dqc, jnp.asarray(pred), dct, bd)
    return np.asarray(satd), np.asarray(err), np.asarray(rec), dq


@pytest.mark.parametrize("qindex, bd", [pytest.param(q, 8, id=str(q)) for q in (60, 120, 200)]
                         + [pytest.param(q, 10, id=f"{q}-bd10") for q in (60, 120, 200)])
def test_tpl_cost_matches_the_reference_expressions(qindex, bd):
    """K15's plain version: mode 0 (the SATD proxy, the five probe lanes of
    a block sharing its source through rep) and mode 1 (the quantization
    error and the recon) on 16x16 residuals from flat to rough, at 8 bits
    and at 10 (samples and spreads times 4)."""
    g = np.random.default_rng(qindex)
    L, rep = 40, 5
    k, maxv = 1 << (bd - 8), (1 << bd) - 1
    src = g.integers(0, maxv + 1, (L // rep, 16, 16)).astype(np.int32)
    spread = k * np.repeat(np.array([2, 10, 40, 120, 255]), L // 5)[:, None, None]
    pred = np.clip(np.repeat(src, rep, axis=0) + g.integers(-255, 256, (L, 16, 16)) * spread // 255,
                   0, maxv).astype(np.int32)
    satd, err, rec, dq = _ref_costs(np.repeat(src, rep, axis=0), pred, qindex, bd)
    s_t, p_t = torch.from_numpy(src), torch.from_numpy(pred)
    got = TT.tpl_cost(s_t, p_t, 0, dq[0], dq[1], bd, rep=rep)
    np.testing.assert_array_equal(got.numpy(), satd)
    rep_src = torch.from_numpy(np.repeat(src, rep, axis=0))
    e, r = TT.tpl_cost(rep_src, p_t, 1, dq[0], dq[1], bd, want_recon=True)
    print(f"bd {bd} qindex {qindex}: largest quantization error {int(e.max())}")
    assert int(e.max()) < 1 << 24  # below 2^24 the reference's float32 sum is exact
    np.testing.assert_array_equal(e.numpy().astype(np.float32), err)
    np.testing.assert_array_equal(r.numpy(), rec)
    e2, r2 = TT.tpl_cost(rep_src, p_t, 1, dq[0], dq[1], bd)
    assert r2 is None and torch.equal(e2, e)


def test_subpel_refine_first_minimum_on_flat_blocks():
    """On a flat reference every candidate has the same SAD: the reference's
    argmin takes the first of the nine, the (-1, -1) corner, in both steps,
    not the centre."""
    n = 16
    ref = np.full((64, 64), 100, np.int32)
    src_b = np.full((4, n, n), 103, np.int32)
    ys = np.array([0, 16, 32, 48], np.int32)
    xs = np.array([48, 0, 16, 32], np.int32)
    mv_fp = np.array([[0, 0], [1, -2], [-3, 0], [5, 5]], np.int32)
    got, want = _refine_both(src_b, ref, ys, xs, mv_fp)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, mv_fp * 8 - 6)


def test_crf_q_rules_match_the_reference():
    for leaf in (20, 60, 120, 200, 255):
        for ratio in (0.05, 0.3, 0.77, 1.0, 1.3, 4.0):
            assert tpl.qindex_from_qstep_ratio(leaf, ratio) == \
                ref_tpl.qindex_from_qstep_ratio(leaf, ratio), (leaf, ratio)
    for cq in (40, 120, 210):
        for r0 in (0.0, 0.02, 0.2, 0.5, 0.93, 1.0):
            for is_key in (True, False):
                for layer in range(4):
                    for hl in range(5):
                        args = (cq, r0, is_key, layer, hl)
                        assert tpl.crf_qindex(*args) == ref_tpl.crf_qindex(*args), args


@pytest.mark.parametrize("kind", ["textured", "flat", "textured-bd10"])
def test_subpel_refine_design_premise(kind):
    """K14's design on the CPU: both steps' candidates of every block, from
    full-pel MVs that put windows across every edge, lie on the 49-point
    {-6..6} step-2 lattice of the (n+8)^2 patch staged at mv_fp - 4 (index j
    at offset 2j - 6); the nine of step 1 at {1, 3, 5}^2, step 2's around its
    winner, whose SAD is the centre's (index 4); and the two first-minimum
    steps walked on the lattice's SADs give subpel_refine_plain's MVs. Flat
    blocks tie everywhere: each step takes its (-1, -1) corner."""
    bd = 10 if kind.endswith("bd10") else 8
    h, w, n = 64, 96, 16
    g = np.random.default_rng(11)
    tex = _textured(h + 8, w + 8, seed=4)
    if bd == 10:
        tex = tex * 4 + g.integers(0, 4, tex.shape).astype(np.int32)
    if kind == "flat":
        tex[:] = 100
    ref = torch.from_numpy(np.ascontiguousarray(tex[4 : 4 + h, 4 : 4 + w]))
    R, C = h // n, w // n
    B = R * C
    ys = torch.from_numpy(np.repeat(np.arange(R), C).astype(np.int32) * n)
    xs = torch.from_numpy(np.tile(np.arange(C), R).astype(np.int32) * n)
    src_b = torch.from_numpy(np.clip(tex[3 : 3 + h, 5 : 5 + w] + g.integers(-3, 4, (h, w)), 0,
                                     (1 << bd) - 1).astype(np.int32)
                             .reshape(R, n, C, n).transpose(0, 2, 1, 3).reshape(B, n, n).copy())
    mv_fp = torch.from_numpy(g.integers(-24, 25, (B, 2)).astype(np.int32))
    patch = me_torch.extract_patches(ref, ys + mv_fp[:, 0] - 4, xs + mv_fp[:, 1] - 4, n + 8, n + 8)
    sad = torch.empty((7, 7, B), dtype=torch.int64)  # the lattice's SADs
    for jy in range(7):
        for jx in range(7):
            fy0, fx0 = 4 * jy - 12, 4 * jx - 12  # 1/16 pel
            p = me_torch._mc_patch_static(patch, fy0 >> 4, fx0 >> 4, fy0 & 15, fx0 & 15, n, 0, bd)
            sad[jy, jx] = (p - src_b).abs().sum(dim=(-2, -1))
    bi = torch.arange(B)
    cy, cx = torch.full((B,), 3), torch.full((B,), 3)
    centre = None
    for step, d in enumerate((2, 1)):
        cand = [(cy + (a - 1) * d, cx + (c - 1) * d) for a in range(3) for c in range(3)]
        for jy, jx in cand:
            assert bool(((jy >= 0) & (jy <= 6) & (jx >= 0) & (jx <= 6)).all())
        if step == 0:
            assert all(set(v.tolist()) == {i} for v, i in zip(cand[4], (3, 3)))
        s9 = torch.stack([sad[jy, jx, bi] for jy, jx in cand])
        if centre is not None:
            assert torch.equal(s9[4], centre)  # step 2's centre: step 1's least SAD
        k = torch.argmin(s9, dim=0)  # the first minimum
        centre = s9.min(dim=0).values
        cy, cx = cy + (k // 3 - 1) * d, cx + (k % 3 - 1) * d
    got = mv_fp * 8 + torch.stack([2 * cy - 6, 2 * cx - 6], dim=1).to(torch.int32)
    want = me_torch.subpel_refine_plain(src_b, ref, ys, xs, mv_fp, 0, bd)
    assert torch.equal(got, want)
    if kind == "flat":
        assert torch.equal(got, mv_fp * 8 - 6)
    else:
        assert len({tuple(v) for v in (got - mv_fp * 8).tolist()}) > 3  # the search moved
