"""The plain versions of K8 (me_sad), K9 (subpel_pred) and K10 (mc_lanes)
in svtav1_tpu_torch.ops.me_torch against svtav1_tpu.ops.me_jax on the same
numpy inputs: full-pel MVs, subpel MVs and predictions, and MC samples must
be equal, integer for integer. Also the premises of the kernels' packed
arithmetic and of me_fullpel_frame's implicit padding and shared source
pyramid (torch and numpy only)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svtav1_tpu.ops import me_jax
from svtav1_tpu_torch.ops import me_torch
from svtav1_tpu_torch.ops.convolve import filter_kernels


def _shifted_pair(h: int, w: int, seed: int, dy: int, dx: int, noise: int):
    """A smooth random texture and the same texture moved by (dy, dx) with
    added noise: (src, ref) int32 planes."""
    g = np.random.default_rng(seed)
    base = g.integers(0, 256, (h // 4 + 8, w // 4 + 8)).astype(np.float64)
    big = np.kron(base, np.ones((4, 4)))
    k = np.ones(5) / 5
    big = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, big)
    big = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, big)
    src = big[16 : 16 + h, 16 : 16 + w]
    ref = big[16 - dy : 16 - dy + h, 16 - dx : 16 - dx + w]
    ref = ref + g.integers(-noise, noise + 1, ref.shape)
    return (np.clip(src, 0, 255).astype(np.int32), np.clip(ref, 0, 255).astype(np.int32))


@pytest.mark.parametrize("h, w, dy, dx, noise", [
    (128, 128, 3, -5, 0),
    (128, 128, -7, 2, 6),
    (192, 128, 9, 11, 3),
    (192, 128, 0, 0, 20),
])
def test_me_fullpel_frame_matches_jax(h, w, dy, dx, noise):
    src, ref = _shifted_pair(h, w, seed=h + dy, dy=dy, dx=dx, noise=noise)
    want, want_sb = me_jax.me_fullpel_frame(jnp.asarray(src), jnp.asarray(ref), h // 64, w // 64)
    got, got_sb = me_torch.me_fullpel_frame(torch.from_numpy(src), torch.from_numpy(ref),
                                            h // 64, w // 64)
    np.testing.assert_array_equal(got_sb.numpy(), np.asarray(want_sb))
    for n in me_torch.SIZES:
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]), err_msg=f"n={n}")


def test_decimation_and_leaf_maps_match_jax():
    src, ref = _shifted_pair(128, 192, seed=4, dy=2, dx=-3, noise=4)
    np.testing.assert_array_equal(me_torch.decimate2_plain(torch.from_numpy(src)).numpy(),
                                  np.asarray(me_jax.decimate2_j(jnp.asarray(src))))
    # leaf maps at random SB centres, some past the plane's edges, against
    # the reference's gathered (72x72) SB window sliced into its 64 leaf
    # windows
    r, B, sb_cols = 4, 6, 3
    g = np.random.default_rng(9)
    centers = g.integers(-70, 90, (1, B, 2)).astype(np.int32)
    got = me_torch.leaf_maps_plain(torch.from_numpy(src), torch.from_numpy(ref),
                                   torch.from_numpy(centers), sb_cols, r)[0].numpy()
    rr, cc = np.repeat(np.arange(2), sb_cols), np.tile(np.arange(sb_cols), 2)
    win = me_jax.gather_windows(jnp.asarray(ref), jnp.asarray(rr * 64 + centers[0, :, 0] - r),
                                jnp.asarray(cc * 64 + centers[0, :, 1] - r), 72, 72)
    src8 = jnp.asarray(src).reshape(2, 8, 8, 3, 8, 8).transpose(0, 3, 1, 4, 2, 5).reshape(-1, 8, 8)
    leaf_win = jnp.stack([win[:, 8 * i : 8 * i + 16, 8 * j : 8 * j + 16]
                          for i in range(8) for j in range(8)], 1).reshape(-1, 16, 16)
    np.testing.assert_array_equal(got, np.asarray(me_jax.sad_maps(src8, leaf_win, 8, r)))


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("fast", [True, False])
def test_subpel_pred_lanes_matches_jax(n, fast):
    H, W = 64, 96
    src, ref = _shifted_pair(H, W, seed=n + fast, dy=1, dx=-2, noise=5)
    g = np.random.default_rng(n * 3 + fast)
    R, C = H // n, W // n
    ys = np.repeat(np.arange(R), C).astype(np.int32) * n
    xs = np.tile(np.arange(C), R).astype(np.int32) * n
    # full-pel MVs, some reaching past every edge of the plane
    mv = g.integers(-3, 4, (R * C, 2)).astype(np.int32)
    mv[:4] = [[-n - 9, 0], [0, -n - 9], [H + 5, 3], [2, W + 5]]
    srcb = src[: R * n, : C * n].reshape(R, n, C, n).transpose(0, 2, 1, 3).reshape(-1, n, n)
    want_mv, want_pred = me_jax.subpel_pred_lanes(jnp.asarray(srcb), jnp.asarray(ref),
                                                  jnp.asarray(ys), jnp.asarray(xs),
                                                  jnp.asarray(mv), 0, 8, fast=fast)
    t = torch.from_numpy
    got_mv, got_pred = me_torch.subpel_pred_lanes(t(srcb.copy()), t(ref.astype(np.uint8)), t(ys),
                                                  t(xs), t(mv), 0, 8, fast=fast)
    np.testing.assert_array_equal(got_mv.numpy(), np.asarray(want_mv))
    np.testing.assert_array_equal(got_pred.numpy(), np.asarray(want_pred))
    # the prediction is the normative MC at the returned MV
    mc = me_torch.mc_lanes(t(ref.astype(np.uint8)), t(ys), t(xs), got_mv[:, 0] * 2,
                           got_mv[:, 1] * 2, n, n, 0, 8)
    np.testing.assert_array_equal(mc.numpy(), got_pred.numpy())


@pytest.mark.parametrize("n", [4, 8, 16])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("stack", [False, True])
def test_mc_lanes_matches_jax(n, bd, stack):
    H, W, B = 40, 56, 64
    g = np.random.default_rng(n * 100 + bd + stack)
    nref = 2 if stack else 1
    planes = g.integers(0, 1 << bd, (nref, H, W)).astype(np.int32)
    ys = g.integers(0, H - n, B).astype(np.int32)
    xs = g.integers(0, W - n, B).astype(np.int32)
    # 1/16-pel MVs, a few reaching past every edge
    mvy = g.integers(-40 * 16, 40 * 16, B).astype(np.int32)
    mvx = g.integers(-40 * 16, 40 * 16, B).astype(np.int32)
    mvy[:4] = [-(H + 9) * 16 - 5, (H + 9) * 16 + 3, 7, -3]
    mvx[:4] = [11, -13, -(W + 9) * 16 - 1, (W + 9) * 16 + 15]
    ridx = g.integers(0, nref, B).astype(np.int32)
    for which in (0, 1):  # REGULAR, SMOOTH
        if stack:
            want = me_jax.mc_lanes(jnp.asarray(planes), jnp.asarray(ys), jnp.asarray(xs),
                                   jnp.asarray(mvy), jnp.asarray(mvx), n, n, which, bd,
                                   ref_idx=jnp.asarray(ridx))
        else:
            want = me_jax.mc_lanes(jnp.asarray(planes[0]), jnp.asarray(ys), jnp.asarray(xs),
                                   jnp.asarray(mvy), jnp.asarray(mvx), n, n, which, bd)
        dt = np.uint8 if bd == 8 else np.int16
        ref_t = torch.from_numpy(planes.astype(dt) if stack else planes[0].astype(dt))
        got = me_torch.mc_lanes(ref_t, torch.from_numpy(ys), torch.from_numpy(xs),
                                torch.from_numpy(mvy), torch.from_numpy(mvx), n, n, which, bd,
                                ref_idx=torch.from_numpy(ridx) if stack else None)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"which={which}")




@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("bd", [8, 10])
def test_mc_lanes_planes_matches_jax(n, bd):
    """K10's multi-plane entry (the lanes of one launch on U, V and a third
    plane of one shape, a 2-reference stack each) against the reference's
    mc_lanes run once per plane, at the shapes test_mc_lanes_matches_jax
    compiles, MVs past every edge."""
    H, W, B = 40, 56, 64
    g = np.random.default_rng(n * 7 + bd)
    planes = g.integers(0, 1 << bd, (3, 2, H, W)).astype(np.int32)
    ys = g.integers(0, H - n, B).astype(np.int32)
    xs = g.integers(0, W - n, B).astype(np.int32)
    mvy = g.integers(-40 * 16, 40 * 16, B).astype(np.int32)
    mvx = g.integers(-40 * 16, 40 * 16, B).astype(np.int32)
    mvy[:4] = [-(H + 9) * 16 - 5, (H + 9) * 16 + 3, 7, -3]
    mvx[:4] = [11, -13, -(W + 9) * 16 - 1, (W + 9) * 16 + 15]
    ridx = g.integers(0, 2, B).astype(np.int32)
    dt = np.uint8 if bd == 8 else np.int16
    t = torch.from_numpy
    got = me_torch.mc_lanes_planes([t(p.astype(dt)) for p in planes], t(ys), t(xs), t(mvy),
                                   t(mvx), n, n, 0, bd, ref_idx=t(ridx))
    assert got.shape == (3, B, n, n)
    for pl in range(3):
        want = me_jax.mc_lanes(jnp.asarray(planes[pl]), jnp.asarray(ys), jnp.asarray(xs),
                               jnp.asarray(mvy), jnp.asarray(mvx), n, n, 0, bd,
                               ref_idx=jnp.asarray(ridx))
        np.testing.assert_array_equal(got[pl].numpy(), np.asarray(want), err_msg=f"plane {pl}")

@pytest.mark.parametrize("which", range(6))
def test_filter_facts_of_k9_packed_arithmetic(which):
    """K9 runs the horizontal 8 taps as two int8 x int8 dot products on
    samples shifted by -128 (adding back 128 x the taps' sum) and the
    vertical 8 taps as four int16 x int8 dot products: every tap but phase
    0's single 128 (a copy in the kernel) fits int8, every phase sums to 128,
    and the 8-bit horizontal intermediate fits a positive int16."""
    taps = np.asarray(filter_kernels(which), dtype=np.int64)
    assert taps.shape == (16, 8)
    assert taps[0].tolist() == [0, 0, 0, 128, 0, 0, 0, 0]
    assert (taps[1:] >= -128).all() and (taps[1:] <= 127).all()
    assert (taps.sum(axis=1) == 128).all()
    # (2^(bd+6) + sum f p + 4) >> 3 over p in [0, 255]: the extremes put 255
    # under the negative (or the positive) taps and 0 under the others
    lo = (16384 + 255 * np.where(taps < 0, taps, 0).sum(axis=1) + 4) >> 3
    hi = (16384 + 255 * np.where(taps > 0, taps, 0).sum(axis=1) + 4) >> 3
    assert lo.min() >= 263 and hi.max() <= 7913


@pytest.mark.parametrize("ref_off_x", [0, 64])
def test_me_fullpel_frame_source_pyramid_and_padding(ref_off_x):
    """me_fullpel_frame on a 136x192 uint8 frame (rows not a multiple of 64)
    and the SB grid the decide gives it (3 x 3): the planes read as if
    edge-padded to the grid equal the planes padded by the caller, and a
    precomputed source pyramid (me_pyramid) gives the same MVs as none; with
    ref_off_x the reference is wider by 2 x ref_off_x columns."""
    h, w = 136, 192
    src, ref = _shifted_pair(h, w + 2 * ref_off_x, seed=17 + ref_off_x, dy=3, dx=-6, noise=4)
    src = src[:, ref_off_x : ref_off_x + w].astype(np.uint8)
    ref = ref.astype(np.uint8)
    sbr, sbc = 3, 3
    t = torch.from_numpy
    got, got_sb = me_torch.me_fullpel_frame(t(src), t(ref), sbr, sbc, ref_off_x=ref_off_x)
    pyr = me_torch.me_pyramid(t(src), sbr, sbc)
    assert [tuple(p.shape) for p in pyr] == [(96, 96), (48, 48)]
    with_pyr, with_pyr_sb = me_torch.me_fullpel_frame(t(src), t(ref), sbr, sbc,
                                                      ref_off_x=ref_off_x, src_pyr=pyr)
    padded = [np.pad(p, ((0, 192 - h), (0, 0)), mode="edge").astype(np.int32) for p in (src, ref)]
    want, want_sb = me_torch.me_fullpel_frame(t(padded[0]), t(padded[1]), sbr, sbc,
                                              ref_off_x=ref_off_x)
    for mvs, sb in ((got, got_sb), (with_pyr, with_pyr_sb)):
        np.testing.assert_array_equal(sb.numpy(), want_sb.numpy())
        for n in me_torch.SIZES:
            assert mvs[n].shape == (sbr * 64 // n, sbc * 64 // n, 2)
            np.testing.assert_array_equal(mvs[n].numpy(), want[n].numpy(), err_msg=f"n={n}")
    assert (got[8].numpy() == (3, -6)).all(axis=-1).mean() > 0.5  # the motion was found


def _shifted_pair10(h: int, w: int, seed: int, dy: int, dx: int, noise: int):
    """_shifted_pair at 10 bits: the 8-bit texture times 4 plus seeded low
    bits, noise scaled alike; samples in 0..1023."""
    src, ref = _shifted_pair(h, w, seed, dy, dx, noise)
    g = np.random.default_rng(seed + 1)
    return tuple(np.clip(4 * p + g.integers(0, 4, p.shape), 0, 1023).astype(np.int32)
                 for p in (src, ref))


@pytest.mark.parametrize("h, w, dy, dx, noise", [
    (128, 128, 3, -5, 0),
    (192, 128, 9, 11, 3),
    (128, 192, 0, 0, 20),
])
def test_me_fullpel_frame_10bit_matches_jax(h, w, dy, dx, noise):
    """K8's plain version on 10-bit planes (0..1023) and on their int16
    form, the card's dtype, against the reference's int32 route."""
    src, ref = _shifted_pair10(h, w, seed=h + dy + 10, dy=dy, dx=dx, noise=noise)
    want, want_sb = me_jax.me_fullpel_frame(jnp.asarray(src), jnp.asarray(ref), h // 64, w // 64)
    for dt in (np.int32, np.int16):
        t = torch.from_numpy
        got, got_sb = me_torch.me_fullpel_frame(t(src.astype(dt)), t(ref.astype(dt)), h // 64,
                                                w // 64, bd=10)
        np.testing.assert_array_equal(got_sb.numpy(), np.asarray(want_sb))
        for n in me_torch.SIZES:
            np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]), err_msg=f"n={n}")
    pyr = me_torch.me_pyramid(torch.from_numpy(src.astype(np.int16)), h // 64, w // 64, bd=10)
    with_pyr, _ = me_torch.me_fullpel_frame(torch.from_numpy(src.astype(np.int16)),
                                            torch.from_numpy(ref.astype(np.int16)), h // 64,
                                            w // 64, src_pyr=pyr, bd=10)
    for n in me_torch.SIZES:
        np.testing.assert_array_equal(with_pyr[n].numpy(), np.asarray(want[n]))


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("fast", [True, False])
def test_subpel_pred_lanes_10bit_matches_jax(n, fast):
    """K9's plain version at 10 bits on int16 planes (the card's dtype),
    both lattices, against the reference; the prediction is K10's MC."""
    H, W = 64, 96
    src, ref = _shifted_pair10(H, W, seed=n + fast + 20, dy=1, dx=-2, noise=9)
    g = np.random.default_rng(n * 7 + fast)
    R, C = H // n, W // n
    ys = np.repeat(np.arange(R), C).astype(np.int32) * n
    xs = np.tile(np.arange(C), R).astype(np.int32) * n
    mv = g.integers(-3, 4, (R * C, 2)).astype(np.int32)
    mv[:4] = [[-n - 9, 0], [0, -n - 9], [H + 5, 3], [2, W + 5]]
    srcb = src[: R * n, : C * n].reshape(R, n, C, n).transpose(0, 2, 1, 3).reshape(-1, n, n)
    want_mv, want_pred = me_jax.subpel_pred_lanes(jnp.asarray(srcb), jnp.asarray(ref),
                                                  jnp.asarray(ys), jnp.asarray(xs),
                                                  jnp.asarray(mv), 0, 10, fast=fast)
    t = torch.from_numpy
    ref16 = t(ref.astype(np.int16))
    got_mv, got_pred = me_torch.subpel_pred_lanes(t(srcb.copy()), ref16, t(ys), t(xs), t(mv), 0,
                                                  10, fast=fast)
    np.testing.assert_array_equal(got_mv.numpy(), np.asarray(want_mv))
    np.testing.assert_array_equal(got_pred.numpy(), np.asarray(want_pred))
    assert int(got_pred.max()) > 255
    mc = me_torch.mc_lanes(ref16, t(ys), t(xs), got_mv[:, 0] * 2, got_mv[:, 1] * 2, n, n, 0, 10)
    np.testing.assert_array_equal(mc.numpy(), got_pred.numpy())


@pytest.mark.parametrize("n", [4, 8, 16])
def test_int16_planes_equal_the_int32_route(n):
    """MC and compound MC of int16 planes (the card's 10-bit dtype) equal
    the same samples as int32, at every clamp and phase."""
    H, W, B = 40, 56, 48
    g = np.random.default_rng(n + 31)
    refs = g.integers(0, 1024, (3, H, W)).astype(np.int32)
    ys, xs = (g.integers(0, s - n, B).astype(np.int32) for s in (H, W))
    mv = g.integers(-40 * 16, 40 * 16, (4, B)).astype(np.int32)
    ri = g.integers(0, 3, (2, B)).astype(np.int32)
    t = torch.from_numpy
    for stack in (refs, refs.astype(np.int16)):
        got = me_torch.mc_lanes(t(stack), t(ys), t(xs), t(mv[0]), t(mv[1]), n, n, 0, 10,
                                ref_idx=t(ri[0]))
        comp = me_torch.mc_lanes_compound(t(stack), t(ys), t(xs), *map(t, mv), n, n, 0, 10,
                                          *map(t, ri))
        if stack.dtype == np.int32:
            want, want_comp = got, comp
        else:
            np.testing.assert_array_equal(got.numpy(), want.numpy())
            np.testing.assert_array_equal(comp.numpy(), want_comp.numpy())
    assert int(want.max()) > 255


def test_uint8_plane_at_10_bits_raises():
    """A wrapper given a plane whose dtype cannot hold its bit depth raises
    (it never casts): uint8 at bd=10, and a depth the kernels lack."""
    p8 = torch.zeros((64, 64), dtype=torch.uint8)
    z = torch.zeros(1, dtype=torch.int32)
    calls = [
        lambda: me_torch.mc_lanes(p8, z, z, z, z, 8, 8, 0, 10),
        lambda: me_torch.mc_lanes_compound(p8[None], z, z, z, z, z, z, 8, 8, 0, 10, z, z),
        lambda: me_torch.subpel_pred_lanes(torch.zeros((1, 8, 8), dtype=torch.int32), p8, z, z,
                                           torch.zeros((1, 2), dtype=torch.int32), 0, 10),
        lambda: me_torch.me_fullpel_frame(p8, p8, 1, 1, bd=10),
        lambda: me_torch.me_pyramid(p8, 1, 1, bd=10),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="uint8 plane cannot hold 10-bit"):
            call()
    with pytest.raises(ValueError, match="bit depth 12"):
        me_torch.mc_lanes(p8.to(torch.int16), z, z, z, z, 8, 8, 0, 12)


@pytest.mark.parametrize("which", range(6))
def test_filter_facts_of_k9_10bit_arithmetic(which):
    """K9's 10-bit form runs the horizontal 8 taps as four int16 x int8 dot
    products on the samples themselves: its intermediate (2^16 + sum f p +
    4) >> 3 over p in [0, 1023] stays a positive int16, in [1031, 31721],
    so the vertical pass keeps the 8-bit form's int16 pairs."""
    taps = np.asarray(filter_kernels(which), dtype=np.int64)
    lo = (65536 + 1023 * np.where(taps < 0, taps, 0).sum(axis=1) + 4) >> 3
    hi = (65536 + 1023 * np.where(taps > 0, taps, 0).sum(axis=1) + 4) >> 3
    assert lo.min() >= 1031 and hi.max() <= 31721 < 32768
    # phase 0's copy: (2^16 + 128 p + 4) >> 3 == 8192 + 16 p
    p = np.arange(1024)
    assert ((65536 + 128 * p + 4) >> 3 == 8192 + 16 * p).all()


@pytest.mark.parametrize("which, bd", [pytest.param(w, bd, id=f"{w}-bd{bd}")
                                       for bd in (8, 10) for w in range(6)])
def test_filter_facts_of_k11_compound_arithmetic(which, bd):
    """K11 runs K10's packed passes with the compound path's vertical start
    2^offset_bits + 2^(COMPOUND_ROUND1 - 1) and shift COMPOUND_ROUND1: over
    intermediates anywhere in their positive int16 range, the vertical sum
    (four IDP.2A into an int32) and the conv-buf prediction it shifts down
    stay positive and inside int32, and so does the blend's sum of two
    predictions. At 10 bits the prediction's range passes int16, so the
    kernel keeps the first one per thread as an int32."""
    taps = np.asarray(filter_kernels(which), dtype=np.int64)
    pos, neg = np.where(taps > 0, taps, 0).sum(axis=1), np.where(taps < 0, taps, 0).sum(axis=1)
    pmax = (1 << bd) - 1
    h_lo = ((1 << (bd + 6)) + pmax * neg + 4) >> 3  # the horizontal intermediate, per phase
    h_hi = ((1 << (bd + 6)) + pmax * pos + 4) >> 3
    lo, hi = int(h_lo.min()), int(h_hi.max())
    assert 0 < lo and hi < 1 << 15
    init = (1 << (bd + 2 * 7 - 3)) + (1 << (7 - 1))
    v_lo = init + pos * lo + neg * hi  # per vertical phase, intermediates at the extremes
    v_hi = init + pos * hi + neg * lo
    assert v_lo.min() > 0 and v_hi.max() < 1 << 31
    conv_lo, conv_hi = int((v_lo >> 7).min()), int((v_hi >> 7).max())
    assert conv_lo >= 0 and 2 * conv_hi < 1 << 31
    assert (conv_hi >= 1 << 15) == (bd == 10), conv_hi
