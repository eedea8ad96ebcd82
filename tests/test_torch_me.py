"""The plain versions of K8 (me_sad), K9 (subpel_pred) and K10 (mc_lanes)
in svtav1_tpu_torch.ops.me_torch against svtav1_tpu.ops.me_jax on the same
numpy inputs: full-pel MVs, subpel MVs and predictions, and MC samples must
be equal, integer for integer."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svtav1_tpu.ops import me_jax
from svtav1_tpu_torch.ops import me_torch


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

