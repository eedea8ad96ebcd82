"""MCTF of the port against svtav1_tpu.ops.tf_jax on the same numpy
inputs: the noise estimate (K13's plain version) and the whole filter
(K8-K10 and K12's plain versions) must equal the reference exactly at
128x128, where the reference's float32 window and noise sums are exact;
and on a noisy static scene the filter brings the frame closer to the clean
signal."""
import numpy as np
import pytest
import torch

from svtav1_tpu.ops import tf_jax
from svtav1_tpu_torch.ops import tf_torch
from svtav1_tpu_torch.utils.testclip import make_frames

W = H = 128


def test_estimate_noise_matches_jax():
    for seed, noise in ((1, 3.0), (2, 12.0)):
        (y, _u, _v), = make_frames(W, H, 1, noise=noise, seed=seed)
        want = np.float32(tf_jax.estimate_noise_j(y.astype(np.int32)))
        got = tf_torch.estimate_noise(torch.from_numpy(y.astype(np.int32)))
        assert got.dtype == np.float32
        assert got == want, (got, want)


@pytest.mark.parametrize("neighbours", [(1, 3), (0, 1, 3, 4, 5)])
def test_filter_frame_matches_jax(neighbours):
    frames = [[np.asarray(p, np.int32) for p in f] for f in make_frames(W, H, 6, seed=2)]
    want = tf_jax.filter_frame(frames[2], [frames[i] for i in neighbours], 120)
    got = tf_torch.filter_frame(frames[2], [frames[i] for i in neighbours], 120,
                                  device="cpu")
    changed = 0
    for pl in range(3):
        assert got[pl].dtype == np.int32
        np.testing.assert_array_equal(got[pl], np.asarray(want[pl]), err_msg=f"plane {pl}")
        changed += int((got[pl] != frames[2][pl]).sum())
    assert changed > 0


def exact_box5(x):
    """tf_jax._box5 with the window sums taken exactly: the 25 shifted
    integer squares summed in int32, then divided by 25 in float32 as the
    reference divides its float32 sum (and as the port divides)."""
    import jax.numpy as jnp

    H, W = x.shape
    p = jnp.pad(x.astype(jnp.int32), 2, mode="edge")
    s = sum(p[i : i + H, j : j + W] for i in range(5) for j in range(5))
    return s.astype(jnp.float32) / 25.0


def port_quotients(center, neighbours, qindex: int, bd: int) -> list:
    """Per plane, the port's unrounded a / ws of every sample (the weighted
    sum over the weight sum that tf_filter_plain rounds), from the inputs
    the port's filter hands K12."""
    from unittest import mock

    seen = []
    real = tf_torch.tf_filter
    with mock.patch.object(tf_torch, "tf_filter",
                           lambda c, p, h2, bd=8: seen.append((c, p, h2)) or real(c, p, h2, bd)):
        tf_torch.filter_frame(center, neighbours, qindex, bd=bd, device="cpu")
    out = []
    for c, preds, h2 in seen:
        a, ws = c.to(torch.float32), torch.ones_like(c, dtype=torch.float32)
        for p in preds:
            d = tf_torch._box5_sum((p - c) * (p - c)).to(torch.float32) / torch.full_like(a, 25.0)
            w = torch.exp((-d / torch.full_like(a, float(h2))).to(torch.float64)).to(torch.float32)
            a, ws = a + w * p.to(torch.float32), ws + w
        out.append((a / ws).numpy())
    return out


@pytest.mark.parametrize("neighbours", [(1, 3), (0, 1, 3, 4)])
def test_filter_frame_10bit_matches_jax(neighbours):
    """MCTF at 10 bits (K8-K10 on int16 planes, K12 and K13 at bd=10) on
    the 10-bit clip (the 8-bit clip << 2 plus seeded low bits) against the
    reference run with exact window sums: at 10 bits its float32
    summed-area table already rounds at 128x128 (with neighbours 0, 1, 3, 4
    a V window sums to 2037.0001 where the samples give 2037). Equal, except
    where the weighted mean lies within float32 rounding of a half: the
    reference's XLA fuses each `acc + w * p` into one rounding, the port
    rounds the product and the sum (the same V sample: 597.5 there,
    597.49994 here). Both are the deliberate divergences of ROADMAP queue 3
    entry 6; the low bits of the output carry signal."""
    from unittest import mock

    frames = [[np.asarray(p, np.int32) for p in f] for f in make_frames(W, H, 5, seed=2, bd=10)]
    center, neigh = frames[2], [frames[i] for i in neighbours]
    with mock.patch.object(tf_jax, "_box5", exact_box5):
        want = [np.asarray(p) for p in tf_jax.filter_frame(center, neigh, 120, bd=10)]
    got = tf_torch.filter_frame(center, neigh, 120, bd=10, device="cpu")
    quot = port_quotients(center, neigh, 120, 10)
    changed = 0
    for pl in range(3):
        differ = got[pl] != want[pl]
        assert (np.abs(got[pl] - want[pl]) <= 1).all(), f"plane {pl}"
        assert (np.abs(quot[pl][differ] % 1 - 0.5) < 1e-4).all(), f"plane {pl}"
        assert differ.sum() <= 1, f"plane {pl}: {int(differ.sum())} samples differ"
        changed += int((got[pl] != center[pl]).sum())
    assert changed > 0 and int(got[0].max()) > 255 and (got[0] & 3).any()


def test_filter_frame_on_a_half_sample_matches_jax():
    """Anchor 4 of the 128x96 clip (padded to 128x128) with neighbours 2 and
    3 at qindex 100: one luma sample's a / ws lies exactly on a half, so it
    rounds as the reference's only with the reference's decay h2, whose
    sigma^2 + strength^2 XLA fuses into one rounding."""
    from svtav1_tpu_torch.pipeline.encoder import pad_to_aligned

    frames = [[pad_to_aligned(np.asarray(p, np.int32), 128 >> (i > 0), 128 >> (i > 0))
               for i, p in enumerate(f)] for f in make_frames(128, 96, 5)]
    want = tf_jax.filter_frame(frames[4], [frames[2], frames[3]], 100)
    got = tf_torch.filter_frame(frames[4], [frames[2], frames[3]], 100, device="cpu")
    for pl in range(3):
        np.testing.assert_array_equal(got[pl], np.asarray(want[pl]), err_msg=f"plane {pl}")


def test_filter_reduces_noise():
    """A static scene with sigma-6 noise, filtered with four neighbours,
    lands closer to the clean signal than its input."""
    w, h = 128, 64
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:h, 0:w]
    clean = (128 + 60 * np.sin(xx / 19.0) + 45 * np.cos(yy / 13.0)).clip(0, 255)
    frames = []
    for _ in range(5):
        frames.append([(clean + rng.normal(0, 6.0, (h, w))).clip(0, 255).astype(np.int32)]
                      + [(c + rng.normal(0, 6.0, (h // 2, w // 2))).clip(0, 255).astype(np.int32)
                         for c in (120.0, 130.0)])
    out = tf_torch.filter_frame(frames[2], [frames[i] for i in (0, 1, 3, 4)], qindex=120,
                               device="cpu")
    err_in = float(((frames[2][0] - clean) ** 2).mean())
    err_out = float(((out[0] - clean) ** 2).mean())
    assert err_out < 0.5 * err_in, (err_in, err_out)
