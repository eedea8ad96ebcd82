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
    the port's filter hands K12 (tf_filter_planes: block-layout
    predictions)."""
    from unittest import mock

    seen = []
    real = tf_torch.tf_filter_planes

    def capture(c, py, puv, h2, bd=8):
        seen.append((c, py, puv, h2))
        return real(c, py, puv, h2, bd)

    with mock.patch.object(tf_torch, "tf_filter_planes", capture):
        tf_torch.filter_frame(center, neighbours, qindex, bd=bd, device="cpu")
    (planes, preds_y, preds_uv, h2), = seen
    stacks = (list(preds_y), [p[0] for p in preds_uv], [p[1] for p in preds_uv])
    out = []
    for c, blocks in zip(planes, stacks):
        c = c.to(torch.int32)
        H, W = c.shape
        n = blocks[0].shape[-1]
        preds = [b.reshape(H // n, W // n, n, n).permute(0, 2, 1, 3).reshape(H, W) for b in blocks]
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


# ---- port-only cases (no JAX compile): K13's decay and K12's three-plane entry


def _plane(rng, h, w, bd, dtype=torch.int32):
    return torch.from_numpy(rng.integers(0, 1 << bd, (h, w)).astype(np.int32)).to(dtype)


def _host_decay(y, qindex, bd):
    """The decay as the host computes it from K13's sums (numpy float32)."""
    sigma = max(tf_torch.estimate_noise(y, bd), np.float32(0.5 * (1 << (bd - 8))))
    return tf_torch.tf_decay(sigma, np.float32(tf_torch.tf_strength(qindex, bd)))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("qindex", [0, 120, 255])
def test_noise_decay_plain_matches_host(bd, qindex):
    """K13's decay in tensor ops equals the host's float32 numpy decay bit
    for bit, on clip frames, uniform noise and a 1088x1920 plane of small
    noise, all flat, whose |Laplacian| sum passes 2^24; the CPU route of
    noise_decay is the plain version."""
    rng = np.random.default_rng(qindex + bd)
    planes = [torch.from_numpy(f[0].astype(np.int32))
              for f in make_frames(W, H, 3, noise=6.0, seed=qindex, bd=bd)]
    s = 1 << (bd - 8)
    planes += [_plane(rng, 64, 128, bd),
               torch.from_numpy((rng.integers(-8, 9, (1088, 1920)) * s + 128 * s).astype(np.int32))]
    for y in planes:
        got = tf_torch.noise_decay_plain(y, qindex, bd)
        assert got.dtype == torch.float32 and got.dim() == 0
        want = _host_decay(y, qindex, bd)
        assert got.numpy() == want, (got, want)
        assert tf_torch.noise_decay(y.to(torch.int16), qindex, bd).numpy() == want
    assert int(tf_torch.noise_sums_plain(planes[-1], bd)[0]) > 1 << 24


@pytest.mark.parametrize("bd", [8, 10])
def test_noise_decay_without_flat_samples(bd):
    """A plane without a flat sample (stripes of period 4: |dx| is the full
    swing at every column), one without interior samples and a flat one:
    the count is 0, 0 and every sample; the decay takes the floor."""
    hi = (1 << bd) - 1
    stripes = torch.tensor([0, 0, hi, hi], dtype=torch.int32).repeat(32, 16)
    flat = torch.full((32, 64), hi // 2, dtype=torch.int32)
    for y, cnt in ((stripes, 0), (stripes[:2], 0), (flat, 30 * 62)):
        assert int(tf_torch.noise_sums_plain(y, bd)[1]) == cnt
        assert tf_torch.noise_decay_plain(y, 120, bd).numpy() == _host_decay(y, 120, bd)
        floor = np.float32(0.5 * (1 << (bd - 8)))
        assert _host_decay(y, 120, bd) == tf_torch.tf_decay(
            floor, np.float32(tf_torch.tf_strength(120, bd)))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("K", [1, 2, 5])
def test_tf_filter_planes_matches_per_plane(K, bd):
    """K12's three-plane entry (its plain version on the CPU) equals
    tf_filter_plain on each plane, the neighbours' block-layout predictions
    rebuilt into planes here, at 128x192 with predictions near the centre
    and some far from it (window sums past the weights' zero cut)."""
    rng = np.random.default_rng(K * bd)
    h, w = 128, 192
    R, C = h // 16, w // 16
    dt = torch.uint8 if bd == 8 else torch.int16
    center = [_plane(rng, h, w, bd, dt), _plane(rng, h // 2, w // 2, bd, dt),
              _plane(rng, h // 2, w // 2, bd, dt)]
    hi = (1 << bd) - 1

    def near(c, spread):
        return (c.to(torch.int32) + torch.from_numpy(
            rng.integers(-spread, spread + 1, c.shape).astype(np.int32))).clamp(0, hi)

    def blocks(p, n):
        return p.reshape(p.shape[0] // n, n, p.shape[1] // n, n).permute(0, 2, 1, 3) \
            .reshape(-1, n, n).contiguous()

    planes = [[near(c, 4 << (bd - 8) if k % 2 else hi) for c in center] for k in range(K)]
    preds_y = [blocks(p[0], 16) for p in planes]
    preds_uv = [torch.stack([blocks(p[1], 8), blocks(p[2], 8)]) for p in planes]
    h2 = tf_torch.noise_decay_plain(center[0], 120, bd)
    got = tf_torch.tf_filter_planes(center, preds_y, preds_uv, h2, bd)
    assert blocks(got[0], 16).shape == (R * C, 16, 16)
    for pl in range(3):
        want = tf_torch.tf_filter_plain(center[pl], torch.stack([p[pl] for p in planes]),
                                        float(h2), bd)
        assert got[pl].dtype == torch.int32
        assert torch.equal(got[pl], want), f"plane {pl}"
        assert (got[pl] != center[pl].to(torch.int32)).any()


def test_tf_filter_planes_refuses_what_the_kernel_cannot_take():
    """Planes that are not multiples of 64, chroma of another size, no
    neighbour or more than the kernel's TF_KMAX: ValueError on every
    device."""
    y = torch.zeros((64, 128), dtype=torch.uint8)
    uv = torch.zeros((32, 64), dtype=torch.uint8)
    py = torch.zeros((32, 16, 16), dtype=torch.int32)
    puv = torch.zeros((2, 32, 8, 8), dtype=torch.int32)
    h2 = torch.tensor(50.0)
    for center, k in (([y[:, :96], uv[:, :48], uv[:, :48]], 1), ([y, uv, uv[:16]], 1),
                      ([y, uv, uv], 0), ([y, uv, uv], tf_torch.TF_KMAX + 1)):
        with pytest.raises(ValueError):
            tf_torch.tf_filter_planes(center, [py] * k, [puv] * k, h2)
    assert tf_torch.tf_filter_planes([y, uv, uv], [py], [puv], h2)[0].shape == (64, 128)


def test_tf_launch_bounds_count_the_plane_dtype():
    """utils/profile_keyframes' bounds of K12's and K13's launches, from
    their C arguments: the centre in its plane dtype (1 byte a sample at 8
    bits, 2 in the 16-bit forms), 4 bytes a prediction and output sample."""
    from svtav1_tpu_torch.utils import profile_keyframes as pk

    K, R, C = 5, 68, 120
    samples = R * C * 384  # a 16x16 luma block and its two 8x8 chroma blocks
    args = (None,) * 8 + (K, R, C, 8, tf_torch.TF_TABLE, None)
    assert pk.launch_bound("tf_filter", args) == (samples * (1 + 4 * K + 4) + 4,
                                                  K * samples * 20)
    assert pk.launch_bound("tf_filter16", args)[0] == samples * (2 + 4 * K + 4) + 4
    noise = (None,) * 4 + (1088, 1920, 8, 0.2, 3.5, None)
    assert pk.launch_bound("tf_noise", noise) == (1088 * 1920 + 20, 1088 * 1920 * 20)
    assert pk.launch_bound("tf_noise16", noise)[0] == 1088 * 1920 * 2 + 20
