"""K1 (intra_pred) plain version against intra_device._predict_modes (JAX),
nmodes=7 and 13 (the directional modes), random edges and availability.
Exact, except for one deliberate divergence (ROADMAP queue 3): DC with
neither neighbour is 1 << (bd - 1) in the port, as in the normative
predictor (ops/intra.py) and every decoder, where the reference predicts
128 at every bit depth; `spec_dc` applies the port's rule to the
reference's output. The rule itself is held against ops/intra.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svtav1_tpu.pipeline import intra_device as ref
from svtav1_tpu_torch.ops import intra as intra_ops
from svtav1_tpu_torch.pipeline import intra_device as port


def spec_dc(want, ha, hl, bd: int):
    """The reference's predictions (B, nmodes, n, n) with the DC of lanes
    that have neither neighbour set to 1 << (bd - 1)."""
    want = want.copy()
    want[~ha & ~hl, 0] = 1 << (bd - 1)
    return want


@pytest.mark.parametrize("n", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("bd", [8, 10])
def test_predict_modes_plain_matches_jax(n, bd):
    rng = np.random.default_rng(n + bd)
    B = 12
    hi = (1 << bd) - 1
    above = rng.integers(0, hi + 1, (B, n)).astype(np.int32)
    left = rng.integers(0, hi + 1, (B, n)).astype(np.int32)
    tl = rng.integers(0, hi + 1, B).astype(np.int32)
    ha = rng.integers(0, 2, B).astype(bool)
    hl = rng.integers(0, 2, B).astype(bool)
    ha[:4] = [True, True, False, False]
    hl[:4] = [True, False, True, False]
    want = np.asarray(ref._predict_modes(jnp.asarray(above), jnp.asarray(left), jnp.asarray(tl),
                                         jnp.asarray(ha), jnp.asarray(hl), n, nmodes=7))
    want = spec_dc(want, ha, hl, bd)
    args = [torch.from_numpy(x) for x in (above, left, tl, ha, hl)]
    got = port._predict_modes(*args, n, nmodes=7, bd=bd)
    np.testing.assert_array_equal(got.numpy(), want)
    mode = rng.integers(0, 7, B).astype(np.int32)
    one = port.predict(*args, n, mode=torch.from_numpy(mode), bd=bd)
    np.testing.assert_array_equal(one.numpy(), want[np.arange(B), mode])


@pytest.mark.parametrize("n", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("bd", [8, 10])
def test_directional_plain_matches_jax(n, bd):
    """All 13 modes, with every availability combination: exact."""
    rng = np.random.default_rng(100 + n + bd)
    B = 16
    hi = (1 << bd) - 1
    above = rng.integers(0, hi + 1, (B, n)).astype(np.int32)
    left = rng.integers(0, hi + 1, (B, n)).astype(np.int32)
    tl = rng.integers(0, hi + 1, B).astype(np.int32)
    ha = np.arange(B) % 2 == 0
    hl = np.arange(B) % 4 < 2
    want = np.asarray(ref._predict_modes(jnp.asarray(above), jnp.asarray(left), jnp.asarray(tl),
                                         jnp.asarray(ha), jnp.asarray(hl), n, nmodes=13))
    want = spec_dc(want, ha, hl, bd)
    args = [torch.from_numpy(x) for x in (above, left, tl, ha, hl)]
    got = port._predict_modes(*args, n, nmodes=13, bd=bd)
    assert got.shape == (B, 13, n, n)
    np.testing.assert_array_equal(got.numpy(), want)
    mode = (np.arange(B) % 6 + 7).astype(np.int32)
    one = port.predict(*args, n, mode=torch.from_numpy(mode), bd=bd)
    np.testing.assert_array_equal(one.numpy(), want[np.arange(B), mode])


def test_directional_modes_raise():
    """The thirteen key-frame modes are the whole set: asking for more raises."""
    z = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="nmodes"):
        port._predict_modes(z, z, z[:, 0], z[:, 0] > 0, z[:, 0] > 0, 8, nmodes=14)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("n", [4, 8, 32])
def test_dc_rule_matches_the_normative_predictor(n, bd):
    """DC of every availability against ops/intra.py's dc_pred (the
    decoder's): with neither neighbour 1 << (bd - 1), 128 at 8 bits and
    512 at 10; with one or both, the rounded mean of the edges."""
    rng = np.random.default_rng(7 * n + bd)
    hi = (1 << bd) - 1
    for ha, hl in ((True, True), (True, False), (False, True), (False, False)):
        above = rng.integers(0, hi + 1, (3, n)).astype(np.int32)
        left = rng.integers(0, hi + 1, (3, n)).astype(np.int32)
        tl = rng.integers(0, hi + 1, 3).astype(np.int32)
        want = intra_ops.dc_pred(above, left, ha, hl, bd)
        args = [torch.from_numpy(x) for x in (above, left, tl, np.full(3, ha), np.full(3, hl))]
        got = port.predict(*args, n, mode=torch.zeros(3, dtype=torch.int32), bd=bd)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{ha} {hl}")
        if not (ha or hl):
            assert (got.numpy() == 1 << (bd - 1)).all()
