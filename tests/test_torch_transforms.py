"""K2 (txfm_quant_recon) plain version against the JAX transforms.

Same numpy inputs through transforms_jax (fwd + quantize + clip, dequantize
+ inverse + add) and through the port's plain version on the CPU. Levels and
recon must be exact; the SSE must equal numpy's int64 sum exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svtav1_tpu.constants.av1 import TxType
from svtav1_tpu.ops import quantize as quant_ref
from svtav1_tpu.ops import transforms as T_ref
from svtav1_tpu.ops import transforms_jax as TJ
from svtav1_tpu_torch.ops import transforms_torch as TT

TYPES = [int(TxType.DCT_DCT), int(TxType.ADST_DCT), int(TxType.DCT_ADST), int(TxType.ADST_ADST)]


def _inputs(n, bd, L, seed):
    rng = np.random.default_rng(seed)
    hi = (1 << bd) - 1
    src = rng.integers(0, hi + 1, (L, n, n)).astype(np.int32)
    # predictions near the source (real residuals) and a few far ones
    pred = np.clip(src + rng.integers(-40 << (bd - 8), 40 << (bd - 8), (L, n, n)), 0, hi)
    pred[0] = rng.integers(0, hi + 1, (n, n))
    return src, pred.astype(np.int32)


def _jax_ref(src, pred, tx_type, dq_dc, dq_ac, bd):
    n = src.shape[-1]
    ls = quant_ref.tx_scale(n, n)
    coeff = TJ.fwd_txfm2d_j(jnp.asarray(src - pred), tx_type, bd)
    lv = jnp.clip(TJ.quantize_j(coeff, dq_dc, dq_ac, ls), -32767, 32767)
    dqc = TJ.dequantize_j(lv, dq_dc, dq_ac, ls, bd)
    rec = TJ.inv_txfm2d_add_j(dqc, jnp.asarray(pred), tx_type, bd)
    return np.asarray(lv), np.asarray(rec)


def test_stage_tables_match_reference_builder():
    """The port's stage tables equal the JAX package's (transforms.stage_table)."""
    for n in TT.SIZES:
        port = TT.numpy_stage_tables(n)
        for (name, cb), stages in port.items():
            ref = T_ref.stage_table(name, cb)
            assert len(ref) == len(stages)
            for a, b in zip(ref, stages):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("n", [4, 8, 16, 32, 64])
def test_plain_matches_jax_static_types(n, bd):
    types = TYPES if n <= 16 else TYPES[:1]
    q = 90 if bd == 8 else 140
    dq_dc, dq_ac = quant_ref.dc_q(q, bd), quant_ref.ac_q(q, bd)
    L = 6 if n < 64 else 3
    for t in types:
        src, pred = _inputs(n, bd, L, seed=n * 7 + t + bd)
        lv_ref, rec_ref = _jax_ref(src, pred, t, dq_dc, dq_ac, bd)
        va, ha = TT.tx_flags(t, L, "cpu")
        lv, rec, sse = TT.txfm_quant_recon(torch.from_numpy(src), torch.from_numpy(pred), va, ha,
                                           dq_dc, dq_ac, bd, want_sse=True)
        adj = min(n, 32)
        np.testing.assert_array_equal(lv.numpy(), lv_ref[:, :adj, :adj])
        assert not lv_ref[:, adj:, :].any() and not lv_ref[:, :, adj:].any()
        np.testing.assert_array_equal(rec.numpy(), rec_ref)
        d = rec_ref.astype(np.int64) - src
        np.testing.assert_array_equal(sse.numpy(), (d * d).sum(axis=(1, 2)))


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_plain_matches_jax_sel_variants(n):
    """Per-lane DCT/ADST (fwd_txfm2d_sel_j / inv_txfm2d_add_sel_j)."""
    bd = 8
    L = 8
    src, pred = _inputs(n, bd, L, seed=100 + n)
    rng = np.random.default_rng(n)
    v = rng.integers(0, 2, L).astype(bool)
    h = rng.integers(0, 2, L).astype(bool)
    dq_dc, dq_ac = quant_ref.dc_q(60, bd), quant_ref.ac_q(60, bd)
    ls = quant_ref.tx_scale(n, n)
    coeff = TJ.fwd_txfm2d_sel_j(jnp.asarray(src - pred), jnp.asarray(v), jnp.asarray(h), bd)
    lv_ref = jnp.clip(TJ.quantize_j(coeff, dq_dc, dq_ac, ls), -32767, 32767)
    rec_ref = TJ.inv_txfm2d_add_sel_j(TJ.dequantize_j(lv_ref, dq_dc, dq_ac, ls, bd),
                                      jnp.asarray(pred), jnp.asarray(v), jnp.asarray(h), bd)
    lv, rec, _ = TT.txfm_quant_recon(torch.from_numpy(src), torch.from_numpy(pred),
                                     torch.from_numpy(v), torch.from_numpy(h), dq_dc, dq_ac, bd)
    np.testing.assert_array_equal(lv.numpy(), np.asarray(lv_ref))
    np.testing.assert_array_equal(rec.numpy(), np.asarray(rec_ref))


def test_plain_repeated_source_lanes():
    """rep > 1: lane i transforms src[i // rep] - pred[i] (the decide's
    all-modes batch)."""
    n, bd, rep = 8, 8, 7
    src, _ = _inputs(n, bd, 3, seed=5)
    _, pred = _inputs(n, bd, 3 * rep, seed=6)
    va, ha = TT.tx_flags(int(TxType.DCT_DCT), 3 * rep, "cpu")
    dq = (quant_ref.dc_q(120, bd), quant_ref.ac_q(120, bd))
    lv, rec, sse = TT.txfm_quant_recon(torch.from_numpy(src), torch.from_numpy(pred), va, ha,
                                       *dq, bd, rep=rep, want_recon=False, want_sse=True)
    assert rec is None
    lv_ref, rec_ref = _jax_ref(np.repeat(src, rep, 0), pred, int(TxType.DCT_DCT), *dq, bd)
    np.testing.assert_array_equal(lv.numpy(), lv_ref)
    d = rec_ref.astype(np.int64) - np.repeat(src, rep, 0)
    np.testing.assert_array_equal(sse.numpy(), (d * d).sum(axis=(1, 2)))


@pytest.mark.parametrize("n", [4, 8, 16, 32, 64])
def test_plain_halves_match_jax(n):
    """K2's two halves around RDOQ: txfm_quant gives the levels and the
    unquantized coefficients of the coded region; recon_from_levels
    dequantizes edited levels, inverts and adds the prediction."""
    bd = 8
    L = 8 if n < 64 else 3
    src, pred = _inputs(n, bd, L, seed=200 + n)
    rng = np.random.default_rng(300 + n)
    v = rng.integers(0, 2, L).astype(bool) & (n <= 16)
    h = rng.integers(0, 2, L).astype(bool) & (n <= 16)
    dq_dc, dq_ac = quant_ref.dc_q(100, bd), quant_ref.ac_q(100, bd)
    ls = quant_ref.tx_scale(n, n)
    adj = min(n, 32)
    coeff = TJ.fwd_txfm2d_sel_j(jnp.asarray(src - pred), jnp.asarray(v), jnp.asarray(h), bd)
    lv_ref = np.asarray(jnp.clip(TJ.quantize_j(coeff, dq_dc, dq_ac, ls), -32767, 32767))
    args = (torch.from_numpy(v), torch.from_numpy(h), dq_dc, dq_ac, bd)
    lv, co = TT.txfm_quant(torch.from_numpy(src), torch.from_numpy(pred), *args)
    np.testing.assert_array_equal(lv.numpy(), lv_ref[:, :adj, :adj])
    np.testing.assert_array_equal(co.numpy(), np.asarray(coeff)[:, :adj, :adj])
    # lower every other nonzero level by one, as RDOQ may
    edit = lv_ref.copy()
    nz = np.flatnonzero(edit)[::2]
    edit.flat[nz] -= np.sign(edit.flat[nz])
    rec_ref = TJ.inv_txfm2d_add_sel_j(TJ.dequantize_j(jnp.asarray(edit), dq_dc, dq_ac, ls, bd),
                                      jnp.asarray(pred), jnp.asarray(v), jnp.asarray(h), bd)
    rec = TT.recon_from_levels(torch.from_numpy(np.ascontiguousarray(edit[:, :adj, :adj])),
                               torch.from_numpy(pred), *args)
    np.testing.assert_array_equal(rec.numpy(), np.asarray(rec_ref))


@pytest.mark.parametrize("qindex", [0, 120, 255])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_tpl_cost_is_k2_halves_with_cost_epilogues(n, bd, qindex):
    """The identity K15 rests on: tpl_cost is K2 on DCT_DCT lanes with its
    own epilogues. Mode 0 is sum |coeff| >> 2 of txfm_quant's coefficients
    (the sum wrapping in int32), mode 1's error sum ((coeff - dqc) >> 2)^2 in
    int64 of the same call's coefficients and dequantized levels, its recon
    recon_from_levels of those levels. The residuals reach 2^14 / min(n, 16),
    so that at qindex 0 levels clip at +-32767."""
    rng = np.random.default_rng(1000 * n + 10 * bd + qindex)
    amp, L = (1 << 14) // min(n, 16), 8
    src = rng.integers(0, amp, (L, n, n))
    pred = rng.integers(0, amp, (L, n, n))
    src[0] = rng.integers(0, 2, (n, n)) * amp  # +-amp checkerboards and a flat lane
    pred[0] = amp - src[0]
    src[1], pred[1] = amp, 0
    pred[2:5] = np.clip(src[2:5] + rng.integers(-40, 41, (3, n, n)), 0, amp)
    s_t, p_t = torch.from_numpy(src.astype(np.int32)), torch.from_numpy(pred.astype(np.int32))
    dq_dc, dq_ac = quant_ref.dc_q(qindex, bd), quant_ref.ac_q(qindex, bd)
    va, ha = TT.tx_flags(int(TxType.DCT_DCT), L, "cpu")
    lv, co = TT.txfm_quant_plain(s_t, p_t, va, ha, dq_dc, dq_ac, bd)
    lv64, co64 = lv.numpy().astype(np.int64), co.numpy().astype(np.int64)
    if qindex == 0:
        assert (np.abs(lv64) == 32767).any()
    satd = TT.tpl_cost_plain(s_t, p_t, 0, dq_dc, dq_ac, bd)
    want = (np.abs(co64).sum(axis=(1, 2)) & 0xFFFFFFFF).astype(np.uint32).view(np.int32) >> 2
    np.testing.assert_array_equal(satd.numpy(), want)
    dq = np.full((n, n), dq_ac, np.int64)
    dq[0, 0] = dq_dc
    ls = quant_ref.tx_scale(n, n)
    dqc = np.sign(lv64) * np.minimum((np.abs(lv64) * dq) >> ls, (1 << (bd + 7)) - 1)
    err, rec = TT.tpl_cost_plain(s_t, p_t, 1, dq_dc, dq_ac, bd, want_recon=True)
    np.testing.assert_array_equal(err.numpy(), (((co64 - dqc) >> 2) ** 2).sum(axis=(1, 2)))
    np.testing.assert_array_equal(
        rec.numpy(), TT.recon_from_levels_plain(lv, p_t, va, ha, dq_dc, dq_ac, bd).numpy())


@pytest.mark.parametrize("n", [4, 8, 16, 32, 64])
def test_generated_networks_match_committed_header(n):
    """csrc/txfm_nets.cuh is gen_txfm_nets' output: every (name, cos_bit)
    network of numpy_stage_tables(n) and the size's TxNets<n> dispatch are
    in the committed header, and the whole text equals the generator's."""
    from svtav1_tpu_torch.csrc import gen_txfm_nets as gen

    with open(gen.HEADER) as f:
        committed = f.read()
    assert gen.size_text(n) in committed
    for name, cb in TT.numpy_stage_tables(n):
        assert f"void {name}_c{cb}(int (&x)[{n}]" in committed
    assert f"struct TxNets<{n}>" in committed
    assert committed == gen.header_text()


_HARNESS_COMMON = """#pragma once
#define __device__
#define __forceinline__ inline
static inline int round_shift(int x, int bit) {
  return bit == 0 ? x : (int)((unsigned)x + (1u << (bit - 1))) >> bit;
}
"""


@pytest.fixture(scope="module")
def nets_binary(tmp_path_factory):
    """The committed header's networks compiled for the host with g++ (the
    CUDA qualifiers defined away): reads `name n lo hi x0 .. x(n-1)` lines,
    prints the network's output line."""
    import re
    import shutil
    import subprocess

    from svtav1_tpu_torch.csrc import gen_txfm_nets as gen

    d = tmp_path_factory.mktemp("txfm_nets")
    shutil.copy(gen.HEADER, d / "txfm_nets.cuh")
    (d / "common.cuh").write_text(_HARNESS_COMMON)
    with open(gen.HEADER) as f:
        fns = re.findall(r"void (\w+_c\d+)\(int \(&x\)\[(\d+)\](, int lo, int hi)?\)", f.read())
    calls = "\n".join(
        f'    if (!std::strcmp(name, "{fn}")) {fn}(*(int(*)[{n}])x{", lo, hi" if inv else ""});'
        for fn, n, inv in fns)
    (d / "h.cpp").write_text(
        '#include <cstdio>\n#include <cstring>\n#include "txfm_nets.cuh"\nusing namespace txnets;\n'
        "int main() {\n  char name[64]; int n, lo, hi, x[64];\n"
        '  while (std::scanf("%63s %d %d %d", name, &n, &lo, &hi) == 4) {\n'
        '    for (int i = 0; i < n; ++i) std::scanf("%d", &x[i]);\n'
        f"{calls}\n"
        '    for (int i = 0; i < n; ++i) std::printf("%d ", x[i]);\n    std::printf("\\n");\n  }\n}\n')
    subprocess.run(["g++", "-O1", "-std=c++17", str(d / "h.cpp"), "-o", str(d / "h")], check=True,
                   capture_output=True, timeout=300)
    return str(d / "h")


@pytest.mark.parametrize("n", [4, 8, 16, 32, 64])
def test_generated_networks_compute_the_stage_tables(nets_binary, n):
    """Each network of the committed header, compiled for the host, gives
    the plain version's 1-D stage-table result (_txfm1d_table; ADST4 by
    _adst4) bit for bit on random lines, with inputs across the int32 range
    so that the products wrap, and with both inverse clamp ranges."""
    import subprocess

    rng = np.random.default_rng(400 + n)
    tabs = TT.tables_for(n, "cpu")
    cases = []
    for (name, cb), stages in tabs.stages.items():
        for trial in range(12):
            big = trial % 3 == 0
            x = rng.integers(-(2 ** 31) if big else -6000, 2 ** 31 - 1 if big else 6000, n)
            bits = 16 if trial % 2 else 18
            inv = name.startswith("i")
            want = TT._txfm1d_table(torch.as_tensor(x.astype(np.int32))[None], stages,
                                    bits if inv else None)[0]
            cases.append((f"{name}_c{cb}", bits, x, want))
    if n == 4:
        for cb, inv in ((13, False), (12, True)):
            for _ in range(12):
                x = rng.integers(-6000, 6000, 4)
                want = TT._adst4(torch.as_tensor(x.astype(np.int32))[None], cb, inv)[0]
                cases.append((f"{'i' if inv else 'f'}adst4_c{cb}", 16, x, want))
    lines = [f"{fn} {n} {-(1 << (b - 1))} {(1 << (b - 1)) - 1} " + " ".join(map(str, x))
             for fn, b, x, _ in cases]
    out = subprocess.run([nets_binary], input="\n".join(lines) + "\n", capture_output=True,
                         text=True, check=True, timeout=60).stdout.split("\n")
    for (fn, _b, _x, want), got in zip(cases, out):
        np.testing.assert_array_equal(np.array(got.split(), np.int64), want.numpy(), err_msg=fn)
    assert len([o for o in out if o]) == len(cases)
