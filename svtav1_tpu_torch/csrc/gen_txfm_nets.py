"""Write csrc/txfm_nets.cuh: K2's 1-D DCT/ADST stage networks as C++ with
every index, weight, shift and clamp flag a literal.

Each network of ops/transforms_torch.numpy_stage_tables(n) (one per
(name, cos_bit) key; fdct16 comes with cos bits 13 and 12, fdct64 with 13
and 10) becomes one function on a line held in registers, `int (&x)[n]`.
Every stage output is

    y[k] = (wa * x[ia] + wb * x[ib] + rnd) >> sh

in int32 that wraps (the products in `unsigned`, as common.cuh's
wrap_mad2), clamped to [lo, hi] where the table's clamp flag is set in an
inverse network. Outputs that copy one input are renamed, not computed.
ADST4 is the sinpi code of the plain version's _adst4 (ops/transforms_torch.py)
with the sinpi values as literals.
`TxNets<n>` picks a line's network from its ADST flag.

Run from the repository root after a change to the stage tables:
    python -m svtav1_tpu_torch.csrc.gen_txfm_nets
tests/test_torch_transforms.py regenerates the text and requires it to
equal the committed header.
"""
from __future__ import annotations

import os

HEADER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "txfm_nets.cuh")

PREAMBLE = """\
// Generated by svtav1_tpu_torch/csrc/gen_txfm_nets.py from
// constants/data/txfm_stages.npz; do not edit. K2's 1-D stage networks with
// their indices, weights, shifts and clamp flags as literals, one function per
// (network, cos bit) on a line held in registers. See the generator.
#pragma once
#include "common.cuh"

namespace txnets {

// (wa * a + wb * b + rnd) >> sh in int32 that wraps, as wrap_mad2
template <int WA, int WB, int SH>
__device__ __forceinline__ int m2(int a, int b) {
  constexpr unsigned kRnd = SH > 0 ? 1u << (SH - 1) : 0u;
  return (int)((unsigned)a * (unsigned)WA + (unsigned)b * (unsigned)WB + kRnd) >> SH;
}

__device__ __forceinline__ int cl(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }
"""

ADST4 = """
// ADST4 (sinpi; ops/transforms_torch.py _adst4) at cos bit {cb}
__device__ __forceinline__ void {fn}(int (&x)[4]) {{
  const unsigned x0 = x[0], x1 = x[1], x2 = x[2], x3 = x[3];
  const unsigned s1p = {s1}u, s2p = {s2}u, s3p = {s3}u, s4p = {s4}u;
{body}}}
"""
ADST4_FWD = """\
  const unsigned a0 = s1p * x0 + s2p * x1 + s4p * x3;
  const unsigned a1 = s3p * (x0 + x1 - x3);
  const unsigned a2 = s4p * x0 - s1p * x1 + s2p * x3;
  const unsigned a3 = s3p * x2;
  x[0] = round_shift((int)(a0 + a3), {cb});
  x[1] = round_shift((int)a1, {cb});
  x[2] = round_shift((int)(a2 - a3), {cb});
  x[3] = round_shift((int)(a2 - a0 + a3), {cb});
"""
ADST4_INV = """\
  const unsigned s0 = s1p * x0 + s4p * x2 + s2p * x3;
  const unsigned s1 = s2p * x0 - s1p * x2 - s4p * x3;
  const unsigned s2 = s3p * ((x0 - x2) + x3);
  const unsigned s3 = s3p * x1;
  x[0] = round_shift((int)(s0 + s3), {cb});
  x[1] = round_shift((int)(s1 + s3), {cb});
  x[2] = round_shift((int)s2, {cb});
  x[3] = round_shift((int)(s0 + s1 - s3), {cb});
"""


def _fn_name(name: str, cos_bit: int) -> str:
    return f"{name}_c{cos_bit}"


def _rows(stmts, per=8):
    return ["  " + " ".join(stmts[i:i + per]) for i in range(0, len(stmts), per)]


def network_text(name: str, cos_bit: int, stages) -> str:
    """One network as a C++ function on `int (&x)[n]`; inverse networks
    take the clamp bounds of their pass."""
    n = len(stages[0][0])
    inverse = name.startswith("i")
    args = f"int (&x)[{n}]" + (", int lo, int hi" if inverse else "")
    lines = [f"__device__ __forceinline__ void {_fn_name(name, cos_bit)}({args}) {{"]
    lines += _rows([f"const int v{k} = x[{k}];" for k in range(n)])
    cur = [f"v{k}" for k in range(n)]
    for s, (ia, wa, ib, wb, sh, clamp2) in enumerate(stages):
        nxt = []
        for k in range(n):
            a, b = cur[int(ia[k])], cur[int(ib[k])]
            WA, WB, SH, C = int(wa[k]), int(wb[k]), int(sh[k]), bool(clamp2[k]) and inverse
            if WA == 1 and WB == 0 and SH == 0 and not C:
                nxt.append(a)  # a copy: rename
                continue
            expr = f"m2<{WA}, {WB}, {SH}>({a}, {b if WB else a})"
            if C:
                expr = f"cl({expr}, lo, hi)"
            var = f"s{s}_{k}"
            lines.append(f"  const int {var} = {expr};")
            nxt.append(var)
        cur = nxt
    lines += _rows([f"x[{k}] = {cur[k]};" for k in range(n)])
    lines.append("}")
    return "\n".join(lines) + "\n"


def _adst4_text(cos_bit: int, inverse: bool) -> str:
    from ..ops import transforms as T

    sp = [int(v) for v in T.sinpi_arr(cos_bit)]
    body = (ADST4_INV if inverse else ADST4_FWD).format(cb=cos_bit)
    return ADST4.format(cb=cos_bit, fn=f"{'i' if inverse else 'f'}adst4_c{cos_bit}",
                        s1=sp[1], s2=sp[2], s3=sp[3], s4=sp[4], body=body)


def size_text(n: int) -> str:
    """Every network of block size n and its TxNets<n> dispatch."""
    from ..ops import transforms as T
    from ..ops import transforms_torch as TT

    cb_col, cb_row = TT._cos_bits(n)
    cbi = T.INV_COS_BIT
    tables = TT.numpy_stage_tables(n)
    parts = [f"\n// ---- {n}-point networks\n"]
    parts += [network_text(name, cb, stages) for (name, cb), stages in tables.items()]
    if n == 4:
        parts += [_adst4_text(cb, False) for cb in sorted({cb_col, cb_row})]
        parts.append(_adst4_text(cbi, True))

    def pick(kind: str, cb: int, extra: str = "") -> str:
        dct = f"{kind}dct{n}_c{cb}(x{extra})"
        if n > 16:
            return f"{dct};"
        adst = f"{kind}adst{n}_c{cb}(x{extra if n > 4 else ''})"
        return f"if (adst) {adst}; else {dct};"

    parts.append(f"""
template <>
struct TxNets<{n}> {{
  static __device__ __forceinline__ void fwd_col(int (&x)[{n}], bool adst) {{ {pick("f", cb_col)} }}
  static __device__ __forceinline__ void fwd_row(int (&x)[{n}], bool adst) {{ {pick("f", cb_row)} }}
  static __device__ __forceinline__ void inv(int (&x)[{n}], bool adst, int lo, int hi) {{
    {pick("i", cbi, ", lo, hi")}
  }}
}};
""")
    return "".join(parts)


def header_text(sizes=(4, 8, 16, 32, 64)) -> str:
    body = "".join(size_text(n) for n in sizes)
    return (PREAMBLE + "\n// TxNets<n>: fwd_col, fwd_row (forward, no clamp) and inv (inverse,\n"
            "// clamp2 outputs to [lo, hi]); `adst` picks the ADST (DCT above 16 points)\n"
            "template <int N>\nstruct TxNets;\n" + body + "\n}  // namespace txnets\n")


def main() -> None:
    with open(HEADER, "w") as f:
        f.write(header_text())
    print(HEADER)


if __name__ == "__main__":
    main()
