"""GOP / prediction-structure scheduling (hierarchical mini-GoPs), copied
from svtav1_tpu's pipeline/gop.py for the port.

Simplified analog of the reference's Picture Decision process
(pd_process.c set_mini_gop_structure :3881 / av1_generate_rps_info :1333):
display-order frames are grouped into dyadic mini-GoPs; the base frame is
coded first (hidden), then the dyadic middles, with show_existing_frame
emitted when a previously-coded hidden frame reaches its display time.

Layers (mini-GoP of 4):  base L0 -> middle L1 -> odd frames L2.
Per-layer qindex offsets mirror the reference's hierarchical QP scaling.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class CodedFrame:
    """One entry of the coding schedule."""

    disp_idx: int  # display index (absolute)
    is_key: bool
    show: bool  # shown when coded (end of its mini-GoP span)
    layer: int  # temporal layer (0 = base)
    past_idx: int | None  # display idx of past ref (LAST)
    future_idx: int | None  # display idx of future ref (ALTREF), if any
    show_existing: list = field(default_factory=list)  # disp idxs to show after this


# per-layer qindex offsets (key, L0, L1, L2) — hierarchical QP scaling
KEY_Q_OFFSET = -12
LAYER_Q_OFFSET = (0, 8, 12)


def _dyadic_order(lo: int, hi: int, past: int, out: list, layer: int) -> None:
    """Code the middle of (lo, hi) then recurse: left half, right half."""
    if hi - lo <= 1:
        return
    mid = (lo + hi) // 2
    out.append(CodedFrame(disp_idx=mid, is_key=False, show=False, layer=layer,
                          past_idx=lo, future_idx=hi))
    _dyadic_order(lo, mid, lo, out, layer + 1)
    _dyadic_order(mid, hi, mid, out, layer + 1)


def schedule_minigop(base_idx: int, size: int) -> list:
    """Coding schedule for display frames (base_idx, base_idx + size].

    base_idx is the already-coded anchor (key or previous base)."""
    end = base_idx + size
    out = [CodedFrame(disp_idx=end, is_key=False, show=False, layer=0,
                      past_idx=base_idx, future_idx=None)]
    _dyadic_order(base_idx, end, base_idx, out, 1)
    # show flags + show_existing chains: display order is a strict prefix
    coded: set = set()
    displayed = base_idx
    for f in out:
        coded.add(f.disp_idx)
        f.show = f.disp_idx == displayed + 1
        if f.show:
            displayed = f.disp_idx
            while displayed + 1 <= end and (displayed + 1) in coded:
                f.show_existing.append(displayed + 1)
                displayed += 1
    return out
