"""Per-stage wall-clock profiler (the analog of the reference's external
profiling workflow — SURVEY §5.1; the SRM_REPORT/FIFO-occupancy debug taps).

Usage: `with stage("decide"): ...` around host-blocking pipeline sections.
Enabled by default (the overhead is two clock reads); `report()` returns the
accumulated seconds per stage and `reset()` clears. Device work dispatched
asynchronously is attributed to the stage that blocks on it (np.asarray /
block_until_ready), so wrap the blocking fetch, not the dispatch.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

_acc: dict = defaultdict(float)
_cnt: dict = defaultdict(int)


@contextmanager
def stage(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _acc[name] += time.perf_counter() - t0
        _cnt[name] += 1


def add(name: str, seconds: float) -> None:
    _acc[name] += seconds
    _cnt[name] += 1


def count(name: str, k: int) -> None:
    """Add k to the count of `name` (events without a time of their own,
    such as the waves of a commit)."""
    _cnt[name] += k


def report() -> dict:
    return {k: round(v, 4) for k, v in sorted(_acc.items(), key=lambda kv: -kv[1])}


def counts() -> dict:
    return dict(_cnt)


def reset() -> None:
    _acc.clear()
    _cnt.clear()
