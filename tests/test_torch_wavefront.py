"""The commit's phase-B task table (pipeline/wavefront.wave_tasks, the work
list of K16 commit_wave) on schedules of synthetic 1080p-shaped frames: a
key frame, a P frame and a B frame, each a random quadtree of 8x8 to 64x64
leaves over 1920x1088 with random modes and, on inter frames, random
references (intra lanes among them). Every intra lane appears once per
plane, and every task's above, left and top-left providers are inter lanes
(phase A) or lie in an earlier wave of the table. K16's byte count
(utils/profile_keyframes.commit_wave_work, its bound) is what K16 itself
reads and writes per task. The table's plain version runs in every CPU
encode-parity test."""
import numpy as np
import pytest

from svtav1_tpu_torch.pipeline import device_commit, wavefront
from svtav1_tpu_torch.pipeline.device_decide import SIZES
from svtav1_tpu_torch.utils import profile_keyframes as pk

W, H = 1920, 1088


def _leaves(g, R8: int, C8: int) -> list:
    """A random quadtree over whole 64x64 superblocks: (mi_row, mi_col, n)."""
    out = []

    def split(r8, c8, n):
        if n > 8 and g.random() < 0.55:
            h = n // 16
            for dr, dc in ((0, 0), (0, h), (h, 0), (h, h)):
                split(r8 + dr, c8 + dc, n // 2)
        else:
            out.append((2 * r8, 2 * c8, n))

    for r in range(0, R8, 8):
        for c in range(0, C8, 8):
            split(r, c, 64)
    return out


def _decisions(g, kind: str, R8: int, C8: int) -> dict:
    """Per-size decision grids as the decide leaves them."""
    dec = {}
    for n in SIZES:
        shape = (R8 * 8 // n, C8 * 8 // n)
        d = dict(mode=g.integers(0, 13, shape).astype(np.int32),
                 tx=g.integers(0, 4, shape).astype(np.int32))
        if kind != "key":
            # -1 intra, else a reference index; a third of the blocks intra
            ref = np.where(g.random(shape) < 0.33, -1, g.integers(0, 2, shape))
            d["ref"] = ref.astype(np.int32)
            d["mvy"] = g.integers(-64, 64, shape).astype(np.int32)
            d["mvx"] = g.integers(-64, 64, shape).astype(np.int32)
        if kind == "B":
            d["ref2"] = np.where(g.random(shape) < 0.5, -1, 2).astype(np.int32)
            d["mv2y"] = g.integers(-64, 64, shape).astype(np.int32)
            d["mv2x"] = g.integers(-64, 64, shape).astype(np.int32)
        dec[n] = d
    return dec


def _schedule(kind: str, seed: int):
    """(schedule, task table) of a synthetic frame of `kind`."""
    g = np.random.default_rng(seed)
    R8, C8 = H // 8, W // 8
    leaves = _leaves(g, R8, C8)
    sched, _ = device_commit._build_schedule([leaves], [_decisions(g, kind, R8, C8)],
                                             (0, 0, W, H))
    return sched, wavefront.wave_tasks(sched)


@pytest.mark.parametrize("kind, seed", [("key", 0), ("P", 1), ("B", 2)])
def test_task_table_covers_intra_lanes_after_their_providers(kind, seed):
    R8, C8 = H // 8, W // 8
    sched, table = _schedule(kind, seed)
    si, pl, lane = table.decode()

    # every intra lane of every size exactly once per plane
    n_intra = 0
    for s, n in enumerate(SIZES):
        NI, N = int(sched[n]["NI"]), len(sched[n]["coords"])
        n_intra += N - NI
        for p in range(3):
            got = np.sort(lane[(si == s) & (pl == p)])
            np.testing.assert_array_equal(got, np.arange(NI, N), err_msg=f"n={n} plane {p}")
    assert len(table.tasks) == 3 * n_intra
    if kind == "key":
        assert all(sched[n]["NI"] == 0 for n in SIZES)
    else:
        assert 0 < n_intra < sum(len(sched[n]["coords"]) for n in SIZES)

    # each task's position in the table: its wave's index k
    k_of_task = np.repeat(np.arange(len(table.waves)), np.diff(table.wave_start))
    assert np.all(np.diff(table.waves) > 0) and table.max_tasks == np.diff(table.wave_start).max()
    # per 8x8 cell: the table wave index of the intra lane covering it, -1
    # under an inter lane (written in phase A)
    cell_k = np.full((R8, C8), -2, np.int64)
    for s, n in enumerate(SIZES):
        c = sched[n]["coords"]
        n8 = n // 8
        k_lane = np.full(len(c), -1, np.int64)
        mine = si == s
        k_lane[lane[mine]] = k_of_task[mine]
        for a in range(n8):
            for b in range(n8):
                cell_k[c[:, 1] + a, c[:, 2] + b] = k_lane
    assert (cell_k >= -1).all()  # the leaves tile the frame

    for s, n in enumerate(SIZES):
        mine = (si == s) & (pl == 0)
        c = sched[n]["coords"][lane[mine]]
        k = k_of_task[mine]
        r8, c8, n8 = c[:, 1], c[:, 2], n // 8
        # the schedule's wave number of each task is its wave's
        np.testing.assert_array_equal(table.waves[k], r8 + c8 + n8 - 1)
        providers = []
        for a in range(n8):
            providers.append(np.where(r8 > 0, cell_k[np.maximum(r8 - 1, 0), c8 + a], -1))
            providers.append(np.where(c8 > 0, cell_k[r8 + a, np.maximum(c8 - 1, 0)], -1))
        providers.append(np.where((r8 > 0) & (c8 > 0),
                                  cell_k[np.maximum(r8 - 1, 0), np.maximum(c8 - 1, 0)], -1))
        assert (np.max(providers, axis=0) < k).all(), f"n={n}: a provider is not done before"


@pytest.mark.parametrize("kind, seed, rdoq", [("key", 3, False), ("P", 4, True), ("B", 5, True)])
def test_commit_wave_bound_counts_what_k16_moves(kind, seed, rdoq):
    """Per task K16 reads its code, mode and tx, the source block and the
    edges, and writes the levels, the recon and the frontier cells (the
    bottom row, the right column and one corner per 8x8 luma cell); its
    bound is the larger of those bytes over the memory rate and its lanes'
    operations over the int32 rate."""
    _, table = _schedule(kind, seed)
    si, pl, _ = table.decode()
    want = 0
    for s, p in zip(si.tolist(), pl.tolist()):
        n = SIZES[s]
        m = n // 2 if p else n
        want += 4 * (3 + m * m + 2 * m + 1 + min(m, 32) ** 2 + m * m + 2 * m + (n // 8) ** 2)
    work = pk.commit_wave_work(table, 4, rdoq)
    assert work["bytes"] == want
    no_rdoq = pk.commit_wave_work(table, 4, False)["ops"]
    assert work["ops"] > no_rdoq if rdoq else work["ops"] == no_rdoq
    assert work["bound_ms"] == max(want / pk.HBM_BYTES_PER_S,
                                   work["ops"] / pk.INT32_OPS_PER_S) * 1e3
