"""The commit's phase-B task table (pipeline/wavefront.wave_tasks, the work
list of K16 commit_wave) on schedules of synthetic 1080p-shaped frames: a
key frame, a P frame and a B frame, each a random quadtree of 8x8 to 64x64
leaves over 1920x1088 with random modes and, on inter frames, random
references (intra lanes among them). Every intra lane appears once per
plane, and every task's above, left and top-left providers are inter lanes
(phase A) or lie in an earlier wave of the table. K16's byte count
(utils/profile_keyframes.commit_wave_work, its bound) is what K16 itself
reads and writes per task. The owner map (what K16 looks up, per cell it
reads, before it waits on the owner's flag) names each cell's intra
writer, so each task's predecessor list is the set of intra writers of the
cells it reads, and it is complete:
small commits coded one task at a time, in random orders that respect only
the lists, equal the wave loop; K16's chain bound is the longest path
through them. The table's plain version runs in every CPU encode-parity
test."""
import numpy as np
import pytest
import torch

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
    return sched, wavefront.wave_tasks(sched, (1, R8, C8))


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


def _writers(sched, table):
    """Independently of wave_tasks: the owner map (per plane and 8x8 cell,
    the task of the intra lane covering it, -1 under an inter lane) and per
    task the set of tasks of its plane that write the cells it reads (the
    intra lanes covering the 8x8 cells above it over its width, left of it
    over its height, and its top-left cell), from the schedule's coords,
    one task at a time."""
    si, pl, lane = table.decode()
    R8, C8 = H // 8, W // 8
    lane_at = {}  # (r8, c8) -> (size index, lane) covering the cell
    for s, n in enumerate(SIZES):
        for ln, (_f, r8, c8) in enumerate(sched[n]["coords"]):
            for a in range(n // 8):
                for b in range(n // 8):
                    lane_at[(int(r8) + a, int(c8) + b)] = (s, ln)
    task_at = {(int(s), int(ln), int(p)): t for t, (s, p, ln) in enumerate(zip(si, pl, lane))}
    owner = np.full((3, 1, *wavefront.owner_grid(R8, C8)), -1, np.int64)
    for (r8, c8), (s, ln) in lane_at.items():
        for p in range(3):
            owner[p, 0, r8, c8] = task_at.get((s, ln, p), -1)
    out = []
    for s, p, ln in zip(si.tolist(), pl.tolist(), lane.tolist()):
        n8 = SIZES[s] // 8
        _f, r8, c8 = (int(v) for v in sched[SIZES[s]]["coords"][ln])
        cells = []
        if r8 > 0:
            cells += [(r8 - 1, c8 + a) for a in range(n8)]
        if c8 > 0:
            cells += [(r8 + a, c8 - 1) for a in range(n8)]
        if r8 > 0 and c8 > 0:
            cells.append((r8 - 1, c8 - 1))
        deps = {task_at.get((*lane_at[c], p)) for c in cells if c[0] < R8 and c[1] < C8}
        out.append(sorted(d for d in deps if d is not None))
    return owner, out


@pytest.mark.parametrize("kind, seed", [("key", 6), ("P", 7), ("B", 8)])
def test_predecessors_are_the_intra_writers_of_the_cells_read(kind, seed):
    """The owner map names each cell's intra writer, so each task's
    predecessor list (the owners of the cells it reads: K16 waits on
    exactly these flags) is the set of intra tasks of its plane that write
    the frontier cells it reads; every predecessor comes earlier in the
    table and in an earlier wave, and the dependency depth is at most the
    wave count."""
    sched, table = _schedule(kind, seed)
    T = len(table.tasks)
    want_owner, want = _writers(sched, table)
    assert table.owner.dtype == np.int32
    np.testing.assert_array_equal(table.owner, want_owner)
    ps, pr = wavefront.predecessors(table)
    assert ps.dtype == np.int32 and pr.dtype == np.int32 and len(ps) == T + 1
    for t in range(T):
        assert sorted(pr[ps[t]:ps[t + 1]].tolist()) == want[t], f"task {t}"
    owner = np.repeat(np.arange(T), np.diff(ps))
    assert (pr < owner).all()
    wave_of = np.repeat(np.arange(len(table.waves)), np.diff(table.wave_start))
    assert (wave_of[pr] < wave_of[owner]).all()
    depth = wavefront.chain_length(table)
    assert 1 <= depth <= len(table.waves)
    if kind != "key":  # intra blocks among inter ones: a shallow graph
        assert depth < len(table.waves)


def test_chain_length_is_the_longest_weighted_path():
    """chain_length against a plain recursion over the predecessor lists,
    with per-task weights and an edge cost."""
    _, table = _schedule("P", 9)
    T = len(table.tasks)
    ps, pr = wavefront.predecessors(table)
    w = np.random.default_rng(0).random(T)
    for weight, edge in ((w, 0.25), (np.ones(T), 0.0)):
        dist = np.zeros(T)
        for t in range(T):
            p = pr[ps[t]:ps[t + 1]]
            dist[t] = weight[t] + (max(dist[q] + edge for q in p) if len(p) else 0.0)
        assert wavefront.chain_length(table, weight, edge) == pytest.approx(dist.max(), rel=1e-12)
    assert wavefront.chain_length(table) == dist.max()


@pytest.mark.parametrize("kind, seed, rdoq", [("key", 10, True), ("P", 11, True)])
def test_commit_wave_chain_bound(kind, seed, rdoq):
    """K16's chain bound: the longest path of the predecessor graph with
    each task at one SM's share of the int32 rate (its own K1, K2 and K5
    operations, which sum to `ops`) and each edge one flag handoff; without
    a handoff time only the depth."""
    _, table = _schedule(kind, seed)
    work = pk.commit_wave_work(table, 4, rdoq)
    assert "chain_ms" not in work
    assert work["depth"] == wavefront.chain_length(table) <= len(table.waves)
    handoff = 0.001
    chain = pk.commit_wave_work(table, 4, rdoq, handoff)["chain_ms"]
    per_sm = pk.INT32_OPS_PER_S / pk.SMS
    mean_ms = work["ops"] / len(table.tasks) / per_sm * 1e3
    # at least the dearest task (above the mean) and the deepest path's
    # handoffs; the handoffs add at most one per edge of the longest path
    assert chain >= max(mean_ms, (work["depth"] - 1) * handoff)
    zero = pk.commit_wave_work(table, 4, rdoq, 0.0)["chain_ms"]
    assert zero < chain <= zero + (work["depth"] - 1) * handoff + 1e-12


def _small_commit(kind: str, seed: int, w: int = 128, h: int = 128):
    """A small commit's phase-B state: schedule, task table, source planes,
    frontier maps (random where phase A would have written them) and the
    lanes, as device_commit._commit_device builds them, on the CPU."""
    g = np.random.default_rng(seed)
    R8, C8 = h // 8, w // 8
    sched, _ = device_commit._build_schedule([_leaves(g, R8, C8)], [_decisions(g, kind, R8, C8)],
                                             (0, 0, w, h))
    table = wavefront.wave_tasks(sched, (1, R8, C8))

    def rand(*shape):
        return torch.from_numpy(g.integers(0, 256, shape).astype(np.int32))

    maps = ([rand(1, R8, w >> s) for s in (0, 1, 1)], [rand(1, C8, h >> s) for s in (0, 1, 1)],
            [rand(1, R8, C8) for _ in range(3)])
    src = [rand(1, h >> s, w >> s) for s in (0, 1, 1)]
    lanes = {}
    for n, s in sched.items():
        N, adj, nc = len(s["coords"]), min(n, 32), n // 2
        lanes[n] = dict(coords=torch.as_tensor(s["coords"], dtype=torch.long),
                        mode=torch.as_tensor(s["mode"], dtype=torch.int32),
                        tx=torch.as_tensor(s["tx"], dtype=torch.int32),
                        uv_tx=torch.as_tensor(s["uv_tx"], dtype=torch.int32),
                        ly=torch.zeros((N, adj, adj), dtype=torch.int32),
                        lu=torch.zeros((N, nc, nc), dtype=torch.int32),
                        lv=torch.zeros((N, nc, nc), dtype=torch.int32),
                        ry=torch.zeros((N, n, n), dtype=torch.int32),
                        ru=torch.zeros((N, nc, nc), dtype=torch.int32),
                        rv=torch.zeros((N, nc, nc), dtype=torch.int32))
    return sched, table, src, maps, lanes


def _copy(maps, lanes):
    return ([[m.clone() for m in ms] for ms in maps],
            {n: {k: v.clone() for k, v in L.items()} for n, L in lanes.items()})


@pytest.mark.parametrize("kind, seed, rdoq", [("key", 12, True), ("P", 13, True),
                                              ("key", 14, False)])
def test_tasks_in_any_order_of_their_predecessors_equal_the_wave_loop(kind, seed, rdoq):
    """The predecessor lists are complete: each task coded alone (the wave
    loop's own _code_group on one lane), in a seeded random order that
    respects only the predecessor lists, gives the wave loop's levels,
    recon and frontier maps."""
    from svtav1_tpu_torch.constants.cdf import get_q_ctx
    from svtav1_tpu_torch.ops import quantize as quant_ops
    from svtav1_tpu_torch.pipeline.intra_md import rd_lambda

    q = 120
    dq_dc, dq_ac, lam = quant_ops.dc_q(q), quant_ops.ac_q(q), rd_lambda(q)
    qctx = get_q_ctx(q) if rdoq else None
    _, table, src, maps, lanes = _small_commit(kind, seed)
    T = len(table.tasks)
    assert T and len(table.waves) > 1
    want_maps, want_lanes = _copy(maps, lanes)
    wavefront.commit_wave_plain(src, want_maps, want_lanes, table, dq_dc, dq_ac, 8, 4, lam, qctx)

    # a random topological order of the predecessor graph
    g = np.random.default_rng(seed)
    ps, pr = wavefront.predecessors(table)
    npred = np.diff(ps).astype(np.int64)
    succ = [[] for _ in range(T)]
    for t in range(T):
        for p in pr[ps[t]:ps[t + 1]]:
            succ[p].append(t)
    ready, order = [t for t in range(T) if npred[t] == 0], []
    while ready:
        t = ready.pop(int(g.integers(len(ready))))
        order.append(t)
        for s_ in succ[t]:
            npred[s_] -= 1
            if npred[s_] == 0:
                ready.append(s_)
    assert len(order) == T and order != sorted(order)

    got_maps, got_lanes = _copy(maps, lanes)
    si, pl, lane = table.decode()
    for t in order:
        n = SIZES[int(si[t])]
        p = int(pl[t])
        rq = wavefront.rdoq_fns(qctx, n, "cpu")[int(p > 0)] if rdoq else None
        ntypes = (4 if n // 2 <= 16 else 1) if p else (4 if n <= 16 else 1)
        wavefront._code_group(src, got_maps, got_lanes[n], n, (p,),
                              [slice(int(lane[t]), int(lane[t]) + 1)], dq_dc, dq_ac, 8, ntypes,
                              lam, rq)
    for a, b in zip(got_maps, want_maps):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    for n in lanes:
        for k in wavefront.KEYS_LV + wavefront.KEYS_REC:
            assert torch.equal(got_lanes[n][k], want_lanes[n][k]), (n, k)
