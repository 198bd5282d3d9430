"""The grouped kernels B (ring phase C and the bitmap pass) and E (hub-core
tail count), one launch over every bucket: their planners
(graphminer_tpu_torch/ops/cuda_ring.py::plan_phase_c_units,
ops/cuda_hubcore.py::tail_count_shapes), the arithmetic the CUDA kernels do
(emulated here in numpy from the planners' own records: B's slice staging
and swizzle, its warp scan and ballot item lookup; E's tiles, lane-group
groups and clamped tails), and the grouped plain versions and engines
against the JAX package — the Pallas phase-C kernel in interpret mode, the
XLA ring partials and hubcore._tail_partials — exactly in int64. On the CPU
the grouped wrappers take their plain versions; the kernels themselves run
in tests/test_torch_kernels.py on a card."""
import types

import numpy as np
import pytest
import torch

import oracle
from graphminer_tpu.core.graph import HostGraph as JHostGraph
from graphminer_tpu.ops import hubcore as jhub
from graphminer_tpu.ops import pallas_ring
from graphminer_tpu.ops import ring as jring
from graphminer_tpu_torch.io.synth import rmat
from graphminer_tpu_torch.ops import _tiles, cuda_hubcore, cuda_ring, hubcore
from graphminer_tpu_torch.ops import ring

SENTINEL = 0x7FFFFFFF
SLICE = cuda_ring.SLICE
LEN_MASK = (1 << cuda_ring.LEN_BITS) - 1


def jax_graph(g):
    return JHostGraph(rowptr=g.rowptr, colidx=g.colidx, is_dag=g.is_dag)


def popc(x):
    return int(np.unpackbits(np.ascontiguousarray(x).view(np.uint8)).sum())


def words(rng, *shape):
    return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)


def tails(rng, rows, width):
    v = np.cumsum(rng.integers(1, 6, (rows, width)), axis=1).astype(np.int32)
    v[np.arange(width)[None, :] >= rng.integers(0, width + 1, rows)[:, None]] \
        = SENTINEL
    return v


# --------------------------------------------------------------------------
# kernel B: planner and emulation
# --------------------------------------------------------------------------

def random_phase_c(rng, specs, sparse=0.6):
    """[(table, src_bm, dst_loc)] numpy buckets: per spec (table key, n
    rows, wc); tables keyed by name, with some all-zero src slices, slots
    outside the table, SENTINEL runs and one empty row."""
    tabs = {"core": words(rng, 64, 16), "bm": words(rng, 300, 16),
            "wide": words(rng, 40, 40)}
    out = []
    for key, n, wc in specs:
        t = tabs[key]
        s = words(rng, n, t.shape[1])
        zero = rng.random((n, t.shape[1] // SLICE)) < sparse
        s.reshape(n, t.shape[1] // SLICE, SLICE)[zero] = 0
        d = rng.integers(-3, t.shape[0] + 3, (n, wc)).astype(np.int32)
        d[rng.random((n, wc)) < 0.1] = SENTINEL
        if n > 1:
            d[1] = SENTINEL                               # a row with no task
        k = rng.integers(0, wc + 1, n)                    # SENTINEL tails
        d[np.arange(wc)[None, :] >= k[:, None]] = SENTINEL
        out.append((t, s, d))
    return out


B_SETS = {
    "mixed": [("core", 1, 4), ("core", 37, 16), ("bm", 50, 64),
              ("core", 9, 200), ("bm", 3, 4), ("core", 0, 16),
              ("wide", 20, 8)],
    "one bucket": [("core", 100, 64)],
    "long rows": [("bm", 6, 700), ("core", 2, 4096)],
}


def b_units(buckets):
    return [cuda_ring.phase_c_units(*(torch.from_numpy(a) for a in bk))
            for bk in buckets]


def keys_of(buckets):
    return [id(t) for t, _, _ in buckets]


def staged_of(buckets, stage_rows=cuda_ring.STAGE_ROWS):
    return [t.shape[0] <= stage_rows for t, _, _ in buckets]


def emulate_phase_c(buckets, n_parts, stage_rows=cuda_ring.STAGE_ROWS):
    """Kernel B's count as csrc/ring_phase_c.cu computes it, block by block
    from the planner's records: a staged table's slice copied with the
    two-half swizzle, each warp batch of 32 items scanned, each slot's item
    found by the ballot of items started before the window plus the
    reduce-or of item starts in it, then one sector AND + popcount."""
    items, tiles, block_tiles = cuda_ring.plan_phase_c_units(
        b_units(buckets), keys_of(buckets), staged_of(buckets, stage_rows),
        n_parts)
    total = 0
    for b in range(n_parts):
        stage, st_key = None, None
        for bk, sl, first, count in tiles[block_tiles[b]:block_tiles[b + 1]]:
            table, src, dl = buckets[bk]
            n_t, wc = table.shape[0], dl.shape[1]
            col = sl * SLICE
            if n_t <= stage_rows and (id(table), sl) != st_key:
                halves = table[:, col:col + SLICE].reshape(n_t, 2, 4)
                stage = np.zeros((2 * n_t, 4), np.int32)
                for r in range(n_t):
                    x = (r >> 2) & 1
                    stage[2 * r + x], stage[2 * r + (x ^ 1)] = halves[r]
                st_key = (id(table), sl)
            its = items[first:first + count]
            for i0 in range(0, count, 32):
                batch = its[i0:i0 + 32]
                row = np.zeros(32, np.int64)
                off = np.zeros(32, np.int64)
                ln = np.zeros(32, np.int64)
                row[:len(batch)] = batch[:, 0]
                off[:len(batch)] = batch[:, 1] >> cuda_ring.LEN_BITS
                ln[:len(batch)] = batch[:, 1] & LEN_MASK
                start = np.cumsum(ln) - ln
                tot = int(ln.sum())
                lane = np.arange(32)
                for w0 in range(0, tot, 32):
                    d = start - w0
                    before = int(((ln > 0) & (d < 0)).sum())
                    mark = 0
                    for k in np.nonzero((ln > 0) & (d >= 0) & (d < 32))[0]:
                        mark |= 1 << int(d[k])
                    upto = [bin(mark & ((2 << l) - 1)).count("1")
                            for l in lane]
                    kk = (before + np.array(upto) - 1) & 31
                    for l in lane[w0 + lane < tot]:
                        k = kk[l]
                        x = dl[row[k], off[k] + w0 + l - start[k]]
                        if not 0 <= x < n_t:
                            continue
                        a = src[row[k], col:col + SLICE].view(np.uint32)
                        if n_t <= stage_rows:
                            sw = (x >> 2) & 1
                            t = np.concatenate([stage[2 * x + sw],
                                                stage[2 * x + (sw ^ 1)]])
                        else:
                            t = table[x, col:col + SLICE]
                        total += popc(a & t.view(np.uint32))
    return total


def plain_b(buckets):
    return sum(int(cuda_ring.ring_phase_c_plain(
        *(torch.from_numpy(a) for a in bk))) for bk in buckets)


@pytest.mark.parametrize("name", sorted(B_SETS))
def test_phase_c_plan_covers_every_unit_once_in_order(name):
    bk = random_phase_c(np.random.default_rng(len(name)), B_SETS[name])
    units = b_units(bk)
    keys = keys_of(bk)
    items, tiles, block_tiles = cuda_ring.plan_phase_c_units(
        units, keys, staged_of(bk), 7)
    assert items.dtype == np.int32 and tiles.dtype == np.int64
    # tiles: consecutive, covering every item once, in (table, slice,
    # bucket) order, and the blocks' ranges partition them in order
    assert tiles[0, 2] == 0 and tiles[:, 3].min() >= 1
    assert np.array_equal(tiles[1:, 2], tiles[:-1, 2] + tiles[:-1, 3])
    assert tiles[-1, 2] + tiles[-1, 3] == items.shape[0]
    assert block_tiles[0] == 0 and block_tiles[-1] == tiles.shape[0]
    assert (np.diff(block_tiles) >= 0).all()
    order = [(list(dict.fromkeys(keys)).index(keys[b]), s, b)
             for b, s in tiles[:, :2]]
    assert order == sorted(order)
    # items: each (row, slice) unit's slots [0, len) once, in runs of at
    # most PIECE, rows ascending within a tile's (bucket, slice)
    got = {}
    for b, s, first, count in tiles:
        its = items[first:first + count]
        assert (np.diff(its[:, 0]) >= 0).all()
        for r, packed in its:
            o, n = packed >> cuda_ring.LEN_BITS, packed & LEN_MASK
            assert 1 <= n <= cuda_ring.PIECE
            got.setdefault((b, s, r), []).append((o, n))
    want = {}
    for b, (sl, rows, lens, valid) in enumerate(units):
        table, src, dl = bk[b]
        for s, r, ln, v in zip(sl, rows, lens, valid):
            want[(b, s, r)] = ln
            ok = (dl[r] >= 0) & (dl[r] < table.shape[0])
            assert ln == np.nonzero(ok)[0].max() + 1 and v == ok.sum()
            assert src[r, s * SLICE:(s + 1) * SLICE].any()
    assert set(got) == set(want)
    for key, runs in got.items():
        offs = [o for o, _ in runs]
        assert offs == list(range(0, want[key], cuda_ring.PIECE))
        assert sum(n for _, n in runs) == want[key]


@pytest.mark.parametrize("n_parts", [1, 5, 132])
@pytest.mark.parametrize("name", sorted(B_SETS))
def test_phase_c_emulation_equals_plain(name, n_parts):
    bk = random_phase_c(np.random.default_rng(3 + len(name)), B_SETS[name])
    assert emulate_phase_c(bk, n_parts) == plain_b(bk) > 0


def test_phase_c_emulation_unstaged_core():
    # the same buckets with no table staged: every sector read in place
    bk = random_phase_c(np.random.default_rng(9), B_SETS["mixed"])
    assert emulate_phase_c(bk, 4, stage_rows=0) == plain_b(bk)


def test_phase_c_plan_parts_have_equal_work():
    bk = random_phase_c(np.random.default_rng(1), [("core", 400, 64),
                                                   ("bm", 300, 16)], 0.3)
    items, tiles, block_tiles = cuda_ring.plan_phase_c_units(
        b_units(bk), keys_of(bk), staged_of(bk, 64), 16)
    # the core table (64 rows) staged, the bitmap table (300) not
    w = np.where(tiles[:, 0] == 0, 1.0, cuda_ring.DIRECT_COST)
    work = np.zeros(items.shape[0])
    for (b, _, first, count), wt in zip(tiles, w):
        work[first:first + count] = (
            (items[first:first + count, 1] & LEN_MASK) * wt
            + cuda_ring.ITEM_COST)
    per = [int(work[tiles[t0, 2]:tiles[t1 - 1, 2] + tiles[t1 - 1, 3]].sum())
           if t1 > t0 else 0 for t0, t1 in zip(block_tiles[:-1],
                                               block_tiles[1:])]
    # each part within one item of the mean
    assert max(per) - min(per) <= 2 * (cuda_ring.PIECE * cuda_ring.DIRECT_COST
                                       + cuda_ring.ITEM_COST)


def test_phase_c_emulation_on_rmat_layout():
    g = rmat(11, 8, seed=5)
    lay = ring.build_ring(g, core=64, device="cpu")
    bk = [(lay.core_bm.numpy(), b.src_bm.numpy(), b.dst_loc.numpy())
          for b in lay.cbuckets] + [
        (lay.bm_table.numpy(), b.src_bm.numpy(), b.dst_loc.numpy())
        for b in lay.bbuckets]
    assert lay.bbuckets and emulate_phase_c(bk, 9) == plain_b(bk)


# --------------------------------------------------------------------------
# kernel E: planner and emulation
# --------------------------------------------------------------------------

def random_tail_groups(rng, specs, nw=8, wt=16, ns=60, nd=40):
    """(src_rows, dst_rows, [(su, dv, wa, wb)]) numpy: rows of nw bitmap
    words and wt sorted tail slots; task ids partly outside the tables and
    SENTINEL padding at the end of each group."""
    sr = np.concatenate([words(rng, ns, nw), tails(rng, ns, wt)], 1)
    dr = np.concatenate([words(rng, nd, nw), tails(rng, nd, wt)], 1)
    groups = []
    for n, pad, wa, wb in specs:
        su = rng.integers(-2, ns + 2, n).astype(np.int32)
        dv = np.sort(rng.integers(-2, nd + 2, n)).astype(np.int32)
        su = np.concatenate([su, np.full(pad, SENTINEL, np.int32)])
        dv = np.concatenate([dv, np.full(pad, SENTINEL, np.int32)])
        groups.append((su, dv, wa, wb))
    return sr, dr, groups


E_SPECS = [(300, 20, 16, 16), (1, 0, 64, 16), (0, 7, 16, 64), (513, 0, 0, 0),
           (40, 3, 16, 0), (90, 1, 4, 8)]


#: lanes a task of kernel E (csrc/hub_tail_count.cu::G)
E_LANES = 4


def emulate_tail_count(sr, dr, groups, words_):
    """Kernel E's count as csrc/hub_tail_count.cu computes it: the
    planner's tiles and clamped widths, groups of E_LANES lanes taking
    consecutive tasks, lane gl ANDing 16-byte chunks gl, gl + E_LANES, ...
    and searching src tail ids gl + E_LANES u of each run of E_LANES K."""
    G = E_LANES
    tg = [tuple(torch.from_numpy(x) for x in g[:2]) + g[2:] for g in groups]
    shapes = cuda_hubcore.tail_count_shapes(tg, sr.shape[0], dr.shape[0],
                                            sr.shape[1] - words_)
    tiles = _tiles.plan_tiles([n for n, _, _ in shapes], [1] * len(shapes),
                              cuda_hubcore.TAIL_TILE)
    total = 0
    for b, first, count, _ in tiles:
        su, dv, _, _ = groups[b]
        _, wa, wb = shapes[b]
        # ids a lane per search: the kernel's template K for ceil(wa / 8)
        k = next(K for K in (1, 2, 4, 6, 8, 1 << 30) if K >= -(-wa // G))
        for i in range(count):
            a, d = su[first + i], dv[first + i]
            if not (0 <= a < sr.shape[0] and 0 <= d < dr.shape[0]):
                continue
            ra, rb = sr[a], dr[d]
            for gl in range(G):
                for c in range(gl, words_ // 4, G):
                    total += popc(ra[4 * c:4 * c + 4].view(np.uint32)
                                  & rb[4 * c:4 * c + 4].view(np.uint32))
                tb = rb[words_:words_ + wb]
                for j0 in range(0, wa, G * min(k, 8)):
                    ids = [ra[words_ + j] for j in
                           range(j0 + gl, min(wa, j0 + G * min(k, 8)), G)]
                    total += sum(x != SENTINEL and x in tb for x in ids)
    return total


def test_tail_count_shapes_clamp_and_cut_padding():
    sr, dr, groups = random_tail_groups(np.random.default_rng(0), E_SPECS)
    tg = [tuple(torch.from_numpy(x) for x in g[:2]) + g[2:] for g in groups]
    shapes = cuda_hubcore.tail_count_shapes(tg, 60, 40, 16)
    for (su, dv, wa, wb), (n, wa_, wb_) in zip(groups, shapes):
        ok = (su >= 0) & (su < 60) & (dv >= 0) & (dv < 40)
        assert n == (np.nonzero(ok)[0].max() + 1 if ok.any() else 0)
        assert (wa_, wb_) == ((0, 0) if min(wa, wb, 16) == 0
                              else (min(wa, 16), min(wb, 16)))
    tiles = _tiles.plan_tiles([n for n, _, _ in shapes], [1] * len(shapes),
                              cuda_hubcore.TAIL_TILE)
    for b, (n, _, _) in enumerate(shapes):
        mine = tiles[tiles[:, 0] == b]
        assert mine[:, 2].sum() == n
        assert np.array_equal(mine[:, 1], np.arange(len(mine)) *
                              cuda_hubcore.TAIL_TILE)


@pytest.mark.parametrize("nw,wt", [(8, 16), (16, 48), (8, 0)])
def test_tail_count_emulation_equals_plain(nw, wt):
    sr, dr, groups = random_tail_groups(np.random.default_rng(nw + wt),
                                        E_SPECS, nw=nw, wt=wt)
    tables = types.SimpleNamespace(src_rows=torch.from_numpy(sr),
                                   dst_rows=torch.from_numpy(dr))
    plan = cuda_hubcore.plan_tail_count(
        tables, [(torch.from_numpy(s), torch.from_numpy(d))
                 for s, d, _, _ in groups],
        [(wa, wb, 0) for _, _, wa, wb in groups], nw)
    assert plan.table is None
    want = int(cuda_hubcore.hub_tail_count_all(plan).sum())
    assert emulate_tail_count(sr, dr, groups, nw) == want > 0


# --------------------------------------------------------------------------
# grouped plain versions and engines against the JAX package
# --------------------------------------------------------------------------

@pytest.mark.parametrize("scale,seed,core", [(10, 19, 4096), (11, 5, 64),
                                             (12, 3, 256)])
def test_phase_c_all_equals_pallas_interpret_and_xla(scale, seed, core):
    g = rmat(scale, 8, seed=seed)
    eng = ring.RingEngine(g, core=core, device="cpu")
    ref = jring.build_ring(jax_graph(g), core=core)
    got = cuda_ring.ring_phase_c_all(eng.phase_c_plan)
    assert got.dtype == torch.int64 and got.dim() == 1
    pallas = sum(int(np.asarray(pallas_ring.cbucket_partials_pallas(
        ref.core_bm, b.src_bm, b.dst_loc, words=ref.words, wc=b.wc,
        interpret=True), dtype=np.int64).sum()) for b in ref.cbuckets)
    xla = sum(int(np.asarray(jring._cbucket_partials(
        t, b.src_bm, b.dst_loc, words=ref.words, wc=b.wc, per_task=False),
        dtype=np.int64).sum())
        for t, bs in ((ref.core_bm, ref.cbuckets), (ref.bm_table,
                                                    ref.bbuckets))
        for b in bs)
    bm_pass = xla - sum(int(np.asarray(jring._cbucket_partials(
        ref.core_bm, b.src_bm, b.dst_loc, words=ref.words, wc=b.wc,
        per_task=False), dtype=np.int64).sum()) for b in ref.cbuckets)
    assert int(got.sum()) == pallas + bm_pass == xla


def test_ring_engine_partials_equal_jax_ring_engine(rand_graphs):
    for g, core in [(g, c) for g in rand_graphs for c in (8, 16)] + [
            (rmat(12, 16, seed=7), 4096), (rmat(13, 8, seed=11), 256)]:
        small = g.n_vertices <= 100          # the dense oracle's reach
        eng = ring.RingEngine(g, core=core, device="cpu")
        parts = eng.partials()
        assert parts.dtype == torch.int64 and parts.shape == (2,)
        assert torch.equal(parts[:1],
                           cuda_ring.ring_phase_c_all(eng.phase_c_plan))
        ref = jring.RingEngine(jax_graph(g), core=core)
        assert int(parts.sum()) == ref.count()
        assert not small or int(parts.sum()) == oracle.triangles(g)


def jax_tail_total(ref):
    if not ref.group_arrays:
        return 0
    return int(np.asarray(jhub._tail_partials(
        ref.tables.src_rows, ref.tables.dst_rows, ref.group_arrays,
        spec=ref.spec, words=ref.layout.words), dtype=np.int64).sum())


@pytest.mark.parametrize("scale,core", [(12, 256), (14, 4096)])
def test_tail_count_all_equals_jax_tail_partials_rmat(scale, core):
    g = rmat(scale, 8 if scale < 14 else 16, seed=7)
    eng = hubcore.TriangleEngine(g, core=core, chunk=1024, device="cpu")
    ref = jhub.TriangleEngine(jax_graph(g), core=core, chunk=1024)
    got = eng.tail_partials()
    assert got.dtype == torch.int64 and got.dim() == 1
    assert torch.equal(got,
                       cuda_hubcore.hub_tail_count_all_plain(eng.tail_plan))
    assert int(got.sum()) == jax_tail_total(ref) == eng.count_tail() > 0


def test_tail_count_all_equals_jax_tail_partials_rand(rand_graphs):
    for g in rand_graphs:
        for core in (4, 16):
            eng = hubcore.TriangleEngine(g, core=core, chunk=64,
                                         device="cpu")
            ref = jhub.TriangleEngine(g, core=core, chunk=64)
            got = cuda_hubcore.hub_tail_count_all_plain(eng.tail_plan)
            assert int(got.sum()) == int(eng.tail_partials().sum()) == \
                jax_tail_total(ref)
            assert eng.count() == oracle.triangles(g)


def test_empty_plans_count_zero_without_a_launch():
    before = (cuda_ring.ring_phase_c.launches,
              cuda_hubcore.hub_tail_count.launches)
    p = cuda_ring.ring_phase_c_all(cuda_ring.plan_phase_c([]))
    assert p.tolist() == [0]
    empty = torch.zeros((0, 8), dtype=torch.int32)
    tables = types.SimpleNamespace(src_rows=empty, dst_rows=empty)
    t = cuda_hubcore.hub_tail_count_all(
        cuda_hubcore.plan_tail_count(tables, [], [], 8))
    assert t.tolist() == [0]
    items, tiles, bt = cuda_ring.plan_phase_c_units([], [], [], 4)
    assert items.shape == (0, 2) and tiles.shape[0] == 0
    assert bt.tolist() == [0] * 5
    assert (cuda_ring.ring_phase_c.launches,
            cuda_hubcore.hub_tail_count.launches) == before


def test_grouped_be_wrappers_check_shapes():
    t = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_ring.plan_phase_c([(t, t[:, :4], torch.zeros((4, 2),
                                                          dtype=torch.int32))])
    with pytest.raises(TypeError):
        cuda_ring.plan_phase_c([(t.long(), t.long(), t.long())])
    tables = types.SimpleNamespace(src_rows=t, dst_rows=t)
    s = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_hubcore.plan_tail_count(tables, [(s, s[:4])], [(8, 8, 0)], 4)
    plan = cuda_ring.plan_phase_c([(t, t, t)])
    assert plan.table is None and plan.device.type == "cpu"
