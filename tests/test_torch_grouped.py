"""The grouped kernels A and C (one launch over every bucket): their tile
planner (graphminer_tpu_torch/ops/_tiles.py), the tile arithmetic the CUDA
kernels do (emulated here in numpy from the planner's own records), and the
grouped wrappers' plain versions and the engines against the JAX package's
one-dispatch _stream_partials and _ring_partials, exactly in int64. On the
CPU the grouped wrappers take their plain versions; the kernels themselves
run in tests/test_torch_kernels.py on a card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphminer_tpu.core.graph import HostGraph as JHostGraph
from graphminer_tpu.ops import ring as jring
from graphminer_tpu.ops import stream as jstream
from graphminer_tpu_torch.io.synth import rmat
from graphminer_tpu_torch.ops import (_tiles, cuda_ring, cuda_stream, ring,
                                      stream)

SENTINEL = 0x7FFFFFFF


def jax_graph(g):
    return JHostGraph(rowptr=g.rowptr, colidx=g.colidx, is_dag=g.is_dag)


def fastdiv_apply(n, d, m, s):
    """gm::FastDiv::div in numpy: (mulhi(n, m) + n) >> s on uint32."""
    n = np.asarray(n, np.uint64)
    hi = (n * np.uint64(m)) >> np.uint64(32)
    return ((hi + n) & np.uint64(0xFFFFFFFF)) >> np.uint64(s)


# --------------------------------------------------------------------------
# the tile planner
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed,tile", [(0, 8), (1, 64), (2, 1 << 13),
                                       (3, 1)])
def test_tiles_cover_every_unit_once_in_order(seed, tile):
    rng = np.random.default_rng(seed)
    units = rng.integers(0, 5 * tile, 12)
    units[[2, 7]] = 0                                   # empty buckets
    per_row = rng.integers(1, 300, 12)
    t = _tiles.plan_tiles(units, per_row, tile)
    assert t.dtype == np.int64 and t.shape[1] == _tiles.TREC
    b, first, count, row0 = t.T
    assert (np.diff(b) >= 0).all() and (count >= 1).all()
    for k in range(12):
        mine = t[b == k]
        # consecutive, in order, exactly covering [0, units[k])
        assert mine[:, 2].sum() == units[k]
        assert np.array_equal(mine[:, 1],
                              np.concatenate([[0], np.cumsum(mine[:, 2])[:-1]]
                                             ).astype(np.int64)[:len(mine)])
        # equal tiles, only the last short, none past the bucket's end
        assert (mine[:-1, 2] == tile).all()
        assert (mine[:, 1] + mine[:, 2] <= units[k]).all()
    assert np.array_equal(row0, first // per_row[b])
    # the kernel divides offset-in-row + index-in-tile: below 2^31
    assert (first - row0 * per_row[b] + count <= _tiles.FASTDIV_LIMIT).all()


def test_shape_only_plan_beyond_2_to_32_chunks():
    # 2^17 + 3 rows of 2048 slots x 128 words: 2^33 + 196,608 chunks,
    # planned from shapes alone (nothing is allocated)
    n_rows, width, ws = (1 << 17) + 3, 2048, 128
    recs, tiles = cuda_stream.plan_stream_shapes(
        [(5, 2, 8, 16, 8), (n_rows, width, ws, 0, 0), (1, 32, 32, 48, 48)])
    per_row = width * ws // 4
    assert tiles[:, 2].sum() == 5 * 2 * 4 + n_rows * per_row + 32 * 20
    big = tiles[tiles[:, 0] == 1]
    assert big[-1, 1] + big[-1, 2] == n_rows * per_row > 1 << 32
    assert big[-1, 3] == n_rows - 1
    assert (big[:, 1] - big[:, 3] * per_row + big[:, 2]
            <= _tiles.FASTDIV_LIMIT).all()
    assert tuple(recs[1, 2:5]) == _tiles.fastdiv(per_row)


def test_plan_refuses_rows_the_division_cannot_take():
    with pytest.raises(ValueError):
        _tiles.plan_tiles([10], [(1 << 31) - 8], 16)
    with pytest.raises(ValueError):
        cuda_stream.plan_stream_shapes([(4, 2, 6, 0, 0)])   # ws % 4


@pytest.mark.parametrize("d", [1, 2, 3, 7, 44, 68, 4096, 5632, 65536 * 3,
                               (1 << 30) - 1])
def test_fastdiv_exact_below_2_to_31(d):
    rng = np.random.default_rng(d)
    n = np.concatenate([rng.integers(0, 1 << 31, 20000),
                        [0, d - 1, d, (1 << 31) - 1]]).astype(np.int64)
    got = fastdiv_apply(n, *_tiles.fastdiv(d))
    assert np.array_equal(got.astype(np.int64), n // d)


@pytest.mark.parametrize("wa,wb,g,staged", [
    (8, 8, 8, 1), (16, 64, 8, 1), (64, 8, 8, 1), (8, 2048, 32, 1),
    (2, 512, 8, 1), (32, 4096, 32, 0), (8, 1024, 16, 1)])
def test_tail_plan_lanes_and_staging(wa, wb, g, staged):
    recs, tiles, region = cuda_ring.plan_tail_pairs_shapes(
        [(1000, wa, wb), (0, 8, 8), (50, 0, 8)])
    assert tuple(recs[0, [2, 5, 8, 9]]) == (wa, wb, g, staged)
    assert (32 // g) * wb <= cuda_ring.REGION_CAP or not staged
    # the two empty buckets stage 4 rows of 8 ids a warp
    assert region == max(32, (32 // g) * wb if staged else 0)
    # only the first bucket has work: 1000 tasks in tiles of TAIL_TILE
    assert (tiles[:, 0] == 0).all() and tiles[:, 2].sum() == 1000
    assert (tiles[:-1, 2] == cuda_ring.TAIL_TILE).all()


# --------------------------------------------------------------------------
# the kernels' tile arithmetic, emulated from the planner's records
# --------------------------------------------------------------------------

def emulate_stream_count(buckets, tile=None):
    """Kernel A's count computed tile by tile as csrc/stream_count.cu does:
    the planner's records, tile-relative multiply-high divisions, the
    tile's dst rows, the bitmap AND and the tail lookup."""
    shapes = [(s.shape[0], s.shape[1], ws, d.shape[1] - ws, s.shape[2] - ws)
              for d, s, ws in buckets]
    recs, tiles = cuda_stream.plan_stream_shapes(shapes)
    if tile is not None:
        tiles = _tiles.plan_tiles(
            [n * w * (ws + wta) // 4 for n, w, ws, _, wta in shapes],
            [max(1, w * (ws + wta) // 4) for n, w, ws, _, wta in shapes],
            tile)
    total = 0
    for b, chunk0, count, row0 in tiles:
        d, s, _ = buckets[b]
        rec = recs[b]
        pr, qs = tuple(rec[2:5]), tuple(rec[5:8])
        q_dst, q_ws, wtv = (int(x) for x in rec[8:11])
        src = s.reshape(-1, 4)[chunk0:chunk0 + count].astype(np.uint32)
        dst = d.reshape(-1, 4)[row0 * q_dst:]
        c = chunk0 - row0 * pr[0] + np.arange(count, dtype=np.int64)
        r = fastdiv_apply(c, *pr).astype(np.int64)
        k = c - r * pr[0]
        col = k - fastdiv_apply(k, *qs).astype(np.int64) * qs[0]
        bm = col < q_ws
        drow = dst[r[bm] * q_dst + col[bm]].astype(np.uint32)
        total += int(np.unpackbits((src[bm] & drow).view(np.uint8)).sum())
        if wtv:
            ids = src[~bm].view(np.int32)               # [m, 4]
            rr = r[~bm]
            tail = dst.reshape(-1)[(rr * q_dst + q_ws)[:, None] * 4
                                   + np.arange(wtv)]    # [m, wtv]
            hit = (ids[:, :, None] == tail[:, None, :]).any(2)
            total += int((hit & (ids != SENTINEL)).sum())
    return total


def random_stream_buckets(rng, specs):
    """[(dst [n, ws + wtv], src [n, width, ws + wta], ws)] with sorted
    SENTINEL-padded tails and some empty (SENTINEL) src slots."""
    def tails(rows, w):
        v = np.cumsum(rng.integers(1, 6, (rows, w)), axis=1).astype(np.int32)
        v[np.arange(w)[None, :] >= rng.integers(0, w + 1, rows)[:, None]] = \
            SENTINEL
        return v

    def words(*shape):
        return rng.integers(-2**31, 2**31, shape, dtype=np.int64
                            ).astype(np.int32)
    out = []
    for n, width, ws, wtv, wta in specs:
        d = np.concatenate([words(n, ws), tails(n, wtv)], 1)
        s = np.concatenate([words(n * width, ws), tails(n * width, wta)], 1)
        empty = rng.random(n * width) < 0.2
        s[empty, :ws], s[empty, ws:] = 0, SENTINEL
        out.append((d, s.reshape(n, width, ws + wta), ws))
    return out


MIXED = [(1, 2048, 8, 0, 0), (37, 2, 128, 48, 32), (64, 32, 32, 16, 8),
         (200, 8, 8, 16, 16), (5, 512, 128, 0, 0), (3, 128, 128, 48, 48),
         (0, 32, 8, 16, 8), (9, 2, 8, 0, 0)]


@pytest.mark.parametrize("tile", [None, 7, 64, 1000])
def test_emulated_tiles_equal_plain(tile):
    bk = random_stream_buckets(np.random.default_rng(5), MIXED)
    plan = cuda_stream.plan_stream(
        [(torch.from_numpy(d), torch.from_numpy(s), ws, d.shape[1] - ws)
         for d, s, ws in bk])
    want = int(cuda_stream.stream_count_all_plain(plan).sum())
    assert emulate_stream_count(bk, tile) == want > 0


def test_emulated_tiles_equal_jax_on_rmat_buckets():
    g = rmat(11, 16, seed=3)
    ref = jstream.build_stream(jax_graph(g), core=256)
    bk = [(np.asarray(b.dst_rows), np.asarray(b.src_rows), b.ws)
          for b in ref.buckets]
    want = int(np.asarray(jstream._stream_partials(
        tuple((b.dst_rows, b.src_rows) for b in ref.buckets), jnp.int32(0),
        spec=tuple(b.spec for b in ref.buckets)), dtype=np.int64).sum())
    assert emulate_stream_count(bk, 512) == want


# --------------------------------------------------------------------------
# grouped plain versions and engines against the JAX package
# --------------------------------------------------------------------------

def jax_stream_total(ref):
    return int(np.asarray(jstream._stream_partials(
        tuple((b.dst_rows, b.src_rows) for b in ref.buckets), jnp.int32(0),
        spec=tuple(b.spec for b in ref.buckets)), dtype=np.int64).sum())


def jax_ring_total(ref):
    bm = ref.bm_table if ref.bm_table is not None else ref.core_bm
    return int(np.asarray(jring._ring_partials(
        ref.core_bm, tuple((b.src_bm, b.dst_loc) for b in ref.cbuckets), bm,
        tuple((b.src_bm, b.dst_loc) for b in ref.bbuckets), ref.tail_tables,
        tuple((b.src_slot, b.dst_slot) for b in ref.tbuckets), jnp.int32(0),
        cspec=tuple(b.wc for b in ref.cbuckets),
        bspec=tuple(b.wc for b in ref.bbuckets),
        tspec=tuple((b.ta, b.tv) for b in ref.tbuckets), words=ref.words),
        dtype=np.int64).sum())


def graphs(rand_graphs):
    return [(g, core) for g in rand_graphs for core in (8, 16)] + [
        (rmat(10, 16, seed=7), 64), (rmat(12, 8, seed=3), 256),
        (rmat(12, 16, seed=7), 4096)]


def test_stream_count_all_equals_jax_stream_partials(rand_graphs):
    for g, core in graphs(rand_graphs):
        eng = stream.StreamEngine(g, core=core, device="cpu")
        got = cuda_stream.stream_count_all(eng.plan)
        assert got.dtype == torch.int64 and got.dim() == 1
        ref = jstream.build_stream(jax_graph(g), core=core)
        assert int(got.sum()) == jax_stream_total(ref) == eng.count()


def test_ring_partials_equal_jax_ring_partials(rand_graphs):
    for g, core in graphs(rand_graphs):
        eng = ring.RingEngine(g, core=core, device="cpu")
        parts = eng.partials()
        assert parts.dtype == torch.int64 and parts.dim() == 1
        lay = eng.layout
        # kernel B's partials over every phase-C and bitmap-pass bucket,
        # then kernel C's
        heads = cuda_ring.ring_phase_c_all(eng.phase_c_plan)
        tails = cuda_ring.ring_tail_pairs_all(eng.tail_plan)
        assert torch.equal(parts, torch.cat([heads, tails]))
        assert int(heads.sum()) == sum(
            int(cuda_ring.ring_phase_c_plain(t, b.src_bm, b.dst_loc))
            for t, bs in ((lay.core_bm, lay.cbuckets),
                          (lay.bm_table, lay.bbuckets)) for b in bs)
        assert int(tails.sum()) == sum(
            int(cuda_ring.ring_tail_pairs_plain(
                lay.tail_tables[b.ta], lay.tail_tables[b.tv], b.src_slot,
                b.dst_slot)) for b in lay.tbuckets)
        ref = jring.build_ring(jax_graph(g), core=core)
        assert int(parts.sum()) == jax_ring_total(ref) == eng.count()


def test_empty_plans_count_zero_without_a_launch():
    before = (cuda_stream.stream_bucket_count.launches,
              cuda_ring.ring_tail_pairs.launches)
    s = cuda_stream.stream_count_all(cuda_stream.plan_stream([]))
    t = cuda_ring.ring_tail_pairs_all(cuda_ring.plan_tail_pairs([]))
    assert s.tolist() == [0] and t.tolist() == [0]
    eng = ring.RingEngine(rmat(8, 4, seed=1), core=4096, device="cpu")
    assert not eng.layout.tbuckets and eng.partials().dim() == 1
    assert (cuda_stream.stream_bucket_count.launches,
            cuda_ring.ring_tail_pairs.launches) == before


def test_grouped_wrappers_check_shapes():
    d = torch.zeros((4, 8), dtype=torch.int32)
    s = torch.zeros((4, 2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_stream.plan_stream([(d[:3], s, 8, 0)])
    with pytest.raises(TypeError):
        cuda_stream.plan_stream([(d.long(), s.long(), 8, 0)])
    t = torch.zeros((4, 8), dtype=torch.int32)
    sl = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_ring.plan_tail_pairs([(t, t, sl, sl[:4])])
    plan = cuda_ring.plan_tail_pairs([(t, t, sl, sl)])
    assert plan.table is None and plan.device.type == "cpu"
