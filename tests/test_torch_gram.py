"""Kernel G's plain version (graphminer_tpu_torch/ops/cuda_gram.py, the CPU
path of CliqueKEngine.hi_partials and TriangleEngine.core_partials) against
the JAX package's hi products on the same inputs: the k = 4 and k = 5
bilinears through the JAX engine's decoded totals, the spoke product row
for row, and cliquebig's chained bilinear at depth 2 and 3; then G's tile
table, its K split and bit 31. Inputs from numpy seeds; all exact."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphminer_tpu.core.graph import HostGraph as JHostGraph
from graphminer_tpu.ops import cliquebig as jcb
from graphminer_tpu.ops import cliquek as jck
from graphminer_tpu.ops import hubcore as jhub
from graphminer_tpu_torch.io.synth import rmat
from graphminer_tpu_torch.ops import cuda_gram
from graphminer_tpu_torch.ops.cuda_expand import expand_bits_plain
from graphminer_tpu_torch.ops.cuda_gram import (bit_gram, bit_gram_plain,
                                                k_ranges, plan_gram,
                                                tile_table)

SENTINEL = np.iinfo(np.int32).max
#: (scale, edge factor, seed, JAX engine kwargs): hi 64 (one 128-bit tile,
#: half empty) and hi 512 (4 x 4 tiles)
GRAPHS = {"rmat11s29": (11, 8, 29, dict(core=256, hi=64)),
          "rmat10ef16": (10, 16, 7, dict(core=1024, hi=512))}


def t(a) -> torch.Tensor:
    """A torch copy of an array (JAX arrays are read-only)."""
    return torch.from_numpy(np.array(a))


def words(rng, *shape):
    return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)


def decoded(lohi) -> int:
    """The total of the JAX bilinears' int32 [*, 2] lo16/hi16 sums."""
    a = np.asarray(lohi, dtype=np.int64).reshape(-1, 2)
    return int(a[:, 0].sum() + (a[:, 1].sum() << 16))


@functools.lru_cache(maxsize=None)
def jax_engine(name, k):
    s, ef, seed, kw = GRAPHS[name]
    g = rmat(s, ef, seed=seed)
    return jck.CliqueKEngine(JHostGraph(rowptr=g.rowptr, colidx=g.colidx),
                             k, tail=False, **kw)


def hi_mask(ref) -> torch.Tensor:
    """B_hh packed: the JAX engine's core rows from its hi cut, hi words."""
    lo_cut = (ref.words - ref.hi_words) * 32
    return t(np.asarray(ref.core)[lo_cut:, ref.words - ref.hi_words:])


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_plain_mode_equals_edge_hi_bilinear(name):
    """k = 4: G over the materialized y2 hi rows (plain mode) against
    _edge_hi_bilinear's total."""
    ref = jax_engine(name, 4)
    want = decoded(jck._edge_hi_bilinear(ref.y2hi, ref.bhh,
                                         hi_words=ref.hi_words,
                                         slab=ref.slab))
    got = bit_gram_plain(t(ref.y2hi), hi_mask(ref))
    assert got.dtype == torch.int64 and got.shape == (ref.hi_words * 32,)
    assert int(got.sum()) == want > 0


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_gathered_mode_equals_tri_stream_bilinear(name):
    """k = 5: G in gathered mode at depth 1 (row = slot // slots, c from
    the bucket) over each _bucket_tris bucket against
    _tri_stream_bilinear's total."""
    ref = jax_engine(name, 5)
    mask, core_hi = hi_mask(ref), t(ref.core_hi)
    want = got = 0
    for rows, cm, step, _ in ref.tri_buckets:
        tcl = int(cm.shape[1])
        want += decoded(jck._tri_stream_bilinear(
            rows, cm, ref.core_hi, ref.bhh, hi_words=ref.hi_words, tcl=tcl,
            rows_step=step))
        cols = t(cm).reshape(-1, 1)
        r = torch.arange(cols.shape[0], dtype=torch.int32) // tcl
        got += int(bit_gram_plain(t(rows), mask, r=r,
                                  tab=core_hi, cols=cols).sum())
    assert len(ref.tri_buckets) > 1 and got == want > 0


@pytest.mark.parametrize("depth", [2, 3])
def test_gathered_mode_equals_chain_hi_bilinear(depth):
    """cliquebig's chained bilinear at depth 2 and 3 on rmat11's y2 hi
    rows and core, with random rows and c ids, some SENTINEL or out of
    range."""
    ref = jax_engine("rmat11s29", 4)
    rng = np.random.default_rng(depth)
    ne, c = ref.n_core_edges, ref.core_hi.shape[0]
    slab, n = 2048, 4096
    rows = rng.integers(-2, ne + 2, n).astype(np.int32)
    cols = rng.integers(-2, c + 2, (n, depth)).astype(np.int32)
    rows[::17] = SENTINEL
    cols[::23, depth - 1] = SENTINEL
    want = decoded(jcb._chain_hi_bilinear(
        ref.y2hi, ref.core_hi, ref.bhh, jnp.asarray(rows), jnp.asarray(cols),
        hi_words=ref.hi_words, slab=slab, depth=depth))
    got = bit_gram_plain(t(ref.y2hi), hi_mask(ref), r=t(rows),
                         tab=t(ref.core_hi), cols=t(cols))
    assert int(got.sum()) == want > 0


@pytest.mark.parametrize("words_,c", [(8, 200), (16, 512)])
def test_plain_equals_spoke_gemm_partials(words_, c):
    """Per core row against hubcore._spoke_gemm_partials, on random bitmap
    rows and a random core mask (not triangular), bit 31 included."""
    rng = np.random.default_rng(words_)
    v, n = 700, 1024
    table = words(rng, v, words_ + 8)           # bitmap words, then a tail
    spoke = words(rng, n, words_) & words(rng, n, words_)
    want = np.asarray(jhub._spoke_gemm_partials(
        jnp.asarray(table), jnp.asarray(spoke), words=words_, c=c, tile=512))
    got = bit_gram_plain(t(spoke), t(table)[v - c:, :words_])[:c]
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert got.sum() > 0


def test_tile_table_covers_every_set_bit():
    """A random mask that is not triangular, with empty tiles: the table
    lists exactly the tiles that hold a set bit, in row-major order."""
    rng = np.random.default_rng(5)
    hw, nm = 16, 470                      # 512 bits: 4 x 4 tiles of 128
    mask = words(rng, nm, hw) & words(rng, nm, hw) & words(rng, nm, hw)
    mask[:, 4:8] = 0                      # column tile 1 empty
    mask[256:384] = 0                     # row tile 2 empty
    mask[300, 5] = np.int32(-2**31)       # ...but for bit 31 of word 5
    mask[0:128, 12:16] = 0                # tile (0, 3) empty
    tiles = tile_table(mask)
    dense = expand_bits_plain(t(mask)).numpy()          # [nm, 512]
    hit = {(i // 128, j // 128) for i, j in zip(*np.nonzero(dense))}
    assert [tuple(x) for x in tiles.tolist()] == sorted(hit)
    assert (2, 1) in hit and (0, 1) not in hit and (0, 3) not in hit
    assert tiles.dtype == np.int32 and tiles.flags.c_contiguous
    assert len(hit) < 16
    plan = plan_gram(t(mask))
    assert plan.n_tiles == len(hit) and plan.dim == 512
    # an upper-triangular DAG mask: the upper triangle of tiles, the
    # diagonal included
    dag = np.triu(np.ones((512, 512), np.uint8), 1)
    packed = np.packbits(dag, axis=1, bitorder="little").view(np.int32)
    assert tile_table(packed).tolist() == [[i, j] for i in range(4)
                                           for j in range(i, 4)]


def test_ragged_width_and_rows_past_the_mask():
    """hw = 1, 2, 5 (dims no multiple of the tile): the plain version
    against a direct per-task count; mask rows past nm add 0."""
    rng = np.random.default_rng(11)
    for hw in (1, 2, 5):
        y = words(rng, 300, hw)
        mask = words(rng, 20 * hw, hw)
        got = bit_gram_plain(t(y), t(mask)).numpy()
        bits = np.unpackbits(y.view(np.uint8), axis=1, bitorder="little")
        mb = np.unpackbits(mask.view(np.uint8), axis=1, bitorder="little")
        want = np.zeros(32 * hw, np.int64)
        want[:mask.shape[0]] = ((bits.T.astype(np.int64)
                                 @ bits.astype(np.int64))
                                [:mask.shape[0]] * mb).sum(axis=1)
        assert np.array_equal(got, want)
        assert len(tile_table(mask)) == (1 if hw < 4 else 2)


def test_bit31_in_every_word():
    """Rows whose every word has bit 31 set (negative int32): bit 31 is a
    row bit like any other, in the rows and in the mask."""
    hw, n = 4, 64
    y = np.full((n, hw), np.int32(-2**31))
    y[::2] |= 1
    mask = np.full((128, hw), np.int32(-2**31))
    got = bit_gram_plain(t(y), t(mask)).numpy()
    # bit 31 of word w is row 31 + 32w: every task has it, and every mask
    # row has bits 31, 63, 95 and 127, all set in every task; bit 0 of each
    # word is set in the even tasks only
    want = np.zeros(128, np.int64)
    want[31::32] = 4 * n
    want[0::32] = 4 * (n // 2)
    assert np.array_equal(got, want)


def test_k_ranges_cover_tasks_and_guard_int32():
    """Every task lies in exactly one K-range of at most kc tasks (a STEP
    multiple), about ROUNDS items a block; a K-range or a task index at
    2^31 raises."""
    for n, tiles_, blocks in ((1, 1, 264), (1000, 1, 264), (118_784, 528, 264),
                              (81_054_679, 10, 264), (3_021_827, 36, 132)):
        kc, items = k_ranges(n, tiles_, blocks)
        chunks = items // tiles_
        assert kc % cuda_gram.STEP == 0 and items % tiles_ == 0
        assert (chunks - 1) * kc < n <= chunks * kc
        assert items <= max(cuda_gram.ROUNDS * blocks, tiles_)
    with pytest.raises(ValueError, match="2\\^31"):
        k_ranges(2**31 - 100, 10, 264)
    with pytest.raises(ValueError, match="2\\^31"):
        k_ranges(2**31 - 300, 1, 1)            # one K-range of every task


def test_wrapper_takes_plain_on_cpu_and_checks_arguments():
    rng = np.random.default_rng(2)
    y, mask = t(words(rng, 100, 4)), t(words(rng, 128, 4))
    before = bit_gram.launches
    assert torch.equal(bit_gram(y, mask, plan=plan_gram(mask)),
                       bit_gram_plain(y, mask))
    assert bit_gram.launches == before
    with pytest.raises(ValueError, match="mask"):
        bit_gram(y, mask[:, :3])
    with pytest.raises(TypeError):
        bit_gram(y.long(), mask)
    with pytest.raises(ValueError):
        bit_gram(y, mask, cols=torch.zeros((100, 7), dtype=torch.int32),
                 tab=y)


def test_gram_bounds_count_the_mask():
    """utils/profiling.py::gram_bounds: the operations the function needs
    are 2 · nnz(B) · n over a non-triangular mask with bit 31 set (rows
    past 32·hw ignored), no more than the tile walk's 2 · 128² · tiles · n
    or the full Gram's 2 · dim² · n; the bytes count the ids, each distinct
    valid row once, the mask rows and the int64 partials."""
    from graphminer_tpu_torch.utils.profiling import gram_bounds
    rng = np.random.default_rng(17)
    hw, n = 8, 1000
    mask = words(rng, 32 * hw + 5, hw) & words(rng, 32 * hw + 5, hw)
    mask[:, 0] |= np.int32(-2**31)
    base = words(rng, 300, hw)
    r = rng.integers(-3, 303, n).astype(np.int32)
    r[::7] = SENTINEL
    plan = plan_gram(t(mask))
    b = gram_bounds(t(base), t(mask), plan.n_tiles, cuda_gram.TILE, r=t(r))
    nnz = int(np.unpackbits(mask[:32 * hw].view(np.uint8)).sum())
    assert b["ops_mask"] == 2 * nnz * n
    assert b["ops_tiles"] == 2 * 128 ** 2 * plan.n_tiles * n
    assert b["ops_full"] == 2 * (32 * hw) ** 2 * n
    assert 0 < b["ops_mask"] < b["ops_tiles"] <= b["ops_full"]
    distinct = np.unique(r[(r >= 0) & (r < 300)]).size
    assert b["bytes"] == (n * 4 + distinct * hw * 4 + 32 * hw * hw * 4
                          + 8 * 32 * hw)
    for key in ("mask", "tiles", "full"):
        assert b[key][1] in ("bytes", "operations") and b[key][0] > 0
    assert b["mask"][0] <= b["tiles"][0] <= b["full"][0]
