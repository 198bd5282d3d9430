"""Port hub-core engine (graphminer_tpu_torch/ops/hubcore.py TriangleEngine,
ops/cuda_hubcore.py) against the JAX package's TriangleEngine on the same
graphs: tail tables, bucket arrays and specs equal element for element, tail
and spoke sums equal, and the count equal to JAX's and to the brute-force
oracle. All exact."""
import functools

import numpy as np
import pytest
import torch

import oracle
from graphminer_tpu.core.graph import HostGraph as JHostGraph
from graphminer_tpu.ops import hubcore as jhub
from graphminer_tpu_torch.core.graph import HostGraph
from graphminer_tpu_torch.io.synth import erdos_renyi, rmat
from graphminer_tpu_torch.ops import cuda_hubcore, hubcore

SOURCES = ["rmat10", "rmat11", "rmat12", "er300"]
CORES = [64, 256, 1024]
CHUNK = 128


def graph(source):
    if source == "er300":
        return erdos_renyi(300, 0.05, seed=7)
    return rmat(int(source[4:]), 8, seed=int(source[4:]) % 3)


def jax_graph(g):
    return JHostGraph(rowptr=g.rowptr, colidx=g.colidx, is_dag=g.is_dag)


@functools.lru_cache(maxsize=None)
def engines(source, core):
    g = graph(source)
    return (hubcore.TriangleEngine(g, core=core, chunk=CHUNK, device="cpu"),
            jhub.TriangleEngine(jax_graph(g), core=core, chunk=CHUNK))


def same(t, a):
    return np.array_equal(t.numpy(), np.asarray(a))


@pytest.mark.parametrize("core", CORES)
@pytest.mark.parametrize("source", SOURCES)
def test_buckets_equal(source, core):
    ours, ref = engines(source, core)
    assert ours.spec == ref.spec
    assert ours.n_tail_tasks == ref.n_tail_tasks
    assert same(ours.tables.src_rows, ref.tables.src_rows)
    assert same(ours.tables.dst_rows, ref.tables.dst_rows)
    assert len(ours.group_arrays) == len(ref.group_arrays)
    for (s, d), (rs, rd) in zip(ours.group_arrays, ref.group_arrays):
        assert s.dtype == torch.int32 and d.dtype == torch.int32
        assert same(s, rs) and same(d, rd)
    assert same(ours.spoke, ref.spoke)


@pytest.mark.parametrize("core", CORES)
@pytest.mark.parametrize("source", SOURCES)
def test_tail_partials_equal(source, core):
    ours, ref = engines(source, core)
    lay = ours.layout
    got = hubcore._tail_partials(ours.tables.src_rows, ours.tables.dst_rows,
                                 ours.group_arrays, spec=ours.spec,
                                 words=lay.words)
    assert got.dtype == torch.int64
    if not ref.group_arrays:
        assert int(got.sum()) == 0
        return
    want = np.asarray(jhub._tail_partials(
        ref.tables.src_rows, ref.tables.dst_rows, ref.group_arrays,
        spec=ref.spec, words=ref.layout.words), dtype=np.int64)
    # JAX returns per-chunk partials; the port one count per group
    per_group = np.split(want, np.cumsum(
        [s.shape[0] for s, _ in ref.group_arrays])[:-1])
    assert got.tolist() == [int(p.sum()) for p in per_group]


@pytest.mark.parametrize("core", CORES)
@pytest.mark.parametrize("source", SOURCES)
def test_spoke_partials_equal(source, core):
    ours, ref = engines(source, core)
    lay = ours.layout
    got = hubcore._spoke_gemm_partials(lay.table, ours.spoke,
                                       words=lay.words, c=lay.core_size,
                                       tile=512)
    want = jhub._spoke_gemm_partials(ref.layout.table, ref.spoke,
                                     words=ref.layout.words,
                                     c=ref.layout.core_size, tile=512)
    assert got.dtype == torch.int64 and same(got, want)


@pytest.mark.parametrize("source", SOURCES)
def test_triangle_count_fast(source):
    g = graph(source)
    got = hubcore.triangle_count_fast(g, core=256, chunk=CHUNK, device="cpu")
    assert got == jhub.triangle_count_fast(jax_graph(g), core=256,
                                           chunk=CHUNK)
    if source == "er300":
        assert got == oracle.triangles(g) == 490


@pytest.mark.parametrize("core", [1, 8, 33, 4096])
def test_rand_graphs_oracle(core, rand_graphs):
    for jg in rand_graphs:
        g = HostGraph(rowptr=jg.rowptr, colidx=jg.colidx)
        eng = hubcore.TriangleEngine(g, core=core, chunk=CHUNK, device="cpu")
        assert eng.count() == eng.count_tail() + eng.count_core() == \
            oracle.triangles(jg)


def test_engine_split_agrees():
    ours, ref = engines("rmat12", 1024)
    assert ours.count() == ours.count_tail() + ours.count_core()
    assert (ours.count_tail(), ours.count_core()) == (ref.count_tail(),
                                                       ref.count_core())


def test_engine_wants_undirected():
    g = rmat(8, 8, seed=1).relabel_by_degree(descending=False).orientation()
    with pytest.raises(ValueError, match="undirected"):
        hubcore.TriangleEngine(g, device="cpu")


@pytest.mark.parametrize("transpose", [False, True])
def test_expand_bits_bit31(transpose):
    """Words with bit 31 set (negative int32) expand like uint32 bits, in
    the packing order w*32 + b, despite torch's arithmetic shift."""
    rng = np.random.default_rng(5)
    x = rng.integers(-(1 << 31), 1 << 31, size=(37, 3), dtype=np.int64
                     ).astype(np.int32)
    x[0] = [-1, -(1 << 31), 0x7FFFFFFF]
    want = np.unpackbits(x.view(np.uint8), axis=1, bitorder="little")
    got = hubcore._expand_bits(torch.from_numpy(x), 96, transpose=transpose)
    assert got.dtype == torch.int8
    got = got.numpy().T if transpose else got.numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(np.asarray(jhub._expand_bits(x, 96)), want)


@pytest.mark.parametrize("wa,wb", [(16, 16), (64, 16), (16, 64), (64, 64),
                                   (0, 0)])
def test_tail_count_clamps_wide_classes(wa, wb):
    """Width classes wider than the stored tail (wt_pad 8 here) clamp as
    JAX's table[:, :words + w] does, and SENTINEL task ids give 0: the plain
    tail count equals JAX's _chunk_counts."""
    rng = np.random.default_rng(wa + 3 * wb)
    words, wt, n = 8, 8, 300

    def rows(m):
        bm = rng.integers(-(1 << 31), 1 << 31, size=(m, words),
                          dtype=np.int64).astype(np.int32)
        t = np.cumsum(rng.integers(1, 4, size=(m, wt)), axis=1)
        k = rng.integers(0, wt + 1, size=m)
        t[np.arange(wt)[None, :] >= k[:, None]] = np.iinfo(np.int32).max
        return np.concatenate([bm, t.astype(np.int32)], axis=1)

    sr, dr = rows(40), rows(30)
    su = rng.integers(-2, 42, size=n).astype(np.int32)
    dv = rng.integers(-2, 32, size=n).astype(np.int32)
    su[::17] = np.iinfo(np.int32).max
    got = cuda_hubcore.hub_tail_count(
        *(torch.from_numpy(a) for a in (sr, dr, su, dv)), words=words,
        wa=wa, wb=wb)
    want = jhub._chunk_counts(sr, dr, words, wa, wb, su, dv)
    assert int(got) == int(want)
