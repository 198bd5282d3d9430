"""Port k-clique engine (graphminer_tpu_torch/ops/cliquek.py, kernels X and
L's plain versions) against the JAX package's ops/cliquek.py on the same
inputs: host arrays element for element, the Gram hi total against JAX's
lo16/hi16 bilinear sums, L against _lo_popcount, the counts and task
populations against JAX's CliqueKEngine, and tests/oracle.k_cliques. Inputs
from numpy seeds; all exact."""
import functools

import numpy as np
import pytest
import torch

import oracle
from graphminer_tpu.core.graph import HostGraph as JHostGraph
from graphminer_tpu.ops import cliquek as jck
from graphminer_tpu_torch.core.graph import HostGraph
from graphminer_tpu_torch.io.synth import rmat
from graphminer_tpu_torch.ops import cliquek
from graphminer_tpu_torch.ops.cuda_cliquek import lo_popcount, \
    lo_popcount_plain
from graphminer_tpu_torch.workloads.clique import clique_count

SENTINEL = np.iinfo(np.int32).max
#: (scale, edge factor, seed, engine kwargs): a real lo population and
#: tail, a smaller one, and rmat12 ef16 at the defaults
GRAPHS = {"rmat12s23": (12, 8, 23, dict(core=256, hi=64)),
          "rmat11s29": (11, 8, 29, dict(core=256, hi=64)),
          "rmat12ef16": (12, 16, 7, {})}


def jax_graph(g):
    return JHostGraph(rowptr=g.rowptr, colidx=g.colidx, is_dag=g.is_dag)


@functools.lru_cache(maxsize=None)
def graph(name):
    s, ef, seed, _ = GRAPHS[name]
    return rmat(s, ef, seed=seed)


@functools.lru_cache(maxsize=None)
def engines(name, k, slab=0):
    g, kw = graph(name), GRAPHS[name][3]
    return (cliquek.CliqueKEngine(g, k, slab=slab, device="cpu", **kw),
            jck.CliqueKEngine(jax_graph(g), k, **kw))


@functools.lru_cache(maxsize=None)
def host_inputs(name, k):
    """The engine's host inputs: (bm, core, inb, ea, eb, c, lo_cut,
    hi_words), built as CliqueKEngine builds them."""
    g, kw = graph(name), GRAPHS[name][3]
    hi = kw.get("hi") or (1024 if k == 4 else 512)
    rg = g.relabel_by_degree(descending=False).orientation()
    v = rg.n_vertices
    c = min(kw.get("core", 4096), v)
    cs = v - c
    words = -(-max(1, -(-c // 32)) // 8) * 8
    hi_words = min(max(1, hi // 32, words - c // 32), words)
    bm, core, inb = cliquek._core_bitmaps(rg, cs, c, words)
    src, dst = rg.edge_list()
    a = dst >= cs
    return (bm, core, inb, src[a].astype(np.int64), dst[a].astype(np.int64),
            c, (words - hi_words) * 32, hi_words, rg, cs, words)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_core_bitmaps_equal(name):
    bm, core, inb, *_, rg, cs, words = host_inputs(name, 4)
    c = rg.n_vertices - cs
    want = jck._core_bitmaps(jax_graph(rg), cs, c, words)
    for got, ref in zip((bm, core, inb), want):
        assert got.dtype == np.uint32 and np.array_equal(got, ref)
    assert (bm.view(np.int32) < 0).any()        # bit 31 words are present


@pytest.mark.parametrize("k", [4, 5])
@pytest.mark.parametrize("name", ["rmat12s23", "rmat11s29"])
def test_enum_tasks_equal(name, k):
    """numpy and native enumerators, each against JAX's, array for array
    (the numpy one with the native one's order: task-major, bit-ascending,
    which _bucket_tris needs)."""
    args = host_inputs(name, k)[:8]
    nat = cliquek._enum_tasks_native(*args, k)
    num = cliquek._enum_tasks(*args, k)
    jnat = jck._enum_tasks_native(*args, k)
    jnum = jck._enum_tasks(*args, k)
    assert nat is not None
    for got, ref in zip(nat, jnat):
        assert got.dtype == np.int32 and np.array_equal(got, ref)
    for got, ref in zip(num, jnum):
        assert got.dtype == np.int32 and np.array_equal(got, ref)
    n = args[3].shape[0]
    assert np.array_equal(nat[0][:n], num[0])
    for a, b in zip(nat[1:], num[1:]):
        assert np.array_equal(np.sort(a, axis=0), np.sort(b, axis=0))
    if k == 5:
        assert nat[1].shape[0] > 0 and np.all(np.diff(nat[1][:, 0]) >= 0)


@pytest.mark.parametrize("name", ["rmat12s23", "rmat11s29"])
def test_bucket_tris_equal(name):
    args = host_inputs(name, 5)[:8]
    y2hi, tri, _ = cliquek._enum_tasks_native(*args, 5)
    got = cliquek._bucket_tris(y2hi, tri)
    want = jck._bucket_tris(y2hi, tri)
    assert len(got) == len(want) > 1
    for g_, w_ in zip(got, want):
        assert g_[2] == w_[2]
        for a, b in zip((g_[0], g_[1], g_[3]), (w_[0], w_[1], w_[3])):
            assert np.array_equal(a, b)
    assert sum(int(b[3].sum()) for b in got) == tri.shape[0]
    assert cliquek._bucket_tris(y2hi, tri[:0]) == []


def test_pad_rows_equal():
    x = np.arange(10, dtype=np.int32).reshape(5, 2)
    for mult, fill in ((4, SENTINEL), (8, 0), (5, SENTINEL)):
        assert np.array_equal(cliquek._pad_rows(x, mult, fill=fill),
                              jck._pad_rows(x, mult, fill=fill))


@pytest.mark.parametrize("k", [4, 5])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_engine_arrays_equal(name, k):
    """B_hh, the k = 4 y2hi rows, the k = 5 triangle tasks and the lo tasks
    equal JAX's engine's: the port keeps the k = 5 tasks as one flat,
    edge-sorted list, which _bucket_tris turns into exactly JAX's
    buckets."""
    ours, ref = engines(name, k)
    assert ours.bhh.dtype == torch.int8
    assert np.array_equal(ours.bhh.numpy(),
                          np.asarray(ref.bhh).astype(np.int8))
    assert (ours.words, ours.hi_words) == (ref.words, ref.hi_words)
    n = ours.n_core_edges
    assert ours.y2hi.shape == (n, ours.hi_words)
    if k == 4:
        assert np.array_equal(ours.y2hi.numpy(), np.asarray(ref.y2hi)[:n])
    else:
        tri = np.stack([ours.tri_rows.numpy(), ours.tri_cols[:, 0].numpy()],
                       axis=1)
        assert tri.shape[0] == ours.n_tri and np.all(np.diff(tri[:, 0]) >= 0)
        buckets = cliquek._bucket_tris(ours.y2hi.numpy(), tri)
        assert len(buckets) == len(ref.tri_buckets)
        for (rows, cm, step, rt), (jr, jc, js, jrt) in zip(buckets,
                                                           ref.tri_buckets):
            assert step == js
            for a, b in ((rows, jr), (cm, jc), (rt, jrt)):
                assert np.array_equal(a, np.asarray(b))
    if ref.lo_cols is None:
        assert ours.lo_cols is None
    else:
        assert np.array_equal(ours.lo_cols.numpy(), np.asarray(ref.lo_cols))


@functools.lru_cache(maxsize=None)
def jax_hi_total(name, k):
    """JAX's hi part: the decoded lo16/hi16 sums of _edge_hi_bilinear
    (k = 4) or _tri_stream_bilinear over the buckets (k = 5)."""
    ref = engines(name, k)[1]
    if ref.k == 4:
        outs = [jck._edge_hi_bilinear(ref.y2hi, ref.bhh,
                                      hi_words=ref.hi_words, slab=ref.slab)]
    else:
        outs = [jck._tri_stream_bilinear(
            rows, cm, ref.core_hi, ref.bhh, hi_words=ref.hi_words,
            tcl=int(cm.shape[1]), rows_step=step)
            for rows, cm, step, _ in ref.tri_buckets]
    total = 0
    for lohi in outs:
        a = np.asarray(lohi, dtype=np.int64)
        total += int(a[:, 0].sum() + (a[:, 1].sum() << 16))
    return total


@pytest.mark.parametrize("name,k,small", [
    (name, k, small) for name in sorted(GRAPHS) for k in (4, 5)
    for small in (False, True)
    if not (small and (name, k) == ("rmat12ef16", 5))])
def test_gram_hi_total_equals_jax(name, k, small):
    """Σ ⟨B, YᵀY⟩ over X's slabs (slabs of SLAB_BYTES, or small slabs of
    4096 tasks at k = 4 and 16384 at k = 5, 4x that on the rmat12 ef16
    graph; its k = 5 hi part, the largest, is left at the default slab)
    equals JAX's per-task bilinear sums."""
    slab = 0
    if small:
        slab = (4096 if k == 4 else 16384) * (4 if name == "rmat12ef16"
                                              else 1)
    ours = engines(name, k, slab)[0]
    got = ours.hi_partials()
    assert got.dtype == torch.int64 and got.shape == (ours.hi_dim,)
    assert int(got.sum()) == jax_hi_total(name, k) > 0
    assert ours.n_slabs >= (2 if small else 1)


@pytest.mark.parametrize("k", [4, 5])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_engine_count_equals_jax(name, k):
    ours, ref = engines(name, k)
    assert (ours.n_tri, ours.n_lo, ours.n_core_edges, ours.n_edges) == \
        (ref.n_tri, ref.n_lo, ref.n_core_edges, ref.n_edges)
    assert ours.count() == ref.count()
    assert ours.native
    assert int(ours.lo_partials().sum()) == \
        (ref._lo_total() if ref.lo_cols is not None else 0)
    assert ours.tail_total == ref.tail_total
    if name != "rmat12ef16":
        assert ours.n_lo > 0 and ours.tail_total > 0


def lo_inputs(rng, nrow, v=300, c=90, words=8, n=500):
    bm = rng.integers(-2**31, 2**31, (v, words), dtype=np.int64
                      ).astype(np.int32)
    bm |= rng.integers(-2**31, 2**31, (v, words), dtype=np.int64
                       ).astype(np.int32)          # denser rows
    core = bm[v - c:].copy()
    cols = np.concatenate([rng.integers(0, v, (n, 2)),
                           rng.integers(-2, c + 2, (n, nrow - 2))], axis=1
                          ).astype(np.int32)
    cols[::7, 0] = -1                              # a < 0: 0 in both
    cols[-40:] = SENTINEL                          # the engine's padding
    return bm, core, cols


@pytest.mark.parametrize("nrow", [3, 4, 5, 6, 7, 8])
def test_lo_popcount_equals_jax(nrow):
    rng = np.random.default_rng(nrow)
    bm, core, cols = lo_inputs(rng, nrow)
    t = torch.from_numpy
    got = lo_popcount(t(bm), t(core), t(cols))
    want = np.asarray(jck._lo_popcount(
        bm, core, cols, words=bm.shape[1], chunk=100, nrow=nrow),
        dtype=np.int64).sum()
    assert got.dtype == torch.int64 and int(got.sum()) == int(want) > 0
    assert torch.equal(got, lo_popcount_plain(t(bm), t(core), t(cols)))


def test_lo_popcount_out_of_range_bm_adds_zero():
    """The intended divergence: a bm index outside [0, V) adds 0 (JAX
    clamps it, or reads bm[0] for a negative b); an empty task list gives
    0."""
    rng = np.random.default_rng(9)
    bm, core, cols = lo_inputs(rng, 4, n=60)
    t = torch.from_numpy
    base = int(lo_popcount(t(bm), t(core), t(cols)).sum())
    bad = cols.copy()
    bad[1, 1], bad[2, 0], bad[3, 1] = bm.shape[0], bm.shape[0] + 5, -1
    ok = np.ones(len(cols), bool)
    ok[1:4] = False
    assert int(lo_popcount(t(bm), t(core), t(bad)).sum()) == \
        int(lo_popcount(t(bm), t(core), t(cols[ok])).sum()) <= base
    assert int(lo_popcount(t(bm), t(core), t(cols[:0])).sum()) == 0


@pytest.mark.parametrize("k", [4, 5])
def test_rand_graphs_oracle(rand_graphs, k):
    """Every graph at the default core (all in core) and at core 16 (a
    sub-core tail), through the engine and clique_count(fast=True)."""
    for jg in rand_graphs:
        g = HostGraph(rowptr=jg.rowptr, colidx=jg.colidx)
        want = oracle.k_cliques(jg, k)
        assert clique_count(g, k, fast=True, device="cpu") == want
        assert cliquek.CliqueKEngine(g, k, core=16, hi=32,
                                     device="cpu").count() == want


def test_dag_input_and_k_checks():
    g = graph("rmat11s29")
    rg = g.relabel_by_degree(descending=False).orientation()
    assert cliquek.CliqueKEngine(rg, 4, core=256, hi=64,
                                 device="cpu").count() == \
        engines("rmat11s29", 4)[1].count()
    with pytest.raises(ValueError, match="k = 4, 5"):
        cliquek.CliqueKEngine(g, 6, device="cpu")
