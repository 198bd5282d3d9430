"""Port large-clique engine (graphminer_tpu_torch/ops/cliquebig.py, kernels
G, L and Q through their plain versions) against the JAX package's
ops/cliquebig.py on the same graphs: counts and hi/lo task counts exactly
equal to JAX's CliqueBigEngine, to tests/oracle.k_cliques and to the native
DFS counter, over the core/hi splits of tests/test_cliquebig.py, on the
native and the numpy enumerators, on both k = 6 paths and at several chunk
sizes. Graphs from numpy seeds; all exact."""
import functools
from unittest import mock

import numpy as np
import pytest
import torch

import oracle
from graphminer_tpu.core.graph import HostGraph as JHostGraph
from graphminer_tpu.io.synth import erdos_renyi
from graphminer_tpu.ops import cliquebig as jcb
from graphminer_tpu_torch import native_bridge
from graphminer_tpu_torch.core.graph import HostGraph
from graphminer_tpu_torch.io.synth import rmat
from graphminer_tpu_torch.ops import cliquebig
from graphminer_tpu_torch.ops.cuda_cliquek import MAX_RUN, lo_runs
from graphminer_tpu_torch.ops.cuda_expand import expand_bits_plain
from graphminer_tpu_torch.ops.cuda_gram import bit_gram_plain
from graphminer_tpu_torch.workloads.clique import clique_count

SENTINEL = np.iinfo(np.int32).max
#: the core/hi splits of tests/test_cliquebig.py: degenerate, partial and
#: whole-graph cores; the small hi forces real lo tasks and tails
SPLITS = [(16, 32), (64, 32), (4096, 256)]


def jax_graph(g):
    return JHostGraph(rowptr=g.rowptr, colidx=g.colidx, is_dag=g.is_dag)


@functools.lru_cache(maxsize=None)
def graph(kind, *args):
    if kind == "er":
        jg = erdos_renyi(*args)
        return HostGraph(rowptr=jg.rowptr, colidx=jg.colidx)
    s, ef, seed = args
    return rmat(s, ef, seed=seed)


def dfs(g, k):
    rg = g.relabel_by_degree(descending=False).orientation()
    return native_bridge.kclique_dfs(rg.rowptr, rg.colidx, k)


def ours(g, k, **kw):
    eng = cliquebig.CliqueBigEngine(g, k, device="cpu", **kw)
    return eng, eng.count()


def jax_ref(g, k, **kw):
    eng = jcb.CliqueBigEngine(jax_graph(g), k, **kw)
    return eng, eng.count()


def same_as_jax(g, k, **kw):
    """The port's count and task counts equal JAX's; returns the count."""
    eng, got = ours(g, k, **kw)
    ref, want = jax_ref(g, k, **kw)
    assert got == want
    assert (eng.n_hi_tasks, eng.n_lo_tasks, eng.tail_total) == \
        (ref.n_hi_tasks, ref.n_lo_tasks, ref.tail_total)
    assert eng.native
    return eng, got


@pytest.mark.parametrize("core,hi", SPLITS)
@pytest.mark.parametrize("n,p,seed,k", [
    (30, 0.5, 0, 6),
    (40, 0.45, 1, 6),
    (40, 0.45, 1, 7),
    (48, 0.45, 5, 8),
])
def test_er_vs_oracle_and_jax(n, p, seed, k, core, hi):
    g = graph("er", n, p, seed)
    _, got = same_as_jax(g, k, core=core, hi=hi)
    assert got == oracle.k_cliques(g, k)


@pytest.mark.parametrize("args,k,kw", [
    ((12, 8, 23), 6, {}),
    ((12, 8, 23), 6, dict(core=256, hi=64)),
    ((11, 8, 29), 7, {}),
])
def test_rmat_vs_jax_and_dfs(args, k, kw):
    g = graph("rmat", *args)
    eng, got = same_as_jax(g, k, **kw)
    assert got == dfs(g, k) > 0
    # the engine's own choice: at k = 6 the device path, above
    # DEV6_MIN_TRIS triangle tasks (rmat12 has 482,181 at the default core)
    assert eng.path == ("device" if k == 6 else "host")
    if kw:          # the small split has lo tasks and a tail
        assert eng.n_lo_tasks > 0 and eng.tail_total > 0


def test_engine_arrays_equal_jax():
    """The y₂ hi rows, B_hh (packed in place, expanded here) and the split
    equal JAX's engine's."""
    g = graph("rmat", 12, 8, 23)
    eng = cliquebig.CliqueBigEngine(g, 7, core=256, device="cpu")
    ref = jcb.CliqueBigEngine(jax_graph(g), 7, core=256)
    assert (eng.c, eng.words, eng.hi_words, eng.lo_bits, eng.n_core_edges,
            eng.edge_chunk) == (ref.c, ref.words, ref.hi_words, ref.lo_bits,
                                ref.n_core_edges, ref.edge_chunk)
    assert np.array_equal(eng.y2hi.numpy(),
                          np.asarray(ref.y2hi)[:eng.n_core_edges])
    bhh = expand_bits_plain(eng.hi_mask, n_out=eng.hi_dim)
    assert np.array_equal(bhh.numpy(), np.asarray(ref.bhh).astype(np.int8))
    assert np.array_equal(eng.core_hi.numpy(), np.asarray(ref.core_hi))


@pytest.mark.parametrize("k", [6, 7])
def test_hi_dispatch_equals_jax_chain(k):
    """One hi dispatch by G's plain version (gathered, depth k - 4) equals
    JAX's _chain_hi_bilinear lo16/hi16 sums on the same tasks, which JAX
    pads with SENTINEL rows."""
    g = graph("rmat", 11, 8, 29)
    eng = cliquebig.CliqueBigEngine(g, k, core=512, hi=64, device="cpu")
    ref = jcb.CliqueBigEngine(jax_graph(g), k, core=512, hi=64)
    rows = np.arange(eng.n_core_edges, dtype=np.int64)
    y2 = eng.bm_np[eng.ea] & eng.bm_np[eng.eb]
    rr, cc = eng._expand_prefixes(rows, y2, k - 4)
    assert rr.shape[0] > 1000
    got = bit_gram_plain(eng.y2hi, eng.hi_mask, r=torch.from_numpy(
        rr.astype(np.int32)), tab=eng.core_hi, cols=torch.from_numpy(
        cc.astype(np.int32)))
    slab = 1024
    pad = -rr.shape[0] % slab
    jr = np.concatenate([rr, np.full(pad, SENTINEL)]).astype(np.int32)
    jc = np.concatenate([cc, np.full((pad, k - 4), SENTINEL)]
                        ).astype(np.int32)
    lohi = np.asarray(jcb._chain_hi_bilinear(
        ref.y2hi, ref.core_hi, ref.bhh, jr, jc, hi_words=ref.hi_words,
        slab=slab, depth=k - 4), dtype=np.int64)
    assert int(got.sum()) == int(lohi[:, 0].sum() + (lohi[:, 1].sum() << 16))


@pytest.mark.parametrize("k", [6, 7])
def test_lo_tasks_and_runs(k):
    """The native and the numpy enumerators give the same lo tasks in the
    same order, the last column varying innermost: kernel L's run table
    (vary_col = nrow - 1) rebuilds them, and its runs are maximal."""
    g = graph("rmat", 11, 8, 29)
    eng = cliquebig.CliqueBigEngine(g, k, core=512, hi=32, device="cpu")
    nat = np.concatenate([t.copy() for t in eng.lo_tasks()])
    rows = np.arange(eng.n_core_edges, dtype=np.int64)
    y2 = eng.bm_np[eng.ea] & eng.bm_np[eng.eb]
    lr, lc = eng._expand_lo_cliques(rows, y2, k - 3)
    num = np.concatenate([eng.ea[lr][:, None], eng.eb[lr][:, None], lc],
                         axis=1).astype(np.int32)
    assert nat.shape == (num.shape[0], k - 1) and num.shape[0] > 10
    assert np.array_equal(nat, num)
    runs = lo_runs(nat, k - 2)
    assert nat.shape[0] > runs.n_runs > 0
    assert torch.equal(runs.tasks(), torch.from_numpy(nat))
    same = (runs.shared[1:] == runs.shared[:-1]).all(dim=1)
    lens = runs.starts[1:] - runs.starts[:-1]
    assert (lens[:-1][same] == MAX_RUN).all()


def test_streaming_chunk_invariance():
    """Neither the dispatch size (native path: many G and L dispatches
    through the two staging buffers in turns) nor the host edge chunk
    (numpy path) changes the count."""
    g = graph("rmat", 11, 8, 3)
    eng, want = ours(g, 6, core=512, hi=32)
    assert eng.n_lo_tasks > 0
    for d in (1 << 12, 1 << 14):
        with mock.patch.object(cliquebig, "DISPATCH_TASKS", d):
            assert eng.count() == want
            assert eng.n_hi_tasks > 4 * d
    with mock.patch.object(native_bridge, "get_lib", lambda: None), \
            mock.patch.object(cliquebig, "DISPATCH_TASKS", 1 << 14):
        for chunk in (128, 1 << 14):
            e2, got = ours(g, 6, core=512, hi=32, edge_chunk=chunk)
            assert got == want and not e2.native
            assert (e2.n_hi_tasks, e2.n_lo_tasks) == (eng.n_hi_tasks,
                                                      eng.n_lo_tasks)


def test_k6_device_path_equals_host():
    """The k = 6 device path (triangle tasks, Q's quads, G at depth 2),
    forced with small chunks, equals the host path: count and hi tasks."""
    g = graph("rmat", 12, 8, 23)
    host, want = ours(g, 6)
    dev = cliquebig.CliqueBigEngine(g, 6, device="cpu")
    dev.DEV6_MIN_TRIS = 0
    dev.T6 = 1 << 12
    dev.CAP6 = 1 << 16
    assert dev.count() == want
    assert dev.path == "device" and dev.n_hi_tasks == host.n_hi_tasks
    dev.DEV6_MIN_TRIS = 1 << 62
    assert dev.count() == want and dev.path == "host"


def test_numpy_path_equals_native():
    """With no native library the numpy enumerator runs (and no device
    path): the same count and task counts as the native one, at k = 6 and
    7 with lo tasks and a tail."""
    g = graph("rmat", 11, 8, 29)
    for k in (6, 7):
        nat, want = ours(g, k, core=256, hi=32)
        assert nat.n_lo_tasks > 0 and nat.tail_total > 0
        with mock.patch.object(native_bridge, "get_lib", lambda: None):
            num = cliquebig.CliqueBigEngine(g, k, core=256, hi=32,
                                            device="cpu")
            num.DEV6_MIN_TRIS = 0
            assert num.count() == want
        assert not num.native and num.path == "host"
        assert (num.n_hi_tasks, num.n_lo_tasks) == (nat.n_hi_tasks,
                                                    nat.n_lo_tasks)


def test_workload_routing_and_checks():
    g = graph("rmat", 10, 8, 7)
    want = clique_count(g, 6, fast=False, device="cpu")
    assert clique_count(g, 6, fast=True, device="cpu") == want > 0
    rg = g.relabel_by_degree(descending=False).orientation()
    assert clique_count(rg, 6, fast=True, device="cpu") == want   # frontier
    with pytest.raises(ValueError, match="k >= 6"):
        cliquebig.CliqueBigEngine(g, 5, device="cpu")


def test_sentinel_never_reaches_a_kernel():
    eng = cliquebig.CliqueBigEngine(graph("er", 30, 0.5, 0), 6,
                                    device="cpu")
    eng.count()
    bad = np.array([[0, 1, 2, 3, SENTINEL]], np.int32)
    with pytest.raises(AssertionError, match="SENTINEL"):
        eng._lo(bad)


@pytest.mark.slow
def test_clique6_rmat13_frozen_anchor():
    """rmat13 ef16 seed 7: 631,682,339 6-cliques (tests/test_cliquebig.py)."""
    assert cliquebig.cliquebig_count(rmat(13, 16, seed=7), 6,
                                     device="cpu") == 631682339


@pytest.mark.slow
def test_clique7_rmat12_frozen_anchor():
    """rmat12 ef16 seed 7: 632,745,449 7-cliques (tests/test_cliquebig.py)."""
    assert cliquebig.cliquebig_count(rmat(12, 16, seed=7), 7,
                                     device="cpu") == 632745449
