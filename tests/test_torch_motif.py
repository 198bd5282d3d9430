"""Port motif and SC workloads (graphminer_tpu_torch/workloads/motif.py and
count.py) against the JAX package's workloads/motif.py and count.py and
brute-force oracles: the k = 3 and 4 formulas over the fast engines (the
plain versions of their kernels on the CPU) and over the generic path, the
k = 5 fused frontier pass and containment inversion, and the SC routing.
Inputs from numpy seeds; all exact."""
import functools
import itertools
from collections import Counter

import numpy as np
import pytest
import torch

from graphminer_tpu.core.graph import HostGraph as JHostGraph
from graphminer_tpu.workloads import count as jcount
from graphminer_tpu.workloads import motif as jmotif
from graphminer_tpu_torch.core.graph import HostGraph
from graphminer_tpu_torch.core.pattern_graph import PatternGraph
from graphminer_tpu_torch.io.synth import erdos_renyi, rmat
from graphminer_tpu_torch.workloads import count, motif

import oracle


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: these tests issue many small torch ops, and under
    xdist the workers' intra-op threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def rmat10():
    return rmat(10, 8, seed=5)


def jax_graph(g):
    return JHostGraph(rowptr=g.rowptr, colidx=g.colidx)


def port_graph(g):
    return HostGraph(rowptr=g.rowptr, colidx=g.colidx)


@pytest.mark.parametrize("k", [3, 4])
def test_motif_fast_equals_jax(k):
    """k = 3 over the ring engine, k = 4 over tri_support, the 4-clique
    and the rectangle engines, against JAX's fast formulas."""
    g = rmat10()
    got = motif.motif_count(g, k, fast=True, device="cpu")
    assert got == jmotif.motif_count(jax_graph(g), k, fast=True)
    assert list(got) == list(motif.MOTIF3_NAMES if k == 3 else
                             motif.MOTIF4_NAMES)
    assert all(isinstance(c, int) and c > 0 for c in got.values())


def induced4(g) -> dict:
    """Induced connected 4-vertex subgraphs by brute force over vertex
    quadruples (numpy), by pattern: with no isolated vertex, the 4-vertex
    graphs of 3 or more edges are connected and differ in edge count and
    largest degree."""
    a = oracle.dense_adj(g).astype(np.int64)
    q = np.array(list(itertools.combinations(range(a.shape[0]), 4)))
    sub = a[q[:, :, None], q[:, None, :]]
    e = sub.sum((1, 2)) // 2
    d = sub.sum(2)
    dmax, ok = d.max(1), d.min(1) > 0
    names = {(3, 2): "4path", (3, 3): "3star", (4, 2): "rectangle",
             (4, 3): "tailedtriangle", (5, 3): "diamond", (6, 3): "4clique"}
    return {nm: int((ok & (e == ne) & (dmax == dm)).sum())
            for (ne, dm), nm in names.items()}


def test_motif_generic_equals_oracle(rand_graphs):
    """The generic k = 3 and 4 formulas (workloads/triangle.py and the
    frontier engine) against brute force on the two smallest rand_graphs:
    tests/oracle.py::motif_counts on the smallest, and on the second a
    quadruple walk (the oracle's permutation walk takes minutes there)."""
    g0, g1 = (port_graph(rand_graphs[i]) for i in (0, 1))
    rename = {"4cycle": "rectangle"}
    for k in (3, 4):
        got = motif.motif_count(g0, k, device="cpu")
        assert {rename.get(n, n): c for n, c in got.items()} == \
            oracle.motif_counts(rand_graphs[0], k)
    got = motif.motif_count(g1, 4, device="cpu")
    assert {rename.get(n, n): c for n, c in got.items()} == \
        induced4(rand_graphs[1])
    assert got["4clique"] > 0


def induced_oracle(g, k):
    """Induced connected k-vertex subgraphs by brute force, by canonical
    key (a copy of tests/test_motif5.py::_induced_oracle over the port's
    PatternGraph)."""
    a = oracle.dense_adj(g)
    cnt = Counter()
    for combo in itertools.combinations(range(a.shape[0]), k):
        sub = a[np.ix_(combo, combo)]
        edges = [(i, j) for i in range(k) for j in range(i + 1, k)
                 if sub[i, j]]
        p = PatternGraph.from_edges(edges, k)
        if {v for e in edges for v in e} == set(range(k)) \
                and motif._is_connected(p):
            cnt[p.canonical_key()] += 1
    return cnt


def test_motif5_equals_brute_force():
    """motif_generic_count and motif5_count at k = 5 against the induced
    5-vertex subgraphs of erdos_renyi(14, 0.35, seed=3), and motif5_count
    against JAX's names and counts."""
    g = erdos_renyi(14, 0.35, 3)
    want = induced_oracle(g, 5)
    got = motif.motif_generic_count(g, 5, device="cpu")
    assert len(got) == 21
    assert {p.canonical_key(): c for p, c in got.items() if c} == dict(want)
    named = motif.motif5_count(g, device="cpu")
    assert named == jmotif.motif5_count(jax_graph(g))
    assert sorted(named.values()) == sorted(got.values())
    assert named["house"] == want[
        motif.NAMED_PATTERNS["house"].canonical_key()]


@pytest.mark.parametrize("k", [3, 4, 5])
def test_patterns_and_containment_equal_jax(k):
    ours = motif._connected_patterns(k)
    ref = jmotif._connected_patterns(k)
    assert [p.canonical_key() for p in ours] == \
        [p.canonical_key() for p in ref]
    assert len(ours) == {3: 2, 4: 6, 5: 21}[k]
    assert np.array_equal(motif._containment_matrix(k),
                          jmotif._containment_matrix(k))


def test_motif6_not_implemented():
    with pytest.raises(NotImplementedError):
        motif.motif_count(rmat10(), 6, device="cpu")


#: SC patterns: the closed forms, the 4-motif family (both spellings of
#: the tailed triangle), the SgL plans and a generated plan
SC = ("hourglass", "4path", "3star", "tailedtriangle", "tailed_triangle",
      "diamond", "4cycle", "triangle", "4clique", "house", "pentagon",
      "5path")


def hourglasses(g) -> int:
    """Pairs of triangles that share exactly one vertex, by brute force
    over the triangles (numpy)."""
    a = oracle.dense_adj(g)
    tris = [set(t) for t in itertools.combinations(range(a.shape[0]), 3)
            if a[t[0], t[1]] and a[t[0], t[2]] and a[t[1], t[2]]]
    return sum(len(x & y) == 1 for x, y in itertools.combinations(tris, 2))


def test_sc_count_equals_jax_and_oracle(rand_graphs):
    """sc_count's routes on the two smallest rand_graphs against JAX's
    sc_count on the smallest and against brute force or the fast house
    engine on the second (hourglass, house and the 4-motif family)."""
    from graphminer_tpu_torch.ops.house import house_count_fast
    g0, g1 = (port_graph(rand_graphs[i]) for i in (0, 1))
    for p in SC:
        assert count.sc_count(g0, p, device="cpu") == \
            jcount.sc_count(rand_graphs[0], p), p
    want = induced4(rand_graphs[1])
    for p in ("4path", "3star", "tailedtriangle", "diamond", "4cycle"):
        assert count.sc_count(g1, p, device="cpu") == \
            want[{"4cycle": "rectangle"}.get(p, p)], p
    assert count.sc_count(g1, "hourglass", device="cpu") == \
        hourglasses(rand_graphs[1]) > 0
    assert count.sc_count(g1, "house", device="cpu") == \
        house_count_fast(g1, core=16, device="cpu") > 0
    with pytest.raises(ValueError):
        count.sc_count(g0, "no-such-pattern", device="cpu")
