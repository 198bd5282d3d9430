"""Port labelled query (graphminer_tpu_torch/workloads/query.py) against
the JAX package's workloads/query.py on the same numpy-seeded labelled
graphs: the GQL candidate filter, the candidate-indexed plan rewrite and
the count with and without the filter, all exact, on the graphs and
queries of tests/test_query_filter.py (its cycle and candidate-indexed
queries among them) and a labelled rmat10; the small graph's counts also
against the brute-force oracle."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from graphminer_tpu.core.graph import HostGraph as JHostGraph
from graphminer_tpu.core.plan import plan_from_pattern as jplan_from_pattern
from graphminer_tpu.workloads import query as jquery
from graphminer_tpu_torch.core.plan import plan_from_pattern
from graphminer_tpu_torch.io.synth import labeled_er, rmat
from graphminer_tpu_torch.workloads import query

import oracle


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: these searches issue many small ops, and under
    xdist the workers' intra-op threads only contend for the cores (24x
    slower with 6 workers of 8 threads on 8 cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_graph(g):
    return JHostGraph(rowptr=g.rowptr, colidx=g.colidx, vlabels=g.vlabels)


@functools.lru_cache(maxsize=None)
def graph(name):
    if name == "rmat10":
        g = rmat(10, 8, seed=7)
        g.vlabels = np.random.default_rng(7).integers(
            1, 5, g.n_vertices).astype(np.uint8)
        return g
    n, p, labels, seed = {"er24": (24, 0.3, 2, 7), "er60": (60, 0.5, 12, 3),
                          "er56": (56, 0.5, 8, 5)}[name]
    return labeled_er(n, p, n_vlabels=labels, seed=seed)


QUERIES = {
    "wedge": ([(0, 1), (1, 2)], [0, 1, 0]),
    "triangle": ([(0, 1), (1, 2), (0, 2)], [1, 1, 0]),
    "square": ([(0, 1), (1, 2), (2, 3), (0, 3)], [0, 1, 0, 1]),
    "path4": ([(0, 1), (1, 2), (2, 3)], [1, 2, 3, 4]),
    "cycle4": ([(0, 1), (1, 2), (2, 3), (0, 3)], [1, 2, 1, 3]),
    "tailed": ([(0, 1), (1, 2), (0, 2), (2, 3)], [1, 2, 3, 4]),
}

CASES = [("er24", "wedge"), ("er24", "triangle"), ("er24", "square"),
         ("er60", "path4"), ("er56", "cycle4"), ("rmat10", "tailed")]


def make(name):
    edges, labels = QUERIES[name]
    return query.make_query(edges, labels), jquery.make_query(edges, labels)


def rewritten(mod, planner, g, q):
    """(plan, cand_sets) as query_count builds them with the filter on."""
    cand_q = mod.gql_candidates(g, q)
    plan = planner(q, name="query", labeled=True, prefer=cand_q.sum(axis=1))
    cand = cand_q[np.asarray(plan.order)]
    return mod.candidate_index_plan(
        plan, {i: np.nonzero(cand[i])[0] for i in range(2, plan.k)},
        max(8, g.max_degree))


@pytest.mark.parametrize("gname,qname", CASES)
def test_candidates_and_plan_equal_jax(gname, qname):
    g = graph(gname)
    q, jq = make(qname)
    cand = query.gql_candidates(g, q)
    assert np.array_equal(cand, jquery.gql_candidates(jax_graph(g), jq))
    assert np.array_equal(query._pattern_core_numbers(q.adjacency()),
                          jquery._pattern_core_numbers(jq.adjacency()))
    plan, sets = rewritten(query, plan_from_pattern, g, q)
    jplan, jsets = rewritten(jquery, jplan_from_pattern, jax_graph(g), jq)
    assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
    assert (sets is None) == (jsets is None)
    if sets is not None:
        assert sets.keys() == jsets.keys()
        for k in sets:
            assert sets[k].dtype == jsets[k].dtype
            assert np.array_equal(sets[k], jsets[k])


@pytest.mark.parametrize("gname,qname", CASES)
def test_query_count_equals_jax(gname, qname):
    g = graph(gname)
    q, jq = make(qname)
    got = query.query_count(g, q, device="cpu")
    assert got == query.query_count(g, q, use_filter=False, device="cpu")
    assert got == jquery.query_count(jax_graph(g), jq)
    if gname == "er24":      # the JAX tests hold the others to the oracle
        assert got == oracle.count_noninduced(
            g, list(q.edges), q.n_vertices, vlabels=list(q.vlabels))


def test_candidate_indexed_levels():
    """The many-label graph of tests/test_query_filter.py makes the rewrite
    take 'cand' levels in the port as in JAX."""
    g = graph("er60")
    q, _ = make("path4")
    plan, sets = rewritten(query, plan_from_pattern, g, q)
    assert sets and any(lp.source[0] == 'cand' for lp in plan.levels)
    assert all(a.dtype == np.int32 and a.size % 8 == 0
               for a in sets.values())
