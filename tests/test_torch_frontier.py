"""Port frontier engine (graphminer_tpu_torch/engine/frontier.py) and the
clique/SgL workloads against tests/oracle.py and the JAX package's
engine.frontier: cliques k = 3-5 and the SGL plans, map = compact, several
sub-chunk sizes, bucketed and not, an explicit width, candidate matrices and
candidate sets, count_patterns_fused, explicit tasks, a k = 2 plan and the
rmat12 goldens. Counts must be equal exactly."""
import numpy as np
import pytest
import torch

import oracle
from graphminer_tpu.core import plan as jplan
from graphminer_tpu.core.graph import HostGraph as JHostGraph
from graphminer_tpu.engine import frontier as jfrontier
from graphminer_tpu_torch.core.graph import HostGraph
from graphminer_tpu_torch.core.pattern_graph import PatternGraph
from graphminer_tpu_torch.core.plan import (SGL_PLANS, Level, Plan,
                                            clique_plan, plan_from_pattern)
from graphminer_tpu_torch.engine import frontier
from graphminer_tpu_torch.io.synth import labeled_er, rmat
from graphminer_tpu_torch.workloads.clique import clique_count
from graphminer_tpu_torch.workloads.sgl import sgl_count


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: these tests issue many small torch ops, and under
    xdist the workers' intra-op threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SGL = ["diamond", "rectangle", "house", "pentagon"]


def port_graphs(rand_graphs):
    return [HostGraph(rowptr=g.rowptr, colidx=g.colidx) for g in rand_graphs]


def jax_graph(g):
    return JHostGraph(rowptr=g.rowptr, colidx=g.colidx, vlabels=g.vlabels,
                      elabels=g.elabels, is_dag=g.is_dag)


def jax_plan(p):
    """The JAX package's plan with the same fields (its own class)."""
    lv = tuple(jplan.Level(**vars(lv)) for lv in p.levels)
    return jplan.Plan(**{**vars(p), "levels": lv})


def count(g, p, **kw):
    return frontier.count_pattern(g, p, device="cpu", **kw)


@pytest.mark.parametrize("k", [3, 4, 5])
def test_cliques_vs_oracle(rand_graphs, k):
    for g in port_graphs(rand_graphs):
        assert clique_count(g, k, device="cpu") == oracle.k_cliques(g, k)


@pytest.mark.parametrize("name", SGL)
def test_sgl_vs_oracle(rand_graphs, name):
    g = port_graphs(rand_graphs)[0]
    edges, n, _ = oracle.PATTERNS[name]
    assert sgl_count(g, name, device="cpu") == \
        oracle.count_noninduced(g, edges, n)


@pytest.mark.parametrize("name", ["3-clique", "4-clique", "5-clique"] + SGL)
def test_equal_jax(rand_graphs, name):
    p = clique_plan(int(name[0])) if "clique" in name else SGL_PLANS[name]
    g = port_graphs(rand_graphs)[3]
    assert count(g, p) == jfrontier.count_pattern(jax_graph(g), jax_plan(p))


@pytest.mark.parametrize("name", ["4-clique", "5-clique"] + SGL)
def test_map_equals_compact(rand_graphs, name):
    p = clique_plan(int(name[0])) if "clique" in name else SGL_PLANS[name]
    for g in port_graphs(rand_graphs)[1:3]:
        assert count(g, p, engine="map") == count(g, p, engine="compact")


def test_map_engine_steps(rand_graphs, monkeypatch):
    """Map steps of one slot column and of many agree."""
    g = port_graphs(rand_graphs)[3]
    p = SGL_PLANS["house"]
    want = count(g, p)
    monkeypatch.setattr(frontier, "MAP_ROWS", 1)
    assert count(g, p, engine="map", chunk=37) == want


@pytest.mark.parametrize("sub", [1, 5, 64])
def test_sub_chunk_sizes(rand_graphs, sub):
    g = port_graphs(rand_graphs)[2]
    for p in (clique_plan(4), SGL_PLANS["pentagon"]):
        assert count(g, p, chunk=16, sub=sub) == count(g, p)


def test_bucketed_and_width():
    g = rmat(9, 8, seed=1)      # max degree > 64: bucketed by default
    for p in (clique_plan(4), SGL_PLANS["diamond"], SGL_PLANS["rectangle"]):
        want = count(g, p, bucketed=False)
        assert count(g, p) == count(g, p, bucketed=True) == want
        assert count(g, p, width=g.max_degree + 3) == want
    p = SGL_PLANS["rectangle"]
    assert count(g, p) == jfrontier.count_pattern(jax_graph(g), jax_plan(p))


def test_candidate_matrix_and_sets():
    g = labeled_er(40, 0.2, seed=3)
    rng = np.random.default_rng(5)
    pat = PatternGraph.from_edges([(0, 1), (1, 2), (0, 2), (2, 3)], 4,
                                  vlabels=[1, 2, 1, 3])
    p = plan_from_pattern(pat, labeled=True)
    cand = (rng.random((4, g.n_vertices)) < 0.7).astype(np.int8)
    want = jfrontier.count_pattern(jax_graph(g), jax_plan(p), cand=cand)
    assert count(g, p, cand=cand) == want
    assert count(g, p, cand=cand, engine="map") == want
    assert count(g, p, cand=np.ones_like(cand)) == count(g, p)
    # a level over a global candidate list: v2 ∈ S ∩ N(v0) ∩ N(v1)
    ps = Plan(name="cand_tri", k=3, levels=(
        Level(source=('cand', 2), intersect=(0, 1)),), use_dag=True)
    sets = {2: np.sort(rng.choice(g.n_vertices, 25, replace=False)
                       ).astype(np.int32)}
    want = jfrontier.count_pattern(jax_graph(g), jax_plan(ps),
                                   cand_sets=sets)
    assert count(g, ps, cand_sets=sets) == want
    assert count(g, ps, cand_sets=sets, engine="map") == want
    everyone = {2: np.arange(g.n_vertices, dtype=np.int32)}
    assert count(g, ps, cand_sets=everyone) == oracle.triangles(g)


def test_count_patterns_fused_equal_jax(rand_graphs):
    g = port_graphs(rand_graphs)[2]
    plans = [clique_plan(3), SGL_PLANS["diamond"], SGL_PLANS["rectangle"],
             clique_plan(4)]
    got = frontier.count_patterns_fused(g, plans, device="cpu")
    assert got == [count(g, p) for p in plans]
    assert got == jfrontier.count_patterns_fused(
        jax_graph(g), [jax_plan(p) for p in plans])
    big = rmat(9, 8, seed=1)
    assert frontier.count_patterns_fused(big, plans[:2], device="cpu") == \
        [count(big, p) for p in plans[:2]]


def test_explicit_tasks_and_k2(rand_graphs):
    g = port_graphs(rand_graphs)[3]
    dag = g.orientation()
    src, dst = dag.edge_list()
    half = src.shape[0] // 2
    p = clique_plan(4)
    parts = [count(dag, p, tasks=(src[:half], dst[:half])),
             count(dag, p, tasks=(src[half:], dst[half:]))]
    assert sum(parts) == count(g, p) == oracle.k_cliques(g, 4)
    edge = Plan(name="edge", k=2, levels=(), edge_sym_break=True)
    assert count(g, edge) == g.n_edges // 2
    assert jfrontier.count_pattern(jax_graph(g), jax_plan(edge)) == \
        g.n_edges // 2


def test_workload_routes(rand_graphs, tmp_path):
    g = port_graphs(rand_graphs)[0]
    for k in (4, 5, 6):     # the hi/lo engines; on a DAG the frontier
        assert clique_count(g, k, fast=True, device="cpu") == \
            clique_count(g.orientation(), k, fast=True, device="cpu") == \
            oracle.k_cliques(g, k)
    for name in ("diamond", "rectangle"):   # the fast SgL engines
        edges, n, _ = oracle.PATTERNS[name]
        assert sgl_count(g, name, fast=True, device="cpu") == \
            oracle.count_noninduced(g, edges, n)
    edges, n, _ = oracle.PATTERNS["house"]      # the fast house engine
    assert sgl_count(g, "house", fast=True, device="cpu") == \
        oracle.count_noninduced(g, edges, n)
    assert clique_count(g, 3, fast=True, device="cpu") == oracle.triangles(g)
    assert sgl_count(g, "pentagon", fast=True, device="cpu") == \
        sgl_count(g, "pentagon", device="cpu")
    f = tmp_path / "tailed.txt"
    f.write_text("0 1\n1 2\n0 2\n2 3\n")
    edges, n, _ = oracle.PATTERNS["tailedtriangle"]
    want = oracle.count_noninduced(g, edges, n)
    assert sgl_count(g, "@" + str(f), device="cpu") == want
    assert sgl_count(g, "tailed_triangle", device="cpu") == want
    with pytest.raises(ValueError):
        sgl_count(g, "no-such-pattern", device="cpu")
    with pytest.raises(ValueError):
        count(g, clique_plan(3), engine="nope")


def test_rmat12_goldens():
    g = rmat(12, 16, seed=7)
    assert clique_count(g, 4, device="cpu") == 4_059_942
    assert sgl_count(g, "diamond", device="cpu") == 57_515_371
