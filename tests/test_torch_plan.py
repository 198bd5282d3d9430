"""Port plan IR and pattern graphs (graphminer_tpu_torch/core/plan.py,
core/pattern_graph.py — host-only copies) against the JAX package's: every
named plan and clique_plan(3..6) field by field, plan_from_pattern and
symmetry_conditions for each named pattern, and the pattern-file parsers."""
import dataclasses

import numpy as np
import pytest

from graphminer_tpu.core import pattern_graph as jpg
from graphminer_tpu.core import plan as jplan
from graphminer_tpu_torch.core import pattern_graph as pg
from graphminer_tpu_torch.core import plan


def fields(p):
    """A plan, level or pattern as nested plain tuples, for field-by-field
    compare."""
    return dataclasses.astuple(p)


NAMED = ["TRIANGLE", "DIAMOND", "RECTANGLE", "HOUSE", "PENTAGON",
         "TAILED_TRIANGLE_APEX"]


@pytest.mark.parametrize("name", NAMED)
def test_named_plans_equal(name):
    assert fields(getattr(plan, name)) == fields(getattr(jplan, name))


@pytest.mark.parametrize("k", [3, 4, 5, 6])
def test_clique_plans_equal(k):
    assert fields(plan.clique_plan(k)) == fields(jplan.clique_plan(k))


def test_sgl_plans_equal():
    assert sorted(plan.SGL_PLANS) == sorted(jplan.SGL_PLANS)
    for k in plan.SGL_PLANS:
        assert fields(plan.SGL_PLANS[k]) == fields(jplan.SGL_PLANS[k])


@pytest.mark.parametrize("name", sorted(jpg.NAMED_PATTERNS))
def test_generated_plans_equal(name):
    ours, ref = pg.NAMED_PATTERNS[name], jpg.NAMED_PATTERNS[name]
    assert fields(ours) == fields(ref)
    assert ours.automorphisms() == ref.automorphisms()
    assert ours.canonical_key() == ref.canonical_key()
    p, q = plan.plan_from_pattern(ours), jplan.plan_from_pattern(ref)
    assert fields(p) == fields(q)
    assert plan.symmetry_conditions(ours, p.order) == \
        jplan.symmetry_conditions(ref, q.order)
    prefer = list(range(ours.n_vertices))[::-1]
    assert fields(plan.plan_from_pattern(ours, labeled=True, prefer=prefer)) \
        == fields(jplan.plan_from_pattern(ref, labeled=True, prefer=prefer))


def test_plan_checks_level_count():
    with pytest.raises(AssertionError):
        plan.Plan(name="bad", k=4, levels=(plan.Level(source=('adj', 0)),))


def test_adj_text_labeled_parse(tmp_path):
    f = tmp_path / "tri_labeled.txt"
    f.write_text("0 1 1 2\n1 2 2 3\n0 1 2 3\n")
    for mod in (pg, jpg):
        p = mod.PatternGraph.from_file(str(f))
        assert p.n_vertices == 3 and p.n_edges == 3
        assert p.vlabels == (1, 2, 3)
    f2 = tmp_path / "path.txt"
    f2.write_text("0 1\n\n1 2\n2 3\n")
    assert fields(pg.PatternGraph.from_file(str(f2))) == \
        fields(jpg.PatternGraph.from_file(str(f2)))
    f4 = tmp_path / "lab.txt"              # tests/test_pattern_file.py's
    f4.write_text("0 5 1 7\n1 7 2 5\n")
    p = pg.PatternGraph.from_file(str(f4))
    assert (p.vlabels, p.edges) == ((5, 7, 5), ((0, 1), (1, 2)))
    f3 = tmp_path / "bad.txt"
    f3.write_text("0 1 2\n")
    with pytest.raises(ValueError):
        pg.PatternGraph.from_file(str(f3))


def test_csr_binary_parse(tmp_path):
    """The codegen/input_patterns CSR format: meta text + int64 rowptr +
    int32 colidx (diamond, both directions)."""
    edges = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3)]
    adj = {v: [] for v in range(4)}
    for u, v in edges:
        adj[u].append(v)
        adj[v].append(u)
    rowptr = np.cumsum([0] + [len(adj[v]) for v in range(4)]).astype(np.int64)
    colidx = np.concatenate([sorted(adj[v]) for v in range(4)]).astype(
        np.int32)
    d = tmp_path / "diamond"
    d.mkdir()
    (d / "graph.meta.txt").write_text(f"{rowptr.size}\n{colidx.size}\n")
    rowptr.tofile(d / "graph.vertex.bin")
    colidx.tofile(d / "graph.edge.bin")
    ours = pg.PatternGraph.from_file(str(d))
    assert fields(ours) == fields(jpg.PatternGraph.from_file(str(d)))
    assert ours.canonical_key() == pg.NAMED_PATTERNS["diamond"].canonical_key()
