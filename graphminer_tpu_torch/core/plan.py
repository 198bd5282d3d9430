"""Matching-order plan IR: the codegen plans as data.

A copy of graphminer_tpu/core/plan.py (host-only, no JAX), kept here
because the port imports nothing of the JAX package.

The reference generates C++ nested-loop kernels offline (codegen/vertex_gen.py
→ src/*/cpu_kernels/*.h). Here the same information — matching order, set
operations per level, symmetry-breaking bounds — is a small datastructure that
the frontier engine (engine/frontier.py) interprets level by level with
torch ops. No source generation is needed.

Level numbering: an embedding is (v0, v1, ..., v_{k-1}). Level i (2 <= i < k)
describes how the candidate set C_i for vertex v_i is built from the already
matched vertices. v0/v1 come from the edge task list (optionally symmetry-
broken v1 < v0 on the host).

Semantics (mirrors VertexSet.h:265-342 vocabulary):
  C_i = source  ∩  N(v_j) for j in intersect  \\  N(v_j) for j in difference
  then keep values < min(v_j : j in bound), drop values in {v_j : j in exclude}.
  source = ('adj', j)  -> N(v_j)      | ('set', l) -> stored candidate set C_l
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class Level:
    source: Tuple[str, int]                  # ('adj', j) | ('set', l) |
                                             # ('cand', i): the global
                                             # filtered candidate list for
                                             # level i (query workload),
                                             # broadcast per embedding
    intersect: Tuple[int, ...] = ()
    difference: Tuple[int, ...] = ()
    bound: Tuple[int, ...] = ()              # v < min(v_j)
    lbound: Tuple[int, ...] = ()             # v > max(v_j) (symmetry order)
    exclude: Tuple[int, ...] = ()            # v != v_j
    store: bool = False                      # keep C_i for reuse at deeper levels
    vlabel: Optional[int] = None             # required vertex label (query)


@dataclass(frozen=True)
class Plan:
    name: str
    k: int                                   # pattern size (vertices)
    levels: Tuple[Level, ...]                # len == k - 2, for v2..v_{k-1}
    use_dag: bool = False                    # run on degree-oriented DAG
    edge_sym_break: bool = False             # restrict tasks to v1 < v0
    multiplicity: int = 1                    # divide final count by this
    v0_label: Optional[int] = None           # edge-task label filters (query)
    v1_label: Optional[int] = None
    order: Optional[Tuple[int, ...]] = None  # matching order: level i -> the
                                             # original pattern-vertex id it
                                             # matches (plan_from_pattern)

    def __post_init__(self):
        assert len(self.levels) == self.k - 2
        assert self.order is None or len(self.order) == self.k


# ---- pattern plan library -------------------------------------------------
# Symmetry-break structure matches the reference generated kernels so counts
# are exactly comparable (cites are the parity reference, not the source):
#   triangle  src/triangle/omp_base.cc:17-21 (DAG)
#   k-clique  src/clique/cpu_kernels/automine_omp.h (DAG)
#   diamond   src/sgl/cpu_kernels/diamond.h
#   rectangle src/sgl/cpu_kernels/rectangle.h
#   house     src/sgl/cpu_kernels/house.h
#   pentagon  src/sgl/cpu_kernels/pentagon.h

def clique_plan(k: int) -> Plan:
    """k-clique on the oriented DAG: C_i = C_{i-1} ∩ N(v_{i-1})."""
    assert k >= 3
    levels = []
    for i in range(2, k):
        src = ('adj', 0) if i == 2 else ('set', i - 1)
        levels.append(Level(source=src, intersect=(i - 1,), store=(i < k - 1)))
    return Plan(name=f"{k}-clique", k=k, levels=tuple(levels), use_dag=True)


TRIANGLE = clique_plan(3)

DIAMOND = Plan(
    name="diamond", k=4, edge_sym_break=True,
    levels=(
        Level(source=('adj', 0), intersect=(1,), store=True),   # v2 ∈ N(v0)∩N(v1)
        Level(source=('set', 2), bound=(2,)),                   # v3 ∈ same set, v3<v2
    ))

RECTANGLE = Plan(
    name="rectangle", k=4, edge_sym_break=True,
    levels=(
        Level(source=('adj', 0), bound=(1,)),                   # v2 ∈ N(v0), v2<v1
        Level(source=('adj', 1), intersect=(2,), bound=(0,)),   # v3 ∈ N(v1)∩N(v2), v3<v0
    ))

HOUSE = Plan(
    name="house", k=5, edge_sym_break=True,
    levels=(
        Level(source=('adj', 0), intersect=(1,)),               # v2 ∈ N(v0)∩N(v1)
        Level(source=('adj', 1), exclude=(0, 2)),               # v3 ∈ N(v1)\{v0,v2}
        Level(source=('adj', 0), intersect=(3,), exclude=(1, 2)),
    ))

PENTAGON = Plan(
    name="pentagon", k=5, edge_sym_break=True,
    levels=(
        Level(source=('adj', 0), bound=(1,)),                   # v2 ∈ N(v0), v2<v1
        Level(source=('adj', 2), bound=(0,), exclude=(1,)),     # v3 ∈ N(v2), v3<v0, ≠v1
        Level(source=('adj', 1), intersect=(3,), bound=(0,), exclude=(2,)),
    ))

# tailed triangle: triangle (v0,v1,v2) + pendant v3 on v2.
# Counted per automine_4motif structure: edge v1<v0, v2 ∈ N(0)∩N(1) (all
# orientations of the triangle edge → each triangle counted once per edge
# choice; pendant on exactly one designated vertex). We count:
#   v2 ∈ N(v0)∩N(v1); v3 ∈ N(v2) \ (N(v0) ∪ N(v1)), v3∉{v0,v1}  → pendant on v2
# plus pendant on v0 / v1 handled by the motif formula path instead; this plan
# is the "pendant on the apex" variant used in differential tests only.
TAILED_TRIANGLE_APEX = Plan(
    name="tailed_triangle_apex", k=4, edge_sym_break=True,
    levels=(
        Level(source=('adj', 0), intersect=(1,)),
        Level(source=('adj', 2), difference=(0, 1), exclude=(0, 1)),
    ))


SGL_PLANS = {
    "diamond": DIAMOND,
    "rectangle": RECTANGLE,
    "4cycle": RECTANGLE,
    "house": HOUSE,
    "pentagon": PENTAGON,
}


# ---- generic plan generation (codegen/vertex_gen.py parity) ---------------

def symmetry_conditions(pat, order):
    """Pairwise conditions (a, b) meaning emb[a] < emb[b] (pattern-vertex
    ids) that select exactly ONE representative per Aut(pat)-class of
    embeddings — the per-level symmetry-order restrictions of the reference
    codegen (vertex_gen.py:83-100), derived here by the orbit–stabilizer
    chain: walk vertices in matching order, constrain each to be the minimum
    of its orbit under the remaining group, then restrict to its stabilizer.
    Every Aut-class has exactly one member satisfying all conditions (the
    lexicographically-least one along `order`), so generated plans run with
    multiplicity 1 instead of |Aut|× overcounting."""
    group = list(pat.automorphisms())
    conds = []
    for w in order:
        if len(group) <= 1:
            break
        orbit = sorted({p[w] for p in group})
        conds.extend((w, u) for u in orbit if u != w)
        group = [p for p in group if p[w] == w]
    return conds


def plan_from_pattern(pat, name: Optional[str] = None,
                      labeled: bool = False,
                      prefer=None) -> Plan:
    """Compile an arbitrary connected PatternGraph into an executable Plan.

    This replaces the reference's offline codegen (vertex_gen.py → generated
    C++ loop nests): matching order is chosen greedily (max connectivity to
    the prefix, degree tie-break, like pattern_sym_ord's order search), and
    symmetry is broken per level via orbit–stabilizer conditions compiled to
    bound/lbound constraints (vertex_gen.py:83-100 parity) — each embedding
    class is enumerated exactly once (multiplicity 1). Hand-tuned plans
    (SGL_PLANS / clique_plan) stay preferable for the hot named patterns;
    this generator covers the long tail and labeled queries.

    labeled=True keeps per-vertex label constraints from pat.vlabels (query
    workload); automorphisms are label-preserving either way.

    prefer: optional per-pattern-vertex score (lower = match earlier) — the
    query workload passes filtered candidate-set sizes so selective vertices
    anchor the search (QueryPlan::generateGQLQueryPlan ordering,
    query_plan.h:10). Connectivity still dominates; prefer breaks ties.
    """
    n = pat.n_vertices
    assert n >= 2 and pat.n_edges >= 1
    a = pat.adjacency()
    deg = a.sum(1)
    pref = [0] * n if prefer is None else [float(x) for x in prefer]

    # matching order: start at the highest-degree (then most selective)
    # edge, grow by max connectivity to the prefix (ties: selectivity,
    # higher degree, lower id)
    best_edge = max(pat.edges,
                    key=lambda e: (deg[e[0]] + deg[e[1]],
                                   -(pref[e[0]] + pref[e[1]]),
                                   max(deg[e[0]], deg[e[1]])))
    u0, v0 = best_edge
    if (deg[v0], -pref[v0]) > (deg[u0], -pref[u0]):
        u0, v0 = v0, u0
    order = [u0, v0]
    while len(order) < n:
        rest = [w for w in range(n) if w not in order]
        w = max(rest, key=lambda w: (sum(a[w, x] for x in order),
                                     -pref[w], deg[w], -w))
        assert sum(a[w, x] for x in order) > 0, "pattern must be connected"
        order.append(w)

    conds = symmetry_conditions(pat, order)
    # a condition between the first two order slots becomes the edge-task
    # symmetry break (v1 < v0); flip the root edge so the direction fits
    first_two = {order[0], order[1]}
    edge_sym = any({c0, c1} == first_two for c0, c1 in conds)
    if (order[0], order[1]) in conds:          # emb[order[0]] < emb[order[1]]
        order[0], order[1] = order[1], order[0]
    pos = {w: i for i, w in enumerate(order)}

    # per-level symmetry constraints from the remaining conditions
    bound = {i: [] for i in range(2, n)}       # v_i < min(...)
    lbound = {i: [] for i in range(2, n)}      # v_i > max(...)
    for c0, c1 in conds:                       # emb[c0] < emb[c1]
        i = max(pos[c0], pos[c1])
        if i <= 1:
            continue                           # handled by edge_sym
        if pos[c0] == i:
            bound[i].append(pos[c1])
        else:
            lbound[i].append(pos[c0])

    levels = []
    for i in range(2, n):
        w = order[i]
        nbrs = tuple(sorted(pos[x] for x in range(n) if a[w, x] and pos[x] < i))
        non_nbrs = tuple(sorted(pos[x] for x in range(n)
                                if not a[w, x] and x != w and pos[x] < i))
        levels.append(Level(
            source=('adj', nbrs[0]),
            intersect=nbrs[1:],
            bound=tuple(sorted(bound[i])),
            lbound=tuple(sorted(lbound[i])),
            exclude=non_nbrs,            # injectivity wrt non-adjacent prefix
            vlabel=int(pat.vlabels[w]) if labeled else None,
        ))

    return Plan(
        name=name or f"pattern_{n}v{pat.n_edges}e",
        k=n,
        levels=tuple(levels),
        edge_sym_break=edge_sym,
        multiplicity=1,
        v0_label=int(pat.vlabels[order[0]]) if labeled else None,
        v1_label=int(pat.vlabels[order[1]]) if labeled else None,
        order=tuple(order),
    )
