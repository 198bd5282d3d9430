"""Labeled subgraph query (matching/counting) with GQL-style filtering.

The counterpart of graphminer_tpu/workloads/query.py. Parity: src/query/ in
the reference — GQL query planning (QueryPlan::generateGQLQueryPlan,
query_plan.h:10), candidate filtering with NLF + k-core + reverse label
index (Filter::{computeCandidateWithNLF, pruneCandidates}, filter.h:5-53 /
filter.cc), and per-level set-op programs executed by a DFS
(omp_base.cc:10-125).

The filter runs on the host (vectorized numpy over dense [V, n_labels] NLF
tables — the data-graph label machinery of graph.cc:566-729), producing a
[k, V] candidate bitmap, as in the JAX package. The query pattern is
compiled by plan_from_pattern(labeled=True) into a Plan whose levels carry
vertex-label constraints, and the port's frontier engine counts it on
`device` with the candidate bitmap masking both the edge-task list and
every level's candidate tiles. Filtering prunes work; label masks alone
already guarantee exactness, so the filter can only shrink the search,
never change the count. Nothing here launches a kernel of ours: the count
is torch set operations (ops/setops.py). Left out: nothing; the JAX module
has no TPU-only part.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from ..core.pattern_graph import PatternGraph
from ..core.plan import plan_from_pattern
from ..device import DeviceLike
from ..engine.frontier import count_pattern
from ..types import SENTINEL, round_up


def gql_candidates(g, query: PatternGraph, use_kcore: bool = True
                   ) -> np.ndarray:
    """Candidate matrix cand[q, v] = True if data vertex v can match query
    vertex q. Filters (each mirrors a reference Filter:: stage):
      * label:  vlabel(v) == vlabel(q)            (reverse label index)
      * degree: deg(v) >= deg(q)                  (GQL basic filter)
      * NLF:    nlf(v)[l] >= nlf(q)[l] for all l  (computeCandidateWithNLF)
      * k-core: core(v) >= core(q)                (DPiso-style pruning)
    then neighborhood refinement to a fixpoint (pruneCandidates): v stays a
    candidate for q only if, for every query-neighbor q' of q, v has at
    least one data-neighbor that is a candidate for q'."""
    assert g.vlabels is not None, "query needs a vertex-labeled data graph"
    vq = query.n_vertices
    v = g.n_vertices
    vlab = g.vlabels.astype(np.int64)
    deg = g.degrees().astype(np.int64)
    nlf = g.build_nlf()                      # [V, n_labels]
    n_labels = nlf.shape[1]

    qadj = query.adjacency()
    qdeg = qadj.sum(1)
    qnlf = np.zeros((vq, n_labels), dtype=np.int64)
    for u, w in query.edges:
        if query.vlabels[w] < n_labels:
            qnlf[u, query.vlabels[w]] += 1
        if query.vlabels[u] < n_labels:
            qnlf[w, query.vlabels[u]] += 1

    cand = np.zeros((vq, v), dtype=bool)
    for q in range(vq):
        ql = query.vlabels[q]
        if ql >= n_labels:           # label absent from the data graph
            continue
        ok = (vlab == ql) & (deg >= qdeg[q])
        ok &= np.all(nlf >= qnlf[q][None, :], axis=1)
        cand[q] = ok

    if use_kcore:
        core = g.k_core().astype(np.int64)
        qcore = _pattern_core_numbers(qadj)
        for q in range(vq):
            cand[q] &= core >= qcore[q]

    # neighborhood refinement to a bounded fixpoint: a candidate must see a
    # candidate of every q-neighbor; iterating propagates pruning through
    # the query graph (the reference's pruneCandidates loop, filter.cc)
    deg_all = np.diff(g.rowptr)
    src = np.repeat(np.arange(v, dtype=np.int64), deg_all)
    for _ in range(max(2, vq)):
        changed = False
        for q in range(vq):
            for qn in range(vq):
                if not qadj[q, qn] or not cand[q].any():
                    continue
                has = np.zeros(v, dtype=bool)
                sees = cand[qn][g.colidx]    # edge (u, w): w candidate of qn
                np.logical_or.at(has, src[sees], True)
                new = cand[q] & has
                if not np.array_equal(new, cand[q]):
                    cand[q] = new
                    changed = True
        if not changed:
            break
    return cand


def _pattern_core_numbers(adj: np.ndarray) -> np.ndarray:
    """Core numbers of the (tiny) query graph by peeling."""
    n = adj.shape[0]
    deg = adj.sum(1).astype(np.int64)
    alive = np.ones(n, dtype=bool)
    core = np.zeros(n, dtype=np.int64)
    k = 0
    while alive.any():
        peel = alive & (deg <= k)
        if not peel.any():
            k += 1
            continue
        core[peel] = k
        alive &= ~peel
        deg -= adj[:, peel].sum(1)
    return core


def candidate_index_plan(plan, cand_levels, wf: int):
    """Rewrite adjacency-sourced levels whose filtered candidate list is
    SMALLER than the adjacency tile they would otherwise build: the level
    then iterates the global candidate list and PROBES adjacency
    (source ('cand', i), original source moved into intersect) — the
    candidate-set-indexed execution of the reference's GQL plan
    (query_plan.h:10, filter.cc) instead of gather-rows-then-mask.

    cand_levels: {level index: sorted np.ndarray of candidate vertex ids}.
    Returns (plan', cand_sets for count_pattern)."""
    levels = []
    cand_sets = {}
    for i, lp in enumerate(plan.levels):
        idx = i + 2
        kind, j = lp.source
        ci = cand_levels.get(idx)
        if kind == 'adj' and ci is not None and 0 < ci.size < wf:
            pad = np.full(round_up(max(ci.size, 8), 8), SENTINEL,
                          dtype=np.int32)
            pad[: ci.size] = np.sort(ci.astype(np.int32))
            cand_sets[idx] = pad
            levels.append(dataclasses.replace(
                lp, source=('cand', idx),
                intersect=tuple(sorted(set((j,) + lp.intersect)))))
        else:
            levels.append(lp)
    return (dataclasses.replace(plan, levels=tuple(levels)),
            (cand_sets or None))


def query_count(g, query: PatternGraph, chunk: int = 2048,
                use_filter: bool = True, device: DeviceLike = "cuda") -> int:
    """Number of distinct embeddings (subgraph isomorphisms / |Aut|) of the
    labeled query in the labeled data graph, counted on `device`.

    With filtering on, the matching order prefers selective query vertices
    (small filtered candidate sets) and levels whose candidate set is
    smaller than their adjacency tile run candidate-set-indexed."""
    assert g.vlabels is not None, "query needs a vertex-labeled data graph"
    cand = None
    cand_sets = None
    if use_filter:
        cand_q = gql_candidates(g, query)
        sizes = cand_q.sum(axis=1)
        plan = plan_from_pattern(query, name="query", labeled=True,
                                 prefer=sizes)
        if not cand_q.all(axis=1).all():
            # reorder rows to the plan's matching order: cand rows are
            # indexed by plan level (v0, v1, v2, ...), not query-vertex id
            cand = cand_q[np.asarray(plan.order)]
            cand_levels = {i: np.nonzero(cand[i])[0]
                           for i in range(2, plan.k)}
            plan, cand_sets = candidate_index_plan(
                plan, cand_levels, max(8, g.max_degree))
    else:
        plan = plan_from_pattern(query, name="query", labeled=True)
    return count_pattern(g, plan, chunk=chunk, cand=cand,
                         cand_sets=cand_sets, device=device)


def make_query(edges: Sequence[Tuple[int, int]], vlabels: Sequence[int]
               ) -> PatternGraph:
    return PatternGraph(tuple(int(x) for x in vlabels),
                        tuple(sorted((min(u, v), max(u, v))
                                     for u, v in edges)))
