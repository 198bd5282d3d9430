"""Small labeled pattern graphs + canonical forms.

A copy of graphminer_tpu/core/pattern_graph.py (host-only numpy), kept here
because the port imports nothing of the JAX package.

Parity: include/pattern.hh (pattern graph with labelling modes, predicates)
and the gSpan canonicality machinery (src/fsm/canonical.h is_min /
dfscode.h) — redesigned: instead of DFS-code minimality we canonicalize the
(tiny) pattern graph directly by brute-force permutation minimization, which
is exact for the ≤6-vertex patterns FSM explores and keeps the search loop
simple (each pattern is visited from whichever parent reaches it first).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import FrozenSet, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class PatternGraph:
    """Connected labeled pattern: vertex labels + undirected edge set.

    elabels (optional) aligns with `edges` — edge-labeled patterns are the
    gSpan DFS-code vocabulary (from, to, vlabel, ELABEL, vlabel) of the
    reference (src/fsm/dfscode.h, omp_base.cc:151-240). Empty () means
    unlabeled edges; canonical keys of unlabeled patterns are unchanged."""
    vlabels: Tuple[int, ...]                       # label per pattern vertex
    edges: Tuple[Tuple[int, int], ...]             # (u, v) with u < v
    elabels: Tuple[int, ...] = ()                  # label per edge (or empty)

    @property
    def n_vertices(self) -> int:
        return len(self.vlabels)

    @property
    def n_edges(self) -> int:
        return len(self.edges)

    def adjacency(self) -> np.ndarray:
        a = np.zeros((self.n_vertices, self.n_vertices), dtype=bool)
        for u, v in self.edges:
            a[u, v] = a[v, u] = True
        return a

    def degree(self, v: int) -> int:
        return sum(1 for e in self.edges if v in e)

    def has_edge(self, u: int, v: int) -> bool:
        return (min(u, v), max(u, v)) in self.edges

    def edge_label(self, u: int, v: int) -> int:
        """Label of edge (u, v); 0 when the pattern is edge-unlabeled."""
        if not self.elabels:
            return 0
        e = (min(u, v), max(u, v))
        return self.elabels[self.edges.index(e)]

    def add_forward(self, at: int, new_label: int,
                    elabel: Optional[int] = None) -> "PatternGraph":
        """Attach a new vertex with new_label to pattern vertex `at`,
        via an edge labeled `elabel` (None keeps the pattern unlabeled)."""
        nv = self.n_vertices
        el = self.elabels + (elabel,) if elabel is not None else self.elabels
        return PatternGraph(self.vlabels + (new_label,),
                            self.edges + ((at, nv),), el)

    def add_backward(self, u: int, v: int,
                     elabel: Optional[int] = None) -> "PatternGraph":
        """Add edge between existing pattern vertices."""
        assert not self.has_edge(u, v)
        e = (min(u, v), max(u, v))
        el = self.elabels + (elabel,) if elabel is not None else self.elabels
        return PatternGraph(self.vlabels, self.edges + (e,), el)

    def canonical_key(self):
        """Brute-force canonical form: min over vertex permutations of the
        (labels, edges) encoding. Exact for small patterns. Edge-labeled
        patterns encode each edge as (u, v, elabel); unlabeled keys keep the
        historical (u, v) form."""
        n = self.n_vertices
        best = None
        for perm in itertools.permutations(range(n)):
            labs = tuple(self.vlabels[p] for p in perm)
            inv = [0] * n
            for newid, old in enumerate(perm):
                inv[old] = newid
            if self.elabels:
                es = tuple(sorted(
                    (min(inv[u], inv[v]), max(inv[u], inv[v]), el)
                    for (u, v), el in zip(self.edges, self.elabels)))
            else:
                es = tuple(sorted((min(inv[u], inv[v]), max(inv[u], inv[v]))
                                  for u, v in self.edges))
            key = (labs, es)
            if best is None or key < best:
                best = key
        return best

    @staticmethod
    def from_edges(edges, n_vertices: int, vlabels=None,
                   elabels=None) -> "PatternGraph":
        pairs = [(min(u, v), max(u, v)) for u, v in edges]
        if elabels is not None:
            order = sorted(range(len(pairs)), key=lambda i: pairs[i])
            es = tuple(pairs[i] for i in order)
            el = tuple(elabels[i] for i in order)
        else:
            es, el = tuple(sorted(pairs)), ()
        vl = tuple(vlabels) if vlabels is not None else (0,) * n_vertices
        return PatternGraph(vl, es, el)

    @staticmethod
    def from_file(path: str) -> "PatternGraph":
        """Read a pattern from the reference's on-disk formats
        (src/common/pattern.cc:80 read_adj_file + the CSR binaries that
        codegen/make_pattern.py writes under codegen/input_patterns/*):

        * adjacency text — one edge per line, ``u v`` (unlabeled) or
          ``u ulabel v vlabel`` (labeled vertices);
        * binary CSR — a directory (or ``<prefix>`` path) holding
          graph.meta.txt (line 1 = len(rowptr), line 2 = directed edge
          count), graph.vertex.bin (int64 rowptr) and graph.edge.bin
          (int64 or int32 colidx — inferred from the file size).
        """
        import os
        prefix = path
        if os.path.isdir(path):
            prefix = os.path.join(path, "graph")
        if os.path.exists(prefix + ".meta.txt"):
            with open(prefix + ".meta.txt") as f:
                toks = f.read().split()
            n_rowptr, n_dir = int(toks[0]), int(toks[1])
            rowptr = np.fromfile(prefix + ".vertex.bin", dtype=np.int64)
            assert rowptr.shape[0] == n_rowptr, (rowptr.shape, n_rowptr)
            esz = os.path.getsize(prefix + ".edge.bin") // max(n_dir, 1)
            colidx = np.fromfile(prefix + ".edge.bin",
                                 dtype=np.int64 if esz == 8 else np.int32)
            nv = n_rowptr - 1
            deg = np.diff(rowptr)
            src = np.repeat(np.arange(nv), deg)
            edges = {(min(int(u), int(v)), max(int(u), int(v)))
                     for u, v in zip(src, colidx)}
            return PatternGraph.from_edges(sorted(edges), nv)
        # adjacency text
        edges, labels = [], {}
        with open(path) as f:
            for line in f:
                vs = line.split()
                if not vs:
                    continue
                if len(vs) == 2:
                    u, v = int(vs[0]), int(vs[1])
                elif len(vs) == 4:
                    u, v = int(vs[0]), int(vs[2])
                    labels[u] = int(vs[1])
                    labels[v] = int(vs[3])
                else:
                    raise ValueError(f"bad pattern line: {line!r}")
                edges.append((u, v))
        nv = max(max(e) for e in edges) + 1
        vl = [labels.get(i, 0) for i in range(nv)] if labels else None
        return PatternGraph.from_edges(edges, nv, vlabels=vl)

    def automorphisms(self):
        """All label/edge-preserving vertex permutations."""
        n = self.n_vertices
        a = self.adjacency()
        el = {e: l for e, l in zip(self.edges, self.elabels)} \
            if self.elabels else None
        out = []
        for perm in itertools.permutations(range(n)):
            if any(self.vlabels[perm[i]] != self.vlabels[i] for i in range(n)):
                continue
            ok = all(a[perm[u], perm[v]] == a[u, v]
                     for u in range(n) for v in range(u + 1, n))
            if ok and el is not None:
                ok = all(
                    el[(min(perm[u], perm[v]), max(perm[u], perm[v]))] == l
                    for (u, v), l in el.items())
            if ok:
                out.append(perm)
        return out


def _p(edges, n):
    return PatternGraph.from_edges(edges, n)


# Named unlabeled patterns (reference: src/sgl/cpu_kernels/ pattern set +
# src/count/ decomposed patterns + include/pattern.hh predicates).
NAMED_PATTERNS = {
    "triangle": _p([(0, 1), (0, 2), (1, 2)], 3),
    "wedge": _p([(0, 1), (0, 2)], 3),
    "3path": _p([(0, 1), (1, 2)], 3),                     # alias of wedge
    "rectangle": _p([(0, 1), (1, 2), (2, 3), (3, 0)], 4),
    "4cycle": _p([(0, 1), (1, 2), (2, 3), (3, 0)], 4),
    "diamond": _p([(0, 1), (0, 2), (0, 3), (1, 2), (1, 3)], 4),
    "4clique": _p([(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)], 4),
    "4path": _p([(0, 1), (1, 2), (2, 3)], 4),
    "3star": _p([(0, 1), (0, 2), (0, 3)], 4),
    "tailed_triangle": _p([(0, 1), (0, 2), (1, 2), (2, 3)], 4),
    "house": _p([(0, 1), (1, 2), (2, 3), (3, 4), (4, 0), (1, 4)], 5),
    "pentagon": _p([(0, 1), (1, 2), (2, 3), (3, 4), (4, 0)], 5),
    "5cycle": _p([(0, 1), (1, 2), (2, 3), (3, 4), (4, 0)], 5),
    "hourglass": _p([(0, 1), (0, 2), (1, 2), (0, 3), (0, 4), (3, 4)], 5),
    "5path": _p([(0, 1), (1, 2), (2, 3), (3, 4)], 5),
    "4star": _p([(0, 1), (0, 2), (0, 3), (0, 4)], 5),
    "5clique": _p([(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (1, 3), (1, 4),
                   (2, 3), (2, 4), (3, 4)], 5),
    "semihouse": _p([(0, 1), (1, 2), (2, 3), (3, 4), (4, 0), (1, 4), (2, 4)], 5),
    "dumbbell": _p([(0, 1), (0, 2), (1, 2), (3, 4), (3, 5), (4, 5), (0, 3)], 6),
    "6path": _p([(0, 1), (1, 2), (2, 3), (3, 4), (4, 5)], 6),
    "tailed_diamond": _p([(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 4)], 5),
}
