"""k-motif counting (k-MC): all induced connected k-vertex pattern counts.

The counterpart of graphminer_tpu/workloads/motif.py. Parity: src/motif/ —
the formula backend (omp_formula.cc:39-47, cmap_formula.h): enumerate only
the expensive patterns (triangles per edge, 4-cliques, 4-cycles) and derive
the rest by inclusion–exclusion over non-induced counts.

k = 3 and 4 take the formulas. Without `fast` their building blocks come
from the generic path (workloads/triangle.py, the frontier engine); with
`fast` from the fast engines: the ring engine (kernels B and C) for k = 3,
and for k = 4 tri_support (kernels S, P, I and the Gram), the 4-clique
engine (kernels G and L) and the rectangle engine (kernel W's pairs mode).
Per-vertex and per-edge sums are int64 on the device; the formulas combine
Python ints; no float anywhere. k = 5 counts every connected pattern
non-induced in one fused pass of the frontier engine (count_patterns_fused;
stars by Σ C(d, 4)) and inverts the containment matrix exactly.

Nothing is left out: the module is host code over the engines, on
`device`.
"""
from __future__ import annotations

import functools
import itertools
from typing import Dict

import numpy as np
import torch

from ..core.pattern_graph import NAMED_PATTERNS, PatternGraph
from ..core.plan import RECTANGLE, clique_plan, plan_from_pattern
from ..device import DeviceLike, resolve_device
from ..engine.frontier import count_pattern, count_patterns_fused
from .triangle import triangle_count, triangles_per_edge

MOTIF3_NAMES = ("wedge", "triangle")
MOTIF4_NAMES = ("4path", "3star", "4cycle", "tailedtriangle", "diamond",
                "4clique")


def _comb2(x):
    return x * (x - 1) // 2


def _comb3(x):
    return x * (x - 1) * (x - 2) // 6


def motif3_count(g, chunk: int = 4096, fast: bool = False,
                 device: DeviceLike = "cuda") -> Dict[str, int]:
    """Induced 3-motifs: wedges = Σ C(d, 2) − 3T, triangles = T."""
    if fast:
        from ..ops.ring import triangle_count_ring
        t = triangle_count_ring(g, device=device)
    else:
        t = triangle_count(g, chunk=chunk, device=device)
    d = g.degrees().astype(np.int64)
    return {"wedge": int(_comb2(d).sum()) - 3 * t, "triangle": t}


def triangle_supports(tri_e: torch.Tensor, src, dst, n_vertices: int):
    """(tri_e int64, t_v int64 [n_vertices]) on tri_e's device: each edge's
    triangle support and each vertex's triangles (a triangle at v lies on
    two of v's edges)."""
    dev = tri_e.device
    tri_e = tri_e.to(torch.int64)
    s = torch.from_numpy(np.asarray(src, dtype=np.int64)).to(dev)
    d = torch.from_numpy(np.asarray(dst, dtype=np.int64)).to(dev)
    t2 = torch.zeros(n_vertices, dtype=torch.int64, device=dev)
    t2.index_add_(0, s, tri_e).index_add_(0, d, tri_e)
    return tri_e, t2 // 2


def motif4_count(g, chunk: int = 2048, fast: bool = False,
                 device: DeviceLike = "cuda") -> Dict[str, int]:
    """Induced 4-motifs via pattern decomposition.

    Non-induced building blocks:
      k4         — 4-clique count
      c4_ni      — 4-cycle count (= C4 + D + 3·K4)
      diamond_ni = Σ_e C(tri_e, 2)
      tt_ni      = Σ_v t_v (d_v − 2)
      p4_ni      = Σ_e (d_u − 1)(d_v − 1) − 3T
      s3_ni      = Σ_v C(d_v, 3)
    then the containment matrix inverted.

    fast=True takes tri_e from tri_support, K4 from the 4-clique engine and
    c4_ni from the rectangle engine. The degree and tri formulas are
    relabel-invariant, so they run in tri_support's degree-ascending id
    space (d = the sorted degrees)."""
    dev = resolve_device(device)
    if fast:
        from ..ops.cliquek import cliquek_count_fast
        from ..ops.rectangle import rectangle_count_fast
        from ..ops.tri_support import tri_support
        ts = tri_support(g, device=dev)
        src, dst, nv = ts.src, ts.dst, ts.n_vertices
        d = np.sort(g.degrees().astype(np.int64))   # ascending relabel
        tri = ts.tri
        k4 = cliquek_count_fast(g, 4, device=dev)
        c4_ni = rectangle_count_fast(g, device=dev)
    else:
        d = g.degrees().astype(np.int64)
        nv = g.n_vertices
        src, dst = g.edge_list(sym_break=True)
        tri = triangles_per_edge(g, src, dst, chunk=chunk, device=dev)
        k4 = count_pattern(g, clique_plan(4), chunk=chunk, device=dev)
        c4_ni = count_pattern(g, RECTANGLE, chunk=chunk, device=dev)
    tri_e, t_v = triangle_supports(tri, src, dst, nv)
    t_total = int(tri_e.sum()) // 3
    dt = torch.from_numpy(d).to(dev)
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)

    diamond_ni = int(_comb2(tri_e).sum())
    tt_ni = int((t_v * (dt - 2)).sum())
    p4_ni = int(((d[src] - 1) * (d[dst] - 1)).sum()) - 3 * t_total
    s3_ni = int(_comb3(d).sum())

    K4 = k4
    D = diamond_ni - 6 * K4
    C4 = c4_ni - D - 3 * K4
    TT = tt_ni - 4 * D - 12 * K4
    S3 = s3_ni - TT - 2 * D - 4 * K4
    P4 = p4_ni - 2 * TT - 4 * C4 - 6 * D - 12 * K4
    return {"4path": P4, "3star": S3, "4cycle": C4, "tailedtriangle": TT,
            "diamond": D, "4clique": K4}


# --------------------------------------------------------------------------
# generic k-motif counting: non-induced enumeration + containment inversion
# --------------------------------------------------------------------------
# Each connected k-vertex pattern is counted non-induced (the frontier
# engine over plans from plan_from_pattern, stars in closed form), and the
# induced vector comes from inverting the integer containment matrix
# N[q][p] = #spanning subgraphs of p isomorphic to q (Möbius inversion over
# the pattern lattice — exact).

def _is_connected(p) -> bool:
    n = p.n_vertices
    adj = p.adjacency()
    seen = {0}
    stack = [0]
    while stack:
        u = stack.pop()
        for v in range(n):
            if adj[u, v] and v not in seen:
                seen.add(v)
                stack.append(v)
    return len(seen) == n


def _spanning(edges, k: int) -> bool:
    """True when the edges touch all k vertices."""
    return len({x for e in edges for x in e}) == k


@functools.lru_cache(maxsize=None)
def _connected_patterns(k: int):
    """All connected k-vertex graphs up to isomorphism, by edge count."""
    all_edges = list(itertools.combinations(range(k), 2))
    seen = {}
    for mask in range(1, 1 << len(all_edges)):
        edges = tuple(e for i, e in enumerate(all_edges) if mask >> i & 1)
        if not _spanning(edges, k):
            continue
        p = PatternGraph.from_edges(edges, k)
        if not _is_connected(p):
            continue
        seen.setdefault(p.canonical_key(), p)
    return tuple(sorted(seen.values(), key=lambda p: p.n_edges))


@functools.lru_cache(maxsize=None)
def _containment_matrix(k: int) -> np.ndarray:
    """M[qi][pi] = #edge subsets E' of pattern p with (V, E') ≅ pattern q.
    Upper triangular (by edge count) with a unit diagonal: exact
    inversion."""
    pats = _connected_patterns(k)
    keys = {p.canonical_key(): i for i, p in enumerate(pats)}
    m = np.zeros((len(pats), len(pats)), dtype=np.int64)
    for pi, p in enumerate(pats):
        for mask in range(1, 1 << len(p.edges)):
            sub = tuple(e for i, e in enumerate(p.edges) if mask >> i & 1)
            if not _spanning(sub, k):
                continue
            qi = keys.get(PatternGraph.from_edges(sub, k).canonical_key())
            if qi is not None:
                m[qi, pi] += 1
    return m


def _comb(x, r):
    out = np.ones_like(x)
    for i in range(r):
        out = out * (x - i)
    for i in range(2, r + 1):
        out = out // i
    return out


def _star_pattern(k: int):
    return PatternGraph.from_edges([(0, i) for i in range(1, k)], k)


def motif_generic_count(g, k: int, chunk: int = 2048,
                        device: DeviceLike = "cuda"):
    """Induced k-motif counts for every connected k-vertex pattern:
    {PatternGraph: count}. Stars take the Σ C(d, k − 1) closed form; every
    other pattern is counted non-induced in one fused pass of the frontier
    engine (shared host prep, task list and one multi-plan pass a width
    class)."""
    pats = _connected_patterns(k)
    star_key = _star_pattern(k).canonical_key()
    enum_idx = [i for i, p in enumerate(pats)
                if p.canonical_key() != star_key]
    noninduced = [0] * len(pats)
    fused = count_patterns_fused(
        g, [plan_from_pattern(pats[i]) for i in enum_idx], chunk=chunk,
        device=device)
    for i, c in zip(enum_idx, fused):
        noninduced[i] = c
    for i, p in enumerate(pats):
        if p.canonical_key() == star_key:
            noninduced[i] = int(_comb(g.degrees().astype(np.int64),
                                      k - 1).sum())
    m = _containment_matrix(k)
    # back-substitution from the densest pattern (the clique) down: the
    # matrix is upper triangular with 1s on the diagonal in edge order
    induced = [0] * len(pats)
    for i in range(len(pats) - 1, -1, -1):
        induced[i] = int(noninduced[i]) - sum(
            int(m[i, j]) * induced[j] for j in range(i + 1, len(pats)))
    return {p: induced[i] for i, p in enumerate(pats)}


#: preferred display names for 5-vertex NAMED_PATTERNS entries that share a
#: canonical form with an alias (pentagon == 5cycle)
_MOTIF5_PREFERRED = ("5path", "4star", "pentagon", "house", "hourglass",
                     "semihouse", "tailed_diamond", "5clique")


def motif5_count(g, chunk: int = 2048,
                 device: DeviceLike = "cuda") -> Dict[str, int]:
    """All 21 induced 5-vertex motif counts, keyed by a readable name."""
    named = {p.canonical_key(): nm for nm, p in NAMED_PATTERNS.items()
             if p.n_vertices == 5}
    for nm in _MOTIF5_PREFERRED:            # aliases resolve to these names
        named[NAMED_PATTERNS[nm].canonical_key()] = nm
    out = {}
    anon = 0
    for p, c in motif_generic_count(g, 5, chunk=chunk, device=device).items():
        nm = named.get(p.canonical_key())
        if nm is None:
            nm = f"5motif_{p.n_edges}e_{anon}"
            anon += 1
        out[nm] = c
    return out


def motif_count(g, k: int, chunk: int = 2048, fast: bool = False,
                device: DeviceLike = "cuda") -> Dict[str, int]:
    if k == 3:
        return motif3_count(g, chunk=chunk, fast=fast, device=device)
    if k == 4:
        return motif4_count(g, chunk=chunk, fast=fast, device=device)
    if k == 5:
        return motif5_count(g, chunk=chunk, device=device)
    raise NotImplementedError(f"k={k} motifs not yet supported (have 3, 4, 5)")
