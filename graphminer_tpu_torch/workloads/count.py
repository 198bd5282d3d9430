"""Subgraph counting (SC) via pattern decomposition + inclusion–exclusion.

The counterpart of graphminer_tpu/workloads/count.py. Parity: src/count/ in
the reference — count-only kernels that derive pattern counts from cheaper
enumerations plus arithmetic corrections (cpu_kernels/6path.h:1-108 and
friends). Closed forms over per-edge and per-vertex triangle support where
they exist (hourglass; the 4-motif family through workloads/motif.py),
hand-tuned plans (the SgL set, cliques) and generated plans on the frontier
engine for the rest, all on `device`, with the JAX package's routing.

Conformance anchor: hourglass on citeseer = 16,034 (src/count/README.md:41),
by Σ_v C(t_v, 2) − 2·Σ_e C(tri_e, 2).
"""
from __future__ import annotations

from ..core.pattern_graph import NAMED_PATTERNS
from ..core.plan import SGL_PLANS, clique_plan, plan_from_pattern
from ..device import DeviceLike
from ..engine.frontier import count_pattern
from .motif import _comb2, motif4_count, triangle_supports
from .triangle import triangle_count, triangles_per_edge


def hourglass_count(g, chunk: int = 4096, device: DeviceLike = "cuda") -> int:
    """Two triangles sharing exactly one vertex: Σ_v C(t_v, 2) −
    2·Σ_e C(tri_e, 2), summed in int64 on the device."""
    src, dst = g.edge_list(sym_break=True)
    tri_e, t_v = triangle_supports(
        triangles_per_edge(g, src, dst, chunk=chunk, device=device), src, dst,
        g.n_vertices)
    return int(_comb2(t_v).sum()) - 2 * int(_comb2(tri_e).sum())


def sc_count(g, pattern: str, chunk: int = 2048,
             device: DeviceLike = "cuda") -> int:
    """Count-only subgraph counting for a named pattern.

    Routes to: closed-form decomposition (hourglass, the 4-motif family) →
    hand-tuned plan (SgL set, cliques) → generic generated plan."""
    p = pattern.lower()
    if p == "hourglass":
        return hourglass_count(g, chunk, device=device)
    if p in ("4path", "3star", "tailedtriangle", "tailed_triangle",
             "diamond", "4cycle"):
        m = motif4_count(g, chunk=chunk, device=device)
        return m[{"tailed_triangle": "tailedtriangle"}.get(p, p)]
    if p == "triangle":
        return triangle_count(g, chunk=chunk, device=device)
    if p in ("4clique", "5clique"):
        return count_pattern(g, clique_plan(int(p[0])), chunk=chunk,
                             device=device)
    if p in SGL_PLANS:
        return count_pattern(g, SGL_PLANS[p], chunk=chunk, device=device)
    if p in NAMED_PATTERNS:
        return count_pattern(g, plan_from_pattern(NAMED_PATTERNS[p], name=p),
                             chunk=chunk, device=device)
    raise ValueError(f"unknown pattern {pattern!r}")
