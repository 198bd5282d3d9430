"""k-clique counting (k-CL).

The counterpart of graphminer_tpu/workloads/clique.py. Parity: src/clique/ —
automine_omp.h:2-183 (DAG nested DFS) and clique{4,5}_warp_edge.cuh GPU
kernels. clique_plan(k) interpreted by the frontier engine over the oriented
DAG.

fast=True on an undirected graph runs the stream engine (kernel A) at
k = 3 and the hi/lo clique engine (ops/cliquek.py: kernels X and L) at
k = 4 and 5; on a DAG the frontier runs, as in JAX. The fast engine for
k >= 6 (graphminer_tpu's ops/cliquebig.py) is not ported yet: fast=True
there raises SystemExit naming ROADMAP.md, whether the graph is a DAG or
not, and nothing runs in its place.
"""
from __future__ import annotations

from ..core.plan import clique_plan
from ..device import DeviceLike
from ..engine.frontier import count_pattern


def clique_count(g, k: int, chunk: int = 1024, backend: str = "auto",
                 fast: bool = False, engine: str = "compact",
                 device: DeviceLike = "cuda") -> int:
    """Exact k-clique count.

    fast=True routes k=3 through the stream engine and k=4,5 through the
    hi/lo clique engine; plain runs use the plan-interpreting frontier."""
    assert k >= 3
    if fast and k >= 6:
        raise SystemExit(
            f"graphminer_tpu_torch: the fast {k}-clique engine "
            "(ops/cliquebig.py) is not ported yet (see ROADMAP.md, queue 1 "
            "item 5)")
    if fast and not g.is_dag:
        if k == 3:
            from ..ops.stream import triangle_count_stream
            return triangle_count_stream(g, device=device)
        from ..ops.cliquek import cliquek_count_fast
        return cliquek_count_fast(g, k, device=device)
    return count_pattern(g, clique_plan(k), chunk=chunk, backend=backend,
                         engine=engine, device=device)
