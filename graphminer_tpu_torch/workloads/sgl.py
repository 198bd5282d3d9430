"""Subgraph listing / counting (SgL).

The counterpart of graphminer_tpu/workloads/sgl.py. Parity: src/sgl/ —
pattern dispatched by name (omp_base.cc:16-52) to generated kernels
(cpu_kernels/{diamond,rectangle,house,pentagon}.h …). Named plans from
core.plan, or plans generated from a PatternGraph, interpreted by the
frontier engine.

fast=True routes diamond to ops/tri_support.py::diamond_count_fast,
rectangle to ops/rectangle.py::rectangle_count_fast and house to
ops/house.py::house_count_fast, on `device`; other patterns take the
frontier engine, as in JAX.
"""
from __future__ import annotations

from ..core.pattern_graph import NAMED_PATTERNS, PatternGraph
from ..core.plan import SGL_PLANS, plan_from_pattern
from ..device import DeviceLike
from ..engine.frontier import count_pattern

#: patterns with a specialized fast engine in the JAX package that is not
#: ported yet (name -> its module there): none
FAST_ENGINES = {}


def sgl_count(g, pattern, chunk: int = 1024, backend: str = "auto",
              fast: bool = False, engine: str = "compact",
              device: DeviceLike = "cuda") -> int:
    """Count a named pattern (hand-tuned plan when available, generated plan
    otherwise — the 'drop a generated kernel into cpu_kernels/' extension
    point of the reference, omp_base.cc:16-52, as a single function call).

    pattern: a name, a PatternGraph, or "@<file>" in the reference's
    adjacency-text / CSR-binary formats (PatternGraph.from_file)."""
    if backend == "fast":
        fast, backend = True, "auto"
    if fast and isinstance(pattern, str):
        key = pattern.lower()
        if key == "diamond":
            from ..ops.tri_support import diamond_count_fast
            return diamond_count_fast(g, device=device)
        if key == "rectangle":
            from ..ops.rectangle import rectangle_count_fast
            return rectangle_count_fast(g, device=device)
        if key == "house":
            from ..ops.house import house_count_fast
            return house_count_fast(g, device=device)
    if isinstance(pattern, PatternGraph):
        plan = plan_from_pattern(pattern)
    elif pattern.startswith("@"):
        # pattern file (reference `sgl <graph> <pattern_file>` parity):
        # @/path/to/adj.txt or @codegen/input_patterns/<name> CSR dir
        pat = PatternGraph.from_file(pattern[1:])
        plan = plan_from_pattern(pat)
    else:
        key = pattern.lower()
        if key in SGL_PLANS:
            plan = SGL_PLANS[key]
        elif key in NAMED_PATTERNS:
            plan = plan_from_pattern(NAMED_PATTERNS[key], name=key)
        else:
            raise ValueError(
                f"unknown pattern {pattern!r}; have "
                f"{sorted(set(SGL_PLANS) | set(NAMED_PATTERNS))}")
    return count_pattern(g, plan, chunk=chunk, backend=backend,
                         engine=engine, device=device)
