"""Rectangle (4-cycle) counting — the max-anchored truncated-codegree
engine.

The counterpart of graphminer_tpu/ops/rectangle.py. Parity:
src/sgl/cpu_kernels/rectangle.h:1-12 (v0 the cycle's max vertex, v2 < v1
its two neighbours, v3 ∈ N(v1) ∩ N(v2) below v0: each 4-cycle once).

A 4-cycle u-x-v-y has two diagonal pairs {u, v} and {x, y}; it is anchored
at the pair holding its maximum vertex v (ids ascend by degree after the
relabel):

    C4 = Σ_{pairs (u, v), v max} C(|N(u) ∩ N(v) ∩ [0, v)|, 2)

With the top `core` ids [cs, V) closed under "max of the cycle", level 0
takes every pair with v core (cases A and B of the JAX engine) in one pass
of kernel W's pairs mode (ops/cuda_colsum.py, csrc/bit_colsum.cu). For a
vertex x let T'[x] be its core bitmap fb(x) (tri_support.
_pack_full_core_bitmaps) with, when x is core, every column <= x - cs
cleared. Then for every u and every core column v (a core x counts only
below v, a sub x always),

    w_u[v] = Σ_{x ∈ N(u)} bit_v(T'[x])       (= Gs[u, v] + Wbᵀ[u, v], u core;
                                                = wcb_u[v] + wsub_u[v], u sub)

and level 0 is Σ_u Σ_{v < c, and v > u - cs when u is core} C(w_u[v], 2):
W walks each row with at least two slots once, whole (not the FT prefix),
masks the core rows on the fly, keeps the column counts bit-sliced in
registers and sums C(w, 2) on chip; rows longer than `chunk` slots are cut
into segments whose counts the finish launch sums. The level is one pairs
launch and at most one finish launch.

Case C, v sub (so all four vertices sub), is the same count on the
sub-induced graph, whose rows stay sorted. From depth 1 on, degrees are
capped by the parent's core, and once the wedges Σ C(deg, 2) are at most
WEDGE_NATIVE_CUT (or from depth 6) the native wedge pass
(native_bridge.c4_anchor, gm_c4) closes it with the same anchoring; graphs
of at most 256 vertices close by the dense identity (_c4_dense).

Level 0's sum is int64 on the device; only the scalar comes back. The
codegree assert (deg < 2^16) keeps each column count within W's 16 bit
planes.

Left out: the JAX engine's products (the Gram `_gram_rows` of the sub rows,
Wb = Mᵀ Acc, the batched wcb matvecs) and its masked factor M, the
`_pairs_lohi` / `_sum_lohi` lo/hi-16 int32 partials (a TPU workaround for
lacking int64), the `lax.map` chunking of case B and the width classes of
its FT lists (`_ft_sub_lists`, `FT_CLASSES`), and the float32-then-int32
casts. The product form survives as a yardstick only
(ops/slab_form.py::rectangle_level0_slab).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.graph import HostGraph
from ..device import DeviceLike, resolve_device
from .cuda_colsum import SEG_CUT, pairs_count, plan_pairs
from .tri_support import CORE, _pack_full_core_bitmaps, core_split

#: wedge budget below which the native anchor pass closes the recursion
WEDGE_NATIVE_CUT = 1 << 29


def _c4_dense(g) -> int:
    """Tiny-graph closer: C4 = (1/2) Σ_{u<v} C(codeg(u, v), 2) — each cycle
    counted at both diagonals (dense numpy)."""
    v = g.n_vertices
    a = np.zeros((v, v), dtype=np.int64)
    deg = np.diff(g.rowptr)
    src = np.repeat(np.arange(v), deg)
    a[src, g.colidx] = 1
    w = a @ a
    ww = w[np.triu_indices(v, 1)]
    return int((ww * (ww - 1) // 2).sum() // 2)


def _c4_wedge_anchor(g) -> int:
    """Bounded-degree closer: the max-anchored wedge pass (gm_c4, native
    OpenMP; numpy without the library). Exactly the engine's anchoring, run
    directly where Σ wedges is affordable. Rows must be sorted ascending."""
    from .. import native_bridge
    nat = native_bridge.c4_anchor(g.rowptr, g.colidx)
    if nat is not None:
        return nat
    # numpy: wedges v-u-w with u, w < v, grouped by (v, w); Σ C(mult, 2)
    v = g.n_vertices
    rowptr, colidx = g.rowptr, g.colidx
    keys = []
    for vv in range(v):
        nb = colidx[rowptr[vv]:rowptr[vv + 1]]
        for u in nb[nb < vv]:
            w = colidx[rowptr[u]:rowptr[u + 1]]
            w = w[w < vv]
            if w.size:
                keys.append(int(vv) * v + w.astype(np.int64))
    if not keys:
        return 0
    _, cnts = np.unique(np.concatenate(keys), return_counts=True)
    return int((cnts * (cnts - 1) // 2).sum())


def rectangle_count_fast(g, core: int = CORE, chunk: int = SEG_CUT,
                         device: DeviceLike = "cuda", _depth: int = 0) -> int:
    """Exact 4-cycle count via the max-anchored hybrid engine.

    Level 0 (every pair with a core end, the hub mass) is one pass of
    kernel W's pairs mode; `chunk` (the name kept) is its segment cut, the
    most list slots one segment takes before a row is split. Recursion
    levels have degree capped by the parent's core threshold, so once the
    wedge count is bounded the native anchor pass closes exactly (the
    recursion would otherwise peel only `core` ids a level)."""
    assert not g.is_dag, "rectangle needs the full undirected graph"
    if g.n_vertices <= 256:
        return _c4_dense(g)
    if _depth >= 1:
        deg = np.diff(g.rowptr).astype(np.int64)
        if (_depth >= 6
                or int((deg * (deg - 1) // 2).sum()) <= WEDGE_NATIVE_CUT):
            return _c4_wedge_anchor(g)
    dev = resolve_device(device)
    rg = g.relabel_by_degree(descending=False)
    v = rg.n_vertices
    deg = np.diff(rg.rowptr).astype(np.int64)
    assert deg.max(initial=0) < (1 << 16), \
        "codegree bound: a count within W's 16 bit planes"
    c, cs, words = core_split(rg, core)

    # level 0, cases A and B: u's whole row against T', on the device
    table = torch.from_numpy(_pack_full_core_bitmaps(rg, cs, words)).to(dev)
    csr = [torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(dev)
           for a, dt in ((rg.rowptr, np.int64), (rg.colidx, np.int32))]
    plan = plan_pairs(*csr,
                      torch.arange(v, dtype=torch.int32, device=dev), cs, c,
                      chunk)
    total = pairs_count(plan, table)
    del plan, table, csr

    if cs:
        # case C: cycles whose max vertex is sub — the sub-induced graph
        # (ids [0, cs) are a CSR prefix; the filter keeps rows sorted)
        colsrc = np.repeat(np.arange(v, dtype=np.int64), deg)
        keep_e = (colsrc < cs) & (rg.colidx < cs)
        rowptr = np.concatenate(
            [[0], np.cumsum(np.bincount(colsrc[keep_e], minlength=cs))])
        sub_g = HostGraph(rowptr=rowptr.astype(rg.rowptr.dtype),
                          colidx=rg.colidx[keep_e].copy())
        if sub_g.colidx.size:
            total += rectangle_count_fast(sub_g, core=core, chunk=chunk,
                                          device=dev, _depth=_depth + 1)
    return total
