"""Rectangle (4-cycle) counting — the max-anchored truncated-codegree
engine.

The counterpart of graphminer_tpu/ops/rectangle.py. Parity:
src/sgl/cpu_kernels/rectangle.h:1-12 (v0 the cycle's max vertex, v2 < v1
its two neighbours, v3 ∈ N(v1) ∩ N(v2) below v0: each 4-cycle once).

A 4-cycle u-x-v-y has two diagonal pairs {u, v} and {x, y}; it is anchored
at the pair holding its maximum vertex v (ids ascend by degree after the
relabel):

    C4 = Σ_{pairs (u, v), v max} C(|N(u) ∩ N(v) ∩ [0, v)|, 2)

With the top `core` ids [cs, V) closed under "max of the cycle", the
truncated codegree w splits into matrix products over the core bitmaps fb
(ops/tri_support.py::_pack_full_core_bitmaps) and their bit expansions
(kernel X, ops/cuda_expand.py), int8 operands into int32 by torch._int_mm:

 * case A, u, v both core: w = Gs[u, v] + Wb[v, u], with
     Gs = Σ_{x sub} fb(x) fb(x)ᵀ        the Gram of tri_support's T4 (R1)
     Wb = Mᵀ Acc, M = Acc ⊙ 1[x < v]     Acc the core-core adjacency (R2)
   Wbᵀ = Accᵀ M is one product of X's transposed expansion of the core
   rows and M, masked to u < v < c.
 * case B, u sub, v core, CHUNK_U sub-core u at a time (R3):
     wcb_u  = expand(fb(u)) M             X's gathered rows times M
     wsub_u = Σ_{x ∈ FT(u)} expand(fb(x))  kernel W (ops/cuda_colsum.py),
                                           FT(u) read in place as the
                                           prefix of u's sorted CSR row
   w = wcb + wsub, masked to v < c.
 * case C, v sub (so all four vertices sub): the same count on the
   sub-induced graph, whose rows stay sorted. From depth 1 on, degrees are
   capped by the parent's core, and once the wedges Σ C(deg, 2) are at most
   WEDGE_NATIVE_CUT (or from depth 6) the native wedge pass
   (native_bridge.c4_anchor, gm_c4) closes it with the same anchoring;
   graphs of at most 256 vertices close by the dense identity (_c4_dense).

Cases A and B sum Σ C(w, 2) in int64 on the device; only the scalar
comes back. The codegree assert (deg < 2^16) keeps each C(w, 2) below 2^31.

Left out: `_pairs_lohi` / `_sum_lohi` (lo/hi-16 int32 partials, a TPU
workaround for lacking int64), the `lax.map` chunking, the width classes
of case B's FT lists (`_ft_sub_lists`, `FT_CLASSES`: W reads the lists in
place) and the float32-then-int32 casts of the products.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.graph import HostGraph
from ..device import DeviceLike, resolve_device
from ..types import round_up
from .cuda_colsum import bit_colsum
from .cuda_expand import expand_bits
from .cuda_tri import FtLists
from .tri_support import (CORE, _pack_full_core_bitmaps, core_neighbours,
                          core_split, gram_rows, pairs_sum)

#: sub-core u a case-B step
CHUNK_U = 4096
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


def _case_a(gs: torch.Tensor, xt: torch.Tensor, m: torch.Tensor,
            c: int) -> int:
    """Σ_{u<v<c} C(Gs[u, v] + Wbᵀ[u, v], 2), Wbᵀ = Accᵀ M (xt = Accᵀ)."""
    w = torch._int_mm(xt, m)
    if gs is not None:
        w += gs
    return pairs_sum(torch.triu(w[:c, :c], diagonal=1))


def _case_b(table: torch.Tensor, ft: FtLists, m: torch.Tensor,
            ftw: np.ndarray, c: int, chunk: int) -> int:
    """Σ_{u sub} Σ_{v<c} C(wcb_u[v] + wsub_u[v], 2), CHUNK_U u a step; W
    launches once a step that has any sub neighbour."""
    dev = table.device
    cs = ftw.shape[0]
    total = 0
    for s in range(0, cs, chunk):
        e = min(cs, s + chunk)
        u = torch.arange(s, e, dtype=torch.int32, device=dev)
        w = torch._int_mm(expand_bits(table, r=u, n_out=round_up(e - s, 32)),
                          m)[:e - s, :c]
        if ftw[s:e].any():
            w = w + bit_colsum(ft, table, u)[:, :c]
        total += pairs_sum(w)
    return total


def rectangle_count_fast(g, core: int = CORE, chunk: int = CHUNK_U,
                         device: DeviceLike = "cuda", _depth: int = 0) -> int:
    """Exact 4-cycle count via the max-anchored hybrid engine.

    Level 0 runs the matrix-product decomposition (the hub mass); recursion
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
    assert np.diff(rg.rowptr).max(initial=0) < (1 << 16), \
        "codegree bound for int32 pairs"
    c, cs, words = core_split(rg, core)
    cpad = 32 * words
    deg, core_nb = core_neighbours(rg, cs)

    table = torch.from_numpy(_pack_full_core_bitmaps(rg, cs, words)).to(dev)
    acc = table[cs:]                                  # core rows
    # Accᵀ and M = Acc ⊙ 1[x < v], both [cpad, cpad] (zero rows past c)
    xt = expand_bits(acc, n_out=cpad, transpose=True)
    m = torch.triu(expand_bits(acc, n_out=cpad), diagonal=1)

    # case A: Gs over the sub rows with >= 2 core nbrs (fewer touch only the
    # diagonal, which u < v drops)
    keep = np.nonzero((core_nb >= 2) & (np.arange(v) < cs))[0]
    gs = gram_rows(table, keep, words) if keep.size else None
    total = _case_a(gs, xt, m, c)
    del gs, xt

    if cs:
        # case B: u sub, v core
        ft = FtLists.from_csr(rg.rowptr, rg.colidx, deg - core_nb, dev)
        total += _case_b(table, ft, m, (deg - core_nb)[:cs], c, chunk)
        del ft, m, table

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
