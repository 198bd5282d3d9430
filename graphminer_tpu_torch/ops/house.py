"""House counting — per-edge triangle × square-side decomposition.

The counterpart of graphminer_tpu/ops/house.py. Parity:
src/count/cpu_kernels/house.h:1-28 (per chord edge e: tri_e · cycle_e −
overlap) and the SgL house kernels it matches (src/sgl/cpu_kernels/
house.h). Summing the reference's per-edge overlap over all edges
collapses to a pure tri_e expression,

    house = Σ_e tri_e · (sq_e − 2·(tri_e − 1)),
    sq_e  = T3_e − deg(u) − deg(v) + 1,

with tri_e = |N(u) ∩ N(v)| (ops/tri_support.py: kernels S, P, I and the
Gram) and T3_e = Σ_{x ∈ N(u), y ∈ N(v)} A[x, y] = (A³)_uv, the 3-walk
support, over the DAG edges (u < v) of the degree-ascending relabel with
the core the top `core` ids [cs, V). With FBc[x] x's core bitmap
(tri_support._pack_full_core_bitmaps) and FT(x) its sub-core neighbours
(the prefix of its sorted CSR row), T3 splits by the classes of the mid
edge (x, y):

    T3(u, v) = Σ_{x ∈ N(u)}  popcount(FBc[x] & FBc[v])   y core, x any
             + Σ_{y ∈ FT(v)} popcount(FBc[y] & FBc[u])   y sub, x core
             + T3ss(u, v)                                 x, y sub

The first two terms are two launches of kernel H (ops/cuda_house.py:
the whole rows with the tasks (u, v) in CSR order, then FT with the
tasks (v, u) sorted by v); the third is the native gm_t3ss pass on the
host (native_bridge.t3ss), as in JAX. T3 is int64 on the device and the
house count is summed there in int64; only the scalar comes back.

Left out: the WS table (`_ws_bucket`: H never forms it) and its
`FT_CLASSES` width buckets, the bilinear product over the expanded core,
the `EDGE_CHUNK` task padding and the `lax.map` chunking (each call is one
launch over all its tasks), and the float32 casts of the bilinear and the
WS dots (`_t3_edges`): every sum here is an integer sum, so the f32 dots,
which can pass 2^24 on hub-dense graphs, have no counterpart.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .cuda_house import HouseView, house_t3, plan_house
from .cuda_tri import FtLists
from .tri_support import (CORE, _pack_full_core_bitmaps, core_neighbours,
                          core_split, tri_support)


def _dag_edges(rg):
    """Undirected edges as (src < dst) pairs in CSR order (ids ascend by
    degree, so the orientation is the id order); int64 numpy."""
    deg = np.diff(rg.rowptr)
    src = np.repeat(np.arange(rg.n_vertices, dtype=np.int64), deg)
    keep = rg.colidx > src
    return src[keep], rg.colidx[keep].astype(np.int64)


def _t3ss_numpy(rg, cs: int) -> np.ndarray:
    """The sub-sub-mid share by the dense identity A[:, sub] A_ss A[sub, :]
    at the DAG edges, int32 [E] in _dag_edges order: the tests' oracle for
    native_bridge.t3ss (O(V²) memory: small graphs only; float64 products
    of 0/1 matrices, exact below 2^53)."""
    v = rg.n_vertices
    a = np.zeros((v, v), dtype=np.float64)
    deg = np.diff(rg.rowptr)
    a[np.repeat(np.arange(v), deg), rg.colidx] = 1
    m = a[:, :cs] @ a[:cs, :cs] @ a[:cs, :]
    src, dst = _dag_edges(rg)
    return m[src, dst].astype(np.int32)


def _t3ss_host(rg, cs: int) -> np.ndarray:
    """gm_t3ss's walk in numpy, for a host without the native library: for
    each u, w2[y] = #{x ∈ FT(u): y ∈ FT(x)}, then each DAG edge (u, v) sums
    w2 over FT(v). int32 [nnz] at the edges' CSR positions."""
    rowptr, colidx = rg.rowptr, rg.colidx
    deg = np.diff(rowptr)
    colsrc = np.repeat(np.arange(rg.n_vertices), deg)
    ft_end = rowptr[:-1] + np.bincount(colsrc[colidx < cs],
                                       minlength=rg.n_vertices)
    ft = lambda x: colidx[rowptr[x]:ft_end[x]]
    out = np.zeros(colidx.shape[0], dtype=np.int32)
    for u in range(rg.n_vertices):
        if ft_end[u] == rowptr[u]:
            continue
        w2 = np.bincount(np.concatenate([ft(x) for x in ft(u)]),
                         minlength=cs)
        for p in range(rowptr[u], rowptr[u + 1]):
            if colidx[p] > u:
                out[p] = w2[ft(colidx[p])].sum()
    return out


def house_calls(rg, core: int, device):
    """The calls of kernel H that edge_t3 makes over rg, the relabeled
    graph: (src, dst, cs, calls), the DAG edges (int64 numpy, CSR order),
    the core's first id and [(house_t3's arguments, its view and plan as
    keywords, the edges they count, int64 on the device)]: the whole rows
    with the tasks (u, v) in CSR order (y core, x any) and, when the core
    leaves sub-core vertices, FT with the tasks (v, u) sorted by v (y sub,
    x core; only those with a sub-core v neighbour and a core u neighbour,
    the rest add 0). Both calls' plans are built here, on the device,
    before either call is launched, and their view is the core suffix of
    each sorted row (FBc[x]'s set bits)."""
    dev = resolve_device(device)
    c, cs, words = core_split(rg, core)
    deg, core_nb = core_neighbours(rg, cs)
    table = torch.from_numpy(_pack_full_core_bitmaps(rg, cs, words)).to(dev)
    src, dst = _dag_edges(rg)
    t32 = lambda x: torch.from_numpy(x.astype(np.int32)).to(dev)
    rows = FtLists.from_csr(rg.rowptr, rg.colidx, deg, dev)
    view = HouseView(nbc=t32(core_nb), cs=cs)
    calls = [((rows, table, t32(src), t32(dst)), dict(view=view),
              torch.arange(src.shape[0], device=dev))]
    if cs:
        ftw = deg - core_nb
        sel = np.nonzero((ftw[dst] > 0) & (core_nb[src] > 0))[0]
        sel = sel[np.argsort(dst[sel], kind="stable")]
        ft = FtLists(rowptr=rows.rowptr, colidx=rows.colidx, ftw=t32(ftw))
        calls.append(((ft, table, t32(dst[sel]), t32(src[sel])),
                      dict(view=view), torch.from_numpy(sel).to(dev)))
    for args, kw, _ in calls:
        kw["plan"] = plan_house(*args[:3], view)
    return src, dst, cs, calls


def edge_t3(g, core: int = CORE, device: DeviceLike = "cuda"):
    """(rg, src, dst, t3): the degree-ascending relabel rg of g, its DAG
    edges (int64 numpy, CSR order) and T3_e per edge, int64 on the device
    — the ordered pairs (x ∈ N(u), y ∈ N(v)) with x ~ y."""
    assert not g.is_dag, "edge_t3 needs the undirected graph"
    dev = resolve_device(device)
    rg = g.relabel_by_degree(descending=False)
    deg = np.diff(rg.rowptr).astype(np.int64)
    assert int(deg.max(initial=0)) ** 2 < 1 << 31, \
        "T3 <= deg(u) deg(v) must fit kernel H's int32 sums"
    src, dst, cs, calls = house_calls(rg, core, dev)
    t3 = torch.zeros(src.shape[0], dtype=torch.int64, device=dev)
    for args, kw, idx in calls:
        t3.index_add_(0, idx, house_t3(*args, **kw).to(torch.int64))
    if cs:
        # x, y sub: the native pass on the host
        from .. import native_bridge
        ss = native_bridge.t3ss(rg.rowptr, rg.colidx, cs)
        if ss is None:
            ss = _t3ss_host(rg, cs)
        colsrc = np.repeat(np.arange(rg.n_vertices, dtype=np.int64), deg)
        t3 += torch.from_numpy(ss[rg.colidx > colsrc].astype(np.int64)).to(dev)
    return rg, src, dst, t3


def house_count_fast(g, core: int = CORE, device: DeviceLike = "cuda") -> int:
    """Exact house count via Σ_e tri_e · (sq_e − 2·(tri_e − 1)), summed in
    int64 on the device."""
    rg, src, dst, t3 = edge_t3(g, core=core, device=device)
    dev = t3.device
    deg = np.diff(rg.rowptr).astype(np.int64)
    sq = t3 - torch.from_numpy(deg[src] + deg[dst] - 1).to(dev)
    ts = tri_support(g, core=core, device=dev)
    # both edge lists are the DAG edges of the same deterministic relabel,
    # in CSR order — assert alignment before combining
    assert ts.src.shape == src.shape
    assert np.array_equal(ts.src, src) and np.array_equal(ts.dst, dst)
    tri = ts.tri
    assert bool((sq >= 0).all()) and bool((tri >= 0).all())
    return int((tri * (sq - 2 * (tri - 1))).sum())
