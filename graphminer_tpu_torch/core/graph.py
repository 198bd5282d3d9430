"""Host-side CSR graph and its preprocessing (numpy).

The counterpart of graphminer_tpu/core/graph.py, copied because importing
anything under graphminer_tpu imports JAX. Parity target: include/graph.h +
src/common/graph.cc in the reference — CSR storage, DAG orientation
(graph.cc:233-279), COO edge-list materialisation (graph.cc:297-326),
neighbor sorting (graph.cc:138-146), label machinery (graph.cc:566-729). All
preprocessing here is vectorized numpy (with an optional native C++ fast
path built from native/graphcore.cpp, see ../native_bridge.py) — it runs
once per graph on the host; the hot counting loops run on the device.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np

from ..types import VID_DTYPE, EID_DTYPE
from ..utils.profiling import PROFILER


@dataclass
class HostGraph:
    """Immutable CSR graph on the host.

    rowptr: int64[V+1], colidx: int32[E]. Neighbor lists are expected sorted
    ascending (call sort_neighbors() after transforms that may break this).
    """
    rowptr: np.ndarray
    colidx: np.ndarray
    vlabels: Optional[np.ndarray] = None
    elabels: Optional[np.ndarray] = None
    meta: object = None
    name: str = "graph"
    is_dag: bool = False

    # ---- basic accessors -------------------------------------------------
    @property
    def n_vertices(self) -> int:
        return self.rowptr.shape[0] - 1

    @property
    def n_edges(self) -> int:
        return int(self.colidx.shape[0])

    def degrees(self) -> np.ndarray:
        return np.diff(self.rowptr).astype(VID_DTYPE)

    @property
    def max_degree(self) -> int:
        return int(self.degrees().max(initial=0))

    def neighbors(self, v: int) -> np.ndarray:
        return self.colidx[self.rowptr[v]:self.rowptr[v + 1]]

    # ---- construction ----------------------------------------------------
    @staticmethod
    def from_edges(src: np.ndarray, dst: np.ndarray, n_vertices: int,
                   symmetrize: bool = False, elabels: Optional[np.ndarray] = None,
                   vlabels: Optional[np.ndarray] = None) -> "HostGraph":
        """Build CSR from a COO edge list (dedup + sort). If symmetrize, add
        both directions and drop self-loops — the canonical undirected input.
        Native C++/OpenMP path (graphcore.cpp gm_csr_from_coo) when labels
        don't need to ride along."""
        src = np.asarray(src, dtype=VID_DTYPE)
        dst = np.asarray(dst, dtype=VID_DTYPE)
        if elabels is None and src.size >= (1 << 22):
            # native wins ~4x at scale (measured: 10s vs 39s at 16.7M COO);
            # below ~4M edges numpy's lexsort is already fast enough
            from .. import native_bridge
            nat = native_bridge.csr_from_coo(src, dst, n_vertices, symmetrize)
            if nat is not None:
                rowptr, colidx = nat
                return HostGraph(rowptr=rowptr, colidx=colidx,
                                 vlabels=vlabels)
        if symmetrize:
            keep = src != dst
            src, dst = src[keep], dst[keep]
            if elabels is not None:
                elabels = elabels[keep]
                elabels = np.concatenate([elabels, elabels])
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        order = np.lexsort((dst, src))
        src, dst = src[order], dst[order]
        if elabels is not None:
            elabels = np.asarray(elabels)[order]
        # dedup
        if src.size:
            keep = np.ones(src.size, dtype=bool)
            keep[1:] = (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
            src, dst = src[keep], dst[keep]
            if elabels is not None:
                elabels = elabels[keep]
        rowptr = np.zeros(n_vertices + 1, dtype=EID_DTYPE)
        np.add.at(rowptr, src + 1, 1)
        rowptr = np.cumsum(rowptr, dtype=EID_DTYPE)
        return HostGraph(rowptr=rowptr, colidx=dst.astype(VID_DTYPE),
                         elabels=elabels, vlabels=vlabels)

    # ---- transforms (each returns a new HostGraph) -----------------------
    def sort_neighbors(self) -> "HostGraph":
        """Sort each adjacency list ascending (graph.cc:138-146)."""
        deg = np.diff(self.rowptr)
        src = np.repeat(np.arange(self.n_vertices, dtype=VID_DTYPE), deg)
        order = np.lexsort((self.colidx, src))
        col = self.colidx[order]
        el = self.elabels[order] if self.elabels is not None else None
        return replace(self, colidx=col, elabels=el)

    @PROFILER.span("prep.orient")
    def orientation(self) -> "HostGraph":
        """Undirected → DAG keeping edges toward higher (degree, id).

        The standard k-clique orientation trick; semantics match reference
        graph.cc:233-279 exactly: keep u→v iff deg(v)>deg(u) or
        (deg(v)==deg(u) and v>u). Counts of oriented patterns are exact.
        Uses the native C++/OpenMP core when available (native/graphcore.cpp),
        numpy otherwise."""
        from .. import native_bridge
        nat = native_bridge.orient(self.rowptr, self.colidx)
        if nat is not None:
            rowptr, colidx = nat
            return replace(self, rowptr=rowptr, colidx=colidx, elabels=None,
                           is_dag=True)
        deg = self.degrees()
        src = np.repeat(np.arange(self.n_vertices, dtype=VID_DTYPE),
                        np.diff(self.rowptr))
        dst = self.colidx
        keep = (deg[dst] > deg[src]) | ((deg[dst] == deg[src]) & (dst > src))
        src, dst = src[keep], dst[keep]
        rowptr = np.zeros(self.n_vertices + 1, dtype=EID_DTYPE)
        np.add.at(rowptr, src + 1, 1)
        rowptr = np.cumsum(rowptr, dtype=EID_DTYPE)
        g = replace(self, rowptr=rowptr, colidx=dst.copy(), elabels=None,
                    is_dag=True)
        return g  # input neighbor lists sorted ⇒ output sorted (stable filter)

    @PROFILER.span("prep.relabel")
    def relabel_by_degree(self, descending: bool = True) -> "HostGraph":
        """Renumber vertices by degree. Unlabeled pattern counts are invariant
        under relabeling; this clusters similar-degree vertices so that padded
        device tiles (bucketed by width) waste minimal work. Native C++ path
        when available."""
        from .. import native_bridge
        nat = native_bridge.relabel_by_degree(self.rowptr, self.colidx,
                                              descending)
        if nat is not None and self.vlabels is None and self.elabels is None:
            rowptr, colidx, perm, inv = nat
            return replace(self, rowptr=rowptr, colidx=colidx)
        deg = self.degrees()
        key = -deg if descending else deg
        perm = np.argsort(key, kind="stable").astype(VID_DTYPE)  # old ids in new order
        inv = np.empty_like(perm)
        inv[perm] = np.arange(self.n_vertices, dtype=VID_DTYPE)   # old → new
        new_rowptr = np.zeros(self.n_vertices + 1, dtype=EID_DTYPE)
        new_rowptr[1:] = np.cumsum(deg[perm], dtype=EID_DTYPE)
        src = np.repeat(np.arange(self.n_vertices, dtype=VID_DTYPE), deg[perm])
        # gather each new row from the old row of perm[new_id]
        counts = deg[perm]
        starts = self.rowptr[perm]
        idx = np.repeat(starts, counts) + (
            np.arange(counts.sum(), dtype=EID_DTYPE)
            - np.repeat(new_rowptr[:-1], counts))
        new_col = inv[self.colidx[idx]]
        vl = self.vlabels[perm] if self.vlabels is not None else None
        el = self.elabels[idx] if self.elabels is not None else None
        g = replace(self, rowptr=new_rowptr, colidx=new_col, vlabels=vl,
                    elabels=el)
        return g.sort_neighbors()

    # ---- derived structures ---------------------------------------------
    def edge_list(self, sym_break: bool = False, ascend: bool = False):
        """Materialize COO (src, dst) from CSR — the task list for
        edge-parallel kernels (graph.cc:297-326). sym_break keeps the v>u
        (descend, default) or v<u (ascend) half."""
        from .. import native_bridge
        nat = native_bridge.edge_list(self.rowptr, self.colidx, sym_break,
                                      ascend)
        if nat is not None:
            return nat
        deg = np.diff(self.rowptr)
        src = np.repeat(np.arange(self.n_vertices, dtype=VID_DTYPE), deg)
        dst = self.colidx.astype(VID_DTYPE)
        if sym_break:
            keep = (src < dst) if ascend else (src > dst)
            return src[keep], dst[keep]
        return src, dst.copy()

    def is_connected_pair(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        """Vectorized membership test v ∈ N(u) via binary search."""
        u = np.asarray(u); v = np.asarray(v)
        lo = self.rowptr[u]; hi = self.rowptr[u + 1]
        out = np.zeros(u.shape, dtype=bool)
        # per-element searchsorted over the flat array restricted to [lo,hi)
        pos = np.searchsorted(self.colidx, v)  # global; refine per-row:
        for i in range(u.shape[0]):  # small-scale helper (tests only)
            seg = self.colidx[lo[i]:hi[i]]
            j = np.searchsorted(seg, v[i])
            out[i] = j < seg.size and seg[j] == v[i]
        return out

    # ---- label machinery (FSM/query; graph.cc:566-729) -------------------
    def label_frequency(self) -> np.ndarray:
        """Per-label vertex counts (graph.cc computeLabelsFrequency :566)."""
        assert self.vlabels is not None
        return np.bincount(self.vlabels.astype(np.int64))

    def build_nlf(self) -> np.ndarray:
        """Neighborhood Label Frequency: nlf[v, l] = #neighbors of v with
        label l (graph.cc BuildNLF :640-ish; query filter input). Dense
        int32 [V, n_labels] — label alphabets are small (citeseer: 6)."""
        assert self.vlabels is not None
        n_labels = int(self.vlabels.max()) + 1
        deg = np.diff(self.rowptr)
        src = np.repeat(np.arange(self.n_vertices, dtype=np.int64), deg)
        lab = self.vlabels[self.colidx].astype(np.int64)
        nlf = np.zeros((self.n_vertices, n_labels), dtype=np.int32)
        np.add.at(nlf, (src, lab), 1)
        return nlf

    def reverse_label_index(self) -> dict:
        """label -> sorted array of vertices with that label
        (graph.cc BuildReverseIndex :600-ish)."""
        assert self.vlabels is not None
        order = np.argsort(self.vlabels, kind="stable")
        labs = self.vlabels[order]
        bounds = np.nonzero(np.diff(labs))[0] + 1
        starts = np.concatenate([[0], bounds])
        stops = np.concatenate([bounds, [labs.shape[0]]])
        return {int(labs[b]): order[b:e].astype(VID_DTYPE)
                for b, e in zip(starts, stops)}

    def k_core(self) -> np.ndarray:
        """Core number per vertex via peeling (graph.cc computeKCore :700-ish;
        query-filter pruning input). O(E) bucket peeling, vectorized rounds:
        each round removes every vertex whose residual degree <= current k."""
        v = self.n_vertices
        deg = np.diff(self.rowptr).astype(np.int64)
        core = np.zeros(v, dtype=np.int32)
        alive = np.ones(v, dtype=bool)
        rdeg = deg.copy()
        k = 0
        while alive.any():
            peel = alive & (rdeg <= k)
            if not peel.any():
                k += 1
                continue
            core[peel] = k
            alive &= ~peel
            # subtract removed vertices from their alive neighbors
            idx = np.nonzero(peel)[0]
            nbrs = np.concatenate([self.neighbors(u) for u in idx]) \
                if idx.size else np.empty(0, dtype=VID_DTYPE)
            if nbrs.size:
                dec = np.bincount(nbrs, minlength=v)
                rdeg -= dec
        return core

    def validate(self) -> None:
        assert self.rowptr[0] == 0
        assert self.rowptr[-1] == self.n_edges
        assert np.all(np.diff(self.rowptr) >= 0)
        if self.n_edges:
            assert self.colidx.min() >= 0 and self.colidx.max() < self.n_vertices
        # neighbor lists sorted strictly ascending within each row
        if self.n_edges > 1:
            within = np.ones(self.n_edges - 1, dtype=bool)
            bounds = self.rowptr[1:-1]
            bounds = bounds[(bounds > 0) & (bounds < self.n_edges)]
            within[bounds - 1] = False  # pair (i, i+1) crosses a row boundary
            d = np.diff(self.colidx) > 0
            assert np.all(d | ~within), "neighbor lists not sorted/unique"
