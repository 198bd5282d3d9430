"""Graph partitioning for graphs that exceed one device or host.

The counterpart of graphminer_tpu/parallel/partition.py, on the port's
HostGraph (host numpy; partitions, blocks and segments are identical).
Parity: include/graph_partition.h + src/common/graph_partition.cc — 1D
edge-cut partitioning, vertex-induced partitions with halo (masks = owned
vertices + their neighbors, re-indexed local CSR, :24-160), 2D blocks and
CSR segmenting (cache blocking, :44-48 citing Zhang et al. 2017). Each
partition owns a contiguous vertex range's edges plus the adjacency closure
needed to complete its patterns, so the local counts of owned-anchor tasks
sum to the exact global count with no replication.

The induced partition's local rows are built in one vectorized pass over
every member row (a stable sort by (row, local id)), where the JAX package
loops over the member vertices in Python; the rows are the same.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from ..core.graph import HostGraph
from ..types import EID_DTYPE, VID_DTYPE


@dataclass
class InducedPartition:
    """Local subgraph for one worker.

    local graph vertices = owned range ∪ halo (neighbors of owned), re-indexed
    0..n_local in GLOBAL id order — order-preserving, because symmetry-break
    comparisons (v1 < v0, bound/lbound levels) are id-order sensitive;
    `global_ids[i]` maps back; `owned_mask[i]` marks owned locals. Edge tasks
    anchored at owned vertices are complete in the local graph (halo
    closure), which is what edge-parallel counting with recomputation needs.

    Contract: apply degree orientation (and any relabeling) on the GLOBAL
    graph BEFORE partitioning — local degrees would otherwise change the
    (degree, id) DAG and break exactly-once counting across partitions."""
    graph: HostGraph
    global_ids: np.ndarray
    owned_mask: np.ndarray
    n_owned: int
    owned_start: int
    owned_stop: int


def edgecut_partition_1d(g: HostGraph, n_parts: int) -> np.ndarray:
    """Split the vertex range into n contiguous chunks balanced by edge count
    (graph_partition.cc edgecut_partition1D). Returns [n_parts+1] boundaries."""
    target = g.n_edges / n_parts
    bounds = [0]
    for p in range(1, n_parts):
        bounds.append(int(np.searchsorted(g.rowptr, target * p)))
    bounds.append(g.n_vertices)
    return np.array(sorted(set(bounds)), dtype=np.int64)


def _local_rows(g: HostGraph, verts: np.ndarray, full_local: np.ndarray,
                member: np.ndarray, remap: np.ndarray):
    """(rowptr, colidx) of the local CSR over `verts`: row i is vertex
    verts[i]'s neighbours re-indexed by remap and sorted, all of them when
    full_local[i], else only those in `member`."""
    deg = np.diff(g.rowptr)[verts]
    n = int(deg.sum())
    row = np.repeat(np.arange(verts.shape[0], dtype=np.int64), deg)
    first = np.cumsum(deg) - deg
    pos = np.repeat(g.rowptr[verts] - first, deg) + np.arange(n)
    nb = g.colidx[pos].astype(np.int64)
    keep = full_local[row] | member[nb]
    row, local = row[keep], remap[nb[keep]]
    local = local[np.lexsort((local, row))]
    rowptr = np.zeros(verts.shape[0] + 1, dtype=EID_DTYPE)
    rowptr[1:] = np.cumsum(np.bincount(row, minlength=verts.shape[0]))
    return rowptr, local.astype(VID_DTYPE)


def induced_partition_1d(g: HostGraph, n_parts: int,
                         hops: int = 1) -> List[InducedPartition]:
    """Vertex-induced 1D partitions with halo
    (graph_partition.cc:82-160 + generate_induced_subgraph :24-79).

    hops: halo radius. Vertices within distance < hops of the owned range
    keep FULL rows; the outermost shell keeps rows restricted to members.
    hops=1 suffices for plans whose every matched vertex is adjacent to the
    task anchor v0 (TC, k-clique, diamond); plans that walk away from v0
    (rectangle, house, pentagon) need hops=2 — see
    parallel.distributed.plan_halo_hops."""
    assert hops >= 1
    bounds = edgecut_partition_1d(g, n_parts)
    deg = np.diff(g.rowptr)
    src_all = np.repeat(np.arange(g.n_vertices, dtype=np.int64), deg)
    out = []
    for p in range(len(bounds) - 1):
        lo, hi = int(bounds[p]), int(bounds[p + 1])
        owned = np.arange(lo, hi, dtype=np.int64)
        # BFS shells: full-row set grows hops-1 times beyond owned
        full = np.zeros(g.n_vertices, dtype=bool)
        full[lo:hi] = True
        frontier = owned
        for _ in range(hops - 1):
            fmask = np.zeros(g.n_vertices, dtype=bool)
            fmask[frontier] = True
            nb = np.unique(g.colidx[fmask[src_all]].astype(np.int64))
            frontier = nb[~full[nb]]
            full[frontier] = True
        # outer shell: neighbors of full-row vertices, restricted rows
        halo = np.unique(g.colidx[full[src_all]].astype(np.int64))
        member = full.copy()
        member[halo] = True
        verts = np.nonzero(member)[0]                # ascending global order
        remap = np.full(g.n_vertices, -1, dtype=np.int64)
        remap[verts] = np.arange(verts.shape[0])
        rowptr, colidx = _local_rows(g, verts, full[verts], member, remap)
        vl = g.vlabels[verts] if g.vlabels is not None else None
        lg = HostGraph(rowptr=rowptr, colidx=colidx, vlabels=vl,
                       name=f"{g.name}.part{p}", is_dag=g.is_dag)
        out.append(InducedPartition(graph=lg, global_ids=verts,
                                    owned_mask=(verts >= lo) & (verts < hi),
                                    n_owned=owned.shape[0],
                                    owned_start=lo, owned_stop=hi))
    return out


@dataclass
class Partition2D:
    """2D-partitioned graph (graph_partition.h:50-55 partition2D parity):
    block (i, j) holds the edges src ∈ cluster i → dst ∈ cluster j as a
    local CSR whose rows are ranks-in-cluster-i and whose columns stay
    GLOBAL dst ids (the reference keeps global colidx too). Block CSRs
    tile the edge set exactly: Σ blocks = the full adjacency."""
    n_clusters: int
    cluster_ids: np.ndarray            # int32 [V] cluster of each vertex
    verts_of_cluster: List[np.ndarray]  # global ids per cluster, ascending
    rank_in_cluster: np.ndarray        # int64 [V]
    rowptr: List[np.ndarray]           # per block [n_i + 1]
    colidx: List[np.ndarray]           # per block [E_ij] global dst ids

    def block(self, i: int, j: int):
        pid = i * self.n_clusters + j
        return self.rowptr[pid], self.colidx[pid]


def partition_2d(g: HostGraph, cluster_ids: np.ndarray) -> Partition2D:
    """Partition g into nc x nc edge blocks by (src cluster, dst cluster)
    — graph_partition.cc partition2D semantics, vectorized numpy."""
    cluster_ids = np.asarray(cluster_ids, dtype=np.int32)
    nc = int(cluster_ids.max()) + 1 if cluster_ids.size else 0
    v = g.n_vertices
    order = np.argsort(cluster_ids, kind="stable")
    rank = np.empty(v, dtype=np.int64)
    verts_of = []
    for i in range(nc):
        vs = order[cluster_ids[order] == i]
        vs = np.sort(vs)
        verts_of.append(vs.astype(np.int64))
        rank[vs] = np.arange(vs.shape[0])
    deg = np.diff(g.rowptr)
    src = np.repeat(np.arange(v, dtype=np.int64), deg)
    sc = cluster_ids[src].astype(np.int64)
    dc = cluster_ids[g.colidx].astype(np.int64)
    pid = sc * nc + dc
    rowptrs, colidxs = [], []
    for p in range(nc * nc):
        i = p // nc
        m = pid == p
        n_i = verts_of[i].shape[0]
        rp = np.zeros(n_i + 1, dtype=EID_DTYPE)
        np.add.at(rp, rank[src[m]] + 1, 1)
        rowptrs.append(np.cumsum(rp, dtype=EID_DTYPE))
        # CSR order is src-major then original column order — stable mask
        # keep preserves per-row ascending columns
        colidxs.append(g.colidx[m].astype(VID_DTYPE))
    return Partition2D(n_clusters=nc, cluster_ids=cluster_ids,
                       verts_of_cluster=verts_of, rank_in_cluster=rank,
                       rowptr=rowptrs, colidx=colidxs)


def save_partitions_2d(path: str, p: Partition2D) -> None:
    """Persist the 2D blocks (the reference writes pgraph.*.bin files —
    graph_partition.cc partition2D tail; here one .npz bundle)."""
    arrs = {"cluster_ids": p.cluster_ids,
            "n_clusters": np.array([p.n_clusters])}
    for b in range(p.n_clusters * p.n_clusters):
        arrs[f"rowptr{b}"] = p.rowptr[b]
        arrs[f"colidx{b}"] = p.colidx[b]
    with open(path, "wb") as f:
        np.savez(f, **arrs)


def fetch_partitions(path: str, clusters: List[int]) -> HostGraph:
    """Load the edges among the given clusters from a saved 2D partition
    and form the induced subgraph in CSR over GLOBAL vertex ids
    (graph_partition.h:55 fetch_partitions parity). Only the requested
    blocks are read — the out-of-core access pattern."""
    with np.load(path) as z:
        nc = int(z["n_clusters"][0])
        cluster_ids = z["cluster_ids"]
        v = cluster_ids.shape[0]
        sel = sorted(set(int(c) for c in clusters))
        rows_parts: List[np.ndarray] = []
        srcs_parts: List[np.ndarray] = []
        for i in sel:
            vs = np.nonzero(cluster_ids == i)[0]
            for j in sel:
                rp = z[f"rowptr{i * nc + j}"]
                ci = z[f"colidx{i * nc + j}"]
                if ci.size == 0:
                    continue
                srcs_parts.append(np.repeat(vs, np.diff(rp)))
                rows_parts.append(ci.astype(np.int64))
    if rows_parts:
        src = np.concatenate(srcs_parts)
        dst = np.concatenate(rows_parts)
        return HostGraph.from_edges(src.astype(VID_DTYPE),
                                    dst.astype(VID_DTYPE), v)
    return HostGraph(rowptr=np.zeros(v + 1, dtype=EID_DTYPE),
                     colidx=np.zeros(0, dtype=VID_DTYPE))


def csr_segmenting(g: HostGraph, n_segments: int) -> List[HostGraph]:
    """Column-range segmenting for locality (graph_partition.h:44-48): each
    segment keeps all rows but only the column range it owns. Σ segments'
    adjacency = the full graph."""
    bounds = np.linspace(0, g.n_vertices, n_segments + 1).astype(np.int64)
    segs = []
    deg = np.diff(g.rowptr)
    src = np.repeat(np.arange(g.n_vertices, dtype=np.int64), deg)
    for s in range(n_segments):
        lo, hi = bounds[s], bounds[s + 1]
        m = (g.colidx >= lo) & (g.colidx < hi)
        rowptr = np.zeros(g.n_vertices + 1, dtype=EID_DTYPE)
        np.add.at(rowptr, src[m] + 1, 1)
        rowptr = np.cumsum(rowptr)
        segs.append(HostGraph(rowptr=rowptr, colidx=g.colidx[m].copy(),
                              name=f"{g.name}.seg{s}", is_dag=g.is_dag))
    return segs


def _segment_tasks(g: HostGraph, n_segments: int):
    """(the oriented graph's tasks src, dst, [(segment, keep mask)]): a
    task is kept in a segment when both its ends have neighbours there."""
    rg = g if g.is_dag else \
        g.relabel_by_degree(descending=False).orientation()
    src, dst = rg.edge_list()
    out = []
    for seg in csr_segmenting(rg, n_segments):
        sdeg = np.diff(seg.rowptr)
        out.append((seg, (sdeg[src] > 0) & (sdeg[dst] > 0)))
    return src, dst, out


def triangle_count_segmented(g: HostGraph, n_segments: int,
                             chunk: int = 2048, device="cuda") -> int:
    """csr_segmenting consumer: exact TC one COLUMN SEGMENT at a time —
    the cache-blocking / out-of-core access pattern of the reference
    (graph_partition.h:44-48, citing Zhang et al. 2017). Column segments
    partition the id space, so |N+(u) ∩ N+(v)| = Σ_s |N+_s(u) ∩ N+_s(v)|
    exactly; the task list comes from the FULL oriented DAG while only one
    segment's adjacency is resident per pass. A (task, segment) pair counts
    only when both ends have neighbours in the segment's column range,
    which on power-law DAGs drops most pairs. Each segment is counted by
    the frontier engine on `device`."""
    from ..core.plan import TRIANGLE
    from ..engine.frontier import count_pattern
    src, dst, segs = _segment_tasks(g, n_segments)
    total = 0
    for seg, keep in segs:
        if keep.any():
            total += count_pattern(seg, TRIANGLE, chunk=chunk,
                                   tasks=(src[keep], dst[keep]),
                                   device=device)
    return total


def segment_task_counts(g: HostGraph, n_segments: int):
    """(pruned_tasks_per_segment, E) — the work model behind the pruning
    above; Σ pruned << n_segments · E is the measurable benefit."""
    src, _, segs = _segment_tasks(g, n_segments)
    return [int(keep.sum()) for _, keep in segs], int(src.shape[0])
