"""Graph keyword search (GKS).

The counterpart of graphminer_tpu/workloads/keyword.py. Parity:
src/keyword/ in the reference — count connected k-vertex subgraphs that
contain exactly one vertex of each keyword label, where every non-keyword
vertex is necessary for connectivity (gks.h, omp_base.cc
is_match/filter/extend_vertex). The reference enumerates with a per-thread
canonicality test; here subgraphs are canonical by construction (sorted
vertex tuples, level-wise dedup) over a BFS frontier.

The frontier lives on `device` as an int64 tensor [n, size]: each level
expands every member's CSR row by repeat_interleave, drops neighbours that
are already members, sorts each row, dedups rows by torch.unique(dim=0) and
keeps the rows with at most one vertex of each keyword label. The final
necessity test, a Python loop over embeddings in the JAX package, runs
vectorised on the device too: each embedding's k x k induced adjacency
comes from membership probes (a binary search of the pair's key in the
sorted edge keys u·V + w), and for every non-keyword position the other
k − 1 vertices are tested for connectivity by k − 2 rounds of boolean
reachability over [n, k, k]. Exact for every k; cheap for the small k that
GKS takes. A level syncs with the host for the sizes of what it makes
(the expansion, the kept rows, the unique rows). Nothing here launches a
kernel of ours.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


def _kw_counts_ok(labs: torch.Tensor, kw: torch.Tensor,
                  final: bool) -> torch.Tensor:
    """[n] bool: ≤ 1 (== 1 when final) vertex of each keyword label."""
    c = (labs[:, :, None] == kw[None, None, :]).sum(dim=1)
    return ((c == 1) if final else (c <= 1)).all(dim=1)


def _induced_adjacency(emb: torch.Tensor, keys: torch.Tensor,
                       n_vertices: int) -> torch.Tensor:
    """[n, k, k] bool: A[e, i, j] = (emb[e, i], emb[e, j]) is an edge,
    by a binary search of the pair's key in the sorted edge keys."""
    q = emb[:, :, None] * n_vertices + emb[:, None, :]
    pos = torch.searchsorted(keys, q.reshape(-1)).clamp(max=keys.numel() - 1)
    return (keys[pos] == q.reshape(-1)).view(q.shape)


def _connected_without(adj: torch.Tensor) -> torch.Tensor:
    """[n, k] bool: is the induced subgraph minus position i connected?
    adj: [n, k, k] bool. Reachability from the first kept position by
    k − 2 rounds (the k − 1 kept vertices are connected iff every one is
    reached within k − 2 hops)."""
    n, k, _ = adj.shape
    eye = torch.eye(k, dtype=torch.bool, device=adj.device)
    keep = ~eye                                   # [k(skip), k]
    start = torch.where(torch.arange(k, device=adj.device) == 0, 1, 0)
    reach = eye[start][None].expand(n, k, k).clone()  # [n, skip, k]
    sub = adj[:, None, :, :] & keep[None, :, :, None] & keep[None, :, None, :]
    for _ in range(k - 2):
        reach = reach | (reach[:, :, :, None] & sub).any(dim=2)
    return (reach | ~keep[None]).all(dim=2)


def gks_count(g, k: int, keywords: Sequence[int],
              device: DeviceLike = "cuda") -> int:
    """Count connected k-vertex subgraphs with exactly one vertex per keyword
    label and no removable (non-cut) non-keyword vertices."""
    assert g.vlabels is not None, "keyword search needs vertex labels"
    assert k >= 2 and len(keywords) <= k
    dev = resolve_device(device)
    kw_h = sorted(set(int(x) for x in keywords))
    put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    vl = put(g.vlabels.astype(np.int64))
    rp = put(g.rowptr.astype(np.int64))
    col = put(g.colidx.astype(np.int64))
    kw = torch.tensor(kw_h, dtype=torch.int64, device=dev)

    # frontier: sorted vertex tuples (canonical), seeded at keyword vertices
    frontier = torch.nonzero(torch.isin(vl, kw))

    for _ in range(k - 1):
        n, s = frontier.shape
        if n == 0:
            return 0
        # CSR expansion: every member's neighbours in one flat pass (the
        # extend_alloc → insert shape)
        flat = frontier.reshape(-1)
        start = rp[flat]
        d = rp[flat + 1] - start
        cs = torch.cumsum(d, 0)
        tot = int(cs[-1])
        if tot == 0:
            return 0
        parent = torch.repeat_interleave(
            torch.arange(flat.numel(), device=dev) // s, d, output_size=tot)
        offs = torch.arange(tot, device=dev) - torch.repeat_interleave(
            cs - d, d, output_size=tot)
        cand = col[torch.repeat_interleave(start, d, output_size=tot) + offs]
        rows = frontier[parent]
        keep = ~(rows == cand[:, None]).any(dim=1)
        block = torch.cat([rows, cand[:, None]], dim=1)[keep]
        block = torch.unique(block.sort(dim=1).values, dim=0)
        frontier = block[_kw_counts_ok(vl[block], kw, final=False)]

    final = frontier[_kw_counts_ok(vl[frontier], kw, final=True)]
    if final.shape[0] == 0:
        return 0
    # non-keyword vertices must each be necessary for connectivity
    src = torch.repeat_interleave(
        torch.arange(g.n_vertices, device=dev), rp[1:] - rp[:-1],
        output_size=col.numel())
    keys = torch.sort(src * g.n_vertices + col).values
    adj = _induced_adjacency(final, keys, g.n_vertices)
    removable = _connected_without(adj) & ~torch.isin(vl[final], kw)
    return int((~removable.any(dim=1)).sum())
