"""Synthetic graph generators (numpy, vectorized) for tests and benchmarks.

The reference's large datasets (mico/livej/orkut/friendster) are external
downloads; in an air-gapped environment RMAT graphs of matching scale stand in
for them on the perf path, while exact-count conformance uses the bundled
citeseer plus brute-force oracles on small random graphs.
"""
from __future__ import annotations

import numpy as np

from ..core.graph import HostGraph


def rmat(scale: int, edge_factor: int = 16, a: float = 0.57, b: float = 0.19,
         c: float = 0.19, seed: int = 0) -> HostGraph:
    """RMAT power-law graph (Graph500 parameters by default), symmetrized,
    dedup'd, self-loops dropped. n = 2^scale vertices, ~edge_factor*n edges."""
    n = 1 << scale
    m = edge_factor * n
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab, abc = a + b, a + b + c
    for bit in range(scale):
        r = rng.random(m)
        src_bit = (r >= ab).astype(np.int64)
        # conditional on src_bit, pick dst bit with renormalized probs
        r2 = rng.random(m)
        thr = np.where(src_bit == 0, a / ab, c / (1.0 - ab))
        dst_bit = (r2 >= thr).astype(np.int64)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    # permute ids to remove degree-locality artifacts
    perm = rng.permutation(n)
    src, dst = perm[src], perm[dst]
    return HostGraph.from_edges(src.astype(np.int32), dst.astype(np.int32), n,
                                symmetrize=True)


def erdos_renyi(n: int, p: float, seed: int = 0) -> HostGraph:
    rng = np.random.default_rng(seed)
    m = np.triu(rng.random((n, n)) < p, 1)
    src, dst = np.nonzero(m)
    return HostGraph.from_edges(src, dst, n, symmetrize=True)


def labeled_er(n: int, p: float, n_vlabels: int = 4, n_elabels: int = 3,
               seed: int = 0) -> HostGraph:
    """Labeled random graph for FSM/query tests."""
    rng = np.random.default_rng(seed)
    g = erdos_renyi(n, p, seed)
    vl = rng.integers(1, n_vlabels + 1, n).astype(np.uint8)
    # edge labels must agree on both directions (u,v)/(v,u): derive from ids
    deg = np.diff(g.rowptr)
    src = np.repeat(np.arange(n), deg)
    lo = np.minimum(src, g.colidx)
    hi = np.maximum(src, g.colidx)
    el = ((lo * 1009 + hi * 9176) % n_elabels + 1).astype(np.uint16)
    return HostGraph(rowptr=g.rowptr, colidx=g.colidx, vlabels=vl, elabels=el)
