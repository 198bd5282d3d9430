"""The Graph500 Kronecker generator, frozen for the benchmark.

The rule: 2^scale vertices and edge_factor * 2^scale edge draws; each of an
edge's `scale` bit levels picks its source bit with P(1) = c + d and its
destination bit from the initiator (a, b; c, d) renormalised on the source
bit; the vertex ids are then permuted at random. The edges are symmetrised,
self-loops and duplicates dropped, and handed on as a CSR with every row
sorted (int64 row pointers, int32 column ids), the format a graph is read
from disk in.

Two paths of one rule:
* `kronecker_csr_numpy` draws with numpy's default_rng exactly as
  graphminer_tpu_torch/io/synth.py::rmat does (copied here, not imported),
  so seed 7 gives the repo's golden graphs (rmat14: 2,860,691 triangles);
* `kronecker_csr_torch` draws with a torch.Generator on the given device
  (the card in a run), so a scale-20 graph is made in about a second. Its
  random stream differs from numpy's, so its graphs differ from the
  goldens' with the same seed; each seed still gives one graph.
"""
from __future__ import annotations

import numpy as np
import torch


def _kron_numpy(scale: int, edge_factor: int, a: float, b: float, c: float,
                seed: int):
    """(src, dst) int64 of the edge draws, ids permuted (synth.rmat's
    stream, draw for draw)."""
    n = 1 << scale
    m = edge_factor * n
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab = a + b
    for _ in range(scale):
        r = rng.random(m)
        src_bit = (r >= ab).astype(np.int64)
        r2 = rng.random(m)
        thr = np.where(src_bit == 0, a / ab, c / (1.0 - ab))
        dst_bit = (r2 >= thr).astype(np.int64)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    perm = rng.permutation(n)
    return perm[src], perm[dst]


def csr_from_draws_numpy(src: np.ndarray, dst: np.ndarray, n: int):
    """Symmetric, deduplicated, loop-free CSR (rowptr int64 [n + 1],
    colidx int32, rows sorted) of the draws."""
    keep = src != dst
    src, dst = src[keep].astype(np.int64), dst[keep].astype(np.int64)
    keys = np.unique(np.concatenate([src * n + dst, dst * n + src]))
    rows = keys // n
    rowptr = np.zeros(n + 1, dtype=np.int64)
    rowptr[1:] = np.cumsum(np.bincount(rows, minlength=n))
    return rowptr, (keys % n).astype(np.int32)


def kronecker_csr_numpy(scale: int, edge_factor: int = 16, a: float = 0.57,
                        b: float = 0.19, c: float = 0.19, seed: int = 0):
    src, dst = _kron_numpy(scale, edge_factor, a, b, c, seed)
    return csr_from_draws_numpy(src, dst, 1 << scale)


def kronecker_csr_torch(scale: int, edge_factor: int = 16, a: float = 0.57,
                        b: float = 0.19, c: float = 0.19, seed: int = 0,
                        device="cpu"):
    """The same rule drawn by a torch.Generator on `device`: (rowptr int64
    [n + 1], colidx int32) on that device. float64 draws, as numpy's."""
    dev = torch.device(device)
    n = 1 << scale
    m = edge_factor * n
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    src = torch.zeros(m, dtype=torch.int64, device=dev)
    dst = torch.zeros(m, dtype=torch.int64, device=dev)
    ab = a + b
    thr0, thr1 = a / ab, c / (1.0 - ab)
    for _ in range(scale):
        r = torch.rand(m, generator=gen, dtype=torch.float64, device=dev)
        src_bit = r >= ab
        r2 = torch.rand(m, generator=gen, dtype=torch.float64, device=dev)
        thr = torch.where(src_bit, thr1, thr0)
        src = (src << 1) | src_bit.to(torch.int64)
        dst = (dst << 1) | (r2 >= thr).to(torch.int64)
        del r, r2, thr, src_bit
    perm = torch.randperm(n, generator=gen, device=dev)
    src, dst = perm[src], perm[dst]
    keep = src != dst
    src, dst = src[keep], dst[keep]
    keys = torch.unique(torch.cat([src * n + dst, dst * n + src]))
    del src, dst, keep
    rowptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    rowptr[1:] = torch.cumsum(torch.bincount(keys // n, minlength=n), 0)
    return rowptr, (keys % n).to(torch.int32)


def kronecker_csr(graph: dict, seed: int, device) -> tuple:
    """The CSR of a configuration's `graph` block (generator "graph500")
    for `seed`: the torch path on `device`, or the numpy path when the
    block says "path": "numpy" (then as numpy arrays)."""
    if graph.get("generator") != "graph500":
        raise ValueError(f"unknown generator {graph.get('generator')!r}")
    args = dict(scale=int(graph["scale"]),
                edge_factor=int(graph["edge_factor"]), a=float(graph["a"]),
                b=float(graph["b"]), c=float(graph["c"]), seed=int(seed))
    if graph.get("path") == "numpy":
        return kronecker_csr_numpy(**args)
    return kronecker_csr_torch(**args, device=device)
