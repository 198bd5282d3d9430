"""Plain exact counters of triangles and 4-cliques (PyTorch, any device).

They take the symmetric CSR the benchmark generated, as (rowptr, colidx)
tensors, and work out everything else themselves:

1. Orientation. Vertices are ranked by (degree, id) and every undirected
   edge is kept once, from its lower-ranked end to its higher-ranked one,
   in rank ids. Every k-clique is then counted exactly once, at its
   lowest-ranked vertex a, as a (k - 1)-clique among N+(a).
2. Wedges. For every vertex a and every pair i < j of positions in its
   sorted out-row, the wedge (a; row[i], row[j]) is closed when the edge
   row[i] -> row[j] is in the sorted edge keys (torch.searchsorted). The
   closed wedges are the triangles. The pairs are made in blocks of at
   most `block_pairs`.
3. 4-cliques. A closed wedge (a; i, j) is the entry M_a[i, j] = 1 of a's
   local DAG on N+(a); the 4-cliques at a are the triangles of M_a,
   sum(M_a ⊙ (M_a @ M_a)). The matrices are batched by their size rounded
   up to a power of two and multiplied in float32 with TF32 off: every
   entry of M_a @ M_a is an integer at most |N+(a)| < 2^24, so the product
   is exact; the sums are taken in int64.

`accumulate` names the type the count is accumulated in: "int64" is the
reference; "float32" (a 24-bit mantissa) is the control that the
benchmark's correctness check must fail.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

#: wedge pairs a block (int64 temporaries of this length, a few of them)
BLOCK_PAIRS = 1 << 25
#: bytes of the float32 batch of local matrices a 4-clique step multiplies
BATCH_BYTES = 1 << 30


def orient(rowptr: torch.Tensor, colidx: torch.Tensor):
    """(rp int64 [n + 1], col int64, keys int64) of the DAG in rank ids:
    rows sorted, keys = src * n + dst ascending."""
    rowptr = rowptr.to(torch.int64)
    n = rowptr.numel() - 1
    dev = rowptr.device
    deg = rowptr[1:] - rowptr[:-1]
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    order = torch.argsort(deg * n + ids)
    rank = torch.empty_like(order)
    rank[order] = ids
    src = torch.repeat_interleave(rank, deg)
    dst = rank[colidx.to(torch.int64)]
    keep = dst > src
    keys, _ = torch.sort(src[keep] * n + dst[keep])
    del src, dst, keep
    rp = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    rp[1:] = torch.cumsum(torch.bincount(keys // n, minlength=n), 0)
    return rp, keys % n, keys


def _wedge_blocks(rp, col, keys, block_pairs: int):
    """Per block of out-row pairs: (a, i, j, closed) — the row, the two
    positions in it (i < j) and whether row[i] -> row[j] is an edge."""
    n = rp.numel() - 1
    dev = rp.device
    e_all = col.numel()
    if e_all == 0:
        return
    d = rp[1:] - rp[:-1]
    src = torch.repeat_interleave(torch.arange(n, device=dev), d)
    pos = torch.arange(e_all, device=dev) - rp[src]
    later = d[src] - 1 - pos                    # pairs whose first is e
    cum = torch.cumsum(later, 0)
    cuts = [0]
    while cuts[-1] < e_all:
        done = int(cum[cuts[-1] - 1]) if cuts[-1] else 0
        nxt = int(torch.searchsorted(cum, done + block_pairs, right=True))
        cuts.append(max(nxt, cuts[-1] + 1) if nxt < e_all else e_all)
    for e0, e1 in zip(cuts[:-1], cuts[1:]):
        cnt = later[e0:e1]
        npairs = int(cnt.sum())
        if npairs == 0:
            continue
        first = torch.repeat_interleave(
            torch.arange(e0, e1, device=dev), cnt)
        start = torch.cumsum(cnt, 0) - cnt
        step = torch.arange(npairs, device=dev) - torch.repeat_interleave(
            start, cnt)
        second = first + 1 + step
        q = col[first] * n + col[second]
        at = torch.searchsorted(keys, q).clamp_(max=keys.numel() - 1)
        closed = keys[at] == q
        yield src[first], pos[first], pos[second], closed


def _accumulate(parts: torch.Tensor, accumulate: str) -> int:
    """Σ parts (int64) in the named type: exactly in int64, or as the
    control does, one part after another in a float32 accumulator (numpy's
    sequential add.accumulate, the same on every device)."""
    if parts.numel() == 0:
        return 0
    if accumulate == "int64":
        return int(parts.sum())
    if accumulate != "float32":
        raise ValueError(f"unknown accumulate {accumulate!r}")
    dt = np.dtype(accumulate)
    return int(np.add.accumulate(parts.cpu().numpy().astype(dt),
                                 dtype=dt)[-1])


def triangles(rowptr, colidx, accumulate: str = "int64",
              block_pairs: int = BLOCK_PAIRS) -> int:
    """Exact triangle count of the symmetric CSR."""
    rp, col, keys = orient(rowptr, colidx)
    per_vertex = torch.zeros(rp.numel() - 1, dtype=torch.int64,
                             device=rp.device)
    for a, _, _, closed in _wedge_blocks(rp, col, keys, block_pairs):
        per_vertex.index_add_(0, a[closed], torch.ones_like(a[closed]))
    return _accumulate(per_vertex, accumulate)


@contextlib.contextmanager
def _exact_float32_matmul():
    """float32 matmuls in full float32 (no TF32) inside, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def clique4(rowptr, colidx, accumulate: str = "int64",
            block_pairs: int = BLOCK_PAIRS,
            batch_bytes: int = BATCH_BYTES) -> int:
    """Exact 4-clique count of the symmetric CSR."""
    rp, col, keys = orient(rowptr, colidx)
    dev = rp.device
    n = rp.numel() - 1
    d = rp[1:] - rp[:-1]
    hits_a, hits_i, hits_j = [], [], []
    for a, i, j, closed in _wedge_blocks(rp, col, keys, block_pairs):
        hits_a.append(a[closed])
        hits_i.append(i[closed])
        hits_j.append(j[closed])
    if not hits_a:
        return 0
    a = torch.cat(hits_a)
    i = torch.cat(hits_i)
    j = torch.cat(hits_j)
    del hits_a, hits_i, hits_j
    # closed wedges grouped by vertex (the blocks run in vertex order)
    per_vertex = torch.zeros(n, dtype=torch.int64, device=dev)
    starts = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    starts[1:] = torch.cumsum(torch.bincount(a, minlength=n), 0)
    size = torch.ones(n, dtype=torch.int64, device=dev)
    has = d >= 3
    size[has] = 1 << torch.ceil(torch.log2(d[has].double())).long()
    with _exact_float32_matmul():
        for p in torch.unique(size[has]).tolist():
            verts = torch.nonzero(has & (size == p)).flatten()
            per_batch = max(1, batch_bytes // (4 * p * p))
            for b0 in range(0, verts.numel(), per_batch):
                vb = verts[b0:b0 + per_batch]
                lo, hi = starts[vb], starts[vb + 1]
                cnt = hi - lo
                m = int(cnt.sum())
                if m == 0:
                    continue
                slot = torch.repeat_interleave(
                    torch.arange(vb.numel(), device=dev), cnt)
                idx = torch.repeat_interleave(lo, cnt) + (
                    torch.arange(m, device=dev)
                    - torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt,
                                              cnt))
                mat = torch.zeros(vb.numel(), p, p, dtype=torch.float32,
                                  device=dev)
                mat[slot, i[idx], j[idx]] = 1.0
                two = torch.bmm(mat, mat)
                per_vertex[vb] = (two * mat).sum(dim=(1, 2),
                                                 dtype=torch.float64).long()
                del mat, two
    return _accumulate(per_vertex, accumulate)


#: the configurations' "pattern" → its counter
COUNTERS = {"triangle": triangles, "clique4": clique4}


def count(pattern: str, rowptr, colidx, accumulate: str = "int64") -> int:
    """The exact count of `pattern` in the symmetric CSR (tensors on the
    device the count runs on)."""
    try:
        counter = COUNTERS[pattern]
    except KeyError:
        raise ValueError(f"no reference counter for pattern {pattern!r}")
    return counter(rowptr, colidx, accumulate=accumulate)
