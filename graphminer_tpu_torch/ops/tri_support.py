"""Per-edge triangle support tri(e) = |N(u) ∩ N(v)| over the full
adjacency, and the diamond fast path Σ_e C(tri_e, 2).

The counterpart of graphminer_tpu/ops/tri_support.py. Parity targets:
src/sgl/cpu_kernels/diamond.h:1-14 (y0y1 = N(v0) ∩ N(v1), ordered pairs
within) and the matrix subsystem's diamond MM variant.

Vertices are relabeled ascending by degree; the core is the top `core`
ids [cs, V). Each vertex x has FBc[x], the bitmap of N(x) ∩ core (int32
words, `_pack_full_core_bitmaps`), and FT(x), its sub-core neighbours,
which are the first ftw[x] ids of its sorted CSR row (core ids are the
largest). For a DAG task (u, v), u < v:

    tri(u, v) = popcount(FBc[u] & FBc[v])            T1, kernel S
              + u, v core:     G[u - cs, v - cs]      T4, the Gram
              + u sub, v core: Σ_{x ∈ FT(u)} bit_{v-cs}(FBc[x])   T2, kernel P
              + u, v sub:      |FT(u) ∩ FT(v)|        T3, kernel I

G = Σ_x e(x) e(x)ᵀ over the bit expansions e(x) of the rows FBc[x] of the
sub-core x with at least two core neighbours (fewer touch only G's
diagonal, which no task reads): kernel X (ops/cuda_expand.py) expands them
transposed in slabs and torch._int_mm adds each slab's product into an
int32 [cpad, cpad] Gram (ops/slab_form.py::slab_gram). Its entries count
rows, fewer than 2^31, so int32 is exact. The Gram's entries at the cc
tasks are gathered on the device. tri is int64 on the device, and the
diamond count Σ C(tri, 2) is summed there in int64; only the scalar comes
back.

Kernels S, P and I (ops/cuda_tri.py) each take one launch a tri_support
call; P and I read FT(x) in place as the CSR row prefix.

Left out: `_chunk2d` and the `lax.map` chunking (each kernel takes all its
tasks in one launch), the width-class bucketing of FT lists (`_ft_lists`,
`FT_CLASSES`; P and I read the lists in place, so nothing is gathered or
padded on the host), and the Gram's float32-then-int32 casts (int8
operands, int32 products).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..types import cdiv, round_up
from .cuda_expand import expand_bits
from .cuda_tri import FtLists, tri_bitmap, tri_lists, tri_probe
from .slab_form import slab_gram

CORE = 4096
#: rows of one expanded Gram slab (int8 [cpad, slab], 128 MB at cpad 4096)
GRAM_SLAB = 1 << 15


def _pack_full_core_bitmaps(g, cs: int, words: int) -> np.ndarray:
    """FBc[x] for every vertex: bits of N(x) ∩ [cs, V) (full adjacency),
    uint32 words viewed as int32 (bit 31 makes a word negative)."""
    v = g.n_vertices
    deg = np.diff(g.rowptr).astype(np.int64)
    src = np.repeat(np.arange(v, dtype=np.int64), deg)
    col = g.colidx.astype(np.int64)
    m = col >= cs
    bm = np.zeros((v, words), dtype=np.uint32)
    cc = (col[m] - cs).astype(np.int64)
    np.bitwise_or.at(bm, (src[m], cc >> 5),
                     np.uint32(1) << (cc & 31).astype(np.uint32))
    return bm.view(np.int32)


def core_split(rg, core: int):
    """(c, cs, words) of the relabeled graph rg at `core`: c core ids
    [cs, V), their bitmaps `words` int32 words wide (a multiple of 8)."""
    v = rg.n_vertices
    c = min(core, v)
    return c, v - c, round_up(max(1, cdiv(c, 32)), 8)


def core_neighbours(rg, cs: int):
    """(deg, |N(x) ∩ core|) int64 [V] of every vertex of rg."""
    v = rg.n_vertices
    deg = np.diff(rg.rowptr).astype(np.int64)
    src = np.repeat(np.arange(v, dtype=np.int64), deg)
    core_nb = np.bincount(src[rg.colidx.astype(np.int64) >= cs],
                          minlength=v).astype(np.int64)
    return deg, core_nb


def gram_rows(table: torch.Tensor, keep: np.ndarray, words: int,
              slab: int = GRAM_SLAB) -> torch.Tensor:
    """int32 [cpad, cpad] Σ_{x ∈ keep} e(x) e(x)ᵀ over the bit expansions of
    the rows table[keep] (cpad = 32 words): X's gathered, transposed
    expansion a slab at a time (padded with zero rows to a multiple of 32)
    and torch._int_mm into one Gram on table's device."""
    dev = table.device
    cpad = 32 * words
    slab = round_up(max(slab, 32), 32)
    ids = torch.from_numpy(np.ascontiguousarray(keep, dtype=np.int32)).to(dev)

    def slabs():
        for s in range(0, ids.shape[0], slab):
            r = ids[s:s + slab]
            yield expand_bits(table, r=r, n_out=round_up(r.shape[0], 32),
                              transpose=True)

    return slab_gram(slabs(), cpad, dev)


@dataclasses.dataclass
class TriSupport:
    """Per-DAG-edge triangle support over the degree-relabeled graph."""
    src: np.ndarray        # [E] int64 task src (relabeled ids)
    dst: np.ndarray        # [E] int64 task dst
    tri: torch.Tensor      # [E] int64 |N(u) ∩ N(v)|, on the device
    n_vertices: int


def tri_support(g, core: int = CORE, chunk: int = GRAM_SLAB,
                device: DeviceLike = "cuda") -> TriSupport:
    """tri(e) for every DAG edge of the undirected graph g; `chunk` is the
    rows of one Gram slab."""
    assert not g.is_dag, "tri_support needs the undirected graph"
    dev = resolve_device(device)
    rg = g.relabel_by_degree(descending=False)
    v = rg.n_vertices
    c, cs, words = core_split(rg, core)

    fbc = _pack_full_core_bitmaps(rg, cs, words)
    table = torch.from_numpy(fbc).to(dev)
    src, dst = rg.orientation().edge_list()
    src = src.astype(np.int64)
    dst = dst.astype(np.int64)
    t32 = lambda a: torch.from_numpy(a.astype(np.int32)).to(dev)

    # common CORE neighbours, every task: kernel S
    tri = tri_bitmap(table, t32(src), t32(dst)).to(torch.int64)
    if cs == 0:
        return TriSupport(src=src, dst=dst, tri=tri, n_vertices=v)

    deg, core_nb = core_neighbours(rg, cs)
    cc = src >= cs
    sc = ~cc & (dst >= cs)
    ss = ~cc & (dst < cs)

    # both core: the Gram's entries (rows: sub-core x with >= 2 core nbrs)
    if cc.any():
        keep = np.nonzero((core_nb >= 2) & (np.arange(v) < cs))[0]
        if keep.size:
            gram = gram_rows(table, keep, words, chunk)
            idx = torch.from_numpy(np.nonzero(cc)[0]).to(dev)
            tri.index_add_(0, idx, gram[torch.from_numpy(src[cc] - cs).to(dev),
                                        torch.from_numpy(dst[cc] - cs).to(dev)
                                        ].to(torch.int64))

    # sub-core ends: FT(x), the CSR row prefix, read in place
    ft = FtLists.from_csr(rg.rowptr, rg.colidx, deg - core_nb, dev)
    if sc.any():                          # u sub, v core: kernel P
        out = tri_probe(ft, table, t32(src[sc]), t32(dst[sc] - cs))
        tri.index_add_(0, torch.from_numpy(np.nonzero(sc)[0]).to(dev),
                       out.to(torch.int64))
    if ss.any():                          # u, v sub: kernel I
        out = tri_lists(ft, t32(src[ss]), t32(dst[ss]))
        tri.index_add_(0, torch.from_numpy(np.nonzero(ss)[0]).to(dev),
                       out.to(torch.int64))
    return TriSupport(src=src, dst=dst, tri=tri, n_vertices=v)


def pairs_sum(w: torch.Tensor) -> int:
    """Σ C(w, 2) over the entries of w (w >= 0), summed in int64 on w's
    device; only the scalar comes back."""
    w = w.to(torch.int64)
    return int((w * (w - 1)).sum()) // 2


def diamond_count_fast(g, core: int = CORE, device: DeviceLike = "cuda") -> int:
    """Diamonds = Σ_e C(tri_e, 2) over undirected edges — exact.

    Each diamond is counted once at its unique shared edge (the reference's
    per-edge ordered-pair count, diamond.h:7-11, is the same sum)."""
    return pairs_sum(tri_support(g, core=core, device=device).tri)
