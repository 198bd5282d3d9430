"""The slab forms: kernel X + torch._int_mm, kept as yardsticks.

The clique engine's hi part: the form that kernel G (ops/cuda_gram.py)
replaced on CliqueKEngine's hi part, kept as G's yardstick: chip_smoke.py
and scripts/prof_breakdown.py --clique time it beside G and hold it to G's
totals. No engine calls it on a count, and building an engine pays for
none of it: CliqueSlab expands B_hh and makes its CUDA streams when they
are first used.

Kernel X (ops/cuda_expand.py) expands the hi tasks in slabs of at most
SLAB_BYTES, transposed (Yᵀ, int8 [hi, slab]), and each slab adds
torch._int_mm(Yᵀ, Y) to an int32 Gram (exact: an entry counts tasks,
fewer than 2^31, which the engine checks), masked by B_hh expanded by X
(hi_adj). Reassociated from the JAX package's per-task bilinear
(graphminer_tpu/ops/cliquek.py::_edge_hi_bilinear, ::_tri_stream_bilinear),
both integer sums are equal.

The rectangle engine's level 0 (rectangle_level0_slab): the product form
that kernel W's pairs mode (ops/cuda_colsum.py) replaced, kept as its
yardstick; chip_smoke.py times it in turns with the pairs mode and the CPU
tests hold the two equal. Case A is the Gram of the sub rows (tri_support.
gram_rows) plus Accᵀ M, M = Acc ⊙ 1[x < v], by one torch._int_mm of X's
expansions; case B takes CHUNK_U sub-core u a step: X's gathered rows times
M by torch._int_mm, plus W's write mode (the FT-prefix column sums) on a
step with a sub neighbour; each Σ C(w, 2) in int64 on the device.

The house engine's core-mid 3-walk share (house_t3_slab): the JAX form
(graphminer_tpu/ops/house.py::_t3_edges) that kernel H (ops/cuda_house.py)
replaced, kept as H's yardstick for chip_smoke.py: per DAG edge the
bilinear xuᵀ·Acc·xv (X's expansions and torch._int_mm) and the dots
⟨xu, WS[v]⟩ + ⟨xv, WS[u]⟩ with the WS rows by W's write mode, CHUNK_E
edges a step, in int64 sums. It equals H's two calls added per edge.
"""
from __future__ import annotations

import itertools

import torch

from ..types import round_up
from .cuda_colsum import bit_colsum
from .cuda_expand import expand_bits

#: most bytes of one X-expanded slab (int8 [hi, slab tasks])
SLAB_BYTES = 1 << 30
#: sub-core u a case-B step of the rectangle yardstick
CHUNK_U = 4096
#: DAG edges a step of the house yardstick
CHUNK_E = 8192
#: CUDA streams the slabs take turns on by default; 2 beat 1 and 4 on the
#: H100 (PERF.md; scripts/prof_breakdown.py --clique times 1, 2 and 4)
HI_STREAMS = 2


def hi_adj(eng) -> torch.Tensor:
    """B_hh int8 [hi_dim, hi_dim] of a CliqueKEngine: the DAG adjacency
    among the hi-region core ids, X's expansion of eng.hi_mask (one X
    launch, read in place); rows past the core are X's zero padding."""
    return expand_bits(eng.hi_mask, n_out=eng.hi_dim)


def slab_gram(slabs, hi_dim: int, device: torch.device,
              streams=()) -> torch.Tensor:
    """int32 [hi_dim, hi_dim] Σ over `slabs` (an iterator of X's
    transposed expansions, int8 [hi_dim, n]) of torch._int_mm(yt, yt.t()).
    With CUDA `streams`, the slabs take turns on them, each stream adding
    into its own Gram, so that one slab's product overlaps the next slab's
    expansion and product: one product at hi_dim <= 1024 has few output
    tiles for the card's SMs. Without, one Gram on the current stream."""
    if not streams:
        g = torch.zeros((hi_dim, hi_dim), dtype=torch.int32, device=device)
        for yt in slabs:
            g += torch._int_mm(yt, yt.t())
        return g
    main = torch.cuda.current_stream(device)
    grams = []
    for st in streams:
        st.wait_stream(main)
        with torch.cuda.stream(st):
            grams.append(torch.zeros((hi_dim, hi_dim), dtype=torch.int32,
                                     device=device))
    for i in itertools.count():
        st = streams[i % len(streams)]
        with torch.cuda.stream(st):
            yt = next(slabs, None)
            if yt is None:
                break
            grams[i % len(streams)] += torch._int_mm(yt, yt.t())
    for st, g in zip(streams, grams):
        main.wait_stream(st)
        g.record_stream(main)
    return torch.stack(grams).sum(dim=0, dtype=torch.int32)


class CliqueSlab:
    """The slab form over a built CliqueKEngine `eng`; slab = 0 takes
    SLAB_BYTES // hi tasks a slab, and any slab is rounded up to a multiple
    of 32 tasks."""

    def __init__(self, eng, slab: int = 0):
        self.eng = eng
        self.slab = round_up(slab or SLAB_BYTES // eng.hi_dim, 32)
        self._bhh = None
        #: side streams by count, made once: the caching allocator keeps
        #: blocks a stream, so new streams each call would cache a slab each
        self._streams = {}

    @property
    def bhh(self) -> torch.Tensor:
        """hi_adj(eng), made on first use."""
        if self._bhh is None:
            self._bhh = hi_adj(self.eng)
        return self._bhh

    def streams(self, n: int = HI_STREAMS) -> list:
        """n CUDA streams of the engine's device, made once; none on the CPU
        or for n = 1 (the current stream)."""
        if self.eng.device.type != "cuda" or n < 2:
            return []
        if n not in self._streams:
            self._streams[n] = [torch.cuda.Stream(self.eng.device)
                                for _ in range(n)]
        return self._streams[n]

    def slab_args(self):
        """(base, keyword arguments) of X's call for each slab of hi tasks:
        its transposed expansion is int8 [hi_dim, n_out], n_out the slab's
        tasks rounded up to 32."""
        eng = self.eng
        if eng.k == 4:
            for s in range(0, eng.y2hi.shape[0], self.slab):
                rows = eng.y2hi[s:s + self.slab]
                yield rows, dict(n_out=round_up(rows.shape[0], 32),
                                 transpose=True)
            return
        base, kw = eng.hi_args()
        for s in range(0, eng.n_tri, self.slab):
            r = kw["r"][s:s + self.slab]
            yield base, dict(r=r, tab=kw["tab"],
                             cols=kw["cols"][s:s + self.slab],
                             n_out=round_up(r.shape[0], 32), transpose=True)

    def slabs(self, calls=None):
        """X's expansion of each of `calls` (default: slab_args()), launched
        on the current stream as the generator advances."""
        for base, kw in (self.slab_args() if calls is None else calls):
            yield expand_bits(base, **kw)

    @property
    def slab_tasks(self) -> list:
        """The expanded rows (n_out) of each X launch; its length is the
        number of slabs."""
        return [kw["n_out"] for _, kw in self.slab_args()]

    @property
    def n_slabs(self) -> int:
        """X launches of the hi part."""
        return len(self.slab_tasks)

    def gram(self, n_streams: int = HI_STREAMS, calls=None) -> torch.Tensor:
        """int32 [hi_dim, hi_dim] Σ_t y_t y_tᵀ over the expanded rows of
        `calls` (default: the engine's hi tasks), slab_gram over n_streams
        streams."""
        return slab_gram(self.slabs(calls), self.eng.hi_dim,
                         self.eng.device, self.streams(n_streams))

    def hi_partials(self, n_streams: int = HI_STREAMS,
                    calls=None) -> torch.Tensor:
        """int64 [hi_dim] the engine's hi_partials by the slab form."""
        return (self.gram(n_streams, calls).to(torch.int64)
                * self.bhh).sum(dim=1)


def _case_a(gs, xt: torch.Tensor, m: torch.Tensor, c: int) -> int:
    """Σ_{u<v<c} C(Gs[u, v] + Wbᵀ[u, v], 2), Wbᵀ = Accᵀ M (xt = Accᵀ)."""
    from .tri_support import pairs_sum
    w = torch._int_mm(xt, m)
    if gs is not None:
        w += gs
    return pairs_sum(torch.triu(w[:c, :c], diagonal=1))


def _case_b(table: torch.Tensor, ft, m: torch.Tensor, cs: int, c: int,
            chunk: int) -> int:
    """Σ_{u sub} Σ_{v<c} C(wcb_u[v] + wsub_u[v], 2), `chunk` u a step; W's
    write mode once a step that has any sub neighbour."""
    from .tri_support import pairs_sum
    dev = table.device
    total = 0
    for s in range(0, cs, chunk):
        e = min(cs, s + chunk)
        u = torch.arange(s, e, dtype=torch.int32, device=dev)
        w = torch._int_mm(expand_bits(table, r=u, n_out=round_up(e - s, 32)),
                          m)[:e - s, :c]
        if bool(ft.ftw[s:e].any()):
            w = w + bit_colsum(ft, table, u)[:, :c]
        total += pairs_sum(w)
    return total


def rectangle_level0_slab(table: torch.Tensor, ft, cs: int, c: int, keep,
                          chunk: int = CHUNK_U) -> int:
    """Cases A and B of the rectangle engine by the product form, on
    table's device: table the full-core bitmaps int32 [V, words] of the
    relabeled graph with the core [cs, cs + c), ft its FtLists (ftw = the
    sub-core neighbours), keep the sub rows with at least two core
    neighbours (numpy ids)."""
    from .tri_support import gram_rows
    words = table.shape[1]
    cpad = 32 * words
    acc = table[cs:]                                  # core rows
    # Accᵀ and M = Acc ⊙ 1[x < v], both [cpad, cpad] (zero rows past c)
    xt = expand_bits(acc, n_out=cpad, transpose=True)
    m = torch.triu(expand_bits(acc, n_out=cpad), diagonal=1)
    gs = gram_rows(table, keep, words) if len(keep) else None
    total = _case_a(gs, xt, m, c)
    del gs, xt
    if cs:
        total += _case_b(table, ft, m, cs, c, chunk)
    return total


def house_t3_slab(table: torch.Tensor, ft, cs: int, src: torch.Tensor,
                  dst: torch.Tensor, chunk: int = CHUNK_E) -> torch.Tensor:
    """int64 [n] xuᵀ·Acc·xv + ⟨xu, WS[v]⟩ + ⟨xv, WS[u]⟩ for the tasks (src,
    dst) (int32, on table's device): table the full-core bitmaps int32
    [V, words] with the core [cs, V), ft its FtLists (ftw = the sub-core
    neighbours: WS[x] = bit_colsum over FT(x)); `chunk` tasks a step."""
    cpad = 32 * table.shape[1]
    acc = expand_bits(table[cs:], n_out=cpad)          # Acc, zero-padded
    out = []
    for s in range(0, src.shape[0], chunk):
        u, v = src[s:s + chunk], dst[s:s + chunk]
        n = u.shape[0]
        xu = expand_bits(table, r=u, n_out=round_up(n, 32))
        xv = expand_bits(table, r=v, n_out=n)
        bil = (torch._int_mm(xu, acc)[:n] * xv).sum(1, dtype=torch.int64)
        xu = xu[:n]
        out.append(bil + (xu * bit_colsum(ft, table, v)).sum(
            1, dtype=torch.int64) + (xv * bit_colsum(ft, table, u)).sum(
            1, dtype=torch.int64))
    return torch.cat(out)
