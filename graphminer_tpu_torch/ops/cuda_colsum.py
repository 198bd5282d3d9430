"""Kernel W — bit column sums over CSR rows (csrc/bit_colsum.cu), in two
modes.

Write mode, bit_colsum: the column sums over each task's sub-core
neighbours, written out (house's WS, graphminer_tpu/ops/house.py::
_ws_bucket). It replaced the XLA path in graphminer_tpu/ops/rectangle.py::
_case_b (:149-158: gathered, SENTINEL-padded FT rows in width classes,
their int8 bit expansion and a sum over the list axis; torch has no
unpackbits). For task i < n,

    out[i, 32 j + b] = Σ_{x ∈ FT(u_i)} bit b of tab[x, j]

with tab int32 [V, words] read as uint32 (bit 31 is a real bit) and FT the
lists of ops/cuda_tri.FtLists, read in place as the prefixes of the sorted
CSR rows. An id outside [0, V) adds 0; a u_i outside [0, V) gives a zero
row. out is int32 [n, 32 words].

Pairs mode, colsum_pairs and colsum_finish: the rectangle engine's level 0
(cases A and B, graphminer_tpu/ops/rectangle.py::_case_a and ::_case_b) as
one int64 scalar, with no [n, cpad] array and no matrix product. With the
core ids [cs, cs + c) and T'[x] = tab[x] with the columns <= x - cs cleared
when x is core,

    w_u[col] = Σ_{x ∈ N(u)} bit col of T'[x]          (u's whole CSR row)
    total    = Σ_u Σ_{col < c, and col > u - cs when u is core} C(w_u[col], 2)

over the rows of a PairsPlan (plan_pairs): every task row with at least two
slots (w <= deg), as segments of at most `cut` slots, heaviest first. The
pairs launch sums the rows that are one segment and adds the column counts
of each split row's segments into an int32 scratch [n_long, 32 words]; the
finish launch applies the masks and the sum to those rows. pairs_count runs
both (the finish only when the plan splits a row).

Each call with work is one launch, counted on the wrapper's .launches
(bit_colsum, colsum_pairs, colsum_finish); a call with none launches
nothing. On a CUDA tensor a wrapper launches its kernel or raises; it takes
its plain version only for CPU tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..types import round_up
from . import _build
from ._tensors import GRID_CAP, PLAIN_ELEMS, on_cuda
from .cuda_tri import FtLists

#: slots of one pairs-mode segment: a longer row is split, and its
#: segments' counts are finished by colsum_finish
SEG_CUT = 1024
#: a column count must fit the kernel's 16 bit planes
MAX_SEG = (1 << 16) - 1


def _check(tab: torch.Tensor, u: torch.Tensor) -> None:
    if tab.dim() != 2 or u.dim() != 1:
        raise ValueError(f"bit_colsum: tab {tuple(tab.shape)} must be 2-D "
                         f"and u {tuple(u.shape)} 1-D")


def bit_colsum(ft: FtLists, tab: torch.Tensor,
               u: torch.Tensor) -> torch.Tensor:
    """Kernel W, write mode: int32 [n, 32 words]; see the module
    docstring."""
    _check(tab, u)
    cuda = ft.check("bit_colsum")
    if on_cuda("bit_colsum", tab, u) != cuda:
        raise ValueError("bit_colsum: tensors on several devices")
    if not cuda:
        return bit_colsum_plain(ft, tab, u)
    n, words = u.shape[0], tab.shape[1]
    out = torch.empty((n, 32 * words), dtype=torch.int32, device=tab.device)
    if n == 0 or words == 0:
        return out
    _build.check_launch(_build.entry("gm_bit_colsum")(
        ft.rowptr.data_ptr(), ft.colidx.data_ptr(), ft.ftw.data_ptr(),
        tab.data_ptr(), tab.shape[0], words, u.data_ptr(), n, out.data_ptr(),
        min(n, GRID_CAP), min(256, round_up(words, 32)),
        _build.stream(tab.device)), "bit_colsum")
    bit_colsum.launches += 1
    return out


bit_colsum.launches = 0


def _expand(rows: torch.Tensor) -> torch.Tensor:
    """int32 [n, 32 words] 0/1 bits of int32 rows [n, words] (bit b of a
    word whatever its sign)."""
    shifts = torch.arange(32, dtype=torch.int32, device=rows.device)
    return ((rows[:, :, None] >> shifts) & 1).reshape(rows.shape[0], -1)


def bit_colsum_plain(ft: FtLists, tab: torch.Tensor,
                     u: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of bit_colsum (any device): every list slot's
    row, shifted and & 1, added into its task's row (index_add_), in slot
    chunks."""
    _check(tab, u)
    v, words = tab.shape
    out = torch.zeros((u.shape[0], 32 * words), dtype=torch.int32,
                      device=tab.device)
    task, x = ft.slots(u)
    ok = (x >= 0) & (x < v)
    step = max(1, PLAIN_ELEMS // max(32 * words, 1))
    for a in range(0, task.shape[0], step):
        k = ok[a:a + step]
        rows = tab[torch.where(k, x[a:a + step], 0)] * k[:, None]
        out.index_add_(0, task[a:a + step], _expand(rows))
    return out


@dataclasses.dataclass(frozen=True)
class PairsPlan:
    """The pairs mode's work over one CSR (rowptr int64 [V + 1], colidx
    int32 [nnz]) and core split (cs, c): `items` int32 [n, 4] (u, first
    slot of the segment in u's row, slots, split-row index or -1), slots
    descending; `long_u` int32 [n_long], the rows cut into several
    segments of at most `cut` slots."""
    rowptr: torch.Tensor
    colidx: torch.Tensor
    cs: int
    c: int
    cut: int
    items: torch.Tensor
    long_u: torch.Tensor

    @property
    def n_vertices(self) -> int:
        return self.rowptr.shape[0] - 1

    def slots(self, a: int = 0, b: int = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every list slot of items[a:b], flat: (item - a int64, id int64),
        in item order and, within an item, in row order."""
        it = self.items[a:b].long()
        dev = it.device
        seg = torch.repeat_interleave(torch.arange(it.shape[0], device=dev),
                                      it[:, 2])
        first = torch.repeat_interleave(torch.cumsum(it[:, 2], 0) - it[:, 2],
                                        it[:, 2])
        pos = self.rowptr[it[seg, 0]] + it[seg, 1] + \
            torch.arange(seg.shape[0], device=dev) - first
        return seg, self.colidx[pos].long()


def plan_pairs(rowptr: torch.Tensor, colidx: torch.Tensor, u: torch.Tensor,
               cs: int, c: int, cut: int = SEG_CUT) -> PairsPlan:
    """The PairsPlan of the task rows `u` (ids outside [0, V) and rows of
    fewer than two slots dropped), on rowptr's device."""
    if rowptr.dtype != torch.int64 or rowptr.dim() != 1 or \
            colidx.dtype != torch.int32 or u.dim() != 1:
        raise TypeError("plan_pairs: rowptr must be int64 [V + 1], colidx "
                        "int32 and u 1-D")
    if not 1 <= cut <= MAX_SEG or cs < 0 or c < 0:
        raise ValueError(f"plan_pairs: cut {cut} must lie in [1, {MAX_SEG}] "
                         f"and cs {cs}, c {c} be >= 0")
    dev = rowptr.device
    v = rowptr.shape[0] - 1
    x = u.to(dev).long()
    x = x[(x >= 0) & (x < v)]
    ln = rowptr[x + 1] - rowptr[x]
    x, ln = x[ln >= 2], ln[ln >= 2]
    nseg = (ln + cut - 1) // cut
    split = nseg > 1
    lidx = torch.full_like(x, -1)
    lidx[split] = torch.arange(int(split.sum()), device=dev)
    row = torch.repeat_interleave(torch.arange(x.shape[0], device=dev), nseg)
    first = torch.repeat_interleave(torch.cumsum(nseg, 0) - nseg, nseg)
    off = (torch.arange(row.shape[0], device=dev) - first) * cut
    slots = torch.clamp(ln[row] - off, max=cut)
    order = torch.sort(slots, descending=True, stable=True).indices
    items = torch.stack([x[row], off, slots, lidx[row]], 1)[order]
    return PairsPlan(rowptr=rowptr, colidx=colidx, cs=int(cs), c=int(c),
                     cut=int(cut), items=items.to(torch.int32).contiguous(),
                     long_u=x[split].to(torch.int32))


def _check_pairs(name: str, plan: PairsPlan, tab: torch.Tensor) -> bool:
    """on_cuda over the plan and the table; True on CUDA."""
    cuda = on_cuda(name, tab, plan.colidx, plan.items, plan.long_u)
    if plan.rowptr.device != tab.device or plan.rowptr.dtype != torch.int64:
        raise ValueError(f"{name}: rowptr must be int64 on {tab.device}")
    if tab.dim() != 2 or tab.shape[0] != plan.n_vertices:
        raise ValueError(f"{name}: tab {tuple(tab.shape)} must have one row "
                         f"a vertex ({plan.n_vertices})")
    if plan.c > 32 * tab.shape[1]:
        raise ValueError(f"{name}: c {plan.c} exceeds the table's "
                         f"{32 * tab.shape[1]} columns")
    if cuda and (tab.shape[1] % 2 or tab.data_ptr() % 8):
        raise ValueError(f"{name} reads 8-byte chunks: words="
                         f"{tab.shape[1]} must be even and the table "
                         "aligned")
    if cuda and not plan.rowptr.is_contiguous():
        raise ValueError(f"{name}: kernel needs a contiguous rowptr")
    return cuda


def _lanes_log2(words: int) -> int:
    """log2 of the lanes of a segment: one lane 2 words, a power of two up
    to the block."""
    return min(8, max(0, (max(1, words // 2) - 1).bit_length()))


def colsum_pairs(plan: PairsPlan, tab: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel W, pairs mode: (total int64 [1], the masked Σ C(w, 2) over the
    plan's unsplit rows; counts int32 [n_long, 32 words], the column counts
    of its split rows). One launch."""
    cuda = _check_pairs("colsum_pairs", plan, tab)
    if not cuda:
        return colsum_pairs_plain(plan, tab)
    dev, words = tab.device, tab.shape[1]
    total = torch.zeros(1, dtype=torch.int64, device=dev)
    counts = torch.zeros((plan.long_u.shape[0], 32 * words),
                         dtype=torch.int32, device=dev)
    n = plan.items.shape[0]
    if n == 0 or words == 0:
        return total, counts
    lg = _lanes_log2(words)
    wave = _build.wave_blocks("gm_colsum_pairs_blocks", dev.index)
    nb = max(1, min(wave, -(-(n << lg) // 256)))
    _build.check_launch(_build.entry("gm_colsum_pairs")(
        plan.rowptr.data_ptr(), plan.colidx.data_ptr(), tab.data_ptr(),
        tab.shape[0], words, plan.cs, plan.c, plan.items.data_ptr(), n, lg,
        counts.data_ptr(), total.data_ptr(), nb, _build.stream(dev)),
        "colsum_pairs")
    colsum_pairs.launches += 1
    return total, counts


colsum_pairs.launches = 0


def colsum_finish(plan: PairsPlan, counts: torch.Tensor,
                  total: torch.Tensor) -> torch.Tensor:
    """Kernel W's finish: adds the masked Σ C(w, 2) over the split rows'
    counts (int32 [n_long, 32 words]) to total (int64 [1], in place on the
    card) and returns it. One launch."""
    n_long = plan.long_u.shape[0]
    if counts.dim() != 2 or counts.shape[0] != n_long or \
            counts.shape[1] % 32 or total.shape != (1,) or \
            total.dtype != torch.int64:
        raise ValueError(f"colsum_finish: counts {tuple(counts.shape)} must "
                         f"be [{n_long}, 32 words] and total int64 [1]")
    cuda = on_cuda("colsum_finish", counts, plan.long_u)
    if total.device != counts.device:
        raise ValueError("colsum_finish: tensors on several devices")
    if not cuda:
        return colsum_finish_plain(plan, counts, total)
    if n_long == 0:
        return total
    _build.check_launch(_build.entry("gm_colsum_finish")(
        counts.data_ptr(), plan.long_u.data_ptr(), n_long,
        counts.shape[1] // 32, plan.cs, plan.c, total.data_ptr(),
        min(n_long, GRID_CAP), _build.stream(counts.device)),
        "colsum_finish")
    colsum_finish.launches += 1
    return total


colsum_finish.launches = 0


def pairs_count(plan: PairsPlan, tab: torch.Tensor) -> int:
    """The plan's masked Σ C(w, 2): colsum_pairs, then colsum_finish when
    the plan splits a row (plain versions on CPU tensors); only the scalar
    comes back."""
    total, counts = colsum_pairs(plan, tab)
    if plan.long_u.shape[0]:
        total = colsum_finish(plan, counts, total)
    return int(total[0])


def _masked_pairs(w: torch.Tensor, u: torch.Tensor, cs: int,
                  c: int) -> torch.Tensor:
    """int64 [1] Σ C(w, 2) over the columns col < c, and col > u - cs for a
    core u, of each row of w (int32 [n, cpad]) and its vertex u [n]."""
    col = torch.arange(w.shape[1], device=w.device)
    lo = torch.where(u >= cs, u - cs, -1)
    keep = (col < c) & (col[None, :] > lo[:, None])
    w = w.to(torch.int64) * keep
    return ((w * (w - 1)).sum() // 2).reshape(1)


def _item_steps(slots: np.ndarray, budget: int):
    """Item ranges [a, b) of at most `budget` items and about `budget`
    slots each (at least one item)."""
    cum = np.cumsum(slots)
    a = 0
    while a < slots.size:
        done = cum[a - 1] if a else 0
        b = int(np.searchsorted(cum, done + budget, side="right"))
        b = min(max(b, a + 1), a + budget)
        yield a, b
        a = b


def colsum_pairs_plain(plan: PairsPlan, tab: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of colsum_pairs (any device), from the same
    plan: each slot's row of T' expanded to bits (int32), added into its
    segment's column counts (index_add_), the unsplit rows' masked
    Σ C(w, 2) summed in int64 and the split rows' counts added into their
    scratch rows, in item ranges of about PLAIN_ELEMS / cpad slots."""
    _check_pairs("colsum_pairs", plan, tab)
    v, words = tab.shape
    cpad = 32 * words
    dev = tab.device
    total = torch.zeros(1, dtype=torch.int64, device=dev)
    counts = torch.zeros((plan.long_u.shape[0], cpad), dtype=torch.int32,
                         device=dev)
    items = plan.items.long()
    col = torch.arange(cpad, device=dev)
    budget = max(1, PLAIN_ELEMS // max(cpad, 1))
    for a, b in _item_steps(items[:, 2].cpu().numpy(), budget):
        it = items[a:b]
        seg, x = plan.slots(a, b)
        ok = (x >= 0) & (x < v)
        bits = _expand(tab[torch.where(ok, x, 0)] * ok[:, None])
        lo = torch.where(x >= plan.cs, x - plan.cs, -1)
        bits *= col[None, :] > lo[:, None]
        w = torch.zeros((b - a, cpad), dtype=torch.int32,
                        device=dev).index_add_(0, seg, bits)
        split = it[:, 3] >= 0
        counts.index_add_(0, it[split, 3], w[split])
        total += _masked_pairs(w[~split], it[~split, 0], plan.cs, plan.c)
    return total, counts


def colsum_finish_plain(plan: PairsPlan, counts: torch.Tensor,
                        total: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of colsum_finish (any device): total plus the
    masked Σ C(w, 2) over the split rows' counts, in int64."""
    return total + _masked_pairs(counts, plan.long_u.long(), plan.cs,
                                 plan.c)
