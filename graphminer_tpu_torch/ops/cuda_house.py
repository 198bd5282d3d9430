"""Kernel H — per-edge 3-walk support over per-list column counts
(csrc/house_t3.cu), for the fast house engine (ops/house.py).

It replaces both XLA passes of graphminer_tpu/ops/house.py: H1 `_ws_bucket`
(:50, a WS table [V, cpad] int16 of per-vertex sub-core column sums) and H2
`_t3_edges` (:65, per DAG edge the bilinear xuᵀ·Acc·xv plus ⟨xu, WS[v]⟩ +
⟨xv, WS[u]⟩); torch has no popcount or unpackbits. For task t < n,

    out[t] = Σ_{x ∈ L(a_t)} popcount(tab[x] & tab[b_t])
           = Σ_{c : bit c of tab[b_t]} C_a[c],   C_a[c] = Σ_{x ∈ L(a_t)} bit c of tab[x]

with tab int32 [V, words] read as uint32 (bit 31 is a real bit) and L(x)
the lists of an ops/cuda_tri.FtLists (the first min(ftw[x], deg x) ids of
CSR row x: ftw = deg gives the whole row, the sub-core counts FT). An id
outside [0, V) adds 0, as a or b or in a list. out is int32 [n]; the
wrapper refuses a call whose longest list times 32 words could pass
2^31 - 1.

plan_house cuts the tasks, on their device by torch ops, into pieces of
consecutive tasks of one run of equal a, heaviest first. A list whose rows
hold at most LIST_SPARSE set bits on average is block items: a piece of at
most BLOCK_PIECE tasks with its whole list, whose C_a a block holds as
int32 counts in shared memory, built by its eight warps, dotting each task
once with no popcount. With the sparse view (HouseView: the set bits of
tab[x] are the last nbc[x] ids of CSR row x less cs, as in the house
engine's core bitmaps, whose row x is x's core neighbours) a block item
walks every list row and task over its ids; without it, over the set bits
of its table row. A list of denser rows is warp items: the first design,
pieces of at most PIECE tasks and segments of at most WARP_SEG slots, one
warp building the counts in planes of registers and dotting each task
against them by popcounts. Any task order gives the same result; runs of
equal a are the fast case.

house_calls (ops/house.py) builds both calls' plans before it launches
either; without a plan the wrapper builds one. Each call with an item is
one launch, counted on house_t3.launches; a call with none launches
nothing. On a CUDA tensor the wrapper launches its kernel or raises; it
takes its plain version only for CPU tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import _build
from ._tensors import BLOCK, GRID_CAP, PLAIN_ELEMS, on_cuda, popcount32
from .cuda_colsum import _expand, bit_colsum_plain
from .cuda_tri import FtLists, _check_ids, _check_tab, _starts

#: most consecutive tasks of one run in a block item (256 a warp)
BLOCK_PIECE = 2048
#: most consecutive tasks of one run in a warp item
PIECE = 1024
#: a list whose rows hold at most this many set bits on average is a block
#: item; a denser one is warp items, cut into segments of at most WARP_SEG
#: slots (csrc/house_t3.cu: a warp item's counts stay within 11 planes)
LIST_SPARSE = 128
WARP_SEG = (1 << 11) - 1
#: warps of a block (a block item's warps; the warp items of one unit)
WARPS = BLOCK // 32


@dataclasses.dataclass
class HouseView:
    """The sparse view of a table: the set bits of tab[x] are the last
    nbc[x] ids of CSR row x less cs (rows sorted ascending, no repeated id):
    the house engine's full-core bitmaps, whose row x is x's core
    neighbours. nbc int32 [V] on the table's device."""
    nbc: torch.Tensor
    cs: int


@dataclasses.dataclass
class HousePlan:
    """Kernel H's items for one call: int32 [m, 4] (first task, tasks,
    first slot of the segment in L(a), slots) on the call's device, the
    n_block block items first; the call's task count and its longest
    list (the int32 guard)."""
    items: torch.Tensor
    n_block: int
    n_tasks: int
    longest: int


def plan_house(ft: FtLists, tab: torch.Tensor, a: torch.Tensor,
               view: Optional[HouseView] = None,
               block_piece: int = BLOCK_PIECE, piece: int = PIECE,
               sparse: int = LIST_SPARSE,
               warp_seg: int = WARP_SEG) -> HousePlan:
    """Kernel H's plan for the tasks whose list owners are `a`, built on
    a's device by torch ops with two host syncs (the runs of equal a; the
    items', the block items' and the longest list's counts together). A
    run's list whose rows hold at most `sparse` set bits on average (the
    view's nbc, else popcounts of tab, summed over the list by prefix sums
    over the CSR slots) gives block items, pieces of at most `block_piece`
    consecutive tasks, each with the whole list; a denser one warp items,
    pieces of at most `piece` tasks and segments of at most `warp_seg`
    slots. Block items first, then warp items, each heaviest (slots +
    tasks) first. Tasks with an empty list get no item."""
    if not 1 <= warp_seg < 2048:
        raise ValueError(f"plan_house: warp_seg {warp_seg} must lie in "
                         "[1, 2047] (a warp item's counts fit 11 planes)")
    n, dev = a.shape[0], a.device
    if n == 0:
        return HousePlan(torch.zeros((0, 4), dtype=torch.int32, device=dev),
                         0, 0, 0)
    first = torch.nonzero(_starts(a)).flatten()     # the runs of equal a
    runs = torch.diff(first, append=first.new_tensor([n]))
    st, ln = ft.lengths(a[first])
    dens = view.nbc if view is not None else popcount32(tab).sum(1)
    x = ft.colidx.long()
    ok = (x >= 0) & (x < tab.shape[0])
    pre = torch.zeros(x.shape[0] + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.where(ok, dens[torch.where(ok, x, 0)].long(), 0), 0,
                 out=pre[1:])
    block = pre[st + ln] - pre[st] <= sparse * ln
    size = torch.where(block, block_piece, piece)
    cut = torch.where(block, ln.clamp(min=1), warp_seg)
    nseg = (ln + cut - 1) // cut                # 0 for an empty list
    per = (runs + size - 1) // size * nseg       # a run's items
    m, n_block, longest = torch.stack([
        per.sum(), (per * block).sum(), ln.max()]).tolist()
    r = torch.repeat_interleave(per, output_size=m)
    k = torch.arange(m, device=dev) - (torch.cumsum(per, 0) - per)[r]
    pi, s0 = k // nseg[r], k % nseg[r] * cut[r]
    nt = torch.minimum(size[r], runs[r] - pi * size[r])
    ns = torch.minimum(cut[r], ln[r] - s0)
    weight = ns + nt
    order = torch.sort(torch.where(block[r], -weight - (1 << 40), -weight),
                       stable=True).indices      # heaviest first
    items = torch.stack([first[r] + pi * size[r], nt, s0, ns], 1)[order]
    return HousePlan(items.to(torch.int32).contiguous(), n_block, n, longest)


def _check(ft: FtLists, tab: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
           view: Optional[HouseView], plan: Optional[HousePlan]) -> bool:
    """The checks of a house_t3 call; True on CUDA."""
    _check_ids("house_t3", a, b)
    cuda = ft.check("house_t3")
    if on_cuda("house_t3", tab, a, b) != cuda:
        raise ValueError("house_t3: tensors on several devices")
    _check_tab("house_t3", tab, cuda)
    if view is not None:
        if on_cuda("house_t3", view.nbc, tab) != cuda or \
                view.nbc.shape != (tab.shape[0],) or view.cs < 0:
            raise ValueError("house_t3: the view must be int32 [V] on the "
                             "table's device, cs >= 0")
    if plan is not None and (plan.n_tasks != a.shape[0] or
                             plan.items.device != a.device):
        raise ValueError("house_t3: the plan is another call's")
    return cuda


def _guard(longest: int, tab: torch.Tensor) -> None:
    if longest * 32 * tab.shape[1] >= 1 << 31:
        raise ValueError(f"house_t3: a list of {longest} rows of "
                         f"{32 * tab.shape[1]} columns could pass int32")


def house_t3(ft: FtLists, tab: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, view: Optional[HouseView] = None,
             plan: Optional[HousePlan] = None) -> torch.Tensor:
    """Kernel H: int32 [n] Σ_{x ∈ L(a_t)} popcount(tab[x] & tab[b_t]); see
    the module docstring. `view` and `plan` are optional: the table's
    sparse view, and a plan built for these tasks (house_calls')."""
    if not _check(ft, tab, a, b, view, plan):
        _guard(int(ft.lengths(a)[1].max()) if a.numel() else 0, tab)
        return house_t3_plain(ft, tab, a, b)
    if plan is None:
        plan = plan_house(ft, tab, a, view)
    out = launch(_build.entry("gm_house_t3"), ft, tab, a, b, view, plan)
    if plan.items.shape[0]:
        house_t3.launches += 1
    return out


house_t3.launches = 0


def launch(fn, ft: FtLists, tab: torch.Tensor, a: torch.Tensor,
           b: torch.Tensor, view: Optional[HouseView],
           plan: HousePlan) -> torch.Tensor:
    """out of one launch of `fn` (gm_house_t3, or a copy of it built
    elsewhere with the same arguments) over a plan; nothing is launched for
    a plan without items."""
    _guard(plan.longest, tab)
    out = torch.zeros(a.shape[0], dtype=torch.int32, device=tab.device)
    m = plan.items.shape[0]
    if m == 0:
        return out
    units = plan.n_block + -(-(m - plan.n_block) // WARPS)
    _build.check_launch(fn(
        ft.rowptr.data_ptr(), ft.colidx.data_ptr(), tab.data_ptr(),
        tab.shape[0], tab.shape[1], a.data_ptr(), b.data_ptr(),
        plan.items.data_ptr(), plan.n_block, m,
        None if view is None else view.nbc.data_ptr(),
        0 if view is None else view.cs, out.data_ptr(),
        min(GRID_CAP, units), _build.stream(tab.device)), "house_t3")
    return out


def house_work(a: np.ndarray, b: np.ndarray, rowptr: np.ndarray,
               colidx: np.ndarray, ftw: np.ndarray, dens: np.ndarray,
               items: np.ndarray, n_block: int, words: int,
               csa_dot: bool = True) -> dict:
    """What kernel H does for one call with the sparse view under a plan's
    items (host numpy; dens: each row's set bits, the view's nbc): its
    items and block items, the tasks it dots (each item dots its tasks
    once a segment) over n, the list slots it builds over the distinct
    lists' slots, the view's ids it walks (a block item's rows and tasks)
    and the table rows it reads (a warp item's), the popcounts it issues
    (a warp item's plane dot, 32 lanes a 128-word stretch: np + 3 a lane
    by the carry-save dot, else 4 np, np the bits of its slots), and the
    tasks on either side of LIST_SPARSE (in block items, in warp items).
    With n_block = 0 and csa_dot False it counts the first design, whose
    items are all warp items."""
    n, v = a.shape[0], ftw.shape[0]
    it = items.astype(np.int64)
    m = it.shape[0]
    nt, ns = it[:, 1], it[:, 3]
    npl = np.frexp(ns.astype(np.float64))[1].astype(np.int64)
    per_dot = (npl + 3 if csa_dot else 4 * npl) * 32 * -(-words // 128)
    row_k = lambda ids: np.where((ids >= 0) & (ids < v), dens[np.clip(
        ids, 0, v - 1)].astype(np.int64), -1)
    expand = lambda start, ln: np.repeat(start, ln) + np.arange(
        int(ln.sum())) - np.repeat(np.cumsum(ln) - ln, ln)
    rep = np.repeat(np.arange(m), nt)
    tk = row_k(b.astype(np.int64))[expand(it[:, 0], nt)]
    blk = rep < n_block
    srep = np.repeat(np.arange(m), ns)
    sk = row_k(colidx[expand(rowptr[a[it[:, 0]]] + it[:, 2], ns)]
               .astype(np.int64))
    sblk = srep < n_block
    x = np.unique(a[(a >= 0) & (a < v)].astype(np.int64))
    ln = np.minimum(np.clip(ftw[x].astype(np.int64), 0, None),
                    rowptr[x + 1] - rowptr[x])
    first_seg = it[:, 2] == 0
    return {"tasks": n, "items": m, "block_items": n_block,
            "dotted_over_n": float(nt.sum() / max(n, 1)),
            "slots_built": int(ns.sum()), "distinct_slots": int(ln.sum()),
            "ids_walked": int(tk[blk & (tk > 0)].sum() +
                              sk[sblk & (sk > 0)].sum()),
            "table_rows_read": int(((tk >= 0) & ~blk).sum() +
                                   ((sk >= 0) & ~sblk).sum()),
            "popcounts": int((per_dot[rep] * ~blk).sum()),
            "tasks_block": int(nt[:n_block].sum()),
            "tasks_warp": int(nt[n_block:][first_seg[n_block:]].sum())}


def house_t3_plain(ft: FtLists, tab: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of house_t3 (any device): C_a for each distinct
    a by W's plain write mode (bit_colsum_plain), then each task's C_a row
    times the bits of tab[b] (shift and & 1, so bit 31 of a negative word
    counts once), summed in int64, in chunks of distinct a and of tasks."""
    n = _check_ids("house_t3", a, b)
    v, words = tab.shape
    cpad = 32 * words
    dev = tab.device
    out = torch.zeros(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    uid, inv = torch.unique(a, return_inverse=True)
    order = torch.sort(inv, stable=True).indices
    step = max(1, PLAIN_ELEMS // max(cpad, 1))
    bounds = torch.searchsorted(inv[order], torch.arange(
        0, uid.shape[0] + step, step, device=dev)).tolist()
    for k, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        cnt = bit_colsum_plain(ft, tab, uid[k * step:(k + 1) * step])
        for s in range(lo, hi, step):
            t = order[s:min(hi, s + step)]
            y = b[t].long()
            ok = (y >= 0) & (y < v)
            bits = _expand(tab[torch.where(ok, y, 0)] * ok[:, None])
            out[t] = (cnt[inv[t] - k * step] * bits).sum(
                1, dtype=torch.int64).to(torch.int32)
    return out
