"""Kernel H — per-edge 3-walk support over per-run column counts
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

C_a is W's write-mode column sum (ops/cuda_colsum.py::bit_colsum) for one
list; H never writes it out. plan_house cuts the tasks into pieces of at
most PIECE consecutive tasks of one run of equal a and each piece's list
into segments of at most SEG slots; a warp takes one (piece, segment) item
at a time, heaviest first, builds C_a over the segment bit-sliced in
registers and adds each task's dot into out with an atomic. Any task order
gives the same result; runs of equal a (CSR order, or sorted by a) are the
fast case.

Each call with a task is one launch, counted on house_t3.launches; a call
with none launches nothing. On a CUDA tensor the wrapper launches its
kernel or raises; it takes its plain version only for CPU tensors.
"""
from __future__ import annotations

import torch

from . import _build
from ._tensors import BLOCK, GRID_CAP, PLAIN_ELEMS, on_cuda
from .cuda_colsum import _expand, bit_colsum_plain
from .cuda_tri import FtLists, _check_ids, _check_tab, _starts

#: most consecutive tasks of one run a warp takes with one build of C_a
PIECE = 1024
#: most list slots one build of C_a takes (csrc/house_t3.cu::SEG: its
#: column counts stay within 11 bit planes); a longer list is cut, and its
#: segments' sums meet in out
SEG = 1024


def plan_house(ft: FtLists, a: torch.Tensor, piece: int = PIECE,
               seg: int = SEG) -> torch.Tensor:
    """Kernel H's items for the tasks whose list owners are `a`, on a's
    device: int32 [m, 4] (first task, tasks, first slot of the segment in
    L(a), slots), one a piece of at most `piece` consecutive tasks of a run
    of equal a and segment of at most `seg` slots of its list, heaviest
    (slots + tasks) first. Tasks with an empty list get no item."""
    n = a.shape[0]
    dev = a.device
    new = _starts(a)
    first = torch.nonzero(new).flatten()
    run_first = first[torch.cumsum(new.long(), 0) - 1]
    brk = new | ((torch.arange(n, device=dev) - run_first) % piece == 0)
    first = torch.nonzero(brk).flatten()
    tasks = torch.diff(first, append=torch.tensor([n], device=dev))
    ln = ft.lengths(a[first])[1]
    keep = ln > 0
    first, tasks, ln = first[keep], tasks[keep], ln[keep]
    nseg = (ln + seg - 1) // seg
    rep = torch.repeat_interleave(torch.arange(first.shape[0], device=dev),
                                  nseg)
    s0 = (torch.arange(rep.shape[0], device=dev) -
          torch.repeat_interleave(torch.cumsum(nseg, 0) - nseg, nseg)) * seg
    slots = torch.clamp(ln[rep] - s0, max=seg)
    items = torch.stack([first[rep], tasks[rep], s0, slots], 1)
    order = torch.sort(slots + tasks[rep], descending=True, stable=True).indices
    return items[order].to(torch.int32).contiguous()


def _check(ft: FtLists, tab: torch.Tensor, a: torch.Tensor,
           b: torch.Tensor) -> bool:
    """The checks of a house_t3 call; True on CUDA."""
    _check_ids("house_t3", a, b)
    cuda = ft.check("house_t3")
    if on_cuda("house_t3", tab, a, b) != cuda:
        raise ValueError("house_t3: tensors on several devices")
    _check_tab("house_t3", tab, cuda)
    if a.numel():
        longest = int(ft.lengths(a)[1].max())
        if longest * 32 * tab.shape[1] >= 1 << 31:
            raise ValueError(f"house_t3: a list of {longest} rows of "
                             f"{32 * tab.shape[1]} columns could pass int32")
    return cuda


def house_t3(ft: FtLists, tab: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor) -> torch.Tensor:
    """Kernel H: int32 [n] Σ_{x ∈ L(a_t)} popcount(tab[x] & tab[b_t]); see
    the module docstring."""
    if not _check(ft, tab, a, b):
        return house_t3_plain(ft, tab, a, b)
    out = torch.zeros(a.shape[0], dtype=torch.int32, device=tab.device)
    items = plan_house(ft, a)
    m = items.shape[0]
    if m == 0:
        return out
    _build.check_launch(_build.entry("gm_house_t3")(
        ft.rowptr.data_ptr(), ft.colidx.data_ptr(), tab.data_ptr(),
        tab.shape[0], tab.shape[1], a.data_ptr(), b.data_ptr(),
        items.data_ptr(), m, out.data_ptr(),
        max(1, min(GRID_CAP, -(-m * 32 // BLOCK))), _build.stream(tab.device)),
        "house_t3")
    house_t3.launches += 1
    return out


house_t3.launches = 0


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
