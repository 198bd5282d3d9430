"""Kernels S, P and I — the per-edge triangle support's list and bitmap
parts (csrc/tri_support.cu), for ops/tri_support.py.

They replace three XLA functions of graphminer_tpu/ops/tri_support.py
(torch has no popcount):

* S, tri_bitmap (for `_bitmap_tri`, :78-95): out[t] = popcount(tab[s_t] &
  tab[d_t]), the common core neighbours of a task's two ends;
* P, tri_probe (for `_subcore_bit_probe`, :109-131): out[t] = the number of
  x in FT(u_t) with bit vl_t set in tab[x] (sub-core u, core v);
* I, tri_lists (for `_list_intersect`, :134-145): out[t] = |FT(u_t) ∩
  FT(w_t)| (both ends sub-core).

tab is the full-core bitmap table int32 [V, words], its words read as
uint32 (bit 31 of a negative word is a real bit). FT(x) is the first
min(ftw[x], deg x) ids of CSR row x (FtLists): the sub-core neighbours of
x, which are the prefix of its row because rows are sorted ascending and
the core ids are the largest. P and I read the lists there, so no list is
gathered on the host and no width class is needed. An id outside [0, V)
adds 0 (a u or w outside it has an empty list, an s or d a zero row), and
so does a bit vl_t outside [0, 32 words). I takes rows without a repeated
id (a CSR of a simple graph).

Each call with a task is one launch, counted on the wrapper's .launches; a
call with none launches nothing. On a CUDA tensor a wrapper launches its
kernel or raises; it takes its plain version only for CPU tensors.

The kernels take any task order, and are fast in tri_support's (DAG CSR
order: runs of equal src, dst ascending in a run). S: a warp takes a
window of S_WINDOW consecutive tasks and keeps a run's src row in
registers. P: a warp takes 32 consecutive tasks, a lane each, and walks
their lists in step, so a run's lanes read its list FT(u) once and share
each 32-byte sector of a row that their bits fall in. I: a group of
I_LANES lanes takes a task and searches the shorter list's ids, I_IDS a
lane at a time in lockstep, in the longer list. bitmap_loads,
probe_loads and list_loads count what a call loads under these designs.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np
import torch

from . import _build
from ._tensors import PLAIN_ELEMS, n_blocks, on_cuda, popcount32

#: tasks an S warp takes in order, a quarter to each group of 8 lanes
#: (csrc/tri_support.cu::S_WINDOW)
S_WINDOW = 128
#: S keeps src rows of at most this many words in registers
S_CACHED_WORDS = 128
#: tasks a P warp takes, a lane each
P_WINDOW = 32
#: words of a 32-byte sector, what one P probe request serves
SECTOR_WORDS = 8
#: lanes an I task takes (csrc/tri_support.cu::I_LANES)
I_LANES = 4
#: ids of the shorter list an I lane searches at once (I_IDS)
I_IDS = 3


@dataclasses.dataclass(frozen=True)
class FtLists:
    """The lists FT(x) of every vertex, on one device: the first
    min(ftw[x], deg x) ids of CSR row x. rowptr int64 [V + 1], colidx int32
    [nnz] (rows sorted ascending), ftw int32 [V]."""
    rowptr: torch.Tensor
    colidx: torch.Tensor
    ftw: torch.Tensor

    @classmethod
    def from_csr(cls, rowptr: np.ndarray, colidx: np.ndarray,
                 ftw: np.ndarray, device) -> "FtLists":
        t = lambda a, dt: torch.from_numpy(
            np.ascontiguousarray(a, dtype=dt)).to(device)
        return cls(rowptr=t(rowptr, np.int64), colidx=t(colidx, np.int32),
                   ftw=t(ftw, np.int32))

    @property
    def n_vertices(self) -> int:
        return self.ftw.shape[0]

    def check(self, name: str) -> bool:
        """on_cuda over the lists (rowptr must be int64); True on CUDA."""
        if self.rowptr.dtype != torch.int64 or \
                self.rowptr.shape != (self.n_vertices + 1,):
            raise TypeError(f"{name}: rowptr must be int64 [V + 1], got "
                            f"{self.rowptr.dtype} {tuple(self.rowptr.shape)}")
        cuda = on_cuda(name, self.colidx, self.ftw)
        if self.rowptr.device != self.ftw.device:
            raise ValueError(f"{name}: rowptr on {self.rowptr.device}, ftw "
                             f"on {self.ftw.device}")
        if cuda and not self.rowptr.is_contiguous():
            raise ValueError(f"{name}: kernel needs a contiguous rowptr")
        return cuda

    def lengths(self, ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(start int64 [n], length int64 [n]) of the lists of `ids`; an id
        outside [0, V) has length 0."""
        v = self.n_vertices
        x = ids.long()
        ok = (x >= 0) & (x < v)
        x = torch.where(ok, x, 0)
        st = self.rowptr[x]
        deg = self.rowptr[x + 1] - st
        ln = torch.minimum(self.ftw[x].long().clamp(min=0), deg)
        return st, torch.where(ok, ln, 0)

    def slots(self, ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every list slot of `ids`, flat: (task int64, id int64), task
        ascending and, within a task, in list order."""
        st, ln = self.lengths(ids)
        task = torch.repeat_interleave(
            torch.arange(ids.shape[0], device=ids.device), ln)
        first = torch.repeat_interleave(torch.cumsum(ln, 0) - ln, ln)
        pos = st[task] + torch.arange(task.shape[0], device=ids.device) - \
            first
        return task, self.colidx[pos].long()


def _chunks(n: int, ft: FtLists, *ids: torch.Tensor) -> Iterator[slice]:
    """Task ranges of a plain version: at most about PLAIN_ELEMS list slots
    a range."""
    longest = 1
    for x in ids:
        if x.numel():
            longest = max(longest, int(ft.lengths(x)[1].max()))
    step = max(1, PLAIN_ELEMS // longest)
    for s in range(0, n, step):
        yield slice(s, min(n, s + step))


def _check_tab(name: str, tab: torch.Tensor, cuda: bool) -> None:
    if tab.dim() != 2:
        raise ValueError(f"{name}: tab must be 2-D, got {tuple(tab.shape)}")
    if cuda and (tab.shape[1] % 4 or tab.data_ptr() % 16):
        raise ValueError(f"{name} reads 16-byte chunks: words="
                         f"{tab.shape[1]} must be a multiple of 4 and the "
                         "table aligned")


def _check_ids(name: str, *ids: torch.Tensor) -> int:
    n = ids[0].shape[0]
    for x in ids:
        if x.shape != (n,):
            raise ValueError(f"{name}: task ids {[tuple(y.shape) for y in ids]}"
                             " must be 1-D of one length")
    return n


def tri_bitmap(tab: torch.Tensor, src: torch.Tensor,
               dst: torch.Tensor) -> torch.Tensor:
    """Kernel S: int32 [n] popcount(tab[src] & tab[dst]); see the module
    docstring."""
    n = _check_ids("tri_bitmap", src, dst)
    cuda = on_cuda("tri_bitmap", tab, src, dst)
    _check_tab("tri_bitmap", tab, cuda)
    if not cuda:
        return tri_bitmap_plain(tab, src, dst)
    out = torch.empty(n, dtype=torch.int32, device=tab.device)
    if n == 0:
        return out
    _build.check_launch(_build.entry("gm_tri_bitmap")(
        tab.data_ptr(), tab.shape[0], tab.shape[1], src.data_ptr(),
        dst.data_ptr(), n, out.data_ptr(), n_blocks(-(-n // S_WINDOW) * 32),
        _build.stream(tab.device)), "tri_bitmap")
    tri_bitmap.launches += 1
    return out


tri_bitmap.launches = 0


def tri_bitmap_plain(tab: torch.Tensor, src: torch.Tensor,
                     dst: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of tri_bitmap (any device): masked row gathers,
    AND and popcount32 in task chunks."""
    n = _check_ids("tri_bitmap", src, dst)
    v = tab.shape[0]
    out = torch.zeros(n, dtype=torch.int32, device=tab.device)
    step = max(1, PLAIN_ELEMS // max(tab.shape[1], 1))
    for s in range(0, n, step):
        a, b = src[s:s + step].long(), dst[s:s + step].long()
        ok = (a >= 0) & (a < v) & (b >= 0) & (b < v)
        y = tab[torch.where(ok, a, 0)] & tab[torch.where(ok, b, 0)]
        out[s:s + step] = (popcount32(y).sum(dim=1) * ok).to(torch.int32)
    return out


def tri_probe(ft: FtLists, tab: torch.Tensor, u: torch.Tensor,
              vloc: torch.Tensor) -> torch.Tensor:
    """Kernel P: int32 [n], the x in FT(u[t]) with bit vloc[t] of tab[x]
    set; see the module docstring."""
    n = _check_ids("tri_probe", u, vloc)
    cuda = ft.check("tri_probe")
    if on_cuda("tri_probe", tab, u, vloc) != cuda:
        raise ValueError("tri_probe: tensors on several devices")
    _check_tab("tri_probe", tab, False)
    if not cuda:
        return tri_probe_plain(ft, tab, u, vloc)
    out = torch.empty(n, dtype=torch.int32, device=tab.device)
    if n == 0:
        return out
    _build.check_launch(_build.entry("gm_tri_probe")(
        ft.rowptr.data_ptr(), ft.colidx.data_ptr(), ft.ftw.data_ptr(),
        tab.data_ptr(), tab.shape[0], tab.shape[1], u.data_ptr(),
        vloc.data_ptr(), n, out.data_ptr(), n_blocks(n),
        _build.stream(tab.device)), "tri_probe")
    tri_probe.launches += 1
    return out


tri_probe.launches = 0


def tri_probe_plain(ft: FtLists, tab: torch.Tensor, u: torch.Tensor,
                    vloc: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of tri_probe (any device): every list slot's
    word, shifted and & 1 (bit b of an int32 word whatever its sign), summed
    a task, in task chunks."""
    n = _check_ids("tri_probe", u, vloc)
    v, words = tab.shape
    out = torch.zeros(n, dtype=torch.int32, device=tab.device)
    for s in _chunks(n, ft, u):
        vl = vloc[s].long()
        okv = (vl >= 0) & (vl < 32 * words)
        task, x = ft.slots(torch.where(okv, u[s], -1))
        ok = (x >= 0) & (x < v)
        b = vl[task]
        w = tab[torch.where(ok, x, 0), b >> 5]
        bit = ((w >> (b & 31).to(torch.int32)) & 1) * ok
        out[s] = torch.zeros(s.stop - s.start, dtype=torch.int32,
                             device=tab.device).index_add_(
                                 0, task, bit.to(torch.int32))
    return out


def _starts(ids: torch.Tensor, window=None) -> torch.Tensor:
    """bool [n]: task t opens a run (t = 0 or ids[t] != ids[t - 1]), and,
    with a window, also where t is a multiple of it."""
    n = ids.shape[0]
    new = torch.ones(n, dtype=torch.bool, device=ids.device)
    new[1:] = ids[1:] != ids[:-1]
    if window:
        new[::window] = True
    return new


def bitmap_loads(tab: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                 window: int = S_WINDOW) -> dict:
    """What kernel S loads for one call with `window` tasks a warp: its
    runs of equal src, windows, the src rows it reads (a row a run within
    a group's quarter window; a task's when rows are wider than
    S_CACHED_WORDS), the dst rows (one a task with both ids in [0, V)) and
    their bytes."""
    n, (v, words) = src.shape[0], tab.shape
    valid = (src >= 0) & (src < v) & (dst >= 0) & (dst < v)
    idx = torch.nonzero(valid).flatten()
    a, seg = src[idx], window // 4
    if words <= S_CACHED_WORDS:
        loads = _starts(a)
        loads[1:] |= (idx[1:] // seg) != (idx[:-1] // seg)
        src_rows = int(loads.sum())
    else:
        src_rows = idx.numel()
    return dict(tasks=n, runs=int(_starts(src).sum()),
                windows=-(-n // window), src_rows=src_rows,
                dst_rows=idx.numel(),
                row_bytes=(src_rows + idx.numel()) * 4 * words)


def probe_loads(ft: FtLists, tab: torch.Tensor, u: torch.Tensor,
                vloc: torch.Tensor, window=P_WINDOW) -> dict:
    """What kernel P loads for one call, its tasks taken `window` at a time
    (None: whole runs), counting only tasks with a non-empty list and a bit
    in [0, 32 words): its runs of equal u; the lists it reads, one a run
    within a window (`lists`, `list_ids`); its sector requests, for each
    such run and list slot with an id in [0, V) one a distinct 32-byte
    sector of the slot's row that the run's bits fall in (`sectors`),
    against the `probes` of one word a slot a task."""
    v, words = tab.shape
    ln = ft.lengths(u)[1]
    vl = vloc.long()
    idx = torch.nonzero((ln > 0) & (vl >= 0) & (vl < 32 * words)).flatten()
    rid = torch.cumsum(_starts(u, window).long(), 0)[idx]
    new = _starts(rid)                     # a run's first such task
    uid, inv = torch.unique(u[idx].long(), return_inverse=True)
    task, x = ft.slots(uid)
    slots = torch.zeros(uid.shape[0], dtype=torch.int64, device=u.device
                        ).index_add_(0, task, ((x >= 0) & (x < v)).long())[inv]
    key = rid * (words // SECTOR_WORDS + 1) + (vl[idx] >> 5) // SECTOR_WORDS
    keys, kinv = torch.unique(key, return_inverse=True)
    per_key = torch.zeros(keys.shape[0], dtype=torch.int64, device=u.device
                          ).scatter_(0, kinv, slots)
    return dict(tasks=u.shape[0], runs=int(_starts(u).sum()),
                windows=-(-u.shape[0] // window) if window else None,
                lists=int(new.sum()), list_ids=int(ln[idx][new].sum()),
                sectors=int(per_key.sum()), probes=int(slots.sum()))


def _sectors(start: torch.Tensor, length: torch.Tensor, piece: int) -> int:
    """32-byte sectors that reading the colidx ranges [start, start +
    length) takes, each `piece` ids at a time from its start (one load
    instruction of as many lanes)."""
    n_pieces = (length + piece - 1) // piece
    rng = torch.repeat_interleave(torch.arange(start.shape[0],
                                               device=start.device), n_pieces)
    first = torch.repeat_interleave(torch.cumsum(n_pieces, 0) - n_pieces,
                                    n_pieces)
    i = (torch.arange(rng.shape[0], device=start.device) - first) * piece
    a = start[rng] + i
    b = start[rng] + torch.minimum(length[rng], i + piece)
    return int(((b - 1) // SECTOR_WORDS - a // SECTOR_WORDS + 1).sum())


def list_loads(ft: FtLists, u: torch.Tensor, w: torch.Tensor,
               lanes: int = I_LANES, ids: int = I_IDS) -> dict:
    """What kernel I loads for one call, a task to each group of `lanes`
    lanes and `ids` ids a lane a round, counting only tasks whose two lists
    are non-empty: its runs of equal u; the shorter list's ids, read once a
    task (`short_ids`), in rounds of lanes * ids slots (`rounds`); the
    loads of the searches in the longer list, at most ceil(log2 longer) +
    2 a slot (the halvings, the compare at the slot found and the hit test
    at the slot after it), padding slots included (`search_loads`); the
    32-byte sector requests of the shorter lists' reads (`lanes` ids a
    load) and of the longer lists, each sector a task spans once, as L1
    keeps the list between a task's searches (`sectors`); the dependent
    loads a task's lanes wait on in turn (`chain`: at most
    ceil(log2 longer) + 2 a round), against the first design's
    (`first_chain`: 8 lanes a task, each its ceil(shorter / 8) ids one
    after another, ceil(log2(longer + 1)) loads an id)."""
    sa, la = ft.lengths(u)
    sb, lb = ft.lengths(w)
    idx = torch.nonzero((la > 0) & (lb > 0)).flatten()
    sa, la, sb, lb = sa[idx], la[idx], sb[idx], lb[idx]
    swap = la > lb                       # u's list is the shorter on a tie
    s_short = torch.where(swap, sb, sa)
    s_long = torch.where(swap, sa, sb)
    short, long_ = torch.minimum(la, lb), torch.maximum(la, lb)
    rounds = (short + lanes * ids - 1) // (lanes * ids)
    depth = torch.ceil(torch.log2(long_.double())).long() + 2
    span = (s_long + long_ - 1) // SECTOR_WORDS - s_long // SECTOR_WORDS + 1
    first = torch.ceil(torch.log2((long_ + 1).double())).long()
    return dict(tasks=u.shape[0], runs=int(_starts(u).sum()),
                short_ids=int(short.sum()), rounds=int(rounds.sum()),
                search_loads=int((rounds * lanes * ids * depth).sum()),
                sectors=_sectors(s_short, short, lanes) + int(span.sum()),
                chain=int((rounds * depth).sum()),
                first_chain=int((((short + 7) // 8) * first).sum()))


def tri_lists(ft: FtLists, u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Kernel I: int32 [n] |FT(u[t]) ∩ FT(w[t])|; see the module
    docstring."""
    n = _check_ids("tri_lists", u, w)
    cuda = ft.check("tri_lists")
    if on_cuda("tri_lists", u, w) != cuda:
        raise ValueError("tri_lists: tensors on several devices")
    if not cuda:
        return tri_lists_plain(ft, u, w)
    out = torch.empty(n, dtype=torch.int32, device=u.device)
    if n == 0:
        return out
    _build.check_launch(_build.entry("gm_tri_lists")(
        ft.rowptr.data_ptr(), ft.colidx.data_ptr(), ft.ftw.data_ptr(),
        ft.n_vertices, u.data_ptr(), w.data_ptr(), n, out.data_ptr(),
        n_blocks(n * I_LANES), _build.stream(u.device)), "tri_lists")
    tri_lists.launches += 1
    return out


tri_lists.launches = 0


def tri_lists_plain(ft: FtLists, u: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of tri_lists (any device): each list slot as
    the key task * V + id, and the u side's keys found among the w side's
    (torch.isin), counted a task, in task chunks."""
    n = _check_ids("tri_lists", u, w)
    v = ft.n_vertices
    out = torch.zeros(n, dtype=torch.int32, device=u.device)
    for s in _chunks(n, ft, u, w):
        ta, xa = ft.slots(u[s])
        tb, xb = ft.slots(w[s])
        okb = (xb >= 0) & (xb < v)
        hit = torch.isin(ta * v + xa, (tb * v + xb)[okb]) & (xa >= 0) & \
            (xa < v)
        out[s] = torch.zeros(s.stop - s.start, dtype=torch.int32,
                             device=u.device).index_add_(
                                 0, ta, hit.to(torch.int32))
    return out
