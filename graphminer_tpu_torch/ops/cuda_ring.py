"""Kernels B and C — the ring engine's counts (csrc/ring_phase_c.cu,
csrc/ring_tail_pairs.cu).

B, ring_phase_c, is the port of the Pallas kernel
graphminer_tpu/ops/pallas_ring.py::_kernel (and of its XLA twin
ops/ring.py::_cbucket_partials): Σ_r Σ_s popcount(src_bm[r] &
table[dst_loc[r, s]]), where a slot outside [0, rows of table) gives 0. It
serves phase C (table = the core bitmaps) and the phase-T bitmap pass
(table = the dense bm_table). One launch counts every such bucket of a
layout: plan_phase_c reads the buckets once per layout and lists, slice by
slice (8 words, one 32-byte sector), the (src row, slice) pairs whose src
slice is non-zero, cut into one range of equal work per block;
ring_phase_c_all launches B once over that list (int64 partials whose sum
is the count). ring_phase_c is the one-bucket call of the same kernel. Both
count their launches on ring_phase_c.launches.

C replaces ops/ring.py::_tail_pairs_partials: for every task i, the number
of non-SENTINEL ids shared by table_a[sa[i]] and table_b[sb[i]] (rows
sorted ascending, SENTINEL padded, no repeated id); a slot outside its
table gives 0. One launch counts every tail-compare bucket of a layout:
plan_tail_pairs builds, once per layout, a tile table in device memory
(ops/_tiles.py) and ring_tail_pairs_all launches C once over it (int64
partials whose sum is the count). ring_tail_pairs is the one-bucket call of
the same kernel. Both count their launches on ring_tail_pairs.launches.

ring_phase_c and ring_tail_pairs return an int64 0-d tensor on the inputs'
device. Each wrapper takes its plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises.

Left out of the Pallas kernel's port: the SMEM index chunking (SMEM_IDS) and
the enable_x64(False) scope (pallas_ring.py:79-106), both TPU limits, and
the per_task=True paths of the XLA twins, which have no caller.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..types import SENTINEL
from . import _build
from ._tensors import PLAIN_ELEMS, on_cuda, popcount32
from ._tiles import plan_tiles


#: words of a slice of kernel B: one 32-byte sector of a row
SLICE = 8
#: most slots of one work item (a run of one row's slots in one slice)
PIECE = 64
#: an item packs its first slot and its length as off << LEN_BITS | len
LEN_BITS = 8
#: most rows of a table whose slice kernel B stages in shared memory
#: (4096 x 32 B = 128 KB: the ring layout's core table)
STAGE_ROWS = 4096
#: the planner's cost of an item beyond its slots (the warp's scan and the
#: item's src sector), in slots
ITEM_COST = 8
#: the planner's cost of a slot of an unstaged table, in staged slots: its
#: table sector comes from L2 or HBM, not shared memory (at rmat18 a slot
#: of the bitmap pass takes about 2.6x one of phase C:
#: chip_smoke.py::phase_c_groups, PERF.md)
DIRECT_COST = 2.6
#: fields of a phase-C bucket record: table, n_table, src_bm, dst_loc,
#: words, wc, staged (csrc/ring_phase_c.cu reads them in this order)
PHASE_C_BREC = 7
#: fields of a phase-C tile record: bucket, slice, first item, items
PHASE_C_TREC = 4


def _check_phase_c(table, src_bm, dst_loc):
    if src_bm.dim() != 2 or table.dim() != 2 or \
            table.shape[1] != src_bm.shape[1] or dst_loc.dim() != 2 or \
            dst_loc.shape[0] != src_bm.shape[0]:
        raise ValueError(f"phase-C shapes disagree: table {tuple(table.shape)}"
                         f" src_bm {tuple(src_bm.shape)} dst_loc "
                         f"{tuple(dst_loc.shape)}")


def phase_c_units(table: torch.Tensor, src_bm: torch.Tensor,
                  dst_loc: torch.Tensor):
    """The work of one bucket, read from its data once per layout: host
    int64 arrays (slices, rows, lens, valid) over every (src row, slice)
    pair whose src slice is non-zero and whose row has a slot inside the
    table, slice-major and rows ascending; lens is 1 + the row's last such
    slot, valid the number of such slots. Every other pair counts 0."""
    n, words = src_bm.shape
    wc = dst_loc.shape[1]
    empty = np.zeros(0, np.int64)
    if n == 0 or wc == 0:
        return empty, empty, empty, empty
    n_t = table.shape[0]
    pos = torch.arange(1, wc + 1, dtype=torch.int32, device=dst_loc.device)
    step = max(1, PLAIN_ELEMS // wc)
    last, valid = [], []
    for r0 in range(0, n, step):
        d = dst_loc[r0:r0 + step]
        ok = (d >= 0) & (d < n_t)
        last.append((ok * pos).amax(dim=1))
        valid.append(ok.sum(dim=1))
    last, valid = torch.cat(last), torch.cat(valid)
    nz = (src_bm.reshape(n, -1, SLICE) != 0).any(dim=2) & (last > 0)[:, None]
    s, r = torch.nonzero(nz.t(), as_tuple=True)
    return (s.cpu().numpy().astype(np.int64), r.cpu().numpy().astype(np.int64),
            last[r].cpu().numpy().astype(np.int64),
            valid[r].cpu().numpy().astype(np.int64))


def plan_phase_c_units(units, table_keys, staged, n_parts: int):
    """Items, tiles and block ranges of kernel B from each bucket's
    phase_c_units (slices, rows, lens, ...), a key naming its table and
    whether the kernel stages that table.

    Order: tables in order of first appearance; within a table, slice by
    slice; within a slice, bucket by bucket, rows ascending. Each (row,
    slice) pair becomes ceil(len / PIECE) items of at most PIECE slots.
    Returns (items int32 [n, 2] = (row, off << LEN_BITS | len), tiles int64
    [n_tiles, PHASE_C_TREC] = (bucket, slice, first item, items),
    block_tiles int64 [n_parts + 1]): part b of equal work (slots +
    ITEM_COST an item) is tiles [block_tiles[b], block_tiles[b + 1]), and a
    tile lies in one (bucket, slice); a slot of an unstaged table weighs
    DIRECT_COST."""
    seg_b, seg_s, pieces = [], [], []
    order = list(dict.fromkeys(table_keys))
    for key in order:
        mine = [b for b, k in enumerate(table_keys) if k == key]
        top = max((int(units[b][0].max()) + 1 for b in mine
                   if units[b][0].size), default=0)
        for s in range(top):
            for b in mine:
                sl, rows, lens = units[b][0], units[b][1], units[b][2]
                lo, hi = np.searchsorted(sl, [s, s + 1])
                if hi > lo:
                    seg_b.append(b)
                    seg_s.append(s)
                    pieces.append((rows[lo:hi], lens[lo:hi],
                                   1.0 if staged[b] else DIRECT_COST))
    if not pieces:
        return (np.zeros((0, 2), np.int32), np.zeros((0, PHASE_C_TREC),
                                                     np.int64),
                np.zeros(n_parts + 1, np.int64))
    rows = np.concatenate([p[0] for p in pieces])
    lens = np.concatenate([p[1] for p in pieces])
    seg_items = np.array([p[0].size for p in pieces], np.int64)
    weight = np.repeat([p[2] for p in pieces], seg_items)
    n_pc = -(-lens // PIECE)
    rep = np.repeat(np.arange(rows.size), n_pc)
    first_piece = np.concatenate([[0], np.cumsum(n_pc)[:-1]])
    off = (np.arange(rep.size) - first_piece[rep]) * PIECE
    plen = np.minimum(PIECE, lens[rep] - off)
    if off.size and int(off.max()) >= 1 << (31 - LEN_BITS):
        raise ValueError("plan_phase_c: rows of more than 2^23 slots")
    items = np.stack([rows[rep], off << LEN_BITS | plen], 1).astype(np.int32)
    seg_pieces = np.bincount(np.repeat(np.arange(seg_items.size), seg_items),
                             weights=n_pc, minlength=seg_items.size)
    seg_first = np.concatenate([[0], np.cumsum(seg_pieces)[:-1]]
                               ).astype(np.int64)
    cum = np.cumsum(plen * weight[rep] + ITEM_COST)
    cuts = np.searchsorted(cum, cum[-1] * np.arange(n_parts + 1) / n_parts,
                           side="right").astype(np.int64)
    cuts[-1] = items.shape[0]
    bounds = np.union1d(seg_first, cuts[:-1])
    tile_first = bounds[bounds < items.shape[0]]
    tile_count = np.diff(np.concatenate([tile_first, [items.shape[0]]]))
    seg = np.searchsorted(seg_first, tile_first, side="right") - 1
    tiles = np.stack([np.asarray(seg_b)[seg], np.asarray(seg_s)[seg],
                      tile_first, tile_count], 1).astype(np.int64)
    block_tiles = np.searchsorted(tile_first, cuts).astype(np.int64)
    return items, tiles, block_tiles


@dataclasses.dataclass(frozen=True)
class PhaseCPlan:
    """A layout's phase-C and bitmap-pass buckets and kernel B's work list,
    on the buckets' device. The records hold raw pointers, so the plan
    keeps the tensors referenced for as long as it lives. l2_bytes is what
    one launch reads past L1, in the kernel's own terms: the items, the
    slots of each item, one src sector an item, each staged slice once a
    block and one table sector a valid task of an unstaged table."""
    groups: Tuple[Tuple[torch.Tensor, ...], ...]   # (table, src_bm, dst_loc)
    table: Optional[torch.Tensor]   # int64 records | tiles | block ranges
    items: Optional[torch.Tensor]   # int32 [n_items, 2]
    n_tiles: int
    n_blocks: int
    stage_rows: int
    l2_bytes: int
    device: torch.device


def plan_phase_c(groups: Sequence[Tuple[torch.Tensor, ...]],
                 device=None) -> PhaseCPlan:
    """The plan of one layout's kernel-B buckets, each (table, src_bm,
    dst_loc), all on one device (`device` names it when there is none).
    For CUDA tensors it reads the buckets once (phase_c_units), builds the
    work list with one part per block of a full wave, and copies it to the
    card."""
    groups = tuple(tuple(gr) for gr in groups)
    for gr in groups:
        _check_phase_c(*gr)
    tensors = [t for gr in groups for t in gr]
    if not tensors:
        return PhaseCPlan((), None, None, 0, 0, 0, 0,
                          torch.device(device or "cpu"))
    if not on_cuda("ring_phase_c_all", *tensors):
        return PhaseCPlan(groups, None, None, 0, 0, 0, 0, tensors[0].device)
    for table, src_bm, _ in groups:
        if src_bm.shape[1] % SLICE:
            raise ValueError(f"kernel reads {SLICE}-word slices: words="
                             f"{src_bm.shape[1]}")
        if table.data_ptr() % 16 or src_bm.data_ptr() % 16:
            raise ValueError("kernel reads 16-byte chunks: rows must be "
                             "aligned")
    staged = [t.shape[0] <= STAGE_ROWS for t, _, _ in groups]
    stage_rows = max((t.shape[0] for (t, _, _), s in zip(groups, staged)
                      if s), default=0)
    n_parts = _build.wave_blocks("gm_ring_phase_c_blocks",
                                 tensors[0].device.index, stage_rows)
    units = [phase_c_units(*gr) for gr in groups]
    items, tiles, block_tiles = plan_phase_c_units(
        units, [t.data_ptr() for t, _, _ in groups], staged, n_parts)
    recs = np.array([(t.data_ptr(), t.shape[0], s.data_ptr(), d.data_ptr(),
                      s.shape[1], d.shape[1], int(st))
                     for (t, s, d), st in zip(groups, staged)], np.int64)
    dev = tensors[0].device
    table = torch.from_numpy(np.concatenate(
        [recs.reshape(-1), tiles.reshape(-1), block_tiles]))
    return PhaseCPlan(groups, table.to(dev), torch.from_numpy(items).to(dev),
                      tiles.shape[0], n_parts, stage_rows,
                      phase_c_l2_bytes(units, staged, [t.shape[0] for t, _, _
                                                       in groups],
                                       items, tiles, block_tiles),
                      dev)


def phase_c_l2_bytes(units, staged, n_tables, items, tiles,
                     block_tiles) -> int:
    """The bytes one launch of kernel B reads past L1 over a work list:
    8 a record and 4 a slot of each item, one 32-byte src sector an item,
    each staged slice once for every run of tiles of one (table, slice) in
    a block, one 32-byte table sector a valid task of an unstaged table,
    and 8 a partial."""
    sector = 4 * SLICE
    n = items.shape[0] * (8 + sector) + 4 * int(
        (items[:, 1] & ((1 << LEN_BITS) - 1)).sum())
    n += sector * sum(int(u[3].sum()) for u, st in zip(units, staged)
                      if not st)
    for b in range(block_tiles.size - 1):
        last = None
        for bk, sl, _, _ in tiles[block_tiles[b]:block_tiles[b + 1]]:
            if staged[bk] and (bk, sl) != last:
                n += sector * n_tables[bk]
            last = (bk, sl)
    return n + 8 * (block_tiles.size - 1)


def ring_phase_c_all(plan: PhaseCPlan) -> torch.Tensor:
    """Kernel B over every bucket of `plan` in one launch: int64 [n]
    partial counts on the plan's device whose sum is the count (one per
    block). On the CPU, the plain version."""
    if plan.table is None:
        return ring_phase_c_all_plain(plan)
    dev = plan.device
    if plan.n_tiles == 0:
        return torch.zeros(1, dtype=torch.int64, device=dev)
    out = torch.empty(plan.n_blocks, dtype=torch.int64, device=dev)
    base = plan.table.data_ptr()
    tiles = base + len(plan.groups) * PHASE_C_BREC * 8
    blocks = tiles + plan.n_tiles * PHASE_C_TREC * 8
    _build.check_launch(_build.entry("gm_ring_phase_c")(
        base, tiles, blocks, plan.items.data_ptr(), plan.stage_rows,
        out.data_ptr(), plan.n_blocks, _build.stream(dev)), "ring_phase_c")
    ring_phase_c.launches += 1
    return out


def ring_phase_c_all_plain(plan: PhaseCPlan) -> torch.Tensor:
    """Plain version of ring_phase_c_all: the sum of the per-bucket plain
    counts, as an int64 [1] tensor."""
    total = torch.zeros(1, dtype=torch.int64, device=plan.device)
    for gr in plan.groups:
        total += ring_phase_c_plain(*gr)
    return total


def ring_phase_c(table: torch.Tensor, src_bm: torch.Tensor,
                 dst_loc: torch.Tensor) -> torch.Tensor:
    """Σ popcount(src_bm[r] & table[dst_loc[r, s]]) over valid slots: the
    one-bucket call of kernel B."""
    _check_phase_c(table, src_bm, dst_loc)
    if not on_cuda("ring_phase_c", table, src_bm, dst_loc):
        return ring_phase_c_plain(table, src_bm, dst_loc)
    return ring_phase_c_all(plan_phase_c([(table, src_bm, dst_loc)])).sum()


ring_phase_c.launches = 0


def ring_phase_c_plain(table: torch.Tensor, src_bm: torch.Tensor,
                       dst_loc: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ring_phase_c (any device), in row chunks."""
    n, words = src_bm.shape
    wc = dst_loc.shape[1]
    n_t = table.shape[0]
    step = max(1, PLAIN_ELEMS // max(wc * words, 1))
    total = torch.zeros((), dtype=torch.int64, device=src_bm.device)
    for r0 in range(0, n, step):
        d = dst_loc[r0:r0 + step]
        ok = (d >= 0) & (d < n_t)
        rows = table[torch.where(ok, d, 0)]            # [r, wc, words]
        pc = popcount32(src_bm[r0:r0 + step, None, :] & rows).sum(dim=2)
        total += (pc * ok).sum()
    return total


#: tasks per tile of kernel C: ~3,000 tiles over the 770,000 rmat18 tail
#: tasks, several for each block of the persistent grid; the kernel stages a
#: tile's slot ids in shared memory sized by the same constant (TILE)
TAIL_TILE = 256
#: fields of a tail-bucket record: ta, na, wa, tb, nb, wb, sa, sb, g, staged
#: (csrc/ring_tail_pairs.cu reads them in this order)
TAIL_BREC = 10
#: ints of shared memory a warp may stage tb rows in (8 KB; 64 KB a block)
REGION_CAP = 2048


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def plan_tail_pairs_shapes(shapes: Sequence[Tuple[int, int, int]]):
    """(bucket records int64 [n, TAIL_BREC] with null pointers and table
    heights, tile records int64 [n_tiles, TREC], region) for tail-pair
    buckets of shape (n tasks, wa, wb). Per bucket: g lanes a task, the
    fewest of 8, 16, 32 that let the warp's 32 / g rows of wb ids fit
    REGION_CAP; staged when they fit. region is the ints a warp stages, the
    most any staged bucket needs."""
    recs = np.zeros((len(shapes), TAIL_BREC), np.int64)
    units, region = [], 0
    for i, (n, wa, wb) in enumerate(shapes):
        g = min(32, max(8, _pow2_at_least(-(-32 * wb // REGION_CAP))))
        staged = (32 // g) * wb <= REGION_CAP
        if staged:
            region = max(region, (32 // g) * wb)
        recs[i, [2, 5, 8, 9]] = (wa, wb, g, int(staged))
        units.append(int(n) if wa and wb else 0)
    return recs, plan_tiles(units, [1] * len(units), TAIL_TILE), region


@dataclasses.dataclass(frozen=True)
class TailPlan:
    """A layout's tail-pair buckets and their tile table, on the buckets'
    device. The table holds raw pointers, so the plan keeps the tensors
    referenced for as long as it lives."""
    groups: Tuple[Tuple[torch.Tensor, ...], ...]   # (ta, tb, sa, sb) each
    table: Optional[torch.Tensor]   # int64 [n*TAIL_BREC + n_tiles*TREC]
    n_tiles: int
    region: int
    device: torch.device


def _check_group(ta, tb, sa, sb):
    if ta.dim() != 2 or tb.dim() != 2 or sa.dim() != 1 or \
            sa.shape != sb.shape:
        raise ValueError(f"tail-pair shapes disagree: {tuple(ta.shape)}"
                         f" {tuple(tb.shape)} {tuple(sa.shape)} "
                         f"{tuple(sb.shape)}")


def plan_tail_pairs(groups: Sequence[Tuple[torch.Tensor, ...]],
                    device=None) -> TailPlan:
    """The plan of one layout's tail-pair buckets, each (table_a, table_b,
    sa, sb), all on one device (`device` names it when there is none). For
    CUDA tensors it builds the tile table and copies it to the card once."""
    groups = tuple(tuple(gr) for gr in groups)
    for gr in groups:
        _check_group(*gr)
    tensors = [t for gr in groups for t in gr]
    if not tensors:
        return TailPlan((), None, 0, 0, torch.device(device or "cpu"))
    if not on_cuda("ring_tail_pairs_all", *tensors):
        return TailPlan(groups, None, 0, 0, tensors[0].device)
    recs, tiles, region = plan_tail_pairs_shapes(
        [(sa.shape[0], ta.shape[1], tb.shape[1]) for ta, tb, sa, _ in groups])
    recs[:, [0, 1, 3, 4, 6, 7]] = [
        (ta.data_ptr(), ta.shape[0], tb.data_ptr(), tb.shape[0],
         sa.data_ptr(), sb.data_ptr()) for ta, tb, sa, sb in groups]
    table = torch.from_numpy(np.concatenate([recs.reshape(-1),
                                             tiles.reshape(-1)]))
    return TailPlan(groups, table.to(tensors[0].device), tiles.shape[0],
                    region, tensors[0].device)


def ring_tail_pairs_all(plan: TailPlan) -> torch.Tensor:
    """Kernel C over every bucket of `plan` in one launch: int64 [n] partial
    counts on the plan's device whose sum is the count (one per block). On
    the CPU, the plain version."""
    if plan.table is None:
        return ring_tail_pairs_all_plain(plan)
    dev = plan.device
    if plan.n_tiles == 0:
        return torch.zeros(1, dtype=torch.int64, device=dev)
    nb = min(plan.n_tiles, _build.wave_blocks(
        "gm_ring_tail_pairs_blocks", dev.index, plan.region))
    out = torch.empty(nb, dtype=torch.int64, device=dev)
    tiles = plan.table.data_ptr() + len(plan.groups) * TAIL_BREC * 8
    _build.check_launch(_build.entry("gm_ring_tail_pairs")(
        plan.table.data_ptr(), tiles, plan.n_tiles, plan.region,
        out.data_ptr(), nb, _build.stream(dev)), "ring_tail_pairs")
    ring_tail_pairs.launches += 1
    return out


def ring_tail_pairs_all_plain(plan: TailPlan) -> torch.Tensor:
    """Plain version of ring_tail_pairs_all: the sum of the per-bucket plain
    counts, as an int64 [1] tensor."""
    total = torch.zeros(1, dtype=torch.int64, device=plan.device)
    for gr in plan.groups:
        total += ring_tail_pairs_plain(*gr)
    return total


def ring_tail_pairs(table_a: torch.Tensor, table_b: torch.Tensor,
                    sa: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """Σ_i |table_a[sa[i]] ∩ table_b[sb[i]]| over non-SENTINEL ids: the
    one-bucket call of kernel C."""
    _check_group(table_a, table_b, sa, sb)
    if not on_cuda("ring_tail_pairs", table_a, table_b, sa, sb):
        return ring_tail_pairs_plain(table_a, table_b, sa, sb)
    return ring_tail_pairs_all(
        plan_tail_pairs([(table_a, table_b, sa, sb)])).sum()


ring_tail_pairs.launches = 0


def ring_tail_pairs_plain(table_a: torch.Tensor, table_b: torch.Tensor,
                          sa: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ring_tail_pairs (any device): gathers and
    the SENTINEL-masked broadcast compare of _tail_pairs_partials."""
    (na, wa), (nb, wb) = table_a.shape, table_b.shape
    n = sa.shape[0]
    step = max(1, PLAIN_ELEMS // max(wa * wb, 1))
    total = torch.zeros((), dtype=torch.int64, device=sa.device)
    for i0 in range(0, n, step):
        ia, ib = sa[i0:i0 + step], sb[i0:i0 + step]
        oka = (ia >= 0) & (ia < na)
        okb = (ib >= 0) & (ib < nb)
        ra = torch.where(oka[:, None], table_a[torch.where(oka, ia, 0)],
                         SENTINEL)
        rb = torch.where(okb[:, None], table_b[torch.where(okb, ib, 0)],
                         SENTINEL)
        m = (ra[:, :, None] == rb[:, None, :]) & (ra != SENTINEL)[:, :, None]
        total += m.sum()
    return total
