"""Kernels B and C — the ring engine's counts (csrc/ring_phase_c.cu,
csrc/ring_tail_pairs.cu).

B, ring_phase_c, is the port of the Pallas kernel
graphminer_tpu/ops/pallas_ring.py::_kernel (and of its XLA twin
ops/ring.py::_cbucket_partials): Σ_r Σ_s popcount(src_bm[r] &
table[dst_loc[r, s]]), where a slot outside [0, rows of table) gives 0. It
serves phase C (table = the core bitmaps) and the phase-T bitmap pass
(table = the dense bm_table).

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
from ._tensors import PLAIN_ELEMS, n_blocks, on_cuda, popcount32
from ._tiles import plan_tiles


def ring_phase_c(table: torch.Tensor, src_bm: torch.Tensor,
                 dst_loc: torch.Tensor) -> torch.Tensor:
    """Σ popcount(src_bm[r] & table[dst_loc[r, s]]) over valid slots."""
    n, words = src_bm.shape
    if table.dim() != 2 or table.shape[1] != words or \
            dst_loc.dim() != 2 or dst_loc.shape[0] != n:
        raise ValueError(f"phase-C shapes disagree: table {tuple(table.shape)}"
                         f" src_bm {tuple(src_bm.shape)} dst_loc "
                         f"{tuple(dst_loc.shape)}")
    if not on_cuda("ring_phase_c", table, src_bm, dst_loc):
        return ring_phase_c_plain(table, src_bm, dst_loc)
    wc = dst_loc.shape[1]
    if n == 0 or wc == 0:
        return torch.zeros((), dtype=torch.int64, device=src_bm.device)
    lib = _build.kernels()
    nb = n_blocks(n * 32)                      # one warp per src row
    out = torch.empty(nb, dtype=torch.int64, device=src_bm.device)
    _build.check_launch(lib.gm_ring_phase_c(
        table.data_ptr(), table.shape[0], src_bm.data_ptr(),
        dst_loc.data_ptr(), n, words, wc, out.data_ptr(), nb,
        torch.cuda.current_stream(src_bm.device).cuda_stream),
        "ring_phase_c")
    ring_phase_c.launches += 1
    return out.sum()


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
    lib = _build.kernels()
    nb = min(plan.n_tiles, _build.wave_blocks(
        "gm_ring_tail_pairs_blocks", torch.cuda.current_device(),
        plan.region))
    out = torch.empty(nb, dtype=torch.int64, device=dev)
    tiles = plan.table.data_ptr() + len(plan.groups) * TAIL_BREC * 8
    _build.check_launch(lib.gm_ring_tail_pairs(
        plan.table.data_ptr(), tiles, plan.n_tiles, plan.region,
        out.data_ptr(), nb, torch.cuda.current_stream(dev).cuda_stream),
        "ring_tail_pairs")
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
