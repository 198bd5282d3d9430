"""Kernel E — the hub-core engine's tail count (csrc/hub_tail_count.cu).

Replaces the XLA code graphminer_tpu/ops/hubcore.py::_gather_rows,
_chunk_counts and _tail_partials: torch has no popcount op, so the port
counts with a hand-written kernel, as it does for kernels A and C. For one
bucket group (wa, wb) of TriangleEngine's tail tasks over the deduplicated
row tables (TailTables),

    src_rows, dst_rows  int32 [N, words + wt_pad]   bitmap words | sorted tail
    su, dv              int32 [n]                    task row ids

it returns, as an int64 0-d tensor on the inputs' device,

    Σ_i popcount(src_rows[su_i, :words] & dst_rows[dv_i, :words])
        + |{x ∈ src_rows[su_i, words:words+wa'], x != SENTINEL}
           ∩ dst_rows[dv_i, words:words+wb']|

where wa' = min(wa, wt_pad) and wb' = min(wb, wt_pad): a width class can be
wider than the stored tail (at rmat18 class 64 against wt_pad 48), and the
JAX slice table[:, :words + wa] clamps silently, so both versions clamp too.
A task id outside its table (the SENTINEL padding of pack_groups) gives 0.

One launch counts every group of an engine: plan_tail_count builds, once
per engine, a tile table in device memory (ops/_tiles.py) and
hub_tail_count_all launches E once over it (int64 partials whose sum is the
count). hub_tail_count is the one-group call of the same kernel. Both count
their launches on hub_tail_count.launches. The wrappers take the plain
versions only for CPU tensors; for CUDA tensors they launch or raise.
"""
from __future__ import annotations

import dataclasses
import types
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..types import SENTINEL
from . import _build
from ._tensors import PLAIN_ELEMS, on_cuda, popcount32
from ._tiles import plan_tiles

#: tasks per tile of kernel E: ~3,100 tiles over the 784,532 rmat18 tail
#: tasks, several for each block of the persistent grid
TAIL_TILE = 256
#: fields of a tail-group record: su, dv, wa, wb (csrc/hub_tail_count.cu
#: reads them in this order)
TAIL_BREC = 4


def _check(src_rows, dst_rows, su, dv, words):
    if src_rows.dim() != 2 or dst_rows.dim() != 2 or \
            src_rows.shape[1] != dst_rows.shape[1] or \
            not 0 < words <= src_rows.shape[1] or su.dim() != 1 or \
            su.shape != dv.shape:
        raise ValueError(f"tail-count shapes disagree: src_rows "
                         f"{tuple(src_rows.shape)} dst_rows "
                         f"{tuple(dst_rows.shape)} su {tuple(su.shape)} dv "
                         f"{tuple(dv.shape)} words={words}")


def clamp_widths(wa: int, wb: int, wt: int) -> Tuple[int, int]:
    """The tail widths a group reads: each class clamped to the stored tail
    width wt, and both 0 when either side's tail is empty (popcount only)."""
    wa_, wb_ = min(wa, wt), min(wb, wt)
    return (0, 0) if wa_ == 0 or wb_ == 0 else (wa_, wb_)


@dataclasses.dataclass(frozen=True)
class TailCountPlan:
    """An engine's tail groups and their tile table, on the tables' device.
    groups holds (su, dv, wa, wb) per group, flat task ids and the class
    widths as the engine gives them; the table holds raw pointers, so the
    plan keeps the tensors referenced for as long as it lives."""
    src_rows: torch.Tensor
    dst_rows: torch.Tensor
    words: int
    groups: Tuple[Tuple[torch.Tensor, torch.Tensor, int, int], ...]
    table: Optional[torch.Tensor]  # int64 [n*TAIL_BREC + n_tiles*TREC]
    n_tiles: int


def tail_count_shapes(groups, ns: int, nd: int,
                      wt: int) -> List[Tuple[int, int, int]]:
    """(tasks, wa, wb) per group (su, dv, wa, wb) as kernel E walks it: the
    widths clamped to the stored tail width wt (clamp_widths), the tasks cut
    after the last one whose ids both lie inside their tables (the rest,
    pack_groups' SENTINEL padding, count 0; the ids are read once)."""
    out = []
    for su, dv, wa, wb in groups:
        ok = (su >= 0) & (su < ns) & (dv >= 0) & (dv < nd)
        pos = torch.nonzero(ok)
        out.append((int(pos[-1]) + 1 if pos.numel() else 0,
                    *clamp_widths(wa, wb, wt)))
    return out


def plan_tail_count(tables, group_arrays, spec, words: int) -> TailCountPlan:
    """The plan of an engine's tail groups: tables has src_rows and
    dst_rows (TailTables); group_arrays and spec are pack_groups' output
    ((su, dv) chunk arrays and (wa, wb, chunk) per group). For CUDA tensors
    it clamps each group's widths, drops the trailing tasks whose ids lie
    outside the tables (pack_groups' SENTINEL padding; read once), tiles the
    rest and copies the table to the card once."""
    src_rows, dst_rows = tables.src_rows, tables.dst_rows
    groups = tuple((s.reshape(-1), d.reshape(-1), int(wa), int(wb))
                   for (s, d), (wa, wb, *_) in zip(group_arrays, spec))
    for su, dv, _, _ in groups:
        _check(src_rows, dst_rows, su, dv, words)
    tensors = [src_rows, dst_rows] + [t for g in groups for t in g[:2]]
    if not on_cuda("hub_tail_count_all", *tensors):
        return TailCountPlan(src_rows, dst_rows, words, groups, None, 0)
    row_w = src_rows.shape[1]
    if words % 4 or row_w % 4:
        raise ValueError(f"kernel reads 16-byte rows: words={words} and row "
                         f"width {row_w} must be multiples of 4")
    if src_rows.data_ptr() % 16 or dst_rows.data_ptr() % 16:
        raise ValueError("kernel reads 16-byte chunks: rows must be aligned")
    shapes = tail_count_shapes(groups, src_rows.shape[0], dst_rows.shape[0],
                               row_w - words)
    recs = np.array([(su.data_ptr(), dv.data_ptr(), wa, wb) for
                     (su, dv, _, _), (_, wa, wb) in zip(groups, shapes)],
                    np.int64).reshape(-1, TAIL_BREC)
    tiles = plan_tiles([n for n, _, _ in shapes], [1] * len(shapes),
                       TAIL_TILE)
    table = torch.from_numpy(np.concatenate([recs.reshape(-1),
                                             tiles.reshape(-1)]))
    return TailCountPlan(src_rows, dst_rows, words, groups,
                         table.to(src_rows.device), tiles.shape[0])


def hub_tail_count_all(plan: TailCountPlan) -> torch.Tensor:
    """Kernel E over every group of `plan` in one launch: int64 [n] partial
    counts on the tables' device whose sum is the count (one per block). On
    the CPU, the plain version."""
    if plan.table is None:
        return hub_tail_count_all_plain(plan)
    dev = plan.src_rows.device
    if plan.n_tiles == 0:
        return torch.zeros(1, dtype=torch.int64, device=dev)
    nb = min(plan.n_tiles, _build.wave_blocks(
        "gm_hub_tail_count_blocks", dev.index))
    out = torch.empty(nb, dtype=torch.int64, device=dev)
    sr, dr = plan.src_rows, plan.dst_rows
    tiles = plan.table.data_ptr() + len(plan.groups) * TAIL_BREC * 8
    _build.check_launch(_build.entry("gm_hub_tail_count")(
        sr.data_ptr(), sr.shape[0], dr.data_ptr(), dr.shape[0], sr.shape[1],
        plan.words, plan.table.data_ptr(), tiles, plan.n_tiles,
        out.data_ptr(), nb, _build.stream(dev)),
        "hub_tail_count")
    hub_tail_count.launches += 1
    return out


def hub_tail_count_all_plain(plan: TailCountPlan) -> torch.Tensor:
    """Plain version of hub_tail_count_all: the sum of the per-group plain
    counts, as an int64 [1] tensor."""
    total = torch.zeros(1, dtype=torch.int64, device=plan.src_rows.device)
    for su, dv, wa, wb in plan.groups:
        total += hub_tail_count_plain(plan.src_rows, plan.dst_rows, su, dv,
                                      words=plan.words, wa=wa, wb=wb)
    return total


def hub_tail_count(src_rows: torch.Tensor, dst_rows: torch.Tensor,
                   su: torch.Tensor, dv: torch.Tensor, *, words: int,
                   wa: int, wb: int) -> torch.Tensor:
    """Count of one tail group (int64 0-d tensor), the one-group call of
    kernel E; see the module docstring."""
    _check(src_rows, dst_rows, su, dv, words)
    if not on_cuda("hub_tail_count", src_rows, dst_rows, su, dv):
        return hub_tail_count_plain(src_rows, dst_rows, su, dv, words=words,
                                    wa=wa, wb=wb)
    tables = types.SimpleNamespace(src_rows=src_rows, dst_rows=dst_rows)
    return hub_tail_count_all(plan_tail_count(
        tables, [(su, dv)], [(wa, wb)], words)).sum()


hub_tail_count.launches = 0


def _gather_rows(table: torch.Tensor, ids: torch.Tensor, width: int,
                 words: int):
    """[B, width] prefix rows (width clamped to the table's); invalid ids
    give bitmap part 0 and tail part SENTINEL, so they add exactly 0
    (hubcore.py::_gather_rows)."""
    v = table.shape[0]
    ok = (ids >= 0) & (ids < v)
    rows = table[:, :width][torch.where(ok, ids, 0)]
    bm = torch.where(ok[:, None], rows[:, :words], 0)
    if rows.shape[1] > words:
        return bm, torch.where(ok[:, None], rows[:, words:], SENTINEL)
    return bm, None


def hub_tail_count_plain(src_rows: torch.Tensor, dst_rows: torch.Tensor,
                         su: torch.Tensor, dv: torch.Tensor, *, words: int,
                         wa: int, wb: int) -> torch.Tensor:
    """Plain PyTorch version of hub_tail_count (any device): the gathers,
    AND + popcount and SENTINEL-masked broadcast compare of _chunk_counts,
    in task chunks."""
    _check(src_rows, dst_rows, su, dv, words)
    n = su.shape[0]
    step = max(1, PLAIN_ELEMS // max(words, wa * wb, 1))
    total = torch.zeros((), dtype=torch.int64, device=su.device)
    for i0 in range(0, n, step):
        bmu, tu = _gather_rows(src_rows, su[i0:i0 + step], words + wa, words)
        bmv, tv = _gather_rows(dst_rows, dv[i0:i0 + step], words + wb, words)
        total += popcount32(bmu & bmv).sum()
        if tu is not None and tv is not None:
            m = (tu[:, :, None] == tv[:, None, :]).any(dim=-1) & \
                (tu != SENTINEL)
            total += m.sum()
    return total
