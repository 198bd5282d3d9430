"""Kernel A — the stream engine's count (csrc/stream_count.cu).

Replaces graphminer_tpu/ops/stream.py::_bucket_counts_fused, which XLA
fused into one broadcast-reduce per bucket, all buckets in one dispatch
(_stream_partials); torch has no popcount op, so the port counts with a
hand-written kernel. For one bucket

    dst_rows int32 [n, ws + wt]           bitmap words | sorted dst tail
    src_rows int32 [n, width, ws + wta]   bitmap words | src tail

the count is

    Σ_r Σ_s popcount(dst[r, :ws] & src[r, s, :ws])
          + |{non-SENTINEL x ∈ src[r, s, ws:]} ∩ dst[r, ws:]|   (wtv > 0)

wt <= wtv: the tail class wtv may be wider than the layout's physical tail
width, and a dst row then keeps every physical tail slot (wtv == 0 means
wt == 0). Tails are sorted ascending and SENTINEL padded, with no repeated
id, as build_stream makes them.

One launch counts every bucket of a layout: plan_stream builds, once per
layout, a tile table in device memory (ops/_tiles.py) and stream_count_all
launches the kernel once over it. stream_bucket_count is the one-bucket call
of the same kernel. Both count their launches on stream_bucket_count.launches.
The wrappers take the plain versions only for CPU tensors; for CUDA tensors
they launch the kernel or raise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..types import SENTINEL
from . import _build
from ._tensors import PLAIN_ELEMS, on_cuda, popcount32
from ._tiles import fastdiv, plan_tiles

#: 16-byte src chunks per tile (128 KB): ~16,000 tiles over the 2.1 GB
#: rmat18 stream, enough for every block of the persistent grid to take
#: several, and small enough that most wide buckets' dst rows of a tile fit
#: the kernel's staging buffer
TILE_CHUNKS = 1 << 13
#: fields of a bucket record: dst, src, per_row (d, m, s), q_src (d, m, s),
#: q_dst, q_ws, wtv (csrc/stream_count.cu reads them in this order)
BREC = 11


def plan_stream_shapes(shapes: Sequence[Tuple[int, int, int, int, int]]):
    """(bucket records int64 [n, BREC] with null pointers, tile records int64
    [n_tiles, TREC]) for buckets of shape (n_rows, width, ws, wtv, wta),
    widths in int32 words. Shapes only: nothing is allocated."""
    recs = np.zeros((len(shapes), BREC), np.int64)
    units, per_row = [], []
    for i, (n_rows, width, ws, wtv, wta) in enumerate(shapes):
        if ws <= 0 or ws % 4 or wtv % 4 or wta % 4:
            raise ValueError(f"kernel reads 4-word chunks: ws={ws} wtv={wtv} "
                             f"wta={wta} must be multiples of 4 (ws > 0)")
        q_src = (ws + wta) // 4
        pr = int(width) * q_src
        recs[i, 2:5] = fastdiv(max(pr, 1))
        recs[i, 5:8] = fastdiv(q_src)
        recs[i, 8:11] = ((ws + wtv) // 4, ws // 4, wtv)
        units.append(int(n_rows) * pr)
        per_row.append(max(pr, 1))
    return recs, plan_tiles(units, per_row, TILE_CHUNKS)


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """A layout's buckets and their tile table, on the buckets' device. The
    table holds the buckets' raw pointers, so the plan keeps the bucket
    tensors referenced for as long as it lives."""
    buckets: Tuple[Tuple[torch.Tensor, torch.Tensor, int, int], ...]
    table: Optional[torch.Tensor]   # int64 [n_buckets*BREC + n_tiles*TREC]
    n_tiles: int
    device: torch.device


def _check_bucket(dst_rows, src_rows, ws, wtv):
    n, width, row_w = src_rows.shape
    if dst_rows.dim() != 2 or dst_rows.shape[0] != n or row_w < ws or \
            not ws <= dst_rows.shape[1] <= ws + wtv:
        raise ValueError(f"bucket shapes disagree: dst {tuple(dst_rows.shape)}"
                         f" src {tuple(src_rows.shape)} ws={ws} wtv={wtv}")


def plan_stream(buckets: Sequence[Tuple[torch.Tensor, torch.Tensor, int, int]],
                device=None) -> StreamPlan:
    """The plan of one layout: buckets are (dst_rows, src_rows, ws, wtv),
    all on one device (`device` names it when there is no bucket). For CUDA
    buckets it builds the tile table and copies it to the card once."""
    buckets = tuple((d, s, int(ws), int(wtv)) for d, s, ws, wtv in buckets)
    for d, s, ws, wtv in buckets:
        _check_bucket(d, s, ws, wtv)
    tensors = [t for d, s, _, _ in buckets for t in (d, s)]
    if not tensors:
        return StreamPlan((), None, 0, torch.device(device or "cpu"))
    if not on_cuda("stream_count_all", *tensors):
        return StreamPlan(buckets, None, 0, tensors[0].device)
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("kernel reads 16-byte chunks: rows must be "
                             "aligned")
    # the tail columns actually stored (a class may be wider)
    recs, tiles = plan_stream_shapes(
        [(s.shape[0], s.shape[1], ws, d.shape[1] - ws, s.shape[2] - ws)
         for d, s, ws, _ in buckets])
    recs[:, 0] = [d.data_ptr() for d, _, _, _ in buckets]
    recs[:, 1] = [s.data_ptr() for _, s, _, _ in buckets]
    table = torch.from_numpy(np.concatenate([recs.reshape(-1),
                                             tiles.reshape(-1)]))
    return StreamPlan(buckets, table.to(tensors[0].device), tiles.shape[0],
                      tensors[0].device)


def stream_count_all(plan: StreamPlan) -> torch.Tensor:
    """Kernel A over every bucket of `plan` in one launch: int64 [n] partial
    counts on the plan's device whose sum is the count (one per block). On
    the CPU, the plain version."""
    if plan.table is None:
        return stream_count_all_plain(plan)
    dev = plan.device
    if plan.n_tiles == 0:
        return torch.zeros(1, dtype=torch.int64, device=dev)
    nb = min(plan.n_tiles, _build.wave_blocks(
        "gm_stream_count_blocks", dev.index))
    out = torch.empty(nb, dtype=torch.int64, device=dev)
    tiles = plan.table.data_ptr() + len(plan.buckets) * BREC * 8
    _build.check_launch(_build.entry("gm_stream_count")(
        plan.table.data_ptr(), tiles, plan.n_tiles, out.data_ptr(), nb,
        _build.stream(dev)), "stream_count")
    stream_bucket_count.launches += 1
    return out


def stream_count_all_plain(plan: StreamPlan) -> torch.Tensor:
    """Plain version of stream_count_all: the sum of the per-bucket plain
    counts, as an int64 [1] tensor."""
    total = torch.zeros(1, dtype=torch.int64, device=plan.device)
    for d, s, ws, wtv in plan.buckets:
        total += stream_bucket_count_plain(d, s, ws=ws, wtv=wtv)
    return total


def stream_bucket_count(dst_rows: torch.Tensor, src_rows: torch.Tensor, *,
                        ws: int, wtv: int) -> torch.Tensor:
    """Count of one stream bucket (int64 0-d tensor), the one-bucket call of
    kernel A; see the module docstring."""
    _check_bucket(dst_rows, src_rows, ws, wtv)
    if not on_cuda("stream_bucket_count", dst_rows, src_rows):
        return stream_bucket_count_plain(dst_rows, src_rows, ws=ws, wtv=wtv)
    return stream_count_all(plan_stream([(dst_rows, src_rows, ws, wtv)])).sum()


stream_bucket_count.launches = 0


def stream_bucket_count_plain(dst_rows: torch.Tensor, src_rows: torch.Tensor,
                              *, ws: int, wtv: int) -> torch.Tensor:
    """Plain PyTorch version of stream_bucket_count (any device): the
    broadcast AND+popcount and the SENTINEL-masked broadcast tail compare of
    _bucket_counts_fused, in row chunks."""
    n, width, row_w = src_rows.shape
    wta = row_w - ws
    per_row = width * max(ws, wta * max(wtv, 1), 1)
    step = max(1, PLAIN_ELEMS // per_row)
    total = torch.zeros((), dtype=torch.int64, device=dst_rows.device)
    for r0 in range(0, n, step):
        d = dst_rows[r0:r0 + step]
        s = src_rows[r0:r0 + step]
        total += popcount32(d[:, None, :ws] & s[:, :, :ws]).sum()
        if wtv and wta:
            ta = s[:, :, ws:]                     # [r, width, wta]
            tb = d[:, ws:]                        # [r, wtv]
            m = (ta[:, :, :, None] == tb[:, None, None, :]) & \
                (ta != SENTINEL)[:, :, :, None]
            total += m.sum()
    return total
