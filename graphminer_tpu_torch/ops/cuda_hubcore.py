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
The wrapper takes the plain version below only for CPU tensors; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from ..types import SENTINEL
from . import _build
from ._tensors import PLAIN_ELEMS, n_blocks, on_cuda, popcount32


def _check(src_rows, dst_rows, su, dv, words):
    if src_rows.dim() != 2 or dst_rows.dim() != 2 or \
            src_rows.shape[1] != dst_rows.shape[1] or \
            not 0 < words <= src_rows.shape[1] or su.dim() != 1 or \
            su.shape != dv.shape:
        raise ValueError(f"tail-count shapes disagree: src_rows "
                         f"{tuple(src_rows.shape)} dst_rows "
                         f"{tuple(dst_rows.shape)} su {tuple(su.shape)} dv "
                         f"{tuple(dv.shape)} words={words}")


def hub_tail_count(src_rows: torch.Tensor, dst_rows: torch.Tensor,
                   su: torch.Tensor, dv: torch.Tensor, *, words: int,
                   wa: int, wb: int) -> torch.Tensor:
    """Count of one tail group (int64 0-d tensor); see module docstring."""
    _check(src_rows, dst_rows, su, dv, words)
    if not on_cuda("hub_tail_count", src_rows, dst_rows, su, dv):
        return hub_tail_count_plain(src_rows, dst_rows, su, dv, words=words,
                                    wa=wa, wb=wb)
    row_w = src_rows.shape[1]
    if words % 4 or row_w % 4:
        raise ValueError(f"kernel reads 16-byte rows: words={words} and row "
                         f"width {row_w} must be multiples of 4")
    if src_rows.data_ptr() % 16 or dst_rows.data_ptr() % 16:
        raise ValueError("kernel reads 16-byte chunks: rows must be aligned")
    wt = row_w - words
    wa_, wb_ = min(wa, wt), min(wb, wt)
    if wa_ == 0 or wb_ == 0:
        wa_ = wb_ = 0                       # one side's tail empty: popcount
    n = su.shape[0]
    if n == 0:
        return torch.zeros((), dtype=torch.int64, device=su.device)
    lib = _build.kernels()
    nb = n_blocks(n * 32)                   # one warp per task
    out = torch.empty(nb, dtype=torch.int64, device=su.device)
    _build.check_launch(lib.gm_hub_tail_count(
        src_rows.data_ptr(), src_rows.shape[0], dst_rows.data_ptr(),
        dst_rows.shape[0], row_w, words, wa_, wb_, su.data_ptr(),
        dv.data_ptr(), n, out.data_ptr(), nb,
        torch.cuda.current_stream(su.device).cuda_stream), "hub_tail_count")
    hub_tail_count.launches += 1
    return out.sum()


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
