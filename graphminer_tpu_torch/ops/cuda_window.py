"""Kernels m3 and m3b — windowed row reads (csrc/window_count.cu).

Ports of the two Pallas kernels of scripts/prof_window.py, _kernel (m3) and
_kernel8 (m3b), the probe of how fast a chunk of dst-sorted tasks can read
its dst rows when they all lie in a small contiguous window of the table:

    window_count(src int32 [nck, cap, W], table int32 [ND, W],
                 starts int32 [nck], lidx int32 [nck, cap],
                 *, span, rows_per_step) -> int32 [nck]
    out[c] = Σ_t popcount(src[c, t] & table[s_c + lidx[c, t]])

with s_c = starts[c] clamped to [0, ND - span] as jax.lax.dynamic_slice
clamps it; a local index outside [0, span) adds nothing. rows_per_step is 1
for m3 and 8 for m3b. Sums are int64 on the device and returned as int32
like the Pallas kernels' (a chunk's count is at most cap * W * 32, checked
below 2^31). The wrapper takes the plain version below only for CPU
tensors; for CUDA tensors it launches the kernel or raises.

The window is staged in shared memory in column slices (see the .cu file):
WINDOW_SMEM bounds a slice, so span * 4 bytes must fit it.
"""
from __future__ import annotations

import torch

from . import _build
from ._tensors import PLAIN_ELEMS, on_cuda, popcount32

ROWS_PER_STEP = (1, 8)
#: shared memory one block stages (two blocks share an SM at this size)
WINDOW_SMEM = 96 * 1024


def _check(src, table, starts, lidx, span, rows_per_step):
    nck, cap, w = src.shape
    if table.dim() != 2 or table.shape[1] != w or \
            starts.shape != (nck,) or lidx.shape != (nck, cap):
        raise ValueError(f"window shapes disagree: src {tuple(src.shape)} "
                         f"table {tuple(table.shape)} starts "
                         f"{tuple(starts.shape)} lidx {tuple(lidx.shape)}")
    if not 0 < span <= table.shape[0]:
        raise ValueError(f"span={span} outside 1..{table.shape[0]}")
    if rows_per_step not in ROWS_PER_STEP:
        raise ValueError(f"rows_per_step={rows_per_step} not in "
                         f"{ROWS_PER_STEP}")
    if cap * w * 32 >= 1 << 31:
        raise ValueError(f"a chunk's count may leave int32: cap={cap} w={w}")


def slice_width(w: int, span: int) -> int:
    """Columns of the window one block stages: all w when span * w int32 fit
    WINDOW_SMEM, else the widest power of two (>= 4) dividing w that does."""
    if w % 4:
        raise ValueError(f"kernel reads 16-byte chunks: W={w} % 4 != 0")
    if span * w * 4 <= WINDOW_SMEM:
        return w
    wb = 4
    while w % (wb * 2) == 0 and span * wb * 2 * 4 <= WINDOW_SMEM:
        wb *= 2
    if span * wb * 4 > WINDOW_SMEM:
        raise ValueError(f"a {span}-row window slice of {wb} columns exceeds "
                         f"{WINDOW_SMEM} bytes of shared memory")
    return wb


def window_count(src: torch.Tensor, table: torch.Tensor, starts: torch.Tensor,
                 lidx: torch.Tensor, *, span: int,
                 rows_per_step: int) -> torch.Tensor:
    """Per-chunk windowed AND + popcount, int32 [nck]; see module docstring."""
    _check(src, table, starts, lidx, span, rows_per_step)
    if not on_cuda("window_count", src, table, starts, lidx):
        return window_count_plain(src, table, starts, lidx, span=span)
    nck, cap, w = src.shape
    wb = slice_width(w, span)
    if src.data_ptr() % 16 or table.data_ptr() % 16:
        raise ValueError("kernel reads 16-byte chunks: rows must be aligned")
    if nck > 65535:
        raise ValueError(f"nck={nck} exceeds the grid's y dimension")
    out = torch.empty((nck, w // wb), dtype=torch.int64, device=src.device)
    if nck == 0:
        return out.sum(dim=1).to(torch.int32)
    _build.check_launch(_build.kernels().gm_window_count(
        src.data_ptr(), table.data_ptr(), table.shape[0], starts.data_ptr(),
        lidx.data_ptr(), nck, cap, w, span, wb, rows_per_step, out.data_ptr(),
        torch.cuda.current_stream(src.device).cuda_stream), "window_count")
    window_count.launches[rows_per_step] += 1
    return out.sum(dim=1).to(torch.int32)


#: launches by rows_per_step: 1 is kernel m3, 8 is kernel m3b
window_count.launches = {r: 0 for r in ROWS_PER_STEP}


def window_count_plain(src: torch.Tensor, table: torch.Tensor,
                       starts: torch.Tensor, lidx: torch.Tensor, *,
                       span: int, rows_per_step: int = 1) -> torch.Tensor:
    """Plain PyTorch version of window_count (any device; rows_per_step has
    no meaning here): clamped window start, row gather, AND + popcount, in
    chunk groups."""
    _check(src, table, starts, lidx, span, rows_per_step)
    nck, cap, w = src.shape
    nd = table.shape[0]
    step = max(1, PLAIN_ELEMS // max(cap * w, 1))
    outs = []
    for c0 in range(0, nck, step):
        st = starts[c0:c0 + step].clamp(0, nd - span)
        li = lidx[c0:c0 + step]
        ok = (li >= 0) & (li < span)
        rows = table[st[:, None] + torch.where(ok, li, 0)]  # [k, cap, w]
        pc = popcount32(src[c0:c0 + step] & rows).sum(dim=2)
        outs.append((pc * ok).sum(dim=1))
    if not outs:
        return torch.zeros(0, dtype=torch.int32, device=src.device)
    return torch.cat(outs).to(torch.int32)
