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
for m3 and 8 for m3b: the task rows a thread takes per step. Sums are int64
on the device and returned as int32 like the Pallas kernels' (a chunk's
count is at most cap * W * 32, checked below 2^31). A CUDA call is one
launch and no other device work: the kernel adds its block sums into a
per-stream workspace and its last block writes the int32 counts
(_tensors.workspace); a call with no tasks launches nothing and returns
zeros. The wrapper takes the plain version below only for CPU tensors;
for CUDA tensors it launches the kernel or raises.

The kernel reads the window's rows through L2 (see the .cu file): a
persistent grid takes contiguous task ranges, a lane group reads a task's
whole src row with streaming loads and its window row through L1.
"""
from __future__ import annotations

import torch

from . import _build
from ._tensors import BLOCK, PLAIN_ELEMS, on_cuda, popcount32, workspace

ROWS_PER_STEP = (1, 8)


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


def grid_blocks(n_tasks: int, w: int, wave: int) -> int:
    """Blocks of a window_count launch over n_tasks tasks of w words: one
    wave of the persistent grid, fewer when the tasks give fewer blocks a
    pass of task rows each."""
    return min(wave, max(1, n_tasks // (BLOCK // (w // 4))))


def window_count(src: torch.Tensor, table: torch.Tensor, starts: torch.Tensor,
                 lidx: torch.Tensor, *, span: int,
                 rows_per_step: int) -> torch.Tensor:
    """Per-chunk windowed AND + popcount, int32 [nck] (kernels m3, m3b);
    see module docstring."""
    _check(src, table, starts, lidx, span, rows_per_step)
    if not on_cuda("window_count", src, table, starts, lidx):
        return window_count_plain(src, table, starts, lidx, span=span)
    nck, cap, w = src.shape
    if w % 4 or w // 4 > BLOCK:
        raise ValueError(f"kernel reads rows of 16-byte chunks, at most "
                         f"{BLOCK} of them: W={w}")
    if src.data_ptr() % 16 or table.data_ptr() % 16 or lidx.data_ptr() % 4:
        raise ValueError("window_count: rows must be 16-byte aligned")
    if nck * cap >= 1 << 31:
        raise ValueError(f"window_count: nck * cap = {nck * cap} tasks "
                         f"exceed int32")
    dev = src.device
    if nck * cap == 0:
        return torch.zeros(nck, dtype=torch.int32, device=dev)
    stream = _build.stream(dev)
    ws = workspace(dev, stream, 1 + nck)
    out = torch.empty(nck, dtype=torch.int32, device=dev)
    nb = grid_blocks(nck * cap, w, _build.wave_blocks(
        "gm_window_count_blocks", dev.index, rows_per_step))
    _build.check_launch(_build.entry("gm_window_count")(
        src.data_ptr(), table.data_ptr(), table.shape[0], starts.data_ptr(),
        lidx.data_ptr(), nck, cap, w, span, rows_per_step, ws.data_ptr(),
        out.data_ptr(), nb, stream), "window_count")
    window_count.launches[rows_per_step] += 1
    return out


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
