"""Chunked task-list execution.

The counterpart of graphminer_tpu/utils/exec.py. The reference streams work
as warp-strided loops over a COO edge list (e.g. clique4_warp_edge.cuh:14).
Here the task list is padded to a multiple of a chunk size and a Python loop
applies a chunk function to one [chunk]-row slice at a time, on the tasks'
device: memory stays bounded by one chunk whatever E is. Padded tasks carry
SENTINEL and add 0. Sums accumulate in int64 on the device; the caller reads
the total back once.

Left out: lax.map and its fixed shapes (torch runs each chunk eagerly).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..types import SENTINEL, cdiv


def pad_to_chunks(arrays: Sequence[torch.Tensor], chunk: int,
                  fill=SENTINEL):
    """Pad 1-D task tensors to a chunk multiple and reshape each to
    [n_chunks, chunk] (at least one chunk)."""
    n = arrays[0].shape[0]
    n_chunks = max(1, cdiv(n, chunk))
    pad = n_chunks * chunk - n
    out = []
    for x in arrays:
        if pad:
            x = torch.cat([x, x.new_full((pad,), int(fill))])
        out.append(x.reshape(n_chunks, chunk))
    return tuple(out)


def map_chunked(fn: Callable, arrays: Sequence[torch.Tensor], chunk: int):
    """Apply fn chunk by chunk and concatenate the per-task results.

    fn maps chunk-shaped tensors to per-task values [chunk] (or [chunk,
    ...]). The padding rows stay in the result; callers slice [:n_tasks]."""
    chunks = pad_to_chunks(arrays, chunk)
    return torch.cat([fn(*xs) for xs in zip(*chunks)])


def sum_chunked(count_fn: Callable, arrays: Sequence[torch.Tensor],
                chunk: int) -> torch.Tensor:
    """Σ over tasks of count_fn(*task_chunk), int64 on the tasks' device.

    count_fn maps chunk-shaped task tensors to per-task counts [chunk].
    Padded tasks carry SENTINEL and must contribute 0. Returns an int64 0-d
    tensor."""
    chunks = pad_to_chunks(arrays, chunk)
    total = torch.zeros((), dtype=torch.int64, device=arrays[0].device)
    for xs in zip(*chunks):
        total += count_fn(*xs).to(torch.int64).sum()
    return total
