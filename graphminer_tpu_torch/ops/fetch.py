"""Kernel D — row fetch and sum (csrc/fetch_rows_sum.cu).

The counterpart of graphminer_tpu/ops/pallas_fetch.py, whose Pallas kernel
_fetch_sum_kernel keeps n_buf row DMAs in flight and sums the rows that an
index list names; it calibrates the random-row gather rate
(scripts/prof_breakdown.py and its port,
graphminer_tpu_torch/scripts/prof_breakdown.py). Here:

    fetch_rows_sum(idx int32 [T], table int32 [V, W], n_buf) -> int32 [1, W]
        = Σ_i table[idx[i]]

Sums are taken in int64 and the result is returned as int32 like the JAX
entry's, after a check that it fits (the TPU kernel's int32 sum wrapped
silently). The check is torch._assert_async: it does not wait for the
device, and a failure raises on the CPU or is a device-side assert on the
card. An index outside [0, V) adds nothing. n_buf is the depth of the
kernel's load pipeline, as it was the depth of the TPU kernel's DMA ring.
The wrapper takes the plain version below only for CPU tensors; for CUDA
tensors it launches the kernel or raises.

Left out: the enable_x64(False) scope (a Mosaic limit).
"""
from __future__ import annotations

import torch

from . import _build
from ._tensors import BLOCK, PLAIN_ELEMS, n_blocks, on_cuda

#: pipeline depths the kernel is built for
N_BUF = (1, 2, 4, 8, 16, 32)
_I32 = (-(1 << 31), (1 << 31) - 1)


def _check(idx: torch.Tensor, table: torch.Tensor, n_buf: int) -> None:
    if idx.dim() != 1 or table.dim() != 2:
        raise ValueError(f"fetch shapes: idx {tuple(idx.shape)} table "
                         f"{tuple(table.shape)}")
    if n_buf not in N_BUF:
        raise ValueError(f"n_buf={n_buf} not in {N_BUF}")


def _to_int32(sums: torch.Tensor) -> torch.Tensor:
    """int64 [W] column sums -> int32 [1, W]; fails if a sum would wrap."""
    torch._assert_async(((sums >= _I32[0]) & (sums <= _I32[1])).all(),
                        "fetch_rows_sum: a column sum leaves int32")
    return sums.to(torch.int32)[None, :]


def fetch_rows_sum(idx: torch.Tensor, table: torch.Tensor,
                   n_buf: int = 8) -> torch.Tensor:
    """Σ_i table[idx[i]] as int32 [1, W]; see module docstring."""
    _check(idx, table, n_buf)
    if not on_cuda("fetch_rows_sum", idx, table):
        return fetch_rows_sum_plain(idx, table)
    v, w = table.shape
    chunks = w // 4 if w % 4 == 0 else w          # threads per row
    if chunks > BLOCK:
        raise ValueError(f"kernel takes rows of at most {4 * BLOCK} int32 "
                         f"(or {BLOCK} when W % 4 != 0): W={w}")
    if table.data_ptr() % 16:
        raise ValueError("kernel reads 16-byte chunks: table must be aligned")
    t = idx.shape[0]
    nb = n_blocks(t * chunks)
    out = torch.empty((nb, w), dtype=torch.int64, device=idx.device)
    _build.check_launch(_build.kernels().gm_fetch_rows_sum(
        idx.data_ptr(), t, table.data_ptr(), v, w, n_buf, out.data_ptr(), nb,
        torch.cuda.current_stream(idx.device).cuda_stream), "fetch_rows_sum")
    fetch_rows_sum.launches += 1
    return _to_int32(out.sum(dim=0))


fetch_rows_sum.launches = 0


def fetch_rows_sum_plain(idx: torch.Tensor, table: torch.Tensor,
                         n_buf: int = 8) -> torch.Tensor:
    """Plain PyTorch version of fetch_rows_sum (any device): gather and sum
    in int64, in index chunks. n_buf has no meaning here."""
    _check(idx, table, n_buf)
    v, w = table.shape
    step = max(1, PLAIN_ELEMS // max(w, 1))
    total = torch.zeros(w, dtype=torch.int64, device=idx.device)
    for i0 in range(0, idx.shape[0], step):
        ix = idx[i0:i0 + step]
        ok = (ix >= 0) & (ix < v)
        rows = table[torch.where(ok, ix, 0)].to(torch.int64)
        total += (rows * ok[:, None]).sum(dim=0)
    return _to_int32(total)
