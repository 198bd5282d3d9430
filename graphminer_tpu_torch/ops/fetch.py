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
silently). A CUDA call is one launch and no other device work: the kernel
sums, checks (a sum outside int32 is a device-side assert) and writes the
int32 row itself, with its int64 sums and finish counter in a per-stream
workspace that it leaves zero (_tensors.workspace). The plain version checks
with torch._assert_async, which raises on the CPU. An index outside [0, V)
adds nothing. n_buf is the depth of the kernel's load pipeline, as it was
the depth of the TPU kernel's DMA ring. The wrapper takes the plain version
below only for CPU tensors; for CUDA tensors it launches the kernel or
raises.

Left out: the enable_x64(False) scope (a Mosaic limit).
"""
from __future__ import annotations

import torch

from . import _build
from ._tensors import BLOCK, PLAIN_ELEMS, on_cuda, workspace

#: pipeline depths the kernel is built for
N_BUF = (1, 2, 4, 8, 16, 32)
_I32 = (-(1 << 31), (1 << 31) - 1)


def _check(idx: torch.Tensor, table: torch.Tensor, n_buf: int) -> None:
    if idx.dim() != 1 or table.dim() != 2:
        raise ValueError(f"fetch shapes: idx {tuple(idx.shape)} table "
                         f"{tuple(table.shape)}")
    if n_buf not in N_BUF:
        raise ValueError(f"n_buf={n_buf} not in {N_BUF}")


def lanes_of(w: int):
    """(vec, lanes): int32 a lane's load (4: 16-byte loads when W % 4 == 0,
    else 1) and lanes a row."""
    vec = 4 if w % 4 == 0 else 1
    return vec, w // vec


def grid_blocks(t: int, w: int, wave: int) -> int:
    """Blocks of a launch over t indices: one wave of the persistent grid,
    fewer when the indices give fewer blocks a row slot each."""
    return min(wave, max(1, -(-t // (BLOCK // lanes_of(w)[1]))))


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
    dev = idx.device
    if w == 0:
        return torch.zeros((1, 0), dtype=torch.int32, device=dev)
    vec, lanes = lanes_of(w)
    if lanes > BLOCK:
        raise ValueError(f"kernel takes rows of at most {4 * BLOCK} int32 "
                         f"(or {BLOCK} when W % 4 != 0): W={w}")
    tptr = table.data_ptr()
    if tptr % 16:
        raise ValueError("kernel reads 16-byte chunks: table must be aligned")
    t = idx.shape[0]
    stream = _build.stream(dev)
    nb = grid_blocks(t, w, _build.wave_blocks(
        "gm_fetch_rows_sum_blocks", dev.index, vec, n_buf))
    ws = workspace(dev, stream, 1 + w)
    out = torch.empty((1, w), dtype=torch.int32, device=dev)
    _build.check_launch(_build.entry("gm_fetch_rows_sum")(
        idx.data_ptr(), t, tptr, v, w, n_buf, ws.data_ptr(), out.data_ptr(),
        nb, stream), "fetch_rows_sum")
    fetch_rows_sum.launches += 1
    return out


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
