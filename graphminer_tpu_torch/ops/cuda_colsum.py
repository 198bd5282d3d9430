"""Kernel W — bit column sums over each task's sub-core neighbours
(csrc/bit_colsum.cu), the wsub term of the rectangle engine's case B
(ops/rectangle.py).

Replaces the XLA path in graphminer_tpu/ops/rectangle.py::_case_b
(:149-158: gathered, SENTINEL-padded FT rows in width classes, their int8
bit expansion and a sum over the list axis; torch has no unpackbits); the
same sum is house's WS (graphminer_tpu/ops/house.py::_ws_bucket). For task
i < n,

    out[i, 32 j + b] = Σ_{x ∈ FT(u_i)} bit b of tab[x, j]

with tab int32 [V, words] read as uint32 (bit 31 is a real bit) and FT the
lists of ops/cuda_tri.FtLists, read in place as the prefixes of the sorted
CSR rows. An id outside [0, V) adds 0; a u_i outside [0, V) gives a zero
row. out is int32 [n, 32 words].

Each call with a task is one launch, counted on bit_colsum.launches; a
call with none launches nothing. On a CUDA tensor the wrapper launches the
kernel or raises; it takes the plain version only for CPU tensors.
"""
from __future__ import annotations

import torch

from ..types import round_up
from . import _build
from ._tensors import GRID_CAP, PLAIN_ELEMS, on_cuda
from .cuda_tri import FtLists


def _check(tab: torch.Tensor, u: torch.Tensor) -> None:
    if tab.dim() != 2 or u.dim() != 1:
        raise ValueError(f"bit_colsum: tab {tuple(tab.shape)} must be 2-D "
                         f"and u {tuple(u.shape)} 1-D")


def bit_colsum(ft: FtLists, tab: torch.Tensor,
               u: torch.Tensor) -> torch.Tensor:
    """Kernel W: int32 [n, 32 words]; see the module docstring."""
    _check(tab, u)
    cuda = ft.check("bit_colsum")
    if on_cuda("bit_colsum", tab, u) != cuda:
        raise ValueError("bit_colsum: tensors on several devices")
    if not cuda:
        return bit_colsum_plain(ft, tab, u)
    n, words = u.shape[0], tab.shape[1]
    out = torch.empty((n, 32 * words), dtype=torch.int32, device=tab.device)
    if n == 0 or words == 0:
        return out
    _build.check_launch(_build.entry("gm_bit_colsum")(
        ft.rowptr.data_ptr(), ft.colidx.data_ptr(), ft.ftw.data_ptr(),
        tab.data_ptr(), tab.shape[0], words, u.data_ptr(), n, out.data_ptr(),
        min(n, GRID_CAP), min(256, round_up(words, 32)),
        _build.stream(tab.device)), "bit_colsum")
    bit_colsum.launches += 1
    return out


bit_colsum.launches = 0


def bit_colsum_plain(ft: FtLists, tab: torch.Tensor,
                     u: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of bit_colsum (any device): every list slot's
    row, shifted and & 1 (bit b of an int32 word whatever its sign), added
    into its task's row (index_add_), in slot chunks."""
    _check(tab, u)
    v, words = tab.shape
    out = torch.zeros((u.shape[0], 32 * words), dtype=torch.int32,
                      device=tab.device)
    shifts = torch.arange(32, dtype=torch.int32, device=tab.device)
    task, x = ft.slots(u)
    ok = (x >= 0) & (x < v)
    step = max(1, PLAIN_ELEMS // max(32 * words, 1))
    for a in range(0, task.shape[0], step):
        k = ok[a:a + step]
        rows = tab[torch.where(k, x[a:a + step], 0)] * k[:, None]
        bits = (rows[:, :, None] >> shifts) & 1
        out.index_add_(0, task[a:a + step],
                       bits.reshape(-1, 32 * words).to(torch.int32))
    return out
