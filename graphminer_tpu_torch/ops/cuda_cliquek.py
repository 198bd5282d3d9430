"""Kernel L — the k-clique engine's lo-task popcount (csrc/lo_popcount.cu).

Replaces the XLA function graphminer_tpu/ops/cliquek.py::_lo_popcount
(torch has no popcount). For lo tasks cols int32 [n, nrow] (a, b, c, ...,
d), 2 <= nrow <= 8, over the bitmap table bm int32 [V, words] and the core
rows core int32 [C, words], it returns int64 partial counts on the device
whose sum is

    Σ_t popcount(bm[a_t] & bm[b_t] & core[cols[t, 2]] & ... )

A task adds 0 unless a and b lie in [0, V) and every core column in
[0, C). That covers the SENTINEL padding of the task list: SENTINEL is
>= 0, so JAX's `x[:, 0] >= 0` test passes it and its core-column range
checks zero it. Intended divergence: where JAX clamps an out-of-range bm
index (or reads bm[0] for a negative b), the port adds 0, as kernel D does
for an index outside its table; the engine never makes such a task.

One persistent launch a count (one wave of blocks, _build.wave_blocks),
one int64 partial a block, counted on lo_popcount.launches; a call with no
tasks launches nothing. The wrapper takes the plain version only for CPU
tensors; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import _build
from ._tensors import BLOCK, PLAIN_ELEMS, on_cuda, popcount32

#: lanes a task (csrc/lo_popcount.cu::G)
LANES = 8
MIN_ROWS, MAX_ROWS = 2, 8


def _check(bm, core, cols):
    if bm.dim() != 2 or core.dim() != 2 or bm.shape[1] != core.shape[1] or \
            cols.dim() != 2 or not MIN_ROWS <= cols.shape[1] <= MAX_ROWS:
        raise ValueError(f"lo_popcount shapes disagree: bm "
                         f"{tuple(bm.shape)} core {tuple(core.shape)} cols "
                         f"{tuple(cols.shape)} (nrow {MIN_ROWS}-{MAX_ROWS})")


def lo_popcount(bm: torch.Tensor, core: torch.Tensor,
                cols: torch.Tensor) -> torch.Tensor:
    """int64 partial lo counts (one a block) whose sum is the lo total; see
    the module docstring."""
    _check(bm, core, cols)
    if not on_cuda("lo_popcount", bm, core, cols):
        return lo_popcount_plain(bm, core, cols)
    dev = bm.device
    n, nrow = cols.shape
    if n == 0:
        return torch.zeros(1, dtype=torch.int64, device=dev)
    words = bm.shape[1]
    if words % 4 or bm.data_ptr() % 16 or core.data_ptr() % 16:
        raise ValueError(f"lo_popcount reads 16-byte chunks: words={words} "
                         "must be a multiple of 4 and the tables aligned")
    nb = min(-(-n // (BLOCK // LANES)),
             _build.wave_blocks("gm_lo_popcount_blocks", dev.index))
    out = torch.empty(nb, dtype=torch.int64, device=dev)
    _build.check_launch(_build.entry("gm_lo_popcount")(
        bm.data_ptr(), bm.shape[0], core.data_ptr(), core.shape[0], words,
        cols.data_ptr(), n, nrow, out.data_ptr(), nb, _build.stream(dev)),
        "lo_popcount")
    lo_popcount.launches += 1
    return out


lo_popcount.launches = 0


def lo_popcount_plain(bm: torch.Tensor, core: torch.Tensor,
                      cols: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of lo_popcount (any device): the masked row
    gathers, ANDs and popcount in task chunks, as an int64 [1] tensor."""
    _check(bm, core, cols)
    v, c = bm.shape[0], core.shape[0]
    step = max(1, PLAIN_ELEMS // max(bm.shape[1], 1))
    total = torch.zeros(1, dtype=torch.int64, device=bm.device)
    for s in range(0, cols.shape[0], step):
        x = cols[s:s + step].long()
        ok = (x[:, :2] >= 0).all(dim=1) & (x[:, :2] < v).all(dim=1) & \
            (x[:, 2:] >= 0).all(dim=1) & (x[:, 2:] < c).all(dim=1)
        x = torch.where(ok[:, None], x, 0)
        y = bm[x[:, 0]] & bm[x[:, 1]]
        for j in range(2, x.shape[1]):
            y = y & core[x[:, j]]
        total += (popcount32(y).sum(dim=1) * ok).sum()
    return total
