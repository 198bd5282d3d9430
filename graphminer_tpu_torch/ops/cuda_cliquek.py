"""Kernel L — the k-clique engine's lo-task popcount over shared runs
(csrc/lo_popcount.cu).

Replaces the XLA function graphminer_tpu/ops/cliquek.py::_lo_popcount
(torch has no popcount). For lo tasks (x_0, ..., x_{nrow-1}), 2 <= nrow
<= 8 — (a, b, d) at k = 4, (a, b, c, d) at k = 5 — over the bitmap table
bm int32 [V, words] and the core rows core int32 [C, words], it returns
int64 partial counts on the device whose sum is

    Σ_t popcount(bm[x_t,0] & bm[x_t,1] & core[x_t,2] & ... )

A task adds 0 unless its bm ids lie in [0, V) and its core ids in
[0, C). That covers the SENTINEL padding of the task list: SENTINEL is
>= 0, so JAX's `x[:, 0] >= 0` test passes it and its core-column range
checks zero it. Intended divergence: where JAX clamps an out-of-range bm
index (or reads bm[0] for a negative b), the port adds 0, as kernel D does
for an index outside its table; the engine never makes such a task.

The tasks reach the kernel as a run table (lo_runs, built once per engine
on the host): a run is a maximal stretch of consecutive tasks that agree
on every column but the varying one — d at k = 4 and c at k = 5, the
native enumerator's innermost loop (ops/cliquek.py::_enum_tasks_native),
cut at MAX_RUN tasks — so the kernel reads a run's shared rows once and
then one row a task.

One persistent launch a count (one wave of blocks, _build.wave_blocks),
one int64 partial a block, counted on lo_popcount.launches; a call with no
tasks launches nothing. The wrapper takes the plain version only for CPU
tensors; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..types import cdiv
from ..utils.profiling import PROFILER
from . import _build
from ._tensors import BLOCK, PLAIN_ELEMS, on_cuda, popcount32, upload

MIN_ROWS, MAX_ROWS = 2, 8
#: lanes a run (csrc/lo_popcount.cu::G)
GROUP = 8
#: most tasks a run of the table holds: a longer stretch is cut into runs
#: of this many, so that one long run does not hold up the grid
MAX_RUN = 256


@dataclasses.dataclass(frozen=True)
class LoRuns:
    """The lo tasks as runs, on one device (lo_runs): shared int32
    [runs, nrow - 1] (each run's ids of the columns other than vary_col, in
    order), starts int32 [runs + 1] (each run's first task, then n) and
    vary int32 [n] (each task's id in vary_col)."""
    shared: torch.Tensor
    starts: torch.Tensor
    vary: torch.Tensor
    vary_col: int

    @property
    def n(self) -> int:
        return self.vary.shape[0]

    @property
    def nrow(self) -> int:
        return self.shared.shape[1] + 1

    @property
    def n_runs(self) -> int:
        return self.shared.shape[0]

    def tasks(self) -> torch.Tensor:
        """The task list int32 [n, nrow] the runs were built from."""
        lens = (self.starts[1:] - self.starts[:-1]).long()
        other = self.shared.repeat_interleave(lens, dim=0)
        vc = self.vary_col
        return torch.cat([other[:, :vc], self.vary[:, None], other[:, vc:]],
                         dim=1)

    def nbytes(self) -> int:
        return 4 * (self.shared.numel() + self.starts.numel() + self.n)


@PROFILER.span("build.pack")
def lo_runs(cols: np.ndarray, vary_col: int = 2,
            device="cpu") -> LoRuns:
    """The run table of the task list cols int32 [n, nrow], in order: a
    new run starts wherever a task differs from the one before it in a
    column other than vary_col, and after every MAX_RUN tasks of one run."""
    cols = np.asarray(cols, dtype=np.int32)
    if cols.ndim != 2 or not MIN_ROWS <= cols.shape[1] <= MAX_ROWS or \
            not 0 <= vary_col < cols.shape[1]:
        raise ValueError(f"lo_runs: cols {cols.shape} (nrow {MIN_ROWS}-"
                         f"{MAX_ROWS}), vary_col {vary_col}")
    n = cols.shape[0]
    other = np.delete(cols, vary_col, axis=1)
    new = np.ones(n, bool)
    new[1:] = (other[1:] != other[:-1]).any(axis=1)
    first = np.flatnonzero(new)
    pieces = (np.diff(np.append(first, n)) + MAX_RUN - 1) // MAX_RUN
    head = np.repeat(np.cumsum(pieces) - pieces, pieces)
    first = np.repeat(first, pieces) + \
        (np.arange(pieces.sum()) - head) * MAX_RUN
    t = lambda a: upload(np.ascontiguousarray(a), device)
    return LoRuns(shared=t(other[first]),
                  starts=t(np.append(first, n).astype(np.int32)),
                  vary=t(cols[:, vary_col]), vary_col=vary_col)


def _check(bm, core):
    if bm.dim() != 2 or core.dim() != 2 or bm.shape[1] != core.shape[1]:
        raise ValueError(f"lo_popcount shapes disagree: bm "
                         f"{tuple(bm.shape)} core {tuple(core.shape)}")


def lo_popcount(bm: torch.Tensor, core: torch.Tensor,
                runs: LoRuns) -> torch.Tensor:
    """int64 partial lo counts (one a block) whose sum is the lo total over
    the run table `runs`; see the module docstring."""
    _check(bm, core)
    if not on_cuda("lo_popcount", bm, core, runs.shared, runs.starts,
                   runs.vary):
        return lo_popcount_plain(bm, core, runs)
    dev = bm.device
    n = runs.n
    if n == 0:
        return torch.zeros(1, dtype=torch.int64, device=dev)
    words = bm.shape[1]
    if words % 4 or bm.data_ptr() % 16 or core.data_ptr() % 16:
        raise ValueError(f"lo_popcount reads 16-byte chunks: words={words} "
                         "must be a multiple of 4 and the tables aligned")
    nb = min(cdiv(runs.n_runs, BLOCK // GROUP),
             _build.wave_blocks("gm_lo_popcount_blocks", dev.index,
                                runs.nrow - 1))
    out = torch.empty(nb, dtype=torch.int64, device=dev)
    _build.check_launch(_build.entry("gm_lo_popcount")(
        bm.data_ptr(), bm.shape[0], core.data_ptr(), core.shape[0], words,
        runs.shared.data_ptr(), runs.nrow - 1, runs.vary_col,
        runs.starts.data_ptr(), runs.vary.data_ptr(), runs.n_runs,
        out.data_ptr(), nb, _build.stream(dev)), "lo_popcount")
    lo_popcount.launches += 1
    return out


lo_popcount.launches = 0


def lo_popcount_plain(bm: torch.Tensor, core: torch.Tensor,
                      runs: LoRuns) -> torch.Tensor:
    """Plain PyTorch version of lo_popcount (any device): the task list
    rebuilt from the runs, then the masked row gathers, ANDs and popcount
    in task chunks, as an int64 [1] tensor."""
    _check(bm, core)
    cols = runs.tasks()
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
