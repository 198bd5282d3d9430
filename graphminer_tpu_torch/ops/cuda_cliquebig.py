"""Kernel Q — quad emission for the large-clique engine's k = 6 device
path (csrc/quad_emit.cu).

Replaces the compaction in the XLA function graphminer_tpu/ops/cliquebig.py
::_tri_expand_bilinear (:156-169: _expand_bits, a cumsum and a scatter;
torch has no unpackbits or popcount). For triangle tasks (erow[t], c1[t])
over the y₂ rows y2 int32 [E, words] and the core rows core int32 [C,
words], it writes every set bit c2 < n_bits of y2[erow[t]] & core[c1[t]]
(words read as uint32, so bit 31 is bit 31), ascending, as one quad

    r_out[o] = erow[t],   cols_out[o] = (c1[t], c2),   o = off[t] - off[0] + j

for the task's j-th bit. off is int64 [T + 1], the scan of the tasks' bit
counts (quad_offsets; a task whose erow or c1 lies outside its table emits
nothing and counts 0), and may be a slice of a longer scan. The quads are
kernel G's gathered arguments at depth 2 (ops/cuda_gram.py::bit_gram with
r = r_out, cols = cols_out), so nothing crosses to the host between Q and G.

y2 and core may be 2-D views at any row stride with contiguous columns.
Each call is one launch, counted on quad_emit.launches; a call with no task
or no quad launches nothing. On a CUDA tensor the wrapper launches the
kernel or raises; it takes the plain version only for CPU tensors.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..types import cdiv
from . import _build
from ._tensors import BLOCK, GRID_CAP, PLAIN_ELEMS
from .cuda_expand import expand_bits_plain


def quad_offsets(counts) -> np.ndarray:
    """int64 [T + 1]: the exclusive scan of the tasks' bit counts, then the
    total (off for quad_emit)."""
    out = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, dtype=np.int64, out=out[1:])
    return out


def _check(y2, core, erow, c1, off, n_bits):
    for name, t, dt in (("y2", y2, torch.int32), ("core", core, torch.int32),
                        ("erow", erow, torch.int32), ("c1", c1, torch.int32),
                        ("off", off, torch.int64)):
        if t.dtype != dt:
            raise TypeError(f"quad_emit: {name} must be {dt}, got {t.dtype}")
        if t.device != y2.device:
            raise ValueError(f"quad_emit: tensors on {y2.device} and "
                             f"{t.device}")
    if y2.dim() != 2 or core.dim() != 2 or y2.shape[1] != core.shape[1]:
        raise ValueError(f"quad_emit: y2 {tuple(y2.shape)} and core "
                         f"{tuple(core.shape)} must be 2-D of one width")
    n = erow.shape[0]
    if erow.shape != (n,) or c1.shape != (n,) or off.shape != (n + 1,):
        raise ValueError(f"quad_emit: erow {tuple(erow.shape)}, c1 "
                         f"{tuple(c1.shape)} and off {tuple(off.shape)} "
                         "must be [T], [T] and [T + 1]")
    if n_bits < 0:
        raise ValueError(f"quad_emit: n_bits {n_bits} < 0")
    return n


def quad_emit(y2: torch.Tensor, core: torch.Tensor, erow: torch.Tensor,
              c1: torch.Tensor, off: torch.Tensor, n_bits: int,
              n_quads: Optional[int] = None):
    """(r_out int32 [Q], cols_out int32 [Q, 2]) of the tasks' quads; see the
    module docstring. n_quads = off[T] - off[0], read from off when not
    given (one copy to the host)."""
    n = _check(y2, core, erow, c1, off, n_bits)
    dev = y2.device
    if n_quads is None:
        n_quads = int(off[-1] - off[0])
    if dev.type == "cpu":
        return quad_emit_plain(y2, core, erow, c1, off, n_bits, n_quads)
    if dev.type != "cuda":
        raise ValueError(f"quad_emit: unsupported device {dev}")
    for name, t in (("y2", y2), ("core", core)):
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"quad_emit: {name} columns must be contiguous")
    for name, t in (("erow", erow), ("c1", c1), ("off", off)):
        if not t.is_contiguous():
            raise ValueError(f"quad_emit: {name} must be contiguous")
    r_out = torch.empty(n_quads, dtype=torch.int32, device=dev)
    cols_out = torch.empty((n_quads, 2), dtype=torch.int32, device=dev)
    if n == 0 or n_quads == 0:
        return r_out, cols_out
    nw = min(y2.shape[1], cdiv(n_bits, 32))
    _build.check_launch(_build.entry("gm_quad_emit")(
        y2.data_ptr(), y2.stride(0), y2.shape[0], core.data_ptr(),
        core.stride(0), core.shape[0], nw, n_bits, erow.data_ptr(),
        c1.data_ptr(), off.data_ptr(), n, r_out.data_ptr(),
        cols_out.data_ptr(), min(GRID_CAP, cdiv(n, BLOCK // 32)),
        _build.stream(dev)), "quad_emit")
    quad_emit.launches += 1
    return r_out, cols_out


quad_emit.launches = 0


def quad_emit_plain(y2: torch.Tensor, core: torch.Tensor, erow: torch.Tensor,
                    c1: torch.Tensor, off: torch.Tensor, n_bits: int,
                    n_quads: Optional[int] = None):
    """Plain PyTorch version of quad_emit (any device): in task blocks, the
    masked gathers and AND, expand_bits_plain, nonzero (row-major: task,
    then bit ascending) and each quad's slot from off and its rank in its
    task."""
    n = _check(y2, core, erow, c1, off, n_bits)
    dev = y2.device
    if n_quads is None:
        n_quads = int(off[-1] - off[0])
    r_out = torch.empty(n_quads, dtype=torch.int32, device=dev)
    cols_out = torch.empty((n_quads, 2), dtype=torch.int32, device=dev)
    nb = min(n_bits, 32 * y2.shape[1])
    step = max(1, PLAIN_ELEMS // max(32 * y2.shape[1], 1))
    for s in range(0, n, step):
        r, c = erow[s:s + step].long(), c1[s:s + step].long()
        ok = (r >= 0) & (r < y2.shape[0]) & (c >= 0) & (c < core.shape[0])
        y = y2[torch.where(ok, r, 0)] & core[torch.where(ok, c, 0)]
        y = torch.where(ok[:, None], y, 0)
        ti, c2 = torch.nonzero(expand_bits_plain(y)[:, :nb], as_tuple=True)
        per = torch.bincount(ti, minlength=r.shape[0])
        first = torch.cumsum(per, 0) - per
        slot = off[s:s + step][ti] - off[0] + \
            torch.arange(ti.shape[0], device=dev) - first[ti]
        r_out[slot] = r[ti].to(torch.int32)
        cols_out[slot] = torch.stack([c[ti], c2], dim=1).to(torch.int32)
    return r_out, cols_out
