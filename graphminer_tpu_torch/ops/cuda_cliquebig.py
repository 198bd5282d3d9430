"""Kernel Q — quad counting and emission for the large-clique engine's
k = 6 device path (csrc/quad_emit.cu).

Replaces the compaction in the XLA function graphminer_tpu/ops/cliquebig.py
::_tri_expand_bilinear (:156-169: _expand_bits, a cumsum for each quad's
position and a scatter; torch has no unpackbits or popcount). For triangle
tasks (erow[t], c1[t]) over the y₂ rows y2 int32 [E, words] and the core
rows core int32 [C, words], let y_t be the bits c2 < n_bits of y2[erow[t]]
& core[c1[t]] (words read as uint32, so bit 31 is bit 31; no bit for a task
whose erow or c1 lies outside its table).

* quad_count writes popcount(y_t) a task (int32 [T]); quad_offsets scans
  those counts into off, int64 [T + 1], on their device.
* quad_emit writes every set bit of y_t, ascending, as one quad

      r_out[o] = erow[t],   cols_out[o] = (c1[t], c2),   o = off[t] - off[0] + j

  for the task's j-th bit. off may be a slice of a longer scan. The quads
  are kernel G's gathered arguments at depth 2 (ops/cuda_gram.py::bit_gram
  with r = r_out, cols = cols_out), so nothing crosses to the host between
  the count, Q and G.

y2 and core may be 2-D views at any row stride with contiguous columns. On
the card the kernels read 16-byte words: the width and both row strides
must be multiples of 4 words and both tables 16-byte aligned (the engine's
tables are: a row is a multiple of 8 words), else the wrapper raises.
Each call of quad_count or quad_emit is one launch, counted on its
.launches; a call with no task (or, for quad_emit, no quad) launches
nothing. On a CUDA tensor a wrapper launches its kernel or raises; it takes
the plain version only for CPU tensors. QUAD_TILE and QUAD_STAGE are the
emit kernel's tile (tasks a block, 32 a warp) and staging buffer (quads a
round), as in the CUDA source.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..types import cdiv
from . import _build
from ._tensors import BLOCK, GRID_CAP, PLAIN_ELEMS, popcount32
from .cuda_expand import expand_bits_plain

QUAD_TILE = 256
QUAD_STAGE = 8192
#: c2 shares a staged 32-bit word with the task's index in its tile
MAX_BITS = 1 << 24


def quad_offsets(counts: torch.Tensor) -> torch.Tensor:
    """int64 [T + 1] on counts' device: the exclusive scan of the tasks' bit
    counts, then the total (off for quad_emit)."""
    off = torch.zeros(counts.shape[0] + 1, dtype=torch.int64,
                      device=counts.device)
    torch.cumsum(counts, 0, dtype=torch.int64, out=off[1:])
    return off


def _check(name, y2, core, erow, c1, off, n_bits):
    for what, t, dt in (("y2", y2, torch.int32), ("core", core, torch.int32),
                        ("erow", erow, torch.int32), ("c1", c1, torch.int32),
                        ("off", off, torch.int64)):
        if t is None:
            continue
        if t.dtype != dt:
            raise TypeError(f"{name}: {what} must be {dt}, got {t.dtype}")
        if t.device != y2.device:
            raise ValueError(f"{name}: tensors on {y2.device} and "
                             f"{t.device}")
    if y2.dim() != 2 or core.dim() != 2 or y2.shape[1] != core.shape[1]:
        raise ValueError(f"{name}: y2 {tuple(y2.shape)} and core "
                         f"{tuple(core.shape)} must be 2-D of one width")
    n = erow.shape[0]
    if erow.shape != (n,) or c1.shape != (n,) or \
            (off is not None and off.shape != (n + 1,)):
        raise ValueError(f"{name}: erow {tuple(erow.shape)}, c1 "
                         f"{tuple(c1.shape)} and off "
                         f"{None if off is None else tuple(off.shape)} must "
                         "be [T], [T] and [T + 1]")
    if n_bits < 0:
        raise ValueError(f"{name}: n_bits {n_bits} < 0")
    return n


def _kernel_args(name, y2, core, erow, c1, off, n_bits):
    """The launch arguments both kernels share, after the card's checks:
    (y2, ldy, ny, core, ldc, nc, nw, n_bits, erow, c1)."""
    if n_bits > MAX_BITS:
        raise ValueError(f"{name}: n_bits {n_bits} > {MAX_BITS}")
    for what, t in (("y2", y2), ("core", core)):
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"{name}: {what} columns must be contiguous")
    for what, t in (("erow", erow), ("c1", c1), ("off", off)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if y2.shape[1] % 4 or any(t.stride(0) % 4 or t.data_ptr() % 16
                              for t in (y2, core)):
        raise ValueError(f"{name} reads 16-byte words: the width "
                         f"{y2.shape[1]} and the row strides must be "
                         "multiples of 4 and the tables aligned")
    nw = min(y2.shape[1], cdiv(n_bits, 32))
    return (y2.data_ptr(), y2.stride(0), y2.shape[0], core.data_ptr(),
            core.stride(0), core.shape[0], nw, n_bits, erow.data_ptr(),
            c1.data_ptr())


def quad_count(y2: torch.Tensor, core: torch.Tensor, erow: torch.Tensor,
               c1: torch.Tensor, n_bits: int) -> torch.Tensor:
    """int32 [T]: popcount(y_t) a task; see the module docstring."""
    n = _check("quad_count", y2, core, erow, c1, None, n_bits)
    dev = y2.device
    if dev.type == "cpu":
        return quad_count_plain(y2, core, erow, c1, n_bits)
    if dev.type != "cuda":
        raise ValueError(f"quad_count: unsupported device {dev}")
    args = _kernel_args("quad_count", y2, core, erow, c1, None, n_bits)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    _build.check_launch(_build.entry("gm_quad_count")(
        *args, n, out.data_ptr(),
        min(GRID_CAP, cdiv(n, BLOCK)), _build.stream(dev)), "quad_count")
    quad_count.launches += 1
    return out


quad_count.launches = 0


def _bit_masks(words: int, n_bits: int, device) -> torch.Tensor:
    """int32 [words]: word w's bits below n_bits."""
    left = np.clip(n_bits - 32 * np.arange(words, dtype=np.int64), 0, 32)
    m = ((np.uint64(1) << left.astype(np.uint64)) - np.uint64(1))
    return torch.from_numpy(m.astype(np.uint32).view(np.int32)).to(device)


def quad_count_plain(y2: torch.Tensor, core: torch.Tensor,
                     erow: torch.Tensor, c1: torch.Tensor,
                     n_bits: int) -> torch.Tensor:
    """Plain PyTorch version of quad_count (any device): in task blocks,
    the masked gathers and AND, the bits below n_bits, popcount32."""
    n = _check("quad_count", y2, core, erow, c1, None, n_bits)
    dev = y2.device
    out = torch.empty(n, dtype=torch.int32, device=dev)
    mask = _bit_masks(y2.shape[1], n_bits, dev)
    step = max(1, PLAIN_ELEMS // max(y2.shape[1], 1))
    for s in range(0, n, step):
        r, c = erow[s:s + step].long(), c1[s:s + step].long()
        ok = (r >= 0) & (r < y2.shape[0]) & (c >= 0) & (c < core.shape[0])
        y = y2[torch.where(ok, r, 0)] & core[torch.where(ok, c, 0)] & mask
        out[s:s + step] = (popcount32(y).sum(dim=1) * ok).to(torch.int32)
    return out


def quad_emit(y2: torch.Tensor, core: torch.Tensor, erow: torch.Tensor,
              c1: torch.Tensor, off: torch.Tensor, n_bits: int,
              n_quads: Optional[int] = None):
    """(r_out int32 [Q], cols_out int32 [Q, 2]) of the tasks' quads; see the
    module docstring. n_quads = off[T] - off[0], read from off when not
    given (one copy to the host)."""
    n = _check("quad_emit", y2, core, erow, c1, off, n_bits)
    dev = y2.device
    if n_quads is None:
        n_quads = int(off[-1] - off[0])
    if dev.type == "cpu":
        return quad_emit_plain(y2, core, erow, c1, off, n_bits, n_quads)
    if dev.type != "cuda":
        raise ValueError(f"quad_emit: unsupported device {dev}")
    args = _kernel_args("quad_emit", y2, core, erow, c1, off, n_bits)
    r_out = torch.empty(n_quads, dtype=torch.int32, device=dev)
    cols_out = torch.empty((n_quads, 2), dtype=torch.int32, device=dev)
    if n == 0 or n_quads == 0:
        return r_out, cols_out
    _build.check_launch(_build.entry("gm_quad_emit")(
        *args, off.data_ptr(), n, r_out.data_ptr(), cols_out.data_ptr(),
        min(GRID_CAP, cdiv(n, QUAD_TILE)), _build.stream(dev)), "quad_emit")
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
    n = _check("quad_emit", y2, core, erow, c1, off, n_bits)
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
