"""Kernel X — bit expansion into int8 0/1 operand rows (csrc/expand_bits.cu).

Replaces the XLA function graphminer_tpu/ops/hubcore.py::_expand_bits and
the gathers and ANDs in front of it in graphminer_tpu/ops/cliquek.py
(y2 & core_hi[c], :267-270) and graphminer_tpu/ops/cliquebig.py (the
depth-chained ANDs, :118-128): torch has no unpackbits. For task t < n the
packed row of hw words is

    y_t = base[row_t] & tab[cols[t, 0]] & ... & tab[cols[t, depth-1]]

with row_t = r[t], or t when r is None. With neither r nor cols (plain
mode) y_t = base[t]. A task whose row lies outside base or any
of whose cols lies outside tab (SENTINEL included) gives a zero row, as the
JAX code's where(ok, ..., 0) does, and so does every task t in [n, n_out):
the output is padded for torch._int_mm by the kernel itself. The result is
int8 [n_out, 32*hw], or [32*hw, n_out] when `transpose`; byte w*32 + b of
a task is bit b of its word w (the packing order of build_hub_layout), the
words read as uint32, so bit 31 of a negative int32 word is bit 31.

base and tab may be 2-D views at any row stride with contiguous columns
(a hi slice of a wider table is read in place, with no copy). Each call is
one launch, counted on expand_bits.launches; on a CUDA tensor the wrapper
launches or raises, and it takes the plain version only for CPU tensors.
The kernel takes depth 0-6 and, when transposed, n_out % 32 == 0.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from ._tensors import PLAIN_ELEMS

MAX_DEPTH = 6


def _shapes(base, r, tab, cols, n_out, transpose):
    """(n, depth, n_out) of a call, after checking the arguments."""
    for name, t in (("base", base), ("tab", tab), ("r", r), ("cols", cols)):
        if t is not None and t.dtype != torch.int32:
            raise TypeError(f"expand_bits: {name} must be int32, got "
                            f"{t.dtype}")
    if base.dim() != 2:
        raise ValueError(f"expand_bits: base must be 2-D, got "
                         f"{tuple(base.shape)}")
    if cols is not None:
        if cols.dim() != 2 or not 0 <= cols.shape[1] <= MAX_DEPTH:
            raise ValueError(f"expand_bits: cols must be [n, 0..{MAX_DEPTH}]"
                             f", got {tuple(cols.shape)}")
        if cols.shape[1] and (tab is None or tab.dim() != 2 or
                              tab.shape[1] != base.shape[1]):
            raise ValueError("expand_bits: cols need a tab of base's width")
        n, depth = cols.shape
    elif r is not None:
        n, depth = r.shape[0], 0
    else:
        n, depth = base.shape[0], 0
    if r is not None and r.shape != (n,):
        raise ValueError(f"expand_bits: r {tuple(r.shape)} for {n} tasks")
    n_out = n if n_out is None else n_out
    if n_out < n:
        raise ValueError(f"expand_bits: n_out={n_out} < {n} tasks")
    return n, depth, n_out


def expand_bits(base: torch.Tensor, *, r: Optional[torch.Tensor] = None,
                tab: Optional[torch.Tensor] = None,
                cols: Optional[torch.Tensor] = None,
                n_out: Optional[int] = None,
                transpose: bool = False) -> torch.Tensor:
    """The expanded rows, int8 [n_out, 32*hw] (or [32*hw, n_out] when
    `transpose`); see the module docstring."""
    n, depth, n_out = _shapes(base, r, tab, cols, n_out, transpose)
    dev = base.device
    for t in (tab, r, cols):
        if t is not None and t.device != dev:
            raise ValueError(f"expand_bits: tensors on {dev} and {t.device}")
    if dev.type == "cpu":
        return expand_bits_plain(base, r=r, tab=tab, cols=cols, n_out=n_out,
                                 transpose=transpose)
    if dev.type != "cuda":
        raise ValueError(f"expand_bits: unsupported device {dev}")
    hw = base.shape[1]
    tab_ = tab if depth else base
    for name, t in (("base", base), ("tab", tab_)):
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"expand_bits: {name} columns must be "
                             "contiguous")
    for name, t in (("r", r), ("cols", cols)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"expand_bits: {name} must be contiguous")
    if transpose and n_out % 32:
        raise ValueError(f"expand_bits: the kernel's transposed output "
                         f"needs n_out % 32 == 0, got {n_out}")
    if n_out * hw >= 1 << 31:
        raise ValueError(f"expand_bits: n_out * hw = {n_out * hw} exceeds "
                         "int32")
    shape = (32 * hw, n_out) if transpose else (n_out, 32 * hw)
    out = torch.empty(shape, dtype=torch.int8, device=dev)
    if out.numel() == 0:
        return out
    _build.check_launch(_build.entry("gm_expand_bits")(
        base.data_ptr(), base.stride(0), base.shape[0],
        r.data_ptr() if r is not None else None,
        tab_.data_ptr(), tab_.stride(0), tab_.shape[0],
        cols.data_ptr() if cols is not None else None, depth, n, hw, n_out,
        int(transpose), out.data_ptr(), _build.stream(dev)), "expand_bits")
    expand_bits.launches += 1
    return out


expand_bits.launches = 0


def _packed_rows(base, *, r=None, tab=None, cols=None):
    """The tasks' packed rows y_t, int32 [n, hw] (any device)."""
    n, depth, _ = _shapes(base, r, tab, cols, None, False)
    row = r.long() if r is not None else \
        torch.arange(n, device=base.device)
    ok = (row >= 0) & (row < base.shape[0])
    y = base[torch.where(ok, row, 0)]
    for j in range(depth):
        cj = cols[:, j].long()
        okj = (cj >= 0) & (cj < tab.shape[0])
        y = y & tab[torch.where(okj, cj, 0)]
        ok &= okj
    return torch.where(ok[:, None], y, 0)


def expand_bits_plain(base: torch.Tensor, *,
                      r: Optional[torch.Tensor] = None,
                      tab: Optional[torch.Tensor] = None,
                      cols: Optional[torch.Tensor] = None,
                      n_out: Optional[int] = None,
                      transpose: bool = False) -> torch.Tensor:
    """Plain PyTorch version of expand_bits (any device, any n_out): the
    gathers and masked ANDs, then shift and & 1 in row chunks.

    torch shifts int32 arithmetically (JAX uses shift_right_logical), but
    (x >> b) & 1 is bit b of x for every b in 0..31 all the same: the sign
    copies land only in bits above 31 - b, and & 1 keeps bit 0."""
    n, _, n_out = _shapes(base, r, tab, cols, n_out, transpose)
    y = _packed_rows(base, r=r, tab=tab, cols=cols)
    hw = base.shape[1]
    shifts = torch.arange(32, dtype=torch.int32, device=base.device)
    shape = (32 * hw, n_out) if transpose else (n_out, 32 * hw)
    out = torch.zeros(shape, dtype=torch.int8, device=base.device)
    step = max(1, PLAIN_ELEMS // max(32 * hw, 1))
    for s in range(0, n, step):
        e = min(n, s + step)
        if transpose:       # built transposed: [hw, 32, rows] -> [32hw, rows]
            bits = (y[s:e].t()[:, None, :] >> shifts[None, :, None]) & 1
            out[:, s:e] = bits.to(torch.int8).reshape(32 * hw, e - s)
        else:
            bits = (y[s:e, :, None] >> shifts) & 1
            out[s:e] = bits.to(torch.int8).reshape(e - s, 32 * hw)
    return out
