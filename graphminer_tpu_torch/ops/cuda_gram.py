"""Kernel G — the bit Gram on the tensor cores (csrc/bit_gram.cu).

Replaces the hi products of the JAX package, each an expansion
(graphminer_tpu/ops/hubcore.py::_expand_bits) followed by a dot_general:
graphminer_tpu/ops/cliquek.py::_edge_hi_bilinear (k = 4),
::_tri_stream_bilinear (k = 5), graphminer_tpu/ops/hubcore.py::
_spoke_gemm_partials (the spoke) and graphminer_tpu/ops/cliquebig.py::
_chain_hi_bilinear (depth 2+). Its task rows are kernel X's
(ops/cuda_expand.py): for task t < n,

    y_t = base[row_t] & tab[cols[t, 0]] & ... & tab[cols[t, depth-1]]

over hw words (row_t = r[t], or t without r; plain mode y_t = base[t]; an
id outside its table, SENTINEL included, gives a zero row; words read as
uint32). With `mask` the packed rows of a 0/1 matrix B (bit j of row i is
B[i, j]; rows at or past mask.shape[0] are zero) it returns int64
[32*hw] on the tensors' device:

    out[i] = Σ_t y_t[i] · popcount(B[i] & y_t) = Σ_j B[i, j] (YᵀY)[i, j]

with Y the 0/1 expansion of the rows, the per-row partial of
⟨B, YᵀY⟩ = Σ_t y_tᵀ B y_t. No expanded row and no Gram reaches device
memory: the kernel multiplies only the T x T output tiles (T = 128) whose
B tile has a set bit — the tile table of plan_gram, built once per B at
engine build — with the tasks (K) split across a persistent grid, and
folds B into its epilogue. base, tab and mask may be 2-D views at any row
stride with contiguous columns (read in place). Each call is one launch,
counted on bit_gram.launches (a call with no task or no tile launches
nothing); on a CUDA tensor the wrapper launches or raises, and it takes
the plain version only for CPU tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..types import cdiv, round_up
from ..utils.profiling import PROFILER
from . import _build
from ._tensors import PLAIN_ELEMS, upload
from .cuda_expand import _packed_rows, _shapes, expand_bits_plain

#: output tile side in bits (csrc/bit_gram.cu::T)
TILE = 128
#: tasks a step of a block (csrc/bit_gram.cu::STEP); K-ranges are multiples
STEP = 256
#: work items a block of the persistent grid takes, about
ROUNDS = 4
#: an s32 accumulator entry counts tasks of one K-range: fewer than this
K_LIMIT = 1 << 31


@dataclasses.dataclass(frozen=True)
class GramPlan:
    """The output tiles that kernel G multiplies for one mask, on the
    mask's device: tiles int32 [n_tiles, 2] of (I, J) tile ids, row-major,
    every TILE x TILE tile of the [dim, dim] output whose mask tile has a
    set bit."""
    tiles: torch.Tensor
    dim: int

    @property
    def n_tiles(self) -> int:
        return self.tiles.shape[0]


def tile_table(mask: np.ndarray, tile: int = TILE) -> np.ndarray:
    """int32 [n_tiles, 2] (I, J) of the tile x tile tiles of the
    [32*hw, 32*hw] output that hold a set bit of the packed mask rows
    [nm, hw] (rows past 32*hw are ignored), row-major."""
    nm, hw = mask.shape
    if tile % 32:
        raise ValueError(f"tile_table: tile {tile} is no multiple of 32")
    dim = 32 * hw
    side = -(-dim // tile)
    nz = np.zeros((side * tile, side * (tile // 32)), bool)
    rows = min(nm, dim)
    nz[:rows, :hw] = mask[:rows] != 0
    hit = nz.reshape(side, tile, side, tile // 32).any(axis=(1, 3))
    # argwhere is a transposed (column-major) view; the kernel reads records
    return np.ascontiguousarray(np.argwhere(hit), dtype=np.int32)


@PROFILER.span("build.pack")
def plan_gram(mask: torch.Tensor) -> GramPlan:
    """The tile table of `mask` (packed int32 rows [nm, hw]) on its device;
    built once per mask (one copy of the mask to the host)."""
    if mask.dim() != 2 or mask.dtype != torch.int32:
        raise ValueError(f"plan_gram: mask must be int32 [nm, hw], got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    tiles = tile_table(mask.cpu().numpy())
    return GramPlan(tiles=upload(tiles, mask.device),
                    dim=32 * mask.shape[1])


def k_ranges(n: int, n_tiles: int, n_blocks: int):
    """(kc, n_items): the K-range of a work item, kc tasks (a multiple of
    STEP), and the (tile, K-range) items of a launch, about ROUNDS a block
    of an n_blocks grid. Raises where an s32 accumulator entry could count
    2^31 tasks or a task index could pass int32."""
    if n + STEP >= K_LIMIT:
        raise ValueError(f"bit_gram: {n} tasks; the kernel indexes fewer "
                         f"than 2^31 - {STEP}")
    target = max(1, ROUNDS * n_blocks // max(n_tiles, 1))
    kc = round_up(max(1, cdiv(n, target)), STEP)
    if n + kc >= K_LIMIT:
        raise ValueError(f"bit_gram: K-ranges of {kc} tasks reach 2^31")
    return kc, n_tiles * cdiv(n, kc)


def _check(base, mask, hw):
    if mask.dtype != torch.int32 or mask.dim() != 2 or mask.shape[1] != hw:
        raise ValueError(f"bit_gram: mask must be int32 [nm, {hw}], got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    if mask.device != base.device:
        raise ValueError(f"bit_gram: tensors on {base.device} and "
                         f"{mask.device}")


def bit_gram(base: torch.Tensor, mask: torch.Tensor, *,
             r: Optional[torch.Tensor] = None,
             tab: Optional[torch.Tensor] = None,
             cols: Optional[torch.Tensor] = None,
             plan: Optional[GramPlan] = None) -> torch.Tensor:
    """int64 [32*hw] row partials of ⟨B, YᵀY⟩; see the module docstring.
    `plan` is plan_gram(mask), made here when not given."""
    n, depth, _ = _shapes(base, r, tab, cols, None, False)
    hw = base.shape[1]
    _check(base, mask, hw)
    dev = base.device
    for t in (tab, r, cols):
        if t is not None and t.device != dev:
            raise ValueError(f"bit_gram: tensors on {dev} and {t.device}")
    if dev.type == "cpu":
        return bit_gram_plain(base, mask, r=r, tab=tab, cols=cols)
    if dev.type != "cuda":
        raise ValueError(f"bit_gram: unsupported device {dev}")
    tab_ = tab if depth else base
    for name, t in (("base", base), ("tab", tab_), ("mask", mask)):
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"bit_gram: {name} columns must be contiguous")
    for name, t in (("r", r), ("cols", cols)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"bit_gram: {name} must be contiguous")
    plan = plan or plan_gram(mask)
    if plan.dim != 32 * hw or plan.tiles.device != dev or \
            not plan.tiles.is_contiguous():
        raise ValueError(f"bit_gram: a plan for dim {plan.dim} on "
                         f"{plan.tiles.device}, rows of {32 * hw} bits on "
                         f"{dev}")
    out = torch.zeros(32 * hw, dtype=torch.int64, device=dev)
    if n == 0 or plan.n_tiles == 0:
        return out
    blocks = _build.wave_blocks("gm_bit_gram_blocks", dev.index, depth)
    kc, n_items = k_ranges(n, plan.n_tiles, blocks)
    _build.check_launch(_build.entry("gm_bit_gram")(
        base.data_ptr(), base.stride(0), base.shape[0],
        r.data_ptr() if r is not None else None,
        tab_.data_ptr(), tab_.stride(0), tab_.shape[0],
        cols.data_ptr() if cols is not None else None, depth, n, hw,
        mask.data_ptr(), mask.stride(0), mask.shape[0],
        plan.tiles.data_ptr(), plan.n_tiles, kc, n_items, out.data_ptr(),
        min(blocks, n_items), _build.stream(dev)), "bit_gram")
    bit_gram.launches += 1
    return out


bit_gram.launches = 0


def bit_gram_plain(base: torch.Tensor, mask: torch.Tensor, *,
                   r: Optional[torch.Tensor] = None,
                   tab: Optional[torch.Tensor] = None,
                   cols: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of bit_gram (any device): the masked gathers
    and ANDs, expand_bits_plain in row blocks (transposed), each block's
    YᵀY as a float32 product of its 0/1 entries (exact: an entry is an
    integer no larger than the block's PLAIN_ELEMS // dim < 2^24 rows, and
    so is every partial sum, in TF32 too) summed into an int64 Gram, then
    the mask-and-sum over the whole Gram (no tile table)."""
    n, _, _ = _shapes(base, r, tab, cols, None, False)
    hw = base.shape[1]
    _check(base, mask, hw)
    dim = 32 * hw
    y = _packed_rows(base, r=r, tab=tab, cols=cols)
    gram = torch.zeros((dim, dim), dtype=torch.int64, device=base.device)
    step = max(1, PLAIN_ELEMS // max(dim, 1))
    for s in range(0, n, step):
        xt = expand_bits_plain(y[s:s + step], transpose=True).float()
        gram += (xt @ xt.t()).to(torch.int64)
    rows = min(mask.shape[0], dim)
    b = expand_bits_plain(mask[:rows]).to(torch.int64)
    out = torch.zeros(dim, dtype=torch.int64, device=base.device)
    out[:rows] = (gram[:rows] * b).sum(dim=1)
    return out
