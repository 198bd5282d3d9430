"""Set-algebra vocabulary over padded sorted vertex rows (plain torch ops).

The counterpart of graphminer_tpu/ops/setops.py, the redesign of the
reference's L2 layer — VertexSet.h:265-342 (intersection_set/num,
difference_set/num, *_except, bounded) and the CUDA mirror
include/set_intersect.cuh / set_difference.cuh. Every op is a batched dense
computation over tiles:

  a : int32 [B, Da]  "query" side — any order, invalid slots = SENTINEL
  b : int32 [B, Db]  "base"  side — sorted ascending, SENTINEL-padded tail

Invariant: original CSR adjacency rows are always the sorted b-side; derived
sets (partial-embedding candidate sets) stay on the a-side as
SENTINEL-masked rows and never need re-sorting.

Two backends, equal in every result:
  * bc — all-pairs broadcast compare. XLA fuses it; eager torch would
        materialize a [B, Da, Db] bool (2^38 B at B = 16,384 and Da = Db =
        4,096), so it compares in row blocks of at most BC_BUDGET elements.
  * bs — torch.searchsorted of each a-slot in its sorted b row (SENTINEL
        tails sort last), then one gather and one compare.

"auto" picks bs on CUDA: the JAX package picks bc off the CPU because a
TPU's gathers run about a thousand times slower than its vector compares,
which does not hold on a GPU, where the search does O(Da·log Db) work
against bc's O(Da·Db). On the CPU it keeps the JAX package's width rule.
The backend changes speed only, never a count. The module reaches no
kernel of ours: the set algebra needs compares and searches, which torch
has.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..types import SENTINEL as _SENTINEL

SENTINEL = int(_SENTINEL)

# Width product above which "auto" picks the binary-search backend on CPU
# (the JAX package's threshold).
_BC_THRESHOLD = 128 * 256
#: most elements of one row block of the bc backend's [rows, Da, Db] compare
BC_BUDGET = 1 << 26


def _default_backend(t: torch.Tensor) -> str:
    return "bs" if t.device.type == "cuda" else "auto_cpu"


def _valid(a: torch.Tensor, upper: Optional[torch.Tensor]) -> torch.Tensor:
    v = a != SENTINEL
    if upper is not None:
        up = upper if upper.dim() == a.dim() else upper[:, None]
        v &= a < up
    return v


def _member_bc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, Da] bool: a[i,j] ∈ b[i,:], by broadcast compare in row blocks of
    at most BC_BUDGET compared pairs."""
    n, da = a.shape
    db = b.shape[-1]
    if da * db == 0:
        return torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    step = max(1, BC_BUDGET // (da * db))
    if step >= n:
        return (a[:, :, None] == b[:, None, :]).any(dim=-1)
    return torch.cat([(a[i:i + step, :, None] == b[i:i + step, None, :]
                       ).any(dim=-1) for i in range(0, n, step)])


def _member_bs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, Da] bool by binary search of each slot in its sorted b row."""
    db = b.shape[-1]
    if db == 0 or a.shape[-1] == 0:
        return torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    # last position with b[pos] <= a; -1 (clamped to 0) when there is none,
    # and then b[0] > a, so the compare below is False
    pos = torch.searchsorted(b.contiguous(), a.contiguous(), right=True) - 1
    return b.gather(-1, pos.clamp_(min=0)) == a


def member(a: torch.Tensor, b: torch.Tensor,
           backend: str = "auto") -> torch.Tensor:
    """Membership mask of a's slots in sorted rows b. SENTINEL slots -> False
    is NOT guaranteed here (SENTINEL matches SENTINEL padding); callers mask
    with _valid. Use the public ops below unless you know what you're doing."""
    if backend == "auto":
        backend = _default_backend(a)
    if backend == "auto_cpu":
        backend = "bc" if a.shape[-1] * b.shape[-1] <= _BC_THRESHOLD else "bs"
    if backend == "bc":
        return _member_bc(a, b)
    if backend == "bs":
        return _member_bs(a, b)
    raise ValueError(f"unknown setops backend {backend!r}; use auto|bc|bs")


# ---- public vocabulary ---------------------------------------------------

def intersect_count(a: torch.Tensor, b: torch.Tensor,
                    upper: Optional[torch.Tensor] = None,
                    backend: str = "auto") -> torch.Tensor:
    """|a ∩ b| per row, counting only a-values < upper. → int32 [B].

    Parity: intersection_num / intersection_num(…,upper) VertexSet.h:278-289."""
    m = member(a, b, backend) & _valid(a, upper)
    return m.sum(dim=-1, dtype=torch.int32)


def intersect(a: torch.Tensor, b: torch.Tensor,
              upper: Optional[torch.Tensor] = None,
              backend: str = "auto") -> torch.Tensor:
    """a ∩ b as a SENTINEL-masked copy of a (order preserved).

    Parity: intersection_set VertexSet.h:265-276."""
    m = member(a, b, backend) & _valid(a, upper)
    return torch.where(m, a, SENTINEL)


def difference_count(a: torch.Tensor, b: torch.Tensor,
                     upper: Optional[torch.Tensor] = None,
                     backend: str = "auto") -> torch.Tensor:
    """|a \\ b| per row (a-values < upper only). → int32 [B].

    Parity: difference_num VertexSet.h:303-318."""
    m = ~member(a, b, backend) & _valid(a, upper)
    return m.sum(dim=-1, dtype=torch.int32)


def difference(a: torch.Tensor, b: torch.Tensor,
               upper: Optional[torch.Tensor] = None,
               backend: str = "auto") -> torch.Tensor:
    """a \\ b as a SENTINEL-masked copy of a.

    Parity: difference_set VertexSet.h:291-301."""
    m = ~member(a, b, backend) & _valid(a, upper)
    return torch.where(m, a, SENTINEL)


def bounded(a: torch.Tensor, upper: torch.Tensor) -> torch.Tensor:
    """Keep only values strictly below upper (symmetry-break truncation).

    Parity: VertexSet::bounded VertexSet.h:240-255 (binary-search truncation —
    here a mask; semantics identical)."""
    up = upper if upper.dim() == a.dim() else upper[:, None]
    return torch.where(a < up, a, SENTINEL)


def exclude(a: torch.Tensor, ancestors: torch.Tensor) -> torch.Tensor:
    """Remove explicit ancestor vertices (the *_except variants,
    VertexSet.h:320-342). ancestors: int32 [B, K]."""
    hit = (a[:, :, None] == ancestors[:, None, :]).any(dim=-1)
    return torch.where(hit, SENTINEL, a)


def count_valid(a: torch.Tensor,
                upper: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Number of live slots per row. → int32 [B]."""
    return _valid(a, upper).sum(dim=-1, dtype=torch.int32)


def connected(x: torch.Tensor, b: torch.Tensor,
              backend: str = "auto") -> torch.Tensor:
    """[B] bool: scalar-per-row x ∈ sorted row b (edge test)."""
    m = member(x[:, None], b, backend)[:, 0]
    return m & (x != SENTINEL)
