"""Kernels B and C — the ring engine's counts (csrc/ring_phase_c.cu,
csrc/ring_tail_pairs.cu).

B, ring_phase_c, is the port of the Pallas kernel
graphminer_tpu/ops/pallas_ring.py::_kernel (and of its XLA twin
ops/ring.py::_cbucket_partials): Σ_r Σ_s popcount(src_bm[r] &
table[dst_loc[r, s]]), where a slot outside [0, rows of table) gives 0. It
serves phase C (table = the core bitmaps) and the phase-T bitmap pass
(table = the dense bm_table).

C, ring_tail_pairs, replaces ops/ring.py::_tail_pairs_partials: for every
task i, the number of non-SENTINEL ids shared by table_a[sa[i]] and
table_b[sb[i]] (rows sorted ascending, SENTINEL padded, no repeated id); a
slot outside its table gives 0.

Both return an int64 0-d tensor on the inputs' device. Each wrapper takes
its plain version only for CPU tensors; for CUDA tensors it launches the
kernel or raises.

Left out of the Pallas kernel's port: the SMEM index chunking (SMEM_IDS) and
the enable_x64(False) scope (pallas_ring.py:79-106), both TPU limits, and
the per_task=True paths of the XLA twins, which have no caller.
"""
from __future__ import annotations

import torch

from ..types import SENTINEL
from . import _build
from ._tensors import PLAIN_ELEMS, n_blocks, on_cuda, popcount32

#: tasks per launch of kernel C times its row width stays below 2^31
MAX_ELEMS = 1 << 30


def ring_phase_c(table: torch.Tensor, src_bm: torch.Tensor,
                 dst_loc: torch.Tensor) -> torch.Tensor:
    """Σ popcount(src_bm[r] & table[dst_loc[r, s]]) over valid slots."""
    n, words = src_bm.shape
    if table.dim() != 2 or table.shape[1] != words or \
            dst_loc.dim() != 2 or dst_loc.shape[0] != n:
        raise ValueError(f"phase-C shapes disagree: table {tuple(table.shape)}"
                         f" src_bm {tuple(src_bm.shape)} dst_loc "
                         f"{tuple(dst_loc.shape)}")
    if not on_cuda("ring_phase_c", table, src_bm, dst_loc):
        return ring_phase_c_plain(table, src_bm, dst_loc)
    wc = dst_loc.shape[1]
    if n == 0 or wc == 0:
        return torch.zeros((), dtype=torch.int64, device=src_bm.device)
    lib = _build.kernels()
    nb = n_blocks(n * 32)                      # one warp per src row
    out = torch.empty(nb, dtype=torch.int64, device=src_bm.device)
    _build.check_launch(lib.gm_ring_phase_c(
        table.data_ptr(), table.shape[0], src_bm.data_ptr(),
        dst_loc.data_ptr(), n, words, wc, out.data_ptr(), nb,
        torch.cuda.current_stream(src_bm.device).cuda_stream),
        "ring_phase_c")
    ring_phase_c.launches += 1
    return out.sum()


ring_phase_c.launches = 0


def ring_phase_c_plain(table: torch.Tensor, src_bm: torch.Tensor,
                       dst_loc: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ring_phase_c (any device), in row chunks."""
    n, words = src_bm.shape
    wc = dst_loc.shape[1]
    n_t = table.shape[0]
    step = max(1, PLAIN_ELEMS // max(wc * words, 1))
    total = torch.zeros((), dtype=torch.int64, device=src_bm.device)
    for r0 in range(0, n, step):
        d = dst_loc[r0:r0 + step]
        ok = (d >= 0) & (d < n_t)
        rows = table[torch.where(ok, d, 0)]            # [r, wc, words]
        pc = popcount32(src_bm[r0:r0 + step, None, :] & rows).sum(dim=2)
        total += (pc * ok).sum()
    return total


def ring_tail_pairs(table_a: torch.Tensor, table_b: torch.Tensor,
                    sa: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """Σ_i |table_a[sa[i]] ∩ table_b[sb[i]]| over non-SENTINEL ids."""
    if table_a.dim() != 2 or table_b.dim() != 2 or sa.dim() != 1 or \
            sa.shape != sb.shape:
        raise ValueError(f"tail-pair shapes disagree: {tuple(table_a.shape)}"
                         f" {tuple(table_b.shape)} {tuple(sa.shape)} "
                         f"{tuple(sb.shape)}")
    if not on_cuda("ring_tail_pairs", table_a, table_b, sa, sb):
        return ring_tail_pairs_plain(table_a, table_b, sa, sb)
    (na, wa), (nb_, wb) = table_a.shape, table_b.shape
    n = sa.shape[0]
    total = torch.zeros((), dtype=torch.int64, device=sa.device)
    if n == 0 or wa == 0 or wb == 0:
        return total
    lib = _build.kernels()
    stream = torch.cuda.current_stream(sa.device).cuda_stream
    step = max(1, MAX_ELEMS // wa)
    for i0 in range(0, n, step):
        m = min(step, n - i0)
        nb = n_blocks(m * wa)
        out = torch.empty(nb, dtype=torch.int64, device=sa.device)
        _build.check_launch(lib.gm_ring_tail_pairs(
            table_a.data_ptr(), na, wa, table_b.data_ptr(), nb_, wb,
            sa[i0:].data_ptr(), sb[i0:].data_ptr(), m, out.data_ptr(), nb,
            stream), "ring_tail_pairs")
        ring_tail_pairs.launches += 1
        total += out.sum()
    return total


ring_tail_pairs.launches = 0


def ring_tail_pairs_plain(table_a: torch.Tensor, table_b: torch.Tensor,
                          sa: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ring_tail_pairs (any device): gathers and
    the SENTINEL-masked broadcast compare of _tail_pairs_partials."""
    (na, wa), (nb, wb) = table_a.shape, table_b.shape
    n = sa.shape[0]
    step = max(1, PLAIN_ELEMS // max(wa * wb, 1))
    total = torch.zeros((), dtype=torch.int64, device=sa.device)
    for i0 in range(0, n, step):
        ia, ib = sa[i0:i0 + step], sb[i0:i0 + step]
        oka = (ia >= 0) & (ia < na)
        okb = (ib >= 0) & (ib < nb)
        ra = torch.where(oka[:, None], table_a[torch.where(oka, ia, 0)],
                         SENTINEL)
        rb = torch.where(okb[:, None], table_b[torch.where(okb, ib, 0)],
                         SENTINEL)
        m = (ra[:, :, None] == rb[:, None, :]) & (ra != SENTINEL)[:, :, None]
        total += m.sum()
    return total
