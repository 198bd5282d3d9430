"""Dense-core triangle counting on kernel G.

The counterpart of graphminer_tpu/ops/dense_core.py. Parity/inspiration:
the reference's matrix-multiply-based GPM subsystem
(src/matrix/omp_mm.cpp:104-215): split the graph by degree, count the
triangles of the dense high-degree core by a matrix product (A@A ⊙ A), and
the sparse tail by ordinary intersections (workloads/triangle.py::
triangle_count_hybrid). With an ascending-degree relabel and orientation
the core [core_start, V) is CLOSED (out-neighbours of core vertices are
core vertices), so the core's triangles need no correction terms.

The core's DAG rows D (bit j of row i: the DAG edge i → j, core-local ids)
are packed on the device from the core–core index pairs, `words` int32 a
row (cdiv(C, 32) padded to a multiple of 8, as ops/tri_support.py pads),
and counted by ONE launch of kernel G (ops/cuda_gram.py) with base = mask
= D: out[i] = Σ_t D[t, i] · popcount(D[i] & D[t]) = #{t → i → j, t → j},
so Σ out counts each core triangle t < i < j once — JAX's
Σ (D·Dᵀ) ⊙ D. G multiplies only the 128 x 128 tiles where D has a set
bit (the upper triangle) and never forms the dense [C, C] matrix (at
C = 16384 the packed rows take 32 MiB; JAX's bf16 matrix took 512 MiB).

Left out: _masked_aat_sum's row tiles and bf16/f32 products (G's int8
tensor cores with s32 tile sums and int64 partials) and _scatter_dense
(the rows are packed, never expanded).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..types import cdiv, round_up
from .cuda_gram import bit_gram, plan_gram


def core_rows(dag, core_start: int, device: DeviceLike = "cuda"
              ) -> torch.Tensor:
    """D: int32 [C, words], the packed DAG rows of the core [core_start, V)
    restricted to core columns, built on `device` from the core–core index
    pairs (each pair sets its bit once)."""
    dev = resolve_device(device)
    v = dag.n_vertices
    c = v - core_start
    words = round_up(max(1, cdiv(c, 32)), 8)
    deg = np.diff(dag.rowptr)
    src = np.repeat(np.arange(v, dtype=np.int64), deg)
    dst = dag.colidx.astype(np.int64)
    m = (src >= core_start) & (dst >= core_start)
    key = torch.from_numpy((src[m] - core_start) * (32 * words)
                           + (dst[m] - core_start)).to(dev)
    key = torch.unique(key)
    bits = torch.ones_like(key) << (key & 31)
    rows = torch.zeros(c * words, dtype=torch.int64, device=dev)
    rows.index_add_(0, key >> 5, bits)        # distinct bits: sum == OR
    rows = torch.where(rows >= 1 << 31, rows - (1 << 32), rows)
    return rows.to(torch.int32).view(c, words)


def core_triangles(dag, core_start: int, device: DeviceLike = "cuda") -> int:
    """Triangles with all three vertices in the core [core_start, V): one
    launch of kernel G over the core's packed DAG rows.

    Requires: dag oriented toward higher (degree, id) AFTER an ascending
    degree relabel, so edges point to higher ids and N⁺(core) ⊆ core."""
    d = core_rows(dag, core_start, device)
    return int(bit_gram(d, d, plan=plan_gram(d)).sum())
