"""Task scheduling: splitting the COO edge task list across workers.

The counterpart of graphminer_tpu/parallel/scheduler.py, copied (host numpy;
the assignments are identical). Parity: include/scheduler.h +
src/common/scheduler.cc — round_robin (chunk-cyclic, :34-85),
vertex_chunking (owner = (v/stride)%n, :100-130), least_first (greedy
bin-packing by min(deg(src),deg(dst)) estimate, :133-214). They produce the
per-device index assignments that parallel/mesh.py counts on; least_first
is its default, round-robin chunking the deterministic fallback.
"""
from __future__ import annotations

from typing import List

import numpy as np


def round_robin(n_workers: int, n_tasks: int, chunk: int = 1024
                ) -> List[np.ndarray]:
    """Chunk-cyclic assignment: chunk i goes to worker i % n."""
    idx = np.arange(n_tasks, dtype=np.int64)
    owner = (idx // chunk) % n_workers
    return [idx[owner == w] for w in range(n_workers)]


def vertex_chunking(n_workers: int, src: np.ndarray, stride: int = 256
                    ) -> List[np.ndarray]:
    """Owner of a task = (src_vertex / stride) % n."""
    owner = (src.astype(np.int64) // stride) % n_workers
    idx = np.arange(src.shape[0], dtype=np.int64)
    return [idx[owner == w] for w in range(n_workers)]


def least_first(n_workers: int, deg_src: np.ndarray, deg_dst: np.ndarray,
                chunk: int = 1024) -> List[np.ndarray]:
    """Greedy bin-packing of task chunks by workload estimate
    min(deg(src), deg(dst)) — the scheduler.cc:133-214 heuristic, applied
    per chunk (not per task) to keep shards contiguous-chunk shaped."""
    n = deg_src.shape[0]
    est = np.minimum(deg_src, deg_dst).astype(np.int64)
    n_chunks = -(-n // chunk)
    chunk_cost = np.add.reduceat(est, np.arange(0, n, chunk))
    order = np.argsort(-chunk_cost, kind="stable")
    loads = np.zeros(n_workers, dtype=np.int64)
    owners = np.zeros(n_chunks, dtype=np.int64)
    for c in order:
        w = int(np.argmin(loads))
        owners[c] = w
        loads[w] += chunk_cost[c]
    idx = np.arange(n, dtype=np.int64)
    chunk_of = idx // chunk
    return [idx[owners[chunk_of] == w] for w in range(n_workers)]
