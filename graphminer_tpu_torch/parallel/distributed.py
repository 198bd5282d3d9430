"""Multi-process distribution: torch.distributed init + partitioned counting.

The counterpart of graphminer_tpu/parallel/distributed.py. Parity targets:
  * MPI multi-node counting — rank computes an edge range of the full graph,
    MPI_Allreduce sums (src/triangle/dist_cpu.cpp:33-57, dist_gpu.cpp:9-34):
    here torch.distributed over gloo, one int64 all_reduce of the ranks'
    counts.
  * Partitioned counting for graphs too big to replicate — each worker gets
    a vertex-induced halo partition (graph_partition.cc:82-160) and counts
    only tasks anchored at OWNED vertices; the partial counts sum exactly.

Two product entry points:
  count_pattern_partitioned(g, plan, n_parts)   — single process, partitions
      counted in turn (the out-of-core path: one partition's device graph
      resident at a time).
  count_pattern_multiprocess(g, plan)           — after init_distributed(),
      each process counts its own partition on its card and the counts are
      summed over every process (the dist_gpu equivalent).

The sum goes over gloo as one int64 CPU tensor: exact, and it works when
several ranks share one card (NCCL refuses two ranks on one GPU). Left out:
jax.distributed and the allgather of every process's count (one all_reduce
gives the sum).
"""
from __future__ import annotations

import atexit
import os
from typing import Optional

import numpy as np
import torch

from ..core.plan import Plan
from ..engine.frontier import count_pattern
from .partition import induced_partition_1d


def plan_halo_hops(plan: Plan) -> int:
    """Halo radius a plan needs under owned-anchor partitioned counting.

    1 when every matched vertex is constrained to N(v0) (source adj0, or
    intersects v0's row, or derives from a level-2-anchored stored set) —
    then every vertex of every counted embedding lies in the 1-hop halo of
    v0 and restricted outer-shell rows are complete. Otherwise 2 (the plans
    in core.plan walk at most one edge away from {v0, v1})."""
    anchored = {0, 1}            # vertex levels guaranteed inside N[v0] ∪ {v1}
    anchored_sets = set()
    for i, lp in enumerate(plan.levels):
        idx = i + 2
        kind, j = lp.source
        ok = (kind == 'adj' and j == 0) or \
             (kind == 'set' and j in anchored_sets) or (0 in lp.intersect)
        if ok:
            anchored.add(idx)
            if lp.store:
                anchored_sets.add(idx)
    return 1 if all(i in anchored for i in range(2, plan.k)) else 2


def _count_partition(part, plan: Plan, **kw) -> int:
    """Count plan embeddings whose anchor v0 is OWNED by this partition —
    via count_pattern's candidate-mask mechanism (anchor restricted to owned
    locals; every global task has exactly one owner)."""
    g = part.graph
    assert plan.multiplicity == 1, \
        "partitioned counting needs symmetry-broken (multiplicity-1) plans"
    cand = np.ones((plan.k, g.n_vertices), dtype=np.int8)
    cand[0, ~part.owned_mask] = 0   # anchor must be owned
    return count_pattern(g, plan, cand=cand, **kw)


def count_pattern_partitioned(g, plan: Plan, n_parts: int,
                              hops: Optional[int] = None, **kw) -> int:
    """Exact pattern count over n_parts induced halo partitions, counted in
    turn in one process — the out-of-core product path
    (graph_partition.cc:82-160 promoted from tests to product). kw goes to
    count_pattern (chunk, device, ...).

    Orientation/relabeling happen on the GLOBAL graph first (the partition
    contract); each partition counts tasks anchored at its owned vertices."""
    if plan.use_dag and not g.is_dag:
        g = g.orientation()
    hops = hops or plan_halo_hops(plan)
    parts = induced_partition_1d(g, n_parts, hops=hops)
    total = 0
    for p in parts:
        total += _count_partition(p, plan, **kw)
    return total // plan.multiplicity


# --------------------------------------------------------------------------
# multi-process (torch.distributed over gloo)
# --------------------------------------------------------------------------

def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """torch.distributed.init_process_group over gloo from the arguments or
    the GRAPHMINER_COORDINATOR ("host:port" of rank 0),
    GRAPHMINER_NUM_PROCESSES and GRAPHMINER_PROCESS_ID variables (the
    MPI_Init equivalent). A no-op with fewer than two processes, no
    coordinator or no process id, and when already initialized. The group
    is destroyed at the process's exit, unless the caller has."""
    import torch.distributed as dist
    coordinator = coordinator or os.environ.get("GRAPHMINER_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("GRAPHMINER_NUM_PROCESSES", "0"))
    if process_id is None:
        process_id = int(os.environ.get("GRAPHMINER_PROCESS_ID", "-1"))
    if not coordinator or num_processes <= 1 or process_id < 0 or \
            dist.is_initialized():
        return
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    atexit.register(_destroy)


def _destroy() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def count_pattern_multiprocess(g, plan: Plan, hops: Optional[int] = None,
                               device=None, **kw) -> int:
    """Per-process partition count + exact global sum over every process
    (the tc_dist_gpu shape: rank-local count, Allreduce).

    Call init_distributed() first (without it this process is the only
    one). Every process must call this with the same (global) graph and
    plan; each counts its own induced partition on `device`, by default
    cuda:{rank % device_count} (no card: it raises), and returns the exact
    global count."""
    import torch.distributed as dist
    multi = dist.is_available() and dist.is_initialized()
    n_proc = dist.get_world_size() if multi else 1
    pid = dist.get_rank() if multi else 0
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("count_pattern_multiprocess: no CUDA device "
                               "is visible (pass device='cpu' to count on "
                               "the CPU)")
        device = f"cuda:{pid % torch.cuda.device_count()}"
    if plan.use_dag and not g.is_dag:
        g = g.orientation()
    hops = hops or plan_halo_hops(plan)
    parts = induced_partition_1d(g, n_proc, hops=hops)
    local = _count_partition(parts[pid], plan, device=device, **kw) \
        if pid < len(parts) else 0
    total = torch.tensor([local], dtype=torch.int64)
    if multi:
        dist.all_reduce(total, op=dist.ReduceOp.SUM)
    return int(total[0]) // plan.multiplicity
