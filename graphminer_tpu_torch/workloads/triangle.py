"""Triangle counting (TC).

The counterpart of graphminer_tpu/workloads/triangle.py. Parity:
src/triangle/ in the reference — omp_base.cc:5-27 (vertex-parallel
Σ|N(u)∩N(v)| over the DAG) and bs_warp_edge.cuh:1-19 (edge-parallel warp
kernel). Orient once on the host, materialize the COO task list, then a
chunked edge-parallel batched intersect-count on the device (ops/setops.py;
no kernel of ours: compares and searches are torch ops). This is the CLI's
default `tc` and the oracle the fast engines are held against.

triangle_count_hybrid counts the dense core on kernel G (ops/dense_core.py)
and the tail edges by the same intersect path.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.device_graph import DeviceGraph, to_device
from ..device import DeviceLike, resolve_device
from ..ops import setops
from ..utils.exec import map_chunked, sum_chunked


def _edge_tc_kernel(dg: DeviceGraph, width: int, backend: str,
                    src: torch.Tensor, dst: torch.Tensor,
                    width_b: int = None) -> torch.Tensor:
    a = dg.gather_rows(src, width)
    b = dg.gather_rows(dst, width_b or width)
    return setops.intersect_count(a, b, backend=backend)


def _tc_device(dg: DeviceGraph, src, dst, *, width: int, chunk: int,
               backend: str, width_b: int = None) -> torch.Tensor:
    fn = functools.partial(_edge_tc_kernel, dg, width, backend,
                           width_b=width_b)
    return sum_chunked(fn, (src, dst), chunk)


def triangle_count(g, chunk: int = 16384, backend: str = "auto",
                   bucketed: bool = True,
                   device: DeviceLike = "cuda") -> int:
    """Exact triangle count of an undirected graph (HostGraph).

    bucketed=True partitions edges by endpoint degree class and runs one
    fixed-width step per class pair (the reference's warp/CTA strategy
    dispatch) — the default; exactness is unaffected. The total is an int64
    on the device, read back once."""
    from ..utils.profiling import PROFILER
    dev = resolve_device(device)
    if not g.is_dag:
        with PROFILER.span("orient"):
            g = g.orientation()
    with PROFILER.span("prep"):
        dg = DeviceGraph.from_host(g, device=dev)
        src, dst = g.edge_list()
    PROFILER.count("edge_tasks", int(src.shape[0]))
    PROFILER.count("set_ops_level2", int(src.shape[0]))
    with PROFILER.span("device_count", dev, hot=True):
        if not bucketed:
            width = max(8, g.max_degree)
            total = _tc_device(dg, to_device(src, dev), to_device(dst, dev),
                               width=width, chunk=chunk, backend=backend)
            return int(total)

        from ..utils.bucketing import bucket_edge_tasks, pick_chunk
        deg = np.diff(g.rowptr)
        order, groups = bucket_edge_tasks(deg[src], deg[dst],
                                          max(8, g.max_degree))
        src, dst = src[order], dst[order]
        total = torch.zeros((), dtype=torch.int64, device=dev)
        for s, e, wa, wb in groups:
            c = pick_chunk(e - s, max_chunk=chunk)
            total += _tc_device(dg, to_device(src[s:e], dev),
                                to_device(dst[s:e], dev), width=wa,
                                width_b=wb, chunk=c, backend=backend)
        return int(total)


def triangle_count_fast(g, **kw) -> int:
    """The hub-core engine (ops/hubcore.py: kernel E and the spoke
    product); exact."""
    from ..ops.hubcore import triangle_count_fast as _fast
    return _fast(g, **kw)


def triangle_count_hybrid(g, core_size: int = 16384, chunk: int = 16384,
                          backend: str = "auto",
                          device: DeviceLike = "cuda") -> int:
    """Hybrid exact triangle count (the reference's matrix/ GEMM +
    intersection split, omp_mm.cpp:104-215).

    Ascending-degree relabel → orientation points to higher ids → the
    high-degree core [V-C, V) is closed under out-neighbors, so core-core
    edges are counted entirely by one launch of kernel G
    (ops/dense_core.py); edges with a tail endpoint go through the bucketed
    intersect path with small widths (torch ops)."""
    from ..ops.dense_core import core_triangles
    from ..utils.bucketing import bucket_edge_tasks, pick_chunk

    assert not g.is_dag, "hybrid path needs the undirected graph (it relabels)"
    dev = resolve_device(device)
    rg = g.relabel_by_degree(descending=False).orientation()
    v = rg.n_vertices
    core_start = v - min(core_size, v)

    total = core_triangles(rg, core_start, dev)

    src, dst = rg.edge_list()
    tail = (src < core_start) | (dst < core_start)
    src, dst = src[tail], dst[tail]
    if src.size:
        dg = DeviceGraph.from_host(rg, device=dev)
        deg = np.diff(rg.rowptr)
        order, groups = bucket_edge_tasks(deg[src], deg[dst],
                                          max(8, rg.max_degree))
        src, dst = src[order], dst[order]
        part = torch.zeros((), dtype=torch.int64, device=dev)
        for s, e, wa, wb in groups:
            ck = pick_chunk(e - s, max_chunk=chunk)
            part += _tc_device(dg, to_device(src[s:e], dev),
                               to_device(dst[s:e], dev), width=wa,
                               width_b=wb, chunk=ck, backend=backend)
        total += int(part)
    return total


def triangles_per_edge(g, src, dst, chunk: int = 4096,
                       backend: str = "auto",
                       device: DeviceLike = "cuda") -> torch.Tensor:
    """tri_e = |N(u) ∩ N(v)| per (u,v) task on the *given* graph (use the
    undirected graph for full per-edge triangle support — the building block
    of the motif formula path and FSM edge support). int32 [n] on the
    device."""
    dev = resolve_device(device)
    dg = DeviceGraph.from_host(g, device=dev)
    width = max(8, g.max_degree)
    fn = functools.partial(_edge_tc_kernel, dg, width, backend)
    out = map_chunked(fn, (to_device(src, dev), to_device(dst, dev)), chunk)
    return out[: len(src)]
