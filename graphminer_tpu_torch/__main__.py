"""Command-line interface, in the shape of graphminer_tpu's:

    python -m graphminer_tpu_torch tc <graph_prefix> [--fast]
    python -m graphminer_tpu_torch clique <graph_prefix> 5
    python -m graphminer_tpu_torch sgl <graph_prefix> diamond
    python -m graphminer_tpu_torch motif <graph_prefix> 4 [--fast]
    python -m graphminer_tpu_torch sc <graph_prefix> hourglass
    python -m graphminer_tpu_torch fsm <graph_prefix> 3 100
    python -m graphminer_tpu_torch gks <graph_prefix> 3 1,2,3
    python -m graphminer_tpu_torch query <graph_prefix> 1,2,3:0-1,1-2
    python -m graphminer_tpu_torch info <graph_prefix>

Verbs: `tc` (the generic set-operation path; with --fast the stream
engine), `clique <k>` and `sgl <pattern>` (the plan-interpreting frontier
engine; clique 3 --fast is the stream engine, clique 4|5 --fast the hi/lo
clique engine of ops/cliquek.py, clique k >= 6 --fast the streamed
large-clique engine of ops/cliquebig.py, sgl diamond --fast the triangle
support engine of ops/tri_support.py, sgl rectangle --fast the 4-cycle
engine of ops/rectangle.py and sgl house --fast the house engine of
ops/house.py), `motif <k>` (workloads/motif.py: k = 3 and 4 by the
formulas, over the generic path or with --fast over the fast engines; k =
5 by the fused frontier pass and the containment inversion), `sc
<pattern>` (workloads/count.py), `fsm [k [minsup]]` (workloads/fsm.py,
defaults 2 and 300; vertex and edge labels loaded), `gks [k [kw,kw,...]]`
(workloads/keyword.py, defaults 3 and 1,2,3), `query @<pattern_file> |
vl,...:u-v,...` (workloads/query.py; gks and query load vertex labels)
and `info`, with the --cpu, --json,
--profile, --chunk, --backend and --engine flags (their defaults come from
GRAPHMINER_* variables through Config.from_env). --profile turns on the
profiler (utils/profiling.py::PROFILER: a count's spans record, and a count
times its device work with a CUDA event pair, the phase device_count) and
prints its report: phases_s (each span's total seconds), phases_self_s
(its self seconds), counters (kernels.built among them) and
`kernel_launches`, the launches of kernels A (stream_bucket_count), B
(ring_phase_c), C (ring_tail_pairs), E (hub_tail_count), X (expand_bits),
L (lo_popcount), G (bit_gram), Q (quad_emit, quad_count), S
(tri_bitmap), P (tri_probe), I (tri_lists), W (bit_colsum, its write
mode; colsum_pairs and colsum_finish, its pairs mode) and H (house_t3) in
this process; on a large-clique count its phases_s also hold the host
seconds of the count's steps (host_hi, host_lo and, at k = 6,
host_hi_estimate, host_hi_triangles, host_hi_h2d, host_hi_offsets,
host_hi_quad_gram); fsm, gks and query launch none of them, and fsm's
profile also holds the counter fsm_overflow_retries. Without --cpu the
count runs on CUDA, and it fails when no card is visible. For tc and
clique, --partition N counts over N induced halo partitions in turn
(parallel/distributed.py) and --sharded shards the edge tasks over every
visible card, or over the CPU with --cpu (parallel/mesh.py); --partition
takes precedence over --sharded, and --sharded over --fast. Both run the
frontier engine, no kernel of ours.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

VERBS = ["tc", "clique", "sgl", "motif", "sc", "fsm", "gks", "query", "info"]


def _scale_out(g, plan, ns, device):
    """The count of `plan` over --partition N induced partitions in turn
    on `device`, or else sharded over every visible card (--sharded; one
    CPU device with --cpu)."""
    if ns.partition:
        from .parallel.distributed import count_pattern_partitioned
        return count_pattern_partitioned(g, plan, ns.partition,
                                         chunk=ns.chunk, device=device)
    from .parallel.mesh import count_pattern_sharded, make_mesh
    mesh = make_mesh(devices=[device] if device.type == "cpu" else None)
    return count_pattern_sharded(g, plan, mesh=mesh, chunk=ns.chunk)


def main(argv=None):
    from .config import Config
    cfg = Config.from_env()          # GRAPHMINER_* env vars seed the defaults
    p = argparse.ArgumentParser(prog="graphminer_tpu_torch")
    p.add_argument("workload", choices=VERBS)
    p.add_argument("graph", help="graph prefix (…/graph)")
    p.add_argument("args", nargs="*", help="workload args")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain PyTorch versions of the "
                        "kernels) instead of CUDA")
    p.add_argument("--sharded", action="store_true",
                   help="tc and clique: shard the edge tasks over all "
                        "visible cards (the CPU with --cpu)")
    p.add_argument("--chunk", type=int, default=cfg.chunk,
                   help="edge tasks per device chunk")
    p.add_argument("--backend", default=cfg.backend,
                   help="setops backend: auto | bc | bs")
    p.add_argument("--engine", default=cfg.engine,
                   help="frontier engine: compact | map")
    p.add_argument("--fast", action="store_true",
                   help="fast engines: tc and clique 3 = stream engine, "
                        "clique 4|5 = hi/lo clique engine (CliqueKEngine), "
                        "clique k >= 6 = large-clique engine "
                        "(CliqueBigEngine), sgl diamond = triangle support "
                        "engine, sgl rectangle = 4-cycle engine, sgl "
                        "house = house engine, motif 3|4 = formula over the "
                        "fast engines")
    p.add_argument("--partition", type=int, default=0, metavar="N",
                   help="tc and clique: count over N induced halo "
                        "partitions in turn (out-of-core)")
    p.add_argument("--profile", action="store_true",
                   help="print the span/counter profiler report and the "
                        "kernel launch counts (a count also times its "
                        "device work with a CUDA event pair)")
    p.add_argument("--json", action="store_true", help="machine output")
    ns = p.parse_args(argv)
    if ns.profile:
        from .utils.profiling import PROFILER
        PROFILER.enabled = True

    from .device import resolve_device
    try:
        device = resolve_device("cpu" if ns.cpu else "cuda")
    except RuntimeError as e:
        raise SystemExit(f"graphminer_tpu_torch: {e}") from None

    from . import load_graph

    needs_labels = ns.workload in ("fsm", "gks", "query")
    t0 = time.time()
    g = load_graph(ns.graph, use_vlabel=needs_labels,
                   use_elabel=ns.workload == "fsm")
    t_load = time.time() - t0

    t0 = time.time()
    out = {}
    run = dict(chunk=ns.chunk, backend=ns.backend, engine=ns.engine,
               device=device)
    if ns.workload == "info":
        out = {"V": g.n_vertices, "E": g.n_edges, "max_degree": g.max_degree,
               "has_vlabels": g.vlabels is not None}
    elif ns.workload == "tc" and (ns.partition or ns.sharded):
        from .core.plan import TRIANGLE
        out["total"] = _scale_out(g, TRIANGLE, ns, device)
    elif ns.workload == "tc":
        if ns.fast:
            from .ops.stream import triangle_count_stream
            out["total"] = triangle_count_stream(g, device=device)
        else:
            from .workloads.triangle import triangle_count
            out["total"] = triangle_count(g, chunk=ns.chunk,
                                          backend=ns.backend,
                                          bucketed=cfg.bucketed,
                                          device=device)
    elif ns.workload == "clique":
        from .workloads.clique import clique_count
        k = int(ns.args[0]) if ns.args else 4
        if ns.partition or ns.sharded:
            from .core.plan import clique_plan
            out["total"] = _scale_out(g, clique_plan(k), ns, device)
        else:
            out["total"] = clique_count(g, k, fast=ns.fast, **run)
        out["k"] = k
    elif ns.workload == "sgl":
        from .workloads.sgl import sgl_count
        # pattern = a name (diamond, house, …) or @<pattern_file> in the
        # reference's adjacency-text / CSR-binary formats (pattern.cc:80)
        pattern = ns.args[0] if ns.args else "diamond"
        out["total"] = sgl_count(g, pattern, fast=ns.fast, **run)
        out["pattern"] = pattern
    elif ns.workload == "motif":
        from .workloads.motif import motif_count
        k = int(ns.args[0]) if ns.args else 4
        out["counts"] = motif_count(g, k, chunk=ns.chunk, fast=ns.fast,
                                    device=device)
        out["k"] = k
    elif ns.workload == "sc":
        from .workloads.count import sc_count
        pattern = ns.args[0] if ns.args else "hourglass"
        out["total"] = sc_count(g, pattern, chunk=ns.chunk, device=device)
        out["pattern"] = pattern
    elif ns.workload == "fsm":
        from .workloads.fsm import fsm_count
        k = int(ns.args[0]) if ns.args else 2
        minsup = int(ns.args[1]) if len(ns.args) > 1 else 300
        out["total"] = fsm_count(g, k, minsup, device=device)
        out.update(k=k, minsup=minsup)
    elif ns.workload == "query":
        # labeled subgraph query (reference query_omp_base: src/query/main.cc
        # `query <data_graph> <query_graph>`): @<pattern_file> in the
        # reference's adj-text/CSR formats, or an inline spec
        # "<vl0>,<vl1>,...:<u>-<v>,<u>-<v>,..." (labels : edges)
        from .core.pattern_graph import PatternGraph
        from .workloads.query import make_query, query_count
        spec = ns.args[0] if ns.args else None
        if spec is None:
            raise SystemExit("query needs @<pattern_file> or vl,..:u-v,..")
        if spec.startswith("@"):
            q = PatternGraph.from_file(spec[1:])
        else:
            labs, _, edges = spec.partition(":")
            q = make_query([tuple(int(x) for x in e.split("-"))
                            for e in edges.split(",") if e],
                           [int(x) for x in labs.split(",")])
        out["total"] = query_count(g, q, chunk=ns.chunk, device=device)
        out["query"] = spec
    elif ns.workload == "gks":
        from .workloads.keyword import gks_count
        k = int(ns.args[0]) if ns.args else 3
        kws = [int(x) for x in (ns.args[1] if len(ns.args) > 1
                                else "1,2,3").split(",")]
        out["total"] = gks_count(g, k, kws, device=device)
        out.update(k=k, keywords=kws)
    out["load_s"] = round(t_load, 3)
    out["run_s"] = round(time.time() - t0, 3)
    if ns.profile:
        import torch
        from .ops.cuda_cliquebig import quad_count, quad_emit
        from .ops.cuda_cliquek import lo_popcount
        from .ops.cuda_colsum import bit_colsum, colsum_finish, colsum_pairs
        from .ops.cuda_expand import expand_bits
        from .ops.cuda_gram import bit_gram
        from .ops.cuda_house import house_t3
        from .ops.cuda_hubcore import hub_tail_count
        from .ops.cuda_ring import ring_phase_c, ring_tail_pairs
        from .ops.cuda_stream import stream_bucket_count
        from .ops.cuda_tri import tri_bitmap, tri_lists, tri_probe
        from .utils.profiling import PROFILER
        rep = PROFILER.report()
        dt = rep["phases_s"].get("device_count", 0.0)
        ops = rep["counters"].get("set_ops_level2", 0)
        if dt and ops:
            rep["set_intersections_per_s"] = ops / dt
        rep["device"] = str(device)
        if device.type == "cuda":
            rep["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        rep["kernel_launches"] = {
            f.__name__: f.launches
            for f in (stream_bucket_count, ring_phase_c, ring_tail_pairs,
                      hub_tail_count, expand_bits, lo_popcount, bit_gram,
                      quad_emit, quad_count, tri_bitmap, tri_probe,
                      tri_lists, bit_colsum, colsum_pairs, colsum_finish,
                      house_t3)}
        out["profile"] = rep

    if ns.json:
        print(json.dumps(out))
    else:
        for k, v in out.items():
            print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
