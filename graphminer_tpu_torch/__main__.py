"""Command-line interface, in the shape of graphminer_tpu's:

    python -m graphminer_tpu_torch tc <graph_prefix> [--fast]
    python -m graphminer_tpu_torch clique <graph_prefix> 5
    python -m graphminer_tpu_torch sgl <graph_prefix> diamond
    python -m graphminer_tpu_torch info <graph_prefix>

Ported so far: `tc` (the generic set-operation path; with --fast the stream
engine), `clique <k>` and `sgl <pattern>` (the plan-interpreting frontier
engine; clique 3 --fast is the stream engine, clique 4|5 --fast the hi/lo
clique engine of ops/cliquek.py, clique k >= 6 --fast the streamed
large-clique engine of ops/cliquebig.py, sgl diamond --fast the triangle
support engine of ops/tri_support.py and sgl rectangle --fast the 4-cycle
engine of ops/rectangle.py) and `info`, with the --cpu,
--json, --profile, --chunk, --backend and --engine flags (their defaults
come from GRAPHMINER_* variables through Config.from_env). --profile adds
`kernel_launches`, the launches of kernels A (stream_bucket_count), B
(ring_phase_c), C (ring_tail_pairs), E (hub_tail_count), X (expand_bits),
L (lo_popcount), G (bit_gram), Q (quad_emit, quad_count), S
(tri_bitmap), P (tri_probe), I (tri_lists) and W (bit_colsum, its write
mode; colsum_pairs and colsum_finish, its pairs mode) in this process; on
a large-clique count its phases_s also hold the host seconds of the
count's steps (host_hi, host_lo and, at k = 6, host_hi_estimate,
host_hi_triangles, host_hi_h2d, host_hi_offsets, host_hi_quad_gram). Without
--cpu the count runs on CUDA, and it fails when no card is visible. Every
other verb, the fast house engine, and the --sharded and --partition flags
are not ported yet: they exit non-zero and name ROADMAP.md, and nothing
runs in their place.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

VERBS = ["tc", "clique", "sgl", "motif", "sc", "fsm", "gks", "query", "info"]
PORTED_VERBS = ("tc", "clique", "sgl", "info")


def _not_ported(what: str) -> None:
    raise SystemExit(f"graphminer_tpu_torch: {what} is not ported yet "
                     "(see ROADMAP.md)")


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
                   help="shard over all visible devices (not ported)")
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
                        "engine, sgl rectangle = 4-cycle engine")
    p.add_argument("--partition", type=int, default=0, metavar="N",
                   help="(not ported)")
    p.add_argument("--profile", action="store_true",
                   help="print the phase/counter profiler report and the "
                        "kernel launch counts")
    p.add_argument("--json", action="store_true", help="machine output")
    ns = p.parse_args(argv)

    if ns.workload not in PORTED_VERBS:
        _not_ported(f"the '{ns.workload}' verb")
    for flag in ("sharded", "partition"):
        if getattr(ns, flag):
            _not_ported(f"--{flag}")

    from .device import resolve_device
    try:
        device = resolve_device("cpu" if ns.cpu else "cuda")
    except RuntimeError as e:
        raise SystemExit(f"graphminer_tpu_torch: {e}") from None

    from . import load_graph

    t0 = time.time()
    g = load_graph(ns.graph)
    t_load = time.time() - t0

    t0 = time.time()
    out = {}
    run = dict(chunk=ns.chunk, backend=ns.backend, engine=ns.engine,
               device=device)
    if ns.workload == "info":
        out = {"V": g.n_vertices, "E": g.n_edges, "max_degree": g.max_degree,
               "has_vlabels": g.vlabels is not None}
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
        out["total"] = clique_count(g, k, fast=ns.fast, **run)
        out["k"] = k
    elif ns.workload == "sgl":
        from .workloads.sgl import sgl_count
        # pattern = a name (diamond, house, …) or @<pattern_file> in the
        # reference's adjacency-text / CSR-binary formats (pattern.cc:80)
        pattern = ns.args[0] if ns.args else "diamond"
        out["total"] = sgl_count(g, pattern, fast=ns.fast, **run)
        out["pattern"] = pattern
    out["load_s"] = round(t_load, 3)
    out["run_s"] = round(time.time() - t0, 3)
    if ns.profile:
        import torch
        from .ops.cuda_cliquebig import quad_count, quad_emit
        from .ops.cuda_cliquek import lo_popcount
        from .ops.cuda_colsum import bit_colsum, colsum_finish, colsum_pairs
        from .ops.cuda_expand import expand_bits
        from .ops.cuda_gram import bit_gram
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
                      tri_lists, bit_colsum, colsum_pairs, colsum_finish)}
        out["profile"] = rep

    if ns.json:
        print(json.dumps(out))
    else:
        for k, v in out.items():
            print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
