"""Scale-out dryrun: sharded, single-device and partitioned counts agree.

The port of __graft_entry__.py::dryrun_multichip. It builds an n-shard
("host", "chip") mesh (2 x n/2 when n is even) over the visible cards,
repeating a card when there are fewer than n (its shards then run in
turn), and checks on RMAT graphs (edge factor 8, seed 3, oriented):

* scale 8: the sharded triangle and diamond counts run;
* scale 14: the triangle count on a (1, 1) mesh, on the n-shard mesh and
  over max(2, hosts) induced halo partitions are equal;
* scale 14: least_first spreads the work over n shards within 1.05
  (max / min of each shard's Σ min(deg(src), deg(dst))), and its heaviest
  shard is at most 1.05 times round_robin's.

    python -m graphminer_tpu_torch.scripts.dryrun_multichip [--n 4]
        [--device cuda|cpu]

Prints the per-partition sizes, the counts with their host seconds and the
balance, and raises on a disagreement.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..core.plan import SGL_PLANS, TRIANGLE
from ..device import resolve_device
from ..io.synth import rmat
from ..parallel.distributed import count_pattern_partitioned
from ..parallel.mesh import count_pattern_sharded, make_mesh, shard_balance
from ..parallel.partition import induced_partition_1d


def _check(cond, msg):
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _spread(balance):
    return max(w for _, w in balance) / max(1, min(w for _, w in balance))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4, help="shards")
    ap.add_argument("--device", default="cuda", help="cuda | cpu")
    ns = ap.parse_args(argv)
    n = ns.n
    dev = resolve_device(ns.device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        devices = [f"cuda:{i % count}" for i in range(n)]
    else:
        devices = ["cpu"] * n
    n_host = 2 if n % 2 == 0 and n > 1 else 1
    mesh = make_mesh(devices=devices, shape=(n_host, n // n_host))

    g = rmat(8, 8, seed=3).orientation()
    total = count_pattern_sharded(g, TRIANGLE, mesh=mesh, chunk=64)
    total2 = count_pattern_sharded(g.sort_neighbors(), SGL_PLANS["diamond"],
                                   mesh=mesh, chunk=64)
    _check(total >= 0 and total2 >= 0, f"rmat8 counts {total}, {total2}")

    g14 = rmat(14, 8, seed=3).orientation()
    mesh1 = make_mesh(devices=devices[:1], shape=(1, 1))
    t0 = time.perf_counter()
    single = count_pattern_sharded(g14, TRIANGLE, mesh=mesh1, chunk=2048)
    dt1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    full = count_pattern_sharded(g14, TRIANGLE, mesh=mesh, chunk=2048)
    dtn = time.perf_counter() - t0
    _check(full == single, f"rmat14 mesh {mesh.shape} {full} != (1, 1) "
           f"{single}")
    n_parts = max(2, n_host)
    t0 = time.perf_counter()
    part = count_pattern_partitioned(g14, TRIANGLE, n_parts=n_parts,
                                     device=devices[0])
    dtp = time.perf_counter() - t0
    _check(part == single, f"rmat14 over {n_parts} partitions {part} != "
           f"{single}")
    parts4 = induced_partition_1d(g14, 4, hops=1)
    print("partition4 rmat14: " + " ".join(
        f"p{i}[owned={p.n_owned},local_edges={p.graph.n_edges}]"
        for i, p in enumerate(parts4)), flush=True)

    lf = shard_balance(g14, n, chunk=2048, policy="least_first")
    rr = shard_balance(g14, n, chunk=2048, policy="round_robin")
    _check(max(w for _, w in lf) <= 1.05 * max(w for _, w in rr),
           f"least_first {lf} heavier than round_robin {rr}")
    _check(_spread(lf) <= 1.05, f"least_first spread {_spread(lf):.3f}: "
           f"{lf}")
    print(f"dryrun_multichip ok: mesh={mesh.shape} on {devices} "
          f"triangles={total} diamond={total2} rmat14_tc={single} "
          f"t(1,1)={dt1:.2f}s t{tuple(mesh.shape.values())}={dtn:.2f}s "
          f"partitioned={part} ({n_parts} parts, {dtp:.2f}s)", flush=True)
    print(f"balance rmat14 x{n}: least_first tasks/shard="
          f"{[k for k, _ in lf]} work/shard={[w for _, w in lf]} "
          f"spread={_spread(lf):.3f}; round_robin work/shard="
          f"{[w for _, w in rr]} spread={_spread(rr):.3f}", flush=True)
    return {"triangles": total, "diamond": total2, "rmat14_tc": single,
            "partitioned": part, "t_single_s": dt1, "t_mesh_s": dtn,
            "t_partitioned_s": dtp, "spread_least_first": _spread(lf),
            "spread_round_robin": _spread(rr)}


if __name__ == "__main__":
    main()
