"""Where does an FSM count's time go?

Mines the frequent patterns of rmat(--scale, 8, seed 7) labelled by
default_rng(7).integers(1, 5) (bench.py's FSM graphs), up to --k edges at
each --minsup, with workloads/fsm.py on --device, and prints one JSON line
per count: the count, its wall seconds (host clock, graph in memory), the
host seconds of its phases (fsm_extend and fsm_filter, each with the
support it fuses, and fsm_support), its host syncs, extensions, filters
and overflow retries, and on a card the peak device memory. Then, with
--one, one forward extension of the largest single-edge pattern under
torch.profiler: its device operations (kernels and copies by name), their
device ms, its host seconds and host syncs, and its column blocks.

    python -m graphminer_tpu_torch.scripts.prof_fsm [--device cpu]
        [--scale 16] [--k 2] [--minsup 1000 300] [--one]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from graphminer_tpu_torch.device import resolve_device
from graphminer_tpu_torch.io.synth import rmat
from graphminer_tpu_torch.utils.profiling import PROFILER
from graphminer_tpu_torch.workloads import fsm


def labelled_rmat(scale: int):
    g = rmat(scale, 8, seed=7)
    g.vlabels = np.random.default_rng(7).integers(
        1, 5, g.n_vertices).astype(np.uint8)
    return g


def one_extension(g, dev) -> dict:
    """One forward extension of the largest single-edge pattern, at its
    first allowed (elabel, vlabel), under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    f = fsm._FSM(g, 1, device=dev)
    init = f.initial_patterns()
    for pat, de in init.values():
        la, lb = pat.vlabels
        f.freq_triples.add((min(la, lb), 0, max(la, lb)))
    pat, de = max(init.values(), key=lambda pd: pd[1].n)
    el, label = f._ext_candidates(pat.vlabels[0])[0]
    f.forward_extend(de, 0, label, el)            # warm-up
    PROFILER.counters.clear()
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        ne = f.forward_extend(de, 0, label, el)
        host = time.perf_counter() - t0
    syncs = PROFILER.counters["fsm_host_syncs"]
    ops, ms = {}, 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name[:40]
            ops[name] = ops.get(name, 0) + 1
            ms += e.time_range.elapsed_us() / 1e3
    w, _ = f._call_width(de, 0)
    blk = fsm._blk_for(w, de.cap)
    return {"pattern": [list(pat.vlabels), label], "n_parent": de.n,
            "n_child": ne.n, "width": w, "block": blk,
            "blocks": -(-de.n // blk), "host_s": host,
            "host_syncs": syncs,
            "device_ops": sum(ops.values()) if ops else None,
            "device_ms": ms if ops else None, "ops_by_name": ops}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=int, default=16)
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--minsup", type=int, nargs="+", default=[1000, 300])
    ap.add_argument("--one", action="store_true",
                    help="also profile one forward extension")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    g = labelled_rmat(a.scale)
    out = []
    for minsup in a.minsup:
        PROFILER.seconds.clear()
        PROFILER.counters.clear()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        f = fsm._FSM(g, minsup, device=dev)
        total = f.run(a.k)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        res = {"scale": a.scale, "k": a.k, "minsup": minsup,
               "total": total, "wall_s": time.perf_counter() - t0,
               "phases_s": dict(PROFILER.seconds),
               "counters": dict(PROFILER.counters),
               "patterns_evaluated": len(f.supports),
               "device": str(dev)}
        if dev.type == "cuda":
            res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        print(json.dumps(res), flush=True)
        out.append(res)
        del f
    if a.one:
        res = one_extension(g, dev)
        res["scale"] = a.scale
        print(json.dumps(res), flush=True)
        out.append(res)
    return out


if __name__ == "__main__":
    main()
