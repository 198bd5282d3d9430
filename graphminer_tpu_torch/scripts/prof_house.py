"""Kernel H (ops/cuda_house.py) against its first design and variants, in
turns.

Builds the two calls of kernel H that ops/house.py::house_calls makes for
the house count of rmat(--scale, 16, seed 7) at --core (4096; the sparse
view) and prints what each call's plan holds (cuda_house.house_work:
items, tasks dotted over n, list slots built over the distinct slots, ids
walked, table rows read, popcounts issued, the tasks on either side of
the plan's density threshold LIST_SPARSE) beside the first design's, and
the time of cuda_house.plan_house on the tensors' device. Then it times H
in one process on the card, in turns (a b c, c b a): as the house engine
calls it, its plan included; over a plan built before the call; over
that plan without the view; --first-design DIR (DIR/graphminer_tpu_torch/
csrc/house_t3.cu, an older checkout's, launched as that checkout's
wrapper launched it, its plan and its check's sync included: pieces of
1,024 tasks and segments of 1,024 slots); and each --variant
NAME=[FILE][:MACRO=VALUE,...][|KEY=VALUE,...] (a copy of
csrc/house_t3.cu with the built one's arguments, or the built source with
other macros: H_MIN_BLOCKS_WARP, H_MIN_BLOCKS_BLOCK; each compiled into a
library of its own under graph_cache/; no FILE: the built library; after
the bar, other arguments of cuda_house.plan_house, over a plan built
before the call). Every result must equal the plain version's.
With --first-design and --count-reps R > 0 it also times the whole
house_count_fast on the card in turns (first design, this checkout, this
checkout, first design), each a process of its own that imports the
checkout's package, counts once to build and warm up, then R times.
Prints one JSON line: per call and variant the event-timed ms of each turn
(CUDA events, median of --reps calls, the host's dispatch and any plan
included), the device ms of the kernel alone (torch.profiler over 50
calls), the bytes bound (utils/profiling.py::house_bytes); the counts'
host seconds; and the card's name and power limit.

    python -m graphminer_tpu_torch.scripts.prof_house [--scale 18]
        [--core 4096] [--device cuda]
        [--first-design graph_cache/parent] [--count-reps 3]
        [--variant NAME=[FILE][:M=V,...][|K=V,...] ...] [--reps 11]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import torch

from graphminer_tpu_torch.io.synth import rmat
from graphminer_tpu_torch.ops import _build
from graphminer_tpu_torch.ops import cuda_house as ch
from graphminer_tpu_torch.ops import tri_support as ts
from graphminer_tpu_torch.ops._tensors import BLOCK, GRID_CAP
from graphminer_tpu_torch.ops.cuda_tri import _starts
from graphminer_tpu_torch.ops.house import house_calls
from graphminer_tpu_torch.utils import profiling as pf

#: the first design's pieces and segments (its cuda_house.PIECE, SEG)
FIRST_PIECE = FIRST_SEG = 1024
#: one process's house counts: a warm-up count, then R timed ones (host
#: seconds, the card synchronized before and after each)
COUNT_CODE = """
import json, sys, time, torch
from graphminer_tpu_torch.io.synth import rmat
from graphminer_tpu_torch.ops.house import house_count_fast
scale, core, reps = (int(x) for x in sys.argv[1:4])
g = rmat(scale, 16, seed=7)
n = house_count_fast(g, core, "cuda")
s = []
for _ in range(reps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    assert house_count_fast(g, core, "cuda") == n
    torch.cuda.synchronize()
    s.append(time.perf_counter() - t0)
print(json.dumps({"count": n, "s": s}))
"""
#: the first design's entry point's arguments
FIRST_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + \
    [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_void_p,
                             ctypes.c_int64, ctypes.c_void_p]


def first_plan(ft, a, piece: int = FIRST_PIECE,
               seg: int = FIRST_SEG) -> torch.Tensor:
    """The first design's items on a's device (its plan_house, about 15
    torch ops with host syncs): int32 [m, 4] (first task, tasks, first
    slot, slots), a piece of at most `piece` tasks of a run of equal a and
    a segment of at most `seg` slots, heaviest first."""
    n = a.shape[0]
    dev = a.device
    new = _starts(a)
    first = torch.nonzero(new).flatten()
    run_first = first[torch.cumsum(new.long(), 0) - 1]
    brk = new | ((torch.arange(n, device=dev) - run_first) % piece == 0)
    first = torch.nonzero(brk).flatten()
    tasks = torch.diff(first, append=torch.tensor([n], device=dev))
    ln = ft.lengths(a[first])[1]
    keep = ln > 0
    first, tasks, ln = first[keep], tasks[keep], ln[keep]
    nseg = (ln + seg - 1) // seg
    rep = torch.repeat_interleave(torch.arange(first.shape[0], device=dev),
                                  nseg)
    s0 = (torch.arange(rep.shape[0], device=dev) -
          torch.repeat_interleave(torch.cumsum(nseg, 0) - nseg, nseg)) * seg
    slots = torch.clamp(ln[rep] - s0, max=seg)
    items = torch.stack([first[rep], tasks[rep], s0, slots], 1)
    order = torch.sort(slots + tasks[rep], descending=True,
                       stable=True).indices
    return items[order].to(torch.int32).contiguous()


def compile_lib(src: str, tag: str, macros=(), argtypes=None):
    """gm_house_t3 of the CUDA source `src` (which may include the
    package's common.cuh) compiled with -D`macros` into
    graph_cache/libhouse_<tag>.so."""
    out_dir = os.path.join(os.path.dirname(_build._PKG), "graph_cache")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, f"libhouse_{tag}.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC,
                    *[f"-D{m}" for m in macros], "-shared", "-o", lib_path,
                    src], check=True, capture_output=True)
    fn = ctypes.CDLL(lib_path).gm_house_t3
    fn.argtypes = argtypes or _build._SIGNATURES["gm_house_t3"]
    fn.restype = ctypes.c_int
    return fn


def first_design(fn):
    """H as the first design's wrapper launched it: the longest list read
    back for its int32 guard, its plan each call, a warp an item,
    min(GRID_CAP, m / 8) blocks."""
    def run(ft, tab, a, b, **_):
        if int(ft.lengths(a)[1].max()) * 32 * tab.shape[1] >= 1 << 31:
            raise ValueError("first design: the sums could pass int32")
        out = torch.zeros(a.shape[0], dtype=torch.int32, device=a.device)
        items = first_plan(ft, a)
        m = items.shape[0]
        if m:
            _build.check_launch(fn(
                ft.rowptr.data_ptr(), ft.colidx.data_ptr(), tab.data_ptr(),
                tab.shape[0], tab.shape[1], a.data_ptr(), b.data_ptr(),
                items.data_ptr(), m, out.data_ptr(),
                max(1, min(GRID_CAP, -(-m * 32 // BLOCK))),
                _build.stream(a.device)), "first design")
        return out
    return run


def host(x):
    return x.cpu().numpy()


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def work(args, kw, cs, rg, reps: int = 5):
    """The plan's counts (cuda_house.house_work) for one call, the first
    design's beside them, and plan_house's time on the tensors' device
    (host clock, synchronized; the median of `reps`)."""
    ft, tab, a, b = args
    dev = a.device
    an, bn = host(a), host(b)
    core_nb = ts.core_neighbours(rg, cs)[1]
    ftw = host(ft.ftw)
    ms = []
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        plan = ch.plan_house(ft, tab, a, kw["view"])
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    new = ch.house_work(an, bn, rg.rowptr, rg.colidx, ftw, core_nb,
                        host(plan.items), plan.n_block, tab.shape[1])
    first = ch.house_work(an, bn, rg.rowptr, rg.colidx, ftw, core_nb,
                          host(first_plan(ft, a)), 0, tab.shape[1],
                          csa_dot=False)
    return {"built": new, "first design": first,
            "plan_ms": sorted(ms)[len(ms) // 2]}


def count_turns(first_dir: str, scale: int, core: int, reps: int) -> dict:
    """house_count_fast's host seconds in turns: the first design's
    checkout, this one, this one, the first design's; each a process of
    its own (COUNT_CODE) with its checkout first on the path."""
    here = os.path.dirname(_build._PKG)
    runs = {"first design": [], "built": []}
    for name in ("first design", "built", "built", "first design"):
        root = os.path.abspath(first_dir if name == "first design"
                               else here)
        env = dict(os.environ, PYTHONPATH=root)
        r = subprocess.run([sys.executable, "-c", COUNT_CODE, str(scale),
                            str(core), str(reps)], cwd=root, env=env,
                           capture_output=True, text=True, check=True)
        runs[name].append(json.loads(r.stdout.strip().splitlines()[-1]))
    counts = {r["count"] for v in runs.values() for r in v}
    if len(counts) != 1:
        raise RuntimeError(f"house counts differ: {runs}")
    return {k: [s for r in v for s in r["s"]] for k, v in runs.items()}


def kernel_ms(fn, calls: int = 50):
    """Device ms of the house_t3 kernel alone a call (torch.profiler over
    `calls` calls after warm-up), or None when no reading held its
    events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and
              "house_t3" in e.name]
        if us:
            return sum(us) / len(us) / 1e3
    return None


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=18)
    ap.add_argument("--core", type=int, default=ts.CORE)
    ap.add_argument("--first-design", default=None, metavar="DIR")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=[FILE][:M=V,...][|K=V,...]")
    ap.add_argument("--count-reps", type=int, default=0)
    ap.add_argument("--reps", type=int, default=11)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    cuda = torch.device(a.device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("prof_house needs a CUDA card")
    rg = rmat(a.scale, 16, seed=7).relabel_by_degree(descending=False)
    src, dst, cs, calls = house_calls(rg, a.core, a.device)
    out = {"scale": a.scale, "calls": []}
    for args, kw, idx in calls:
        out["calls"].append({"work": work(args, kw, cs, rg)})
    if not cuda:                        # the counting alone
        print(json.dumps(out))
        return out
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    entry = _build.entry("gm_house_t3")
    fns = {"built": lambda args, kw: ch.house_t3(*args, view=kw["view"]),
           "built, plan before": lambda args, kw: ch.house_t3(
               *args, view=kw["view"], plan=kw["plan"]),
           "built, plan before, no view": lambda args, kw: ch.launch(
               entry, *args, None, kw["plan"])}
    if a.first_design:
        fn = compile_lib(os.path.join(a.first_design, "graphminer_tpu_torch",
                                      "csrc", "house_t3.cu"), "first",
                         argtypes=FIRST_ARGS)
        fns["first design"] = lambda args, kw, run=first_design(fn): \
            run(*args)
    plans = {}
    for i, spec in enumerate(a.variant):
        name, rest = spec.split("=", 1)
        rest, _, plan_kw = rest.partition("|")
        path, _, macros = rest.partition(":")
        fn = compile_lib(path, f"variant{i}",
                         [m for m in macros.split(",") if m]) \
            if path else entry
        kw_ = {k: int(x) for k, x in (p.split("=") for p in
                                      plan_kw.split(",") if p)}
        plans[name] = [ch.plan_house(*args[:3], kw["view"], **kw_)
                       for args, kw, _ in calls]
        fns[name] = lambda args, kw, fn=fn, name=name: ch.launch(
            fn, *args, kw["view"], plans[name][kw["call"]])
    for i, (_, kw, _) in enumerate(calls):
        kw["call"] = i
    for i, ((args, kw, idx), row) in enumerate(zip(calls, out["calls"]), 1):
        plain = ch.house_t3_plain(*args)
        nbytes = pf.house_bytes(*args)
        rows = {k: {"event_ms": []} for k in fns}
        for k in list(fns) + list(reversed(fns)):     # turns: a b c, c b a
            ms, val = pf.time_ms(lambda: fns[k](args, kw), "cuda", a.reps)
            if not torch.equal(val, plain):
                raise RuntimeError(f"call {i} {k}: result != plain")
            rows[k]["event_ms"].append(ms)
        for k, fn in fns.items():
            rows[k]["device_ms"] = kernel_ms(lambda: fn(args, kw))
        row.update(tasks=int(idx.numel()), bytes=nbytes,
                   bound_ms=pf.bound_ms(nbytes)[0], variants=rows)
    if a.first_design and a.count_reps > 0:
        out["house_count_s"] = count_turns(a.first_design, a.scale, a.core,
                                           a.count_reps)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
