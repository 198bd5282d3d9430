"""Where does the rectangle (4-cycle) count's time go?

Counts the 4-cycles of rmat(--scale, 16, seed 7) with
ops/rectangle.py::rectangle_count_fast `--reps` times (graph already in
memory) and prints one JSON line: the count (checked against GOLDEN where
the scale has one), each count's host seconds, and, on a card, the device
ms of one more count under torch.profiler with its busy share (device time
over that count's host seconds) and its events' ms by name, and the peak
device memory of a count (max_memory_allocated after
reset_peak_memory_stats). It calls nothing but rectangle_count_fast, so it
also measures an older checkout of the package: run it by its path with
that checkout's root on PYTHONPATH, in turns with the current one.

    python -m graphminer_tpu_torch.scripts.prof_rectangle [--device cpu]
        [--scale 18] [--reps 3]
    PYTHONPATH=<checkout> python <this file> [--scale 18]
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from graphminer_tpu_torch.device import resolve_device
from graphminer_tpu_torch.io.synth import rmat
from graphminer_tpu_torch.ops.rectangle import rectangle_count_fast

#: rmat(scale, 16, seed=7) 4-cycles (bench.py:82-85)
GOLDEN = {12: 52_988_519, 13: 172_972_822, 14: 571_816_674,
          18: 51_349_430_411}


def profiled(fn):
    """(value, host s, device ms, {event name: ms}) of one fn() under
    torch.profiler (device activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        val = fn()
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by[e.name[:48]] = by.get(e.name[:48], 0.0) + \
                e.time_range.elapsed_us() / 1e3
    return val, host, sum(by.values()), by


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=int, default=18)
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    cuda = dev.type == "cuda"
    g = rmat(a.scale, 16, seed=7)
    count = lambda: rectangle_count_fast(g, device=dev)
    out = {"device": torch.cuda.get_device_name(dev) if cuda else "cpu",
           "scale": a.scale, "count": count(), "host_s": []}
    want = GOLDEN.get(a.scale)
    if want is not None and out["count"] != want:
        raise RuntimeError(f"rmat{a.scale}: {out['count']} != {want}")
    for _ in range(a.reps):
        t0 = time.perf_counter()
        got = count()
        if cuda:
            torch.cuda.synchronize(dev)
        out["host_s"].append(time.perf_counter() - t0)
        if got != out["count"]:
            raise RuntimeError(f"rmat{a.scale}: {got} != {out['count']}")
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
        count()
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
        _, host, dev_ms, by = profiled(count)
        out.update(profiled_host_s=host, device_ms=dev_ms,
                   busy=dev_ms / 1e3 / host,
                   events_ms=dict(sorted(by.items(), key=lambda kv: -kv[1])))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
