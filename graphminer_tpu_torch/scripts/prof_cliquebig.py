"""Where do the large-clique engine's seconds go, and which k = 6 path wins?

For each RMAT scale of --scales (edge factor 16, seed 7) it builds
CliqueBigEngine (ops/cliquebig.py) at --k and times counts: at k = 6 the
host-streamed path and the device path (kernels Q and G) in turns (host,
device, device, host), then the device path at each CAP6 of --caps; at
k >= 7 the engine's one path, twice. Each count is checked against GOLDEN
where the scale has one, and printed with its host seconds (the whole
count, and its hi and lo parts: stream_s; at k = 6 also the hi part's
steps: the triangle-task estimate by count_multi, and on the device path
the triangle stream, the copies to the card, Q's offsets (one count
launch, the scan and the chunk ends read back) and the Q and G launches),
the device ms of its G, L and Q launches (CUDA events, kernel_ms), its
task counts, dispatches and launches and the peak device memory; the
build with its prep and tail seconds. The kernels are built before the
first timing.

    python -m graphminer_tpu_torch.scripts.prof_cliquebig [--device cuda|cpu]
        [--k 6] [--scales 10 12 14 16] [--caps 16777216 268435456]
"""
from __future__ import annotations

import argparse
import time

import torch

from ..device import resolve_device
from ..io.synth import rmat
from ..ops.cliquebig import CliqueBigEngine
from ..ops.cuda_cliquebig import quad_count, quad_emit
from ..ops.cuda_cliquek import lo_popcount
from ..ops.cuda_gram import bit_gram

#: rmat(scale, 16, seed=7) k-cliques (bench.py, tests/test_cliquebig.py)
GOLDEN = {(13, 6): 631_682_339, (14, 6): 3_345_978_434,
          (16, 6): 59_924_973_905, (18, 6): 1_123_232_293_537,
          (12, 7): 632_745_449, (12, 8): 2_295_344_783}
#: DEV6_MIN_TRIS values that force the host and the device path
FORCE = {"host": 1 << 62, "device": 0}


def timed_count(eng, dev, scale: int, label: str) -> dict:
    """One count with its statistics; raises on a count that disagrees
    with GOLDEN."""
    wrappers = (bit_gram, lo_popcount, quad_emit, quad_count)
    before = [f.launches for f in wrappers]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    total = eng.count()
    res = {"count": total, "path": eng.path, "count_s": eng.count_s,
           "stream_s": eng.stream_s, "kernel_ms": eng.kernel_ms,
           "n_hi_tasks": eng.n_hi_tasks, "n_lo_tasks": eng.n_lo_tasks,
           "n_tri_tasks": eng.n_tri_tasks,
           "dispatches": eng.dispatches,
           "launches": {f.__name__: f.launches - b
                        for f, b in zip(wrappers, before)},
           "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                          if dev.type == "cuda" else None)}
    want = GOLDEN.get((scale, eng.k))
    if want is not None and total != want:
        raise RuntimeError(f"rmat{scale} k={eng.k}: {total} != {want}")
    print(f"  {label}: {total} ({'golden' if want else 'no golden'}) path "
          f"{eng.path} count {eng.count_s:.3f} s (host s: "
          + ", ".join(f"{k} {v:.3f}" for k, v in eng.stream_s.items())
          + ") device ms "
          + ", ".join(f"{k} {v:.3f}" for k, v in eng.kernel_ms.items())
          + f"; hi tasks {eng.n_hi_tasks}, lo tasks {eng.n_lo_tasks}, "
          f"triangle tasks {eng.n_tri_tasks}, "
          f"dispatches {eng.dispatches}, launches {res['launches']}, peak "
          f"{res['peak_bytes']} B", flush=True)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--k", type=int, default=6)
    ap.add_argument("--scales", type=int, nargs="+", default=[10, 12, 14, 16])
    ap.add_argument("--caps", type=int, nargs="*", default=[])
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device: {kind}", flush=True)
    if dev.type == "cuda":              # the build stays out of the timings
        from ..ops import _build
        _build.kernels()
    out = {"device": kind, "k": a.k, "scales": {}}
    for scale in a.scales:
        t0 = time.perf_counter()
        eng = CliqueBigEngine(rmat(scale, 16, seed=7), a.k, device=dev)
        build_s = time.perf_counter() - t0
        print(f"rmat{scale} k={a.k}: build {build_s:.3f} s (prep "
              f"{eng.prep_s:.3f} s, tail {eng.tail_s:.3f} s, tail count "
              f"{eng.tail_total}); core edges {eng.n_core_edges} of "
              f"{eng.n_edges}, hi {eng.hi_dim}", flush=True)
        runs = []
        if a.k == 6:
            for path in ("host", "device", "device", "host"):
                eng.DEV6_MIN_TRIS = FORCE[path]
                runs.append(timed_count(eng, dev, scale, path))
            eng.DEV6_MIN_TRIS = FORCE["device"]
            for cap in a.caps:
                eng.CAP6 = cap
                runs.append(dict(cap=cap, **timed_count(
                    eng, dev, scale, f"device CAP6 {cap}")))
        else:
            runs = [timed_count(eng, dev, scale, "count") for _ in range(2)]
        out["scales"][scale] = {"build_s": build_s, "prep_s": eng.prep_s,
                                "tail_s": eng.tail_s, "runs": runs}
        del eng
    return out


if __name__ == "__main__":
    main()
