"""The benchmark of graphminer_tpu_torch: one run of one cell.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s>
                              --trace <0|1>

from the root of a checkout that holds BENCHMARK.json. Everything is found
by name from the manifest: the cell's configuration file (the graph's
generator, the pattern, the entry), its mix (bench_port/mixes/<traffic>.json),
the entry's adapter (bench_port/entries/<entry>.py) and one reader a metric
(bench_port/metrics/<metric>.py).

A run: check that the cell's cards are there (else exit 2, no result);
make the graph on the card from the seed (bench_port/reference/graph500.py)
and hand its CSR to the entry, which prepares the program; make the mix's
warm-up calls; then call back to back for --seconds (under torch.profiler
with --trace 1). Once the window has closed: read the peak device memory,
free the program's state, count the same graph with the plain reference
(bench_port/reference/counts.py) and compare every count returned with it.
The last line of standard output is the result as one JSON object; the
last lines of standard error are the numbers compared, each beside its
limit. A run exits non-zero and prints no result when a module named jax,
jaxlib, flax or graphminer_tpu is loaded by then.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()  # the process's start, as near as Python sees it

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench_port import load, trace as _trace  # noqa: E402
from bench_port.reference import counts, graph500  # noqa: E402

PKG = os.path.join(ROOT, "bench_port")
#: top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "graphminer_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def _named(items, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def _metric_reader(root: str, name: str):
    path = os.path.join(root, "bench_port", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "bench_port.metrics._" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(manifest: dict, cell: str, traced: bool) -> List[dict]:
    """The metrics a run of `cell` reports: its end-to-end metrics with
    --trace 0, its per-layer metrics with --trace 1 (a metric without a
    "workloads" key belongs to every cell)."""
    group = manifest["per_layer" if traced else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


@dataclasses.dataclass
class Run:
    """What a run recorded, as the metric readers see it."""
    setup_s: float
    spans: Dict[str, float]
    window_s: float
    calls: List[load.Call]
    n_vertices: int
    n_dag_edges: int
    n_devices: int
    trace: Optional[_trace.Trace] = None

    @property
    def ok_calls(self) -> List[load.Call]:
        return [c for c in self.calls if c.error is None]


def _sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class Spans:
    """Host-clock spans of set-up, by name (s)."""

    def __init__(self):
        self.s: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str, devices=()):
        t0 = time.perf_counter()
        yield
        _sync(devices)
        self.s[name] = self.s.get(name, 0.0) + time.perf_counter() - t0


def run_cell(root: str, workload: str, seed: int, seconds: float,
             traced: bool, device_type: str = "cuda",
             config_override: Optional[dict] = None,
             t0: Optional[float] = None) -> dict:
    """One run of one cell; returns the result object. device_type "cpu"
    runs the same path on the CPU (the port's plain versions; the tests'
    small graphs); `config_override` replaces top-level keys of the
    configuration (the tests' sizes)."""
    t0 = time.perf_counter() if t0 is None else t0
    spans = Spans()
    spans.s["start"] = time.perf_counter() - t0
    manifest = load_json(os.path.join(root, "BENCHMARK.json"))
    cell = _named(manifest["workloads"], workload, "workload")
    cfg_entry = _named(manifest["configs"], cell["config"], "config")
    config = load_json(os.path.join(root, cfg_entry["file"]))
    config.update(config_override or {})
    mix = load_json(os.path.join(root, "bench_port", "mixes",
                                 cell["traffic"] + ".json"))
    load.check_mix(mix)
    metrics = cell_metrics(manifest, workload, traced)
    readers = {m["name"]: _metric_reader(root, m["name"]) for m in metrics}
    entry_mod = importlib.import_module(
        "bench_port.entries." + config["entry"])
    chips = int(cell["chips"])
    if device_type == "cuda":
        devices = [torch.device("cuda", i) for i in range(chips)]
        with spans("cuda_init", devices):
            for d in devices:
                torch.zeros(1, device=d)
    else:
        devices = [torch.device("cpu")] * chips
    with spans("graph", devices[:1]):
        rowptr, colidx = graph500.kronecker_csr(config["graph"], seed,
                                                devices[0])
        if isinstance(rowptr, torch.Tensor):
            rowptr, colidx = rowptr.cpu().numpy(), colidx.cpu().numpy()
    n_vertices = int(rowptr.shape[0] - 1)
    n_dag_edges = int(colidx.shape[0] // 2)

    entry = entry_mod.prepare(rowptr, colidx, config, devices, spans)
    wrap = contextlib.nullcontext
    if traced:
        from torch.profiler import record_function

        def wrap():
            return record_function(_trace.CALL)
    with spans("warmup", devices):
        warm = load.warmup(mix, entry.count, contextlib.nullcontext)
    setup_s = time.perf_counter() - t0

    tr = None
    if traced:
        calls, tr = _trace.traced(
            lambda: load.window(mix, entry.count, seconds, wrap), devices)
    else:
        calls = load.window(mix, entry.count, seconds, wrap)
        _sync(devices)
    window_s = (max(c.end for c in calls) - min(c.start for c in calls)
                if calls else 0.0)

    peak = 0
    if devices[0].type == "cuda":
        peak = max(torch.cuda.max_memory_allocated(d) for d in devices)
    del entry
    gc.collect()
    if devices[0].type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = counts.count(config["pattern"],
                       torch.from_numpy(rowptr).to(devices[0]),
                       torch.from_numpy(colidx).to(devices[0]))
    ref_s = time.perf_counter() - t_ref

    every = warm + calls
    wrong = [c for c in every if c.error is not None or c.value != ref]
    gaps = [abs(c.value - ref) for c in every if c.error is None]
    gap_max = max(gaps) if len(gaps) == len(every) and gaps else None
    failed = sum(1 for c in calls if c.error is not None or c.value != ref)
    correct = bool(calls) and not wrong and gap_max == 0

    run = Run(setup_s=setup_s, spans=dict(spans.s), window_s=window_s,
              calls=calls, n_vertices=n_vertices, n_dag_edges=n_dag_edges,
              n_devices=len(devices), trace=tr)
    values = {}
    for m in metrics:
        v = readers[m["name"]](run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}

    if devices[0].type == "cuda":
        device = {"platform": "gpu",
                  "kind": torch.cuda.get_device_name(devices[0]),
                  "count": len(devices), "memory_peak_bytes": int(peak)}
    else:
        device = {"platform": "cpu", "kind": "cpu", "count": len(devices),
                  "memory_peak_bytes": 0}
    result = {"correct": correct, "attempted": len(calls), "failed": failed,
              "metrics": values, "device": device}
    if tr is not None:
        device["busy_s"] = sum(tr.busy_s(i) for i in range(len(devices))) \
            / len(devices)
        device["window_s"] = tr.window_s
        result["breakdown"] = _trace.breakdown(tr)
    result["graph"] = {"n_vertices": n_vertices,
                       "n_undirected_edges": n_dag_edges,
                       "count": ref, "reference_s": ref_s,
                       "warmup_calls": len(warm),
                       "spans_s": dict(spans.s),
                       "errors": sorted({c.error for c in every
                                         if c.error})[:3]}
    result["checks"] = {
        "count_gap_max": {"value": gap_max, "limit": 0},
        "wrong_counts": {"value": len(wrong), "limit": 0},
    }
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    chips = int(_named(manifest["workloads"], args.workload,
                       "workload")["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench_port: the cell {args.workload} needs {chips} CUDA "
              f"card(s); {have} visible", file=sys.stderr)
        return 2
    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t0=_T0)
    bad = forbidden_modules()
    if bad:
        print(f"bench_port: the run loaded {bad}; it may load none of "
              f"{list(FORBIDDEN)}", file=sys.stderr)
        return 3
    g = result["graph"]
    print(f"graph: V {g['n_vertices']}, undirected edges "
          f"{g['n_undirected_edges']}, reference count {g['count']} "
          f"({g['reference_s']:.3f} s)", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
