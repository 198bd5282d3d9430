"""The benchmark's readers of the program's spans (bench_port/spans.py and
its nine metrics): known values on a hand-built run, None where the program
keeps no spans, and on untraced CPU runs of each cell the set-up split
within the harness's build span."""
import json
import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_port import spans, trace  # noqa: E402
from bench_port.load import Call  # noqa: E402
from bench_port.run import Run, _metric_reader, run_cell  # noqa: E402
from graphminer_tpu_torch.utils.profiling import (PROFILER,  # noqa: E402
                                                  SpanRecord)

TINY = {"generator": "graph500", "scale": 9, "edge_factor": 16, "a": 0.57,
        "b": 0.19, "c": 0.19}
SETUP = ("build_pack_s", "build_upload_s", "build_enum_s", "build_tail_s",
         "kernel_load_s")
COUNT = ("count_host_ms", "idle_in_count_pct", "clique4_count_host_ms",
         "clique4_idle_in_count_pct")


def _reader(name):
    return _metric_reader(ROOT, name)


def _cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


def _rec(name, start, end, self_s, i):
    return SpanRecord(name, start, end, self_s, i, None, 0, None)


def _run(lag=0.0):
    """A window of 10,000 us with three counts on the host and four device
    events, and a set-up of 10 s ending at 100 s; the first call starts
    `lag` s later (a traced run starts its profiler there)."""
    host = [(0.0, 1e4, trace.WINDOW)]
    for s, e, r in ((1000, 2000, 1500), (4000, 5000, 4600),
                    (7000, 8000, 7200)):
        host += [(s, e, trace.CALL), (s, e, "count"), (s, r, "count.launch"),
                 (r, e, "count.readback")]
    host += [(1e4 + 10, 1e4 + 20, "count")]      # after the window
    dev = {0: [(0.0, 1200.0, "B"), (1600.0, 4500.0, "A"),
               (5100.0, 7100.0, "A"), (7900.0, 1e4, "G")]}
    tr = trace.Trace(lo=0.0, hi=1e4, device=dev, host=host)
    calls = [Call(100.0 + lag + i, 100.0 + lag + i + 0.01, value=1)
             for i in range(3)]
    return Run(setup_s=10.0, spans={"build": 9.0}, window_s=1e-2,
               calls=calls, n_vertices=10, n_dag_edges=20, n_devices=1,
               trace=tr)


RECORDS = [
    _rec("build.pack", 80.0, 85.0, 5.0, 0),        # before set-up
    _rec("build.pack", 91.0, 95.0, 2.0, 1),
    _rec("build.upload", 92.0, 93.0, 0.5, 2),
    _rec("build.pack", 95.0, 96.0, 1.0, 3),
    _rec("build.enumerate", 96.0, 99.5, 3.0, 4),
    _rec("build.tail", 99.5, 99.75, 0.25, 5),
    _rec("kernels.load", 99.75, 99.875, 0.125, 6),
    _rec("count", 130.5, 130.6, 0.1, 7),            # in the window
]


@pytest.mark.parametrize("lag", [0.0, 30.0])
def test_setup_readers_sum_self_times_inside_setup(monkeypatch, lag):
    monkeypatch.setattr(PROFILER, "span_records", lambda: list(RECORDS))
    run = _run(lag)
    want = {"build_pack_s": 3.0, "build_upload_s": 0.5, "build_enum_s": 3.0,
            "build_tail_s": 0.25, "kernel_load_s": 0.125}
    for name, v in want.items():
        assert _reader(name)(run) == pytest.approx(v), name
    monkeypatch.setattr(PROFILER, "span_records", lambda: RECORDS[-1:])
    assert all(_reader(n)(run) is None for n in SETUP)


def test_count_readers_on_a_synthetic_trace():
    run = _run()
    host_ms = (3000 - (500 + 400 + 800)) / 3 / 1e3
    idle_pct = 100 * (400 + 500 + 800) / (400 + 600 + 800)
    for prefix in ("", "clique4_"):
        assert _reader(prefix + "count_host_ms")(run) == \
            pytest.approx(host_ms)
        assert _reader(prefix + "idle_in_count_pct")(run) == \
            pytest.approx(idle_pct)


def test_readers_give_none_where_the_program_keeps_no_spans(monkeypatch):
    run = _run()
    run.trace.host = [h for h in run.trace.host
                      if not h[2].startswith("count")]
    assert all(_reader(n)(run) is None for n in COUNT)
    run.trace = None
    assert all(_reader(n)(run) is None for n in COUNT)
    monkeypatch.setattr(spans, "PROFILING", "no_such_module")
    assert all(_reader(n)(_run()) is None for n in SETUP)
    monkeypatch.undo()
    monkeypatch.delattr(type(PROFILER), "span_records")
    assert all(_reader(n)(_run()) is None for n in SETUP)


@pytest.mark.parametrize("cell", _cells())
def test_setup_split_lies_within_build_on_a_cpu_run(cell):
    was = PROFILER.enabled
    PROFILER.enabled = False
    try:
        r = run_cell(ROOT, cell, 4200000007, 0.2, False, "cpu",
                     {"graph": TINY})
        t1 = time.perf_counter()
    finally:
        PROFILER.enabled = was
    assert r["correct"] is True
    build_s = r["graph"]["spans_s"]["build"]
    run = Run(setup_s=r["metrics"]["setup_s"]["value"],
              spans=r["graph"]["spans_s"], window_s=0.0,
              calls=[Call(t1, t1, value=r["graph"]["count"])],
              n_vertices=r["graph"]["n_vertices"],
              n_dag_edges=r["graph"]["n_undirected_edges"], n_devices=1)
    got = {n: _reader(n)(run) for n in SETUP}
    assert got["build_pack_s"] > 0 and got["build_upload_s"] > 0
    assert got["kernel_load_s"] is None      # no kernel library on the CPU
    if cell.startswith("clique4"):
        assert got["build_enum_s"] > 0 and got["build_tail_s"] > 0
    else:
        assert got["build_enum_s"] is None and got["build_tail_s"] is None
    assert sum(v for v in got.values() if v is not None) <= build_s
