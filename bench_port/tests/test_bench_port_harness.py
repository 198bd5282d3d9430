"""The harness on the CPU: the manifest against the benchmark's contract,
the metric arithmetic, a cell added as new files only, and no JAX."""
import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_port import stats, trace  # noqa: E402
from bench_port.load import Call  # noqa: E402
from bench_port.run import FORBIDDEN, Run  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TINY = {"generator": "graph500", "scale": 9, "edge_factor": 16, "a": 0.57,
        "b": 0.19, "c": 0.19}


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_manifest_keys_names_and_units():
    m = manifest()
    assert list(m) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert m["command"] == ["python3", "bench_port/run.py"]
    assert m["paths"] == ["bench_port"]
    assert 1 <= m["run_seconds"] <= 51
    metrics = m["end_to_end"] + m["per_layer"]
    names = ([c["name"] for c in m["configs"]]
             + [w["name"] for w in m["workloads"]]
             + [x["name"] for x in metrics])
    assert len(set(names)) == len(names)
    for n in names + [w["traffic"] for w in m["workloads"]] + [
            k for c in m["configs"] for k in c["reduced"]]:
        assert NAME.match(n), n
    for x in metrics:
        assert UNIT.match(x["unit"]), x["unit"]
        assert x["better"] in ("lower", "higher")
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench_port/configs/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert set(c["reduced"]) == set(cfg["reduced"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert os.path.exists(os.path.join(
            ROOT, "bench_port", "mixes", w["traffic"] + ".json"))
    for x in m["end_to_end"]:
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    for x in m["per_layer"]:
        assert "bound" not in x and "\n" not in x["layer"]


def test_every_metric_and_entry_has_its_file():
    m = manifest()
    for x in m["end_to_end"] + m["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "bench_port", "metrics",
                                           x["name"] + ".py")), x["name"]
    for c in m["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            entry = json.load(f)["entry"]
        assert os.path.exists(os.path.join(ROOT, "bench_port", "entries",
                                           entry + ".py"))


def test_each_moves_names_an_end_to_end_metric_its_cells_report():
    m = manifest()
    cells = [w["name"] for w in m["workloads"]]
    e2e = {x["name"]: x.get("workloads", cells) for x in m["end_to_end"]}
    assert "setup_s" in e2e
    for cell in cells:
        assert cell in e2e["setup_s"]
        assert any(cell in ws for n, ws in e2e.items() if n != "setup_s")
        assert any(cell in x.get("workloads", cells) for x in m["per_layer"])
    for x in m["per_layer"]:
        assert x["moves"] in e2e
        for cell in x.get("workloads", cells):
            assert cell in cells and cell in e2e[x["moves"]]


def test_at_most_a_quarter_of_cells_take_four_chips():
    ws = manifest()["workloads"]
    four = sum(1 for w in ws if w["chips"] == 4)
    assert all(w["chips"] in (1, 4) for w in ws)
    assert four <= max(1, len(ws) // 4)


def test_window_mean_and_p95():
    assert stats.window_mean_ms(2.0, 400) == pytest.approx(5.0)
    assert stats.window_mean_ms(2.0, 0) is None
    values = list(range(1, 101))
    assert stats.percentile(values, 95) == 95
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile(list(range(1, 21)), 95) == 19
    assert stats.percentile([], 95) is None


def test_idle_share_and_gaps_from_intervals():
    iv = [(0, 2), (1, 3), (5, 6), (9, 12)]
    assert stats.merge(iv) == [(0, 3), (5, 6), (9, 12)]
    assert stats.busy(iv, 0, 10) == 5
    assert stats.idle_share(iv, 0, 10) == pytest.approx(0.5)
    assert stats.gaps(iv, 0, 10) == [(3, 5), (6, 9)]
    assert stats.gaps([], 2, 4) == [(2, 4)]
    assert stats.idle_share([(0, 10)], 0, 10) == 0.0


def test_csr_bytes_and_least_time():
    # scale 20: 2^20 + 1 int32 row pointers, one int32 a DAG edge, an int64
    assert stats.csr_bytes(1 << 20, 15_700_000) == (
        4 * ((1 << 20) + 1) + 4 * 15_700_000 + 8)
    assert stats.least_seconds(3.35e12) == pytest.approx(1.0)
    assert stats.least_seconds(0, 1.979e15) == pytest.approx(1.0)


def _run_with_trace(device, n_calls):
    tr = trace.Trace(lo=0.0, hi=1e6, device=device,
                     host=[(0.0, 1e6, trace.WINDOW)])
    calls = [Call(i, i + 0.01, value=1) for i in range(n_calls)]
    return Run(setup_s=1.0, spans={"prep": 0.5}, window_s=1.0, calls=calls,
               n_vertices=1000, n_dag_edges=5000, n_devices=1, trace=tr)


def _reader(name):
    from bench_port.run import _metric_reader
    return _metric_reader(ROOT, name)


def test_trace_readers_on_synthetic_events():
    dev = {0: [(0.0, 2.5e5, "A"), (2.0e5, 5.0e5, "B"), (8.0e5, 9.0e5, "A")]}
    run = _run_with_trace(dev, 10)
    assert _reader("idle_share.repeat")(run) == pytest.approx(40.0)
    assert _reader("device_ops")(run) == pytest.approx(0.3)
    device_s = (2.5e5 + 3.0e5 + 1.0e5) / 1e6 / 10
    want = 100 * stats.csr_bytes(1000, 5000) / 3.35e12 / device_s
    assert _reader("count_roofline")(run) == pytest.approx(want)
    assert _reader("prep_s")(run) == 0.5
    assert _reader("build_s")(run) is None
    empty = _run_with_trace({}, 10)
    for name in ("idle_share.repeat", "device_ops", "count_roofline"):
        assert _reader(name)(empty) is None
    bd = trace.breakdown(run.trace)
    assert bd["device_ops"][0] == ["A", pytest.approx(0.35)]
    assert bd["idle_gaps"][0] == [trace.WINDOW, pytest.approx(0.3)]


def _subprocess(code, cwd, extra_path=()):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([*extra_path, ROOT])
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_a_cell_added_as_new_files_only(tmp_path):
    """A configuration, a mix and a metric added as new files, and entries
    added to the manifest, run without an edit to any file the benchmark
    has."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "bench_port"), root / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()
              and p.name != "BENCHMARK.json"}
    cfg = {"name": "tc-tiny", "source": "test", "graph": dict(TINY),
           "pattern": "triangle", "entry": "hybrid_tc", "entry_args": {},
           "reduced": {"scale": "test"}}
    (root / "bench_port/configs/tc-tiny.json").write_text(json.dumps(cfg))
    (root / "bench_port/mixes/closed1w1.json").write_text(json.dumps(
        {"kind": "closed", "clients": 1, "warmup_calls": 1}))
    (root / "bench_port/metrics/count_max_ms.py").write_text(
        "def read(run):\n"
        "    return max((c.end - c.start) * 1e3 for c in run.ok_calls)\n")
    m = manifest()
    m["configs"].append({"name": "tc-tiny", "source": "test",
                         "file": "bench_port/configs/tc-tiny.json",
                         "reduced": ["scale"], "why": "test"})
    m["workloads"].append({"name": "tc.tiny.closed1w1", "config": "tc-tiny",
                           "traffic": "closed1w1", "chips": 1, "why": "test"})
    m["end_to_end"].append({"name": "count_max_ms", "unit": "ms",
                            "better": "lower", "bound": 0.05,
                            "source": "host_clock",
                            "workloads": ["tc.tiny.closed1w1"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    code = (f"import sys, json; sys.path.insert(0, {str(root)!r})\n"
            "from bench_port import run\n"
            f"assert run.__file__.startswith({str(root)!r})\n"
            f"r = run.run_cell({str(root)!r}, 'tc.tiny.closed1w1', 3, 0.3,"
            " False, 'cpu')\n"
            "print(json.dumps(r))\n")
    p = _subprocess(code, str(root), [str(root)])
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    assert set(r["metrics"]) == {"count_max_ms", "setup_s"}
    after = {p: p.read_bytes() for p in before}
    assert after == before


@pytest.mark.parametrize("mix,ok", [
    ({"kind": "closed", "clients": 1, "warmup_calls": 3}, True),
    ({"kind": "closed", "warmup_calls": 1}, True),
    ({"kind": "closed", "clients": 2}, False),
    ({"kind": "open", "clients": 1}, False),
])
def test_a_mix_is_closed_with_one_client(mix, ok):
    from bench_port import load
    if ok:
        load.check_mix(mix)
    else:
        with pytest.raises(ValueError):
            load.check_mix(mix)


def test_no_module_named_jax_or_the_jax_package_is_loaded():
    """Every cell run through on the CPU loads no module whose top-level
    name is jax, jaxlib, flax or graphminer_tpu (graphminer_tpu_torch is
    the system under test and allowed)."""
    cells = [w["name"] for w in manifest()["workloads"]]
    code = ("import sys, json\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            "from bench_port import run, control\n"
            f"for cell in {cells!r}:\n"
            f"    r = run.run_cell({ROOT!r}, cell, 5, 0.2, False, 'cpu',"
            f" {{'graph': {TINY!r}}})\n"
            "    assert r['correct'], r\n"
            "assert 'graphminer_tpu_torch' in sys.modules\n"
            "print(json.dumps(run.forbidden_modules()))\n")
    p = _subprocess(code, ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


def test_no_source_under_bench_port_imports_jax():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "bench_port")):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            with open(os.path.join(dirpath, fn)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    tops = [a.name.split(".")[0] for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    tops = [node.module.split(".")[0]]
                else:
                    continue
                assert not set(tops) & set(FORBIDDEN), (fn, tops)


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(ROOT, "bench_port", "reference")
    for fn in os.listdir(ref):
        if fn.endswith(".py"):
            with open(os.path.join(ref, fn)) as f:
                src = f.read()
            assert "graphminer_tpu" not in re.sub(r'""".*?"""', "", src,
                                                  flags=re.S), fn


def test_forbidden_names_compare_whole_top_level_names():
    from bench_port.run import forbidden_modules
    sys.modules["graphminer_tpu_torch_fake.x"] = sys
    try:
        assert "graphminer_tpu" not in forbidden_modules()
    finally:
        del sys.modules["graphminer_tpu_torch_fake.x"]


def test_a_run_without_a_card_exits_non_zero_and_prints_no_result():
    p = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench_port", "run.py"),
         "--workload", manifest()["workloads"][0]["name"], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.cuda
def test_each_cell_runs_on_the_card_at_a_small_size():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from bench_port.run import run_cell
    for w in manifest()["workloads"]:
        r = run_cell(ROOT, w["name"], 11, 0.5, True, "cuda",
                     {"graph": dict(TINY, scale=12)})
        assert r["correct"] is True
        assert r["device"]["busy_s"] > 0
