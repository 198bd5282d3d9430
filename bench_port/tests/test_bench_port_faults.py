"""The correctness check fails what it must: a run of each cell driven on
the CPU (the harness's look for a card skipped, the port's plain versions
underneath) with the timed path broken, and with the control, the
reference accumulated in float32, put in the program's place."""
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_port import control  # noqa: E402
from bench_port.run import run_cell  # noqa: E402
from graphminer_tpu_torch.ops.cliquek import CliqueKEngine  # noqa: E402
from graphminer_tpu_torch.ops.hybrid import HybridEngine  # noqa: E402

TINY = {"generator": "graph500", "scale": 9, "edge_factor": 16, "a": 0.57,
        "b": 0.19, "c": 0.19}
SEED = 2**31 + 77
#: small cores, so that the tiny graph has work on every side of each
#: engine's timed path (the hybrid's ring and stream, the clique's hi and
#: lo), by the configuration's entry
ARGS = {"hybrid_tc": {"core": 128},
        "cliquek": {"k": 4, "core": 256, "hi": 32}}


def _cells():
    """{cell: its configuration's entry} of the manifest."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        m = json.load(f)
    files = {c["name"]: c["file"] for c in m["configs"]}
    out = {}
    for w in m["workloads"]:
        with open(os.path.join(ROOT, files[w["config"]])) as f:
            out[w["name"]] = json.load(f)["entry"]
    return out


CELLS = _cells()


def _run(cell):
    return run_cell(ROOT, cell, SEED, 0.2, False, "cpu",
                    {"graph": TINY, "entry_args": ARGS[CELLS[cell]]})


def _altered(orig):
    """The answer altered where it is produced: the first partial + 1."""
    def f(self):
        p = orig(self).clone()
        p[0] += 1
        return p
    return f


def _half(orig):
    """Half of the work left out: every other partial summed."""
    def f(self):
        return orig(self)[::2]
    return f


FAULTS = {
    "hybrid_tc": {
        "answer altered": (HybridEngine, "partials", _altered),
        "half the tasks left out": (HybridEngine, "partials", _half),
    },
    "cliquek": {
        "answer altered": (CliqueKEngine, "hi_partials", _altered),
        "half the tasks left out": (CliqueKEngine, "hi_partials", _half),
    },
}


def test_every_cell_has_its_faults():
    assert set(CELLS.values()) <= set(FAULTS) == set(ARGS)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"]["count_gap_max"]["value"] == 0


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(CELLS)
                                        for f in sorted(FAULTS[CELLS[c]])])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    cls, name, make = FAULTS[CELLS[cell]][fault]
    monkeypatch.setattr(cls, name, make(getattr(cls, name)))
    r = _run(cell)
    assert r["correct"] is False
    assert r["failed"] == r["attempted"] > 0
    assert r["checks"]["count_gap_max"]["value"] > 0


def test_the_tiny_engines_have_both_sides():
    from graphminer_tpu_torch.core.graph import HostGraph
    from bench_port.reference import graph500
    rp, col = graph500.kronecker_csr_torch(9, seed=SEED)
    g = HostGraph(rowptr=rp.numpy(), colidx=col.numpy()).relabel_by_degree(
        descending=False).orientation()
    hy = HybridEngine(g, device="cpu", **ARGS["hybrid_tc"])
    assert hy.ring.cbuckets and hy.stream.buckets
    ck = CliqueKEngine(g, device="cpu", **ARGS["cliquek"])
    assert ck.n_core_edges and ck.n_lo


def test_a_call_that_raises_is_failed(monkeypatch):
    def boom(self):
        raise RuntimeError("lost")
    monkeypatch.setattr(HybridEngine, "count", boom)
    cell = next(c for c, e in sorted(CELLS.items()) if e == "hybrid_tc")
    r = _run(cell)
    assert r["correct"] is False and r["checks"]["wrong_counts"]["value"] > 0


#: the smallest scales at which the float32 control's count passes 2^24
#: (triangles: 36.1 M at 17; 4-cliques: 102.5 M at 15)
CONTROL_SCALE = {"triangle": 17, "clique4": 15}


def _pattern(cell):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        m = json.load(f)
    w = next(w for w in m["workloads"] if w["name"] == cell)
    c = next(c for c in m["configs"] if c["name"] == w["config"])
    with open(os.path.join(ROOT, c["file"])) as f:
        return json.load(f)["pattern"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_float32_control_fails_the_check(cell):
    """The control put in the program's place through run_cell's own
    comparison, at a scale whose count passes 2^24: the run is not
    correct, and every count it made is wrong."""
    scale = CONTROL_SCALE[_pattern(cell)]
    r = control.control_run(ROOT, cell, SEED, 0.01, "cpu",
                            {"graph": dict(TINY, scale=scale)})
    assert r["correct"] is False
    assert r["checks"]["count_gap_max"]["value"] > 0
    assert r["failed"] == r["attempted"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_float32_control_fails_at_the_cells_size(cell):
    """The same at the cell's own configuration, on the card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = control.control_run(ROOT, cell, SEED, 1.0, "cuda")
    assert r["correct"] is False
    assert r["checks"]["count_gap_max"]["value"] > 0
