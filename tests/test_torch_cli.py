"""Port CLI (python -m graphminer_tpu_torch) against the JAX package's CLI
on rmat12 and rmat10 graphs saved in the reference binary format (one of
them with vertex and edge labels)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from graphminer_tpu.__main__ import main as jmain
from graphminer_tpu_torch.__main__ import main
from graphminer_tpu_torch.io.loader import save_graph
from graphminer_tpu_torch.io.synth import rmat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def prefix(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("rmat12") / "graph")
    save_graph(rmat(12, 16, seed=7), p)
    return p


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("rmat10") / "graph")
    save_graph(rmat(10, 8, seed=7), p)
    return p


@pytest.fixture(scope="module")
def labelled(tmp_path_factory):
    """rmat10 with vertex labels 1-4 and edge labels 0-1 (one label a
    direction of each edge), as bench.py labels its FSM graphs."""
    p = str(tmp_path_factory.mktemp("rmat10l") / "graph")
    g = rmat(10, 8, seed=7)
    rng = np.random.default_rng(7)
    g.vlabels = rng.integers(1, 5, g.n_vertices).astype(np.uint8)
    src = np.repeat(np.arange(g.n_vertices), np.diff(g.rowptr))
    lo = np.minimum(src, g.colidx).astype(np.int64)
    hi = np.maximum(src, g.colidx).astype(np.int64)
    g.elabels = ((lo * 7 + hi * 3) % 2).astype(np.uint16)
    save_graph(g, p)
    return p


@pytest.fixture
def one_thread():
    """One torch thread for the labelled searches: many small ops, and
    under xdist the workers' intra-op threads only contend."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(fn, capsys, *args):
    assert fn(list(args) + ["--json"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def run_port(*args, env=None):
    return subprocess.run([sys.executable, "-m", "graphminer_tpu_torch",
                           *args], cwd=REPO, capture_output=True, text=True,
                          timeout=120, env=env)


def test_tc_fast_cpu_agrees_with_jax(prefix, capsys):
    ours = run(main, capsys, "tc", prefix, "--fast", "--cpu", "--profile")
    ref = run(jmain, capsys, "tc", prefix, "--fast", "--cpu")
    assert ours["total"] == ref["total"] > 0
    prof = ours["profile"]
    assert prof["device"] == "cpu"
    assert prof["counters"]["edge_tasks"] > 0
    assert set(prof["kernel_launches"]) == {
        "stream_bucket_count", "ring_phase_c", "ring_tail_pairs",
        "hub_tail_count", "expand_bits", "lo_popcount", "bit_gram",
        "quad_emit", "quad_count", "tri_bitmap", "tri_probe", "tri_lists",
        "bit_colsum", "colsum_pairs", "colsum_finish", "house_t3"}


def test_info_agrees_with_jax(prefix, capsys):
    ours = run(main, capsys, "info", prefix, "--cpu")
    ref = run(jmain, capsys, "info", prefix, "--cpu")
    for k in ("V", "E", "max_degree", "has_vlabels"):
        assert ours[k] == ref[k]


def test_tc_without_card_exits_naming_cuda(prefix):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = run_port("tc", prefix, "--fast", "--json", env=env)
    assert r.returncode != 0
    assert "CUDA" in r.stderr
    assert r.stdout == ""


def test_fsm_without_card_exits_naming_cuda(labelled):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = run_port("fsm", labelled, "2", "30", "--json", env=env)
    assert r.returncode != 0
    assert "CUDA" in r.stderr
    assert r.stdout == ""


@pytest.mark.parametrize("args", [
    ("fsm", "2", "30"), ("gks", "3", "1,2,3"),
    ("query", "1,2,3:0-1,1-2,0-2")])
def test_labelled_verbs_cpu_agree_with_jax(labelled, capsys, args,
                                           one_thread):
    """fsm (vertex and edge labels), gks and query (vertex labels) on
    --cpu print JAX's total and keys, and launch no kernel of ours."""
    ours = run(main, capsys, args[0], labelled, *args[1:], "--cpu",
               "--profile")
    ref = run(jmain, capsys, args[0], labelled, *args[1:], "--cpu")
    assert ours["total"] == ref["total"] > 0
    assert set(ours) - {"profile"} == set(ref)
    for k in ("k", "minsup", "keywords", "query"):
        assert ours.get(k) == ref.get(k)
    prof = ours["profile"]
    assert prof["device"] == "cpu"
    assert set(prof["kernel_launches"].values()) == {0}
    if args[0] == "fsm":
        assert "fsm_overflow_retries" in prof["counters"]


@pytest.mark.parametrize("args", [
    ("tc", "--partition", "2"),
    ("tc", "--fast", "--sharded"), ("tc", "--fast", "--partition", "2"),
    ("clique", "4", "--sharded"), ("clique", "4", "--partition", "2")])
def test_unported_exits_naming_roadmap(prefix, capsys, args):
    """The scale-out flags on --cpu print the JAX CLI's total (partition
    before sharded before fast, as JAX takes them) and launch no kernel of
    ours."""
    ours = run(main, capsys, args[0], prefix, *args[1:], "--cpu",
               "--profile")
    ref = run(jmain, capsys, args[0], prefix, *args[1:], "--cpu")
    assert ours["total"] == ref["total"] > 0
    assert ours.get("k") == ref.get("k")
    assert ours["profile"]["device"] == "cpu"
    assert set(ours["profile"]["kernel_launches"].values()) == {0}


@pytest.mark.parametrize("args", [
    ("tc",), ("tc", "--backend", "bc", "--chunk", "1000"),
    ("clique", "4"), ("clique", "4", "--engine", "map"),
    ("sgl", "diamond"), ("sgl", "rectangle", "--backend", "bs")])
def test_generic_verbs_cpu_agree_with_jax(small, capsys, args):
    ours = run(main, capsys, args[0], small, *args[1:], "--cpu", "--profile")
    ref = run(jmain, capsys, args[0], small, *args[1:], "--cpu")
    assert ours["total"] == ref["total"] > 0
    for key in ("k", "pattern"):
        assert ours.get(key) == ref.get(key)
    prof = ours["profile"]
    assert prof["device"] == "cpu"
    assert prof["counters"]["edge_tasks"] > 0
    assert set(prof["kernel_launches"].values()) == {0}


@pytest.mark.parametrize("pattern", ["diamond", "rectangle", "house"])
def test_sgl_fast_cpu_agrees_with_jax(small, capsys, pattern):
    """sgl diamond|rectangle|house --fast runs the triangle support, 4-cycle
    and house engines (the plain versions of their kernels on --cpu) and
    agrees with the JAX package's fast engine and, but for the house (whose
    generic plan takes ~40 s here; tests/test_torch_house.py holds the two
    on graphs of at most 80 vertices), with the generic plan."""
    ours = run(main, capsys, "sgl", small, pattern, "--fast", "--cpu",
               "--profile")
    ref = run(jmain, capsys, "sgl", small, pattern, "--fast", "--cpu")
    assert ours["total"] == ref["total"] > 0
    if pattern != "house":
        gen = run(main, capsys, "sgl", small, pattern, "--cpu")
        assert ours["total"] == gen["total"]
    assert ours["pattern"] == pattern
    prof = ours["profile"]
    assert prof["device"] == "cpu"
    assert set(prof["kernel_launches"].values()) == {0}


@pytest.mark.parametrize("k", ["4", "5", "6"])
def test_clique_fast_cpu_agrees_with_jax(small, capsys, k):
    """clique 4|5 --fast runs CliqueKEngine and clique 6 --fast
    CliqueBigEngine (the plain versions of their kernels on --cpu), and
    each agrees with the JAX package's fast engine."""
    ours = run(main, capsys, "clique", small, k, "--fast", "--cpu",
               "--profile")
    ref = run(jmain, capsys, "clique", small, k, "--fast", "--cpu")
    assert ours["total"] == ref["total"] > 0 and ours["k"] == int(k)
    prof = ours["profile"]
    assert prof["device"] == "cpu"
    assert prof["counters"]["edge_tasks"] > 0
    assert set(prof["kernel_launches"].values()) == {0}
    if k == "6":        # the large-clique count's host split
        assert {"host_hi", "host_lo", "host_hi_estimate"} <= \
            set(prof["phases_s"])


@pytest.mark.parametrize("args", [("motif", "4", "--fast"), ("motif", "3"),
                                  ("sc", "hourglass"), ("sc", "diamond")])
def test_motif_sc_cpu_agree_with_jax(small, capsys, args):
    """motif <k> [--fast] and sc <pattern> on --cpu agree with the JAX
    package's CLI; motif 4 --fast also with the generic formulas."""
    ours = run(main, capsys, args[0], small, *args[1:], "--cpu", "--profile")
    ref = run(jmain, capsys, args[0], small, *args[1:], "--cpu")
    key = "counts" if args[0] == "motif" else "total"
    assert ours[key] == ref[key] and ours[key]
    for k in ("k", "pattern"):
        assert ours.get(k) == ref.get(k)
    assert ours["profile"]["device"] == "cpu"
    assert set(ours["profile"]["kernel_launches"].values()) == {0}
    if "--fast" in args:
        assert ours["counts"] == run(main, capsys, "motif", small, "4",
                                     "--cpu")["counts"]
