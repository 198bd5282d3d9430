"""Port CLI (python -m graphminer_tpu_torch) against the JAX package's CLI
on rmat12 and rmat10 graphs saved in the reference binary format."""
import json
import os
import subprocess
import sys

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
        "bit_colsum", "colsum_pairs", "colsum_finish"}


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


@pytest.mark.parametrize("args", [
    ("tc", "--partition", "2"), ("sgl", "house", "--fast"),
    ("fsm", "2"), ("motif", "3"),
    ("tc", "--fast", "--sharded"), ("tc", "--fast", "--partition", "2")])
def test_unported_exits_naming_roadmap(prefix, args):
    with pytest.raises(SystemExit) as e:
        main([args[0], prefix, *args[1:], "--cpu"])
    assert e.value.code != 0
    assert "ROADMAP.md" in str(e.value.code)


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


@pytest.mark.parametrize("pattern", ["diamond", "rectangle"])
def test_sgl_fast_cpu_agrees_with_jax(small, capsys, pattern):
    """sgl diamond|rectangle --fast runs the triangle support and 4-cycle
    engines (the plain versions of their kernels on --cpu) and agrees with
    the JAX package's fast engine and with the generic plan."""
    ours = run(main, capsys, "sgl", small, pattern, "--fast", "--cpu",
               "--profile")
    ref = run(jmain, capsys, "sgl", small, pattern, "--fast", "--cpu")
    gen = run(main, capsys, "sgl", small, pattern, "--cpu")
    assert ours["total"] == ref["total"] == gen["total"] > 0
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
