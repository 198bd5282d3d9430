"""Port host layer (graphminer_tpu_torch core/graph, io, native_bridge)
against the JAX package on the same inputs: equal arrays, exactly."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from graphminer_tpu.io import loader as jloader
from graphminer_tpu.io import synth as jsynth
from graphminer_tpu_torch import native_bridge
from graphminer_tpu_torch.io import cache, loader, synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_csr_equal(a, b):
    assert np.array_equal(a.rowptr, b.rowptr)
    assert np.array_equal(a.colidx, b.colidx)
    assert a.rowptr.dtype == b.rowptr.dtype == np.int64
    assert a.colidx.dtype == b.colidx.dtype == np.int32


@pytest.mark.parametrize("scale", [8, 9, 10, 11, 12])
def test_rmat_csr_equal(scale):
    assert_csr_equal(synth.rmat(scale, 16, seed=7),
                     jsynth.rmat(scale, 16, seed=7))


@pytest.mark.parametrize("scale,ef,seed", [(10, 8, 2), (12, 16, 7),
                                           (13, 8, 11)])
def test_relabel_orient_csr_equal(scale, ef, seed):
    ours = synth.rmat(scale, ef, seed=seed).relabel_by_degree(
        descending=False).orientation()
    ref = jsynth.rmat(scale, ef, seed=seed).relabel_by_degree(
        descending=False).orientation()
    assert ours.is_dag and ref.is_dag
    assert_csr_equal(ours, ref)
    ours.validate()


def test_numpy_fallback_matches_native(monkeypatch):
    """The numpy paths of core/graph.py give the native bridge's CSR."""
    g = synth.rmat(10, 8, seed=5)
    nat = g.relabel_by_degree(descending=False).orientation()
    nat_el = nat.edge_list(sym_break=True)
    monkeypatch.setattr(native_bridge, "get_lib", lambda: None)
    npy = g.relabel_by_degree(descending=False).orientation()
    assert_csr_equal(nat, npy)
    for a, b in zip(nat_el, npy.edge_list(sym_break=True)):
        assert np.array_equal(a, b)


def test_native_bridge_builds_its_own_library():
    """The bridge loads its own build of graphcore.cpp, never the committed
    native/libgraphcore.so (built with -march=native elsewhere)."""
    lib = native_bridge.get_lib()
    assert lib is not None
    assert native_bridge._lib_path().startswith(native_bridge.BUILD_DIR)
    assert "-march=native" not in native_bridge.CXXFLAGS


def test_loader_roundtrip_both_ways(tmp_path):
    g = synth.rmat(9, 8, seed=3)
    loader.save_graph(g, str(tmp_path / "port" / "graph"))
    ref = jloader.load_graph(str(tmp_path / "port" / "graph"))
    assert_csr_equal(g, ref)
    assert ref.meta.max_degree == g.max_degree

    jg = jsynth.rmat(9, 8, seed=4)
    jloader.save_graph(jg, str(tmp_path / "jax" / "graph"))
    ours = loader.load_graph(str(tmp_path / "jax" / "graph"))
    assert_csr_equal(ours, jg)
    assert dataclasses.asdict(ours.meta) == dataclasses.asdict(
        jloader.read_meta(str(tmp_path / "jax" / "graph")))


def test_cache_roundtrip(tmp_path):
    g = synth.rmat(8, 8, seed=1).relabel_by_degree(False).orientation()
    calls = []
    build = lambda: calls.append(1) or g
    a = cache.cached_graph("rmat8", build, cache_dir=str(tmp_path))
    b = cache.cached_graph("rmat8", build, cache_dir=str(tmp_path))
    assert calls == [1]
    assert_csr_equal(a, b)
    assert b.is_dag
    assert cache.load_graph("absent", cache_dir=str(tmp_path)) is None


def test_port_never_imports_jax():
    code = ("import sys\n"
            "import graphminer_tpu_torch, graphminer_tpu_torch.ops.stream, "
            "graphminer_tpu_torch.ops.ring, graphminer_tpu_torch.__main__\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert 'graphminer_tpu' not in sys.modules\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_port_sources_name_no_jax():
    for root, _, files in os.walk(os.path.join(REPO, "graphminer_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    src = fh.read()
                assert "import jax" not in src and "from jax" not in src, f
