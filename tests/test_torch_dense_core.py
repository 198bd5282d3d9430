"""Port dense-core counting (graphminer_tpu_torch/ops/dense_core.py, kernel
G's plain version on the CPU) and workloads/triangle.py::
triangle_count_hybrid against the JAX package's dense_core and hybrid on
the same seeded graphs at cores 256 and 1024; exact."""
import numpy as np
import pytest
import torch

import oracle
from graphminer_tpu.core.graph import HostGraph as JHostGraph
from graphminer_tpu.ops import dense_core as jdense_core
from graphminer_tpu.workloads import triangle as jtriangle
from graphminer_tpu_torch.core.graph import HostGraph
from graphminer_tpu_torch.io.synth import rmat
from graphminer_tpu_torch.ops import cuda_gram, dense_core
from graphminer_tpu_torch.workloads import triangle


@pytest.fixture(scope="module")
def g12():
    return rmat(12, 8, seed=31)


def jax_graph(g):
    return JHostGraph(rowptr=g.rowptr, colidx=g.colidx, is_dag=g.is_dag)


def graphs(rand_graphs, g12):
    return [g12] + [HostGraph(rowptr=g.rowptr, colidx=g.colidx)
                    for g in rand_graphs]


def test_core_rows_bits(g12):
    """Bit j of row i of D is the DAG edge core_start+i → core_start+j;
    words are cdiv(C, 32) padded to a multiple of 8."""
    rg = g12.relabel_by_degree(descending=False).orientation()
    cs = rg.n_vertices - 300
    d = dense_core.core_rows(rg, cs, "cpu")
    assert d.dtype == torch.int32 and d.shape == (300, 16)
    bits = np.unpackbits(d.numpy().view(np.uint8), axis=1,
                         bitorder="little")
    want = np.zeros((300, 16 * 32), np.uint8)
    for v in range(cs, rg.n_vertices):
        nb = rg.neighbors(v).astype(np.int64)
        want[v - cs, nb - cs] = 1
    assert np.array_equal(bits, want)


@pytest.mark.parametrize("core", [256, 1024])
def test_core_triangles_equal_jax(rand_graphs, g12, core):
    for g in graphs(rand_graphs, g12):
        rg = g.relabel_by_degree(descending=False).orientation()
        cs = rg.n_vertices - min(core, rg.n_vertices)
        got = dense_core.core_triangles(rg, cs, device="cpu")
        assert got == jdense_core.core_triangles(jax_graph(rg), cs)
        d = dense_core.core_rows(rg, cs, "cpu")
        assert got == int(cuda_gram.bit_gram_plain(d, d).sum())


@pytest.mark.parametrize("core", [256, 1024])
def test_hybrid_equal_jax(rand_graphs, g12, core):
    want = jtriangle.triangle_count_hybrid(jax_graph(g12), core_size=core)
    assert triangle.triangle_count_hybrid(g12, core_size=core,
                                          device="cpu") == want
    for g in graphs(rand_graphs, g12)[1:]:
        assert triangle.triangle_count_hybrid(g, core_size=core,
                                              device="cpu") == \
            oracle.triangles(g)
    assert triangle.triangle_count(g12, device="cpu") == want
