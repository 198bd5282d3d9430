"""Port generic triangle count (graphminer_tpu_torch/workloads/triangle.py,
utils/exec.py, utils/bucketing.py) against tests/oracle.py and the JAX
package's workloads.triangle: both setops backends, bucketed and not, a
chunk boundary, and triangles_per_edge. Counts must be equal exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from graphminer_tpu.core.graph import HostGraph as JHostGraph
from graphminer_tpu.utils import bucketing as jbucketing
from graphminer_tpu.utils import exec as jexec
from graphminer_tpu.workloads import triangle as jtriangle
from graphminer_tpu_torch.core.graph import HostGraph
from graphminer_tpu_torch.io.synth import rmat
from graphminer_tpu_torch.types import SENTINEL
from graphminer_tpu_torch.utils import bucketing, exec as texec
from graphminer_tpu_torch.workloads import triangle


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: these tests issue many small torch ops, and under
    xdist the workers' intra-op threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_graphs(rand_graphs):
    return [HostGraph(rowptr=g.rowptr, colidx=g.colidx) for g in rand_graphs]


def jax_graph(g):
    return JHostGraph(rowptr=g.rowptr, colidx=g.colidx, is_dag=g.is_dag)


@pytest.mark.parametrize("backend", ["bc", "bs", "auto"])
@pytest.mark.parametrize("bucketed", [True, False])
def test_random_vs_oracle_and_jax(rand_graphs, backend, bucketed):
    for g in port_graphs(rand_graphs):
        want = oracle.triangles(g)
        assert triangle.triangle_count(g, backend=backend, bucketed=bucketed,
                                       device="cpu") == want
    g = port_graphs(rand_graphs)[3]
    assert jtriangle.triangle_count(jax_graph(g), backend=backend,
                                    bucketed=bucketed) == oracle.triangles(g)


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_chunk_boundary(rand_graphs, chunk):
    g = port_graphs(rand_graphs)[1]
    assert triangle.triangle_count(g, chunk=chunk, device="cpu") == \
        oracle.triangles(g)


def test_rmat12_equals_jax():
    g = rmat(12, 16, seed=7)
    want = jtriangle.triangle_count(jax_graph(g))
    assert want == 482_181
    assert triangle.triangle_count(g, device="cpu") == want


def test_triangles_per_edge_equal_jax(rand_graphs):
    g = port_graphs(rand_graphs)[2]
    src, dst = g.edge_list()
    got = triangle.triangles_per_edge(g, src, dst, chunk=50, device="cpu")
    want = np.asarray(jtriangle.triangles_per_edge(
        jax_graph(g), jnp.asarray(src), jnp.asarray(dst), chunk=50))
    assert got.shape == (src.shape[0],)
    assert np.array_equal(got.numpy(), want)
    assert int(got.sum()) == 6 * oracle.triangles(g)


def test_bucketing_equal_jax():
    rng = np.random.default_rng(4)
    for maxdeg in (5, 64, 3000, 20000):
        du = rng.integers(0, maxdeg + 1, 500)
        dv = rng.integers(0, maxdeg + 1, 500)
        assert bucketing.width_class(du, maxdeg)[1] == \
            jbucketing.width_class(du, maxdeg)[1]
        o1, g1 = bucketing.bucket_edge_tasks(du, dv, maxdeg)
        o2, g2 = jbucketing.bucket_edge_tasks(du, dv, maxdeg)
        assert np.array_equal(o1, o2) and g1 == g2
    for n in (0, 5, 1025, 20000, 10**6):
        assert bucketing.pick_chunk(n) == jbucketing.pick_chunk(n)


def test_exec_chunks_equal_jax():
    x = np.arange(11, dtype=np.int32)
    ours = texec.pad_to_chunks((torch.from_numpy(x),), 4)[0]
    ref = jexec.pad_to_chunks((jnp.asarray(x),), 4)[0]
    assert np.array_equal(ours.numpy(), np.asarray(ref))
    assert int(ours[-1, -1]) == SENTINEL
    # padded tasks carry SENTINEL and add 0
    fn = lambda t: torch.where(t == SENTINEL, 0, t)
    assert int(texec.sum_chunked(fn, (torch.from_numpy(x),), 4)) == 55
    total = texec.sum_chunked(fn, (torch.from_numpy(x),), 4)
    assert total.shape == () and total.dtype == torch.int64
    out = texec.map_chunked(fn, (torch.from_numpy(x),), 4)
    assert out.shape == (12,) and out[:11].tolist() == x.tolist()


def test_hybrid_dense_core_not_ported(rand_graphs):
    """triangle_count_hybrid (the dense core on kernel G's plain version)
    gives JAX's hybrid count at the default core."""
    g = port_graphs(rand_graphs)[0]
    assert triangle.triangle_count_hybrid(g, device="cpu") == \
        jtriangle.triangle_count_hybrid(jax_graph(g)) == oracle.triangles(g)


def test_fast_is_hub_core(rand_graphs):
    g = port_graphs(rand_graphs)[3]
    assert triangle.triangle_count_fast(g, device="cpu") == \
        oracle.triangles(g)
