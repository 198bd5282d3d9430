"""Port sharded counting (graphminer_tpu_torch/parallel/mesh.py) against the
JAX package's parallel/mesh.py and generic count on the same seeded graphs:
shard assignments equal JAX's with its SENTINEL padding taken off, equal
shard_balance, and exact sharded counts on meshes of CPU devices (repeated
devices count in turn; distinct ones in threads)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from graphminer_tpu.core.graph import HostGraph as JHostGraph
from graphminer_tpu.core.plan import SGL_PLANS as JSGL_PLANS
from graphminer_tpu.core.plan import clique_plan as jclique_plan
from graphminer_tpu.engine.frontier import count_pattern as jcount_pattern
from graphminer_tpu.parallel import mesh as jmesh
from graphminer_tpu_torch.core.graph import HostGraph
from graphminer_tpu_torch.core.plan import SGL_PLANS, TRIANGLE, clique_plan
from graphminer_tpu_torch.io.synth import rmat
from graphminer_tpu_torch.parallel import mesh

SENTINEL = 0x7FFFFFFF
SHAPES = [((1, 8), ("host", "chip")), ((2, 4), ("host", "chip")),
          ((8,), ("chip",))]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the frontier issues many small ops, and under
    xdist the workers' intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_graph(g):
    return JHostGraph(rowptr=g.rowptr, colidx=g.colidx, is_dag=g.is_dag)


@pytest.fixture(scope="module")
def g10():
    return rmat(10, 8, seed=7)


def test_make_mesh():
    for shape, axes in SHAPES:
        m = mesh.make_mesh(devices=["cpu"] * 8, shape=shape,
                           axis_names=axes)
        assert m.devices.shape == shape and m.devices.size == 8
        assert m.shape == dict(zip(axes, shape))
        assert all(d == torch.device("cpu") for d in m.devices.flat)
    assert mesh.make_mesh(devices=[torch.device("cpu")]).shape == \
        {"host": 1, "chip": 1}
    with pytest.raises(ValueError):
        mesh.make_mesh(devices=["cpu"] * 4, shape=(4,))


def test_make_mesh_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.make_mesh()


@pytest.mark.parametrize("policy", ["least_first", "round_robin"])
@pytest.mark.parametrize("n_shards,chunk", [(1, 64), (3, 128), (8, 256)])
def test_shard_tasks_equal_jax_unpadded(g10, policy, n_shards, chunk):
    dag = g10.orientation()
    src, dst = dag.edge_list()
    deg = np.diff(dag.rowptr)
    ours = mesh._shard_tasks(src, dst, deg, n_shards, chunk, policy=policy)
    js, jd = jmesh._shard_tasks(src, dst, deg, n_shards, chunk,
                                policy=policy)
    js = np.asarray(js).reshape(n_shards, -1)
    jd = np.asarray(jd).reshape(n_shards, -1)
    assert len(ours) == n_shards
    for (s, d), a, b in zip(ours, js, jd):
        n = s.shape[0]
        assert np.array_equal(s, a[:n]) and np.array_equal(d, b[:n])
        assert (a[n:] == SENTINEL).all() and (b[n:] == SENTINEL).all()
    assert sum(s.shape[0] for s, _ in ours) == src.shape[0]
    assert mesh.shard_balance(dag, n_shards, chunk, policy) == \
        jmesh.shard_balance(jax_graph(dag), n_shards, chunk, policy)


@pytest.mark.parametrize("shape,axes", SHAPES)
def test_sharded_counts_cpu_meshes(rand_graphs, g10, shape, axes):
    m = mesh.make_mesh(devices=["cpu"] * 8, shape=shape, axis_names=axes)
    for rg in rand_graphs:
        g = HostGraph(rowptr=rg.rowptr, colidx=rg.colidx)
        assert mesh.count_pattern_sharded(g, TRIANGLE, mesh=m, chunk=64) \
            == oracle.triangles(g)
    jg = jax_graph(g10)
    assert mesh.count_pattern_sharded(g10, clique_plan(4), mesh=m,
                                      chunk=256) == \
        jcount_pattern(jg, jclique_plan(4))
    assert mesh.count_pattern_sharded(g10, SGL_PLANS["diamond"], mesh=m,
                                      chunk=128) == \
        jcount_pattern(jg, JSGL_PLANS["diamond"])


def test_sharded_equals_jax_sharded(g10):
    """Against JAX's own sharded count on its 8-device CPU mesh (once: its
    compile is slow), round_robin on our side too."""
    jm = jmesh.make_mesh(shape=(2, 4))
    want = jmesh.count_pattern_sharded(jax_graph(g10), jclique_plan(3),
                                       mesh=jm, chunk=256)
    m = mesh.make_mesh(devices=["cpu"] * 8, shape=(2, 4))
    for policy in ("least_first", "round_robin"):
        assert mesh.count_pattern_sharded(g10, clique_plan(3), mesh=m,
                                          chunk=256, policy=policy) == want


def test_sharded_threads_distinct_devices(g10):
    """Distinct devices (cpu:0 ... cpu:3, all the host's memory) count in
    one thread each, and repeated ones in turn; the sum is exact, and an
    error in a thread reaches the caller."""
    want = jcount_pattern(jax_graph(g10), jclique_plan(3))
    m = mesh.make_mesh(devices=[f"cpu:{i % 4}" for i in range(8)],
                       shape=(2, 4))
    assert len(set(m.devices.flat)) == 4
    for chunk in (64, 1000):
        assert mesh.count_pattern_sharded(g10, TRIANGLE, mesh=m,
                                          chunk=chunk) == want
    with pytest.raises(ValueError):
        mesh.count_pattern_sharded(g10, TRIANGLE, mesh=m, chunk=64,
                                   backend="no such backend")
