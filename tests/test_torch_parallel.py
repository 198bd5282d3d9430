"""Port scheduler and partitioner (graphminer_tpu_torch/parallel/
{scheduler,partition}.py) against the JAX package's on the same
numpy-seeded inputs: assignments, induced halo partitions (rowptr, colidx,
global_ids, owned_mask at hops 1 and 2), 2D blocks and their save/fetch
round trip, CSR segments, segmented TC and its task counts, all equal."""
import numpy as np
import pytest
import torch

import oracle
from graphminer_tpu.core.graph import HostGraph as JHostGraph
from graphminer_tpu.parallel import partition as jpartition
from graphminer_tpu.parallel import scheduler as jscheduler
from graphminer_tpu_torch.core.graph import HostGraph
from graphminer_tpu_torch.io.synth import rmat
from graphminer_tpu_torch.parallel import partition, scheduler


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the segmented counts issue many small ops, and
    under xdist the workers' intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_graph(g):
    return JHostGraph(rowptr=g.rowptr, colidx=g.colidx, vlabels=g.vlabels,
                      is_dag=g.is_dag)


def graphs(rand_graphs):
    """rand_graphs[2] and rmat(10, 8, seed=7), undirected."""
    return [HostGraph(rowptr=rand_graphs[2].rowptr,
                      colidx=rand_graphs[2].colidx), rmat(10, 8, seed=7)]


def same_arrays(a, b):
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("n,chunk", [(1, 64), (3, 128), (4, 1000)])
def test_scheduler_assignments_equal_jax(n, chunk):
    rng = np.random.default_rng(n)
    tasks = 5000
    src = rng.integers(0, 1000, tasks).astype(np.int32)
    ds, dd = rng.integers(1, 900, (2, tasks))
    pairs = [(scheduler.round_robin(n, tasks, chunk=chunk),
              jscheduler.round_robin(n, tasks, chunk=chunk)),
             (scheduler.vertex_chunking(n, src, stride=chunk),
              jscheduler.vertex_chunking(n, src, stride=chunk)),
             (scheduler.least_first(n, ds, dd, chunk=chunk),
              jscheduler.least_first(n, ds, dd, chunk=chunk))]
    for ours, ref in pairs:
        assert len(ours) == len(ref) == n
        for a, b in zip(ours, ref):
            same_arrays(a, b)
        assert np.array_equal(np.sort(np.concatenate(ours)),
                              np.arange(tasks))


@pytest.mark.parametrize("hops", [1, 2])
@pytest.mark.parametrize("n_parts", [2, 3])
def test_induced_partitions_equal_jax(rand_graphs, hops, n_parts):
    """Both the undirected graph and the oriented DAG (the partition
    contract), with vertex labels carried along."""
    for g in graphs(rand_graphs):
        g.vlabels = np.random.default_rng(3).integers(
            1, 5, g.n_vertices).astype(np.uint8)
        for h in (g, g.orientation()):
            same_arrays(partition.edgecut_partition_1d(h, n_parts),
                        jpartition.edgecut_partition_1d(jax_graph(h),
                                                        n_parts))
            ours = partition.induced_partition_1d(h, n_parts, hops=hops)
            ref = jpartition.induced_partition_1d(jax_graph(h), n_parts,
                                                  hops=hops)
            assert len(ours) == len(ref)
            assert sum(p.n_owned for p in ours) == h.n_vertices
            for a, b in zip(ours, ref):
                same_arrays(a.graph.rowptr, b.graph.rowptr)
                same_arrays(a.graph.colidx, b.graph.colidx)
                same_arrays(a.graph.vlabels, b.graph.vlabels)
                same_arrays(a.global_ids, b.global_ids)
                same_arrays(a.owned_mask, b.owned_mask)
                assert (a.n_owned, a.owned_start, a.owned_stop,
                        a.graph.is_dag, a.graph.name) == \
                    (b.n_owned, b.owned_start, b.owned_stop,
                     b.graph.is_dag, b.graph.name)
                a.graph.validate()


def test_induced_partition_unsorted_rows():
    """Rows that are not sorted come out sorted, as the JAX package's
    per-row np.sort leaves them."""
    g = rmat(8, 8, seed=5)
    rng = np.random.default_rng(1)
    col = g.colidx.copy()
    for v in range(g.n_vertices):
        b, e = g.rowptr[v], g.rowptr[v + 1]
        col[b:e] = rng.permutation(col[b:e])
    h = HostGraph(rowptr=g.rowptr, colidx=col)
    for hops in (1, 2):
        for a, b in zip(partition.induced_partition_1d(h, 3, hops),
                        jpartition.induced_partition_1d(jax_graph(h), 3,
                                                        hops)):
            same_arrays(a.graph.colidx, b.graph.colidx)


def test_induced_partition_triangles(rand_graphs):
    """Per-partition owned-anchor triangle counts sum to the global count
    (the distributed-counting invariant), orientation before
    partitioning."""
    g = graphs(rand_graphs)[0]
    dag = g.orientation()
    for n_parts in (2, 3):
        total = 0
        for p in partition.induced_partition_1d(dag, n_parts):
            lg = p.graph
            src, dst = lg.edge_list()
            own = p.owned_mask[src]
            for u, v in zip(src[own], dst[own]):
                total += np.intersect1d(lg.neighbors(u), lg.neighbors(v),
                                        True).size
        assert total == oracle.triangles(g)


def test_partition_2d_and_fetch_equal_jax(rand_graphs, tmp_path):
    g = graphs(rand_graphs)[1]
    cids = np.random.default_rng(5).integers(0, 3, g.n_vertices)
    ours = partition.partition_2d(g, cids)
    ref = jpartition.partition_2d(jax_graph(g), cids)
    assert ours.n_clusters == ref.n_clusters == 3
    same_arrays(ours.cluster_ids, ref.cluster_ids)
    same_arrays(ours.rank_in_cluster, ref.rank_in_cluster)
    for a, b in zip(ours.verts_of_cluster, ref.verts_of_cluster):
        same_arrays(a, b)
    for i in range(3):
        for j in range(3):
            for a, b in zip(ours.block(i, j), ref.block(i, j)):
                same_arrays(a, b)
    assert sum(c.size for c in ours.colidx) == g.n_edges
    path, jpath = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    partition.save_partitions_2d(path, ours)
    jpartition.save_partitions_2d(jpath, ref)
    for sel in ([0, 1, 2], [1], [0, 2]):
        a = partition.fetch_partitions(path, sel)
        b = jpartition.fetch_partitions(jpath, sel)
        same_arrays(a.rowptr, b.rowptr)
        same_arrays(a.colidx, b.colidx)
    full = partition.fetch_partitions(path, [2, 1, 0])
    same_arrays(full.rowptr, g.rowptr)
    same_arrays(full.colidx, g.colidx)


@pytest.mark.parametrize("n_segments", [1, 3, 4])
def test_segments_and_segmented_tc_equal_jax(rand_graphs, n_segments):
    small, g10 = graphs(rand_graphs)
    for g in (small, g10):
        for a, b in zip(partition.csr_segmenting(g, n_segments),
                        jpartition.csr_segmenting(jax_graph(g),
                                                  n_segments)):
            same_arrays(a.rowptr, b.rowptr)
            same_arrays(a.colidx, b.colidx)
            assert (a.name, a.is_dag) == (b.name, b.is_dag)
        assert partition.segment_task_counts(g, n_segments) == \
            jpartition.segment_task_counts(jax_graph(g), n_segments)
    assert partition.triangle_count_segmented(
        small, n_segments, chunk=256, device="cpu") == oracle.triangles(small)
    assert partition.triangle_count_segmented(
        g10, n_segments, chunk=256, device="cpu") == \
        jpartition.triangle_count_segmented(jax_graph(g10), n_segments)
