"""Port triangle support and diamond engine
(graphminer_tpu_torch/ops/tri_support.py, kernels S, P and I's plain
versions and the X + torch._int_mm Gram) against the JAX package's
ops/tri_support.py on the same graphs: the task arrays and the per-task
support element for element, the diamond count against JAX's and the
port's generic frontier count, Σ tri against three times the triangle
count. Inputs from numpy seeds; all exact."""
import functools

import numpy as np
import pytest
import torch

from graphminer_tpu.core.graph import HostGraph as JHostGraph
from graphminer_tpu.ops import tri_support as jts
from graphminer_tpu_torch.core.graph import HostGraph
from graphminer_tpu_torch.io.synth import erdos_renyi, rmat
from graphminer_tpu_torch.ops import tri_support as ts
from graphminer_tpu_torch.ops.hubcore import triangle_count_fast
from graphminer_tpu_torch.workloads.sgl import sgl_count

#: name -> graph maker: ER graphs, the rand_graphs recipe and rmat10/11
GRAPHS = {"er80": lambda: erdos_renyi(80, 0.2, 5),
          "er200": lambda: erdos_renyi(200, 0.05, 6),
          "rmat10": lambda: rmat(10, 8, seed=4),
          "rmat11": lambda: rmat(11, 8, seed=9)}


def jax_graph(g):
    return JHostGraph(rowptr=g.rowptr, colidx=g.colidx)


@functools.lru_cache(maxsize=None)
def graph(name):
    return GRAPHS[name]()


def same_support(g, core):
    ours = ts.tri_support(g, core=core, device="cpu")
    ref = jts.tri_support(jax_graph(g), core=core)
    assert ours.n_vertices == ref.n_vertices
    assert ours.src.dtype == ref.src.dtype == np.int64
    assert np.array_equal(ours.src, ref.src)
    assert np.array_equal(ours.dst, ref.dst)
    assert ours.tri.dtype == torch.int64 and ours.tri.device.type == "cpu"
    assert np.array_equal(ours.tri.numpy(), ref.tri)
    return ours


@pytest.mark.parametrize("core", [8, 32, 64, 128])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_tri_support_equals_jax(name, core):
    """Every task class (cc, sc, ss) at the small cores, on each graph."""
    g = graph(name)
    ours = same_support(g, core)
    cs = ours.n_vertices - min(core, ours.n_vertices)
    cc = ours.src >= cs
    assert cc.any()
    if cs:                                        # core < V: sc tasks
        assert (~cc & (ours.dst >= cs)).any()
    if name.startswith("rmat"):
        assert (ours.dst < cs).any()              # and ss tasks


def brute_support(g, src, dst):
    """|N(u) ∩ N(v)| per task by Python sets over the relabeled graph."""
    rg = g.relabel_by_degree(descending=False)
    adj = [set(rg.neighbors(x).tolist()) for x in range(rg.n_vertices)]
    return np.array([len(adj[u] & adj[w]) for u, w in zip(src, dst)],
                    dtype=np.int64)


@pytest.mark.parametrize("core", [8, 32, 64, 128])
def test_tri_support_rand_graphs(rand_graphs, core):
    """Against a brute-force oracle on every rand_graphs graph, and against
    JAX at core >= 32. At core 8, JAX's tri_support raises on one of them:
    its width classes cover the src ends' lists only
    (graphminer_tpu/ops/tri_support.py:207), and an ss task's dst list is
    longer; the port has no width classes."""
    for jg in rand_graphs:
        g = HostGraph(rowptr=jg.rowptr, colidx=jg.colidx)
        ours = ts.tri_support(g, core=core, device="cpu")
        assert np.array_equal(ours.tri.numpy(),
                              brute_support(g, ours.src, ours.dst))
        if core >= 32:
            same_support(g, core)


def test_gram_slab_invariance():
    """`chunk` (the Gram's rows a slab) does not change tri: 64-row slabs,
    a ragged last slab, and one slab."""
    g = graph("rmat11")
    ref = ts.tri_support(g, core=128, device="cpu").tri
    for chunk in (64, 100):
        got = ts.tri_support(g, core=128, chunk=chunk, device="cpu").tri
        assert torch.equal(got, ref)


def test_tri_support_whole_core_is_t1_only():
    """core >= V: every task is cc with an empty sub-core, so tri is
    kernel S's part alone (the early return), equal to JAX's."""
    same_support(graph("rmat10"), 4096)


@functools.lru_cache(maxsize=None)
def frontier_diamonds():
    """(graph, its diamond count by the generic frontier plan)."""
    g = rmat(11, 8, seed=9).sort_neighbors()
    return g, sgl_count(g, "diamond", device="cpu")


@pytest.mark.parametrize("core", [32, 128, 4096])
def test_diamond_equals_jax_and_frontier(core):
    g, want = frontier_diamonds()
    assert want > 0
    assert ts.diamond_count_fast(g, core=core, device="cpu") == want == \
        jts.diamond_count_fast(jax_graph(g), core=core)


def test_diamond_workload_routing():
    g = graph("rmat10")
    assert sgl_count(g, "diamond", fast=True, device="cpu") == \
        sgl_count(g, "diamond", device="cpu")


@pytest.mark.parametrize("core", [16, 4096])
def test_tri_sum_is_three_triangles(core):
    g = rmat(11, 8, seed=2)
    tri = ts.tri_support(g, core=core, device="cpu").tri
    assert int(tri.sum()) == 3 * triangle_count_fast(g, device="cpu")


def test_pack_full_core_bitmaps_equal_jax():
    """FBc words equal JAX's, bit-31 words included."""
    rg = graph("rmat11").relabel_by_degree(descending=False)
    for core in (32, 200, 2048):
        c, cs, words = ts.core_split(rg, core)
        ours = ts._pack_full_core_bitmaps(rg, cs, words)
        ref = jts._pack_full_core_bitmaps(jax_graph(rg), cs, words)
        assert ours.dtype == np.int32 and np.array_equal(ours, ref)
    assert (ours < 0).any()


def test_gram_rows_equal_dense_product():
    """The slab Gram over gathered rows (several slabs, a ragged last one)
    equals the dense product of the expanded rows."""
    rng = np.random.default_rng(3)
    tab = rng.integers(-2**31, 2**31, (300, 8), dtype=np.int64).astype(
        np.int32)
    keep = np.sort(rng.choice(300, 150, replace=False))
    bits = (tab[keep][:, :, None].view(np.uint32) >> np.arange(32,
            dtype=np.uint32)) & 1
    x = bits.reshape(keep.size, 256).astype(np.int64)
    got = ts.gram_rows(torch.from_numpy(tab), keep, 8, slab=64)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), x.T @ x)
