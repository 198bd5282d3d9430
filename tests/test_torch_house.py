"""Port house engine (graphminer_tpu_torch/ops/house.py: kernel H's plain
version, the native t3ss share, tri_support) against the JAX package's
ops/house.py on the same graphs: the DAG edges and T3 per edge element for
element, the house count, the dense A³ identity, the generic frontier count
on small graphs, and the bridge's t3ss against the dense sub-sub share.
Inputs from numpy seeds; all exact."""
import functools

import numpy as np
import pytest
import torch

from graphminer_tpu.core.graph import HostGraph as JHostGraph
from graphminer_tpu.ops import house as jh
from graphminer_tpu_torch import native_bridge
from graphminer_tpu_torch.core.graph import HostGraph
from graphminer_tpu_torch.io.synth import erdos_renyi, rmat
from graphminer_tpu_torch.ops import house as h
from graphminer_tpu_torch.ops import tri_support as ts
from graphminer_tpu_torch.ops.cuda_house import house_t3
from graphminer_tpu_torch.ops.cuda_tri import FtLists
from graphminer_tpu_torch.ops.slab_form import house_t3_slab
from graphminer_tpu_torch.workloads.sgl import sgl_count

#: name -> graph maker: the ER graphs and rmat10/11
GRAPHS = {"er40": lambda: erdos_renyi(40, 0.3, 0),
          "er64": lambda: erdos_renyi(64, 0.2, 1),
          "er80": lambda: erdos_renyi(80, 0.25, 2),
          "er64b": lambda: erdos_renyi(64, 0.2, 3),
          "rmat10": lambda: rmat(10, 8, seed=5),
          "rmat11": lambda: rmat(11, 8, seed=23)}


@functools.lru_cache(maxsize=None)
def graph(name):
    return GRAPHS[name]()


def jax_graph(g):
    return JHostGraph(rowptr=g.rowptr, colidx=g.colidx)


def port_graph(g):
    return HostGraph(rowptr=g.rowptr, colidx=g.colidx)


@pytest.mark.parametrize("name,core", [("er40", 8), ("er64", 16),
                                       ("er80", 32), ("er64b", 64),
                                       ("rmat10", 64), ("rmat10", 256)])
def test_edge_t3_equals_jax(name, core):
    """The DAG edges and T3 per edge against JAX's edge_t3 (its bilinear,
    WS dots and t3ss)."""
    g = graph(name)
    rg, src, dst, t3 = h.edge_t3(g, core=core, device="cpu")
    _, jsrc, jdst, jt3 = jh.edge_t3(jax_graph(g), core=core)
    assert np.array_equal(src, jsrc) and np.array_equal(dst, jdst)
    assert t3.dtype == torch.int64 and t3.device.type == "cpu"
    assert np.array_equal(t3.numpy(), jt3)


@pytest.mark.parametrize("name,core", [("er40", 8), ("er80", 32),
                                       ("rmat10", 256)])
def test_edge_t3_is_a_cubed(name, core):
    """T3_e = (A³)_uv at every DAG edge of the relabeled graph (float64
    products of 0/1 matrices, exact below 2^53)."""
    rg, src, dst, t3 = h.edge_t3(graph(name), core=core, device="cpu")
    a = np.zeros((rg.n_vertices,) * 2, dtype=np.float64)
    a[np.repeat(np.arange(rg.n_vertices), np.diff(rg.rowptr)),
      rg.colidx] = 1
    assert np.array_equal(t3.numpy(), (a @ a @ a)[src, dst].astype(np.int64))


def test_house_count_fast_rand_graphs(rand_graphs):
    """The house count against JAX's on every rand_graphs graph at core 16
    (both H calls and t3ss) and at core n (no sub-core vertex), and against
    the port's generic frontier count (graphs of at most 80 vertices)."""
    for jg in rand_graphs:
        g = port_graph(jg)
        want = jh.house_count_fast(jg, core=16)
        assert h.house_count_fast(g, core=16, device="cpu") == want
        assert h.house_count_fast(g, core=g.n_vertices, device="cpu") == \
            want
        assert sgl_count(g, "house", device="cpu") == want


def test_house_count_fast_rmat11():
    g = graph("rmat11")
    assert h.house_count_fast(g, core=128, device="cpu") == \
        jh.house_count_fast(jax_graph(g), core=128) > 0


def test_t3ss_native_equals_dense():
    """native_bridge.t3ss (gm_t3ss) and the numpy walk against the dense
    sub-sub share A[:, sub] A_ss A[sub, :] at the DAG edges."""
    g = graph("rmat10")
    rg = g.relabel_by_degree(descending=False)
    cs = rg.n_vertices - 64
    nat = native_bridge.t3ss(rg.rowptr, rg.colidx, cs)
    assert nat is not None and nat.dtype == np.int32
    keep = rg.colidx > np.repeat(np.arange(rg.n_vertices), np.diff(rg.rowptr))
    want = h._t3ss_numpy(rg, cs)
    assert want.any()
    assert np.array_equal(nat[keep], want)
    assert not nat[~keep].any()
    assert np.array_equal(h._t3ss_host(rg, cs), nat)


def test_yardstick_equals_kernel_calls():
    """The JAX-form yardstick (ops/slab_form.py::house_t3_slab: X + torch.
    _int_mm + W's write mode) equals H's two calls added per edge."""
    g = graph("rmat10")
    rg = g.relabel_by_degree(descending=False)
    c, cs, words = ts.core_split(rg, 64)
    deg, core_nb = ts.core_neighbours(rg, cs)
    table = torch.from_numpy(ts._pack_full_core_bitmaps(rg, cs, words))
    src, dst = h._dag_edges(rg)
    t = lambda x: torch.from_numpy(x.astype(np.int32))
    rows = FtLists.from_csr(rg.rowptr, rg.colidx, deg, "cpu")
    ft = FtLists.from_csr(rg.rowptr, rg.colidx, deg - core_nb, "cpu")
    want = house_t3(rows, table, t(src), t(dst)).long() + \
        house_t3(ft, table, t(dst), t(src)).long()
    got = house_t3_slab(table, ft, cs, t(src), t(dst), chunk=1000)
    assert got.dtype == torch.int64 and torch.equal(got, want)


def test_prof_house_counts():
    """scripts/prof_house.py's counting on the CPU (rmat11 at core 256,
    both calls): every task dotted once by the new plan, against the first
    design's segments; slots built once a list in call 1; fewer popcounts
    and table rows read; the tasks on either side of LIST_SPARSE (in block
    and in warp items) add up to the tasks."""
    from graphminer_tpu_torch.scripts import prof_house
    out = prof_house.main(["--scale", "11", "--core", "256",
                           "--device", "cpu"])
    assert len(out["calls"]) == 2
    for c in out["calls"]:
        new, first = c["work"]["built"], c["work"]["first design"]
        assert new["dotted_over_n"] == 1.0 <= first["dotted_over_n"]
        assert new["distinct_slots"] == first["distinct_slots"] <= \
            new["slots_built"] <= first["slots_built"]
        assert new["popcounts"] < first["popcounts"]
        assert new["table_rows_read"] < first["table_rows_read"]
        assert new["tasks_block"] + new["tasks_warp"] == new["tasks"]
        assert new["block_items"] > 0 and c["work"]["plan_ms"] > 0
    assert out["calls"][0]["work"]["built"]["slots_built"] == \
        out["calls"][0]["work"]["built"]["distinct_slots"]
