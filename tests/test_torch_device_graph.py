"""Port DeviceGraph (graphminer_tpu_torch/core/device_graph.py) against the
JAX package's DeviceGraph: the padded table, gather_rows and
gather_elabel_rows with the table and with the flat CSR, at widths below,
equal to and above the padded width, with out-of-range and SENTINEL ids;
labels_of and degree_of. Arrays must be equal exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphminer_tpu.core.device_graph import DeviceGraph as JDeviceGraph
from graphminer_tpu.core.graph import HostGraph as JHostGraph
from graphminer_tpu_torch.core.device_graph import DeviceGraph, _pad_width
from graphminer_tpu_torch.io.synth import labeled_er, rmat
from graphminer_tpu_torch.types import SENTINEL


def jax_graph(g):
    return JHostGraph(rowptr=g.rowptr, colidx=g.colidx, vlabels=g.vlabels,
                      elabels=g.elabels, is_dag=g.is_dag)


@pytest.fixture(scope="module")
def graph():
    return labeled_er(70, 0.12, seed=5)


def ids(n_vertices):
    rng = np.random.default_rng(1)
    vs = rng.integers(0, n_vertices, 40).astype(np.int32)
    vs[:5] = [-1, -7, n_vertices, n_vertices + 3, SENTINEL]
    return vs


def pair(g, use_table):
    ours = DeviceGraph.from_host(g, device="cpu", use_table=use_table)
    ref = JDeviceGraph.from_host(jax_graph(g), use_table=use_table)
    return ours, ref


@pytest.mark.parametrize("use_table", [True, False])
def test_layout_equal(graph, use_table):
    ours, ref = pair(graph, use_table)
    for name in ("rowptr", "colidx", "deg", "vlabels", "elabels"):
        assert np.array_equal(getattr(ours, name).numpy(),
                              np.asarray(getattr(ref, name))), name
    assert (ours.adj_table is None) == (ref.adj_table is None) == \
        (not use_table)
    if use_table:
        assert np.array_equal(ours.adj_table.numpy(),
                              np.asarray(ref.adj_table))
        assert np.array_equal(ours.elab_table.numpy(),
                              np.asarray(ref.elab_table))
    assert (ours.n_vertices, ours.n_edges, ours.max_degree) == \
        (ref.n_vertices, ref.n_edges, ref.max_degree)


@pytest.mark.parametrize("use_table", [True, False])
@pytest.mark.parametrize("delta", [-5, 0, 9])
def test_gather_rows_equal(graph, use_table, delta):
    ours, ref = pair(graph, use_table)
    width = _pad_width(graph.max_degree) + delta
    vs = ids(graph.n_vertices)
    t = torch.from_numpy(vs)
    for fn in ("gather_rows", "gather_elabel_rows"):
        got = getattr(ours, fn)(t, width)
        want = np.asarray(getattr(ref, fn)(jnp.asarray(vs), width))
        assert got.shape == (vs.shape[0], width)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want), fn


def test_labels_and_degrees_equal(graph):
    ours, ref = pair(graph, True)
    vs = ids(graph.n_vertices)
    for fn in ("labels_of", "degree_of"):
        got = getattr(ours, fn)(torch.from_numpy(vs))
        want = np.asarray(getattr(ref, fn)(jnp.asarray(vs)))
        assert np.array_equal(got.numpy(), want), fn
    tile = vs.reshape(8, 5)   # labels_of also takes candidate tiles
    assert np.array_equal(ours.labels_of(torch.from_numpy(tile)).numpy(),
                          np.asarray(ref.labels_of(jnp.asarray(tile))))


def test_budget_picks_flat_csr():
    g = rmat(9, 8, seed=3)
    wpad = _pad_width(g.max_degree)
    small = DeviceGraph.from_host(g, device="cpu",
                                  table_budget=g.n_vertices * wpad * 4 - 1)
    big = DeviceGraph.from_host(g, device="cpu")
    assert small.adj_table is None and big.adj_table is not None
    vs = torch.from_numpy(ids(g.n_vertices))
    assert torch.equal(small.gather_rows(vs, wpad + 3),
                       big.gather_rows(vs, wpad + 3))


@pytest.mark.parametrize("maxdeg,want", [(1, 8), (8, 8), (9, 16), (64, 64),
                                         (65, 128), (300, 384)])
def test_pad_width(maxdeg, want):
    from graphminer_tpu.core.device_graph import _pad_width as jpad
    assert _pad_width(maxdeg) == jpad(maxdeg) == want


def test_cuda_request_without_card_raises(graph):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError):
        DeviceGraph.from_host(graph)
