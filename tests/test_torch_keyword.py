"""Port graph keyword search (graphminer_tpu_torch/workloads/keyword.py)
against the JAX package's workloads/keyword.py on the same numpy-seeded
labelled graphs (the parameters of tests/test_keyword.py and a labelled
rmat9), exactly, and its vectorised necessity test against a direct
search."""
import functools

import numpy as np
import pytest
import torch

from graphminer_tpu.core.graph import HostGraph as JHostGraph
from graphminer_tpu.workloads import keyword as jkeyword
from graphminer_tpu_torch.io.synth import labeled_er, rmat
from graphminer_tpu_torch.workloads import keyword


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: these searches issue many small ops, and under
    xdist the workers' intra-op threads only contend for the cores (24x
    slower with 6 workers of 8 threads on 8 cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_graph(g):
    return JHostGraph(rowptr=g.rowptr, colidx=g.colidx, vlabels=g.vlabels)


@functools.lru_cache(maxsize=None)
def rmat9():
    g = rmat(9, 8, seed=7)
    g.vlabels = np.random.default_rng(7).integers(
        1, 5, g.n_vertices).astype(np.uint8)
    return g


@pytest.mark.parametrize("seed,n,p,k,kw", [
    (0, 18, 0.25, 3, (1, 2, 3)),
    (1, 20, 0.2, 4, (1, 2, 3)),
    (2, 16, 0.35, 3, (1, 2)),
    (3, 14, 0.3, 4, (1, 2, 3, 4)),
])
def test_gks_equals_jax(seed, n, p, k, kw):
    g = labeled_er(n, p, n_vlabels=max(kw) + 1, seed=seed)
    assert keyword.gks_count(g, k, kw, device="cpu") == \
        jkeyword.gks_count(jax_graph(g), k, kw)


@pytest.mark.parametrize("k,kw", [(3, (1, 2, 3)), (3, (1, 2)), (2, (1,))])
def test_gks_rmat9_equals_jax(k, kw):
    g = rmat9()
    got = keyword.gks_count(g, k, kw, device="cpu")
    assert got == jkeyword.gks_count(jax_graph(g), k, kw)
    if len(kw) == k:
        assert got > 0


def test_connected_without_equals_search():
    """_connected_without over every graph on 5 vertices given by a random
    sample of adjacency matrices, against a direct search per position."""
    rng = np.random.default_rng(1)
    k = 5
    m = np.triu(rng.random((400, k, k)) < 0.4, 1)
    adj = m | m.transpose(0, 2, 1)
    got = keyword._connected_without(torch.from_numpy(adj)).numpy()
    for e in range(adj.shape[0]):
        for i in range(k):
            keep = [v for v in range(k) if v != i]
            seen, stack = {keep[0]}, [keep[0]]
            while stack:
                w = stack.pop()
                for u in keep:
                    if adj[e, w, u] and u not in seen:
                        seen.add(u)
                        stack.append(u)
            assert got[e, i] == (len(seen) == len(keep))
