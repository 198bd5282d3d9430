"""Port hub layout (graphminer_tpu_torch/ops/hubcore.py) against the JAX
package's build_hub_layout: the table equal bit for bit, including words
with bit 31 set; and the plain popcount on such words."""
import dataclasses

import numpy as np
import pytest
import torch

from graphminer_tpu.core.graph import HostGraph as JHostGraph
from graphminer_tpu.io.synth import rmat as jrmat
from graphminer_tpu.ops import hubcore as jhub
from graphminer_tpu_torch.core.graph import HostGraph
from graphminer_tpu_torch.device import resolve_device
from graphminer_tpu_torch.io.synth import rmat
from graphminer_tpu_torch.ops import hubcore
from graphminer_tpu_torch.ops._tensors import popcount32


def dag_pair(g):
    """The same oriented DAG in both packages' HostGraph classes."""
    ours = HostGraph(rowptr=g.rowptr, colidx=g.colidx).relabel_by_degree(
        descending=False).orientation()
    ref = JHostGraph(rowptr=g.rowptr, colidx=g.colidx).relabel_by_degree(
        descending=False).orientation()
    return ours, ref


def assert_layout_equal(ours, ref):
    assert ours.table.dtype == torch.int32
    assert np.array_equal(ours.table.numpy(), np.asarray(ref.table))
    assert (ours.words, ours.core_start, ours.core_size, ours.wt_pad,
            ours.n_vertices) == (ref.words, ref.core_start, ref.core_size,
                                 ref.wt_pad, ref.n_vertices)
    assert np.array_equal(ours.t_width, ref.t_width)


@pytest.mark.parametrize("core", [1, 8, 32, 33, 4096])
@pytest.mark.parametrize("source", ["rand", "rmat10", "rmat11", "rmat12"])
def test_table_equal(core, source, rand_graphs):
    graphs = (rand_graphs if source == "rand"
              else [rmat(int(source[4:]), 8, seed=core % 5)])
    for g in graphs:
        ours, ref = dag_pair(g)
        assert_layout_equal(hubcore.build_hub_layout(ours, core=core,
                                                     device="cpu"),
                            jhub.build_hub_layout(ref, core=core))


def test_bit31_words_equal():
    """Hand-built DAG whose core-local ids are ≡ 31 (mod 32): every stored
    bitmap word has bit 31 set, and the tables agree bit for bit."""
    v, core = 128, 96
    cs = v - core
    hubs = [cs + 31, cs + 63, cs + 95]            # core-local 31, 63, 95
    src, dst = [], []
    for u in range(cs):
        for h in hubs:
            src.append(u)
            dst.append(h)
        src.append(u)
        dst.append((u + 1) % cs)                  # a sub-core tail entry
    src.append(hubs[0]); dst.append(hubs[1])
    src.append(hubs[1]); dst.append(hubs[2])
    s, d = np.asarray(src), np.asarray(dst)
    ours = dataclasses.replace(HostGraph.from_edges(s, d, v), is_dag=True)
    ref = dataclasses.replace(JHostGraph.from_edges(s, d, v), is_dag=True)
    lay = hubcore.build_hub_layout(ours, core=core, device="cpu")
    assert_layout_equal(lay, jhub.build_hub_layout(ref, core=core))
    words = lay.table[:cs, :lay.words].numpy().view(np.uint32)
    assert (words[:, :3] == np.uint32(1 << 31)).all()
    assert (lay.table[:cs, :3] < 0).all()        # int32 view is negative


def test_popcount_matches_numpy():
    rng = np.random.default_rng(3)
    x = rng.integers(-(1 << 31), 1 << 31, size=4096, dtype=np.int64
                     ).astype(np.int32)
    x[:4] = [np.int32(-1), np.int32(-(1 << 31)), 0, np.int32(0x7FFFFFFF)]
    got = popcount32(torch.from_numpy(x)).numpy()
    want = np.bitwise_count(x.view(np.uint32)).astype(np.int64)
    assert got.dtype == np.int64
    assert np.array_equal(got, want)
    assert (x < 0).sum() > 1000                   # many words with bit 31


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    g = dag_pair(rmat(8, 8, seed=1))[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        hubcore.build_hub_layout(g, device="cuda")
    assert resolve_device("cpu") == torch.device("cpu")
