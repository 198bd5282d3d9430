"""Port 4-clique engine (graphminer_tpu_torch/ops/clique4.py: kernel G's
gathered mode, plain version on the CPU, + the frontier tail) against the
JAX package's clique4 on the same seeded graphs at cores 128 and 256, and
at the default core against the port's generic clique count; exact."""
import pytest
import torch

from graphminer_tpu.core.graph import HostGraph as JHostGraph
from graphminer_tpu.ops import clique4 as jclique4
from graphminer_tpu_torch.io.synth import rmat
from graphminer_tpu_torch.ops import clique4, cuda_gram
from graphminer_tpu_torch.workloads.clique import clique_count


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the tail issues many small ops, and under xdist
    the workers' intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GRAPHS = [(11, 17), (12, 23)]


def jax_graph(g):
    return JHostGraph(rowptr=g.rowptr, colidx=g.colidx, is_dag=g.is_dag)


@pytest.mark.parametrize("scale,seed", GRAPHS)
@pytest.mark.parametrize("core", [128, 256])
def test_clique4_equal_jax(scale, seed, core):
    g = rmat(scale, 8, seed=seed)
    jeng = jclique4.Clique4Engine(jax_graph(g), core=core)
    eng = clique4.Clique4Engine(g, core=core, device="cpu")
    assert eng.n_core_edges == jeng.n_core_edges > 0
    assert eng.tail_total == jeng.tail_total
    assert int(eng.core_partials().sum()) == \
        jeng._gram_total(jeng.src, jeng.dst)
    want = jclique4.clique4_count_fast(jax_graph(g), core=core)
    assert eng.count() == want
    assert clique4.clique4_count_fast(g, core=core, device="cpu") == want


def test_clique4_gram_is_gathered_g():
    """The core-dst count is G's gathered mode, depth 1, with the core rows
    of the layout table as its mask, read in place."""
    eng = clique4.Clique4Engine(rmat(10, 8, seed=7), core=128, device="cpu")
    base, mask, kw = eng.gram_args()
    assert kw["cols"].shape == (eng.n_core_edges, 1)
    assert mask.data_ptr() == eng.lay.table[eng.lay.core_start:].data_ptr()
    assert base.data_ptr() == kw["tab"].data_ptr() == \
        eng.lay.table.data_ptr()
    assert torch.equal(eng.core_partials(),
                       cuda_gram.bit_gram_plain(base, mask, **kw))


def test_clique4_default_core_equals_generic():
    """rmat11 only: at the default core (4096) the whole graph is core, and
    G's plain version multiplies a [2^11, 2^11] Gram a task block."""
    g = rmat(11, 8, seed=17)
    assert clique4.clique4_count_fast(g, device="cpu") == \
        clique_count(g, 4, device="cpu")
